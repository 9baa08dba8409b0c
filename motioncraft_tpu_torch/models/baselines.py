"""The baseline denoisers MotionDiffuse, MCM, MDM, FineMoGen, ReMoDiffuse and
MoMatMoGen (PyTorch port of motioncraft_tpu/models/baselines.py).

  - MotionDiffuseTransformer: the generic stack of the shared skeleton
    (models/diffusion_transformer.py): a Linear joint embedding, ``block_{i}``
    = EfficientSelfAttention -> EfficientCrossAttention -> FFN, a zero-init
    output, the pooled text projection added to the time embedding.  Both
    attentions run kernel K5, in training too (the cross-attention masks
    the text where ``cond_type % 10 == 0``).  No classifier-free
    guidance.
  - MCMTransformer: the same skeleton with MCMDecoderLayer: self-attention
    across the channels (the [B, D, T] transpose, D tokens of T features,
    an all-ones mask, so the config's ``sa_block_cfg.latent_dim`` is the
    frame count), a channel FFN, the text cross-attention and a temporal
    FFN.  At 4 heads over T = 196 frames the channel attention's head width
    is 49, which K5 runs padded to 64 (ops/linear_attention.py).
  - MDMTransformer: a pooled-CLIP conditioning token (time embedding of the
    sinusoidal table's row t plus the projected text) before the motion
    tokens, the sinusoidal position table added, a post-LN transformer
    encoder, and classifier-free guidance as two trunk passes mixed at
    ``guide_scale``.  Its attention is the plain einsum one, as in the JAX
    package (no Pallas kernel there).  Its training forward drops the text
    of a row where ``cond_type % 10 == 0`` and runs one trunk pass with
    the encoder's dropout, its masks from the step's generator; the
    config's ``cond_mask_prob`` is stored and never read, as in the JAX
    package.  ``post_process`` rescales the root channels of the official
    released checkpoint.
  - FineMoGenTransformer: STMoGen's skeleton (body-part PoseEncoder /
    PoseDecoder, CFG on the doubled batch) with SAMI as the ca_block
    (models/attentions.py): two MoEs a layer (K4's route and K1 each) and
    SFFN (K2).  SAMI has no text branch to hoist and computes both CFG
    halves in layer 0, as the JAX package's does; with the JAX package's
    default ``text_hoist`` its sampling fails (its hoist calls SAMI without
    motion), so the port's default computes what JAX computes with the
    hoist off.  In training SAMI's MoEs run the slot path (K4's
    positions, K6) and add their aux losses, and its template times add
    their KL terms.

The training of ReMoDiffuse and MoMatMoGen raises: the JAX package's loss
applies them without a retrieval (``RETRIEVAL_TRAINING``).  bf16, int8 and
the step cache are not ported to the baselines: each family's
``exact_f32_only`` says so, and ``bf16_cast_``, ``int8_quantize_`` and the
CLIs refuse them on it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..registry import ATTENTIONS, SUBMODULES
from .blocks import FFN, Linear, ZeroDense, timestep_embedding
from .diffusion_transformer import DiffusionTransformerBase, ffn_from_cfg
from .stmogen import STMoGenTransformer
from .text_encoder import ClipTextModel, PostLNEncoderLayer

EXACT_F32_ONLY = ("bf16, int8 and the step cache are not ported to the baselines "
                  "(ROADMAP queue 2: K5's bf16 instantiation, with bf16, int8 and the "
                  "step cache on the baselines)")
RETRIEVAL_TRAINING = ("the JAX package's MotionDiffusion.loss applies the model without a "
                      "re_dict, so its training of ReMoDiffuse and MoMatMoGen stops with a "
                      "TypeError (ROADMAP queue 3: ReMoDiffuse / MoMatMoGen training)")


@SUBMODULES.register_module()
class MotionDiffuseTransformer(DiffusionTransformerBase):
    """The plain sa / ca / FFN decoder stack."""

    exact_f32_only = EXACT_F32_ONLY

    def __init__(self, input_feats: int = 263, max_seq_len: int = 240,
                 latent_dim: int = 512, time_embed_dim: int = 2048, num_layers: int = 8,
                 sa_block_cfg: Optional[dict] = None, ca_block_cfg: Optional[dict] = None,
                 ffn_cfg: Optional[dict] = None, text_encoder: Optional[dict] = None,
                 use_pos_embedding: bool = True, post_process_cfg: Optional[dict] = None,
                 init_cfg: Optional[dict] = None, remat: bool = False):
        super().__init__(input_feats, max_seq_len, latent_dim, time_embed_dim, num_layers,
                         text_encoder, use_pos_embedding, remat)
        self.setup_io()
        self.build_temporal_blocks(sa_block_cfg, ca_block_cfg, ffn_cfg)


class MCMDecoderLayer(nn.Module):
    """Channel self-attention, channel FFN, text cross-attention, temporal
    FFN.  The keywords the other layers read (a ControlNet's copied block
    hands every layer ``text_feat``; the stacks ``motion_length`` and
    ``num_intervals``) are accepted and ignored, as flax's ``**kwargs``
    takes them."""

    def __init__(self, sa_block_cfg: Optional[dict] = None,
                 ca_block_cfg: Optional[dict] = None, ffn_cfg: Optional[dict] = None):
        super().__init__()
        self.sa_block = ATTENTIONS.build(sa_block_cfg)
        self.ffn_channel = ffn_from_cfg(ffn_cfg)
        self.ca_block = ATTENTIONS.build(ca_block_cfg)
        self.ffn_temporal = ffn_from_cfg(ffn_cfg)

    def forward(self, x, xf, emb, src_mask, cond_type=None, **kwargs):
        B, T, D = x.shape
        if self.sa_block is not None:
            # tokens are the feature channels, every one of them attended
            ones = torch.ones((B, D, 1), dtype=x.dtype, device=x.device)
            x = self.sa_block(x.transpose(1, 2), src_mask=ones, emb=emb).transpose(1, 2)
        if self.ffn_channel is not None:
            x = self.ffn_channel(x, emb)
        if self.ca_block is not None:
            x = self.ca_block(x, xf=xf, emb=emb, src_mask=src_mask, cond_type=cond_type)
        if self.ffn_temporal is not None:
            x = self.ffn_temporal(x, emb)
        return x


@SUBMODULES.register_module()
class MCMTransformer(MotionDiffuseTransformer):
    """MCM: the skeleton with channel-attention decoder layers."""

    def make_layer(self, sa_block_cfg, ca_block_cfg, ffn_cfg) -> nn.Module:
        return MCMDecoderLayer(sa_block_cfg, ca_block_cfg, ffn_cfg)


def sinusoidal_table(rows: int, dim: int) -> np.ndarray:
    """MDM's position table [rows, dim] (f32, numpy): sin on the even
    channels, cos on the odd ones, as the JAX package computes it."""
    pe = np.zeros((rows, dim), np.float32)
    pos = np.arange(rows, dtype=np.float32)[:, None]
    div = np.exp(np.arange(0, dim, 2, dtype=np.float32) * (-np.log(10000.0) / dim))
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    return pe


@SUBMODULES.register_module()
class MDMTransformer(nn.Module):
    """MDM: a conditioning token from the pooled CLIP text and the timestep
    before the motion tokens, through a post-LN transformer encoder."""

    # the sinusoidal table's rows: the timesteps index it (TimestepEmbedder)
    # and its first T + 1 rows are the positions of a T-frame clip
    TABLE_ROWS = 1000
    exact_f32_only = EXACT_F32_ONLY

    def __init__(self, input_feats: int = 263, latent_dim: int = 256, ff_size: int = 1024,
                 num_layers: int = 8, num_heads: int = 4, dropout: float = 0.1,
                 activation: str = "gelu", clip_dim: int = 512,
                 clip_version: Optional[str] = None, guide_scale: float = 1.0,
                 cond_mask_prob: float = 0.1, use_official_ckpt: bool = False,
                 clip_layers: int = 12, post_process_cfg: Optional[dict] = None,
                 init_cfg: Optional[dict] = None):
        super().__init__()
        self.input_feats, self.latent_dim, self.num_layers = input_feats, latent_dim, num_layers
        self.guide_scale, self.use_official_ckpt = guide_scale, use_official_ckpt
        self.poseEmbedding = Linear(input_feats, latent_dim)
        for i in range(num_layers):
            self.add_module(f"layer_{i}", PostLNEncoderLayer(latent_dim, num_heads, ff_size,
                                                             dropout, activation))
        self.time_embed = nn.Sequential(Linear(latent_dim, latent_dim), nn.SiLU(),
                                        Linear(latent_dim, latent_dim))
        self.embed_text = Linear(clip_dim, latent_dim)
        self.poseFinal = Linear(latent_dim, input_feats)
        self.clip = ClipTextModel(width=clip_dim, layers=clip_layers,
                                  heads=max(1, clip_dim // 64), embed_dim=clip_dim)
        self.register_buffer("table", torch.from_numpy(
            sinusoidal_table(self.TABLE_ROWS, latent_dim)), persistent=False)

    def stack_dtype(self) -> torch.dtype:
        return self.poseEmbedding.weight.dtype

    @torch.no_grad()
    def encode_text(self, text_ids, generator=None):
        """The pooled CLIP text feature [B, clip_dim] (frozen: no gradient,
        no dropout)."""
        return self.clip(text_ids, return_pooled=True)

    def _trunk(self, motion, timesteps, text_emb, generator=None):
        T = motion.shape[1]
        if T + 1 > self.TABLE_ROWS:
            raise ValueError(f"MDMTransformer: {T} frames exceed its position table")
        h = self.poseEmbedding(motion)
        cond = self.time_embed(self.table[timesteps]) + self.embed_text(text_emb)
        xseq = torch.cat([cond[:, None], h], dim=1) + self.table[None, :T + 1]
        for i in range(self.num_layers):
            xseq = getattr(self, f"layer_{i}")(xseq, generator=generator)
        return self.poseFinal(xseq[:, 1:])

    def forward(self, motion, timesteps, motion_mask=None, motion_length=None,
                xf_out=None, *, mode: str = "test", cond_type=None, generator=None,
                **kwargs):
        """``xf_out`` is the pooled text [B, clip_dim].  The test forward
        mixes an unconditional and a text pass at ``guide_scale``; the
        training forward (``mode="train"``) is one pass with the text
        zeroed where ``cond_type % 10 == 0`` and, in ``train()`` mode, the
        encoder's dropout drawn from ``generator``."""
        if mode == "train":
            if cond_type is not None:
                keep = ((cond_type.reshape(-1, 1) % 10) > 0).to(xf_out.dtype)
                xf_out = xf_out * keep
            return self._trunk(motion, timesteps, xf_out, generator)
        if mode != "test":
            raise ValueError(f"mode {mode!r}")
        out_uncond = self._trunk(motion, timesteps, torch.zeros_like(xf_out))
        out_text = self._trunk(motion, timesteps, xf_out)
        return out_uncond + self.guide_scale * (out_text - out_uncond)

    def post_process(self, motion):
        """The official checkpoint's root rescale: its first 4 channels x 25."""
        if self.use_official_ckpt:
            motion = torch.cat([motion[..., :4] * 25.0, motion[..., 4:]], dim=-1)
        return motion


@SUBMODULES.register_module()
class FineMoGenTransformer(STMoGenTransformer):
    """FineMoGen: the STMoGen skeleton with SAMI attention (the configs set
    ``ca_block_cfg.type='SAMI'``).  Its step cache is not ported either."""

    exact_f32_only = EXACT_F32_ONLY
    supports_step_cache = False


class RetrievalDatabase:
    """ReMoDiffuse's retrieval bank on the host: an ``.npz`` of
    ``text_features`` [n, C], ``captions``, ``motions`` [n, T, F],
    ``m_lengths`` and ``clip_seq_features`` [n, L, latent].  ``retrieve``
    ranks by cosine similarity times the kinematic length term and caches
    its picks by caption; ``gather`` hands the picked rows to the
    transformer's ``encode_retrieval``.  Built from a model's
    ``retrieval_cfg``, whose encoder keys it ignores."""

    def __init__(self, num_retrieval=None, retrieval_file=None, kinematic_coef=0.1, stride=4,
                 **_):
        data = np.load(retrieval_file)
        self.text_features = np.asarray(data["text_features"])
        self.captions = data["captions"]
        self.motions = np.asarray(data["motions"])
        self.m_lengths = np.asarray(data["m_lengths"])
        self.clip_seq_features = np.asarray(data["clip_seq_features"])
        self.num_retrieval = num_retrieval
        self.kinematic_coef = kinematic_coef
        self.stride = stride
        self.results = {}

    def retrieve(self, caption_feature: np.ndarray, length: int, caption: str,
                 training: bool = False) -> list:
        """The bank indices of the ``num_retrieval`` best matches of one
        caption, in rank order (a training query skips the entries of its
        own length).  ``np.argsort(-score)``, as the JAX package sorts, so
        ties fall as there.  ``hash(caption)`` keys the cache only."""
        key = hash(caption)
        if key in self.results:
            return self.results[key]
        rel = np.abs(self.m_lengths - length)
        rel = rel / np.maximum(rel, length)
        tf = self.text_features / (np.linalg.norm(self.text_features, axis=-1,
                                                  keepdims=True) + 1e-12)
        cf = caption_feature / (np.linalg.norm(caption_feature) + 1e-12)
        score = (tf @ cf) * np.exp(-rel * self.kinematic_coef)
        picked = []
        for idx in np.argsort(-score):
            if not training or self.m_lengths[idx] != length:
                picked.append(int(idx))
                if len(picked) == self.num_retrieval:
                    break
        self.results[key] = picked
        return picked

    def gather(self, indexes, B: int):
        """(motions [n, T, F], frame mask [n, T], CLIP token features
        [n, L, latent]) of the picked rows, f32 numpy."""
        idx = np.asarray(indexes)
        motions = self.motions[idx]
        lengths = self.m_lengths[idx]
        mask = (np.arange(motions.shape[1])[None] < lengths[:, None]).astype(np.float32)
        return (motions.astype(np.float32), mask,
                self.clip_seq_features[idx].astype(np.float32))


class RetrievalEncoder(nn.Module):
    """The retrieved motions and captions re-encoded on the device."""

    def __init__(self, latent_dim: int = 512, num_motion_layers: int = 4,
                 num_text_layers: int = 2, num_heads: int = 8, ff_size: int = 1024,
                 max_seq_len: int = 196, stride: int = 4, motion_feats: int = 263,
                 sa_block_cfg: Optional[dict] = None, ffn_cfg: Optional[dict] = None):
        super().__init__()
        self.num_motion_layers, self.num_text_layers = num_motion_layers, num_text_layers
        self.stride = stride
        self.motion_pos_embedding = nn.Parameter(torch.randn(max_seq_len, latent_dim))
        self.motion_proj = Linear(motion_feats, latent_dim)
        ffn_dim = dict(ffn_cfg or {}).get("ffn_dim", 1024)
        for i in range(num_motion_layers):
            self.add_module(f"motion_sa_{i}", ATTENTIONS.build(sa_block_cfg))
            self.add_module(f"motion_ffn1_{i}", Linear(latent_dim, ffn_dim))
            self.add_module(f"motion_ffn2_{i}", ZeroDense(ffn_dim, latent_dim))
        for i in range(num_text_layers):
            self.add_module(f"text_layer_{i}", PostLNEncoderLayer(latent_dim, num_heads,
                                                                  ff_size, 0.0, "gelu"))

    def forward(self, motions, mask, clip_seq_features, num_retrieval: int) -> dict:
        """B x R retrieved rows -> {"re_motion" [B, R, T / stride, latent],
        "re_text" [B, R, 1, latent], "re_mask" [B, R, T / stride]}."""
        BR, T, _ = motions.shape
        B = BR // num_retrieval
        re_motion = self.motion_proj(motions) + self.motion_pos_embedding[None, :T]
        for i in range(self.num_motion_layers):
            re_motion = getattr(self, f"motion_sa_{i}")(re_motion, src_mask=mask[..., None])
            h = F.gelu(getattr(self, f"motion_ffn1_{i}")(re_motion))
            re_motion = re_motion + getattr(self, f"motion_ffn2_{i}")(h)
        re_motion = re_motion.reshape(B, num_retrieval, T, -1)[:, :, ::self.stride]
        re_mask = mask[:, ::self.stride].reshape(B, num_retrieval, -1)
        txt = clip_seq_features
        for i in range(self.num_text_layers):
            txt = getattr(self, f"text_layer_{i}")(txt)
        re_text = txt.reshape(B, num_retrieval, txt.shape[1], -1)[:, :, -1:]
        return {"re_motion": re_motion, "re_text": re_text, "re_mask": re_mask}


# bernoulli(fold_in(PRNGKey(0), t)) of jax 0.9 (threefry, partitionable) for
# t = 0..999: bit t of these bytes, least significant bit first
COIN_HEX = ("9a753be35694233867f9cab10fa1ae51123493095e9e17fe69487bdf979f3cc0"
            "265dacde4db31749eeb10795bff2c4ef1c09801680d908c282ed5ffd9bfa2f6f"
            "056864c4105ab957f57e499c8543f27da5235aa2a2c5c463937750fcae2b0c4a"
            "14f660411e436a7f2e12fdb215ec5c9dabaa2607cb778596c5f7b316da")


def coin_table() -> np.ndarray:
    """ReMoDiffuse's per-timestep coin, [1000] bool."""
    bits = np.unpackbits(np.frombuffer(bytes.fromhex(COIN_HEX), np.uint8), bitorder="little")
    return bits[:1000].astype(bool)


@SUBMODULES.register_module()
class ReMoDiffuseTransformer(DiffusionTransformerBase):
    """Retrieval-augmented denoiser with four-way classifier-free guidance
    over (text and retrieval, text, retrieval, neither)."""

    exact_f32_only = EXACT_F32_ONLY

    def __init__(self, input_feats: int = 263, max_seq_len: int = 240,
                 latent_dim: int = 512, time_embed_dim: int = 2048, num_layers: int = 8,
                 sa_block_cfg: Optional[dict] = None, ca_block_cfg: Optional[dict] = None,
                 ffn_cfg: Optional[dict] = None, text_encoder: Optional[dict] = None,
                 use_pos_embedding: bool = True, retrieval_cfg: Optional[dict] = None,
                 scale_func_cfg: Optional[dict] = None, post_process_cfg: Optional[dict] = None,
                 init_cfg: Optional[dict] = None, remat: bool = False):
        super().__init__(input_feats, max_seq_len, latent_dim, time_embed_dim, num_layers,
                         text_encoder, use_pos_embedding, remat)
        self.setup_io()
        self.build_temporal_blocks(sa_block_cfg, ca_block_cfg, ffn_cfg)
        rc = dict(retrieval_cfg or {})
        self.retrieval_encoder = RetrievalEncoder(
            latent_dim=rc.get("latent_dim", 512), num_motion_layers=rc.get("num_motion_layers", 4),
            num_text_layers=rc.get("num_layers", 2), num_heads=rc.get("num_heads", 8),
            ff_size=rc.get("ff_size", 1024), max_seq_len=rc.get("max_seq_len", 196),
            stride=rc.get("stride", 4), motion_feats=input_feats,
            sa_block_cfg=rc.get("sa_block_cfg"), ffn_cfg=rc.get("ffn_cfg"))
        self.scale_func_cfg = dict(scale_func_cfg or {})
        self.register_buffer("coin", torch.from_numpy(coin_table()), persistent=False)

    def forward_train(self, **kwargs):
        raise NotImplementedError(f"training {type(self).__name__}: {RETRIEVAL_TRAINING}")

    def encode_retrieval(self, motions, mask, clip_seq_features, num_retrieval: int) -> dict:
        """The ``re_dict`` of B x ``num_retrieval`` gathered rows
        (``RetrievalDatabase.gather``); it depends on no timestep."""
        return self.retrieval_encoder(motions, mask, clip_seq_features, num_retrieval)

    def scale_func(self, timestep: torch.Tensor):
        """The four CFG weights (both, text, retrieval, none) at one
        original-scale timestep (a 0-d tensor): past t = 100 the coin picks
        (w, 0, 1 - w, 0) or (0, w, 0, 1 - w), w = t / 1000 x coarse_scale +
        1; else the config's fixed weights."""
        cfg = self.scale_func_cfg
        coarse = cfg.get("coarse_scale", 4.0)
        both_c, text_c = cfg.get("both_coef", 0.5), cfg.get("text_coef", 0.25)
        retr_c = cfg.get("retr_coef", 0.15)
        w = (1 - (1000 - timestep.to(torch.float32)) / 1000) * coarse + 1
        coin, late = self.coin[timestep], timestep > 100
        zero = torch.zeros_like(w)

        def pick(on_heads, on_tails, early):
            return torch.where(late, torch.where(coin, on_heads, on_tails),
                               torch.full_like(w, early))

        return (pick(w, zero, both_c), pick(zero, w, text_c), pick(1 - w, zero, retr_c),
                pick(zero, 1 - w, 1 - both_c - text_c - retr_c))

    def decode(self, h):
        """The zero-init output of the stack's rows (MoMatMoGen: of each
        person's half)."""
        B, T = h.shape[:2]
        return self.out(h).reshape(B, T, -1)

    def forward_test(self, h, src_mask, emb, xf_out, re_dict=None, timesteps=None, **kwargs):
        """The batch x 4 at cond_type 99 / 1 / 10 / 0, one pass, mixed by
        ``scale_func(timesteps[0])``."""
        B = h.shape[0]
        cond = torch.tensor([99, 1, 10, 0], device=h.device).repeat_interleave(B)
        rep = lambda a: torch.cat([a] * 4)  # noqa: E731
        h, xf4, emb4, mask4 = rep(h), rep(xf_out), rep(emb), rep(src_mask)
        re4 = {k: rep(v) for k, v in re_dict.items()}
        for block in self.blocks:
            h = block(h, xf4, emb4, mask4, cond.reshape(4 * B, 1, 1), re_dict=re4)
        out = self.decode(h)
        both_c, text_c, retr_c, none_c = self.scale_func(timesteps[0])
        return (out[:B] * both_c + out[B:2 * B] * text_c + out[2 * B:3 * B] * retr_c
                + out[3 * B:] * none_c)


class DualFFN(nn.Module):
    """One FFN applied to each person's half of [B, T, 2 x latent]."""

    def __init__(self, latent_dim: int, ffn_dim: int, dropout: float = 0.0,
                 time_embed_dim: int = 2048):
        super().__init__()
        self.latent_dim = latent_dim
        self.ffn = FFN(latent_dim, ffn_dim, dropout, time_embed_dim)

    def forward(self, x, emb):
        L = self.latent_dim
        return torch.cat([self.ffn(x[:, :, :L], emb), self.ffn(x[:, :, L:], emb)], dim=-1)


class MoMatDecoderLayer(nn.Module):
    """A two-person layer: the dual attention, then the dual FFN."""

    def __init__(self, ca_block_cfg: Optional[dict] = None, ffn_cfg: Optional[dict] = None):
        super().__init__()
        self.ca_block = ATTENTIONS.build(ca_block_cfg)
        self.ffn = (None if ffn_cfg is None else
                    DualFFN(**{k: v for k, v in dict(ffn_cfg).items() if k != "num_heads"}))

    def forward(self, x, xf, emb, src_mask, cond_type=None, **kwargs):
        if self.ca_block is not None:
            x = self.ca_block(x, xf=xf, emb=emb, src_mask=src_mask, cond_type=cond_type,
                              **kwargs)
        return x if self.ffn is None else self.ffn(x, emb)


@SUBMODULES.register_module()
class MoMatMoGenTransformer(ReMoDiffuseTransformer):
    """Two-person ReMoDiffuse: motion [B, T, 2 x input_feats], one joint
    embedding, position embedding and output for both persons.  No config
    in configs/ builds it."""

    def make_layer(self, sa_block_cfg, ca_block_cfg, ffn_cfg) -> nn.Module:
        return MoMatDecoderLayer(ca_block_cfg, ffn_cfg)

    def _embed(self, motion, timesteps):
        T, F_ = motion.shape[1], self.input_feats
        emb = self.time_embed(timestep_embedding(timesteps, self.latent_dim))
        halves = [self.joint_embed(m) for m in (motion[:, :, :F_], motion[:, :, F_:])]
        if self.use_pos_embedding:
            halves = [h + self.sequence_embedding[None, :T] for h in halves]
        return torch.cat(halves, dim=-1), emb

    def decode(self, h):
        B, T = h.shape[:2]
        L = self.latent_dim
        return torch.cat([self.out(h[:, :, :L]).reshape(B, T, -1),
                          self.out(h[:, :, L:]).reshape(B, T, -1)], dim=-1)
