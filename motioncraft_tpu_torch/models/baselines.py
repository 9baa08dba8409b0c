"""The baseline denoisers MotionDiffuse, MCM, MDM and FineMoGen (PyTorch port
of those classes of motioncraft_tpu/models/baselines.py).

  - MotionDiffuseTransformer: the generic stack of the shared skeleton
    (models/diffusion_transformer.py): a Linear joint embedding, ``block_{i}``
    = EfficientSelfAttention -> EfficientCrossAttention -> FFN, a zero-init
    output, the pooled text projection added to the time embedding.  Both
    attentions run kernel K5.  No classifier-free guidance.
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
    package (no Pallas kernel there).  ``post_process`` rescales the root
    channels of the official released checkpoint.
  - FineMoGenTransformer: STMoGen's skeleton (body-part PoseEncoder /
    PoseDecoder, CFG on the doubled batch) with SAMI as the ca_block
    (models/attentions.py): two MoEs a layer (K4's route and K1 each) and
    SFFN (K2).  SAMI has no text branch to hoist and computes both CFG
    halves in layer 0, as the JAX package's does; with the JAX package's
    default ``text_hoist`` its sampling fails (its hoist calls SAMI without
    motion), so the port's default computes what JAX computes with the
    hoist off.

Training the baselines is not ported (ROADMAP queue 1: baseline training):
their training forward raises.  Nor are bf16, int8 and the step cache: each
family's ``exact_f32_only`` says so, and ``bf16_cast_``, ``int8_quantize_``
and the CLIs refuse them on it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from ..registry import ATTENTIONS, SUBMODULES
from .diffusion_transformer import DiffusionTransformerBase, ffn_from_cfg
from .stmogen import STMoGenTransformer
from .text_encoder import ClipTextModel, PostLNEncoderLayer

EXACT_F32_ONLY = ("bf16, int8 and the step cache are not ported to the baselines "
                  "(ROADMAP queue 2: K5's bf16 instantiation, with bf16, int8 and the "
                  "step cache on the baselines)")


@SUBMODULES.register_module()
class MotionDiffuseTransformer(DiffusionTransformerBase):
    """The plain sa / ca / FFN decoder stack."""

    exact_f32_only = EXACT_F32_ONLY

    def __init__(self, input_feats: int = 263, max_seq_len: int = 240,
                 latent_dim: int = 512, time_embed_dim: int = 2048, num_layers: int = 8,
                 sa_block_cfg: Optional[dict] = None, ca_block_cfg: Optional[dict] = None,
                 ffn_cfg: Optional[dict] = None, text_encoder: Optional[dict] = None,
                 use_pos_embedding: bool = True, post_process_cfg: Optional[dict] = None,
                 init_cfg: Optional[dict] = None):
        super().__init__(input_feats, max_seq_len, latent_dim, time_embed_dim, num_layers,
                         text_encoder, use_pos_embedding)
        self.setup_io()
        self.build_temporal_blocks(sa_block_cfg, ca_block_cfg, ffn_cfg)


class MCMDecoderLayer(nn.Module):
    """Channel self-attention, channel FFN, text cross-attention, temporal
    FFN."""

    def __init__(self, sa_block_cfg: Optional[dict] = None,
                 ca_block_cfg: Optional[dict] = None, ffn_cfg: Optional[dict] = None):
        super().__init__()
        self.sa_block = ATTENTIONS.build(sa_block_cfg)
        self.ffn_channel = ffn_from_cfg(ffn_cfg)
        self.ca_block = ATTENTIONS.build(ca_block_cfg)
        self.ffn_temporal = ffn_from_cfg(ffn_cfg)

    def forward(self, x, xf, emb, src_mask, cond_type=None):
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
        self.poseEmbedding = nn.Linear(input_feats, latent_dim)
        for i in range(num_layers):
            self.add_module(f"layer_{i}", PostLNEncoderLayer(latent_dim, num_heads, ff_size,
                                                             dropout, activation))
        self.time_embed = nn.Sequential(nn.Linear(latent_dim, latent_dim), nn.SiLU(),
                                        nn.Linear(latent_dim, latent_dim))
        self.embed_text = nn.Linear(clip_dim, latent_dim)
        self.poseFinal = nn.Linear(latent_dim, input_feats)
        self.clip = ClipTextModel(width=clip_dim, layers=clip_layers,
                                  heads=max(1, clip_dim // 64), embed_dim=clip_dim)
        self.register_buffer("table", torch.from_numpy(
            sinusoidal_table(self.TABLE_ROWS, latent_dim)), persistent=False)

    def stack_dtype(self) -> torch.dtype:
        return self.poseEmbedding.weight.dtype

    @torch.no_grad()
    def encode_text(self, text_ids):
        """The pooled CLIP text feature [B, clip_dim] (frozen)."""
        return self.clip(text_ids, return_pooled=True)

    def _trunk(self, motion, timesteps, text_emb):
        T = motion.shape[1]
        if T + 1 > self.TABLE_ROWS:
            raise ValueError(f"MDMTransformer: {T} frames exceed its position table")
        h = self.poseEmbedding(motion)
        cond = self.time_embed(self.table[timesteps]) + self.embed_text(text_emb)
        xseq = torch.cat([cond[:, None], h], dim=1) + self.table[None, :T + 1]
        for i in range(self.num_layers):
            xseq = getattr(self, f"layer_{i}")(xseq)
        return self.poseFinal(xseq[:, 1:])

    def forward(self, motion, timesteps, motion_mask=None, motion_length=None,
                xf_out=None, *, mode: str = "test", **kwargs):
        """``xf_out`` is the pooled text [B, clip_dim].  The test forward
        mixes an unconditional and a text pass at ``guide_scale``."""
        if mode == "train":
            raise NotImplementedError("training MDMTransformer: ROADMAP queue 1: "
                                      "baseline training")
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
