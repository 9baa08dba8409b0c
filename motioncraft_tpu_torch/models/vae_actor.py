"""VAE architectures, the ACTOR encoder / decoder and the InterCLIP
two-person evaluator (PyTorch port of motioncraft_tpu/models/vae_actor.py).

  - ``ACTOREncoder``: a transformer VAE encoder; learned distribution query
    tokens (mu, and with ``output_var`` logvar) ahead of the embedded
    frames, or per-class / condition-MLP queries, a sinusoidal or learned
    position embedding, post-LN encoder layers; returns the query tokens'
    features
  - ``ACTORDecoder``: sinusoidal position queries of ``max_seq_len`` frames
    attending to themselves (masked by ``motion_mask``) and to the latent
    (plus a per-class or condition-MLP bias), post-LN, to ``input_feats``
  - ``PoseVAE`` (per frame) and ``MotionVAE`` (per sequence): the
    reconstruction loss of the decoded reparameterised latent and the
    weighted KL; the reparameterisation's standard-normal draw comes from a
    generator, or is handed in (``noise``)
  - ``InterCLIP``: InterGen's two-person motion encoder and CLIP-token text
    transformer, each embedding L2-normalised and scaled by
    ``latent_scale``

Module and parameter names follow the flax modules (utils/convert.py).
The attention is ``text_encoder.ClipAttention`` (einsum + softmax, as the
JAX package writes it) and the encoder layers ``PostLNEncoderLayer``:
plain ops, as the JAX package computes them outside any Pallas kernel.
The entry points (``PoseVAE`` / ``MotionVAE`` / ``InterCLIP``) build on the
card unless the caller passes ``device="cpu"``; without a card they raise.
InterCLIP's weights start from torch's initialisation under ``seed``, not
from flax's (ROADMAP queue 3, "Random streams"): an evaluation loads
trained ones.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..registry import ARCHITECTURES, SUBMODULES, build_loss, build_submodule
from .architecture import resolve_device
from .blocks import LayerNorm, Linear
from .text_encoder import ClipAttention, PostLNEncoderLayer


def _sin_table(max_len, d):
    pe = np.zeros((max_len, d), np.float32)
    pos = np.arange(max_len, dtype=np.float32)[:, None]
    div = np.exp(np.arange(0, d, 2, dtype=np.float32) * (-np.log(10000.0) / d))
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    return pe


def sin_table(max_len: int, d: int, like: torch.Tensor) -> torch.Tensor:
    """The sinusoidal position table [max_len, d] in ``like``'s dtype and
    device."""
    return torch.as_tensor(_sin_table(max_len, d), dtype=like.dtype, device=like.device)


class MLP(nn.Module):
    """build_MLP: a Linear / exact-GELU chain over ``dim_list``
    (``layer_{i}``), then a Linear ``out`` to ``latent_dim``."""

    def __init__(self, dim_list: Sequence[int], latent_dim: int):
        super().__init__()
        dims = list(dim_list)
        self.depth = len(dims) - 1
        for i in range(self.depth):
            self.add_module(f"layer_{i}", Linear(dims[i], dims[i + 1]))
        self.out = Linear(dims[-1], latent_dim)

    def forward(self, x):
        for i in range(self.depth):
            x = F.gelu(getattr(self, f"layer_{i}")(x))
        return self.out(x)


def _queries(latent_dim: int, condition_dim, num_class):
    """A condition's query (or bias) source: a condition MLP, or a per-class
    table [num_class, latent_dim]."""
    if num_class is None:
        return MLP((condition_dim,), latent_dim)
    return nn.Parameter(torch.randn(num_class, latent_dim))


def _lookup(source, condition):
    """The query of each row's condition: the MLP of it, or the class's row."""
    if isinstance(source, MLP):
        return source(condition)
    return source[condition.to(torch.long).reshape(-1)]


@SUBMODULES.register_module()
class ACTOREncoder(nn.Module):
    """Transformer VAE encoder with learned distribution query tokens:
    motion [B, T, ...] with motion_mask [B, T] -> mu [B, latent_dim], or
    with ``output_var`` (mu, logvar)."""

    def __init__(self, max_seq_len: int = 16, input_feats: Optional[int] = None,
                 latent_dim: int = 256, condition_dim: Optional[int] = None,
                 num_heads: int = 4, ff_size: int = 1024, num_layers: int = 8,
                 activation: str = "gelu", dropout: float = 0.1,
                 use_condition: bool = False, num_class: Optional[int] = None,
                 use_final_proj: bool = False, output_var: bool = False,
                 pos_embedding: str = "sinusoidal", init_cfg: Optional[dict] = None):
        super().__init__()
        if input_feats is None:
            raise ValueError("ACTOREncoder needs input_feats (flax infers it from the "
                             "first call; the port builds its weights up front)")
        self.latent_dim, self.num_layers = latent_dim, num_layers
        self.use_condition, self.output_var = use_condition, output_var
        self.pos_embedding_type = pos_embedding
        self.skelEmbedding = Linear(input_feats, latent_dim)
        n_tok = 2 if output_var else 1
        if use_condition:
            self.mu_layer = _queries(latent_dim, condition_dim, num_class)
            if output_var:
                self.sigma_layer = _queries(latent_dim, condition_dim, num_class)
        else:
            self.query = nn.Parameter(torch.randn(n_tok, latent_dim))
        if pos_embedding != "sinusoidal":
            self.pos_embedding = nn.Parameter(torch.randn(max_seq_len + 2, latent_dim))
        for i in range(num_layers):
            self.add_module(f"layer_{i}", PostLNEncoderLayer(latent_dim, num_heads, ff_size,
                                                             dropout, activation))

    def forward(self, motion, motion_mask=None, condition=None, generator=None):
        B, T = motion.shape[:2]
        x = self.skelEmbedding(motion.reshape(B, T, -1))
        n_tok = 2 if self.output_var else 1
        if self.use_condition:
            toks = [_lookup(self.mu_layer, condition).reshape(B, 1, -1)]
            if self.output_var:
                toks.append(_lookup(self.sigma_layer, condition).reshape(B, 1, -1))
        else:
            toks = [self.query[None].expand(B, n_tok, self.latent_dim).to(x.dtype)]
        feature = torch.cat(toks + [x], dim=1)
        key_mask = torch.cat([torch.ones(B, n_tok, dtype=torch.bool, device=x.device),
                              motion_mask.to(torch.bool)], dim=1)
        if self.pos_embedding_type == "sinusoidal":
            feature = feature + sin_table(feature.shape[1], self.latent_dim, feature)[None]
        else:
            feature = feature + self.pos_embedding[None, :feature.shape[1]]
        for i in range(self.num_layers):
            feature = getattr(self, f"layer_{i}")(feature, key_mask=key_mask,
                                                  generator=generator)
        if self.output_var:
            return feature[:, 0], feature[:, 1]
        return feature[:, 0]


@SUBMODULES.register_module()
class ACTORDecoder(nn.Module):
    """Latent [B, input_dim] -> motion [B, max_seq_len, input_feats]: per
    layer, self-attention of the position queries (keys masked by
    ``motion_mask``), cross-attention to the latent, an exact-GELU FFN, each
    post-LN."""

    def __init__(self, max_seq_len: int = 16, input_feats: Optional[int] = None,
                 input_dim: int = 256, latent_dim: int = 256,
                 condition_dim: Optional[int] = None, num_heads: int = 4,
                 ff_size: int = 1024, num_layers: int = 8, activation: str = "gelu",
                 dropout: float = 0.1, use_condition: bool = False,
                 num_class: Optional[int] = None, pos_embedding: str = "sinusoidal",
                 init_cfg: Optional[dict] = None):
        super().__init__()
        if input_feats is None:
            raise ValueError("ACTORDecoder needs input_feats")
        L = latent_dim
        self.max_seq_len, self.latent_dim, self.num_layers = max_seq_len, L, num_layers
        self.use_condition = use_condition
        self.linear = Linear(input_dim, L) if input_dim != L else None
        if use_condition:
            self.condition_bias = _queries(L, condition_dim, num_class)
        for i in range(num_layers):
            self.add_module(f"sa_{i}", ClipAttention(L, num_heads))
            self.add_module(f"ca_q_{i}", Linear(L, L))
            self.add_module(f"ca_kv_{i}", Linear(L, 2 * L))
            self.add_module(f"ffn1_{i}", Linear(L, ff_size))
            self.add_module(f"ffn2_{i}", Linear(ff_size, L))
            for n in (1, 2, 3):
                self.add_module(f"norm{n}_{i}", LayerNorm(L))
        self.final = Linear(L, input_feats)

    def forward(self, z, motion_mask=None, condition=None):
        B, L = z.shape[0], self.latent_dim
        if self.linear is not None:
            z = self.linear(z)
        if self.use_condition:
            z = z + _lookup(self.condition_bias, condition)
        x = sin_table(self.max_seq_len, L, z)[None].expand(B, self.max_seq_len, L)
        memory = z.reshape(B, 1, -1)
        key_mask = motion_mask.to(torch.bool)
        for i in range(self.num_layers):
            layer = lambda n: getattr(self, f"{n}_{i}")  # noqa: E731
            x = layer("norm1")(x + layer("sa")(x, key_mask=key_mask))
            k, v = layer("ca_kv")(memory).chunk(2, dim=-1)
            attn = (torch.einsum("bqd,bkd->bqk", layer("ca_q")(x), k) / L ** 0.5).softmax(-1)
            x = layer("norm2")(x + torch.einsum("bqk,bkd->bqd", attn, v))
            x = layer("norm3")(x + layer("ffn2")(F.gelu(layer("ffn1")(x))))
        return self.final(x)


@ARCHITECTURES.register_module()
class PoseVAE(nn.Module):
    """Per-frame pose VAE: each frame's pose (its features but the last 4)
    through the encoder, the reparameterised latent through the decoder,
    the mean reconstruction loss plus the weighted KL."""

    def __init__(self, encoder=None, decoder=None, loss_recon=None,
                 kl_div_loss_weight=None, init_cfg=None, device=None, **kwargs):
        super().__init__()
        self.device = resolve_device(device)
        self.encoder = build_submodule(encoder)
        self.decoder = build_submodule(decoder)
        self.loss_recon = build_loss(loss_recon)
        self.kl_div_loss_weight = kl_div_loss_weight
        self.to(self.device)

    def _reparameterise(self, mu, logvar, generator, noise):
        if noise is None:
            noise = torch.randn(mu.shape, generator=generator, device=mu.device)
        return mu + torch.exp(logvar / 2) * noise.to(mu)

    def _logs(self, recon, mu, logvar):
        logs = {"recon_loss": recon}
        if self.kl_div_loss_weight is not None:
            logs["kl_div_loss"] = (-0.5 * torch.sum(1 + logvar - mu ** 2 - torch.exp(logvar))
                                   * self.kl_div_loss_weight)
        total = sum(v for k, v in logs.items() if "loss" in k)
        logs["loss"] = total
        return total, logs

    def loss(self, batch, generator=None, noise=None):
        """(total, logs) of a batch (``motion`` [B, T, D]); the latent's
        draw is ``noise`` if given, else from ``generator``."""
        motion = torch.as_tensor(batch["motion"], device=self.device).float()
        B, T = motion.shape[:2]
        pose = motion.reshape(B * T, -1)[:, :-4]
        empty = pose.new_ones(B * T, 0)
        mu, logvar = self.encoder(pose, empty)
        pred = self.decoder(self._reparameterise(mu, logvar, generator, noise), empty)
        return self._logs(self.loss_recon(pred, pose, reduction_override="mean"), mu, logvar)


@ARCHITECTURES.register_module()
class MotionVAE(PoseVAE):
    """Sequence-level motion VAE: the reconstruction loss averaged over the
    valid frames (``motion_mask``)."""

    def loss(self, batch, generator=None, noise=None):
        motion = torch.as_tensor(batch["motion"], device=self.device).float()
        mask = torch.as_tensor(batch["motion_mask"], device=self.device).float()
        mu, logvar = self.encoder(motion, mask)
        pred = self.decoder(self._reparameterise(mu, logvar, generator, noise), mask)
        recon = self.loss_recon(pred, motion, reduction_override="none")
        recon = (recon.mean(-1) * mask).sum() / mask.sum().clamp(min=1e-8)
        return self._logs(recon, mu, logvar)


class InterMotionEncoderModule(nn.Module):
    """InterGen's two-person motion encoder: each person's features but the
    last 4, embedded, behind a query token, post-LN layers; the query's
    feature through ``out_ln`` and ``out`` (512)."""

    def __init__(self, input_dim: int = 258, latent_dim: int = 1024, ff_size: int = 2048,
                 num_layers: int = 8, num_heads: int = 8, dropout: float = 0.1):
        super().__init__()
        self.latent_dim, self.num_layers = latent_dim, num_layers
        self.embed_motion = Linear(2 * (input_dim - 4), latent_dim)
        self.query_token = nn.Parameter(torch.randn(1, latent_dim))
        for i in range(num_layers):
            self.add_module(f"layer_{i}", PostLNEncoderLayer(latent_dim, num_heads, ff_size,
                                                             dropout, "gelu"))
        self.out_ln = LayerNorm(latent_dim)
        self.out = Linear(latent_dim, 512)

    def forward(self, motion, motion_mask):
        B, T = motion.shape[:2]
        x = self.embed_motion(motion.reshape(B, T, 2, -1)[..., :-4].reshape(B, T, -1))
        emb = torch.cat([self.query_token[None].expand(B, 1, self.latent_dim).to(x.dtype), x],
                        dim=1)
        emb = emb + sin_table(T + 1, self.latent_dim, emb)[None]
        mask = torch.cat([torch.ones(B, 1, dtype=torch.bool, device=x.device),
                          motion_mask.to(torch.bool)], dim=1)
        for i in range(self.num_layers):
            emb = getattr(self, f"layer_{i}")(emb, key_mask=mask)
        return self.out(self.out_ln(emb)[:, 0])


class InterTextEncoderModule(nn.Module):
    """CLIP token embeddings (frozen) -> a trainable post-LN transformer ->
    ``text_ln`` -> the end-of-text row through ``out`` (512)."""

    def __init__(self, clip_width: int = 768, ff_size: int = 2048, num_layers: int = 8,
                 vocab_size: int = 49408, context_length: int = 77):
        super().__init__()
        self.num_layers = num_layers
        self.token_embedding = nn.Embedding(vocab_size, clip_width)
        self.positional_embedding = nn.Parameter(torch.randn(context_length, clip_width) * 0.01)
        for i in range(num_layers):
            self.add_module(f"layer_{i}", PostLNEncoderLayer(clip_width, 8, ff_size, 0.1,
                                                             "gelu"))
        self.text_ln = LayerNorm(clip_width)
        self.out = Linear(clip_width, 512)

    def forward(self, text_ids):
        x = (self.token_embedding(text_ids).detach()
             + self.positional_embedding[None, :text_ids.shape[1]])
        for i in range(self.num_layers):
            x = getattr(self, f"layer_{i}")(x)
        x = self.text_ln(x)
        return self.out(x[torch.arange(x.shape[0], device=x.device), text_ids.argmax(dim=-1)])


def _unit(emb):
    return emb / (torch.linalg.vector_norm(emb, dim=-1, keepdim=True) + 1e-12)


@SUBMODULES.register_module()
class InterCLIP(nn.Module):
    """Two-person contrastive evaluator: normalised motion / text embeddings
    scaled by ``latent_scale``."""

    def __init__(self, input_dim=258, latent_dim=1024, ff_size=2048, num_layers=8,
                 num_heads=8, dropout=0.1, activation="gelu", init_cfg=None, seed=0,
                 device=None):
        super().__init__()
        self.device = resolve_device(device)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            self.motion_module = InterMotionEncoderModule(input_dim, latent_dim, ff_size,
                                                          num_layers, num_heads, dropout)
            self.text_module = InterTextEncoderModule(ff_size=ff_size)
        self.latent_scale = 1.0
        self.to(self.device).eval()

    @torch.no_grad()
    def encode_motion(self, motion, motion_length=None, motion_mask=None, **kw):
        emb = self.motion_module(torch.as_tensor(motion, device=self.device).float(),
                                 torch.as_tensor(motion_mask, device=self.device).float())
        return _unit(emb) * self.latent_scale

    @torch.no_grad()
    def encode_text(self, text, token=None, **kw):
        from .tokenizer import tokenize

        ids = torch.as_tensor(np.asarray(tokenize(list(text))), device=self.device,
                              dtype=torch.long)
        return _unit(self.text_module(ids)) * self.latent_scale
