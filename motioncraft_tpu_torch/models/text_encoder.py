"""CLIP ViT-B/32 text tower + the finetuned post-LN transformer (PyTorch port
of motioncraft_tpu/models/text_encoder.py).

Token and positional embeddings, pre-LN blocks with QuickGELU under a causal
mask, ln_final; then a pre-projection to the text latent width, two post-LN
encoder layers (torch nn.TransformerEncoderLayer semantics, exact-erf GELU)
and a LayerNorm.  The attention is written out (einsum + softmax) as in the
JAX package, so both compute the same sums.  CLIP is frozen: it runs under
``torch.no_grad()`` (the JAX package's ``stop_gradient``) and training leaves
its parameters out of the optimizer (parallel/train_state.py); the two
post-LN layers train, with dropout (``dropout``: its masks drawn from the
training step's generator, so a seed fixes a run).  Under bf16-cast
weights the whole tower runs in bf16 (the causal mask in the activations'
dtype), as in the JAX package.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.dist_utils import tp_copy, tp_reduce
from .blocks import LayerNorm, Linear, dropout, row_parallel, tensor_comm


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


class ClipAttention(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj = Linear(width, 3 * width)
        self.out_proj = Linear(width, width)

    def forward(self, x, mask=None, key_mask=None):
        """``mask``: an additive [.., T, T] mask; ``key_mask``: [B, T] bool,
        True where a key may be attended to."""
        B, T, C = x.shape
        qkv = self.in_proj(x).reshape(B, T, 3, self.heads, C // self.heads)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        attn = torch.einsum("bqhd,bkhd->bhqk", q * (C // self.heads) ** -0.5, k)
        if mask is not None:
            attn = attn + mask
        if key_mask is not None:
            attn = attn.masked_fill(~key_mask[:, None, None, :], -1e9)
        y = torch.einsum("bhqk,bkhd->bqhd", attn.softmax(dim=-1), v).reshape(B, T, C)
        return self.out_proj(y)


class ClipBlock(nn.Module):
    mesh = None  # the mesh it computes over (parallel/mesh.py:attach_mesh)

    def __init__(self, width: int, heads: int):
        super().__init__()
        self.attn = ClipAttention(width, heads)
        self.ln_1 = LayerNorm(width)
        self.ln_2 = LayerNorm(width)
        self.mlp_fc = Linear(width, 4 * width)
        self.mlp_proj = Linear(4 * width, width)

    def forward(self, x, mask=None):
        """``mlp_fc`` column- and ``mlp_proj`` row-parallel where the tensor
        group splits them (parallel/tp.py)."""
        x = x + self.attn(self.ln_1(x), mask)
        comm = tensor_comm(self, self.mlp_fc, "weight", 0)
        h = quick_gelu(self.mlp_fc(tp_copy(self.ln_2(x), comm)))
        return x + row_parallel(self.mlp_proj, h, comm)


def eot_rows(x, text_ids):
    """The rows of ``x`` [B, T, C] at each sequence's end-of-text token
    (the largest token id, its first occurrence, as CLIP pools)."""
    return x[torch.arange(x.shape[0], device=x.device), text_ids.argmax(dim=-1)]


class ClipTextModel(nn.Module):
    """OpenAI CLIP text transformer (ViT-B/32: 512 wide, 12 layers, 8 heads,
    context 77, causal mask); returns the ln_final features [B, 77, width],
    or with ``return_pooled`` CLIP's ``encode_text``: the end-of-text row
    times ``text_projection`` [width, embed_dim] (a model that pools passes
    ``embed_dim``, which makes that parameter)."""

    mesh = None  # the mesh it computes over (parallel/mesh.py:attach_mesh)

    def __init__(self, vocab_size: int = 49408, context_length: int = 77,
                 width: int = 512, layers: int = 12, heads: int = 8,
                 embed_dim: Optional[int] = None):
        super().__init__()
        self.layers = layers
        self.token_embedding = nn.Embedding(vocab_size, width)
        self.positional_embedding = nn.Parameter(torch.randn(context_length, width) * 0.01)
        for i in range(layers):
            self.add_module(f"resblock_{i}", ClipBlock(width, heads))
        self.ln_final = LayerNorm(width)
        self.text_projection = (None if embed_dim is None else
                                nn.Parameter(torch.randn(width, embed_dim) * 0.02))

    def forward(self, text_ids, return_pooled: bool = False):
        T = text_ids.shape[1]
        x = self.embed(text_ids) + self.positional_embedding[None, :T]
        causal = torch.full((T, T), float("-inf"), dtype=x.dtype,
                            device=x.device).triu(1)[None, None]
        for i in range(self.layers):
            x = getattr(self, f"resblock_{i}")(x, causal)
        x = self.ln_final(x)
        if return_pooled:
            return eot_rows(x, text_ids) @ self.text_projection
        return x


    def embed(self, text_ids):
        """The token embedding; with its rows split over the tensor group
        (parallel/tp.py) each rank looks up the ids of its rows, zeros for
        the others, and the group sums."""
        comm = tensor_comm(self, self.token_embedding, "weight", 0)
        if comm is None:
            return self.token_embedding(text_ids)
        weight = self.token_embedding.weight
        rows = weight.shape[0]
        local = text_ids - comm.rank * rows
        mine = (local >= 0) & (local < rows)
        x = F.embedding(local.clamp(0, rows - 1), weight) * mine[..., None].to(weight.dtype)
        return tp_reduce(x, comm)


class PostLNEncoderLayer(nn.Module):
    """torch nn.TransformerEncoderLayer semantics (post-LN, full attention)."""

    mesh = None  # the data mesh of training (parallel/mesh.py:attach_mesh)

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int = 2048,
                 dropout: float = 0.0, activation: str = "gelu"):
        super().__init__()
        if activation not in ("gelu", "relu"):
            raise NotImplementedError(f"activation {activation!r}")
        self.act = F.gelu if activation == "gelu" else F.relu
        self.dropout = dropout
        self.self_attn = ClipAttention(d_model, nhead)
        self.norm1 = LayerNorm(d_model)
        self.linear1 = Linear(d_model, dim_feedforward)
        self.linear2 = Linear(dim_feedforward, d_model)
        self.norm2 = LayerNorm(d_model)

    def forward(self, x, key_mask=None, generator=None):
        """In training, the three dropouts draw their masks from
        ``generator``."""
        p, train, g, mesh = self.dropout, self.training, generator, self.mesh
        x = self.norm1(x + dropout(self.self_attn(x, key_mask=key_mask), p, train, g, mesh))
        comm = tensor_comm(self, self.linear1, "weight", 0)
        h = dropout(self.act(self.linear1(tp_copy(x, comm))), p, train, g, mesh, split=comm)
        h = row_parallel(self.linear2, h, comm)
        return self.norm2(x + dropout(h, p, train, g, mesh))


class TextEncoder(nn.Module):
    """CLIP (frozen) -> pre-projection -> finetuned transformer -> LayerNorm;
    returns xf_out [B, 77, latent_dim], and with ``use_text_proj``
    (xf_proj, xf_out): xf_proj [B, time_embed_dim] the ``text_proj`` Linear
    of xf_out's end-of-text row, which the denoiser adds to its time
    embedding."""

    def __init__(self, latent_dim: int = 256, num_layers: int = 2, ff_size: int = 2048,
                 num_heads: int = 4, dropout: float = 0.0, activation: str = "gelu",
                 use_text_proj: bool = False, time_embed_dim: int = 2048,
                 clip_width: int = 512, clip_layers: int = 12):
        super().__init__()
        self.num_layers = num_layers
        self.clip = ClipTextModel(width=clip_width, layers=clip_layers,
                                  heads=max(1, clip_width // 64))
        self.text_pre_proj = (Linear(clip_width, latent_dim)
                              if latent_dim != clip_width else None)
        for i in range(num_layers):
            self.add_module(f"textTransEncoder_{i}", PostLNEncoderLayer(
                latent_dim, num_heads, ff_size, dropout, activation))
        self.text_ln = LayerNorm(latent_dim)
        self.text_proj = Linear(latent_dim, time_embed_dim) if use_text_proj else None

    def forward(self, text_ids, generator=None):
        with torch.no_grad():
            x = self.clip(text_ids)
        if self.text_pre_proj is not None:
            x = self.text_pre_proj(x)
        for i in range(self.num_layers):
            x = getattr(self, f"textTransEncoder_{i}")(x, generator=generator)
        xf_out = self.text_ln(x)
        if self.text_proj is None:
            return xf_out
        return self.text_proj(eot_rows(xf_out, text_ids)), xf_out
