"""Shared neural blocks (PyTorch port of motioncraft_tpu/models/blocks.py).

  - LayerNorm: torch's, eps 1e-5 (the reference's nn.LayerNorm)
  - timestep_embedding: sinusoidal, cos first then sin
  - ZeroDense / StylizationBlock: AdaLN-style time conditioning
  - SFFN: the per-head (body-part) FFN, through kernel K2 (ops/sffn.py) at
    inference; in training the plain einsum pair with dropout, as the JAX
    package trains it

Module and parameter names follow the flax modules, so a flax ``params``
tree maps onto the ``state_dict`` by name (utils/convert.py).  GELU is the
exact erf form everywhere.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.sffn import head_ffn

LayerNorm = nn.LayerNorm  # eps defaults to 1e-5, as the reference


def timestep_embedding(timesteps: torch.Tensor, dim: int,
                       max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal timestep embedding; cos first then sin, as the reference."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=timesteps.device)
                      / half)
    args = timesteps[:, None].to(torch.float32) * freqs[None]
    embedding = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        embedding = torch.cat([embedding, torch.zeros_like(embedding[:, :1])], dim=-1)
    return embedding


class ZeroDense(nn.Module):
    """Linear with zero-initialised weight and bias (zero_module semantics)."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.linear = nn.Linear(in_features, features)
        nn.init.zeros_(self.linear.weight)
        nn.init.zeros_(self.linear.bias)

    def forward(self, x):
        return self.linear(x)


class StylizationBlock(nn.Module):
    """AdaLN conditioning: time-emb -> (scale, shift); zero-init output."""

    def __init__(self, latent_dim: int, time_embed_dim: int, dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.emb_layers = nn.Linear(time_embed_dim, 2 * latent_dim)
        self.norm = LayerNorm(latent_dim)
        self.out_layers = ZeroDense(latent_dim, latent_dim)

    def forward(self, h, emb):
        emb_out = self.emb_layers(F.silu(emb))[:, None, :]
        scale, shift = emb_out.chunk(2, dim=-1)
        h = self.norm(h) * (1 + scale) + shift
        return self.out_layers(F.dropout(F.silu(h), self.dropout, self.training))


class SFFN(nn.Module):
    """Per-body-part (per-head) FFN over the concatenated head layout, with
    the stacked [H, d, f] weights of the flax module; the FFN pair runs as
    kernel K2 (ops/sffn.py) on the card."""

    def __init__(self, latent_dim: int, ffn_dim: int, num_heads: int,
                 dropout: float = 0.0, time_embed_dim: int = 2048):
        super().__init__()
        H, d, f = num_heads, latent_dim, ffn_dim
        self.num_heads, self.dropout = H, dropout
        self.w1 = nn.Parameter(torch.randn(H, d, f) / math.sqrt(d))
        self.b1 = nn.Parameter(torch.zeros(H, f))
        self.w2 = nn.Parameter(torch.randn(H, f, d) / math.sqrt(f))
        self.b2 = nn.Parameter(torch.zeros(H, d))
        self.proj_out = StylizationBlock(H * d, time_embed_dim, dropout)

    def forward(self, x, emb):
        B, T, D = x.shape
        if self.training:
            y = torch.einsum("bthd,hdf->bthf", x.reshape(B, T, self.num_heads, -1),
                             self.w1) + self.b1
            y = F.dropout(F.gelu(y), self.dropout, self.training)
            y = (torch.einsum("bthf,hfd->bthd", y, self.w2) + self.b2).reshape(B, T, D)
        else:
            y = head_ffn(x.reshape(B * T, D), self.w1, self.b1, self.w2,
                         self.b2).reshape(B, T, D)
        return x + self.proj_out(y, emb)
