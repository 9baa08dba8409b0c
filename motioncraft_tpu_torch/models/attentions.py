"""STMA, MotionCraft's spatio-temporal MoE attention, and the linear
self-attention of its dynamic body graph (PyTorch port of the ``STMA`` and
``EfficientSelfAttention`` modules of motioncraft_tpu/models/attentions.py).

STMA: per-head body-part features -> MoE projections of text (2L lanes:
key, value) and motion (4L lanes: body value, key, value, query); static
body graph = learned softmax(H x H) mix of per-part values; dynamic body
graph = linear self-attention across the H part tokens of each frame; global
linear attention over the joint text + motion sequence, through kernel K3
(ops/stma_attention.py).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.stma_attention import NEG_INF, stma_linear_attention
from ..registry import ATTENTIONS
from .blocks import LayerNorm, StylizationBlock
from .moe import MOE


@ATTENTIONS.register_module()
class EfficientSelfAttention(nn.Module):
    """MotionDiffuse linear self-attention.  The JAX package's
    ``merged_lanes`` form (softmax in the [.., D] layout, one [D, D] product
    masked to the block diagonal) is a TPU layout of the same function; here
    the per-head products compute it directly."""

    def __init__(self, latent_dim: int, num_heads: int, dropout: float = 0.0,
                 time_embed_dim=None, merged_lanes: bool = False):
        super().__init__()
        if not merged_lanes:
            raise NotImplementedError("EfficientSelfAttention without merged_lanes "
                                      "(the generic linear-attention kernel path)")
        if time_embed_dim is not None:
            raise NotImplementedError("EfficientSelfAttention with time conditioning")
        self.num_heads = num_heads
        self.norm = LayerNorm(latent_dim)
        self.query = nn.Linear(latent_dim, latent_dim)
        self.key = nn.Linear(latent_dim, latent_dim)
        self.value = nn.Linear(latent_dim, latent_dim)

    def forward(self, x, src_mask):
        B, T, D = x.shape
        H = self.num_heads
        xn = self.norm(x)
        q = self.query(xn).reshape(B, T, H, -1).softmax(dim=-1)
        k = (self.key(xn) + (1 - src_mask) * NEG_INF).softmax(dim=1).reshape(B, T, H, -1)
        v = (self.value(xn) * src_mask).reshape(B, T, H, -1)
        att = torch.einsum("bnhd,bnhl->bhdl", k, v)
        return x + torch.einsum("bthd,bhdl->bthl", q, att).reshape(B, T, D)


@ATTENTIONS.register_module()
class STMA(nn.Module):
    """MotionCraft MC-Attn, inference only."""

    def __init__(self, latent_dim: int, text_latent_dim: int, num_heads: int,
                 num_text_heads: int, num_experts: int, topk: int,
                 gate_type: str = "cosine_top", gate_noise: float = 1.0,
                 ffn_dim: int = 512, time_embed_dim: int = 2048,
                 max_seq_len: int = 196, max_text_seq_len: int = 77,
                 temporal_comb: bool = False, dropout: float = 0.0,
                 static_body: bool = True, dynamic_body: bool = False,
                 patch_size: int = 1, expert_axis=None):
        super().__init__()
        if patch_size != 1:
            raise NotImplementedError("STMA with patch_size > 1")
        if num_text_heads != 1:
            raise NotImplementedError("STMA with more than one text head")
        L, H = latent_dim, num_heads
        self.latent_dim, self.num_heads = L, H
        self.num_text_heads = num_text_heads
        self.static_body, self.dynamic_body = static_body, dynamic_body
        self.norm = LayerNorm(L)
        self.text_norm = LayerNorm(text_latent_dim)
        self.text_moe = MOE(num_experts, topk, text_latent_dim, text_latent_dim * 4,
                            2 * L, num_text_heads, max_text_seq_len, gate_type,
                            gate_noise, expert_axis=expert_axis)
        self.motion_moe = MOE(num_experts, topk, L, L * 4, 4 * L, H, max_seq_len,
                              gate_type, gate_noise, expert_axis=expert_axis)
        self.body_weight = nn.Parameter(torch.randn(H, H))
        if dynamic_body:
            self.body_d_attn = EfficientSelfAttention(L, 8, dropout, time_embed_dim=None,
                                                      merged_lanes=True)
        self.proj_out = StylizationBlock(H * L, time_embed_dim, dropout)

    def text_branch(self, xf):
        """LayerNorm + text MoE of the text features: depends only on ``xf``,
        so the caller computes it once per sampling call
        (STMoGenTransformer.precompute_text_feats)."""
        text_in = xf.reshape(xf.shape[0], xf.shape[1], self.num_text_heads, -1)
        return self.text_moe(self.text_norm(text_in))

    def forward(self, x, xf=None, emb=None, src_mask=None, cond_type=None,
                cfg_dedup: bool = False, text_feat=None):
        B, T, D = x.shape
        H, L = self.num_heads, self.latent_dim
        # CFG layer-0 dedup: the two batch halves are the same x/xf/emb, so the
        # motion MoE and the body graph run on the first half and are tiled
        dedup = cfg_dedup and B % 2 == 0 and B > 1
        Bc = B // 2 if dedup else B
        xh = x.reshape(B, T, H, L)
        if text_feat is None:
            text_feat = self.text_branch(xf)
        motion_feat = self.motion_moe(self.norm(xh[:Bc]))

        body_value = motion_feat[..., :L]
        body_feat = body_value
        if self.static_body:
            body_feat = torch.einsum("hl,bnld->bnhd", self.body_weight.softmax(dim=1),
                                     body_value)
        body_feat = body_feat.reshape(Bc, T, D)
        if self.dynamic_body:
            d_in = body_value.reshape(Bc * T, H, L)
            d_mask = torch.ones(Bc * T, H, 1, dtype=x.dtype, device=x.device)
            body_feat = body_feat + self.body_d_attn(d_in, d_mask).reshape(Bc, T, D)
        if dedup:
            motion_feat = torch.cat([motion_feat, motion_feat], dim=0)
            body_feat = torch.cat([body_feat, body_feat], dim=0)

        text_cond = ((cond_type % 10) > 0).to(x.dtype).reshape(B, 1, 1)
        y_t = stma_linear_attention(motion_feat, text_feat.reshape(B, -1, 2 * L),
                                    src_mask.reshape(B, T, 1), text_cond)
        return x + self.proj_out(body_feat + y_t.reshape(B, T, D), emb)
