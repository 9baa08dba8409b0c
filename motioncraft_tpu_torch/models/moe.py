"""Mixture-of-Experts layer with Tutel-compatible inference semantics
(PyTorch port of motioncraft_tpu/models/moe.py).

Inference only, through the rank-compact fused dispatch: the kept
(token, k) choices are sorted by expert into groups padded to 512 rows, the
grouped expert FFN runs as kernel K1 (ops/moe_ffn.py) and the arrival ranks
come from kernel K4 (ops/moe_positions.py).  Capacity is Tutel's
``K * int(1.5 * ceil(N / E))``; at inference the ranks follow arrival order
(k-major), so overflow drops the latest arrivals, as the JAX package does.
The gate is applied at combine time and the expert bias b2 enters through a
one-hot [N, E] @ [E, D] product.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.moe_ffn import BLOCK, grouped_ffn
from ..ops.moe_positions import moe_positions_counts


class CosineTopGate(nn.Module):
    """Tutel CosineTopKGate: cosine similarity in a learned 256-d projection,
    scaled by a learned temperature clipped at log(100)."""

    def __init__(self, model_dim: int, num_experts: int, proj_dim: int = 256,
                 init_t: float = 0.5):
        super().__init__()
        self.temperature = nn.Parameter(torch.full((1,), math.log(1.0 / init_t)))
        self.sim_matrix = nn.Parameter(torch.randn(proj_dim, num_experts) * 0.005)
        self.cosine_projector = nn.Linear(model_dim, proj_dim)

    def forward(self, x):
        proj = self.cosine_projector(x.float())
        # norm + 1e-12, not F.normalize (which clamps the norm instead)
        proj = proj / (torch.linalg.vector_norm(proj, dim=-1, keepdim=True) + 1e-12)
        sim = self.sim_matrix / (torch.linalg.vector_norm(
            self.sim_matrix, dim=0, keepdim=True) + 1e-12)
        logit_scale = torch.exp(self.temperature.clamp(max=math.log(100.0)))
        return (proj @ sim) * logit_scale


class MoELayer(nn.Module):
    """Top-k expert FFN layer over flat tokens [N, D] -> [N, D]."""

    def __init__(self, num_experts: int, topk: int, model_dim: int, hidden_dim: int,
                 gate_type: str = "cosine_top", gate_noise: float = 1.0,
                 capacity_factor: float = 1.5, batch_prioritized: bool = True,
                 expert_axis=None):
        super().__init__()
        if gate_type != "cosine_top":
            raise NotImplementedError(f"gate_type {gate_type!r}")
        if expert_axis is not None:
            raise NotImplementedError("expert_axis (expert parallelism)")
        E, D, Fh = num_experts, model_dim, hidden_dim
        self.num_experts, self.topk = E, topk
        self.capacity_factor = capacity_factor
        # gate_noise and batch_prioritized act in training only
        self.gate = CosineTopGate(D, E)
        self.expert_w1 = nn.Parameter(torch.randn(E, D, Fh) / math.sqrt(D))
        self.expert_b1 = nn.Parameter(torch.zeros(E, Fh))
        self.expert_w2 = nn.Parameter(torch.randn(E, Fh, D) / math.sqrt(Fh))
        self.expert_b2 = nn.Parameter(torch.zeros(E, D))

    def forward(self, x):
        N, D = x.shape
        E, K = self.num_experts, self.topk
        logits = self.gate(x)                                      # f32 [N, E]
        # experts ranked by logit (softmax keeps the order), lower index first
        # on equal logits: the routing is a function of the logits alone, so
        # devices that agree on the logits route alike (a topk over softmax
        # scores can break a rounding tie one way on the CPU, another on the card)
        topk_idx = torch.sort(logits, dim=1, descending=True, stable=True).indices[:, :K]
        topk_scores = logits.softmax(dim=1).gather(1, topk_idx)    # [N, K]
        gates = topk_scores / (topk_scores.sum(dim=1, keepdim=True) + 1e-9)

        capacity = K * int(self.capacity_factor * ((N + E - 1) // E))
        capacity = max(1, min(capacity, N))
        flat_idx = topk_idx.t().reshape(-1).to(torch.int32)        # k-major [K*N]
        pos_flat, counts = moe_positions_counts(flat_idx, E)
        positions = pos_flat.reshape(K, N).t().long()              # [N, K]
        valid = positions < capacity
        gates = gates * valid.to(gates.dtype)

        fill = counts.long().clamp(max=capacity)                   # [E]
        fill_aligned = (fill + BLOCK - 1) // BLOCK * BLOCK
        M = (N * K + BLOCK - 1) // BLOCK * BLOCK + E * BLOCK       # static bound
        ends = torch.cumsum(fill_aligned, dim=0)
        offset = ends - fill_aligned
        rank = offset[topk_idx] + positions                        # [N, K]
        r = torch.where(valid, rank, torch.full_like(rank, M))     # dropped -> dump row
        token_ids = torch.arange(N, device=x.device).repeat_interleave(K)
        token_for_rank = torch.zeros(M + 1, dtype=torch.long, device=x.device)
        token_for_rank[r.reshape(-1)] = token_ids
        xs = x[token_for_rank[:M]]                                 # [M, D] expert-sorted

        nb = M // BLOCK
        starts = torch.arange(nb, device=x.device) * BLOCK
        block_expert = torch.searchsorted(ends, starts, right=True).clamp(
            max=E - 1).to(torch.int32)
        ye = grouped_ffn(block_expert, xs, self.expert_w1, self.expert_b1,
                         self.expert_w2)
        ye = torch.cat([ye, ye.new_zeros(1, D)], dim=0)
        y = gates[:, 0, None] * ye[r[:, 0]]
        for k in range(1, K):
            y = y + gates[:, k, None] * ye[r[:, k]]
        ge = torch.einsum("nk,nke->ne", gates, F.one_hot(topk_idx, E).to(gates.dtype))
        return y + ge @ self.expert_b2


class MOE(nn.Module):
    """The reference's MOE wrapper: learned positional embedding per
    (sequence position, head), the MoE layer, GELU, output projection."""

    def __init__(self, num_experts: int, topk: int, input_dim: int, ffn_dim: int,
                 output_dim: int, num_heads: int, max_seq_len: int,
                 gate_type: str = "cosine_top", gate_noise: float = 1.0,
                 expert_axis=None):
        super().__init__()
        self.embedding = nn.Parameter(torch.randn(1, max_seq_len, num_heads, input_dim))
        self.model = MoELayer(num_experts, topk, input_dim, ffn_dim,
                              gate_type=gate_type, gate_noise=gate_noise,
                              expert_axis=expert_axis)
        self.proj = nn.Linear(input_dim, output_dim)

    def forward(self, x):
        B, T, H, D = x.shape
        y = self.model((x + self.embedding[:, :T]).reshape(-1, D))
        return self.proj(F.gelu(y)).reshape(B, T, H, -1)
