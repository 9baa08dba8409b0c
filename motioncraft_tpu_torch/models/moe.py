"""Mixture-of-Experts layer with Tutel-compatible semantics (PyTorch port
of motioncraft_tpu/models/moe.py).

Inference (``eval()``) takes the rank-compact fused dispatch: the kept
(token, k) choices are sorted by expert into groups padded to 512 rows, the
grouped expert FFN runs as kernel K1 (ops/moe_ffn.py), and the whole routing
from the gate logits (top-k, gates, arrival ranks, drops, dispatch tables)
is one call of kernel K4's route mode (ops/moe_positions.py:moe_route).  The
gate is applied at combine time and the expert bias b2 enters through the
[N, E] masked gates @ [E, D].

Training (``train()``) takes the slot-buffer dispatch of the JAX package's
training path: gate noise on the logits, slots assigned in batch-prioritized
order (descending top-1 score, a stable sort), each kept (token, k) written
into an [E, capacity, D] buffer, the expert FFN run over the buffers as
kernel K6 (ops/expert_ffn.py), and Tutel's load-importance aux loss.

Under bf16 training (apis/train.py:make_train_step(fp16=)) the gate still
computes f32 logits (its projector promotes the input), so the noise, the
scores and the expert ranking are f32 as in f32 training; the slot buffer
is in the MoE input's dtype: the text MoEs' bf16 slots meet the bf16
expert weights in K6's bf16 instantiation, the motion MoEs' f32 slots meet
the weights widened to f32 (exact) in the f32 K6, and the combine runs in
that dtype, the gates cast to it, as the JAX package's einsums promote.

Capacity is Tutel's ``K * int(1.5 * ceil(N / E))``; a choice ranked at or
past it is dropped (gate 0).  Under bf16 inference the gate still computes
its logits in f32 (its projector promoted to f32), the expert FFN runs in
bf16 (K1's bf16 instantiation) and the combine in bf16, the gates and b2
cast to it, as the JAX package does.  In both modes experts are ranked by logit, the
lower index first on equal logits (a stable sort; on the card in inference,
K4's route picks them in that order).

Int8 expert weights (ops/quant.py), inference only: W8 dequantizes them to
the activations' dtype and keeps the path above (K4, then K1); W8A8 routes
with K4 as ever, then fills a slot buffer [E, C, D] on the device from the
route's tables (C, the capacity, is static: nothing is read back to the
host) and runs the int8 expert pair ``expert_ffn_q`` over it, b2 inside, as
the JAX package's W8A8 takes its slot path; K1 does not run.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.expert_ffn import fused_expert_ffn
from ..ops.moe_ffn import BLOCK, grouped_ffn
from ..ops.moe_positions import moe_positions_counts, moe_route
from ..ops.quant import dequant, expert_ffn_q
from .blocks import Linear, promote_dtype


def draw_gate_noise(logits, generator):
    """The training gate noise: a standard-normal draw of the logits' shape
    and dtype from ``generator``, as the JAX package draws it in the
    logits' dtype."""
    return torch.randn(logits.shape, generator=generator, device=logits.device,
                       dtype=logits.dtype)


def _normal_cdf(x, sigma):
    return 0.5 * (1.0 + torch.erf(x / (sigma * math.sqrt(2.0))))


def load_importance_loss(scores_wo_noise, topk_noisy_scores, num_experts: int,
                         gate_noise: float):
    """Tutel's is_gshard_loss=False aux loss: mean of the squared
    coefficients of variation of the (soft) importance and the
    (noise-smoothed) load of the experts."""
    imp = scores_wo_noise.sum(dim=0)
    l_imp = imp.var(correction=0) / (imp.mean() ** 2 + 1e-10)
    if gate_noise > 0:
        threshold = topk_noisy_scores[:, -1:]
        prob = _normal_cdf(scores_wo_noise - threshold, gate_noise / num_experts)
        load = prob.sum(dim=0)
        l_load = load.var(correction=0) / (load.mean() ** 2 + 1e-10)
        return (l_imp + l_load) / 2.0
    return l_imp


class CosineTopGate(nn.Module):
    """Tutel CosineTopKGate: cosine similarity in a learned 256-d projection,
    scaled by a learned temperature clipped at log(100)."""

    def __init__(self, model_dim: int, num_experts: int, proj_dim: int = 256,
                 init_t: float = 0.5):
        super().__init__()
        self.temperature = nn.Parameter(torch.full((1,), math.log(1.0 / init_t)))
        self.sim_matrix = nn.Parameter(torch.randn(proj_dim, num_experts) * 0.005)
        self.cosine_projector = Linear(model_dim, proj_dim)

    def forward(self, x):
        """f32 logits [N, E] whatever the dtype of ``x`` and the weights:
        the projection runs in f32; the expert similarity and the scale are
        computed in the weights' dtype and then widened, as flax does."""
        proj = self.cosine_projector(x.float())
        # norm + 1e-12, not F.normalize (which clamps the norm instead)
        proj = proj / (torch.linalg.vector_norm(proj, dim=-1, keepdim=True) + 1e-12)
        sim = self.sim_matrix / (torch.linalg.vector_norm(
            self.sim_matrix, dim=0, keepdim=True) + 1e-12)
        logit_scale = torch.exp(self.temperature.clamp(max=math.log(100.0)))
        return (proj @ sim.float()) * logit_scale.float()


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
        self.gate_noise, self.batch_prioritized = gate_noise, batch_prioritized
        self.gate = CosineTopGate(D, E)
        self.expert_w1 = nn.Parameter(torch.randn(E, D, Fh) / math.sqrt(D))
        self.expert_b1 = nn.Parameter(torch.zeros(E, Fh))
        self.expert_w2 = nn.Parameter(torch.randn(E, Fh, D) / math.sqrt(Fh))
        self.expert_b2 = nn.Parameter(torch.zeros(E, D))

    def capacity(self, N: int) -> int:
        E, K = self.num_experts, self.topk
        return max(1, min(K * int(self.capacity_factor * ((N + E - 1) // E)), N))

    def forward(self, x, generator=None, noise=None, aux_losses=None):
        """x [N, D] -> [N, D].  In training, the gate noise is ``noise``
        (a standard-normal [N, E] draw) if given, else drawn from
        ``generator``, and the aux loss is appended to ``aux_losses``."""
        if self.training:
            return self._forward_slots(x, generator, noise, aux_losses)
        D = x.shape[1]
        logits = self.gate(x)                                      # f32 [N, E]
        route = moe_route(logits, self.topk, self.capacity(x.shape[0]), BLOCK)
        w1, w2 = self.expert_w1, self.expert_w2
        if w1.dtype == torch.int8:
            if not hasattr(self, "expert_w1_wscale"):
                return self._forward_slots_int8(x, route)
            w1 = dequant(w1, self.expert_w1_wscale, x.dtype)
            w2 = dequant(w2, self.expert_w2_wscale, x.dtype)
        xs = x.index_select(0, route.token_for_rank)               # [M, D] expert-sorted
        ye = grouped_ffn(route.block_expert, xs, w1, self.expert_b1, w2)
        ye = torch.cat([ye, ye.new_zeros(1, D)], dim=0)            # row M: dropped choices
        gates, r = route.gates.to(x.dtype), route.r
        y = gates[:, 0, None] * ye.index_select(0, r[:, 0])
        for k in range(1, self.topk):
            y = y + gates[:, k, None] * ye.index_select(0, r[:, k])
        return y + route.ge.to(x.dtype) @ self.expert_b2.to(x.dtype)

    def _forward_slots_int8(self, x, route):
        """W8A8: the route's kept choices into an [E, C, D] slot buffer
        (slot e * C + the choice's rank within its expert; dropped choices
        to a dump row past the end), the int8 expert pair over it, and the
        gate-weighted combine."""
        N, D = x.shape
        E, C = self.num_experts, self.capacity(N)
        M = route.token_for_rank.shape[0]
        r = route.r.long()                                          # [N, K], M where dropped
        valid = r < M
        fill = route.counts.long().clamp(max=C)
        aligned = (fill + BLOCK - 1) // BLOCK * BLOCK
        offset = torch.cumsum(aligned, dim=0) - aligned             # each expert's first row
        rows = torch.where(valid, r, torch.zeros_like(r))
        e = route.block_expert.long()[rows // BLOCK]
        dump = E * C
        slots = torch.where(valid, e * C + rows - offset[e], torch.full_like(r, dump))
        token_for_slot = torch.zeros(dump + 1, dtype=torch.long, device=x.device)
        token_for_slot[slots.reshape(-1)] = torch.arange(
            N, device=x.device).repeat_interleave(self.topk)
        filled = torch.zeros(dump + 1, dtype=torch.bool, device=x.device)
        filled[slots.reshape(-1)] = True
        xe = torch.where(filled[:dump, None], x.index_select(0, token_for_slot[:dump]),
                         x.new_zeros(()))
        ye = expert_ffn_q(xe.reshape(E, C, D), self.expert_w1, self.expert_w1_scale,
                          self.expert_b1, self.expert_w2, self.expert_w2_scale, self.expert_b2)
        ye = torch.cat([ye.reshape(dump, D), ye.new_zeros(1, D)], dim=0)
        gates = route.gates.to(x.dtype)
        y = gates[:, 0, None] * ye.index_select(0, slots[:, 0])
        for k in range(1, self.topk):
            y = y + gates[:, k, None] * ye.index_select(0, slots[:, k])
        return y

    def _forward_slots(self, x, generator, noise, aux_losses):
        N, D = x.shape
        E, K = self.num_experts, self.topk
        logits = self.gate(x)                                      # f32 [N, E]
        noisy = logits
        if self.gate_noise > 0:
            if noise is None:
                noise = draw_gate_noise(logits, generator)
            noisy = logits + self.gate_noise * noise / E
        scores = noisy.softmax(dim=1)
        topk_idx = torch.sort(noisy, dim=1, descending=True, stable=True).indices[:, :K]
        topk_scores = scores.gather(1, topk_idx)                   # [N, K]
        gates = topk_scores / (topk_scores.sum(dim=1, keepdim=True) + 1e-9)

        # slot ranks in batch-prioritized order: tokens by descending top-1
        # score, ties (padded frames give identical tokens) in token order
        capacity = self.capacity(N)
        order = None
        idx_for_rank = topk_idx
        if self.batch_prioritized:
            order = torch.sort(-topk_scores[:, 0].detach(), stable=True).indices
            idx_for_rank = topk_idx[order]
        pos_flat, _ = moe_positions_counts(idx_for_rank.t().reshape(-1).to(torch.int32), E)
        positions = pos_flat.reshape(K, N).t().long()              # [N, K]
        if order is not None:
            positions = torch.empty_like(positions).index_copy_(0, order, positions)
        valid = positions < capacity
        gates = gates * valid.to(gates.dtype)

        # each kept (token, k) fills slot e * capacity + position of the flat
        # [E * capacity] buffer; dropped ones go to a dump row past its end
        dump = E * capacity
        slots = torch.where(valid, topk_idx * capacity + positions,
                            torch.full_like(positions, dump))
        token_for_slot = torch.zeros(dump + 1, dtype=torch.long, device=x.device)
        token_for_slot[slots.reshape(-1)] = torch.arange(N, device=x.device).repeat_interleave(K)
        filled = torch.zeros(dump + 1, dtype=torch.bool, device=x.device)
        filled[slots.reshape(-1)] = True
        # index_select, not x[...]: its backward is an index_add with atomics,
        # where advanced indexing's sorts the indices and serializes over the
        # empty slots' duplicates of token 0
        xe = torch.where(filled[:dump, None], x.index_select(0, token_for_slot[:dump]), 0.0)
        # bf16 slots meet bf16 weights in K6's bf16 instantiation; f32 slots
        # meet them widened (exact), as the reference's einsums promote
        ye = fused_expert_ffn(*promote_dtype(xe.reshape(E, capacity, D), self.expert_w1,
                                             self.expert_b1, self.expert_w2, self.expert_b2))
        ye = torch.cat([ye.reshape(dump, D), ye.new_zeros(1, D)], dim=0)
        picked = ye.index_select(0, slots.reshape(-1)).reshape(N, K, D)
        y = torch.einsum("nk,nkd->nd", gates.to(picked.dtype), picked)
        if aux_losses is not None:
            aux_losses.append(load_importance_loss(logits.softmax(dim=1), topk_scores, E,
                                                   self.gate_noise))
        return y


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
        self.proj = Linear(input_dim, output_dim)

    def forward(self, x, generator=None, aux_losses=None):
        B, T, H, D = x.shape
        y = self.model((x + self.embedding[:, :T]).reshape(-1, D), generator=generator,
                       aux_losses=aux_losses)
        return self.proj(F.gelu(y)).reshape(B, T, H, -1)
