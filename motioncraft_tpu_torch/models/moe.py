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

On a data mesh (parallel/mesh.py, attached by ``make_train_step(mesh=)``) the
training routing runs over the global batch, as the JAX package's
sharded step computes it: the gate noise is drawn at the global token
count and each rank keeps its rows; the per-token top-1 score and top-k
experts [N, 1 + K] are all-gathered, so that every rank sorts the global
list in batch-prioritized order and runs K4's positions over it as one
process would, the capacity that of the global token count, and keeps
its tokens' positions; the aux loss takes the importance and load sums
over the ranks (a differentiable all-reduce, the variance after the
sum).  K6 then runs on this rank's slot buffer: its kept tokens at their
global positions, the other ranks' slots empty.

The model across ranks (parallel/tp.py:shard_module_ cuts the weights, the
layer reads which dims are split from its ``shard_specs``):

- Experts over an ``expert`` group of X ranks (``expert_w1/b1/w2/b2`` of
  experts ``[j * E / X, (j + 1) * E / X)`` on rank j): each rank fills its
  [E, C, D] slot buffer (its tokens at their global positions), the
  buffers cross the group by one all-to-all (each rank sums the chunks of
  its experts, whose slots are disjoint), K6 runs on the local [E / X, C,
  D] and the results return by another all-to-all; the backward is the
  same two exchanges.  The routing stays global (above), the aux loss
  global, and each expert's gradient is reduced over the ranks that hold
  it (utils/dist_utils.py:allreduce_grads).
- The hidden dim over a ``tensor`` group (Megatron): the slot buffer is
  built from ``tp_copy(x)`` (the gradient summed over the group), K6 / K1
  run on this rank's slice of F with b2 zeros, the partial outputs are
  summed (``tp_reduce``) and b2 is added once.
- Inference with an expert axis (``expert_axis``, or experts split over a
  mesh) takes the slot path, as the JAX package does: K4's route, then
  K6 over the slot buffers, b2 inside, not K1.  On a mesh of several
  row-ranks (a sampling call over ``apis/test.py:mesh_sample``, the mesh
  server) the gate logits are all-gathered into the global token list
  (``parallel/mesh.py:gather_tokens``: the CFG halves are blocks of each
  rank's rows) and K4 routes the whole dispatch as one process would;
  each rank then runs its tokens (K1 over the route's rows, the other
  ranks' rows zero, or its slots).

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
from ..parallel.mesh import ACROSS_CARDS, draw_rows, gather_tokens, token_blocks, token_rows
from ..parallel.tp import split_axis
from ..utils.dist_utils import (all_gather_rows, all_reduce_sum, all_to_all, tp_copy,
                                tp_reduce)
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
                         gate_noise: float, mesh=None):
    """Tutel's is_gshard_loss=False aux loss: mean of the squared
    coefficients of variation of the (soft) importance and the
    (noise-smoothed) load of the experts; on a data mesh the importance
    and the load are summed over the ranks' tokens first."""
    imp = all_reduce_sum(scores_wo_noise.sum(dim=0), mesh)
    l_imp = imp.var(correction=0) / (imp.mean() ** 2 + 1e-10)
    if gate_noise > 0:
        threshold = topk_noisy_scores[:, -1:]
        prob = _normal_cdf(scores_wo_noise - threshold, gate_noise / num_experts)
        load = all_reduce_sum(prob.sum(dim=0), mesh)
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


class LinearTopGate(nn.Module):
    """Tutel's LinearTopKGate: a bias-free Linear (``wg``) to the E logits,
    computed in f32 whatever the dtype of ``x``, as flax promotes it."""

    def __init__(self, model_dim: int, num_experts: int):
        super().__init__()
        self.wg = Linear(model_dim, num_experts, bias=False)

    def forward(self, x):
        return self.wg(x.float())


GATES = {"cosine_top": CosineTopGate, "linear_top": LinearTopGate}


class MoELayer(nn.Module):
    """Top-k expert FFN layer over flat tokens [N, D] -> [N, D]; the gate
    (``gate_type``: the cosine or the linear top-k gate) gives the f32
    logits that every mode routes."""

    mesh = None  # the mesh it computes over (parallel/mesh.py:attach_mesh)

    def __init__(self, num_experts: int, topk: int, model_dim: int, hidden_dim: int,
                 gate_type: str = "cosine_top", gate_noise: float = 1.0,
                 capacity_factor: float = 1.5, batch_prioritized: bool = True,
                 expert_axis=None):
        super().__init__()
        if gate_type not in GATES:
            raise ValueError(f"gate_type {gate_type!r}: one of {sorted(GATES)}")
        E, D, Fh = num_experts, model_dim, hidden_dim
        self.num_experts, self.topk = E, topk
        self.capacity_factor = capacity_factor
        # gate_noise and batch_prioritized act in training only
        self.gate_noise, self.batch_prioritized = gate_noise, batch_prioritized
        # with an expert axis inference takes the slot path, as the JAX
        # package's does (K4's route, then K6 over the slot buffers)
        self.expert_axis = expert_axis
        self.gate = GATES[gate_type](D, E)
        self.expert_w1 = nn.Parameter(torch.randn(E, D, Fh) / math.sqrt(D))
        self.expert_b1 = nn.Parameter(torch.zeros(E, Fh))
        self.expert_w2 = nn.Parameter(torch.randn(E, Fh, D) / math.sqrt(Fh))
        self.expert_b2 = nn.Parameter(torch.zeros(E, D))

    def capacity(self, N: int) -> int:
        E, K = self.num_experts, self.topk
        return max(1, min(K * int(self.capacity_factor * ((N + E - 1) // E)), N))

    def _comms(self):
        """(expert comm, tensor comm) of the axes that split this layer's
        experts and hidden dim (parallel/tp.py:shard_module_), None where
        unsplit."""
        ep, tp = split_axis(self, "expert_w1", 0), split_axis(self, "expert_w1", 2)
        if (ep or tp) and self.mesh is None:
            raise RuntimeError("a sharded MoELayer computes over its mesh: attach_mesh")
        return (None if ep is None else self.mesh.comm(ep),
                None if tp is None else self.mesh.comm(tp))

    def forward(self, x, generator=None, noise=None, aux_losses=None, blocks: int = 1):
        """x [N, D] -> [N, D].  In training, the gate noise is ``noise``
        (a standard-normal [N, E] draw) if given, else drawn from
        ``generator``, and the aux loss is appended to ``aux_losses``.  On
        a mesh the tokens are ``blocks`` blocks of this rank's rows
        (parallel/mesh.py:token_rows) and route over the global list."""
        if self.training:
            return self._forward_slots(x, generator, noise, aux_losses)
        D = x.shape[1]
        mesh = self.mesh
        logits = self.gate(x)                                      # f32 [N, E]
        own = None
        if mesh is not None and mesh.world > 1:
            own = token_rows(mesh, x.shape[0], blocks, x.device)   # global ids of x's tokens
            logits = gather_tokens(mesh, logits, blocks)
        route = moe_route(logits, self.topk, self.capacity(logits.shape[0]), BLOCK)
        w1, w2 = self.expert_w1, self.expert_w2
        ep, tp = self._comms()
        if w1.dtype == torch.int8:
            if ep is not None or tp is not None:
                raise NotImplementedError(f"int8 experts split over a mesh: {ACROSS_CARDS}")
            if not hasattr(self, "expert_w1_wscale"):
                return self._forward_slots_int8(x, route, own)
            w1 = dequant(w1, self.expert_w1_wscale, x.dtype)
            w2 = dequant(w2, self.expert_w2_wscale, x.dtype)
        if ep is not None or self.expert_axis is not None:
            return self._forward_slots_eval(x, route, own, ep, tp)
        tfr = route.token_for_rank.long()
        if own is None:
            xs = x.index_select(0, tfr)                            # [M, D] expert-sorted
        else:  # the rows of other ranks' tokens stay zero
            local = torch.full((logits.shape[0],), -1, dtype=torch.long, device=x.device)
            local[own] = torch.arange(x.shape[0], device=x.device)
            li = local.index_select(0, tfr)
            xs = torch.where((li >= 0)[:, None], x.index_select(0, li.clamp(min=0)),
                             x.new_zeros(()))
        ye = grouped_ffn(route.block_expert, xs, w1, self.expert_b1, w2)
        ye = torch.cat([ye, ye.new_zeros(1, D)], dim=0)            # row M: dropped choices
        gates, r, ge = route.gates, route.r, route.ge
        if own is not None:
            gates, r, ge = gates[own], r[own], ge[own]
        gates = gates.to(x.dtype)
        y = gates[:, 0, None] * ye.index_select(0, r[:, 0])
        for k in range(1, self.topk):
            y = y + gates[:, k, None] * ye.index_select(0, r[:, k])
        y = tp_reduce(y, tp)
        return y + ge.to(x.dtype) @ self.expert_b2.to(x.dtype)

    def _route_slots(self, route, N, own=None):
        """The slot of each of the N tokens' kept choices in the flat
        [E * C] buffer (C the route's capacity: slot e * C + the choice's
        rank within its expert), E * C where dropped; ``own``: the tokens'
        rows of a global route."""
        E = self.num_experts
        C = self.capacity(route.r.shape[0])
        M = route.token_for_rank.shape[0]
        r = route.r.long() if own is None else route.r[own].long()   # [N, K], M where dropped
        valid = r < M
        fill = route.counts.long().clamp(max=C)
        aligned = (fill + BLOCK - 1) // BLOCK * BLOCK
        offset = torch.cumsum(aligned, dim=0) - aligned             # each expert's first row
        rows = torch.where(valid, r, torch.zeros_like(r))
        e = route.block_expert.long()[rows // BLOCK]
        dump = E * C
        return torch.where(valid, e * C + rows - offset[e], torch.full_like(r, dump)), C

    def _fill(self, x, slots, dump):
        """The [dump, D] slot buffer: each kept (token, k) at its slot,
        the empty slots 0."""
        N = x.shape[0]
        token_for_slot = torch.zeros(dump + 1, dtype=torch.long, device=x.device)
        token_for_slot[slots.reshape(-1)] = torch.arange(
            N, device=x.device).repeat_interleave(self.topk)
        filled = torch.zeros(dump + 1, dtype=torch.bool, device=x.device)
        filled[slots.reshape(-1)] = True
        # index_select, not x[...]: its backward is an index_add with atomics,
        # where advanced indexing's sorts the indices and serializes over the
        # empty slots' duplicates of token 0
        return torch.where(filled[:dump, None], x.index_select(0, token_for_slot[:dump]),
                           x.new_zeros(()))

    def _experts(self, xe, ep, tp):
        """The expert FFN over the slot buffers ``xe`` [E, C, D] of this
        rank's tokens -> [E, C, D], b2 inside: with the experts split over
        ``ep`` the buffers cross the expert group (each rank's [E/X, C, D]
        the sum of the group's, whose slots are disjoint), K6 runs on this
        rank's experts and the results return the same way; with the
        hidden dim split over ``tp`` K6 takes zeros for b2 and the partial
        outputs are summed before b2 is added."""
        mesh = self.mesh
        E, C, D = xe.shape
        if ep is not None:
            X = ep.size
            xe = all_to_all(xe.reshape(X, E // X, C, D), mesh, ep).sum(dim=0)
        b2 = self.expert_b2
        if tp is not None:
            b2 = torch.zeros_like(b2)
        # bf16 slots meet bf16 weights in K6's bf16 instantiation; f32 slots
        # meet them widened (exact), as the reference's einsums promote
        ye = fused_expert_ffn(*promote_dtype(xe, self.expert_w1, self.expert_b1,
                                             self.expert_w2, b2))
        if tp is not None:
            ye = tp_reduce(ye, tp) + self.expert_b2.to(ye.dtype)[:, None, :]
        if ep is not None:
            X = ep.size
            ye = all_to_all(ye.unsqueeze(0).expand((X,) + tuple(ye.shape)).contiguous(),
                            mesh, ep).reshape(E, C, D)
        return ye

    def _forward_slots_eval(self, x, route, own, ep, tp):
        """Inference on the slot path (an expert axis): the route's kept
        choices into [E, C, D] slot buffers, the experts (``_experts``) and
        the gate-weighted combine."""
        N, D = x.shape
        E = self.num_experts
        slots, C = self._route_slots(route, N, own)
        dump = E * C
        xe = self._fill(tp_copy(x, tp), slots, dump).reshape(E, C, D)
        ye = self._experts(xe, ep, tp)
        ye = torch.cat([ye.reshape(dump, D), ye.new_zeros(1, D)], dim=0)
        gates = (route.gates if own is None else route.gates[own]).to(x.dtype)
        y = gates[:, 0, None] * ye.index_select(0, slots[:, 0])
        for k in range(1, self.topk):
            y = y + gates[:, k, None] * ye.index_select(0, slots[:, k])
        return y

    def _forward_slots_int8(self, x, route, own=None):
        """W8A8: the route's kept choices into an [E, C, D] slot buffer
        (slot e * C + the choice's rank within its expert; dropped choices
        to a dump row past the end), the int8 expert pair over it, and the
        gate-weighted combine."""
        N, D = x.shape
        E = self.num_experts
        slots, C = self._route_slots(route, N, own)
        dump = E * C
        xe = self._fill(x, slots, dump)
        ye = expert_ffn_q(xe.reshape(E, C, D), self.expert_w1, self.expert_w1_scale,
                          self.expert_b1, self.expert_w2, self.expert_w2_scale, self.expert_b2)
        ye = torch.cat([ye.reshape(dump, D), ye.new_zeros(1, D)], dim=0)
        gates = (route.gates if own is None else route.gates[own]).to(x.dtype)
        y = gates[:, 0, None] * ye.index_select(0, slots[:, 0])
        for k in range(1, self.topk):
            y = y + gates[:, k, None] * ye.index_select(0, slots[:, k])
        return y

    def _forward_slots(self, x, generator, noise, aux_losses):
        N, D = x.shape
        E, K = self.num_experts, self.topk
        mesh = self.mesh
        ep, tp = self._comms()
        logits = self.gate(x)                                      # f32 [N, E]
        noisy = logits
        if self.gate_noise > 0:
            if noise is None:
                noise = draw_rows(mesh, lambda shape: draw_gate_noise(
                    logits.new_empty(shape), generator), logits.shape)
            noisy = logits + self.gate_noise * noise / E
        scores = noisy.softmax(dim=1)
        topk_idx = torch.sort(noisy, dim=1, descending=True, stable=True).indices[:, :K]
        topk_scores = scores.gather(1, topk_idx)                   # [N, K]
        gates = topk_scores / (topk_scores.sum(dim=1, keepdim=True) + 1e-9)

        # slot ranks in batch-prioritized order over the global token list:
        # tokens by descending top-1 score, ties (padded frames give
        # identical tokens) in token order
        top1, route_idx, own = topk_scores[:, 0].detach(), topk_idx, None
        if mesh is not None and mesh.world > 1:
            # expert indices < E are exact in f32; a training microbatch is
            # one block of rows, so rank-major is the global order
            packed = all_gather_rows(torch.cat([top1[:, None], topk_idx.to(top1.dtype)], 1)
                                     .detach(), mesh)
            top1, route_idx = packed[:, 0], packed[:, 1:].long()
            own = token_rows(mesh, N, 1, x.device)
        NG = route_idx.shape[0]
        capacity = self.capacity(NG)
        order = None
        idx_for_rank = route_idx
        if self.batch_prioritized:
            order = torch.sort(-top1, stable=True).indices
            idx_for_rank = route_idx[order]
        pos_flat, _ = moe_positions_counts(idx_for_rank.t().reshape(-1).to(torch.int32), E)
        positions = pos_flat.reshape(K, NG).t().long()             # [NG, K]
        if order is not None:
            positions = torch.empty_like(positions).index_copy_(0, order, positions)
        if own is not None:
            positions = positions[own]
        valid = positions < capacity
        gates = gates * valid.to(gates.dtype)

        # each kept (token, k) fills slot e * capacity + position of the flat
        # [E * capacity] buffer; dropped ones go to a dump row past its end
        dump = E * capacity
        slots = torch.where(valid, topk_idx * capacity + positions,
                            torch.full_like(positions, dump))
        xe = self._fill(tp_copy(x, tp), slots, dump)
        ye = self._experts(xe.reshape(E, capacity, D), ep, tp)
        ye = torch.cat([ye.reshape(dump, D), ye.new_zeros(1, D)], dim=0)
        picked = ye.index_select(0, slots.reshape(-1)).reshape(N, K, D)
        y = torch.einsum("nk,nkd->nd", gates.to(picked.dtype), picked)
        if aux_losses is not None:
            aux_losses.append(load_importance_loss(logits.softmax(dim=1), topk_scores, E,
                                                   self.gate_noise, mesh))
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
                       aux_losses=aux_losses, blocks=token_blocks(self.model.mesh, B))
        return self.proj(F.gelu(y)).reshape(B, T, H, -1)
