"""MoE routing and slot ranks (kernel K4), one launch each.

Replaces ``_positions_pallas`` / ``moe_positions_counts`` of
motioncraft_tpu/ops/pallas_moe.py (Tutel's ``fast_cumsum_sub_one``) and the
routing the JAX package builds around it (motioncraft_tpu/models/moe.py):

- ``moe_positions_counts(flat_idx, E)``: the arrival rank of each (token, k)
  choice within its expert, k-major, and the per-expert counts;
- ``moe_route(logits, topk, capacity, block)``: from the gate logits, the
  whole rank-compact dispatch of the inference MoE: top-k by logit, gates,
  ranks, capacity drops and the tables the grouped expert FFN (K1) and the
  combine read.

On a CUDA tensor both launch csrc/moe_positions.cu once: a cooperative
persistent grid that ranks each tile's choices, meets at one grid-wide
barrier, and then writes every output from the per-tile counts.  It needs
every block of its grid resident at once; the launch is refused (and the
wrapper raises) otherwise.  The ranks are exact int32, bit-identical to the
JAX ranks, because the capacity drops depend on them.  Bound by device-memory
bytes: the logits in and the routing out.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from . import _build

_TILE = 512  # tokens (or ids) per tile of the CUDA kernel
_fns = {}


class Route(NamedTuple):
    """The inference MoE's dispatch: M rows sorted by expert, each expert's
    kept choices padded to a multiple of ``block`` rows."""
    gates: torch.Tensor           # [N, K] f32, normalised over the K, 0 where dropped
    r: torch.Tensor               # [N, K] int32 row of each choice; M where dropped
    token_for_rank: torch.Tensor  # [M] int32 token of each row; 0 on padding rows
    block_expert: torch.Tensor    # [M / block] int32 expert of each group of rows
    ge: torch.Tensor              # [N, E] f32 the masked gates scattered to their experts
    counts: torch.Tensor          # [E] int32 choices of each expert before the drops


def route_rows(n_tokens: int, topk: int, num_experts: int, block: int) -> int:
    """M, the static bound on the aligned rows of every expert together."""
    return (n_tokens * topk + block - 1) // block * block + num_experts * block


def _function(symbol, argtypes):
    fn = _fns.get(symbol)
    if fn is None:
        fn = _fns[symbol] = _build.function("moe_positions", symbol, argtypes)
    return fn


def moe_positions_counts_plain(flat_idx: torch.Tensor, num_experts: int
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-hot cumsum: (positions [M] int32, counts [E] int32); ids outside
    [0, E) get position 0 and are not counted."""
    onehot = (flat_idx[:, None] == torch.arange(num_experts, device=flat_idx.device)
              ).to(torch.int32)
    csum = torch.cumsum(onehot, dim=0, dtype=torch.int32)
    pos = ((csum - 1) * onehot).sum(dim=1, dtype=torch.int32)
    return pos, onehot.sum(dim=0, dtype=torch.int32)


def moe_positions_counts(flat_idx: torch.Tensor, num_experts: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``flat_idx`` [M] int32 expert ids in k-major order -> (positions [M],
    counts [E]), both int32.  A CPU tensor takes the plain version; a CUDA
    tensor launches the kernel."""
    if flat_idx.device.type == "cpu":
        return moe_positions_counts_plain(flat_idx, num_experts)
    if flat_idx.device.type != "cuda":
        raise ValueError(f"moe_positions_counts: unsupported device {flat_idx.device}")
    if flat_idx.dtype != torch.int32 or flat_idx.dim() != 1:
        raise ValueError("moe_positions_counts: flat_idx must be a 1-D int32 tensor")
    if not 1 <= num_experts <= 256:
        raise ValueError(f"moe_positions_counts: num_experts {num_experts} not in [1, 256]")
    M = flat_idx.shape[0]
    if M == 0:
        return flat_idx.new_empty(0), flat_idx.new_zeros(num_experts)
    idx = flat_idx.contiguous()
    tiles = (M + _TILE - 1) // _TILE
    # the outputs and the scratch table in one allocation
    pos, counts, table = torch.empty(M + (1 + tiles) * num_experts, dtype=torch.int32,
                                     device=idx.device).split([M, num_experts,
                                                               tiles * num_experts])
    v, i = ctypes.c_void_p, ctypes.c_int
    fn = _function("mc_moe_positions", [v, i, i, v, v, v, v])
    rc = fn(idx.data_ptr(), M, num_experts, table.data_ptr(), pos.data_ptr(),
            counts.data_ptr(), _build.stream_ptr(idx.device))
    _build.check("moe_positions", rc)
    moe_positions_counts.launches += 1
    return pos, counts


moe_positions_counts.launches = 0


def moe_route_plain(logits: torch.Tensor, topk: int, capacity: int, block: int) -> Route:
    """The routing as plain tensor code: experts ranked by logit with a
    stable sort, the arrival ranks from the one-hot cumsum, the tables from
    cumsum, scatter and searchsorted."""
    N, E = logits.shape
    K, dev = topk, logits.device
    # experts ranked by logit (softmax keeps the order), lower index first
    # on equal logits: the routing is a function of the logits alone, so
    # devices that agree on the logits route alike (a topk over softmax
    # scores can break a rounding tie one way on the CPU, another on the card)
    topk_idx = torch.sort(logits, dim=1, descending=True, stable=True).indices[:, :K]
    topk_scores = logits.softmax(dim=1).gather(1, topk_idx)    # [N, K]
    gates = topk_scores / (topk_scores.sum(dim=1, keepdim=True) + 1e-9)

    flat_idx = topk_idx.t().reshape(-1).to(torch.int32)        # k-major [K*N]
    pos_flat, counts = moe_positions_counts_plain(flat_idx, E)
    positions = pos_flat.reshape(K, N).t().long()              # [N, K]
    valid = positions < capacity
    gates = gates * valid.to(gates.dtype)

    fill = counts.long().clamp(max=capacity)                   # [E]
    fill_aligned = (fill + block - 1) // block * block
    M = route_rows(N, K, E, block)
    ends = torch.cumsum(fill_aligned, dim=0)
    offset = ends - fill_aligned
    rank = offset[topk_idx] + positions                        # [N, K]
    r = torch.where(valid, rank, torch.full_like(rank, M))     # dropped -> dump row
    token_ids = torch.arange(N, device=dev).repeat_interleave(K)
    token_for_rank = torch.zeros(M + 1, dtype=torch.long, device=dev)
    token_for_rank[r.reshape(-1)] = token_ids

    starts = torch.arange(M // block, device=dev) * block
    block_expert = torch.searchsorted(ends, starts, right=True).clamp(max=E - 1)
    ge = torch.einsum("nk,nke->ne", gates, F.one_hot(topk_idx, E).to(gates.dtype))
    return Route(gates, r.to(torch.int32), token_for_rank[:M].to(torch.int32),
                 block_expert.to(torch.int32), ge, counts)


def moe_route(logits: torch.Tensor, topk: int, capacity: int, block: int) -> Route:
    """``logits`` [N, E] f32 gate logits -> the ``Route`` of the top-``topk``
    choices under ``capacity`` choices an expert, in groups of ``block``
    rows.  A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel once."""
    if logits.device.type == "cpu":
        return moe_route_plain(logits, topk, capacity, block)
    if logits.device.type != "cuda":
        raise ValueError(f"moe_route: unsupported device {logits.device}")
    if logits.dtype != torch.float32 or logits.dim() != 2:
        raise ValueError("moe_route: logits must be a 2-D float32 tensor")
    N, E = logits.shape
    K = topk
    if not 1 <= K <= E <= 64:
        raise ValueError(f"moe_route: kernel takes 1 <= topk <= E <= 64, got topk={K}, E={E}")
    if N < 1 or capacity < 1 or block < 1:
        raise ValueError(f"moe_route: N={N}, capacity={capacity}, block={block} must be >= 1")
    M = route_rows(N, K, E, block)
    if M >= 2 ** 31:
        raise ValueError(f"moe_route: {M} rows overflow the int32 row indices")
    lg = logits.contiguous()
    tiles = (N + _TILE - 1) // _TILE
    # every output and the scratch table in one allocation
    sizes = [N * K, N * K, M, M // block, N * E, E, tiles * K * E]
    gates, r, token_for_rank, block_expert, ge, counts, table = torch.empty(
        sum(sizes), dtype=torch.int32, device=lg.device).split(sizes)
    gates, ge = gates.view(torch.float32), ge.view(torch.float32)
    v, i = ctypes.c_void_p, ctypes.c_int
    fn = _function("mc_moe_route", [v, i, i, i, i, i, i, v, v, v, v, v, v, v, v])
    rc = fn(lg.data_ptr(), N, E, K, capacity, block, M, gates.data_ptr(), r.data_ptr(),
            token_for_rank.data_ptr(), block_expert.data_ptr(), ge.data_ptr(),
            counts.data_ptr(), table.data_ptr(), _build.stream_ptr(lg.device))
    _build.check("moe_positions", rc)
    moe_route.launches += 1
    return Route(gates.view(N, K), r.view(N, K), token_for_rank, block_expert,
                 ge.view(N, E), counts)


moe_route.launches = 0
