"""MoE slot ranks (kernel K4): the arrival rank of each (token, k) choice
within its expert, and the per-expert counts.

Replaces ``_positions_pallas`` / ``moe_positions_counts`` of
motioncraft_tpu/ops/pallas_moe.py (Tutel's ``fast_cumsum_sub_one``).  On a
CUDA tensor ``moe_positions_counts`` launches csrc/moe_positions.cu: a
parallel two-pass block scan (per-block per-expert counts, then each block's
exclusive offset over the blocks before it plus ranks inside the block), in
place of the TPU kernel's sequential carry from one grid step to the next.
The ranks are exact int32, bit-identical to the JAX ranks, because the MoE
capacity drops depend on them.  Bound by device-memory bytes (8 bytes per
id); at the flagship the launches dominate.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build

_THREADS = 1024  # ids per block of the CUDA scan
_fn = None


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
    pos = torch.empty_like(flat_idx)
    counts = torch.empty(num_experts, dtype=torch.int32, device=flat_idx.device)
    if M == 0:
        return pos, counts.zero_()
    idx = flat_idx.contiguous()
    scratch = torch.empty(((M + _THREADS - 1) // _THREADS) * num_experts,
                          dtype=torch.int32, device=idx.device)
    global _fn
    if _fn is None:
        v, i = ctypes.c_void_p, ctypes.c_int
        _fn = _build.function("moe_positions", "mc_moe_positions",
                              [v, i, i, v, v, v, v])
    rc = _fn(idx.data_ptr(), M, num_experts, scratch.data_ptr(), pos.data_ptr(),
             counts.data_ptr(), _build.stream_ptr(idx.device))
    _build.check("moe_positions", rc)
    moe_positions_counts.launches += 1
    return pos, counts


moe_positions_counts.launches = 0
