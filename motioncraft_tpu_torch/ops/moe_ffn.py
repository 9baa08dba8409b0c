"""Grouped expert FFN over rank-compact MoE rows (kernel K1).

Replaces ``grouped_ffn`` of motioncraft_tpu/ops/pallas_moe_ffn.py.  The rows
of ``xs`` [M_pad, D] are sorted by expert in groups padded to ``BLOCK`` rows,
so each block belongs to one expert, ``block_expert[block]``:

    out_block = gelu_erf(x_block @ w1[e] + b1[e]) @ w2[e]

b2 and the gate are left to the caller (models/moe.py).  On a CUDA tensor the
wrapper launches csrc/moe_ffn.cu: one CTA per 64-row tile reads its block's
expert id and keeps the hidden activation in shared memory, 32 columns at a
time, so it never reaches device memory.  Bound by f32 operations
(4*D*F flops per row against 8*D bytes); exact f32 rules out TF32 tensor
cores.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build

BLOCK = 512  # rows per expert-aligned group
_fn = None


def grouped_ffn_plain(block_expert, xs, w1, b1, w2):
    """Plain version: one batched product pair over the expert of each block."""
    m_pad, d = xs.shape
    e = block_expert.long()
    x = xs.reshape(m_pad // BLOCK, BLOCK, d)
    h = F.gelu(torch.bmm(x, w1[e]) + b1[e][:, None, :])
    return torch.bmm(h, w2[e]).reshape(m_pad, d)


def grouped_ffn(block_expert: torch.Tensor, xs: torch.Tensor, w1: torch.Tensor,
                b1: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """xs [M_pad, D] expert-sorted rows (BLOCK-aligned groups), block_expert
    [M_pad / BLOCK] int32, w1 [E, D, F], b1 [E, F], w2 [E, F, D] -> [M_pad, D].
    A CPU tensor takes the plain version; a CUDA tensor launches the kernel."""
    m_pad, d = xs.shape
    if m_pad % BLOCK:
        raise ValueError(f"grouped_ffn: {m_pad} rows is not a multiple of {BLOCK}")
    if xs.device.type == "cpu":
        return grouped_ffn_plain(block_expert, xs, w1, b1, w2)
    if xs.device.type != "cuda":
        raise ValueError(f"grouped_ffn: unsupported device {xs.device}")
    E, _, hid = w1.shape
    tensors = (xs, w1, b1, w2)
    if any(t.dtype != torch.float32 or t.device != xs.device for t in tensors):
        raise ValueError("grouped_ffn: xs, w1, b1, w2 must be float32 on one device")
    if (w1.shape != (E, d, hid) or b1.shape != (E, hid) or w2.shape != (E, hid, d)
            or block_expert.shape != (m_pad // BLOCK,)
            or block_expert.dtype != torch.int32):
        raise ValueError("grouped_ffn: inconsistent shapes or block_expert dtype")
    if d not in (32, 64, 128, 256) or hid % 32:
        raise ValueError(f"grouped_ffn: kernel takes D in 32/64/128/256 and F % 32 == 0, "
                         f"got D={d}, F={hid}")
    xs, w1, b1, w2, be = (t.contiguous() for t in (*tensors, block_expert))
    if any(t.data_ptr() % 16 for t in (xs, w1, w2)):
        raise ValueError("grouped_ffn: xs, w1, w2 must be 16-byte aligned")
    out = torch.empty_like(xs)
    global _fn
    if _fn is None:
        v, i = ctypes.c_void_p, ctypes.c_int
        _fn = _build.function("moe_ffn", "mc_grouped_ffn", [v, v, v, v, v, v, i, i, i, v])
    rc = _fn(be.data_ptr(), xs.data_ptr(), w1.data_ptr(), b1.data_ptr(),
             w2.data_ptr(), out.data_ptr(), m_pad, d, hid,
             _build.stream_ptr(xs.device))
    _build.check("moe_ffn", rc)
    grouped_ffn.launches += 1
    return out


grouped_ffn.launches = 0
