"""Grouped expert FFN over rank-compact MoE rows (kernel K1).

Replaces ``grouped_ffn`` of motioncraft_tpu/ops/pallas_moe_ffn.py.  The rows
of ``xs`` [M_pad, D] are sorted by expert in groups padded to ``BLOCK`` rows,
so each block belongs to one expert, ``block_expert[block]``:

    out_block = gelu_erf(x_block @ w1[e] + b1[e]) @ w2[e]

b2 and the gate are left to the caller (models/moe.py).  On a CUDA tensor the
wrapper launches csrc/moe_ffn.cu.  The kernel is bound by operations (4*D*F
flops per row against 8*D bytes).  Exact f32 does not rule out the tensor
cores: both products run on them in 3xTF32 (each f32 operand split into two
TF32 parts, three TF32 products summed in f32, about 22 mantissa bits).  One
CTA per 128-row quarter of an expert block reads its expert id, keeps its
rows in shared memory, streams w1/w2 64 hidden columns at a time with
double-buffered asynchronous copies, and keeps the hidden chunk in
registers, so the hidden activation never reaches device memory.  Its
bound is 3xTF32 on the tensor cores (three passes at 495 TFLOP/s);
mma.sync does not reach that peak, wgmma would.

bf16 operands (bf16 inference) launch the kernel's bf16 instantiation,
counted apart as ``grouped_ffn_bf16``: bf16 products with f32 accumulation,
the hidden rounded to bf16 before the second product, the output in bf16,
as the Pallas kernel computes on bf16 operands.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build

BLOCK = 512  # rows per expert-aligned group
_fns = {}  # C symbol -> its ctypes function


def grouped_ffn_plain(block_expert, xs, w1, b1, w2):
    """Plain version: one batched product pair over the expert of each block,
    in f32, with the hidden rounded to ``xs.dtype`` before the second
    product and the output stored in it, as the Pallas kernel does (for f32
    operands the casts do nothing)."""
    m_pad, d = xs.shape
    e = block_expert.long()
    x = xs.reshape(m_pad // BLOCK, BLOCK, d).float()
    h = F.gelu(torch.bmm(x, w1[e].float()) + b1[e].float()[:, None, :])
    out = torch.bmm(h.to(xs.dtype).float(), w2[e].float())
    return out.reshape(m_pad, d).to(xs.dtype)


def _check(name, block_expert, xs, w1, b1, w2, dtype):
    m_pad, d = xs.shape
    E, _, hid = w1.shape
    if any(t.dtype != dtype or t.device != xs.device for t in (xs, w1, b1, w2)):
        raise ValueError(f"{name}: xs, w1, b1, w2 must be {dtype} on one device")
    if (w1.shape != (E, d, hid) or b1.shape != (E, hid) or w2.shape != (E, hid, d)
            or block_expert.shape != (m_pad // BLOCK,)
            or block_expert.dtype != torch.int32):
        raise ValueError(f"{name}: inconsistent shapes or block_expert dtype")
    if d not in (32, 64, 128, 256) or hid % 32:
        raise ValueError(f"{name}: kernel takes D in 32/64/128/256 and F % 32 == 0, "
                         f"got D={d}, F={hid}")
    xs, w1, b1, w2, be = (t.contiguous() for t in (xs, w1, b1, w2, block_expert))
    if any(t.data_ptr() % 16 for t in (xs, w1, w2)):
        raise ValueError(f"{name}: xs, w1, w2 must be 16-byte aligned")
    return be, xs, w1, b1, w2


def _launch(symbol, be, xs, w1, b1, w2):
    fn = _fns.get(symbol)
    if fn is None:
        v, i = ctypes.c_void_p, ctypes.c_int
        fn = _fns[symbol] = _build.function("moe_ffn", symbol, [v, v, v, v, v, v, i, i, i, v])
    out = torch.empty_like(xs)
    rc = fn(be.data_ptr(), xs.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
            out.data_ptr(), xs.shape[0], xs.shape[1], w1.shape[2],
            _build.stream_ptr(xs.device))
    _build.check("moe_ffn", rc)
    return out


def grouped_ffn(block_expert: torch.Tensor, xs: torch.Tensor, w1: torch.Tensor,
                b1: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """xs [M_pad, D] expert-sorted rows (BLOCK-aligned groups), block_expert
    [M_pad / BLOCK] int32, w1 [E, D, F], b1 [E, F], w2 [E, F, D] -> [M_pad, D].
    A CPU tensor takes the plain version; a CUDA tensor launches the kernel,
    its bf16 instantiation (``grouped_ffn_bf16``) for bf16 operands."""
    m_pad, d = xs.shape
    if m_pad % BLOCK:
        raise ValueError(f"grouped_ffn: {m_pad} rows is not a multiple of {BLOCK}")
    if xs.device.type == "cpu":
        return grouped_ffn_plain(block_expert, xs, w1, b1, w2)
    if xs.device.type != "cuda":
        raise ValueError(f"grouped_ffn: unsupported device {xs.device}")
    if xs.dtype == torch.bfloat16:
        return grouped_ffn_bf16(block_expert, xs, w1, b1, w2)
    out = _launch("mc_grouped_ffn",
                  *_check("grouped_ffn", block_expert, xs, w1, b1, w2, torch.float32))
    grouped_ffn.launches += 1
    return out


def grouped_ffn_bf16(block_expert: torch.Tensor, xs: torch.Tensor, w1: torch.Tensor,
                     b1: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """``grouped_ffn`` on bf16 operands (all of xs, w1, b1, w2), bf16 out.
    A CPU tensor takes the plain version; a CUDA tensor launches the bf16
    kernel."""
    if xs.device.type == "cpu":
        return grouped_ffn_plain(block_expert, xs, w1, b1, w2)
    if xs.device.type != "cuda" or xs.shape[0] % BLOCK:
        raise ValueError(f"grouped_ffn_bf16: unsupported device {xs.device} or "
                         f"{xs.shape[0]} rows not a multiple of {BLOCK}")
    out = _launch("mc_grouped_ffn_bf16",
                  *_check("grouped_ffn_bf16", block_expert, xs, w1, b1, w2, torch.bfloat16))
    grouped_ffn_bf16.launches += 1
    return out


grouped_ffn.launches = 0
grouped_ffn_bf16.launches = 0
