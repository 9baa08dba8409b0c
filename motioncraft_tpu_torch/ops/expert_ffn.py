"""Expert FFN over the MoE slot buffers (kernel K6).

Replaces ``fused_expert_ffn`` of motioncraft_tpu/ops/pallas_ffn.py; its plain
version is that module's ``_ffn_reference``.  ``xe`` [E, C, D] holds each
expert's C capacity slots:

    out[e, c] = gelu_erf(xe[e, c] @ w1[e] + b1[e]) @ w2[e] + b2[e]

On a CUDA tensor the wrapper launches csrc/expert_ffn.cu: K1's tensor-core
FFN tile on a (slot tile, expert) grid, both products in 3xTF32 (f32
accuracy), the hidden activation in registers, so the [E, C, F] hidden never
reaches device memory; b2 is added in the epilogue and each expert's last
tile is ragged.  Bound by operations (4*D*F flops per row against 8*D
bytes).  The gradient recomputes the plain version
(ops/recompute.py), as the Pallas kernel's custom VJP does; that recompute
does materialize the hidden activation.

bf16 operands (bf16 training's text MoEs) launch the kernel's bf16
instantiation, counted apart as ``fused_expert_ffn_bf16``: K1's bf16 tile
(common.cuh ffn_tile_bf16) on the same grid, as the Pallas kernel computes
on bf16 operands: f32 accumulation, b1 and the GELU in f32, the hidden
rounded to bf16 before the second product, b2 in f32, the output in bf16.
Its plain version is the same function on bf16 tensors, which is what the
reference's einsum pair computes in bf16; its gradient recomputes that in
bf16, as the custom VJP takes the reference's VJP on the bf16 residuals.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build
from .recompute import with_recomputed_grad

_fns = {}  # C symbol -> its ctypes function


def expert_ffn_plain(xe, w1, b1, w2, b2):
    """Plain version: the batched product pair over the expert axis, in the
    operands' dtype."""
    h = F.gelu(torch.bmm(xe, w1) + b1[:, None, :])
    return torch.bmm(h, w2) + b2[:, None, :]


def _launcher(symbol, counted):
    def launch(xe, w1, b1, w2, b2):
        E, C, d = xe.shape
        hid = w1.shape[2]
        out = torch.empty_like(xe)
        fn = _fns.get(symbol)
        if fn is None:
            v, i = ctypes.c_void_p, ctypes.c_int
            fn = _fns[symbol] = _build.function("expert_ffn", symbol,
                                                [v, v, v, v, v, v, i, i, i, i, v])
        rc = fn(xe.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
                out.data_ptr(), E, C, d, hid, _build.stream_ptr(xe.device))
        _build.check("expert_ffn", rc)
        counted.launches += 1
        return out
    return launch


def _checked(name, xe, w1, b1, w2, b2, dtype):
    E, C, d = xe.shape
    hid = w1.shape[2]
    tensors = (xe, w1, b1, w2, b2)
    if any(t.dtype != dtype or t.device != xe.device for t in tensors):
        raise ValueError(f"{name}: xe, w1, b1, w2, b2 must be {dtype} on one device")
    if (w1.shape != (E, d, hid) or b1.shape != (E, hid) or w2.shape != (E, hid, d)
            or b2.shape != (E, d)):
        raise ValueError(f"{name}: inconsistent shapes")
    if d not in (32, 64, 128, 256) or hid % 32 or E > 65535:
        raise ValueError(f"{name}: kernel takes D in 32/64/128/256, F % 32 == 0 "
                         f"and E <= 65535, got D={d}, F={hid}, E={E}")
    tensors = tuple(t.contiguous() for t in tensors)
    if any(t.data_ptr() % 16 for t in (tensors[0], tensors[1], tensors[3])):
        raise ValueError(f"{name}: xe, w1, w2 must be 16-byte aligned")
    return tensors


def fused_expert_ffn(xe: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                     w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """xe [E, C, D], w1 [E, D, F], b1 [E, F], w2 [E, F, D], b2 [E, D] ->
    [E, C, D].  A CPU tensor takes the plain version; a CUDA tensor launches
    the kernel, its bf16 instantiation (``fused_expert_ffn_bf16``) for bf16
    operands, differentiable through the plain version's gradient."""
    if xe.device.type == "cpu":
        return expert_ffn_plain(xe, w1, b1, w2, b2)
    if xe.device.type != "cuda":
        raise ValueError(f"fused_expert_ffn: unsupported device {xe.device}")
    if xe.dtype == torch.bfloat16:
        return fused_expert_ffn_bf16(xe, w1, b1, w2, b2)
    args = _checked("fused_expert_ffn", xe, w1, b1, w2, b2, torch.float32)
    if xe.shape[0] == 0 or xe.shape[1] == 0:
        return torch.empty_like(xe)
    return with_recomputed_grad(_launch_f32, expert_ffn_plain, *args)


def fused_expert_ffn_bf16(xe: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                          w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """``fused_expert_ffn`` on bf16 operands (all five), bf16 out.  A CPU
    tensor takes the plain version; a CUDA tensor launches the bf16 kernel,
    differentiable through the plain version's gradient in bf16."""
    if xe.device.type == "cpu":
        return expert_ffn_plain(xe, w1, b1, w2, b2)
    if xe.device.type != "cuda":
        raise ValueError(f"fused_expert_ffn_bf16: unsupported device {xe.device}")
    args = _checked("fused_expert_ffn_bf16", xe, w1, b1, w2, b2, torch.bfloat16)
    if xe.shape[0] == 0 or xe.shape[1] == 0:
        return torch.empty_like(xe)
    return with_recomputed_grad(_launch_bf16, expert_ffn_plain, *args)


fused_expert_ffn.launches = 0
fused_expert_ffn_bf16.launches = 0
_launch_f32 = _launcher("mc_expert_ffn", fused_expert_ffn)
_launch_bf16 = _launcher("mc_expert_ffn_bf16", fused_expert_ffn_bf16)
