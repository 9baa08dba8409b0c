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
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build
from .recompute import with_recomputed_grad

_fn = None


def expert_ffn_plain(xe, w1, b1, w2, b2):
    """Plain version: the batched product pair over the expert axis."""
    h = F.gelu(torch.bmm(xe, w1) + b1[:, None, :])
    return torch.bmm(h, w2) + b2[:, None, :]


def _launch(xe, w1, b1, w2, b2):
    E, C, d = xe.shape
    hid = w1.shape[2]
    out = torch.empty_like(xe)
    global _fn
    if _fn is None:
        v, i = ctypes.c_void_p, ctypes.c_int
        _fn = _build.function("expert_ffn", "mc_expert_ffn",
                              [v, v, v, v, v, v, i, i, i, i, v])
    rc = _fn(xe.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
             out.data_ptr(), E, C, d, hid, _build.stream_ptr(xe.device))
    _build.check("expert_ffn", rc)
    fused_expert_ffn.launches += 1
    return out


def fused_expert_ffn(xe: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                     w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """xe [E, C, D], w1 [E, D, F], b1 [E, F], w2 [E, F, D], b2 [E, D] ->
    [E, C, D].  A CPU tensor takes the plain version; a CUDA tensor launches
    the kernel, differentiable through the plain version's gradient."""
    if xe.device.type == "cpu":
        return expert_ffn_plain(xe, w1, b1, w2, b2)
    if xe.device.type != "cuda":
        raise ValueError(f"fused_expert_ffn: unsupported device {xe.device}")
    E, C, d = xe.shape
    hid = w1.shape[2]
    tensors = (xe, w1, b1, w2, b2)
    if any(t.dtype != torch.float32 or t.device != xe.device for t in tensors):
        raise ValueError("fused_expert_ffn: xe, w1, b1, w2, b2 must be float32 on one device")
    if (w1.shape != (E, d, hid) or b1.shape != (E, hid) or w2.shape != (E, hid, d)
            or b2.shape != (E, d)):
        raise ValueError("fused_expert_ffn: inconsistent shapes")
    if d not in (32, 64, 128, 256) or hid % 32 or E > 65535:
        raise ValueError(f"fused_expert_ffn: kernel takes D in 32/64/128/256, F % 32 == 0 "
                         f"and E <= 65535, got D={d}, F={hid}, E={E}")
    xe, w1, b1, w2, b2 = (t.contiguous() for t in tensors)
    if any(t.data_ptr() % 16 for t in (xe, w1, w2)):
        raise ValueError("fused_expert_ffn: xe, w1, w2 must be 16-byte aligned")
    if E == 0 or C == 0:
        return torch.empty_like(xe)
    return with_recomputed_grad(_launch, expert_ffn_plain, xe, w1, b1, w2, b2)


fused_expert_ffn.launches = 0
