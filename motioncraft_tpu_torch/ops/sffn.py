"""Per-head (body-part) FFN over the interleaved head layout (kernel K2).

Replaces ``head_ffn`` of motioncraft_tpu/ops/pallas_sffn.py.  Per head h:

    y_h = gelu_erf(x_h @ w1[h] + b1[h]) @ w2[h] + b2[h]

over rows of the interleaved ``[N, H*d]`` matrix.  On a CUDA tensor the
wrapper launches csrc/sffn.cu: a (row tile, head) grid whose CTAs read their
head's columns in place (no transposes) and keep the hidden activation in
shared memory.  Bound by f32 operations (4*d*f flops per row and head
against 8*d bytes); exact f32 rules out TF32 tensor cores.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build

_fn = None


def head_ffn_plain(x, w1, b1, w2, b2):
    """Plain version: the per-head einsum pair."""
    n, hd = x.shape
    heads, d, _ = w1.shape
    h = F.gelu(torch.einsum("nhd,hdf->nhf", x.reshape(n, heads, d), w1) + b1)
    return (torch.einsum("nhf,hfd->nhd", h, w2) + b2).reshape(n, hd)


def head_ffn(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
             w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """x [N, H*d] -> [N, H*d]; w1 [H, d, f], b1 [H, f], w2 [H, f, d],
    b2 [H, d].  A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel."""
    if x.device.type == "cpu":
        return head_ffn_plain(x, w1, b1, w2, b2)
    if x.device.type != "cuda":
        raise ValueError(f"head_ffn: unsupported device {x.device}")
    n, hd = x.shape
    heads, d, f = w1.shape
    tensors = (x, w1, b1, w2, b2)
    if any(t.dtype != torch.float32 or t.device != x.device for t in tensors):
        raise ValueError("head_ffn: all operands must be float32 on one device")
    if (hd != heads * d or b1.shape != (heads, f) or w2.shape != (heads, f, d)
            or b2.shape != (heads, d)):
        raise ValueError("head_ffn: inconsistent shapes")
    if d not in (32, 64, 128, 256) or f % 32:
        raise ValueError(f"head_ffn: kernel takes d in 32/64/128/256 and f % 32 == 0, "
                         f"got d={d}, f={f}")
    x, w1, b1, w2, b2 = (t.contiguous() for t in tensors)
    if any(t.data_ptr() % 16 for t in (x, w1, w2)):
        raise ValueError("head_ffn: x, w1, w2 must be 16-byte aligned")
    out = torch.empty_like(x)
    if n == 0:
        return out
    global _fn
    if _fn is None:
        v, i = ctypes.c_void_p, ctypes.c_int
        _fn = _build.function("sffn", "mc_head_ffn", [v, v, v, v, v, v, i, i, i, i, v])
    rc = _fn(x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
             b2.data_ptr(), out.data_ptr(), n, heads, d, f,
             _build.stream_ptr(x.device))
    _build.check("sffn", rc)
    head_ffn.launches += 1
    return out


head_ffn.launches = 0
