"""Per-head (body-part) FFN over the interleaved head layout (kernel K2).

Replaces ``head_ffn`` of motioncraft_tpu/ops/pallas_sffn.py.  Per head h:

    y_h = gelu_erf(x_h @ w1[h] + b1[h]) @ w2[h] + b2[h]

over rows of the interleaved ``[N, H*d]`` matrix.  On a CUDA tensor the
wrapper launches csrc/sffn.cu: K1's tensor-core FFN tile on a (row tile,
head) grid, whose CTAs read their head's columns in place (no transposes),
keep the hidden activation in registers and run both products in 3xTF32
(f32 accuracy).  Bound by operations (4*d*f flops per row and head against
8*d bytes).

bf16 operands (bf16 inference) launch the kernel's bf16 instantiation,
counted apart as ``head_ffn_bf16``: bf16 products with f32 accumulation, the
hidden rounded to bf16, b2 added in f32 and the output stored in bf16, as
the Pallas kernel computes on bf16 operands.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build

_fns = {}  # C symbol -> its ctypes function


def head_ffn_plain(x, w1, b1, w2, b2):
    """Plain version: the per-head einsum pair in f32, with the hidden
    rounded to ``x.dtype`` before the second product, b2 added in f32 and
    the output stored in ``x.dtype``, as the Pallas kernel does (for f32
    operands the casts do nothing)."""
    n, hd = x.shape
    heads, d, _ = w1.shape
    h = F.gelu(torch.einsum("nhd,hdf->nhf", x.reshape(n, heads, d).float(), w1.float())
               + b1.float())
    y = torch.einsum("nhf,hfd->nhd", h.to(x.dtype).float(), w2.float()) + b2.float()
    return y.reshape(n, hd).to(x.dtype)


def _launch(name, symbol, dtype, x, w1, b1, w2, b2):
    n, hd = x.shape
    heads, d, f = w1.shape
    tensors = (x, w1, b1, w2, b2)
    if any(t.dtype != dtype or t.device != x.device for t in tensors):
        raise ValueError(f"{name}: all operands must be {dtype} on one device")
    if (hd != heads * d or b1.shape != (heads, f) or w2.shape != (heads, f, d)
            or b2.shape != (heads, d)):
        raise ValueError(f"{name}: inconsistent shapes")
    if d not in (32, 64, 128, 256) or f % 32:
        raise ValueError(f"{name}: kernel takes d in 32/64/128/256 and f % 32 == 0, "
                         f"got d={d}, f={f}")
    x, w1, b1, w2, b2 = (t.contiguous() for t in tensors)
    if any(t.data_ptr() % 16 for t in (x, w1, w2)):
        raise ValueError(f"{name}: x, w1, w2 must be 16-byte aligned")
    out = torch.empty_like(x)
    if n == 0:
        return out
    fn = _fns.get(symbol)
    if fn is None:
        v, i = ctypes.c_void_p, ctypes.c_int
        fn = _fns[symbol] = _build.function("sffn", symbol, [v, v, v, v, v, v, i, i, i, i, v])
    rc = fn(x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
            out.data_ptr(), n, heads, d, f, _build.stream_ptr(x.device))
    _build.check("sffn", rc)
    return out


def head_ffn(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
             w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """x [N, H*d] -> [N, H*d]; w1 [H, d, f], b1 [H, f], w2 [H, f, d],
    b2 [H, d].  A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel, its bf16 instantiation (``head_ffn_bf16``) for
    bf16 operands."""
    if x.device.type == "cpu":
        return head_ffn_plain(x, w1, b1, w2, b2)
    if x.device.type != "cuda":
        raise ValueError(f"head_ffn: unsupported device {x.device}")
    if x.dtype == torch.bfloat16:
        return head_ffn_bf16(x, w1, b1, w2, b2)
    out = _launch("head_ffn", "mc_head_ffn", torch.float32, x, w1, b1, w2, b2)
    if x.shape[0]:
        head_ffn.launches += 1
    return out


def head_ffn_bf16(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                  w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """``head_ffn`` on bf16 operands, bf16 out.  A CPU tensor takes the
    plain version; a CUDA tensor launches the bf16 kernel."""
    if x.device.type == "cpu":
        return head_ffn_plain(x, w1, b1, w2, b2)
    if x.device.type != "cuda":
        raise ValueError(f"head_ffn_bf16: unsupported device {x.device}")
    out = _launch("head_ffn_bf16", "mc_head_ffn_bf16", torch.bfloat16, x, w1, b1, w2, b2)
    if x.shape[0]:
        head_ffn_bf16.launches += 1
    return out


head_ffn.launches = 0
head_ffn_bf16.launches = 0
