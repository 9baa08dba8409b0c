"""Masked linear attention per (batch, head) (kernel K5).

Replaces ``fused_linear_attention`` of motioncraft_tpu/ops/pallas_attention.py;
its plain version is ``linear_attention_core`` / ``masked_linear_attention``
of motioncraft_tpu/ops/linear_attention.py.  Per (batch, head), with the
masks already applied by the caller: key softmax over the sequence,
``A = K^T V`` (d x d), query softmax over the channels, ``Y = Q A``.

On a CUDA tensor the wrapper launches csrc/linear_attention.cu, K3's
split-sequence cell: one thread-block cluster of 4 CTAs per (b, h) reads the
[B, N, H, d] tensors in place through their strides, each CTA a quarter of
the keys and values, once; the CTAs merge their online key softmaxes and
partial ``K^T V`` through distributed shared memory, and each writes the
output of a quarter of the query rows.  At the flagship training step the
bound is 0.055 ms, by bytes (both products in 3xTF32 on the tensor cores);
the cluster fills the card with 1536 CTAs and reads each key once.  The
gradient recomputes the plain version (ops/recompute.py), as the Pallas
kernel's custom VJP does.

The operands' dtypes pick the instantiation, as the JAX package's dispatch
(``_reference``, which promotes) gives the output's dtype, and that dtype
decides whether the layers after the call run in bf16 or f32:

  - all three bf16 (bf16 inference of the baselines): the bf16 kernel,
    counted apart as ``fused_linear_attention_bf16``, bf16 out.  It loads
    and stores bf16 (half the f32 kernel's bytes and bound) and rounds the
    merged ``A`` and the query softmax to bf16 as the Pallas kernel does on
    a bf16 value; its plain version (``fused_linear_attention_plain_bf16``)
    is the Pallas body's order of operations;
  - any operand f32, the others bf16: the bf16 ones widened to f32 (exact)
    into the f32 kernel, f32 out, as ``_reference`` promotes;
  - anything else (float16: K5 has no f16 instantiation, and no float16
    training step hands it one; float64; operands on two devices): raise.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .recompute import with_recomputed_grad

NEG_INF = -1000000.0
WIDTHS = (16, 32, 64, 128)  # the head widths the kernel is instantiated for
_fns = {}  # C symbol -> its ctypes function


def linear_attention_core(query, key, value):
    """query [B,T,H,d] (softmaxed over d), key [B,N,H,d] (softmaxed over N),
    value [B,N,H,l] (masked) -> [B,T,H,l]."""
    attention = torch.einsum("bnhd,bnhl->bhdl", key, value)
    return torch.einsum("bthd,bhdl->bthl", query, attention)


def masked_linear_attention(q_logits, k_logits, value, key_mask=None):
    """The reference's conventions: keys masked additively at -1e6 (already,
    or through ``key_mask`` [B,N,1,1]), key softmax over the sequence, query
    softmax over the channels, then the contraction."""
    if key_mask is not None:
        k_logits = k_logits + (1 - key_mask) * NEG_INF
    return linear_attention_core(q_logits.softmax(dim=-1), k_logits.softmax(dim=1), value)


def fused_linear_attention_plain(q_logits, k_logits, value):
    """Plain version of K5 (the Pallas kernel's jnp ``_reference``) in f32:
    bf16 operands beside an f32 one widened, as the wrapper's f32 path
    takes them (on f32 operands the casts do nothing)."""
    return masked_linear_attention(q_logits.float(), k_logits.float(), value.float())


def fused_linear_attention_plain_bf16(q_logits, k_logits, value):
    """Plain version of K5 on bf16 operands, in the Pallas body's order
    (pallas_attention.py ``_kernel``): the key softmax over the sequence in
    f32, rounded to bf16; ``A = K^T V`` accumulated in f32, rounded to bf16;
    the query softmax over the channels in f32, rounded to bf16; ``Q A``
    accumulated in f32, stored in bf16."""
    bf = torch.bfloat16
    k = k_logits.float()
    k_exp = torch.exp(k - k.amax(dim=1, keepdim=True))
    k_soft = (k_exp / (k_exp.sum(dim=1, keepdim=True) + 1e-30)).to(bf)
    att = torch.einsum("bnhd,bnhl->bhdl", k_soft.float(), value.float()).to(bf)
    q = q_logits.float()
    q_exp = torch.exp(q - q.amax(dim=-1, keepdim=True))
    q_soft = (q_exp / (q_exp.sum(dim=-1, keepdim=True) + 1e-30)).to(bf)
    return torch.einsum("bthd,bhdl->bthl", q_soft.float(), att.float()).to(bf)


def _aligned(t):
    """``t`` itself if the kernel can read it in place (unit stride on d,
    other strides multiples of 4, 16-byte aligned), else a contiguous copy."""
    if (t.stride(-1) == 1 and all(s % 4 == 0 for s in t.stride()[:3])
            and t.data_ptr() % 16 == 0):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _launch(symbol, q_logits, k_logits, value):
    B, T, H, d = q_logits.shape
    N = k_logits.shape[1]
    out = torch.empty((B, T, H, d), dtype=q_logits.dtype, device=q_logits.device)
    fn = _fns.get(symbol)
    if fn is None:
        v, i = ctypes.c_void_p, ctypes.c_int
        fn = _fns[symbol] = _build.function("linear_attention", symbol,
                                            [v, v, v, v, i, i, i, i, i, v, v])
    strides = (ctypes.c_longlong * 9)(*(s for t in (q_logits, k_logits, value)
                                        for s in (t.stride(0), t.stride(1), t.stride(2))))
    rc = fn(q_logits.data_ptr(), k_logits.data_ptr(), value.data_ptr(), out.data_ptr(),
            B, T, N, H, d, ctypes.cast(strides, ctypes.c_void_p),
            _build.stream_ptr(q_logits.device))
    _build.check("linear_attention", rc)
    return out


def _launch_f32(q_logits, k_logits, value):
    out = _launch("mc_linear_attention", q_logits, k_logits, value)
    fused_linear_attention.launches += 1
    return out


def _launch_bf16(q_logits, k_logits, value):
    out = _launch("mc_linear_attention_bf16", q_logits, k_logits, value)
    fused_linear_attention_bf16.launches += 1
    return out


def padded_width(d: int) -> int:
    """The kernel's instantiated head width that a call at ``d`` runs at:
    the smallest of 16, 32, 64 and 128 that holds it."""
    for w in WIDTHS:
        if d <= w:
            return w
    raise ValueError(f"fused_linear_attention: kernel takes d up to {WIDTHS[-1]}, got {d}")


def pad_heads(q_logits, k_logits, value, width: int):
    """The three operands widened from d to ``width`` channels: the query
    logits with NEG_INF (their channel softmax is exactly 0 there), the key
    logits and the values with 0 (the extra channels of K^T V meet a query
    weight of 0, and the extra output channels are 0).  Cutting the output
    back to d gives the function at d."""
    d = q_logits.shape[-1]
    pad = (0, width - d)
    return (torch.nn.functional.pad(q_logits, pad, value=NEG_INF),
            torch.nn.functional.pad(k_logits, pad), torch.nn.functional.pad(value, pad))


def _check(name, q_logits, k_logits, value, dtype):
    """The wrapper's checks on a CUDA call: device, dtype, shapes, grid."""
    B, T, H, d = q_logits.shape
    N = k_logits.shape[1]
    tensors = (q_logits, k_logits, value)
    if any(t.dtype != dtype or t.device != q_logits.device for t in tensors):
        raise ValueError(f"{name}: operands must be {dtype} on one device")
    if k_logits.shape != (B, N, H, d) or value.shape != (B, N, H, d):
        raise ValueError(f"{name}: inconsistent shapes")
    if 4 * B > 2 ** 31 - 1 or H > 65535:  # grid (4 B, H): a cluster of 4 per cell
        raise ValueError(f"{name}: grid too large")


def _run(name, launch, plain, q_logits, k_logits, value, dtype):
    """Checks, the empty case, the padded head width, then the kernel
    (differentiable through ``plain``'s gradient)."""
    _check(name, q_logits, k_logits, value, dtype)
    B, T, H, d = q_logits.shape
    width = padded_width(d)
    if B == 0 or T == 0 or H == 0:
        return q_logits.new_empty((B, T, H, d))
    tensors = (q_logits, k_logits, value)
    if width != d:
        return _run(name, launch, plain, *pad_heads(*tensors, width), dtype)[..., :d]
    q, k, v = (_aligned(t) for t in tensors)
    return with_recomputed_grad(launch, plain, q, k, v)


def fused_linear_attention(q_logits: torch.Tensor, k_logits: torch.Tensor,
                           value: torch.Tensor) -> torch.Tensor:
    """q_logits [B,T,H,d], k_logits [B,N,H,d] (additively masked), value
    [B,N,H,d] (multiplicatively masked) -> [B,T,H,d].  A CPU tensor takes
    the plain version; a CUDA tensor launches the kernel (any strides, unit
    stride on d), differentiable through the plain version's gradient.  A
    d the kernel is not instantiated for (MCM's channel attention, 196 / 4
    = 49) runs padded to the next width (``pad_heads``), the output cut
    back to d.  Three bf16 operands go to ``fused_linear_attention_bf16``
    (bf16 out); bf16 ones beside an f32 one are widened to f32 (f32 out);
    other dtypes raise."""
    dtypes = {q_logits.dtype, k_logits.dtype, value.dtype}
    if dtypes == {torch.bfloat16}:
        return fused_linear_attention_bf16(q_logits, k_logits, value)
    if torch.float16 in dtypes:
        raise ValueError("fused_linear_attention: float16 operands: K5 has no f16 "
                         "instantiation (ROADMAP queue 2); it takes float32 or bfloat16")
    if not dtypes <= {torch.float32, torch.bfloat16}:
        raise ValueError(f"fused_linear_attention: operands must be float32 or bfloat16, "
                         f"got {sorted(str(t) for t in dtypes)}")
    q_logits, k_logits, value = (t.float() for t in (q_logits, k_logits, value))
    if q_logits.device.type == "cpu":
        return fused_linear_attention_plain(q_logits, k_logits, value)
    if q_logits.device.type != "cuda":
        raise ValueError(f"fused_linear_attention: unsupported device {q_logits.device}")
    return _run("fused_linear_attention", _launch_f32, fused_linear_attention_plain,
                q_logits, k_logits, value, torch.float32)


def fused_linear_attention_bf16(q_logits: torch.Tensor, k_logits: torch.Tensor,
                                value: torch.Tensor) -> torch.Tensor:
    """``fused_linear_attention`` on three bf16 operands, bf16 out.  A CPU
    tensor takes the plain bf16 version; a CUDA tensor launches the bf16
    kernel.  The padded head width pads the query logits at NEG_INF, which
    is -999424 in bf16: their channel softmax is still exactly 0 there."""
    if q_logits.device.type == "cpu":
        return fused_linear_attention_plain_bf16(q_logits, k_logits, value)
    if q_logits.device.type != "cuda":
        raise ValueError(f"fused_linear_attention_bf16: unsupported device "
                         f"{q_logits.device}")
    return _run("fused_linear_attention_bf16", _launch_bf16,
                fused_linear_attention_plain_bf16, q_logits, k_logits, value,
                torch.bfloat16)


fused_linear_attention.launches = 0
fused_linear_attention_bf16.launches = 0
