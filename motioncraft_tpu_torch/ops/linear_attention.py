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
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .recompute import with_recomputed_grad

NEG_INF = -1000000.0
WIDTHS = (16, 32, 64, 128)  # the head widths the kernel is instantiated for
_fn = None


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
    """Plain version of K5 (the Pallas kernel's jnp ``_reference``)."""
    return masked_linear_attention(q_logits, k_logits, value)


def _aligned(t):
    """``t`` itself if the kernel can read it in place (unit stride on d,
    other strides multiples of 4, 16-byte aligned), else a contiguous copy."""
    if (t.stride(-1) == 1 and all(s % 4 == 0 for s in t.stride()[:3])
            and t.data_ptr() % 16 == 0):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _launch(q_logits, k_logits, value):
    B, T, H, d = q_logits.shape
    N = k_logits.shape[1]
    out = torch.empty((B, T, H, d), dtype=torch.float32, device=q_logits.device)
    global _fn
    if _fn is None:
        v, i = ctypes.c_void_p, ctypes.c_int
        _fn = _build.function("linear_attention", "mc_linear_attention",
                              [v, v, v, v, i, i, i, i, i, v, v])
    strides = (ctypes.c_longlong * 9)(*(s for t in (q_logits, k_logits, value)
                                        for s in (t.stride(0), t.stride(1), t.stride(2))))
    rc = _fn(q_logits.data_ptr(), k_logits.data_ptr(), value.data_ptr(), out.data_ptr(),
             B, T, N, H, d, ctypes.cast(strides, ctypes.c_void_p),
             _build.stream_ptr(q_logits.device))
    _build.check("linear_attention", rc)
    fused_linear_attention.launches += 1
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


def fused_linear_attention(q_logits: torch.Tensor, k_logits: torch.Tensor,
                           value: torch.Tensor) -> torch.Tensor:
    """q_logits [B,T,H,d], k_logits [B,N,H,d] (additively masked), value
    [B,N,H,d] (multiplicatively masked) -> [B,T,H,d].  A CPU tensor takes
    the plain version; a CUDA tensor launches the kernel (any strides, unit
    stride on d), differentiable through the plain version's gradient.  A
    d the kernel is not instantiated for (MCM's channel attention, 196 / 4
    = 49) runs padded to the next width (``pad_heads``), the output cut
    back to d."""
    if q_logits.device.type == "cpu":
        return fused_linear_attention_plain(q_logits, k_logits, value)
    if q_logits.device.type != "cuda":
        raise ValueError(f"fused_linear_attention: unsupported device {q_logits.device}")
    B, T, H, d = q_logits.shape
    N = k_logits.shape[1]
    tensors = (q_logits, k_logits, value)
    if any(t.dtype != torch.float32 or t.device != q_logits.device for t in tensors):
        raise ValueError("fused_linear_attention: operands must be float32 on one device")
    if k_logits.shape != (B, N, H, d) or value.shape != (B, N, H, d):
        raise ValueError("fused_linear_attention: inconsistent shapes")
    width = padded_width(d)
    if 4 * B > 2 ** 31 - 1 or H > 65535:  # grid (4 B, H): a cluster of 4 per cell
        raise ValueError("fused_linear_attention: grid too large")
    if B == 0 or T == 0 or H == 0:
        return q_logits.new_empty((B, T, H, d))
    if width != d:
        return fused_linear_attention(*pad_heads(*tensors, width))[..., :d]
    q, k, v = (_aligned(t) for t in tensors)
    return with_recomputed_grad(_launch, fused_linear_attention_plain, q, k, v)


fused_linear_attention.launches = 0
