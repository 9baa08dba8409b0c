"""STMA global linear attention over the joint text + motion sequence
(kernel K3).

Replaces ``stma_linear_attention`` of
motioncraft_tpu/ops/pallas_stma_attention.py.  Per (batch, head): keys masked
additively by -1e6 (``src_mask`` on motion rows, the text-cond flag on text
rows), key softmax over the joint text ++ motion sequence, ``A = K^T V``
(d x d), query channel softmax, ``Y = Q A``.  On a CUDA tensor the wrapper
launches csrc/stma_attention.cu: one thread-block cluster of 4 CTAs per
(b, h) (2 at d = 16) reads its head's lanes of the interleaved projection in
place, each CTA a quarter of the joint text ++ motion sequence, once, with
an online per-channel key softmax; the CTAs merge their maxima, sums and
partial ``K^T V`` through distributed shared memory, and each applies the
query softmax to a quarter of the query rows and writes their output; both
products run in 3xTF32 on the tensor cores.  At the flagship the bound is
0.047 ms, by bytes (the key, value and query lanes of ``motion_feat``,
``text_feat`` and the output); the cluster fills the card with 1536 CTAs
and reads each key once.

bf16 ``motion_feat`` and ``text_feat`` (bf16 inference) launch the kernel's
bf16 instantiation, counted apart as ``stma_linear_attention_bf16``: it
loads bf16, computes in f32 and stores bf16, as the Pallas kernel upcasts
its operands and stores in ``motion_feat.dtype``; its bytes, and so its
bound, are half the f32 kernel's.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

NEG_INF = -1000000.0
_fns = {}  # C symbol -> its ctypes function


def stma_linear_attention_plain(motion_feat, text_feat, src_mask, text_cond):
    """Plain version: the concatenated-sequence softmax chain of STMA, in
    f32, stored in ``motion_feat.dtype``, as the Pallas kernel upcasts its
    operands (for f32 operands the casts do nothing)."""
    B, T, H, d4 = motion_feat.shape
    d = d4 // 4
    TXT = text_feat.shape[1]
    mot, txt = motion_feat.float(), text_feat.float()
    mask = src_mask.reshape(B, T, 1, 1).float()
    tcond = text_cond.reshape(B, 1, 1, 1).float()
    key_text = (txt[:, :, None, :d] + (1 - tcond) * NEG_INF).expand(B, TXT, H, d)
    value_text = (txt[:, :, None, d:] * tcond).expand(B, TXT, H, d)
    key_mot = mot[..., d:2 * d] + (1 - mask) * NEG_INF
    value_mot = mot[..., 2 * d:3 * d] * mask
    query = mot[..., 3 * d:]
    key = torch.cat([key_text, key_mot], dim=1).softmax(dim=1)
    value = torch.cat([value_text, value_mot], dim=1)
    att = torch.einsum("bnhd,bnhl->bhdl", key, value)
    out = torch.einsum("bthd,bhdl->bthl", query.softmax(dim=-1), att)
    return out.to(motion_feat.dtype)


def _aligned(t):
    """A contiguous, 16-byte aligned ``t`` (the kernel reads float4s)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(name, symbol, dtype, motion_feat, text_feat, src_mask, text_cond):
    B, T, H, d4 = motion_feat.shape
    d = d4 // 4
    TXT = text_feat.shape[1]
    if any(t.dtype != dtype or t.device != motion_feat.device
           for t in (motion_feat, text_feat)):
        raise ValueError(f"{name}: motion_feat and text_feat must be {dtype} on one device")
    if any(t.device != motion_feat.device or t.dtype != torch.float32
           for t in (src_mask, text_cond)):
        raise ValueError(f"{name}: src_mask and text_cond must be float32 on its device")
    if (d4 != 4 * d or text_feat.shape != (B, TXT, 2 * d)
            or src_mask.numel() != B * T or text_cond.numel() != B):
        raise ValueError(f"{name}: inconsistent shapes")
    if d not in (16, 32, 64, 128):
        raise ValueError(f"{name}: kernel takes d in 16/32/64/128, got {d}")
    mot, txt = _aligned(motion_feat), _aligned(text_feat)
    # the 0/1 mask and text flag are f32 in either dtype
    mask, tc = src_mask.reshape(B, T).contiguous(), text_cond.reshape(B).contiguous()
    out = torch.empty((B, T, H, d), dtype=dtype, device=mot.device)
    if B == 0 or T == 0:
        return out
    fn = _fns.get(symbol)
    if fn is None:
        v, i = ctypes.c_void_p, ctypes.c_int
        fn = _fns[symbol] = _build.function("stma_attention", symbol,
                                            [v, v, v, v, v, i, i, i, i, i, v])
    rc = fn(mot.data_ptr(), txt.data_ptr(), mask.data_ptr(), tc.data_ptr(),
            out.data_ptr(), B, T, TXT, H, d, _build.stream_ptr(mot.device))
    _build.check("stma_attention", rc)
    return out


def stma_linear_attention(motion_feat: torch.Tensor, text_feat: torch.Tensor,
                          src_mask: torch.Tensor, text_cond: torch.Tensor
                          ) -> torch.Tensor:
    """motion_feat [B, T, H, 4d] (body-value | key | value | query lanes),
    text_feat [B, TXT, 2d] (key | value, one text head), src_mask [B, T, 1]
    (1 = valid), text_cond [B, 1, 1] (1 = text on), both f32 in either
    dtype -> [B, T, H, d] in
    ``motion_feat.dtype``.  A CPU tensor takes the plain version; a CUDA
    tensor launches the kernel, its bf16 instantiation
    (``stma_linear_attention_bf16``) for bf16 features."""
    if motion_feat.device.type == "cpu":
        return stma_linear_attention_plain(motion_feat, text_feat, src_mask, text_cond)
    if motion_feat.device.type != "cuda":
        raise ValueError(f"stma_linear_attention: unsupported device {motion_feat.device}")
    if motion_feat.dtype == torch.bfloat16:
        return stma_linear_attention_bf16(motion_feat, text_feat, src_mask, text_cond)
    out = _launch("stma_linear_attention", "mc_stma_attention", torch.float32,
                  motion_feat, text_feat, src_mask, text_cond)
    if out.numel():
        stma_linear_attention.launches += 1
    return out


def stma_linear_attention_bf16(motion_feat: torch.Tensor, text_feat: torch.Tensor,
                               src_mask: torch.Tensor, text_cond: torch.Tensor
                               ) -> torch.Tensor:
    """``stma_linear_attention`` on bf16 features, bf16 out.  A CPU tensor
    takes the plain version; a CUDA tensor launches the bf16 kernel."""
    if motion_feat.device.type == "cpu":
        return stma_linear_attention_plain(motion_feat, text_feat, src_mask, text_cond)
    if motion_feat.device.type != "cuda":
        raise ValueError(f"stma_linear_attention_bf16: unsupported device "
                         f"{motion_feat.device}")
    out = _launch("stma_linear_attention_bf16", "mc_stma_attention_bf16", torch.bfloat16,
                  motion_feat, text_feat, src_mask, text_cond)
    if out.numel():
        stma_linear_attention_bf16.launches += 1
    return out


stma_linear_attention.launches = 0
stma_linear_attention_bf16.launches = 0


def max_active_clusters() -> int:
    """How many of the d = 128 kernel's clusters fit on the current card at
    once (``cudaOccupancyMaxActiveClusters``)."""
    clusters = ctypes.c_int(0)
    fn = _build.function("stma_attention", "mc_stma_max_active_clusters",
                         [ctypes.c_void_p])
    _build.check("stma_attention", fn(ctypes.addressof(clusters)))
    return clusters.value
