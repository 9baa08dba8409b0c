"""STMA global linear attention over the joint text + motion sequence
(kernel K3).

Replaces ``stma_linear_attention`` of
motioncraft_tpu/ops/pallas_stma_attention.py.  Per (batch, head): keys masked
additively by -1e6 (``src_mask`` on motion rows, the text-cond flag on text
rows), key softmax over the joint text ++ motion sequence, ``A = K^T V``
(d x d), query channel softmax, ``Y = Q A``.  On a CUDA tensor the wrapper
launches csrc/stma_attention.cu: one CTA per (b, h) reads its head's lanes of
the interleaved projection in place, computes the joint softmax as a two-part
(text, motion) max and sum per channel, keeps A in shared memory and writes
only the output.  Bound by f32 operations, narrowly (about 26 flops per byte
at the flagship against a ridge of 20).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

NEG_INF = -1000000.0
_fn = None


def stma_linear_attention_plain(motion_feat, text_feat, src_mask, text_cond):
    """Plain version: the concatenated-sequence softmax chain of STMA."""
    B, T, H, d4 = motion_feat.shape
    d = d4 // 4
    TXT = text_feat.shape[1]
    mask = src_mask.reshape(B, T, 1, 1)
    tcond = text_cond.reshape(B, 1, 1, 1)
    key_text = (text_feat[:, :, None, :d] + (1 - tcond) * NEG_INF).expand(B, TXT, H, d)
    value_text = (text_feat[:, :, None, d:] * tcond).expand(B, TXT, H, d)
    key_mot = motion_feat[..., d:2 * d] + (1 - mask) * NEG_INF
    value_mot = motion_feat[..., 2 * d:3 * d] * mask
    query = motion_feat[..., 3 * d:]
    key = torch.cat([key_text, key_mot], dim=1).softmax(dim=1)
    value = torch.cat([value_text, value_mot], dim=1)
    att = torch.einsum("bnhd,bnhl->bhdl", key, value)
    return torch.einsum("bthd,bhdl->bthl", query.softmax(dim=-1), att)


def stma_linear_attention(motion_feat: torch.Tensor, text_feat: torch.Tensor,
                          src_mask: torch.Tensor, text_cond: torch.Tensor
                          ) -> torch.Tensor:
    """motion_feat [B, T, H, 4d] (body-value | key | value | query lanes),
    text_feat [B, TXT, 2d] (key | value, one text head), src_mask [B, T, 1]
    (1 = valid), text_cond [B, 1, 1] (1 = text on) -> [B, T, H, d].
    A CPU tensor takes the plain version; a CUDA tensor launches the kernel."""
    if motion_feat.device.type == "cpu":
        return stma_linear_attention_plain(motion_feat, text_feat, src_mask, text_cond)
    if motion_feat.device.type != "cuda":
        raise ValueError(f"stma_linear_attention: unsupported device {motion_feat.device}")
    B, T, H, d4 = motion_feat.shape
    d = d4 // 4
    TXT = text_feat.shape[1]
    tensors = (motion_feat, text_feat, src_mask, text_cond)
    if any(t.dtype != torch.float32 or t.device != motion_feat.device for t in tensors):
        raise ValueError("stma_linear_attention: operands must be float32 on one device")
    if (d4 != 4 * d or text_feat.shape != (B, TXT, 2 * d)
            or src_mask.numel() != B * T or text_cond.numel() != B):
        raise ValueError("stma_linear_attention: inconsistent shapes")
    if d not in (16, 32, 64, 128):
        raise ValueError(f"stma_linear_attention: kernel takes d in 16/32/64/128, got {d}")
    mot, txt = motion_feat.contiguous(), text_feat.contiguous()
    mask, tc = src_mask.reshape(B, T).contiguous(), text_cond.reshape(B).contiguous()
    out = torch.empty((B, T, H, d), dtype=torch.float32, device=mot.device)
    if B == 0 or T == 0:
        return out
    global _fn
    if _fn is None:
        v, i = ctypes.c_void_p, ctypes.c_int
        _fn = _build.function("stma_attention", "mc_stma_attention",
                              [v, v, v, v, v, i, i, i, i, i, v])
    rc = _fn(mot.data_ptr(), txt.data_ptr(), mask.data_ptr(), tc.data_ptr(),
             out.data_ptr(), B, T, TXT, H, d, _build.stream_ptr(mot.device))
    _build.check("stma_attention", rc)
    stma_linear_attention.launches += 1
    return out


stma_linear_attention.launches = 0
