"""Wav2Vec2 audio encoder (a copy of motioncraft_tpu/models/wav2vec.py).

The reference's EMAGE stack wraps HuggingFace Wav2Vec2 for audio features
(EMAGE_2024/models/utils/wav2vec.py:72-146): the convolutional feature
extractor, linear interpolation of its ~49 fps frames to the motion frame
rate, the feature projection and the transformer encoder.  The JAX package
writes that topology natively in flax; the port writes it again in PyTorch
with the flax module and parameter names, so a flax ``params`` tree maps
onto it through ``utils/convert.py:from_jax_params``, and a HuggingFace
torch checkpoint through ``utils/torch_convert.py:convert_wav2vec2`` (the
positional convolution's weight norm folded into its kernel).

Inference semantics only (the condition path never trains the audio tower;
EMAGE freezes it too): no spec-augment masking, no dropout.  The
convolutions run as cuDNN's (TF32 off, ``architecture.exact_f32``) and the
attention as plain products and a softmax: no Pallas kernel runs here.  The
HuggingFace host wrapper (the JAX package's ``Wav2Vec2Encoder``, which
loads released weights through ``transformers``) is not ported.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .blocks import Conv1d, LayerNorm, Linear, promote_dtype


def linear_interpolate(x: torch.Tensor, output_len: int) -> torch.Tensor:
    """[B, T, C] -> [B, output_len, C], torch ``F.interpolate(mode='linear',
    align_corners=True)`` semantics, computed as the JAX package does: the
    sample positions in float64 on the host, the lerp in the tensor's
    dtype."""
    T = x.shape[1]
    if T == output_len:
        return x
    if T == 1:
        return x.expand(x.shape[0], output_len, x.shape[2])
    pos = np.arange(output_len, dtype=np.float64) * (T - 1) / (output_len - 1)
    lo_np = np.clip(np.floor(pos).astype(np.int64), 0, T - 2)
    lo = torch.from_numpy(lo_np).to(x.device)
    w = torch.from_numpy((pos - lo_np)[None, :, None]).to(device=x.device, dtype=x.dtype)
    return x[:, lo] * (1.0 - w) + x[:, lo + 1] * w


class GroupNorm(nn.GroupNorm):
    """flax's GroupNorm on [B, C, L] (eps 1e-5), promoting its input and
    affine parameters to one dtype."""

    def forward(self, x):
        x, w, b = promote_dtype(x, self.weight, self.bias)
        return F.group_norm(x, self.num_groups, w, b, self.eps)


class Wav2Vec2FeatureExtractor(nn.Module):
    """Strided conv stack over the raw 16 kHz waveform ('group' norm layout:
    GroupNorm after conv 0 only, the base-960h architecture):
    [B, samples] -> [B, frames, conv_dim[-1]]."""

    def __init__(self, conv_dim: Sequence[int] = (512,) * 7,
                 conv_kernel: Sequence[int] = (10, 3, 3, 3, 3, 2, 2),
                 conv_stride: Sequence[int] = (5, 2, 2, 2, 2, 2, 2)):
        super().__init__()
        self.num_conv = len(conv_dim)
        c_in = 1
        for i, (c, k, s) in enumerate(zip(conv_dim, conv_kernel, conv_stride)):
            self.add_module(f"conv_{i}", Conv1d(c_in, c, k, stride=s, bias=False))
            c_in = c
        self.group_norm = GroupNorm(conv_dim[0], conv_dim[0], eps=1e-5)

    def forward(self, wav):
        x = wav[:, None, :]  # [B, 1, S]
        for i in range(self.num_conv):
            x = getattr(self, f"conv_{i}")(x)
            if i == 0:
                x = self.group_norm(x)
            x = F.gelu(x)
        return x.transpose(1, 2)  # [B, frames, C]


class Wav2Vec2Attention(nn.Module):
    def __init__(self, hidden_size: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            self.add_module(name, Linear(hidden_size, hidden_size))

    def forward(self, x):
        B, T, D = x.shape
        H = self.num_heads
        hd = D // H
        q = self.q_proj(x) * (hd ** -0.5)
        k, v = self.k_proj(x), self.v_proj(x)
        q, k, v = (a.reshape(B, T, H, hd) for a in (q, k, v))
        attn = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k), dim=-1)
        y = torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(B, T, D)
        return self.out_proj(y)


class Wav2Vec2EncoderLayer(nn.Module):
    """Post-norm transformer layer (do_stable_layer_norm=False, the base
    architecture): x = ln(x + attn(x)); x = final_ln(x + ff(x))."""

    def __init__(self, hidden_size: int, num_heads: int, intermediate_size: int):
        super().__init__()
        self.attention = Wav2Vec2Attention(hidden_size, num_heads)
        self.layer_norm = LayerNorm(hidden_size)
        self.intermediate_dense = Linear(hidden_size, intermediate_size)
        self.output_dense = Linear(intermediate_size, hidden_size)
        self.final_layer_norm = LayerNorm(hidden_size)

    def forward(self, x):
        x = self.layer_norm(x + self.attention(x))
        h = self.output_dense(F.gelu(self.intermediate_dense(x)))
        return self.final_layer_norm(x + h)


class Wav2Vec2Module(nn.Module):
    """Full Wav2Vec2 ('group'-norm base layout): feature extractor ->
    optional EMAGE fps interpolation -> feature projection -> conv
    positional embedding + post-norm encoder stack."""

    def __init__(self, conv_dim: Sequence[int] = (512,) * 7,
                 conv_kernel: Sequence[int] = (10, 3, 3, 3, 3, 2, 2),
                 conv_stride: Sequence[int] = (5, 2, 2, 2, 2, 2, 2),
                 hidden_size: int = 768, num_layers: int = 12, num_heads: int = 12,
                 intermediate_size: int = 3072, num_conv_pos_embeddings: int = 128,
                 num_conv_pos_embedding_groups: int = 16):
        super().__init__()
        self.num_layers = num_layers
        self.feature_extractor = Wav2Vec2FeatureExtractor(conv_dim, conv_kernel, conv_stride)
        self.fp_layer_norm = LayerNorm(conv_dim[-1])
        self.fp_projection = Linear(conv_dim[-1], hidden_size)
        k = num_conv_pos_embeddings
        # grouped, half padding; an even kernel emits one extra frame that
        # is trimmed on the right
        self.pos_conv = Conv1d(hidden_size, hidden_size, k, padding=k // 2,
                               groups=num_conv_pos_embedding_groups)
        self.trim_pos = k % 2 == 0
        self.encoder_layer_norm = LayerNorm(hidden_size)
        for i in range(num_layers):
            self.add_module(f"layer_{i}", Wav2Vec2EncoderLayer(hidden_size, num_heads,
                                                               intermediate_size))

    def forward(self, wav, output_len: Optional[int] = None):
        """wav: [B, samples] raw 16 kHz.  ``output_len``: interpolate the
        ~49 fps conv features to this many frames BEFORE projection (the
        EMAGE alignment to the motion frame count)."""
        x = self.feature_extractor(wav)
        if output_len is not None:
            x = linear_interpolate(x, output_len)
        x = self.fp_projection(self.fp_layer_norm(x))
        pos = self.pos_conv(x.transpose(1, 2)).transpose(1, 2)
        if self.trim_pos:
            pos = pos[:, :-1]
        x = self.encoder_layer_norm(x + F.gelu(pos))
        for i in range(self.num_layers):
            x = getattr(self, f"layer_{i}")(x)
        return x  # [B, T, hidden]


class Wav2Vec2Conditioner(nn.Module):
    """ControlNet condition pre-encoder (``condition_pre_encode_type=
    'wav2vec'``): Wav2Vec2 over the raw-waveform lane, interpolated to the
    motion frame count, projected to the condition latent width."""

    def __init__(self, out_dim: int, wav2vec_cfg: Optional[dict] = None):
        super().__init__()
        self.wav2vec = Wav2Vec2Module(**(wav2vec_cfg or {}))
        self.proj = Linear(self.wav2vec.fp_projection.out_features, out_dim)

    def forward(self, c, seq_len: int):
        """c: [B, samples, F] (lane 0 the raw / amplitude waveform,
        data/beat2.py's onset + amplitude layout) or [B, samples] ->
        [B, seq_len, out_dim]."""
        wav = c[..., 0] if c.dim() == 3 else c
        return self.proj(self.wav2vec(wav, output_len=seq_len))
