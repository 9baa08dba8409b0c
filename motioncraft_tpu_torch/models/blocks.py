"""Shared neural blocks (PyTorch port of motioncraft_tpu/models/blocks.py).

  - LayerNorm: torch's, eps 1e-5 (the reference's nn.LayerNorm), and
    Linear / Conv1d: torch's, each promoting as flax does (below)
  - QLinear: the int8 counterpart of the JAX package's QDense, which
    ops/quant.py:quantize_ puts in place of an eligible nn.Linear: W8A8
    (``kernel_scale``: per-row int8 activations, int32 products) or W8
    (``kernel_wscale``: the weight dequantized into the float product)
  - timestep_embedding: sinusoidal, cos first then sin
  - ZeroDense / StylizationBlock: AdaLN-style time conditioning
  - FFN: the baselines' GELU FFN with a stylized residual
  - SFFN: the per-head (body-part) FFN, through kernel K2 (ops/sffn.py) at
    inference; in training the plain einsum pair with dropout, as the JAX
    package trains it.  Int8 weights (ops/quant.py): W8 dequantizes w1/w2
    to the activations' dtype and runs K2; W8A8 runs the per-head int8
    product pair with GELU between
  - ConvBasicBlock1D / WavEncoder: the speech condition's raw-audio conv
    encoder, with BatchNorm statistics (buffers ``running_mean`` /
    ``running_var``, flax's ``batch_stats`` ``mean`` / ``var``); in
    training its BatchNorm is flax's (``FlaxBatchNorm1d``)

Module and parameter names follow the flax modules, so a flax ``params``
tree maps onto the ``state_dict`` by name (utils/convert.py).  GELU is the
exact erf form everywhere.

Mixed precision: ``promote_dtype`` is flax's ``promote_dtype`` (every
floating operand cast to their common type, bf16 with f32 -> f32), and
``Linear``, ``LayerNorm`` and ``Conv1d`` apply it to their input and
weights as flax's Dense, LayerNorm and Conv do; a product of an activation
with a parameter elsewhere (the per-head einsums, the MoE's expert FFN and
combine) calls it itself.  So under bf16 parameters a bf16 activation
computes in bf16 and an f32 one in f32 on the rounded weights.  bf16 training
(apis/train.py:make_train_step(fp16=)) relies on that: its motion path
stays f32, its text path bf16.  bf16 inference rounds every floating
parameter and buffer to bf16 (apis/factory.py:bf16_cast_) and casts the
motion to bf16; the modules that flax promotes to f32 there (an f32 input
meeting bf16 weights: the time embedding, the MoE gate's projector, the
condition encoder) hold f32 tensors of the rounded values.  LayerNorm on
bf16 computes its statistics and affine in f32 and rounds its output, as
flax's does.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.quant import dequant, qdot, qeinsum, quantize_weight
from ..ops.sffn import head_ffn
from ..parallel.mesh import ACROSS_CARDS, draw_rows
from ..parallel.tp import split_axis
from ..utils.dist_utils import all_reduce_sum, tp_copy, tp_reduce


def promote_dtype(*tensors):
    """flax's ``promote_dtype``: the tensors (None passes through) cast to
    their common floating type, so bf16 meeting f32 computes in f32."""
    dtype = functools.reduce(torch.promote_types,
                             [t.dtype for t in tensors if t is not None])
    return tuple(t if t is None or t.dtype == dtype else t.to(dtype) for t in tensors)


class Linear(nn.Linear):
    """``nn.Linear`` that promotes its input, weight and bias to one dtype,
    as flax's Dense does (torch's raises on mixed dtypes)."""

    def forward(self, x):
        x, w, b = promote_dtype(x, self.weight, self.bias)
        return F.linear(x, w, b)


class Conv1d(nn.Conv1d):
    """``nn.Conv1d`` that promotes its input, weight and bias to one dtype,
    as flax's Conv does."""

    def forward(self, x):
        x, w, b = promote_dtype(x, self.weight, self.bias)
        return self._conv_forward(x, w, b)


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` (eps 1e-5 by default, as the reference) that
    promotes its input and affine parameters to one dtype, as flax's does."""

    def forward(self, x):
        x, w, b = promote_dtype(x, self.weight, self.bias)
        return F.layer_norm(x, self.normalized_shape, w, b, self.eps)


def dropout(x, p: float, training: bool, generator=None, mesh=None, split=None):
    """flax's ``nn.Dropout``: in training, each element kept with
    probability 1 - p (a Bernoulli draw from ``generator``, default torch's
    generator of ``x``'s device) and scaled by 1 / (1 - p), else 0; ``x``
    itself otherwise.  On a data mesh the mask is drawn at the global
    batch's shape and the rank keeps its rows (parallel/mesh.py:draw_rows);
    where ``x``'s last dim is this rank's slice of a dim split over the
    tensor group ``split`` (a column-parallel product's output), the mask
    is drawn at the whole width and the rank keeps its columns."""
    if not training or p == 0.0:
        return x
    shape = x.shape
    if split is not None and split.size > 1:
        shape = shape[:-1] + (shape[-1] * split.size,)
    keep = draw_rows(mesh, lambda s: x.new_empty(s).bernoulli_(
        1.0 - p, generator=generator), shape)
    if shape != x.shape:
        keep = keep.narrow(-1, split.rank * x.shape[-1], x.shape[-1])
    return x * keep / (1.0 - p)


def tensor_comm(module: nn.Module, owner: nn.Module, leaf: str, dim: int):
    """The tensor group that splits dim ``dim`` of ``owner``'s parameter
    ``leaf`` (parallel/tp.py:shard_module_) over ``module``'s mesh, or
    None where it is whole."""
    axis = split_axis(owner, leaf, dim)
    if axis is None:
        return None
    if module.mesh is None:
        raise RuntimeError(f"a sharded {type(module).__name__} computes over its mesh: "
                           "attach_mesh")
    return module.mesh.comm(axis)


def row_parallel(linear: nn.Linear, y, comm):
    """``linear(y)`` of a row-parallel Linear (its weight's input dim split
    over ``comm``): this rank's partial product, summed over the group,
    then the bias, once (Megatron's g)."""
    if comm is None:
        return linear(y)
    y, w, b = promote_dtype(y, linear.weight, linear.bias)
    out = tp_reduce(F.linear(y, w), comm)
    return out if b is None else out + b


def timestep_embedding(timesteps: torch.Tensor, dim: int,
                       max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal timestep embedding; cos first then sin, as the reference."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=timesteps.device)
                      / half)
    args = timesteps[:, None].to(torch.float32) * freqs[None]
    embedding = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        embedding = torch.cat([embedding, torch.zeros_like(embedding[:, :1])], dim=-1)
    return embedding


class QLinear(nn.Module):
    """An ``nn.Linear`` with int8 weights (the JAX package's QDense on an
    int8 kernel).  ``weight`` [out, in] int8; the scale keeps the flax
    layout [1, out] and names the mode: ``kernel_scale`` W8A8 (per-row
    dynamic activation quantization, int32 products, out in the
    activations' dtype), ``kernel_wscale`` W8 (the weight dequantized to
    the activations' dtype into the float product).  The bias stays float
    and is added in the output's dtype."""

    def __init__(self, weight: torch.Tensor, scale: torch.Tensor, bias=None,
                 weight_only: bool = False):
        super().__init__()
        self.out_features, self.in_features = weight.shape
        self.weight_only = weight_only
        self.register_buffer("weight", weight)
        self.register_buffer("kernel_wscale" if weight_only else "kernel_scale", scale)
        self.bias = None if bias is None else nn.Parameter(bias, requires_grad=False)

    @classmethod
    def from_linear(cls, linear: nn.Linear, weight_only: bool = False) -> "QLinear":
        wq, scale = quantize_weight(linear.weight.detach(), 1)  # per output row
        bias = None if linear.bias is None else linear.bias.detach()
        return cls(wq, scale.t().contiguous(), bias, weight_only)

    def forward(self, x):
        if self.weight_only:
            w = dequant(self.weight, self.kernel_wscale.reshape(-1, 1), x.dtype)
            y = F.linear(x, w)
        else:
            y = qdot(x, self.weight.t(), self.kernel_scale)
        return y if self.bias is None else y + self.bias.to(y.dtype)


class ZeroDense(nn.Module):
    """Linear with zero-initialised weight and bias (zero_module semantics)."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.linear = Linear(in_features, features)
        nn.init.zeros_(self.linear.weight)
        nn.init.zeros_(self.linear.bias)

    def forward(self, x):
        return self.linear(x)


class StylizationBlock(nn.Module):
    """AdaLN conditioning: time-emb -> (scale, shift); zero-init output."""

    mesh = None  # the data mesh of training (parallel/mesh.py:attach_mesh)

    def __init__(self, latent_dim: int, time_embed_dim: int, dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.emb_layers = Linear(time_embed_dim, 2 * latent_dim)
        self.norm = LayerNorm(latent_dim)
        self.out_layers = ZeroDense(latent_dim, latent_dim)

    def forward(self, h, emb):
        emb_out = self.emb_layers(F.silu(emb))[:, None, :]
        scale, shift = emb_out.chunk(2, dim=-1)
        h = self.norm(h) * (1 + scale) + shift
        return self.out_layers(dropout(F.silu(h), self.dropout, self.training,
                                       mesh=self.mesh))


class FFN(nn.Module):
    """The baselines' FFN: Linear -> exact GELU -> zero-init Linear, added to
    its input through a StylizationBlock."""

    mesh = None

    def __init__(self, latent_dim: int, ffn_dim: int, dropout: float = 0.0,
                 time_embed_dim: int = 2048):
        super().__init__()
        self.dropout = dropout
        self.linear1 = Linear(latent_dim, ffn_dim)
        self.linear2 = ZeroDense(ffn_dim, latent_dim)
        self.proj_out = StylizationBlock(latent_dim, time_embed_dim, dropout)

    def forward(self, x, emb):
        comm = tensor_comm(self, self.linear1, "weight", 0)
        y = dropout(F.gelu(self.linear1(tp_copy(x, comm))), self.dropout, self.training,
                    mesh=self.mesh, split=comm)
        return x + self.proj_out(row_parallel(self.linear2.linear, y, comm), emb)


class SFFN(nn.Module):
    """Per-body-part (per-head) FFN over the concatenated head layout, with
    the stacked [H, d, f] weights of the flax module; the FFN pair runs as
    kernel K2 (ops/sffn.py) on the card."""

    mesh = None

    def __init__(self, latent_dim: int, ffn_dim: int, num_heads: int,
                 dropout: float = 0.0, time_embed_dim: int = 2048):
        super().__init__()
        H, d, f = num_heads, latent_dim, ffn_dim
        self.num_heads, self.dropout = H, dropout
        self.w1 = nn.Parameter(torch.randn(H, d, f) / math.sqrt(d))
        self.b1 = nn.Parameter(torch.zeros(H, f))
        self.w2 = nn.Parameter(torch.randn(H, f, d) / math.sqrt(f))
        self.b2 = nn.Parameter(torch.zeros(H, d))
        self.proj_out = StylizationBlock(H * d, time_embed_dim, dropout)

    def forward(self, x, emb):
        """With the hidden dim split over the tensor group (parallel/tp.py)
        each rank runs its slice of the FFN pair, column- then
        row-parallel, the partial outputs summed before b2 is added (K2
        takes zeros for b2 there)."""
        B, T, D = x.shape
        comm = tensor_comm(self, self, "w1", 2)
        if self.w1.dtype == torch.int8:
            if comm is not None:
                raise NotImplementedError(f"int8 SFFN weights split over a mesh: {ACROSS_CARDS}")
            y = self._forward_int8(x).reshape(B, T, D)
        elif self.training:
            xh, w1, b1, w2, b2 = promote_dtype(tp_copy(x, comm).reshape(B, T, self.num_heads, -1),
                                               self.w1, self.b1, self.w2, self.b2)
            y = torch.einsum("bthd,hdf->bthf", xh, w1) + b1
            y = dropout(F.gelu(y), self.dropout, self.training, mesh=self.mesh, split=comm)
            if comm is None:
                y = torch.einsum("bthf,hfd->bthd", y, w2) + b2
            else:
                y = tp_reduce(torch.einsum("bthf,hfd->bthd", y, w2), comm) + b2
            y = y.reshape(B, T, D)
        elif comm is None:
            y = head_ffn(x.reshape(B * T, D), self.w1, self.b1, self.w2,
                         self.b2).reshape(B, T, D)
        else:
            y = head_ffn(x.reshape(B * T, D), self.w1, self.b1, self.w2,
                         torch.zeros_like(self.b2))
            y = (tp_reduce(y, comm) + self.b2.to(y.dtype).reshape(1, D)).reshape(B, T, D)
        return x + self.proj_out(y, emb)

    def _forward_int8(self, x):
        B, T, D = x.shape
        if hasattr(self, "w1_wscale"):  # W8: dequantized weights through K2
            return head_ffn(x.reshape(B * T, D), dequant(self.w1, self.w1_wscale, x.dtype),
                            self.b1, dequant(self.w2, self.w2_wscale, x.dtype), self.b2)
        # W8A8: the per-head int8 products, scales [H, 1, out] -> [H, out]
        xh = x.reshape(B, T, self.num_heads, -1)
        y = qeinsum("bthd,hdf->bthf", xh, self.w1, self.w1_scale.squeeze(1)) + self.b1.to(x.dtype)
        y = F.gelu(y)
        return qeinsum("bthf,hfd->bthd", y, self.w2, self.w2_scale.squeeze(1)) + self.b2.to(x.dtype)


class PatchEmbed1D(nn.Module):
    """Temporal patchify: [B, T, C] right-padded with zeros to a multiple of
    ``patch_size`` frames, then a Conv1d of kernel = stride = patch_size
    (flax's Conv ``proj``, kernel [p, C, D]) -> [B, ceil(T / p), D], with an
    optional LayerNorm."""

    def __init__(self, in_dim: int, patch_size: int, embed_dim: int, use_norm: bool = False):
        super().__init__()
        self.patch_size = patch_size
        self.proj = Conv1d(in_dim, embed_dim, patch_size, stride=patch_size)
        self.norm = LayerNorm(embed_dim) if use_norm else None

    def forward(self, x):
        pad = (-x.shape[1]) % self.patch_size
        if pad:
            x = F.pad(x, (0, 0, 0, pad))
        y = self.proj(x.transpose(1, 2)).transpose(1, 2)
        return y if self.norm is None else self.norm(y)


def unpatchify(x: torch.Tensor, patch_size: int) -> torch.Tensor:
    """[B, N, p * C] -> [B, N * p, C]: each patch's p frames in order."""
    B, N, PC = x.shape
    return x.reshape(B, N * patch_size, PC // patch_size)


class FlaxBatchNorm1d(nn.BatchNorm1d):
    """flax's BatchNorm on [B, C, L] (eps 1e-5, momentum 0.99): in eval mode
    the running statistics; in training the batch's, its variance the
    biased E[x^2] - E[x]^2 clipped at 0, and the running statistics moved
    by 1 - momentum towards them, the variance the biased one too (torch's
    own update takes the unbiased variance).  On a data mesh the batch is
    the global one: the sums and sums of squares are all-reduced
    (differentiably) over the ranks, which hold as many rows each, as the
    JAX package's sharded step takes its statistics; every rank moves its
    running statistics alike."""

    mesh = None

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=1e-5, momentum=0.01)

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        if self.mesh is None:
            mean = x.mean(dim=(0, 2))
            var = ((x * x).mean(dim=(0, 2)) - mean * mean).clamp(min=0)
        else:
            sums = all_reduce_sum(torch.stack([x.sum(dim=(0, 2)), (x * x).sum(dim=(0, 2))]),
                                  self.mesh)
            count = x.shape[0] * x.shape[2] * self.mesh.world
            mean = sums[0] / count
            var = (sums[1] / count - mean * mean).clamp(min=0)
        with torch.no_grad():
            self.running_mean.lerp_(mean.detach(), self.momentum)
            self.running_var.lerp_(var.detach(), self.momentum)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean[:, None]) * mul[:, None] + self.bias[:, None]


class ConvBasicBlock1D(nn.Module):
    """The residual conv block of WavEncoder on [B, C, L]: conv1 (stride,
    symmetric padding) -> bn1 -> leaky ReLU -> conv2 ('same') -> bn2, plus
    the shortcut (down_conv -> down_bn where it downsamples), then leaky
    ReLU.  BatchNorm as flax's (``FlaxBatchNorm1d``)."""

    def __init__(self, inplanes: int, planes: int, ker_size: int = 15, stride: int = 1,
                 pad: int = 0, downsample: bool = False):
        super().__init__()
        self.conv1 = Conv1d(inplanes, planes, ker_size, stride=stride, padding=pad)
        self.bn1 = FlaxBatchNorm1d(planes)
        self.conv2 = Conv1d(planes, planes, ker_size, padding=ker_size // 2)
        self.bn2 = FlaxBatchNorm1d(planes)
        self.downsample = downsample
        if downsample:
            self.down_conv = Conv1d(inplanes, planes, ker_size, stride=stride, padding=pad)
            self.down_bn = FlaxBatchNorm1d(planes)

    def forward(self, x):
        y = F.leaky_relu(self.bn1(self.conv1(x)), 0.01)
        y = self.bn2(self.conv2(y))
        shortcut = self.down_bn(self.down_conv(x)) if self.downsample else x
        return F.leaky_relu(y + shortcut, 0.01)


class WavEncoder(nn.Module):
    """Raw-audio conv encoder, 16 kHz samples -> about 30 fps features:
    [B, L] or [B, L, audio_in] -> [B, L', out_dim].  Six blocks, strides
    5, 6, 1, 6, 1, 3 (540 samples a frame); block 0 pads 1600 samples on each
    side, so a window of 64 x 533 samples gives exactly 64 frames.  The
    convolutions run as cuDNN's (TF32 off)."""

    def __init__(self, out_dim: int, audio_in: int = 1):
        super().__init__()
        d = out_dim
        self.block0 = ConvBasicBlock1D(audio_in, d // 4, 15, 5, pad=1600, downsample=True)
        self.block1 = ConvBasicBlock1D(d // 4, d // 4, 15, 6, pad=0, downsample=True)
        self.block2 = ConvBasicBlock1D(d // 4, d // 4, 15, 1, pad=7)
        self.block3 = ConvBasicBlock1D(d // 4, d // 2, 15, 6, pad=0, downsample=True)
        self.block4 = ConvBasicBlock1D(d // 2, d // 2, 15, 1, pad=7)
        self.block5 = ConvBasicBlock1D(d // 2, d, 15, 3, pad=0, downsample=True)

    def forward(self, wav):
        x = (wav[:, :, None] if wav.dim() == 2 else wav).transpose(1, 2)
        for i in range(6):
            x = getattr(self, f"block{i}")(x)
        return x.transpose(1, 2)
