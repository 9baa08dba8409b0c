"""Int8 weights for inference, W8A8 dynamic and W8 weight-only (the port's
copy of motioncraft_tpu/ops/quant.py).

Two compute modes over the same int8 storage:

- **W8A8 dynamic** (``weight_only=False``): symmetric per-output-channel
  weight scales, computed once by ``quantize_``, and symmetric per-row
  activation scales computed in the forward; int8 x int8 products
  accumulated in int32, rescaled in f32, output in the activation dtype.
- **W8 weight-only** (``weight_only=True``): the int8 weights are
  dequantized to the activation dtype in the forward and feed the float
  product (for the SFFN and the experts, kernels K2 and K1).  The mode is
  the scale's name: ``<name>_wscale`` for W8, ``<name>_scale`` for W8A8, as
  in the JAX package's ``quant`` collection.

The int8 products are ``dot_general`` / ``einsum`` in the JAX package,
outside any Pallas kernel.  Here they go through ``int_mm``: on the card
``torch._int_mm`` (int8 x int8 -> int32, which takes more than 16 rows and
k, n multiples of 8: the operands are padded with zeros, exact because each
row is quantized by itself and a zero column adds nothing), on the CPU the
plain int32 product.  Both give the
same int32 accumulators exactly.  A per-head or per-expert product (PyTorch
has no batched int8 product on the card) is a loop over the heads or the
experts on slices of static shape.

``quantize_`` selects weights by their flax path (the port's module names
are the flax names, ``layers_N`` for an ``nn.Sequential`` index), with the
JAX package's include and exclude patterns, so that both packages quantize
the same set.  It rewrites them in place: an eligible ``nn.Linear`` becomes
a ``models.blocks.QLinear``; an SFFN's ``w1``/``w2`` and a MoE layer's
``expert_w1``/``expert_w2`` become int8 buffers beside their scales.
Quantize after loading the weights and after ``bf16_cast_``: the scales are
f32 and a later cast would round them.
"""

from __future__ import annotations

import re
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

# stacked [G, d_in, d_out] weights with an int8 branch in their module (SFFN,
# MoELayer); their contraction axis is 1
_STACKED_LEAVES = ("expert_w1", "expert_w2", "w1", "w2")

# the JAX package's audited scopes (ops/quant.py there): the denoiser's hot
# path, read through int8-aware modules
_DEFAULT_INCLUDE = re.compile(
    r"(/ca_block/|/sa_block/|/ffn/|/time_embed|/joint_embed|/out/"
    r"|/before_proj|/after_proj)")
# never: the gate projections (routing stays f32), the text encoders, the
# speech encoder and the body-graph stack
_DEFAULT_EXCLUDE = re.compile(r"(/gate/|/text_enc|/clip|/wav_enc|/gnn/)")

# the default size floor of a quantized weight (the JAX package's): smaller
# products gain little from int8
MIN_ELEMS = 1 << 15
# torch._int_mm on the card takes more than 16 rows
INT_MM_MIN_ROWS = 17


def _div127(a: torch.Tensor) -> torch.Tensor:
    """``a / 127`` correctly rounded on every device: a CUDA tensor divided
    by a Python number is multiplied by its reciprocal, which differs in the
    last bit (and then moves codes)."""
    return a / torch.full_like(a, 127.0)


def quantize_weight(w: torch.Tensor, contract_axis: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel int8 quantization: (w_int8, scale) with
    ``w ~ w_int8 * scale``; ``scale`` (f32) keeps ``w``'s rank with the
    contraction axis reduced to 1.  Round half to even, as jnp.round."""
    w32 = w.float()
    scale = _div127(w32.abs().amax(dim=contract_axis, keepdim=True).clamp(min=1e-12))
    return torch.round(w32 / scale).clamp(-127, 127).to(torch.int8), scale


def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dynamic symmetric per-row (last axis) activation quantization:
    (x_int8, row scale f32 [..., 1])."""
    x32 = x.float()
    ax = _div127(x32.abs().amax(dim=-1, keepdim=True).clamp(min=1e-12))
    return torch.round(x32 / ax).clamp(-127, 127).to(torch.int8), ax


def dequant(wq: torch.Tensor, wscale: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Weight-only dequantization: ``wq * wscale`` in f32, cast to ``dtype``."""
    return (wq.float() * wscale).to(dtype)


def int_mm_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version: the int32 product of int8 ``a`` [m, k] and ``b`` [k, n]."""
    return a.to(torch.int32) @ b.to(torch.int32)


def int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 ``a`` [m, k] x int8 ``b`` [k, n] -> int32 [m, n], exact.  A CPU
    tensor takes the plain int32 product; a CUDA tensor ``torch._int_mm``,
    which takes more than 16 rows and k and n multiples of 8: the operands
    are padded with zeros up to those (exact: a zero row or column adds
    nothing) and the result cut back.  Each of ``int_mm.hooks`` is called
    with (a, b) first, on every device."""
    for hook in int_mm.hooks:
        hook(a, b)
    if a.device.type == "cpu":
        return int_mm_plain(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"int_mm: unsupported device {a.device}")
    if a.dtype != torch.int8 or b.dtype != torch.int8 or a.dim() != 2 or b.dim() != 2:
        raise ValueError("int_mm: two 2-d int8 operands")
    (m, k), n = a.shape, b.shape[1]
    if b.shape[0] != k:
        raise ValueError(f"int_mm: inner sizes {k} and {b.shape[0]} differ")
    pk, pn, pm = -k % 8, -n % 8, max(0, INT_MM_MIN_ROWS - m)
    if pk or pm:
        a = F.pad(a, (0, pk, 0, pm))
    if pk or pn:
        b = F.pad(b, (0, pn, 0, pk))
    int_mm.launches += 1
    out = torch._int_mm(a, b)
    return out[:m, :n] if pm or pn else out


int_mm.launches = 0
int_mm.hooks = []


def qdot(x: torch.Tensor, wq: torch.Tensor, wscale: torch.Tensor) -> torch.Tensor:
    """``x @ dequant(wq)`` through the int8 product: x [..., K] float, wq
    [K, N] int8, wscale [1, N] (or [N]) f32; out in x's dtype."""
    xq, ax = quantize_rows(x)
    acc = int_mm(xq.reshape(-1, x.shape[-1]), wq).reshape(*x.shape[:-1], -1)
    return (acc.float() * ax * wscale.reshape(-1)).to(x.dtype)


# the grouped layouts of the SFFN (per head: the group axis is x's -2) and of
# the slot-buffer experts (per expert: the group axis is x's 0)
_QEINSUM_GROUP_AXIS = {"bthd,hdf->bthf": -2, "bthf,hfd->bthd": -2,
                       "ecd,edf->ecf": 0, "ecf,efd->ecd": 0}


def qeinsum(eq: str, x: torch.Tensor, wq: torch.Tensor, wscale: torch.Tensor) -> torch.Tensor:
    """The quantized grouped products of the stacked-FFN layouts
    (``_QEINSUM_GROUP_AXIS``): x's contraction axis is its last; wq [G, K, N]
    int8; ``wscale`` broadcasts against the output.  One int8 product per
    group, on static slices."""
    axis = _QEINSUM_GROUP_AXIS.get(eq)
    if axis is None:
        raise ValueError(f"qeinsum: layout {eq!r} is not one of {sorted(_QEINSUM_GROUP_AXIS)}")
    xq, ax = quantize_rows(x)
    K = x.shape[-1]
    accs = [int_mm(xq.select(axis, g).reshape(-1, K), wq[g]) for g in range(wq.shape[0])]
    lead = xq.select(axis, 0).shape[:-1]
    acc = torch.stack([a.reshape(*lead, -1) for a in accs], dim=axis % x.dim())
    return (acc.float() * ax * wscale).to(x.dtype)


def expert_ffn_q(xe, w1q, s1, b1, w2q, s2, b2):
    """Int8 slot-buffer expert FFN [E, C, D] -> [E, C, D]; s1 / s2 are the
    per-(expert, out-channel) scales [E, 1, F] / [E, 1, D]."""
    h = qeinsum("ecd,edf->ecf", xe, w1q, s1) + b1[:, None, :].to(xe.dtype)
    h = F.gelu(h)
    return qeinsum("ecf,efd->ecd", h, w2q, s2) + b2[:, None, :].to(xe.dtype)


def flax_path(name: str) -> str:
    """The flax path of a module (its ``named_modules`` name): each part
    after a '/', an nn.Sequential index N as ``layers_N``; '' for the root."""
    return "".join(f"/layers_{p}" if p.isdigit() else f"/{p}" for p in name.split(".") if p)


def _set_int8(module: nn.Module, leaf: str, weight_only: bool) -> None:
    """A stacked weight -> an int8 buffer of the same name beside its scale."""
    wq, scale = quantize_weight(getattr(module, leaf).detach(), 1)
    del module._parameters[leaf]
    module.register_buffer(leaf, wq)
    module.register_buffer(leaf + ("_wscale" if weight_only else "_scale"), scale)


def quantize_(model: nn.Module, *, include: Optional[re.Pattern] = None,
              exclude: Optional[re.Pattern] = None, min_elems: Optional[int] = None,
              predicate: Optional[Callable[[str, torch.Tensor], bool]] = None,
              weight_only: bool = False) -> int:
    """Rewrite ``model``'s eligible weights to int8 in place; returns how
    many.  Eligible (as ``quantize_variables`` of the JAX package): an
    ``nn.Linear``'s weight (the flax 2-d ``kernel``) or a stacked
    ``w1``/``w2``/``expert_w1``/``expert_w2`` of at least ``min_elems``
    (default ``MIN_ELEMS``) elements whose flax path (``.../kernel``, ``.../w1``) matches
    ``include`` and not ``exclude``; ``predicate(path, weight)`` replaces
    both patterns when given.  Scales are ``kernel_scale`` / ``w1_scale`` /
    ... (``_wscale`` under ``weight_only``).  Idempotent: int8 weights are
    skipped, and a widening pass keeps the earlier scales."""
    from ..models.blocks import QLinear

    include = include or _DEFAULT_INCLUDE
    exclude = exclude or _DEFAULT_EXCLUDE
    min_elems = MIN_ELEMS if min_elems is None else min_elems

    def want(path: str, w: torch.Tensor) -> bool:
        if w.dtype == torch.int8 or w.numel() < min_elems:
            return False
        if predicate is not None:
            return bool(predicate(path, w))
        return bool(include.search(path)) and not exclude.search(path)

    n = 0
    for name, module in list(model.named_modules()):
        if isinstance(module, nn.Linear):
            if want(flax_path(name) + "/kernel", module.weight):
                parent, _, child = name.rpartition(".")
                setattr(model.get_submodule(parent), child,
                        QLinear.from_linear(module, weight_only))
                n += 1
            continue
        for leaf in _STACKED_LEAVES:
            w = module._parameters.get(leaf)
            if w is not None and w.dim() == 3 and want(f"{flax_path(name)}/{leaf}", w):
                _set_int8(module, leaf, weight_only)
                n += 1
    return n


def quantize_like(model: nn.Module, quant_tree) -> int:
    """Quantize exactly the weights that a flax ``quant`` collection has
    scales for, each in its mode (``_wscale``: W8), so that a state_dict
    carrying those int8 weights and scales (utils/convert.py) loads with
    ``strict=True``.  Returns how many."""
    modes = {}

    def walk(node, path):
        for key, val in node.items():
            if hasattr(val, "items"):
                walk(val, f"{path}/{key}")
            else:
                leaf, _, mode = key.rpartition("_")
                modes[f"{path}/{leaf}"] = mode == "wscale"

    walk(quant_tree, "")
    return sum(quantize_(model, min_elems=0, weight_only=w8,
                         predicate=lambda p, _, w8=w8: modes.get(p) is w8)
               for w8 in (False, True))


def count_quantized(model: nn.Module) -> Tuple[int, int]:
    """(number of int8 weights, their element count)."""
    ws = [b for b in model.buffers() if b.dtype == torch.int8]
    return len(ws), sum(b.numel() for b in ws)
