"""Weights between the JAX package and the port, and seeded weights for runs
without a checkpoint.

The port's modules carry the flax module and parameter names, so flax
``variables`` map onto the port's ``state_dict`` by path:

  - ``Dense.kernel`` [in, out]      -> ``Linear.weight`` [out, in]
  - ``Conv.kernel`` [k, in, out]    -> ``Conv1d.weight`` [out, in, k]
    (a 2-d Conv's [kh, kw, in, out] -> ``Conv2d.weight`` [out, in, kw, kh]:
    the body graph's temporal convs, models/gnns.py)
  - ``LayerNorm.scale`` / ``BatchNorm.scale`` -> ``weight``
  - ``Embed.embedding`` (token_embedding, and the evaluator's
    word_embeddings / position_embeddings) -> ``Embedding.weight``
  - ``batch_stats`` ``mean`` / ``var`` -> the BatchNorm buffers
    ``running_mean`` / ``running_var`` (``num_batches_tracked`` 0)
  - ``nn.Sequential`` ``layers_N``  -> index ``N``
  - everything else as it is (``expert_w1`` [E, D, F], ``w1`` [H, d, f], ...)
  - int8 weights (ops/quant.py) stay int8, and the ``quant`` collection's
    scales (``kernel_scale`` / ``kernel_wscale`` [1, out], ``w1_scale``
    [H, 1, f], ...) become buffers of the same name beside their weight;
    the model must be quantized first (``quantize_like``) for a strict load

A bidirectional GRU is the one module whose layout differs: flax keeps a
GRUCell per direction (``gru_fwd`` / ``gru_bwd``: Dense ``ir iz in`` on the
input, ``hr hz hn`` on the hidden, the hidden r / z biases folded into
``ir`` / ``iz``), torch one ``nn.GRU`` with the three gates stacked (r, z,
n); ``bigru_from_jax_params`` maps such a tree.

``to_jax_variables`` is the exact inverse (``num_batches_tracked``, which
flax does not keep, left out): a 3- or 4-d ``weight`` is a conv's, a 2-d one a
Linear's (or, under one of the embedding names, an Embedding's), a 1-d one
a norm's scale.  ``from_jax_params`` / ``to_jax_params`` carry ``params``
alone.  A ``_scale`` / ``_wscale`` entry of a quantized model goes back to the
``quant`` collection.
"""

from __future__ import annotations

import math
import re
from typing import Dict, Mapping

import numpy as np
import torch


EMBEDDINGS = ("token_embedding", "word_embeddings", "position_embeddings")
# BatchNorm buffers: flax batch_stats leaf -> state_dict leaf
STATS = {"mean": "running_mean", "var": "running_var"}
SCALES = ("_scale", "_wscale")  # the quant collection's leaves


def _array(a) -> np.ndarray:
    """f32, or int8 as it is (an int8-quantized weight)."""
    a = np.asarray(a)
    return a.astype(np.int8 if a.dtype == np.int8 else np.float32, copy=False)


def _walk(tree: Mapping, visit, path=()):
    for key, val in tree.items():
        if isinstance(val, Mapping):
            _walk(val, visit, path + (re.sub(r"^layers_(\d+)$", r"\1", key),))
        else:
            visit(list(path), key, _array(val))


def _tensor(a: np.ndarray) -> torch.Tensor:
    """``a`` as a contiguous tensor; a transposed kernel is copied by torch,
    whose strided copy runs on every core (numpy's on one)."""
    if a.ndim > 1 and not a.flags.c_contiguous and min(a.strides) >= 0:
        return torch.from_numpy(a).contiguous()
    return torch.from_numpy(np.ascontiguousarray(a))


def from_jax_params(params: Mapping) -> Dict[str, torch.Tensor]:
    """Flax ``params`` (nested dict of numpy arrays) -> the port's state_dict;
    a pipelined model's blocks stacked under ``stacked_blocks`` come out per
    layer (``block_{i}``), as the port stores them."""
    if "stacked_blocks" in params:
        from ..parallel.pp import unstack_block_params

        params = unstack_block_params(dict(params))
    out: Dict[str, torch.Tensor] = {}

    def visit(path, key, a):
        if key == "kernel":  # Dense [in, out] or Conv [..., in, out]: reverse the axes
            key, a = "weight", np.transpose(a)
        elif key == "scale" or (key == "embedding" and path and path[-1] in EMBEDDINGS):
            key = "weight"
        out[".".join(path + [key])] = _tensor(a)

    _walk(params, visit)
    return out


def from_jax_variables(variables: Mapping) -> Dict[str, torch.Tensor]:
    """Flax ``variables`` (``params``; for BatchNorm, ``batch_stats``; for
    int8 weights, ``quant``) -> the port's state_dict, each BatchNorm's
    ``num_batches_tracked`` 0."""
    out = from_jax_params(variables["params"])

    def visit(path, key, a):
        out[".".join(path + [STATS[key]])] = _tensor(a)
        out[".".join(path + ["num_batches_tracked"])] = torch.tensor(0)

    _walk(variables.get("batch_stats", {}), visit)
    _walk(variables.get("quant", {}),
          lambda path, key, a: out.__setitem__(".".join(path + [key]), _tensor(a)))
    return out


def flax_leaf(name: str, ndim: int):
    """The flax path of the state_dict entry ``name`` (a tensor of ``ndim``
    dims; the ``params`` collection's name for it) and, for each flax dim,
    the tensor's dim: a 2- or 3-d ``weight`` is a kernel with its axes
    reversed, a 1-d one a norm's scale, an embedding's its ``embedding``."""
    *parents, key = [f"layers_{p}" if p.isdigit() else p for p in name.split(".")]
    dims = tuple(range(ndim))
    if key == "weight":
        if parents and parents[-1] in EMBEDDINGS:
            key = "embedding"
        elif ndim in (2, 3, 4):
            key, dims = "kernel", tuple(reversed(dims))
        elif ndim == 1:
            key = "scale"
        else:
            raise ValueError(f"{name}: a {ndim}-d weight has no flax counterpart")
    return parents + [key], dims


def to_jax_variables(state_dict: Mapping[str, torch.Tensor]) -> dict:
    """The port's state_dict -> flax ``{"params": ..., "batch_stats": ...}``
    (``batch_stats`` only where the model has BatchNorm buffers) of numpy
    arrays, the inverse of ``from_jax_variables``: every tensor comes back
    bit for bit."""
    trees: dict = {"params": {}, "batch_stats": {}, "quant": {}}
    back = {v: k for k, v in STATS.items()}
    for name, value in state_dict.items():
        t = value.detach().cpu()
        (*parents, key), dims = flax_leaf(name, t.ndim)
        if key == "num_batches_tracked":
            continue
        t = t if t.dtype == torch.int8 else t.float()  # _array's dtypes
        col = "params"
        if key in back:
            col, key = "batch_stats", back[key]
        elif key.endswith(SCALES):
            col = "quant"
        elif dims != tuple(range(t.ndim)):
            t = t.permute(dims)  # copied below by torch, on every core
        node = trees[col]
        for p in parents:
            node = node.setdefault(p, {})
        node[key] = t.contiguous().numpy().reshape(t.shape or (1,))  # as np.ascontiguousarray
    return {k: v for k, v in trees.items() if v or k == "params"}


def to_jax_params(state_dict: Mapping[str, torch.Tensor]) -> dict:
    """The ``params`` of ``to_jax_variables``: ``from_jax_params`` of it
    gives back every parameter bit for bit."""
    return to_jax_variables(state_dict)["params"]


def bigru_from_jax_params(params: Mapping) -> Dict[str, torch.Tensor]:
    """A flax tree holding a bidirectional GRU (``gru_fwd`` / ``gru_bwd``
    GRUCells beside ordinary modules) -> the port's state_dict, the GRU
    under ``gru`` (``nn.GRU(bidirectional=True)``): each direction's
    ``weight_ih`` / ``weight_hh`` the r, z, n kernels transposed and
    stacked, ``bias_ih`` the input biases (the folded r / z ones included)
    and ``bias_hh`` zeros in its r / z thirds and ``hn``'s bias in its n
    third, so torch computes the cell flax does."""
    out = from_jax_params({k: v for k, v in params.items()
                           if k not in ("gru_fwd", "gru_bwd")})
    for name, suffix in (("gru_fwd", ""), ("gru_bwd", "_reverse")):
        cell = params[name]
        w = lambda gates: _tensor(np.concatenate(  # noqa: E731
            [np.transpose(_array(cell[g]["kernel"])) for g in gates]))
        hn = _array(cell["hn"]["bias"])
        out[f"gru.weight_ih_l0{suffix}"] = w(("ir", "iz", "in"))
        out[f"gru.weight_hh_l0{suffix}"] = w(("hr", "hz", "hn"))
        out[f"gru.bias_ih_l0{suffix}"] = _tensor(np.concatenate(
            [_array(cell[g]["bias"]) for g in ("ir", "iz", "in")]))
        out[f"gru.bias_hh_l0{suffix}"] = _tensor(np.concatenate(
            [np.zeros(2 * hn.size, np.float32), hn]))
    return out


def fabricate_state_dict(model: torch.nn.Module, seed: int = 0) -> Dict[str, torch.Tensor]:
    """Seeded random weights for every parameter and BatchNorm statistic of
    ``model`` (on the CPU), with magnitudes tamed so a deep stack of random
    layers stays in a sane numeric range: each tensor is N(0, 1) /
    sqrt(fan-in) (a conv's fan-in is in x its kernel's size); the gate temperatures are 0
    (logit scale 1) and the MoE position embeddings are scaled up by 8, so
    routing spreads across the experts; SAMI's kernel widths ``sigma`` and
    ``t_sigma`` keep the model's values (100 and 1 as built: a random width
    near 0 would make its time kernel one-hot).  A BatchNorm's scale is near
    1, its running mean near 0 and its running variance in [0.5, 1.5)."""
    g = torch.Generator().manual_seed(seed)
    norms = {name for name, m in model.named_modules()
             if isinstance(m, torch.nn.modules.batchnorm._BatchNorm)}
    sd = {}
    for name, p in model.state_dict().items():
        if not p.is_floating_point():
            sd[name] = p.clone()
            continue
        shape = tuple(p.shape)
        owner, _, leaf = name.rpartition(".")
        if owner in norms:
            if leaf == "running_var":
                sd[name] = torch.rand(shape, generator=g) + 0.5
            else:
                sd[name] = torch.randn(shape, generator=g) * 0.1 + (leaf == "weight")
            continue
        if leaf in ("expert_w1", "expert_w2", "w1", "w2"):
            fan_in = shape[-2]
        elif leaf == "weight" and len(shape) in (3, 4):  # a conv's [out, in, k...]
            fan_in = math.prod(shape[1:])
        else:
            fan_in = shape[-1]
        v = torch.randn(shape, generator=g) / math.sqrt(max(fan_in, 4))
        if leaf == "temperature":
            v = torch.zeros(shape)
        elif leaf in ("sigma", "t_sigma"):
            v = p.detach().cpu().clone()
        elif name.endswith("moe.embedding"):
            v = v * 8.0
        sd[name] = v
    return sd
