"""Weights between the JAX package and the port, and seeded weights for runs
without a checkpoint.

The port's modules carry the flax module and parameter names, so a flax
``params`` tree maps onto the port's ``state_dict`` by path:

  - ``Dense.kernel`` [in, out]      -> ``Linear.weight`` [out, in]
  - ``LayerNorm.scale``             -> ``LayerNorm.weight``
  - ``Embed.embedding`` (token_embedding, and the evaluator's
    word_embeddings / position_embeddings) -> ``Embedding.weight``
  - ``nn.Sequential`` ``layers_N``  -> index ``N``
  - everything else as it is (``expert_w1`` [E, D, F], ``w1`` [H, d, f], ...)

``to_jax_params`` is its exact inverse: a 2-d ``weight`` is a Linear's (or,
under one of the embedding names, an Embedding's), a 1-d one a LayerNorm's.
"""

from __future__ import annotations

import math
import re
from typing import Dict, Mapping

import numpy as np
import torch


EMBEDDINGS = ("token_embedding", "word_embeddings", "position_embeddings")


def from_jax_params(params: Mapping) -> Dict[str, torch.Tensor]:
    """Flax ``params`` (nested dict of numpy arrays) -> the port's state_dict."""
    out: Dict[str, torch.Tensor] = {}

    def walk(node, path):
        for key, val in node.items():
            if isinstance(val, Mapping):
                walk(val, path + [re.sub(r"^layers_(\d+)$", r"\1", key)])
                continue
            a = np.asarray(val, dtype=np.float32)
            if key == "kernel":
                key, a = "weight", a.T
            elif key == "scale" or (key == "embedding" and path and path[-1] in EMBEDDINGS):
                key = "weight"
            out[".".join(path + [key])] = torch.from_numpy(np.ascontiguousarray(a))

    walk(params, [])
    return out


def to_jax_params(state_dict: Mapping[str, torch.Tensor]) -> dict:
    """The port's state_dict -> a flax ``params`` tree of numpy arrays, the
    inverse of ``from_jax_params``: ``from_jax_params(to_jax_params(sd))``
    gives back every tensor bit for bit."""
    tree: dict = {}
    for name, value in state_dict.items():
        path = [f"layers_{p}" if p.isdigit() else p for p in name.split(".")]
        *parents, key = path
        a = value.detach().cpu().numpy().astype(np.float32, copy=False)
        if key == "weight":
            if parents and parents[-1] in EMBEDDINGS:
                key = "embedding"
            elif a.ndim == 2:
                key, a = "kernel", a.T
            elif a.ndim == 1:
                key = "scale"
            else:
                raise ValueError(f"{name}: a {a.ndim}-d weight has no flax counterpart")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[key] = np.ascontiguousarray(a)
    return tree


def fabricate_state_dict(model: torch.nn.Module, seed: int = 0) -> Dict[str, torch.Tensor]:
    """Seeded random weights for every parameter of ``model`` (on the CPU),
    with magnitudes tamed so a deep stack of random layers stays in a sane
    numeric range: each tensor is N(0, 1) / sqrt(fan-in); the gate
    temperatures are 0 (logit scale 1) and the MoE position embeddings are
    scaled up by 8, so routing spreads across the experts."""
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for name, p in model.state_dict().items():
        if not p.is_floating_point():
            continue
        shape = tuple(p.shape)
        leaf = name.rsplit(".", 1)[-1]
        fan_in = shape[-2] if leaf in ("expert_w1", "expert_w2", "w1", "w2") else shape[-1]
        v = torch.randn(shape, generator=g) / math.sqrt(max(fan_in, 4))
        if leaf == "temperature":
            v = torch.zeros(shape)
        elif name.endswith("moe.embedding"):
            v = v * 8.0
        sd[name] = v
    return sd
