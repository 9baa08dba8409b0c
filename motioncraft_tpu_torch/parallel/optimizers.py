"""Per-submodule optimizers (PyTorch port of
motioncraft_tpu/parallel/optimizers.py, after the reference's
mogen/core/optimizer).

``build_optimizers(module, cfgs)``: when every value of ``cfgs`` is itself
an optimizer config keyed by a top-level submodule (or parameter) name, one
optimizer for each over that subtree's parameters, as the JAX package's
``optax.multi_transform`` routes each top-level parameter subtree to its
own transform; a flat config gives one optimizer over every parameter.
"""

from __future__ import annotations

from typing import Dict, Union

import torch
from torch import nn

from .train_state import build_optimizer


def _top_level(name: str) -> str:
    return name.split(".", 1)[0]


def build_optimizers(module: nn.Module, cfgs: Dict
                     ) -> Union[torch.optim.Optimizer, Dict[str, torch.optim.Optimizer]]:
    """{name: optimizer over ``module.<name>``'s parameters} for a
    dict-of-dicts ``cfgs`` (KeyError for a name that is no top-level
    subtree; ValueError, as optax's, when a subtree has no optimizer), or
    one optimizer for a flat config."""
    params = dict(module.named_parameters())
    if cfgs and "type" not in cfgs and all(isinstance(v, dict) for v in cfgs.values()):
        top = sorted({_top_level(n) for n in params})
        missing = [k for k in cfgs if k not in top]
        if missing:
            raise KeyError(f"optimizer keys {missing} not found among param subtrees {top}")
        uncovered = [k for k in top if k not in cfgs]
        if uncovered:
            raise ValueError(f"param subtrees {uncovered} have no optimizer")
        return {k: build_optimizer(dict(cfg), [p for n, p in params.items()
                                               if _top_level(n) == k])
                for k, cfg in cfgs.items()}
    return build_optimizer(dict(cfgs), list(params.values()))
