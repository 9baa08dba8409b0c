"""Optimizer and train-state construction (PyTorch port of
motioncraft_tpu/parallel/train_state.py).

The reference recipe: Adam lr 2e-4, step decay at epoch boundaries, an
optional clip of the gradients' global norm; Adafactor, AdaBelief and LAMB
as optax makes them (parallel/optim.py), under the same schedule and clip.
Frozen subtrees (the CLIP text tower; for a ControlNet, its base as
``controlnet_frozen_prefixes`` says) get ``requires_grad_(False)`` and stay
out of the optimizer: they take no gradient, no update and no optimizer
state, and the clip's global norm
runs over the trainable parameters only, as ``optax.masked(chain(clip,
opt))`` computes it.  The JAX package's ``optax.masked`` passes a frozen
leaf's raw gradient through as its update, and ``apply_gradients`` adds it
(ROADMAP queue 3: "frozen means frozen").  The learning rate
follows a schedule of the optimizer's update count, evaluated before each
update as optax's ``count`` is.

On a sharded model (``sharding``, parallel/tp.py) each rank's parameters
and optimizer moments are its shards; the clip's global norm counts each
leaf once (its shards' squares summed over the ranks that hold them) and
the optimizers take the whole leaf's statistics (parallel/optim.py).
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence, Tuple

import torch
from torch import nn

from .optim import AdaBelief, Adafactor, Lamb

# the optimizers the JAX package builds with optax's defaults alone
OPTAX_DEFAULTS = {"adafactor": Adafactor, "adabelief": AdaBelief, "lamb": Lamb}


def freeze(module: nn.Module, frozen_prefixes: Sequence[str]
           ) -> List[Tuple[str, nn.Parameter]]:
    """Freeze every parameter whose '/'-joined path starts with one of the
    prefixes or contains it after a '/' (e.g. 'text_enc/clip'); return the
    trainable (name, parameter) pairs."""
    trainable = []
    for name, p in module.named_parameters():
        path = name.replace(".", "/")
        if any(path.startswith(pref) or f"/{pref}" in path for pref in frozen_prefixes):
            p.requires_grad_(False)
        elif p.requires_grad:
            trainable.append((name, p))
    return trainable


def build_lr_schedule(base_lr: float, policy: Optional[dict] = None,
                      steps_per_epoch: int = 1) -> Callable[[int], float]:
    """mmcv lr_config equivalent, as a function of the update count:
    dict(policy='step', step=[10], gamma=0.1), 'CosineAnnealing' with
    total_steps (and min_lr_ratio), or 'fixed'."""
    name = (policy or {}).get("policy", "fixed")
    if name == "fixed":
        return lambda count: base_lr
    if name == "step":
        gamma = policy.get("gamma", 0.1)
        milestones = policy["step"]
        if isinstance(milestones, int):
            milestones = [milestones]
        bounds = [m * steps_per_epoch for m in milestones]
        return lambda count: base_lr * gamma ** sum(count >= b for b in bounds)
    if name == "CosineAnnealing":
        total, alpha = policy["total_steps"], policy.get("min_lr_ratio", 0.0)

        def cosine(count):
            cos = 0.5 * (1 + math.cos(math.pi * min(count, total) / total))
            return base_lr * ((1 - alpha) * cos + alpha)
        return cosine
    raise NotImplementedError(policy)


def build_optimizer(optimizer_cfg: dict, params) -> torch.optim.Optimizer:
    """cfg like dict(type='Adam', lr=2e-4); Adam, AdamW and SGD with optax's
    defaults, Adafactor, AdaBelief and LAMB as optax's with their defaults
    (parallel/optim.py; the config's other keys are not read, as the JAX
    package's build_optimizer reads none).  The lr is set per update from the
    schedule."""
    cfg = dict(optimizer_cfg)
    opt_type = cfg.pop("type", "Adam").lower()
    lr = cfg.pop("lr", 2e-4)
    if opt_type == "adam":
        b1, b2 = cfg.get("betas", (0.9, 0.999))
        return torch.optim.Adam(params, lr=lr, betas=(b1, b2), eps=cfg.get("eps", 1e-8))
    if opt_type == "adamw":
        return torch.optim.AdamW(params, lr=lr, weight_decay=cfg.get("weight_decay", 1e-2))
    if opt_type == "sgd":
        return torch.optim.SGD(params, lr=lr, momentum=cfg.get("momentum", 0.9))
    if opt_type in OPTAX_DEFAULTS:
        return OPTAX_DEFAULTS[opt_type](params, lr=lr)
    raise NotImplementedError(f"optimizer {opt_type!r}")


class TrainState:
    """A model's optimizer, lr schedule and gradient clip.  ``step`` counts
    the optimizer updates (optax's ``count``)."""

    def __init__(self, model: nn.Module, optimizer_cfg: dict,
                 lr_schedule: Optional[Callable[[int], float]] = None,
                 grad_clip: Optional[dict] = None,
                 frozen_prefixes: Sequence[str] = ("text_enc/clip",), sharding=None):
        self.model = model
        self.params = [p for _, p in freeze(model, frozen_prefixes)]
        self.optimizer = build_optimizer(optimizer_cfg, self.params)
        self.sharding = self.optimizer.sharding = sharding
        base_lr = self.optimizer.param_groups[0]["lr"]
        self.lr_schedule = lr_schedule or (lambda count: base_lr)
        self.max_norm = grad_clip.get("max_norm", 1.0) if grad_clip else None
        self.step = 0

    def apply_gradients(self) -> None:
        """One update from the parameters' ``.grad``, then clear them."""
        live = [p for p in self.params if p.grad is not None]
        grads = [p.grad for p in live]
        if self.max_norm is not None and grads:
            # optax.clip_by_global_norm: scale by max_norm / norm when norm >= max_norm
            if self.sharding is None:
                norm = torch.linalg.vector_norm(torch.stack(
                    [torch.linalg.vector_norm(g) for g in grads]))
            else:
                norm = self.sharding.sum_sq(
                    [(p.grad, self.sharding.spec(p)) for p in live]).sqrt()
            factor = torch.where(norm < self.max_norm, torch.ones_like(norm),
                                 self.max_norm / norm)
            for g in grads:
                g.mul_(factor)
        for group in self.optimizer.param_groups:
            group["lr"] = self.lr_schedule(self.step)
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        self.step += 1
