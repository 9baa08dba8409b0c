"""Adafactor, AdaBelief and LAMB as ``torch.optim.Optimizer``s that perform
optax's updates with optax's defaults (``optax.adafactor(lr)``,
``optax.adabelief(lr)``, ``optax.lamb(lr)``, as the JAX package's
``build_optimizer`` makes them).

Each keeps its state per parameter as optax keeps it per leaf and reads the
learning rate from its param group before each update (``TrainState`` sets
it from the schedule, as optax evaluates a schedule at its own count).

- Adafactor (``scale_by_factored_rms`` -> ``clip_by_block_rms(1.0)`` -> lr
  -> ``scale_by_param_block_rms(1e-3)`` -> -1): the second moment is
  factored into row and column means over a parameter's two largest dims
  when the smaller of them is at least 128, else kept whole; decay 1 -
  (t + 1)^-0.8 at update t (0 first), eps 1e-30 added to the squared
  gradient; the update's RMS clipped at 1, then scaled by the lr and by the
  parameter's RMS (at least 1e-3).
- AdaBelief (``scale_by_belief``: b1 0.9, b2 0.999, eps 1e-16, eps_root
  1e-16 added to the second moment, which keeps it): m / (sqrt(s) + eps)
  with both moments bias-corrected, times -lr.
- LAMB (``scale_by_adam``: eps 1e-6, eps_root 0; weight decay 0; the trust
  ratio ||p|| / ||u||, 1 where either norm is 0): times -lr.
"""

from __future__ import annotations

import numpy as np
import torch


def _rms(x: torch.Tensor) -> torch.Tensor:
    return x.square().mean().sqrt()


def factored_dims(shape, min_dim_size_to_factor: int = 128):
    """optax's ``_factored_dims``: (d1, d0), the second largest and the
    largest dim (numpy's argsort order), or None when the tensor has fewer
    than two dims or its second largest is below the threshold."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < min_dim_size_to_factor:
        return None
    return int(order[-2]), int(order[-1])


class Adafactor(torch.optim.Optimizer):
    """optax.adafactor(lr) with its defaults (module docstring)."""

    def __init__(self, params, lr: float = 1e-3, decay_rate: float = 0.8,
                 min_dim_size_to_factor: int = 128, clipping_threshold: float = 1.0,
                 min_scale: float = 1e-3, eps: float = 1e-30):
        super().__init__(params, dict(lr=lr, decay_rate=decay_rate,
                                      min_dim_size_to_factor=min_dim_size_to_factor,
                                      clipping_threshold=clipping_threshold,
                                      min_scale=min_scale, eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                g, state = p.grad, self.state[p]
                dims = factored_dims(p.shape, group["min_dim_size_to_factor"])
                if not state:
                    state["count"] = 0
                    if dims is None:
                        state["v"] = torch.zeros_like(p)
                    else:
                        d1, d0 = dims
                        state["v_row"] = p.new_zeros([n for i, n in enumerate(p.shape) if i != d0])
                        state["v_col"] = p.new_zeros([n for i, n in enumerate(p.shape) if i != d1])
                t = np.float32(state["count"] + 1)
                decay = 1.0 - float(t ** np.float32(-group["decay_rate"]))
                g_sq = g.square() + group["eps"]
                if dims is None:
                    v = state["v"].mul_(decay).add_(g_sq, alpha=1.0 - decay)
                    update = g * v.rsqrt()
                else:
                    d1, d0 = dims
                    v_row = state["v_row"].mul_(decay).add_(g_sq.mean(dim=d0), alpha=1.0 - decay)
                    v_col = state["v_col"].mul_(decay).add_(g_sq.mean(dim=d1), alpha=1.0 - decay)
                    reduced_d1 = d1 - 1 if d1 > d0 else d1
                    row_factor = (v_row / v_row.mean(dim=reduced_d1, keepdim=True)).rsqrt()
                    update = g * row_factor.unsqueeze(d0) * v_col.rsqrt().unsqueeze(d1)
                update = update / torch.clamp(_rms(update) / group["clipping_threshold"], min=1.0)
                scale = torch.clamp(_rms(p), min=group["min_scale"])
                p.sub_(update * group["lr"] * scale)
                state["count"] += 1


class AdaBelief(torch.optim.Optimizer):
    """optax.adabelief(lr) with its defaults (module docstring)."""

    def __init__(self, params, lr: float = 1e-3, betas=(0.9, 0.999), eps: float = 1e-16,
                 eps_root: float = 1e-16):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps, eps_root=eps_root))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            b1, b2 = group["betas"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g, state = p.grad, self.state[p]
                if not state:
                    state["count"] = 0
                    state["mu"], state["nu"] = torch.zeros_like(p), torch.zeros_like(p)
                mu = state["mu"].mul_(b1).add_(g, alpha=1 - b1)
                err = g - mu
                nu = state["nu"].mul_(b2).add_(err.square(), alpha=1 - b2).add_(group["eps_root"])
                state["count"] += 1
                t = state["count"]
                mu_hat = mu / (1 - np.float32(b1) ** t)
                nu_hat = nu / (1 - np.float32(b2) ** t)
                p.sub_(mu_hat / (nu_hat.sqrt() + group["eps"]) * group["lr"])


class Lamb(torch.optim.Optimizer):
    """optax.lamb(lr) with its defaults (module docstring)."""

    def __init__(self, params, lr: float = 1e-3, betas=(0.9, 0.999), eps: float = 1e-6,
                 eps_root: float = 0.0, weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps, eps_root=eps_root,
                                      weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            b1, b2 = group["betas"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g, state = p.grad, self.state[p]
                if not state:
                    state["count"] = 0
                    state["mu"], state["nu"] = torch.zeros_like(p), torch.zeros_like(p)
                mu = state["mu"].mul_(b1).add_(g, alpha=1 - b1)
                nu = state["nu"].mul_(b2).add_(g.square(), alpha=1 - b2)
                state["count"] += 1
                t = state["count"]
                mu_hat = mu / (1 - np.float32(b1) ** t)
                nu_hat = nu / (1 - np.float32(b2) ** t)
                update = mu_hat / ((nu_hat + group["eps_root"]).sqrt() + group["eps"])
                update = update + group["weight_decay"] * p
                p_norm, u_norm = torch.linalg.vector_norm(p), torch.linalg.vector_norm(update)
                ratio = torch.where((p_norm == 0) | (u_norm == 0), torch.ones_like(p_norm),
                                    p_norm / u_norm)
                p.sub_(update * ratio * group["lr"])
