"""Gaussian diffusion schedule tables and the posterior algebra, in PyTorch.

Port of motioncraft_tpu/diffusion/gaussian.py restricted to what DDIM
sampling and training need.  The tables are derived in float64 on the host (numpy), then cast once
to float32 tensors on the target device, as the JAX package does.  Timestep
respacing (SpacedDiffusion) is folded into the tables: ``timestep_map``
carries respaced -> original indices, and the denoiser always sees
original-scale timesteps (``model_timesteps``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence, Union

import numpy as np
import torch

from .schedules import get_named_beta_schedule, space_timesteps

MEAN_TYPES = ("previous_x", "start_x", "epsilon")
# learned variances serve DDPM sampling and the VLB terms, which are not ported
VAR_TYPES = ("fixed_small", "fixed_large")


@dataclasses.dataclass(frozen=True)
class GaussianDiffusion:
    """Schedule tables (float32 tensors on one device) and static config."""

    betas: torch.Tensor
    alphas_cumprod: torch.Tensor
    alphas_cumprod_prev: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    sqrt_recip_alphas_cumprod: torch.Tensor
    sqrt_recipm1_alphas_cumprod: torch.Tensor
    posterior_variance: torch.Tensor
    posterior_log_variance_clipped: torch.Tensor
    posterior_mean_coef1: torch.Tensor
    posterior_mean_coef2: torch.Tensor
    fixed_large_variance: torch.Tensor
    fixed_large_log_variance: torch.Tensor
    timestep_map: torch.Tensor  # respaced index -> original timestep (int64)
    model_mean_type: str = "start_x"
    model_var_type: str = "fixed_large"
    num_timesteps: int = 1000
    original_num_steps: int = 1000


def create_diffusion(
    betas: Optional[np.ndarray] = None,
    *,
    beta_scheduler: str = "linear",
    diffusion_steps: int = 1000,
    model_mean_type: str = "start_x",
    model_var_type: str = "fixed_large",
    respace: Optional[Union[str, Sequence[int]]] = None,
    rescale_timesteps: bool = False,
    device: Union[str, torch.device] = "cpu",
) -> GaussianDiffusion:
    """Build the tables; every derivation runs in float64 on the host."""
    if model_mean_type not in MEAN_TYPES:
        raise NotImplementedError(f"model_mean_type {model_mean_type!r}")
    if model_var_type not in VAR_TYPES:
        raise NotImplementedError(f"model_var_type {model_var_type!r}")
    if rescale_timesteps:
        raise NotImplementedError("rescale_timesteps")
    if betas is None:
        betas = get_named_beta_schedule(beta_scheduler, diffusion_steps)
    betas = np.asarray(betas, dtype=np.float64)
    if betas.ndim != 1 or not ((betas > 0).all() and (betas <= 1).all()):
        raise ValueError(
            f"betas must be 1-D in (0, 1]; got shape {betas.shape}, "
            f"range [{betas.min():.4g}, {betas.max():.4g}]")
    original_num_steps = len(betas)

    if respace is not None:
        use_timesteps = space_timesteps(original_num_steps, respace)
        base_alphas_cumprod = np.cumprod(1.0 - betas)
        last_alpha_cumprod = 1.0
        new_betas, timestep_map = [], []
        for i, alpha_cumprod in enumerate(base_alphas_cumprod):
            if i in use_timesteps:
                new_betas.append(1 - alpha_cumprod / last_alpha_cumprod)
                last_alpha_cumprod = alpha_cumprod
                timestep_map.append(i)
        betas = np.array(new_betas, dtype=np.float64)
        timestep_map = np.array(timestep_map, dtype=np.int64)
    else:
        timestep_map = np.arange(original_num_steps, dtype=np.int64)

    alphas = 1.0 - betas
    alphas_cumprod = np.cumprod(alphas, axis=0)
    alphas_cumprod_prev = np.append(1.0, alphas_cumprod[:-1])
    posterior_variance = betas * (1.0 - alphas_cumprod_prev) / (1.0 - alphas_cumprod)
    fixed_large_variance = np.append(posterior_variance[1], betas[1:])

    def as_dev(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return GaussianDiffusion(
        betas=as_dev(betas),
        alphas_cumprod=as_dev(alphas_cumprod),
        alphas_cumprod_prev=as_dev(alphas_cumprod_prev),
        sqrt_alphas_cumprod=as_dev(np.sqrt(alphas_cumprod)),
        sqrt_one_minus_alphas_cumprod=as_dev(np.sqrt(1.0 - alphas_cumprod)),
        sqrt_recip_alphas_cumprod=as_dev(np.sqrt(1.0 / alphas_cumprod)),
        sqrt_recipm1_alphas_cumprod=as_dev(np.sqrt(1.0 / alphas_cumprod - 1)),
        posterior_variance=as_dev(posterior_variance),
        posterior_log_variance_clipped=as_dev(
            np.log(np.append(posterior_variance[1], posterior_variance[1:]))),
        posterior_mean_coef1=as_dev(
            betas * np.sqrt(alphas_cumprod_prev) / (1.0 - alphas_cumprod)),
        posterior_mean_coef2=as_dev(
            (1.0 - alphas_cumprod_prev) * np.sqrt(alphas) / (1.0 - alphas_cumprod)),
        fixed_large_variance=as_dev(fixed_large_variance),
        fixed_large_log_variance=as_dev(np.log(fixed_large_variance)),
        timestep_map=torch.as_tensor(timestep_map, device=device),
        model_mean_type=model_mean_type,
        model_var_type=model_var_type,
        num_timesteps=len(betas),
        original_num_steps=original_num_steps,
    )


def build_diffusion(cfg: dict, device: Union[str, torch.device] = "cpu") -> GaussianDiffusion:
    """Config-dict constructor: ``dict(beta_scheduler=..., diffusion_steps=...,
    model_mean_type=..., model_var_type=..., respace=...)``."""
    return create_diffusion(
        beta_scheduler=cfg["beta_scheduler"],
        diffusion_steps=cfg["diffusion_steps"],
        model_mean_type=cfg["model_mean_type"],
        model_var_type=cfg["model_var_type"],
        respace=cfg.get("respace", None),
        device=device,
    )


def _extract(table: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
    """table[t] broadcast to an ndim-rank batch shape."""
    out = table[t]
    return out.reshape(out.shape + (1,) * (ndim - out.ndim))


def model_timesteps(d: GaussianDiffusion, t: torch.Tensor) -> torch.Tensor:
    """Respaced -> original timesteps, as the denoiser sees them."""
    return d.timestep_map[t]


def q_sample(d: GaussianDiffusion, x_start, t, noise):
    """Sample q(x_t | x_0)."""
    return (_extract(d.sqrt_alphas_cumprod, t, x_start.ndim) * x_start
            + _extract(d.sqrt_one_minus_alphas_cumprod, t, x_start.ndim) * noise)


def q_posterior_mean_variance(d: GaussianDiffusion, x_start, x_t, t):
    mean = (_extract(d.posterior_mean_coef1, t, x_t.ndim) * x_start
            + _extract(d.posterior_mean_coef2, t, x_t.ndim) * x_t)
    return (mean, _extract(d.posterior_variance, t, x_t.ndim),
            _extract(d.posterior_log_variance_clipped, t, x_t.ndim))


def predict_xstart_from_eps(d: GaussianDiffusion, x_t, t, eps):
    return (_extract(d.sqrt_recip_alphas_cumprod, t, x_t.ndim) * x_t
            - _extract(d.sqrt_recipm1_alphas_cumprod, t, x_t.ndim) * eps)


def predict_xstart_from_xprev(d: GaussianDiffusion, x_t, t, xprev):
    return (_extract(1.0 / d.posterior_mean_coef1, t, x_t.ndim) * xprev
            - _extract(d.posterior_mean_coef2 / d.posterior_mean_coef1, t, x_t.ndim) * x_t)


def predict_eps_from_xstart(d: GaussianDiffusion, x_t, t, pred_xstart):
    return ((_extract(d.sqrt_recip_alphas_cumprod, t, x_t.ndim) * x_t - pred_xstart)
            / _extract(d.sqrt_recipm1_alphas_cumprod, t, x_t.ndim))


def p_mean_variance(d: GaussianDiffusion, model_output: torch.Tensor,
                    x: torch.Tensor, t: torch.Tensor) -> Dict[str, torch.Tensor]:
    """p(x_{t-1} | x_t) statistics and pred_xstart from a model output that
    was computed outside (the CFG-doubled denoiser batch lives in the model)."""
    if d.model_var_type == "fixed_large":
        variance = d.fixed_large_variance
        log_variance = d.fixed_large_log_variance
    else:
        variance = d.posterior_variance
        log_variance = d.posterior_log_variance_clipped
    model_variance = _extract(variance, t, x.ndim) * torch.ones_like(x)
    model_log_variance = _extract(log_variance, t, x.ndim) * torch.ones_like(x)

    if d.model_mean_type == "previous_x":
        pred_xstart = predict_xstart_from_xprev(d, x, t, model_output)
        model_mean = model_output
    else:
        if d.model_mean_type == "start_x":
            pred_xstart = model_output
        else:
            pred_xstart = predict_xstart_from_eps(d, x, t, model_output)
        model_mean, _, _ = q_posterior_mean_variance(d, pred_xstart, x, t)
    return {"mean": model_mean, "variance": model_variance,
            "log_variance": model_log_variance, "pred_xstart": pred_xstart}


def training_losses(d: GaussianDiffusion,
                    model_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
                    x_start: torch.Tensor, t: torch.Tensor,
                    noise: torch.Tensor) -> Dict[str, torch.Tensor]:
    """MSE-type training targets: the model sees x_t at original-scale
    timesteps; the architecture applies its masked, weighted reduction to
    the returned pred/target."""
    x_t = q_sample(d, x_start, t, noise)
    model_output = model_fn(x_t, model_timesteps(d, t))
    if d.model_mean_type == "previous_x":
        target = q_posterior_mean_variance(d, x_start, x_t, t)[0]
    elif d.model_mean_type == "start_x":
        target = x_start
    else:
        target = noise
    mse = ((target - model_output) ** 2).mean(dim=tuple(range(1, x_start.ndim)))
    return {"mse": mse, "target": target, "pred": model_output, "x_t": x_t}
