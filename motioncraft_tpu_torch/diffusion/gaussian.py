"""Gaussian diffusion schedule tables and the posterior algebra, in PyTorch
(port of motioncraft_tpu/diffusion/gaussian.py).

DDIM and ancestral DDPM sampling (with RePaint's re-noising ``undo`` and
the outpainting x0 overwrite), the training targets, the learned variances
(``model_var_type`` ``'learned'`` / ``'learned_range'``: the model output
carries the log-variance, or its interpolation between the clipped
posterior and the beta log-variances, after its mean) and the variational
lower bound (``normal_kl``, ``discretized_gaussian_log_likelihood``,
``vb_terms_bpd``, ``prior_bpd``, ``calc_bpd_loop``, in bits per dim).
The tables are derived in float64 on the host (numpy), then cast once to
float32 tensors on the target device, as the JAX package does.  Timestep
respacing (SpacedDiffusion) is folded into the tables: ``timestep_map``
carries respaced -> original indices, and the denoiser always sees
original-scale timesteps (``model_timesteps``; with ``rescale_timesteps``
scaled to a 1000-step range, as floats).

The learned variance is split off the model output as the JAX package
splits it: along axis 1 at ``x.shape[1]``.  For motion [B, T, D] that
axis is time, not the channels (ROADMAP queue 3), so such a model emits
[B, 2T, D]; the port keeps the JAX package's axis.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Sequence, Union

import numpy as np
import torch

from .schedules import get_named_beta_schedule, space_timesteps

MEAN_TYPES = ("previous_x", "start_x", "epsilon")
VAR_TYPES = ("learned", "fixed_small", "fixed_large", "learned_range")


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
    alphas_cumprod_next: torch.Tensor
    log_one_minus_alphas_cumprod: torch.Tensor
    log_betas: torch.Tensor
    timestep_map: torch.Tensor  # respaced index -> original timestep (int64)
    # the float32 alphas_cumprod_prev on the host: the samplers read per-step
    # constants from it without a device round trip
    alphas_cumprod_prev_host: np.ndarray
    model_mean_type: str = "start_x"
    model_var_type: str = "fixed_large"
    num_timesteps: int = 1000
    original_num_steps: int = 1000
    rescale_timesteps: bool = False


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
        alphas_cumprod_next=as_dev(np.append(alphas_cumprod[1:], 0.0)),
        log_one_minus_alphas_cumprod=as_dev(np.log(1.0 - alphas_cumprod)),
        log_betas=as_dev(np.log(betas)),
        timestep_map=torch.as_tensor(timestep_map, device=device),
        alphas_cumprod_prev_host=np.asarray(alphas_cumprod_prev, np.float32),
        model_mean_type=model_mean_type,
        model_var_type=model_var_type,
        num_timesteps=len(betas),
        original_num_steps=original_num_steps,
        rescale_timesteps=rescale_timesteps,
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
    """Respaced -> original timesteps, as the denoiser sees them; with
    ``rescale_timesteps``, f32 scaled by 1000 / the original step count."""
    ts = d.timestep_map[t]
    if d.rescale_timesteps:
        ts = ts.to(torch.float32) * (1000.0 / d.original_num_steps)
    return ts


def q_mean_variance(d: GaussianDiffusion, x_start, t):
    """The mean, variance and log-variance of q(x_t | x_0)."""
    mean = _extract(d.sqrt_alphas_cumprod, t, x_start.ndim) * x_start
    variance = _extract(1.0 - d.alphas_cumprod, t, x_start.ndim)
    log_variance = _extract(d.log_one_minus_alphas_cumprod, t, x_start.ndim)
    return mean, variance, log_variance


def q_sample(d: GaussianDiffusion, x_start, t, noise):
    """Sample q(x_t | x_0)."""
    return (_extract(d.sqrt_alphas_cumprod, t, x_start.ndim) * x_start
            + _extract(d.sqrt_one_minus_alphas_cumprod, t, x_start.ndim) * noise)


def undo(d: GaussianDiffusion, x, t, noise):
    """One forward (re-noising) step x_{t-1} -> x_t, RePaint's time travel;
    ``noise`` is the standard-normal draw."""
    beta = _extract(d.betas, t, x.ndim)
    return torch.sqrt(1 - beta) * x + torch.sqrt(beta) * noise


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
                    x: torch.Tensor, t: torch.Tensor,
                    clip_denoised: bool = False,
                    denoised_fn: Optional[Callable] = None,
                    outpainting_mask: Optional[torch.Tensor] = None,
                    outpainting_gt: Optional[torch.Tensor] = None
                    ) -> Dict[str, torch.Tensor]:
    """p(x_{t-1} | x_t) statistics and pred_xstart from a model output that
    was computed outside (the CFG-doubled denoiser batch lives in the model).
    The predicted x0 goes through ``denoised_fn`` and, with
    ``clip_denoised``, is clipped to [-1, 1] before the posterior mean.
    With an outpainting mask, the kept frames' x0 is the ground truth
    (RePaint in DDIM; start_x prediction only, as the reference asserts)."""
    if outpainting_mask is not None and d.model_mean_type == "start_x":
        model_output = torch.where(outpainting_mask, outpainting_gt, model_output)
    if d.model_var_type in ("learned", "learned_range"):
        # split along axis 1 at x.shape[1], as the JAX package splits it
        C = x.shape[1]
        model_output, var_values = model_output[:, :C], model_output[:, C:]
        if d.model_var_type == "learned":
            model_log_variance = var_values
        else:
            min_log = _extract(d.posterior_log_variance_clipped, t, x.ndim)
            max_log = _extract(d.log_betas, t, x.ndim)
            frac = (var_values + 1) / 2
            model_log_variance = frac * max_log + (1 - frac) * min_log
        model_variance = torch.exp(model_log_variance)
    else:
        if d.model_var_type == "fixed_large":
            variance = d.fixed_large_variance
            log_variance = d.fixed_large_log_variance
        else:
            variance = d.posterior_variance
            log_variance = d.posterior_log_variance_clipped
        model_variance = _extract(variance, t, x.ndim) * torch.ones_like(x)
        model_log_variance = _extract(log_variance, t, x.ndim) * torch.ones_like(x)

    def process_xstart(v):
        if denoised_fn is not None:
            v = denoised_fn(v)
        return v.clamp(-1.0, 1.0) if clip_denoised else v

    if d.model_mean_type == "previous_x":
        pred_xstart = process_xstart(predict_xstart_from_xprev(d, x, t, model_output))
        model_mean = model_output
    else:
        if d.model_mean_type == "start_x":
            pred_xstart = process_xstart(model_output)
        else:
            pred_xstart = process_xstart(predict_xstart_from_eps(d, x, t, model_output))
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


def _mean_flat(x):
    return x.mean(dim=tuple(range(1, x.ndim)))


def normal_kl(mean1, logvar1, mean2, logvar2):
    """KL between two Gaussians, in nats (each argument a tensor or a
    number)."""
    logvar1, logvar2 = (torch.as_tensor(v, dtype=torch.float32) for v in (logvar1, logvar2))
    return 0.5 * (-1.0 + logvar2 - logvar1 + torch.exp(logvar1 - logvar2)
                  + ((mean1 - mean2) ** 2) * torch.exp(-logvar2))


def approx_standard_normal_cdf(x):
    """The tanh approximation of the standard normal CDF."""
    return 0.5 * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))


def discretized_gaussian_log_likelihood(x, *, means, log_scales):
    """The log-likelihood of ``x`` (in [-1, 1], 8-bit bins) under a Gaussian
    discretized to the bins, the edge bins open."""
    centered_x = x - means
    inv_stdv = torch.exp(-log_scales)
    cdf_plus = approx_standard_normal_cdf(inv_stdv * (centered_x + 1.0 / 255.0))
    cdf_min = approx_standard_normal_cdf(inv_stdv * (centered_x - 1.0 / 255.0))
    log_cdf_plus = torch.log(cdf_plus.clamp(min=1e-12))
    log_one_minus_cdf_min = torch.log((1.0 - cdf_min).clamp(min=1e-12))
    log_cdf_delta = torch.log((cdf_plus - cdf_min).clamp(min=1e-12))
    return torch.where(x < -0.999, log_cdf_plus,
                       torch.where(x > 0.999, log_one_minus_cdf_min, log_cdf_delta))


def vb_terms_bpd(d: GaussianDiffusion, model_fn: Callable, x_start, x_t, t,
                 clip_denoised: bool = False) -> Dict[str, torch.Tensor]:
    """The variational lower bound's term at timesteps ``t`` [B], in bits
    per dim: the KL of the true posterior from the model's, and at t = 0
    the decoder's discretized negative log-likelihood."""
    true_mean, _, true_log_var = q_posterior_mean_variance(d, x_start, x_t, t)
    out = p_mean_variance(d, model_fn(x_t, model_timesteps(d, t)), x_t, t,
                          clip_denoised=clip_denoised)
    kl = _mean_flat(normal_kl(true_mean, true_log_var, out["mean"], out["log_variance"]))
    decoder_nll = -discretized_gaussian_log_likelihood(
        x_start, means=out["mean"], log_scales=0.5 * out["log_variance"])
    decoder_nll = _mean_flat(decoder_nll) / math.log(2.0)
    return {"output": torch.where(t == 0, decoder_nll, kl / math.log(2.0)),
            "pred_xstart": out["pred_xstart"]}


def prior_bpd(d: GaussianDiffusion, x_start):
    """The prior's KL term, KL(q(x_T | x_0) || N(0, I)), in bits per dim."""
    t = torch.full((x_start.shape[0],), d.num_timesteps - 1, dtype=torch.long,
                   device=x_start.device)
    qt_mean, _, qt_log_var = q_mean_variance(d, x_start, t)
    return _mean_flat(normal_kl(qt_mean, qt_log_var, 0.0, 0.0)) / math.log(2.0)


def calc_bpd_loop(d: GaussianDiffusion, model_fn: Callable, x_start, randn,
                  clip_denoised: bool = False) -> Dict[str, torch.Tensor]:
    """The whole variational lower bound in bits per dim, over every
    timestep from the last to 0: per timestep the noise (from the draw
    source ``randn``, in that order), x_t, its VLB term, and the MSEs of
    the predicted x0 and of the implied noise; ``total_bpd`` [B] is the
    terms' sum plus the prior's."""
    B = x_start.shape[0]
    vb, xstart_mse, mse = [], [], []
    for step in range(d.num_timesteps - 1, -1, -1):
        t = torch.full((B,), step, dtype=torch.long, device=x_start.device)
        noise = randn(x_start.shape).to(x_start.dtype)
        x_t = q_sample(d, x_start, t, noise)
        out = vb_terms_bpd(d, model_fn, x_start, x_t, t, clip_denoised)
        eps = predict_eps_from_xstart(d, x_t, t, out["pred_xstart"])
        vb.append(out["output"])
        xstart_mse.append(_mean_flat((out["pred_xstart"] - x_start) ** 2))
        mse.append(_mean_flat((eps - noise) ** 2))
    vb, xstart_mse, mse = (torch.stack(v, dim=1) for v in (vb, xstart_mse, mse))  # [B, T]
    prior = prior_bpd(d, x_start)
    return {"total_bpd": vb.sum(dim=1) + prior, "prior_bpd": prior,
            "vb": vb, "xstart_mse": xstart_mse, "mse": mse}
