"""DDIM sampling loop, in PyTorch.

Port of ``ddim_step`` / ``ddim_sample_loop`` of
motioncraft_tpu/diffusion/sampling.py without the RePaint, outpainting,
pre-sequence and step-cache branches.  The loop is a Python ``for`` over the
respaced timesteps with static shapes; the model call is one function handed
in by the architecture, which does the CFG batching itself.  With ``eta=0``
the loop draws no noise and is deterministic once the initial noise is fixed.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from . import gaussian as G
from .gaussian import GaussianDiffusion

# model_fn(x[B,T,D], t_original[B]) -> model_output[B,T,D]
ModelFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


class SampleResult(NamedTuple):
    sample: torch.Tensor
    pred_xstart: torch.Tensor


def ddim_step(d: GaussianDiffusion, model_fn: ModelFn, x: torch.Tensor,
              t: torch.Tensor, *, eta: float = 0.0,
              generator: Optional[torch.Generator] = None):
    """One DDIM update.  Returns (sample, pred_xstart)."""
    model_output = model_fn(x, G.model_timesteps(d, t))
    out = G.p_mean_variance(d, model_output, x, t)
    eps = G.predict_eps_from_xstart(d, x, t, out["pred_xstart"])
    alpha_bar = G._extract(d.alphas_cumprod, t, x.ndim)
    alpha_bar_prev = G._extract(d.alphas_cumprod_prev, t, x.ndim)
    sigma = (eta * torch.sqrt((1 - alpha_bar_prev) / (1 - alpha_bar))
             * torch.sqrt(1 - alpha_bar / alpha_bar_prev))
    sample = (out["pred_xstart"] * torch.sqrt(alpha_bar_prev)
              + torch.sqrt(1 - alpha_bar_prev - sigma ** 2) * eps)
    if eta > 0:
        noise = torch.randn(x.shape, generator=generator, device=x.device,
                            dtype=x.dtype)
        nonzero = (t != 0).to(x.dtype).reshape((-1,) + (1,) * (x.ndim - 1))
        sample = sample + nonzero * sigma * noise
    return sample, out["pred_xstart"]


def ddim_sample_loop(d: GaussianDiffusion, model_fn: ModelFn,
                     noise: torch.Tensor, *, eta: float = 0.0,
                     generator: Optional[torch.Generator] = None) -> SampleResult:
    """The DDIM chain from ``noise`` at the last respaced step down to 0."""
    B = noise.shape[0]
    x, pred_x0 = noise, noise
    for t_scalar in range(d.num_timesteps - 1, -1, -1):
        t = torch.full((B,), t_scalar, dtype=torch.long, device=noise.device)
        x, pred_x0 = ddim_step(d, model_fn, x, t, eta=eta, generator=generator)
    return SampleResult(sample=x, pred_xstart=pred_x0)
