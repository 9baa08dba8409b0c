"""DDIM sampling loops, in PyTorch: plain DDIM and RePaint-harmonized DDIM.

Port of ``ddim_step`` / ``ddim_sample_loop`` / ``ddim_sample_loop_harmonize``
of motioncraft_tpu/diffusion/sampling.py, with the pre-sequence seeding, the
outpainting x0 overwrite and blend, and the noisy-tail bank; the step cache
is not ported.  Each loop is a Python ``for`` over a schedule known on the
host, so every per-step decision (the timestep, whether a step denoises or
re-noises, the late-stage blend where sqrt(1 - alpha_bar_prev) < 0.2, the
tail bank's index) is a host value and nothing in a loop waits for the
device.  The model call is one function handed in by the architecture,
which does the CFG batching itself.

Randomness: every standard-normal draw goes through ``randn(shape)``, in a
fixed order (per DDIM step: the pre-sequence's q_sample noise, the eta noise,
the outpainting noise; per re-noising step: its noise).  The architecture
draws from a ``torch.Generator`` (``generator_randn``); ``Replay`` hands
in given draws (the JAX package's in the tests, the same ones to the card
and the CPU).  With ``eta=0`` the eta noise is not drawn (it is
multiplied by 0 in the JAX package).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch

from . import gaussian as G
from .gaussian import GaussianDiffusion
from .schedules import get_schedule_jump_cjm_ddim

# model_fn(x[B,T,D], t_original[B]) -> model_output[B,T,D]
ModelFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
# randn(shape) -> a standard-normal float32 tensor of that shape on the device
Randn = Callable[[Sequence[int]], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class RepaintConfig:
    """Static RePaint/outpainting knobs."""

    overlap_len: int = 4
    add_blend: bool = True
    same_overlap_noisy: bool = False
    no_repaint: bool = False
    no_resample: bool = False
    jump_length: int = 3
    jump_n_sample: int = 2


class Outpainting(NamedTuple):
    """Per-window outpainting state."""

    mask: torch.Tensor  # bool [B, T, D]; True where the ground truth is kept
    gt: torch.Tensor  # [B, T, D]
    clip_idx: int = 0  # window index (host)
    # noised tails saved by the previous window, [num_timesteps, B, overlap, D]
    previous_noisy_tail: Optional[torch.Tensor] = None


class SampleResult(NamedTuple):
    sample: torch.Tensor
    pred_xstart: torch.Tensor
    # [num_timesteps, B, overlap, D] when repaint.same_overlap_noisy else None
    noisy_tail: Optional[torch.Tensor] = None


def generator_randn(generator: Optional[torch.Generator], device) -> Randn:
    """``torch.randn`` from ``generator`` (the global generator of
    ``device`` when None) as a draw source."""
    def randn(shape):
        return torch.randn(tuple(shape), generator=generator, device=device)
    return randn


class Replay:
    """A draw source that hands out the given arrays (numpy or tensors) in
    order, on ``device``, checking each shape: the same draws for every run
    that takes one (the card and the CPU, or the JAX package's draws)."""

    def __init__(self, draws, device="cpu"):
        self.draws, self.device, self.used = list(draws), device, 0

    def __call__(self, shape):
        if self.used == len(self.draws):
            raise IndexError(f"Replay: all {self.used} draws are used")
        a = self.draws[self.used]
        if tuple(a.shape) != tuple(shape):
            raise ValueError(f"Replay: draw {self.used} is {tuple(a.shape)}, "
                             f"asked for {tuple(shape)}")
        self.used += 1
        t = a if torch.is_tensor(a) else torch.from_numpy(np.array(a, np.float32))
        return t.to(self.device, torch.float32, copy=True)

    def done(self):
        return self.used == len(self.draws)


def _seed_pre_seq(d: GaussianDiffusion, x, t, pre_seq, randn: Randn):
    """Overwrite the leading frames with the noised previous-window output."""
    if pre_seq is None:
        return x
    x_t = G.q_sample(d, pre_seq, t, randn(pre_seq.shape))
    return torch.cat([x_t, x[:, pre_seq.shape[1]:]], dim=1)


def ddim_step(d: GaussianDiffusion, model_fn: ModelFn, x: torch.Tensor, t: int, *,
              eta: float = 0.0, randn: Optional[Randn] = None, pre_seq=None,
              outpainting: Optional[Outpainting] = None,
              repaint: Optional[RepaintConfig] = None):
    """One DDIM update at the respaced step ``t`` (a host int), with the
    RePaint blend after the update.  Returns (sample, pred_xstart,
    saved_tail or None)."""
    randn = randn or generator_randn(None, x.device)
    B = x.shape[0]
    tt = torch.full((B,), t, dtype=torch.long, device=x.device)
    x = _seed_pre_seq(d, x, tt, pre_seq, randn)
    model_output = model_fn(x, G.model_timesteps(d, tt))
    out = G.p_mean_variance(
        d, model_output, x, tt,
        outpainting_mask=None if outpainting is None else outpainting.mask,
        outpainting_gt=None if outpainting is None else outpainting.gt)
    eps = G.predict_eps_from_xstart(d, x, tt, out["pred_xstart"])
    alpha_bar = G._extract(d.alphas_cumprod, tt, x.ndim)
    alpha_bar_prev = G._extract(d.alphas_cumprod_prev, tt, x.ndim)
    sigma = (eta * torch.sqrt((1 - alpha_bar_prev) / (1 - alpha_bar))
             * torch.sqrt(1 - alpha_bar / alpha_bar_prev))
    sample = (out["pred_xstart"] * torch.sqrt(alpha_bar_prev)
              + torch.sqrt(1 - alpha_bar_prev - sigma ** 2) * eps)
    if eta > 0:
        noise = randn(x.shape)
        if t != 0:
            sample = sample + sigma * noise

    saved_tail = None
    if outpainting is not None:
        rp = repaint or RepaintConfig()
        ov = rp.overlap_len
        if rp.same_overlap_noisy and outpainting.clip_idx > 0:
            # the exact noisy tail the previous window saved at this t
            prev_tail = outpainting.previous_noisy_tail[t]
            weighed_gt = torch.cat([prev_tail, outpainting.gt[:, ov:]], dim=1)
        else:
            weighed_gt = (torch.sqrt(alpha_bar_prev) * outpainting.gt
                          + torch.sqrt(1 - alpha_bar_prev) * randn(x.shape))
        # the late-stage linear crossfade over the overlap, decided on the
        # host from the same float32 table the device reads
        acp_prev = d.alphas_cumprod_prev_host[t]
        if rp.add_blend and np.sqrt(np.float32(1) - acp_prev) < np.float32(0.2):
            lin = torch.linspace(0.0, 1.0, ov, dtype=x.dtype, device=x.device).reshape(1, ov, 1)
            blended = weighed_gt[:, :ov] * (1 - lin) + sample[:, :ov] * lin
            weighed_gt = torch.cat([blended, weighed_gt[:, ov:]], dim=1)
        sample = torch.where(outpainting.mask, weighed_gt, sample)
        if rp.same_overlap_noisy:
            saved_tail = sample[:, -ov:]
    return sample, out["pred_xstart"], saved_tail


def ddim_sample_loop(d: GaussianDiffusion, model_fn: ModelFn, noise: torch.Tensor, *,
                     eta: float = 0.0, randn: Optional[Randn] = None, pre_seq=None,
                     outpainting: Optional[Outpainting] = None,
                     repaint: Optional[RepaintConfig] = None) -> SampleResult:
    """The DDIM chain from ``noise`` at the last respaced step down to 0;
    with an outpainting mask and RePaint on, the harmonized loop."""
    rp = repaint or RepaintConfig()
    randn = randn or generator_randn(None, noise.device)
    if outpainting is not None and not rp.no_repaint:
        return ddim_sample_loop_harmonize(d, model_fn, noise, eta=eta, randn=randn,
                                          outpainting=outpainting, repaint=rp)
    tails = None
    if outpainting is not None and rp.same_overlap_noisy:
        B, _, D = noise.shape
        tails = noise.new_zeros((d.num_timesteps, B, rp.overlap_len, D))
    x, pred_x0 = noise, noise
    for t in range(d.num_timesteps - 1, -1, -1):
        x, pred_x0, tail = ddim_step(d, model_fn, x, t, eta=eta, randn=randn,
                                     pre_seq=pre_seq, outpainting=outpainting,
                                     repaint=repaint)
        if tails is not None:
            tails[t] = tail
    return SampleResult(sample=x, pred_xstart=pred_x0, noisy_tail=tails)


def harmonize_schedule(num_timesteps: int, repaint: RepaintConfig):
    """The RePaint jump schedule as (t_last, denoises) pairs: a step from
    t_last to a smaller t denoises, one to a larger t re-noises."""
    if repaint.no_resample:
        times = get_schedule_jump_cjm_ddim(num_timesteps)
    else:
        times = get_schedule_jump_cjm_ddim(num_timesteps, jump_length=repaint.jump_length,
                                           jump_n_sample=repaint.jump_n_sample)
    return [(t_last, t_cur < t_last) for t_last, t_cur in zip(times[:-1], times[1:])]


def ddim_sample_loop_harmonize(d: GaussianDiffusion, model_fn: ModelFn,
                               noise: torch.Tensor, *, outpainting: Outpainting,
                               repaint: RepaintConfig, eta: float = 0.0,
                               randn: Optional[Randn] = None) -> SampleResult:
    """RePaint time-travel DDIM over the jump schedule: denoising steps run
    ``ddim_step``, the others ``undo``'s re-noising."""
    randn = randn or generator_randn(None, noise.device)
    B, _, D = noise.shape
    tails = (noise.new_zeros((d.num_timesteps, B, repaint.overlap_len, D))
             if repaint.same_overlap_noisy else None)
    x = noise
    for t_last, denoises in harmonize_schedule(d.num_timesteps, repaint):
        if denoises:
            x, _, tail = ddim_step(d, model_fn, x, t_last, eta=eta, randn=randn,
                                   outpainting=outpainting, repaint=repaint)
            if tails is not None:
                tails[t_last] = tail
        else:
            tt = torch.full((B,), t_last, dtype=torch.long, device=x.device)
            x = G.undo(d, x, tt, randn(x.shape))
    return SampleResult(sample=x, pred_xstart=x, noisy_tail=tails)
