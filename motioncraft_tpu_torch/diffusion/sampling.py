"""Sampling loops, in PyTorch: ancestral DDPM, plain DDIM and
RePaint-harmonized DDIM.

Port of ``p_sample_step`` / ``p_sample_loop`` / ``ddim_step`` /
``ddim_sample_loop`` / ``ddim_sample_loop_harmonize`` of
motioncraft_tpu/diffusion/sampling.py, with the pre-sequence seeding, the
outpainting x0 overwrite and blend, the noisy-tail bank and the step cache
(diffusion/stepcache.py).  Each loop is a Python ``for`` over a schedule
known on the host, so every per-step decision (the timestep, whether a step
denoises or re-noises, the late-stage blend where sqrt(1 - alpha_bar_prev) <
0.2, the tail bank's index) is a host value and nothing in a loop waits for
the device.  The model call is one function handed in by the architecture,
which does the CFG batching itself.

Step cache: with ``step_cache0`` (the per-layer residual cache, on the
device) the model call is ``model_fn(x, t, cache, flags) -> (out,
new_cache)``, where ``flags`` is the step's numpy bool row of the reuse table
(``pattern_flags``): the layers branch on host bools.  The harmonized loop
makes the table against its jump schedule, so the first denoise step after a
re-noising jump computes every layer, and carries the cache through the
re-noising steps untouched.  ``collect_errors`` (plain loop only) runs every
layer and fills a device tensor [steps, layers] of each layer's relative L1
residual change, which the caller copies to the host once.

Randomness: every standard-normal draw goes through ``randn(shape)``, in a
fixed order (per DDPM step: the pre-sequence's q_sample noise, then the
step's noise, drawn at t = 0 too, where it is multiplied by 0, as the JAX
package draws it; per DDIM step: the pre-sequence's q_sample noise, the eta
noise, the outpainting noise; per re-noising step: its noise).  The architecture
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
from .stepcache import StepCacheConfig, pattern_flags

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
    # [num_timesteps, layers] f32 on the device under collect_errors else None
    cache_errors: Optional[torch.Tensor] = None


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


def p_sample_step(d: GaussianDiffusion, model_fn: ModelFn, x: torch.Tensor, t: int, *,
                  randn: Optional[Randn] = None, clip_denoised: bool = False,
                  denoised_fn=None, pre_seq=None):
    """One ancestral DDPM update at step ``t`` (a host int): the posterior
    mean plus exp(log_variance / 2) times the step's noise, which is drawn
    at every step and added where t > 0.  Returns (sample, pred_xstart)."""
    randn = randn or generator_randn(None, x.device)
    tt = torch.full((x.shape[0],), t, dtype=torch.long, device=x.device)
    x = _seed_pre_seq(d, x, tt, pre_seq, randn)
    model_output = model_fn(x, G.model_timesteps(d, tt))
    out = G.p_mean_variance(d, model_output, x, tt, clip_denoised=clip_denoised,
                            denoised_fn=denoised_fn)
    noise = randn(x.shape)
    sample = out["mean"]
    if t != 0:
        sample = sample + torch.exp(0.5 * out["log_variance"]) * noise
    return sample, out["pred_xstart"]


def p_sample_loop(d: GaussianDiffusion, model_fn: ModelFn, noise: torch.Tensor, *,
                  randn: Optional[Randn] = None, clip_denoised: bool = False,
                  denoised_fn=None, pre_seq=None) -> SampleResult:
    """The whole DDPM chain from ``noise`` at the last step down to 0: one
    denoiser call a step."""
    randn = randn or generator_randn(None, noise.device)
    x, pred_x0 = noise, noise
    for t in range(d.num_timesteps - 1, -1, -1):
        x, pred_x0 = p_sample_step(d, model_fn, x, t, randn=randn,
                                   clip_denoised=clip_denoised, denoised_fn=denoised_fn,
                                   pre_seq=pre_seq)
    return SampleResult(sample=x, pred_xstart=pred_x0)


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


def _wrap_cached_model_fn(model_fn, cache, flags_row):
    """The cached ``model_fn(x, t, cache, flags) -> (out, new_cache)`` as the
    plain ``(x, t) -> out`` that ``ddim_step`` calls once, the new cache
    kept in the returned holder."""
    holder = {}

    def mf(x, t):
        out, holder["cache"] = model_fn(x, t, cache, flags_row)
        return out

    return mf, holder


def cache_layers(step_cache0) -> int:
    """The reuse table's width: the layers of the cache (a dict cache, the
    ControlNet's, keeps its layer residuals under "h")."""
    return (step_cache0["h"] if isinstance(step_cache0, dict) else step_cache0).shape[0]


def cache_error(new_cache, old_cache) -> torch.Tensor:
    """Per-layer relative L1 residual change [layers] in f32 (SmoothCache's
    calibration signal); the cache's leading axis is the layers."""
    if isinstance(new_cache, dict):
        new_cache, old_cache = new_cache["h"], old_cache["h"]
    new, old = new_cache.float().flatten(1), old_cache.float().flatten(1)
    return (new - old).abs().sum(dim=1) / (old.abs().sum(dim=1) + 1e-8)


def ddim_sample_loop(d: GaussianDiffusion, model_fn: ModelFn, noise: torch.Tensor, *,
                     eta: float = 0.0, randn: Optional[Randn] = None, pre_seq=None,
                     outpainting: Optional[Outpainting] = None,
                     repaint: Optional[RepaintConfig] = None, step_cache0=None,
                     cache_cfg: Optional[StepCacheConfig] = None) -> SampleResult:
    """The DDIM chain from ``noise`` at the last respaced step down to 0;
    with an outpainting mask and RePaint on, the harmonized loop.  With
    ``step_cache0``, ``model_fn`` takes the cache and the step's flags
    (module docstring)."""
    rp = repaint or RepaintConfig()
    randn = randn or generator_randn(None, noise.device)
    if outpainting is not None and not rp.no_repaint:
        return ddim_sample_loop_harmonize(d, model_fn, noise, eta=eta, randn=randn,
                                          outpainting=outpainting, repaint=rp,
                                          step_cache0=step_cache0, cache_cfg=cache_cfg)
    tails = None
    if outpainting is not None and rp.same_overlap_noisy:
        B, _, D = noise.shape
        tails = noise.new_zeros((d.num_timesteps, B, rp.overlap_len, D))
    cache, errors = step_cache0, None
    if cache is not None:
        cfg = cache_cfg or StepCacheConfig()
        L = cache_layers(cache)
        if cfg.collect_errors:
            flags = np.zeros((d.num_timesteps, L), bool)
            errors = torch.zeros((d.num_timesteps, L), device=noise.device)
        else:
            flags = pattern_flags(d.num_timesteps, L, cfg)
    x, pred_x0, mf = noise, noise, model_fn
    for s, t in enumerate(range(d.num_timesteps - 1, -1, -1)):
        if cache is not None:
            mf, holder = _wrap_cached_model_fn(model_fn, cache, flags[s])
        x, pred_x0, tail = ddim_step(d, mf, x, t, eta=eta, randn=randn,
                                     pre_seq=pre_seq, outpainting=outpainting,
                                     repaint=repaint)
        if cache is not None:
            if errors is not None:
                errors[s] = cache_error(holder["cache"], cache)
            cache = holder["cache"]
        if tails is not None:
            tails[t] = tail
    return SampleResult(sample=x, pred_xstart=pred_x0, noisy_tail=tails,
                        cache_errors=errors)


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
                               randn: Optional[Randn] = None, step_cache0=None,
                               cache_cfg: Optional[StepCacheConfig] = None) -> SampleResult:
    """RePaint time-travel DDIM over the jump schedule: denoising steps run
    ``ddim_step``, the others ``undo``'s re-noising.  A step cache is
    carried through the re-noising steps untouched, and its reuse table
    makes every first denoise step after a jump compute."""
    randn = randn or generator_randn(None, noise.device)
    B, _, D = noise.shape
    tails = (noise.new_zeros((d.num_timesteps, B, repaint.overlap_len, D))
             if repaint.same_overlap_noisy else None)
    schedule = harmonize_schedule(d.num_timesteps, repaint)
    cache = step_cache0
    if cache is not None:
        cfg = cache_cfg or StepCacheConfig()
        if cfg.collect_errors:
            raise NotImplementedError("collect_errors calibration runs on the plain DDIM loop")
        flags = pattern_flags(len(schedule), cache_layers(cache), cfg,
                              denoise_mask=np.array([dn for _, dn in schedule]))
    x, mf = noise, model_fn
    for s, (t_last, denoises) in enumerate(schedule):
        if denoises:
            if cache is not None:
                mf, holder = _wrap_cached_model_fn(model_fn, cache, flags[s])
            x, _, tail = ddim_step(d, mf, x, t_last, eta=eta, randn=randn,
                                   outpainting=outpainting, repaint=repaint)
            if cache is not None:
                cache = holder["cache"]
            if tails is not None:
                tails[t_last] = tail
        else:
            tt = torch.full((B,), t_last, dtype=torch.long, device=x.device)
            x = G.undo(d, x, tt, randn(x.shape))
    return SampleResult(sample=x, pred_xstart=x, noisy_tail=tails)
