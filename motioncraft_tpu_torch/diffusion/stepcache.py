"""Diffusion step caching (SmoothCache-style layer-residual reuse), the
port's own copy of motioncraft_tpu/diffusion/stepcache.py (numpy only).

Adjacent DDIM steps give highly correlated per-layer residuals in DiT-style
denoisers; SmoothCache (arXiv:2411.10510) reuses a layer's cached residual
on steps where its rate of change is small and skips that layer's compute.

The reuse/compute decision per (step, layer) is a static schedule made on
the host: a numpy bool table.  The eager samplers (diffusion/sampling.py)
read one row of it per step, and each layer takes a real Python branch: it
runs, or it replays ``cache[layer]`` without launching anything.  The
per-layer residual cache [L, 2B, T, D] stays on the device in the compute
dtype; nothing in the loop reads a device value.

Flag tables come from a uniform pattern (``reuse_every``) or from a
calibration run that measures each layer's relative L1 residual change
along the real sampling trajectory (``flags_from_errors``).  Opt-in: the
defaults leave every sampler exact.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class StepCacheConfig:
    """Static step-cache knobs.

    reuse_every: within a consecutive run of denoise steps, compute a layer on
        every ``reuse_every``-th step and reuse its cached residual otherwise
        (2 -> about half the layer computes).
    warmup: leading denoise steps of each run that always compute (the first
        step of a chain must compute: the cache starts at zeros).
    tail: trailing schedule steps that always compute (low-t steps set the
        fine detail).
    flags: explicit [num_steps, num_layers] bool table, overriding the
        pattern (e.g. from ``flags_from_errors``).
    collect_errors: ``MotionDiffusion.sample`` runs the cache machinery with
        all-compute flags and also returns the per-(step, layer) relative L1
        residual change, for calibration.
    """

    reuse_every: int = 2
    warmup: int = 2
    tail: int = 2
    flags: Optional[np.ndarray] = None
    collect_errors: bool = False

    def __post_init__(self):
        if self.reuse_every < 1:
            raise ValueError("reuse_every must be >= 1")
        if self.warmup < 1:
            raise ValueError("warmup must be >= 1 (step 0 must compute: "
                             "the residual cache starts at zeros)")


def pattern_flags(num_steps: int, num_layers: int, cfg: StepCacheConfig,
                  denoise_mask: Optional[np.ndarray] = None) -> np.ndarray:
    """[num_steps, num_layers] bool reuse table from the uniform pattern.

    ``denoise_mask`` marks which schedule steps call the model (the RePaint
    harmonized loop interleaves ``undo`` re-noising steps); a re-noising
    step resets the run counter, so the first denoise after a jump always
    recomputes (x just changed discontinuously).
    """
    if cfg.flags is not None:
        flags = np.asarray(cfg.flags, dtype=bool)
        if flags.shape != (num_steps, num_layers):
            raise ValueError(f"explicit flags shape {flags.shape} != "
                             f"{(num_steps, num_layers)}")
        if flags[0].any():
            raise ValueError("step 0 cannot reuse: cache starts at zeros")
        if denoise_mask is not None:
            # the first denoise step after an ``undo`` re-noise would replay
            # a residual cached across the discontinuity
            mask = np.asarray(denoise_mask, dtype=bool)
            first_after_jump = mask & np.concatenate([[True], ~mask[:-1]])
            bad = flags[first_after_jump]
            if bad.any():
                raise ValueError(
                    "explicit flags mark reuse on the first denoise step "
                    "after a re-noise jump (steps "
                    f"{np.nonzero(first_after_jump)[0][bad.any(axis=1)].tolist()}); "
                    "the cached residual predates the discontinuity: zero "
                    "those rows or regenerate the table with this "
                    "denoise_mask")
        return flags
    flags = np.zeros((num_steps, num_layers), dtype=bool)
    run = 0
    for s in range(num_steps):
        if denoise_mask is not None and not denoise_mask[s]:
            run = 0
            continue
        if (run >= cfg.warmup and s < num_steps - cfg.tail
                and run % cfg.reuse_every != 0):
            flags[s, :] = True
        run += 1
    return flags


def flags_from_errors(errors: np.ndarray, threshold: float,
                      max_consecutive: int = 3, tail: int = 2) -> np.ndarray:
    """Calibrated reuse table from measured residual change.

    ``errors[s, l]`` is layer ``l``'s relative L1 residual change at step
    ``s`` against its previous computed residual (from a
    ``StepCacheConfig(collect_errors=True)`` run).  A layer reuses at step
    ``s`` when its preceding step's change was under ``threshold`` (the
    SmoothCache criterion), at most ``max_consecutive`` times in a row so
    that drift cannot build up; the last ``tail`` steps always compute, and
    so does step 0.
    """
    errors = np.asarray(errors, dtype=np.float64)
    S, L = errors.shape
    flags = np.zeros((S, L), dtype=bool)
    streak = np.zeros((L,), dtype=np.int64)
    for s in range(1, S):
        for l in range(L):
            if (s < S - tail and errors[s - 1, l] < threshold
                    and streak[l] < max_consecutive):
                flags[s, l] = True
                streak[l] += 1
            else:
                streak[l] = 0
    return flags


def load_flags(path: str) -> np.ndarray:
    """A calibrated [steps, layers] reuse table written by
    tools/torch_calibrate_step_cache.py (or tools/calibrate_step_cache.py):
    its ``.npz`` output or its ``--json`` artifact (e.g.
    ``artifacts/step_cache_flagship.json``)."""
    if path.endswith(".json"):
        with open(path) as f:
            return np.asarray(json.load(f)["flags"], dtype=bool)
    return np.load(path)["flags"].astype(bool)

