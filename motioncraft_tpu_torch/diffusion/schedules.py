"""Beta schedules, timestep respacing and RePaint jump schedules.

Host-side (numpy float64) schedule math.  Semantics match the reference
guided-diffusion port: get_named_beta_schedule / betas_for_alpha_bar /
space_timesteps (reference mogen/models/utils/gaussian_diffusion.py:
235-280, 1346-1404) and the RePaint time-travel schedules
(reference mogen/models/utils/scheduler.py:70-208).  Everything here is
static given the config.  A copy of motioncraft_tpu/diffusion/schedules.py:
the port imports nothing of the JAX package.
"""

from __future__ import annotations

import math
from typing import Iterable, List, Sequence, Set, Union

import numpy as np


def get_named_beta_schedule(schedule_name: str, num_diffusion_timesteps: int) -> np.ndarray:
    """'linear' (Ho et al., scaled to any T) or 'cosine' (Nichol & Dhariwal)."""
    if schedule_name == "linear":
        scale = 1000 / num_diffusion_timesteps
        return np.linspace(scale * 0.0001, scale * 0.02, num_diffusion_timesteps, dtype=np.float64)
    if schedule_name == "cosine":
        return betas_for_alpha_bar(
            num_diffusion_timesteps,
            lambda t: math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2,
        )
    raise NotImplementedError(f"unknown beta schedule: {schedule_name}")


def betas_for_alpha_bar(num_diffusion_timesteps: int, alpha_bar, max_beta: float = 0.999) -> np.ndarray:
    betas = []
    for i in range(num_diffusion_timesteps):
        t1 = i / num_diffusion_timesteps
        t2 = (i + 1) / num_diffusion_timesteps
        betas.append(min(1 - alpha_bar(t2) / alpha_bar(t1), max_beta))
    return np.array(betas, dtype=np.float64)


def space_timesteps(num_timesteps: int, section_counts: Union[str, Sequence[int]]) -> Set[int]:
    """Pick a subset of original timesteps.

    Supports list-of-section-counts, comma strings, ``"ddimN"`` uniform
    striding, and the ``"fast27"`` alias (= '15,15,8,6,6' with the noisiest
    step swapped), matching gaussian_diffusion.py:1346-1404 exactly.
    """
    if isinstance(section_counts, str):
        if section_counts.startswith("ddim"):
            desired_count = int(section_counts[len("ddim"):])
            for i in range(1, num_timesteps):
                if len(range(0, num_timesteps, i)) == desired_count:
                    return set(range(0, num_timesteps, i))
            raise ValueError(f"cannot create exactly {desired_count} steps with an integer stride")
        if section_counts == "fast27":
            steps = space_timesteps(num_timesteps, "15,15,8,6,6")
            steps.remove(num_timesteps - 1)
            steps.add(num_timesteps - 3)
            return steps
        section_counts = [int(x) for x in section_counts.split(",")]
    size_per = num_timesteps // len(section_counts)
    extra = num_timesteps % len(section_counts)
    start_idx = 0
    all_steps: List[int] = []
    for i, section_count in enumerate(section_counts):
        size = size_per + (1 if i < extra else 0)
        if size < section_count:
            raise ValueError(f"cannot divide section of {size} steps into {section_count}")
        frac_stride = 1 if section_count <= 1 else (size - 1) / (section_count - 1)
        cur_idx = 0.0
        for _ in range(section_count):
            all_steps.append(start_idx + round(cur_idx))
            cur_idx += frac_stride
        start_idx += size
    return set(all_steps)


def _check_times(times: Iterable[int], t_0: int, t_T: int) -> None:
    times = list(times)
    assert times[0] > times[1], (times[0], times[1])
    assert times[-1] == -1, times[-1]
    for t_last, t_cur in zip(times[:-1], times[1:]):
        assert abs(t_last - t_cur) == 1, (t_last, t_cur)
    for t in times:
        assert t_0 <= t <= t_T, (t, t_0, t_T)


def get_schedule_jump(t_T: int, n_sample: int, jump_length: int, jump_n_sample: int,
                      jump2_length: int = 1, jump2_n_sample: int = 1,
                      jump3_length: int = 1, jump3_n_sample: int = 1,
                      start_resampling: int = 100000000) -> List[int]:
    """RePaint triple-nested time-travel schedule (scheduler.py:70-147)."""
    jumps = {j: jump_n_sample - 1 for j in range(0, t_T - jump_length, jump_length)}
    jumps2 = {j: jump2_n_sample - 1 for j in range(0, t_T - jump2_length, jump2_length)}
    jumps3 = {j: jump3_n_sample - 1 for j in range(0, t_T - jump3_length, jump3_length)}

    t = t_T
    ts = []
    while t >= 1:
        t -= 1
        ts.append(t)
        if t + 1 < t_T - 1 and t <= start_resampling:
            for _ in range(n_sample - 1):
                t += 1
                ts.append(t)
                if t >= 0:
                    t -= 1
                    ts.append(t)
        if jumps3.get(t, 0) > 0 and t <= start_resampling - jump3_length:
            jumps3[t] -= 1
            for _ in range(jump3_length):
                t += 1
                ts.append(t)
        if jumps2.get(t, 0) > 0 and t <= start_resampling - jump2_length:
            jumps2[t] -= 1
            for _ in range(jump2_length):
                t += 1
                ts.append(t)
            jumps3 = {j: jump3_n_sample - 1 for j in range(0, t_T - jump3_length, jump3_length)}
        if jumps.get(t, 0) > 0 and t <= start_resampling - jump_length:
            jumps[t] -= 1
            for _ in range(jump_length):
                t += 1
                ts.append(t)
            jumps2 = {j: jump2_n_sample - 1 for j in range(0, t_T - jump2_length, jump2_length)}
            jumps3 = {j: jump3_n_sample - 1 for j in range(0, t_T - jump3_length, jump3_length)}
    ts.append(-1)
    _check_times(ts, -1, t_T)
    return ts


def get_schedule_jump_paper() -> List[int]:
    """The fixed 250-step/10-jump schedule from the RePaint paper (scheduler.py:150-176)."""
    t_T, jump_length, jump_n_sample = 250, 10, 10
    jumps = {j: jump_n_sample - 1 for j in range(0, t_T - jump_length, jump_length)}
    t = t_T
    ts = []
    while t >= 1:
        t -= 1
        ts.append(t)
        if jumps.get(t, 0) > 0:
            jumps[t] -= 1
            for _ in range(jump_length):
                t += 1
                ts.append(t)
    ts.append(-1)
    _check_times(ts, -1, t_T)
    return ts


def get_schedule_jump_cjm_ddim(time_respacing: int = 25, jump_length: int = 1,
                               jump_n_sample: int = 1) -> List[int]:
    """Harmonized-DDIM jump schedule starting at t_T = 0.6*steps (scheduler.py:178-208)."""
    t_T = 15 if time_respacing == 25 else int(time_respacing * 0.6)
    jumps = {j: jump_n_sample - 1 for j in range(0, t_T - jump_length, jump_length)}
    t = t_T
    ts = []
    while t >= 1:
        t -= 1
        ts.append(t)
        if jumps.get(t, 0) > 0:
            jumps[t] -= 1
            for _ in range(jump_length):
                t += 1
                ts.append(t)
    ts.append(-1)
    _check_times(ts, -1, t_T)
    return ts


def get_schedule(t_T: int, t_0: int, n_sample: int, n_steplength: int) -> List[int]:
    """Simple resampling schedule (scheduler.py:17-44)."""
    if n_steplength > 1 and not n_sample > 1:
        raise RuntimeError("n_steplength has no effect if n_sample=1")
    t = t_T
    times = [t]
    while t >= 0:
        t -= 1
        times.append(t)
        n_cur = min(n_steplength, t_T - t)
        for _ in range(n_sample - 1):
            for _ in range(n_cur):
                t += 1
                times.append(t)
            for _ in range(n_cur):
                t -= 1
                times.append(t)
    _check_times(times, t_0, t_T)
    return times
