"""Timestep schedule samplers, uniform and loss-second-moment (PyTorch port
of motioncraft_tpu/diffusion/samplers.py).

The loss history is the JAX package's numpy bookkeeping, copied; draws come
from a ``torch.Generator`` on the device the timesteps are used on.  On one
process every (t, loss) pair of the step is visible on the host, so
``update_with_local_losses`` folds them in directly.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def create_named_schedule_sampler(name: str, num_timesteps: int):
    if name == "uniform":
        return UniformSampler(num_timesteps)
    if name == "loss-second-moment":
        return LossSecondMomentResampler(num_timesteps)
    raise NotImplementedError(f"unknown schedule sampler: {name}")


class ScheduleSampler:
    num_timesteps: int

    def weights(self) -> np.ndarray:
        raise NotImplementedError

    def sample(self, batch_size: int, generator: Optional[torch.Generator] = None,
               device="cpu"):
        """Importance-sample timesteps; returns (t [B] int64, weights [B] f32)."""
        w = np.asarray(self.weights(), dtype=np.float64)
        p = torch.as_tensor(w / w.sum(), dtype=torch.float32, device=device)
        t = torch.multinomial(p, batch_size, replacement=True, generator=generator)
        return t, 1.0 / (len(p) * p[t])


class UniformSampler(ScheduleSampler):
    def __init__(self, num_timesteps: int):
        self.num_timesteps = num_timesteps
        self._weights = np.ones([num_timesteps])

    def weights(self):
        return self._weights

    def sample(self, batch_size: int, generator: Optional[torch.Generator] = None,
               device="cpu"):
        t = torch.randint(0, self.num_timesteps, (batch_size,), generator=generator,
                          device=device)
        return t, torch.ones(batch_size, device=device)


class LossAwareSampler(ScheduleSampler):
    def update_with_local_losses(self, local_ts, local_losses):
        """Fold one step's per-sample (t, loss) pairs into the history
        (tensors or arrays; a device tensor is copied to the host)."""
        ts = np.asarray(torch.as_tensor(local_ts).detach().cpu()).reshape(-1)
        losses = np.asarray(torch.as_tensor(local_losses).detach().cpu()).reshape(-1)
        self.update_with_all_losses(ts.tolist(), losses.tolist())

    def update_with_all_losses(self, ts, losses):
        raise NotImplementedError


class LossSecondMomentResampler(LossAwareSampler):
    def __init__(self, num_timesteps: int, history_per_term: int = 10,
                 uniform_prob: float = 0.001):
        self.num_timesteps = num_timesteps
        self.history_per_term = history_per_term
        self.uniform_prob = uniform_prob
        self._loss_history = np.zeros([num_timesteps, history_per_term], dtype=np.float64)
        self._loss_counts = np.zeros([num_timesteps], dtype=np.int64)

    def weights(self):
        if not self._warmed_up():
            return np.ones([self.num_timesteps], dtype=np.float64)
        weights = np.sqrt(np.mean(self._loss_history ** 2, axis=-1))
        weights /= weights.sum()
        weights *= 1 - self.uniform_prob
        weights += self.uniform_prob / len(weights)
        return weights

    def update_with_all_losses(self, ts, losses):
        for t, loss in zip(ts, losses):
            if self._loss_counts[t] == self.history_per_term:
                self._loss_history[t, :-1] = self._loss_history[t, 1:]
                self._loss_history[t, -1] = loss
            else:
                self._loss_history[t, self._loss_counts[t]] = loss
                self._loss_counts[t] += 1

    def _warmed_up(self):
        return (self._loss_counts == self.history_per_term).all()
