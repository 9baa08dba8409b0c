"""In-training evaluation hook (PyTorch port of
motioncraft_tpu/apis/eval_hook.py).

``EvalHook`` is a callable matching train_model's ``eval_fn(state, epoch)``:
every ``interval`` epochs it samples the test set with the current weights
and runs the dataset's metric suite, tracking the best ``save_best`` key and
writing that epoch's weights to ``best_params.npz`` in the JAX package's
flat layout (utils/checkpoint.py:save_params).
"""

from __future__ import annotations

import os
from typing import Optional


class EvalHook:
    def __init__(self, dataset, arch, batch_size: int = 32, interval: int = 1,
                 limit: Optional[int] = None, save_best: Optional[str] = None,
                 work_dir: Optional[str] = None, logger=print, seed: int = 0,
                 rule: str = "less"):
        self.dataset = dataset
        self.arch = arch
        self.batch_size = batch_size
        self.interval = interval
        self.limit = limit
        self.save_best = save_best
        self.rule = rule
        self.work_dir = work_dir
        self.logger = logger
        self.seed = seed
        self.best = None

    def __call__(self, state, epoch: int):
        if (epoch + 1) % self.interval:
            return None
        from ..data import build_dataloader
        from .test import single_device_test

        loader = build_dataloader(self.dataset, samples_per_gpu=self.batch_size,
                                  shuffle=False, round_up=False)
        loader.drop_last = False
        results = single_device_test(self.arch, loader, seed=self.seed + epoch,
                                     limit=self.limit, device=self.arch.device)
        metrics = self.dataset.evaluate(results, self.work_dir)
        self.logger(f"[eval @ epoch {epoch}] "
                    + " ".join(f"{k}={float(v):.4f}" for k, v in metrics.items()))
        if self.save_best and self.save_best in metrics:
            val = float(metrics[self.save_best])
            better = (self.best is None
                      or (val < self.best if self.rule == "less" else val > self.best))
            if better:
                self.best = val
                if self.work_dir:
                    from ..utils.checkpoint import save_params
                    save_params(os.path.join(self.work_dir, "best_params.npz"), state.model)
                    self.logger(f"new best {self.save_best}={val:.4f} saved")
        return metrics
