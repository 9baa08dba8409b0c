"""Testing API: batched sampling over an iterable of request batches
(PyTorch port of ``single_device_test`` of motioncraft_tpu/apis/test.py).

A plain loop: one ``MotionDiffusion.sample`` call per batch, the prediction
copied to the host, the results split per sample.  The noise of every batch
comes from one generator seeded with ``seed``, in batch order.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Iterable, List, Optional

import torch

from ..models.architecture import resolve_device


def single_device_test(arch, batches: Iterable[Dict[str, Any]], *, seed: int = 0,
                       limit: Optional[int] = None, device=None,
                       logger: Optional[Callable[[str], None]] = None
                       ) -> List[Dict[str, Any]]:
    """Sample every batch (dicts of numpy arrays: ``motion``, ``motion_mask``,
    ``motion_length``, ``text_ids``, optionally ``motion_metas``) on
    ``device`` (the card unless the caller asks for the CPU) and return one
    host dict per sample, ``pred_motion`` included.  ``logger`` gets one line
    per batch with its wall time."""
    device = resolve_device(device)
    if device != arch.device:
        raise ValueError(f"arch lives on {arch.device}, asked to run on {device}")
    generator = torch.Generator(device=device).manual_seed(seed)
    results: List[Dict[str, Any]] = []
    for i, batch in enumerate(batches):
        t0 = time.perf_counter()
        pred = arch.sample(batch, generator=generator).cpu()  # waits for the device
        res = dict(batch)
        res["pred_motion"] = pred
        results.extend(arch.split_results(res))
        if logger:
            logger(f"batch {i}: {pred.shape[0]} samples in "
                   f"{time.perf_counter() - t0:.3f} s")
        if limit and len(results) >= limit:
            break
    return results[:limit] if limit else results
