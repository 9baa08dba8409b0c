"""Testing API: batched sampling over a loader (PyTorch port of
``single_device_test`` of motioncraft_tpu/apis/test.py).

A plain loop: one ``MotionDiffusion.sample`` call per batch, the prediction
copied to the host, the results split per sample.  The noise of every batch
comes from one generator seeded with ``seed``, in batch order.  A batch
shorter than the loader's ``batch_size`` (the last of an epoch) is padded up
to it by repeating its last row, and the extra predictions are dropped, as
in the JAX package: MoE capacity depends on the token count, so the short
batch would otherwise route differently.  GT mode is not padded.
``step_cache`` (diffusion/stepcache.py) is handed to every batch's sampling
call; its calibration mode, ``collect_errors``, is refused here
(``MotionDiffusion.sample`` runs it).
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Iterable, List, Optional

import numpy as np
import torch

from ..models.architecture import resolve_device


def _numeric(batch: Dict[str, Any]) -> Dict[str, Any]:
    return {k: v for k, v in batch.items()
            if torch.is_tensor(v) or (isinstance(v, np.ndarray)
                                      and np.issubdtype(v.dtype, np.number))}


def _pad_rows(v, pad: int):
    rows = [v] + [v[-1:]] * pad
    return torch.cat(rows) if torch.is_tensor(v) else np.concatenate(rows)


def single_device_test(arch, data_loader: Iterable[Dict[str, Any]], *, seed: int = 0,
                       limit: Optional[int] = None, device=None,
                       logger: Optional[Callable[[str], None]] = None,
                       dispatch_batches: int = 1,
                       compute_dtype: Optional[torch.dtype] = None,
                       step_cache=None) -> List[Dict[str, Any]]:
    """Sample every batch of ``data_loader`` (a ``data.DataLoader`` or any
    iterable of dicts of numpy arrays: ``motion``, ``motion_mask``,
    ``motion_length``, ``text_ids``, optionally ``motion_metas``, which the
    evaluator reads) on ``device`` (the card unless the caller asks for the
    CPU) and return one host dict per sample, ``pred_motion`` included.  The
    batch size padded to is the loader's ``batch_size``, or for a plain
    iterable that of its first batch.  ``logger`` gets one line per batch
    with its wall time.  ``compute_dtype`` is the denoiser's dtype
    (``MotionDiffusion.sample``; bf16 on a bf16-cast model), ``step_cache``
    its ``StepCacheConfig``."""
    if step_cache is not None and step_cache.collect_errors:
        raise ValueError("collect_errors is a calibration mode; use "
                         "MotionDiffusion.sample directly")
    if dispatch_batches != 1:
        raise NotImplementedError("dispatch_batches > 1 (batches grouped into one device "
                                  "dispatch): ROADMAP queue 1: multi-GPU, serving and the "
                                  "host-side tools")
    device = resolve_device(device)
    if device != arch.device:
        raise ValueError(f"arch lives on {arch.device}, asked to run on {device}")
    generator = torch.Generator(device=device).manual_seed(seed)
    bs = getattr(data_loader, "batch_size", None)
    gt = arch.inference_type == "gt"
    results: List[Dict[str, Any]] = []
    for i, batch in enumerate(data_loader):
        t0 = time.perf_counter()
        nbatch = _numeric(batch)
        n = nbatch["motion"].shape[0]
        bs = bs or n
        if not gt and n < bs:
            nbatch = {k: _pad_rows(v, bs - n) for k, v in nbatch.items()}
        pred = arch.sample(nbatch, generator=generator, compute_dtype=compute_dtype,
                           step_cache=step_cache)[:n].cpu()  # waits for the device
        res = dict(batch)
        res["pred_motion"] = pred
        results.extend(arch.split_results(res))
        if logger:
            logger(f"batch {i}: {n} samples in {time.perf_counter() - t0:.3f} s")
        if limit and len(results) >= limit:
            break
    return results[:limit] if limit else results


def multi_host_test(*args, **kwargs):
    raise NotImplementedError("multi_host_test (sampling over several processes): "
                              "ROADMAP queue 1: multi-GPU, serving and the host-side tools")
