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
(``MotionDiffusion.sample`` runs it).  ``dispatch_batches`` = K groups K
batches: each is sampled in turn on the one generator, as at K = 1, and
the group's predictions are copied to the host together, one wait for
the device a group (the JAX package's one dispatch a group); the
predictions are those of K = 1 bit for bit.

``multi_host_test``: each process samples its interleaved slice (a
``dist=True`` loader) with ``seed + rank``, and ``collect_results`` puts
the ranks' results back in dataset order on every rank.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Iterable, List, Optional

import numpy as np
import torch

from ..models.architecture import resolve_device
from ..utils.dist_utils import collect_results


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
    if dispatch_batches < 1:
        raise ValueError("dispatch_batches must be >= 1")
    device = resolve_device(device)
    if device != arch.device:
        raise ValueError(f"arch lives on {arch.device}, asked to run on {device}")
    generator = torch.Generator(device=device).manual_seed(seed)
    bs = getattr(data_loader, "batch_size", None)
    gt = arch.inference_type == "gt"
    results: List[Dict[str, Any]] = []
    group: list = []  # (batch index, batch, prediction on the device, t0)
    enqueued = 0

    def flush():
        preds = [p.cpu() for _, _, p, _ in group]  # waits for the device
        for (i, batch, _, t0), pred in zip(group, preds):
            res = dict(batch)
            res["pred_motion"] = pred
            results.extend(arch.split_results(res))
            if logger:
                logger(f"batch {i}: {len(pred)} samples in {time.perf_counter() - t0:.3f} s")
        group.clear()

    for i, batch in enumerate(data_loader):
        t0 = time.perf_counter()
        nbatch = _numeric(batch)
        n = nbatch["motion"].shape[0]
        bs = bs or n
        if not gt and n < bs:
            nbatch = {k: _pad_rows(v, bs - n) for k, v in nbatch.items()}
        pred = arch.sample(nbatch, generator=generator, compute_dtype=compute_dtype,
                           step_cache=step_cache)[:n]
        group.append((i, batch, pred, t0))
        enqueued += n
        if len(group) == dispatch_batches:
            flush()
        if limit and enqueued >= limit:
            break
    flush()
    return results[:limit] if limit else results


def multi_host_test(arch, data_loader: Iterable[Dict[str, Any]], *,
                    total_size: Optional[int] = None, seed: int = 0, mesh=None,
                    **kwargs) -> List[Dict[str, Any]]:
    """``single_device_test`` (its keyword arguments in ``kwargs``) over this
    process's interleaved slice of the dataset (``data_loader`` built with
    ``dist=True``), its noise seeded with ``seed + rank``, then every
    rank's results in dataset order, each sample once, cut to
    ``total_size`` (default the whole dataset).  ``mesh``: the data mesh
    (default: over the joined process group, on ``arch``'s device)."""
    if mesh is None:
        from ..parallel.mesh import create_mesh

        mesh = create_mesh(device=arch.device)
    rank = 0 if mesh is None else mesh.rank
    if total_size is None:
        total_size = len(data_loader.dataset)
    local = single_device_test(arch, data_loader, seed=seed + rank, **kwargs)
    return collect_results(local, total_size, mesh)


def mesh_sample(arch, batch: Dict[str, Any], mesh, *, generator=None, randn=None,
                **kwargs) -> torch.Tensor:
    """``arch.sample`` of the global ``batch`` over ``mesh`` (every rank
    calls it with the same batch and generator state): each row-rank
    samples its block of rows (parallel/mesh.py), the random draws taken
    at the global shape (``draw_rows``), the MoEs routed over the global
    batch and, on an expert or tensor axis, the sharded layers computing
    over their groups; returns the whole batch's output in the global
    order, on every rank.  It computes what one process computes on the
    whole batch.  Without a mesh: ``arch.sample``."""
    from ..diffusion import generator_randn
    from ..parallel.mesh import draw_rows, gather_rows, local_batch_size, sampling, shard_batch

    if mesh is None:
        return arch.sample(batch, generator=generator, randn=randn, **kwargs)
    rows = local_batch_size(len(batch["motion"]), mesh)
    base = randn or generator_randn(generator, arch.device)
    with sampling(arch, mesh, rows):
        out = arch.sample(shard_batch(batch, mesh),
                          randn=lambda shape: draw_rows(mesh, base, shape), **kwargs)
    return gather_rows(mesh, out)
