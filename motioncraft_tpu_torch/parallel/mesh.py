"""The data mesh: data-parallel processes on torch.distributed (PyTorch port
of motioncraft_tpu/parallel/mesh.py, its ``data`` axis).

The JAX package shards the batch over a ``data`` mesh axis and lets XLA
insert the collectives; its step computes what one device computes on the
global batch.  The port runs one process a rank, one card each
(NCCL by default; gloo where the caller names it, as the CPU tests and
several ranks on one card do), and a ``DataMesh`` says which rank this is,
where it computes and over which process group.  The model-sharding axes
(``expert``, ``tensor``, ``pipe``) are the next slice.

Where the rows of the global batch live (one module knows it): with
``grad_accum`` = G microbatches of m = B / G rows, rank r of W holds the
rows ``i * m + r * m / W + j`` (0 <= j < m / W) as its microbatch i, so
that every rank holds its share of every microbatch and microbatch i is
global rows ``i * m .. (i + 1) * m``, the JAX package's ``[G, B / G]``
reshape.  At G = 1 that is ``P('data')``'s contiguous block.  Per-row
random draws (``draw_rows``) are taken at the global microbatch's shape
and the rank keeps its block, so a W-rank step draws what one process at
the global batch draws; ``gather_rows`` puts the ranks' per-row vectors
back in the global order.
"""

from __future__ import annotations

import datetime
import os
import socket
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
NEXT_SLICE = "ROADMAP queue 1: multi-GPU: the model across cards"
# a collective's limit: a rank may wait at a barrier while rank 0 writes a
# checkpoint or runs the evaluation hook
DEFAULT_TIMEOUT_S = 1800.0


@dataclass
class DataMesh:
    """``world`` data-parallel ranks; this process is ``rank`` and computes
    on ``device``; collectives run over ``group`` (None: the default
    process group) with ``backend``."""

    world: int
    rank: int
    device: torch.device
    backend: str
    group: Any = None

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: self.world}

    @property
    def host_device(self) -> torch.device:
        """Where host data (pickled results) crosses: the card under NCCL,
        which moves device memory only; the host under gloo."""
        return self.device if self.backend == "nccl" else torch.device("cpu")

    def barrier(self) -> None:
        dist.barrier(group=self.group)


def _init_method(address: str) -> str:
    return address if "://" in address else f"tcp://{address}"


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, backend: str = "nccl",
                     timeout_s: float = DEFAULT_TIMEOUT_S) -> int:
    """Join the process group (the JAX package's ``jax.distributed.initialize``)
    and return this process's rank.  The arguments given explicitly (the
    coordinator's ``host:port``, or an ``init_method`` URL such as
    ``file:///path``), else torchrun's environment (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``); with neither, or at
    one process, nothing is joined and the rank is 0.  ``backend``: NCCL
    (one card a rank) unless the caller names gloo."""
    if dist.is_initialized():
        return dist.get_rank()
    env = os.environ
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    if coordinator_address is None and "MASTER_ADDR" in env:
        coordinator_address = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
    if not num_processes or num_processes == 1:
        return 0
    if coordinator_address is None or process_id is None:
        raise ValueError(f"{num_processes} processes need a coordinator address and "
                         "this process's id (or torchrun's RANK / MASTER_ADDR)")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: 'nccl' or 'gloo'")
    dist.init_process_group(backend, init_method=_init_method(coordinator_address),
                            world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return process_id


def local_device(rank: int) -> torch.device:
    """The card of a rank: ``LOCAL_RANK`` where torchrun sets it, else the
    rank modulo the cards this host has.  Raises without a card."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' (and the gloo backend) "
                           "to run the ranks on the CPU")
    local = int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count()))
    return torch.device("cuda", local)


def create_mesh(n_devices: Optional[int] = None, axes: Sequence[str] = (DATA_AXIS,),
                shape: Optional[Sequence[int]] = None, device=None) -> Optional[DataMesh]:
    """The data mesh over the joined process group, one device a rank
    (``device``, default this rank's card).  Without a process group and at
    one device: None, the one-process path.  An ``expert`` or ``tensor``
    axis of size above 1 raises: the model across cards is not ported."""
    shape = tuple(shape) if shape is not None else (n_devices or 0,) + (1,) * (len(axes) - 1)
    for axis, size in zip(axes, shape):
        if axis != DATA_AXIS and size > 1:
            raise NotImplementedError(f"a {axis!r} mesh axis of {size}: {NEXT_SLICE}")
    if not dist.is_initialized():
        if (n_devices or 1) > 1:
            raise RuntimeError(f"a data mesh of {n_devices} needs the process group: "
                               "init_distributed first (one process a rank)")
        return None
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_devices not in (None, world):
        raise ValueError(f"{n_devices} devices over {world} processes: one device a rank")
    device = torch.device(device) if device is not None else local_device(rank)
    backend = dist.get_backend()
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError(f"NCCL moves CUDA tensors: a rank on {device} needs gloo")
        torch.cuda.set_device(device)
    return DataMesh(world, rank, device, backend)


def local_batch_size(global_batch: int, mesh: Optional[DataMesh]) -> int:
    if mesh is None:
        return global_batch
    if global_batch % mesh.world:
        raise ValueError(f"a global batch of {global_batch} over {mesh.world} ranks")
    return global_batch // mesh.world


def local_rows(global_batch: int, mesh: Optional[DataMesh], grad_accum: int = 1) -> np.ndarray:
    """The global row indices this rank holds, in its local order (the
    module docstring's layout)."""
    if mesh is None:
        return np.arange(global_batch)
    if global_batch % (grad_accum * mesh.world):
        raise ValueError(f"a global batch of {global_batch} in {grad_accum} microbatches "
                         f"over {mesh.world} ranks")
    m = global_batch // grad_accum
    share = m // mesh.world
    return (np.arange(grad_accum)[:, None] * m + mesh.rank * share
            + np.arange(share)[None, :]).reshape(-1)


def shard_batch(batch: Dict[str, Any], mesh: Optional[DataMesh],
                grad_accum: int = 1) -> Dict[str, Any]:
    """This rank's rows of a global host batch (arrays, tensors and lists
    with the batch's leading size; other values as they are)."""
    if mesh is None:
        return batch
    B = len(batch["motion"])
    rows = local_rows(B, mesh, grad_accum)

    def take(v):
        if (isinstance(v, np.ndarray) or torch.is_tensor(v)) and v.ndim and len(v) == B:
            return v[torch.as_tensor(rows) if torch.is_tensor(v) else rows]
        if isinstance(v, list) and len(v) == B:
            return [v[i] for i in rows]
        return v

    return {k: take(v) for k, v in batch.items()}


def draw_rows(mesh: Optional[DataMesh], draw: Callable[[tuple], torch.Tensor],
              shape: Sequence[int]) -> torch.Tensor:
    """``draw(shape)``, a per-row random draw of this rank's (micro)batch;
    on a data mesh drawn at the global (micro)batch's shape, every rank from
    the same generator state, and this rank's rows kept."""
    shape = tuple(shape)
    if mesh is None:
        return draw(shape)
    n = shape[0]
    return draw((n * mesh.world,) + shape[1:])[mesh.rank * n:(mesh.rank + 1) * n]


def gather_rows(mesh: Optional[DataMesh], x: torch.Tensor, grad_accum: int = 1) -> torch.Tensor:
    """The ranks' per-row vectors [B / W, ...] in the global order [B, ...]."""
    if mesh is None:
        return x
    from ..utils.dist_utils import all_gather_rows

    with torch.no_grad():
        full = all_gather_rows(x.contiguous(), mesh)                 # [W * B / W] rank-major
    share = x.shape[0] // grad_accum
    full = full.reshape((mesh.world, grad_accum, share) + tuple(x.shape[1:]))
    return full.transpose(0, 1).reshape((-1,) + tuple(x.shape[1:]))


def attach_mesh(module: torch.nn.Module, mesh: Optional[DataMesh]) -> None:
    """Hand ``mesh`` to every submodule that computes over the batch in
    training (each declares a ``mesh`` attribute): the MoE's routing, the
    BatchNorms' statistics, the dropout masks, the loss's reductions."""
    for m in module.modules():
        if hasattr(type(m), "mesh"):
            m.mesh = mesh


def broadcast_module(module: torch.nn.Module, mesh: Optional[DataMesh]) -> None:
    """Every rank takes rank 0's parameters and buffers."""
    if mesh is None:
        return
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, src=0, group=mesh.group)


def free_port() -> int:
    """A free TCP port of this host, for a ``tcp://localhost:<port>``
    rendezvous."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_entry(rank, fn, world, init_method, backend, group_timeout_s, results, args):
    import pickle

    init_distributed(init_method, world, rank, backend=backend, timeout_s=group_timeout_s)
    try:
        # pickled here, tensors by value: the queue's own pickler would hand
        # the parent shared memory of a process that is about to exit
        results.put((rank, pickle.dumps(fn(rank, *args))))
    finally:
        dist.destroy_process_group()


def launch(fn: Callable, world: int, args: tuple = (), init_method: Optional[str] = None,
           backend: str = "nccl", timeout_s: Optional[float] = None,
           group_timeout_s: float = DEFAULT_TIMEOUT_S) -> list:
    """Run ``fn(rank, *args)`` in ``world`` spawned processes, each in the
    process group (``init_method``: default ``tcp://localhost:<a free
    port>``; a ``file://`` URL keeps concurrent launches apart; a
    collective that waits ``group_timeout_s`` fails its rank), and return
    their results by rank.  A rank that raises, or a launch that passes
    ``timeout_s`` (default: none), raises here; the other ranks are
    ended."""
    import pickle
    import time

    import torch.multiprocessing as mp

    init_method = init_method or f"tcp://localhost:{free_port()}"
    ctx = mp.get_context("spawn")
    results = ctx.SimpleQueue()
    procs = mp.start_processes(_rank_entry, args=(fn, world, init_method, backend,
                                                  group_timeout_s, results, args),
                               nprocs=world, join=False, start_method="spawn")
    deadline = None if timeout_s is None else time.monotonic() + timeout_s
    out: Dict[int, Any] = {}
    try:
        while True:
            while not results.empty():   # drained before the joins
                rank, value = results.get()
                out[rank] = pickle.loads(value)  # bytes that the ranks wrote
            if procs.join(timeout=0.2):
                break
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"{world} ranks did not finish in {timeout_s:.0f} s")
        while not results.empty():
            rank, value = results.get()
            out[rank] = pickle.loads(value)
    finally:
        for p in procs.processes:
            if p.is_alive():
                p.kill()
            p.join(5)
    if len(out) != world:
        raise RuntimeError(f"ranks {sorted(set(range(world)) - set(out))} returned nothing")
    return [out[r] for r in range(world)]
