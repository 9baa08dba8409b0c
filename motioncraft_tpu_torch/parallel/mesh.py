"""The device mesh: data-, expert- and tensor-parallel processes on
torch.distributed (PyTorch port of motioncraft_tpu/parallel/mesh.py).

The JAX package shards the batch over a ``data`` mesh axis, the experts
over ``expert`` and the FFNs' hidden dims over ``tensor``, and lets XLA
insert the collectives; its step computes what one device computes on the
global batch.  The port runs one process a rank, one card each (NCCL by
default; gloo where the caller names it, as the CPU tests and several
ranks on one card do), and a ``DataMesh`` says which rank this is, where it
computes, its coordinates on the axes and the process group of every set
of axes.  A rank's coordinates follow ``np.asarray(devices).reshape(shape)``
(row-major over ``(data, expert, tensor)``), as the JAX package lays its
devices out.  A ``pipe`` axis above 1 raises (PIPELINE).

Which rows a rank holds (one module knows it): the rows are split over
the data x expert ranks (Tutel's layout; ``world`` of them, this rank the
``rank``-th, ``group`` their process group) and replicated over
``tensor``, whose ranks compute the same rows on their slices of the
weights.  The JAX package keeps the batch on ``data`` alone and replicates
it over ``expert``; both compute the global batch (ROADMAP queue 3).  With
``grad_accum`` = G microbatches of m = B / G rows, row-rank r of W holds
the rows ``i * m + r * m / W + j`` (0 <= j < m / W) as its microbatch i,
so that every rank holds its share of every microbatch and microbatch i is
global rows ``i * m .. (i + 1) * m``, the JAX package's ``[G, B / G]``
reshape.  At G = 1 that is ``P('data')``'s contiguous block.  Per-row
random draws (``draw_rows``) are taken at the global microbatch's shape
and the rank keeps its block, so a W-rank step draws what one process at
the global batch draws; ``gather_rows`` puts the ranks' per-row vectors
back in the global order.  A token list that a module makes of k blocks of
this rank's rows (the CFG-doubled sampling batch: text half, then
unconditional half) is in the global order block-major (``token_rows``).
"""

from __future__ import annotations

import contextlib
import datetime
import os
import socket
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
EXPERT_AXIS = "expert"
TENSOR_AXIS = "tensor"
PIPE_AXIS = "pipe"
MESH_AXES = (DATA_AXIS, EXPERT_AXIS, TENSOR_AXIS)
ROW_AXES = (DATA_AXIS, EXPERT_AXIS)  # the axes the batch rows are split over
PIPELINE = "ROADMAP queue 1: multi-GPU: pipeline parallelism"
# a collective's limit: a rank may wait at a barrier while rank 0 writes a
# checkpoint or runs the evaluation hook
DEFAULT_TIMEOUT_S = 1800.0


@dataclass
class Comm:
    """A process group over some of the mesh's axes: ``size`` ranks, this
    one the ``rank``-th (in global rank order); ``group`` None is the
    default group, and a ``size`` of 1 runs no collective."""

    group: Any
    size: int
    rank: int


@dataclass
class DataMesh:
    """The mesh: ``world`` ranks hold the batch rows (data x expert), this
    process is row-rank ``rank`` and computes on ``device``; row
    collectives run over ``group`` (None: the default process group) with
    ``backend``.  ``axes`` (default ``{"data": world}``) the size of each
    axis of ``MESH_AXES``, ``coords`` this rank's coordinate on each, and
    ``comm(*axes)`` the process group that varies those axes with the
    others fixed."""

    world: int
    rank: int
    device: torch.device
    backend: str
    group: Any = None
    axes: Optional[Dict[str, int]] = None
    coords: Optional[Dict[str, int]] = None
    comms: Dict[tuple, Comm] = field(default_factory=dict)
    # the rows this rank holds in the current sampling call (``sampling``);
    # None in training, where a module's token list is one block of them
    sample_rows: Optional[int] = None
    global_rank: Optional[int] = None  # in the process group (default: rank)

    def __post_init__(self):
        if self.axes is None:
            self.axes = {DATA_AXIS: self.world}
            self.coords = {DATA_AXIS: self.rank}
        if self.global_rank is None:
            self.global_rank = self.rank

    @property
    def lead(self) -> bool:
        """Rank 0 of the process group: it writes and dispatches."""
        return self.global_rank == 0

    @property
    def shape(self) -> Dict[str, int]:
        return dict(self.axes)

    def size(self, axis: str) -> int:
        return self.axes.get(axis, 1)

    @property
    def model_sharded(self) -> bool:
        """True where the mesh shards weights (an expert or tensor axis)."""
        return self.size(EXPERT_AXIS) > 1 or self.size(TENSOR_AXIS) > 1

    def comm(self, *axes: str) -> Comm:
        """The process group over ``axes`` (those of size 1 dropped) that
        holds this rank."""
        key = tuple(a for a in MESH_AXES if a in axes and self.size(a) > 1)
        if not key:
            return Comm(None, 1, 0)
        if key not in self.comms:  # every axis of the mesh: the default group
            return Comm(None, int(np.prod([self.size(a) for a in key])), self.global_rank)
        return self.comms[key]

    @property
    def host_device(self) -> torch.device:
        """Where host data (pickled results) crosses: the card under NCCL,
        which moves device memory only; the host under gloo."""
        return self.device if self.backend == "nccl" else torch.device("cpu")

    def barrier(self) -> None:
        dist.barrier()


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


def mesh_shape(n: int, axes: Sequence[str]) -> tuple:
    """The JAX package's default factorization of ``n`` devices over
    ``axes``: up to 2 on each axis after the first, the rest on the first."""
    sizes, rem = [], n
    for _ in axes[1:]:
        s = 2 if rem % 2 == 0 and rem >= 2 else 1
        sizes.append(s)
        rem //= s
    return (rem,) + tuple(sizes)


def _comms(axes: Dict[str, int], coords_of) -> Dict[tuple, Comm]:
    """One process group per (set of axes, fixed other coordinates), made
    by every rank in one order (``dist.new_group`` is collective); this
    rank's group of each set."""
    import itertools

    live = [a for a in MESH_AXES if axes[a] > 1]
    world, me = dist.get_world_size(), dist.get_rank()
    out = {}
    for k in range(1, len(live)):
        for key in itertools.combinations(live, k):
            groups: Dict[tuple, list] = {}
            for g in range(world):
                c = coords_of(g)
                groups.setdefault(tuple(c[a] for a in live if a not in key), []).append(g)
            for ranks in groups.values():
                pg = dist.new_group(ranks)
                if me in ranks:
                    out[key] = Comm(pg, len(ranks), ranks.index(me))
    return out


def create_mesh(n_devices: Optional[int] = None, axes: Sequence[str] = (DATA_AXIS,),
                shape: Optional[Sequence[int]] = None, device=None) -> Optional[DataMesh]:
    """The mesh over the joined process group, one device a rank
    (``device``, default this rank's card), over ``axes`` of
    ``MESH_AXES`` (default ``data`` alone) and ``shape`` (default the JAX
    package's factorization, ``mesh_shape``).  Without a process group and
    at one device: None, the one-process path.  A ``pipe`` axis above 1
    raises (PIPELINE)."""
    axes = tuple(axes)
    unknown = [a for a in axes if a not in MESH_AXES + (PIPE_AXIS,)]
    if unknown or len(set(axes)) != len(axes):
        raise ValueError(f"mesh axes {axes}: each one of {MESH_AXES + (PIPE_AXIS,)}")
    if shape is not None and len(shape) != len(axes):
        raise ValueError(f"mesh shape {tuple(shape)} for axes {axes}")
    if shape is not None and PIPE_AXIS in axes and shape[axes.index(PIPE_AXIS)] > 1:
        raise NotImplementedError(f"a {PIPE_AXIS!r} mesh axis of "
                                  f"{shape[axes.index(PIPE_AXIS)]}: {PIPELINE}")
    if not dist.is_initialized():
        n = n_devices or (int(np.prod(shape)) if shape is not None else 1)
        if n > 1:
            raise RuntimeError(f"a mesh of {n} devices needs the process group: "
                               "init_distributed first (one process a rank)")
        return None
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_devices not in (None, world):
        raise ValueError(f"{n_devices} devices over {world} processes: one device a rank")
    shape = tuple(shape) if shape is not None else mesh_shape(world, axes)
    if PIPE_AXIS in axes and shape[axes.index(PIPE_AXIS)] > 1:
        raise NotImplementedError(f"a {PIPE_AXIS!r} mesh axis of "
                                  f"{shape[axes.index(PIPE_AXIS)]}: {PIPELINE}")
    if int(np.prod(shape)) != world:
        raise ValueError(f"a mesh of shape {shape} over {world} processes")
    sizes = {a: int(shape[axes.index(a)]) if a in axes else 1 for a in MESH_AXES}
    grid = np.arange(world).reshape([sizes[a] for a in MESH_AXES])

    def coords_of(g):
        return dict(zip(MESH_AXES, (int(i) for i in np.argwhere(grid == g)[0])))

    device = torch.device(device) if device is not None else local_device(rank)
    backend = dist.get_backend()
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError(f"NCCL moves CUDA tensors: a rank on {device} needs gloo")
        torch.cuda.set_device(device)
    coords = coords_of(rank)
    comms = _comms(sizes, coords_of)
    rows_world = sizes[DATA_AXIS] * sizes[EXPERT_AXIS]
    rows_rank = coords[DATA_AXIS] * sizes[EXPERT_AXIS] + coords[EXPERT_AXIS]
    key = tuple(a for a in ROW_AXES if sizes[a] > 1)
    rows_group = comms[key].group if key in comms else None
    shown = {a: sizes[a] for a in axes if a in MESH_AXES}
    return DataMesh(rows_world, rows_rank, device, backend, rows_group,
                    axes=shown, coords={a: coords[a] for a in shown}, comms=comms,
                    global_rank=rank)


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
    if mesh is None or mesh.world == 1:
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


def token_blocks(mesh: Optional[DataMesh], batch: int) -> int:
    """How many blocks of this rank's rows a module's batch of ``batch``
    rows is made of: the CFG-doubled sampling batch is 2, a training
    microbatch 1."""
    if mesh is None or not mesh.sample_rows:
        return 1
    if batch % mesh.sample_rows:
        raise ValueError(f"a batch of {batch} rows in blocks of {mesh.sample_rows}")
    return batch // mesh.sample_rows


def token_rows(mesh: Optional[DataMesh], n: int, blocks: int = 1, device=None) -> torch.Tensor:
    """The global positions [n] of this rank's ``n`` tokens (``blocks``
    blocks of its rows' tokens) in the global token list, which holds each
    block's tokens of every row-rank in rank order, block after block."""
    if mesh is None or mesh.world == 1:
        return torch.arange(n, device=device)
    per = n // blocks
    return (torch.arange(blocks, device=device)[:, None] * (mesh.world * per)
            + mesh.rank * per + torch.arange(per, device=device)[None, :]).reshape(-1)


def gather_tokens(mesh: Optional[DataMesh], x: torch.Tensor, blocks: int = 1) -> torch.Tensor:
    """The row-ranks' tokens ``x`` [n, ...] as the global token list
    [W * n, ...] (``token_rows``' order); differentiable."""
    if mesh is None or mesh.world == 1:
        return x
    from ..utils.dist_utils import all_gather_rows

    full = all_gather_rows(x.contiguous(), mesh)                     # rank-major
    if blocks == 1:
        return full
    rest = tuple(x.shape[1:])
    return (full.reshape((mesh.world, blocks, x.shape[0] // blocks) + rest)
            .transpose(0, 1).reshape((-1,) + rest))


@contextlib.contextmanager
def sampling(module: torch.nn.Module, mesh: Optional[DataMesh], rows: int):
    """Within the block the modules of ``module`` compute over ``mesh``
    (``attach_mesh``), this rank holding ``rows`` rows of a sampling call's
    global batch; the modules' previous meshes are put back on exit."""
    before = [(m, m.mesh) for m in module.modules() if hasattr(type(m), "mesh")]
    attach_mesh(module, mesh)
    if mesh is not None:
        mesh.sample_rows = rows
    try:
        yield
    finally:
        if mesh is not None:
            mesh.sample_rows = None
        for m, prev in before:
            m.mesh = prev


def broadcast_module(module: torch.nn.Module, mesh: Optional[DataMesh]) -> None:
    """Every rank takes rank 0's parameters and buffers."""
    if mesh is None:
        return
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, src=0)


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
