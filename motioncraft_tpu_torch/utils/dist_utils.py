"""Collectives of data-parallel training and evaluation (PyTorch port of
motioncraft_tpu/utils/dist_utils.py) over a ``parallel.mesh.DataMesh``.

- ``mean_across_hosts``: the logged scalars' mean over the ranks.
- ``all_reduce_sum`` / ``all_gather_rows``: differentiable collectives for
  use inside the forward.  A rank's loss is the global one, built from
  global sums: the backward of ``all_reduce_sum`` sums the ranks' incoming
  gradients, which gives each rank W times its share of the gradient, and
  ``allreduce_grads``'s mean over the W ranks takes the factor out.
- ``tp_copy`` / ``tp_reduce``: Megatron's f and g over the tensor group
  (identity forward and a summed backward; a summed forward and the
  identity backward), around a column-parallel first product and a
  row-parallel second one; ``all_to_all``: the expert group's exchange
  of slot buffers, its own adjoint.
- ``allreduce_grads``: each trainable gradient's sum over the ranks that
  hold the same shard of its parameter (``parallel/tp.py``), over the
  normalizer that makes it the one-process gradient.  The pipe ranks of a
  replicated leaf each hold their stage's share of its gradient, so their
  sum is the gradient; a stage's layers are summed over ``data`` alone.
- ``collect_results``: the per-rank result lists back in dataset order
  (pickle, all-gather the lengths, pad, all-gather the bytes, unpickle,
  zip-merge), the reference's ``collect_results_gpu``.

Every collective here counts its calls and bytes in ``TRAFFIC`` by kind
("all_reduce", "all_to_all", "all_gather"), which the caller resets and
reads (``traffic``).  Their wall time is taken only once a caller turns
timing on (``traffic(timing=True)``): it synchronizes the card on either
side of every collective, which the training and serving paths do not.
"""

from __future__ import annotations

import itertools
import pickle
import time
from typing import Any, Dict, Iterable, List, Optional

import torch
import torch.distributed as dist


TRAFFIC: Dict[str, Dict[str, float]] = {}
_TIMING = [False]


def traffic(reset: bool = False, timing: Optional[bool] = None) -> Dict[str, Dict[str, float]]:
    """{kind: {"calls", "bytes", "ms"}} of the collectives since the last
    reset (bytes: what this rank hands the collective; ms: host wall time,
    the device synchronized on either side, 0 while timing is off).
    ``timing`` turns the timing of later collectives on or off."""
    out = {k: dict(v) for k, v in TRAFFIC.items()}
    if reset:
        TRAFFIC.clear()
    if timing is not None:
        _TIMING[0] = bool(timing)
    return out


def _timed(kind: str, t: torch.Tensor, fn):
    rec = TRAFFIC.setdefault(kind, {"calls": 0, "bytes": 0, "ms": 0.0})
    rec["calls"] += 1
    rec["bytes"] += t.numel() * t.element_size()
    if not _TIMING[0]:
        return fn()
    sync = t.is_cuda
    if sync:
        torch.cuda.synchronize(t.device)
    t0 = time.perf_counter()
    out = fn()
    if sync:
        torch.cuda.synchronize(t.device)
    rec["ms"] += (time.perf_counter() - t0) * 1e3
    return out


def _all_reduce(x: torch.Tensor, group, op=None) -> torch.Tensor:
    op = dist.ReduceOp.SUM if op is None else op
    _timed("all_reduce", x, lambda: dist.all_reduce(x, op=op, group=group))
    return x


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x.clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad.clone(), ctx.group), None


class _AllGatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, world, rank):
        ctx.group, ctx.rank, ctx.n = group, rank, x.shape[0]
        parts = [torch.empty_like(x) for _ in range(world)]
        _timed("all_gather", x, lambda: dist.all_gather(parts, x.contiguous(), group=group))
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, grad):
        grad = _all_reduce(grad.contiguous().clone(), ctx.group)
        return grad[ctx.rank * ctx.n:(ctx.rank + 1) * ctx.n], None, None, None


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad.contiguous().clone(), ctx.group), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def _exchange(x: torch.Tensor, group, host: torch.device) -> torch.Tensor:
    """all_to_all_single of equal chunks along dim 0; under gloo through
    the host (``host``), where its all-to-all runs."""
    src = x.contiguous().to(host)
    out = torch.empty_like(src)
    _timed("all_to_all", src, lambda: dist.all_to_all_single(out, src, group=group))
    return out.to(x.device)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, host):
        ctx.group, ctx.host = group, host
        return _exchange(x, group, host)

    @staticmethod
    def backward(ctx, grad):
        return _exchange(grad, ctx.group, ctx.host), None, None


def all_reduce_sum(x: torch.Tensor, mesh) -> torch.Tensor:
    """The sum of ``x`` over the row-ranks, on every rank; differentiable
    (the backward sums the ranks' gradients).  ``x`` itself without a
    mesh."""
    return x if mesh is None or mesh.world == 1 else _AllReduceSum.apply(x, mesh.group)


def all_gather_rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """The row-ranks' ``x`` [n, ...] stacked by rank [W * n, ...];
    differentiable (a rank's rows get the sum of the ranks' gradients of
    them)."""
    if mesh is None or mesh.world == 1:
        return x
    return _AllGatherRows.apply(x, mesh.group, mesh.world, mesh.rank)


def tp_copy(x: torch.Tensor, comm) -> torch.Tensor:
    """Megatron's f: ``x`` as it is, its gradient summed over ``comm``."""
    return x if comm is None or comm.size == 1 else _Copy.apply(x, comm.group)


def tp_reduce(x: torch.Tensor, comm) -> torch.Tensor:
    """Megatron's g: the sum of ``x`` over ``comm``, the identity's
    gradient."""
    return x if comm is None or comm.size == 1 else _Reduce.apply(x, comm.group)


def all_to_all(x: torch.Tensor, mesh, comm) -> torch.Tensor:
    """Chunk i of ``x`` (dim 0 in ``comm.size`` equal chunks) to the
    ``i``-th rank of ``comm``, whose chunks arrive in rank order;
    differentiable (the backward is the same exchange)."""
    if comm.size == 1:
        return x
    return _AllToAll.apply(x, comm.group, mesh.host_device)


def allreduce_grads(params: Iterable[torch.nn.Parameter], mesh, shards=None) -> None:
    """Replace each parameter's ``.grad`` by the one-process gradient of the
    global batch: the sum over the ranks that hold the same shard of it
    (``shards``: {parameter: its sharded axes}, parallel/tp.py; the others
    replicated), divided by the row-ranks (each rank's loss is the global
    one, whose row sums' backward hands it W times its rows' share) and
    by the tensor ranks that add the same replicated gradient.  One flat
    buffer for each such group.  A parameter that has a gradient on any
    rank takes part (as zeros where a rank has none); one that has none
    anywhere keeps none, as one process leaves it."""
    if mesh is None:
        return
    params = list(params)
    if not params or mesh.world * mesh.size("tensor") * mesh.size("pipe") == 1:
        return
    shards = shards or {}
    # position i holds a stage's layer on every pipe rank (stages hold equal layers)
    has = torch.tensor([float(p.grad is not None) for p in params], device=mesh.device)
    _all_reduce(has, None, dist.ReduceOp.MAX)
    buckets: Dict[tuple, list] = {}
    for p, h in zip(params, has.tolist()):
        if h:
            axes = tuple(a for a in ("data", "expert", "tensor", "pipe")
                         if a not in shards.get(p, ()))
            buckets.setdefault(axes, []).append(p)
    for axes, live in buckets.items():
        norm = mesh.world * (mesh.size("tensor") if "tensor" in axes else 1)
        comm = mesh.comm(*axes)
        flat = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1)
                          for p in live])
        if comm.size > 1:
            _all_reduce(flat, comm.group)
        flat.div_(norm)
        offset = 0
        for p in live:
            n = p.numel()
            p.grad = flat[offset:offset + n].view_as(p)
            offset += n


def mean_across_hosts(tree: Dict[str, torch.Tensor], mesh) -> Dict[str, torch.Tensor]:
    """The mean over the ranks of each scalar of ``tree``, in one collective."""
    if mesh is None or not tree:
        return tree
    keys = sorted(tree)
    v = torch.stack([torch.as_tensor(tree[k], dtype=torch.float32, device=mesh.device)
                     .detach().reshape(()) for k in keys])
    if mesh.world > 1:
        _all_reduce(v, mesh.group)
    v = v / mesh.world
    return {k: v[i] for i, k in enumerate(keys)}


_MISSING = object()


def interleave_parts(part_list: List[List[Any]], total_size: Optional[int] = None) -> List[Any]:
    """zip-merge per-rank result lists back into sampler order and drop the
    round-up padding (the reference's ``for res in zip(*part_list)``),
    with zip_longest so that unequal part lengths (round_up=False) merge."""
    merged: List[Any] = []
    for tup in itertools.zip_longest(*part_list, fillvalue=_MISSING):
        merged.extend(r for r in tup if r is not _MISSING)
    return merged if total_size is None else merged[:total_size]


def collect_results(local_results: List[Any], total_size: Optional[int] = None,
                    mesh=None) -> List[Any]:
    """Every rank's results in dataset order, on every rank.  Rank r
    evaluated the interleaved slice ``indices[r::W]`` (RoundUpSampler), so
    the whole list is the zip-interleave of the parts, cut to
    ``total_size``.  The parts cross as pickled bytes that this program's
    ranks wrote."""
    if mesh is None or mesh.world == 1:
        return local_results if total_size is None else local_results[:total_size]
    dev = mesh.host_device
    buf = torch.frombuffer(bytearray(pickle.dumps(local_results)), dtype=torch.uint8)
    size = torch.tensor([buf.numel()], dtype=torch.int64, device=dev)
    sizes = [torch.empty_like(size) for _ in range(mesh.world)]
    dist.all_gather(sizes, size, group=mesh.group)
    sizes = [int(s) for s in sizes]
    padded = torch.zeros(max(sizes), dtype=torch.uint8, device=dev)
    padded[:buf.numel()] = buf.to(dev)
    parts = [torch.empty_like(padded) for _ in range(mesh.world)]
    dist.all_gather(parts, padded, group=mesh.group)
    part_list = [pickle.loads(p[:n].cpu().numpy().tobytes()) for p, n in zip(parts, sizes)]
    return interleave_parts(part_list, total_size)
