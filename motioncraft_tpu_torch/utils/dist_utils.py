"""Collectives of data-parallel training and evaluation (PyTorch port of
motioncraft_tpu/utils/dist_utils.py) over a ``parallel.mesh.DataMesh``.

- ``allreduce_grads``: the trainable gradients in one flat buffer, their
  mean over the ranks (the reference's coalesced ``allreduce_grads``; XLA
  emits it from the batch sharding in the JAX package).
- ``mean_across_hosts``: the logged scalars' mean over the ranks.
- ``all_reduce_sum`` / ``all_gather_rows``: differentiable collectives for
  use inside the forward.  A rank's loss is the global one, built from
  global sums: the backward of ``all_reduce_sum`` sums the ranks' incoming
  gradients, which gives each rank W times its share of the gradient, and
  ``allreduce_grads``'s mean over the W ranks takes the factor out.
- ``collect_results``: the per-rank result lists back in dataset order
  (pickle, all-gather the lengths, pad, all-gather the bytes, unpickle,
  zip-merge), the reference's ``collect_results_gpu``.
"""

from __future__ import annotations

import itertools
import pickle
from typing import Any, Dict, Iterable, List, Optional

import torch
import torch.distributed as dist


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _AllGatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, world, rank):
        ctx.group, ctx.rank, ctx.n = group, rank, x.shape[0]
        parts = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad[ctx.rank * ctx.n:(ctx.rank + 1) * ctx.n], None, None, None


def all_reduce_sum(x: torch.Tensor, mesh) -> torch.Tensor:
    """The sum of ``x`` over the ranks, on every rank; differentiable (the
    backward sums the ranks' gradients).  ``x`` itself without a mesh."""
    return x if mesh is None else _AllReduceSum.apply(x, mesh.group)


def all_gather_rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """The ranks' ``x`` [n, ...] stacked by rank [W * n, ...]; differentiable
    (a rank's rows get the sum of the ranks' gradients of them)."""
    if mesh is None:
        return x
    return _AllGatherRows.apply(x, mesh.group, mesh.world, mesh.rank)


def allreduce_grads(params: Iterable[torch.nn.Parameter], mesh) -> None:
    """Replace each parameter's ``.grad`` by its mean over the ranks, in one
    flat buffer.  A parameter that has a gradient on any rank takes part
    (as zeros where a rank has none); one that has none anywhere keeps
    none, as one process leaves it."""
    if mesh is None:
        return
    params = list(params)
    if not params:
        return
    has = torch.tensor([float(p.grad is not None) for p in params], device=mesh.device)
    dist.all_reduce(has, op=dist.ReduceOp.MAX, group=mesh.group)
    live = [p for p, h in zip(params, has.tolist()) if h]
    if not live:
        return
    flat = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1)
                      for p in live])
    dist.all_reduce(flat, group=mesh.group)
    flat.div_(mesh.world)
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
    dist.all_reduce(v, group=mesh.group)
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
