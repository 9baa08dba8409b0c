"""Pipeline parallelism: a GPipe microbatch schedule over a ``pipe`` mesh
axis (PyTorch port of motioncraft_tpu/parallel/pp.py).

The JAX package stores a pipelined decoder stack stacked (``stacked_blocks``,
a leading [num_layers] axis sharded over ``pipe``) and runs ``gpipe`` under
``shard_map``: each of S stages holds num_layers / S contiguous layers, the
local batch (the data shard) is cut into M microbatches, M + S - 1 ticks run
them through, activations move stage to stage by ``ppermute``, the last
stage's output is ``psum``-broadcast over the pipe ring, and the aux losses
are the mean over microbatches of the per-microbatch layer sums, summed over
the stages and averaged over ``data``.

The port runs one process a stage.  A stage holds its own layers only (the
model's ``pipeline_stage_``, called by ``parallel/tp.py:shard_module_``), so
their parameters, gradients and optimizer moments live on that rank alone.
``gpipe`` runs the same schedule with point-to-point messages: a stage
receives a microbatch's activations from the one before it (``_Recv``, whose
backward sends the activations' gradient back), runs its layers and sends the
result on (``_Send``, whose backward receives the gradient).  All forwards
run first, then all backwards (GPipe, no 1F1B), and the backward runs one
microbatch at a time in a fixed order (the last microbatch first, as JAX's
backward scan runs the ticks) inside one autograd function, so every stage
posts its sends and receives in the order its neighbours post theirs:
NCCL matches point-to-point calls by order, not by tag.  The consts (text
features, time embedding, mask, cond_type, motion lengths) are computed on
every stage (they are replicated over ``pipe``) and ride along with each
microbatch; their gradients, summed over the microbatches in f32, are
summed over the stages onto stage 0, which alone runs the backward of the
layers that made them, as it alone has the stack input's gradient.  Under
gloo a message crosses through the host (``DataMesh.host_device``), as PR
19's all-to-all does.

MoE routing: each (data shard, microbatch) routes on its own, with its own
capacity and drops, as in the JAX package's ``shard_map`` body (and the
reference's per-rank Tutel).  One process with a pipelined config and no
pipe axis applies the layers per microbatch in sequence: what JAX computes
at S = 1, and what S stages compute on the same microbatches.

``stack_block_params`` / ``unstack_block_params`` convert the JAX package's
numpy flax trees between the per-layer ``block_{i}`` layout and the stacked
one; ``stack_state_dict`` / ``unstack_state_dict`` do the same on the port's
state_dict names.
"""

from __future__ import annotations

import hashlib
import re
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .mesh import PIPE_AXIS

STACKED = "stacked_blocks"
_BLOCK = re.compile(r"^block_(\d+)\.(.*)$")


def stage_layers(num_layers: int, stages: int, stage: int) -> range:
    """The global ids of the layers stage ``stage`` of ``stages`` holds:
    num_layers / stages contiguous ones."""
    if num_layers % stages:
        raise ValueError(f"{num_layers} layers not divisible by {stages} pipeline stages")
    n = num_layers // stages
    return range(stage * n, (stage + 1) * n)


class Pipe:
    """The pipe group of this rank as gpipe uses it: ``stages`` S, this
    rank's ``stage``, the global ranks of its neighbours, where messages
    cross (``host``: the host under gloo) and the group."""

    def __init__(self, mesh):
        comm = mesh.comm(PIPE_AXIS)
        self.group, self.stages, self.stage = comm.group, comm.size, comm.rank
        self.ranks, self.host = comm.ranks, mesh.host_device
        self.comm = comm

    @property
    def last(self) -> bool:
        return self.stage == self.stages - 1

    def send(self, t: torch.Tensor, stage: int) -> None:
        from ..utils.dist_utils import _timed

        src = t.detach().to(self.host).contiguous()
        _timed("send", src, lambda: dist.send(src, dst=self.ranks[stage], group=self.group))

    def recv(self, like: torch.Tensor, stage: int) -> torch.Tensor:
        buf = torch.empty(like.shape, dtype=like.dtype, device=self.host)
        dist.recv(buf, src=self.ranks[stage], group=self.group)
        return buf.to(like.device)

    def reduce_first(self, t: torch.Tensor) -> Optional[torch.Tensor]:
        """The sum of every stage's ``t`` on stage 0; None on the others."""
        from ..utils.dist_utils import _timed

        buf = t.detach().to(self.host).contiguous()
        _timed("reduce", buf, lambda: dist.reduce(buf, dst=self.ranks[0], group=self.group))
        return buf.to(t.device) if self.stage == 0 else None

    def broadcast_last(self, t: Optional[torch.Tensor], like: torch.Tensor) -> torch.Tensor:
        """The last stage's ``t`` on every stage (``like``: its shape and
        dtype elsewhere)."""
        from ..utils.dist_utils import _timed

        buf = (t.detach().to(self.host).contiguous() if self.last
               else torch.empty(like.shape, dtype=like.dtype, device=self.host))
        _timed("broadcast", buf, lambda: dist.broadcast(buf, src=self.ranks[-1],
                                                        group=self.group))
        return buf.to(like.device)


class _Recv(torch.autograd.Function):
    """A microbatch's activations from the stage before; the backward sends
    their gradient back to it."""

    @staticmethod
    def forward(ctx, anchor, like, pipe):
        ctx.pipe = pipe
        return pipe.recv(like, pipe.stage - 1)

    @staticmethod
    def backward(ctx, grad):
        ctx.pipe.send(grad, ctx.pipe.stage - 1)
        return None, None, None


class _Send(torch.autograd.Function):
    """Sends a microbatch's activations to the next stage and returns a
    scalar for the backward to start from, whose backward receives their
    gradient from that stage."""

    @staticmethod
    def forward(ctx, y, pipe):
        ctx.pipe, ctx.like = pipe, y.detach()
        pipe.send(y, pipe.stage + 1)
        return y.new_zeros(())

    @staticmethod
    def backward(ctx, grad):
        return ctx.pipe.recv(ctx.like, ctx.pipe.stage + 1), None


def _schedule(stage_fn, pipe: Optional[Pipe], x, consts, M: int, graph: bool):
    """The forward ticks on this stage: per microbatch its input (stage 0:
    ``x``'s rows; else received), the stage's layers, the send on; returns
    the stack output on every stage, the per-microbatch records (input
    anchor, backward root, aux) and the aux names."""
    S = 1 if pipe is None else pipe.stages
    stage = 0 if pipe is None else pipe.stage
    B = x.shape[0]
    if B % M:
        raise ValueError(f"local batch {B} not divisible by {M} microbatches")
    mb = B // M
    outs, records, names = [], [], None
    for k in range(M):
        rows = slice(k * mb, (k + 1) * mb)
        anchor = None
        with torch.set_grad_enabled(graph):
            cin = tuple(None if c is None else c[rows] for c in consts)
            if stage == 0:
                xin = x[rows]
            elif graph:
                anchor = x.new_zeros(0).requires_grad_()
                xin = _Recv.apply(anchor, x[rows].detach(), pipe)
            else:
                xin = pipe.recv(x[rows], stage - 1)
            y, aux = stage_fn(xin, cin, k)
            names = sorted(aux) if names is None else names
            root = y
            if stage < S - 1:
                root = _Send.apply(y, pipe) if graph else pipe.send(y, stage + 1)
            else:
                outs.append(y.detach())
        records.append((anchor, root, [aux[n] for n in names]))
    out = torch.cat(outs) if stage == S - 1 else None
    if S > 1:
        out = pipe.broadcast_last(out, x)
    return out, records, names


class _GPipe(torch.autograd.Function):
    """The whole schedule as one autograd node, so that its backward (all
    the microbatches', the last first) runs once and in one order on every
    stage.  Inputs: ``x``, the consts, the parameters the layers read;
    outputs: the stack output and the aux means (their names in
    ``run["names"]``)."""

    @staticmethod
    def forward(ctx, run, x, *tensors):
        n_c = run["n_consts"]
        consts = [None if c is None else
                  c.detach().requires_grad_(c.requires_grad and c.is_floating_point())
                  for c in tensors[:n_c]]
        x_in = x.detach().requires_grad_(x.requires_grad)
        out, records, names = _schedule(run["fn"], run["pipe"], x_in, consts, run["M"], True)
        ctx.run, ctx.records, ctx.x, ctx.consts = run, records, x_in, consts
        ctx.params = tensors[n_c:]
        run["names"] = names
        M = run["M"]
        aux = [sum(r[2][i].detach().float() for r in records) / M for i in range(len(names))]
        return (out, *aux)

    @staticmethod
    def backward(ctx, grad_out, *grad_aux):
        run, pipe, M = ctx.run, ctx.run["pipe"], ctx.run["M"]
        last = pipe is None or pipe.last
        mb = ctx.x.shape[0] // M
        inputs = [t for t in (ctx.x, *ctx.consts, *ctx.params)
                  if t is not None and t.requires_grad]
        acc: List[Optional[torch.Tensor]] = [None] * len(inputs)
        for k in reversed(range(M)):
            anchor, root, aux = ctx.records[k]
            outputs = [root]
            grads = [grad_out[k * mb:(k + 1) * mb] if last else torch.ones_like(root)]
            for a, g in zip(aux, grad_aux):
                if g is not None and a.requires_grad:
                    outputs.append(a)
                    grads.append((g / M).to(a.dtype))
            want = inputs + ([anchor] if anchor is not None else [])
            got = torch.autograd.grad(outputs, want, grads, allow_unused=True)
            for i, g in enumerate(got[:len(inputs)]):
                if g is not None:  # summed over the microbatches in f32
                    acc[i] = g.float() if acc[i] is None else acc[i] + g.float()
        ctx.records = None
        if pipe is not None:
            # the consts' gradients summed on stage 0, whose backward alone
            # runs the layers that made them (text encoder, time MLP)
            for i, t in enumerate(inputs):
                if any(t is c for c in ctx.consts):
                    acc[i] = pipe.reduce_first(torch.zeros(t.shape, device=t.device)
                                               if acc[i] is None else acc[i])
        it = iter(None if a is None else a.to(t.dtype) for a, t in zip(acc, inputs))
        result = [None]
        for t in (ctx.x, *ctx.consts, *ctx.params):
            result.append(next(it) if t is not None and t.requires_grad else None)
        return tuple(result)


def gpipe(stage_fn: Callable, params: Sequence[torch.Tensor], x: torch.Tensor,
          consts: Sequence[Optional[torch.Tensor]], *, n_microbatch: int,
          mesh=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Run this stage's layers as a GPipe pipeline over ``mesh``'s ``pipe``
    axis (one stage without one).

    Args:
      stage_fn: ``(x_mb, consts_mb, k) -> (y_mb, aux)``: this stage's
        layers on microbatch ``k``; ``y_mb`` has ``x_mb``'s shape and
        dtype, ``aux`` is a dict of scalars (the stage's layer sums for the
        microbatch; the same names on every stage).
      params: the tensors ``stage_fn`` reads and trains (the stage's
        parameters as its layers read them).
      x: ``[B, ...]`` the stack's input on this rank (stage 0 reads it; the
        others its shape and dtype).
      consts: ``[B, ...]`` tensors (or None) that ride along with each
        microbatch.
      n_microbatch: M; B must be divisible by it.

    Returns ``(out, aux)``: ``out`` [B, ...] the last stage's output on
    every stage (its gradient is read on the last stage; the caller keeps
    the replicated weights after the stack from taking gradients on the
    others), ``aux`` {name: the mean over microbatches of the microbatch
    sums, summed over the stages} (the sum's gradient the identity; the
    caller averages over ``data``).  Differentiable where grad mode is on
    and any input requires grad."""
    from ..utils.dist_utils import tp_reduce

    pipe = Pipe(mesh) if mesh is not None and mesh.size(PIPE_AXIS) > 1 else None
    M = int(n_microbatch)
    consts = tuple(consts)
    graph = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (x, *consts, *params))
    if not graph:
        out, records, names = _schedule(stage_fn, pipe, x, consts, M, False)
        aux = [sum(r[2][i].float() for r in records) / M for i in range(len(names))]
    else:
        run = {"fn": stage_fn, "pipe": pipe, "M": M, "n_consts": len(consts)}
        out, *aux = _GPipe.apply(run, x, *consts, *params)
        names = run["names"]
    comm = None if pipe is None else pipe.comm
    return out, {n: tp_reduce(a, comm) for n, a in zip(names, aux)}


def fold_generator(generator: torch.Generator, layer: int, row: int) -> torch.Generator:
    """A generator on ``generator``'s device seeded from its state, the
    global ``layer`` id and a microbatch's first global ``row``: the gate
    noise stream of one (layer, microbatch), as the JAX package folds its
    key by the stacked layer index and rows[0].  The state is read on the
    host (no device sync) and not advanced."""
    h = hashlib.blake2b(generator.get_state().numpy().tobytes(), digest_size=8)
    h.update(np.asarray([layer, row], np.int64).tobytes())
    seed = int.from_bytes(h.digest(), "little") & ((1 << 63) - 1)
    return torch.Generator(device=generator.device).manual_seed(seed)


def stack_block_params(params: dict, num_layers: int, *, prefix: str = "block_",
                       stacked_name: str = STACKED) -> dict:
    """Per-layer ``block_{i}`` subtrees of a numpy flax tree -> one
    ``stacked_blocks`` subtree with a leading [num_layers] axis (the layout
    a ``pipeline_axis`` model stores in the JAX package).  Other entries
    pass through."""
    params = dict(params)
    blocks = []
    for i in range(num_layers):
        key = f"{prefix}{i}"
        if key not in params:
            raise KeyError(f"missing per-layer params '{key}' (have: {sorted(params)})")
        blocks.append(params.pop(key))

    def stack(nodes):
        if isinstance(nodes[0], dict):
            return {k: stack([n[k] for n in nodes]) for k in nodes[0]}
        return np.stack([np.asarray(n) for n in nodes])

    params[stacked_name] = stack(blocks)
    return params


def unstack_block_params(params: dict, *, prefix: str = "block_",
                         stacked_name: str = STACKED) -> dict:
    """The inverse of ``stack_block_params``: the stacked subtree split into
    per-layer ``block_{i}`` entries (the plain model's layout)."""
    params = dict(params)
    stacked = params.pop(stacked_name)

    def first(node):
        return first(next(iter(node.values()))) if isinstance(node, dict) else node

    def take(node, i):
        return ({k: take(v, i) for k, v in node.items()} if isinstance(node, dict)
                else np.asarray(node)[i])

    for i in range(np.asarray(first(stacked)).shape[0]):
        params[f"{prefix}{i}"] = take(stacked, i)
    return params


def stack_state_dict(sd: Dict[str, Any], num_layers: int) -> Dict[str, Any]:
    """The port's per-layer ``block_{i}.<name>`` entries -> ``stacked_blocks.
    <name>`` with a leading [num_layers] dim; other entries pass through."""
    out, layers = {}, {}
    for k, v in sd.items():
        m = _BLOCK.match(k)
        if m is None:
            out[k] = v
        else:
            layers.setdefault(m.group(2), {})[int(m.group(1))] = v
    for name, by_layer in layers.items():
        if sorted(by_layer) != list(range(num_layers)):
            raise KeyError(f"{name}: layers {sorted(by_layer)} of {num_layers}")
        out[f"{STACKED}.{name}"] = torch.stack([torch.as_tensor(by_layer[i])
                                                for i in range(num_layers)])
    return out


def unstack_state_dict(sd: Dict[str, Any], first: int = 0) -> Dict[str, Any]:
    """The inverse of ``stack_state_dict``: ``stacked_blocks.<name>`` [n, ...]
    -> ``block_{first + i}.<name>``."""
    out = {}
    for k, v in sd.items():
        if k.startswith(STACKED + "."):
            name = k[len(STACKED) + 1:]
            for i in range(v.shape[0]):
                out[f"block_{first + i}.{name}"] = v[i]
        else:
            out[k] = v
    return out


def is_stage_key(name: str) -> bool:
    """True for a state_dict entry of a decoder layer (``block_{i}.``)."""
    return _BLOCK.match(name) is not None


def gather_stages(local: Dict[str, Any], mesh) -> Optional[Dict[str, Any]]:
    """Every stage's ``local`` ({name: value} of its own layers' entries,
    on the CPU) merged, on stage 0 of this rank's pipe group (global rank 0
    among them); None on the other stages.  Every rank calls it."""
    comm = mesh.comm(PIPE_AXIS)
    if comm.size == 1:
        return dict(local)
    parts = [None] * comm.size if comm.rank == 0 else None
    dist.gather_object(local, parts, dst=comm.ranks[0], group=comm.group)
    if comm.rank != 0:
        return None
    merged: Dict[str, Any] = {}
    for p in parts:
        merged.update(p)
    return merged


def one_process_names(names: Sequence[str], num_layers: int) -> List[str]:
    """The one-process order of a stage's parameter ``names`` (its own
    layers' after the replicated ones): the replicated names, then every
    layer's names in layer order, as the whole model lists them."""
    rest = [n for n in names if not is_stage_key(n)]
    own = [n for n in names if is_stage_key(n)]
    if names[len(rest):] != own:
        raise ValueError("a stage's layers must follow its other parameters")
    first = int(_BLOCK.match(own[0]).group(1)) if own else 0
    template = [_BLOCK.match(n).group(2) for n in own if int(_BLOCK.match(n).group(1)) == first]
    return rest + [f"block_{i}.{t}" for i in range(num_layers) for t in template]
