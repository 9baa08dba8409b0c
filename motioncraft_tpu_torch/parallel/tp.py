"""Tensor- and expert-parallel weight layout (PyTorch port of the sharding
rules of motioncraft_tpu/parallel/tp.py).

The rules are the JAX package's, keyed on the flax path and shape that
each parameter of the port's ``state_dict`` maps to (utils/convert.py):

- the MoE expert FFNs: ``expert_w1`` [E, d, f] over (expert, -, tensor),
  ``expert_b1`` [E, f] (expert, tensor), ``expert_w2`` [E, f, d]
  (expert, tensor, -), ``expert_b2`` [E, d] (expert, -);
- the SFFN stacks: ``w1`` [H, d, f] and ``b1`` [H, f] column-parallel,
  ``w2`` [H, f, d] row-parallel, ``b2`` replicated (it adds after the sum);
- the text encoder's and the baselines' FFN ``linear1`` and CLIP's
  ``mlp_fc`` column-parallel (kernel and bias), ``linear2`` (the plain
  FFN's ``linear2/linear``) and ``mlp_proj`` row-parallel (kernel only);
- CLIP's ``token_embedding`` rows over tensor.

A dim that its axis does not divide, or an axis of size 1 or absent, is
replicated.  ``leaf_spec`` gives the flax-layout spec (the JAX package's
``PartitionSpec`` as a tuple: ``()`` replicated), ``torch_spec`` the same
on the port's tensor (a Linear's weight is the flax kernel transposed).

Where the JAX package lets GSPMD insert the collectives, the port's
modules run them (Megatron's f / g, ``utils/dist_utils.py``) wherever
``shard_module_`` has sliced their weights: each rank keeps its shard, and
``Sharding`` records which dims of which parameter are split over which
axis, for the gradient reduction, the clip, the optimizers' per-leaf
statistics and the checkpoint's gather.

A ``pipe`` axis (parallel/pp.py) is a shard of another kind: a stage holds
whole leaves of its own layers (the JAX package's stacked leaves, their
layer axis split over ``pipe``, as ``leaf_spec`` says) and none of the
others'.  Their gradients are reduced over ``data`` alone, the clip's norm
sums each stage's layers once and the replicated leaves once, their
optimizer statistics are whole on their stage, and the checkpoint gathers
the stages' layers on global rank 0 in the one-process layout.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

from ..utils.convert import flax_leaf
from .mesh import EXPERT_AXIS, PIPE_AXIS, TENSOR_AXIS

_EP = "__expert__"
_TP = "__tensor__"
Spec = Tuple[Optional[str], ...]


def _tp_rule(names: Sequence[str], shape: Tuple[int, ...]) -> Optional[tuple]:
    """The raw spec of one leaf (flax path names, flax shape), or None to
    replicate; the JAX package's rule word for word."""
    if not names:
        return None
    leaf = names[-1]
    parent = names[-2] if len(names) >= 2 else ""
    if leaf == "expert_w1" and len(shape) == 3:
        return (_EP, None, _TP)
    if leaf == "expert_b1" and len(shape) == 2:
        return (_EP, _TP)
    if leaf == "expert_w2" and len(shape) == 3:
        return (_EP, _TP, None)
    if leaf == "expert_b2" and len(shape) == 2:
        return (_EP, None)
    if leaf == "w1" and len(shape) == 3:
        return (None, None, _TP)
    if leaf == "b1" and len(shape) == 2:
        return (None, _TP)
    if leaf == "w2" and len(shape) == 3:
        return (None, _TP, None)
    if parent in ("linear1", "mlp_fc"):
        if leaf == "kernel" and len(shape) == 2:
            return (None, _TP)
        if leaf == "bias" and len(shape) == 1:
            return (_TP,)
    grandparent = names[-3] if len(names) >= 3 else ""
    if (parent in ("linear2", "mlp_proj")
            or (grandparent == "linear2" and parent == "linear")):
        if leaf == "kernel" and len(shape) == 2:
            return (_TP, None)
    if parent == "token_embedding" and leaf == "embedding" and len(shape) == 2:
        return (_TP, None)
    return None


def _resolve(raw: Optional[tuple], shape: Tuple[int, ...], axes: Dict[str, int],
             expert_axis: Optional[str], tensor_axis: Optional[str]) -> Spec:
    if raw is None:
        return ()
    out = []
    for i, tok in enumerate(raw):
        axis = {_EP: expert_axis, _TP: tensor_axis, None: None}[tok]
        if (axis is None or axes.get(axis, 1) <= 1 or i >= len(shape)
                or shape[i] % axes[axis] != 0):
            out.append(None)
        else:
            out.append(axis)
    return tuple(out)


def leaf_spec(names: Sequence[str], shape: Sequence[int], axes: Dict[str, int], *,
              expert_axis: Optional[str] = EXPERT_AXIS,
              tensor_axis: Optional[str] = TENSOR_AXIS,
              pipe_axis: Optional[str] = PIPE_AXIS) -> Spec:
    """The flax-layout spec of a leaf at flax path ``names`` of flax
    ``shape`` on a mesh of ``axes`` sizes: one axis name or None a dim,
    ``()`` for a replicated leaf (the JAX package's ``leaf_spec``).  A
    pipeline's stacked leaf (under ``stacked_blocks``) splits its layer
    axis over ``pipe`` where that divides it, the rules above applying to
    the rest of its shape."""
    names, shape = list(names), tuple(int(n) for n in shape)
    if pipe_axis is not None and "stacked_blocks" in names and shape:
        inner = _resolve(_tp_rule(names, shape[1:]), shape[1:], axes, expert_axis,
                         tensor_axis)
        lead = (pipe_axis if axes.get(pipe_axis, 1) > 1 and shape[0] % axes[pipe_axis] == 0
                else None)
        return (lead, *(inner or (None,) * (len(shape) - 1)))
    return _resolve(_tp_rule(names, shape), shape, axes, expert_axis, tensor_axis)


def torch_spec(name: str, shape: Sequence[int], axes: Dict[str, int]) -> Spec:
    """The spec of the state_dict entry ``name`` of ``shape`` on its own
    dims (() replicated)."""
    names, dims = flax_leaf(name, len(shape))  # utils/convert.py's mapping
    flax_shape = tuple(shape[d] for d in dims)
    spec = leaf_spec(names, flax_shape, axes)
    if not any(spec):
        return ()
    out = [None] * len(shape)
    for fd, axis in enumerate(spec):
        out[dims[fd]] = axis
    return tuple(out)


def shard_plan(model: nn.Module, axes: Dict[str, int]) -> Dict[str, Spec]:
    """{parameter name: its torch spec} of the parameters that the mesh of
    ``axes`` shards (the others are replicated)."""
    plan = {}
    for name, p in model.named_parameters():
        spec = torch_spec(name, tuple(p.shape), axes)
        if spec:
            plan[name] = spec
    return plan


def _owner(model: nn.Module, name: str):
    *path, leaf = name.split(".")
    mod = model
    for p in path:
        mod = getattr(mod, p)
    return mod, leaf


def local_slice(t: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """This rank's shard of the whole tensor ``t`` under ``spec``."""
    for dim, axis in enumerate(spec):
        if axis is not None:
            n = t.shape[dim] // mesh.size(axis)
            t = t.narrow(dim, mesh.coords[axis] * n, n)
    return t


def global_shape(shape: Sequence[int], spec: Spec, mesh) -> Tuple[int, ...]:
    return tuple(n * (mesh.size(a) if a else 1)
                 for n, a in zip(shape, spec or (None,) * len(shape)))


class Sharding:
    """The sharded parameters of a model on ``mesh``: ``specs`` {name:
    torch spec}; ``by_param`` the same keyed by the parameter; on a pipe
    axis ``num_layers`` (the whole stack's) and ``staged``, the parameters
    of this stage's layers."""

    def __init__(self, model: nn.Module, mesh, specs: Dict[str, Spec],
                 num_layers: Optional[int] = None):
        from .pp import is_stage_key

        self.mesh, self.specs, self.num_layers = mesh, dict(specs), num_layers
        params = dict(model.named_parameters())
        self.names = {p: n for n, p in params.items()}
        self.by_param = {params[n]: s for n, s in self.specs.items()}
        self.staged = ({p for n, p in params.items() if is_stage_key(n)}
                       if num_layers is not None else set())

    def spec(self, p) -> Spec:
        return self.by_param.get(p, ())

    def axes_of(self, p) -> Tuple[str, ...]:
        """Every axis a parameter is split over: its dims' and, for a
        stage's layer, ``pipe``."""
        return tuple(a for a in self.spec(p) if a) + ((PIPE_AXIS,) if p in self.staged else ())

    def gather(self, t: torch.Tensor, spec: Spec) -> torch.Tensor:
        """The whole tensor of this rank's shard ``t`` (every rank calls
        it): all-gathered along each sharded dim over its axis."""
        host = self.mesh.host_device
        for dim, axis in enumerate(spec):
            if axis is None:
                continue
            comm = self.mesh.comm(axis)
            src = t.detach().to(host).contiguous()
            parts = [torch.empty_like(src) for _ in range(comm.size)]
            dist.all_gather(parts, src, group=comm.group)
            t = torch.cat(parts, dim=dim).to(t.device)
        return t

    def sum_sq(self, tensors_axes) -> torch.Tensor:
        """The sum of squares of whole leaves from their shards (each given
        with ``axes_of`` its parameter): each leaf's local sum all-reduced
        over its shards' ranks (every rank calls it in one order)."""
        total, groups = None, {}
        for t, axes in tensors_axes:
            sq = t.float().square().sum()
            groups[axes] = groups.get(axes, 0) + sq
        for axes in sorted(groups):
            v = groups[axes]
            comm = self.mesh.comm(*axes)
            if comm.size > 1:
                from ..utils.dist_utils import _all_reduce
                v = _all_reduce(v.clone(), comm.group)
            total = v if total is None else total + v
        return total


def shard_module_(model: nn.Module, mesh) -> Optional[Sharding]:
    """Cut ``model``'s parameters to this rank's shards as the mesh's plan
    says (every rank holds the whole model first, as after
    ``broadcast_module``) and tell each owning module which of its leaves
    are split (``module.shard_specs``: {leaf: torch spec}).  Returns the
    ``Sharding``, or None where the mesh shards nothing.  On a ``pipe``
    axis the model keeps its stage's layers (``pipeline_stage_``)."""
    if mesh is None or not mesh.model_sharded:
        return None
    if mesh.size(PIPE_AXIS) > 1:
        if getattr(model, "pipeline_axis", None) is None:
            raise ValueError(f"a {PIPE_AXIS!r} mesh axis needs a model with pipeline_axis "
                             "(STMoGenTransformer)")
        model.pipeline_stage_(mesh.coords[PIPE_AXIS], mesh.size(PIPE_AXIS))
        return Sharding(model, mesh, {}, num_layers=model.num_layers)
    plan = shard_plan(model, mesh.axes)
    with torch.no_grad():
        for name, spec in plan.items():
            mod, leaf = _owner(model, name)
            p = getattr(mod, leaf)
            p.data = local_slice(p.data, spec, mesh).clone()
            specs = dict(getattr(mod, "shard_specs", None) or {})
            specs[leaf] = spec
            mod.shard_specs = specs
    return Sharding(model, mesh, plan)


def split_axis(module: nn.Module, leaf: str, dim: int) -> Optional[str]:
    """The axis that splits dim ``dim`` of ``module``'s parameter ``leaf``
    (``shard_module_``), or None."""
    spec = (getattr(module, "shard_specs", None) or {}).get(leaf, ())
    return spec[dim] if spec else None


def _staged(sharding: Optional[Sharding]) -> bool:
    return sharding is not None and sharding.num_layers is not None


def full_state_dict(model: nn.Module, sharding: Optional[Sharding]) -> Dict[str, torch.Tensor]:
    """``model.state_dict()`` with every shard gathered whole (every rank
    calls it), detached copies on the CPU; on a pipe axis the whole on
    stage 0 of each pipe group (global rank 0 among them) in the one-process
    model's order, the other stages holding their own layers."""
    from .pp import gather_stages, is_stage_key, one_process_names

    sd = model.state_dict()
    out = {}
    for k, v in sd.items():
        spec = sharding.specs.get(k, ()) if sharding is not None else ()
        out[k] = (sharding.gather(v, spec) if spec else v).detach().cpu().clone()
    if _staged(sharding):
        layers = gather_stages({k: v for k, v in out.items() if is_stage_key(k)},
                               sharding.mesh)
        if layers is not None:
            out.update(layers)
            out = {k: out[k] for k in one_process_names(list(sd), sharding.num_layers)}
    return out


def load_local_state_dict(model: nn.Module, full: Dict[str, torch.Tensor],
                          sharding: Optional[Sharding]) -> None:
    """Load a whole state_dict, each rank keeping its shards (on a pipe
    axis, its stage's layers)."""
    if sharding is not None:
        full = {k: (local_slice(v, sharding.specs[k], sharding.mesh)
                    if k in sharding.specs else v) for k, v in full.items()}
    if _staged(sharding):
        own = set(model.state_dict())
        full = {k: v for k, v in full.items() if k in own}
    model.load_state_dict(full, strict=True)


def moment_spec(p, key: str, value: torch.Tensor, spec: Spec, mesh, whole: bool = False) -> Spec:
    """The spec of the optimizer state ``value`` (``key``) of parameter ``p``
    (this rank's shard, split by ``spec``; ``whole``: ``value`` is the
    gathered moment): the parameter's for a moment of its shape;
    Adafactor's factored ``v_row`` / ``v_col`` the parameter's without the
    dim they average over; () for a scalar or a whole parameter."""
    if not spec or not torch.is_tensor(value) or value.dim() == 0:
        return ()
    if not whole and tuple(value.shape) == tuple(p.shape):
        return spec
    gshape = global_shape(p.shape, spec, mesh)
    if whole and tuple(value.shape) == gshape:
        return spec
    if key in ("v_row", "v_col"):
        from .optim import factored_dims

        d1, d0 = factored_dims(gshape)
        drop = d0 if key == "v_row" else d1
        return tuple(a for i, a in enumerate(spec) if i != drop)
    raise ValueError(f"optimizer state {key!r} of shape {tuple(value.shape)} for a "
                     f"parameter of shape {tuple(p.shape)}")


def full_optimizer_state(optimizer, params, sharding: Optional[Sharding]) -> dict:
    """``optimizer.state_dict()`` with every sharded moment gathered whole
    (every rank calls it), on the CPU; on a pipe axis the whole on stage 0
    of each pipe group, indexed as the one-process model's parameters."""
    sd = optimizer.state_dict()
    if sharding is None:
        return sd
    state = {}
    for idx, st in sd["state"].items():
        p = params[idx]
        spec = sharding.spec(p)
        state[idx] = {k: (sharding.gather(v, s).cpu()
                          if (s := moment_spec(p, k, v, spec, sharding.mesh))
                          else v) for k, v in st.items()}
    if not _staged(sharding):
        return {"state": state, "param_groups": sd["param_groups"]}
    from .pp import gather_stages, is_stage_key, one_process_names

    names = [sharding.names[p] for p in params]
    by_name = {names[i]: {k: v.cpu() if torch.is_tensor(v) else v for k, v in st.items()}
               for i, st in state.items()}
    layers = gather_stages({n: v for n, v in by_name.items() if is_stage_key(n)},
                           sharding.mesh)
    if layers is None:
        return {"state": state, "param_groups": sd["param_groups"]}
    by_name.update(layers)
    order = one_process_names(names, sharding.num_layers)
    return {"state": {i: by_name[n] for i, n in enumerate(order) if n in by_name},
            "param_groups": [dict(g, params=list(range(len(order))))
                             for g in sd["param_groups"]]}


def load_local_optimizer_state(optimizer, params, full: dict,
                               sharding: Optional[Sharding]) -> None:
    """Load a whole optimizer state_dict, each rank keeping its shards (on
    a pipe axis, its stage's layers')."""
    if _staged(sharding):
        from .pp import one_process_names

        names = [sharding.names[p] for p in params]
        index = {n: i for i, n in enumerate(one_process_names(names, sharding.num_layers))}
        state = {int(k): v for k, v in full["state"].items()}
        optimizer.load_state_dict({
            "state": {i: state[index[n]] for i, n in enumerate(names) if index[n] in state},
            "param_groups": [dict(g, params=list(range(len(names))))
                             for g in full["param_groups"]]})
        return
    if sharding is not None:
        state = {}
        for idx, st in full["state"].items():
            p = params[int(idx)]
            spec = sharding.spec(p)
            out = {}
            for k, v in st.items():
                if spec and torch.is_tensor(v) and v.dim():
                    s = moment_spec(p, k, v, spec, sharding.mesh, whole=True)
                    v = local_slice(v, s, sharding.mesh) if s else v
                out[k] = v
            state[idx] = out
        full = {"state": state, "param_groups": full["param_groups"]}
    optimizer.load_state_dict(full)
