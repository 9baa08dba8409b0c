"""Rank entry points of the pipeline-parallel tests
(tests/test_torch_pipeline.py).

Each runs in a process that ``parallel/mesh.py:launch`` spawned (gloo on
the CPU, one thread a rank), so this module imports nothing of JAX, flax or
the JAX package: the tests hand it numpy inputs and take numpy results
back.  A case names its mesh (``axes``, ``shape``); every function also runs
in the test process without a mesh, as the one-process reference.
"""

import torch
import torch.distributed as dist

from torch_dist_ranks import _gate_hooks, _rows, one_thread


def toy_case(case, mesh=None):
    """``gpipe`` of the toy layer tanh(x @ W[l] + b[l] + c) (aux: the mean
    of its output) over ``case["W"]`` [L, D, D], ``case["b"]`` [L, D] on this
    rank's rows of ``case["x"]`` [B, ...] and ``case["c"]``: the output (the
    global rows), the aux and the gradients of sum(out ** 2) with respect
    to this stage's layers (summed over data), by global layer."""
    from motioncraft_tpu_torch.parallel.mesh import gather_rows
    from motioncraft_tpu_torch.parallel.pp import gpipe, stage_layers
    from motioncraft_tpu_torch.utils.dist_utils import all_reduce_sum

    L = len(case["W"])
    ids = (stage_layers(L, mesh.size("pipe"), mesh.coords["pipe"]) if mesh is not None
           else range(L))
    W = torch.from_numpy(case["W"][list(ids)]).requires_grad_()
    b = torch.from_numpy(case["b"][list(ids)]).requires_grad_()
    x = torch.from_numpy(_rows(case["x"], mesh, 1))
    c = torch.from_numpy(_rows(case["c"], mesh, 1))

    def stage_fn(xm, cm, k):
        aux = 0.0
        for j in range(len(ids)):
            xm = torch.tanh(xm @ W[j] + b[j] + cm[0][:, None, :])
            aux = aux + xm.mean()
        return xm, {"aux_loss": aux}

    with torch.enable_grad():
        out, aux = gpipe(stage_fn, [W, b], x, (c,), n_microbatch=case["M"], mesh=mesh)
        (out ** 2).sum().backward()  # this rank's rows' share
    data = 1 if mesh is None else mesh.world
    if data > 1:
        for t in (W.grad, b.grad):
            dist.all_reduce(t, group=mesh.group)
    return {"out": gather_rows(mesh, out.detach()).numpy(),
            "aux": float(all_reduce_sum(aux["aux_loss"].detach(), mesh) / data),
            "layers": list(ids), "gW": W.grad.numpy(), "gb": b.grad.numpy()}


def _arch(case, mesh):
    """The tiny pipelined model with the weights ``case["sd"]``, cut to this
    rank's stage, the mesh attached."""
    from motioncraft_tpu_torch.parallel.mesh import attach_mesh
    from motioncraft_tpu_torch.parallel.tp import shard_module_
    from motioncraft_tpu_torch.registry import build_architecture

    arch = build_architecture(case["cfg"], device="cpu")
    arch.model.load_state_dict({k: torch.from_numpy(v) for k, v in case["sd"].items()},
                               strict=True)
    sharding = shard_module_(arch.model, mesh)
    attach_mesh(arch, mesh)
    return arch, sharding


def forward_case(case, mesh=None):
    """The training forward (mode="train", the gates skewed where
    ``case["skew"]``) and the test forward (CFG-doubled) of the tiny
    pipelined model on this rank's rows of ``case["inputs"]`` (motion, t,
    t_test, motion_mask, motion_length, cond_type, text_ids): the outputs in the
    global order and the aux loss the model appends."""
    from motioncraft_tpu_torch.parallel.mesh import gather_rows

    arch, _ = _arch(case, mesh)
    inp = {k: torch.from_numpy(_rows(v, mesh, 1)) for k, v in case["inputs"].items()}
    handles = _gate_hooks(arch.model, mesh, case.get("skew", False), None)
    out = {}
    try:
        with torch.no_grad():
            xf = arch.model.encode_text(inp["text_ids"])
            kw = dict(motion_mask=inp["motion_mask"], motion_length=inp["motion_length"],
                      xf_out=xf)
            arch.train()
            aux = []
            y = arch.model(inp["motion"], inp["t"], mode="train", cond_type=inp["cond_type"],
                           aux_losses=aux, **kw)
            out["train"] = gather_rows(mesh, y).numpy()
            out["aux"] = float(aux[0])
            arch.eval()
            if case.get("test", True):
                out["test"] = gather_rows(mesh, arch.model(inp["motion"], inp["t_test"],
                                                           mode="test", **kw)).numpy()
    finally:
        arch.eval()
        for h in handles:
            h.remove()
    return out


def _bytes(named):
    """{"block": bytes of the decoder layers' tensors, "rest": the others'}."""
    from motioncraft_tpu_torch.parallel.pp import is_stage_key

    out = {"block": 0, "rest": 0}
    for name, t in named:
        out["block" if is_stage_key(name) else "rest"] += t.numel() * t.element_size()
    return out


def step_case(case, mesh=None):
    """One ``make_train_step`` step of ``case["optimizer"]`` (with
    ``case["grad_clip"]``, ``case["grad_accum"]`` microbatches and
    ``case["fp16"]``) of the tiny pipelined model from the weights
    ``case["sd"]`` on this rank's rows of the global ``case["batch"]`` and
    draws, the gates skewed where ``case["skew"]``: the logs, the whole
    updated weights (on global rank 0), the layers this rank holds and the
    bytes of its parameters, gradients and optimizer moments."""
    from motioncraft_tpu_torch.apis import make_train_step
    from motioncraft_tpu_torch.parallel import TrainState
    from motioncraft_tpu_torch.parallel.mesh import broadcast_module, shard_batch
    from motioncraft_tpu_torch.parallel.tp import full_state_dict, shard_module_
    from motioncraft_tpu_torch.registry import build_architecture

    arch = build_architecture(case["cfg"], device="cpu")
    arch.model.load_state_dict({k: torch.from_numpy(v) for k, v in case["sd"].items()},
                               strict=True)
    broadcast_module(arch.model, mesh)
    sharding = shard_module_(arch.model, mesh)
    state = TrainState(arch.model, dict(case["optimizer"]), sharding=sharding,
                       grad_clip=case.get("grad_clip"))
    ga = case.get("grad_accum", 1)
    step = make_train_step(arch, state, fp16=case.get("fp16"), grad_accum=ga, mesh=mesh)
    names = {p: n for n, p in arch.model.named_parameters()}
    grads, apply = {}, state.apply_gradients

    def spy():  # the gradients this rank holds, as the update takes them
        grads.update(_bytes((names[p], p.grad) for p in state.params if p.grad is not None))
        apply()

    state.apply_gradients = spy
    handles = _gate_hooks(arch.model, mesh, case.get("skew", False), None)
    arch.train()
    try:
        logs = step(shard_batch(case["batch"], mesh, ga),
                    **{k: torch.from_numpy(_rows(v, mesh, ga)) for k, v in case["draws"].items()})
    finally:
        arch.eval()
        for h in handles:
            h.remove()
    return {"logs": {k: float(v) for k, v in logs.items() if not k.startswith("_")},
            "sd": {k: v.numpy() for k, v in full_state_dict(arch.model, sharding).items()},
            "layers": list(getattr(arch.model, "layer_ids", [])),
            "param_bytes": _bytes(arch.model.named_parameters()), "grad_bytes": grads,
            "opt_bytes": _bytes((names[p], v) for p, st in state.optimizer.state.items()
                                for v in st.values() if torch.is_tensor(v) and v.dim())}


def pipe_case(kind, case, mesh=None):
    return {"toy": toy_case, "forward": forward_case, "step": step_case}[kind](case, mesh)


def pipe_rank(rank, cases):
    """Every case of ``cases`` ({name: (kind, case)}) on its mesh over the
    launched ranks."""
    from motioncraft_tpu_torch.parallel.mesh import create_mesh

    torch.set_num_threads(1)
    out = {}
    for name, (kind, case) in cases.items():
        mesh = create_mesh(device="cpu", axes=case["axes"], shape=case["shape"])
        out[name] = pipe_case(kind, case, mesh)
    return out


def one_process(cases):
    """Every case without a mesh (its ``one_cfg``: the pipelined config at
    data x M microbatches)."""
    with one_thread():
        return {name: pipe_case(kind, dict(case, cfg=case.get("one_cfg", case.get("cfg"))))
                for name, (kind, case) in cases.items()}
