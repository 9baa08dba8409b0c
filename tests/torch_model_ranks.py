"""Rank entry points of the model-parallel tests
(tests/test_torch_model_parallel.py, tests/test_torch_mesh_serving.py).

Each runs in a process that ``parallel/mesh.py:launch`` spawned (gloo on
the CPU, one thread a rank), so this module imports nothing of JAX, flax or
the JAX package: the tests hand it numpy inputs and take numpy results
back.  A case names its mesh (``axes``, ``shape``); the rank builds it,
cuts the model to its shards (``parallel/tp.py:shard_module_``) and
returns whole tensors (its shards gathered), so that the test compares
them with one process.  Every function also runs in the test process
without a mesh, as the one-process reference.
"""

import os
import time
import types

import numpy as np
import torch

from torch_dist_ranks import _gate_hooks, _rows, one_thread  # noqa: F401


def _mesh(case):
    from motioncraft_tpu_torch.parallel.mesh import create_mesh

    if case.get("axes") is None:
        return None
    return create_mesh(device="cpu", axes=case["axes"], shape=case["shape"])


def moe_case(case, mesh=None):
    """A ``MoELayer`` (``case["kw"]``, weights ``case["sd"]``) on this
    rank's rows of ``case["x"]``: in training its output, aux loss, the
    gradients of the global loss sum(y * c) / N + aux (every parameter's
    gathered whole) and the rank's own input gradient; in eval its
    output.  Outputs come back gathered in the global order."""
    from motioncraft_tpu_torch.models.moe import MoELayer
    from motioncraft_tpu_torch.parallel.mesh import gather_rows
    from motioncraft_tpu_torch.parallel.tp import shard_module_
    from motioncraft_tpu_torch.utils.dist_utils import all_reduce_sum, allreduce_grads

    layer = MoELayer(**case["kw"])
    layer.load_state_dict({k: torch.from_numpy(v) for k, v in case["sd"].items()})
    sharding = shard_module_(layer, mesh)
    layer.mesh = mesh
    x, c = case["x"], case["c"]
    xl = torch.from_numpy(_rows(x, mesh, 1)).requires_grad_(True)
    out = {"specs": {} if sharding is None else dict(sharding.specs)}
    layer.train()
    aux = []
    with torch.enable_grad():  # whatever the calling process's grad mode
        y = layer(xl, aux_losses=aux)
        loss = (all_reduce_sum((y * torch.from_numpy(_rows(c, mesh, 1))).sum(), mesh) / len(x)
                + aux[0])
        loss.backward()
    allreduce_grads(list(layer.parameters()), mesh, None if sharding is None else
                    {p: sharding.axes_of(p) for p in layer.parameters()})
    grads = {}
    for name, p in layer.named_parameters():
        spec = () if sharding is None else sharding.specs.get(name, ())
        grads[name] = (sharding.gather(p.grad, spec) if spec else p.grad).numpy()
    out["train"] = dict(y=gather_rows(mesh, y.detach()).numpy(), aux=float(aux[0].detach()),
                        loss=float(loss.detach()), grads=grads, x_grad=xl.grad.numpy())
    layer.eval()
    with torch.no_grad():
        out["eval"] = gather_rows(mesh, layer(torch.from_numpy(_rows(x, mesh, 1)))).numpy()
    return out


def step_case(case, mesh=None):
    """One ``make_train_step`` step of the tiny model ``case["cfg"]`` from
    the weights ``case["sd"]`` with ``case["optimizer"]``, on this rank's
    rows of the global ``case["batch"]`` and draws (gates pinned to
    ``case["pins"]`` where given); returns the logs, the whole updated
    weights, the specs of the shards and each rank's parameter and
    optimizer bytes."""
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
    step = make_train_step(arch, state, mesh=mesh)
    handles = _gate_hooks(arch.model, mesh, case.get("skew", False), case.get("pins"))
    arch.train()
    try:
        logs = step(shard_batch(case["batch"], mesh),
                    **{k: torch.from_numpy(_rows(v, mesh, 1)) for k, v in case["draws"].items()})
    finally:
        arch.eval()
        for h in handles:
            h.remove()
    opt_bytes = sum(v.numel() * v.element_size() for st in state.optimizer.state.values()
                    for v in st.values() if torch.is_tensor(v))
    return {"logs": {k: float(v) for k, v in logs.items() if not k.startswith("_")},
            "sd": {k: v.numpy() for k, v in full_state_dict(arch.model, sharding).items()},
            "specs": {} if sharding is None else dict(sharding.specs),
            "param_bytes": sum(p.numel() * p.element_size() for p in arch.model.parameters()),
            "opt_bytes": opt_bytes,
            "shapes": {k: tuple(v.shape) for k, v in arch.model.state_dict().items()}}


def opt_case(case, mesh=None):
    """Two steps of ``case["optimizer"]`` (Adafactor factoring dims from 4,
    or LAMB; lr 1e-2) on a small ``MoELayer``'s shards, from the whole
    gradients ``case["grads"]``; returns the whole updated weights."""
    from motioncraft_tpu_torch.models.moe import MoELayer
    from motioncraft_tpu_torch.parallel.optim import Adafactor, Lamb
    from motioncraft_tpu_torch.parallel.tp import full_state_dict, local_slice, shard_module_

    layer = MoELayer(num_experts=4, topk=2, model_dim=8, hidden_dim=16)
    layer.load_state_dict({k: torch.from_numpy(v) for k, v in case["sd"].items()})
    sharding = shard_module_(layer, mesh)
    opt = (Adafactor(layer.parameters(), lr=1e-2, min_dim_size_to_factor=4)
           if case["optimizer"] == "adafactor" else Lamb(layer.parameters(), lr=1e-2))
    opt.sharding = sharding
    for grads in case["grads"]:
        for name, p in layer.named_parameters():
            g = torch.from_numpy(grads[name])
            spec = () if sharding is None else sharding.specs.get(name, ())
            p.grad = local_slice(g, spec, mesh).clone() if spec else g
        opt.step()
    return {"sd": {k: v.numpy() for k, v in full_state_dict(layer, sharding).items()}}


def model_case(kind, case, mesh=None):
    return {"moe": moe_case, "step": step_case, "opt": opt_case}[kind](case, mesh)


def model_rank(rank, cases):
    """Every case of ``cases`` ({name: (kind, case)}) on its mesh over the
    launched ranks."""
    torch.set_num_threads(1)
    return {name: model_case(kind, case, _mesh(case)) for name, (kind, case) in cases.items()}


def build_served(case):
    """The tiny model of ``case`` with its weights, in eval() (bf16-cast
    for ``case["bf16"]``; for ``case["int8"]`` every eligible weight
    W8A8-quantized, whatever its size)."""
    from motioncraft_tpu_torch.apis import bf16_cast_, int8_quantize_
    from motioncraft_tpu_torch.ops import quant
    from motioncraft_tpu_torch.registry import build_architecture

    arch = build_architecture(case["cfg"], device="cpu")
    arch.model.load_state_dict({k: torch.from_numpy(v) for k, v in case["sd"].items()},
                               strict=True)
    if case.get("bf16"):
        bf16_cast_(arch)
    if case.get("int8"):
        before, quant.MIN_ELEMS = quant.MIN_ELEMS, 0
        try:
            int8_quantize_(arch, weight_only=False)
        finally:
            quant.MIN_ELEMS = before
    return arch.eval()


def server_case(case, mesh=None):
    """A ``MotionGenServer`` over ``mesh`` (rank 0 submits each group of
    ``case["requests"]`` ((texts, lengths) a call, the dispatcher holding
    a group open ``case["wait_ms"]``) and stops; the others follow), or
    one process alone; returns rank 0's outputs and stats.  With
    ``case["idle_s"]`` rank 0 starts the server and stays idle that long
    before the first call."""
    from motioncraft_tpu_torch.serving import MotionGenServer

    arch = build_served(case)
    srv = MotionGenServer(arch, max_seq_len=case["T"], input_feats=322,
                          batch_buckets=case["buckets"], max_wait_ms=case["wait_ms"], seed=case["seed"],
                          compute_dtype=torch.bfloat16 if case.get("bf16") else None,
                          step_cache=case.get("step_cache"), mesh=mesh,
                          keepalive_s=case.get("keepalive_s", 60.0))
    if mesh is not None and not mesh.lead:
        srv.follow()
        return None
    try:
        if mesh is not None and case.get("idle_s"):
            srv.start()  # no request for longer than the group's timeout
            time.sleep(case["idle_s"])
        outs = [srv.generate(texts, lengths, timeout=300)
                for texts, lengths in case["requests"]]
    finally:
        srv.stop()
    return {"outs": outs, "stats": srv.stats()}


def serve_rank(rank, cases):
    from motioncraft_tpu_torch.parallel.mesh import create_mesh

    torch.set_num_threads(1)
    mesh = create_mesh(device="cpu")
    return {name: server_case(case, mesh) for name, case in cases.items()}


def checkpoint_rank(rank, root):
    """``save_checkpoint`` (3 epochs, the newest kept) and
    ``save_state_params`` of one state on every rank of a data mesh, each
    rank into a directory of its own; returns what that directory holds."""
    from motioncraft_tpu_torch.utils.checkpoint import save_checkpoint, save_state_params

    torch.manual_seed(0)
    model = torch.nn.Linear(3, 2)
    state = types.SimpleNamespace(model=model, optimizer=torch.optim.Adam(model.parameters()),
                                  params=list(model.parameters()), step=0)
    work = os.path.join(root, f"rank_{rank}")
    for epoch in range(3):
        save_checkpoint(os.path.join(work, "ckpt"), state, epoch, max_to_keep=1)
    save_state_params(os.path.join(work, "params.npz"), state)
    return sorted(os.path.relpath(os.path.join(d, f), work)
                  for d, _, files in os.walk(work) for f in files)
