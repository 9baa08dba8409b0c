"""Rank entry points of the data-parallel tests (tests/test_torch_dist_*.py).

Each runs in a process that ``parallel/mesh.py:launch`` spawned (gloo on
the CPU, one thread a rank), so this module imports nothing of JAX, flax or
the JAX package: the tests hand it numpy inputs and take numpy results
back.  ``train_case`` also runs in the test process itself without a mesh,
as the one-process reference.
"""

import contextlib

import numpy as np
import torch

SKEW = 3.0  # added to expert 0's gate logit: every token leans to it


@contextlib.contextmanager
def one_thread():
    """torch on one thread, as every rank runs: the CPU's products can sum
    in another order on another thread count, and a gate logit one ulp
    apart can move a near-tied expert pick."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)


class _Pin(torch.autograd.Function):
    """The given value, the identity's gradient."""

    @staticmethod
    def forward(ctx, out, value):
        return value.clone()

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def _rows(a, mesh, grad_accum):
    from motioncraft_tpu_torch.parallel.mesh import local_rows

    return a if mesh is None else a[local_rows(len(a), mesh, grad_accum)]


def _gate_hooks(model, mesh, skew, pins):
    """Forward hooks on every MoE gate: with ``skew`` expert 0's logit
    raised by SKEW; with ``pins`` ({gate path: [global logits a call]}) the
    call's logits replaced by this rank's rows of the pinned ones (its
    tokens are a contiguous block of the global microbatch's)."""
    from motioncraft_tpu_torch.models.moe import CosineTopGate

    calls = {}

    def hook(name):
        def fn(mod, inp, out):
            if pins is not None:
                i = calls.get(name, 0)
                calls[name] = i + 1
                n = out.shape[0]
                first = 0 if mesh is None else mesh.rank * n
                out = _Pin.apply(out, torch.from_numpy(pins[name][i][first:first + n]))
            if skew:
                out = out + torch.nn.functional.one_hot(
                    torch.zeros((), dtype=torch.long), out.shape[1]).to(out.dtype) * SKEW
            return out
        return fn

    return [m.register_forward_hook(hook(n)) for n, m in model.named_modules()
            if isinstance(m, CosineTopGate)]


def train_case(case, mesh=None):
    """One ``make_train_step`` step (SGD, no momentum: the update is the
    gradient times lr) of the tiny model ``case["cfg"]`` from the weights
    ``case["sd"]`` on this rank's rows of the global ``case["batch"]`` and
    draws; returns the logs, the updated weights, every positions list
    that K4's plain version computed and, on a mesh, every all-gathered
    [N, 1 + K] (top-1 score, experts) list of the MoEs' routing."""
    from motioncraft_tpu_torch.apis import make_train_step
    from motioncraft_tpu_torch.models import moe
    from motioncraft_tpu_torch.parallel import TrainState
    from motioncraft_tpu_torch.parallel.mesh import shard_batch
    from motioncraft_tpu_torch.registry import build_architecture

    ga = case.get("grad_accum", 1)
    arch = build_architecture(case["cfg"], device="cpu")
    arch.model.load_state_dict({k: torch.from_numpy(v) for k, v in case["sd"].items()},
                               strict=True)
    state = TrainState(arch.model, {"type": "SGD", "lr": case["lr"], "momentum": 0.0},
                       frozen_prefixes=case.get("frozen", ("text_enc/clip",)))
    step = make_train_step(arch, state, fp16=case.get("fp16"), grad_accum=ga, mesh=mesh)
    positions, gathered = [], []
    counts, gather = moe.moe_positions_counts, moe.all_gather_rows

    def recorded(idx, E):
        out = counts(idx, E)
        positions.append(out[0].numpy().copy())
        return out

    def recorded_gather(x, m):
        out = gather(x, m)
        gathered.append(out.detach().numpy().copy())
        return out

    handles = _gate_hooks(arch.model, mesh, case.get("skew", False), case.get("pins"))
    moe.moe_positions_counts, moe.all_gather_rows = recorded, recorded_gather
    arch.train()
    try:
        logs = step(shard_batch(case["batch"], mesh, ga),
                    **{k: torch.from_numpy(_rows(v, mesh, ga)) for k, v in case["draws"].items()})
    finally:
        arch.eval()
        moe.moe_positions_counts, moe.all_gather_rows = counts, gather
        for h in handles:
            h.remove()
    return {"logs": {k: float(v) for k, v in logs.items() if not k.startswith("_")},
            "timesteps": logs["_timesteps"].numpy(), "loss_batch": logs["_loss_batch"].numpy(),
            "sd": {k: v.detach().numpy().copy() for k, v in arch.model.state_dict().items()},
            "positions": positions, "gathered": gathered}


def train_rank(rank, cases):
    from motioncraft_tpu_torch.parallel.mesh import create_mesh

    torch.set_num_threads(1)
    mesh = create_mesh(device="cpu")
    return {name: train_case(case, mesh) for name, case in cases.items()}


def collect_rank(rank, n_items):
    """``collect_results`` of rank-tagged parts (rank r holds the
    interleaved items r, r + W, ...) and the ranks' dist=True loader
    indices; also ``mean_across_hosts`` of the rank and the backward of the
    differentiable collectives."""
    from motioncraft_tpu_torch.data import build_dataloader
    from motioncraft_tpu_torch.parallel.mesh import create_mesh, gather_rows
    from motioncraft_tpu_torch.utils.dist_utils import (all_gather_rows, all_reduce_sum,
                                                        collect_results, mean_across_hosts)

    torch.set_num_threads(1)
    mesh = create_mesh(device="cpu")
    W = mesh.world
    # a round-up loader's slice: items past n_items repeat the first ones
    mine = [{"item": int(i % n_items), "rank": rank}
            for i in range(rank, -(-n_items // W) * W, W)]
    merged = collect_results(mine, n_items, mesh)
    loader = build_dataloader(list(range(n_items)), 2, dist=True, shuffle=True, seed=3)
    loader.sampler.set_epoch(1)
    x = torch.full((2, 3), float(rank + 1), requires_grad=True)
    total = all_reduce_sum(x.sum(), mesh)
    rows = all_gather_rows(x * (rank + 1), mesh)
    (total + rows.sum()).backward()
    return {"merged": merged, "indices": loader.sampler.indices().tolist(),
            "mean": float(mean_across_hosts({"r": torch.tensor(float(rank))}, mesh)["r"]),
            "total": float(total), "rows": rows.detach().numpy(), "grad": x.grad.numpy(),
            "gathered": gather_rows(mesh, torch.arange(4) + 4 * rank, 2).tolist()}


def eval_rank(rank, cfg, sd, samples, batch_size, seed):
    """``multi_host_test`` of a tiny model over a list dataset, this
    rank's ``single_device_test`` over its own slice, and ``collect_rank``
    over the dataset's length."""
    from motioncraft_tpu_torch.apis import multi_host_test, single_device_test
    from motioncraft_tpu_torch.data import build_dataloader
    from motioncraft_tpu_torch.parallel.mesh import create_mesh
    from motioncraft_tpu_torch.registry import build_architecture

    torch.set_num_threads(1)
    arch = build_architecture(cfg, device="cpu")
    arch.model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)

    def loader():
        out = build_dataloader(samples, batch_size, shuffle=False, round_up=True, dist=True)
        out.drop_last = False
        return out

    merged = multi_host_test(arch, loader(), seed=seed, device="cpu",
                             mesh=create_mesh(device="cpu"))
    local = single_device_test(arch, loader(), seed=seed + rank, device="cpu")
    return {"merged": np.stack([r["pred_motion"] for r in merged]),
            "texts": [r["text"] for r in merged],
            "local": np.stack([r["pred_motion"] for r in local]),
            "collect": collect_rank(rank, len(samples))}
