"""The model across ranks (expert- and tensor-parallel) of the port against
the JAX package's sharded computations and against the port's one process,
on the CPU.

The port side is gloo ranks spawned by ``parallel/mesh.py:launch``
(tests/torch_model_ranks.py; one launch of 2 ranks and one of 4 run every
case), each on its rows of the same global input (rows over data x expert,
replicated over tensor) with the model cut to its shards.  The JAX side
is ``jax.jit`` on the CPU's virtual devices with the weights placed by
``parallel/tp.py:tree_shardings``; under GSPMD it computes the one-device
result.  Gate noise is 0 on both sides (the frameworks' draws differ).

- ``MoELayer`` with a gate skewed towards expert 0, so that the capacity
  drops choices: on an ``expert`` 2 mesh (2 ranks) and a ``data`` 2 x
  ``expert`` 2 mesh (4 ranks), in training (output, aux loss, every
  gradient gathered whole) and in eval (K4's route over the gathered
  logits, K6 on the local experts); against JAX's
  ``MoELayer(expert_axis="expert")`` under ``create_mesh(8)`` as
  tests/test_spmd_equivalence.py runs it (1e-5), and against the port's
  one-process layer (outputs 1e-6 of scale, gradients 1e-5).
- The tiny flagship's train step (skewed gates): SGD (lr 1, the update
  the gradient) with the experts sharded (``expert`` 2) against JAX's
  step on the same mesh (1e-5 / 1e-4 of scale, PR 18's bounds), and Adam
  on 4 ranks (``expert`` 2 x ``tensor`` 2) against JAX's ``tp_mesh``
  step: the loss within 1e-5 relative and the params within 5e-5, JAX's
  own bounds (tests/test_tensor_parallel.py); both against the port's
  one-process step; every rank's shapes as JAX's shards.
- Adafactor (factored: ``min_dim_size_to_factor`` 4) and LAMB steps of a
  sharded layer, and the tiny flagship's clipped SGD step on 4 ranks
  (the clip's norm over the shards), against one process.
- The port's shard plan against ``tree_shardings`` leaf by leaf, Adam's
  moments included, and a dim that its axis does not divide.
"""

import os
import time

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import motioncraft_tpu.models  # noqa: F401  (registers the flax classes)
import torch_model_ranks as ranks
from motioncraft_tpu.apis.factory import make_text_batch, tiny_t2m_cfg
from motioncraft_tpu.apis.train import make_train_step as jax_make_train_step
from motioncraft_tpu.models.moe import MoELayer as JaxMoELayer
from motioncraft_tpu.parallel import create_train_state, tree_shardings
from motioncraft_tpu.parallel.mesh import batch_sharding, replicated
from motioncraft_tpu.parallel.mesh import create_mesh as jax_create_mesh
from motioncraft_tpu.registry import build_architecture as build_jax
from motioncraft_tpu_torch.models.moe import MoELayer
from motioncraft_tpu_torch.ops.moe_ffn import BLOCK
from motioncraft_tpu_torch.ops.moe_positions import moe_route
from motioncraft_tpu_torch.parallel import tp
from motioncraft_tpu_torch.parallel.mesh import launch
from motioncraft_tpu_torch.registry import build_architecture as build_torch
from motioncraft_tpu_torch.utils.convert import from_jax_params, to_jax_params
from test_torch_dist_train import _interceptor, _numeric, global_draws
from torch_port_util import assert_close_scaled, seeded_params

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs the 8-device virtual CPU mesh")

B, T = 4, 16
CLIP = ("text_enc/clip",)
EP2 = (("data", "expert"), (1, 2))
DP2EP2 = (("data", "expert"), (2, 2))
EP2TP2 = (("data", "expert", "tensor"), (1, 2, 2))
MOE_KW = dict(num_experts=8, topk=2, model_dim=32, hidden_dim=64, gate_noise=0.0)
SGD = {"type": "SGD", "lr": 1.0, "momentum": 0.0}
ADAM = {"type": "Adam", "lr": 2e-4}


def _moe_inputs():
    """A layer's weights with its gate skewed: expert 0's similarity column
    the tokens' mean projected direction, so most tokens rank it first
    and the capacity drops choices."""
    rng = np.random.RandomState(3)
    torch.manual_seed(0)
    layer = MoELayer(**MOE_KW)
    x = rng.randn(64, 32).astype(np.float32)
    with torch.no_grad():
        proj = layer.gate.cosine_projector(torch.from_numpy(x))
        proj = proj / proj.norm(dim=1, keepdim=True)
        layer.gate.sim_matrix[:, 0] = proj.mean(dim=0) * layer.gate.sim_matrix[:, 1].norm()
    sd = {k: v.numpy().copy() for k, v in layer.state_dict().items()}
    c = rng.randn(64, 32).astype(np.float32)
    return dict(kw=MOE_KW, sd=sd, x=x, c=c)


def _jax_moe(case):
    """JAX's expert-sharded MoELayer under create_mesh(8) (data 4, expert
    2): (train output, aux), eval output."""
    layer = JaxMoELayer(**MOE_KW, expert_axis="expert")
    params = {"params": to_jax_params({k: torch.from_numpy(v) for k, v in case["sd"].items()})}
    mesh = jax_create_mesh(8)
    out = {}
    with jax.set_mesh(mesh):
        for train in (True, False):
            out[train] = jax.device_get(jax.jit(
                lambda p, v, train=train: layer.apply(p, v, train=train),
                in_shardings=(replicated(mesh), replicated(mesh)))(params, case["x"]))
    return out


def _tiny_cfg(expert_axis=None):
    cfg = tiny_t2m_cfg(expert_axis=expert_axis)
    cfg["model"]["ca_block_cfg"]["gate_noise"] = 0.0
    return cfg


def _batch():
    rng = np.random.RandomState(5)
    return make_text_batch(["a person walks forward", "someone waves hello",
                            "a man jumps twice", "she turns around slowly"],
                           max_seq_len=T, motion=rng.randn(B, T, 322).astype(np.float32),
                           lengths=np.array([[16], [11], [9], [14]], np.int32))


def jax_step(arch_j, params, batch, key, mesh, optimizer):
    """JAX's train step with the state placed by tree_shardings on ``mesh``
    and the batch on ``data``, the gates skewed as the port's hooks skew
    them: (updated params, logs)."""
    state = create_train_state(jax.tree_util.tree_map(jnp.asarray, params), optimizer,
                               None, None, CLIP)
    base = jax_make_train_step(arch_j)

    def step(s, b, r):
        with fnn.intercept_methods(_interceptor(True, None)):
            return base(s, b, r)

    sh = tree_shardings(state, mesh)
    fn = jax.jit(step, in_shardings=(sh, batch_sharding(mesh), replicated(mesh)),
                 out_shardings=(sh, replicated(mesh)))
    with jax.set_mesh(mesh):
        state, logs = jax.device_get(fn(state, _numeric(batch), key))
    return state.params, logs


def _opt_unit_case(optimizer):
    """A sharded layer's two optimizer steps on fixed whole gradients."""
    rng = np.random.RandomState(9)
    torch.manual_seed(1)
    layer = MoELayer(num_experts=4, topk=2, model_dim=8, hidden_dim=16)
    sd = {k: v.numpy().copy() for k, v in layer.state_dict().items()}
    grads = [{k: rng.randn(*v.shape).astype(np.float32) for k, v in sd.items()}
             for _ in range(2)]
    return dict(sd=sd, grads=grads, optimizer=optimizer)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX references, the port's ranks (a 2-rank and a 4-rank launch)
    and the port's one-process runs."""
    moe = _moe_inputs()
    cfg = _tiny_cfg(expert_axis="expert")
    arch_j = build_jax(cfg)
    params = seeded_params(to_jax_params(build_torch(cfg, device="cpu").model.state_dict()), 1)
    sd = {k: v.numpy() for k, v in from_jax_params(params).items()}
    batch = _batch()
    key = jax.random.PRNGKey(17)
    step = dict(cfg=cfg, sd=sd, batch=_numeric(batch), draws=global_draws(arch_j, batch, key, 1),
                skew=True)
    want = {"moe": _jax_moe(moe),
            "ep_sgd": jax_step(arch_j, params, batch, key,
                               jax_create_mesh(2, axes=("data", "expert"), shape=(1, 2)), SGD),
            "tp_adam": jax_step(arch_j, params, batch, key,
                                jax_create_mesh(8, axes=("data", "expert", "tensor")), ADAM)}
    two = {"moe": ("moe", dict(moe, axes=EP2[0], shape=EP2[1])),
           "ep_sgd": ("step", dict(step, optimizer=SGD, axes=EP2[0], shape=EP2[1]))}
    four = {"moe": ("moe", dict(moe, axes=DP2EP2[0], shape=DP2EP2[1])),
            "tp_adam": ("step", dict(step, optimizer=ADAM, axes=EP2TP2[0], shape=EP2TP2[1])),
            "tp_sgd_clip": ("step", dict(step, optimizer=SGD, axes=EP2TP2[0],
                                         shape=EP2TP2[1], grad_clip={"max_norm": 1e-3})),
            "unit_adafactor": ("opt", dict(_opt_unit_case("adafactor"),
                                           axes=EP2TP2[0], shape=EP2TP2[1])),
            "unit_lamb": ("opt", dict(_opt_unit_case("lamb"), axes=EP2TP2[0],
                                      shape=EP2TP2[1]))}
    root = tmp_path_factory.mktemp("mp")
    got2 = launch(ranks.model_rank, 2, args=(two,), backend="gloo",
                  init_method=f"file://{root / 'rv2'}", timeout_s=240, group_timeout_s=90)
    got4 = launch(ranks.model_rank, 4, args=(four,), backend="gloo",
                  init_method=f"file://{root / 'rv4'}", timeout_s=300, group_timeout_s=90)
    with ranks.one_thread():
        one = {name: ranks.model_case(kind, dict(case, axes=None))
               for name, (kind, case) in {**two, **four}.items()}
    return {"want": want, "two": got2, "four": got4, "one": one, "sd": sd,
            "params": params, "moe": moe}


@pytest.mark.parametrize("world", [2, 4])
def test_moe_layer_against_jax_and_one_process(runs, world):
    got = runs["two" if world == 2 else "four"]
    (y_j, aux_j), (ye_j, _) = runs["want"]["moe"][True], runs["want"]["moe"][False]
    one = runs["one"]["moe"]
    for r in got:
        g = r["moe"]
        assert g["specs"]["expert_w1"] == ("expert", None, None)
        np.testing.assert_allclose(g["train"]["y"], np.asarray(y_j), atol=1e-5)
        assert abs(g["train"]["aux"] - float(aux_j)) < 1e-5
        np.testing.assert_allclose(g["eval"], np.asarray(ye_j), atol=1e-5)
        assert_close_scaled(g["train"]["y"], one["train"]["y"], 1e-6, "y")
        assert_close_scaled(g["eval"], one["eval"], 1e-6, "eval")
        assert_close_scaled(g["train"]["loss"], one["train"]["loss"], 1e-6, "loss")
        for k, w in one["train"]["grads"].items():
            assert_close_scaled(g["train"]["grads"][k], w, 1e-5, k)
    # the skewed gate makes the capacity drop choices and keep others
    moe = runs["moe"]
    layer = MoELayer(**MOE_KW)
    layer.load_state_dict({k: torch.from_numpy(v) for k, v in moe["sd"].items()})
    with torch.no_grad():
        route = moe_route(layer.gate(torch.from_numpy(moe["x"])), MOE_KW["topk"],
                          layer.capacity(len(moe["x"])), BLOCK)
    assert (route.gates == 0).any() and (route.gates > 0).any()


def _updates(after, before, lr):
    return {k: (after[k] - before[k]) / lr for k in after}


def test_expert_sharded_step_against_jax(runs):
    params_j, logs_j = runs["want"]["ep_sgd"]
    want = _updates({k: v.numpy() for k, v in from_jax_params(params_j).items()}, runs["sd"], 1)
    one = runs["one"]["ep_sgd"]
    for r in runs["two"]:
        g = r["ep_sgd"]
        for key in ("loss", "recon_loss", "moe_route_loss"):
            assert_close_scaled(g["logs"][key], logs_j[key], 1e-5, key)
            assert_close_scaled(g["logs"][key], one["logs"][key], 1e-6, key)
        upd = _updates(g["sd"], runs["sd"], 1)
        upd_one = _updates(one["sd"], runs["sd"], 1)
        for k, w in want.items():
            assert_close_scaled(upd[k], w, 1e-4, k)
            assert_close_scaled(upd[k], upd_one[k], 1e-5, k)
        E = runs["sd"]["block_0.ca_block.motion_moe.model.expert_w1"].shape[0]
        assert g["shapes"]["block_0.ca_block.motion_moe.model.expert_w1"][0] == E // 2


def test_tensor_parallel_step_against_jax_tp_mesh(runs):
    """JAX's own bounds: loss within 1e-5 relative, params within 5e-5."""
    params_j, logs_j = runs["want"]["tp_adam"]
    want = {k: v.numpy() for k, v in from_jax_params(params_j).items()}
    one = runs["one"]["tp_adam"]
    loss_j = float(logs_j["loss"])
    for r in runs["four"]:
        g = r["tp_adam"]
        assert abs(g["logs"]["loss"] - loss_j) < 1e-5 * max(1.0, abs(loss_j))
        assert abs(g["logs"]["loss"] - one["logs"]["loss"]) < 1e-6 * max(1.0, abs(loss_j))
        for k, w in want.items():
            assert np.abs(g["sd"][k] - w).max() < 5e-5, k
            assert np.abs(g["sd"][k] - one["sd"][k]).max() < 5e-5, k


def test_shards_have_jax_shapes(runs):
    """Every rank's leaves have the shapes of JAX's shards of them under
    tree_shardings on the same mesh: the expert leaves E / 2, the hidden
    leaves F / 2."""
    mesh = jax_create_mesh(4, axes=("data", "expert", "tensor"), shape=(1, 2, 2))
    placed = jax.device_put(runs["params"], tree_shardings(runs["params"], mesh))
    want = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(placed):
        name = ".".join(str(getattr(k, "key", k)) for k in path)
        want[name] = {s.data.shape for s in leaf.addressable_shards}
    sd = from_jax_params(runs["params"])
    split = 0
    for r in runs["four"]:
        shapes = r["tp_adam"]["shapes"]
        for k in sd:
            flax_names, dims = tp.flax_leaf(k, sd[k].dim())
            (shape,) = want[".".join(flax_names)]
            assert tuple(shapes[k][d] for d in dims) == tuple(shape), k
            split += tuple(shapes[k]) != tuple(sd[k].shape)
    assert split > 0
    for r in runs["four"]:
        assert r["tp_adam"]["param_bytes"] < sum(v.numel() * 4 for v in sd.values())


@pytest.mark.parametrize("name", ["tp_sgd_clip", "unit_adafactor", "unit_lamb"])
def test_sharded_optimizer_steps_against_one_process(runs, name):
    """The clip's global norm and Adafactor's and LAMB's per-leaf
    statistics over a leaf's shards give the one-process step (the clip
    binds: max_norm 1e-3)."""
    one = runs["one"][name]
    for r in runs["four"]:
        g = r[name]
        if name == "tp_sgd_clip":
            assert_close_scaled(g["logs"]["loss"], one["logs"]["loss"], 1e-6, "loss")
            upd, want = _updates(g["sd"], runs["sd"], 1), _updates(one["sd"], runs["sd"], 1)
            norm = np.sqrt(sum(np.square(w).sum() for w in want.values()))
            assert abs(norm - 1e-3) < 1e-6
            for k, w in want.items():
                assert_close_scaled(upd[k], w, 1e-4, k)
        else:
            for k, w in one["sd"].items():
                assert_close_scaled(g["sd"][k], w, 1e-5, k)


def test_shard_plan_against_tree_shardings():
    """The port's plan, keyed on its state_dict's names, gives each leaf and
    each of Adam's moments the spec that tree_shardings gives the flax
    leaf; a dim that its axis does not divide is replicated."""
    cfg = tiny_t2m_cfg(expert_axis="expert")
    model = build_torch(cfg, device="cpu").model
    params = jax.tree_util.tree_map(jnp.asarray, to_jax_params(model.state_dict()))
    mesh = jax_create_mesh(8, axes=("data", "expert", "tensor"))
    axes = dict(mesh.shape)
    state = create_train_state(params, ADAM)
    specs = {}
    for path, s in jax.tree_util.tree_leaves_with_path(tree_shardings(state, mesh)):
        specs["/".join(str(getattr(k, "key", getattr(k, "name", k))) for k in path)] = s.spec
    split = 0
    for name, p in model.named_parameters():
        flax_names, dims = tp.flax_leaf(name, p.dim())
        path = "/".join(flax_names)
        spec = tp.torch_spec(name, tuple(p.shape), axes)
        flax_spec = tuple(spec[d] for d in dims) if spec else ()
        want = [v for k, v in specs.items() if k.endswith(path) and (
            k.startswith("params/") or "/mu/" in k or "/nu/" in k)]
        frozen = name.startswith("text_enc.clip.")  # no moments for the frozen CLIP
        assert len(want) == (1 if frozen else 3), path  # params, mu, nu
        for w in want:
            assert flax_spec == tuple(w), (name, flax_spec, w)
        moment = tp.moment_spec(p, "exp_avg", torch.zeros_like(p), spec, None)
        assert moment == spec
        split += bool(spec)
    assert split >= 10
    assert tp.torch_spec("model.expert_w1", (16, 7, 33), axes) == ("expert", None, None)
    assert tp.leaf_spec(["model", "expert_w1"], (16, 7, 33), axes) == ("expert", None, None)
    assert tp.torch_spec("clip.resblock_0.mlp_fc.weight", (128, 32), axes) == ("tensor", None)


def test_collectives_counted_and_timed_only_on_request():
    """A collective's calls and bytes are always counted; its wall time only
    once a caller turns timing on (no card synchronized otherwise)."""
    from motioncraft_tpu_torch.utils import dist_utils

    x = torch.zeros(4)
    dist_utils.traffic(reset=True, timing=False)
    dist_utils._timed("all_reduce", x, lambda: time.sleep(0.02))
    assert dist_utils.traffic(reset=True, timing=True) == {
        "all_reduce": {"calls": 1, "bytes": 16, "ms": 0.0}}
    try:
        dist_utils._timed("all_reduce", x, lambda: time.sleep(0.02))
        rec = dist_utils.traffic(reset=True)["all_reduce"]
    finally:
        dist_utils.traffic(reset=True, timing=False)
    assert rec["calls"] == 1 and rec["bytes"] == 16 and rec["ms"] >= 20


def test_checkpoint_written_by_global_rank_0_alone(tmp_path):
    """On a data-only mesh (no sharding) the savers write on rank 0 alone:
    the other rank's directory stays empty."""
    got = launch(ranks.checkpoint_rank, 2, args=(str(tmp_path),), backend="gloo",
                 init_method=f"file://{tmp_path / 'rendezvous'}", timeout_s=120,
                 group_timeout_s=60)
    assert got[0] == [os.path.join("ckpt", "epoch_2.pth"), "params.npz"]
    assert got[1] == []


def test_expert_axis_through_build_flagship_samples_on_the_slot_path():
    """``expert_axis`` through build_flagship: one process samples through
    K4's route and the slot buffers (K6's plain version here, b2 inside)
    what the grouped path (K1's) samples without it."""
    from motioncraft_tpu_torch.apis import build_flagship
    from motioncraft_tpu_torch.apis import tiny_t2m_cfg as torch_tiny_cfg
    from motioncraft_tpu_torch.models import moe
    from motioncraft_tpu_torch.utils.convert import fabricate_state_dict

    archs = [build_flagship(torch_tiny_cfg(), device="cpu", expert_axis=axis).eval()
             for axis in ("expert", None)]
    sd = fabricate_state_dict(archs[1].model, seed=4)
    batch = make_text_batch(["a person walks forward", "someone waves"], max_seq_len=T,
                            lengths=np.array([[16], [9]], np.int32))
    calls = []
    ffn = moe.fused_expert_ffn
    moe.fused_expert_ffn = lambda *a: calls.append(1) or ffn(*a)
    try:
        outs = []
        for arch in archs:
            arch.model.load_state_dict(sd, strict=True)
            outs.append(arch.sample(batch, generator=torch.Generator().manual_seed(2)))
    finally:
        moe.fused_expert_ffn = ffn
    assert calls and archs[0].model.block_0.ca_block.motion_moe.model.expert_axis == "expert"
    torch.testing.assert_close(outs[0], outs[1], rtol=0,
                               atol=1e-5 * max(1.0, float(outs[1].abs().max())))
