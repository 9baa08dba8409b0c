"""Pipeline parallelism of the port (parallel/pp.py, the pipelined
STMoGenTransformer) against the JAX package's GPipe and against the port's
one process, on the CPU.

The port side is gloo ranks spawned by ``parallel/mesh.py:launch``
(tests/torch_pipe_ranks.py; one launch of 2 ranks and one of 4 run every
case), one process a stage.  The JAX side is ``jax.jit`` on the CPU's
virtual devices under ``create_mesh(n, axes=("data", "pipe"), shape=...)``,
the stacked weights placed by ``tree_shardings``.  Gate noise is 0 on both
sides (the frameworks' draws differ) and the gates are skewed towards expert
0 (tests/torch_dist_ranks.py), so that each microbatch's capacity drops
choices.

- ``gpipe`` on the JAX package's toy layer: forward, aux and gradients at 2
  stages (data 1 x pipe 2) and 4 (data 1 x pipe 4) against JAX's at
  (4, 2) and (2, 4), 1e-6 / 1e-5 as tests/test_pipeline_parallel.py holds
  it against the sequential stack.
- The tiny flagship (``tiny_t2m_cfg``, 2 layers, M = 2) on data 1 x pipe 2
  and data 2 x pipe 2: the training forward and its aux loss against JAX's
  ``piped.model.apply`` (1e-5), one SGD step (lr 1) on the first and one
  Adam step on the second against JAX's ``make_train_step`` on the same
  mesh at PR 18-19's bounds, every leaf (the replicated ones outside the
  stack too); the CFG-doubled test forward on both.  Against the
  port's one process with the pipelined config at data x M microbatches
  (the same microbatch groups): also a clipped SGD step (the clip binds),
  an Adafactor step and a bf16 step of 2 accumulated microbatches.
- Each rank holds its stage's layers alone: their parameters, gradients and
  Adam moments are 1 / S of one process's bytes, as JAX's shards of the
  stacked leaves are.
- The block layouts: ``stack_block_params`` / ``unstack_block_params`` /
  ``align_block_layout`` against the JAX package's, both ways; a JAX
  pipelined snapshot evaluates in the port's plain model, and the port's
  pipelined snapshot in the JAX package's.
"""

import copy

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import motioncraft_tpu.models  # noqa: F401  (registers the flax classes)
import torch_pipe_ranks as ranks
from motioncraft_tpu.apis.factory import make_text_batch, tiny_t2m_cfg
from motioncraft_tpu.apis.train import make_train_step as jax_make_train_step
from motioncraft_tpu.parallel import create_train_state, tree_shardings
from motioncraft_tpu.parallel import stack_block_params as jax_stack
from motioncraft_tpu.parallel import unstack_block_params as jax_unstack
from motioncraft_tpu.parallel.mesh import batch_sharding, replicated
from motioncraft_tpu.parallel.mesh import create_mesh as jax_create_mesh
from motioncraft_tpu.parallel.pp import gpipe as jax_gpipe
from motioncraft_tpu.registry import build_architecture as build_jax
from motioncraft_tpu.utils import checkpoint as jax_ckpt
from motioncraft_tpu_torch.parallel import pp
from motioncraft_tpu_torch.parallel.mesh import launch
from motioncraft_tpu_torch.registry import build_architecture as build_torch
from motioncraft_tpu_torch.utils import checkpoint
from motioncraft_tpu_torch.utils.convert import from_jax_params, to_jax_params
from test_torch_dist_train import _interceptor, _numeric, global_draws
from torch_port_util import assert_close_scaled, seeded_params

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs the 8-device virtual CPU mesh")

B, T, M = 8, 16, 2
CLIP = ("text_enc/clip",)
D1P2 = (("data", "pipe"), (1, 2))
D2P2 = (("data", "pipe"), (2, 2))
SGD = {"type": "SGD", "lr": 1.0, "momentum": 0.0}
ADAM = {"type": "Adam", "lr": 2e-4}


def _toy():
    """The JAX package's toy stack: W [4, 16, 16], b [4, 16], x [8, 5, 16],
    c [8, 16] (tests/test_pipeline_parallel.py's draws)."""
    k = jax.random.PRNGKey(0)
    return {"W": np.asarray(jax.random.normal(k, (4, 16, 16)) * 0.3),
            "b": np.asarray(jax.random.normal(jax.random.fold_in(k, 1), (4, 16)) * 0.1),
            "x": np.asarray(jax.random.normal(jax.random.fold_in(k, 2), (8, 5, 16))),
            "c": np.asarray(jax.random.normal(jax.random.fold_in(k, 3), (8, 16)))}


def _toy_layer(p, xmb, cmb):
    w, b = p
    y = jnp.tanh(xmb @ w + b + cmb[:, None, :])
    return y, {"aux_loss": jnp.mean(y)}


def jax_toy(toy, shape, n_mb):
    """JAX's gpipe on ``shape`` (data, pipe): output, aux and the gradients
    of sum(out ** 2)."""
    W, b, x, c = (jnp.asarray(toy[k]) for k in ("W", "b", "x", "c"))
    mesh = jax_create_mesh(8, axes=("data", "pipe"), shape=shape)

    def run(W, b):
        return jax_gpipe(_toy_layer, (W, b), x, c, n_microbatch=n_mb)

    with jax.set_mesh(mesh):
        (out, aux), grads = jax.jit(lambda W, b: (run(W, b), jax.grad(
            lambda W, b: jnp.sum(run(W, b)[0] ** 2), argnums=(0, 1))(W, b)))(W, b)
    return jax.device_get((out, aux["aux_loss"], grads))


def _cfg(n_mb=None):
    """The tiny flagship, gate noise 0; pipelined at ``n_mb`` microbatches."""
    cfg = tiny_t2m_cfg()
    cfg["model"]["ca_block_cfg"]["gate_noise"] = 0.0
    if n_mb is not None:
        cfg["model"]["pipeline_axis"] = "pipe"
        cfg["model"]["pipeline_microbatches"] = n_mb
    return cfg


def _batch():
    rng = np.random.RandomState(5)
    texts = ["a person walks forward", "someone waves hello", "a man jumps twice",
             "she turns around slowly", "he kicks with the left leg", "a dancer spins",
             "someone sits down", "a person raises both arms"]
    lengths = np.array([[16], [11], [9], [14], [16], [7], [12], [15]], np.int32)
    return make_text_batch(texts, max_seq_len=T, motion=rng.randn(B, T, 322).astype(np.float32),
                           lengths=lengths)


def _sum_aux(losses):
    """The aux_loss-named leaves of the sown losses (what the architecture
    collects)."""
    return sum(jnp.asarray(leaf, jnp.float32)
               for path, leaf in jax.tree_util.tree_leaves_with_path(losses)
               if any(getattr(k, "key", None) == "aux_loss" for k in path))


def jax_pipelined(piped, stacked, batch, key, shape, optimizer, inp, test):
    """In one jit on the (data, pipe) mesh of ``shape``, the gates skewed:
    JAX's train step of the pipelined model (updated params, logs) and its
    training forward (output, aux) and, with ``test``, its CFG test forward
    on ``inp``."""
    mesh = jax_create_mesh(int(np.prod(shape)), axes=("data", "pipe"), shape=shape)
    params = jax.tree_util.tree_map(jnp.asarray, stacked)
    state = create_train_state(params, optimizer, None, None, CLIP)
    base = jax_make_train_step(piped)

    def fn(s, b, r, p, i):
        with fnn.intercept_methods(_interceptor(True, None)):
            new, logs = base(s, b, r)
            xf = piped.encode_text({"params": p}, i["text_ids"])
            kw = dict(motion_mask=i["motion_mask"], motion_length=i["motion_length"], xf_out=xf)
            y, st = piped.model.apply({"params": p}, i["motion"], i["t"], cond_type=i["cond_type"],
                                      mode="train", train=True, mutable=["losses"], **kw)
            res = {"train": y, "aux": _sum_aux(st["losses"])}
            if test:
                res["test"] = piped.model.apply({"params": p}, i["motion"], i["t_test"],
                                                mode="test", **kw)
        return new, logs, res

    sh = tree_shardings(state, mesh)
    jitted = jax.jit(fn, in_shardings=(sh, batch_sharding(mesh), replicated(mesh),
                                       tree_shardings(params, mesh), batch_sharding(mesh)),
                     out_shardings=(sh, replicated(mesh), replicated(mesh)))
    with jax.set_mesh(mesh):
        new, logs, res = jax.device_get(jitted(state, _numeric(batch), key, params, inp))
    return jax_unstack(dict(new.params)), logs, res


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX references, the port's ranks (a 2-rank and a 4-rank launch)
    and the port's one-process runs."""
    toy = _toy()
    plain = _cfg()
    params = seeded_params(to_jax_params(build_torch(plain, device="cpu").model.state_dict()), 1)
    sd = {k: v.numpy() for k, v in from_jax_params(params).items()}
    stacked = jax_stack(dict(params), plain["model"]["num_layers"])
    batch = _batch()
    key = jax.random.PRNGKey(17)
    piped = build_jax(_cfg(M))
    draws = global_draws(piped, batch, key, 1)
    rng = np.random.RandomState(7)
    inp = {"motion": rng.randn(B, T, 322).astype(np.float32),
           "t": rng.randint(0, 1000, (B,)).astype(np.int32),
           "cond_type": rng.randint(0, 100, (B, 1, 1)).astype(np.int32),
           # a sampling step's one timestep: the CFG mix reads the first row's
           "t_test": np.full((B,), 637, np.int32),
           **{k: batch[k] for k in ("motion_mask", "motion_length", "text_ids")}}
    want = {"toy2": jax_toy(toy, (4, 2), 2), "toy4": jax_toy(toy, (2, 4), 4),
            "d1p2": jax_pipelined(piped, stacked, batch, key, D1P2[1], SGD, inp, True),
            "d2p2": jax_pipelined(piped, stacked, batch, key, D2P2[1], ADAM, inp, True)}
    # the one process runs the microbatch groups of data x M
    step = dict(cfg=_cfg(M), sd=sd, batch=_numeric(batch), draws=draws, skew=True)
    fwd = dict(cfg=_cfg(M), sd=sd, inputs={**inp, **{k: inp[k].astype(np.int64) for k in (
        "t", "t_test", "cond_type")}}, skew=True)
    two = {"toy2": ("toy", dict(toy, M=2, axes=D1P2[0], shape=D1P2[1])),
           "fwd2": ("forward", dict(fwd, axes=D1P2[0], shape=D1P2[1])),
           "sgd": ("step", dict(step, optimizer=SGD, axes=D1P2[0], shape=D1P2[1])),
           "adafactor": ("step", dict(step, optimizer={"type": "Adafactor", "lr": 1e-2},
                                      axes=D1P2[0], shape=D1P2[1])),
           "accum_bf16": ("step", dict(step, optimizer=SGD, grad_accum=2,
                                       fp16={"dtype": "bfloat16"}, axes=D1P2[0],
                                       shape=D1P2[1]))}
    four = {"toy4": ("toy", dict(toy, M=4, axes=("data", "pipe"), shape=(1, 4))),
            "fwd4": ("forward", dict(fwd, axes=D2P2[0], shape=D2P2[1])),
            "adam": ("step", dict(step, one_cfg=_cfg(2 * M), optimizer=ADAM, axes=D2P2[0],
                                  shape=D2P2[1])),
            "clip": ("step", dict(step, one_cfg=_cfg(2 * M), optimizer=SGD,
                                  grad_clip={"max_norm": 1e-3}, axes=D2P2[0],
                                  shape=D2P2[1]))}
    root = tmp_path_factory.mktemp("pp")
    got2 = launch(ranks.pipe_rank, 2, args=(two,), backend="gloo",
                  init_method=f"file://{root / 'rv2'}", timeout_s=240, group_timeout_s=90)
    got4 = launch(ranks.pipe_rank, 4, args=(four,), backend="gloo",
                  init_method=f"file://{root / 'rv4'}", timeout_s=300, group_timeout_s=90)
    one = ranks.one_process({k: v for k, v in {**two, **four}.items()
                             if not k.startswith("toy")
                             and k != "fwd4"} | {"fwd4_one": ("forward", dict(
                                 fwd, cfg=_cfg(2 * M), test=False))})
    return {"want": want, "two": got2, "four": got4, "one": one, "sd": sd,
            "params": params, "stacked": stacked, "toy": toy}


@pytest.mark.parametrize("stages", [2, 4])
def test_gpipe_against_jax(runs, stages):
    out_j, aux_j, (gW_j, gb_j) = runs["want"][f"toy{stages}"]
    got = runs["two" if stages == 2 else "four"]
    L = len(runs["toy"]["W"])
    assert [r[f"toy{stages}"]["layers"] for r in got] == [
        list(range(s * L // stages, (s + 1) * L // stages)) for s in range(stages)]
    for r in got:
        g = r[f"toy{stages}"]
        assert np.abs(g["out"] - np.asarray(out_j)).max() < 1e-6
        assert abs(g["aux"] - float(aux_j)) < 1e-6
        for mine, theirs in ((g["gW"], gW_j), (g["gb"], gb_j)):
            ref = np.asarray(theirs)[g["layers"]]
            assert np.abs(mine - ref).max() / max(1.0, np.abs(ref).max()) < 1e-5


@pytest.mark.parametrize("mesh", ["d1p2", "d2p2"])
def test_training_forward_against_jax(runs, mesh):
    """The pipelined training forward's output and its aux loss (the mean
    over microbatch groups of the per-group layer sums) against JAX's on
    the same mesh, and against one process at data x M microbatches."""
    res_j = runs["want"][mesh][2]
    name = "fwd2" if mesh == "d1p2" else "fwd4"
    got = runs["two" if mesh == "d1p2" else "four"]
    one = runs["one"][name if mesh == "d1p2" else "fwd4_one"]
    for r in got:
        g = r[name]
        assert_close_scaled(g["train"], np.asarray(res_j["train"]), 1e-5, "train")
        assert_close_scaled(g["aux"], float(res_j["aux"]), 1e-5, "aux")
        assert_close_scaled(g["train"], one["train"], 1e-6, "one train")
        assert_close_scaled(g["aux"], one["aux"], 1e-6, "one aux")


@pytest.mark.parametrize("mesh", ["d1p2", "d2p2"])
def test_forward_test_cfg_against_jax(runs, mesh):
    """The CFG-doubled test forward (its microbatches split the doubled
    batch: on data 2, the global doubled batch split over data as JAX's
    shard_map takes it) against JAX's pipelined one on the same mesh; on
    data 1 against one process too."""
    want = np.asarray(runs["want"][mesh][2]["test"])
    assert want.shape == (B, T, 322)
    name = "fwd2" if mesh == "d1p2" else "fwd4"
    for r in runs["two" if mesh == "d1p2" else "four"]:
        assert_close_scaled(r[name]["test"], want, 1e-5, "test")
    if mesh == "d1p2":
        assert_close_scaled(runs["two"][0]["fwd2"]["test"], runs["one"]["fwd2"]["test"], 1e-6,
                            "one test")


def _updates(after, before, lr):
    return {k: (after[k] - before[k]) / lr for k in after}


def test_sgd_step_against_jax(runs):
    """SGD (lr 1: the update is the gradient) on data 1 x pipe 2: the loss
    terms within 1e-5 and every leaf's update within 1e-4 of scale of
    JAX's (PR 18-19's bounds), the layers and the replicated leaves
    (text encoder, time embedding, joint embedding, output decoder) alike;
    the same step as one process."""
    params_j, logs_j, _ = runs["want"]["d1p2"]
    want = _updates({k: v.numpy() for k, v in from_jax_params(params_j).items()}, runs["sd"], 1)
    one = runs["one"]["sgd"]
    g = runs["two"][0]["sgd"]
    for key in ("loss", "recon_loss", "moe_route_loss"):
        for r in runs["two"]:
            assert_close_scaled(r["sgd"]["logs"][key], logs_j[key], 1e-5, key)
        assert_close_scaled(g["logs"][key], one["logs"][key], 1e-6, key)
    assert set(g["sd"]) == set(runs["sd"])
    upd, upd_one = _updates(g["sd"], runs["sd"], 1), _updates(one["sd"], runs["sd"], 1)
    for prefix in ("text_enc.", "time_embed.", "joint_embed.", "out.", "block_0.", "block_1."):
        assert any(k.startswith(prefix) and np.abs(w).max() > 0 for k, w in want.items())
    for k, w in want.items():
        assert_close_scaled(upd[k], w, 1e-4, k)
        assert_close_scaled(upd[k], upd_one[k], 1e-5, k)


def test_adam_step_against_jax(runs):
    """Adam on data 2 x pipe 2: the loss within 1e-5 relative and the params
    within 5e-5 of JAX's (tests/test_tensor_parallel.py's bounds) and of one
    process at 4 microbatches."""
    params_j, logs_j, _ = runs["want"]["d2p2"]
    want = {k: v.numpy() for k, v in from_jax_params(params_j).items()}
    one = runs["one"]["adam"]
    loss_j = float(logs_j["loss"])
    for r in runs["four"]:
        assert abs(r["adam"]["logs"]["loss"] - loss_j) < 1e-5 * max(1.0, abs(loss_j))
    g = runs["four"][0]["adam"]
    for k, w in want.items():
        assert np.abs(g["sd"][k] - w).max() < 5e-5, k
        assert np.abs(g["sd"][k] - one["sd"][k]).max() < 5e-5, k


def _without_key_bias(name, a):
    """``a`` without the key third of an attention's in_proj bias, whose
    gradient is 0 in exact arithmetic (the softmax does not see it): its
    rounding noise, summed in another order over the stages, Adafactor
    scales to a full step of either sign."""
    return a[:len(a) // 3].tolist() + a[2 * len(a) // 3:].tolist() if (
        name.endswith("in_proj.bias")) else a


@pytest.mark.parametrize("name", ["clip", "adafactor"])
def test_clip_and_per_leaf_optimizer_against_one_process(runs, name):
    """The clip's global norm sums each stage's layers once and the
    replicated leaves once (it binds: max_norm 1e-3), and Adafactor's
    per-leaf statistics are whole on a stage: the step of one process."""
    one = runs["one"][name]
    g = runs["four" if name == "clip" else "two"][0][name]
    assert_close_scaled(g["logs"]["loss"], one["logs"]["loss"], 1e-6, "loss")
    if name == "clip":
        upd, want = _updates(g["sd"], runs["sd"], 1), _updates(one["sd"], runs["sd"], 1)
        norm = np.sqrt(sum(np.square(w).sum() for w in want.values()))
        assert abs(norm - 1e-3) < 1e-6
        for k, w in want.items():
            assert_close_scaled(upd[k], w, 1e-4, k)
    else:
        for k, w in one["sd"].items():
            assert_close_scaled(_without_key_bias(k, g["sd"][k]), _without_key_bias(k, w),
                                1e-5, k)


def test_grad_accum_and_bf16_against_one_process(runs):
    """--grad-accum 2 with the config's fp16 (bf16 through K6's bf16
    instantiation) on data 1 x pipe 2: each of the 2 accumulated
    microbatches pipelined in 2, against one process running the same
    groups: the loss terms and every SGD update within 1e-6 / 1e-5 of
    scale.  The stages sum the consts' gradients in f32 onto stage 0,
    which runs the text tower's bf16 backward once, as one process does."""
    one = runs["one"]["accum_bf16"]
    for r in runs["two"]:
        for key in ("loss", "recon_loss", "moe_route_loss"):
            assert_close_scaled(r["accum_bf16"]["logs"][key], one["logs"][key], 1e-6, key)
    upd = _updates(runs["two"][0]["accum_bf16"]["sd"], runs["sd"], 1)
    for k, w in _updates(one["sd"], runs["sd"], 1).items():
        assert_close_scaled(upd[k], w, 1e-5, k)


def test_each_stage_holds_its_layers_alone(runs):
    """Stage s holds layer s alone: its layers' parameters, gradients and
    Adam moments are half one process's bytes, as JAX's shards of the
    stacked leaves over pipe 2 are half the leaf (the counterpart of
    tests/test_pipeline_parallel.py's test_stacked_params_shard_over_pipe);
    the replicated leaves are whole on every stage."""
    mesh = jax_create_mesh(4, axes=("data", "pipe"), shape=D2P2[1])
    placed = jax.device_put(runs["stacked"], tree_shardings(runs["stacked"], mesh))
    for leaf in jax.tree_util.tree_leaves(placed["stacked_blocks"]):
        assert leaf.sharding.spec[0] == "pipe"
        assert max(s.data.nbytes for s in leaf.addressable_shards) * 2 == leaf.nbytes
    one = runs["one"]["adam"]
    for r, res in enumerate(runs["four"]):
        g = res["adam"]
        assert g["layers"] == [r % 2]
        for kind in ("param_bytes", "grad_bytes", "opt_bytes"):
            assert g[kind]["block"] * 2 == one[kind]["block"] > 0, kind
            assert g[kind]["rest"] == one[kind]["rest"], kind


def test_block_layouts_against_jax():
    """stack / unstack and align_block_layout, both ways, give the JAX
    package's trees leaf for leaf; the state_dict versions round-trip."""
    cfg = _cfg()
    model = build_torch(cfg, device="cpu").model
    params = seeded_params(to_jax_params(model.state_dict()), 2)
    L = cfg["model"]["num_layers"]
    stacked = pp.stack_block_params(dict(params), L)
    eq = lambda a, b: jax.tree_util.tree_map(np.testing.assert_array_equal, a, b)  # noqa: E731
    eq(stacked, jax.device_get(jax_stack(dict(params), L)))
    eq(pp.unstack_block_params(stacked), jax.device_get(jax_unstack(dict(stacked))))
    eq(pp.unstack_block_params(stacked), params)
    for model_cfg, tree in ((_cfg(M), {"params": params}), (cfg, {"params": stacked}),
                            (_cfg(M), params), (cfg, {"params": params})):
        eq(checkpoint.align_block_layout(model_cfg, tree),
           jax.device_get(jax_ckpt.align_block_layout(model_cfg, tree)))
    sd = model.state_dict()
    st = pp.stack_state_dict(sd, L)
    assert st["stacked_blocks.ffn.w1"].shape[0] == L and not any(
        k.startswith("block_") for k in st)
    back = pp.unstack_state_dict(st)
    assert set(back) == set(sd) and all(torch.equal(back[k], sd[k]) for k in sd)


def test_pipelined_snapshots_load_across_packages(tmp_path):
    """A JAX pipelined params.npz (blocks stacked) loads into the port's
    plain model (the weights it was stacked from); the port's pipelined
    model writes the stacked layout, which the JAX package's
    align_block_layout turns into its plain model's tree."""
    cfg = _cfg()
    model = build_torch(cfg, device="cpu").model
    params = seeded_params(to_jax_params(model.state_dict()), 3)
    jax_ckpt.save_params(str(tmp_path / "jax_pp.npz"),
                         {"params": jax_stack(dict(params), cfg["model"]["num_layers"])})
    sd = checkpoint.load_eval_variables(cfg, model, checkpoint=str(tmp_path / "jax_pp.npz"))
    want = from_jax_params(params)
    assert set(sd) == set(want) and all(torch.equal(sd[k], want[k]) for k in want)
    assert all(torch.equal(model.state_dict()[k], want[k]) for k in want)

    piped = build_torch(_cfg(M), device="cpu").model
    piped.load_state_dict(want, strict=True)
    checkpoint.save_params(str(tmp_path / "port_pp.npz"), piped)
    loaded = jax_ckpt.load_params(str(tmp_path / "port_pp.npz"))
    assert "stacked_blocks" in loaded["params"] and "block_0" not in loaded["params"]
    plain_tree = jax_ckpt.align_block_layout(cfg, loaded)["params"]
    assert jax.tree_util.tree_structure(plain_tree) == jax.tree_util.tree_structure(params)
    jax.tree_util.tree_map(np.testing.assert_array_equal, plain_tree, params)


def test_pipelined_model_refusals():
    """The JAX package's refusals, in its words: per-layer ffn_cfg lists,
    dropout in training, the step cache; and a pipe axis needs a
    pipelined model."""
    cfg = _cfg(M)
    bad = copy.deepcopy(cfg)
    bad["model"]["ffn_cfg"] = [bad["model"]["ffn_cfg"]] * 2
    with pytest.raises(ValueError, match="per-layer ffn_cfg lists cannot be stacked"):
        build_torch(bad, device="cpu")
    drop = copy.deepcopy(cfg)
    drop["model"]["ca_block_cfg"]["dropout"] = 0.1
    arch = build_torch(drop, device="cpu").train()
    from motioncraft_tpu_torch.apis import make_train_batch
    with pytest.raises(ValueError, match="does not thread dropout rngs"):
        arch.loss(make_train_batch(4, max_seq_len=T))
    from motioncraft_tpu_torch.diffusion.stepcache import StepCacheConfig
    arch = build_torch(cfg, device="cpu").eval()
    assert arch.model.precompute_text_feats(torch.zeros(2, 77, 16)) is None
    with pytest.raises(ValueError, match="step caching is not supported with pipeline_axis"):
        arch.sample(make_text_batch(["a person walks"], max_seq_len=T),
                    step_cache=StepCacheConfig(reuse_every=2))
