"""Data-parallel training of the port against the JAX package's sharded step,
on the CPU.

The JAX side is ``jax.jit(make_train_step)`` on a 2-device ``("data",)``
mesh (``create_mesh(2, axes=("data",))``; plain ``create_mesh(2)`` would put
both devices on ``expert`` and shard nothing) with the batch sharded on
``data``: it computes what one device computes on the global batch.  The
port side is 2 gloo ranks spawned by ``parallel/mesh.py:launch``
(tests/torch_dist_ranks.py; one launch runs every case), each on its rows
of the same global batch with JAX's draws (t, noise, cond_type; gate noise
0, the frameworks' draws differ) in the mesh's layout.  One SGD step
(momentum 0, lr 1) on each side, so the update is the gradient.

- The tiny flagship (``tiny_t2m_cfg``, B = 4; the flax tree's structure
  taken from the port's model, seeded values): in f32 with
  ``grad_accum=2`` (each microbatch routed over its own 2 global rows, one
  from each rank) and a skewed gate (expert 0's logit raised by 3 on both
  sides, flax by an interceptor, the port by a hook), so that the
  capacity drops tokens of both ranks; and in bf16 (``fp16``), the port's gates fed the
  JAX step's logits (as tests/test_torch_train_bf16.py does: the text
  path's bf16 rounding moves near-tied picks).  The loss terms within 1e-5
  x max(1, |JAX|), each update within 1e-4 of its tensor's scale (bf16:
  1e-3), the frozen CLIP unmoved; the timesteps the loss-aware sampler
  gets come back in the global order.
- The same 2-rank steps, and one with a balanced gate, against the port's
  one-process step at the global batch (tests/torch_dist_ranks.py:
  train_case without a mesh): the loss within 1e-6 and the updates within
  1e-5 of scale (the ranks' sums run in another order; in bf16 the limits
  above: each side rounds its gradients to bf16 once, the ranks their
  halves), K4's positions over the global token list bit for bit, and the
  two ranks' weights equal bit for bit.  On the skewed case the capacity
  keeps and drops choices of both ranks' tokens.  float16 (``fp16`` with
  loss scale 8, against one process only; its step against JAX's is
  tests/test_torch_train_f16.py's) the same way at bf16's limits: the
  gradients reach the f32 masters widened, and the all-reduce is f32.
- The tiny S2G ControlNet (configs/tests/tiny_s2g.py, B = 4 with the
  audio condition): loss, updates, and the WavEncoder's BatchNorm running
  statistics against flax's returned ``batch_stats`` of the global batch
  (the JAX train step drops them: ROADMAP queue 3); the ranks' statistics
  equal.
"""

import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import motioncraft_tpu.models  # noqa: F401  (registers the flax classes)
import torch_dist_ranks as ranks
from motioncraft_tpu.apis.factory import make_text_batch, tiny_t2m_cfg
from motioncraft_tpu.apis.train import make_train_step as jax_make_train_step
from motioncraft_tpu.config import Config as JaxConfig
from motioncraft_tpu.models.moe import CosineTopGate as JaxGate
from motioncraft_tpu.parallel import create_train_state
from motioncraft_tpu.parallel.mesh import batch_sharding, replicated
from motioncraft_tpu.parallel.mesh import create_mesh as jax_create_mesh
from motioncraft_tpu.registry import build_architecture as build_jax
from motioncraft_tpu_torch.config import Config
from motioncraft_tpu_torch.parallel.mesh import launch
from motioncraft_tpu_torch.registry import build_architecture as build_torch
from motioncraft_tpu_torch.utils.convert import (from_jax_params, from_jax_variables,
                                                 to_jax_params, to_jax_variables)
from test_torch_controlnet_train import speech_audio, with_gate_noise_0
from test_torch_quant import _as_jax_picks
from test_torch_train import jax_draws
from torch_port_util import assert_close_scaled, seeded_batch_stats, seeded_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
S2G = os.path.join(REPO, "configs", "tests", "tiny_s2g.py")
REL, GRAD_REL, GRAD_REL_BF16 = 1e-5, 1e-4, 1e-3
SAME_REL, SAME_GRAD_REL = 1e-6, 1e-5
LR, B, T = 1.0, 4, 16
BF16 = dict(dtype="bfloat16")
F16 = dict(dtype="float16", loss_scale=8.0)
# the cases held against JAX; "f32" (a balanced gate, one microbatch) only
# against one process
CASES = {"f32": dict(key=11, jax=False), "accum_skewed": dict(key=13, grad_accum=2, skew=True),
         "bf16": dict(key=14, fp16=BF16), "f16": dict(key=15, fp16=F16, jax=False)}
JAX_CASES = [n for n, c in CASES.items() if c.get("jax", True)]
CLIP, S2G_CLIP = ("text_enc/clip",), ("base_model/text_enc/clip",)


def _numeric(batch):
    return {k: v for k, v in batch.items() if isinstance(v, np.ndarray)}


def _interceptor(skew, record):
    """flax: expert 0's gate logit raised by ranks.SKEW; each gate call's
    logits sent to ``record`` {gate path: [logits]}."""
    def fn(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        if isinstance(context.module, JaxGate) and context.method_name == "__call__":
            if skew:
                out = out + ranks.SKEW * jax.nn.one_hot(0, out.shape[1], dtype=out.dtype)
            if record is not None:
                name = ".".join(context.module.path)
                jax.debug.callback(lambda a, name=name: record.setdefault(name, []).append(
                    np.asarray(a)), out)
        return out
    return fn


def jax_sharded_step(arch_j, params, batch, key, frozen, grad_accum=1, fp16=None, skew=False,
                     record=None, extra_variables=None, also=None):
    """JAX's train step on a 2-device data mesh, the batch sharded on
    ``data``: (updated params, logs), and ``also(batch)`` computed in the
    same jit when given."""
    mesh = jax_create_mesh(2, axes=("data",))
    state = create_train_state(jax.tree_util.tree_map(jnp.asarray, params),
                               {"type": "SGD", "lr": LR, "momentum": 0.0}, None, None,
                               frozen, extra_variables=extra_variables)
    base = jax_make_train_step(arch_j, fp16=fp16, grad_accum=grad_accum)

    def step(s, b, r):
        with fnn.intercept_methods(_interceptor(skew, record)):
            return base(s, b, r), (None if also is None else also(b))

    fn = jax.jit(step, in_shardings=(replicated(mesh), batch_sharding(mesh), replicated(mesh)),
                 out_shardings=replicated(mesh))
    with jax.set_mesh(mesh):
        (state, logs), extra = jax.device_get(fn(state, _numeric(batch), key))
    return (state.params, logs) if also is None else (state.params, logs, extra)


def global_draws(arch_j, batch, key, grad_accum):
    """JAX's draws of t, noise and cond_type for the global batch, as its
    step takes them (microbatch i from split(key, N)[i])."""
    if grad_accum == 1:
        return jax_draws(arch_j, batch, key)
    m = B // grad_accum
    parts = [jax_draws(arch_j, {k: v[i * m:(i + 1) * m] for k, v in _numeric(batch).items()}, r)
             for i, r in enumerate(jax.random.split(key, grad_accum))]
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


def _updates(after, before):
    return {k: (after[k] - before[k]) / LR for k in after}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case's JAX step, the port's 2 ranks (one launch) and the port's
    one-process step."""
    cfg = tiny_t2m_cfg()
    cfg["model"]["ca_block_cfg"]["gate_noise"] = 0.0
    arch_j = build_jax(cfg)
    rng = np.random.RandomState(5)
    batch = make_text_batch(["a person walks forward", "someone waves hello",
                             "a man jumps twice", "she turns around slowly"],
                            max_seq_len=T, motion=rng.randn(B, T, 322).astype(np.float32),
                            lengths=np.array([[16], [11], [9], [14]], np.int32))
    # the flax tree's structure from the port's model (no JAX init to trace)
    params = seeded_params(to_jax_params(build_torch(cfg, device="cpu").model.state_dict()), 1)
    sd = {k: v.numpy() for k, v in from_jax_params(params).items()}
    cases, want = {}, {}
    for name, c in CASES.items():
        key, ga = jax.random.PRNGKey(c["key"]), c.get("grad_accum", 1)
        record = {} if c.get("fp16") and name in JAX_CASES else None
        if name in JAX_CASES:
            p1, logs = jax_sharded_step(arch_j, params, batch, key, CLIP, grad_accum=ga,
                                        fp16=c.get("fp16"), skew=c.get("skew", False),
                                        record=record)
            want[name] = (from_jax_params(p1), logs)
        cases[name] = dict(cfg=cfg, sd=sd, batch=_numeric(batch), lr=LR, grad_accum=ga,
                           draws=global_draws(arch_j, batch, key, ga), fp16=c.get("fp16"),
                           skew=c.get("skew", False),
                           pins=None if record is None else
                           {n: [_as_jax_picks(a) for a in v] for n, v in record.items()})
    s2g_case, s2g_want = s2g_setup()
    cases["s2g"], want["s2g"] = s2g_case, s2g_want
    rendezvous = tmp_path_factory.mktemp("dist") / "rendezvous"
    got = launch(ranks.train_rank, 2, args=(cases,), backend="gloo",
                 init_method=f"file://{rendezvous}", timeout_s=240, group_timeout_s=60)
    with ranks.one_thread():
        one = {name: ranks.train_case(case) for name, case in cases.items()}
    return {"cases": cases, "want": want, "got": got, "one": one, "sd": sd}


def s2g_setup():
    arch_j = build_jax(with_gate_noise_0(JaxConfig.fromfile(S2G).model))
    rng = np.random.RandomState(5)
    batch = make_text_batch(["a person is doing a speech", "someone talks",
                             "a speech about gestures", "hello world"],
                            max_seq_len=T, motion=rng.randn(B, T, 322).astype(np.float32),
                            lengths=np.array([[16], [11], [16], [7]], np.int32))
    batch["c"] = speech_audio(6, B)
    cfg = with_gate_noise_0(Config.fromfile(S2G).model)
    init = to_jax_variables(build_torch(cfg, device="cpu").model.state_dict())
    variables = {"params": seeded_params(init["params"], 1),
                 "batch_stats": seeded_batch_stats(init["batch_stats"], 2)}
    key = jax.random.PRNGKey(21)
    # the step and, for the global batch's condition, the running statistics
    # that flax returns (the JAX step drops them)
    p1, logs, moved = jax_sharded_step(
        arch_j, variables["params"], batch, key, S2G_CLIP,
        extra_variables={"batch_stats": variables["batch_stats"]},
        also=lambda b: arch_j.model.apply(variables, b["c"], T, method="encode_condition",
                                          train=True, mutable=["batch_stats"])[1])
    stats = from_jax_variables({"params": p1, **moved})
    case = dict(cfg=cfg, sd={k: v.numpy() for k, v in from_jax_variables(variables).items()},
                batch=_numeric(batch), lr=LR, draws=jax_draws(arch_j, batch, key),
                frozen=S2G_CLIP)
    return case, (stats, logs)


def _check_against_jax(got, want_params, logs_j, sd, grad_rel):
    for key in ("loss", "recon_loss", "moe_route_loss"):
        assert_close_scaled(got["logs"][key], logs_j[key], REL, key)
    np.testing.assert_array_equal(got["timesteps"], np.asarray(logs_j["_timesteps"]))
    upd = _updates(got["sd"], sd)
    want = _updates({k: v.numpy() for k, v in want_params.items()}, sd)
    moved = 0
    for name, w in want.items():
        if ".clip." in name or name.startswith("text_enc.clip."):
            assert not np.any(upd[name]) and not np.any(w), name
            continue
        assert_close_scaled(upd[name], w, grad_rel, name)
        moved += bool(np.any(w))
    assert moved > len(want) // 2


@pytest.mark.parametrize("name", JAX_CASES)
def test_two_ranks_against_jax_sharded_step(runs, name):
    want_params, logs_j = runs["want"][name]
    for got in runs["got"]:
        _check_against_jax(got[name], want_params, logs_j, runs["sd"],
                           GRAD_REL_BF16 if name == "bf16" else GRAD_REL)


@pytest.mark.parametrize("name", list(CASES) + ["s2g"])
def test_two_ranks_against_one_process(runs, name):
    (r0, r1), one = (g[name] for g in runs["got"]), runs["one"][name]
    for k in r0["sd"]:
        np.testing.assert_array_equal(r0["sd"][k], r1["sd"][k], err_msg=k)
    assert r0["logs"] == r1["logs"]
    # bf16: each side rounds its gradients to bf16 once, the ranks their
    # halves and one process the whole
    rel, grad_rel = ((REL, GRAD_REL_BF16) if name in ("bf16", "f16") else
                     (SAME_REL, SAME_GRAD_REL))
    for key, v in one["logs"].items():
        assert_close_scaled(r0["logs"][key], v, rel, key)
    np.testing.assert_array_equal(r0["timesteps"], one["timesteps"])
    assert_close_scaled(r0["loss_batch"], one["loss_batch"], rel, "loss_batch")
    assert len(r0["positions"]) == len(one["positions"]) > 0
    for a, b in zip(r0["positions"], one["positions"]):
        np.testing.assert_array_equal(a, b)
    base = runs["cases"][name]["sd"]
    upd, want = _updates(r0["sd"], base), _updates(one["sd"], base)
    for k in want:
        assert_close_scaled(upd[k], want[k], grad_rel, k)


def test_skewed_gate_drops_across_ranks(runs):
    """On the skewed case a microbatch's capacity drops choices of both
    ranks' tokens and keeps choices of both: the ranks compete for the same
    slots, which per-rank routing would not see."""
    got = runs["got"][0]["accum_skewed"]
    E = runs["cases"]["accum_skewed"]["cfg"]["model"]["ca_block_cfg"]["num_experts"]
    both = 0
    for packed, pos_flat in zip(got["gathered"], got["positions"]):
        NG, K = packed.shape[0], packed.shape[1] - 1
        cap = max(1, min(K * int(1.5 * -(-NG // E)), NG))
        order = np.argsort(-packed[:, 0], kind="stable")
        pos = np.empty((NG, K), np.int64)
        pos[order] = pos_flat.reshape(K, NG).T
        rank_of = np.arange(NG) // (NG // 2)
        kept, dropped = (pos < cap).any(1), (pos >= cap).any(1)
        both += (set(rank_of[kept]) == {0, 1}) and (set(rank_of[dropped]) == {0, 1})
    assert both > 0


def test_s2g_controlnet_two_ranks_against_jax(runs):
    stats, logs_j = runs["want"]["s2g"]
    sd = runs["cases"]["s2g"]["sd"]
    bn = [k for k in stats if k.endswith(("running_mean", "running_var"))]
    assert len(bn) == 32
    want = _updates({k: v.numpy() for k, v in stats.items() if k not in bn}, sd)
    for got in runs["got"]:
        g = got["s2g"]
        for key in ("loss", "recon_loss", "moe_route_loss"):
            assert_close_scaled(g["logs"][key], logs_j[key], REL, key)
        for k in bn:
            assert not np.array_equal(stats[k].numpy(), sd[k]), k
            assert_close_scaled(g["sd"][k], stats[k].numpy(), REL, k)
        upd = _updates({k: g["sd"][k] for k in want}, sd)
        for k, w in want.items():
            assert_close_scaled(upd[k], w, GRAD_REL, k)
    for k in bn:
        np.testing.assert_array_equal(runs["got"][0]["s2g"]["sd"][k],
                                      runs["got"][1]["s2g"]["sd"][k])
