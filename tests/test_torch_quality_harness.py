"""The trained-weights quality harness of the port on the CPU, held against the
JAX package's tools:

- tools/torch_train_protocol_evaluator.py: the split and the batch picks
  are the JAX tool's sequence; the InfoNCE loss and three Adam steps equal
  the JAX modules' with optax.adam; an evaluator .npz written by either
  package gives the other's embeddings;
- tools/torch_make_calib_ckpt.py: the synthetic motion bank is the JAX
  tool's bit for bit, and a short CPU run saves a loadable snapshot;
- tools/torch_measure_approx_drift.py: sample_err is the JAX tool's, done
  modes are reused (not those measured on other inputs), and a CPU run of
  two modes writes the JAX schema with its exact mode's metrics.json equal
  to a direct tools/torch_test.py run's;
- tools/torch_soak_report.py parses a train.log that tools/torch_train.py
  wrote across a --resume;
- tools/torch_quality_run.py refuses an out dir that holds anything.
"""

import importlib.util
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from motioncraft_tpu.eval.models import ActorAgnosticEncoderModule as JaxMotion
from motioncraft_tpu.eval.models import DistilbertActorAgnosticModule as JaxText
from motioncraft_tpu.eval.models import T2MContrastiveModel_SMPLX as JaxEvaluator
from motioncraft_tpu.eval.models import _WordPieceTokenizer as JaxTokenizer
from motioncraft_tpu.utils.checkpoint import save_params as jax_save_params
from motioncraft_tpu_torch.config import Config
from motioncraft_tpu_torch.eval.models import T2MContrastiveModel_SMPLX, _WordPieceTokenizer
from motioncraft_tpu_torch.registry import build_architecture
from motioncraft_tpu_torch.utils import checkpoint
from motioncraft_tpu_torch.utils.convert import (fabricate_state_dict, from_jax_params,
                                                 to_jax_params)
from torch_port_util import seeded_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "tests", "tiny_t2m.py")
LOSS_REL, PARAM_ATOL, EMB_ATOL = 1e-5, 1e-5, 1e-5
# a gradient against JAX's, relative to the tensor's largest entry
GRAD_REL = 1e-4


def _load(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "tools",
                                                                     name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ev_tool = _load("torch_train_protocol_evaluator")
calib_tool = _load("torch_make_calib_ckpt")
drift_tool = _load("torch_measure_approx_drift")
soak_tool = _load("torch_soak_report")
VERBS = ["walks", "jumps", "waves", "dances", "kicks", "turns", "sits down", "runs"]


# ---------------------------------------------------------------- evaluator
def test_split_and_picks_follow_the_jax_tools_sequence():
    cls = np.arange(256) % 32
    seed, batch = 5, 32
    got_rng, train_idx, test_idx, by_class = ev_tool.split(cls, seed)
    got = [ev_tool.picks(got_rng, by_class, batch) for _ in range(4)]
    # tools/train_protocol_evaluator.py, line for line
    rng = np.random.RandomState(seed)
    perm = rng.permutation(len(cls))
    want_train, want_test = perm[: int(0.8 * len(cls))], perm[int(0.8 * len(cls)):]
    want_by_class = [want_train[cls[want_train] == c] for c in range(32)]
    want = [np.array([want_by_class[c][rng.randint(len(want_by_class[c]))]
                      for c in rng.permutation(32)[:batch]]) for _ in range(4)]
    np.testing.assert_array_equal(train_idx, want_train)
    np.testing.assert_array_equal(test_idx, want_test)
    for a, b in zip(by_class, want_by_class):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def jax_evaluator():
    """The tool's two flax encoders and their seeded variables."""
    key = jax.random.PRNGKey(0)
    mm, tm = JaxMotion(**ev_tool.MOTION_ENCODER), JaxText(**ev_tool.TEXT_ENCODER)
    mp = jax.jit(mm.init)(key, jnp.zeros((1, 8, 322)), jnp.full((1,), 8))
    tp = jax.jit(tm.init)(key, jnp.zeros((1, 8), jnp.int32), jnp.ones((1, 8), jnp.int32))
    mp = {"params": seeded_params(jax.tree_util.tree_map(np.asarray, mp["params"]), 1)}
    tp = {"params": seeded_params(jax.tree_util.tree_map(np.asarray, tp["params"]), 2)}
    return mm, tm, mp, tp


def _batch(B, T, seed=0):
    rng = np.random.RandomState(seed)
    motion = (rng.randn(B, T, 322) * 0.5).astype(np.float32)
    texts = [f"a person {VERBS[i % len(VERBS)]} then {VERBS[(3 * i + 1) % len(VERBS)]}"
             for i in range(B)]
    return motion, texts


def test_info_nce_and_adam_steps_match_jax(jax_evaluator):
    """Three steps: the port's loss and gradients against the JAX modules',
    then torch's Adam and optax.adam each given the JAX gradients (Adam's
    first steps turn the rounding noise of a gradient that is zero in exact
    arithmetic, such as a key bias's under the softmax, into an lr-sized
    move, so two trajectories that differ in the last bits of their
    gradients part by up to lr in those entries); and the same three steps
    of the tool's train_step against the JAX tool's step, loss for loss.
    At the tool's temperature of 10 the seeded encoders' squared distances
    spread by 0.05, their logits lie within 5e-3 of uniform and the f32
    gradients, differences of nearly equal softmax terms, keep two or three
    digits in either package; a temperature of 0.1 spreads the logits."""
    B, T, temp, lr = 8, 24, 0.1, 1e-3
    motion, texts = _batch(B, T)
    ids, mask = _WordPieceTokenizer(None)(texts)
    want_ids, want_mask = JaxTokenizer()(texts)
    np.testing.assert_array_equal(ids, want_ids)
    np.testing.assert_array_equal(mask, want_mask)
    mm, tm, mp, tp = jax_evaluator

    # tools/train_protocol_evaluator.py's loss and step
    def loss_fn(params, motion, length, ids, mask):
        mp_, tp_ = params
        m_emb, _ = mm.apply(mp_, motion, length)
        t_emb, _ = tm.apply(tp_, ids, mask)
        d2 = (jnp.sum(m_emb**2, -1)[:, None] + jnp.sum(t_emb**2, -1)[None, :]
              - 2.0 * m_emb @ t_emb.T)
        logits = -d2 / temp
        labels = jnp.arange(motion.shape[0])
        return 0.5 * (optax.softmax_cross_entropy_with_integer_labels(logits, labels).mean()
                      + optax.softmax_cross_entropy_with_integer_labels(
                          logits.T, labels).mean())

    tx = optax.adam(lr)
    grad_fn = jax.jit(jax.value_and_grad(loss_fn))

    def port_modules():
        motion_mod, text_mod = ev_tool.build_modules(0, "cpu")
        motion_mod.load_state_dict(from_jax_params(mp["params"]), strict=True)
        text_mod.load_state_dict(from_jax_params(tp["params"]), strict=True)
        return motion_mod, text_mod, ev_tool.make_optimizer(motion_mod, text_mod, lr)

    length = np.full((B,), T)
    batch = (torch.from_numpy(motion), torch.from_numpy(length), torch.from_numpy(ids).long(),
             torch.from_numpy(mask).long())
    pairs = lambda mods, params: ((mods[0], params[0]), (mods[1], params[1]))  # noqa: E731

    motion_mod, text_mod, optimizer = port_modules()
    params = (mp, tp)
    opt_state = tx.init(params)
    for _ in range(3):
        optimizer.zero_grad(set_to_none=True)
        got = ev_tool.batch_loss(motion_mod, text_mod, batch, temp)
        got.backward()
        want, grads = grad_fn(params, motion, length, ids, mask)
        assert abs(float(got) - float(want)) <= LOSS_REL * abs(float(want))
        for mod, g in pairs((motion_mod, text_mod), grads):
            g_all = from_jax_params(jax.tree_util.tree_map(np.asarray, g["params"]))
            for name, p in mod.named_parameters():
                g_want = g_all[name]
                if p.grad is None:  # the frozen DistilBERT: optax's update is 0 there
                    assert not g_want.any(), name
                    continue
                scale = float(g_want.abs().max())
                assert float((p.grad - g_want).abs().max()) <= GRAD_REL * scale, name
                p.grad = g_want.clone()
        optimizer.step()
        updates, opt_state = tx.update(grads, opt_state)
        params = optax.apply_updates(params, updates)
    for mod, tree in pairs((motion_mod, text_mod), params):
        got = dict(jax.tree_util.tree_leaves_with_path(to_jax_params(mod.state_dict())))
        for path, w in jax.tree_util.tree_leaves_with_path(
                jax.tree_util.tree_map(np.asarray, tree["params"])):
            err = float(np.abs(np.asarray(got[path]) - w).max())
            assert err <= PARAM_ATOL, (jax.tree_util.keystr(path), err)

    motion_mod, text_mod, optimizer = port_modules()
    params, opt_state = (mp, tp), tx.init((mp, tp))
    for _ in range(3):
        got = float(ev_tool.train_step(motion_mod, text_mod, optimizer, batch, temp))
        want, grads = grad_fn(params, motion, length, ids, mask)
        updates, opt_state = tx.update(grads, opt_state)
        params = optax.apply_updates(params, updates)
        assert abs(got - float(want)) <= LOSS_REL * abs(float(want)), (got, float(want))


def _evaluator_cfg():
    return dict(motion_encoder=ev_tool.MOTION_ENCODER, text_encoder=ev_tool.TEXT_ENCODER)


def _embeddings_agree(port, jax_model, motion, texts):
    lengths = np.array([motion.shape[1] - i for i in range(len(motion))])
    for got, want in ((port.encode_motion(motion, lengths),
                       jax_model.encode_motion(motion, lengths)),
                      (port.encode_text(texts), jax_model.encode_text(texts))):
        err = float(np.abs(got.numpy() - np.asarray(want)).max())
        assert err <= EMB_ATOL * max(1.0, float(np.abs(want).max())), err


def test_evaluator_npz_reads_alike_in_both_packages(tmp_path, jax_evaluator):
    motion, texts = _batch(6, 20, seed=1)
    # written by the port's tool
    motion_mod, text_mod = ev_tool.build_modules(3, "cpu")
    port_npz = str(tmp_path / "port.npz")
    checkpoint.save_params(port_npz, ev_tool.evaluator_tree(motion_mod, text_mod))
    init = {"type": "Pretrained", "checkpoint": port_npz}
    port = T2MContrastiveModel_SMPLX(**_evaluator_cfg(), init_cfg=init, device="cpu")
    jax_model = JaxEvaluator(**_evaluator_cfg(), init_cfg=init)
    assert port.pretrained_loaded and jax_model.pretrained_loaded
    _embeddings_agree(port, jax_model, motion, texts)
    # written the JAX tool's way, against the JAX model holding the same tree
    _, _, mp, tp = jax_evaluator
    jax_npz = str(tmp_path / "jax.npz")
    jax_save_params(jax_npz, {"motion": mp, "text": tp})
    jax_model.motion_params, jax_model.text_params = mp, tp
    init = {"type": "Pretrained", "checkpoint": jax_npz}
    _embeddings_agree(T2MContrastiveModel_SMPLX(**_evaluator_cfg(), init_cfg=init,
                                                device="cpu"), jax_model, motion, texts)


# ------------------------------------------------------- calibration checkpoint
def test_calibration_bank_is_the_jax_tools():
    jax_tool = _load("make_calib_ckpt")
    assert calib_tool.PROMPTS == jax_tool.PROMPTS
    got, want = calib_tool.make_dataset(16, 322, 24, 3), jax_tool.make_dataset(16, 322, 24, 3)
    assert len(got) == len(want) == 24
    for i in range(24):
        a, b = got[i], want[i]
        assert a.keys() == b.keys() and a["motion_metas"] == b["motion_metas"]
        assert a["motion_length"] == b["motion_length"]
        for k in ("motion", "motion_mask"):
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


def test_calibration_checkpoint_trains_and_loads(tmp_path):
    out = str(tmp_path / "calib.npz")
    res = calib_tool.run(calib_tool.parse_args([CONFIG, out, "--device", "cpu", "--steps", "8",
                                                "--batch-size", "2"]), logger=lambda m: None)
    assert res["steps"] == 8 and len(res["losses"]) == 1 and math.isfinite(res["losses"][0])
    cfg = Config.fromfile(CONFIG)
    arch = build_architecture(cfg.model, device="cpu")
    checkpoint.load_eval_variables(cfg.model, arch.model, checkpoint=out)
    want = res["arch"].model.state_dict()
    assert all(torch.equal(v, want[k]) for k, v in arch.model.state_dict().items())


# -------------------------------------------------------------------- drift
def _dump(path, seed, lengths):
    rng = np.random.RandomState(seed)
    np.savez(path, pred_motion=rng.randn(len(lengths), 12, 322).astype(np.float32),
             motion_length=np.asarray(lengths))


def test_sample_err_is_the_jax_tools(tmp_path):
    jax_tool = _load("measure_approx_drift")
    a, b = str(tmp_path / "a.npz"), str(tmp_path / "b.npz")
    _dump(a, 0, [12, 5, 9, 1, 12])
    _dump(b, 1, [12, 5, 9, 1, 12, 7])
    assert drift_tool.sample_err(a, b) == jax_tool.sample_err(a, b)
    assert drift_tool.METRIC_KEYS == jax_tool.METRIC_KEYS


def _done_modes(tmp_path, argv, inputs_of=lambda name, inputs: inputs):
    """Mode dirs of exact and int8w as a finished run of ``argv`` leaves
    them, their recorded inputs passed through ``inputs_of``; returns the
    metrics written and the parsed ``argv``."""
    ckpt = tmp_path / "params.npz"
    np.savez(ckpt, w=np.arange(4.0))
    argv = argv + ["--checkpoint", str(ckpt)]
    args = drift_tool.parse_args(argv)
    digests = {str(ckpt): drift_tool.file_digest(str(ckpt))}
    metrics = {k: float(i) for i, k in enumerate(drift_tool.METRIC_KEYS)}
    for name, extra in drift_tool.modes_of(args):
        wd = tmp_path / "drift" / name
        wd.mkdir(parents=True)
        (wd / "metrics.json").write_text(json.dumps(dict(metrics, flags={"m": name})))
        _dump(str(wd / "samples.npz"), len(name), [12, 6])
        inputs = inputs_of(name, drift_tool.mode_inputs(args, extra, digests))
        (wd / "drift_mode.json").write_text(json.dumps({"wall_s": 1.0, "inputs": inputs}))
    return metrics, args


def test_completed_modes_are_reused(tmp_path, monkeypatch):
    argv = ["--device", "cpu", "--modes", "int8w", "--workroot", str(tmp_path / "drift"),
            "--out", str(tmp_path / "o.json")]
    metrics, args = _done_modes(tmp_path, argv)

    def no_sampling(name):
        raise AssertionError(f"{name} loaded: a done mode was run again")

    monkeypatch.setattr(drift_tool, "load_tool", no_sampling)
    res = drift_tool.run(args, logger=lambda m: None)
    assert all(r["reused"] for r in res["records"].values())
    assert list(res["out"]["modes"]) == ["exact", "int8w"]
    assert res["out"]["modes"]["int8w"]["delta_vs_exact"] == dict.fromkeys(metrics, 0.0)
    with open(tmp_path / "o.json") as f:
        assert json.load(f) == res["out"]


@pytest.mark.parametrize("changed", ["checkpoint_sha256", "limit", "replications"])
def test_modes_of_other_inputs_are_sampled_anew(tmp_path, monkeypatch, changed):
    # int8w's dir was measured on another checkpoint, limit or replication
    # count: it is run again, exact (same inputs) is reused
    def other(name, inputs):
        return dict(inputs, **{changed: "other"}) if name == "int8w" else inputs

    argv = ["--device", "cpu", "--modes", "int8w", "--workroot", str(tmp_path / "drift"),
            "--out", str(tmp_path / "o.json"), "--limit", "8", "--replications", "2"]
    _, args = _done_modes(tmp_path, argv, other)
    sampled = []

    class Sampled(Exception):
        pass

    def sample(name):
        sampled.append(name)
        raise Sampled

    monkeypatch.setattr(drift_tool, "load_tool", sample)
    log = []
    with pytest.raises(Sampled):
        drift_tool.run(args, logger=log.append)
    assert sampled == ["torch_test"]
    assert log[0].startswith("[exact] already complete")
    assert log[1].startswith("[int8w]") and "other inputs" in log[1]


def test_cpu_run_writes_the_jax_schema(tmp_path, monkeypatch):
    make = _load("make_tiny_data")
    make.make_motionx(str(tmp_path / "data_tiny"), np.random.RandomState(0))
    monkeypatch.chdir(tmp_path)
    cfg = Config.fromfile(CONFIG)
    arch = build_architecture(cfg.model, device="cpu")
    arch.model.load_state_dict(fabricate_state_dict(arch.model, seed=4))
    params = str(tmp_path / "params.npz")
    checkpoint.save_params(params, arch.model)
    argv = ["--config", CONFIG, "--checkpoint", params, "--device", "cpu", "--modes",
            "step_cache_2", "--limit", "8", "--replications", "1", "--workroot",
            str(tmp_path / "drift"), "--out", str(tmp_path / "drift.json")]
    out = drift_tool.main(argv)["out"]
    with open(os.path.join(REPO, "artifacts", "approx_drift.json")) as f:
        jax_out = json.load(f)
    assert set(jax_out) <= set(out) and list(out["modes"]) == ["exact", "step_cache_2"]
    assert set(out["modes"]["exact"]) == set(jax_out["modes"]["exact"])
    cached = out["modes"]["step_cache_2"]
    assert set(cached) == set(jax_out["modes"]["step_cache_2"])
    assert set(cached["sample_rel_err"]) == set(jax_out["modes"]["step_cache_2"]
                                                ["sample_rel_err"])
    assert cached["flags"]["step_cache"] == 2 and cached["sample_rel_err"]["n_clips"] == 6
    assert set(cached["delta_vs_exact"]) == set(out["modes"]["exact"]["metrics"])
    assert all(math.isfinite(v) for v in cached["delta_vs_exact"].values())
    # the exact mode is tools/torch_test.py's run with the same arguments
    torch_test = _load("torch_test")
    direct = str(tmp_path / "direct")
    torch_test.main(drift_tool.test_argv(drift_tool.parse_args(argv), direct, []))
    with open(os.path.join(direct, "metrics.json")) as f, \
            open(tmp_path / "drift" / "exact" / "metrics.json") as g:
        assert json.load(f) == json.load(g)


def test_quality_run_refuses_a_used_out_dir(tmp_path):
    # its steps resume, reuse and prune by what they find there
    (tmp_path / "run.json").write_text("{}")
    with pytest.raises(SystemExit, match="not empty"):
        _load("torch_quality_run").main(["--out-dir", str(tmp_path), "--device", "cpu"])
    assert os.listdir(tmp_path) == ["run.json"]


# --------------------------------------------------------------- soak report
def test_soak_report_parses_a_resumed_cli_log(tmp_path, monkeypatch):
    make = _load("make_tiny_data")
    make.make_protocol_learnable(str(tmp_path / "data_tiny"), np.random.RandomState(0),
                                 n=16, t=24)
    monkeypatch.chdir(tmp_path)
    torch_train = _load("torch_train")
    argv = [CONFIG, "--device", "cpu", "--work-dir", str(tmp_path / "soak"), "--grad-accum",
            "2", "--cfg-options", "data.workers_per_gpu=0"]
    torch_train.main(argv + ["--max-epochs", "2"])
    torch_train.main(argv + ["--max-epochs", "3", "--resume"])
    out = soak_tool.main(["--work-dir", str(tmp_path / "soak"), "--out",
                          str(tmp_path / "soak.json"), "--batch", "4", "--grad-accum", "2",
                          "--note", "resumed once"])
    # 16 clips in batches of 4: 4 optimizer steps an epoch, a loss line every 2
    assert out["steps_per_epoch"] == 4 and out["optimizer_steps"] == 12
    assert out["epochs_completed"] == 3 and out["resume_events"] == [1]
    assert out["checkpoints_saved"] == 3 and len(out["loss_curve"]) == 6
    assert [x["step"] for x in out["loss_curve"]] == [2, 4, 6, 8, 10, 12]
    median = sorted(e["seconds"] for e in out["epoch_seconds"] if e["epoch"] > 0)[1]
    assert out["steady_epoch_seconds_median"] == median
    assert out["steady_samples_per_s"] == pytest.approx(4 * 4 / median)
    assert "global batch 4" in out["recipe"]
    with open(tmp_path / "soak.json") as f:
        assert json.load(f) == out
