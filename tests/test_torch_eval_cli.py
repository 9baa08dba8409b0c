"""tools/torch_test.py on the CPU with configs/tests/tiny_t2m.py over a
synthetic Motion-X tree (tools/make_tiny_data.py's layout):

- GT mode gives FID ~ 0, and its metric dict equals that of the JAX
  package's tools/test.py run with the same evaluator weights (.npz) and
  --seed, within 1e-4 relative;
- DDIM mode from a JAX ``save_params`` .npz writes finite metrics and
  metrics.json with its flags, the last batch padded;
- the options the port does not run are refused, and so is --device cuda
  without a card;
- EvalHook, called by train_model, writes best_params.npz in the JAX
  layout.
"""

import copy
import importlib.util
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import motioncraft_tpu.models  # noqa: F401  (registers the flax classes)
from motioncraft_tpu.config import Config
from motioncraft_tpu.eval.models import T2MContrastiveModel_SMPLX as JaxEvaluator
from motioncraft_tpu.registry import build_architecture as build_jax
from motioncraft_tpu.utils.checkpoint import load_params as jax_load_params
from motioncraft_tpu.utils.checkpoint import save_params as jax_save_params
from torch_port_util import bf16_cast_dtypes, seeded_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "tests", "tiny_t2m.py")
REL = 1e-4


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


torch_test = _load("torch_test", os.path.join(REPO, "tools", "torch_test.py"))


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """./data_tiny (Motion-X only), the tiny evaluator's seeded weights and
    a seeded JAX snapshot of the tiny config's denoiser."""
    root = tmp_path_factory.mktemp("cli")
    make = _load("make_tiny_data", os.path.join(REPO, "tools", "make_tiny_data.py"))
    make.make_motionx(str(root / "data_tiny"), np.random.RandomState(0))
    cfg = Config.fromfile(CONFIG)
    ev_cfg = {k: v for k, v in cfg.data["test"]["eval_cfg"]["evaluator_model"].items()
              if k != "type"}
    shapes = JaxEvaluator(**ev_cfg)
    motion = seeded_params(jax.tree_util.tree_map(np.asarray, shapes.motion_params["params"]), 1)
    text = seeded_params(jax.tree_util.tree_map(np.asarray, shapes.text_params["params"]), 2)
    jax_save_params(str(root / "evaluator.npz"), {"motion": {"params": motion},
                                                  "text": {"params": text}})
    arch = build_jax(cfg.model)
    batch = {"motion": np.zeros((1, 16, 322), np.float32),
             "motion_mask": np.ones((1, 16), np.float32),
             "motion_length": np.full((1, 1), 16, np.int32),
             "text_ids": np.zeros((1, 77), np.int32)}
    variables = arch.init(jax.random.PRNGKey(0), batch)
    params = seeded_params(jax.tree_util.tree_map(np.asarray, variables["params"]), 3)
    jax_save_params(str(root / "params.npz"), {"params": params})
    return root


def _evaluator_option(root):
    return ("data.test.eval_cfg.evaluator_model.init_cfg="
            + repr(dict(type="Pretrained", checkpoint=str(root / "evaluator.npz"))))


def test_gt_mode_matches_the_jax_cli(workdir, monkeypatch):
    opts = ["model.inference_type=gt", _evaluator_option(workdir)]
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu", HOME=str(workdir))
    out = subprocess.run([sys.executable, os.path.join(REPO, "tools", "test.py"), CONFIG,
                          "jax_gt", "--seed", "4", "--cfg-options", *opts],
                         env=env, cwd=str(workdir), capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    with open(workdir / "jax_gt" / "metrics.json") as f:
        want = json.load(f)

    monkeypatch.chdir(workdir)
    got = torch_test.main([CONFIG, "port_gt", "--device", "cpu", "--seed", "4",
                           "--cfg-options", *opts])["out"]
    with open(workdir / "port_gt" / "metrics.json") as f:
        assert json.load(f) == got
    assert abs(got["FID (mean)"]) < 1e-3
    assert not got["flags"]["untrained_evaluator"] and got["flags"] == want["flags"]
    metric_keys = [k for k in want if k not in ("flags", "protocol")]
    assert sorted(k for k in got if k not in ("flags", "protocol")) == sorted(metric_keys)
    for k in metric_keys:
        assert abs(got[k] - want[k]) <= REL * max(1.0, abs(want[k])), (k, got[k], want[k])


def test_ddim_mode_from_a_jax_snapshot(workdir, monkeypatch):
    monkeypatch.chdir(workdir)
    run = torch_test.main([CONFIG, "port_ddim", "--device", "cpu", "--batch-size", "5",
                           "--checkpoint", str(workdir / "params.npz"),
                           "--dump-samples", str(workdir / "samples.npz"),
                           "--cfg-options", _evaluator_option(workdir)])
    out, results = run["out"], run["results"]
    # 6 clips x 2 replications in batches of 5: the last one (2) padded
    assert len(results) == 12 and run["arch"].inference_type == "ddim"
    metric = {k: v for k, v in out.items() if k not in ("flags", "protocol")}
    assert len(metric) == 8 and all(np.isfinite(v) for v in metric.values())
    with open(workdir / "port_ddim" / "metrics.json") as f:
        saved = json.load(f)
    assert saved == out and set(saved["flags"]) == {
        "untrained_evaluator", "hash_tokenizer", "int8_weights", "step_cache",
        "step_cache_table"}
    dumped = np.load(workdir / "samples.npz")
    assert dumped["pred_motion"].shape == (12, 16, 322)
    assert np.isfinite(dumped["pred_motion"]).all()
    # the loaded weights are the snapshot's
    params = jax_load_params(str(workdir / "params.npz"))["params"]
    w = run["arch"].model.state_dict()["time_embed.0.weight"].numpy()
    np.testing.assert_array_equal(w, params["time_embed"]["layers_0"]["kernel"].T)


def test_ddim_mode_bf16(workdir, monkeypatch):
    """--bf16: the snapshot's weights cast to bf16 and sampled with the
    denoiser in bf16 (the bf16 plain versions of K1-K3 on the CPU); the
    metrics and the dumped motions come out finite and f32."""
    monkeypatch.chdir(workdir)
    run = torch_test.main([CONFIG, "port_bf16", "--device", "cpu", "--batch-size", "5",
                           "--bf16", "--checkpoint", str(workdir / "params.npz"),
                           "--cfg-options", _evaluator_option(workdir)])
    out, results = run["out"], run["results"]
    assert len(results) == 12
    assert bf16_cast_dtypes(run["arch"].model) == ({torch.bfloat16}, {torch.float32})
    metric = {k: v for k, v in out.items() if k not in ("flags", "protocol")}
    assert len(metric) == 8 and all(np.isfinite(v) for v in metric.values())
    pred = np.stack([np.asarray(r["pred_motion"]) for r in results])
    assert pred.dtype == np.float32 and np.isfinite(pred).all()


@pytest.mark.parametrize("argv", [["--bf16", "--int8"], ["--int8"], ["--step-cache", "2"],
                                  ["--step-cache-table", "t.json"],
                                  ["--dispatch-batches", "2"], ["--no_repaint"]])
def test_options_not_ported_are_refused(argv):
    """Grouped dispatch and the RePaint knobs are refused; int8 and the step
    cache are ported now and parse (tests/test_torch_quant.py runs them)."""
    if argv[0] in ("--dispatch-batches", "--no_repaint"):
        with pytest.raises(SystemExit, match="ROADMAP queue 1: "):
            torch_test.parse_args([CONFIG, "out"] + argv)
        return
    args = torch_test.parse_args([CONFIG, "out"] + argv)
    assert (args.int8, args.bf16, args.step_cache, args.step_cache_table) == {
        "--bf16": ("w8a8", True, 0, None), "--int8": ("w8a8", False, 0, None),
        "--step-cache": (None, False, 2, None),
        "--step-cache-table": (None, False, 0, "t.json")}[argv[0]]


def test_cuda_without_a_card_is_refused(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        torch_test.run(torch_test.parse_args([CONFIG, "out"]))


def test_eval_hook_in_train_model_saves_the_best_weights(workdir, monkeypatch):
    from motioncraft_tpu_torch.apis import EvalHook, make_train_batch, train_model
    from motioncraft_tpu_torch.registry import build_architecture, build_dataset

    monkeypatch.chdir(workdir)
    cfg = Config.fromfile(CONFIG)
    arch = build_architecture(cfg.model, device="cpu")
    test_cfg = copy.deepcopy(dict(cfg.data["test"]))
    test_cfg["eval_cfg"]["evaluator_model"]["device"] = "cpu"
    np.random.seed(0)
    dataset = build_dataset(test_cfg)
    lines = []
    hook = EvalHook(dataset, arch, batch_size=4, save_best="FID (mean)",
                    work_dir=str(workdir / "hook"), logger=lines.append)
    train_model(arch, [make_train_batch(2, max_seq_len=16)], max_epochs=1, log_interval=1,
                logger=lines.append, eval_fn=hook)
    assert hook.best is not None and np.isfinite(hook.best)
    assert any(ln.startswith("[eval @ epoch 0]") for ln in lines)
    saved = jax_load_params(str(workdir / "hook" / "best_params.npz"))["params"]
    np.testing.assert_array_equal(saved["time_embed"]["layers_2"]["bias"],
                                  arch.model.state_dict()["time_embed.2.bias"].numpy())
