"""The port's CLIs over several processes on the CPU (gloo), on
configs/tests/tiny_t2m.py over a small learnable tree
(tools/make_tiny_data.py's layout; 16 clips of 24 frames, batch 4, gate
noise 1 drawn at the global batch's shape):

- ``tools/torch_train.py --devices 2 --device cpu`` (2 spawned ranks, each
  its rows of the one-process loader's batches) for 1 epoch against the
  one-process CLI run: the same train.log step lines (the loss terms as
  printed, to 1e-4 relative: the ranks sum in another order) and a
  params.npz within 2e-2 x lr of it, as tests/test_torch_train.py holds
  two Adam steps (Adam moves an element whose gradient sits at rounding
  level by up to lr either way: none does here); rank 0 alone writes
  train.log and the checkpoint.
- ``--resume`` on 2 ranks for a second epoch: the resume line, 8 steps in
  all, and params.npz against the one-process run of 2 epochs to the same
  limits.
- ``tools/torch_test.py`` over 2 processes (``--coordinator file://...
  --num-processes 2 --process-id R``) in GT mode: each rank samples its
  half of the 32 test items, rank 0 alone writes metrics.json (FID about
  0) and the dump of every item.
"""

import importlib.util
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "tests", "tiny_t2m.py")
ONE_THREAD = ["--cfg-options", "data.workers_per_gpu=0"]
LR = 2e-4  # the tiny config's Adam
TIMEOUT_S = 180


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


torch_train = _load("torch_train_dist", os.path.join(REPO, "tools", "torch_train.py"))


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("dist_cli")
    make = _load("make_tiny_data", os.path.join(REPO, "tools", "make_tiny_data.py"))
    make.make_protocol_learnable(str(root / "data_tiny"), np.random.RandomState(0), n=16, t=24)
    return root


def _env():
    return dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")


def _cli(tree, tool, *argv):
    out = subprocess.run([sys.executable, os.path.join(REPO, "tools", tool), *argv],
                         cwd=tree, env=_env(), capture_output=True, text=True,
                         timeout=TIMEOUT_S)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    return out


def _steps(work):
    with open(os.path.join(work, "train.log")) as f:
        return [re.sub(r" step_ms=\S+", "", ln.split(" - INFO - ")[1]).strip()
                for ln in f if " loss=" in ln]


def _same_steps(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        gv = dict(kv.split("=") for kv in g.split(": ")[1].split())
        wv = dict(kv.split("=") for kv in w.split(": ")[1].split())
        assert g.split(": ")[0] == w.split(": ")[0] and gv.keys() == wv.keys()
        for k in wv:
            assert float(gv[k]) == pytest.approx(float(wv[k]), rel=1e-4, abs=1e-5), (g, w)


def _same_params(got_path, want_path):
    got, want = np.load(got_path), np.load(want_path)
    assert set(got.files) == set(want.files)
    for k in want.files:
        assert np.abs(got[k] - want[k]).max() <= 2e-2 * LR, k


@pytest.fixture(scope="module")
def runs(tree):
    """One process for 1 and for 2 epochs (in this process); 2 ranks for 1
    epoch, then resumed for a second."""
    cwd = os.getcwd()
    os.chdir(tree)
    try:
        for epochs in (1, 2):
            torch_train.main([CONFIG, "--device", "cpu", "--work-dir", f"one_{epochs}",
                              "--max-epochs", str(epochs), *ONE_THREAD])
    finally:
        os.chdir(cwd)
    _cli(tree, "torch_train.py", CONFIG, "--device", "cpu", "--devices", "2", "--work-dir",
         "two", "--max-epochs", "1", *ONE_THREAD)
    first = {"steps": _steps(tree / "two"),
             "params": dict(np.load(tree / "two" / "params.npz"))}
    _cli(tree, "torch_train.py", CONFIG, "--device", "cpu", "--devices", "2", "--work-dir",
         "two", "--max-epochs", "2", "--resume", *ONE_THREAD)
    return tree, first


def test_two_ranks_train_as_one_process(runs):
    tree, first = runs
    _same_steps(first["steps"], _steps(tree / "one_1"))
    np.savez(tree / "two_epoch0.npz", **first["params"])
    _same_params(tree / "two_epoch0.npz", tree / "one_1" / "params.npz")
    with open(tree / "two" / "train.log") as f:
        log = f.read()
    assert "mesh: {'data': 2} over gloo; dataset: 16 samples, 4 steps/epoch" in log
    assert sorted(os.listdir(tree / "two" / "ckpt")) == ["epoch_0.pth", "epoch_1.pth"]


def test_two_ranks_resume(runs):
    tree, _ = runs
    with open(tree / "two" / "train.log") as f:
        log = f.read()
    assert re.search(r"resumed from \S+epoch_0\.pth at epoch 0 \(step 4\)", log)
    assert "training done at step 8" in log
    _same_steps(_steps(tree / "two"), _steps(tree / "one_2"))
    _same_params(tree / "two" / "params.npz", tree / "one_2" / "params.npz")


def test_torch_test_over_two_processes(tree):
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(REPO, "tools", "torch_test.py"), CONFIG, "eval",
         "--device", "cpu", "--coordinator", f"file://{tree / 'eval_rendezvous'}",
         "--num-processes", "2", "--process-id", str(r), "--batch-size", "4",
         "--dump-samples", f"eval/dump_{r}", "--cfg-options", "model.inference_type=gt"],
        cwd=tree, env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=TIMEOUT_S)[0])
        finally:
            p.kill()
    assert all(p.returncode == 0 for p in procs), outs
    with open(tree / "eval" / "metrics.json") as f:
        metrics = json.load(f)
    assert abs(metrics["FID (mean)"]) < 1e-3
    # the test set: 16 clips x 2 replications; 4 batches of 4 a rank
    for out in outs:
        assert "sampled 32 results" in out and len(re.findall(r"batch \d+: 4 samples", out)) == 4
    assert os.path.exists(tree / "eval" / "dump_0.npz")
    assert not os.path.exists(tree / "eval" / "dump_1.npz")
    assert np.load(tree / "eval" / "dump_0.npz")["pred_motion"].shape == (32, 16, 322)
