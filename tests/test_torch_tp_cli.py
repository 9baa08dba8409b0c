"""``tools/torch_train.py --tensor-parallel`` on the CPU (gloo), on
configs/tests/tiny_t2m.py over tests/test_torch_dist_cli.py's learnable
tree (16 clips of 24 frames, batch 4, gate noise 1 drawn at the global
batch's shape), with the evaluation hook on:

- ``--devices 2 --tensor-parallel 2``: tools/train.py's mesh
  ``(data 1, expert 1, tensor 2)`` in the ``mesh:`` line; the FFNs' hidden
  dims split over the two ranks, which hold the same rows.  One epoch
  against the one-process CLI run (the step lines to 1e-4 relative, the
  params.npz within 2e-2 x lr, tests/test_torch_dist_cli.py's limits);
  ``--resume`` for a second epoch against the one-process run of two,
  and two epochs on end equal to the resumed run bit for bit.  The
  one-process runs have no evaluation hook: its test pipeline's crops
  draw from numpy's global generator, which the CLI puts back after
  rank 0's evaluation on a mesh (so that the ranks hold the same rows) and
  not in one process (tools/torch_train.py:keeping_rng).
- The evaluation hook of the run is a one-process evaluation of the
  whole weights (rank 0 over a gathered copy): the best_params.npz it
  saves is the run's params.npz bit for bit; the TP-trained params.npz
  samples in one process as the one-process run's does (1e-4 of scale).
- The checkpoint holds the whole model and optimizer state (shards
  gathered): its shapes are one process's.
"""

import os
import re

import numpy as np
import pytest
import torch

from test_torch_dist_cli import (CONFIG, LR, _cli, _load, _same_params, _same_steps,
                                 _steps)
from torch_dist_ranks import one_thread

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EVAL = "evaluation={'interval': 1, 'batch_size': 8, 'save_best': 'FID (mean)'}"
OPTS = ["--cfg-options", "data.workers_per_gpu=0"]

torch_train = _load("torch_train_tp", os.path.join(REPO, "tools", "torch_train.py"))


def _eval_lines(work):
    with open(os.path.join(work, "train.log")) as f:
        return [ln.split(" - INFO - ")[1].strip() for ln in f if "[eval @ epoch" in ln]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("tp_cli")
    make = _load("make_tiny_data", os.path.join(REPO, "tools", "make_tiny_data.py"))
    make.make_protocol_learnable(str(root / "data_tiny"), np.random.RandomState(0), n=16, t=24)
    cwd = os.getcwd()
    os.chdir(root)
    try:
        # one thread, as each rank runs: another thread count sums in another
        # order, and a gate logit one ulp apart can move a near-tied pick
        with one_thread():
            for epochs in (1, 2):
                torch_train.main([CONFIG, "--device", "cpu", "--work-dir", f"one_{epochs}",
                                  "--max-epochs", str(epochs), *OPTS])
    finally:
        os.chdir(cwd)
    tp = ["--device", "cpu", "--devices", "2", "--tensor-parallel", "2", "--work-dir", "tp"]
    _cli(root, "torch_train.py", CONFIG, *tp, "--max-epochs", "1", *OPTS, EVAL)
    first = {"steps": _steps(root / "tp"), "eval": _eval_lines(root / "tp")}
    np.savez(root / "tp_epoch0.npz", **np.load(root / "tp" / "params.npz"))
    np.savez(root / "tp_best0.npz", **np.load(root / "tp" / "best_params.npz"))
    _cli(root, "torch_train.py", CONFIG, *tp, "--max-epochs", "2", "--resume", *OPTS, EVAL)
    _cli(root, "torch_train.py", CONFIG, *tp, "--work-dir", "tp_2", "--max-epochs", "2",
         *OPTS, EVAL)
    return root, first


def test_tensor_parallel_cli_trains_as_one_process(runs):
    root, first = runs
    with open(root / "tp" / "train.log") as f:
        log = f.read()
    assert ("mesh: {'data': 1, 'expert': 1, 'tensor': 2} over gloo; dataset: 16 samples, "
            "4 steps/epoch") in log
    _same_steps(first["steps"], _steps(root / "one_1"))
    _same_params(root / "tp_epoch0.npz", root / "one_1" / "params.npz")
    assert re.search(r"resumed from \S+epoch_0\.pth at epoch 0 \(step 4\)", log)
    _same_steps(_steps(root / "tp"), _steps(root / "one_2"))
    _same_params(root / "tp" / "params.npz", root / "one_2" / "params.npz")
    # rank 0's evaluation leaves the ranks' crops in step: two epochs on
    # end are the resumed run, bit for bit
    assert _steps(root / "tp_2") == _steps(root / "tp")
    a, b = np.load(root / "tp_2" / "params.npz"), np.load(root / "tp" / "params.npz")
    assert all(np.array_equal(a[k], b[k]) for k in b.files)
    ckpt = torch.load(root / "tp" / "ckpt" / "epoch_1.pth", map_location="cpu",
                      weights_only=False)
    one = torch.load(root / "one_2" / "ckpt" / "epoch_1.pth", map_location="cpu",
                     weights_only=False)
    assert {k: v.shape for k, v in ckpt["model"].items()} == \
        {k: v.shape for k, v in one["model"].items()}
    for i, st in one["optimizer"]["state"].items():
        assert {k: getattr(v, "shape", None) for k, v in ckpt["optimizer"]["state"][i].items()} \
            == {k: getattr(v, "shape", None) for k, v in st.items()}


def test_eval_hook_under_tensor_parallelism_is_one_process_evaluation(runs):
    """Rank 0's hook evaluates the gathered whole weights in one process:
    the best_params.npz it saves after epoch 0 is the run's params.npz bit
    for bit; and the TP-trained params.npz samples in one process as the
    one-process run's params.npz does."""
    from motioncraft_tpu_torch.apis.factory import make_text_batch
    from motioncraft_tpu_torch.config import Config
    from motioncraft_tpu_torch.registry import build_architecture
    from motioncraft_tpu_torch.utils.checkpoint import load_eval_variables

    root, first = runs
    assert len(first["eval"]) == 1 and "FID (mean)=" in first["eval"][0]
    best, params = np.load(root / "tp_best0.npz"), np.load(root / "tp_epoch0.npz")
    assert set(best.files) == set(params.files)
    assert all(np.array_equal(best[k], params[k]) for k in params.files)
    cfg = Config.fromfile(CONFIG)
    batch = make_text_batch(["a person walks", "a person waves"], 16, 322,
                            lengths=np.array([[16], [12]], np.int32))
    outs = []
    for path in (root / "tp_epoch0.npz", root / "one_1" / "params.npz"):
        arch = build_architecture(cfg.model, device="cpu")
        load_eval_variables(cfg.model, arch.model, checkpoint=str(path))
        outs.append(arch.eval().sample(batch, generator=torch.Generator().manual_seed(0)))
    assert torch.isfinite(outs[0]).all()
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=1e-4 * float(outs[1].abs().max()))


def test_data_parallel_cli_prunes_checkpoints_on_rank_0_alone(runs):
    """``--devices 2`` alone (a data-only mesh) with ``max_keep_ckpts=1``
    over 3 epochs: rank 0 writes and prunes, the other rank writes
    nothing, so the run ends with the last epoch's file alone."""
    root, _ = runs
    _cli(root, "torch_train.py", CONFIG, "--device", "cpu", "--devices", "2", "--work-dir",
         "dp_keep", "--max-epochs", "3", *OPTS, "checkpoint_config.max_keep_ckpts=1")
    assert sorted(os.listdir(root / "dp_keep" / "ckpt")) == ["epoch_2.pth"]
    with open(root / "dp_keep" / "train.log") as f:
        assert f.read().count("saved checkpoint at epoch") == 3
