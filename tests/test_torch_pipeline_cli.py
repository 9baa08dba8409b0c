"""``tools/torch_train.py --pipeline-parallel`` on the CPU (gloo), on
configs/tests/tiny_t2m.py at 2 layers over tests/test_torch_dist_cli.py's
learnable tree (16 clips of 24 frames, batch 4, gate noise 1 drawn from the
step's generator folded per (layer, microbatch)), with the evaluation hook
on:

- ``--devices 2 --pipeline-parallel 2``: tools/train.py's mesh ``(data 1,
  pipe 2)`` in the ``mesh:`` line, each rank one stage; one epoch, then
  ``--resume`` for a second, against the one-process CLI run of the same
  pipelined config (``model.pipeline_axis``, 2 microbatches: the layers per
  microbatch in sequence) for two epochs: the step lines to 1e-4 relative
  and params.npz within 2e-2 x lr (tests/test_torch_dist_cli.py's limits).
- params.npz holds the blocks stacked (``params/stacked_blocks/...``), the
  layout the JAX package's save_params writes for that config: the JAX
  package's load_params + align_block_layout read it into its plain model's
  tree, and tools/torch_test.py evaluates it on the plain config.  The
  checkpoint holds the whole model and optimizer state in the one-process
  layout, and rank 0's evaluation hook ran on a whole copy.
- tools/train.py's refusals, in its words: ``--tensor-parallel`` or
  ``--multihost`` with ``--pipeline-parallel``, a config that is not an
  STMoGen stack, a device count the stages do not divide.
"""

import json
import os
import re

import jax
import numpy as np
import pytest
import torch

from motioncraft_tpu.utils import checkpoint as jax_ckpt
from motioncraft_tpu_torch.registry import build_architecture
from motioncraft_tpu_torch.utils.convert import to_jax_params
from test_torch_dist_cli import CONFIG, _cli, _load, _same_params, _same_steps, _steps
from torch_dist_ranks import one_thread

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EVAL = "evaluation={'interval': 1, 'batch_size': 8, 'save_best': 'FID (mean)'}"
OPTS = ["--cfg-options", "data.workers_per_gpu=0", "model.model.num_layers=2"]
PIPED = ["model.model.pipeline_axis='pipe'", "model.model.pipeline_microbatches=2"]

torch_train = _load("torch_train_pp", os.path.join(REPO, "tools", "torch_train.py"))
torch_test = _load("torch_test_pp", os.path.join(REPO, "tools", "torch_test.py"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("pp_cli")
    make = _load("make_tiny_data", os.path.join(REPO, "tools", "make_tiny_data.py"))
    make.make_protocol_learnable(str(root / "data_tiny"), np.random.RandomState(0), n=16, t=24)
    cwd = os.getcwd()
    os.chdir(root)
    try:
        with one_thread():  # as each rank runs
            torch_train.main([CONFIG, "--device", "cpu", "--work-dir", "one",
                              "--max-epochs", "2", *OPTS, *PIPED])
    finally:
        os.chdir(cwd)
    pp = ["--device", "cpu", "--devices", "2", "--pipeline-parallel", "2", "--work-dir", "pp"]
    _cli(root, "torch_train.py", CONFIG, *pp, "--max-epochs", "1", *OPTS, EVAL)
    first = _steps(root / "pp")
    _cli(root, "torch_train.py", CONFIG, *pp, "--max-epochs", "2", "--resume", *OPTS, EVAL)
    return root, first


def test_pipeline_cli_trains_as_one_process(runs):
    root, first = runs
    with open(root / "pp" / "train.log") as f:
        log = f.read()
    assert "mesh: {'data': 1, 'pipe': 2} over gloo; dataset: 16 samples, 4 steps/epoch" in log
    assert "resumed from" in log and "at epoch 0 (step 4)" in log
    one = _steps(root / "one")
    _same_steps(first, one[:len(first)])
    _same_steps(_steps(root / "pp"), one)
    _same_params(root / "pp" / "params.npz", root / "one" / "params.npz")
    assert log.count("[eval @ epoch") == 2 and (root / "pp" / "best_params.npz").is_file()
    ckpt = torch.load(root / "pp" / "ckpt" / "epoch_1.pth", map_location="cpu",
                      weights_only=False)
    ref = torch.load(root / "one" / "ckpt" / "epoch_1.pth", map_location="cpu",
                     weights_only=False)
    assert list(ckpt["model"]) == list(ref["model"])
    assert all(ckpt["model"][k].shape == v.shape for k, v in ref["model"].items())
    assert sorted(ckpt["optimizer"]["state"]) == sorted(ref["optimizer"]["state"])
    for i, st in ref["optimizer"]["state"].items():
        assert {k: getattr(v, "shape", None) for k, v in ckpt["optimizer"]["state"][i].items()} \
            == {k: getattr(v, "shape", None) for k, v in st.items()}


def test_pipeline_params_read_by_both_packages(runs, tmp_path):
    """The stacked params.npz: the JAX package's align_block_layout gives its
    plain model's tree (the port's plain model's flax tree, leaf for leaf
    in shape); tools/torch_test.py evaluates it on the plain config."""
    root, _ = runs
    flat = np.load(root / "pp" / "params.npz")
    assert any(k.startswith("params/stacked_blocks/") for k in flat.files)
    assert not any(k.startswith("params/block_") for k in flat.files)
    from motioncraft_tpu_torch.config import Config

    cfg = Config.fromfile(CONFIG)
    cfg.model["model"]["num_layers"] = 2
    plain = jax_ckpt.align_block_layout(cfg.model, jax_ckpt.load_params(
        str(root / "pp" / "params.npz")))["params"]
    want = to_jax_params(build_architecture(cfg.model, device="cpu").model.state_dict())
    assert jax.tree_util.tree_structure(plain) == jax.tree_util.tree_structure(want)
    assert jax.tree_util.tree_map(np.shape, plain) == jax.tree_util.tree_map(np.shape, want)
    cwd = os.getcwd()
    os.chdir(root)
    try:
        torch_test.main([CONFIG, str(tmp_path / "eval"), "--device", "cpu", "--checkpoint",
                         str(root / "pp" / "params.npz"), "--cfg-options",
                         "model.model.num_layers=2"])
    finally:
        os.chdir(cwd)
    with open(tmp_path / "eval" / "metrics.json") as f:
        metrics = json.load(f)
    assert np.isfinite(metrics["FID (mean)"] if "FID (mean)" in metrics
                       else metrics["metrics"]["FID (mean)"])


with open(os.path.join(REPO, "tools", "train.py")) as _f:
    # tools/train.py's source, its strings split over lines joined
    JAX_TRAIN = re.sub(r'"\s*\n\s*f?"', "", _f.read())


@pytest.mark.parametrize("argv, message", [
    (["--tensor-parallel", "2"], "--pipeline-parallel composes only with the data axis for now"),
    (["--multihost"], "--pipeline-parallel composes only with the data axis for now"),
    (["--devices", "3"], "--pipeline-parallel 2 does not divide 3 devices"),
    ([os.path.join(REPO, "configs", "mdm", "mdm_t2m_smplx.py")],
     "--pipeline-parallel is implemented for STMoGenTransformer decoder stacks")],
    ids=["tensor-parallel", "multihost", "devices", "not-stmogen"])
def test_pipeline_refusals_are_the_jax_cli(argv, message, tmp_path, monkeypatch):
    for key in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)
    config = CONFIG
    if argv[0].endswith(".py"):
        config, argv = argv[0], argv[1:]
    with pytest.raises(SystemExit, match=message):
        torch_train.main([config, "--device", "cpu", "--work-dir", str(tmp_path),
                          "--pipeline-parallel", "2", *argv])
    assert message.replace(" 2 does not divide 3 ", " {pp} does not divide {n} ") in JAX_TRAIN
