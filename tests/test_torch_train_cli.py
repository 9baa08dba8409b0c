"""tools/torch_train.py on the CPU with configs/tests/tiny_t2m.py over a small
learnable tree (tools/make_tiny_data.py --protocol-learnable's layout):

- 2 epochs equal 1 epoch plus --resume for 1 more, bit for bit;
- one CLI epoch equals train_model called with the config's recipe;
- params.npz has the key set and shapes of the flax tree of the same config
  and loads in the JAX package's load_params;
- a partial checkpoint left by a killed write is never what
  latest_checkpoint returns, and max_keep_ckpts prunes;
- a config with ``evaluation`` runs the EvalHook after each epoch;
- each option the port does not train yet is refused.
"""

import importlib.util
import os
import re
import shutil

import jax
import numpy as np
import pytest
import torch

import motioncraft_tpu.models  # noqa: F401  (registers the flax classes)
from motioncraft_tpu.config import Config as JaxConfig
from motioncraft_tpu.registry import build_architecture as build_jax
from motioncraft_tpu.utils.checkpoint import load_params as jax_load_params
from motioncraft_tpu_torch.apis import train_model
from motioncraft_tpu_torch.config import Config
from motioncraft_tpu_torch.data import build_dataloader
from motioncraft_tpu_torch.registry import build_architecture, build_dataset
from motioncraft_tpu_torch.utils import checkpoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "tests", "tiny_t2m.py")
# the feeder threads of workers_per_gpu > 0 take the samples' random crops in
# the order they run; an exact resume needs one thread
ONE_THREAD = ["--cfg-options", "data.workers_per_gpu=0"]


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


torch_train = _load("torch_train", os.path.join(REPO, "tools", "torch_train.py"))


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """./data_tiny: 32 learnable clips of 24 frames (8 steps an epoch)."""
    root = tmp_path_factory.mktemp("train_cli")
    make = _load("make_tiny_data", os.path.join(REPO, "tools", "make_tiny_data.py"))
    make.make_protocol_learnable(str(root / "data_tiny"), np.random.RandomState(0), n=32, t=24)
    return root


def _train(work, *extra):
    return torch_train.main([CONFIG, "--device", "cpu", "--work-dir", str(work), *extra])


def _loss_lines(work):
    """The train.log step lines without their time stamps and step_ms."""
    with open(os.path.join(work, "train.log")) as f:
        return [re.sub(r" step_ms=\S+", "", ln.split(" - INFO - ")[1]).strip()
                for ln in f if " loss=" in ln]


def _assert_same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_two_epochs_equal_one_plus_a_resumed_one(tree, monkeypatch):
    monkeypatch.chdir(tree)
    straight = _train(tree / "straight", "--max-epochs", "2", *ONE_THREAD)
    _train(tree / "split", "--max-epochs", "1", *ONE_THREAD)
    resumed = _train(tree / "split", "--max-epochs", "2", "--resume", *ONE_THREAD)
    assert straight.step == resumed.step == 16
    _assert_same(resumed.model.state_dict(), straight.model.state_dict())
    got, want = (s.optimizer.state_dict()["state"] for s in (resumed, straight))
    assert got.keys() == want.keys()
    for i in want:
        _assert_same(got[i], want[i])
    assert _loss_lines(tree / "split") == _loss_lines(tree / "straight")
    with open(tree / "split" / "train.log") as f:
        log = f.read()
    assert re.search(r"resumed from \S+epoch_0\.pth at epoch 0 \(step 8\)", log)
    assert "dataset: 32 samples, 8 steps/epoch" in log
    assert re.findall(r"saved checkpoint at epoch (\d+)", log) == ["0", "1"]


def test_one_cli_epoch_equals_train_model_with_the_recipe(tree, monkeypatch):
    monkeypatch.chdir(tree)
    cli = _train(tree / "cli", "--max-epochs", "1", "--grad-accum", "2", "--seed", "3",
                 *ONE_THREAD)
    cfg = Config.fromfile(CONFIG)
    torch.manual_seed(3)
    arch = build_architecture(cfg.model, device="cpu")
    loader = build_dataloader(build_dataset(cfg.data["train"]),
                              samples_per_gpu=cfg.data["samples_per_gpu"], shuffle=True,
                              seed=3, workers_per_gpu=0)
    state = train_model(arch, loader, optimizer_cfg=dict(cfg.optimizer),
                        lr_config=dict(cfg.lr_config), max_epochs=1,
                        steps_per_epoch=len(loader), seed=3, grad_accum=2,
                        logger=lambda m: None)
    assert state.step == cli.step == 8
    _assert_same(arch.model.state_dict(), cli.model.state_dict())


def test_params_npz_is_the_flax_tree_and_loads_in_jax(tree, monkeypatch):
    monkeypatch.chdir(tree)
    state = _train(tree / "npz", "--max-epochs", "1", *ONE_THREAD)
    path = str(tree / "npz" / "params.npz")
    loaded = jax_load_params(path)
    arch = build_jax(JaxConfig.fromfile(CONFIG).model)
    batch = {"motion": np.zeros((1, 16, 322), np.float32),
             "motion_mask": np.ones((1, 16), np.float32),
             "motion_length": np.full((1, 1), 16, np.int32),
             "text_ids": np.zeros((1, 77), np.int32)}
    variables = arch.init(jax.random.PRNGKey(0), batch)

    def shapes(tree_):
        return {jax.tree_util.keystr(p): np.shape(v)
                for p, v in jax.tree_util.tree_leaves_with_path(tree_)}

    assert shapes(loaded["params"]) == shapes(variables["params"])
    # and it is the trained model's
    reloaded = build_architecture(Config.fromfile(CONFIG).model, device="cpu")
    checkpoint.load_eval_variables(Config.fromfile(CONFIG).model, reloaded.model,
                                   checkpoint=path)
    _assert_same(reloaded.model.state_dict(), state.model.state_dict())


def test_killed_writes_are_never_resumed_and_old_checkpoints_pruned(tree, monkeypatch):
    monkeypatch.chdir(tree)
    work = tree / "keep"
    _train(work, "--max-epochs", "3", "--cfg-options", "data.workers_per_gpu=0",
           "checkpoint_config.max_keep_ckpts=2")
    ckpt = work / "ckpt"
    assert sorted(os.listdir(ckpt)) == ["epoch_1.pth", "epoch_2.pth"]
    # a write killed outside save_checkpoint (a file cut short under its
    # name) and one killed inside it (its temporary file)
    data = (ckpt / "epoch_2.pth").read_bytes()
    (ckpt / "epoch_3.pth").write_bytes(data[: len(data) // 2])
    (ckpt / ".epoch_4.partial.tmp").write_bytes(data[: len(data) // 3])
    assert checkpoint.latest_checkpoint(str(ckpt)) == str(ckpt / "epoch_2.pth")

    # save_checkpoint interrupted mid-write leaves neither file behind
    real = torch.save

    def dies(obj, f):
        f.write(b"PK partial")
        raise KeyboardInterrupt

    state = _train(work, "--max-epochs", "4", "--resume", "--cfg-options",
                   "data.workers_per_gpu=0", "checkpoint_config.max_keep_ckpts=2")
    assert state.step == 32
    assert checkpoint.latest_checkpoint(str(ckpt)) == str(ckpt / "epoch_3.pth")
    monkeypatch.setattr(torch, "save", dies)
    with pytest.raises(KeyboardInterrupt):
        checkpoint.save_checkpoint(str(ckpt), state, 4, max_to_keep=2)
    monkeypatch.setattr(torch, "save", real)
    assert sorted(os.listdir(ckpt)) == [".epoch_4.partial.tmp", "epoch_2.pth", "epoch_3.pth"]
    with open(work / "train.log") as f:
        assert re.search(r"resumed from \S+epoch_2\.pth at epoch 2", f.read())
    shutil.rmtree(work)


def test_evaluation_config_runs_the_eval_hook(tree, monkeypatch):
    monkeypatch.chdir(tree)
    work = tree / "hook"
    _train(work, "--max-epochs", "1", "--cfg-options", "data.workers_per_gpu=0",
           "evaluation={'interval': 1, 'batch_size': 8, 'save_best': 'FID (mean)'}")
    with open(work / "train.log") as f:
        log = f.read()
    assert re.search(r"\[eval @ epoch 0\] .*FID \(mean\)=", log)
    assert "new best FID (mean)=" in log and (work / "best_params.npz").is_file()


@pytest.mark.parametrize("argv, item", [
    (["--devices", "2"], "multi-GPU"), (["--tensor-parallel", "2"], "multi-GPU"),
    (["--pipeline-parallel", "2"], "multi-GPU"), (["--multihost"], "multi-GPU"),
    (["--coordinator", "localhost:1234"], "multi-GPU"),
    (["--base-checkpoint", "base.npz"], "the rest of training"),
    (["--cfg-options", "model.model.type=ControlT2MHalf"], "the rest of training"),
    (["--cfg-options", "data.train.base={'type': 'TextMotionDataset'}"],
     "the rest of training"),
    (["--cfg-options", "fp16={'loss_scale': 512.0}"], "the rest of training")],
    ids=["devices", "tensor-parallel", "pipeline-parallel", "multihost", "coordinator",
         "base-checkpoint", "controlnet", "mixed", "fp16"])
def test_options_not_ported_are_refused(argv, item, tmp_path):
    with pytest.raises(SystemExit, match=f"ROADMAP queue 1: {item}"):
        torch_train.main([CONFIG, "--device", "cpu", "--work-dir", str(tmp_path), *argv])
