"""tools/torch_train.py on the CPU with configs/tests/tiny_t2m.py over a small
learnable tree (tools/make_tiny_data.py --protocol-learnable's layout):

- 2 epochs equal 1 epoch plus --resume for 1 more, bit for bit;
- one CLI epoch equals train_model called with the config's recipe;
- params.npz has the key set and shapes of the flax tree of the same config
  and loads in the JAX package's load_params;
- a partial checkpoint left by a killed write is never what
  latest_checkpoint returns, and max_keep_ckpts prunes;
- a config with ``evaluation`` runs the EvalHook after each epoch;
- the config's fp16 (bf16 compute), model.remat and an optax-default
  optimizer (Adafactor) through --cfg-options: one CLI epoch equals
  train_model called with the same options, its masters f32;
- the config's fp16 in float16: one CLI epoch equals train_model called
  with the same option;
- each option the port does not train yet is refused, and so are
  ReMoDiffuse and MoMatMoGen, which the JAX package's loss cannot train;
- ControlNet training from a base: the JAX package's tools/train.py trains
  a tiny T2M base (configs/tests/tiny_s2g.py's) and writes params.npz; the
  port's CLI trains configs/tests/tiny_s2g.py on BEAT2 speech windows
  (SpeechMotionDataset over tools/make_tiny_data.py's tree) from it with
  --base-checkpoint; its params.npz keeps every frozen base leaf bit for
  bit, moved the trainable ones and the WavEncoder's statistics, and both
  tools/torch_s2g_test.py and the JAX package's tools/s2g_test.py sample
  from it with --checkpoint.
"""

import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys

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
from motioncraft_tpu_torch.parallel import freeze
from motioncraft_tpu_torch.registry import build_architecture, build_dataset
from motioncraft_tpu_torch.utils import checkpoint
from motioncraft_tpu_torch.utils.convert import from_jax_params, from_jax_variables

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


def test_fp16_remat_and_adafactor_through_the_cli(tree, monkeypatch):
    monkeypatch.chdir(tree)
    options = ["data.workers_per_gpu=0", "fp16={'loss_scale': 8.0}", "model.model.remat=True",
               "optimizer.type=Adafactor"]
    cli = _train(tree / "bf16", "--max-epochs", "1", "--seed", "4", "--cfg-options", *options)
    cfg = Config.fromfile(CONFIG)
    torch.manual_seed(4)
    model_cfg = dict(cfg.model)
    model_cfg["model"] = dict(cfg.model["model"], remat=True)
    arch = build_architecture(model_cfg, device="cpu")
    assert arch.model.remat
    loader = build_dataloader(build_dataset(cfg.data["train"]),
                              samples_per_gpu=cfg.data["samples_per_gpu"], shuffle=True,
                              seed=4, workers_per_gpu=0)
    state = train_model(arch, loader, optimizer_cfg=dict(cfg.optimizer, type="Adafactor"),
                        lr_config=dict(cfg.lr_config), max_epochs=1,
                        steps_per_epoch=len(loader), seed=4, fp16={"loss_scale": 8.0},
                        logger=lambda m: None)
    assert state.step == cli.step == 8
    assert type(cli.optimizer).__name__ == "Adafactor" and cli.model.remat
    assert all(v.dtype == torch.float32 for v in cli.model.state_dict().values())
    _assert_same(arch.model.state_dict(), cli.model.state_dict())
    losses = [float(ln.split(" loss=")[1].split()[0]) for ln in _loss_lines(tree / "bf16")]
    assert losses and np.isfinite(losses).all()



def test_float16_through_the_cli(tree, monkeypatch):
    """``fp16`` in float16 through --cfg-options: one CLI epoch equals
    train_model called with the same option (the same losses and weights),
    its masters f32 and its losses finite."""
    monkeypatch.chdir(tree)
    fp16 = {"dtype": "float16", "loss_scale": 8.0}
    cli = _train(tree / "f16", "--max-epochs", "1", "--seed", "5", "--cfg-options",
                 "data.workers_per_gpu=0", f"fp16={fp16!r}")
    cfg = Config.fromfile(CONFIG)
    torch.manual_seed(5)
    arch = build_architecture(cfg.model, device="cpu")
    loader = build_dataloader(build_dataset(cfg.data["train"]),
                              samples_per_gpu=cfg.data["samples_per_gpu"], shuffle=True,
                              seed=5, workers_per_gpu=0)
    lines = []
    state = train_model(arch, loader, optimizer_cfg=dict(cfg.optimizer),
                        lr_config=dict(cfg.lr_config), max_epochs=1,
                        steps_per_epoch=len(loader), seed=5, fp16=fp16,
                        log_interval=cfg.log_config["interval"], logger=lines.append)
    assert state.step == cli.step == 8
    assert all(v.dtype == torch.float32 for v in cli.model.state_dict().values())
    _assert_same(arch.model.state_dict(), cli.model.state_dict())
    losses = [float(ln.split(" loss=")[1].split()[0]) for ln in _loss_lines(tree / "f16")]
    want = [float(ln.split(" loss=")[1].split()[0]) for ln in lines if " loss=" in ln]
    assert losses == want and len(losses) == 4 and np.isfinite(losses).all()

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


def lmdb_speech_set(tmp_path):
    """A speech train set whose BEAT2 cache_path holds a reference LMDB
    cache."""
    cache = tmp_path / "cache"
    (cache / "train" / "smplxflame_30_cache").mkdir(parents=True)
    (cache / "train" / "smplxflame_30_cache" / "data.mdb").write_bytes(b"")
    yaml = tmp_path / "beat2.yaml"
    yaml.write_text(f"data_path: {REPO}/tests/fixtures/mini/beat2/\npose_length: 16\n"
                    f"cache_path: {cache}\ntraining_speakers: [2]\n")
    return repr(dict(type="SpeechMotionDataset", dataset_name="beats2",
                     data_prefix="./data", ann_file="train.txt", pipeline=[],
                     ann_config=str(yaml)))


@pytest.mark.parametrize("argv, item", [
    (["--devices", "2", "--device", "cuda"], "this host has 1 CUDA device"),
    (["--tensor-parallel", "2", "--multihost"], "--tensor-parallel with --multihost"),
    (["--pipeline-parallel", "2", "--tensor-parallel", "2"],
     "--pipeline-parallel composes only with the data axis"),
    (["--multihost", "--devices", "2"], "one rank a process"),
    (["--multihost", "--num-processes", "2"], "need a coordinator address"),
    ([os.path.join(REPO, "configs", "remodiffuse", "remodiffuse_t2m.py")],
     "ROADMAP queue 3: ReMoDiffuse / MoMatMoGen training"),
    (["--cfg-options", "data.train=LMDB"], "ROADMAP queue 1: the rest of training")],
    ids=["devices", "tensor-parallel", "pipeline-parallel", "multihost", "coordinator",
         "remodiffuse", "lmdb-cache"])
def test_options_not_ported_are_refused(argv, item, tmp_path, monkeypatch):
    """What the port does not run is refused: pipeline parallelism with
    tensor parallelism and tensor parallelism across hosts (as
    tools/train.py refuses them; each runs alone within a host:
    tests/test_torch_pipeline_cli.py, tests/test_torch_tp_cli.py), ReMoDiffuse training, an LMDB
    cache; and of the data-parallel options, more ranks than the
    host has cards (here one, pretended), --multihost with several ranks a
    process, and a multi-process run without its coordinator."""
    if "cuda" in argv:
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    for key in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)
    config = CONFIG
    if argv[0].endswith(".py"):
        config, argv = argv[0], argv[1:]
    argv = ["data.train=" + lmdb_speech_set(tmp_path) if a == "data.train=LMDB" else a
            for a in argv]
    # the LMDB cache is refused where the dataset would read it
    with pytest.raises((SystemExit, NotImplementedError, ValueError), match=item):
        torch_train.main([config, "--device", "cpu", "--work-dir", str(tmp_path), *argv])


# ------------------------------------------------------- ControlNet from a base
S2G_CONFIG = os.path.join(REPO, "configs", "tests", "tiny_s2g.py")
JAX_ENV = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")


def _jax_cli(root, tool, *argv):
    """The JAX package's tools/<tool>.py in a process of its own, run in
    ``root`` (HOME there too), as a Popen."""
    return subprocess.Popen([sys.executable, os.path.join(REPO, "tools", tool), *argv],
                            env=dict(JAX_ENV, HOME=str(root)), cwd=str(root),
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _finish(proc):
    log, _ = proc.communicate(timeout=600)
    assert proc.returncode == 0, log[-5000:]


@pytest.fixture(scope="module")
def controlnet_run(tmp_path_factory):
    """(root, the JAX base's params.npz, the port's ControlNet work dir)."""
    root = tmp_path_factory.mktemp("controlnet_cli")
    make = _load("make_tiny_data", os.path.join(REPO, "tools", "make_tiny_data.py"))
    rng = np.random.RandomState(0)
    make.make_motionx(str(root / "data_tiny"), rng)
    make.make_beat2(str(root / "data_tiny"), rng, t=48)  # 5 windows of 16 frames
    base = Config.fromfile(S2G_CONFIG).model["model"]["base_model"]
    (root / "t2m_base.py").write_text(
        f"_base_ = [{S2G_CONFIG!r}]\nmodel = dict(model=dict(_delete_=True, **{base!r}))\n")
    pipeline = [dict(type="Normalize", mean_path="./data_tiny/stats/mean.npy",
                     std_path="./data_tiny/stats/std.npy"),
                dict(type="ContrlCrop", crop_size=16),
                dict(type="ToTensor", keys=["motion", "motion_mask"]),
                dict(type="Collect", keys=["motion", "motion_mask", "motion_length"],
                     meta_keys=["text"])]
    speech = dict(_delete_=True, type="SpeechMotionDataset", dataset_name="beats2",
                  data_prefix="./data_tiny", ann_file="train.txt", pipeline=pipeline,
                  ann_config=os.path.join(REPO, "configs", "tests", "tiny_beat2.yaml"))
    (root / "s2g_train.py").write_text(
        f"_base_ = [{S2G_CONFIG!r}]\ndata = dict(samples_per_gpu=4, workers_per_gpu=0, "
        f"train={speech!r})\nmodel = dict(model=dict(unfreeze_mode='root_face_hand'))\n")
    _finish(_jax_cli(root, "train.py", "t2m_base.py", "--work-dir", "jax_base",
                     "--max-epochs", "1"))
    cwd = os.getcwd()
    os.chdir(root)
    try:
        torch_train.main(["s2g_train.py", "--device", "cpu", "--work-dir", "port_s2g",
                          "--base-checkpoint", "jax_base/params.npz", "--max-epochs", "2"])
    finally:
        os.chdir(cwd)
    return root, root / "jax_base" / "params.npz", root / "port_s2g"


def test_controlnet_trains_from_a_jax_base(controlnet_run):
    root, base_npz, work = controlnet_run
    base = checkpoint.load_params(str(base_npz))
    assert set(base) == {"params"}
    got = checkpoint.load_params(str(work / "params.npz"))
    assert set(got) == {"params", "batch_stats"}
    with open(work / "train.log") as f:
        log = f.read()
    assert "loaded base checkpoint jax_base/params.npz" in log
    assert "dataset: 5 samples, 1 steps/epoch" in log  # (48 - 16) / 8 + 1 windows
    cfg = Config.fromfile(str(root / "s2g_train.py"))
    arch = build_architecture(cfg.model, device="cpu")
    trainable = {n for n, _ in freeze(arch.model, torch_train.frozen_prefixes(cfg.model["model"]))}
    sd_base = {"base_model." + k: v for k, v in from_jax_params(base["params"]).items()}
    sd_got = from_jax_variables(got)
    n_frozen = 0
    for name, value in sd_base.items():
        if name in trainable:
            continue
        n_frozen += 1
        assert torch.equal(sd_got[name], value), f"frozen {name} moved"
    assert n_frozen > 100
    heads = [n for n in trainable if n.startswith("base_model.")]
    assert heads and all(not torch.equal(sd_got[n], sd_base[n]) for n in heads
                         if not n.startswith("base_model.out.face_out."))
    # the control block started as base block 0 and trained from there
    ctrl = [n for n in sd_got if n.startswith("controlnet_0.copied_block.")]
    assert ctrl and sum(not torch.equal(
        sd_got[n], sd_base[n.replace("controlnet_0.copied_block.", "base_model.block_0.")])
        for n in ctrl) > len(ctrl) // 2
    stats = [n for n in sd_got if n.endswith("running_var")]
    assert len(stats) == 16 and all(not torch.equal(sd_got[n], torch.ones_like(sd_got[n]))
                                    for n in stats)


def test_both_s2g_clis_read_the_port_trained_controlnet(controlnet_run, monkeypatch):
    root, _, work = controlnet_run
    argv = [S2G_CONFIG, "--checkpoint", str(work / "params.npz"), "--beats2-args",
            os.path.join(REPO, "configs", "tests", "tiny_beat2.yaml")]
    proc = _jax_cli(root, "s2g_test.py", *argv, "--work-dir", "jax_eval")
    monkeypatch.chdir(root)
    tool = _load("torch_s2g_test", os.path.join(REPO, "tools", "torch_s2g_test.py"))
    tool.main([*argv, "--device", "cpu", "--work-dir", "port_eval"])
    _finish(proc)
    metrics = {}
    for side in ("jax_eval", "port_eval"):
        with open(root / side / "metrics.json") as f:
            metrics[side] = json.load(f)
    assert set(metrics["port_eval"]) == set(metrics["jax_eval"])
    assert all(np.isfinite(v) for v in metrics["port_eval"].values()
               if isinstance(v, float))
