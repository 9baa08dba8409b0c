"""tools/torch_train.py on the baseline configs, on the CPU, at tiny widths
over synthetic trees in the shipped configs' data paths (each config
``_base_``s a shipped one, keeps its data block, optimizer and lr policy,
and narrows the model):

- one epoch of MotionDiffuse (motiondiffuse_t2m.py: the HumanML3D train
  split), MCM (mcm_t2m_smplx.py: Motion-X's humanml3d_align_train_val.txt),
  MDM (mdm_kit.py: the KIT-ML train split) and FineMoGen
  (finemogen_t2m.py, HumanML3D), each with finite losses, params.npz and
  its CLIP bit for bit where the CLI's model started;
- the JAX package's tools/train.py on the same MotionDiffuse config and
  tree: the same dataset line and a params.npz of the same names and
  shapes;
- the JAX package cannot train MCM at the shipped 196 frames: its
  ``Architecture.init`` traces the model at 16 frames, which sizes the
  channel attention's parameters by the frame count (ROADMAP queue 3);
- the MCM ControlNet (mcm_m2d_finedance.py with a data block of the
  FineDance keys only) from the port's MCM base with --base-checkpoint:
  every frozen base leaf of its params.npz the base's bit for bit, the
  copied block is base block 0, the zero-initialised projections moved;
- the CLI's checks: all fourteen baseline and MCM ControlNet configs pass
  them; ReMoDiffuse and MoMatMoGen are refused, naming the JAX loss that
  passes no retrieval.
"""

import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from motioncraft_tpu_torch.config import Config
from motioncraft_tpu_torch.data.datasets import finedance_split
from motioncraft_tpu_torch.parallel import freeze
from motioncraft_tpu_torch.registry import build_architecture
from motioncraft_tpu_torch.utils import checkpoint
from motioncraft_tpu_torch.utils.convert import from_jax_params, from_jax_variables
from test_torch_baselines import mcm_cfg, mdm_cfg, motiondiffuse_cfg
from test_torch_mcm_controlnet import control_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(REPO, "configs")
T = 196  # the shipped crops; MCM's channel attention reads all 196 frames
N_CLIPS, BATCH = 8, 4
JAX_ENV = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
TRAINED = [os.path.join(d, f) for d, f in (
    ("motiondiffuse", "motiondiffuse_t2m.py"), ("motiondiffuse", "motiondiffuse_kit.py"),
    ("motiondiffuse", "motiondiffuse_t2m_smplx.py"), ("mcm", "mcm_t2m.py"),
    ("mcm", "mcm_t2m_smplx.py"), ("mdm", "mdm_t2m.py"), ("mdm", "mdm_kit.py"),
    ("mdm", "mdm_t2m_official.py"), ("mdm", "mdm_t2m_smplx.py"),
    ("finemogen", "finemogen_t2m.py"), ("finemogen", "finemogen_kit.py"),
    ("finemogen", "finemogen_t2m_smplx.py"), ("mcm", "mcm_s2g_beats2.py"),
    ("mcm", "mcm_m2d_finedance.py"))]


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


torch_train = _load("torch_train", os.path.join(REPO, "tools", "torch_train.py"))
smoke = _load("chip_smoke", os.path.join(REPO, "chip_smoke.py"))


def _wide(cfg, feats):
    """A tests/test_torch_baselines.py family config at ``feats`` features and
    the shipped crop."""
    m = cfg["model"]
    m["input_feats"] = feats
    if "max_seq_len" in m:  # MDM has none: its position table covers 999 frames
        m["max_seq_len"] = T
    if m["type"] == "MCMTransformer":
        m["sa_block_cfg"]["latent_dim"] = T
    return m


def finemogen_hml():
    """FineMoGen on HumanML3D's layout (8 body-part heads), narrowed."""
    sami = dict(type="SAMI", latent_dim=8, text_latent_dim=16, num_heads=8, num_text_heads=1,
                num_experts=4, topk=2, gate_type="cosine_top", gate_noise=1.0, ffn_dim=16,
                time_embed_dim=32, max_seq_len=T, max_text_seq_len=77, temporal_comb=False,
                dropout=0)
    return dict(type="FineMoGenTransformer", input_feats=263, max_seq_len=T, latent_dim=64,
                time_embed_dim=32, num_layers=2, ca_block_cfg=sami,
                ffn_cfg=dict(latent_dim=8, ffn_dim=16, dropout=0, time_embed_dim=32,
                             num_heads=8),
                text_encoder=dict(pretrained_model="clip", latent_dim=16, num_layers=1,
                                  ff_size=16, dropout=0, use_text_proj=False, clip_width=32,
                                  clip_layers=1),
                pose_encoder_cfg=dict(dataset_name="human_ml3d", latent_dim=8, input_dim=263),
                pose_decoder_cfg=dict(dataset_name="human_ml3d", latent_dim=8,
                                      output_dim=263),
                scale_func_cfg=dict(scale=6.5), moe_route_loss_weight=10.0,
                template_kl_loss_weight=0.0001)


def mcm_base():
    return _wide(mcm_cfg(), 322)


def m2d_model():
    """mcm_m2d_finedance.py's ControlNet over ``mcm_base``, one control block."""
    m = control_model("music")
    m["base_model"] = mcm_base()
    return m


# run -> (shipped config, its narrowed model, what its data block changes)
RUNS = {
    "motiondiffuse": ("motiondiffuse/motiondiffuse_t2m.py",
                      lambda: _wide(motiondiffuse_cfg(), 263), {}),
    # the shipped Motion-X set repeats 100 times an epoch
    "mcm": ("mcm/mcm_t2m_smplx.py", mcm_base, dict(train=dict(times=1))),
    "mdm": ("mdm/mdm_kit.py", lambda: _wide(mdm_cfg(), 251), {}),
    "finemogen": ("finemogen/finemogen_t2m.py", finemogen_hml, {}),
}


def write_config(root, name, shipped, model, data):
    path = root / f"{name}.py"
    data = dict(dict(samples_per_gpu=BATCH, workers_per_gpu=0), **data)
    path.write_text(f"_base_ = [{os.path.join(CONFIGS, shipped)!r}]\n"
                    f"model = dict(model=dict(_delete_=True, **{model!r}))\n"
                    f"data = {data!r}\ncheckpoint_config = dict(interval=1)\n"
                    "log_config = dict(interval=1)\n")
    return str(path)


def write_trees(root):
    """./data: HumanML3D and KIT-ML train splits, Motion-X in the
    HumanML3D-aligned layout, FineDance train tracks (360 + 200 frames: one
    196-frame crop each after the head trim)."""
    data = str(root / "data")
    for feats, dataset, seed in ((263, "human_ml3d", 1), (251, "kit_ml", 2)):
        smoke.write_humanml3d_tree(data, N_CLIPS, T, seed, feats=feats, dataset=dataset)
        d = os.path.join(data, "datasets", dataset)
        os.replace(os.path.join(d, "test.txt"), os.path.join(d, "train.txt"))
    smoke.write_motionx_tree(data, N_CLIPS, 120, 3, smoke.MIX_MOTIONX)
    smoke.write_finedance_tree(data, finedance_split("cross_genre")[0][:BATCH], 200, 4)


M2D_DATA = dict(
    _delete_=True,
    train=dict(type="FinedanceMotionDataset", dataset_name="finedance", data_prefix="./data",
               ann_file="train.txt", motion_dir="motion_fea163", text_dir="label_json",
               datasplit="cross_genre", music_dir="music_npy", pipeline=[
                   dict(type="Normalize", mean_path="./data/datasets/finedance/mean.npy",
                        std_path="./data/datasets/finedance/std.npy"),
                   dict(type="ContrlCrop", crop_size=T, stride=30),
                   dict(type="ToTensor", keys=["motion", "motion_mask"]),
                   dict(type="Collect", keys=["motion", "motion_mask", "motion_length"],
                        meta_keys=["text"])]))


def _cli(root, *argv):
    cwd = os.getcwd()
    os.chdir(root)
    try:
        return torch_train.main([*argv, "--device", "cpu", "--max-epochs", "1"])
    finally:
        os.chdir(cwd)


def _log(work):
    with open(os.path.join(work, "train.log")) as f:
        return f.read()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(root, {run: (config, work dir)}): the JAX package's tools/train.py on
    the MotionDiffuse config in a process of its own beside the port's four
    runs, then the port's M2D ControlNet from the port's MCM base."""
    root = tmp_path_factory.mktemp("baseline_cli")
    write_trees(root)
    configs = {name: write_config(root, name, shipped, model(), data)
               for name, (shipped, model, data) in RUNS.items()}
    jax_run = subprocess.Popen(
        [sys.executable, os.path.join(REPO, "tools", "train.py"), configs["motiondiffuse"],
         "--work-dir", "jax_motiondiffuse", "--max-epochs", "1"], env=dict(JAX_ENV, HOME=str(root)), cwd=str(root),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    out = {}
    try:
        for name, config in configs.items():
            _cli(root, config, "--work-dir", f"port_{name}")
            out[name] = (config, root / f"port_{name}")
    finally:
        log, _ = jax_run.communicate(timeout=600)
    assert jax_run.returncode == 0, log[-5000:]
    out["m2d"] = (write_config(root, "m2d", "mcm/mcm_m2d_finedance.py", m2d_model(),
                               M2D_DATA), root / "port_m2d")
    _cli(root, out["m2d"][0], "--work-dir", "port_m2d", "--base-checkpoint",
         "port_mcm/params.npz")
    return root, out


def _initial(config):
    """The CLI's starting weights: its seed, then the model built."""
    torch.manual_seed(0)
    return build_architecture(Config.fromfile(config).model, device="cpu").model.state_dict()


@pytest.mark.parametrize("name", sorted(RUNS))
def test_one_epoch_of_each_family(runs, name):
    root, out = runs
    config, work = out[name]
    log = _log(work)
    assert f"dataset: {N_CLIPS} samples, {N_CLIPS // BATCH} steps/epoch" in log
    losses = [float(ln.split(" loss=")[1].split()[0]) for ln in log.splitlines()
              if " loss=" in ln]
    assert len(losses) == N_CLIPS // BATCH and np.isfinite(losses).all()
    if name == "finemogen":
        assert "moe_route_loss=" in log and "template_kl_loss=" in log
    got = from_jax_variables(checkpoint.load_params(str(work / "params.npz")))
    start = _initial(config)
    assert set(got) == set(start)
    clip = [k for k in start if k.startswith("clip." if name == "mdm" else "text_enc.clip.")]
    assert clip and all(torch.equal(got[k], start[k]) for k in clip)
    # the output head moved; behind a zero-initialised head (all but MDM's)
    # and zero-initialised residual projections the gradient reaches one
    # layer further each step, so two steps leave the deeper leaves where
    # they were (tests/test_torch_baseline_train.py holds every gradient)
    head = [k for k in start if k.startswith("poseFinal." if name == "mdm" else "out.")]
    assert head and all(not torch.equal(got[k], start[k]) for k in head)


def test_jax_trains_the_same_config_alike(runs):
    """The JAX package's tools/train.py on the same config and tree: the
    same dataset line, and a params.npz of the same names and shapes."""
    root, out = runs
    jax_log = _log(root / "jax_motiondiffuse")
    assert f"dataset: {N_CLIPS} samples, {N_CLIPS // BATCH} steps/epoch" in jax_log
    want = checkpoint.load_params(str(root / "jax_motiondiffuse" / "params.npz"))
    got = checkpoint.load_params(str(out["motiondiffuse"][1] / "params.npz"))
    flat = {}
    for side, tree in (("jax", want), ("port", got)):
        flat[side] = {k: v.shape for k, v in from_jax_params(tree["params"]).items()}
    assert flat["jax"] == flat["port"]


def test_jax_cannot_train_mcm_at_196_frames():
    """The JAX package's Architecture.init traces a batch cut to 16 frames;
    MCM's channel attention normalises over the frames, so the init makes
    its parameters 16 wide, and the training apply at 196 frames stops. The
    port builds them at the config's width."""
    import jax
    from flax.errors import ScopeParamShapeError

    import motioncraft_tpu.models  # noqa: F401  (registers the flax classes)
    from motioncraft_tpu.apis.factory import make_text_batch
    from motioncraft_tpu.registry import build_architecture as build_jax

    cfg = mcm_cfg()
    _wide(cfg, 322)
    arch_j = build_jax(cfg)
    batch = make_text_batch(["a person walks"] * 2, max_seq_len=T)
    params = arch_j.init(jax.random.PRNGKey(0), batch)["params"]
    assert params["block_0"]["sa_block"]["norm"]["scale"].shape == (16,)
    with pytest.raises(ScopeParamShapeError, match=r"expected to generate shape \(196,\)"):
        arch_j.loss({"params": params}, batch, jax.random.PRNGKey(1))
    port = build_architecture(cfg, device="cpu").model
    assert port.block_0.sa_block.norm.weight.shape == (T,)


def test_mcm_controlnet_from_a_base(runs):
    root, out = runs
    config, work = out["m2d"]
    log = _log(work)
    assert "loaded base checkpoint port_mcm/params.npz" in log
    assert f"dataset: {BATCH} samples, 1 steps/epoch" in log
    base = from_jax_params(checkpoint.load_params(str(root / "port_mcm" / "params.npz"))["params"])
    got = from_jax_variables(checkpoint.load_params(str(work / "params.npz")))
    cfg = Config.fromfile(config).model
    model = build_architecture(cfg, device="cpu").model
    trainable = {n for n, _ in freeze(model, torch_train.frozen_prefixes(cfg["model"]))}
    frozen = [n for n in got if n.startswith("base_model.") and n not in trainable]
    assert len(frozen) > 50
    assert all(torch.equal(got[n], base[n[len("base_model."):]]) for n in frozen)
    # the base's Linear joint embedding and output train; the copied block
    # is base block 0, which its one step leaves where it was (the
    # zero-initialised after_proj passes it no gradient yet), and the
    # zero-initialised projections around it moved
    assert {n for n in trainable if n.startswith("base_model.")} == {
        f"base_model.{m}.{p}" for m in ("joint_embed", "out.linear") for p in ("weight", "bias")}
    ctrl = [n for n in got if n.startswith("controlnet_0.copied_block.")]
    assert ctrl and all(torch.equal(
        got[n], base[n.replace("controlnet_0.copied_block.", "block_0.")]) for n in ctrl)
    assert not torch.equal(got["controlnet_0.after_proj.linear.weight"],
                           torch.zeros_like(got["controlnet_0.after_proj.linear.weight"]))


@pytest.mark.parametrize("config", TRAINED, ids=[os.path.basename(p)[:-3] for p in TRAINED])
def test_the_cli_accepts_the_baselines(config):
    cfg = Config.fromfile(os.path.join(CONFIGS, config))
    torch_train.check_config(cfg)
    assert cfg.model["model"]["type"] not in torch_train.RETRIEVAL_MODELS


@pytest.mark.parametrize("model_type", ["ReMoDiffuseTransformer", "MoMatMoGenTransformer"])
def test_retrieval_models_are_refused_before_anything_is_built(model_type, tmp_path):
    config = os.path.join(CONFIGS, "remodiffuse", "remodiffuse_t2m.py")
    argv = [config, "--device", "cpu", "--work-dir", str(tmp_path / "work")]
    if model_type == "MoMatMoGenTransformer":
        argv += ["--cfg-options", f"model.model.type={model_type}"]
    with pytest.raises(SystemExit, match="ROADMAP queue 3: ReMoDiffuse / MoMatMoGen training"):
        torch_train.main(argv)
    assert not (tmp_path / "work").exists()
