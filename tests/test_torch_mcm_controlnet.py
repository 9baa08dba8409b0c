"""The port's MCM ControlNet (models/controlnet.py:ControlT2MHalfMCM, over
models/baselines.py:MCMTransformer) against the JAX package at tiny widths
(a 3-layer MCM base 32 wide, one control block, 16-frame windows), on one
seeded flax tree carried over by ``from_jax_params`` / ``from_jax_variables``
with ``strict=True``, for both conditions of the two MCM configs: 163-d
music features (configs/mcm/mcm_m2d_finedance.py) and 16 kHz onset +
amplitude through the WavEncoder (configs/mcm/mcm_s2g_beats2.py):

- the test forward (one pass, no CFG, the pooled text added to the time
  embedding) with the condition on and off;
- ``encode_condition`` for a condition shorter, as long as and longer than
  the window;
- a released-layout merged ``.pth`` (MCM base + MCM copied blocks) loads
  tensor for tensor as through the JAX converter;
- tools/torch_m2d_test.py and tools/torch_s2g_test.py against
  tools/m2d_test.py and tools/s2g_test.py on a tiny MCM config written to
  tmp_path (window 16), on the same data, weights, evaluator and draws, at
  --recording-batch 1 and 2 (two recordings in lockstep);
- bf16 and int8 run; --step-cache exits and the sampler refuses the step
  cache, and there is no text MoE to hoist.

Tolerance: 1e-5 x max(1, max |JAX|) for the outputs and the sampled
motions (sums in another order); the metrics, which carry the motions
through the evaluator and FID's matrix square root, 1e-4 relative.
"""

import copy
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import unfreeze

import fabricate_torch as fab
import motioncraft_tpu.models  # noqa: F401  (registers the flax classes)
from motioncraft_tpu.eval.models import T2MContrastiveModel_SMPLX as JaxEvaluator
from motioncraft_tpu.models.tokenizer import tokenize
from motioncraft_tpu.registry import build_architecture as build_jax
from motioncraft_tpu.utils import torch_convert as jax_convert
from motioncraft_tpu.utils.checkpoint import save_params as jax_save_params
from motioncraft_tpu_torch.registry import build_architecture as build_torch
from motioncraft_tpu_torch.utils import checkpoint, torch_convert
from motioncraft_tpu_torch.utils.convert import from_jax_variables
from torch_port_util import (Replay, assert_close_scaled, jax_windowed_draws,
                             seeded_batch_stats, seeded_params, t)

REL, REL_METRIC = 1e-5, 1e-4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T, D, SPF, LAT, TE = 16, 322, 16000 // 30, 32, 32
KINDS = ("music", "wav")
TEXT = "A dancer is performing a Jazz dance in the modern style"


def base_model():
    return dict(type="MCMTransformer", input_feats=D, max_seq_len=T, latent_dim=LAT,
                time_embed_dim=TE, num_layers=3,
                sa_block_cfg=dict(type="EfficientSelfAttention", latent_dim=T, num_heads=4,
                                  dropout=0, time_embed_dim=TE),
                ca_block_cfg=dict(type="EfficientCrossAttention", latent_dim=LAT,
                                  text_latent_dim=16, num_heads=4, dropout=0,
                                  time_embed_dim=TE),
                ffn_cfg=dict(latent_dim=LAT, ffn_dim=64, dropout=0, time_embed_dim=TE),
                text_encoder=dict(pretrained_model="clip", latent_dim=16, num_layers=1,
                                  num_heads=4, ff_size=32, dropout=0, use_text_proj=True,
                                  clip_width=32, clip_layers=1))


def control_model(kind):
    """The denoiser of mcm_s2g_beats2.py (wav) or mcm_m2d_finedance.py
    (music), narrowed."""
    if kind == "wav":
        cond = dict(dataset_name="beats2", condition_pre_encode=True,
                    condition_pre_encode_type="wav", control_cond_feats=2,
                    condition_latent_dim=16, condition_cfg=True)
        feats = 2
    else:
        cond = dict(dataset_name="finedance", condition_pre_encode=False,
                    control_cond_feats=163, condition_cfg=True)
        feats = 163
    return dict(type="ControlT2MHalfMCM", base_model=base_model(), copy_blocks_num=1,
                control_cond_feats=feats, condition_encode_cfg=cond)


def arch_cfg(kind, respace="4"):
    diff = dict(beta_scheduler="linear", diffusion_steps=1000, model_mean_type="epsilon",
                model_var_type="fixed_small")
    return dict(type="MotionDiffusion", model=control_model(kind),
                loss_recon=dict(type="MSELoss", loss_weight=1, reduction="none"),
                diffusion_train=diff, diffusion_test=dict(diff, respace=respace),
                inference_type="ddim", loss_reduction="frame",
                repaint=dict(overlap_len=4))


def condition(kind, frames, seed, batch=2):
    rng = np.random.RandomState(seed)
    if kind == "music":
        return rng.randn(batch, frames, 163).astype(np.float32)
    n = frames * SPF
    amp = np.abs(rng.randn(batch, n) * 0.3)
    onset = (rng.rand(batch, n) < 2e-4).astype(np.float64)
    return np.stack([amp, onset], axis=-1).astype(np.float32)


def _batch(kind):
    return {"motion": np.zeros((2, T, D), np.float32),
            "motion_mask": np.ones((2, T), np.float32),
            "motion_length": np.full((2, 1), T, np.int32),
            "text_ids": tokenize([TEXT, "A dancer is performing a Hiphop dance"]),
            "c": condition(kind, T, 0)}


def seeded_variables(init, seed):
    v = jax.tree_util.tree_map(np.asarray, unfreeze(init))
    out = {"params": seeded_params(v["params"], seed)}
    if "batch_stats" in v:
        out["batch_stats"] = seeded_batch_stats(v["batch_stats"], seed + 100)
    return out


@pytest.fixture(scope="module", params=KINDS)
def pair(request):
    """(kind, JAX arch, its seeded variables, the port's arch)."""
    kind = request.param
    arch_j = build_jax(arch_cfg(kind))
    variables = seeded_variables(arch_j.init(jax.random.PRNGKey(0), _batch(kind)), 1)
    arch_t = build_torch(arch_cfg(kind), device="cpu")
    arch_t.model.load_state_dict(from_jax_variables(variables), strict=True)
    return kind, arch_j, variables, arch_t


def _jvars(variables):
    return jax.tree_util.tree_map(jnp.asarray, variables)


@pytest.mark.parametrize("with_c", [True, False], ids=["c_on", "c_off"])
def test_forward_test(pair, with_c):
    kind, arch_j, variables, arch_t = pair
    batch = _batch(kind)
    x = np.random.RandomState(3).randn(2, T, D).astype(np.float32)
    ts = np.array([499, 31], np.int32)
    c = batch["c"] if with_c else None
    v = _jvars(variables)
    xp, xf = arch_j.encode_text(v, batch["text_ids"])
    assert arch_j.model.apply(v, xf, method="precompute_text_feats") is None
    want = np.asarray(jax.jit(lambda v_: arch_j.model.apply(
        v_, x, ts, motion_mask=batch["motion_mask"], motion_length=batch["motion_length"],
        xf_out=xf, xf_proj=xp, c=c, mode="test"))(v))
    with torch.no_grad():
        xp_t, xf_t = arch_t.encode_text(batch["text_ids"])
        assert arch_t.model.precompute_text_feats(xf_t) is None
        got = arch_t.model(t(x), t(ts, torch.long), motion_mask=t(batch["motion_mask"]),
                           motion_length=t(batch["motion_length"]), xf_out=xf_t, xf_proj=xp_t,
                           c=None if c is None else t(c)).numpy()
    assert got.shape == (2, T, D) and np.abs(want).max() > 1e-2
    assert_close_scaled(got, want, REL, f"{kind} forward_test c={with_c}")


@pytest.mark.parametrize("frames", [10, T, 20], ids=["shorter", "equal", "longer"])
def test_encode_condition(pair, frames):
    kind, arch_j, variables, arch_t = pair
    c = condition(kind, frames, frames)
    want = np.asarray(jax.jit(lambda v_: arch_j.model.apply(
        v_, c, T, method="encode_condition"))(_jvars(variables)))
    with torch.no_grad():
        got = arch_t.model.encode_condition(t(c), T).numpy()
    assert got.shape == (2, T, LAT)
    assert_close_scaled(got, want, REL, f"{kind} encode_condition")


def test_wav_encoder_at_the_shipped_window():
    """mcm_s2g_beats2.py's window is 196 frames, 196 x 533 audio samples,
    which the WavEncoder turns into 194 frames (the JAX one alike):
    ``encode_condition`` pads the last two with zeros and adds the
    sequence embedding over the first 194, as the JAX package does."""
    from motioncraft_tpu.models.blocks import WavEncoder as JaxWavEncoder
    from motioncraft_tpu_torch.models.blocks import WavEncoder

    window = 196
    c = condition("wav", window, 9, batch=1)
    flax_enc = JaxWavEncoder(out_dim=16, audio_in=2)
    variables = seeded_variables(flax_enc.init(jax.random.PRNGKey(0), c[:, :SPF * 8]), 4)
    want = np.asarray(jax.jit(flax_enc.apply)(variables, c))
    enc = WavEncoder(16, audio_in=2).eval()
    enc.load_state_dict(from_jax_variables(variables), strict=True)
    with torch.no_grad():
        got = enc(t(c)).numpy()
    assert got.shape == want.shape == (1, window - 2, 16)
    assert_close_scaled(got, want, REL, "WavEncoder at 196 frames")


def test_exact_f32_only(pair):
    """The MCM ControlNet takes bf16 and int8 (a copy of the fixture's
    model): the casts run and a bf16 sample comes out finite and f32
    (tests/test_torch_baselines_{bf16,int8}.py hold it against the JAX
    package's); the sampler refuses the step cache with the JAX package's
    words, as the CLIs' --step-cache reaches it."""
    import copy

    from motioncraft_tpu_torch.apis import bf16_cast_, int8_quantize_
    from motioncraft_tpu_torch.diffusion import StepCacheConfig
    from motioncraft_tpu_torch.ops.quant import count_quantized

    kind, _, _, arch_t = pair
    assert not arch_t.model.supports_step_cache
    with pytest.raises(ValueError, match="ControlT2MHalfMCM does not support step caching"):
        arch_t.sample(_batch(kind), step_cache=StepCacheConfig(reuse_every=2))
    arch = copy.deepcopy(arch_t)
    bf16_cast_(arch)
    int8_quantize_(arch, min_elems=1)
    assert count_quantized(arch.model)[0] > 0
    got = arch.sample(_batch(kind), compute_dtype=torch.bfloat16,
                      generator=torch.Generator().manual_seed(0))
    assert got.dtype == torch.float32 and np.isfinite(got.numpy()).all()


def _merged_sd(params, kind, rng):
    """A released-layout merged MCM ControlNet state dict."""
    sd = fab.mcm_sd(params["base_model"], rng, 3, 1, 1, prefix="base_model.")
    blk = params["controlnet_0"]
    fab.mcm_layer(sd, "controlnet.0.copied_block", blk["copied_block"], rng)
    fab.lin(sd, "controlnet.0.after_proj", blk["after_proj"]["linear"], rng)
    fab.lin(sd, "controlnet.0.before_proj", blk["before_proj"], rng)
    if kind == "wav":
        fab.wav_encoder(sd, "condition_pre_encoder.pre_encoder",
                        params["condition_pre_encoder"], rng)
    fab.lin(sd, "control_cond_input", params["control_cond_input"]["linear"], rng)
    return {"model." + k: (np.asarray(v, np.float32) * 0.3) for k, v in sd.items()}


def test_merged_pth_loads_like_the_jax_route(pair, tmp_path):
    """The port's convert_controlnet(block_type="mcm") gives the JAX
    converter's trees; load_controlnet_ckpt and load_eval_variables give
    exactly the tensors of those trees carried over."""
    kind, _, variables, _ = pair
    sd = _merged_sd(variables["params"], kind, np.random.RandomState(0))
    dims = (3, 1, 1, 1, 1)
    want_tree = jax_convert.convert_controlnet(sd, *dims, block_type="mcm")
    got_tree = torch_convert.convert_controlnet(sd, *dims, block_type="mcm")
    for got_t, want_t in zip(got_tree, want_tree):
        assert (jax.tree_util.tree_structure(got_t)
                == jax.tree_util.tree_structure(want_t))
        for g, w in zip(jax.tree_util.tree_leaves(got_t), jax.tree_util.tree_leaves(want_t)):
            np.testing.assert_array_equal(g, w)
    assert bool(want_tree[1]) == (kind == "wav")

    path = str(tmp_path / "mcm_control.pth")
    torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in sd.items()}}, path)
    loaded = copy.deepcopy(variables)
    jax_convert._tree_update(loaded["params"], want_tree[0])
    if want_tree[1]:
        jax_convert._tree_update(loaded["batch_stats"], want_tree[1])
    want = from_jax_variables(loaded)
    model = build_torch(arch_cfg(kind), device="cpu").model
    got = torch_convert.load_controlnet_ckpt(path, model, *dims, block_type="mcm")
    assert sorted(got) == sorted(want)
    assert all(torch.equal(got[k], want[k]) for k in want)
    again = build_torch(arch_cfg(kind), device="cpu").model
    got = checkpoint.load_eval_variables(arch_cfg(kind), again, torch_checkpoint=path)
    assert all(torch.equal(got[k], want[k]) for k in want)


# ----------------------------------------------------------- the CLIs
EVALUATOR = dict(type="T2MContrastiveModel_SMPLX",
                 motion_encoder=dict(nfeats=322, vae=True, num_layers=1, latent_dim=32,
                                     ff_size=32, num_heads=2),
                 text_encoder=dict(num_layers=1, latent_dim=32, ff_size=32, num_heads=2,
                                   bert_cfg=dict(dim=32, n_layers=1, n_heads=2,
                                                 hidden_dim=64)))

# Runs a JAX CLI as its own __main__ and keeps what each call of the
# windowed samplers returned (the normalised motions, one per recording).
JAX_CLI_RUNNER = """
import runpy, sys
import numpy as np
import motioncraft_tpu.apis.windowed as w
outs, one, batch = [], w.windowed_sample, w.windowed_sample_batch
def keep(*a, **k):
    r = one(*a, **k)
    outs.append(np.asarray(r))
    return r
def keep_batch(*a, **k):
    r = batch(*a, **k)
    outs.extend(np.asarray(x) for x in r)
    return r
w.windowed_sample, w.windowed_sample_batch = keep, keep_batch
out, cli = sys.argv[1], sys.argv[2]
sys.argv = sys.argv[2:]
try:
    runpy.run_path(cli, run_name="__main__")
finally:
    np.savez(out, *outs)
"""


def _cli_config(tmp_path, kind):
    """A config file that ``_base_``s the MCM config of ``kind`` with the
    narrow model, a 16-frame window, DDIM over 4 steps, the tiny data
    trees and a tiny evaluator with seeded weights."""
    name = "mcm_s2g_beats2.py" if kind == "wav" else "mcm_m2d_finedance.py"
    ev = dict(EVALUATOR, init_cfg=dict(type="Pretrained",
                                       checkpoint=str(tmp_path / "evaluator.npz")))
    lines = [f"_base_ = [{os.path.join(REPO, 'configs', 'mcm', name)!r}]",
             f"model = dict(model=dict({control_model(kind)!r}, _delete_=True), "
             "diffusion_test=dict(respace='4'))",
             "windowed = dict(window=16, pre_frames=4)"]
    if kind == "music":
        # the FineDance test set alone: the shipped config's data.test also
        # holds the BEAT2 base's ann_config, which the JAX dataset refuses
        # (test_the_jax_m2d_cli_refuses_the_shipped_data_block)
        root = tmp_path / "data_tiny"
        test = dict(type="FinedanceMotionDataset", dataset_name="finedance",
                    data_prefix=str(root), ann_file="test.txt", motion_dir="motion_fea163",
                    text_dir="label_json", datasplit="cross_genre", music_dir="music_npy",
                    pipeline=[dict(type="Normalize",
                                   mean_path=str(root / "datasets" / "finedance" / "mean.npy"),
                                   std_path=str(root / "datasets" / "finedance" / "std.npy"))])
        lines.append(f"data = dict(test=dict({test!r}, _delete_=True), eval_model={ev!r})")
    else:
        lines.append(f"eval_model = {ev!r}")
    path = tmp_path / f"mcm_{kind}.py"
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def _load_tool(name):
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _second_beat2_recording(beat2, rs, name="2_alice_0_3_3", frames=28):
    """A second test recording in the tiny BEAT2 tree, shorter than the
    first: two windows, so at R = 2 the lockstep run samples a padded
    third window for it and drops it."""
    from scipy.io import wavfile

    first = "2_alice_0_2_2"
    with np.load(beat2 / "smplxflame_30" / f"{first}.npz") as f:
        arrays = {k: v if k == "betas" else (rs.randn(frames, v.shape[1]) * 0.1).astype(
            np.float32) for k, v in f.items()}
    np.savez(beat2 / "smplxflame_30" / f"{name}.npz", **arrays)
    wav = (rs.randn(frames * SPF) * 0.1 * 32767).astype(np.int16)
    wavfile.write(beat2 / "wave16k" / f"{name}.wav", 16000, wav)
    text = (beat2 / "textgrid" / f"{first}.TextGrid").read_text()
    (beat2 / "textgrid" / f"{name}.TextGrid").write_text(text)
    with open(beat2 / "train_test_split.csv", "a") as f:
        f.write(f"{name},test\n")


@pytest.fixture(scope="module")
def cli_root(tmp_path_factory):
    """The tiny FineDance trees (two tracks of 40 frames: three 16-frame
    windows overlapping by 4) and BEAT2 trees (recordings of 40 and 28
    frames), the evaluator's seeded weights and each kind's seeded
    denoiser snapshot."""
    root = tmp_path_factory.mktemp("mcm_cli")
    make = _load_tool("make_tiny_data")
    # FineDance drops a track's first 360 frames
    make.make_finedance(str(root / "data_tiny"), np.random.RandomState(0), t=400)
    make.make_beat2(str(root / "data_tiny"), np.random.RandomState(1), t=40)
    _second_beat2_recording(root / "data_tiny" / "beat2", np.random.RandomState(2))
    shapes = JaxEvaluator(**{k: v for k, v in EVALUATOR.items() if k != "type"})
    motion = seeded_params(jax.tree_util.tree_map(np.asarray,
                                                  shapes.motion_params["params"]), 1)
    text = seeded_params(jax.tree_util.tree_map(np.asarray,
                                                shapes.text_params["params"]), 2)
    jax_save_params(str(root / "evaluator.npz"), {"motion": {"params": motion},
                                                  "text": {"params": text}})
    for kind in KINDS:
        arch = build_jax(arch_cfg(kind))
        variables = seeded_variables(arch.init(jax.random.PRNGKey(0), _batch(kind)), 5)
        jax_save_params(str(root / f"{kind}.npz"), variables)
    yaml = (REPO + "/configs/tests/fixture_beat2.yaml")
    with open(yaml) as f:
        text_yaml = f.read()
    data = str(root / "data_tiny")
    (root / "beat2.yaml").write_text(
        text_yaml.replace("./tests/fixtures/mini/beat2/", data + "/beat2/")
        .replace("./tests/fixtures/mini/stats/", data + "/stats/"))
    return root


CLIS = {"music": ("m2d_test", "torch_m2d_test"), "wav": ("s2g_test", "torch_s2g_test")}
RECORDING_BATCHES = (1, 2)


def _cli_args(root, kind, R):
    extra = ["--beats2-args", str(root / "beat2.yaml")] if kind == "wav" else []
    return [_cli_config(root, kind), "--checkpoint", str(root / f"{kind}.npz"), "--seed",
            "3", "--recording-batch", str(R), *extra]


@pytest.fixture(scope="module")
def jax_runs(cli_root):
    """Both JAX CLIs at each --recording-batch, run at once, each in its
    own process: {(kind, R): (the normalised motions its windowed samplers
    returned, its metrics.json)}."""
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu", HOME=str(cli_root))
    procs = {(kind, R): subprocess.Popen(
        [sys.executable, "-c", JAX_CLI_RUNNER, str(cli_root / f"jax_{kind}_R{R}.npz"),
         os.path.join(REPO, "tools", f"{CLIS[kind][0]}.py"), *_cli_args(cli_root, kind, R),
         "--work-dir", str(cli_root / f"jax_{kind}_R{R}")],
        env=env, cwd=str(cli_root), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for kind in KINDS for R in RECORDING_BATCHES}
    runs = {}
    for (kind, R), proc in procs.items():
        log, _ = proc.communicate(timeout=600)
        assert proc.returncode == 0, log[-5000:]
        with np.load(cli_root / f"jax_{kind}_R{R}.npz") as f:
            motions = [f[k] for k in sorted(f.files, key=lambda s: int(s.split("_")[1]))]
        with open(cli_root / f"jax_{kind}_R{R}" / "metrics.json") as f:
            runs[kind, R] = motions, json.load(f)
    return runs


@pytest.mark.parametrize("R", RECORDING_BATCHES, ids=["R1", "R2"])
@pytest.mark.parametrize("kind", KINDS, ids=["m2d", "s2g"])
def test_cli_matches_the_jax_cli(cli_root, jax_runs, kind, R, monkeypatch):
    """One seeded snapshot through both packages' long-form CLI, one
    recording at a time (R = 1) and two in lockstep (R = 2, R rows a
    denoiser call): the port on the JAX run's draws (its key split per
    group of R recordings, folded per window), replayed.  The sampled
    motions of each recording agree to 1e-5 x scale, and metrics.json has
    the JAX CLI's keys, flags and values."""
    import motioncraft_tpu_torch.diffusion as port_diffusion
    from motioncraft_tpu.diffusion.sampling import RepaintConfig as JaxRepaint
    from motioncraft_tpu_torch.apis.windowed import denormalize

    want, want_metrics = jax_runs[kind, R]
    # the JAX CLI: rng = PRNGKey(seed), then per group rng, sub = split(rng)
    rng, draws = jax.random.PRNGKey(3), []
    for g0 in range(0, len(want), R):
        group = want[g0:g0 + R]
        rng, sub = jax.random.split(rng)
        rounds = max((len(motion) - 4) // 12 for motion in group)
        draws += jax_windowed_draws(4, JaxRepaint(overlap_len=4), sub, (len(group), T, D),
                                    rounds, 4)
    replay = Replay(draws)
    monkeypatch.setattr(port_diffusion, "generator_randn", lambda *a: replay)
    monkeypatch.chdir(cli_root)
    res = _load_tool(CLIS[kind][1]).main(_cli_args(cli_root, kind, R) + [
        "--device", "cpu", "--work-dir", str(cli_root / f"port_{kind}_R{R}")])
    assert replay.done() and len(res["preds"]) == len(want) >= R
    # both tiny trees normalise with mean 0 and std 1
    zero, one = np.zeros(D, np.float32), np.ones(D, np.float32)
    for pred, w in zip(res["preds"], want):
        assert len(w) > 16 and np.abs(w).max() > 1e-2
        assert_close_scaled(pred, denormalize(w, zero, one), REL, f"{kind} motion")
    got = res["out"]
    assert got["flags"] == want_metrics["flags"] and sorted(got) == sorted(want_metrics)
    for k, w in want_metrics.items():
        if isinstance(w, float):
            assert abs(got[k] - w) <= REL_METRIC * max(1.0, abs(w)), (k, got[k], w)


def test_the_jax_m2d_cli_refuses_the_shipped_data_block(cli_root):
    """configs/mcm/mcm_m2d_finedance.py takes data from both its bases, so
    its FineDance test set carries the BEAT2 base's ``ann_config``:
    tools/m2d_test.py stops there (the JAX dataset refuses the keyword).
    The port's dataset accepts and ignores it and reads the tracks the
    FineDance keys alone give (ROADMAP queue 3, departures)."""
    import motioncraft_tpu.data  # noqa: F401  (registers the JAX datasets)
    from motioncraft_tpu.config import Config as JaxConfig
    from motioncraft_tpu.registry import DATASETS as JAX_DATASETS
    from motioncraft_tpu_torch.config import Config
    from motioncraft_tpu_torch.registry import build_dataset

    shipped = os.path.join(REPO, "configs", "mcm", "mcm_m2d_finedance.py")
    test_j = dict(JaxConfig.fromfile(shipped).data["test"])
    test_t = dict(Config.fromfile(shipped).data["test"])
    assert test_t == test_j and test_j["ann_config"] == "configs/beat2/st_mogen_emage.yaml"
    root = str(cli_root / "data_tiny")
    for cfg in (test_j, test_t):
        cfg.update(data_prefix=root, test_mode=False, pipeline=[])
    with pytest.raises(TypeError, match="ann_config"):
        JAX_DATASETS.build(test_j)
    got = build_dataset(test_t).data_infos
    want = JAX_DATASETS.build({k: v for k, v in test_j.items() if k != "ann_config"}).data_infos
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g["text"] == w["text"]
        np.testing.assert_array_equal(g["motion"], w["motion"])
