"""The port's ancestral DDPM sampler against the JAX package's: the whole
``p_sample_loop`` (a respaced 1000-step schedule cut to 20 steps) with a
model both sides compute alike, on the JAX run's own draws replayed, for
each mean and variance type, with and without a pre-sequence and with the
x0 processing; and tools/torch_test.py on a tiny DDPM config on the CPU,
with bf16 and int8 on that baseline (metrics.json as the JAX package's
tools/test.py writes it) and the step cache refused.  Tolerance: 1e-5 x
max(1, max |JAX|), as the DDIM loop of test_torch_sample.py is held."""

import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motioncraft_tpu.diffusion import build_diffusion as jax_diffusion
from motioncraft_tpu.diffusion import p_sample_loop as jax_p_sample_loop
from motioncraft_tpu_torch.diffusion import Replay, build_diffusion, p_sample_loop
from torch_port_util import assert_close_scaled, jax_ddpm_draws, t

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 20
SHAPE = (2, 8, 5)
PRE = 3


def _model_j(x, ts):
    return jnp.tanh(x) * 0.5 + 1e-4 * ts[:, None, None]


def _model_t(x, ts):
    return torch.tanh(x) * 0.5 + 1e-4 * ts[:, None, None]


def _clip_fn_j(v):
    return v * 0.9


def _clip_fn_t(v):
    return v * 0.9


@pytest.mark.parametrize("pre", [False, True], ids=["plain", "pre_seq"])
@pytest.mark.parametrize("var_type", ["fixed_small", "fixed_large"])
@pytest.mark.parametrize("mean_type", ["epsilon", "start_x"])
def test_p_sample_loop_on_replayed_draws(mean_type, var_type, pre):
    cfg = dict(beta_scheduler="linear", diffusion_steps=1000, model_mean_type=mean_type,
               model_var_type=var_type, respace=str(STEPS))
    dj, dt = jax_diffusion(cfg), build_diffusion(cfg)
    assert dt.num_timesteps == dj.num_timesteps == STEPS
    rs = np.random.RandomState(0)
    noise = rs.randn(*SHAPE).astype(np.float32)
    pre_seq = rs.randn(SHAPE[0], PRE, SHAPE[2]).astype(np.float32) if pre else None
    rng = jax.random.PRNGKey(7)
    want = np.asarray(jax.jit(lambda n, r, p: jax_p_sample_loop(dj, _model_j, n, r, pre_seq=p))(
        noise, rng, pre_seq))
    draws = jax_ddpm_draws(STEPS, rng, SHAPE, pre_len=PRE if pre else None, initial=False)
    replay = Replay(draws)
    got = p_sample_loop(dt, _model_t, t(noise), randn=replay,
                        pre_seq=None if pre_seq is None else t(pre_seq)).sample.numpy()
    assert replay.done()  # one step noise a step, t = 0 included
    assert np.abs(want).max() > 1e-2
    assert_close_scaled(got, want, 1e-5, f"ddpm {mean_type} {var_type}")


def test_p_sample_loop_processes_x0():
    """clip_denoised and denoised_fn act on the predicted x0 before the
    posterior mean, as the JAX package's p_mean_variance does."""
    cfg = dict(beta_scheduler="cosine", diffusion_steps=1000, model_mean_type="start_x",
               model_var_type="fixed_small", respace=str(STEPS))
    dj, dt = jax_diffusion(cfg), build_diffusion(cfg)
    noise = (np.random.RandomState(1).randn(*SHAPE) * 3).astype(np.float32)
    rng = jax.random.PRNGKey(3)

    def model_j(x, ts):
        return x * 2.0

    want = np.asarray(jax.jit(lambda n, r: jax_p_sample_loop(
        dj, model_j, n, r, clip_denoised=True, denoised_fn=_clip_fn_j))(noise, rng))
    got = p_sample_loop(dt, lambda x, ts: x * 2.0, t(noise),
                        randn=Replay(jax_ddpm_draws(STEPS, rng, SHAPE, initial=False)),
                        clip_denoised=True, denoised_fn=_clip_fn_t).sample.numpy()
    assert_close_scaled(got, want, 1e-5, "ddpm clip_denoised")
    unclipped = p_sample_loop(dt, lambda x, ts: x * 2.0, t(noise),
                              randn=Replay(jax_ddpm_draws(STEPS, rng, SHAPE, initial=False))
                              ).sample.numpy()
    assert np.abs(unclipped - got).max() > 1e-2  # the clipping mattered


# ---------------------------------------------------------- the CLI
def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


TINY_DDPM = """_base_ = [{base!r}]
model = dict(_delete_=True, type='MotionDiffusion',
             model=dict(type='MotionDiffuseTransformer', input_feats=322, max_seq_len=16,
                        latent_dim=32, time_embed_dim=32, num_layers=2,
                        sa_block_cfg=dict(type='EfficientSelfAttention', latent_dim=32,
                                          num_heads=4, dropout=0, time_embed_dim=32),
                        ca_block_cfg=dict(type='EfficientCrossAttention', latent_dim=32,
                                          text_latent_dim=16, num_heads=4, dropout=0,
                                          time_embed_dim=32),
                        ffn_cfg=dict(latent_dim=32, ffn_dim=64, dropout=0,
                                     time_embed_dim=32),
                        text_encoder=dict(pretrained_model='clip', latent_dim=16,
                                          num_layers=2, num_heads=4, ff_size=32, dropout=0,
                                          use_text_proj=True, clip_width=32,
                                          clip_layers=2)),
             loss_recon=dict(type='MSELoss', loss_weight=1, reduction='none'),
             diffusion_test=dict(beta_scheduler='linear', diffusion_steps=1000,
                                 model_mean_type='epsilon', model_var_type='fixed_small',
                                 respace='8'),
             inference_type='ddpm')
"""


@pytest.fixture(scope="module")
def ddpm_workdir(tmp_path_factory):
    """./data_tiny (Motion-X only) and a tiny MotionDiffuse DDPM config over
    it, with a seeded snapshot of its weights."""
    from motioncraft_tpu_torch.config import Config
    from motioncraft_tpu_torch.registry import build_architecture
    from motioncraft_tpu_torch.utils.checkpoint import save_params
    from motioncraft_tpu_torch.utils.convert import fabricate_state_dict

    root = tmp_path_factory.mktemp("ddpm_cli")
    make = _load("make_tiny_data", os.path.join(REPO, "tools", "make_tiny_data.py"))
    make.make_motionx(str(root / "data_tiny"), np.random.RandomState(0))
    cfg_path = root / "tiny_ddpm.py"
    cfg_path.write_text(TINY_DDPM.format(base=os.path.join(REPO, "configs", "tests",
                                                          "tiny_t2m.py")))
    arch = build_architecture(Config.fromfile(str(cfg_path)).model, device="cpu")
    arch.model.load_state_dict(fabricate_state_dict(arch.model, seed=2))
    save_params(str(root / "params.npz"), arch.model)
    return root


def test_torch_test_cli_runs_a_ddpm_config(ddpm_workdir, monkeypatch):
    torch_test = _load("torch_test", os.path.join(REPO, "tools", "torch_test.py"))
    monkeypatch.chdir(ddpm_workdir)
    run = torch_test.main([str(ddpm_workdir / "tiny_ddpm.py"), "out", "--device", "cpu",
                           "--batch-size", "4", "--checkpoint",
                           str(ddpm_workdir / "params.npz")])
    arch, out = run["arch"], run["out"]
    assert arch.inference_type == "ddpm" and arch.diffusion_test.num_timesteps == 8
    assert type(arch.model).__name__ == "MotionDiffuseTransformer"
    assert len(run["results"]) == 12  # 6 clips x 2 replications
    pred = np.stack([np.asarray(r["pred_motion"]) for r in run["results"]])
    assert pred.shape == (12, 16, 322) and np.isfinite(pred).all()
    metric = {k: v for k, v in out.items() if k not in ("flags", "protocol")}
    assert len(metric) == 8 and all(np.isfinite(v) for v in metric.values())
    with open(ddpm_workdir / "out" / "metrics.json") as f:
        assert json.load(f) == out
    # the snapshot's weights were loaded
    snap = np.load(ddpm_workdir / "params.npz")
    np.testing.assert_array_equal(arch.model.state_dict()["joint_embed.weight"].numpy(),
                                  snap["params/joint_embed/kernel"].T)


LOWPREC = (("--bf16",), ("--int8",), ("--int8-mode", "w8"))


@pytest.fixture(scope="module")
def jax_lowprec_runs(ddpm_workdir):
    """The JAX package's tools/test.py on the tiny DDPM config and snapshot
    with each low-precision option, the three processes at once: {argv:
    (return code, metrics.json or the output's tail)}."""
    import subprocess
    import sys

    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu", HOME=str(ddpm_workdir))
    procs = {}
    for i, argv in enumerate(LOWPREC):
        procs[argv] = subprocess.Popen(
            [sys.executable, os.path.join(REPO, "tools", "test.py"),
             str(ddpm_workdir / "tiny_ddpm.py"), f"jax_lp{i}", "--batch-size", "4",
             "--checkpoint", str(ddpm_workdir / "params.npz"), *argv],
            env=env, cwd=str(ddpm_workdir), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    out = {}
    for i, (argv, proc) in enumerate(procs.items()):
        log, _ = proc.communicate(timeout=900)
        if proc.returncode:
            out[argv] = (proc.returncode, log[-3000:])
        else:
            with open(ddpm_workdir / f"jax_lp{i}" / "metrics.json") as f:
                out[argv] = (0, json.load(f))
    return out


@pytest.mark.parametrize("argv", [["--bf16"], ["--int8"], ["--int8-mode", "w8"],
                                  ["--step-cache", "2"]])
def test_lowprec_options_are_refused_on_a_baseline(ddpm_workdir, monkeypatch, argv,
                                                   request):
    """bf16 and int8 run on a baseline (K5's bf16 instantiation on the
    card): finite metrics whose keys and flags are those the JAX package's
    tools/test.py writes with the same option (the draws differ, so the
    values do).  The step cache stays refused by the sampler, with the JAX
    package's words: DDPM has none."""
    torch_test = _load("torch_test", os.path.join(REPO, "tools", "torch_test.py"))
    monkeypatch.chdir(ddpm_workdir)
    if argv[0] == "--step-cache":
        with pytest.raises(ValueError, match="step caching requires inference_type='ddim'"):
            torch_test.main([str(ddpm_workdir / "tiny_ddpm.py"), "out_lp", "--device",
                             "cpu", "--batch-size", "4", *argv])
        return
    run = torch_test.main([str(ddpm_workdir / "tiny_ddpm.py"), "out_lp", "--device", "cpu",
                           "--batch-size", "4", "--checkpoint",
                           str(ddpm_workdir / "params.npz"), *argv])
    arch, out = run["arch"], run["out"]
    rc, want = request.getfixturevalue("jax_lowprec_runs")[tuple(argv)]
    assert rc == 0, want
    assert sorted(out) == sorted(want) and out["flags"] == want["flags"]
    assert out["protocol"] == want["protocol"]
    metric = {k: v for k, v in out.items() if k not in ("flags", "protocol")}
    assert len(metric) == 8 and all(np.isfinite(v) for v in metric.values())
    pred = np.stack([np.asarray(r["pred_motion"]) for r in run["results"]])
    assert pred.dtype == np.float32 and np.isfinite(pred).all()
    if argv == ["--bf16"]:
        assert arch.model.joint_embed.weight.dtype == torch.bfloat16
