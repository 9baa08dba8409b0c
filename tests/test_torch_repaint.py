"""RePaint-harmonized DDIM of the port against the JAX package: ``undo``,
the pre-sequence seeding, one DDIM step with outpainting (the late blend on
and off, the tail bank read at t with clip_idx 0 and > 0), the 84-step
harmonized loop of the M2D schedule ('15,15,8,6,6', jump 3 x 2), and
``MotionDiffusion.sample`` with ``outpainting`` and with ``pre_seq`` on the
tiny M2D ControlNet.  Both sides get the same draws: the port replays the
JAX key tree's normals (torch_port_util.jax_sample_draws).

Tolerances: 1e-5 x max(1, max |JAX|) for the schedule algebra with an
analytic model (elementwise float32 in another order); 1e-4 x max(1, max
|JAX|) through the denoiser, as tests/test_torch_sample.py (sums in another
order, erf from other libraries).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import motioncraft_tpu.models  # noqa: F401  (registers the flax classes)
from motioncraft_tpu.config import Config as JaxConfig
from motioncraft_tpu.diffusion import build_diffusion as jax_diffusion
from motioncraft_tpu.diffusion import gaussian as JG
from motioncraft_tpu.diffusion import sampling as JS
from motioncraft_tpu.models.tokenizer import tokenize
from motioncraft_tpu.registry import build_architecture as build_jax
from motioncraft_tpu_torch.config import Config
from motioncraft_tpu_torch.diffusion import build_diffusion, gaussian as G, sampling as S
from motioncraft_tpu_torch.registry import build_architecture as build_torch
from motioncraft_tpu_torch.utils.convert import from_jax_params
from torch_port_util import Replay, assert_close_scaled, jax_sample_draws, seeded_params, t

REL = 1e-5
MODEL_REL = 1e-4
CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "configs", "tests", "tiny_m2d.py")
DIFF = dict(beta_scheduler="linear", diffusion_steps=1000, model_mean_type="start_x",
            model_var_type="fixed_large", respace="15,15,8,6,6")
B, T, D, OV = 2, 12, 5, 4


@pytest.fixture(scope="module")
def diffusions():
    return jax_diffusion(DIFF), build_diffusion(DIFF)


def _model_j(x, ts):
    return jnp.tanh(x) * 0.5 + 1e-3 * ts[:, None, None].astype(jnp.float32)


def _model_t(x, ts):
    return torch.tanh(x) * 0.5 + 1e-3 * ts[:, None, None].to(torch.float32)


def _outpainting(rng, clip_idx=0, tails=False):
    gt = np.zeros((B, T, D), np.float32)
    gt[:, :OV] = rng.randn(B, OV, D)
    mask = np.zeros((B, T, D), bool)
    mask[:, :OV] = True
    bank = rng.randn(50, B, OV, D).astype(np.float32) if tails else None
    op_j = JS.Outpainting(mask=jnp.asarray(mask), gt=jnp.asarray(gt), clip_idx=clip_idx,
                          previous_noisy_tail=None if bank is None else jnp.asarray(bank))
    op_t = S.Outpainting(mask=t(mask), gt=t(gt), clip_idx=clip_idx,
                         previous_noisy_tail=None if bank is None else t(bank))
    return op_j, op_t


def test_undo_and_pre_seq(diffusions):
    dj, dt = diffusions
    rng = np.random.RandomState(0)
    x = rng.randn(B, T, D).astype(np.float32)
    ts = np.array([7, 30], np.int64)
    key = jax.random.PRNGKey(3)
    want = np.asarray(JG.undo(dj, jnp.asarray(x), jnp.asarray(ts), key))
    noise = np.asarray(jax.random.normal(key, x.shape, jnp.float32))
    assert_close_scaled(G.undo(dt, t(x), t(ts), t(noise)).numpy(), want, REL, "undo")

    pre = rng.randn(B, OV, D).astype(np.float32)
    want = np.asarray(JS._seed_pre_seq(dj, jnp.asarray(x), jnp.asarray(ts), jnp.asarray(pre),
                                       key))
    pre_noise = np.asarray(jax.random.normal(key, pre.shape, jnp.float32))
    got = S._seed_pre_seq(dt, t(x), t(ts), t(pre), Replay([pre_noise]))
    assert_close_scaled(got.numpy(), want, REL, "_seed_pre_seq")
    np.testing.assert_array_equal(got.numpy()[:, OV:], x[:, OV:])


@pytest.mark.parametrize("step,blend,same_tail,clip_idx", [
    (0, True, False, 0),     # the late blend: sqrt(1 - alpha_bar_prev) = 0
    (3, True, False, 0),     # still under 0.2
    (30, True, False, 0),    # over 0.2: no blend
    (3, False, False, 0),    # add_blend off
    (30, True, True, 0),     # tail kept, fresh noise (the first outpainted window)
    (3, True, True, 1),      # the previous window's tail at t replaces the noise
    (41, False, True, 2),
])
def test_ddim_step_with_outpainting(diffusions, step, blend, same_tail, clip_idx):
    dj, dt = diffusions
    rp_j = JS.RepaintConfig(overlap_len=OV, add_blend=blend, same_overlap_noisy=same_tail)
    rp_t = S.RepaintConfig(overlap_len=OV, add_blend=blend, same_overlap_noisy=same_tail)
    rng = np.random.RandomState(step)
    x = rng.randn(B, T, D).astype(np.float32)
    op_j, op_t = _outpainting(rng, clip_idx, tails=same_tail)
    key = jax.random.PRNGKey(11)
    want = JS.ddim_step(dj, _model_j, jnp.asarray(x), jnp.full((B,), step, jnp.int32), key,
                        outpainting=op_j, repaint=rp_j)
    draws = [] if same_tail and clip_idx > 0 else [np.asarray(jax.random.normal(
        jax.random.split(key, 4)[3], x.shape, jnp.float32))]
    source = Replay(draws)
    got = S.ddim_step(dt, _model_t, t(x), step, randn=source, outpainting=op_t, repaint=rp_t)
    assert source.done()
    for what, g, w in zip(("sample", "pred_xstart"), got, want):
        assert_close_scaled(g.numpy(), np.asarray(w), REL, what)
    assert (got[2] is None) == (want[2] is None) == (not same_tail)
    if same_tail:
        assert_close_scaled(got[2].numpy(), np.asarray(want[2]), REL, "saved tail")
    blended = blend and np.sqrt(1 - np.asarray(dj.alphas_cumprod_prev)[step]) < 0.2
    assert blended == (step in (0, 3) and blend)


def test_ddim_step_with_pre_seq(diffusions):
    dj, dt = diffusions
    rng = np.random.RandomState(5)
    x = rng.randn(B, T, D).astype(np.float32)
    pre = rng.randn(B, OV, D).astype(np.float32)
    key = jax.random.PRNGKey(2)
    want = JS.ddim_step(dj, _model_j, jnp.asarray(x), jnp.full((B,), 20, jnp.int32), key,
                        pre_seq=jnp.asarray(pre))
    draws = [np.asarray(jax.random.normal(jax.random.split(key, 4)[0], pre.shape, jnp.float32))]
    got = S.ddim_step(dt, _model_t, t(x), 20, randn=Replay(draws), pre_seq=t(pre))
    assert_close_scaled(got[0].numpy(), np.asarray(want[0]), REL, "sample")


def test_jump_schedule_has_84_steps_57_denoising():
    pairs = S.harmonize_schedule(50, S.RepaintConfig(jump_length=3, jump_n_sample=2))
    assert len(pairs) == 84 and sum(d for _, d in pairs) == 57
    assert pairs[0] == (29, True) and pairs[-1] == (0, True)


@pytest.mark.parametrize("same_tail,clip_idx", [(False, 0), (True, 0), (True, 1)])
def test_harmonized_loop(diffusions, same_tail, clip_idx):
    """The whole 84-step RePaint loop of an outpainted M2D window."""
    dj, dt = diffusions
    rp_j = JS.RepaintConfig(overlap_len=OV, same_overlap_noisy=same_tail)
    rp_t = S.RepaintConfig(overlap_len=OV, same_overlap_noisy=same_tail)
    rng = np.random.RandomState(7)
    noise = rng.randn(B, T, D).astype(np.float32)
    op_j, op_t = _outpainting(rng, clip_idx, tails=same_tail)
    key = jax.random.PRNGKey(4)
    want = JS.ddim_sample_loop(dj, _model_j, jnp.asarray(noise), key, outpainting=op_j,
                               repaint=rp_j)
    # the loop's draws: per step, key, sub = split(key)
    draws, key_loop = [], key
    for _, denoises in S.harmonize_schedule(50, rp_t):
        key_loop, sub = jax.random.split(key_loop)
        if not denoises:
            draws.append(np.asarray(jax.random.normal(sub, noise.shape, jnp.float32)))
        elif not (same_tail and clip_idx > 0):
            draws.append(np.asarray(jax.random.normal(jax.random.split(sub, 4)[3],
                                                      noise.shape, jnp.float32)))
    source = Replay(draws)
    got = S.ddim_sample_loop(dt, _model_t, t(noise), randn=source, outpainting=op_t,
                             repaint=rp_t)
    assert source.done()
    assert_close_scaled(got.sample.numpy(), np.asarray(want.sample), REL, "harmonized loop")
    if same_tail:
        assert_close_scaled(got.noisy_tail.numpy(), np.asarray(want.noisy_tail), REL, "tails")
    else:
        assert got.noisy_tail is None and want.noisy_tail is None


@pytest.fixture(scope="module")
def tiny_m2d():
    """The tiny M2D ControlNet (configs/tests/tiny_m2d.py) in both packages
    on one seeded flax tree, and a window batch with music."""
    cfg_j = JaxConfig.fromfile(CONFIG)
    arch_j = build_jax(cfg_j.model)
    rng = np.random.RandomState(0)
    batch = {"motion": np.zeros((1, 16, 322), np.float32),
             "motion_mask": np.ones((1, 16), np.float32),
             "motion_length": np.full((1, 1), 16, np.int32),
             "text_ids": tokenize(["A dancer is performing a Jazz dance in the modern style"]),
             "c": rng.randn(1, 16, 163).astype(np.float32)}
    variables = arch_j.init(jax.random.PRNGKey(0), batch)
    params = seeded_params(jax.tree_util.tree_map(np.asarray, variables["params"]), 1)
    variables = {"params": jax.tree_util.tree_map(jnp.asarray, params)}
    arch_t = build_torch(Config.fromfile(CONFIG).model, device="cpu")
    arch_t.model.load_state_dict(from_jax_params(params), strict=True)
    return arch_j, variables, arch_t, batch


@pytest.mark.parametrize("mode", ["outpainting", "outpainting_tail", "pre_seq"])
def test_sample_with_outpainting_or_pre_seq(tiny_m2d, mode):
    arch_j, variables, arch_t, batch = tiny_m2d
    same_tail = mode == "outpainting_tail"
    rp = dict(overlap_len=4, same_overlap_noisy=same_tail)
    arch_j.repaint_cfg = JS.RepaintConfig(**rp)
    arch_t.repaint_cfg = S.RepaintConfig(**rp)
    rng = np.random.RandomState(9)
    last = rng.randn(1, 16, 322).astype(np.float32)
    gt = np.zeros_like(last)
    gt[:, :4] = last[:, -4:]
    mask = np.zeros(last.shape, bool)
    mask[:, :4] = True
    key = jax.random.PRNGKey(6)
    shape = batch["motion"].shape
    if mode == "pre_seq":
        want = jax.jit(lambda v, b, r: arch_j.sample(v, b, r, pre_seq=last[:, -4:]))(
            variables, batch, key)
        draws = jax_sample_draws(4, arch_j.repaint_cfg, key, shape, pre_len=4)
        got = arch_t.sample(batch, randn=Replay(draws), pre_seq=t(last[:, -4:]))
    else:
        op = JS.Outpainting(mask=jnp.asarray(mask), gt=jnp.asarray(gt))
        want = jax.jit(lambda v, b, r: arch_j.sample(v, b, r, outpainting=op))(
            variables, batch, key)
        draws = jax_sample_draws(4, arch_j.repaint_cfg, key, shape, outpainting=True)
        got = arch_t.sample(batch, randn=Replay(draws),
                            outpainting=S.Outpainting(mask=t(mask), gt=t(gt)))
    assert isinstance(got, tuple) == isinstance(want, tuple) == same_tail
    for g, w in zip(got if same_tail else [got], want if same_tail else [want]):
        assert np.abs(np.asarray(w)).max() > 1e-3
        assert_close_scaled(g.numpy(), np.asarray(w), MODEL_REL, mode)
