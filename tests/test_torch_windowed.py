"""The port's windowed long-form sampler (apis/windowed.py) against the JAX
package on the tiny M2D ControlNet (configs/tests/tiny_m2d.py: 16-frame
windows overlapping by 4, RePaint outpainting), on one seeded flax tree:

- ``windowed_sample`` over 3 windows (plain DDIM, then two outpainted
  windows) and ``windowed_sample_batch`` at R = 2 with recordings of two
  lengths, both sides on the JAX key tree's draws (fold_in per window);
- the lockstep sampler at R = 1 equals the single-recording one bit for bit
  with the condition encoded per window, and within 1e-5 x scale with it
  encoded per chunk; chunking the windows changes nothing;
- the pre-sequence seeding path (``use_repaint=False``).

Tolerance through the denoiser: 1e-4 x max(1, max |JAX|), as
tests/test_torch_sample.py.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import motioncraft_tpu.models  # noqa: F401  (registers the flax classes)
from motioncraft_tpu.apis import windowed as jax_windowed
from motioncraft_tpu.config import Config as JaxConfig
from motioncraft_tpu.diffusion.sampling import RepaintConfig as JaxRepaint
from motioncraft_tpu.models.tokenizer import tokenize
from motioncraft_tpu.registry import build_architecture as build_jax
from motioncraft_tpu_torch.apis import windowed
from motioncraft_tpu_torch.config import Config
from motioncraft_tpu_torch.diffusion import RepaintConfig
from motioncraft_tpu_torch.registry import build_architecture as build_torch
from motioncraft_tpu_torch.utils.convert import from_jax_params
from torch_port_util import Replay, assert_close_scaled, jax_windowed_draws, seeded_params

REL = 1e-4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "tests", "tiny_m2d.py")
WINDOW, PRE, D = 16, 4, 322


def make_mwb(music, text="A dancer is performing a Jazz dance in the modern style"):
    """tools/m2d_test.py's window batches over one track's music."""
    text_ids = tokenize([text])

    def mwb(start, end):
        seg = music[start:end]
        if len(seg) < end - start:
            seg = np.pad(seg, ((0, end - start - len(seg)), (0, 0)))
        return {"motion": np.zeros((1, WINDOW, D), np.float32),
                "motion_mask": np.ones((1, WINDOW), np.float32),
                "motion_length": np.full((1, 1), WINDOW, np.int32),
                "text_ids": text_ids, "c": seg.astype(np.float32)[None]}

    return mwb


@pytest.fixture(scope="module")
def pair():
    cfg_j = JaxConfig.fromfile(CONFIG)
    arch_j = build_jax(cfg_j.model)
    music = np.random.RandomState(0).randn(WINDOW, 163).astype(np.float32)
    variables = arch_j.init(jax.random.PRNGKey(0), make_mwb(music)(0, WINDOW))
    params = seeded_params(jax.tree_util.tree_map(np.asarray, variables["params"]), 1)
    variables = {"params": jax.tree_util.tree_map(jnp.asarray, params)}
    arch_t = build_torch(Config.fromfile(CONFIG).model, device="cpu")
    arch_t.model.load_state_dict(from_jax_params(params), strict=True)
    arch_j.repaint_cfg = JaxRepaint(overlap_len=PRE)
    arch_t.repaint_cfg = RepaintConfig(overlap_len=PRE)
    return arch_j, variables, arch_t


def _music(seed, n):
    return np.random.RandomState(seed).randn(n, 163).astype(np.float32)


@pytest.mark.parametrize("use_repaint", [True, False], ids=["repaint", "pre_seq"])
def test_windowed_sample_matches_jax(pair, use_repaint):
    arch_j, variables, arch_t = pair
    music, total, key = _music(3, 40), 40, jax.random.PRNGKey(4)
    assert windowed.num_windows(total, WINDOW, PRE) == 3
    want = jax_windowed.windowed_sample(arch_j, variables, make_mwb(music), total_frames=total,
                                        window=WINDOW, pre_frames=PRE, rng=key,
                                        use_repaint=use_repaint, repaint=arch_j.repaint_cfg)
    draws = Replay(jax_windowed_draws(arch_j.diffusion_test.num_timesteps, arch_j.repaint_cfg,
                                      key, (1, WINDOW, D), 3, PRE, use_repaint))
    got = windowed.windowed_sample(arch_t, make_mwb(music), total_frames=total, window=WINDOW,
                                   pre_frames=PRE, randn=draws, use_repaint=use_repaint,
                                   repaint=arch_t.repaint_cfg)
    assert draws.done() and got.shape == (total, D)
    assert np.abs(want).max() > 1e-3
    assert_close_scaled(got, want, REL, "windowed_sample")


def test_batch_of_mixed_lengths_matches_jax(pair):
    """R = 2 in lockstep, recordings of 40 and 28 frames (3 and 2 windows):
    the shorter one's padded third window is sampled and dropped."""
    arch_j, variables, arch_t = pair
    musics, totals, key = [_music(5, 40), _music(6, 28)], [40, 28], jax.random.PRNGKey(10)
    texts = ["A dancer is performing a Jazz dance", "A dancer is performing a Hiphop dance"]
    want = jax_windowed.windowed_sample_batch(
        arch_j, variables, [make_mwb(m, s) for m, s in zip(musics, texts)], totals,
        window=WINDOW, pre_frames=PRE, rng=key, repaint=arch_j.repaint_cfg)
    draws = Replay(jax_windowed_draws(arch_j.diffusion_test.num_timesteps, arch_j.repaint_cfg,
                                      key, (2, WINDOW, D), 3, PRE))
    got = windowed.windowed_sample_batch(
        arch_t, [make_mwb(m, s) for m, s in zip(musics, texts)], totals, window=WINDOW,
        pre_frames=PRE, randn=draws, repaint=arch_t.repaint_cfg)
    assert draws.done()
    for g, w, n in zip(got, want, totals):
        assert g.shape == (n, D)
        assert_close_scaled(g, w, REL, f"recording of {n} frames")


def test_batch_of_one_is_the_single_sampler(pair):
    _, _, arch_t = pair
    music = _music(11, 40)
    kw = dict(window=WINDOW, pre_frames=PRE, repaint=arch_t.repaint_cfg)
    # window 0 draws its noise; each outpainted one its noise and the
    # outpainting noise of its 2 steps (respace '4': the jump schedule 1, 0)
    draws = [np.random.RandomState(i).randn(1, WINDOW, D).astype(np.float32)
             for i in range(1 + 2 * 3)]
    sample = lambda: Replay(draws)  # noqa: E731  (the same draws for every run)
    single = windowed.windowed_sample(arch_t, make_mwb(music), total_frames=40,
                                      randn=sample(), **kw)
    raw = windowed.windowed_sample_batch(arch_t, [make_mwb(music)], [40], randn=sample(),
                                         precompute_condition=False, **kw)[0]
    np.testing.assert_array_equal(raw, single)
    encoded = windowed.windowed_sample_batch(arch_t, [make_mwb(music)], [40], randn=sample(),
                                             **kw)[0]
    assert_close_scaled(encoded, single, 1e-5, "condition encoded per chunk")
    chunked = windowed.windowed_sample_batch(arch_t, [make_mwb(music)], [40], randn=sample(),
                                             window_chunk=2, **kw)[0]
    assert_close_scaled(chunked, encoded, 1e-6, "two chunks")


def test_denormalize_and_window_count():
    assert [windowed.num_windows(n, 120, 30) for n in (60, 120, 209, 210, 1290)] == [
        1, 1, 1, 2, 14]
    m = np.random.RandomState(0).randn(5, 322).astype(np.float32)
    mean, std = np.arange(322, dtype=np.float32), np.full(322, 2.0, np.float32)
    np.testing.assert_array_equal(windowed.denormalize(m, mean, std),
                                  jax_windowed.denormalize(m, mean, std))
