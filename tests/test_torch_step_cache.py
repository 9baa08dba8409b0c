"""The port's step cache (diffusion/stepcache.py, the cached samplers and
decoder stacks) against the JAX package on the CPU.

- The flag tables: ``pattern_flags`` (uniform, with a jump schedule's
  denoise mask, explicit tables and their validation), ``flags_from_errors``
  and ``load_flags`` equal the JAX package's on the same inputs and on the
  committed flagship artifact (artifacts/step_cache_flagship.json).
- All-compute flags: the port's cached ``forward_test``, ``sample`` (plain
  and RePaint-harmonized), ControlNet and windowed samplers equal its
  uncached ones bit for bit (the compute branch returns the layer's output
  itself).
- A reuse pattern, ``collect_errors`` and the harmonized loop against JAX's
  jitted samplers with JAX's draws replayed, on the tiny T2M config and the
  tiny M2D ControlNet: within REL = 1e-4 x max(1, max |JAX|), as
  tests/test_torch_sample.py (the sums differ in order, erf comes from
  other libraries).  The calibration errors are relative changes, held
  within 1e-4 relative, step 0 (a change against the zero cache, divided by
  1e-8) within 1e-4 of its own size.
- The guards raise as the JAX package's do.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import motioncraft_tpu.models  # noqa: F401  (registers the flax classes)
from motioncraft_tpu.apis import windowed as jax_windowed
from motioncraft_tpu.apis.factory import make_text_batch, tiny_t2m_cfg
from motioncraft_tpu.config import Config as JaxConfig
from motioncraft_tpu.diffusion import StepCacheConfig as JaxStepCache
from motioncraft_tpu.diffusion import stepcache as jax_stepcache
from motioncraft_tpu.diffusion.sampling import Outpainting as JaxOutpainting
from motioncraft_tpu.diffusion.sampling import RepaintConfig as JaxRepaint
from motioncraft_tpu.registry import build_architecture as build_jax
from motioncraft_tpu_torch.apis import single_device_test, windowed
from motioncraft_tpu_torch.apis.factory import tiny_t2m_cfg as torch_tiny_cfg
from motioncraft_tpu_torch.config import Config
from motioncraft_tpu_torch.diffusion import (Outpainting, RepaintConfig, StepCacheConfig,
                                             flags_from_errors, load_flags, pattern_flags)
from motioncraft_tpu_torch.registry import build_architecture as build_torch
from motioncraft_tpu_torch.utils.convert import from_jax_params
from test_torch_windowed import make_mwb
from torch_port_util import (Replay, assert_close_scaled, jax_sample_draws, jax_windowed_draws,
                             seeded_params, t)

REL = 1e-4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACT = os.path.join(REPO, "artifacts", "step_cache_flagship.json")
M2D_CONFIG = os.path.join(REPO, "configs", "tests", "tiny_m2d.py")
REUSE = dict(reuse_every=2, warmup=1, tail=0)
ALL_COMPUTE = dict(reuse_every=1, warmup=1, tail=0)


def both(**kw):
    """The same step-cache config in both packages."""
    return JaxStepCache(**kw), StepCacheConfig(**kw)


# ---------------------------------------------------------------- flag tables

@pytest.mark.parametrize("steps,layers,kw", [
    (6, 3, dict(reuse_every=2, warmup=1, tail=1)), (50, 4, {}), (50, 4, dict(reuse_every=3)),
    (84, 3, dict(reuse_every=2, warmup=2, tail=4))])
def test_pattern_flags_uniform(steps, layers, kw):
    j, p = both(**kw)
    got = pattern_flags(steps, layers, p)
    np.testing.assert_array_equal(got, jax_stepcache.pattern_flags(steps, layers, j))
    assert (got == got[:, :1]).all()
    if kw == dict(reuse_every=2, warmup=1, tail=1):
        np.testing.assert_array_equal(got[:, 0], [False, True, False, True, False, False])


def test_pattern_flags_denoise_mask_resets_runs():
    mask = np.array([True, True, False, True, True])
    j, p = both(reuse_every=2, warmup=1, tail=0)
    got = pattern_flags(5, 1, p, denoise_mask=mask)
    np.testing.assert_array_equal(got[:, 0], [False, True, False, False, True])
    np.testing.assert_array_equal(got, jax_stepcache.pattern_flags(5, 1, j, denoise_mask=mask))
    # the flagship M2D jump schedule (DDIM-50, jump 3 x 2: 84 steps)
    from motioncraft_tpu_torch.diffusion import harmonize_schedule
    mask = np.array([dn for _, dn in harmonize_schedule(50, RepaintConfig(overlap_len=30))])
    j, p = both()
    np.testing.assert_array_equal(pattern_flags(len(mask), 4, p, denoise_mask=mask),
                                  jax_stepcache.pattern_flags(len(mask), 4, j,
                                                              denoise_mask=mask))


def test_pattern_flags_validation():
    for kw in (dict(warmup=0), dict(reuse_every=0)):
        with pytest.raises(ValueError):
            StepCacheConfig(**kw)
    with pytest.raises(ValueError, match="step 0"):
        pattern_flags(4, 2, StepCacheConfig(flags=np.ones((4, 2), bool)))
    with pytest.raises(ValueError, match="shape"):
        pattern_flags(5, 2, StepCacheConfig(flags=np.zeros((4, 2), bool)))


def test_explicit_flags_respect_denoise_mask():
    mask = np.array([True, True, False, True, True])
    flags = np.zeros((5, 2), bool)
    flags[3, 0] = True  # the first denoise step after the jump at 2
    with pytest.raises(ValueError, match="after a re-noise jump"):
        pattern_flags(5, 2, StepCacheConfig(flags=flags), denoise_mask=mask)
    ok = np.zeros((5, 2), bool)
    ok[4, 0] = True
    np.testing.assert_array_equal(
        pattern_flags(5, 2, StepCacheConfig(flags=ok), denoise_mask=mask), ok)


def test_flags_from_errors():
    errors = np.array([[9.0], [0.01], [0.01], [0.01], [0.01], [0.01]])
    got = flags_from_errors(errors, threshold=0.05, max_consecutive=2, tail=1)
    np.testing.assert_array_equal(got[:, 0], [False, False, True, True, False, False])
    rng = np.random.RandomState(0)
    for _ in range(5):
        e = rng.rand(50, 4) * 0.2
        kw = dict(threshold=float(rng.rand() * 0.2), max_consecutive=int(rng.randint(1, 5)),
                  tail=int(rng.randint(0, 4)))
        np.testing.assert_array_equal(flags_from_errors(e, **kw),
                                      jax_stepcache.flags_from_errors(e, **kw))


def test_load_flags(tmp_path):
    table = np.random.RandomState(1).rand(12, 3) > 0.5
    table[0] = False
    npz = str(tmp_path / "flags.npz")
    np.savez(npz, flags=table, errors=np.zeros((12, 3)))
    for path in (npz, ARTIFACT):
        np.testing.assert_array_equal(load_flags(path), jax_stepcache.load_flags(path))
    np.testing.assert_array_equal(load_flags(npz), table)


def test_committed_flags_match_committed_errors():
    with open(ARTIFACT) as f:
        a = json.load(f)
    errors, flags = np.asarray(a["errors"]), np.asarray(a["flags"], bool)
    assert flags.shape == (50, 4)
    np.testing.assert_array_equal(
        flags_from_errors(errors, threshold=a["threshold"],
                          max_consecutive=a["max_consecutive"], tail=a["tail"]), flags)
    assert abs(flags.mean() - a["reuse_fraction"]) < 1e-6


def test_committed_flags_are_valid_schedule():
    flags = load_flags(ARTIFACT)
    assert not flags[0].any() and not flags[-2:].any()
    np.testing.assert_array_equal(pattern_flags(50, 4, StepCacheConfig(flags=flags)), flags)
    assert int((~flags).sum()) == 83  # (step, layer) pairs that compute


# ------------------------------------------------------------ the T2M sampler

@pytest.fixture(scope="module")
def pair():
    cfg = tiny_t2m_cfg()
    arch_j = build_jax(cfg)
    batch = make_text_batch(["a person walks forward", "someone waves hello"],
                            max_seq_len=16, lengths=np.array([[16], [11]], np.int32))
    variables = arch_j.init(jax.random.PRNGKey(0), batch)
    params = seeded_params(jax.tree_util.tree_map(np.asarray, variables["params"]), 1)
    variables = {"params": jax.tree_util.tree_map(jnp.asarray, params)}
    arch_t = build_torch(torch_tiny_cfg(), device="cpu")
    arch_t.model.load_state_dict(from_jax_params(params), strict=True)
    return arch_j, variables, arch_t, batch


def _jax_noise(rng, shape):
    return t(np.asarray(jax.random.normal(jax.random.split(rng)[0], shape, jnp.float32)))


def test_all_compute_forward_is_exact(pair):
    _, _, arch_t, batch = pair
    x = t(np.random.RandomState(3).randn(*batch["motion"].shape).astype(np.float32))
    ts = torch.full((2,), 499, dtype=torch.long)
    kw = dict(motion_mask=t(batch["motion_mask"]), motion_length=t(batch["motion_length"]))
    with torch.no_grad():
        xf = arch_t.encode_text(batch["text_ids"])
        tf = arch_t.model.precompute_text_feats(xf)
        base = arch_t.model(x, ts, xf_out=xf, text_feats=tf, **kw)
        cache0 = arch_t.model.make_step_cache(2, 16)
        assert cache0.shape == (2, 4, 16, arch_t.model.latent_dim)
        out, cache = arch_t.model(x, ts, xf_out=xf, text_feats=tf, step_cache=cache0,
                                  cache_flags=np.zeros(2, bool), **kw)
        assert torch.equal(out, base) and cache.shape == cache0.shape
        # reusing every layer replays the cache: the stack is the embedding
        # plus the cached residuals, and the new cache is the old one
        again, same = arch_t.model(x, ts, xf_out=xf, text_feats=tf, step_cache=cache,
                                   cache_flags=np.ones(2, bool), **kw)
        assert torch.equal(same, cache) and not torch.equal(again, base)


def test_all_compute_is_exact(pair):
    _, _, arch_t, batch = pair
    g = lambda: torch.Generator().manual_seed(7)  # noqa: E731
    base = arch_t.sample(batch, generator=g())
    cached = arch_t.sample(batch, generator=g(), step_cache=StepCacheConfig(**ALL_COMPUTE))
    assert torch.equal(base, cached)
    res = single_device_test(arch_t, [batch], seed=0, device="cpu",
                             step_cache=StepCacheConfig(**ALL_COMPUTE))
    plain = single_device_test(arch_t, [batch], seed=0, device="cpu")
    for a, b in zip(res, plain):
        np.testing.assert_array_equal(a["pred_motion"], b["pred_motion"])


def test_reuse_matches_jax(pair):
    arch_j, variables, arch_t, batch = pair
    rng = jax.random.PRNGKey(11)
    j, p = both(**REUSE)
    assert pattern_flags(4, 2, p).any(), "the pattern must reuse"
    want = np.asarray(jax.jit(lambda v, b, r: arch_j.sample(v, b, r, step_cache=j))(
        variables, batch, rng))
    noise = _jax_noise(rng, batch["motion"].shape)
    got = arch_t.sample(batch, noise=noise, step_cache=p).numpy()
    base = arch_t.sample(batch, noise=noise).numpy()
    assert np.abs(got - base).max() > 1e-3  # the reuse took effect
    assert_close_scaled(got, want, REL, "sample with reuse")


def test_collect_errors_matches_jax(pair):
    arch_j, variables, arch_t, batch = pair
    rng = jax.random.PRNGKey(17)
    cfg_j, cfg_t = both(collect_errors=True)
    want, errs_j = jax.jit(lambda v, b, r: arch_j.sample(v, b, r, step_cache=cfg_j))(
        variables, batch, rng)
    noise = _jax_noise(rng, batch["motion"].shape)
    out, errs = arch_t.sample(batch, noise=noise, step_cache=cfg_t)
    assert isinstance(errs, np.ndarray) and errs.shape == (4, 2)
    assert torch.equal(out, arch_t.sample(batch, noise=noise))  # the probe computes all
    assert_close_scaled(out.numpy(), np.asarray(want), REL, "collect_errors sample")
    errs_j = np.asarray(errs_j)
    assert (errs[1:] > 0).all()
    np.testing.assert_allclose(errs[0], errs_j[0], rtol=1e-4)
    np.testing.assert_allclose(errs[1:], errs_j[1:], rtol=1e-4, atol=1e-6)
    flags = flags_from_errors(errs, threshold=np.inf, tail=1)
    assert flags.any()
    reuse = arch_t.sample(batch, noise=noise, step_cache=StepCacheConfig(flags=flags))
    assert torch.isfinite(reuse).all()


def _outpainting(batch):
    motion = np.random.RandomState(8).randn(*batch["motion"].shape).astype(np.float32)
    mask = np.zeros(motion.shape, bool)
    mask[:, :4] = True
    return (JaxOutpainting(mask=jnp.asarray(mask), gt=jnp.asarray(motion)),
            Outpainting(mask=t(mask), gt=t(motion)))


def test_harmonize_composes(pair):
    """RePaint's harmonized loop (respace '4', jump 2 x 2: 10 steps, 7 of
    them denoising): all-compute equals uncached bit for bit; a reuse
    pattern matches JAX with its draws replayed."""
    arch_j, variables, arch_t, batch = pair
    op_j, op_t = _outpainting(batch)
    rp = dict(overlap_len=4, jump_length=2, jump_n_sample=2)
    arch_j.repaint_cfg, arch_t.repaint_cfg = JaxRepaint(**rp), RepaintConfig(**rp)
    rng = jax.random.PRNGKey(19)
    try:
        draws = jax_sample_draws(4, arch_j.repaint_cfg, rng, batch["motion"].shape,
                                 outpainting=True)
        run = lambda sc: arch_t.sample(batch, randn=Replay(draws), outpainting=op_t,  # noqa: E731
                                       step_cache=sc).numpy()
        base = run(None)
        np.testing.assert_array_equal(run(StepCacheConfig(**ALL_COMPUTE)), base)
        j, p = both(**REUSE)
        want = np.asarray(jax.jit(lambda v, b, r: arch_j.sample(
            v, b, r, outpainting=op_j, step_cache=j))(variables, batch, rng))
        got = run(p)
        assert np.abs(got - base).max() > 1e-3
        assert_close_scaled(got, want, REL, "harmonized sample with reuse")
    finally:
        arch_j.repaint_cfg = arch_t.repaint_cfg = None


def test_guards(pair):
    _, _, arch_t, batch = pair
    with pytest.raises(ValueError, match="ddim"):
        arch_t.sample(batch, inference_type="ddpm", step_cache=StepCacheConfig())
    _, op_t = _outpainting(batch)
    arch_t.repaint_cfg = RepaintConfig(overlap_len=4)
    try:
        with pytest.raises(NotImplementedError, match="plain DDIM"):
            arch_t.sample(batch, outpainting=op_t,
                          step_cache=StepCacheConfig(collect_errors=True))
        arch_t.repaint_cfg = RepaintConfig(overlap_len=4, no_repaint=True,
                                           same_overlap_noisy=True)
        with pytest.raises(ValueError, match="tail-tracking"):
            arch_t.sample(batch, outpainting=op_t,
                          step_cache=StepCacheConfig(collect_errors=True))
    finally:
        arch_t.repaint_cfg = None
    with pytest.raises(ValueError, match="collect_errors"):
        single_device_test(arch_t, [batch], device="cpu",
                           step_cache=StepCacheConfig(collect_errors=True))
    with pytest.raises(ValueError, match="does not support"):
        model = arch_t.model
        try:
            arch_t.model = torch.nn.Identity()
            arch_t.sample(batch, step_cache=StepCacheConfig())
        finally:
            arch_t.model = model


# ---------------------------------------------------- the ControlNet (M2D)

@pytest.fixture(scope="module")
def m2d():
    cfg_j = JaxConfig.fromfile(M2D_CONFIG)
    arch_j = build_jax(cfg_j.model)
    music = np.random.RandomState(0).randn(16, 163).astype(np.float32)
    variables = arch_j.init(jax.random.PRNGKey(0), make_mwb(music)(0, 16))
    params = seeded_params(jax.tree_util.tree_map(np.asarray, variables["params"]), 1)
    variables = {"params": jax.tree_util.tree_map(jnp.asarray, params)}
    arch_t = build_torch(Config.fromfile(M2D_CONFIG).model, device="cpu")
    arch_t.model.load_state_dict(from_jax_params(params), strict=True)
    arch_j.repaint_cfg = JaxRepaint(overlap_len=4)
    arch_t.repaint_cfg = RepaintConfig(overlap_len=4)
    return arch_j, variables, arch_t


def test_controlnet_cache_layout(m2d):
    _, _, arch_t = m2d
    cache = arch_t.model.make_step_cache(3, 16, torch.bfloat16)
    L, copy = arch_t.model.num_layers, arch_t.model.copy_blocks_num
    D = arch_t.model.base_model.latent_dim
    assert cache["h"].shape == (L, 6, 16, D) and cache["c"].shape == (copy, 6, 16, D)
    assert cache["h"].dtype == cache["c"].dtype == torch.bfloat16


def test_controlnet_all_compute_is_exact_and_reuse_matches_jax(m2d):
    arch_j, variables, arch_t = m2d
    batch = make_mwb(np.random.RandomState(2).randn(16, 163).astype(np.float32))(0, 16)
    rng = jax.random.PRNGKey(7)
    noise = _jax_noise(rng, batch["motion"].shape)
    base = arch_t.sample(batch, noise=noise)
    assert torch.equal(arch_t.sample(batch, noise=noise,
                                     step_cache=StepCacheConfig(**ALL_COMPUTE)), base)
    j, p = both(reuse_every=2, warmup=1, tail=1)
    want = np.asarray(jax.jit(lambda v, b, r: arch_j.sample(v, b, r, step_cache=j))(
        variables, batch, rng))
    got = arch_t.sample(batch, noise=noise, step_cache=p).numpy()
    assert np.abs(got - base.numpy()).max() > 1e-3
    assert_close_scaled(got, want, REL, "ControlNet sample with reuse")


def test_controlnet_reuse_replays_c(m2d):
    """A reused control-injected layer replays its cached h-residual and its
    cached c together; a computed one makes them anew."""
    _, _, arch_t = m2d
    batch = make_mwb(np.random.RandomState(4).randn(16, 163).astype(np.float32))(0, 16)
    model = arch_t.model
    x = t(np.random.RandomState(5).randn(1, 16, 322).astype(np.float32))
    kw = dict(motion_mask=t(batch["motion_mask"]), motion_length=t(batch["motion_length"]),
              c=t(batch["c"]))
    ts = torch.full((1,), 499, dtype=torch.long)
    with torch.no_grad():
        xf = arch_t.encode_text(batch["text_ids"])
        _, cache = model(x, ts, xf_out=xf, step_cache=model.make_step_cache(1, 16),
                         cache_flags=np.zeros(model.num_layers, bool), **kw)
        assert cache["c"].abs().max() > 0
        flags = np.zeros(model.num_layers, bool)
        flags[1] = True  # the control-injected layer reuses
        fake = {"h": cache["h"] * 0.5, "c": cache["c"] * 0.5}
        _, new = model(x, ts, xf_out=xf, step_cache=fake, cache_flags=flags, **kw)
        assert torch.equal(new["c"], fake["c"]) and torch.equal(new["h"][1], fake["h"][1])
        assert torch.equal(new["h"][0], cache["h"][0])  # layer 0 computed
        _, again = model(x, ts, xf_out=xf, step_cache=fake,
                         cache_flags=np.zeros(model.num_layers, bool), **kw)
        assert torch.equal(again["c"], cache["c"]) and torch.equal(again["h"], cache["h"])


def test_windowed_step_cache(m2d):
    """The windowed samplers take the step cache: all-compute equals the
    uncached windows bit for bit (single and lockstep), a reuse pattern
    matches JAX's windowed sampler on its draws."""
    arch_j, variables, arch_t = m2d
    # two windows: plain DDIM, then one outpainted (harmonized) window
    music, total, key = np.random.RandomState(3).randn(28, 163).astype(np.float32), 28, \
        jax.random.PRNGKey(4)
    kw = dict(total_frames=total, window=16, pre_frames=4)
    draws = jax_windowed_draws(arch_j.diffusion_test.num_timesteps, arch_j.repaint_cfg, key,
                               (1, 16, 322), 2, 4)
    run = lambda sc: windowed.windowed_sample(  # noqa: E731
        arch_t, make_mwb(music), randn=Replay(draws), repaint=arch_t.repaint_cfg,
        step_cache=sc, **kw)
    base = run(None)
    np.testing.assert_array_equal(run(StepCacheConfig(**ALL_COMPUTE)), base)
    lock = windowed.windowed_sample_batch(
        arch_t, [make_mwb(music)], [total], window=16, pre_frames=4, randn=Replay(draws),
        repaint=arch_t.repaint_cfg, precompute_condition=False,
        step_cache=StepCacheConfig(**ALL_COMPUTE))[0]
    np.testing.assert_array_equal(lock, base)
    j, p = both(reuse_every=2, warmup=1, tail=0)
    want = jax_windowed.windowed_sample(arch_j, variables, make_mwb(music), rng=key,
                                        repaint=arch_j.repaint_cfg, step_cache=j, **kw)
    got = run(p)
    assert np.abs(got - base).max() > 1e-3
    assert_close_scaled(got, want, REL, "windowed sample with reuse")
