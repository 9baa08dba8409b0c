"""The diffusion's learned variances, timestep rescaling and variational
lower bound, and the GMOF / GAN losses, against the JAX package on the CPU.

A small respaced linear schedule (100 steps respaced to 10), seeded numpy
inputs and an analytic model both sides compute alike, its learned-variance
half on the time axis, as the JAX package splits it along axis 1: tanh of
the input, and for the VLB a near-identity denoiser (0.95 x_t), whose
decoder term at t = 0 sits in the discretized likelihood's well-conditioned
range.  Far from it (|x - mean| many sigmas) both bin edges' CDFs round to
one f32 value, so ``log(cdf_plus - cdf_min)`` is the 1e-12 clip or the log
of one ulp, an 11-nat step that one ulp of tanh decides in either
framework.  ``calc_bpd_loop`` takes the JAX run's noise draws, in order
(the random streams differ).  Tolerance: 1e-5 x max(1, max |JAX|) (sums
and transcendental functions in another order); the losses 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motioncraft_tpu.diffusion import gaussian as jg
from motioncraft_tpu.diffusion import sampling as js
from motioncraft_tpu.models import losses as jax_losses
from motioncraft_tpu_torch.diffusion import Replay, ddim_sample_loop
from motioncraft_tpu_torch.diffusion import gaussian as tg
from motioncraft_tpu_torch.models import losses
from motioncraft_tpu_torch.registry import build_loss
from torch_port_util import assert_close_scaled, t

REL = 1e-5
B, T, D = 2, 6, 5


def pair(var_type="fixed_large", mean_type="start_x", rescale=False):
    kw = dict(beta_scheduler="linear", diffusion_steps=100, model_mean_type=mean_type,
              model_var_type=var_type, respace="10", rescale_timesteps=rescale)
    return jg.create_diffusion(**kw), tg.create_diffusion(**kw)


def model_j(x, ts):
    """Mean part tanh(x), variance part in [-1, 1] stacked on axis 1."""
    scale = (ts.astype(jnp.float32) / 100.0)[:, None, None]
    return jnp.concatenate([jnp.tanh(x) * 0.5, jnp.sin(x * scale)], axis=1)


def model_t(x, ts):
    scale = (ts.to(torch.float32) / 100.0)[:, None, None]
    return torch.cat([torch.tanh(x) * 0.5, torch.sin(x * scale)], dim=1)


def inputs(seed=0):
    rng = np.random.RandomState(seed)
    x = np.clip(rng.randn(B, T, D) * 0.6, -1, 1).astype(np.float32)
    x[0, 0, 0], x[1, 1, 1] = -1.0, 1.0  # the edge bins
    return x, rng.randn(B, T, D).astype(np.float32), np.array([0, 7], np.int64)


def test_tables_and_rescaled_timesteps():
    dj, dt = pair(rescale=True)
    for name in ("alphas_cumprod_next", "log_one_minus_alphas_cumprod", "log_betas"):
        np.testing.assert_array_equal(getattr(dt, name).numpy(), np.asarray(getattr(dj, name)))
    ts = np.array([0, 4, 9])
    want = np.asarray(jg.model_timesteps(dj, jnp.asarray(ts)))
    got = tg.model_timesteps(dt, t(ts)).numpy()
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("var_type", ["learned", "learned_range", "fixed_small"])
@pytest.mark.parametrize("mean_type", ["start_x", "epsilon"])
def test_p_mean_variance(var_type, mean_type):
    dj, dt = pair(var_type, mean_type)
    x, _, ts = inputs()
    learned = var_type.startswith("learned")
    out_j = np.asarray(model_j(jnp.asarray(x), jnp.asarray(ts)))
    if not learned:
        out_j = out_j[:, :T]
    want = jg.p_mean_variance(dj, jnp.asarray(out_j), jnp.asarray(x), jnp.asarray(ts))
    got = tg.p_mean_variance(dt, t(out_j), t(x), t(ts))
    for k in ("mean", "variance", "log_variance", "pred_xstart"):
        assert_close_scaled(got[k].numpy(), want[k], REL, f"{var_type} {k}")


def test_q_mean_variance_and_the_kl_terms():
    dj, dt = pair()
    x, noise, ts = inputs(1)
    for a, b in zip(tg.q_mean_variance(dt, t(x), t(ts)),
                    jg.q_mean_variance(dj, jnp.asarray(x), jnp.asarray(ts))):
        assert_close_scaled(a.numpy(), b, REL, "q_mean_variance")
    lv = np.log(np.abs(noise) + 0.1).astype(np.float32)
    assert_close_scaled(tg.normal_kl(t(x), t(lv), t(noise), t(-lv)).numpy(),
                        jg.normal_kl(x, lv, noise, -lv), REL, "normal_kl")
    assert_close_scaled(tg.approx_standard_normal_cdf(t(noise)).numpy(),
                        jg.approx_standard_normal_cdf(jnp.asarray(noise)), REL, "cdf")
    assert_close_scaled(
        tg.discretized_gaussian_log_likelihood(t(x), means=t(noise * 0.1),
                                               log_scales=t(lv)).numpy(),
        jg.discretized_gaussian_log_likelihood(jnp.asarray(x), means=noise * 0.1,
                                               log_scales=lv), REL, "discretized LL")
    assert_close_scaled(tg.prior_bpd(dt, t(x)).numpy(), jg.prior_bpd(dj, jnp.asarray(x)),
                        REL, "prior_bpd")


def denoiser_j(x, ts):
    return jnp.concatenate([x * 0.95, model_j(x, ts)[:, T:]], axis=1)


def denoiser_t(x, ts):
    return torch.cat([x * 0.95, model_t(x, ts)[:, T:]], dim=1)


@pytest.mark.parametrize("var_type", ["learned_range", "fixed_large"])
def test_vb_terms_and_calc_bpd_loop(var_type):
    dj, dt = pair(var_type)
    learned = var_type == "learned_range"
    mj = denoiser_j if learned else (lambda x, ts: denoiser_j(x, ts)[:, :T])
    mt = denoiser_t if learned else (lambda x, ts: denoiser_t(x, ts)[:, :T])
    x, noise, ts = inputs(2)
    x_t = np.asarray(jg.q_sample(dj, jnp.asarray(x), jnp.asarray(ts), jnp.asarray(noise)))
    want = jg.vb_terms_bpd(dj, mj, jnp.asarray(x), jnp.asarray(x_t), jnp.asarray(ts))
    got = tg.vb_terms_bpd(dt, mt, t(x), t(x_t), t(ts))
    for k in ("output", "pred_xstart"):
        assert_close_scaled(got[k].numpy(), want[k], REL, f"vb_terms {k}")
    rng = jax.random.PRNGKey(3)
    want = jg.calc_bpd_loop(dj, mj, jnp.asarray(x), rng)
    draws, key = [], rng
    for _ in range(dj.num_timesteps):
        key, sub = jax.random.split(key)
        draws.append(np.asarray(jax.random.normal(sub, x.shape, jnp.float32)))
    source = Replay(draws)
    got = tg.calc_bpd_loop(dt, mt, t(x), source)
    assert source.used == len(draws)
    for k in ("total_bpd", "prior_bpd", "vb", "xstart_mse", "mse"):
        assert_close_scaled(got[k].numpy(), want[k], REL, f"calc_bpd_loop {k}")


def test_ddim_with_learned_variance():
    """DDIM reads the mean half of a learned-variance output, as the JAX
    package's loop does."""
    dj, dt = pair("learned_range")
    noise = np.random.RandomState(4).randn(B, T, D).astype(np.float32)
    want = np.asarray(js.ddim_sample_loop(dj, model_j, jnp.asarray(noise),
                                          jax.random.PRNGKey(0)).sample)
    got = ddim_sample_loop(dt, model_t, t(noise)).sample.numpy()
    assert_close_scaled(got, want, REL, "ddim learned_range")


# ------------------------------------------------------------------ losses
def test_gmof_loss():
    rng = np.random.RandomState(5)
    pred, target, w = (rng.randn(3, 4, 5).astype(np.float32) for _ in range(3))
    assert_close_scaled(losses.gmof(t(pred), 0.7).numpy(), jax_losses.gmof(pred, 0.7), 1e-6)
    cfg = dict(type="MSELossWithGMOF", reduction="mean", loss_weight=2.0, sigma=0.5)
    port = build_loss(cfg)
    ref = jax_losses.MSELossWithGMOF(reduction="mean", loss_weight=2.0, sigma=0.5)
    for kw in (dict(), dict(reduction_override="none"), dict(reduction_override="sum"),
               dict(avg_factor=7.0)):
        got = port(t(pred), t(target), weight=t(w), **kw).numpy()
        assert_close_scaled(got, ref(pred, target, weight=w, **kw), 1e-6, f"GMOF {kw}")


@pytest.mark.parametrize("gan_type", ["vanilla", "lsgan", "wgan", "hinge"])
def test_gan_loss(gan_type):
    x = np.random.RandomState(6).randn(4, 7).astype(np.float32) * 3
    port = build_loss(dict(type="GANLoss", gan_type=gan_type, real_label_val=0.9,
                           fake_label_val=0.1, loss_weight=0.5))
    ref = jax_losses.GANLoss(gan_type, real_label_val=0.9, fake_label_val=0.1,
                             loss_weight=0.5)
    for real in (True, False):
        for disc in (True, False):
            assert_close_scaled(port(t(x), real, is_disc=disc).numpy(),
                                ref(jnp.asarray(x), real, is_disc=disc), 1e-6,
                                f"{gan_type} real={real} disc={disc}")
    with pytest.raises(NotImplementedError):
        losses.GANLoss("wasserstein")
