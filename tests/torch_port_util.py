"""Shared helpers of the tests that hold the PyTorch port against the JAX
package: seeded flax parameter trees made with numpy, and numpy <-> torch."""

import math
import os

import numpy as np
import pytest
import torch

# the port's draw source; the tests hand it the JAX package's draws
from motioncraft_tpu_torch.diffusion import Replay  # noqa: F401

# Under pytest-xdist each worker process would run torch's intra-op thread
# pool on every core: N workers x all cores oversubscribe the machine, and the
# tiny models' small ops wait on one another (a 20-step training test took
# 50 times its one-process time).  Every worker imports this module while it
# collects, so each takes its share of the cores here.
_WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
if _WORKERS > 1:
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // _WORKERS))


def seeded_params(tree, seed=0):
    """A flax ``params`` tree of the same structure with seeded N(0, 1) /
    sqrt(fan-in) values (numpy; a Conv kernel [k, in, out] has fan-in
    k x in): gate temperatures 0 (logit scale 1), MoE position embeddings
    scaled by 8 so routing spreads across experts, SAMI's kernel widths
    ``sigma`` / ``t_sigma`` at their initial 100 / 1 (a random width near 0
    makes its time kernel one-hot)."""
    rng = np.random.RandomState(seed)

    def walk(node, path):
        out = {}
        for key, val in sorted(node.items()):
            if isinstance(val, dict) or hasattr(val, "items"):
                out[key] = walk(dict(val), path + [key])
                continue
            shape = np.shape(val)
            if key == "kernel":
                fan_in = int(np.prod(shape[:-1]))
            elif key in ("expert_w1", "expert_w2", "w1", "w2"):
                fan_in = shape[-2]
            else:
                fan_in = shape[-1]
            v = rng.randn(*shape) / math.sqrt(max(fan_in, 4))
            if key == "temperature":
                v = np.zeros(shape)
            elif key in ("sigma", "t_sigma"):
                v = np.full(shape, 100.0 if key == "sigma" else 1.0)
            elif key == "embedding" and path[-1:] != ["token_embedding"]:
                v = v * 8.0
            out[key] = v.astype(np.float32)
        return out

    return walk(dict(tree), [])


def seeded_batch_stats(tree, seed=0):
    """A flax ``batch_stats`` tree of the same structure with seeded values
    (numpy): each ``mean`` N(0, 0.1^2), each ``var`` in [0.5, 1.5), so that
    BatchNorm divides by a positive variance."""
    rng = np.random.RandomState(seed)

    def walk(node):
        out = {}
        for key, val in sorted(node.items()):
            if isinstance(val, dict) or hasattr(val, "items"):
                out[key] = walk(dict(val))
            elif key == "var":
                out[key] = (rng.rand(*np.shape(val)) + 0.5).astype(np.float32)
            else:
                out[key] = (rng.randn(*np.shape(val)) * 0.1).astype(np.float32)
        return out

    return walk(dict(tree))


def bf16_cast_dtypes(model):
    """(dtypes of the parameters outside bf16_cast_'s promoted modules,
    dtypes of those inside): ({bf16}, {f32}) for a bf16-cast model."""
    from motioncraft_tpu_torch.apis.factory import PROMOTED_MODULES

    inside = {n: bool(set(n.split(".")) & set(PROMOTED_MODULES))
              for n, _ in model.named_parameters()}
    return ({p.dtype for n, p in model.named_parameters() if not inside[n]},
            {p.dtype for n, p in model.named_parameters() if inside[n]})


def t(a, dtype=None):
    """numpy -> CPU torch tensor."""
    x = torch.from_numpy(np.array(a))
    return x.to(dtype) if dtype is not None else x


def assert_close_scaled(got, want, rel, what=""):
    """max |got - want| <= rel * max(1, max |want|)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    diff = float(np.abs(got - want).max())
    assert diff <= rel * scale, f"{what}: max diff {diff} > {rel} * {scale}"


@pytest.fixture(autouse=True)
def grad_mode_on():
    """Some test modules of the JAX package turn torch's grad mode off when
    they are imported (and every xdist worker imports them all); the tests
    that use this fixture take gradients."""
    with torch.enable_grad():
        yield


def train_step_grads(arch, batch, generator=None, fp16=None, **draws):
    """One ``make_train_step`` step of ``arch`` on ``batch`` (SGD at lr 0,
    so the weights stay), the given draws (t, noise, cond_type) handed to
    the loss: (the step's logs, {name: the gradient the update saw})."""
    from motioncraft_tpu_torch.apis import make_train_step
    from motioncraft_tpu_torch.parallel import TrainState

    state = TrainState(arch.model, {"type": "SGD", "lr": 0.0})
    grads, update = {}, state.apply_gradients

    def capture():
        grads.update({n: p.grad.clone() for n, p in arch.model.named_parameters()
                      if p.grad is not None})
        update()

    state.apply_gradients = capture
    arch.train()
    try:
        logs = make_train_step(arch, state, fp16=fp16)(batch, generator, **draws)
    finally:
        arch.eval()
    return logs, grads


def check_route_invariants(route, capacity):
    """What every MoE routing (ops/moe_positions.py:Route) must satisfy: each
    kept (token, k) choice owns exactly one row and that row names its token;
    every other row (padding) holds 0; dropped choices have r == M and gate
    0; each expert keeps min(count, capacity) choices; block_expert is
    non-decreasing within [0, E); a token's row of ge holds its K gates and
    zeros."""
    gates, r, tfr, be, ge, counts = (a.cpu().numpy() for a in route)
    (N, K), E, M = r.shape, ge.shape[1], tfr.shape[0]
    assert ((r >= 0) & (r <= M)).all()
    kept = r < M
    assert (gates[~kept] == 0).all()
    rows = r[kept]
    assert np.unique(rows).size == rows.size, "two choices share a row"
    assert (tfr[rows] == np.broadcast_to(np.arange(N)[:, None], (N, K))[kept]).all()
    pad = np.ones(M, bool)
    pad[rows] = False
    assert (tfr[pad] == 0).all(), "a padding row is not 0"
    assert kept.sum() == np.minimum(counts, capacity).sum()
    assert counts.sum() == N * K
    assert (np.diff(be) >= 0).all() and be.min() >= 0 and be.max() < E
    assert (np.count_nonzero(ge, axis=1) <= K).all()
    # gates are >= 0, so a row's K largest entries are its gates
    np.testing.assert_array_equal(np.sort(ge, axis=1)[:, E - K:], np.sort(gates, axis=1))


def route_logits(N, E, kind, seed=0):
    """Gate logits [N, E] (numpy f32) of one kind: "balanced" N(0, 1);
    "skewed", every token leaning to expert 0, so that it overflows its
    capacity; "ties", small integers, so that equal logits are common (the
    lower index must win)."""
    rng = np.random.RandomState(seed)
    if kind == "ties":
        return rng.randint(-2, 3, (N, E)).astype(np.float32)
    lg = rng.randn(N, E).astype(np.float32)
    if kind == "skewed":
        lg[:, 0] += 3.0
    return lg


def tutel_capacity(N, E, K, factor=1.5):
    """MoELayer.capacity: Tutel's K * int(factor * ceil(N / E)), within [1, N]."""
    return max(1, min(K * int(factor * ((N + E - 1) // E)), N))


def jax_sample_draws(num_timesteps, repaint, rng, shape, *, outpainting=False,
                     pre_len=None, clip_idx=0):
    """The standard-normal draws of one ``MotionDiffusion.sample`` call of
    the JAX package with key ``rng``, in the order the port consumes them:
    the initial noise (``split(rng)[0]``), then per loop step (``key, sub =
    split(key)`` from ``split(rng)[1]``): a DDIM step's pre-sequence noise
    (``split(sub, 4)[0]``) and outpainting noise (``split(sub, 4)[3]``,
    unless the tail bank replaces it), a re-noising step's noise (``sub``).
    eta is 0, so the eta noise is never drawn."""
    import jax
    import jax.numpy as jnp
    from motioncraft_tpu.diffusion.schedules import get_schedule_jump_cjm_ddim

    B, T, D = shape
    normal = lambda key, s: np.asarray(jax.random.normal(key, s, jnp.float32))  # noqa: E731
    r_noise, key = jax.random.split(rng)
    draws = [normal(r_noise, shape)]
    gt_noise = outpainting and not (repaint.same_overlap_noisy and clip_idx > 0)
    if outpainting and not repaint.no_repaint:
        times = (get_schedule_jump_cjm_ddim(num_timesteps) if repaint.no_resample else
                 get_schedule_jump_cjm_ddim(num_timesteps, jump_length=repaint.jump_length,
                                            jump_n_sample=repaint.jump_n_sample))
        for t_last, t_cur in zip(times[:-1], times[1:]):
            key, sub = jax.random.split(key)
            if t_cur > t_last:
                draws.append(normal(sub, shape))
            elif gt_noise:
                draws.append(normal(jax.random.split(sub, 4)[3], shape))
        return draws
    for _ in range(num_timesteps):
        key, sub = jax.random.split(key)
        r_seed, _, _, r_gt = jax.random.split(sub, 4)
        if pre_len:
            draws.append(normal(r_seed, (B, pre_len, D)))
        if gt_noise:
            draws.append(normal(r_gt, shape))
    return draws


def jax_windowed_draws(num_timesteps, repaint, rng, shape, rounds, pre_frames,
                       use_repaint=True):
    """The draws of a JAX windowed sampler over ``rounds`` windows: window w
    samples with ``fold_in(rng, w)``."""
    import jax

    draws = []
    for w in range(rounds):
        key = jax.random.fold_in(rng, w)
        if w == 0:
            draws += jax_sample_draws(num_timesteps, repaint, key, shape)
        elif use_repaint:
            draws += jax_sample_draws(num_timesteps, repaint, key, shape, outpainting=True,
                                      clip_idx=1 if w >= 2 else 0)
        else:
            draws += jax_sample_draws(num_timesteps, repaint, key, shape, pre_len=pre_frames)
    return draws


def jax_ddpm_draws(num_timesteps, rng, shape, *, pre_len=None, initial=True):
    """The standard-normal draws of the JAX package's DDPM sampling with key
    ``rng``, in the order the port consumes them: with ``initial``
    (``MotionDiffusion.sample``) the initial noise (``split(rng)[0]``) and the
    loop on ``split(rng)[1]``, else ``p_sample_loop`` on ``rng`` itself; per
    step (``key, sub = split(key)``, ``r_seed, r_noise = split(sub)``) the
    pre-sequence's noise (with ``pre_len``) and the step's noise, drawn at
    t = 0 too."""
    import jax
    import jax.numpy as jnp

    B, T, D = shape
    normal = lambda key, s: np.asarray(jax.random.normal(key, s, jnp.float32))  # noqa: E731
    draws, key = [], rng
    if initial:
        r_noise, key = jax.random.split(rng)
        draws.append(normal(r_noise, shape))
    for _ in range(num_timesteps):
        key, sub = jax.random.split(key)
        r_seed, r_step = jax.random.split(sub)
        if pre_len:
            draws.append(normal(r_seed, (B, pre_len, D)))
        draws.append(normal(r_step, shape))
    return draws
