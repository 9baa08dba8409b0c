"""The ported training slice against the JAX package on the CPU.

The same numpy inputs (and, where JAX draws them, the JAX run's own random
numbers, recomputed here from its key) go through the JAX functions and the
port's counterparts:

  - q_sample / training_losses and the timestep samplers (their numpy
    history bookkeeping must agree exactly);
  - load_importance_loss, MoELayer in training at gate noise 1.0 with the
    noise fed to both, and STMA's training path, forward and gradients;
  - the tiny config's MotionDiffusion.loss and every parameter's gradient,
    at gate_noise 0 (the gate noise draws of the two frameworks differ);
  - two Adam steps of each package's train step, with the lr schedule's
    boundary between them, and the frozen CLIP untouched on both sides;
  - a 20-step port-only train_model run whose loss falls.

Tolerances: module outputs and the loss agree to 1e-5 and gradients to 1e-4
of the largest magnitude compared (per tensor, at least 1): the sums run in
another order, erf comes from different libraries, and a gradient sums
hundreds of such products.  After two Adam steps the parameters agree to
2e-2 x lr: Adam divides each gradient by its own root mean square, so a
gradient at rounding level (its sign undecided) moves its parameter by up to
lr on either side; the bound admits that for at most 0.1% of the elements
and holds every other element to it.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import motioncraft_tpu.models  # noqa: F401  (registers the flax classes)
from motioncraft_tpu.apis.factory import make_text_batch, tiny_t2m_cfg
from motioncraft_tpu.apis.train import make_train_step as jax_make_train_step
from motioncraft_tpu.diffusion import build_diffusion as jax_diffusion
from motioncraft_tpu.diffusion import gaussian as jax_gaussian
from motioncraft_tpu.diffusion import samplers as jax_samplers
from motioncraft_tpu.models import attentions as jax_att
from motioncraft_tpu.models import moe as jax_moe
from motioncraft_tpu.parallel import build_lr_schedule as jax_lr_schedule
from motioncraft_tpu.parallel import create_train_state
from motioncraft_tpu.parallel.train_state import build_optimizer as jax_build_optimizer
from motioncraft_tpu.registry import build_architecture as build_jax
from motioncraft_tpu_torch.apis import make_train_batch, make_train_step, train_model
from motioncraft_tpu_torch.apis.train import device_prefetch
from motioncraft_tpu_torch.diffusion import build_diffusion, q_sample, training_losses
from motioncraft_tpu_torch.diffusion import samplers
from motioncraft_tpu_torch.models import attentions, moe
from motioncraft_tpu_torch.parallel import TrainState, build_lr_schedule
from motioncraft_tpu_torch.registry import build_architecture as build_torch
from motioncraft_tpu_torch.utils.convert import fabricate_state_dict, from_jax_params
from test_torch_modules import STMA_KW, carry
from torch_port_util import assert_close_scaled, grad_mode_on, seeded_params, t  # noqa: F401

REL = 1e-5
GRAD_REL = 1e-4


def assert_grads_close(got: dict, want: dict, rel=GRAD_REL):
    assert set(got) == set(want)
    for name in sorted(want):
        assert_close_scaled(got[name], want[name], rel, name)


# ------------------------------------------------------------------ diffusion
def test_q_sample_and_training_losses():
    cfg = tiny_t2m_cfg()["diffusion_train"]
    dj, dt = jax_diffusion(cfg), build_diffusion(cfg)
    rng = np.random.RandomState(0)
    x0, noise = rng.randn(2, 3, 4, 5).astype(np.float32)
    ts = np.array([0, 999, 417], np.int32)
    np.testing.assert_array_equal(
        q_sample(dt, t(x0), t(ts, torch.long), t(noise)).numpy(),
        np.asarray(jax_gaussian.q_sample(dj, jnp.asarray(x0), ts, jnp.asarray(noise))))
    got = training_losses(dt, lambda x, s: torch.tanh(x) * s[:, None, None].float() / 1000,
                          t(x0), t(ts, torch.long), t(noise))
    want = jax_gaussian.training_losses(
        dj, lambda x, s: jnp.tanh(x) * s[:, None, None] / 1000, jnp.asarray(x0), ts,
        jnp.asarray(noise))
    for key in ("mse", "target", "pred", "x_t"):
        assert_close_scaled(got[key].numpy(), want[key], REL, key)


def test_schedule_samplers():
    assert isinstance(samplers.create_named_schedule_sampler("uniform", 10),
                      samplers.UniformSampler)
    g = torch.Generator().manual_seed(0)
    ts, w = samplers.UniformSampler(10).sample(64, g)
    assert ts.min() >= 0 and ts.max() < 10 and torch.equal(w, torch.ones(64))

    jax_s = jax_samplers.LossSecondMomentResampler(6, history_per_term=3)
    port_s = samplers.create_named_schedule_sampler("loss-second-moment", 6)
    port_s.history_per_term = 3
    port_s._loss_history = np.zeros([6, 3])
    rng = np.random.RandomState(1)
    for _ in range(12):
        ts, losses = rng.randint(0, 6, (5,)), rng.rand(5).astype(np.float32)
        jax_s.update_with_local_losses(jnp.asarray(ts), jnp.asarray(losses))
        port_s.update_with_local_losses(torch.from_numpy(ts), torch.from_numpy(losses))
        np.testing.assert_array_equal(port_s._loss_history, jax_s._loss_history)
        np.testing.assert_array_equal(port_s._loss_counts, jax_s._loss_counts)
        np.testing.assert_array_equal(port_s.weights(), jax_s.weights())
    assert port_s._warmed_up()
    ts, w = port_s.sample(4096, g)
    p = port_s.weights() / port_s.weights().sum()
    np.testing.assert_allclose(w.numpy(), 1 / (6 * p[ts.numpy()]), rtol=1e-6)


# ----------------------------------------------------------------------- MoE
@pytest.mark.parametrize("gate_noise", [0.0, 1.0])
def test_load_importance_loss(gate_noise):
    rng = np.random.RandomState(2)
    scores = rng.dirichlet(np.ones(8), 50).astype(np.float32)
    top = -np.sort(-scores, axis=1)[:, :2]
    want = jax_moe.load_importance_loss(jnp.asarray(scores), jnp.asarray(top), 8, gate_noise)
    got = moe.load_importance_loss(t(scores), t(top), 8, gate_noise)
    assert_close_scaled(got.numpy(), want, REL)


def _jax_train_apply(flax_module, variables, noise, *args, **kw):
    """flax apply in training, its gate-noise draws replaced by ``noise``
    (one [N, E] array per MoE call, in call order) and its sown losses
    returned with the output.  Other normal draws of that shape-checking
    apply (flax evaluates the param initializers' shapes) stay as they are."""
    pending = list(noise)
    real = jax.random.normal

    def fed(key, shape, dtype=jnp.float32):
        if pending and tuple(shape) == pending[0].shape:
            return jnp.asarray(pending.pop(0), dtype)
        return real(key, shape, dtype)

    jax.random.normal = fed
    try:
        return flax_module.apply(variables, *args, train=True, mutable=["losses"],
                                 rngs={"gate_noise": jax.random.PRNGKey(0)}, **kw)
    finally:
        jax.random.normal = real


@pytest.mark.parametrize("drops", [False, True])
def test_moe_layer_train(drops):
    """Gate noise 1.0 fed to both, batch-prioritized slot dispatch, with and
    without capacity drops; output, aux loss and gradients."""
    N, D, E, K = 600, 32, 4, 2
    rng = np.random.RandomState(3)
    x = rng.randn(N, D).astype(np.float32)
    noise = rng.randn(N, E).astype(np.float32)
    w = rng.randn(N, D).astype(np.float32)
    kw = dict(gate_noise=1.0, capacity_factor=0.75 if drops else 1.5)
    flax_m = jax_moe.MoELayer(E, K, D, 2 * D, **kw)
    v, m = carry(flax_m, moe.MoELayer(E, K, D, 2 * D, **kw), x)

    def jax_loss(params, x_):
        (y, l_aux), _ = _jax_train_apply(flax_m, {"params": params}, [noise], x_)
        return (y * w).sum() + l_aux, (y, l_aux)

    (_, (want_y, want_aux)), want_g = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(
        v["params"], jnp.asarray(x))
    m.train()
    aux = []
    y = m(t(x), noise=t(noise), aux_losses=aux)
    with torch.no_grad():
        counts = torch.bincount(m.gate(t(x)).add(t(noise) / E).topk(K).indices.reshape(-1),
                                minlength=E)
    assert (int(counts.max()) > m.capacity(N)) == drops
    assert_close_scaled(y.detach().numpy(), want_y, REL, "y")
    assert_close_scaled(aux[0].detach().numpy(), want_aux, REL, "aux")
    ((y * t(w)).sum() + aux[0]).backward()
    assert_grads_close({k: p.grad.numpy() for k, p in m.named_parameters()},
                       {k: a.numpy() for k, a in from_jax_params(want_g).items()})


def test_stma_train():
    """STMA's training path (text branch in the layer, joined keys and
    values, K5's plain version, the aux losses) at gate noise 0."""
    rng = np.random.RandomState(4)
    B, T, TXT = 3, 12, 77
    kw_np = dict(xf=rng.randn(B, TXT, 16).astype(np.float32),
                 emb=rng.randn(B, 32).astype(np.float32),
                 src_mask=(np.arange(T)[None, :, None] < np.array([12, 7, 3])[:, None, None]
                           ).astype(np.float32),
                 cond_type=np.array([5, 0, 91], np.float32).reshape(B, 1, 1))
    x = rng.randn(B, T, 6 * 8).astype(np.float32)
    w = rng.randn(B, T, 6 * 8).astype(np.float32)
    cfg = dict(STMA_KW, gate_noise=0.0)
    flax_m = jax_att.STMA(**cfg)
    v, m = carry(flax_m, attentions.STMA(**cfg), x, **kw_np)

    def jax_loss(params):
        y, state = flax_m.apply({"params": params}, jnp.asarray(x), train=True,
                                mutable=["losses"],
                                **{k: jnp.asarray(a) for k, a in kw_np.items()})
        aux = sum(jax.tree_util.tree_leaves(state["losses"]["aux_loss"]))
        return (y * w).sum() + aux, (y, aux)

    (_, (want_y, want_aux)), want_g = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(
        v["params"])
    m.train()
    aux = []
    y = m(t(x), **{k: t(a) for k, a in kw_np.items()}, aux_losses=aux)
    assert len(aux) == 2  # the text and the motion MoE
    assert_close_scaled(y.detach().numpy(), want_y, REL, "STMA")
    assert_close_scaled(sum(aux).detach().numpy(), want_aux, REL, "aux")
    ((y * t(w)).sum() + sum(aux)).backward()
    assert_grads_close({k: p.grad.numpy() for k, p in m.named_parameters()},
                       {k: a.numpy() for k, a in from_jax_params(want_g).items()})


# ------------------------------------------------------------ whole model
def _train_cfg():
    cfg = tiny_t2m_cfg()
    cfg["model"]["ca_block_cfg"]["gate_noise"] = 0.0
    return cfg


@pytest.fixture(scope="module")
def pair():
    cfg = _train_cfg()
    arch_j = build_jax(cfg)
    rng = np.random.RandomState(5)
    batch = make_text_batch(["a person walks forward", "someone waves hello"],
                            max_seq_len=16, motion=rng.randn(2, 16, 322).astype(np.float32),
                            lengths=np.array([[16], [11]], np.int32))
    variables = arch_j.init(jax.random.PRNGKey(0), batch)
    params = seeded_params(jax.tree_util.tree_map(np.asarray, variables["params"]), 1)
    arch_t = build_torch(cfg, device="cpu")
    arch_t.model.load_state_dict(from_jax_params(params), strict=True)
    return arch_j, params, arch_t, batch


def jax_draws(arch_j, batch, rng):
    """The t, noise and cond_type that MotionDiffusion.loss draws from rng."""
    r_t, r_noise, r_cond, _, _ = jax.random.split(rng, 5)
    B = batch["motion"].shape[0]
    return dict(t=np.asarray(arch_j.sampler.sample(r_t, B)[0]),
                noise=np.asarray(jax.random.normal(r_noise, batch["motion"].shape)),
                cond_type=np.asarray(jax.random.randint(r_cond, (B, 1, 1), 0, 100)))


def test_loss_and_gradients(pair):
    arch_j, params, arch_t, batch = pair
    rng = jax.random.PRNGKey(11)
    (_, logs_j), grads_j = jax.jit(jax.value_and_grad(
        lambda p: arch_j.loss({"params": p}, batch, rng), has_aux=True))(
            jax.tree_util.tree_map(jnp.asarray, params))
    draws = jax_draws(arch_j, batch, rng)
    arch_t.zero_grad()
    arch_t.train()
    try:
        total, logs_t = arch_t.loss(batch, **draws)
        total.backward()
    finally:
        arch_t.eval()
    np.testing.assert_array_equal(logs_t["timesteps"].numpy(), np.asarray(logs_j["timesteps"]))
    for key in ("loss", "recon_loss", "moe_route_loss", "recon_loss_batch", "t_mean"):
        assert_close_scaled(logs_t[key].detach().numpy(), logs_j[key], REL, key)
    assert float(logs_j["moe_route_loss"]) > 0
    want = {k: a.numpy() for k, a in from_jax_params(jax.device_get(grads_j)).items()}
    for name in [k for k in want if k.startswith("text_enc.clip.")]:
        assert not np.any(want.pop(name)), f"JAX grad of the frozen {name} is not zero"
        assert arch_t.model.get_parameter(name).grad is None
    assert_grads_close({k: p.grad.numpy() for k, p in arch_t.model.named_parameters()
                        if p.grad is not None}, want)
    arch_t.zero_grad()


def test_two_adam_steps(pair):
    arch_j, params, arch_t, batch = pair
    lr, policy = 1e-3, dict(policy="step", step=[1], gamma=0.5)
    schedule_j = jax_lr_schedule(lr, policy, 1)
    schedule_t = build_lr_schedule(lr, policy, 1)
    assert [schedule_t(c) for c in range(3)] == pytest.approx(
        [float(schedule_j(c)) for c in range(3)], rel=1e-7)
    assert schedule_t(0) == lr and schedule_t(1) == lr * 0.5

    state_j = create_train_state(jax.tree_util.tree_map(jnp.asarray, params),
                                 {"type": "Adam", "lr": lr}, schedule_j)
    step_j = jax.jit(jax_make_train_step(arch_j))
    port_model = build_torch(_train_cfg(), device="cpu")
    port_model.model.load_state_dict(arch_t.model.state_dict())
    state_t = TrainState(port_model.model, {"type": "Adam", "lr": lr}, schedule_t)
    step_t = make_train_step(port_model, state_t)
    port_model.train()
    try:
        for seed in (21, 22):
            rng = jax.random.PRNGKey(seed)
            state_j, _ = step_j(state_j, batch, rng)
            step_t(batch, **jax_draws(arch_j, batch, rng))
    finally:
        port_model.eval()
    assert state_t.step == int(state_j.step) == 2
    before = from_jax_params(params)
    want = from_jax_params(jax.device_get(state_j.params))
    got = port_model.model.state_dict()
    for name, w in want.items():
        if name.startswith("text_enc.clip."):
            assert torch.equal(w, before[name]) and torch.equal(got[name], before[name]), name
            continue
        diff = (got[name] - w).abs()
        assert float(diff.max()) <= 2 * lr, name
        assert int((diff > 2e-2 * lr).sum()) <= max(1, diff.numel() // 1000), name
    assert sum(not torch.equal(got[n], before[n]) for n in want) > len(want) // 2


@pytest.mark.parametrize("clip", [None, dict(max_norm=0.5)])
@pytest.mark.parametrize("opt", [dict(type="Adam", lr=1e-2),
                                 dict(type="AdamW", lr=1e-2, weight_decay=0.1),
                                 dict(type="SGD", lr=1e-2, momentum=0.9),
                                 dict(type="Adafactor", lr=1e-2),
                                 dict(type="AdaBelief", lr=1e-2),
                                 dict(type="Lamb", lr=1e-2)])
def test_optimizers_match_optax(opt, clip):
    """Three updates with a step decay after the second, against the JAX
    package's optax chain (clip by global norm inside it when set).  "c" and
    "d" are large enough for Adafactor to factor their second moments (two
    dims of at least 128), "a" and "b" are not."""
    rng = np.random.RandomState(9)
    p0 = {"a": rng.randn(3, 4).astype(np.float32), "b": rng.randn(5).astype(np.float32),
          "c": rng.randn(130, 200).astype(np.float32),
          "d": rng.randn(2, 128, 140).astype(np.float32)}
    grads = [{k: rng.randn(*v.shape).astype(np.float32) for k, v in p0.items()}
             for _ in range(3)]
    policy = dict(policy="step", step=[2], gamma=0.1)
    tx = jax_build_optimizer(opt, jax_lr_schedule(opt["lr"], policy, 1), clip,
                             frozen_prefixes=())
    params = {k: jnp.asarray(v) for k, v in p0.items()}
    opt_state = tx.init(params)
    module = torch.nn.Module()
    for k, v in p0.items():
        module.register_parameter(k, torch.nn.Parameter(t(v)))
    state = TrainState(module, opt, build_lr_schedule(opt["lr"], policy, 1), clip,
                       frozen_prefixes=())
    for g in grads:
        updates, opt_state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                       opt_state, params)
        params = optax.apply_updates(params, updates)
        for k, v in g.items():
            module.get_parameter(k).grad = t(v)
        state.apply_gradients()
    for k, v in params.items():
        np.testing.assert_allclose(module.get_parameter(k).detach().numpy(), np.asarray(v),
                                   rtol=0, atol=1e-6)


def test_cosine_schedule_matches_optax():
    policy = dict(policy="CosineAnnealing", total_steps=10, min_lr_ratio=0.1)
    want = jax_lr_schedule(2e-4, policy)
    got = build_lr_schedule(2e-4, policy)
    for count in (0, 1, 5, 9, 10, 15):
        assert got(count) == pytest.approx(float(want(count)), rel=1e-6)


def test_train_model_loss_falls():
    arch = build_torch(tiny_t2m_cfg(), device="cpu")
    arch.model.load_state_dict(fabricate_state_dict(arch.model, seed=0), strict=True)
    clip = {k: v.clone() for k, v in arch.model.state_dict().items()
            if k.startswith("text_enc.clip.")}
    batches = [make_train_batch(4, seed=i, max_seq_len=16) for i in range(2)]
    lines = []
    train_model(arch, batches, optimizer_cfg=dict(type="Adam", lr=1e-3), max_epochs=10,
                log_interval=1, logger=lines.append)
    losses = [float(s.split(" loss=")[1].split()[0]) for s in lines if " loss=" in s]
    assert len(losses) == 20 and all(np.isfinite(losses))
    assert np.mean(losses[-5:]) < 0.95 * np.mean(losses[:5]), losses
    assert not arch.training
    state = arch.model.state_dict()
    assert all(torch.equal(v, state[k]) for k, v in clip.items())


def test_train_model_cut_options_raise():
    """A mesh with a pipe axis over an expert axis (pipeline parallelism
    composes with the data axis alone, as tools/train.py's) and float16
    raise; fp16={} trains in bf16 (the JAX package's default compute dtype)
    against f32 masters; an optimizer neither package builds raises."""
    from motioncraft_tpu_torch.parallel.mesh import create_mesh

    arch = build_torch(tiny_t2m_cfg(), device="cpu")
    with pytest.raises(ValueError, match="composes only with the data axis"):
        create_mesh(4, axes=("data", "expert", "pipe"), shape=(1, 2, 2))
    with pytest.raises(NotImplementedError):
        train_model(arch, [make_train_batch(2, max_seq_len=16)], fp16={"dtype": "float16"})
    before = {k: v.clone() for k, v in arch.model.state_dict().items()}
    state = train_model(arch, [make_train_batch(2, max_seq_len=16)], fp16={},
                        logger=lambda m: None)
    after = arch.model.state_dict()
    assert state.step == 1 and all(v.dtype == torch.float32 for v in after.values())
    assert any(not torch.equal(after[k], before[k]) for k in after)
    with pytest.raises(NotImplementedError):
        TrainState(arch.model, {"type": "Lion"})


def test_grad_accum_keeps_input_order():
    arch = build_torch(tiny_t2m_cfg(), device="cpu")
    state = TrainState(arch.model, {"type": "SGD", "lr": 0.0})
    step = make_train_step(arch, state, grad_accum=2)
    batch = make_train_batch(4, max_seq_len=16)
    arch.train()
    try:
        logs = step(batch, t=np.array([5, 6, 7, 8]))
        with pytest.raises(ValueError, match="must divide"):
            make_train_step(arch, state, grad_accum=3)(batch)
    finally:
        arch.eval()
    assert logs["_timesteps"].tolist() == [5, 6, 7, 8] and logs["_loss_batch"].shape == (4,)
    assert state.step == 1 and np.isfinite(float(logs["loss"]))


def test_device_prefetch_order_errors_and_early_exit():
    def batches(n, fail_at=None):
        for i in range(n):
            if i == fail_at:
                raise KeyError("feeder failed")
            yield {"motion": np.full((2, 3), i, np.float32), "name": "dropped"}

    got = [int(b["motion"][0, 0]) for b in device_prefetch(batches(7), "cpu", depth=2)]
    assert got == list(range(7))
    assert all(set(b) == {"motion"} for b in device_prefetch(batches(2), "cpu"))
    with pytest.raises(KeyError, match="feeder failed"):
        for _ in device_prefetch(batches(5, fail_at=3), "cpu"):
            pass
    before = threading.active_count()
    gen = device_prefetch(batches(1000), "cpu", depth=1)
    next(gen)
    gen.close()  # the consumer stops early: the feeder must not stay blocked
    assert threading.active_count() == before
