"""bf16 training of the port against the JAX package's, on the CPU.

- Promotion: the port's ``promote_dtype``, ``Linear`` and ``LayerNorm`` on
  bf16 weights against flax's ``promote_dtype``, Dense and LayerNorm, with
  an f32 input (f32 out, on the rounded weights) and a bf16 one (bf16 out).
  Tolerance 1e-5 x scale in f32 (another summation order), one bf16 ulp
  of the largest output (2^-7 of it) in bf16 (each rounds its f32 result
  once, and a result near a rounding boundary may round the other way).
- The tiny T2M config, gate noise 0 (the frameworks' gate noise draws
  differ): the JAX package's bf16 step (``make_train_step(fp16=...)``'s
  loss function: every floating parameter cast to bf16 inside the
  differentiated function, the loss in f32 times ``loss_scale``, the
  gradients divided by it) against the port's ``make_train_step(fp16=)``:
  the loss terms and every gradient, at ``loss_scale`` 1 and 8; then two
  Adam steps of each package's own train step with ``loss_scale=8.0`` and
  ``grad_accum=2``.  The port's MoE gates are fed the JAX run's logits
  (values; the gradient flows through the port's own gate): the text
  features reach the text MoEs' gates in bf16, one ulp apart between the
  frameworks, which moves near-tied expert choices; on a row where the port
  (by logit) and JAX (by softmax score) would rank differently it gets the
  log-scores, whose order is JAX's pick (as tests/test_torch_quant.py).
  Tolerances: the loss terms 1e-5 x max(1, |JAX|), as in f32 (the loss
  runs on the f32 motion path); each gradient 1e-3 x max(1, max |JAX|):
  both round it to bf16 (the parameter's dtype in the step), and the bf16
  text path rounds its intermediates in other places (XLA rounds each op
  of a softmax to bf16, torch rounds the fused result once), which leaves
  the text path's gradients up to 1-2% of their tensor's largest apart.
  After the two Adam steps: both Adam moments, which hold the two steps'
  gradients (divided by the loss scale, averaged over the microbatches),
  agree to 3e-2 of their tensor's largest (plus 1e-9 for the few tensors
  whose gradient is zero up to rounding, e.g. a key bias under a softmax
  over the keys); each parameter whose first moment is at least a quarter
  of its tensor's largest agrees to 2e-2 lr; every parameter agrees to
  4.01 lr, the most two Adam steps from one start can part (each moves it
  at most 1.0014 lr).  Adam divides each element by its own root mean
  square, so an element whose gradient sits in that bf16 noise moves up to
  lr either way: an f32 test's elementwise bound does not hold there.
- Every other family trains in bf16 too (the port alone; their f32 steps
  are held against JAX by tests/test_torch_baseline_train.py and
  tests/test_torch_controlnet_train.py): one bf16 Adam step of each tiny
  baseline config and of the tiny S2G ControlNet (the WavEncoder's
  convolutions promote the f32 audio, as flax's Conv does): a finite loss,
  f32 masters, and the trainable parameters moved.
"""

import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import motioncraft_tpu.models  # noqa: F401  (registers the flax classes)
from motioncraft_tpu.apis.factory import make_text_batch, tiny_t2m_cfg
from motioncraft_tpu.apis.train import make_train_step as jax_make_train_step
from motioncraft_tpu.models.blocks import LayerNorm as FlaxLayerNorm
from motioncraft_tpu.models.moe import CosineTopGate as JaxGate
from motioncraft_tpu.parallel import create_train_state
from motioncraft_tpu.registry import build_architecture as build_jax
from motioncraft_tpu_torch.apis import make_train_batch, make_train_step
from motioncraft_tpu_torch.config import Config
from motioncraft_tpu_torch.models.blocks import LayerNorm, Linear, promote_dtype
from motioncraft_tpu_torch.models.moe import CosineTopGate
from motioncraft_tpu_torch.parallel import TrainState
from motioncraft_tpu_torch.registry import build_architecture as build_torch
from motioncraft_tpu_torch.utils.convert import fabricate_state_dict, from_jax_params
from test_torch_baseline_train import FAMILIES, family_batch
from test_torch_controlnet_train import speech_audio
from test_torch_quant import _as_jax_picks
from test_torch_train import jax_draws
from torch_port_util import assert_close_scaled, grad_mode_on, seeded_params, t  # noqa: F401
from torch_port_util import train_step_grads

BF = jnp.bfloat16
REL = 1e-5
GRAD_REL = 1e-3
MOMENT_REL, MOMENT_ATOL = 3e-2, 1e-9
FP16 = dict(dtype="bfloat16")


def _f32(a):
    return np.array(a.detach().float() if torch.is_tensor(a) else jnp.asarray(a, jnp.float32))


def test_promotion_is_flax_s():
    rng = np.random.RandomState(0)
    x = rng.randn(5, 24).astype(np.float32)
    w = jnp.asarray(rng.randn(24, 16) * 0.2, BF)
    b = jnp.asarray(rng.randn(16) * 0.1, BF)
    dense, ln = fnn.Dense(16), FlaxLayerNorm()
    lin, norm = Linear(24, 16), LayerNorm(24)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(_f32(w).T))
        lin.bias.copy_(torch.from_numpy(_f32(b)))
        norm.weight.copy_(torch.from_numpy(rng.rand(24).astype(np.float32) + 0.5))
        norm.bias.copy_(torch.from_numpy(rng.randn(24).astype(np.float32) * 0.1))
    lin.to(torch.bfloat16)
    norm.to(torch.bfloat16)
    ln_p = {"scale": jnp.asarray(_f32(norm.weight), BF), "bias": jnp.asarray(_f32(norm.bias), BF)}
    for xj, xt in ((jnp.asarray(x), t(x)), (jnp.asarray(x, BF), t(x).to(torch.bfloat16))):
        want_d = dense.apply({"params": {"kernel": w, "bias": b}}, xj)
        want_n = ln.apply({"params": ln_p}, xj)
        with torch.no_grad():
            got_d, got_n = lin(xt), norm(xt)
        for got, want in ((got_d, want_d), (got_n, want_n)):
            assert str(got.dtype).split(".")[1] == str(want.dtype)
            tol = (2.0 ** -7 if want.dtype == BF else REL) * np.abs(_f32(want)).max()
            np.testing.assert_allclose(_f32(got), _f32(want), rtol=0, atol=tol)
    a, none, c = promote_dtype(t(x).to(torch.bfloat16), None, t(x))
    assert a.dtype == c.dtype == torch.float32 and none is None
    assert torch.equal(a, t(x).to(torch.bfloat16).float())


# ------------------------------------------------------------ whole model
def _cfg():
    cfg = tiny_t2m_cfg()
    cfg["model"]["ca_block_cfg"]["gate_noise"] = 0.0
    return cfg


@pytest.fixture(scope="module")
def pair():
    cfg = _cfg()
    arch_j = build_jax(cfg)
    rng = np.random.RandomState(5)
    batch = make_text_batch(["a person walks forward", "someone waves hello"],
                            max_seq_len=16, motion=rng.randn(2, 16, 322).astype(np.float32),
                            lengths=np.array([[16], [11]], np.int32))
    variables = arch_j.init(jax.random.PRNGKey(0), batch)
    params = seeded_params(jax.tree_util.tree_map(np.asarray, variables["params"]), 1)
    return arch_j, params, batch


def _port(params):
    arch = build_torch(_cfg(), device="cpu")
    arch.model.load_state_dict(from_jax_params(params), strict=True)
    return arch


def _recorder(got):
    """A flax interceptor that sends each MoE gate's logits to the host,
    keyed by the gate's path, in call order (inside jit, scan and grad)."""
    def record(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        if isinstance(context.module, JaxGate) and context.method_name == "__call__":
            name = ".".join(context.module.path)
            jax.debug.callback(lambda a, name=name: got.setdefault(name, []).append(
                np.asarray(a)), out)
        return out
    return record


class _Pin(torch.autograd.Function):
    """The given value, the identity's gradient."""

    @staticmethod
    def forward(ctx, out, value):
        return value.clone()

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def _pin_gates(model, logits):
    """Hooks that hand each gate call of ``model`` the next of ``logits``
    {gate module path: [logits a call]} in call order; returns the handles
    and the calls made."""
    calls = {}

    def hook(name):
        def fn(mod, inp, out):
            i = calls.get(name, 0)
            calls[name] = i + 1
            return _Pin.apply(out, torch.from_numpy(_as_jax_picks(logits[name][i])))
        return fn

    return [m.register_forward_hook(hook(n)) for n, m in model.named_modules()
            if isinstance(m, CosineTopGate)], calls


@pytest.fixture(scope="module")
def jax_bf16_grads(pair):
    """(loss_scale) -> (logs, gradients, gate logits) of the JAX package's
    bf16 step on the pair's batch, ``make_train_step(fp16=...)``'s loss
    function (the loss scale traced: one compile)."""
    arch_j, params, batch = pair
    rng = jax.random.PRNGKey(11)
    logits = {}

    def loss_fn(p, loss_scale):
        p = jax.tree_util.tree_map(lambda a: a.astype(BF), p)
        with fnn.intercept_methods(_recorder(logits)):
            loss, logs = arch_j.loss({"params": p}, batch, rng)
        return jnp.asarray(loss, jnp.float32) * loss_scale, logs

    grad_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    p = jax.tree_util.tree_map(jnp.asarray, params)

    def run(loss_scale):
        logits.clear()
        (_, logs), grads = grad_fn(p, jnp.float32(loss_scale))
        grads = jax.tree_util.tree_map(lambda g: np.asarray(g) / loss_scale, grads)
        return logs, grads, dict(logits)

    return rng, run


@pytest.mark.parametrize("loss_scale", [1.0, 8.0])
def test_bf16_loss_and_gradients(pair, jax_bf16_grads, loss_scale):
    arch_j, params, batch = pair
    rng, run = jax_bf16_grads
    logs_j, grads_j, logits = run(loss_scale)
    arch_t = _port(params)
    handles, calls = _pin_gates(arch_t.model, logits)
    try:
        logs_t, got = train_step_grads(arch_t, batch, fp16=dict(FP16, loss_scale=loss_scale),
                                       **jax_draws(arch_j, batch, rng))
    finally:
        for h in handles:
            h.remove()
    assert sorted(calls) == sorted(logits) and len(calls) == 4 and set(calls.values()) == {1}
    for key in ("loss", "recon_loss", "moe_route_loss"):
        assert_close_scaled(logs_t[key].numpy(), logs_j[key], REL, key)
    assert all(p.dtype == torch.float32 for p in arch_t.model.parameters())
    want = {k: a.numpy() for k, a in from_jax_params(grads_j).items()}
    for name in [k for k in want if k.startswith("text_enc.clip.")]:
        assert not np.any(want.pop(name)) and name not in got
    assert set(got) == set(want)
    for name in sorted(want):
        assert got[name].dtype == torch.float32
        # the f32 master takes the bf16 gradient widened: bf16 values
        assert torch.equal(got[name], got[name].to(torch.bfloat16).float()), name
        assert_close_scaled(got[name].numpy(), want[name], GRAD_REL, name)


def test_two_adam_steps_bf16_loss_scale_grad_accum(pair):
    arch_j, params, batch = pair
    lr, fp16, accum = 1e-3, dict(FP16, loss_scale=8.0), 2
    state_j = create_train_state(jax.tree_util.tree_map(jnp.asarray, params),
                                 {"type": "Adam", "lr": lr})
    logits = {}
    step = jax_make_train_step(arch_j, fp16=fp16, grad_accum=accum)

    def recorded(state, b, r):
        with fnn.intercept_methods(_recorder(logits)):
            return step(state, b, r)

    step_j = jax.jit(recorded)
    arch_t = _port(params)
    state_t = TrainState(arch_t.model, {"type": "Adam", "lr": lr})
    step_t = make_train_step(arch_t, state_t, fp16=fp16, grad_accum=accum)
    arch_t.train()
    try:
        for seed in (21, 22):
            rng = jax.random.PRNGKey(seed)
            logits.clear()
            state_j, logs_j = step_j(state_j, batch, rng)
            jax.block_until_ready(state_j.params)
            # the scan's microbatches: rows [i m, (i + 1) m) with key split(rng)[i]
            m = batch["motion"].shape[0] // accum
            draws = [jax_draws(arch_j, {k: v[i * m:(i + 1) * m] for k, v in batch.items()},
                               r) for i, r in enumerate(jax.random.split(rng, accum))]
            handles, calls = _pin_gates(arch_t.model, logits)
            try:
                logs_t = step_t(batch, **{k: np.concatenate([d[k] for d in draws])
                                          for k in draws[0]})
            finally:
                for h in handles:
                    h.remove()
            assert calls == {k: accum for k in logits} and len(calls) == 4
            assert_close_scaled(logs_t["loss"].numpy(), logs_j["loss"], REL, "loss")
    finally:
        arch_t.eval()
    assert state_t.step == int(state_j.step) == 2
    moments_j = _adam_moments(state_j.opt_state)
    names = {id(p): n for n, p in arch_t.model.named_parameters()}
    moments_t = {names[id(p)]: (st["exp_avg"], st["exp_avg_sq"])
                 for p, st in state_t.optimizer.state.items()}
    assert set(moments_t) == set(moments_j) and moments_t
    before = from_jax_params(params)
    want = from_jax_params(jax.device_get(state_j.params))
    got = arch_t.model.state_dict()
    for name, w in want.items():
        assert got[name].dtype == torch.float32
        if name.startswith("text_enc.clip."):
            assert torch.equal(got[name], before[name]), name
            continue
        for m_t, m_j in zip(moments_t[name], moments_j[name]):
            np.testing.assert_allclose(m_t.numpy(), m_j, rtol=0, err_msg=name,
                                       atol=MOMENT_REL * np.abs(m_j).max() + MOMENT_ATOL)
        diff = (got[name] - w).abs()
        mu = np.abs(moments_j[name][0])
        clear = torch.from_numpy(mu >= 0.25 * mu.max())
        assert float(diff.max()) <= 4.01 * lr, name
        assert float(diff[clear].max()) <= 2e-2 * lr, name
    assert sum(not torch.equal(got[n], before[n]) for n in want) > len(want) // 2


def _adam_moments(opt_state):
    """{port parameter name: (mu, nu)} of a JAX train state's Adam moments
    (the frozen leaves are masked out of it)."""
    flat = {"mu": {}, "nu": {}}
    for path, a in jax.tree_util.tree_leaves_with_path(opt_state):
        keys = [str(getattr(k, "key", getattr(k, "name", getattr(k, "idx", k)))) for k in path]
        for moment in flat:
            if moment in keys:
                flat[moment][tuple(keys[keys.index(moment) + 1:])] = np.asarray(a)
    trees = {}
    for moment, leaves in flat.items():
        tree = {}
        for keys, a in leaves.items():
            node = tree
            for k in keys[:-1]:
                node = node.setdefault(k, {})
            node[keys[-1]] = a
        trees[moment] = {k: v.numpy() for k, v in from_jax_params(tree).items()}
    return {n: (trees["mu"][n], trees["nu"][n]) for n in trees["mu"]}


def _s2g():
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return Config.fromfile(os.path.join(repo, "configs", "tests", "tiny_s2g.py")).model


@pytest.mark.parametrize("family", sorted(FAMILIES) + ["s2g_controlnet"])
def test_every_family_trains_in_bf16(family):
    if family == "s2g_controlnet":
        cfg = _s2g()
        batch = make_train_batch(2, seed=3, max_seq_len=16)
        batch["c"] = speech_audio(4, 2, 16)
    else:
        make_cfg, feats, kind = FAMILIES[family]
        cfg, batch = make_cfg(), family_batch(feats, kind)
    arch = build_torch(cfg, device="cpu")
    arch.model.load_state_dict(fabricate_state_dict(arch.model, seed=1), strict=True)
    before = {k: v.clone() for k, v in arch.model.state_dict().items()}
    state = TrainState(arch.model, {"type": "Adam", "lr": 1e-3},
                       frozen_prefixes=("clip/", "text_enc/clip"))
    arch.train()
    try:
        logs = make_train_step(arch, state, fp16=FP16)(batch, torch.Generator().manual_seed(0))
    finally:
        arch.eval()
    assert np.isfinite(float(logs["loss"]))
    after = arch.model.state_dict()
    assert all(v.dtype == before[k].dtype for k, v in after.items())
    moved = [n for n, p in arch.model.named_parameters()
             if p.requires_grad and not torch.equal(after[n], before[n])]
    assert len(moved) > len(state.params) // 2
