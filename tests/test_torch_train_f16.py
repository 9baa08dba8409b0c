"""float16 training of the port against the JAX package's, on the CPU.

The JAX package trains in float16 through ``fp16=dict(dtype='float16',
loss_scale=...)``: every floating parameter cast to float16 inside the
differentiated function, the loss in f32 times ``loss_scale``, the
gradients divided by it (a static scale: no step is skipped).  The port's
``make_train_step(fp16=)`` does the same; its text tower and text MoEs run
in float16 (K6's f16 instantiation on the card), its motion path in f32 on
the rounded weights (float16 meeting f32 promotes to f32 in both).

- The tiny T2M config at gate noise 0, the gates pinned to JAX's logits as
  tests/test_torch_train_bf16.py pins them (its helpers, imported): the
  loss terms and every gradient at ``loss_scale`` 1, 8 and 2^16.  The loss
  terms within 1e-5 x max(1, |JAX|), as in f32 (the loss runs on the f32
  motion path); each gradient within 2e-4 x max(1, max |JAX|): both round
  it to f16 (the parameter's dtype in the step; ulp 2^-11 relative, 8x
  finer than bf16's, whose test holds 1e-3), and the f16 text path rounds
  its intermediates in other places (XLA fuses a chain of elementwise ops
  and rounds once, torch rounds each op).
- The text tower's leaves (``text_enc.text_pre_proj`` and
  ``text_enc.textTransEncoder_*``, TEXT_TOWER) underflow at loss scales 1
  and 8: their cotangents fall below f16's smallest subnormal (6e-8) in
  both frameworks, at other places, and their gradients part by up to 70%
  / 32% of each tensor's largest (measured).  That is what loss scaling is
  for: at 2^16 every gradient tensor agrees within 5e-3 of its own largest
  (plus 1e-9: the key biases under a softmax over the keys, whose
  gradient is zero up to rounding), and the test holds that.
- Two Adam steps at ``loss_scale=8.0``, ``grad_accum=2`` over a batch of 4:
  the port's own train step against JAX's composed from its parts, exactly
  as its ``make_train_step`` scan computes (microbatch i the rows [2i,
  2i + 2) with key ``split(rng)[i]``, the loss function's gradients
  divided by the scale and averaged, then ``TrainState.apply_gradients``),
  so that the loss function compiled for the gradient test serves every
  microbatch.  Both Adam moments within 1e-2 of their tensor's largest
  (plus 1e-9 for the tensors whose gradient is zero up to rounding), the
  text tower's within 0.5 (its underflow above; measured 0.43); each
  parameter whose first moment is at least a quarter of its tensor's
  largest within 5e-3 lr, but the text tower's; every parameter within
  4.01 lr, the most two Adam steps from one start can part (an element
  whose gradient sits in the rounding noise moves up to lr either way).
- Every other family trains in float16 too (the port alone): one float16
  Adam step of each tiny baseline config and of the tiny S2G ControlNet
  (its WavEncoder's convolutions and BatchNorm promote the f32 audio to
  f32): a finite loss, f32 masters, and more than half of the trainable
  parameters moved.  The S2G ControlNet's float16 loss terms are also held
  against the JAX package's float16 loss on the same weights, batch and
  draws (gates pinned), to 1e-5 x max(1, |JAX|).
"""

import re

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import motioncraft_tpu.models  # noqa: F401  (registers the flax classes)
from motioncraft_tpu.apis.factory import make_text_batch
from motioncraft_tpu.config import Config as JaxConfig
from motioncraft_tpu.parallel import create_train_state
from motioncraft_tpu.registry import build_architecture as build_jax
from motioncraft_tpu_torch.apis import make_train_batch, make_train_step
from motioncraft_tpu_torch.apis.train import cast_parameters, half_dtype
from motioncraft_tpu_torch.config import Config
from motioncraft_tpu_torch.parallel import TrainState
from motioncraft_tpu_torch.registry import build_architecture as build_torch
from motioncraft_tpu_torch.utils.convert import (fabricate_state_dict, from_jax_params,
                                                 from_jax_variables, to_jax_params,
                                                 to_jax_variables)
from test_torch_baseline_train import FAMILIES, family_batch
from test_torch_controlnet_train import (CONFIG as S2G_CONFIG, speech_audio,
                                         with_gate_noise_0)
from test_torch_train import jax_draws
from test_torch_train_bf16 import _adam_moments, _cfg, _pin_gates, _port, _recorder
from torch_port_util import (assert_close_scaled, grad_mode_on, seeded_params,  # noqa: F401
                             train_step_grads)

F16 = jnp.float16
REL = 1e-5
GRAD_REL = 2e-4
SCALED, SCALED_REL, ZERO_ATOL = 2.0 ** 16, 5e-3, 1e-9
MOMENT_REL, TOWER_MOMENT_REL = 1e-2, 0.5
PARAM_REL = 5e-3
FP16 = dict(dtype="float16")
TEXT_TOWER = re.compile(r"text_enc\.(text_pre_proj|textTransEncoder_\d+)\.")


def test_half_dtype_names():
    assert half_dtype({"dtype": "float16"}) == torch.float16
    assert half_dtype({}) == half_dtype({"dtype": "torch.bfloat16"}) == torch.bfloat16
    with pytest.raises(ValueError, match="'float32'"):
        half_dtype({"dtype": "float32"})


@pytest.fixture(scope="module")
def pair():
    """tests/test_torch_train_bf16.py's pair, the same arrays: the seeded
    values depend only on the flax tree's shapes, taken here from the
    port's model (its eager flax init costs seconds)."""
    rng = np.random.RandomState(5)
    batch = make_text_batch(["a person walks forward", "someone waves hello"],
                            max_seq_len=16, motion=rng.randn(2, 16, 322).astype(np.float32),
                            lengths=np.array([[16], [11]], np.int32))
    shapes = to_jax_params(build_torch(_cfg(), device="cpu").model.state_dict())
    return build_jax(_cfg()), seeded_params(shapes, 1), batch


@pytest.fixture(scope="module")
def jax_f16_grads(pair):
    """(batch, rng, loss_scale, params=the pair's) -> (logs, gradients, gate
    logits) of the JAX package's float16 step on a batch of the pair's
    shapes, ``make_train_step(fp16=...)``'s loss function (parameters,
    batch, key and scale traced: one compile)."""
    arch_j, params, _ = pair
    logits = {}

    def loss_fn(p, batch, rng, loss_scale):
        p = jax.tree_util.tree_map(lambda a: a.astype(F16), p)
        with fnn.intercept_methods(_recorder(logits)):
            loss, logs = arch_j.loss({"params": p}, batch, rng)
        return jnp.asarray(loss, jnp.float32) * loss_scale, logs

    grad_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    start = jax.tree_util.tree_map(jnp.asarray, params)

    def run(batch, rng, loss_scale, p=start):
        logits.clear()
        (_, logs), grads = grad_fn(p, batch, rng, jnp.float32(loss_scale))
        grads = jax.tree_util.tree_map(lambda g: np.asarray(g) / np.float32(loss_scale), grads)
        return logs, grads, dict(logits)

    return run


@pytest.mark.parametrize("loss_scale", [1.0, 8.0, SCALED])
def test_f16_loss_and_gradients(pair, jax_f16_grads, loss_scale):
    arch_j, params, batch = pair
    rng = jax.random.PRNGKey(11)
    logs_j, grads_j, logits = jax_f16_grads(batch, rng, loss_scale)
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
    assert set(got) == set(want) and any(TEXT_TOWER.match(n) for n in want)
    for name in sorted(want):
        assert got[name].dtype == torch.float32 and torch.isfinite(got[name]).all(), name
        # the f32 master takes the f16 gradient widened, then divided by
        # the scale: times the scale, f16 values
        scaled = got[name] * loss_scale
        assert torch.equal(scaled, scaled.half().float()), name
        assert_close_scaled(got[name].numpy(), want[name], GRAD_REL, name)
        if loss_scale == SCALED:  # no underflow: each tensor to its own largest
            np.testing.assert_allclose(got[name].numpy(), want[name], rtol=0, err_msg=name,
                                       atol=SCALED_REL * np.abs(want[name]).max() + ZERO_ATOL)


def test_two_adam_steps_f16_loss_scale_grad_accum(pair, jax_f16_grads):
    arch_j, params, first = pair
    lr, fp16, accum = 1e-3, dict(FP16, loss_scale=8.0), 2
    rng = np.random.RandomState(6)
    second = make_text_batch(["a person jumps in place", "someone sits down slowly"],
                             max_seq_len=16, motion=rng.randn(2, 16, 322).astype(np.float32),
                             lengths=np.array([[13], [16]], np.int32))
    batch = {k: np.concatenate([first[k], second[k]]) for k in first}
    micro = (first, second)
    state_j = create_train_state(jax.tree_util.tree_map(jnp.asarray, params),
                                 {"type": "Adam", "lr": lr})
    apply_j = jax.jit(lambda state, grads: state.apply_gradients(grads))
    arch_t = _port(params)
    state_t = TrainState(arch_t.model, {"type": "Adam", "lr": lr})
    step_t = make_train_step(arch_t, state_t, fp16=fp16, grad_accum=accum)
    arch_t.train()
    try:
        for seed in (21, 22):
            keys = jax.random.split(jax.random.PRNGKey(seed), accum)
            runs = [jax_f16_grads(mb, key, fp16["loss_scale"], state_j.params)
                    for mb, key in zip(micro, keys)]
            grads = jax.tree_util.tree_map(lambda *g: sum(g) / np.float32(accum),
                                           *(r[1] for r in runs))
            state_j = apply_j(state_j, grads)
            loss_j = np.mean([float(r[0]["loss"]) for r in runs])
            logits = {k: sum((r[2][k] for r in runs), []) for k in runs[0][2]}
            draws = [jax_draws(arch_j, mb, key) for mb, key in zip(micro, keys)]
            handles, calls = _pin_gates(arch_t.model, logits)
            try:
                logs_t = step_t(batch, **{k: np.concatenate([d[k] for d in draws])
                                          for k in draws[0]})
            finally:
                for h in handles:
                    h.remove()
            assert calls == {k: accum for k in logits} and len(calls) == 4
            assert_close_scaled(logs_t["loss"].numpy(), loss_j, REL, "loss")
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
        tower = TEXT_TOWER.match(name) is not None
        for m_t, m_j in zip(moments_t[name], moments_j[name]):
            rel = TOWER_MOMENT_REL if tower else MOMENT_REL
            np.testing.assert_allclose(m_t.numpy(), m_j, rtol=0, err_msg=name,
                                       atol=rel * np.abs(m_j).max() + ZERO_ATOL)
        diff = (got[name] - w).abs()
        mu = np.abs(moments_j[name][0])
        clear = torch.from_numpy(mu >= 0.25 * mu.max())
        assert float(diff.max()) <= 4.01 * lr, name
        assert tower or float(diff[clear].max()) <= PARAM_REL * lr, name
    assert sum(not torch.equal(got[n], before[n]) for n in want) > len(want) // 2


@pytest.fixture(scope="module")
def s2g_f16_loss():
    """(seeded variables, batch, key, draws, the JAX package's float16 loss
    logs at that key, its gate logits) on configs/tests/tiny_s2g.py."""
    arch_j = build_jax(with_gate_noise_0(JaxConfig.fromfile(S2G_CONFIG).model))
    batch = make_train_batch(2, seed=3, max_seq_len=16)
    batch["c"] = speech_audio(4, 2, 16)
    model = build_torch(Config.fromfile(S2G_CONFIG).model, device="cpu").model
    variables = to_jax_variables(fabricate_state_dict(model, seed=1))
    key = jax.random.PRNGKey(7)
    logits = {}

    def loss(params, stats):
        params = jax.tree_util.tree_map(lambda a: a.astype(F16), params)
        with fnn.intercept_methods(_recorder(logits)):
            return arch_j.loss({"params": params, "batch_stats": stats}, batch, key)[1]

    logs = jax.jit(loss)(*(jax.tree_util.tree_map(jnp.asarray, variables[k])
                           for k in ("params", "batch_stats")))
    return variables, batch, jax_draws(arch_j, batch, key), logs, dict(logits)


@pytest.mark.parametrize("family", sorted(FAMILIES) + ["s2g_controlnet"])
def test_every_family_trains_in_f16(family, request):
    if family == "s2g_controlnet":
        cfg = with_gate_noise_0(Config.fromfile(S2G_CONFIG).model)
        variables, batch, draws, logs_j, logits = request.getfixturevalue("s2g_f16_loss")
        arch = build_torch(cfg, device="cpu")
        arch.model.load_state_dict(from_jax_variables(variables), strict=True)
        # the float16 loss terms against the JAX package's on the same draws
        handles, calls = _pin_gates(arch.model, logits)
        arch.train()
        try:
            with torch.no_grad(), cast_parameters(arch.model, torch.float16):
                _, logs_t = arch.loss(batch, **draws)
        finally:
            arch.eval()
            for h in handles:
                h.remove()
        arch.model.load_state_dict(from_jax_variables(variables), strict=True)
        assert calls and set(calls.values()) == {1}
        for key in ("loss", "recon_loss", "moe_route_loss"):
            assert_close_scaled(logs_t[key].numpy(), logs_j[key], REL, key)
    else:
        make_cfg, feats, kind = FAMILIES[family]
        cfg, batch = make_cfg(), family_batch(feats, kind)
        arch = build_torch(cfg, device="cpu")
        arch.model.load_state_dict(fabricate_state_dict(arch.model, seed=1), strict=True)
    before = {k: v.clone() for k, v in arch.model.state_dict().items()}
    state = TrainState(arch.model, {"type": "Adam", "lr": 1e-3},
                       frozen_prefixes=("clip/", "text_enc/clip", "base_model/text_enc/clip"))
    arch.train()
    try:
        logs = make_train_step(arch, state, fp16=dict(FP16, loss_scale=8.0))(
            batch, torch.Generator().manual_seed(0))
    finally:
        arch.eval()
    assert np.isfinite(float(logs["loss"]))
    after = arch.model.state_dict()
    assert all(v.dtype == before[k].dtype for k, v in after.items())
    moved = [n for n, p in arch.model.named_parameters()
             if p.requires_grad and not torch.equal(after[n], before[n])]
    assert len(moved) > len(state.params) // 2
