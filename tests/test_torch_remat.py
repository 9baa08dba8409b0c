"""Activation remat (the ``remat`` model option) of the port, on the CPU.

- The tiny T2M config with gate noise on (1.0, the flagship's), one
  training step through ``make_train_step`` in f32 and in bf16: ``remat``
  on gives the loss, every gradient and the step generator's state after
  the step of ``remat`` off, bit for bit.  The recompute in the backward
  pass replays the gate noise that the layer drew from the generator and
  adds no aux loss; each layer runs twice with it on, once with it off.
- The same config and weights against the JAX package's ``remat=True``
  (``nn.remat`` over each decoder layer), the JAX run's gate noise replaced
  by given arrays and the port handed the same ones (keyed by the
  generator's state, so that the recompute is handed the draw the forward
  got), the JAX run's t, noise and cond_type handed to the port: the loss
  terms to 1e-5 and every gradient to 1e-4 of max(1, max |JAX|), the f32
  tolerances of tests/test_torch_train.py.
- A ControlNet's base blocks remat with its base's ``remat``, bit for bit.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import motioncraft_tpu.models  # noqa: F401  (registers the flax classes)
from motioncraft_tpu.apis.factory import make_text_batch, tiny_t2m_cfg
from motioncraft_tpu.registry import build_architecture as build_jax
from motioncraft_tpu_torch.apis import make_train_batch
from motioncraft_tpu_torch.models import moe
from motioncraft_tpu_torch.registry import build_architecture as build_torch
from motioncraft_tpu_torch.utils.convert import fabricate_state_dict, from_jax_params
from test_torch_controlnet_train import speech_audio
from test_torch_train import jax_draws
from torch_port_util import assert_close_scaled, grad_mode_on, seeded_params  # noqa: F401
from torch_port_util import train_step_grads

REL = 1e-5
GRAD_REL = 1e-4


def _cfg(remat):
    cfg = tiny_t2m_cfg()
    cfg["model"]["remat"] = remat
    assert cfg["model"]["ca_block_cfg"]["gate_noise"] == 1.0
    return cfg


@pytest.mark.parametrize("fp16", [None, dict(dtype="bfloat16")], ids=["f32", "bf16"])
def test_remat_is_bit_for_bit(fp16):
    batch = make_train_batch(3, seed=4, max_seq_len=16)
    sd = None
    out = {}
    for remat in (False, True):
        arch = build_torch(_cfg(remat), device="cpu")
        sd = sd or fabricate_state_dict(arch.model, seed=2)
        arch.model.load_state_dict(sd, strict=True)
        runs = []
        arch.model.block_0.register_forward_pre_hook(lambda *_: runs.append(1))
        g = torch.Generator().manual_seed(9)
        logs, grads = train_step_grads(arch, batch, g, fp16)
        out[remat] = logs, grads, g.get_state(), len(runs)
    (logs0, grads0, g0, runs0), (logs1, grads1, g1, runs1) = out[False], out[True]
    assert (runs0, runs1) == (1, 2)  # the layer recomputed in the backward pass
    assert torch.equal(g0, g1)  # the recompute left the generator where it was
    for key in ("loss", "recon_loss", "moe_route_loss"):
        assert torch.equal(logs0[key], logs1[key]), key
    assert float(logs0["moe_route_loss"]) > 0
    assert grads0.keys() == grads1.keys() and grads0
    for name in grads0:
        assert torch.equal(grads0[name], grads1[name]), name


def test_remat_matches_jax_remat():
    cfg = _cfg(True)
    arch_j = build_jax(cfg)
    rng = np.random.RandomState(5)
    batch = make_text_batch(["a person walks forward", "someone waves hello"],
                            max_seq_len=16, motion=rng.randn(2, 16, 322).astype(np.float32),
                            lengths=np.array([[16], [11]], np.int32))
    variables = arch_j.init(jax.random.PRNGKey(0), batch)
    params = seeded_params(jax.tree_util.tree_map(np.asarray, variables["params"]), 1)
    # each layer's text MoE (B x 77 tokens) then its motion MoE (B x T x H)
    E, H = cfg["model"]["ca_block_cfg"]["num_experts"], cfg["model"]["ca_block_cfg"]["num_heads"]
    shapes = [(2 * 77, E), (2 * 16 * H, E)] * cfg["model"]["num_layers"]
    noise_rng = np.random.RandomState(7)
    noise = [noise_rng.randn(*s).astype(np.float32) for s in shapes]
    key = jax.random.PRNGKey(11)
    draws = jax_draws(arch_j, batch, key)

    pending, real = list(noise), jax.random.normal

    def fed(k, shape, dtype=jnp.float32):
        if pending and tuple(shape) == pending[0].shape:
            return jnp.asarray(pending.pop(0), dtype)
        return real(k, shape, dtype)

    jax.random.normal = fed
    try:
        (_, logs_j), grads_j = jax.jit(jax.value_and_grad(
            lambda p: arch_j.loss({"params": p}, batch, key), has_aux=True))(
                jax.tree_util.tree_map(jnp.asarray, params))
    finally:
        jax.random.normal = real
    assert not pending

    handed, draw = {}, moe.draw_gate_noise

    def replay(logits, generator):
        """The next given array for each new generator state; the same
        array again for a state it was drawn at (the recompute)."""
        state = bytes(generator.get_state().numpy())
        if state not in handed:
            handed[state] = torch.from_numpy(noise[len(handed)])
        draw(logits, generator)  # move the generator on as a draw does
        return handed[state]

    arch_t = build_torch(cfg, device="cpu")
    arch_t.model.load_state_dict(from_jax_params(params), strict=True)
    moe.draw_gate_noise = replay
    try:
        logs_t, grads_t = train_step_grads(arch_t, batch, torch.Generator().manual_seed(0), **draws)
    finally:
        moe.draw_gate_noise = draw
    assert len(handed) == len(noise)
    for k in ("loss", "recon_loss", "moe_route_loss"):
        assert_close_scaled(logs_t[k].numpy(), logs_j[k], REL, k)
    want = {k: a.numpy() for k, a in from_jax_params(jax.device_get(grads_j)).items()
            if not k.startswith("text_enc.clip.")}
    assert set(grads_t) == set(want)
    for name in sorted(want):
        assert_close_scaled(grads_t[name].numpy(), want[name], GRAD_REL, name)


def test_controlnet_base_blocks_remat():
    """The S2G tiny ControlNet: its base's remat checkpoints the base
    blocks of the training forward; loss and gradients bit for bit."""
    from motioncraft_tpu_torch.config import Config

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    base_cfg = Config.fromfile(os.path.join(repo, "configs", "tests", "tiny_s2g.py")).model
    out = {}
    for remat in (False, True):
        cfg = copy.deepcopy(dict(base_cfg))
        cfg["model"] = copy.deepcopy(dict(cfg["model"]))
        cfg["model"]["base_model"] = dict(cfg["model"]["base_model"], remat=remat)
        arch = build_torch(cfg, device="cpu")
        arch.model.load_state_dict(fabricate_state_dict(arch.model, seed=3), strict=True)
        runs = []
        arch.model.base_model.block_0.register_forward_pre_hook(lambda *_: runs.append(1))
        T = cfg["model"]["base_model"]["max_seq_len"]
        batch = make_train_batch(2, seed=5, max_seq_len=T)
        batch["c"] = speech_audio(6, 2, T)  # onset + amplitude, [2, T x 533, 2]
        out[remat] = train_step_grads(arch, batch, torch.Generator().manual_seed(1)), len(runs)
    ((logs0, grads0), runs0), ((logs1, grads1), runs1) = out[False], out[True]
    assert (runs0, runs1) == (1, 2)
    assert torch.equal(logs0["loss"], logs1["loss"])
    assert grads0.keys() == grads1.keys() and grads0
    for name in grads0:
        assert torch.equal(grads0[name], grads1[name]), name
