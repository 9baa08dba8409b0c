"""ControlNet training of the port against the JAX package on the CPU, on the
tiny S2G config (configs/tests/tiny_s2g.py: a 2-layer STMoGen base, one
control block, a WavEncoder of width 16 over onset + amplitude at 16 kHz)
at gate noise 0, on seeded flax params and BatchNorm statistics carried
over by ``from_jax_variables``; the JAX batches carry ``c``, as its speech
and music datasets give them (without it the JAX init builds no control
branch):

- the WavEncoder's training output and the running statistics it moves to,
  against flax's returned ``batch_stats``;
- the training forward's output and aux loss, then ``MotionDiffusion.loss``
  and every trainable parameter's gradient, on JAX's draws of t, noise and
  cond_type, with rows of both kinds of ``cond_type % 10`` (the condition
  zeroed where the text is off);
- ``init_control_blocks_from_base`` against JAX's on the params tree;
- ``controlnet_frozen_prefixes`` for every freezing setting: the port's
  trainable parameters are the JAX mask's True leaves;
- two Adam steps (the gradient clip on) against JAX's optimizer with the
  frozen leaves' updates zeroed here, in the test;
- the two departures: JAX's ``create_train_state`` moves a frozen base
  leaf by its raw gradient, the port leaves it bit for bit; JAX's train
  step keeps the WavEncoder's statistics, the port stores the ones flax
  returns.

Tolerances, as tests/test_torch_train.py: outputs and the loss 1e-5 of
max(1, max |JAX|), gradients 1e-4; after two Adam steps 2e-2 x lr but for
0.1% of the elements, 2 x lr for all; a convolution bias that feeds a
BatchNorm in training has a gradient of exactly 0 (the batch mean takes it
out), so both sides see rounding there and Adam moves it by up to lr a
step, either way: those are held to moving at most 2.01 x lr on each side.
The WavEncoder alone in training
5e-5: six BatchNorms on batch statistics each divide by the batch's
standard deviation, which scales up the rounding of what they normalise;
on its test input the port's f32 output is 1.1e-5 and flax's 2.7e-5 of
scale from a float64 evaluation of the same weights.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import unfreeze

import motioncraft_tpu.models  # noqa: F401  (registers the flax classes)
from motioncraft_tpu.apis.factory import make_text_batch
from motioncraft_tpu.apis.train import make_train_step as jax_make_train_step
from motioncraft_tpu.config import Config as JaxConfig
from motioncraft_tpu.models import controlnet as jax_cn
from motioncraft_tpu.models.blocks import WavEncoder as JaxWavEncoder
from motioncraft_tpu.parallel import create_train_state
from motioncraft_tpu.parallel.train_state import build_optimizer as jax_build_optimizer
from motioncraft_tpu.parallel.train_state import path_freeze_mask
from motioncraft_tpu.registry import build_architecture as build_jax
from motioncraft_tpu_torch.apis import make_train_step
from motioncraft_tpu_torch.config import Config
from motioncraft_tpu_torch.models import controlnet
from motioncraft_tpu_torch.models.blocks import WavEncoder
from motioncraft_tpu_torch.parallel import TrainState, freeze
from motioncraft_tpu_torch.registry import build_architecture as build_torch
from motioncraft_tpu_torch.utils.convert import (from_jax_params, from_jax_variables,
                                                 to_jax_params)
from test_torch_train import assert_grads_close, jax_draws
from torch_port_util import (assert_close_scaled, grad_mode_on, seeded_batch_stats,  # noqa: F401
                             seeded_params, t)

REL, GRAD_REL, REL_BN = 1e-5, 1e-4, 5e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "tests", "tiny_s2g.py")
T, SPF, B = 16, 16000 // 30, 4
CLIP = ("base_model/text_enc/clip",)
# the first key whose cond_type draws turn the text (and so the condition)
# off in some rows and on in others, found below
RNG_SEEDS = range(100, 200)
# the WavEncoder's convolution biases that a BatchNorm follows
BN_FED_BIAS = re.compile(r"condition_pre_encoder\.block\d\.(conv1|conv2|down_conv)\.bias")


def speech_audio(seed, batch, frames=T):
    """Onset + amplitude features of seeded speech-like audio, [batch,
    frames x SPF, 2]."""
    rng = np.random.RandomState(seed)
    amp = np.abs(rng.randn(batch, frames * SPF) * 0.3)
    onset = (rng.rand(batch, frames * SPF) < 2e-3).astype(np.float64)
    return np.stack([amp, onset], axis=-1).astype(np.float32)


def with_gate_noise_0(model_cfg):
    model_cfg["model"]["base_model"]["ca_block_cfg"]["gate_noise"] = 0.0
    return model_cfg


@pytest.fixture(scope="module")
def pair():
    """(JAX arch, seeded variables, port arch, batch with c, the jitted JAX
    value-and-grad of the loss over params at a key)."""
    arch_j = build_jax(with_gate_noise_0(JaxConfig.fromfile(CONFIG).model))
    rng = np.random.RandomState(5)
    batch = make_text_batch(["a person is doing a speech, and the speech content is so",
                             "someone talks", "a speech about gestures", "hello world"],
                            max_seq_len=T, motion=rng.randn(B, T, 322).astype(np.float32),
                            lengths=np.array([[16], [11], [16], [7]], np.int32))
    batch["c"] = speech_audio(6, B)
    init = jax.tree_util.tree_map(np.asarray, unfreeze(arch_j.init(jax.random.PRNGKey(0),
                                                                   batch)))
    variables = {"params": seeded_params(init["params"], 1),
                 "batch_stats": seeded_batch_stats(init["batch_stats"], 2)}
    arch_t = build_torch(with_gate_noise_0(Config.fromfile(CONFIG).model), device="cpu")
    arch_t.model.load_state_dict(from_jax_variables(variables), strict=True)
    stats = jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"])
    grad_fn = jax.jit(jax.value_and_grad(
        lambda p, key: arch_j.loss({"params": p, "batch_stats": stats}, batch, key),
        has_aux=True))
    return arch_j, variables, arch_t, batch, grad_fn


def mixed_key(arch_j, batch):
    """A key whose cond_type draws have the text off in some rows (the
    condition zeroed there) and on in others."""
    for seed in RNG_SEEDS:
        key = jax.random.PRNGKey(seed)
        off = jax_draws(arch_j, batch, key)["cond_type"].reshape(-1) % 10 == 0
        if off.any() and not off.all():
            return key
    raise AssertionError("no key in RNG_SEEDS mixes the two kinds of rows")


def trainable_paths(tree_or_mask, mask=None):
    """The '/'-joined paths of a flax tree's leaves (with ``mask``, those
    whose mask leaf is True)."""
    src = tree_or_mask if mask is None else mask
    return {"/".join(str(p.key) for p in path)
            for path, leaf in jax.tree_util.tree_leaves_with_path(src)
            if mask is None or bool(leaf)}


# ------------------------------------------------------------ WavEncoder
def test_wav_encoder_training_and_statistics():
    x = speech_audio(3, 3, frames=24)
    flax_enc = JaxWavEncoder(out_dim=16, audio_in=2)
    init = unfreeze(flax_enc.init(jax.random.PRNGKey(0), x[:, :SPF * 8]))
    variables = {"params": seeded_params(jax.tree_util.tree_map(np.asarray, init["params"]), 3),
                 "batch_stats": seeded_batch_stats(
                     jax.tree_util.tree_map(np.asarray, init["batch_stats"]), 4)}
    want, moved = jax.jit(lambda v: flax_enc.apply(v, x, train=True,
                                                   mutable=["batch_stats"]))(variables)
    enc = WavEncoder(16, audio_in=2)
    enc.load_state_dict(from_jax_variables(variables), strict=True)
    enc.train()
    got = enc(t(x))
    assert np.abs(np.asarray(want)).max() > 1e-2
    assert_close_scaled(got.detach().numpy(), want, REL_BN, "WavEncoder in training")
    want_sd = from_jax_variables({"params": variables["params"], **jax.device_get(moved)})
    stats = [k for k in want_sd if k.endswith(("running_mean", "running_var"))]
    assert len(stats) == 32
    for k in stats:
        before = from_jax_variables(variables)[k]
        assert not torch.equal(want_sd[k], before), f"flax did not move {k}"
        assert_close_scaled(enc.state_dict()[k].numpy(), want_sd[k].numpy(), REL, k)
    enc.eval()  # eval mode: the running statistics, nothing moves
    before = {k: v.clone() for k, v in enc.state_dict().items()}
    enc(t(x))
    assert all(torch.equal(v, enc.state_dict()[k]) for k, v in before.items())


# ------------------------------------------------------------ the model
def test_train_forward(pair):
    """The denoiser's training forward alone: output and aux loss."""
    arch_j, variables, arch_t, batch, _ = pair
    rng = np.random.RandomState(7)
    x = rng.randn(B, T, 322).astype(np.float32)
    ts = np.array([3, 500, 999, 120], np.int32)
    cond_type = np.array([45, 0, 90, 7], np.int32).reshape(B, 1, 1)
    model = arch_j.model

    def apply(v):
        xf = model.apply(v, batch["text_ids"], method="encode_text", train=True)
        return model.apply(v, x, ts, motion_mask=batch["motion_mask"],
                           motion_length=batch["motion_length"], xf_out=xf,
                           cond_type=cond_type, c=batch["c"], mode="train", train=True,
                           rngs={"gate_noise": jax.random.PRNGKey(0)},
                           mutable=["losses", "batch_stats"])

    want, state = jax.jit(apply)(variables)
    # each STMA sows its MoEs' sum as aux_loss, which the JAX loss reads
    aux_j = sum(leaf for path, leaf in jax.tree_util.tree_leaves_with_path(state["losses"])
                if "aux_loss" in jax.tree_util.keystr(path))
    m = arch_t.model
    m.train()
    try:
        aux = []
        with torch.no_grad():
            xf = m.encode_text(t(batch["text_ids"], torch.long))
            got = m(t(x), t(ts, torch.long), motion_mask=t(batch["motion_mask"]), xf_out=xf,
                    mode="train", cond_type=t(cond_type, torch.long), c=t(batch["c"]),
                    aux_losses=aux)
    finally:
        m.load_state_dict(from_jax_variables(variables), strict=True)  # the statistics back
        m.eval()
    assert len(aux) == 2 * 3  # the text and motion MoE of 2 base blocks + 1 control block
    assert np.abs(np.asarray(want)).max() > 1e-3
    assert_close_scaled(got.numpy(), want, REL, "training forward")
    assert_close_scaled(sum(aux).numpy(), aux_j, REL, "aux losses")


def test_loss_and_gradients(pair):
    arch_j, variables, arch_t, batch, grad_fn = pair
    key = mixed_key(arch_j, batch)
    (_, logs_j), grads_j = grad_fn(jax.tree_util.tree_map(jnp.asarray, variables["params"]),
                                   key)
    draws = jax_draws(arch_j, batch, key)
    frozen = path_freeze_mask(variables["params"], CLIP)
    m = arch_t.model
    m.zero_grad()
    arch_t.train()
    try:
        total, logs_t = arch_t.loss(batch, **draws)
        total.backward()
    finally:
        arch_t.eval()
        m.load_state_dict(from_jax_variables(variables), strict=True)
    for k in ("loss", "recon_loss", "moe_route_loss", "recon_loss_batch", "t_mean"):
        assert_close_scaled(logs_t[k].detach().numpy(), logs_j[k], REL, k)
    want = {k: a.numpy() for k, a in from_jax_params(jax.device_get(grads_j)).items()}
    clip = {k for k in from_jax_params(variables["params"]) if k.startswith(
        "base_model.text_enc.clip.")}
    assert clip and trainable_paths(variables["params"], frozen)
    for name in clip:
        assert not np.any(want.pop(name)), name
        assert m.get_parameter(name).grad is None
    got = {k: p.grad.numpy() for k, p in m.named_parameters() if p.grad is not None}
    # the control branch learns: its zero-initialised projections get a gradient
    assert np.abs(got["controlnet_0.after_proj.linear.weight"]).max() > 0
    assert np.abs(got["control_cond_input.linear.weight"]).max() > 0
    assert_grads_close(got, want, GRAD_REL)
    m.zero_grad()


def test_init_control_blocks_from_base(pair):
    _, variables, arch_t, _, _ = pair
    params = variables["params"]
    want = from_jax_params(jax_cn.init_control_blocks_from_base(params, 1))
    got = controlnet.init_control_blocks_from_base(from_jax_params(params), 1)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    copied = [k for k in got if k.startswith("controlnet_0.copied_block.")]
    assert copied and all(
        torch.equal(got[k], got[k.replace("controlnet_0.copied_block.", "base_model.block_0.")])
        for k in copied)
    assert not all(torch.equal(got[k], from_jax_params(params)[k]) for k in copied)
    with pytest.raises(KeyError):
        controlnet.init_control_blocks_from_base(from_jax_params(params), 2)


@pytest.mark.parametrize("joint_embed_unfreeze,unfreeze_mode", [
    (False, "all"), (True, "all"), (True, "root"), (True, "root_face"), (True, "root_hand"),
    (True, "root_face_hand")])
def test_frozen_prefixes(pair, joint_embed_unfreeze, unfreeze_mode):
    """The port's trainable parameters under each freezing setting are the
    JAX optimizer mask's True leaves."""
    _, variables, _, _, _ = pair
    want_prefixes = jax_cn.controlnet_frozen_prefixes(joint_embed_unfreeze, unfreeze_mode)
    prefixes = controlnet.controlnet_frozen_prefixes(joint_embed_unfreeze, unfreeze_mode)
    assert prefixes == want_prefixes
    mask = path_freeze_mask(variables["params"], tuple(prefixes) + CLIP)
    model_cfg = Config.fromfile(CONFIG).model
    model_cfg["model"].update(joint_embed_unfreeze=joint_embed_unfreeze,
                              unfreeze_mode=unfreeze_mode)
    model = build_torch(model_cfg, device="cpu").model
    trainable = dict(freeze(model, tuple(prefixes) + CLIP))
    got = trainable_paths(to_jax_params(trainable))
    assert got == trainable_paths(variables["params"], mask)
    names = set(trainable)
    assert not any(n.startswith(("base_model.block_", "base_model.text_enc.",
                                 "base_model.time_embed.", "base_model.sequence_embedding"))
                   for n in names)
    heads = {n.split(".")[2] for n in names if n.startswith(("base_model.joint_embed.",
                                                             "base_model.out."))}
    if not joint_embed_unfreeze:
        assert not heads
    else:
        keep = (set(jax_cn._ALL_PARTS) if unfreeze_mode == "all"
                else jax_cn.UNFREEZE_MODE_PARTS[unfreeze_mode])
        assert heads == {f"{p}_{s}" for p in keep for s in ("embed", "out")}
    assert any(n.startswith("controlnet_0.copied_block.") for n in names)
    assert "condition_pre_encoder.block0.bn1.weight" in names


def _prefixes():
    return tuple(controlnet.controlnet_frozen_prefixes(True, "root_face_hand")) + CLIP


def test_two_adam_steps_frozen_updates_zeroed(pair):
    """Two Adam steps with the gradient clip on: JAX's optimizer (its clip's
    norm over the trainable leaves, inside optax.masked) with the frozen
    leaves' updates zeroed here, against the port's TrainState."""
    arch_j, variables, arch_t, batch, grad_fn = pair
    lr, clip = 1e-3, dict(max_norm=0.5)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    mask = path_freeze_mask(variables["params"], _prefixes())
    tx = jax_build_optimizer({"type": "Adam", "lr": lr}, None, clip, _prefixes(), params)
    opt_state = tx.init(params)

    @jax.jit
    def update(grads, opt_state, params):
        updates, opt_state = tx.update(grads, opt_state, params)
        updates = jax.tree_util.tree_map(lambda u, keep: u if keep else jnp.zeros_like(u),
                                         updates, mask)
        return jax.tree_util.tree_map(lambda p, u: p + u, params, updates), opt_state

    port = build_torch(with_gate_noise_0(Config.fromfile(CONFIG).model), device="cpu")
    port.model.load_state_dict(from_jax_variables(variables), strict=True)
    state = TrainState(port.model, {"type": "Adam", "lr": lr}, grad_clip=clip,
                       frozen_prefixes=_prefixes())
    step = make_train_step(port, state)
    norms = []
    port.train()
    try:
        for seed in (31, 32):
            key = jax.random.PRNGKey(seed)
            _, grads = grad_fn(params, key)
            norms.append(float(jnp.sqrt(sum(jnp.sum(g ** 2) for g, keep in zip(
                jax.tree_util.tree_leaves(grads), jax.tree_util.tree_leaves(mask)) if keep))))
            params, opt_state = update(grads, opt_state, params)
            step(batch, **jax_draws(arch_j, batch, key))
    finally:
        port.eval()
    assert min(norms) > clip["max_norm"], norms  # the clip acted in both steps
    before = from_jax_params(variables["params"])
    want = from_jax_params(jax.device_get(params))
    got = port.model.state_dict()
    trainable = {n for n, p in port.model.named_parameters() if p.requires_grad}
    for name, w in want.items():
        if name not in trainable:
            assert torch.equal(got[name], before[name]) and torch.equal(w, before[name]), name
            continue
        if BN_FED_BIAS.fullmatch(name):
            for side in (got[name], w):
                assert float((side - before[name]).abs().max()) <= 2.01 * lr, name
            continue
        diff = (got[name] - w).abs()
        assert float(diff.max()) <= 2 * lr, name
        assert int((diff > 2e-2 * lr).sum()) <= max(1, diff.numel() // 1000), name
    assert sum(bool(BN_FED_BIAS.fullmatch(n)) for n in trainable) == 16
    # what stays (the face head under face_no_loss, the copied block's body
    # attention query, whose output the training forward does not read)
    # stays on both sides
    still = {n for n in trainable if torch.equal(got[n], before[n])}
    assert still == {n for n in trainable if torch.equal(want[n], before[n])}
    assert len(still) < len(trainable) // 10, sorted(still)


def test_departure_frozen_means_frozen(pair):
    """JAX's create_train_state passes a frozen leaf's raw gradient through
    optax.masked and adds it: the frozen base moves.  The port's frozen
    leaves stay bit for bit (ROADMAP queue 3, departures)."""
    arch_j, variables, arch_t, batch, grad_fn = pair
    key = jax.random.PRNGKey(41)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    _, grads = grad_fn(params, key)
    st = create_train_state(params, {"type": "Adam", "lr": 2e-4}, None, None, _prefixes())
    st = jax.jit(lambda state, g: state.apply_gradients(g))(st, grads)
    old = variables["params"]["base_model"]["block_0"]["ffn"]["w1"]
    new = np.asarray(st.params["base_model"]["block_0"]["ffn"]["w1"])
    g = np.asarray(grads["base_model"]["block_0"]["ffn"]["w1"])
    assert np.abs(g).max() > 1e-3
    np.testing.assert_allclose(new - old, g, rtol=1e-5, atol=1e-6)  # moved by its gradient

    port = build_torch(with_gate_noise_0(Config.fromfile(CONFIG).model), device="cpu")
    port.model.load_state_dict(from_jax_variables(variables), strict=True)
    state = TrainState(port.model, {"type": "Adam", "lr": 2e-4}, frozen_prefixes=_prefixes())
    port.train()
    try:
        make_train_step(port, state)(batch, **jax_draws(arch_j, batch, key))
    finally:
        port.eval()
    after = port.model.state_dict()
    before = from_jax_variables(variables)
    frozen = [n for n, p in port.model.named_parameters() if not p.requires_grad]
    assert "base_model.block_0.ffn.w1" in frozen
    assert all(torch.equal(after[n], before[n]) for n in frozen)
    assert all(p not in state.optimizer.state for p in port.model.parameters()
               if not p.requires_grad)


def test_departure_wav_encoder_statistics_kept(pair):
    """JAX's train step drops the batch_stats its apply returns: the state
    keeps the initial statistics.  The port's loss leaves the WavEncoder's
    running statistics where flax's returned batch_stats are (ROADMAP
    queue 3, departures)."""
    arch_j, variables, arch_t, batch, _ = pair
    key = jax.random.PRNGKey(51)
    st = create_train_state(jax.tree_util.tree_map(jnp.asarray, variables["params"]),
                            {"type": "SGD", "lr": 0.0, "momentum": 0.0}, None, None, CLIP,
                            extra_variables={"batch_stats": variables["batch_stats"]})
    st, _ = jax.jit(jax_make_train_step(arch_j))(st, batch, key)
    kept = jax.device_get(st.extra_variables["batch_stats"])
    jax.tree_util.tree_map(np.testing.assert_array_equal, kept, variables["batch_stats"])

    # flax's returned statistics: the condition encoder in training on c
    _, moved = jax.jit(lambda v: arch_j.model.apply(
        v, batch["c"], T, method="encode_condition", train=True,
        mutable=["batch_stats"]))(variables)
    want = from_jax_variables({"params": variables["params"], **jax.device_get(moved)})
    m = arch_t.model
    before = {k: v.clone() for k, v in m.state_dict().items()}
    arch_t.train()
    try:
        arch_t.loss(batch, **jax_draws(arch_j, batch, key))
        got = {k: v.clone() for k, v in m.state_dict().items()}
    finally:
        arch_t.eval()
        m.load_state_dict(before, strict=True)
    stats = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert len(stats) == 32
    for k in stats:
        assert not torch.equal(got[k], before[k]), k
        assert_close_scaled(got[k].numpy(), want[k].numpy(), REL, k)
