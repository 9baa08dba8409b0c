"""Training of the baseline zoo in the port against the JAX package on the
CPU, at tiny widths, on one seeded flax tree a family carried over by
``from_jax_variables`` with ``strict=True``: MotionDiffuse, MCM, MDM (at
dropout 0), FineMoGen (gate noise 0, one text head) and the MCM ControlNet
over music features (M2D) and over raw audio through the WavEncoder (S2G):

- the training forward (``mode="train"``) at ``cond_type`` 0, 5, 11 and 99
  (the text off in the first row only) against flax's ``train=True``
  apply, with the sums of the MoE aux losses and of SAMI's template KL
  terms that the JAX loss reads from its sown ``losses``;
- ``MotionDiffusion.loss`` and every trainable parameter's gradient against
  ``jax.grad`` of the JAX loss, on JAX's draws of t, noise and cond_type
  replayed (a key whose cond_type draws turn the text off in some rows and
  not in others); the frozen CLIP takes no gradient on either side;
- MDM's dropout (0.1, as its configs ship): the training step's generator
  fixes its masks (one seed, one loss, bit for bit), it acts in ``train()``
  mode only, and MDM's CLIP (at ``clip``, not ``text_enc/clip``) stays bit
  for bit through two Adam steps of the training CLI's freezing;
- JAX's MDM never reads ``cond_mask_prob``: its loss is the same at 0 and
  at 1, and so is the port's;
- K5's gradient at a head width the kernel is not instantiated for (MCM's
  channel attention, d = 49): the wrapper's padded route (``pad_heads``,
  the kernel with its recomputed plain gradient, the cut back to d), with
  the plain version standing in for the kernel, and the plain padded path
  against the plain function at d.

Tolerances, as tests/test_torch_train.py and
tests/test_torch_controlnet_train.py hold the flagship and the STMoGen
ControlNets: outputs and the loss 1e-5 of max(1, max |JAX|), gradients 1e-4
(sums in another order, erf from another library; a gradient sums
hundreds of such products); the WavEncoder's BatchNorms in training (S2G)
take their statistics from the batch, which scales up the rounding of what
they normalise, so its training forward and its loss are held to 5e-5, as
its module test is.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import motioncraft_tpu.models  # noqa: F401  (registers the flax classes)
from motioncraft_tpu.apis.factory import make_text_batch
from motioncraft_tpu.registry import build_architecture as build_jax
from motioncraft_tpu_torch.apis import make_train_step
from motioncraft_tpu_torch.ops.linear_attention import (fused_linear_attention,
                                                        fused_linear_attention_plain,
                                                        pad_heads, padded_width)
from motioncraft_tpu_torch.ops.recompute import with_recomputed_grad
from motioncraft_tpu_torch.parallel import TrainState
from motioncraft_tpu_torch.registry import build_architecture as build_torch
from motioncraft_tpu_torch.utils.convert import from_jax_params, from_jax_variables
from test_torch_baselines import mcm_cfg, mdm_cfg, motiondiffuse_cfg
from test_torch_finemogen import finemogen_cfg
from test_torch_mcm_controlnet import arch_cfg as mcm_controlnet_cfg
from test_torch_mcm_controlnet import condition, seeded_variables
from test_torch_train import assert_grads_close, jax_draws
from torch_port_util import assert_close_scaled, grad_mode_on, t  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location("torch_train",
                                               os.path.join(REPO, "tools", "torch_train.py"))
torch_train = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(torch_train)

REL, GRAD_REL, REL_BN = 1e-5, 1e-4, 5e-5
B = 4
LENGTHS = np.array([[16], [11], [16], [7]], np.int32)
TEXTS = ["a person walks forward", "someone waves hello", "a dancer spins twice",
         "a man jumps over a box"]
COND_TYPES = np.array([0, 5, 11, 99], np.int32).reshape(B, 1, 1)
RNG_SEEDS = range(100, 200)


def _mdm_dropout(p):
    cfg = mdm_cfg()
    cfg["model"]["dropout"] = p
    return cfg


def _finemogen():
    cfg = finemogen_cfg()
    cfg["model"]["ca_block_cfg"]["gate_noise"] = 0.0
    return cfg


# family -> (config, feats, condition kind or None)
FAMILIES = {
    "motiondiffuse": (motiondiffuse_cfg, 24, None),
    "mcm": (mcm_cfg, 24, None),
    "mdm": (lambda: _mdm_dropout(0.0), 24, None),
    "finemogen": (_finemogen, 322, None),
    "mcm_m2d": (lambda: mcm_controlnet_cfg("music"), 322, "music"),
    "mcm_s2g": (lambda: mcm_controlnet_cfg("wav"), 322, "wav"),
}
CLIP = {"mdm": "clip.", "mcm_m2d": "base_model.text_enc.clip.",
        "mcm_s2g": "base_model.text_enc.clip."}


def family_batch(feats, kind, seed=5):
    rng = np.random.RandomState(seed)
    batch = make_text_batch(TEXTS, max_seq_len=16, input_feats=feats,
                            motion=rng.randn(B, 16, feats).astype(np.float32), lengths=LENGTHS)
    if kind is not None:
        batch["c"] = condition(kind, 16, seed + 1, batch=B)
    return batch


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def family(request):
    """(name, JAX arch, seeded variables, port arch, batch, the jitted JAX
    value-and-grad of the loss over params at a key)."""
    name = request.param
    make_cfg, feats, kind = FAMILIES[name]
    arch_j = build_jax(make_cfg())
    batch = family_batch(feats, kind)
    variables = seeded_variables(jax.jit(lambda: arch_j.init(jax.random.PRNGKey(0), batch))(),
                                 1)
    arch_t = build_torch(make_cfg(), device="cpu")
    arch_t.model.load_state_dict(from_jax_variables(variables), strict=True)
    extra = {k: jax.tree_util.tree_map(jnp.asarray, v) for k, v in variables.items()
             if k != "params"}
    grad_fn = jax.jit(jax.value_and_grad(
        lambda p, key: arch_j.loss({"params": p, **extra}, batch, key), has_aux=True))
    return name, arch_j, variables, arch_t, batch, grad_fn


def _reload(arch_t, variables):
    """The seeded weights and statistics back (a BatchNorm in training moves
    its running statistics)."""
    arch_t.model.load_state_dict(from_jax_variables(variables), strict=True)
    arch_t.eval()


def _split(enc):
    return enc if isinstance(enc, tuple) else (None, enc)


def test_train_forward(family):
    """The denoiser's training forward alone: output, aux and KL sums."""
    name, arch_j, variables, arch_t, batch, _ = family
    rng = np.random.RandomState(7)
    x = rng.randn(*batch["motion"].shape).astype(np.float32)
    ts = np.array([3, 500, 999, 120], np.int32)
    model = arch_j.model
    key = jax.random.PRNGKey(0)

    def apply(v):
        xf_proj, xf = _split(model.apply(v, batch["text_ids"], method="encode_text",
                                         train=True, rngs={"dropout": key}))
        return model.apply(v, x, ts, motion_mask=batch["motion_mask"],
                           motion_length=batch["motion_length"], xf_out=xf, xf_proj=xf_proj,
                           num_intervals=1, cond_type=COND_TYPES, c=batch.get("c"),
                           mode="train", train=True, rngs={"gate_noise": key, "dropout": key},
                           mutable=["losses", "batch_stats"])

    want, state = jax.jit(apply)(jax.tree_util.tree_map(jnp.asarray, variables))
    sums = {}
    for leaf_name in ("aux_loss", "kl_loss"):
        leaves = [leaf for path, leaf in jax.tree_util.tree_leaves_with_path(
            state.get("losses", {})) if leaf_name in jax.tree_util.keystr(path)]
        sums[leaf_name] = float(sum(leaves)) if leaves else None
    m = arch_t.model
    m.train()
    aux, kl = [], []
    try:
        with torch.no_grad():
            xf_proj, xf = _split(m.encode_text(t(batch["text_ids"], torch.long)))
            kw = {} if batch.get("c") is None else {"c": t(batch["c"])}
            got = m(t(x), t(ts, torch.long), motion_mask=t(batch["motion_mask"]),
                    motion_length=t(batch["motion_length"]), xf_out=xf, xf_proj=xf_proj,
                    num_intervals=1, mode="train", cond_type=t(COND_TYPES, torch.long),
                    aux_losses=aux, kl_losses=kl, **kw)
    finally:
        _reload(arch_t, variables)
    assert np.abs(np.asarray(want)).max() > 1e-3  # the comparison is not of zeros
    rel = REL_BN if name == "mcm_s2g" else REL
    assert_close_scaled(got.numpy(), want, rel, f"{name} training forward")
    # FineMoGen: each SAMI layer's text and motion MoE, and its template KL
    assert (len(aux), len(kl)) == ((4, 2) if name == "finemogen" else (0, 0))
    assert (sums["aux_loss"] is None) == (not aux) and (sums["kl_loss"] is None) == (not kl)
    for got_terms, want_sum, what in ((aux, sums["aux_loss"], "aux"),
                                      (kl, sums["kl_loss"], "kl")):
        if got_terms:
            assert_close_scaled(float(sum(got_terms)), want_sum, REL, f"{name} {what}")


def mixed_key(arch_j, batch):
    """A key whose cond_type draws turn the text off in some rows and not
    in others."""
    for seed in RNG_SEEDS:
        key = jax.random.PRNGKey(seed)
        off = jax_draws(arch_j, batch, key)["cond_type"].reshape(-1) % 10 == 0
        if off.any() and not off.all():
            return key
    raise AssertionError("no key in RNG_SEEDS mixes the two kinds of rows")


def test_loss_and_gradients(family):
    name, arch_j, variables, arch_t, batch, grad_fn = family
    key = mixed_key(arch_j, batch)
    (_, logs_j), grads_j = grad_fn(jax.tree_util.tree_map(jnp.asarray, variables["params"]),
                                   key)
    draws = jax_draws(arch_j, batch, key)
    m = arch_t.model
    m.zero_grad()
    arch_t.train()
    try:
        total, logs_t = arch_t.loss(batch, **draws)
        total.backward()
        got = {k: p.grad.numpy().copy() for k, p in m.named_parameters()
               if p.grad is not None}
        no_grad = {k for k, p in m.named_parameters() if p.grad is None}
    finally:
        m.zero_grad()
        _reload(arch_t, variables)
    losses = {k for k in logs_j if "loss" in k and k != "recon_loss_batch"}
    assert losses == {k for k in logs_t if "loss" in k and k != "recon_loss_batch"}
    assert losses == ({"loss", "recon_loss", "moe_route_loss", "template_kl_loss"}
                      if name == "finemogen" else {"loss", "recon_loss"})
    rel = REL_BN if name == "mcm_s2g" else REL
    for k in sorted(losses) + ["recon_loss_batch", "t_mean"]:
        assert_close_scaled(logs_t[k].detach().numpy(), logs_j[k], rel, f"{name} {k}")
    want = {k: a.numpy() for k, a in from_jax_params(jax.device_get(grads_j)).items()}
    clip = {k for k in want if k.startswith(CLIP.get(name, "text_enc.clip."))}
    assert clip and no_grad == clip, sorted(no_grad ^ clip)[:5]
    for k in clip:
        assert not np.any(want.pop(k)), f"JAX's gradient of the frozen {k} is not zero"
    assert_grads_close(got, want, GRAD_REL)


# ------------------------------------------------------------- MDM dropout
def _mdm_port(p=0.1, cond_mask_prob=0.1, seed=3):
    cfg = _mdm_dropout(p)
    cfg["model"]["cond_mask_prob"] = cond_mask_prob
    arch = build_torch(cfg, device="cpu")
    torch.manual_seed(seed)
    for prm in arch.model.parameters():
        torch.nn.init.normal_(prm, std=0.2)
    return arch, cfg


def test_mdm_dropout_follows_the_step_generator():
    arch, _ = _mdm_port()
    batch = family_batch(24, None)
    arch.train()
    try:
        losses = [arch.loss(batch, generator=torch.Generator().manual_seed(s))[0].detach()
                  for s in (11, 11, 12)]
        # the forward in train() and in eval() mode on the same draws
        m = arch.model
        x = t(np.random.RandomState(8).randn(B, 16, 24).astype(np.float32))
        kw = dict(motion_mask=t(batch["motion_mask"]), xf_out=m.encode_text(
            t(batch["text_ids"], torch.long)), mode="train",
            cond_type=t(COND_TYPES, torch.long))
        ts = t(np.array([5, 50, 500, 900]), torch.long)
        with torch.no_grad():
            trained = [m(x, ts, generator=torch.Generator().manual_seed(1), **kw)
                       for _ in range(2)]
            m.eval()
            plain = m(x, ts, generator=torch.Generator().manual_seed(1), **kw)
    finally:
        arch.eval()
    assert torch.equal(losses[0], losses[1]) and not torch.equal(losses[0], losses[2])
    assert torch.equal(trained[0], trained[1])
    assert not torch.equal(trained[0], plain)
    assert float((trained[0] - plain).abs().max()) > 1e-2


def test_mdm_clip_stays_through_two_adam_steps():
    """The training CLI's freezing: MDM's CLIP (``clip/``) takes no gradient,
    no update and no Adam state; everything else moves."""
    arch, cfg = _mdm_port()
    before = {k: v.clone() for k, v in arch.model.state_dict().items()}
    prefixes = torch_train.frozen_prefixes(cfg["model"])
    assert prefixes == ("clip/",)
    state = TrainState(arch.model, {"type": "Adam", "lr": 1e-3}, frozen_prefixes=prefixes)
    step = make_train_step(arch, state)
    arch.train()
    try:
        for seed in (1, 2):
            step(family_batch(24, None, seed), torch.Generator().manual_seed(seed))
    finally:
        arch.eval()
    after = arch.model.state_dict()
    clip = [n for n, _ in arch.model.named_parameters() if n.startswith("clip.")]
    assert clip and all(torch.equal(after[n], before[n]) for n in clip)
    assert all(not p.requires_grad and p not in state.optimizer.state
               for n, p in arch.model.named_parameters() if n.startswith("clip."))
    rest = [n for n, _ in arch.model.named_parameters() if not n.startswith("clip.")]
    assert all(not torch.equal(after[n], before[n]) for n in rest)


def test_mdm_cond_mask_prob_is_never_read():
    """JAX's MDM stores ``cond_mask_prob`` and drops the text by cond_type
    alone: its loss is the same at 0 and at 1; so is the port's."""
    batch = family_batch(24, None)
    key = jax.random.PRNGKey(3)
    losses_j = []
    for prob in (0.0, 1.0):
        cfg = _mdm_dropout(0.0)
        cfg["model"]["cond_mask_prob"] = prob
        arch_j = build_jax(cfg)
        variables = jax.jit(lambda a=arch_j: a.init(jax.random.PRNGKey(0), batch))()
        losses_j.append(float(jax.jit(lambda v, a=arch_j: a.loss(v, batch, key)[0])(
            variables)))
    assert losses_j[0] == losses_j[1]
    losses_t = []
    for prob in (0.0, 1.0):
        arch, _ = _mdm_port(p=0.0, cond_mask_prob=prob)
        arch.train()
        losses_t.append(arch.loss(batch, generator=torch.Generator().manual_seed(4))[0])
    assert torch.equal(losses_t[0], losses_t[1])


# ------------------------------------------------------- K5 padded gradient
def _padded_route(q, k, v):
    """The CUDA wrapper's route at a d it pads (ops/linear_attention.py),
    with the plain version in the kernel's place: pad, the recomputed-grad
    call, the cut back to d."""
    d = q.shape[-1]
    padded = pad_heads(q, k, v, padded_width(d))
    return with_recomputed_grad(fused_linear_attention_plain, fused_linear_attention_plain,
                                *padded)[..., :d]


@pytest.mark.parametrize("route", ["wrapper", "plain padded"])
def test_k5_padded_gradient(route):
    """MCM's channel self-attention: 49-wide heads (196 frames over 4
    heads) of 512 channel tokens, unmasked, here at 2 rows x 40 tokens."""
    rng = np.random.RandomState(9)
    shape = (2, 40, 4, 49)
    q, k, v = (t(rng.randn(*shape).astype(np.float32)).requires_grad_() for _ in range(3))
    w = t(rng.randn(*shape).astype(np.float32))
    assert padded_width(49) == 64
    want = fused_linear_attention(q, k, v)  # the CPU's plain version at d = 49
    want_g = torch.autograd.grad((want * w).sum(), (q, k, v))
    if route == "wrapper":
        got = _padded_route(q, k, v)
    else:
        got = fused_linear_attention_plain(*pad_heads(q, k, v, 64))[..., :49]
    got_g = torch.autograd.grad((got * w).sum(), (q, k, v))
    assert_close_scaled(got.detach().numpy(), want.detach().numpy(), REL, f"{route} output")
    for a, b, what in zip(got_g, want_g, "qkv"):
        assert float(b.abs().max()) > 1e-3
        assert_close_scaled(a.numpy(), b.numpy(), REL, f"{route} d{what}")
