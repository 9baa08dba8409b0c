"""The VAE architectures, the ACTOR encoder / decoder and InterCLIP's two
encoders against the JAX package on the CPU (models/vae_actor.py).

Each flax module is initialised at tiny widths, its ``params`` replaced by
a seeded numpy tree and carried into the port by ``from_jax_params`` with
``strict=True``; the same numpy inputs go through both.  ``MotionVAE``'s
loss takes the JAX run's reparameterisation draw (the random streams
differ).  InterCLIP's wrapper (normalise, scale) is checked on its
encoders' outputs; its full-width text tower (768 wide, 8 layers) is not
built here.  Tolerance: 1e-5 x max(1, max |JAX|) (the attention's sums and
softmax in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import motioncraft_tpu.models  # noqa: F401  (registers the flax classes)
from motioncraft_tpu.models import vae_actor as jax_va
from motioncraft_tpu.registry import build_architecture as build_jax
from motioncraft_tpu_torch.models import vae_actor
from motioncraft_tpu_torch.registry import ARCHITECTURES, build_architecture
from motioncraft_tpu_torch.utils.convert import from_jax_params
from torch_port_util import assert_close_scaled, grad_mode_on, seeded_params, t  # noqa: F401

REL = 1e-5
B, T, F = 3, 6, 10


def carry(flax_m, port, *args, seed=1, **kw):
    shapes = jax.eval_shape(lambda: flax_m.init(jax.random.PRNGKey(0), *args, **kw))
    params = seeded_params(jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                                                  dict(shapes["params"])), seed)
    port.load_state_dict(from_jax_params(params), strict=True)
    return {"params": jax.tree_util.tree_map(jnp.asarray, params)}, port.eval()


def motion_inputs(seed=0, feats=F):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, T, feats).astype(np.float32)
    mask = (np.arange(T)[None] < np.array([[T], [4], [2]])).astype(np.float32)
    return x, mask


ENCODERS = {
    "queries": dict(output_var=True),
    "one_query_learned_pe": dict(pos_embedding="learned"),
    "class_queries": dict(use_condition=True, num_class=5, output_var=True),
    "condition_mlp": dict(use_condition=True, condition_dim=7, output_var=True),
}


@pytest.mark.parametrize("case", sorted(ENCODERS))
def test_actor_encoder(case):
    kw = dict(max_seq_len=T, input_feats=F, latent_dim=16, num_heads=4, ff_size=24,
              num_layers=2, dropout=0.0, **ENCODERS[case])
    x, mask = motion_inputs()
    cond = None
    if kw.get("num_class"):
        cond = np.array([0, 4, 2], np.int32)
    elif kw.get("condition_dim"):
        cond = np.random.RandomState(1).randn(B, 7).astype(np.float32)
    flax_m = jax_va.ACTOREncoder(**kw)
    v, port = carry(flax_m, vae_actor.ACTOREncoder(**kw), x, mask, cond)
    want = jax.jit(lambda v_: flax_m.apply(v_, x, mask, cond))(v)
    with torch.no_grad():
        got = port(t(x), t(mask), None if cond is None else t(cond))
    for a, b in zip(*((w,) if not kw.get("output_var") else w for w in (got, want))):
        assert_close_scaled(a.numpy(), b, REL, f"ACTOREncoder {case}")


@pytest.mark.parametrize("case", ["plain", "projected_class_bias", "condition_mlp"])
def test_actor_decoder(case):
    kw = dict(max_seq_len=T, input_feats=F, input_dim=16, latent_dim=16, num_heads=4,
              ff_size=24, num_layers=2)
    cond = None
    if case == "projected_class_bias":
        kw.update(input_dim=12, use_condition=True, num_class=5)
        cond = np.array([1, 3, 0], np.int32)
    elif case == "condition_mlp":
        kw.update(use_condition=True, condition_dim=7)
        cond = np.random.RandomState(2).randn(B, 7).astype(np.float32)
    z = np.random.RandomState(3).randn(B, kw["input_dim"]).astype(np.float32)
    _, mask = motion_inputs()
    flax_m = jax_va.ACTORDecoder(**kw)
    v, port = carry(flax_m, vae_actor.ACTORDecoder(**kw), z, mask, cond)
    want = jax.jit(lambda v_: flax_m.apply(v_, z, mask, cond))(v)
    with torch.no_grad():
        got = port(t(z), t(mask), None if cond is None else t(cond)).numpy()
    assert got.shape == (B, T, F)
    assert_close_scaled(got, want, REL, f"ACTORDecoder {case}")


def vae_cfg():
    return dict(type="MotionVAE",
                encoder=dict(type="ACTOREncoder", max_seq_len=T, input_feats=F, latent_dim=16,
                             num_heads=4, ff_size=24, num_layers=1, dropout=0.0,
                             output_var=True),
                decoder=dict(type="ACTORDecoder", max_seq_len=T, input_feats=F, input_dim=16,
                             latent_dim=16, num_heads=4, ff_size=24, num_layers=1),
                loss_recon=dict(type="MSELoss", reduction="none"), kl_div_loss_weight=1e-2)


def test_motion_vae_loss():
    """MotionVAE's masked reconstruction loss plus its weighted KL, the
    latent's draw handed across; the port's entry point builds on the
    card unless told otherwise."""
    x, mask = motion_inputs(4)
    batch = {"motion": x, "motion_mask": mask}
    arch_j = build_jax(vae_cfg())
    shapes = jax.eval_shape(lambda r: arch_j.init(r, batch), jax.random.PRNGKey(0))
    enc, dec = (seeded_params(jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                                                     dict(shapes[k]["params"])), seed)
                for k, seed in (("encoder", 1), ("decoder", 2)))
    vj = {"encoder": {"params": enc}, "decoder": {"params": dec}}
    rng = jax.random.PRNGKey(9)
    total_j, logs_j = jax.jit(lambda v, r: arch_j.loss(v, batch, r))(vj, rng)
    noise = np.asarray(jax.random.normal(rng, (B, 16)))
    arch_t = build_architecture(vae_cfg(), device="cpu")
    assert isinstance(arch_t, vae_actor.MotionVAE)
    arch_t.encoder.load_state_dict(from_jax_params(enc), strict=True)
    arch_t.decoder.load_state_dict(from_jax_params(dec), strict=True)
    total_t, logs_t = arch_t.loss(batch, noise=t(noise))
    for k in ("recon_loss", "kl_div_loss", "loss"):
        assert_close_scaled(logs_t[k].detach().numpy(), logs_j[k], REL, k)
    total_t.backward()
    assert all(torch.isfinite(p.grad).all() for p in arch_t.parameters() if p.grad is not None)
    assert "PoseVAE" in ARCHITECTURES and "InterCLIP" in vae_actor.SUBMODULES


def test_inter_clip_encoders():
    rng = np.random.RandomState(5)
    motion = rng.randn(B, T, 2 * 12).astype(np.float32)
    _, mask = motion_inputs()
    mkw = dict(input_dim=12, latent_dim=16, ff_size=24, num_layers=2, num_heads=4, dropout=0.1)
    flax_m = jax_va.InterMotionEncoderModule(**mkw)
    v, port_m = carry(flax_m, vae_actor.InterMotionEncoderModule(**mkw), motion, mask)
    want = jax.jit(lambda v_: flax_m.apply(v_, motion, mask))(v)
    with torch.no_grad():
        got = port_m(t(motion), t(mask))
    assert_close_scaled(got.numpy(), want, REL, "InterCLIP motion")
    from motioncraft_tpu_torch.models.tokenizer import tokenize

    ids = np.asarray(tokenize(["two people shake hands", "one pushes the other"]))
    tkw = dict(clip_width=32, ff_size=24, num_layers=2)
    flax_t = jax_va.InterTextEncoderModule(**tkw)
    v, port_t = carry(flax_t, vae_actor.InterTextEncoderModule(**tkw), ids, seed=3)
    want = jax.jit(lambda v_: flax_t.apply(v_, ids))(v)
    with torch.no_grad():
        got_t = port_t(t(ids, torch.long))
    assert_close_scaled(got_t.numpy(), want, REL, "InterCLIP text")
    # the wrapper: each embedding L2-normalised and scaled, on these encoders
    clip = vae_actor.InterCLIP.__new__(vae_actor.InterCLIP)
    torch.nn.Module.__init__(clip)
    clip.motion_module, clip.text_module = port_m, port_t
    clip.device, clip.latent_scale = torch.device("cpu"), 2.0
    emb = clip.encode_motion(motion, motion_mask=mask).numpy()
    want_m = np.asarray(got) / (np.linalg.norm(np.asarray(got), axis=-1, keepdims=True) + 1e-12)
    assert_close_scaled(emb, 2.0 * want_m, REL, "encode_motion")
    text = clip.encode_text(["two people shake hands", "one pushes the other"]).numpy()
    assert_close_scaled(np.linalg.norm(text, axis=-1), np.full(2, 2.0), REL, "encode_text")
