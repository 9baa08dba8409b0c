"""The baseline denoisers of the port (MotionDiffuse, MCM, MDM) against the
JAX package at tiny widths, on the same seeded flax tree carried over by
``from_jax_params`` with ``strict=True``: their blocks (FFN, the Efficient
self / cross / mixed attentions through K5's plain version, and one head
width that is no power of two through the padded wrapper's arithmetic), the
text encoders that pool (CLIP's ``text_projection``, ``use_text_proj``),
each whole ``forward_test``, each whole ``MotionDiffusion.sample`` under
``inference_type='ddpm'`` on the JAX run's draws replayed, and the
reference checkpoint converters on fabricated state dicts (MDM in both its
namings, with the official checkpoint's post-processing), and the bf16 and
int8 casts of each family.  Tolerance: 1e-4
x max(1, max |JAX|), as test_torch_sample.py holds the flagship; the sums
differ in order and erf comes from different libraries."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import motioncraft_tpu.models  # noqa: F401  (registers the flax classes)
from motioncraft_tpu.apis.factory import make_text_batch
from motioncraft_tpu.models import attentions as jax_att
from motioncraft_tpu.models.blocks import FFN as JaxFFN
from motioncraft_tpu.registry import build_architecture as build_jax
from motioncraft_tpu.utils import torch_convert as jax_tc
from motioncraft_tpu_torch.models import attentions as port_att
from motioncraft_tpu_torch.models.blocks import FFN
from motioncraft_tpu_torch.ops.linear_attention import (fused_linear_attention_plain,
                                                        pad_heads, padded_width)
from motioncraft_tpu_torch.registry import build_architecture as build_torch
from motioncraft_tpu_torch.utils import torch_convert as port_tc
from motioncraft_tpu_torch.utils.checkpoint import load_eval_variables
from motioncraft_tpu_torch.utils.convert import from_jax_params
from torch_port_util import Replay, assert_close_scaled, jax_ddpm_draws, seeded_params, t

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import fabricate_torch as fab  # noqa: E402

REL = 1e-4
T, FEATS, STEPS = 16, 24, 20
TE = 32  # time_embed_dim


def _diffusion(mean_type, beta="linear"):
    return dict(beta_scheduler=beta, diffusion_steps=1000, model_mean_type=mean_type,
                model_var_type="fixed_small", respace=str(STEPS))


def _text_encoder():
    return dict(pretrained_model="clip", latent_dim=16, num_layers=2, num_heads=4,
                ff_size=32, dropout=0, use_text_proj=True, clip_width=32, clip_layers=2)


def motiondiffuse_cfg():
    return dict(type="MotionDiffusion",
                model=dict(type="MotionDiffuseTransformer", input_feats=FEATS, max_seq_len=T,
                           latent_dim=32, time_embed_dim=TE, num_layers=2,
                           sa_block_cfg=dict(type="EfficientSelfAttention", latent_dim=32,
                                             num_heads=4, dropout=0, time_embed_dim=TE),
                           ca_block_cfg=dict(type="EfficientCrossAttention", latent_dim=32,
                                             text_latent_dim=16, num_heads=4, dropout=0,
                                             time_embed_dim=TE),
                           ffn_cfg=dict(latent_dim=32, ffn_dim=64, dropout=0,
                                        time_embed_dim=TE),
                           text_encoder=_text_encoder()),
                loss_recon=dict(type="MSELoss", loss_weight=1, reduction="none"),
                diffusion_train=_diffusion("epsilon"), diffusion_test=_diffusion("epsilon"),
                inference_type="ddpm")


def mcm_cfg():
    cfg = motiondiffuse_cfg()
    cfg["model"] = dict(cfg["model"], type="MCMTransformer",
                        sa_block_cfg=dict(type="EfficientSelfAttention", latent_dim=T,
                                          num_heads=4, dropout=0, time_embed_dim=TE))
    return cfg


def mdm_cfg(official=False):
    return dict(type="MotionDiffusion",
                model=dict(type="MDMTransformer", input_feats=FEATS, latent_dim=32, ff_size=64,
                           num_layers=2, num_heads=4, dropout=0.1, clip_dim=32,
                           clip_layers=2, guide_scale=2.5, use_official_ckpt=official),
                loss_recon=dict(type="MSELoss", loss_weight=1, reduction="none"),
                diffusion_train=_diffusion("start_x", "cosine"),
                diffusion_test=_diffusion("start_x", "cosine"), inference_type="ddpm")


FAMILIES = {"motiondiffuse": motiondiffuse_cfg, "mcm": mcm_cfg, "mdm": mdm_cfg}


def _batch():
    return make_text_batch(["a person walks forward", "someone waves hello"], max_seq_len=T,
                           input_feats=FEATS, lengths=np.array([[T], [11]], np.int32))


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def pair(request):
    """(family, JAX arch, its variables, the port's arch, batch) on one seeded
    tree."""
    cfg = FAMILIES[request.param]()
    arch_j = build_jax(cfg)
    batch = _batch()
    variables = arch_j.init(jax.random.PRNGKey(0), batch)
    params = seeded_params(jax.tree_util.tree_map(np.asarray, variables["params"]), 1)
    arch_t = build_torch(cfg, device="cpu")
    arch_t.model.load_state_dict(from_jax_params(params), strict=True)
    return (request.param, arch_j, {"params": jax.tree_util.tree_map(jnp.asarray, params)},
            arch_t, batch)


def _encode(arch_j, variables, batch):
    enc = arch_j.encode_text(variables, batch["text_ids"])
    return enc if isinstance(enc, tuple) else (None, enc)


def test_encode_text(pair):
    """The text condition: (xf_proj, xf_out) with use_text_proj, MDM's
    pooled CLIP feature (EOT row x text_projection)."""
    family, arch_j, variables, arch_t, batch = pair
    want = _encode(arch_j, variables, batch)
    got = arch_t.encode_text(batch["text_ids"])
    got = got if isinstance(got, tuple) else (None, got)
    assert (want[0] is None) == (got[0] is None) == (family == "mdm")
    for w, g, what in zip(want, got, ("xf_proj", "xf_out")):
        if w is not None:
            assert_close_scaled(g.numpy(), np.asarray(w), REL, f"{family} {what}")


def test_forward_test(pair):
    family, arch_j, variables, arch_t, batch = pair
    x = np.random.RandomState(3).randn(*batch["motion"].shape).astype(np.float32)
    ts = np.array([999, 321], np.int32)
    xf_proj, xf = _encode(arch_j, variables, batch)
    want = np.asarray(jax.jit(lambda v, x_, t_, m, ml, xf_, xp: arch_j.model.apply(
        v, x_, t_, motion_mask=m, motion_length=ml, xf_out=xf_, xf_proj=xp, mode="test"))(
        variables, x, ts, batch["motion_mask"], batch["motion_length"], xf, xf_proj))
    with torch.no_grad():
        enc = arch_t.encode_text(batch["text_ids"])
        xp_t, xf_t = enc if isinstance(enc, tuple) else (None, enc)
        kw = {} if xp_t is None else {"xf_proj": xp_t}
        got = arch_t.model(t(x), t(ts, torch.long), motion_mask=t(batch["motion_mask"]),
                           motion_length=t(batch["motion_length"]), xf_out=xf_t, **kw).numpy()
    assert np.abs(want).max() > 1e-2  # the comparison is not of zeros
    assert_close_scaled(got, want, REL, f"{family} forward_test")


def test_sample_ddpm(pair):
    """The whole DDPM chain (20 steps) through MotionDiffusion.sample, on the
    JAX run's initial noise and step draws, replayed."""
    family, arch_j, variables, arch_t, batch = pair
    rng = jax.random.PRNGKey(5)
    want = np.asarray(jax.jit(lambda v, b, r: arch_j.sample(v, b, r))(variables, batch, rng))
    draws = jax_ddpm_draws(STEPS, rng, batch["motion"].shape)
    got = arch_t.sample(batch, randn=Replay(draws)).numpy()
    assert arch_t.inference_type == "ddpm" and arch_t.diffusion_test.num_timesteps == STEPS
    assert np.isfinite(got).all()
    assert_close_scaled(got, want, REL, f"{family} sample")


def test_baselines_refuse_the_step_cache_and_training(pair):
    """The step cache is refused; training, which raised before baseline
    training was ported, runs (tests/test_torch_baseline_train.py holds it
    against JAX)."""
    from motioncraft_tpu_torch.diffusion import StepCacheConfig

    family, _, _, arch_t, batch = pair
    with pytest.raises(ValueError, match="step caching"):
        arch_t.sample(batch, step_cache=StepCacheConfig(reuse_every=2))
    arch_t.train()
    try:
        total, _ = arch_t.loss(dict(batch, motion=np.zeros_like(batch["motion"])),
                               generator=torch.Generator().manual_seed(0))
    finally:
        arch_t.eval()
    assert np.isfinite(float(total))


def test_baselines_refuse_bf16_and_int8(pair):
    """The casts run on every family (a copy of the fixture's model):
    ``bf16_cast_`` rounds every tensor as ``bf16_cast_variables`` casts
    every leaf, bit for bit, keeping the time MLP's in f32; ``int8_quantize_``
    at ``min_elems=1`` quantizes the leaves ``int8_quantize_variables``
    quantizes (MDM: its time MLP alone).  Their forwards and samples are
    held against the JAX package's in tests/test_torch_baselines_{bf16,int8}.py."""
    import copy

    from motioncraft_tpu.apis.factory import bf16_cast_variables, int8_quantize_variables
    from motioncraft_tpu_torch.apis import PROMOTED_MODULES, bf16_cast_, int8_quantize_
    from motioncraft_tpu_torch.ops.quant import count_quantized

    family, _, variables, arch_t, _ = pair
    arch = copy.deepcopy(arch_t)
    bf16_cast_(arch)
    want = from_jax_params(jax.tree_util.tree_map(
        lambda a: np.asarray(a.astype(jnp.float32)), bf16_cast_variables(variables)["params"]))
    got = arch.model.state_dict()
    assert set(got) == set(want)
    for k, v in got.items():
        promoted = bool(set(k.split(".")) & set(PROMOTED_MODULES))
        assert v.dtype == (torch.float32 if promoted else torch.bfloat16), k
        np.testing.assert_array_equal(v.float().numpy(), want[k].numpy(), err_msg=k)
    arch = copy.deepcopy(arch_t)
    int8_quantize_(arch, min_elems=1)
    quantized = int8_quantize_variables(variables, min_elems=1)["params"]
    n = sum(a.dtype == jnp.int8 for a in jax.tree_util.tree_leaves(quantized))
    assert count_quantized(arch.model)[0] == n == {"motiondiffuse": 32, "mcm": 24,
                                                   "mdm": 2}[family]


# ------------------------------------------------------------- modules
def _module_pair(flax_module, port_module, *args, seed=2, **kwargs):
    """Init ``flax_module`` on ``args`` and load the same seeded tree into
    ``port_module``; returns the JAX apply with those params."""
    variables = flax_module.init(jax.random.PRNGKey(0), *args, **kwargs)
    params = seeded_params(jax.tree_util.tree_map(np.asarray, variables["params"]), seed)
    port_module.load_state_dict(from_jax_params(params), strict=True)
    return lambda *a, **k: np.asarray(flax_module.apply({"params": params}, *a, **k))


def _inputs(B=2, Tq=T, D=32, N=7, text=16, seed=4):
    rs = np.random.RandomState(seed)
    x = rs.randn(B, Tq, D).astype(np.float32)
    xf = rs.randn(B, N, text).astype(np.float32)
    emb = rs.randn(B, TE).astype(np.float32)
    mask = (np.arange(Tq)[None] < np.array([[Tq], [Tq - 5]])).astype(np.float32)[..., None]
    cond = np.array([1, 10], np.int32).reshape(B, 1, 1)  # text on, then off
    return x, xf, emb, mask, cond


def test_ffn():
    x, _, emb, _, _ = _inputs()
    port = FFN(32, 64, 0.0, TE)
    apply = _module_pair(JaxFFN(32, 64, 0.0, TE), port, x, emb)
    with torch.no_grad():
        assert_close_scaled(port(t(x), t(emb)).numpy(), apply(x, emb), REL, "FFN")


@pytest.mark.parametrize("D,H", [(32, 4), (20, 4)], ids=["d8", "d5"])
def test_efficient_self_attention(D, H):
    """Non-merged, with its StylizationBlock; d = 5 is MCM's case of a head
    width the kernel is not instantiated for."""
    x, _, emb, mask, _ = _inputs(D=D)
    port = port_att.EfficientSelfAttention(D, H, 0.0, TE)
    apply = _module_pair(jax_att.EfficientSelfAttention(D, H, 0.0, TE), port, x, mask, emb)
    with torch.no_grad():
        got = port(t(x), t(mask), t(emb)).numpy()
    assert_close_scaled(got, apply(x, mask, emb), REL, f"EfficientSelfAttention D={D}")


def test_padded_head_width_is_the_function():
    """MCM's channel attention (T = 196 over 4 heads: d = 49) runs K5 at the
    next instantiated width: the query logits padded at NEG_INF, keys and
    values at 0, the output cut back.  On the CPU the padded operands go
    through the plain version, which must give the unpadded function."""
    rs = np.random.RandomState(5)
    B, Tq, N, H, d = 2, 12, 9, 4, 49
    q, k, v = (t(rs.randn(B, n, H, d).astype(np.float32)) for n in (Tq, N, N))
    k[1, 6:] += -1e6  # masked keys, as the attentions mask them
    v[1, 6:] = 0
    assert padded_width(49) == 64 and padded_width(64) == 64 and padded_width(5) == 16
    want = fused_linear_attention_plain(q, k, v)
    got = fused_linear_attention_plain(*pad_heads(q, k, v, 64))
    assert got.shape == (B, Tq, H, 64) and float(got[..., d:].abs().max()) == 0.0
    assert_close_scaled(got[..., :d].numpy(), want.numpy(), 1e-6, "padded K5 plain")
    with pytest.raises(ValueError, match="up to 128"):
        padded_width(129)


@pytest.mark.parametrize("cond", [False, True], ids=["no_cond_type", "cond_type"])
def test_efficient_cross_attention(cond):
    x, xf, emb, _, cond_type = _inputs()
    ct = cond_type if cond else None
    port = port_att.EfficientCrossAttention(32, 16, 4, 0.0, TE)
    apply = _module_pair(jax_att.EfficientCrossAttention(32, 16, 4, 0.0, TE), port, x, xf,
                         emb, ct)
    with torch.no_grad():
        got = port(t(x), xf=t(xf), emb=t(emb), cond_type=None if ct is None else t(ct))
    want = apply(x, xf, emb, ct)
    assert_close_scaled(got.numpy(), want, REL, f"EfficientCrossAttention cond={cond}")


def test_efficient_mixed_attention():
    x, xf, emb, mask, cond_type = _inputs()
    port = port_att.EfficientMixedAttention(32, 16, 4, 0.0, TE)
    apply = _module_pair(jax_att.EfficientMixedAttention(32, 16, 4, 0.0, TE), port, x, xf,
                         emb, mask, cond_type)
    with torch.no_grad():
        got = port(t(x), xf=t(xf), emb=t(emb), src_mask=t(mask), cond_type=t(cond_type))
    assert_close_scaled(got.numpy(), apply(x, xf, emb, mask, cond_type), REL,
                        "EfficientMixedAttention")


def test_efficient_mixed_attention_refuses_dropout_in_training():
    """It no longer refuses: in training with dropout its key softmax is
    dropped out (from the step's generator) before the contraction, as the
    JAX package computes it (held against JAX with the JAX run's masks in
    tests/test_torch_zoo_attentions.py).  One seed (the generator's, and
    torch's, which its stylized residual's dropout draws from) gives one
    output, another seed another; in eval it is K5's path."""
    x, xf, emb, mask, cond_type = _inputs()
    port = port_att.EfficientMixedAttention(32, 16, 4, 0.1, TE)
    apply = _module_pair(jax_att.EfficientMixedAttention(32, 16, 4, 0.1, TE), port, x, xf,
                         emb, mask, cond_type)
    kw = dict(xf=t(xf), emb=t(emb), src_mask=t(mask), cond_type=t(cond_type))
    with torch.no_grad():
        assert_close_scaled(port.eval()(t(x), **kw).numpy(), apply(x, xf, emb, mask, cond_type),
                            REL, "EfficientMixedAttention eval")
        port.train()
        runs = []
        for s in (1, 1, 2):
            torch.manual_seed(s)
            runs.append(port(t(x), generator=torch.Generator().manual_seed(s), **kw))
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], runs[2])


# ---------------------------------------------------------- converters
def _jax_params(cfg):
    arch = build_jax(cfg)
    return jax.tree_util.tree_map(np.asarray,
                                  arch.init(jax.random.PRNGKey(0), _batch())["params"])


def _assert_trees_equal(got, want, path=""):
    assert sorted(got) == sorted(want), (path, sorted(got), sorted(want))
    for k in want:
        if isinstance(want[k], dict):
            _assert_trees_equal(got[k], want[k], f"{path}/{k}")
        else:
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]),
                                          err_msg=f"{path}/{k}")


CONVERTERS = {
    "motiondiffuse": (motiondiffuse_cfg, lambda p, r: fab.motiondiffuse_sd(p, r, 2, 2, 2),
                      lambda m, sd: m.convert_motiondiffuse(sd, 2, 2, 2)),
    "mcm": (mcm_cfg, lambda p, r: fab.mcm_sd(p, r, 2, 2, 2),
            lambda m, sd: m.convert_mcm(sd, 2, 2, 2)),
    "mdm": (mdm_cfg, lambda p, r: fab.mdm_sd(p, r, 2, 2),
            lambda m, sd: m.convert_mdm(sd, 2, 2)),
    "mdm_official": (lambda: mdm_cfg(official=True),
                     lambda p, r: fab.mdm_sd(p, r, 2, 2, official=True),
                     lambda m, sd: m.convert_mdm(sd, 2, 2)),
}


@pytest.mark.parametrize("family", sorted(CONVERTERS))
def test_converter_matches_jax_and_loads(family, tmp_path):
    """The port's converter gives the JAX converter's tree on a fabricated
    reference state dict ('model.'-prefixed, as mmcv saves it); the .pth
    loads through load_eval_variables with strict=True.  The official MDM
    file holds no CLIP, which keeps the weights it had."""
    make_cfg, fabricate, convert = CONVERTERS[family]
    cfg = make_cfg()
    params = _jax_params(cfg)
    sd = fabricate(params, np.random.RandomState(0))
    if not family.startswith("mdm"):
        sd = {"model." + k: v for k, v in sd.items()}
    want, got = convert(jax_tc, sd), convert(port_tc, sd)
    _assert_trees_equal(got, want)

    arch = build_torch(cfg, device="cpu")
    before = {k: v.clone() for k, v in arch.model.state_dict().items()}
    path = str(tmp_path / "ref.pth")
    torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in sd.items()}}, path)
    loaded = load_eval_variables(cfg, arch.model, torch_checkpoint=path)
    expect = from_jax_params(want)
    for name, value in arch.model.state_dict().items():
        if name in expect:
            np.testing.assert_array_equal(value.numpy(), expect[name].numpy(), err_msg=name)
        else:  # only the official MDM file leaves tensors out: its CLIP
            assert family == "mdm_official" and name.startswith("clip."), name
            assert torch.equal(value, before[name])
    assert set(loaded) == set(before)


def test_mdm_official_post_process():
    """use_official_ckpt: the sampled motion's first 4 channels x 25, after
    the sampler, as the JAX architecture's post_process."""
    cfg = mdm_cfg(official=True)
    arch_j, arch_t = build_jax(cfg), build_torch(cfg, device="cpu")
    motion = np.random.RandomState(6).randn(2, T, FEATS).astype(np.float32)
    want = np.asarray(arch_j.post_process(jnp.asarray(motion)))
    got = arch_t.post_process(t(motion)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[..., :4], motion[..., :4] * 25.0)
    plain = build_torch(mdm_cfg(), device="cpu")
    np.testing.assert_array_equal(plain.post_process(t(motion)).numpy(), motion)
