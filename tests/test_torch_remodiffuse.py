"""The port's ReMoDiffuse and MoMatMoGen (models/baselines.py, with
models/attentions.py:SemanticsModulatedAttention and its dual) against the
JAX package at tiny widths (2 layers 32 wide, 4 heads, 2 retrievals of 16
frames cut to every 4th), on one seeded flax tree carried over by
``from_jax_params`` with ``strict=True`` (the retrieval encoder grafted in,
as ``init_all`` never calls it):

- SemanticsModulatedAttention and DualSemanticsModulatedAttention at the
  four CFG rows (cond_type 99 / 1 / 10 / 0, the retrieval masked wholly in
  rows 1 and 0) with padded motion and retrieved frames, one retrieved
  motion wholly padded (its keys at -2e6 where the retrieval is off), the
  attention through K5's plain version against JAX's jnp softmaxes;
- ``RetrievalDatabase.retrieve`` / ``gather`` on a fabricated bank with a
  tie, the picks exactly the JAX package's;
- ``encode_retrieval``, the four-way CFG test forward on both sides of
  t = 100, ``scale_func``'s coin over all 1000 timesteps (exactly), and
  ``MotionDiffusion.sample(extra_model_kwargs={"re_dict": ...})`` under DDIM
  with ``start_x`` on the JAX run's draws;
- MoMatMoGen's test forward;
- ``convert_remodiffuse`` against the JAX converter on fabricated reference
  state dicts (both families), exactly, and the ``.pth`` through
  ``load_eval_variables``;
- exact f32 only, no training (the JAX package's loss passes no
  retrieval: pinned), and tools/torch_test.py's refusal.

Tolerance: 1e-5 x max(1, max |JAX|) (sums in another order).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import unfreeze

import fabricate_torch as fab
import motioncraft_tpu.models  # noqa: F401  (registers the flax classes)
from motioncraft_tpu.apis.factory import make_text_batch
from motioncraft_tpu.models import attentions as jax_att
from motioncraft_tpu.models.baselines import RetrievalDatabase as JaxDatabase
from motioncraft_tpu.registry import build_architecture as build_jax
from motioncraft_tpu.utils import torch_convert as jax_tc
from motioncraft_tpu_torch.models import attentions as port_att
from motioncraft_tpu_torch.models.baselines import RetrievalDatabase, coin_table
from motioncraft_tpu_torch.registry import build_architecture as build_torch
from motioncraft_tpu_torch.utils import torch_convert as port_tc
from motioncraft_tpu_torch.utils.checkpoint import load_eval_variables
from motioncraft_tpu_torch.utils.convert import from_jax_params
from torch_port_util import Replay, assert_close_scaled, jax_sample_draws, seeded_params, t

REL = 1e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, T, FEATS, LAT, H, TE, TXT = 2, 16, 24, 32, 4, 32, 16
R, BANK_T, STRIDE, CLIP_T, STEPS = 2, 16, 4, 5, 5
TR = BANK_T // STRIDE


def model_cfg(dual=False):
    ca = "DualSemanticsModulatedAttention" if dual else "SemanticsModulatedAttention"
    return dict(
        type="MoMatMoGenTransformer" if dual else "ReMoDiffuseTransformer",
        input_feats=FEATS, max_seq_len=T, latent_dim=LAT, time_embed_dim=TE, num_layers=2,
        ca_block_cfg=dict(type=ca, latent_dim=LAT, text_latent_dim=TXT, num_heads=H,
                          dropout=0, time_embed_dim=TE),
        ffn_cfg=dict(latent_dim=LAT, ffn_dim=48, dropout=0, time_embed_dim=TE),
        text_encoder=dict(pretrained_model="clip", latent_dim=TXT, num_layers=1, num_heads=4,
                          ff_size=32, dropout=0, use_text_proj=False, clip_width=32,
                          clip_layers=1),
        retrieval_cfg=dict(num_retrieval=R, topk=R, latent_dim=LAT, output_dim=LAT,
                           num_layers=1, num_motion_layers=2, kinematic_coef=0.1,
                           max_seq_len=BANK_T, num_heads=H, ff_size=32, stride=STRIDE,
                           sa_block_cfg=dict(type="EfficientSelfAttention", latent_dim=LAT,
                                             num_heads=H, dropout=0),
                           ffn_cfg=dict(latent_dim=LAT, ffn_dim=48, dropout=0)),
        scale_func_cfg=dict(coarse_scale=6.5, both_coef=0.52351, text_coef=-0.28419,
                            retr_coef=2.39872))


def arch_cfg(dual=False):
    diff = dict(beta_scheduler="linear", diffusion_steps=1000, model_mean_type="start_x",
                model_var_type="fixed_large")
    return dict(type="MotionDiffusion", model=model_cfg(dual),
                loss_recon=dict(type="MSELoss", loss_weight=1, reduction="none"),
                diffusion_train=diff, diffusion_test=dict(diff, respace=str(STEPS)),
                inference_type="ddim", loss_reduction="frame")


def _batch(dual=False):
    return make_text_batch(["a person walks forward", "someone jumps high"], max_seq_len=T,
                           input_feats=FEATS * (2 if dual else 1),
                           lengths=np.array([[T], [11]], np.int32))


def _retrieved(seed=0):
    """Gathered retrieval rows for B x R: motions, frame masks (one
    retrieved motion wholly padded), CLIP token features."""
    rs = np.random.RandomState(seed)
    motions = rs.randn(B * R, BANK_T, FEATS).astype(np.float32)
    lengths = np.array([BANK_T, 9, 0, 13])
    mask = (np.arange(BANK_T)[None] < lengths[:, None]).astype(np.float32)
    return motions, mask, rs.randn(B * R, CLIP_T, LAT).astype(np.float32)


def _seeded(dual=False):
    """(JAX arch, its seeded params, the port's arch): the flax tree of
    ``init_all`` with the separately initialised retrieval encoder
    grafted in."""
    arch_j = build_jax(arch_cfg(dual))
    model = arch_j.model
    retrieved = _retrieved()
    re_init = unfreeze(model.init(jax.random.PRNGKey(1), *retrieved, R,
                                  method="encode_retrieval"))
    re_dict = model.apply(re_init, *retrieved, R, method="encode_retrieval")
    batch = _batch(dual)
    variables = unfreeze(model.init(
        jax.random.PRNGKey(0), batch["motion"], np.zeros((B,), np.int32),
        motion_mask=batch["motion_mask"], motion_length=batch["motion_length"],
        text_ids=batch["text_ids"], re_dict=re_dict, method="init_all"))
    variables["params"]["retrieval_encoder"] = re_init["params"]["retrieval_encoder"]
    params = seeded_params(jax.tree_util.tree_map(np.asarray, variables["params"]), 2)
    arch_t = build_torch(arch_cfg(dual), device="cpu")
    arch_t.model.load_state_dict(from_jax_params(params), strict=True)
    return arch_j, params, arch_t


@pytest.fixture(scope="module")
def remo():
    return _seeded()


@pytest.fixture(scope="module")
def momat():
    return _seeded(dual=True)


def _v(params):
    return {"params": jax.tree_util.tree_map(jnp.asarray, params)}


def _re_dicts(arch_j, params, arch_t):
    retrieved = _retrieved()
    want = jax.tree_util.tree_map(np.asarray, arch_j.model.apply(
        _v(params), *retrieved, R, method="encode_retrieval"))
    with torch.no_grad():
        got = arch_t.model.encode_retrieval(*(t(a) for a in retrieved), R)
    return want, got


# ------------------------------------------------------------ attention
def _sma_inputs(dual, seed=4):
    rs = np.random.RandomState(seed)
    n = 4  # the four CFG rows
    x = rs.randn(n, T, LAT * (2 if dual else 1)).astype(np.float32)
    xf = rs.randn(n, 7, TXT).astype(np.float32)
    emb = rs.randn(n, TE).astype(np.float32)
    mask = (np.arange(T)[None] < np.array([[T], [12], [T], [9]])).astype(np.float32)[..., None]
    cond = np.array([99, 1, 10, 0], np.int32).reshape(n, 1, 1)
    re_mask = np.ones((n, R, TR), np.float32)
    re_mask[1, 0, 2:] = 0
    re_mask[2, 1] = 0  # a wholly padded retrieved motion in a retrieval-on row
    re_mask[3, 1] = 0  # and in a row with the retrieval off: keys at -2e6
    re_dict = {"re_motion": rs.randn(n, R, TR, LAT).astype(np.float32),
               "re_text": rs.randn(n, R, 1, LAT).astype(np.float32), "re_mask": re_mask}
    return x, xf, emb, mask, cond, re_dict


@pytest.mark.parametrize("dual", [False, True], ids=["single", "dual"])
def test_semantics_modulated_attention(dual):
    x, xf, emb, mask, cond, re_dict = _sma_inputs(dual)
    flax_cls = (jax_att.DualSemanticsModulatedAttention if dual
                else jax_att.SemanticsModulatedAttention)
    port_cls = (port_att.DualSemanticsModulatedAttention if dual
                else port_att.SemanticsModulatedAttention)
    flax_mod = flax_cls(LAT, TXT, H, 0.0, TE)
    kw = dict(xf=xf, emb=emb, src_mask=mask, cond_type=cond, re_dict=re_dict)
    variables = flax_mod.init(jax.random.PRNGKey(0), x, **kw)
    params = seeded_params(jax.tree_util.tree_map(np.asarray, variables["params"]), 3)
    port = port_cls(LAT, TXT, H, 0.0, TE)
    port.load_state_dict(from_jax_params(params), strict=True)
    want = np.asarray(jax.jit(lambda p: flax_mod.apply({"params": p}, x, **kw))(params))
    with torch.no_grad():
        got = port(t(x), xf=t(xf), emb=t(emb), src_mask=t(mask), cond_type=t(cond),
                   re_dict={k: t(v) for k, v in re_dict.items()}).numpy()
    assert np.abs(want - x).max() > 1e-2  # the attention adds something
    assert_close_scaled(got, want, REL, f"SMA dual={dual}")


# -------------------------------------------------------------- database
def test_retrieval_database_picks_as_jax(tmp_path):
    """Cosine x kinematic ranking with two bank entries tied (the same text
    feature and length), the cache by caption, a training query skipping
    its own length, and gather."""
    rs = np.random.RandomState(3)
    n, d = 20, 8
    text = rs.randn(n, d).astype(np.float32)
    lengths = rs.randint(4, BANK_T + 1, size=n)
    text[7], lengths[7] = text[3], lengths[3]
    bank = dict(text_features=text, captions=np.array([f"cap {i}" for i in range(n)]),
                motions=rs.randn(n, BANK_T, FEATS).astype(np.float32), m_lengths=lengths,
                clip_seq_features=rs.randn(n, CLIP_T, LAT).astype(np.float32))
    np.savez(tmp_path / "bank.npz", **bank)
    cfg = dict(num_retrieval=3, topk=3, retrieval_file=str(tmp_path / "bank.npz"))
    port, jax_db = RetrievalDatabase(**cfg), JaxDatabase(**cfg)
    query = text[3] + 0.05 * rs.randn(d).astype(np.float32)
    picks = port.retrieve(query, int(lengths[3]), "a query")
    assert picks == jax_db.retrieve(query, int(lengths[3]), "a query")
    assert {3, 7} <= set(picks)  # the tie is picked, in JAX's order
    assert port.retrieve(-query, 5, "a query") == picks  # cached by caption
    for length in (5, int(lengths[0])):
        assert (port.retrieve(query, length, f"train {length}", training=True)
                == jax_db.retrieve(query, length, f"train {length}", training=True))
    for g, w in zip(port.gather(picks, 1), jax_db.gather(picks, 1)):
        np.testing.assert_array_equal(g, w)


# ------------------------------------------------------------ the model
def test_encode_retrieval(remo):
    want, got = _re_dicts(*remo)
    assert set(got) == {"re_motion", "re_text", "re_mask"}
    assert got["re_motion"].shape == (B, R, TR, LAT) and got["re_text"].shape == (B, R, 1, LAT)
    np.testing.assert_array_equal(got["re_mask"].numpy(), want["re_mask"])
    for k in ("re_motion", "re_text"):
        assert_close_scaled(got[k].numpy(), want[k], REL, k)


def test_coin_table_is_jax_s_over_every_timestep(remo):
    """scale_func past t = 100 flips JAX's bernoulli(fold_in(PRNGKey(0), t));
    the port's table holds that coin for every t, exactly, and the four
    weights follow it (the same zeros; the values to the last ulps, as XLA
    fuses w's arithmetic)."""
    arch_j, params, arch_t = remo
    ts = np.arange(1000, dtype=np.int32)
    want = np.stack([np.asarray(c) for c in jax.jit(jax.vmap(
        lambda t_: arch_j.model.apply(_v(params), t_, method="scale_func")))(ts)])
    coins = np.asarray(jax.jit(jax.vmap(lambda t_: jax.random.bernoulli(
        jax.random.fold_in(jax.random.PRNGKey(0), t_))))(ts))
    np.testing.assert_array_equal(coin_table(), coins)
    with torch.no_grad():
        got = np.stack([np.stack([c.numpy() for c in arch_t.model.scale_func(
            torch.tensor(int(i)))]) for i in ts], axis=1)
    np.testing.assert_array_equal(got == 0, want == 0)
    assert_close_scaled(got, want, REL, "scale_func")
    late = ts > 100
    assert ((want[0] == 0) == ~coins)[late].all() and len(set(coins[late])) == 2


@pytest.mark.parametrize("step", [999, 640, 77], ids=["t999", "t640", "t77"])
def test_four_way_cfg_forward(remo, step):
    """Four passes (99 / 1 / 10 / 0) mixed by scale_func: late steps on
    each side of the coin, and an early one at the config's weights."""
    arch_j, params, arch_t = remo
    re_j, re_t = _re_dicts(arch_j, params, arch_t)
    batch = _batch()
    x = np.random.RandomState(5).randn(B, T, FEATS).astype(np.float32)
    ts = np.full((B,), step, np.int32)
    xf = arch_j.encode_text(_v(params), batch["text_ids"])
    want = np.asarray(jax.jit(lambda v: arch_j.model.apply(
        v, x, ts, motion_mask=batch["motion_mask"], motion_length=batch["motion_length"],
        xf_out=xf, re_dict=re_j, mode="test"))(_v(params)))
    with torch.no_grad():
        got = arch_t.model(t(x), t(ts, torch.long), motion_mask=t(batch["motion_mask"]),
                           motion_length=t(batch["motion_length"]),
                           xf_out=arch_t.encode_text(batch["text_ids"]), re_dict=re_t).numpy()
    assert np.abs(want).max() > 1e-2
    assert_close_scaled(got, want, REL, f"ReMoDiffuse forward t={step}")


def test_sample_ddim_with_the_retrieval(remo):
    """The whole DDIM chain (start_x) through MotionDiffusion.sample, the
    encoded retrieval reaching every denoiser call through
    ``extra_model_kwargs``, on the JAX run's draws."""
    arch_j, params, arch_t = remo
    re_j, re_t = _re_dicts(arch_j, params, arch_t)
    batch = _batch()
    rng = jax.random.PRNGKey(6)
    want = np.asarray(jax.jit(lambda v, b, r, rd: arch_j.sample(
        v, b, r, extra_model_kwargs={"re_dict": rd}))(_v(params), batch, rng, re_j))
    draws = Replay(jax_sample_draws(STEPS, None, rng, batch["motion"].shape))
    got = arch_t.sample(batch, randn=draws, extra_model_kwargs={"re_dict": re_t}).numpy()
    assert draws.done() and np.isfinite(got).all() and np.abs(want).max() > 1e-2
    assert_close_scaled(got, want, REL, "ReMoDiffuse DDIM sample")


def test_momatmogen_forward(momat):
    """Two persons through one joint embedding, DualSemanticsModulated-
    Attention and DualFFN, the four-way CFG mix."""
    arch_j, params, arch_t = momat
    re_j, re_t = _re_dicts(arch_j, params, arch_t)
    batch = _batch(dual=True)
    x = np.random.RandomState(7).randn(B, T, 2 * FEATS).astype(np.float32)
    ts = np.array([640, 640], np.int32)
    xf = arch_j.encode_text(_v(params), batch["text_ids"])
    want = np.asarray(jax.jit(lambda v: arch_j.model.apply(
        v, x, ts, motion_mask=batch["motion_mask"], motion_length=batch["motion_length"],
        xf_out=xf, re_dict=re_j, mode="test"))(_v(params)))
    with torch.no_grad():
        got = arch_t.model(t(x), t(ts, torch.long), motion_mask=t(batch["motion_mask"]),
                           xf_out=arch_t.encode_text(batch["text_ids"]), re_dict=re_t).numpy()
    assert got.shape == (B, T, 2 * FEATS) and np.abs(want).max() > 1e-2
    assert_close_scaled(got, want, REL, "MoMatMoGen forward")


@pytest.mark.parametrize("family", ["remo", "momat"], ids=["remodiffuse", "momatmogen"])
def test_converter_matches_jax_and_loads(family, tmp_path, request):
    """convert_remodiffuse gives the JAX converter's tree on a fabricated
    reference state dict ('model.'-prefixed), exactly; the .pth loads
    through load_eval_variables with strict=True."""
    _, params, _ = request.getfixturevalue(family)
    dual = family == "momat"
    sd = fab.remodiffuse_sd(params, np.random.RandomState(0), 2, 2, 1, 1, 1, dual=dual,
                            prefix="model.")
    want = jax_tc.convert_remodiffuse(sd, 2, 2, 1, 1, 1)
    got = port_tc.convert_remodiffuse(sd, 2, 2, 1, 1, 1)
    assert (jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want))
    for g, w in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(g, w)
    path = str(tmp_path / "remodiffuse.pth")
    torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in sd.items()}}, path)
    cfg = arch_cfg(dual)
    model = build_torch(cfg, device="cpu").model
    loaded = load_eval_variables(cfg, model, torch_checkpoint=path)
    expect = from_jax_params(want)
    assert sorted(loaded) == sorted(expect)
    assert all(torch.equal(model.state_dict()[k], expect[k]) for k in expect)


def test_exact_f32_only_and_no_training(remo):
    from motioncraft_tpu_torch.apis import int8_quantize_
    from motioncraft_tpu_torch.diffusion import StepCacheConfig

    _, _, arch_t = remo
    batch = _batch()
    with pytest.raises(ValueError, match="K5's bf16 instantiation"):
        int8_quantize_(arch_t)
    with pytest.raises(ValueError, match="step caching"):
        arch_t.sample(batch, step_cache=StepCacheConfig(reuse_every=2))
    arch_t.train()
    try:
        with pytest.raises(NotImplementedError,
                           match="ROADMAP queue 3: ReMoDiffuse / MoMatMoGen training"):
            arch_t.loss(batch, generator=torch.Generator().manual_seed(0))
    finally:
        arch_t.eval()


@pytest.mark.parametrize("dual", [False, True], ids=["remodiffuse", "momatmogen"])
def test_jax_loss_passes_no_retrieval(dual):
    """The JAX package's MotionDiffusion.loss applies the model without a
    re_dict, which its semantics-modulated attention indexes: its training
    stops with a TypeError, so the port refuses the two families."""
    arch_j, params, _ = _seeded(dual)
    with pytest.raises(TypeError, match="'NoneType' object is not subscriptable"):
        arch_j.loss({"params": params}, _batch(dual), jax.random.PRNGKey(0))


def test_torch_test_cli_refuses_remodiffuse(monkeypatch):
    """Neither package's T2M evaluation CLI builds a retrieval: the port's
    says so and exits."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "torch_test", os.path.join(REPO, "tools", "torch_test.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    monkeypatch.chdir(REPO)
    with pytest.raises(SystemExit, match="retrieval"):
        tool.main(["configs/remodiffuse/remodiffuse_t2m.py", "out", "--device", "cpu"])
    sys.modules.pop("torch_test", None)
