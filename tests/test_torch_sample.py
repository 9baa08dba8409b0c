"""The whole ported slice against the JAX package on the tiny T2M config:
text encoding, one CFG test forward, and the full DDIM sampling loop, on the
same weights (a seeded flax tree carried over by ``from_jax_params``), the
same text ids and the JAX run's initial noise.  Tolerance: 1e-4 x max(1,
max |JAX output|), as the torch re-statement parity test of the JAX package
uses; the sums differ in order and erf comes from different libraries."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import motioncraft_tpu.models  # noqa: F401  (registers the flax classes)
from motioncraft_tpu.apis.factory import make_text_batch, tiny_t2m_cfg
from motioncraft_tpu.registry import build_architecture as build_jax
from motioncraft_tpu_torch.apis import single_device_test
from motioncraft_tpu_torch.apis.factory import tiny_t2m_cfg as torch_tiny_cfg
from motioncraft_tpu_torch.registry import build_architecture as build_torch
from motioncraft_tpu_torch.utils.convert import from_jax_params
from torch_port_util import assert_close_scaled, seeded_params, t

REL = 1e-4


@pytest.fixture(scope="module")
def pair():
    cfg = tiny_t2m_cfg()
    arch_j = build_jax(cfg)
    batch = make_text_batch(["a person walks forward", "someone waves hello"],
                            max_seq_len=16, lengths=np.array([[16], [11]], np.int32))
    variables = arch_j.init(jax.random.PRNGKey(0), batch)
    params = seeded_params(jax.tree_util.tree_map(np.asarray, variables["params"]), 1)
    variables = {"params": jax.tree_util.tree_map(jnp.asarray, params)}
    arch_t = build_torch(torch_tiny_cfg(), device="cpu")
    arch_t.model.load_state_dict(from_jax_params(params), strict=True)
    return arch_j, variables, arch_t, batch


def test_tiny_config_is_the_jax_tiny_config():
    assert torch_tiny_cfg() == tiny_t2m_cfg()


def test_ddim_loop_with_an_analytic_model():
    """The flagship's DDIM-50 schedule: tables, original-scale timesteps and
    the whole loop, with a model both sides compute exactly alike."""
    from motioncraft_tpu.diffusion import build_diffusion as jax_diffusion
    from motioncraft_tpu.diffusion import ddim_sample_loop as jax_loop
    from motioncraft_tpu_torch.diffusion import build_diffusion, ddim_sample_loop

    cfg = tiny_t2m_cfg()["diffusion_test"] | {"respace": "15,15,8,6,6"}
    dj, dt = jax_diffusion(cfg), build_diffusion(cfg)
    assert dt.num_timesteps == dj.num_timesteps == 50
    np.testing.assert_array_equal(dt.timestep_map.numpy(), np.asarray(dj.timestep_map))
    for name in ("alphas_cumprod", "alphas_cumprod_prev", "sqrt_recip_alphas_cumprod",
                 "sqrt_recipm1_alphas_cumprod", "posterior_mean_coef1",
                 "fixed_large_variance"):
        np.testing.assert_array_equal(getattr(dt, name).numpy(), np.asarray(getattr(dj, name)))
    noise = np.random.RandomState(0).randn(2, 8, 5).astype(np.float32)
    seen = []

    def model_t(x, ts):
        seen.append(int(ts[0]))
        return torch.tanh(x) * 0.5

    want = np.asarray(jax_loop(dj, lambda x, ts: jnp.tanh(x) * 0.5, jnp.asarray(noise),
                               jax.random.PRNGKey(0)).sample)
    got = ddim_sample_loop(dt, model_t, t(noise)).sample.numpy()
    assert seen == list(np.asarray(dj.timestep_map)[::-1])
    assert_close_scaled(got, want, 1e-5, "ddim loop")


def test_encode_text(pair):
    arch_j, variables, arch_t, batch = pair
    want = np.asarray(arch_j.encode_text(variables, batch["text_ids"]))
    got = arch_t.encode_text(batch["text_ids"]).numpy()
    assert_close_scaled(got, want, REL, "encode_text")


def test_forward_test(pair):
    arch_j, variables, arch_t, batch = pair
    rng = np.random.RandomState(3)
    x = rng.randn(*batch["motion"].shape).astype(np.float32)
    ts = np.full((2,), 499, np.int32)
    xf = arch_j.encode_text(variables, batch["text_ids"])
    tf = arch_j.model.apply(variables, xf, method="precompute_text_feats")
    want = np.asarray(jax.jit(lambda v, x_, t_, m, ml, xf_, tf_: arch_j.model.apply(
        v, x_, t_, motion_mask=m, motion_length=ml, xf_out=xf_, text_feats=tf_,
        mode="test"))(variables, x, ts, batch["motion_mask"], batch["motion_length"],
                      xf, tf))
    with torch.no_grad():
        xf_t = arch_t.encode_text(batch["text_ids"])
        got = arch_t.model(t(x), t(ts, torch.long), motion_mask=t(batch["motion_mask"]),
                           motion_length=t(batch["motion_length"]), xf_out=xf_t,
                           text_feats=arch_t.model.precompute_text_feats(xf_t)).numpy()
    assert np.abs(want).max() > 1e-3  # the comparison is not of zeros
    assert_close_scaled(got, want, REL, "forward_test")


def test_sample_ddim(pair):
    arch_j, variables, arch_t, batch = pair
    rng = jax.random.PRNGKey(5)
    want = np.asarray(jax.jit(lambda v, b, r: arch_j.sample(v, b, r))(variables, batch, rng))
    r_noise, _ = jax.random.split(rng)
    noise = np.asarray(jax.random.normal(r_noise, batch["motion"].shape, jnp.float32))
    got = arch_t.sample(batch, noise=t(noise)).numpy()
    assert arch_t.diffusion_test.num_timesteps == 4
    assert_close_scaled(got, want, REL, "sample")


def test_sample_gt_returns_the_motion(pair):
    _, _, arch_t, batch = pair
    motion = np.random.RandomState(0).randn(*batch["motion"].shape).astype(np.float32)
    out = arch_t.sample(dict(batch, motion=motion), inference_type="gt")
    np.testing.assert_array_equal(out.numpy(), motion)
    gt = build_torch(dict(torch_tiny_cfg(), inference_type="gt"), device="cpu")
    assert gt.model is None
    np.testing.assert_array_equal(gt.sample(dict(batch, motion=motion)).numpy(), motion)


def test_single_device_test(pair):
    _, _, arch_t, batch = pair
    lines = []
    res = single_device_test(arch_t, [batch, batch], seed=0, device="cpu",
                             logger=lines.append)
    assert len(res) == 4 and len(lines) == 2
    for item in res:
        assert item["pred_motion"].shape == (16, 322)
        assert np.isfinite(item["pred_motion"]).all()
    # one generator across batches: the two batches get different noise
    assert not np.allclose(res[0]["pred_motion"], res[2]["pred_motion"])
    again = single_device_test(arch_t, [batch], seed=0, device="cpu", limit=1)
    np.testing.assert_array_equal(again[0]["pred_motion"], res[0]["pred_motion"])


def _skew_gates(node):
    """Every cosine gate of a params tree leans to expert 0: the projector's
    bias dominates its input and points along expert 0's column, so every
    token picks expert 0 first and that expert overflows its capacity."""
    for key, val in node.items():
        if key == "gate":
            d = val["cosine_projector"]["bias"].shape[0]
            direction = np.random.RandomState(9).randn(d).astype(np.float32)
            val["cosine_projector"]["bias"] = 20.0 * direction
            val["sim_matrix"][:, 0] = direction
        elif isinstance(val, dict):
            _skew_gates(val)


def _overflows(logits, k):
    """Whether the largest expert load of one gate call exceeds the MoE's
    capacity (ranked by logit, the lower index first on equal logits)."""
    logits = np.asarray(logits)
    N, E = logits.shape
    top = np.argsort(-logits, axis=1, kind="stable")[:, :k]
    cap = max(1, min(k * int(1.5 * ((N + E - 1) // E)), N))
    return np.bincount(top.reshape(-1), minlength=E).max() > cap


@pytest.mark.parametrize("dedup,hoist", [(True, True), (True, False), (False, True),
                                         (False, False)])
def test_cfg_switches_with_capacity_drops(dedup, hoist):
    """cfg_layer0_dedup / text_hoist: each combination of the port's
    forward_test equals JAX's, with every MoE call overflowing its capacity
    on both sides (drops make dedup on and off route differently)."""
    from flax.core import unfreeze
    from motioncraft_tpu.models.moe import CosineTopGate as JaxGate
    from motioncraft_tpu_torch.models.moe import CosineTopGate

    flags = dict(cfg_layer0_dedup=dedup, text_hoist=hoist)
    cfg = tiny_t2m_cfg()
    cfg["model"] = dict(cfg["model"], **flags)
    arch_j = build_jax(cfg)
    batch = make_text_batch(["a person walks forward", "someone waves hello"],
                            max_seq_len=16, lengths=np.array([[16], [11]], np.int32))
    variables = arch_j.init(jax.random.PRNGKey(0), batch)
    params = seeded_params(jax.tree_util.tree_map(np.asarray, unfreeze(variables["params"])), 2)
    _skew_gates(params)
    variables = {"params": jax.tree_util.tree_map(jnp.asarray, params)}
    tcfg = torch_tiny_cfg()
    tcfg["model"] = dict(tcfg["model"], **flags)
    arch_t = build_torch(tcfg, device="cpu")
    arch_t.model.load_state_dict(from_jax_params(params), strict=True)

    rng = np.random.RandomState(4)
    x = rng.randn(*batch["motion"].shape).astype(np.float32)
    ts = np.full((2,), 499, np.int32)
    capture = dict(capture_intermediates=lambda m, _: isinstance(m, JaxGate),
                   mutable=["intermediates"])
    xf = arch_j.encode_text(variables, batch["text_ids"])
    tf = arch_j.model.apply(variables, xf, method="precompute_text_feats")
    run = jax.jit(lambda v, tf_: arch_j.model.apply(
        v, x, ts, motion_mask=batch["motion_mask"], motion_length=batch["motion_length"],
        xf_out=xf, text_feats=tf_, mode="test", **capture))
    want, st = run(variables, tf)
    if hoist:  # the hoisted text MoE ran outside; in the layers its gate sees the same input
        _, st = run(variables, None)
    jax_logits = [v for path, v in jax.tree_util.tree_leaves_with_path(st)
                  if "__call__" in jax.tree_util.keystr(path)]
    assert (tf is None) == (not hoist)

    torch_logits = []
    hooks = [m.register_forward_hook(lambda mod, i, o: torch_logits.append(o.numpy()))
             for m in arch_t.modules() if isinstance(m, CosineTopGate)]
    with torch.no_grad():
        xf_t = arch_t.encode_text(batch["text_ids"])
        tf_t = arch_t.model.precompute_text_feats(xf_t)
        got = arch_t.model(t(x), t(ts, torch.long), motion_mask=t(batch["motion_mask"]),
                           motion_length=t(batch["motion_length"]), xf_out=xf_t,
                           text_feats=tf_t).numpy()
    for h in hooks:
        h.remove()
    assert (tf_t is None) == (not hoist)
    # per layer: one motion MoE call and one text MoE call
    assert len(torch_logits) == len(jax_logits) == 2 * arch_t.model.num_layers
    assert sorted(lg.shape[0] for lg in torch_logits) == sorted(
        lg.shape[0] for lg in jax_logits)
    assert all(_overflows(lg, 2) for lg in torch_logits + jax_logits)
    assert_close_scaled(got, want, REL, "forward_test")


def test_config_with_both_switches_builds():
    cfg = torch_tiny_cfg()
    cfg["model"] = dict(cfg["model"], cfg_layer0_dedup=False, text_hoist=False)
    model = build_torch(cfg, device="cpu").model
    assert not model.cfg_layer0_dedup and not model.text_hoist


class _Loader(list):
    """An iterable of batches with a loader's batch size."""
    batch_size = 3


def test_single_device_test_pads_the_short_batch(pair):
    """The last short batch is sampled padded to the loader's batch size
    (its last row repeated) and the extra predictions are dropped; GT mode
    is not padded."""
    _, _, arch_t, batch = pair
    full = make_text_batch(["a", "b", "c"], max_seq_len=16,
                           lengths=np.array([[16], [9], [12]], np.int32))
    seen = []
    sample = arch_t.sample

    def spy(b, **kw):
        seen.append({k: np.asarray(v) for k, v in b.items()})
        return sample(b, **kw)

    arch_t.sample = spy
    try:
        res = single_device_test(arch_t, _Loader([full, batch]), seed=0, device="cpu")
    finally:
        del arch_t.sample
    assert [s["motion"].shape[0] for s in seen] == [3, 3] and len(res) == 5
    short = seen[1]
    for k, v in batch.items():
        np.testing.assert_array_equal(short[k][:2], v)
        np.testing.assert_array_equal(short[k][2], v[-1])
    # the kept predictions are those of the padded batch's first rows
    g = torch.Generator().manual_seed(0)
    arch_t.sample(full, generator=g)
    want = arch_t.sample(short, generator=g)[:2].numpy()
    np.testing.assert_array_equal(np.stack([r["pred_motion"] for r in res[3:]]), want)
    gt = build_torch(dict(torch_tiny_cfg(), inference_type="gt"), device="cpu")
    res = single_device_test(gt, _Loader([full, batch]), device="cpu")
    np.testing.assert_array_equal(np.stack([r["pred_motion"] for r in res[3:]]),
                                  batch["motion"])
