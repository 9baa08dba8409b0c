"""The port's int8 inference (ops/quant.py, QLinear, the int8 branches of SFFN
and MoELayer, apis.int8_quantize_) against the JAX package's on the CPU.

- The primitives: ``quantize_weight`` / ``quantize_rows`` give the JAX
  package's int8 bytes and f32 scales exactly (the same f32 arithmetic,
  round half to even); the int32 accumulators of ``qdot`` / ``qeinsum``
  (``int_mm``'s plain int32 product here) equal JAX's int8 ``dot_general``
  / ``einsum`` exactly, and their outputs within 1e-6 x scale.
- ``quantize_`` selects the leaves that ``quantize_variables`` selects (by
  flax path, at the default ``min_elems`` and at 0), on the tiny T2M model,
  a mid-width one where the default threshold splits the leaves, and the
  tiny M2D ControlNet: the JAX tree carried over by ``from_jax_variables``
  loads into the quantized port model with ``strict=True`` and equals its
  own quantization bit for bit.
- Modules in W8A8 and W8 on the same inputs and weights: QLinear against
  QDense, SFFN, MoELayer within 1e-5 x max(1, max |JAX|) (the f32 sums
  after the int32 products differ in order; MoE routing by the same
  logits).
- The tiny model, the MoE gates pinned to the JAX run's picks: a W8
  forward and ``sample`` within REL = 1e-4 (as tests/test_torch_sample.py).
  A W8A8 forward within W8A8_REL = 2e-3 x scale: an activation whose f32
  value differs from JAX's in the last bit (sums in another order
  upstream) can land on the other side of a rounding boundary of its int8
  code, which moves that row by one code (1/127 of its largest entry) in
  the next product; the codes that differ are counted (at most one code
  apart, at most 1e-3 of them).  Over a whole DDIM chain those steps add
  up: a one-ulp change of the initial noise alone moves the port's own
  W8A8 sample by up to 3% of its scale (measured and printed by the test),
  so the W8A8 ``sample`` is held to MODEL_REL = 5e-2, the bound of
  tests/test_torch_bf16.py, as is bf16 + int8.  W8 + the step cache within
  REL; under W8A8 the MoE runs no grouped kernel (K1).
- The four CLIs take --int8 / --int8-mode / --step-cache (and torch_test.py
  --step-cache-table) on the tiny configs with --device cpu and stamp
  tools/test.py's keys into metrics.json.
"""

import copy
import functools
import importlib.util
import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import unfreeze

import motioncraft_tpu.models  # noqa: F401  (registers the flax classes)
from motioncraft_tpu.apis.factory import (bf16_cast_variables, flagship_t2m_cfg,
                                          make_text_batch, tiny_t2m_cfg)
from motioncraft_tpu.config import Config as JaxConfig
from motioncraft_tpu.diffusion import StepCacheConfig as JaxStepCache
from motioncraft_tpu.models.blocks import SFFN as JaxSFFN
from motioncraft_tpu.models.blocks import QDense
from motioncraft_tpu.models.moe import MoELayer as JaxMoE
from motioncraft_tpu.ops import quant as jq
from motioncraft_tpu.registry import build_architecture as build_jax
from motioncraft_tpu_torch.apis import bf16_cast_, int8_quantize_
from motioncraft_tpu_torch.apis.factory import flagship_t2m_cfg as torch_flagship_cfg
from motioncraft_tpu_torch.apis.factory import tiny_t2m_cfg as torch_tiny_cfg
from motioncraft_tpu_torch.config import Config
from motioncraft_tpu_torch.diffusion import StepCacheConfig, load_flags
from motioncraft_tpu_torch.models import moe as torch_moe
from motioncraft_tpu_torch.models.blocks import SFFN, QLinear
from motioncraft_tpu_torch.ops import quant
from motioncraft_tpu_torch.ops.moe_ffn import grouped_ffn_plain
from motioncraft_tpu_torch.registry import build_architecture as build_torch
from motioncraft_tpu_torch.utils.checkpoint import load_eval_variables, save_params
from motioncraft_tpu_torch.utils.convert import from_jax_params, from_jax_variables
from test_torch_eval_cli import _evaluator_option, workdir  # noqa: F401  (a fixture)
from test_torch_windowed import make_mwb
from torch_port_util import assert_close_scaled, seeded_params, t

REL = 1e-4
MODULE_REL = 1e-5
W8A8_REL = 2e-3
MODEL_REL = 5e-2
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T2M_CONFIG = os.path.join(REPO, "configs", "tests", "tiny_t2m.py")
M2D_CONFIG = os.path.join(REPO, "configs", "tests", "tiny_m2d.py")
MODES = {"w8a8": False, "w8": True}


def _load(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "tools",
                                                                     name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, unfreeze(tree))


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


# ------------------------------------------------------------- primitives

@pytest.mark.parametrize("shape,axis", [((64, 48), 0), ((48, 64), 1), ((4, 16, 32), 1)])
def test_quantize_weight_matches_jax(shape, axis):
    w = (np.random.RandomState(0).randn(*shape) * 0.2).astype(np.float32)
    w[0] = 0.0  # a zero channel: the 1e-12 floor
    wq_j, s_j = jq.quantize_weight(jnp.asarray(w), axis)
    wq, s = quant.quantize_weight(t(w), axis)
    assert wq.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(wq.numpy(), np.asarray(wq_j))
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_j))
    # the round trip is on the 8-bit grid
    assert np.linalg.norm(wq.numpy() * s.numpy() - w) / np.linalg.norm(w) < 0.006


def test_quantize_rows_matches_jax():
    x = np.random.RandomState(1).randn(5, 9, 96).astype(np.float32)
    x[0, 0] = 0.0
    xq_j, a_j = jq._quantize_rows(jnp.asarray(x))
    xq, a = quant.quantize_rows(t(x))
    np.testing.assert_array_equal(xq.numpy(), np.asarray(xq_j))
    np.testing.assert_array_equal(a.numpy(), np.asarray(a_j))


@pytest.mark.parametrize("m", [1, 2, 17, 45])
def test_qdot_accumulators_are_exact(m):
    rng = np.random.RandomState(2)
    x = rng.randn(m, 96).astype(np.float32)
    w = (rng.randn(96, 32) * 0.1).astype(np.float32)
    wq_j, s_j = jq.quantize_weight(jnp.asarray(w), 0)
    xq_j, _ = jq._quantize_rows(jnp.asarray(x))
    want = np.asarray(jax.lax.dot_general(xq_j, wq_j, (((1,), (0,)), ((), ())),
                                          preferred_element_type=jnp.int32))
    wq, s = quant.quantize_weight(t(w), 0)
    xq, _ = quant.quantize_rows(t(x))
    acc = quant.int_mm(xq, wq)
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.numpy(), want)
    np.testing.assert_array_equal(acc.numpy(), quant.int_mm_plain(xq, wq).numpy())
    assert_close_scaled(quant.qdot(t(x), wq, s).numpy(),
                        np.asarray(jq.qdot(jnp.asarray(x), wq_j, s_j)), 1e-6, "qdot")
    assert np.linalg.norm(quant.qdot(t(x), wq, s).numpy() - x @ w) < 0.02 * np.linalg.norm(
        x @ w)


@pytest.mark.parametrize("eq,xs,ws", [("bthd,hdf->bthf", (2, 7, 4, 16), (4, 16, 32)),
                                      ("bthf,hfd->bthd", (2, 7, 4, 32), (4, 32, 16)),
                                      ("ecd,edf->ecf", (4, 9, 16), (4, 16, 32)),
                                      ("ecf,efd->ecd", (4, 9, 32), (4, 32, 16))])
def test_qeinsum_matches_jax(eq, xs, ws):
    rng = np.random.RandomState(3)
    x, w = rng.randn(*xs).astype(np.float32), (rng.randn(*ws) * 0.2).astype(np.float32)
    wq_j, s_j = jq.quantize_weight(jnp.asarray(w), 1)
    xq_j, _ = jq._quantize_rows(jnp.asarray(x))
    acc_j = np.asarray(jnp.einsum(eq, xq_j, wq_j, preferred_element_type=jnp.int32))
    wq, s = quant.quantize_weight(t(w), 1)
    if eq.startswith("bth"):  # SFFN's scales [H, 1, out] -> [H, out]
        s_j, s = s_j.squeeze(1), s.squeeze(1)
    xq, _ = quant.quantize_rows(t(x))
    axis = quant._QEINSUM_GROUP_AXIS[eq]
    acc = torch.stack([quant.int_mm(xq.select(axis, g).reshape(-1, xs[-1]), wq[g])
                       .reshape(*xq.select(axis, 0).shape[:-1], -1)
                       for g in range(ws[0])], dim=axis % len(xs))
    np.testing.assert_array_equal(acc.numpy(), acc_j)
    assert_close_scaled(quant.qeinsum(eq, t(x), wq, s).numpy(),
                        np.asarray(jq.qeinsum(eq, jnp.asarray(x), wq_j, s_j)), 1e-6, eq)
    with pytest.raises(ValueError, match="layout"):
        quant.qeinsum("nd,df->nf", t(x), wq, s)


# ---------------------------------------------------------------- modules

@pytest.mark.parametrize("mode", sorted(MODES))
def test_qlinear_matches_qdense(mode):
    x = np.random.RandomState(4).randn(6, 80).astype(np.float32)
    q = QDense(56)
    v = _np(q.init(jax.random.PRNGKey(5), jnp.asarray(x)))
    wq, s = jq.quantize_weight(jnp.asarray(v["params"]["kernel"]), 0)
    vq = {"params": {"kernel": wq, "bias": v["params"]["bias"]},
          "quant": {"kernel_wscale" if MODES[mode] else "kernel_scale": s}}
    want = np.asarray(q.apply(vq, jnp.asarray(x)))
    lin = torch.nn.Linear(80, 56)
    lin.load_state_dict(from_jax_params(v["params"]))
    ql = QLinear.from_linear(lin, MODES[mode])
    sd = from_jax_variables(vq)
    assert set(sd) == set(ql.state_dict())
    for k, val in ql.state_dict().items():
        assert torch.equal(val, sd[k]), k
    got = ql(t(x))
    assert got.dtype == torch.float32
    assert_close_scaled(got.detach().numpy(), want, MODULE_REL, f"QLinear {mode}")
    assert ql(t(x).to(torch.bfloat16)).dtype == torch.bfloat16  # bf16 in, bf16 out
    if mode == "w8":  # W8 is the float product on the dequantized weight, bit for bit
        w_deq = ql.weight.float() * ql.kernel_wscale.reshape(-1, 1)
        assert torch.equal(got, torch.nn.functional.linear(t(x), w_deq) + ql.bias)


def test_qlinear_weight_only_beats_w8a8():
    x = t(np.random.RandomState(22).randn(16, 96).astype(np.float32))
    lin = torch.nn.Linear(96, 64, bias=False)
    y = lin(x).detach()
    err = {m: float((QLinear.from_linear(lin, w8)(x) - y).norm() / y.norm())
           for m, w8 in MODES.items()}
    assert err["w8"] < 0.01 and err["w8"] <= err["w8a8"] + 1e-6


@pytest.mark.parametrize("mode", sorted(MODES))
def test_sffn_int8_matches_jax(mode):
    B, T, H, d, f = 2, 7, 4, 16, 32
    rng = np.random.RandomState(6)
    x, emb = rng.randn(B, T, H * d).astype(np.float32), rng.randn(B, 64).astype(np.float32)
    mod = JaxSFFN(latent_dim=d, ffn_dim=f, num_heads=H, time_embed_dim=64)
    v = _np(mod.init(jax.random.PRNGKey(8), jnp.asarray(x), jnp.asarray(emb)))
    v["params"] = seeded_params(v["params"], 2)
    pick = lambda p, leaf: p.endswith(("/w1", "/w2"))  # noqa: E731
    vq = jq.quantize_variables(_jnp(v), min_elems=0, predicate=pick,
                               weight_only=MODES[mode])
    assert jq.count_quantized(vq)[0] == 2
    want = np.asarray(mod.apply(vq, jnp.asarray(x), jnp.asarray(emb)))
    port = SFFN(d, f, H, time_embed_dim=64).eval()
    port.load_state_dict(from_jax_params(v["params"]))
    assert quant.quantize_(port, min_elems=0, predicate=pick, weight_only=MODES[mode]) == 2
    port.load_state_dict(from_jax_variables(_np(vq)), strict=True)
    with torch.no_grad():
        got = port(t(x), t(emb)).numpy()
    assert_close_scaled(got, want, MODULE_REL, f"SFFN {mode}")


@pytest.mark.parametrize("mode", sorted(MODES))
def test_moe_layer_int8_matches_jax(mode, monkeypatch):
    """The MoE layer in W8A8 (K4's route filling the slot buffer, the int8
    expert pair) and W8 (dequantized weights through the grouped FFN)."""
    N, D, F, E = 64, 32, 64, 4
    x = np.random.RandomState(9).randn(N, D).astype(np.float32)
    mod = JaxMoE(num_experts=E, topk=2, model_dim=D, hidden_dim=F, gate_type="cosine_top",
                 dispatch_mode="slots")
    v = _np(mod.init(jax.random.PRNGKey(10), jnp.asarray(x)))
    v["params"] = seeded_params(v["params"], 3)
    pick = lambda p, leaf: p.endswith(("expert_w1", "expert_w2"))  # noqa: E731
    vq = jq.quantize_variables(_jnp(v), min_elems=0, predicate=pick,
                               weight_only=MODES[mode])
    want = np.asarray(mod.apply(vq, jnp.asarray(x))[0])
    port = torch_moe.MoELayer(E, 2, D, F).eval()
    port.load_state_dict(from_jax_params(v["params"]))
    quant.quantize_(port, min_elems=0, predicate=pick, weight_only=MODES[mode])
    port.load_state_dict(from_jax_variables(_np(vq)), strict=True)
    grouped = []
    monkeypatch.setattr(torch_moe, "grouped_ffn",
                        lambda *a: grouped.append(1) or grouped_ffn_plain(*a))
    with torch.no_grad():
        got = port(t(x)).numpy()
    assert len(grouped) == (0 if mode == "w8a8" else 1)
    assert_close_scaled(got, want, MODULE_REL, f"MoELayer {mode}")


def test_moe_w8a8_drops_like_the_slot_path():
    """Capacity drops under W8A8: every token leans to expert 0, which
    overflows; the dropped choices get no slot and gate 0, as in JAX."""
    N, D, F, E = 48, 16, 32, 4
    rng = np.random.RandomState(12)
    x = rng.randn(N, D).astype(np.float32)
    mod = JaxMoE(num_experts=E, topk=2, model_dim=D, hidden_dim=F, gate_type="cosine_top",
                 dispatch_mode="slots")
    v = _np(mod.init(jax.random.PRNGKey(13), jnp.asarray(x)))
    v["params"] = seeded_params(v["params"], 4)
    g = v["params"]["gate"]
    direction = rng.randn(g["cosine_projector"]["bias"].shape[0]).astype(np.float32)
    g["cosine_projector"]["bias"] = 20 * direction
    g["sim_matrix"][:, 0] = direction
    vq = jq.quantize_variables(_jnp(v), min_elems=0)
    want = np.asarray(mod.apply(vq, jnp.asarray(x))[0])
    port = torch_moe.MoELayer(E, 2, D, F).eval()
    port.load_state_dict(from_jax_params(v["params"]))
    quant.quantize_(port, min_elems=0)
    port.load_state_dict(from_jax_variables(_np(vq)), strict=True)
    with torch.no_grad():
        route = torch_moe.moe_route(port.gate(t(x)), 2, port.capacity(N), torch_moe.BLOCK)
        assert int(route.counts.max()) > port.capacity(N)  # expert 0 overflows
        got = port(t(x)).numpy()
    assert_close_scaled(got, want, MODULE_REL, "MoELayer W8A8 with drops")


# ---------------------------------------------------------- leaf selection

def _mid_cfg():
    """One layer wide enough that the default min_elems (32768) takes some
    leaves (the stylization products, the MOE projections) and not others
    (the SFFN, the experts, the pose heads, the time MLP)."""
    return dict(num_layers=1, latent_dim=32, ff_size=64, time_embed_dim=128,
                text_latent_dim=32, clip_width=32, clip_layers=1, num_experts=4,
                max_seq_len=16, respace="4")


def _tree(kind):
    """(JAX seeded variables, port cfg) of one model kind (built once a
    module)."""
    v, cfg_t = _built_tree(kind)
    return v, copy.deepcopy(cfg_t)


@functools.lru_cache(maxsize=None)
def _built_tree(kind):
    if kind == "m2d":
        arch_j = build_jax(JaxConfig.fromfile(M2D_CONFIG).model)
        batch = make_mwb(np.zeros((16, 163), np.float32))(0, 16)
        cfg_t = Config.fromfile(M2D_CONFIG).model
    else:
        cfg = tiny_t2m_cfg() if kind == "t2m" else flagship_t2m_cfg(**_mid_cfg())
        arch_j = build_jax(cfg)
        batch = make_text_batch(["a person walks"], max_seq_len=16)
        cfg_t = torch_tiny_cfg() if kind == "t2m" else torch_flagship_cfg(**_mid_cfg())
    v = _np(arch_j.init(jax.random.PRNGKey(0), batch))
    return {"params": seeded_params(v["params"], 1)}, cfg_t


@pytest.mark.parametrize("kind,min_elems,weight_only", [
    ("t2m", 0, False), ("t2m", 1 << 15, False), ("mid", 1 << 15, False), ("mid", 0, True),
    ("m2d", 0, False)])
def test_quantize_selects_the_jax_leaves(kind, min_elems, weight_only):
    v, cfg_t = _tree(kind)
    vq = _np(jq.quantize_variables(_jnp(v), min_elems=min_elems, weight_only=weight_only))
    want = from_jax_variables(vq)
    arch = build_torch(cfg_t, device="cpu")
    arch.model.load_state_dict(from_jax_params(v["params"]), strict=True)
    n = quant.quantize_(arch.model, min_elems=min_elems, weight_only=weight_only)
    got = arch.model.state_dict()
    assert set(got) == set(want)
    int8 = sorted(k for k, val in got.items() if val.dtype == torch.int8)
    assert int8 == sorted(k for k, val in want.items() if val.dtype == torch.int8)
    assert n == len(int8) == jq.count_quantized(vq)[0]
    for k, val in got.items():
        assert torch.equal(val, want[k]), k
    names = " ".join(int8)
    assert not re.search(r"text_enc|\.gate\.", names)
    if kind == "mid" and min_elems:  # the default threshold splits the leaves
        assert 0 < n < quant.quantize_(build_torch(cfg_t, device="cpu").model, min_elems=0)
    if kind == "m2d":
        assert "controlnet_0.after_proj.linear.weight" in int8 and "before_proj" in names
    if min_elems == 0:
        arch.model.load_state_dict(want, strict=True)
        assert quant.quantize_(arch.model, min_elems=0) == 0  # idempotent
        assert quant.count_quantized(arch.model)[0] == n


def test_quantize_scopes_and_widening():
    """The gnn / text_enc / gate scopes stay float; a second, wider pass
    keeps the first pass's scales; weight-only names its scales _wscale."""
    model = torch.nn.Module()
    for path in ("joint_embed.joint_0", "joint_embed.gnn.block_0.conv", "text_enc.proj",
                 "ffn.linear1", "other.dense", "ca_block.gate.cosine_projector"):
        parent = model
        *parents, leaf = path.split(".")
        for p in parents:
            if not hasattr(parent, p):
                parent.add_module(p, torch.nn.Module())
            parent = getattr(parent, p)
        parent.add_module(leaf, torch.nn.Linear(32, 32))
    assert quant.quantize_(model, min_elems=0) == 2  # joint_0 and ffn.linear1
    assert isinstance(model.joint_embed.joint_0, QLinear)
    assert type(model.joint_embed.gnn.block_0.conv) is torch.nn.Linear
    assert type(model.text_enc.proj) is torch.nn.Linear
    assert type(model.ca_block.gate.cosine_projector) is torch.nn.Linear
    first = model.ffn.linear1.kernel_scale.clone()
    assert quant.quantize_(model, min_elems=0, weight_only=True,
                           predicate=lambda p, w: "/other/" in p) == 1
    assert torch.equal(model.ffn.linear1.kernel_scale, first)
    assert hasattr(model.other.dense, "kernel_wscale")
    assert not hasattr(model.other.dense, "kernel_scale")
    assert quant.count_quantized(model)[0] == 3


def test_int8_npz_snapshot_loads_quantized(tmp_path):
    """A quantized model's save_params snapshot holds the int8 params and the
    quant collection; load_eval_variables quantizes a fresh model alike
    and loads it strict."""
    v, cfg_t = _tree("t2m")
    arch = build_torch(cfg_t, device="cpu")
    arch.model.load_state_dict(from_jax_params(v["params"]), strict=True)
    int8_quantize_(arch, min_elems=0)
    path = str(tmp_path / "int8.npz")
    save_params(path, arch.model)
    fresh = build_torch(cfg_t, device="cpu")
    load_eval_variables(cfg_t, fresh.model, checkpoint=path)
    a, b = arch.model.state_dict(), fresh.model.state_dict()
    assert set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)


# ------------------------------------------------------------ the tiny model

@pytest.fixture(scope="module")
def pair():
    v, cfg_t = _tree("t2m")
    arch_j = build_jax(tiny_t2m_cfg())
    batch = make_text_batch(["a person walks forward", "someone waves hello"],
                            max_seq_len=16, lengths=np.array([[16], [11]], np.int32))
    return arch_j, v, cfg_t, batch


def _port(cfg_t, vq):
    """A port model quantized as the JAX tree ``vq`` is, with its weights."""
    arch = build_torch(cfg_t, device="cpu")
    quant.quantize_like(arch.model, vq["quant"])
    arch.model.load_state_dict(from_jax_variables(vq), strict=True)
    return arch


def _forwards(arch_j, vq, arch_t, batch, monkeypatch):
    """One CFG test forward on both sides, each side's int8 activation codes
    recorded in call order (the JAX side through an ordered debug
    callback)."""
    x = np.random.RandomState(3).randn(*batch["motion"].shape).astype(np.float32)
    ts = np.full((2,), 499, np.int32)
    v = _jnp(vq)
    xf = arch_j.encode_text(v, batch["text_ids"])
    codes_j, codes_t = [], []
    real_j, real_t = jq._quantize_rows, quant.quantize_rows

    def record_j(x_):
        xq, ax = real_j(x_)
        jax.debug.callback(lambda a: codes_j.append(np.asarray(a)), xq, ordered=True)
        return xq, ax

    def record_t(x_):
        xq, ax = real_t(x_)
        codes_t.append(xq.numpy())
        return xq, ax

    monkeypatch.setattr(jq, "_quantize_rows", record_j)
    monkeypatch.setattr(quant, "quantize_rows", record_t)
    want = np.asarray(jax.jit(lambda v_, x_: arch_j.model.apply(
        v_, x_, ts, motion_mask=batch["motion_mask"], motion_length=batch["motion_length"],
        xf_out=xf, mode="test"))(v, jnp.asarray(x)))
    jax.effects_barrier()
    with torch.no_grad():
        xf_t = arch_t.encode_text(batch["text_ids"])
        got = arch_t.model(t(x), t(ts, torch.long), motion_mask=t(batch["motion_mask"]),
                           motion_length=t(batch["motion_length"]), xf_out=xf_t).numpy()
    return got, want, codes_j, codes_t


@pytest.mark.parametrize("mode", sorted(MODES))
def test_forward_int8_matches_jax(pair, mode, monkeypatch):
    arch_j, v, cfg_t, batch = pair
    vq = _np(jq.quantize_variables(_jnp(v), min_elems=0, weight_only=MODES[mode]))
    arch_t = _port(cfg_t, vq)
    got, want, codes_j, codes_t = _forwards(arch_j, vq, arch_t, batch, monkeypatch)
    assert np.abs(want).max() > 1e-3
    if mode == "w8":
        assert not codes_t and not codes_j  # weight-only quantizes no activation
        assert_close_scaled(got, want, REL, "forward W8")
        return
    # the same quantized activations in the same order on both sides; a code
    # that differs differs by one (a last-bit difference across a boundary)
    assert [c.shape for c in codes_t] == [c.shape for c in codes_j]
    diffs = [np.abs(a.astype(np.int32) - b.astype(np.int32)) for a, b in zip(codes_t, codes_j)]
    flips, total = sum(int((d > 0).sum()) for d in diffs), sum(d.size for d in diffs)
    print(f"W8A8 forward: {flips} of {total} activation codes differ from JAX's; max diff "
          f"{np.abs(got - want).max():.3e} (scale {np.abs(want).max():.3e})")
    assert max(int(d.max()) for d in diffs) <= 1 and flips <= 1e-3 * total
    assert_close_scaled(got, want, W8A8_REL, "forward W8A8")


def _jax_gate_logits(state):
    """{port module name: gate logits} from flax's captured intermediates."""
    out = {}
    for path, a in jax.tree_util.tree_flatten_with_path(state["intermediates"])[0]:
        keys = [str(getattr(k, "key", getattr(k, "idx", k))) for k in path]
        if keys[-3:-1] == ["gate", "__call__"]:
            out[".".join(keys[:-2])] = np.asarray(a)
    return out


def _as_jax_picks(logits, k=2):
    """The logits, each row whose top-k by logit differs from lax.top_k of
    its softmax scores replaced by its log-scores."""
    scores = np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=1))
    by_score = np.sort(np.asarray(jax.lax.top_k(jnp.asarray(scores), k)[1]), axis=1)
    by_logit = np.sort(np.argsort(-logits, axis=1, kind="stable")[:, :k], axis=1)
    out = np.array(logits)
    rows = (by_score != by_logit).any(axis=1)
    out[rows] = np.log(scores[rows])
    return out


def _pinned_samples(arch_j, vq, arch_t, batch, rng, dtype=None, check_restated=False):
    """(port sample, JAX sample) on the same noise with the port's MoE gates
    fed the JAX run's logits, call for call: a token whose top-2 logits are
    a near-tie (gaps of 1e-7 occur at this size) may pick another expert
    on the other side, and both picks are right.  JAX's slot path on the
    CPU ranks experts by softmax score (lax.top_k: the lower index first
    where two scores round equal), the port by logit (ROADMAP queue 3): on
    a row where the two rankings pick differently the port is handed the
    log-scores instead, whose logit order is JAX's pick.  The JAX sample is
    its DDIM chain restated step by step (its text MoEs computed in the
    layers, which the hoist equals), each step's gate logits captured; with
    ``check_restated`` it is held against the JAX package's own jitted
    sampler first."""
    from motioncraft_tpu.diffusion.sampling import ddim_step
    from motioncraft_tpu.models.moe import CosineTopGate as JaxGate
    from motioncraft_tpu_torch.models.moe import CosineTopGate

    V, cdt = _jnp(vq), dtype and jnp.bfloat16
    B, T, D = batch["motion"].shape
    xf = arch_j.encode_text(V, batch["text_ids"])
    xf = xf.astype(cdt) if cdt else xf
    fwd = jax.jit(lambda v_, x_, t_: arch_j.model.apply(
        v_, x_.astype(cdt) if cdt else x_, t_, motion_mask=batch["motion_mask"],
        motion_length=batch["motion_length"], xf_out=xf, mode="test",
        capture_intermediates=lambda m, _: isinstance(m, JaxGate), mutable=["intermediates"]))
    steps = []

    def model_fn(x_, t_):
        out, state = fwd(V, x_, t_)
        steps.append(_jax_gate_logits(state))
        return out.astype(jnp.float32)

    r_noise, key = jax.random.split(rng)
    noise = jax.random.normal(r_noise, (B, T, D), jnp.float32)
    x, d = noise, arch_j.diffusion_test
    for t_scalar in range(d.num_timesteps - 1, -1, -1):
        key, sub = jax.random.split(key)
        x, _, _ = ddim_step(d, model_fn, x, jnp.full((B,), t_scalar, jnp.int32), sub,
                            eta=0.0, clip_denoised=False)
    want = np.asarray(arch_j.post_process(x))
    if check_restated:
        jitted = np.asarray(jax.jit(lambda v_, b, r: arch_j.sample(v_, b, r))(V, batch, rng))
        assert_close_scaled(want, jitted, 1e-5, "JAX restated")

    calls = {}

    def pin(name):
        def hook(mod, inp, out):
            i = calls.get(name, 0)
            calls[name] = i + 1
            text = "text_moe" in name  # hoisted: once a sampling call
            return torch.from_numpy(_as_jax_picks(steps[0 if text else i][name]))
        return hook

    hooks = [m.register_forward_hook(pin(n)) for n, m in arch_t.model.named_modules()
             if isinstance(m, CosineTopGate)]
    try:
        got = arch_t.sample(batch, noise=t(np.asarray(noise)), compute_dtype=dtype)
    finally:
        for h in hooks:
            h.remove()
    assert calls and all(n == (1 if "text_moe" in k else len(steps)) for k, n in calls.items())
    return got.numpy(), want


@pytest.mark.parametrize("mode", sorted(MODES))
def test_sample_int8_matches_jax(pair, mode):
    arch_j, v, cfg_t, batch = pair
    vq = _np(jq.quantize_variables(_jnp(v), min_elems=0, weight_only=MODES[mode]))
    arch_t = _port(cfg_t, vq)
    got, want = _pinned_samples(arch_j, vq, arch_t, batch, jax.random.PRNGKey(5),
                                check_restated=mode == "w8")
    base = build_torch(cfg_t, device="cpu")
    base.model.load_state_dict(from_jax_params(v["params"]), strict=True)
    exact = base.sample(batch, noise=t(np.asarray(jax.random.normal(
        jax.random.split(jax.random.PRNGKey(5))[0], batch["motion"].shape)))).numpy()
    assert np.abs(got - exact).max() > 0  # the int8 weights took effect
    assert np.linalg.norm(got - exact) < 0.05 * np.linalg.norm(exact)
    if mode == "w8a8":  # the chain's own sensitivity to a one-ulp input change
        noise = np.asarray(jax.random.normal(jax.random.split(jax.random.PRNGKey(5))[0],
                                             batch["motion"].shape))
        nudged = arch_t.sample(batch, noise=t(np.nextafter(noise, np.float32(np.inf))))
        print(f"W8A8 sample: max diff against JAX {np.abs(got - want).max():.3e}; a one-ulp "
              f"noise change moves the port's by {np.abs(nudged.numpy() - got).max():.3e} "
              f"(scale {np.abs(want).max():.3e})")
    assert_close_scaled(got, want, REL if mode == "w8" else MODEL_REL, f"sample {mode}")


def test_bf16_int8_composes(pair):
    """bf16_cast_ then int8_quantize_ against bf16_cast_variables then
    quantize_variables: the same int8 bytes and f32 scales, the time MLP on
    f32 activations, and the sample within MODEL_REL."""
    arch_j, v, cfg_t, batch = pair
    vq = _np(jq.quantize_variables(bf16_cast_variables(_jnp(v)), min_elems=0))
    arch_t = build_torch(cfg_t, device="cpu")
    arch_t.model.load_state_dict(from_jax_params(v["params"]), strict=True)
    int8_quantize_(bf16_cast_(arch_t), min_elems=0)
    want_sd = from_jax_variables(jax.tree_util.tree_map(
        lambda a: a if a.dtype == np.int8 else np.asarray(a, np.float32), vq))
    for k, val in arch_t.model.state_dict().items():
        if val.dtype == torch.int8 or k.endswith("_scale"):
            assert torch.equal(val, want_sd[k]), k
            assert val.dtype in (torch.int8, torch.float32), k
    te = arch_t.model.time_embed[0]
    assert isinstance(te, QLinear) and te.bias.dtype == torch.float32
    got, want = _pinned_samples(arch_j, vq, arch_t, batch, jax.random.PRNGKey(6),
                                dtype=torch.bfloat16)
    assert np.isfinite(got).all()
    assert_close_scaled(got, want, MODEL_REL, "bf16 + W8A8 sample")


def test_w8_composes_with_step_cache(pair):
    arch_j, v, cfg_t, batch = pair
    vq = _np(jq.quantize_variables(_jnp(v), min_elems=0, weight_only=True))
    arch_t = _port(cfg_t, vq)
    kw = dict(reuse_every=2, warmup=1, tail=0)
    rng = jax.random.PRNGKey(31)
    want = np.asarray(jax.jit(lambda v_, b, r: arch_j.sample(
        v_, b, r, step_cache=JaxStepCache(**kw)))(_jnp(vq), batch, rng))
    noise = t(np.asarray(jax.random.normal(jax.random.split(rng)[0], batch["motion"].shape)))
    got = arch_t.sample(batch, noise=noise, step_cache=StepCacheConfig(**kw)).numpy()
    assert_close_scaled(got, want, REL, "W8 + step cache sample")


# ------------------------------------------------------------------ the CLIs

# the tiny configs' weights are all below the default size floor (as in
# the JAX package): the CLI tests quantize every eligible weight
@pytest.fixture
def every_weight(monkeypatch):
    monkeypatch.setattr(quant, "MIN_ELEMS", 0)


def test_torch_test_cli_int8_and_step_cache(workdir, monkeypatch, tmp_path,  # noqa: F811
                                            every_weight):
    """tools/torch_test.py with --bf16 --int8 (W8A8) and --int8-mode w8
    --step-cache-table: finite metrics and tools/test.py's flags stamped
    into metrics.json (--step-cache N runs in the other CLIs' tests)."""
    tool = _load("torch_test")
    monkeypatch.chdir(workdir)
    layers = Config.fromfile(T2M_CONFIG).model["model"]["num_layers"]
    table = np.zeros((4, layers), bool)
    table[2] = True
    np.savez(tmp_path / "table.npz", flags=table)
    runs = {"int8": (["--bf16", "--int8"], {"int8_weights": "w8a8", "step_cache": 0}),
            "w8_table": (["--int8-mode", "w8", "--step-cache-table", str(tmp_path / "table.npz")],
                         {"int8_weights": "w8", "step_cache_table": str(tmp_path / "table.npz")})}
    for name, (extra, flags) in runs.items():
        run = tool.main([T2M_CONFIG, name, "--device", "cpu", "--batch-size", "5",
                         "--checkpoint", str(workdir / "params.npz"), *extra,
                         "--cfg-options", _evaluator_option(workdir)])
        with open(workdir / name / "metrics.json") as f:
            out = json.load(f)
        assert out == run["out"] and set(out["flags"]) == {
            "untrained_evaluator", "hash_tokenizer", "int8_weights", "step_cache",
            "step_cache_table"}
        for k, val in flags.items():
            assert out["flags"][k] == val, (name, k)
        metric = {k: val for k, val in out.items() if k not in ("flags", "protocol")}
        assert len(metric) == 8 and all(np.isfinite(val) for val in metric.values())
        assert (quant.count_quantized(run["arch"].model)[0] > 0) == bool(flags["int8_weights"])
    with pytest.raises(SystemExit, match="mutually exclusive"):
        tool.parse_args([T2M_CONFIG, "out", "--step-cache", "2", "--step-cache-table", "x"])
    with pytest.raises(SystemExit):
        tool.parse_args([T2M_CONFIG, "out", "--step-cache", "1"])


def test_torch_m2d_cli_int8_and_step_cache(tmp_path, monkeypatch, every_weight):
    tool = _load("torch_m2d_test")
    monkeypatch.chdir(REPO)
    run = tool.main(["configs/tests/fixture_m2d.py", "--device", "cpu", "--int8",
                     "--step-cache", "2", "--work-dir", str(tmp_path)])
    with open(tmp_path / "metrics.json") as f:
        out = json.load(f)
    assert out["flags"]["int8_weights"] == "w8a8" and out["flags"]["step_cache"] == 2
    assert quant.count_quantized(run["arch"].model)[0] > 0
    assert np.isfinite(run["preds"][0]).all()
    assert tool.parse_args(["configs/tests/fixture_m2d.py", "--int8-mode", "w8"]).int8 == "w8"


def test_torch_s2g_cli_int8_and_step_cache(tmp_path, monkeypatch, every_weight):
    tool = _load("torch_s2g_test")
    monkeypatch.chdir(REPO)
    monkeypatch.delenv("MOTIONCRAFT_SMPLX_MODEL", raising=False)
    run = tool.main(["configs/tests/tiny_s2g.py", "--device", "cpu", "--int8", "w8",
                     "--step-cache", "2", "--beats2-args", "configs/tests/fixture_beat2.yaml",
                     "--work-dir", str(tmp_path), "--limit", "1"])
    flags = run["out"]["flags"]
    assert flags["int8_weights"] == "w8" and flags["step_cache"] == 2
    assert quant.count_quantized(run["arch"].model)[0] > 0
    assert np.isfinite(np.asarray(run["preds"][0])).all()


def test_torch_serve_int8_and_step_cache(every_weight):
    tool = _load("torch_serve")
    args = tool.parse_args([T2M_CONFIG, "--device", "cpu", "--int8", "--step-cache", "2",
                            "--buckets", "1", "--seq-buckets", "16"])
    assert args.int8 == "w8a8" and args.step_cache == 2
    srv = tool.build_server(args, logger=lambda m: None)
    with srv:
        out = srv.generate(["a person waves"], [6], timeout=120)[0]
    assert out.shape == (6, 322) and np.isfinite(out).all()
    assert quant.count_quantized(srv._arch.model)[0] > 0
    assert srv._step_cache.reuse_every == 2


def test_torch_calibrate_step_cache_cli(workdir, monkeypatch, tmp_path):  # noqa: F811
    """tools/torch_calibrate_step_cache.py on the tiny config (perturbed
    random weights: the zero-initialised heads would give a vacuous
    profile): the .npz and the --json artifact in the committed artifact's
    schema, a table that tools/torch_test.py's --step-cache-table runs."""
    monkeypatch.chdir(workdir)
    tool = _load("torch_calibrate_step_cache")
    out, art = str(tmp_path / "calib.npz"), str(tmp_path / "calib.json")
    run = tool.main([T2M_CONFIG, out, "--device", "cpu", "--batches", "1", "--batch-size",
                     "4", "--threshold", "1.0", "--tail", "1", "--perturb", "0.05",
                     "--json", art])
    layers = Config.fromfile(T2M_CONFIG).model["model"]["num_layers"]
    flags, errors = run["flags"], run["errors"]
    assert flags.shape == errors.shape == (4, layers)
    assert not flags[0].any() and not flags[-1].any() and (errors[1:] > 0).all()
    np.testing.assert_array_equal(np.load(out)["flags"], flags)
    with open(art) as f:
        a = json.load(f)
    with open(os.path.join(REPO, "artifacts", "step_cache_flagship.json")) as f:
        committed = json.load(f)
    assert set(committed) <= set(a) and a["random_weights"] and a["platform"] == "cpu"
    np.testing.assert_array_equal(np.asarray(a["flags"], bool), flags)
    np.testing.assert_array_equal(load_flags(art), flags)
