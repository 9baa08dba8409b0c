"""The port's ControlNet (models/controlnet.py:ControlT2MHalf) against the
JAX package on the tiny M2D config (configs/tests/tiny_m2d.py: a 2-layer
base, one control block, 163-d music), on one seeded flax tree carried over
by ``from_jax_params`` with ``strict=True``:

- the CFG test forward with the condition on and off (the four
  cfg_layer0_dedup x text_hoist combinations with every MoE call over its
  capacity: tests/test_torch_controlnet_drops.py);
- ``encode_condition`` for a condition shorter, as long as and longer than
  the window;
- a released-layout merged base+control ``.pth`` loads with the same
  tensors, exactly, as through the JAX converter, and a ``.npz`` snapshot
  crosses between the packages;
- the zero-initialised branch changes nothing; what is not ported raises.

Tolerance: 1e-5 x max(1, max |JAX|) for the outputs (sums in another order).
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import unfreeze

import fabricate_torch as fab
import motioncraft_tpu.models  # noqa: F401  (registers the flax classes)
from motioncraft_tpu.apis.factory import flagship_m2d_cfg as jax_flagship_m2d_cfg
from motioncraft_tpu.config import Config as JaxConfig
from motioncraft_tpu.models.tokenizer import tokenize
from motioncraft_tpu.registry import build_architecture as build_jax
from motioncraft_tpu.utils import torch_convert as jax_convert
from motioncraft_tpu_torch.apis.factory import flagship_m2d_cfg
from motioncraft_tpu_torch.config import Config
from motioncraft_tpu_torch.registry import build_architecture as build_torch
from motioncraft_tpu_torch.utils import checkpoint, torch_convert
from motioncraft_tpu_torch.utils.convert import from_jax_params, to_jax_params
from test_torch_sample import _skew_gates
from torch_port_util import assert_close_scaled, seeded_params, t

REL = 1e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "tests", "tiny_m2d.py")
T = 16


def _cfgs(**flags):
    cfg_j, cfg_t = JaxConfig.fromfile(CONFIG).model, Config.fromfile(CONFIG).model
    for cfg in (cfg_j, cfg_t):
        cfg["model"]["base_model"].update(flags)
    return cfg_j, cfg_t


def _batch():
    rng = np.random.RandomState(0)
    return {"motion": np.zeros((2, T, 322), np.float32),
            "motion_mask": np.ones((2, T), np.float32),
            "motion_length": np.full((2, 1), T, np.int32),
            "text_ids": tokenize(["A dancer is performing a Jazz dance in the modern style",
                                  "A dancer is performing a Hiphop dance"]),
            "c": rng.randn(2, T, 163).astype(np.float32)}


def _pair(skew=False, seed=1, **flags):
    cfg_j, cfg_t = _cfgs(**flags)
    arch_j = build_jax(cfg_j)
    variables = unfreeze(arch_j.init(jax.random.PRNGKey(0), _batch()))
    params = seeded_params(jax.tree_util.tree_map(np.asarray, variables["params"]), seed)
    if skew:
        _skew_gates(params)
    arch_t = build_torch(cfg_t, device="cpu")
    arch_t.model.load_state_dict(from_jax_params(params), strict=True)
    return arch_j, params, arch_t


@pytest.fixture(scope="module")
def seeded():
    return _pair()


def _forward_jax(arch_j, params, batch, x, ts, c, capture=False):
    from motioncraft_tpu.models.moe import CosineTopGate as JaxGate

    v = {"params": jax.tree_util.tree_map(jnp.asarray, params)}
    xf = arch_j.encode_text(v, batch["text_ids"])
    tf = arch_j.model.apply(v, xf, method="precompute_text_feats")
    kw = dict(capture_intermediates=lambda m, _: isinstance(m, JaxGate),
              mutable=["intermediates"]) if capture else {}
    run = jax.jit(lambda v_, tf_: arch_j.model.apply(
        v_, x, ts, motion_mask=batch["motion_mask"], motion_length=batch["motion_length"],
        xf_out=xf, c=c, text_feats=tf_, mode="test", **kw))
    out = run(v, tf)
    if not capture:
        return np.asarray(out), tf
    want, st = out
    if tf is not None:  # the hoisted text MoEs ran outside; in the layers their gates see the same
        _, st = run(v, None)
    logits = [v_ for path, v_ in jax.tree_util.tree_leaves_with_path(st)
              if "__call__" in jax.tree_util.keystr(path)]
    return np.asarray(want), tf, logits


def _forward_torch(arch_t, batch, x, ts, c, logits=None):
    """The port's forward; with ``logits``, a second run without the hoist
    appends every gate's logits, as the JAX side collects them."""
    def run(hoist):
        with torch.no_grad():
            xf = arch_t.encode_text(batch["text_ids"])
            tf = arch_t.model.precompute_text_feats(xf) if hoist else None
            out = arch_t.model(t(x), t(ts, torch.long), motion_mask=t(batch["motion_mask"]),
                               motion_length=t(batch["motion_length"]), xf_out=xf,
                               text_feats=tf, c=None if c is None else t(c))
        return out.numpy(), tf

    from motioncraft_tpu_torch.models.moe import CosineTopGate

    out = run(True)
    if logits is not None:
        hooks = [m.register_forward_hook(lambda mod, i, o: logits.append(o.numpy()))
                 for m in arch_t.modules() if isinstance(m, CosineTopGate)]
        run(False)
        for h in hooks:
            h.remove()
    return out


def _inputs():
    rng = np.random.RandomState(3)
    return rng.randn(2, T, 322).astype(np.float32), np.full((2,), 499, np.int32)


@pytest.mark.parametrize("with_c", [True, False], ids=["c_on", "c_off"])
def test_forward_test(seeded, with_c):
    arch_j, params, arch_t = seeded
    batch = _batch()
    x, ts = _inputs()
    c = batch["c"] if with_c else None
    want, _ = _forward_jax(arch_j, params, batch, x, ts, c)
    got, _ = _forward_torch(arch_t, batch, x, ts, c)
    assert np.abs(want).max() > 1e-3
    assert_close_scaled(got, want, REL, "forward_test")


@pytest.mark.parametrize("length", [10, T, 20])
def test_encode_condition(seeded, length):
    arch_j, params, arch_t = seeded
    c = np.random.RandomState(length).randn(2, length, 163).astype(np.float32)
    v = {"params": jax.tree_util.tree_map(jnp.asarray, params)}
    want = np.asarray(arch_j.model.apply(v, c, T, method="encode_condition"))
    with torch.no_grad():
        got = arch_t.model.encode_condition(t(c), T).numpy()
    assert got.shape == (2, T, arch_t.model.base_model.latent_dim)
    assert_close_scaled(got, want, REL, "encode_condition")


def test_zero_init_branch_changes_nothing():
    arch = build_torch(Config.fromfile(CONFIG).model, device="cpu")
    batch = _batch()
    x, ts = _inputs()
    on, _ = _forward_torch(arch, batch, x, ts, batch["c"])
    off, _ = _forward_torch(arch, batch, x, ts, None)
    np.testing.assert_array_equal(on, off)


def test_flagship_m2d_cfg_is_the_jax_one():
    assert flagship_m2d_cfg() == jax_flagship_m2d_cfg()
    model = build_torch(dict(flagship_m2d_cfg(num_layers=3, latent_dim=8, text_latent_dim=16,
                                              ff_size=16, time_embed_dim=32, clip_width=32,
                                              clip_layers=1, num_experts=4)),
                        device="cpu").model
    assert model.copy_blocks_num == 2 and model.base_model.max_seq_len == 120


def test_what_is_not_ported_raises():
    cfg = Config.fromfile(CONFIG).model
    # a pre-encoder type neither package builds (wav2vec is built since it
    # was ported: tests/test_torch_wav2vec.py); a patched condition over an
    # unpatched base, whose output shape the JAX package breaks (a patched
    # ControlNet over a patched base is held against JAX in
    # tests/test_torch_zoo_stmogen.py)
    for change, reason, error in ((dict(condition_encode_cfg=dict(
            condition_pre_encode=True, condition_pre_encode_type="mel")), "mel",
            NotImplementedError), (dict(patch_size=4), "patch_size", ValueError)):
        bad = copy.deepcopy(cfg)
        bad["model"].update(change)
        with pytest.raises(error, match=reason):
            build_torch(bad, device="cpu")
    # both block types train (tests/test_torch_controlnet_train.py, the
    # STMoGen one; tests/test_torch_baseline_train.py, the MCM one)
    arch = build_torch(cfg, device="cpu")
    arch.train()
    total, _ = arch.loss(dict(_batch(), motion=np.zeros((2, T, 322), np.float32)))
    assert np.isfinite(float(total))
    from test_torch_mcm_controlnet import _batch as mcm_batch
    from test_torch_mcm_controlnet import arch_cfg as mcm_arch_cfg
    mcm = build_torch(mcm_arch_cfg("music"), device="cpu")
    mcm.train()
    total, _ = mcm.loss(mcm_batch("music"))
    assert np.isfinite(float(total))


def test_merged_pth_loads_like_the_jax_route(seeded, tmp_path):
    """A released-layout merged base+control .pth ('model.base_model.*',
    'model.controlnet.N.*', 'model.control_cond_input.*'): the port's
    load_controlnet_ckpt and load_eval_variables give exactly the tensors of
    the JAX converter's tree carried over; a base-only file fills the base
    and leaves the control branch."""
    arch_j, params, arch_t = seeded
    cfg = JaxConfig.fromfile(CONFIG).model["model"]
    bm = cfg["base_model"]
    dims = (bm["num_layers"], bm["ffn_cfg"]["num_heads"], cfg["copy_blocks_num"],
            bm["text_encoder"]["num_layers"], bm["text_encoder"]["clip_layers"])
    rng = np.random.RandomState(0)
    sd = fab.stmogen_sd(params["base_model"], rng, dims[0], dims[1], dims[3], dims[4],
                        prefix="base_model.")
    blk = params["controlnet_0"]
    fab.stma(sd, "controlnet.0.copied_block.ca_block", blk["copied_block"]["ca_block"], rng)
    fab.sffn(sd, "controlnet.0.copied_block.ffn", blk["copied_block"]["ffn"], rng, dims[1])
    fab.lin(sd, "controlnet.0.after_proj", blk["after_proj"]["linear"], rng)
    fab.lin(sd, "controlnet.0.before_proj", blk["before_proj"], rng)
    fab.lin(sd, "control_cond_input", params["control_cond_input"]["linear"], rng)
    path = str(tmp_path / "m2d.pth")
    torch.save({"state_dict": {"model." + k: torch.from_numpy(np.asarray(v, np.float32) * 0.3)
                               for k, v in sd.items()}}, path)

    tree, stats = jax_convert.convert_controlnet(jax_convert.load_torch_state_dict(path),
                                                 *dims)
    assert not stats
    loaded = copy.deepcopy(params)
    jax_convert._tree_update(loaded, tree)
    want = from_jax_params(loaded)
    model = build_torch(Config.fromfile(CONFIG).model, device="cpu").model
    got = torch_convert.load_controlnet_ckpt(path, model, *dims)
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    again = build_torch(Config.fromfile(CONFIG).model, device="cpu").model
    got = checkpoint.load_eval_variables(Config.fromfile(CONFIG).model, again,
                                         torch_checkpoint=path)
    assert all(torch.equal(got[k], want[k]) for k in want)

    base_only = {k[len("base_model."):]: torch.from_numpy(np.asarray(v, np.float32))
                 for k, v in sd.items() if k.startswith("base_model.")}
    torch.save(base_only, str(tmp_path / "base.pth"))
    before = {k: v.clone() for k, v in again.state_dict().items()}
    got = torch_convert.load_controlnet_ckpt(str(tmp_path / "base.pth"), again, *dims)
    for k, v in got.items():
        assert torch.equal(v, before[k]) != k.startswith("base_model."), k


def test_npz_snapshots_cross_between_the_packages(seeded, tmp_path):
    from motioncraft_tpu.utils.checkpoint import load_params as jax_load
    from motioncraft_tpu.utils.checkpoint import save_params as jax_save

    _, params, arch_t = seeded
    tree = to_jax_params(arch_t.model.state_dict())
    assert (jax.tree_util.tree_structure(tree)
            == jax.tree_util.tree_structure(jax.tree_util.tree_map(np.asarray, params)))
    jax_save(str(tmp_path / "jax.npz"), {"params": params})
    model = build_torch(Config.fromfile(CONFIG).model, device="cpu").model
    checkpoint.load_eval_variables(Config.fromfile(CONFIG).model, model,
                                   checkpoint=str(tmp_path / "jax.npz"))
    for k, v in arch_t.model.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k
    checkpoint.save_params(str(tmp_path / "port.npz"), arch_t.model)
    back = jax_load(str(tmp_path / "port.npz"))["params"]
    for (pa, a), (pb, b) in zip(jax.tree_util.tree_leaves_with_path(back),
                                jax.tree_util.tree_leaves_with_path(params)):
        assert pa == pb and np.array_equal(a, b), pa
