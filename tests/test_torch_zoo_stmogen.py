"""STMoGen's patched, joint and body-graph variants, the linear top-k gate and
per-head text keys, against the JAX package on the CPU.

Each flax module (or tiny model) is initialised, its ``params`` (and
``batch_stats``) replaced by seeded numpy trees and carried into the port by
``from_jax_variables`` with ``strict=True``; the same numpy inputs go
through both.  The JAX package runs its own CPU paths (the slot MoE, the
einsum SFFN, its linear attention); the port runs its kernels' plain
versions (K1-K5 on a CPU tensor).

- Modules: ``PatchEmbed1D`` / ``unpatchify`` / ``fold_patch_mask``; STMA
  with a patch size, one text head a head and the linear top-k gate; the
  MoE layer with the linear gate, in inference and in one training forward
  (gate noise 0: the random streams differ); every ``Graph`` layout and
  mode; the STGCN (both temporal-conv types, each adaptive adjacency) in
  eval and in one training forward, its running statistics included; the
  PoseEncoder / PoseDecoder variants.
- The slice: DDIM samples of tiny V1 (motionx, patch 2 on the stack and
  STMA, the linear gate, a two-entry ``ffn_cfg`` list), V2 (human_ml3d, the
  body graph over 8 part tokens, one text head a head) and V3 (human_ml3d,
  23 joint heads), the JAX run's initial noise handed across; V1 in bf16
  too; the ControlNet over a patched base; a training forward of V2.
- Weights: every new parameter and ``batch_stats`` leaf goes from flax to
  the port and back bit for bit; a reference ``.pth``'s PatchEmbed conv
  converts as in the JAX package.

Tolerance: 1e-5 x max(1, max |JAX|) for a module, 1e-4 for a whole sample
(test_torch_sample.py's), 5e-2 for the bf16 sample (test_torch_bf16.py's).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import motioncraft_tpu.models  # noqa: F401  (registers the flax classes)
from motioncraft_tpu.apis.factory import make_text_batch, tiny_t2m_cfg
from motioncraft_tpu.models import attentions as jax_att
from motioncraft_tpu.models import blocks as jax_blocks
from motioncraft_tpu.models import gnns as jax_gnns
from motioncraft_tpu.models import moe as jax_moe
from motioncraft_tpu.models import stmogen as jax_stmogen
from motioncraft_tpu.registry import build_architecture as build_jax
from motioncraft_tpu_torch.apis.factory import bf16_cast_
from motioncraft_tpu_torch.models import attentions, blocks, gnns, moe, stmogen
from motioncraft_tpu_torch.registry import build_architecture as build_torch
from motioncraft_tpu_torch.utils.convert import from_jax_variables, to_jax_variables
from torch_port_util import assert_close_scaled, seeded_batch_stats, seeded_params, t

REL, SAMPLE_REL, BF16_REL = 1e-5, 1e-4, 5e-2
T = 16


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def seeded_variables(shapes, seed=1):
    """Seeded numpy ``params`` (and ``batch_stats``) of a flax variables tree
    or of its shapes."""
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), dict(shapes))
    out = {"params": seeded_params(zeros["params"], seed)}
    if "batch_stats" in zeros:
        out["batch_stats"] = seeded_batch_stats(zeros["batch_stats"], seed + 1)
    return out


def carry(flax_module, torch_module, *args, seed=1, **kw):
    """Seeded flax variables of ``flax_module`` (shapes from tracing its init
    on ``args``) -> (jnp variables, the torch module loaded, in eval)."""
    shapes = jax.eval_shape(lambda: flax_module.init(jax.random.PRNGKey(0), *args, **kw))
    v = seeded_variables(shapes, seed)
    torch_module.load_state_dict(from_jax_variables(v), strict=True)
    return jax.tree_util.tree_map(jnp.asarray, v), torch_module.eval()


# -------------------------------------------------------------- the blocks
@pytest.mark.parametrize("frames,use_norm", [(8, False), (7, True)])
def test_patch_embed_and_unpatchify(frames, use_norm):
    x = np.random.RandomState(frames).randn(2, frames, 5).astype(np.float32)
    flax_m = jax_blocks.PatchEmbed1D(2, 8, use_norm=use_norm)
    v, m = carry(flax_m, blocks.PatchEmbed1D(5, 2, 8, use_norm=use_norm), x)
    with torch.no_grad():
        got = m(t(x)).numpy()
    assert got.shape == (2, (frames + 1) // 2, 8)
    assert_close_scaled(got, flax_m.apply(v, x), REL, "PatchEmbed1D")
    y = np.random.RandomState(1).randn(2, 3, 12).astype(np.float32)
    np.testing.assert_array_equal(blocks.unpatchify(t(y), 3).numpy(),
                                  np.asarray(jax_blocks.unpatchify(jnp.asarray(y), 3)))


def test_fold_patch_mask():
    mask = (np.arange(12)[None, :, None] < np.array([12, 7, 4])[:, None, None]).astype(np.float32)
    np.testing.assert_array_equal(attentions.fold_patch_mask(t(mask), 2).numpy(),
                                  np.asarray(jax_att.fold_patch_mask(jnp.asarray(mask), 2)))


STMA_KW = dict(latent_dim=8, text_latent_dim=16, num_heads=6, num_text_heads=1,
               num_experts=4, topk=2, ffn_dim=16, time_embed_dim=32, max_seq_len=12,
               max_text_seq_len=77, dynamic_body=True)


@pytest.mark.parametrize("change", [dict(patch_size=2), dict(num_text_heads=6),
                                    dict(gate_type="linear_top")],
                         ids=["patch", "text_heads", "linear_top"])
def test_stma_variants(change):
    """STMA on a CFG-doubled batch, one change at a time: a patch size (its
    frame mask of 2 x 12 frames folds to 12 patches), one text head a head
    (the 12-wide text features split into 6 heads of 2), the linear top-k
    gate."""
    kw = dict(STMA_KW, **change)
    if change.get("num_text_heads"):
        kw["text_latent_dim"] = 2
    rng = np.random.RandomState(5)
    B, Tt, TXT, p = 2, 12, 77, change.get("patch_size", 1)
    x = np.tile(rng.randn(B, Tt, 6 * 8).astype(np.float32), (2, 1, 1))
    xf = np.tile(rng.randn(B, TXT, 12 if change.get("num_text_heads") else 16)
                 .astype(np.float32), (2, 1, 1))
    emb = np.tile(rng.randn(B, 32).astype(np.float32), (2, 1))
    mask = np.ones((2 * B, Tt * p, 1), np.float32)
    mask[1::2, 15:] = 0
    cond = np.concatenate([np.ones((B, 1, 1)), np.zeros((B, 1, 1))]).astype(np.float32)
    flax_m = jax_att.STMA(**kw)
    args = dict(xf=xf, emb=emb, src_mask=mask, cond_type=cond)
    v, m = carry(flax_m, attentions.STMA(**kw), x, **args)
    want = jax.jit(lambda v_: flax_m.apply(v_, x, cfg_dedup=True, **args))(v)
    with torch.no_grad():
        got = m(t(x), xf=t(xf), emb=t(emb), src_mask=t(mask), cond_type=t(cond),
                cfg_dedup=True).numpy()
    assert_close_scaled(got, want, REL, f"STMA {change}")


def test_linear_top_gate_moe():
    """The MoE layer with the linear gate: its f32 logits, the inference
    output, and one training forward's output and aux loss (gate noise 0)."""
    rng = np.random.RandomState(3)
    x = jnp.asarray(rng.randn(60, 16).astype(np.float32))
    kw = dict(num_experts=4, topk=2, model_dim=16, hidden_dim=32, gate_type="linear_top")
    flax_m = jax_moe.MoELayer(**kw, gate_noise=0.0)
    v, m = carry(flax_m, moe.MoELayer(4, 2, 16, 32, gate_type="linear_top", gate_noise=0.0), x)
    assert isinstance(m.gate, moe.LinearTopGate) and m.gate.wg.bias is None
    x = np.asarray(x)
    with torch.no_grad():
        got = m(t(x)).numpy()
    want, _ = jax.jit(flax_m.apply)(v, x)
    assert_close_scaled(got, want, REL, "linear-gate MoE")
    (want_t, aux_j), _ = jax.jit(lambda v_, x_: flax_m.apply(v_, x_, train=True,
                                                             mutable=["losses"]))(v, x)
    aux = []
    m.train()
    got_t = m(t(x), aux_losses=aux).detach().numpy()
    assert_close_scaled(got_t, want_t, REL, "linear-gate MoE training")
    assert_close_scaled(aux[0].detach().numpy(), aux_j, REL, "aux loss")
    with pytest.raises(ValueError, match="gate_type"):
        moe.MoELayer(4, 2, 16, 32, gate_type="switch")


# ------------------------------------------------------------ the body graph
@pytest.mark.parametrize("layout", ["smpl_parts", "smpl_joints"])
@pytest.mark.parametrize("mode", ["spatial", "stgcn_spatial", "binary_adj"])
def test_graph(layout, mode):
    want = jax_gnns.Graph(layout, mode)
    got = gnns.Graph(layout, mode)
    np.testing.assert_array_equal(got.A, want.A)
    np.testing.assert_array_equal(got.hop_dis, want.hop_dis)


@pytest.mark.parametrize("tcn_type,adaptive,stages", [("unit_tcn", "importance", 3),
                                                      ("mstcn", "offset", 2),
                                                      ("unit_tcn", "init", 2)])
def test_stgcn_eval_and_train(tcn_type, adaptive, stages):
    """The stage stack in eval (the running statistics) and in one training
    forward (the batch's statistics; the running ones moved as flax moves
    them); in_channels 6 against base 12, so a first block widens."""
    x = np.random.RandomState(7).randn(2, 9, 8, 6).astype(np.float32)
    kw = dict(graph_cfg=dict(layout="smpl_parts", mode="spatial"), in_channels=6,
              base_channels=12, num_stages=stages, inflate_stages=(2,), tcn_type=tcn_type,
              gcn_adaptive=adaptive)
    flax_m = jax_gnns.STGCN(**kw)
    v, m = carry(flax_m, gnns.STGCN(**kw), x)
    with torch.no_grad():
        got = m(t(x)).numpy()
    assert_close_scaled(got, flax_m.apply(v, x), REL, "STGCN eval")
    want, new = flax_m.apply(v, x, train=True, mutable=["batch_stats"])
    m.train()
    with torch.no_grad():
        got = m(t(x)).numpy()
    assert_close_scaled(got, want, REL, "STGCN train")
    moved = to_jax_variables(m.state_dict())["batch_stats"]
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(moved),
                                 jax.tree_util.tree_leaves_with_path(_numpy(new["batch_stats"]))):
        assert_close_scaled(a, b, REL, jax.tree_util.keystr(path))
    assert not np.allclose(moved["data_bn"]["mean"], _numpy(v["batch_stats"])["data_bn"]["mean"])


POSE_CASES = {
    "patch": (dict(dataset_name="motionx", input_dim=322, patch_size=2), 322),
    "joints": (dict(dataset_name="human_ml3d", input_dim=263, joints=True), 263),
    "body_graph": (dict(dataset_name="human_ml3d", input_dim=263, body_graph=True,
                        gnn_cfg=dict(graph_cfg=dict(layout="smpl_parts", mode="spatial"),
                                     in_channels=8, base_channels=8, num_stages=2)), 263),
}


@pytest.mark.parametrize("case", sorted(POSE_CASES))
def test_pose_io_variants(case):
    kw, dim = POSE_CASES[case]
    rng = np.random.RandomState(9)
    L = 8
    x = rng.randn(2, 8, dim).astype(np.float32)
    flax_e = jax_stmogen.PoseEncoder(latent_dim=L, **kw)
    v, m = carry(flax_e, stmogen.PoseEncoder(latent_dim=L, **kw), x)
    with torch.no_grad():
        feat = m(t(x)).numpy()
    assert_close_scaled(feat, flax_e.apply(v, x), REL, f"PoseEncoder {case}")
    if case == "body_graph":
        return  # the decoder has no graph
    dkw = {k: kw[k] for k in ("dataset_name", "patch_size", "joints") if k in kw}
    flax_d = jax_stmogen.PoseDecoder(latent_dim=L, output_dim=dim, zero_init=False, **dkw)
    v, m = carry(flax_d, stmogen.PoseDecoder(latent_dim=L, output_dim=dim, zero_init=False,
                                             **dkw), feat)
    with torch.no_grad():
        got = m(t(feat)).numpy()
    assert got.shape == x.shape
    assert_close_scaled(got, flax_d.apply(v, feat), REL, f"PoseDecoder {case}")


# ----------------------------------------------------------------- the slice
def variant(name):
    """Tiny V1 / V2 / V3 (the tiny flagship with one override each)."""
    cfg = copy.deepcopy(tiny_t2m_cfg())
    m = cfg["model"]
    ca = m["ca_block_cfg"]
    if name == "v1":
        m["patch_size"] = ca["patch_size"] = 2
        ca["gate_type"] = "linear_top"
        m["ffn_cfg"] = [dict(m["ffn_cfg"], ffn_dim=16), dict(m["ffn_cfg"], ffn_dim=8)]
        return cfg
    H = 8 if name == "v2" else 23
    m.update(input_feats=263, latent_dim=8 * H)
    ca["num_heads"] = m["ffn_cfg"]["num_heads"] = H
    m["pose_encoder_cfg"].update(dataset_name="human_ml3d", input_dim=263)
    m["pose_decoder_cfg"].update(dataset_name="human_ml3d", output_dim=263)
    if name == "v2":
        m["pose_encoder_cfg"].update(body_graph=True, gnn_cfg=dict(
            graph_cfg=dict(layout="smpl_parts", mode="spatial"), in_channels=8,
            base_channels=8, num_stages=2))
        ca.update(num_text_heads=8, text_latent_dim=2)
    else:
        m["pose_encoder_cfg"]["joints"] = m["pose_decoder_cfg"]["joints"] = True
    return cfg


def build_pair(cfg, batch, seed=1):
    """(JAX architecture, jnp variables, numpy variables, the port's
    architecture on the CPU loaded with them)."""
    arch_j = build_jax(cfg)
    shapes = jax.eval_shape(lambda r: arch_j.init(r, batch), jax.random.PRNGKey(0))
    v = seeded_variables(shapes, seed)
    arch_t = build_torch(copy.deepcopy(cfg), device="cpu")
    arch_t.model.load_state_dict(from_jax_variables(v), strict=True)
    return arch_j, jax.tree_util.tree_map(jnp.asarray, v), v, arch_t


def text_batch(feats):
    return make_text_batch(["a person walks forward", "someone waves hello"], max_seq_len=T,
                           input_feats=feats, lengths=np.array([[T], [11]], np.int32))


_PAIRS = {}


def pair(name):
    """(batch, build_pair's four) of variant ``name``, built once a process."""
    if name not in _PAIRS:
        cfg = variant(name)
        batch = text_batch(cfg["model"]["input_feats"])
        _PAIRS[name] = (batch,) + build_pair(cfg, batch)
    return _PAIRS[name]


@pytest.mark.parametrize("name", ["v1", "v2", "v3"])
def test_sample_ddim(name):
    batch, arch_j, vj, _, arch_t = pair(name)
    rng = jax.random.PRNGKey(5)
    want = np.asarray(jax.jit(lambda v, b, r: arch_j.sample(v, b, r))(vj, batch, rng))
    noise = np.asarray(jax.random.normal(jax.random.split(rng)[0], batch["motion"].shape,
                                         jnp.float32))
    got = arch_t.sample(batch, noise=t(noise)).numpy()
    assert np.isfinite(got).all() and np.abs(want).max() > 1e-2
    assert_close_scaled(got, want, SAMPLE_REL, f"{name} sample")
    if name == "v1":  # the step cache holds the stack's patches
        assert tuple(arch_t.model.make_step_cache(2, T).shape) == (2, 4, T // 2, 8 * 12)


@pytest.mark.parametrize("name", ["v1", "v2", "v3"])
def test_weights_round_trip(name):
    """from_jax_variables then to_jax_variables gives every leaf back bit
    for bit: the PatchEmbed convs, the joint heads, the linear gates' wg,
    the STGCN's [k, 1, in, out] kernels, its PA and its batch_stats."""
    _, _, _, v, arch_t = pair(name)
    back = to_jax_variables(arch_t.model.state_dict())
    assert set(back) == set(v)
    for col in v:
        want = dict(jax.tree_util.tree_leaves_with_path(v[col]))
        got = dict(jax.tree_util.tree_leaves_with_path(back[col]))
        assert got.keys() == want.keys(), name
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=jax.tree_util.keystr(k))


def test_sample_bf16_v1():
    from motioncraft_tpu.apis.factory import bf16_cast_variables

    batch, arch_j, vj, _, arch_t = pair("v1")
    arch_t = copy.deepcopy(arch_t)
    bf16_cast_(arch_t)
    rng = jax.random.PRNGKey(5)
    want = np.asarray(jax.jit(lambda v, b, r: arch_j.sample(v, b, r, compute_dtype=jnp.bfloat16))(
        bf16_cast_variables(vj), batch, rng))
    noise = np.asarray(jax.random.normal(jax.random.split(rng)[0], batch["motion"].shape,
                                         jnp.float32))
    got = arch_t.sample(batch, noise=t(noise), compute_dtype=torch.bfloat16).numpy()
    assert_close_scaled(got, want, BF16_REL, "v1 bf16 sample")


def test_train_forward_v2():
    """V2's training forward (the per-head text keys through K5's plain
    version, the MoEs' slot path) at gate noise 0.  The JAX package's
    denoiser calls its PoseEncoder without the train flag, so the body
    graph's BatchNorms normalise with their running statistics and leave
    them as they were; the port's do the same."""
    batch, _, vj, _, arch_t = pair("v2")
    cfg = variant("v2")
    cfg["model"]["ca_block_cfg"]["gate_noise"] = 0.0
    arch_j = build_jax(cfg)
    arch_t = copy.deepcopy(arch_t)
    for m in arch_t.modules():
        if isinstance(m, moe.MoELayer):
            m.gate_noise = 0.0
    rng = np.random.RandomState(4)
    x = rng.randn(2, T, 263).astype(np.float32)
    ts = np.array([10, 600], np.int32)
    cond = np.array([[[1]], [[0]]], np.int32)
    xf = arch_j.encode_text(vj, batch["text_ids"])
    (want, new) = jax.jit(lambda v: arch_j.model.apply(
        v, x, ts, motion_mask=batch["motion_mask"], motion_length=batch["motion_length"],
        xf_out=xf, cond_type=cond, mode="train", train=True,
        mutable=["losses", "batch_stats"]))(vj)
    arch_t.train()
    with torch.no_grad():
        got = arch_t.model(t(x), t(ts, torch.long), motion_mask=t(batch["motion_mask"]),
                           motion_length=t(batch["motion_length"]),
                           xf_out=t(np.asarray(xf)), cond_type=t(cond), mode="train",
                           aux_losses=[]).numpy()
    arch_t.eval()
    assert_close_scaled(got, want, SAMPLE_REL, "v2 training forward")
    stats = to_jax_variables(arch_t.model.state_dict())["batch_stats"]
    for (path, a), (_, b), (_, c) in zip(*(jax.tree_util.tree_leaves_with_path(tree) for tree in (
            stats, _numpy(new["batch_stats"]), _numpy(vj["batch_stats"])))):
        np.testing.assert_array_equal(a, b, err_msg=jax.tree_util.keystr(path))
        np.testing.assert_array_equal(a, c, err_msg=jax.tree_util.keystr(path))


def test_controlnet_over_a_patched_base():
    """The ControlNet with patch_size 2 over a base of patch_size 2 (its
    condition patched by ``condition_patch``): the CFG test forward with the
    condition on, and its step cache's shapes."""
    from motioncraft_tpu.config import Config as JaxConfig
    from motioncraft_tpu_torch.config import Config
    from test_torch_controlnet import CONFIG, _batch, _forward_jax, _forward_torch, _inputs

    cfgs = []
    for cfg in (JaxConfig.fromfile(CONFIG).model, Config.fromfile(CONFIG).model):
        cfg["model"]["patch_size"] = 2
        cfg["model"]["base_model"]["patch_size"] = 2
        cfg["model"]["base_model"]["ca_block_cfg"]["patch_size"] = 2
        cfgs.append(cfg)
    batch = _batch()
    arch_j = build_jax(cfgs[0])
    shapes = jax.eval_shape(lambda r: arch_j.init(r, batch), jax.random.PRNGKey(0))
    v = seeded_variables(shapes, 1)
    arch_t = build_torch(cfgs[1], device="cpu")
    arch_t.model.load_state_dict(from_jax_variables(v), strict=True)
    assert isinstance(arch_t.model.condition_patch, blocks.PatchEmbed1D)
    x, ts = _inputs()
    want, _ = _forward_jax(arch_j, v["params"], batch, x, ts, batch["c"])
    got, _ = _forward_torch(arch_t, batch, x, ts, batch["c"])
    assert got.shape == x.shape
    assert_close_scaled(got, want, REL, "patched ControlNet forward")
    cache = arch_t.model.make_step_cache(2, T)
    assert tuple(cache["h"].shape[2:]) == tuple(cache["c"].shape[2:]) == (T // 2, 96)
    bad = copy.deepcopy(cfgs[1])
    bad["model"]["patch_size"] = 4
    with pytest.raises(ValueError, match="patch_size"):
        build_torch(bad, device="cpu")


def test_reference_checkpoint_patch_embed():
    """A reference ``.pth``'s PatchEmbed1D conv (``{part}_embed.proj``)
    converts as the JAX package's converter converts it."""
    from motioncraft_tpu.utils import torch_convert as jax_convert
    from motioncraft_tpu_torch.utils import torch_convert

    rng = np.random.RandomState(2)
    sd = {"joint_embed.head_embed.proj.weight": rng.randn(8, 5, 2).astype(np.float32),
          "joint_embed.head_embed.proj.bias": rng.randn(8).astype(np.float32),
          "joint_embed.body_embed.weight": rng.randn(8, 9).astype(np.float32),
          "joint_embed.body_embed.bias": rng.randn(8).astype(np.float32)}
    want = jax_convert.t_pose_io(sd, "joint_embed", "embed")
    got = torch_convert.t_pose_io(sd, "joint_embed", "embed")
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(a, b)


def test_what_jax_cannot_run_still_raises():
    """Two text heads over twelve, a patch size on the stack alone, a
    pipelined stack with an ffn_cfg list and the 8-node graph over
    motionx's 12 part tokens: the JAX package fails on each."""
    with pytest.raises(ValueError, match="text heads"):
        attentions.STMA(**dict(STMA_KW, num_heads=12, num_text_heads=2))
    cfg = variant("v1")["model"]
    for change in (dict(ca_block_cfg=dict(cfg["ca_block_cfg"], patch_size=1)),
                   dict(patch_size=1, ca_block_cfg=dict(cfg["ca_block_cfg"], patch_size=1),
                        pipeline_axis="pipe")):
        kw = {k: v for k, v in dict(cfg, **change).items() if k != "type"}
        with pytest.raises(ValueError, match="patch_size|ffn_cfg"):
            stmogen.STMoGenTransformer(**kw)
    with pytest.raises(ValueError, match="8-node graph"):
        stmogen.PoseEncoder(dataset_name="motionx", latent_dim=8, input_dim=322,
                            body_graph=True, gnn_cfg=dict(
                                graph_cfg=dict(layout="smpl_parts"), in_channels=8,
                                base_channels=8, num_stages=2))
