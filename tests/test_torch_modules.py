"""The port's modules against their flax counterparts at tiny widths.

Each flax module is initialised, its ``params`` replaced by a seeded tree
(numpy), and the same tree carried into the port by ``from_jax_params``
(``load_state_dict(strict=True)``, so no parameter is left unmapped).  Then
the same numpy inputs go through both.  The JAX package runs its CPU paths
(the MoE slot dispatch, the einsum SFFN, the XLA STMA attention); the port
runs the rank-compact dispatch and its kernels' plain versions.  Tolerance:
1e-5 x max(1, max |flax|), the order of the sums being the only difference.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motioncraft_tpu.models import attentions as jax_att
from motioncraft_tpu.models import blocks as jax_blocks
from motioncraft_tpu.models import moe as jax_moe
from motioncraft_tpu.models import text_encoder as jax_text
from motioncraft_tpu_torch.models import attentions, blocks, moe, text_encoder
from motioncraft_tpu_torch.models.architecture import MotionDiffusion, resolve_device
from motioncraft_tpu_torch.models.baselines import ReMoDiffuseTransformer
from motioncraft_tpu_torch.apis.factory import tiny_t2m_cfg
from motioncraft_tpu_torch.ops import moe_positions_counts_plain, moe_route_plain
from motioncraft_tpu_torch.ops.moe_ffn import BLOCK
from motioncraft_tpu_torch.utils.convert import from_jax_params
from torch_port_util import assert_close_scaled, seeded_params, t

REL = 1e-5


def _j(args, kw):
    conv = lambda a: jnp.asarray(a) if isinstance(a, np.ndarray) else a  # noqa: E731
    return [conv(a) for a in args], {k: conv(a) for k, a in kw.items()}


def carry(flax_module, torch_module, *init_args, seed=1, **init_kw):
    """Seeded flax params -> (flax variables, the torch module loaded)."""
    args, kw = _j(init_args, init_kw)
    variables = jax.jit(lambda: flax_module.init(jax.random.PRNGKey(0), *args, **kw))()
    params = seeded_params(jax.tree_util.tree_map(np.asarray, variables["params"]), seed)
    torch_module.load_state_dict(from_jax_params(params), strict=True)
    return {"params": jax.tree_util.tree_map(jnp.asarray, params)}, torch_module.eval()


def japply(flax_module, variables, *args, **kw):
    """flax apply, jitted (eager flax dispatch is an order slower here)."""
    args, kw = _j(args, kw)
    return jax.jit(lambda v: flax_module.apply(v, *args, **kw))(variables)


def test_timestep_embedding():
    ts = np.array([0, 17, 999], np.int32)
    assert_close_scaled(blocks.timestep_embedding(t(ts), 9).numpy(),
                        jax_blocks.timestep_embedding(jnp.asarray(ts), 9), REL)


def test_stylization_block():
    rng = np.random.RandomState(0)
    h, emb = rng.randn(2, 5, 24).astype(np.float32), rng.randn(2, 32).astype(np.float32)
    v, m = carry(jax_blocks.StylizationBlock(24, 32), blocks.StylizationBlock(24, 32), h, emb)
    want = japply(jax_blocks.StylizationBlock(24, 32), v, h, emb)
    assert_close_scaled(m(t(h), t(emb)).detach().numpy(), want, REL)


def test_sffn():
    rng = np.random.RandomState(1)
    x, emb = rng.randn(2, 7, 3 * 16).astype(np.float32), rng.randn(2, 32).astype(np.float32)
    flax_m = jax_blocks.SFFN(latent_dim=16, ffn_dim=24, num_heads=3, time_embed_dim=32)
    v, m = carry(flax_m, blocks.SFFN(16, 24, 3, time_embed_dim=32), x, emb)
    assert_close_scaled(m(t(x), t(emb)).detach().numpy(), japply(flax_m, v, x, emb), REL)


@pytest.mark.parametrize("drops", [False, True])
def test_moe_layer(drops):
    """No-drop routing, and a skewed batch whose experts overflow capacity
    (arrival-order drops must fall on the same choices in both)."""
    N, D, E, K = 600, 16, 4, 2
    rng = np.random.RandomState(2)
    x = rng.randn(N, D).astype(np.float32)
    if drops:
        x = x + 3.0 * rng.randn(1, D).astype(np.float32)  # one shared direction
    flax_m = jax_moe.MoELayer(E, K, D, 2 * D)
    v, m = carry(flax_m, moe.MoELayer(E, K, D, 2 * D), x)
    with torch.no_grad():
        got = m(t(x)).numpy()
        idx = m.gate(t(x)).softmax(1).topk(K, dim=1).indices
        counts = moe_positions_counts_plain(idx.t().reshape(-1).int(), E)[1]
    capacity = K * int(1.5 * ((N + E - 1) // E))
    assert (int(counts.max()) > capacity) == drops
    want, _ = japply(flax_m, v, x)
    assert_close_scaled(got, want, REL, "MoELayer")


@pytest.mark.parametrize("E,K", [(16, 2), (4, 1), (16, 1)])
def test_moe_layer_widths(E, K):
    """Other expert counts and top-k than test_moe_layer's, on a skewed
    batch (drops) through the same routing call."""
    N, D = 500, 16
    rng = np.random.RandomState(E + K)
    x = (rng.randn(N, D) + 2.0 * rng.randn(1, D)).astype(np.float32)
    flax_m = jax_moe.MoELayer(E, K, D, 2 * D)
    v, m = carry(flax_m, moe.MoELayer(E, K, D, 2 * D), x)
    with torch.no_grad():
        got = m(t(x)).numpy()
        counts = moe_route_plain(m.gate(t(x)), K, m.capacity(N), BLOCK).counts
    assert int(counts.max()) > m.capacity(N)
    want, _ = japply(flax_m, v, x)
    assert_close_scaled(got, want, REL, "MoELayer")


def test_eval_moe_routes_in_one_call(monkeypatch):
    """The inference MoE routes through one moe_route call and, outside it,
    sorts, searches and one-hot encodes nothing."""
    N, D, E, K = 300, 16, 4, 2
    m = moe.MoELayer(E, K, D, 2 * D).eval()
    x = torch.from_numpy(np.random.RandomState(7).randn(N, D).astype(np.float32))
    calls, inside = [], [False]

    def route(*args):
        calls.append(args[1:])
        inside[0] = True
        try:
            return moe_route_plain(*args)
        finally:
            inside[0] = False

    def forbid(fn):
        def wrapped(*a, **kw):
            assert inside[0], f"{fn.__name__} outside moe_route"
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(moe, "moe_route", route)
    for owner, name in ((torch, "sort"), (torch, "searchsorted"), (torch.nn.functional, "one_hot")):
        monkeypatch.setattr(owner, name, forbid(getattr(owner, name)))
    with torch.no_grad():
        y = m(x)
    assert calls == [(K, m.capacity(N), BLOCK)] and y.shape == (N, D)


def test_moe_wrapper():
    rng = np.random.RandomState(3)
    x = rng.randn(2, 9, 3, 16).astype(np.float32)
    flax_m = jax_moe.MOE(4, 2, 16, 32, 24, 3, 12)
    v, m = carry(flax_m, moe.MOE(4, 2, 16, 32, 24, 3, 12), x)
    want, _ = japply(flax_m, v, x)
    with torch.no_grad():
        assert_close_scaled(m(t(x)).numpy(), want, REL, "MOE")


def test_efficient_self_attention_merged_lanes():
    rng = np.random.RandomState(4)
    x = rng.randn(6, 12, 32).astype(np.float32)
    mask = (rng.rand(6, 12, 1) > 0.2).astype(np.float32)
    flax_m = jax_att.EfficientSelfAttention(32, 8, 0.0, time_embed_dim=None,
                                            merged_lanes=True)
    v, m = carry(flax_m, attentions.EfficientSelfAttention(32, 8, merged_lanes=True),
                 x, src_mask=mask)
    with torch.no_grad():
        assert_close_scaled(m(t(x), t(mask)).numpy(), japply(flax_m, v, x, src_mask=mask), REL)


STMA_KW = dict(latent_dim=8, text_latent_dim=16, num_heads=6, num_text_heads=1,
               num_experts=4, topk=2, ffn_dim=16, time_embed_dim=32, max_seq_len=12,
               max_text_seq_len=77, dynamic_body=True)


@pytest.mark.parametrize("cfg_dedup,hoist", [(False, False), (True, False), (True, True)])
def test_stma(cfg_dedup, hoist):
    """STMA on a CFG-doubled batch (halves identical up to cond_type), with
    and without the layer-0 dedup and the hoisted text features."""
    rng = np.random.RandomState(5)
    B, T, TXT = 2, 12, 77
    x = np.tile(rng.randn(B, T, 6 * 8).astype(np.float32), (2, 1, 1))
    xf = np.tile(rng.randn(B, TXT, 16).astype(np.float32), (2, 1, 1))
    emb = np.tile(rng.randn(B, 32).astype(np.float32), (2, 1))
    mask = np.ones((2 * B, T, 1), np.float32)
    mask[1::2, 8:] = 0
    cond = np.concatenate([np.ones((B, 1, 1)), np.zeros((B, 1, 1))]).astype(np.float32)
    flax_m = jax_att.STMA(**STMA_KW)
    kw = dict(xf=xf, emb=emb, src_mask=mask, cond_type=cond)
    v, m = carry(flax_m, attentions.STMA(**STMA_KW), x, **kw)
    text_feat = None
    if hoist:
        text_feat = japply(flax_m, v, None, xf=xf, text_only=True)
    want = japply(flax_m, v, x, cfg_dedup=cfg_dedup, text_feat=text_feat, **kw)
    with torch.no_grad():
        tf = m.text_branch(t(xf)) if hoist else None
        if hoist:
            assert_close_scaled(tf.numpy(), text_feat, REL, "text branch")
        got = m(t(x), xf=t(xf), emb=t(emb), src_mask=t(mask), cond_type=t(cond),
                cfg_dedup=cfg_dedup, text_feat=tf).numpy()
    assert_close_scaled(got, want, REL, "STMA")


def test_text_encoder():
    ids = np.random.RandomState(6).randint(1, 49408, (2, 77)).astype(np.int32)
    kw = dict(latent_dim=16, num_layers=2, ff_size=32, num_heads=4, clip_width=32,
              clip_layers=2)
    flax_m = jax_text.TextEncoder(**kw)
    v, m = carry(flax_m, text_encoder.TextEncoder(**kw), ids)
    with torch.no_grad():
        assert_close_scaled(m(t(ids, torch.long)).numpy(), japply(flax_m, v, ids), REL)


def test_entry_points_need_a_card_or_an_explicit_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MotionDiffusion(**{k: v for k, v in tiny_t2m_cfg().items() if k != "type"})
    assert resolve_device("cpu") == torch.device("cpu")


def _stmogen(**change):
    from motioncraft_tpu_torch.models.stmogen import STMoGenTransformer

    model = {k: v for k, v in tiny_t2m_cfg()["model"].items() if k != "type"}
    return STMoGenTransformer(**dict(model, **change))


def _pose_encoder_graph_on_motionx():
    from motioncraft_tpu_torch.models.stmogen import PoseEncoder

    return PoseEncoder(dataset_name="motionx", latent_dim=8, input_dim=322, body_graph=True,
                       gnn_cfg=dict(graph_cfg=dict(layout="smpl_parts"), in_channels=8,
                                    base_channels=8, num_stages=2))


@pytest.mark.parametrize("build,error,match", [
    # what the JAX package cannot run either (the patch sizes, the linear
    # gate, learned variances and one text head a head are ported:
    # tests/test_torch_zoo_stmogen.py, tests/test_torch_zoo_diffusion.py):
    # two text heads over six, a patch size on the stack alone, a pipelined
    # stack with an ffn_cfg list, the 8-node part graph over motionx's 12
    # part tokens, and ReMoDiffuse's training (the JAX package's loss
    # passes no retrieval)
    (lambda: attentions.STMA(**dict(STMA_KW, num_text_heads=2)), ValueError,
     "2 text heads and 6 heads"),
    (lambda: _stmogen(patch_size=2), ValueError, "patch_size 2 over a ca_block of patch_size 1"),
    (lambda: _stmogen(pipeline_axis="pipe", ffn_cfg=[tiny_t2m_cfg()["model"]["ffn_cfg"]] * 2),
     ValueError, "per-layer ffn_cfg lists cannot be stacked"),
    (_pose_encoder_graph_on_motionx, ValueError, "8-node graph does not fit 12 part tokens"),
    (lambda: ReMoDiffuseTransformer(text_encoder=dict(clip_width=32,
                                                      clip_layers=1)).forward_train(),
     NotImplementedError, "training ReMoDiffuseTransformer"),
], ids=["two_text_heads", "patch_on_stack_alone", "pipeline_ffn_list", "graph_on_motionx",
        "remodiffuse_train"])
def test_cut_branches_raise(build, error, match):
    with pytest.raises(error, match=match):
        build()


@pytest.mark.parametrize("dataset,dim", [("motionx", 322), ("human_ml3d", 263),
                                         ("kit_ml", 251)])
@pytest.mark.parametrize("side", ["encoder", "decoder"])
def test_pose_io(dataset, dim, side):
    """PoseEncoder / PoseDecoder of each body layout the configs use."""
    from motioncraft_tpu.models import stmogen as jax_stmogen
    from motioncraft_tpu_torch.models import stmogen

    rng = np.random.RandomState(8)
    L, n_parts = 8, len(stmogen.body_layout.part_slices(dataset))
    if side == "encoder":
        x = rng.randn(2, 5, dim).astype(np.float32)
        flax_m = jax_stmogen.PoseEncoder(dataset_name=dataset, latent_dim=L, input_dim=dim)
        m = stmogen.PoseEncoder(dataset_name=dataset, latent_dim=L, input_dim=dim)
    else:
        x = rng.randn(2, 5, (n_parts + 1) * L).astype(np.float32)
        flax_m = jax_stmogen.PoseDecoder(dataset_name=dataset, latent_dim=L, output_dim=dim)
        m = stmogen.PoseDecoder(dataset_name=dataset, latent_dim=L, output_dim=dim)
    v, m = carry(flax_m, m, x)
    want = japply(flax_m, v, x)
    assert want.shape[-1] == ((n_parts + 1) * L if side == "encoder" else dim)
    with torch.no_grad():
        assert_close_scaled(m(t(x)).numpy(), want, REL, f"{side} {dataset}")
