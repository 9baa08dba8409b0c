"""Checkpoint I/O of the port against the JAX package, on the tiny T2M
config and a tiny SMPL-X evaluator.

- A reference-layout STMoGen ``.pth`` and SMPL-X evaluator ``.ckpt``
  (fabricated from the flax trees' shapes) load into the port with the
  same tensors, exactly, as the JAX converter's route (its ``convert_*``,
  then ``from_jax_params``); the loaded models agree with JAX's.
- A ``save_params`` ``.npz`` of either package loads into the other, with
  equal outputs; ``to_jax_params`` inverts ``from_jax_params`` bit for bit.
- A resumed training run computes, step for step, what the uninterrupted
  one does.

Tolerance of the outputs: 1e-4 x max(1, max |JAX|) for the denoiser, as in
test_torch_sample.py; 1e-5 x max(1, max |JAX|) for the evaluator.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import unfreeze

import motioncraft_tpu.models  # noqa: F401  (registers the flax classes)
from fabricate_torch import lin, ln, stmogen_sd
from motioncraft_tpu.apis.factory import make_text_batch, tiny_t2m_cfg
from motioncraft_tpu.eval.models import T2MContrastiveModel_SMPLX as JaxEvaluator
from motioncraft_tpu.registry import build_architecture as build_jax
from motioncraft_tpu.utils import checkpoint as jax_ckpt
from motioncraft_tpu.utils import torch_convert as jax_convert
from motioncraft_tpu_torch.apis import make_train_batch, train_model
from motioncraft_tpu_torch.apis.factory import tiny_t2m_cfg as torch_tiny_cfg
from motioncraft_tpu_torch.eval.models import T2MContrastiveModel_SMPLX
from motioncraft_tpu_torch.registry import build_architecture as build_torch
from motioncraft_tpu_torch.utils import checkpoint, torch_convert
from motioncraft_tpu_torch.utils.convert import (fabricate_state_dict, from_jax_params,
                                                 to_jax_params)
from torch_port_util import assert_close_scaled, seeded_params, t

REL = 1e-4
EVAL_REL = 1e-5
EVALUATOR = dict(
    motion_encoder=dict(nfeats=322, vae=True, num_layers=4, latent_dim=16, ff_size=24,
                        num_heads=2),
    text_encoder=dict(num_layers=4, latent_dim=16, ff_size=24, num_heads=2,
                      bert_cfg=dict(vocab_size=30522, dim=16, n_layers=6, n_heads=2,
                                    hidden_dim=32, max_position=64)))


def _scaled(sd, factor=0.3):
    """Fabricated N(0, 1) tensors tamed so the random stack stays in range."""
    return {k: (v * factor).astype(np.float32) for k, v in sd.items()}


@pytest.fixture(scope="module")
def tiny():
    cfg = tiny_t2m_cfg()
    arch_j = build_jax(cfg)
    batch = make_text_batch(["a person walks forward", "someone waves hello"],
                            max_seq_len=16, lengths=np.array([[16], [11]], np.int32))
    variables = unfreeze(arch_j.init(jax.random.PRNGKey(0), batch))
    return cfg, arch_j, jax.tree_util.tree_map(np.asarray, variables), batch


def _forward_jax(arch_j, variables, batch, x, ts):
    xf = arch_j.encode_text(variables, batch["text_ids"])
    tf = arch_j.model.apply(variables, xf, method="precompute_text_feats")
    return np.asarray(jax.jit(lambda v: arch_j.model.apply(
        v, x, ts, motion_mask=batch["motion_mask"], motion_length=batch["motion_length"],
        xf_out=xf, text_feats=tf, mode="test"))(variables))


def _forward_torch(arch_t, batch, x, ts):
    with torch.no_grad():
        xf = arch_t.encode_text(batch["text_ids"])
        return arch_t.model(t(x), t(ts, torch.long), motion_mask=t(batch["motion_mask"]),
                            motion_length=t(batch["motion_length"]), xf_out=xf,
                            text_feats=arch_t.model.precompute_text_feats(xf)).numpy()


def _inputs(batch):
    x = np.random.RandomState(3).randn(*batch["motion"].shape).astype(np.float32)
    return x, np.full((2,), 499, np.int32)


def _assert_same_state(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


def test_reference_stmogen_pth_loads_like_the_jax_route(tiny, tmp_path):
    cfg, arch_j, variables, batch = tiny
    m = cfg["model"]
    dims = (m["num_layers"], m["ffn_cfg"]["num_heads"], m["text_encoder"]["num_layers"],
            m["text_encoder"]["clip_layers"])
    sd = _scaled(stmogen_sd(variables["params"], np.random.RandomState(0), *dims,
                            prefix="model."))
    path = str(tmp_path / "stmogen.pth")
    torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in sd.items()}}, path)

    # the JAX converter's route (its load_stmogen_ckpt remaps every block
    # key under a ControlNet base_block and so reads no base-only file)
    loaded = jax.tree_util.tree_map(np.copy, variables)
    jax_convert._tree_update(loaded["params"], jax_convert.convert_stmogen(
        jax_convert.load_torch_state_dict(path), *dims))
    want = from_jax_params(loaded["params"])
    arch_t = build_torch(torch_tiny_cfg(), device="cpu")
    got = torch_convert.load_stmogen_ckpt(path, arch_t.model, *dims)
    _assert_same_state(got, want)
    _assert_same_state(arch_t.model.state_dict(), want)
    # the same file through the eval loader of the port, and the same
    # weights as the base of a merged ControlNet checkpoint
    again = build_torch(torch_tiny_cfg(), device="cpu")
    _assert_same_state(checkpoint.load_eval_variables(cfg, again.model,
                                                      torch_checkpoint=path), want)
    merged = {k.replace(".ca_block.", ".base_block.ca_block.").replace(
        ".ffn.", ".base_block.ffn."): torch.from_numpy(v) for k, v in sd.items()}
    merged["model.control_blocks.0.weight"] = torch.zeros(2)
    torch.save(merged, str(tmp_path / "merged.pth"))
    _assert_same_state(torch_convert.load_stmogen_ckpt(
        str(tmp_path / "merged.pth"), again.model, *dims), want)

    x, ts = _inputs(batch)
    ref = _forward_jax(arch_j, jax.tree_util.tree_map(jnp.asarray, loaded), batch, x, ts)
    assert np.abs(ref).max() > 1e-3
    assert_close_scaled(_forward_torch(arch_t, batch, x, ts), ref, REL, "forward_test")


def test_a_checkpoint_of_another_shape_is_refused(tiny, tmp_path):
    cfg, _, variables, _ = tiny
    m = cfg["model"]
    sd = stmogen_sd(variables["params"], np.random.RandomState(0), m["num_layers"],
                    m["ffn_cfg"]["num_heads"], 1, 1)
    sd["text_ln.weight"] = np.ones(7, np.float32)
    path = str(tmp_path / "bad.pth")
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    with pytest.raises(ValueError, match="shape mismatch"):
        torch_convert.load_stmogen_ckpt(path, build_torch(torch_tiny_cfg(), device="cpu").model,
                                        m["num_layers"], m["ffn_cfg"]["num_heads"], 1, 1)


def _postln(sd, prefix, tree, rng):
    a = tree["self_attn"]
    sd[f"{prefix}.self_attn.in_proj_weight"] = rng.randn(
        *a["in_proj"]["kernel"].shape[::-1]).astype(np.float32)
    sd[f"{prefix}.self_attn.in_proj_bias"] = rng.randn(
        *a["in_proj"]["bias"].shape).astype(np.float32)
    lin(sd, f"{prefix}.self_attn.out_proj", a["out_proj"], rng)
    for nm in ("linear1", "linear2"):
        lin(sd, f"{prefix}.{nm}", tree[nm], rng)
    for nm in ("norm1", "norm2"):
        ln(sd, f"{prefix}.{nm}", tree[nm], rng)


def evaluator_sd(motion, text, rng, num_layers=4):
    """A reference-layout SMPL-X evaluator state dict ('motionencoder.*',
    'textencoder.*', DistilBERT named as HuggingFace does) with the shapes
    of the flax trees ``motion`` and ``text``."""
    sd = {}
    lin(sd, "motionencoder.skel_embedding", motion["skel_embedding"], rng)
    for enc, tree in (("motionencoder", motion), ("textencoder", text)):
        for tok in ("mu_token", "logvar_token"):
            sd[f"{enc}.{tok}"] = rng.randn(*tree[tok].shape).astype(np.float32)
        for i in range(num_layers):
            _postln(sd, f"{enc}.seqTransEncoder.layers.{i}", tree[f"layer_{i}"], rng)
    lin(sd, "textencoder.projection.1", text["projection"], rng)
    bert, p = text["text_model"], "textencoder.text_model"
    for nm in ("word_embeddings", "position_embeddings"):
        sd[f"{p}.embeddings.{nm}.weight"] = rng.randn(
            *bert[nm]["embedding"].shape).astype(np.float32)
    ln(sd, f"{p}.embeddings.LayerNorm", bert["emb_ln"], rng)
    for i in range(6):
        layer, lp = bert[f"layer_{i}"], f"{p}.transformer.layer.{i}"
        d = layer["self_attn"]["out_proj"]["kernel"].shape[0]
        for nm in ("q_lin", "k_lin", "v_lin"):
            lin(sd, f"{lp}.attention.{nm}", {"kernel": np.zeros((d, d)),
                                             "bias": np.zeros(d)}, rng)
        lin(sd, f"{lp}.attention.out_lin", layer["self_attn"]["out_proj"], rng)
        lin(sd, f"{lp}.ffn.lin1", layer["linear1"], rng)
        lin(sd, f"{lp}.ffn.lin2", layer["linear2"], rng)
        ln(sd, f"{lp}.sa_layer_norm", layer["norm1"], rng)
        ln(sd, f"{lp}.output_layer_norm", layer["norm2"], rng)
    return _scaled(sd)


def test_reference_evaluator_ckpt_loads_like_the_jax_route(tmp_path):
    shapes = JaxEvaluator(**EVALUATOR)
    sd = evaluator_sd(shapes.motion_params["params"], shapes.text_params["params"],
                      np.random.RandomState(1))
    path = str(tmp_path / "epoch=199.ckpt")
    torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in sd.items()}}, path)
    init_cfg = dict(type="Pretrained", checkpoint=path)
    jax_ev = JaxEvaluator(**EVALUATOR, init_cfg=init_cfg)
    ev = T2MContrastiveModel_SMPLX(**EVALUATOR, init_cfg=init_cfg, device="cpu")
    assert jax_ev.pretrained_loaded and ev.pretrained_loaded
    _assert_same_state(ev.motion_module.state_dict(),
                       from_jax_params(jax_ev.motion_params["params"]))
    _assert_same_state(ev.text_module.state_dict(),
                       from_jax_params(jax_ev.text_params["params"]))

    rng = np.random.RandomState(2)
    motion = rng.randn(3, 10, 322).astype(np.float32)
    lengths = np.array([10, 7, 4])
    texts = ["a person walks", "someone jumps up and down", "waves"]
    assert_close_scaled(ev.encode_motion(motion, lengths).numpy(),
                        jax_ev.encode_motion(motion, lengths), EVAL_REL, "encode_motion")
    assert_close_scaled(ev.encode_text(texts).numpy(), jax_ev.encode_text(texts),
                        EVAL_REL, "encode_text")


def test_to_jax_params_inverts_from_jax_params(tiny):
    _, _, variables, _ = tiny
    params = seeded_params(variables["params"], 5)
    sd = from_jax_params(params)
    back = to_jax_params(sd)
    flat_p = jax.tree_util.tree_leaves_with_path(params)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [jax.tree_util.keystr(p) for p, _ in flat_p] == [
        jax.tree_util.keystr(p) for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_p, flat_b):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    _assert_same_state(from_jax_params(back), sd)


def test_npz_snapshots_cross_between_the_packages(tiny, tmp_path):
    cfg, arch_j, variables, batch = tiny
    params = seeded_params(variables["params"], 6)
    x, ts = _inputs(batch)

    # written by the JAX package, evaluated by the port
    jax_ckpt.save_params(str(tmp_path / "jax.npz"), {"params": params})
    arch_t = build_torch(torch_tiny_cfg(), device="cpu")
    checkpoint.load_eval_variables(cfg, arch_t.model, checkpoint=str(tmp_path / "jax.npz"))
    ref = _forward_jax(arch_j, {"params": jax.tree_util.tree_map(jnp.asarray, params)},
                       batch, x, ts)
    assert_close_scaled(_forward_torch(arch_t, batch, x, ts), ref, REL, "jax.npz")

    # written by the port, evaluated by the JAX package
    other = build_torch(torch_tiny_cfg(), device="cpu")
    other.model.load_state_dict(fabricate_state_dict(other.model, seed=3))
    checkpoint.save_params(str(tmp_path / "port.npz"), other.model)
    loaded = jax_ckpt.load_params(str(tmp_path / "port.npz"))
    assert jax.tree_util.tree_structure(loaded["params"]) == jax.tree_util.tree_structure(
        variables["params"])
    got = _forward_jax(arch_j, jax.tree_util.tree_map(jnp.asarray, loaded), batch, x, ts)
    assert_close_scaled(_forward_torch(other, batch, x, ts), got, REL, "port.npz")


def test_pipelined_snapshots_are_refused(tiny):
    """A snapshot that misses a layer is refused where a pipelined config
    stacks its blocks (align_block_layout); a stacked one unstacks for the
    plain config, and the stacked layout stays for the pipelined one."""
    cfg, _, _, _ = tiny
    piped = {"model": dict(cfg["model"], pipeline_axis="pipe")}
    layers = cfg["model"]["num_layers"]
    blocks = {f"block_{i}": {"w": np.full((2,), i, np.float32)} for i in range(layers)}
    with pytest.raises(KeyError, match=f"block_{layers}"):
        checkpoint.align_block_layout(
            {"model": dict(piped["model"], num_layers=layers + 1)}, {"params": blocks})
    stacked = checkpoint.align_block_layout(piped, {"params": dict(blocks)})["params"]
    assert list(stacked) == ["stacked_blocks"]
    assert stacked["stacked_blocks"]["w"].shape == (layers, 2)
    assert checkpoint.align_block_layout(piped, {"params": stacked})["params"] is stacked
    plain = checkpoint.align_block_layout(cfg, {"params": stacked})["params"]
    assert sorted(plain) == sorted(blocks)
    assert all(np.array_equal(plain[k]["w"], blocks[k]["w"]) for k in blocks)
    with pytest.raises(NotImplementedError, match="no converter reads them"):
        checkpoint.load_eval_variables({"model": {"type": "MotionVAE"}}, None,
                                       torch_checkpoint="x.pth")


def _train(arch, epochs, **kw):
    lines = []
    batches = [make_train_batch(2, seed=s, max_seq_len=16) for s in range(2)]
    train_model(arch, batches, max_epochs=epochs, steps_per_epoch=1, seed=3,
                log_interval=1, logger=lines.append, **kw)
    return [ln_ for ln_ in lines if " loss=" in ln_]


def test_resume_continues_the_run_exactly(tmp_path):
    def fresh(seed):
        arch = build_torch(torch_tiny_cfg(), device="cpu")
        arch.model.load_state_dict(fabricate_state_dict(arch.model, seed=seed))
        return arch

    straight = fresh(0)
    want = _train(straight, 3)
    first = fresh(0)
    _train(first, 2, checkpoint_fn=lambda state, epoch: checkpoint.save_checkpoint(
        str(tmp_path), state, epoch))
    assert checkpoint.latest_checkpoint(str(tmp_path)).endswith("epoch_1.pth")
    resumed = fresh(1)  # other weights: the checkpoint must replace them all
    got = _train(resumed, 3, resume_dir=str(tmp_path))
    assert len(got) == 1 and got[0].split(" step_ms=")[0] == want[2].split(" step_ms=")[0]
    _assert_same_state(resumed.model.state_dict(), straight.model.state_dict())
