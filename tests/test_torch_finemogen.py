"""FineMoGen in the port against the JAX package at tiny widths, on one
seeded flax tree carried over by ``from_jax_params`` (``strict=True``):
SAMI alone at ``num_intervals`` 1 and 2 (each run of NI rows one sequence
of intervals), the whole ``FineMoGenTransformer.forward_test`` (2 layers,
12 heads x 8, 4 experts), and DDIM sampling through
``MotionDiffusion.sample`` on the JAX run's draws replayed.  The JAX
package samples FineMoGen only with ``text_hoist=False``: its hoist calls
SAMI without motion and raises, which a test here pins; the port's default
computes what JAX computes with the hoist off.  Also the reference
checkpoint converter (bit for bit the JAX one's on a fabricated state
dict), the CLIs' bf16, int8 and step-cache options on it; SAMI in
training and the training loss
against JAX at gate noise 0 (tests/test_torch_baseline_train.py holds the
gradients).

Tolerances: SAMI 1e-5 x max(1, max |JAX|) (sums in another order, erf
from another library; the gate logits well apart, the MoE position
embeddings x 8); a whole forward and a sample 1e-4 x scale, as
test_torch_sample.py holds the flagship."""

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
from motioncraft_tpu.registry import build_architecture as build_jax
from motioncraft_tpu.utils import torch_convert as jax_tc
from motioncraft_tpu_torch.models import attentions as port_att
from motioncraft_tpu_torch.registry import build_architecture as build_torch
from motioncraft_tpu_torch.utils import torch_convert as port_tc
from motioncraft_tpu_torch.utils.checkpoint import load_eval_variables
from motioncraft_tpu_torch.utils.convert import from_jax_params
from torch_port_util import Replay, assert_close_scaled, jax_sample_draws, seeded_params, t

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import fabricate_torch as fab  # noqa: E402

REL_MODULE, REL = 1e-5, 1e-4
LAT, H, T, TE, STEPS = 8, 12, 16, 32, 4
SAMI_KW = dict(latent_dim=LAT, text_latent_dim=16, num_heads=H, num_text_heads=1,
               num_experts=4, topk=2, ffn_dim=16, time_embed_dim=TE, max_seq_len=T,
               max_text_seq_len=77)


def finemogen_cfg(**model):
    m = dict(type="FineMoGenTransformer", input_feats=322, max_seq_len=T,
             latent_dim=LAT * H, time_embed_dim=TE, num_layers=2,
             ca_block_cfg=dict(type="SAMI", **SAMI_KW, gate_type="cosine_top",
                               gate_noise=1.0, temporal_comb=False, dropout=0),
             ffn_cfg=dict(latent_dim=LAT, ffn_dim=16, dropout=0, time_embed_dim=TE,
                          num_heads=H),
             text_encoder=dict(pretrained_model="clip", latent_dim=16, num_layers=1,
                               ff_size=16, dropout=0, use_text_proj=False, clip_width=32,
                               clip_layers=1),
             pose_encoder_cfg=dict(dataset_name="motionx", latent_dim=LAT, input_dim=322),
             pose_decoder_cfg=dict(dataset_name="motionx", latent_dim=LAT, output_dim=322),
             scale_func_cfg=dict(scale=6.5), **model)
    diffusion = dict(beta_scheduler="linear", diffusion_steps=1000,
                     model_mean_type="start_x", model_var_type="fixed_large")
    return dict(type="MotionDiffusion", model=m,
                loss_recon=dict(type="MSELoss", loss_weight=1, reduction="none"),
                diffusion_train=diffusion, diffusion_test=dict(diffusion, respace=str(STEPS)),
                inference_type="ddim")


def _batch():
    batch = make_text_batch(["a person walks forward", "someone waves hello"], max_seq_len=T,
                            lengths=np.array([[T], [11]], np.int32))
    batch["motion"] = np.random.RandomState(13).randn(*batch["motion"].shape).astype(np.float32)
    return batch


@pytest.fixture(scope="module")
def pair():
    """(JAX arch with the hoist off, its variables, the port's arch built
    from the default config, batch) on one seeded tree."""
    arch_j = build_jax(finemogen_cfg(text_hoist=False))
    batch = _batch()
    variables = jax.jit(lambda: arch_j.init(jax.random.PRNGKey(0), batch))()
    params = seeded_params(jax.tree_util.tree_map(np.asarray, variables["params"]), 1)
    arch_t = build_torch(finemogen_cfg(), device="cpu")
    arch_t.model.load_state_dict(from_jax_params(params), strict=True)
    return arch_j, {"params": jax.tree_util.tree_map(jnp.asarray, params)}, arch_t, batch


@pytest.mark.parametrize("NI,B", [(1, 2), (2, 2), (2, 4)])
def test_sami(NI, B):
    """SAMI on a batch whose rows differ in length, mask and text flag; with
    NI = 2 each pair of rows is one sequence of two intervals."""
    rng = np.random.RandomState(5)
    x = rng.randn(B, T, H * LAT).astype(np.float32)
    xf = rng.randn(B, 77, 16).astype(np.float32)
    emb = rng.randn(B, TE).astype(np.float32)
    lengths = np.array([[T], [9], [12], [5]][:B], np.int32)
    mask = (np.arange(T)[None] < lengths).astype(np.float32)[..., None]
    cond = np.array([1, 1, 0, 0][:B], np.float32).reshape(B, 1, 1)
    kw = dict(xf=xf, emb=emb, src_mask=mask, cond_type=cond, motion_length=lengths)
    flax_m = jax_att.SAMI(**SAMI_KW)
    variables = jax.jit(lambda: flax_m.init(jax.random.PRNGKey(0), x, **kw))()
    params = seeded_params(jax.tree_util.tree_map(np.asarray, variables["params"]), 2)
    port = port_att.SAMI(**SAMI_KW).eval()
    port.load_state_dict(from_jax_params(params), strict=True)
    want = np.asarray(jax.jit(lambda v: flax_m.apply(v, x, num_intervals=NI, **kw))(
        {"params": params}))
    with torch.no_grad():
        got = port(t(x), xf=t(xf), emb=t(emb), src_mask=t(mask), cond_type=t(cond),
                   motion_length=t(lengths), num_intervals=NI).numpy()
    assert np.abs(want - x).max() > 1e-2  # the attention's residual is not zero
    assert_close_scaled(got, want, REL_MODULE, f"SAMI NI={NI} B={B}")


def test_sami_refuses_training():
    """SAMI in training (it raised before baseline training was ported),
    at gate noise 0, against flax's ``train=True``: the output, its MoEs'
    aux losses and its template KL, the population std's."""
    rng = np.random.RandomState(6)
    B = 3
    x = rng.randn(B, T, H * LAT).astype(np.float32)
    lengths = np.array([[T], [9], [12]], np.int32)
    kw = dict(xf=rng.randn(B, 77, 16).astype(np.float32),
              emb=rng.randn(B, TE).astype(np.float32),
              src_mask=(np.arange(T)[None] < lengths).astype(np.float32)[..., None],
              cond_type=np.array([0, 7, 42], np.int32).reshape(B, 1, 1), motion_length=lengths)
    cfg = dict(SAMI_KW, gate_noise=0.0)
    flax_m = jax_att.SAMI(**cfg)
    variables = jax.jit(lambda: flax_m.init(jax.random.PRNGKey(0), x, **kw))()
    params = seeded_params(jax.tree_util.tree_map(np.asarray, variables["params"]), 2)
    want, state = jax.jit(lambda v: flax_m.apply(v, x, train=True, mutable=["losses"], **kw))(
        {"params": params})
    port = port_att.SAMI(**cfg).train()
    port.load_state_dict(from_jax_params(params), strict=True)
    aux, kl = [], []
    with torch.no_grad():
        got = port(t(x), **{k: t(v) for k, v in kw.items()}, aux_losses=aux, kl_losses=kl)
    assert len(aux) == 2 and len(kl) == 1  # the text and the motion MoE; the template
    assert_close_scaled(got.numpy(), want, REL_MODULE, "SAMI in training")
    losses = state["losses"]
    assert_close_scaled(float(sum(aux)), sum(losses["aux_loss"]), REL_MODULE, "aux")
    assert_close_scaled(float(kl[0]), sum(losses["kl_loss"]), REL_MODULE, "kl")


@pytest.mark.parametrize("NI", [1, 2])
def test_forward_test(pair, NI):
    arch_j, variables, arch_t, batch = pair
    ts = np.array([499, 499], np.int32)
    xf = arch_j.encode_text(variables, batch["text_ids"])
    want = np.asarray(jax.jit(lambda v, x_, t_, m, ml, xf_: arch_j.model.apply(
        v, x_, t_, motion_mask=m, motion_length=ml, xf_out=xf_, num_intervals=NI,
        mode="test"))(variables, batch["motion"], ts, batch["motion_mask"],
                      batch["motion_length"], xf))
    with torch.no_grad():
        xf_t = arch_t.encode_text(batch["text_ids"])
        assert arch_t.model.precompute_text_feats(xf_t) is None  # SAMI has no text branch
        got = arch_t.model(t(batch["motion"]), t(ts, torch.long),
                           motion_mask=t(batch["motion_mask"]),
                           motion_length=t(batch["motion_length"]), xf_out=xf_t,
                           num_intervals=NI).numpy()
    assert np.abs(want).max() > 1e-2
    assert_close_scaled(got, want, REL, f"FineMoGen forward_test NI={NI}")


def test_sample_matches_jax_with_the_hoist_off(pair):
    """DDIM (respace 4) through MotionDiffusion.sample on the JAX run's
    initial noise; the port's default config against JAX's hoist off."""
    arch_j, variables, arch_t, batch = pair
    rng = jax.random.PRNGKey(7)
    want = np.asarray(jax.jit(lambda v, b, r: arch_j.sample(v, b, r))(variables, batch, rng))
    draws = jax_sample_draws(STEPS, arch_t.repaint_cfg, rng, batch["motion"].shape)
    got = arch_t.sample(batch, randn=Replay(draws)).numpy()
    assert arch_t.model.text_hoist and arch_t.diffusion_test.num_timesteps == STEPS
    assert np.isfinite(got).all() and np.abs(want).max() > 1e-2
    assert_close_scaled(got, want, REL, "FineMoGen sample")


def test_jax_default_config_cannot_sample(pair):
    """The JAX package's default text_hoist runs SAMI's text-only hoist,
    which SAMI does not have: its sample raises."""
    _, variables, _, batch = pair
    arch_j = build_jax(finemogen_cfg())
    with pytest.raises(AttributeError, match="'NoneType' object has no attribute 'shape'"):
        arch_j.sample(variables, batch, jax.random.PRNGKey(7))


def test_convert_finemogen_matches_jax_and_loads(tmp_path):
    cfg = finemogen_cfg()
    arch_j = build_jax(cfg)
    params = jax.tree_util.tree_map(
        np.asarray, jax.jit(lambda: arch_j.init(jax.random.PRNGKey(0), _batch()))()["params"])
    sd = fab.finemogen_sd(params, np.random.RandomState(4), 2, H, 1, 1, prefix="model.")
    want, got = (tc.convert_finemogen(sd, 2, H, 1, 1) for tc in (jax_tc, port_tc))

    def same(a, b, path=""):
        assert sorted(a) == sorted(b), path
        for k in b:
            if isinstance(b[k], dict):
                same(a[k], b[k], f"{path}/{k}")
            else:
                np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), f"{path}/{k}")

    same(got, want)
    arch = build_torch(cfg, device="cpu")
    path = str(tmp_path / "finemogen.pth")
    torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in sd.items()}}, path)
    loaded = load_eval_variables(cfg, arch.model, torch_checkpoint=path)
    expect = from_jax_params(want)
    assert set(loaded) == set(arch.model.state_dict()) == set(expect)
    for name, value in arch.model.state_dict().items():
        np.testing.assert_array_equal(value.numpy(), expect[name].numpy(), err_msg=name)


@pytest.mark.parametrize("argv", [["--bf16"], ["--int8"], ["--int8-mode", "w8"],
                                  ["--step-cache", "2"]])
def test_lowprec_options_are_refused(pair, argv, monkeypatch):
    """Each option of the CLIs runs on FineMoGen (a copy of the fixture's
    model): --bf16 casts it and samples in bf16, --int8 / --int8-mode w8
    quantize the leaves the JAX package quantizes (at a size floor of 1
    element here), --step-cache gives the step cache, which FineMoGen takes
    as the JAX package's does.  tests/test_torch_baselines_{bf16,int8}.py
    hold these against the JAX package's numbers."""
    import copy

    from motioncraft_tpu.apis.factory import int8_quantize_variables
    from motioncraft_tpu_torch.ops import quant

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from tools.torch_lowprec import apply_lowprec_, step_cache_from_args
    from tools.torch_test import parse_args

    _, variables, arch_t, _ = pair
    arch = copy.deepcopy(arch_t)
    monkeypatch.setattr(quant, "MIN_ELEMS", 1)
    args = parse_args(["config.py", "out", *argv])
    dtype = apply_lowprec_(arch, args, logger=lambda m: None)
    assert dtype == (torch.bfloat16 if argv == ["--bf16"] else None)
    n = quant.count_quantized(arch.model)[0]
    if argv[0].startswith("--int8"):
        want = int8_quantize_variables(variables, min_elems=1)["params"]
        assert n == sum(a.dtype == jnp.int8 for a in jax.tree_util.tree_leaves(want)) > 0
    else:
        assert n == 0
    cache = step_cache_from_args(args, logger=lambda m: None)
    assert (cache is not None) == (argv[0] == "--step-cache")
    got = arch.sample(_batch(), compute_dtype=dtype, step_cache=cache,
                      generator=torch.Generator().manual_seed(0))
    assert got.dtype == torch.float32 and np.isfinite(got.numpy()).all()


def test_step_cache_table_clis_on_finemogen(tmp_path, monkeypatch):
    """tools/torch_calibrate_step_cache.py calibrates a table on FineMoGen
    (which takes the step cache, as in the JAX package) and
    tools/torch_test.py samples with it in bf16, on the tiny config over a
    synthetic Motion-X tree."""
    import importlib.util
    import json

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

    def load(name):
        spec = importlib.util.spec_from_file_location(name, os.path.join(repo, "tools",
                                                                         name + ".py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    load("make_tiny_data").make_motionx(str(tmp_path / "data_tiny"), np.random.RandomState(0))
    config = tmp_path / "tiny_finemogen.py"
    config.write_text(f"_base_ = [{os.path.join(repo, 'configs', 'tests', 'tiny_t2m.py')!r}]\n"
                      f"model = dict(_delete_=True, **{finemogen_cfg()!r})\n")
    monkeypatch.chdir(tmp_path)
    table = str(tmp_path / "table.npz")
    run = load("torch_calibrate_step_cache").main(
        [str(config), table, "--device", "cpu", "--batches", "1", "--batch-size", "2",
         "--threshold", "1.0", "--tail", "1", "--perturb", "0.05"])
    flags = run["flags"]
    assert flags.shape == (STEPS, 2) and not flags[0].any() and not flags[-1].any()
    out = load("torch_test").main([str(config), "out", "--device", "cpu", "--batch-size", "4",
                                   "--bf16", "--step-cache-table", table])["out"]
    assert out["flags"]["step_cache_table"] == table
    with open(tmp_path / "out" / "metrics.json") as f:
        assert json.load(f) == out
    metric = {k: v for k, v in out.items() if k not in ("flags", "protocol")}
    assert all(np.isfinite(v) for v in metric.values())


def test_training_is_refused(pair):
    """Training, which raised before baseline training was ported:
    ``MotionDiffusion.loss`` on the fixture's weights at gate noise 0
    against the JAX package's loss on its draws, every term, each weighted
    by the model's ``aux_loss_weights``."""
    from test_torch_train import jax_draws

    _, variables, _, batch = pair
    cfg = finemogen_cfg(moe_route_loss_weight=10.0, template_kl_loss_weight=1e-2)
    cfg["model"]["ca_block_cfg"]["gate_noise"] = 0.0
    arch_j = build_jax(cfg)
    key = jax.random.PRNGKey(9)
    _, want = jax.jit(lambda v: arch_j.loss(v, batch, key))(variables)
    arch_t = build_torch(cfg, device="cpu")
    arch_t.model.load_state_dict(from_jax_params(jax.device_get(variables["params"])),
                                 strict=True)
    arch_t.train()
    with torch.no_grad():
        _, got = arch_t.loss(batch, **jax_draws(arch_j, batch, key))
    for k in ("loss", "recon_loss", "moe_route_loss", "template_kl_loss"):
        assert_close_scaled(float(got[k]), float(want[k]), REL_MODULE, k)
    assert float(want["template_kl_loss"]) > 0
