"""The port's speech-to-gesture model against the JAX package on the tiny
S2G config (configs/tests/tiny_s2g.py: a 2-layer base, one control block,
a WavEncoder of width 16 over onset + amplitude at 16 kHz, 16-frame windows
overlapping by 4), on seeded flax params and BatchNorm statistics carried
over by ``from_jax_variables`` with ``strict=True``:

- ``WavEncoder`` (models/blocks.py) against the flax one on one window of
  audio and on a 64-frame window;
- the ControlNet's CFG test forward with the condition on and off, and
  ``encode_condition`` for audio shorter, as long as and longer than the
  window;
- a whole windowed S2G sample (3 windows: DDIM, then two RePaint-outpainted
  windows) and a lockstep batch of two recordings, both sides on the JAX key
  tree's draws;
- ``.npz`` snapshots cross between the packages with ``batch_stats`` both
  ways, and a released-layout merged ``.pth`` with a WavEncoder loads as
  the JAX converter maps it.

Tolerances: 1e-5 x max(1, max |JAX|) for the encoder and one forward (sums
in another order); 1e-4 x that through the sampler, as
tests/test_torch_windowed.py.
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
from motioncraft_tpu.apis import windowed as jax_windowed
from motioncraft_tpu.config import Config as JaxConfig
from motioncraft_tpu.diffusion.sampling import RepaintConfig as JaxRepaint
from motioncraft_tpu.models.blocks import WavEncoder as JaxWavEncoder
from motioncraft_tpu.models.tokenizer import tokenize
from motioncraft_tpu.registry import build_architecture as build_jax
from motioncraft_tpu.utils import torch_convert as jax_convert
from motioncraft_tpu_torch.apis import windowed
from motioncraft_tpu_torch.config import Config
from motioncraft_tpu_torch.diffusion import RepaintConfig
from motioncraft_tpu_torch.models.blocks import WavEncoder
from motioncraft_tpu_torch.registry import build_architecture as build_torch
from motioncraft_tpu_torch.utils import checkpoint, torch_convert
from motioncraft_tpu_torch.utils.convert import (fabricate_state_dict, from_jax_variables,
                                                 to_jax_variables)
from torch_port_util import (Replay, assert_close_scaled, jax_windowed_draws,
                             seeded_batch_stats, seeded_params, t)

REL, REL_SAMPLE = 1e-5, 1e-4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "tests", "tiny_s2g.py")
WINDOW, PRE, D, SPF = 16, 4, 322, 16000 // 30
TEXT = "A person is doing a speech, and the speech content is hello world"


def audio(seed, frames, batch=1):
    """Onset + amplitude features of ``frames`` frames of seeded speech-like
    audio: |wav| and a sparse 0/1 onset train, [batch, frames * SPF, 2]."""
    rng = np.random.RandomState(seed)
    n = frames * SPF
    amp = np.abs(rng.randn(batch, n) * 0.3)
    onset = (rng.rand(batch, n) < 2e-4).astype(np.float64)
    return np.stack([amp, onset], axis=-1).astype(np.float32)


def seeded_variables(variables, seed):
    v = jax.tree_util.tree_map(np.asarray, unfreeze(variables))
    return {"params": seeded_params(v["params"], seed),
            "batch_stats": seeded_batch_stats(v["batch_stats"], seed + 100)}


@pytest.mark.parametrize("frames,batch", [(WINDOW, 1), (64, 2)], ids=["window", "64_frames"])
def test_wav_encoder_matches_flax(frames, batch):
    x = audio(frames, frames, batch)
    flax_enc = JaxWavEncoder(out_dim=16, audio_in=2)
    variables = seeded_variables(flax_enc.init(jax.random.PRNGKey(0), x[:, :SPF * 8]), 2)
    var = [v for path, v in jax.tree_util.tree_leaves_with_path(variables["batch_stats"])
           if path[-1].key == "var"]
    assert len(var) == 16 and min(float(v.min()) for v in var) >= 0.5
    want = np.asarray(jax.jit(flax_enc.apply)(variables, x))
    enc = WavEncoder(16, audio_in=2).eval()
    enc.load_state_dict(from_jax_variables(variables), strict=True)
    with torch.no_grad():
        got = enc(t(x)).numpy()
    # block 0 pads 1600 samples a side and the strides make 540 samples a
    # frame: 16 x 533 samples give 17 frames, 64 x 533 exactly 64
    assert got.shape == (batch, frames + (frames == WINDOW), 16)
    assert np.abs(want).max() > 1e-2
    assert_close_scaled(got, want, REL, "WavEncoder")


def make_mwb(feats, text=TEXT):
    """tools/s2g_test.py's window batches over one recording's audio
    features [L, 2]."""
    text_ids = tokenize([text])

    def mwb(start, end):
        seg = feats[start * SPF:end * SPF]
        if len(seg) < (end - start) * SPF:
            seg = np.pad(seg, ((0, (end - start) * SPF - len(seg)), (0, 0)))
        return {"motion": np.zeros((1, WINDOW, D), np.float32),
                "motion_mask": np.ones((1, WINDOW), np.float32),
                "motion_length": np.full((1, 1), WINDOW, np.int32),
                "text_ids": text_ids, "c": seg.astype(np.float32)[None]}

    return mwb


@pytest.fixture(scope="module")
def pair():
    arch_j = build_jax(JaxConfig.fromfile(CONFIG).model)
    init = arch_j.init(jax.random.PRNGKey(0), make_mwb(audio(0, WINDOW)[0])(0, WINDOW))
    variables = seeded_variables(init, 1)
    arch_t = build_torch(Config.fromfile(CONFIG).model, device="cpu")
    arch_t.model.load_state_dict(from_jax_variables(variables), strict=True)
    arch_j.repaint_cfg = JaxRepaint(overlap_len=PRE)
    arch_t.repaint_cfg = RepaintConfig(overlap_len=PRE)
    jvars = jax.tree_util.tree_map(jnp.asarray, variables)
    return arch_j, variables, jvars, arch_t


def test_tiny_model_has_the_encoder_and_its_statistics(pair):
    _, variables, _, arch_t = pair
    sd = arch_t.model.state_dict()
    stats = [k for k in sd if k.endswith("running_var")]
    # 6 blocks: bn1, bn2, and down_bn in blocks 0, 1, 3, 5
    assert len(stats) == 16 and all(k.startswith("condition_pre_encoder.") for k in stats)
    assert arch_t.model.control_cond_input.linear.in_features == 16
    back = to_jax_variables(sd)
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(variables))


@pytest.mark.parametrize("with_c", [True, False], ids=["c_on", "c_off"])
def test_forward_test(pair, with_c):
    arch_j, _, jvars, arch_t = pair
    batch = make_mwb(audio(3, WINDOW)[0])(0, WINDOW)
    x = np.random.RandomState(4).randn(1, WINDOW, D).astype(np.float32)
    ts = np.full((1,), 499, np.int32)
    c = batch["c"] if with_c else None
    xf = arch_j.encode_text(jvars, batch["text_ids"])
    tf = arch_j.model.apply(jvars, xf, method="precompute_text_feats")
    want = np.asarray(jax.jit(lambda v: arch_j.model.apply(
        v, x, ts, motion_mask=batch["motion_mask"], motion_length=batch["motion_length"],
        xf_out=xf, c=c, text_feats=tf, mode="test"))(jvars))
    with torch.no_grad():
        xf_t = arch_t.encode_text(batch["text_ids"])
        got = arch_t.model(t(x), t(ts, torch.long), motion_mask=t(batch["motion_mask"]),
                           motion_length=t(batch["motion_length"]), xf_out=xf_t,
                           text_feats=arch_t.model.precompute_text_feats(xf_t),
                           c=None if c is None else t(c)).numpy()
    assert np.abs(want).max() > 1e-3
    assert_close_scaled(got, want, REL, "forward_test")


@pytest.mark.parametrize("frames", [10, WINDOW, 20])
def test_encode_condition(pair, frames):
    """The encoder gives frames + 1 frames at this length (17 for 16): it
    is cut to the window, or padded with zeros when the audio is short."""
    arch_j, _, jvars, arch_t = pair
    c = audio(frames, frames, 2)
    want = np.asarray(jax.jit(lambda v: arch_j.model.apply(
        v, c, WINDOW, method="encode_condition"))(jvars))
    with torch.no_grad():
        got = arch_t.model.encode_condition(t(c), WINDOW).numpy()
    assert got.shape == (2, WINDOW, arch_t.model.base_model.latent_dim)
    assert_close_scaled(got, want, REL, "encode_condition")


def test_zero_init_branch_changes_nothing():
    arch = build_torch(Config.fromfile(CONFIG).model, device="cpu")
    batch = make_mwb(audio(5, WINDOW)[0])(0, WINDOW)
    x = torch.randn(1, WINDOW, D, generator=torch.Generator().manual_seed(0))
    outs = []
    with torch.no_grad():
        xf = arch.encode_text(batch["text_ids"])
        for c in (t(batch["c"]), None):
            outs.append(arch.model(x, torch.full((1,), 499), motion_mask=t(batch["motion_mask"]),
                                   xf_out=xf, text_feats=arch.model.precompute_text_feats(xf),
                                   c=c))
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)


def test_windowed_sample_matches_jax(pair):
    arch_j, _, jvars, arch_t = pair
    total, key = 40, jax.random.PRNGKey(6)
    feats = audio(7, total)[0]
    assert windowed.num_windows(total, WINDOW, PRE) == 3
    want = jax_windowed.windowed_sample(arch_j, jvars, make_mwb(feats), total_frames=total,
                                        window=WINDOW, pre_frames=PRE, rng=key,
                                        repaint=arch_j.repaint_cfg)
    draws = Replay(jax_windowed_draws(arch_j.diffusion_test.num_timesteps, arch_j.repaint_cfg,
                                      key, (1, WINDOW, D), 3, PRE))
    got = windowed.windowed_sample(arch_t, make_mwb(feats), total_frames=total, window=WINDOW,
                                   pre_frames=PRE, randn=draws, repaint=arch_t.repaint_cfg)
    assert draws.done() and got.shape == (total, D)
    assert np.abs(want).max() > 1e-3
    assert_close_scaled(got, want, REL_SAMPLE, "windowed_sample")


def test_batch_of_two_recordings_matches_jax(pair):
    """R = 2 in lockstep (40 and 28 frames: 3 and 2 windows), the audio of
    each window encoded for the whole chunk at once, as both packages'
    windowed_sample_batch do."""
    arch_j, _, jvars, arch_t = pair
    totals, key = [40, 28], jax.random.PRNGKey(8)
    feats = [audio(9, 40)[0], audio(10, 28)[0]]
    texts = [TEXT, "A person is doing a speech, and the speech content is good morning"]
    want = jax_windowed.windowed_sample_batch(
        arch_j, jvars, [make_mwb(f, s) for f, s in zip(feats, texts)], totals,
        window=WINDOW, pre_frames=PRE, rng=key, repaint=arch_j.repaint_cfg)
    draws = Replay(jax_windowed_draws(arch_j.diffusion_test.num_timesteps, arch_j.repaint_cfg,
                                      key, (2, WINDOW, D), 3, PRE))
    got = windowed.windowed_sample_batch(
        arch_t, [make_mwb(f, s) for f, s in zip(feats, texts)], totals, window=WINDOW,
        pre_frames=PRE, randn=draws, repaint=arch_t.repaint_cfg)
    assert draws.done()
    for g, w, n in zip(got, want, totals):
        assert g.shape == (n, D)
        assert_close_scaled(g, w, REL_SAMPLE, f"recording of {n} frames")


def test_npz_snapshots_cross_with_batch_stats(pair, tmp_path):
    """A JAX .npz of params and batch_stats loads into the port with
    strict=True, statistics included; the port's .npz gives the JAX package
    both trees back bit for bit."""
    from motioncraft_tpu.utils.checkpoint import load_params as jax_load
    from motioncraft_tpu.utils.checkpoint import save_params as jax_save

    _, variables, _, arch_t = pair
    cfg = Config.fromfile(CONFIG).model
    jax_save(str(tmp_path / "jax.npz"), variables)
    model = build_torch(cfg, device="cpu").model
    checkpoint.load_eval_variables(cfg, model, checkpoint=str(tmp_path / "jax.npz"))
    want = arch_t.model.state_dict()
    for k, v in model.state_dict().items():
        assert torch.equal(v, want[k]), k
    assert any(k.endswith("running_var") for k in want)
    checkpoint.save_params(str(tmp_path / "port.npz"), arch_t.model)
    back = jax_load(str(tmp_path / "port.npz"))
    assert sorted(back) == ["batch_stats", "params"]
    for (pa, a), (pb, b) in zip(jax.tree_util.tree_leaves_with_path(back),
                                jax.tree_util.tree_leaves_with_path(variables)):
        assert pa == pb and np.array_equal(a, b), pa


def test_merged_pth_with_a_wav_encoder_loads_like_the_jax_route(pair, tmp_path):
    """A released-layout merged .pth whose WavEncoder sits under
    condition_pre_encoder.pre_encoder.feat_extractor.N: the port's
    load_controlnet_ckpt and load_eval_variables give exactly the tensors
    of the JAX converter's params and batch_stats carried over."""
    _, variables, _, _ = pair
    params = variables["params"]
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
    fab.wav_encoder(sd, "condition_pre_encoder.pre_encoder", params["condition_pre_encoder"],
                    rng)
    fab.lin(sd, "control_cond_input", params["control_cond_input"]["linear"], rng)
    path = str(tmp_path / "s2g.pth")
    torch.save({"state_dict": {"model." + k: torch.from_numpy(np.asarray(v, np.float32) * 0.3)
                               for k, v in sd.items()}}, path)

    tree, stats = jax_convert.convert_controlnet(jax_convert.load_torch_state_dict(path),
                                                 *dims)
    assert stats["condition_pre_encoder"]["block0"]["bn1"]["var"].shape == (4,)
    loaded = copy.deepcopy(variables)
    jax_convert._tree_update(loaded["params"], tree)
    jax_convert._tree_update(loaded["batch_stats"], stats)
    want = from_jax_variables(loaded)
    model = build_torch(Config.fromfile(CONFIG).model, device="cpu").model
    got = torch_convert.load_controlnet_ckpt(path, model, *dims)
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    again = build_torch(Config.fromfile(CONFIG).model, device="cpu").model
    got = checkpoint.load_eval_variables(Config.fromfile(CONFIG).model, again,
                                         torch_checkpoint=path)
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_fabricated_encoder_statistics_are_sane():
    """Seeded weights keep every running variance positive and the encoder's
    output finite, and leave the models without BatchNorm drawn as before
    (the M2D ControlNet: the same tensors as a draw that knows no
    BatchNorm rule)."""
    arch = build_torch(Config.fromfile(CONFIG).model, device="cpu")
    sd = fabricate_state_dict(arch.model, seed=3)
    arch.model.load_state_dict(sd, strict=True)
    assert all(float(v.min()) >= 0.5 for k, v in sd.items() if k.endswith("running_var"))
    assert all(int(v) == 0 for k, v in sd.items() if k.endswith("num_batches_tracked"))
    with torch.no_grad():
        out = arch.model.encode_condition(t(audio(11, 64)), WINDOW)
    assert torch.isfinite(out).all() and float(out.abs().max()) > 0

    m2d = build_torch(Config.fromfile(os.path.join(REPO, "configs", "tests", "tiny_m2d.py"))
                      .model, device="cpu").model
    g = torch.Generator().manual_seed(3)
    for name, v in fabricate_state_dict(m2d, seed=3).items():
        leaf = name.rsplit(".", 1)[-1]
        fan_in = v.shape[-2] if leaf in ("expert_w1", "expert_w2", "w1", "w2") else v.shape[-1]
        want = torch.randn(v.shape, generator=g) / max(fan_in, 4) ** 0.5
        if leaf == "temperature":
            want = torch.zeros(v.shape)
        elif name.endswith("moe.embedding"):
            want = want * 8.0
        assert torch.equal(v, want), name
