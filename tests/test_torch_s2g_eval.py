"""The port's speech-to-gesture evaluation path against the JAX package, on
the CPU:

- BEAT2 loading on the committed fixture (configs/tests/fixture_beat2.yaml,
  tests/fixtures/mini/beat2): the native onsets, ``load_recordings`` and
  ``beat2_pose_to_smplx322`` give the JAX package's arrays exactly; the
  port's YAML reader gives ``yaml.safe_load``'s mapping on the three
  files of the st_mogen_emage schema;
- rotations, FK and LBS (joints and vertices on the fabricated body model
  of tests/test_smplx_lbs.py): 1e-5 x max(1, max |JAX|);
- each gesture metric on the same arrays: 1e-6 relative;
- one tools/torch_s2g_test.py run on the fixture with a fabricated SMPL-X
  npz and one on the FK route, each giving tools/s2g_test.py's keys and
  flags.
"""

import importlib.util
import json
import os
import re
import shutil
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from motioncraft_tpu.data import beat2 as jax_beat2
from motioncraft_tpu.data import native as jax_native
from motioncraft_tpu.data.datasets import beat2_pose_to_smplx322 as jax_pose322
from motioncraft_tpu.eval import gesture_metrics as jax_gm
from motioncraft_tpu.ops import fk as jax_fk
from motioncraft_tpu.ops import rotation as jax_rot
from motioncraft_tpu.ops import smplx_lbs as jax_lbs
from motioncraft_tpu_torch.data import beat2
from motioncraft_tpu_torch.data.datasets import beat2_pose_to_smplx322
from motioncraft_tpu_torch.eval import gesture_metrics as gm
from motioncraft_tpu_torch.ops import fk, rotation, smplx_lbs
from test_smplx_lbs import fabricate_model
from torch_port_util import assert_close_scaled, bf16_cast_dtypes, t

REL = 1e-5
METRIC_REL = 1e-6
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE_YAML = os.path.join(REPO, "configs", "tests", "fixture_beat2.yaml")
YAMLS = ["configs/beat2/st_mogen_emage.yaml", "configs/tests/fixture_beat2.yaml",
         "configs/tests/tiny_beat2.yaml"]


@pytest.fixture
def in_repo(monkeypatch):
    monkeypatch.chdir(REPO)  # the fixture's data paths are relative to the repository


@pytest.mark.parametrize("path", YAMLS)
def test_yaml_reader_matches_safe_load(path):
    with open(os.path.join(REPO, path)) as f:
        text = f.read()
    assert beat2.parse_flat_yaml(text) == yaml.safe_load(text)
    args = beat2.load_beat2_args(os.path.join(REPO, path))
    want = jax_beat2.load_beat2_args(os.path.join(REPO, path))
    assert vars(args) == vars(want)


def test_yaml_reader_types_and_refusals():
    text = "a: 1\nb: -2.5e-3\nc: [1, 2, x]\nd: ~\ne: 'q # r'\nf: true # note\ng:\n"
    assert beat2.parse_flat_yaml(text) == yaml.safe_load(text)
    for bad in ("a:\n  b: 1\n", "a: {b: 1}\n", "- 1\n", "a: [1, 2\n"):
        with pytest.raises(ValueError):
            beat2.parse_flat_yaml(bad)


def test_native_onsets_match_the_jax_package(in_repo):
    """The same source, built by each package: the same onsets, bit for
    bit, on each fixture recording and on seeded noise with bursts."""
    if not jax_native.available():
        # another test process may have been writing the library (make into
        # native/) when this one tried to load it: try once more
        time.sleep(5)
        jax_native._tried = False
    assert jax_native.available(), "the JAX package's native extractor did not build"
    wavs = [beat2.read_wav(os.path.join("tests/fixtures/mini/beat2/wave16k", n))[1]
            for n in sorted(os.listdir("tests/fixtures/mini/beat2/wave16k"))]
    rng = np.random.RandomState(0)
    burst = rng.randn(48000).astype(np.float32) * 0.05
    burst[::4000] += 1.0
    for wav in wavs + [burst, burst[:1500], burst[:100]]:
        got = beat2.onset_amplitude(wav, 16000)
        np.testing.assert_array_equal(got, jax_beat2.onset_amplitude(wav, 16000))
        assert got.shape == (len(wav), 2)
    assert beat2.onset_amplitude(burst).sum(0)[1] > 5


def test_load_recordings_matches_the_jax_package(in_repo):
    args = beat2.load_beat2_args(FIXTURE_YAML)
    got = beat2.load_recordings(args, "test")
    want = jax_beat2.load_recordings(jax_beat2.load_beat2_args(FIXTURE_YAML), "test")
    assert [r["name"] for r in got] == [r["name"] for r in want] == ["2_mini_0_2_2",
                                                                      "2_mini_0_3_3"]
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for key in ("pose", "facial", "trans", "wav", "audio"):
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)
        assert g["word_spans"] == w["word_spans"] and g["word_spans"]
        assert g["audio"].shape == (len(g["pose"]) * 533, 2) and g["audio"][:, 1].sum() > 0
        np.testing.assert_array_equal(
            beat2_pose_to_smplx322(g["pose"], g["facial"], g["trans"]),
            jax_pose322(w["pose"], w["facial"], w["trans"]))


def test_rotations_match_jax():
    rng = np.random.RandomState(1)
    aa = (rng.randn(64, 3) * rng.choice([1e-9, 0.3, 2.0], (64, 1))).astype(np.float32)
    R = rotation.axis_angle_to_matrix(t(aa)).numpy()
    assert_close_scaled(R, np.asarray(jax_rot.axis_angle_to_matrix(jnp.asarray(aa))), REL,
                        "axis_angle_to_matrix")
    back = rotation.matrix_to_axis_angle(t(R)).numpy()
    assert_close_scaled(back, np.asarray(jax_rot.matrix_to_axis_angle(jnp.asarray(R))), REL,
                        "matrix_to_axis_angle")
    small = np.linalg.norm(aa, axis=1) < 3.0  # below pi the axis-angle is unique
    assert small.sum() > 40
    assert_close_scaled(back[small], aa[small], 1e-4, "round trip")


@pytest.mark.parametrize("width", [165, 156])
def test_fk_matches_jax(width):
    rng = np.random.RandomState(2)
    pose = (rng.randn(40, width) * 0.3).astype(np.float32)
    root = rng.randn(40, 3).astype(np.float32)
    got = fk.SMPLXSkeleton(device="cpu")(pose, root).numpy()
    want = np.asarray(jax_fk.SMPLXSkeleton().forward(jnp.asarray(pose), jnp.asarray(root)))
    assert got.shape == (40, 55, 3)
    assert_close_scaled(got, want, REL, "FK joints")
    np.testing.assert_array_equal(fk.default_rest_joints(), jax_fk.default_rest_joints())
    np.testing.assert_array_equal(fk.SMPLX_PARENTS, jax_fk.SMPLX_PARENTS)


@pytest.fixture(scope="module")
def body_models():
    data = fabricate_model()
    return (smplx_lbs.SMPLXModel(data, device="cpu"),
            jax_lbs.SMPLXModel(data, dtype=jnp.float32), data)


def test_lbs_matches_jax(body_models):
    port, jax_model, _ = body_models
    rng = np.random.RandomState(3)
    B = 5
    kw = dict(betas=rng.randn(B, 300) * 0.5, expression=rng.randn(B, 100) * 0.5,
              transl=rng.randn(B, 3), **smplx_lbs.pose165_parts(rng.randn(B, 165) * 0.3))
    got, want = port.forward(**kw), jax_model.forward(**kw)
    for key in ("joints", "vertices"):
        assert_close_scaled(got[key].numpy(), np.asarray(want[key]), REL, key)
    got = port.forward(full_pose=rng.randn(2, 165) * 0.3, return_verts=False)
    assert sorted(got) == ["joints"]


def test_lbs_forward_chunked_matches_jax(body_models, tmp_path):
    """The CLI's calls: joints of a posed sequence, face vertices with
    expression and jaw only, over several chunks; and from_npz."""
    port, jax_model, data = body_models
    rng = np.random.RandomState(4)
    T = 70
    pose = (rng.randn(T, 165) * 0.3).astype(np.float32)
    betas = np.broadcast_to(rng.randn(1, 300).astype(np.float32), (T, 300))
    kw = dict(betas=betas, **smplx_lbs.pose165_parts(pose))
    got = port.forward_chunked(chunk=32, return_verts=False, **kw)["joints"]
    want = jax_model.forward_chunked(chunk=32, return_verts=False,
                                     **jax_lbs.pose165_parts(pose), betas=betas)["joints"]
    assert_close_scaled(got, want, REL, "chunked joints")
    face = dict(betas=betas, expression=rng.randn(T, 100).astype(np.float32),
                jaw_pose=pose[:, 66:69])
    assert_close_scaled(port.forward_chunked(chunk=32, **face)["vertices"],
                        jax_model.forward_chunked(chunk=32, **face)["vertices"], REL,
                        "chunked face vertices")
    np.savez(tmp_path / "SMPLX_NEUTRAL_2020.npz", **data)
    loaded = smplx_lbs.SMPLXModel.from_npz(str(tmp_path / "SMPLX_NEUTRAL_2020.npz"),
                                           device="cpu")
    assert smplx_lbs.find_model_path(str(tmp_path / "SMPLX_NEUTRAL_2020.npz"))
    assert_close_scaled(loaded.forward(**kw)["joints"].numpy(), got, REL, "from_npz")


def _close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=METRIC_REL, atol=0, err_msg=what)


def test_gesture_metrics_match_jax():
    rng = np.random.RandomState(5)
    T = 200
    # smooth joint trajectories with pauses, so that speed has minima
    phase = np.linspace(0, 12 * np.pi, T)[:, None, None]
    joints = (np.sin(phase * rng.uniform(0.5, 1.5, (1, 55, 3))) * 0.2
              + rng.randn(T, 55, 3) * 0.002).astype(np.float32)
    mmae = rng.uniform(0.2, 0.6, 55).astype(np.float32)
    for impl in (gm, jax_gm):
        assert impl.UPPER_BODY == jax_gm.UPPER_BODY
    a, b = gm.L1div(), jax_gm.L1div()
    for seq in (joints.reshape(T, -1), joints[:50].reshape(50, -1)):
        a.run(seq)
        b.run(seq)
    _close(a.avg(), b.avg(), "L1div")
    for kw in (dict(), dict(mmae=mmae, t_start=10, t_end=T - 10)):
        got, want = gm.motion_beats(joints, **kw), jax_gm.motion_beats(joints, **kw)
        assert len(got) == 55 and sum(map(len, got)) > 0
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    onsets, beats = np.sort(rng.rand(20) * 6), np.sort(rng.rand(15) * 6)
    _close(gm.gahr(beats, onsets, 0.3), jax_gm.gahr(beats, onsets, 0.3), "gahr")
    assert gm.gahr(beats, [], 0.3) == jax_gm.gahr(beats, [], 0.3) == 0.0
    wav = (rng.randn(T * 533) * 0.05).astype(np.float32)
    wav[::5000] += 1.0
    for kw in (dict(), dict(mmae=mmae, align_mask=20)):
        got = gm.BeatAlign(**kw).score(wav, joints, full_wav_len=len(wav) + 700)
        want = jax_gm.BeatAlign(**kw).score(wav, joints, full_wav_len=len(wav) + 700)
        assert got > 0
        _close(got, want, f"BeatAlign {sorted(kw)}")
    _close(gm.audio_onsets_seconds(wav), jax_gm.audio_onsets_seconds(wav), "onsets")
    face_p, face_g = rng.randn(T, 30, 3), rng.randn(T, 30, 3)
    for name in ("facial_mse", "facial_lvd", "facial_l2"):
        _close(getattr(gm, name)(face_p, face_g), getattr(jax_gm, name)(face_p, face_g), name)


# tools/s2g_test.py's metrics.json: the four metrics, FID with more than one
# recording, the protocol verdict and the honesty flags
S2G_KEYS = {"L1div", "BeatAlign", "facial_L2", "facial_LVD", "FID_whole", "FID_hands",
            "protocol", "flags"}
S2G_FLAGS = {"smplx_vertices", "mmae_asset", "untrained_evaluator", "hash_tokenizer",
             "int8_weights", "step_cache"}


def _tool():
    spec = importlib.util.spec_from_file_location(
        "torch_s2g_test", os.path.join(REPO, "tools", "torch_s2g_test.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


def test_the_keys_are_tools_s2g_test_py_s():
    with open(os.path.join(REPO, "tools", "s2g_test.py")) as f:
        src = f.read()
    for key in S2G_KEYS | S2G_FLAGS:
        assert re.search(rf"[\"']{key}[\"']", src), key


def test_torch_s2g_cli_with_a_body_model(tmp_path, monkeypatch):
    """The fixture's two test recordings, with a fabricated SMPL-X npz and
    a mean-velocity file: LBS joints and face vertices, the protocol's
    keys; an untrained evaluator keeps "protocol" false."""
    root = tmp_path / "beat2"
    shutil.copytree(os.path.join(REPO, "tests", "fixtures", "mini", "beat2"), root)
    (root / "weights").mkdir()
    np.save(root / "weights" / "mean_vel_smplxflame_30.npy", np.full(55, 0.5, np.float32))
    np.savez(tmp_path / "SMPLX_NEUTRAL_2020.npz", **fabricate_model())
    stats = os.path.join(REPO, "tests", "fixtures", "mini", "stats")
    (tmp_path / "beat2.yaml").write_text(
        f"data_path: {root}/\npose_length: 16\nstride: 8\npre_frames: 4\npose_fps: 30\n"
        f"audio_sr: 16000\naudio_rep: onset+amplitude\npose_rep: smplxflame_30\n"
        f"training_speakers: [2]\nalign_mask: 5\nsmplx_model_path: "
        f"{tmp_path / 'SMPLX_NEUTRAL_2020.npz'}\nmean_pose_path: {stats}/mean.npy\n"
        f"std_pose_path: {stats}/std.npy\n")
    monkeypatch.chdir(REPO)
    tool = _tool()
    run = tool.main(["configs/tests/tiny_s2g.py", "--device", "cpu", "--beats2-args",
                     str(tmp_path / "beat2.yaml"), "--work-dir", str(tmp_path / "work"),
                     "--recording-batch", "2"])
    with open(tmp_path / "work" / "metrics.json") as f:
        out = json.load(f)
    assert set(out) == S2G_KEYS and set(out["flags"]) == S2G_FLAGS
    flags = out["flags"]
    assert flags["smplx_vertices"] and flags["mmae_asset"] and flags["untrained_evaluator"]
    assert out["protocol"] is False and flags["int8_weights"] is False
    assert all(np.isfinite(out[k]) for k in S2G_KEYS - {"protocol", "flags"})
    assert run["body_model"] is not None and run["windows"] == 7
    assert [p.shape for p in run["preds"]] == [(88, 322), (88, 322)]
    # int8 and the step cache are ported now (tests/test_torch_quant.py runs them)
    for argv, want in ((["--bf16", "--int8"], ("w8a8", 0)), (["--int8"], ("w8a8", 0)),
                       (["--int8-mode", "w8"], ("w8", 0)), (["--step-cache", "4"], (None, 4))):
        args = tool.parse_args(["configs/tests/tiny_s2g.py", *argv])
        assert (args.int8, args.step_cache) == want


def test_torch_s2g_cli_fk_route(tmp_path, monkeypatch):
    """Without the body model npz: the approximate FK, facial metrics on
    expression coefficients, "protocol" false, as tools/s2g_test.py."""
    monkeypatch.chdir(REPO)
    monkeypatch.delenv("MOTIONCRAFT_SMPLX_MODEL", raising=False)
    run = _tool().main(["configs/tests/tiny_s2g.py", "--device", "cpu", "--beats2-args",
                        "configs/tests/fixture_beat2.yaml", "--work-dir", str(tmp_path),
                        "--limit", "1"])
    out = run["out"]
    assert set(out) == S2G_KEYS - {"FID_whole", "FID_hands"}
    assert out["flags"]["smplx_vertices"] is False and out["protocol"] is False
    assert run["body_model"] is None and run["preds"][0].shape == (88, 322)
    assert torch.isfinite(torch.as_tensor(run["preds"][0])).all()


def test_torch_s2g_cli_bf16(tmp_path, monkeypatch):
    """--bf16 on the FK route: the WavEncoder in f32 on the widened bf16
    weights (as flax promotes it), the denoiser in bf16; finite
    predictions."""
    monkeypatch.chdir(REPO)
    monkeypatch.delenv("MOTIONCRAFT_SMPLX_MODEL", raising=False)
    run = _tool().main(["configs/tests/tiny_s2g.py", "--device", "cpu", "--bf16",
                        "--beats2-args", "configs/tests/fixture_beat2.yaml",
                        "--work-dir", str(tmp_path), "--limit", "1"])
    assert bf16_cast_dtypes(run["arch"].model) == ({torch.bfloat16}, {torch.float32})
    assert run["preds"][0].shape == (88, 322)
    assert np.isfinite(np.asarray(run["preds"][0])).all()
