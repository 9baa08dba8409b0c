"""The port's host-side modules against the JAX package's, on the CPU:

- rotations (ops/rotation.py): every helper on seeded inputs within 1e-5 x
  max(1, max |JAX|), and on the edge cases (zero rotation, a half turn about
  each axis, where matrix_to_quaternion's branch and sign are ambiguous:
  there the resulting matrices compare);
- ``SMPLSkeleton``, ``mean_max_velocity`` and ``load_rest_joints(path)``
  (ops/fk.py), a file by path winning over ``$MOTIONCRAFT_SMPLX_J``;
- the SMPL-X export (utils/export.py), smoothed and not, on one 322-d clip;
- the web player's HTML (utils/web_player.py): the embedded joints within
  1e-5, the rest of the file equal;
- HumanML3D recovery (ops/humanml3d.py);
- BVH and mocap (data/bvh.py, data/mocap.py): parse_bvh / write_bvh
  byte-identical, every mocap function on a seeded BVH;
- data preparation (data/prep.py) on a tiny tree, its CLI included;
- rendering (utils/fast_render.py, utils/render.py) with a stub frame
  renderer and a fabricated SMPL-X model; the stick figure written where
  matplotlib is.

The JAX package's pure-jnp functions run under ``jax.jit`` (one compile
each, as its samplers run them; eager, each op compiles for each new shape,
seconds a function), its numpy-side tools (export, mocap, prep, rendering)
as they are, with the 6d rotations they call jitted (``jit_jax_6d``).
"""

import json
import os
import random
import re
import runpy
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from motioncraft_tpu.data import bvh as jax_bvh  # noqa: E402
from motioncraft_tpu.data import mocap as jax_mocap  # noqa: E402
from motioncraft_tpu.data import prep as jax_prep  # noqa: E402
from motioncraft_tpu.ops import fk as jax_fk  # noqa: E402
from motioncraft_tpu.ops import humanml3d as jax_hml  # noqa: E402
from motioncraft_tpu.ops import rotation as jax_rot  # noqa: E402
from motioncraft_tpu.utils import export as jax_export  # noqa: E402
from motioncraft_tpu.utils import fast_render as jax_fast_render  # noqa: E402
from motioncraft_tpu.utils import render as jax_render  # noqa: E402
from motioncraft_tpu.utils import web_player as jax_web  # noqa: E402
from motioncraft_tpu_torch.data import bvh, mocap, prep  # noqa: E402
from motioncraft_tpu_torch.ops import fk, humanml3d, rotation  # noqa: E402
from motioncraft_tpu_torch.utils import export, fast_render, render, web_player  # noqa: E402
from test_smplx_lbs import fabricate_model  # noqa: E402
from torch_port_util import assert_close_scaled, t  # noqa: E402
from torch_render_stub import stub_factory  # noqa: E402

REL = 1e-5
RNG = np.random.RandomState(0)
AA = (RNG.randn(48, 3) * RNG.choice([1e-7, 0.3, 1.5, 3.0], (48, 1))).astype(np.float32)
# zero rotation, a half turn about each axis (and its negative), a near half
# turn; padded with AA's rows to AA's shape, whose JAX ops are compiled already
EDGE = np.array([[0, 0, 0], [np.pi, 0, 0], [0, np.pi, 0], [0, 0, np.pi],
                 [-np.pi, 0, 0], [0, 0, np.pi - 1e-4]], np.float32)
EDGE_BATCH = np.concatenate([EDGE, AA[len(EDGE):]])
QUAT = (RNG.randn(32, 4) * 2).astype(np.float32)  # not unit: the formulas normalise
D6 = RNG.randn(32, 6).astype(np.float32)


def both(fn_name, x, module_jax=jax_rot, module_port=rotation):
    """(port's, JAX's) ``fn_name`` of numpy ``x``, as numpy."""
    got = getattr(module_port, fn_name)(t(x)).numpy()
    want = np.asarray(jax.jit(getattr(module_jax, fn_name))(jnp.asarray(x)))
    return got, want


def matrices(x):
    return jax.jit(jax_rot.axis_angle_to_matrix)(jnp.asarray(x))


ROTATION_CASES = {
    "quaternion_to_matrix": QUAT,
    "matrix_to_quaternion": np.asarray(matrices(AA)),
    "axis_angle_to_quaternion": AA,
    "matrix_to_rotation_6d": np.asarray(matrices(AA)),
    "rotation_6d_to_matrix": D6,
    "quat_to_6v": QUAT,
    "quat_from_6v": D6,
    "ax_to_6v": AA,
    "ax_from_6v": D6,
    "axis_angle_to_matrix": AA,
    "matrix_to_axis_angle": np.asarray(matrices(AA[np.linalg.norm(AA, axis=1) < 3.0])),
    "quaternion_to_axis_angle": QUAT / np.linalg.norm(QUAT, axis=1, keepdims=True),
}


@pytest.mark.parametrize("name", sorted(ROTATION_CASES))
def test_rotation_helper_matches_jax(name):
    got, want = both(name, ROTATION_CASES[name])
    assert got.dtype == np.float32
    assert_close_scaled(got, want, REL, name)


@pytest.mark.parametrize("name", ["matrix_to_quaternion", "quat_from_6v", "ax_from_6v",
                                  "matrix_to_axis_angle"])
def test_rotation_edge_cases_give_the_same_matrices(name):
    """At a half turn q and -q (and aa and -aa) are the same rotation, and
    the branch taken may differ by a rounding: the matrices must agree."""
    R = np.asarray(matrices(EDGE_BATCH))
    x = {"matrix_to_quaternion": R, "matrix_to_axis_angle": R}.get(
        name, np.asarray(jax.jit(jax_rot.matrix_to_rotation_6d)(jnp.asarray(R))))
    got, want = both(name, x)
    to_matrix = (jax_rot.quaternion_to_matrix if name in ("matrix_to_quaternion", "quat_from_6v")
                 else jax_rot.axis_angle_to_matrix)
    got_R, want_R = (np.asarray(jax.jit(to_matrix)(jnp.asarray(v))) for v in (got, want))
    assert_close_scaled(got_R, want_R, REL, name)
    assert_close_scaled(got_R, R, 1e-4, f"{name} round trip")
    # away from the half turns the values themselves agree
    assert_close_scaled(got[0], want[0], REL, f"{name} at zero rotation")


def test_quat_slerp_matches_jax():
    x = QUAT / np.linalg.norm(QUAT, axis=1, keepdims=True)
    y = np.roll(x, 1, axis=0)
    y[:4] = -x[:4] + 1e-4  # nearly opposite: the shorter arc, then the linear branch
    y[4:8] = x[4:8] * (1 - 1e-3)  # nearly parallel: linear
    for a in (0.0, 0.3, np.linspace(0, 1, 32).astype(np.float32)):
        got = rotation.quat_slerp(t(x), t(y), torch.as_tensor(a)).numpy()
        want = np.asarray(jax.jit(jax_rot.quat_slerp)(jnp.asarray(x), jnp.asarray(y),
                                                       jnp.asarray(a)))
        assert_close_scaled(got, want, REL, f"quat_slerp a={a}")


def test_smpl_skeleton_matches_jax():
    rng = np.random.RandomState(3)
    pose = (rng.randn(20, 72) * 0.4).astype(np.float32)
    root = rng.randn(20, 3).astype(np.float32)
    got = fk.SMPLSkeleton(device="cpu")(pose, root).numpy()
    want = np.asarray(jax.jit(jax_fk.SMPLSkeleton())(jnp.asarray(pose), jnp.asarray(root)))
    assert got.shape == (20, 22, 3)
    assert_close_scaled(got, want, REL, "SMPLSkeleton")
    np.testing.assert_array_equal(fk.SMPL_PARENTS, jax_fk.SMPL_PARENTS)


def test_mean_max_velocity_matches_jax():
    rng = np.random.RandomState(4)
    seqs = [rng.randn(n, 55, 3).astype(np.float32) for n in (2, 17, 40)] + [np.zeros((1, 55, 3))]
    got = fk.mean_max_velocity(seqs + [t(seqs[1])], pose_fps=30)
    want = jax_fk.mean_max_velocity(seqs + [seqs[1]], pose_fps=30)
    assert abs(got - want) <= REL * max(1.0, abs(want))
    assert fk.mean_max_velocity([]) == jax_fk.mean_max_velocity([]) == 1.0
    assert fk.mean_max_velocity([np.zeros((1, 55, 3))]) == 1.0


def test_rest_joints_by_path_win_over_the_environment(tmp_path, monkeypatch):
    rng = np.random.RandomState(5)
    by_env, by_path = (rng.randn(55, 3).astype(np.float32) for _ in range(2))
    np.save(tmp_path / "env.npy", by_env)
    np.save(tmp_path / "path.npy", by_path)
    monkeypatch.setenv("MOTIONCRAFT_SMPLX_J", str(tmp_path / "env.npy"))
    for load in (fk.load_rest_joints, jax_fk.load_rest_joints):
        np.testing.assert_array_equal(load(str(tmp_path / "path.npy")), by_path)
        np.testing.assert_array_equal(load(), by_env)
        np.testing.assert_array_equal(load(str(tmp_path / "missing.npy")), by_env)
    pose = (rng.randn(40, 165) * 0.3).astype(np.float32)  # CLIP's frames: one JAX compile
    root = rng.randn(40, 3).astype(np.float32)
    got = fk.SMPLXSkeleton(str(tmp_path / "path.npy"), device="cpu")(pose, root).numpy()
    want = np.asarray(jax.jit(jax_fk.SMPLXSkeleton(str(tmp_path / "path.npy")).forward)(
        jnp.asarray(pose), jnp.asarray(root)))
    assert_close_scaled(got, want, REL, "SMPLXSkeleton from a path")
    np.testing.assert_array_equal(fk.SMPLSkeleton(str(tmp_path / "path.npy"),
                                                  device="cpu").rest_joints.numpy(),
                                  by_path[:22])


# ------------------------------------------------------------------ export
CLIP = (np.random.RandomState(6).randn(40, 322) * 0.3).astype(np.float32)


@pytest.fixture
def jit_jax_6d(monkeypatch):
    """The JAX package's ``ax_to_6v`` / ``ax_from_6v``, which its export and
    prep import when called, under ``jax.jit``."""
    monkeypatch.setattr(jax_rot, "ax_to_6v", jax.jit(jax_rot.ax_to_6v))
    monkeypatch.setattr(jax_rot, "ax_from_6v", jax.jit(jax_rot.ax_from_6v))


def assert_same_npz(got_path, want_path, what):
    got, want = np.load(got_path, allow_pickle=True), np.load(want_path, allow_pickle=True)
    assert sorted(got.files) == sorted(want.files), what
    for key in want.files:
        g, w = got[key], want[key]
        assert g.shape == w.shape and g.dtype == w.dtype, (what, key, g.shape, w.shape)
        if w.dtype.kind in "fc":
            assert_close_scaled(g, w, REL, f"{what}: {key}")
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{what}: {key}")


@pytest.mark.parametrize("case", ["s2g", "s2g_raw", "m2d", "m2d_raw", "gt"])
def test_export_npz_matches_jax(case, tmp_path, jit_jax_6d):
    betas = np.random.RandomState(7).randn(300).astype(np.float32)
    calls = {"s2g": lambda m, p: m.s2g_export_npz(CLIP, p, betas=betas, fps=30),
             "s2g_raw": lambda m, p: m.s2g_export_npz(CLIP, p, fps=20, smooth=False),
             "m2d": lambda m, p: m.m2d_export_npz(CLIP, p, fps=30),
             "m2d_raw": lambda m, p: m.m2d_export_npz(CLIP, p, smooth=False),
             "gt": lambda m, p: m.gt_export_npz(CLIP, p, betas=betas)}
    calls[case](export, str(tmp_path / "port.npz"))
    calls[case](jax_export, str(tmp_path / "jax.npz"))
    assert_same_npz(tmp_path / "port.npz", tmp_path / "jax.npz", case)
    d = np.load(tmp_path / "port.npz")
    assert d["poses"].shape == (40, 165) and np.abs(d["poses"][:, 69:75]).max() == 0


def test_export_filters_and_fk_match_jax(jit_jax_6d):
    for sigma in (0.0, 1.0, 3.5):
        np.testing.assert_array_equal(export.temporal_filter(CLIP, sigma),
                                      jax_export.temporal_filter(CLIP, sigma))
    assert_close_scaled(export.smooth_axis_angle_6d(CLIP[:, :66], 3.0),
                        jax_export.smooth_axis_angle_6d(CLIP[:, :66], 3.0), REL,
                        "smooth_axis_angle_6d")
    got = export.fk_joints_322(CLIP, device="cpu")
    assert got.shape == (40, 55, 3)
    assert_close_scaled(got, jax_export.fk_joints_322(CLIP), REL, "fk_joints_322")


# --------------------------------------------------------------- web player
DATA_RE = re.compile(r'(<script id="motion-data" type="application/json">)(.*?)(</script>)',
                     re.S)


@pytest.mark.parametrize("max_frames", [2000, 16])
def test_web_player_matches_jax(tmp_path, max_frames):
    """Both players of the same joints (the FK is held above: here a
    difference of 1e-7 could move the 4-decimal rounding by 1e-4)."""
    joints = export.fk_joints_322(CLIP, device="cpu")
    paths = []
    for m in (web_player, jax_web):
        paths.append(m.export_web_player(joints, fk.SMPLX_PARENTS,
                                         str(tmp_path / f"{m.__name__}.html"), fps=30,
                                         title="a person <waves>", max_frames=max_frames))
    got, want = (open(p).read() for p in paths)
    gd, wd = (json.loads(DATA_RE.search(h).group(2)) for h in (got, want))
    assert gd["fps"] == wd["fps"] and gd["parents"] == wd["parents"] == fk.SMPLX_PARENTS.tolist()
    assert len(gd["joints"]) == min(40, max_frames)
    assert_close_scaled(gd["joints"], wd["joints"], REL, "embedded joints")
    assert DATA_RE.sub("", got) == DATA_RE.sub("", want)
    with pytest.raises(ValueError):
        web_player.export_web_player(np.zeros((4, 3)), [-1], str(tmp_path / "bad.html"))


# ----------------------------------------------------------------- humanml3d
def test_humanml3d_recovery_matches_jax():
    rng = np.random.RandomState(8)
    data = (rng.randn(2, 30, 263) * 0.2).astype(np.float32)
    q = rng.randn(2, 30, 4).astype(np.float32)
    v = rng.randn(2, 30, 3).astype(np.float32)
    assert_close_scaled(humanml3d.qinv(t(q)).numpy(),
                        np.asarray(jax.jit(jax_hml.qinv)(jnp.asarray(q))), REL, "qinv")
    assert_close_scaled(humanml3d.qrot(t(q), t(v)).numpy(),
                        np.asarray(jax.jit(jax_hml.qrot)(jnp.asarray(q), jnp.asarray(v))), REL,
                        "qrot")
    for got, want, what in zip(humanml3d.recover_root_rot_pos(t(data)),
                               jax.jit(jax_hml.recover_root_rot_pos)(jnp.asarray(data)),
                               ("root rotation", "root position")):
        assert_close_scaled(got.numpy(), np.asarray(want), REL, what)
    got = humanml3d.recover_from_ric(data).numpy()
    assert got.shape == (2, 30, 22, 3)
    assert_close_scaled(got, np.asarray(jax.jit(jax_hml.recover_from_ric)(data)), REL,
                        "recover_from_ric")
    assert humanml3d.T2M_KINEMATIC_CHAIN == jax_hml.T2M_KINEMATIC_CHAIN
    assert humanml3d.KIT_KINEMATIC_CHAIN == jax_hml.KIT_KINEMATIC_CHAIN


# ------------------------------------------------------------- BVH / mocap
def write_seeded_bvh(path, T=24, seed=9):
    """A BVH of 5 joints (a root with 6 channels in ZXY order, a spine in
    ZXY, a leg in XYZ, two end sites), seeded frames with a constant
    channel and foot-like bumps on the leg."""
    rng = np.random.RandomState(seed)
    frames = rng.randn(T, 12) * 20.0
    frames[:, :3] = np.cumsum(rng.randn(T, 3), 0)
    frames[:, 6] = 5.0  # a constant channel
    frames[:, 9] = 30 * np.abs(np.sin(np.arange(T) / 3.0))
    text = ("HIERARCHY\nROOT Hips\n{\n  OFFSET 0.0 0.0 0.0\n"
            "  CHANNELS 6 Xposition Yposition Zposition Zrotation Xrotation Yrotation\n"
            "  JOINT Spine\n  {\n    OFFSET 0.0 10.0 0.0\n"
            "    CHANNELS 3 Zrotation Xrotation Yrotation\n"
            "    End Site\n    {\n      OFFSET 0.0 5.0 0.0\n    }\n  }\n"
            "  JOINT LeftLeg\n  {\n    OFFSET 3.0 -2.0 0.5\n"
            "    CHANNELS 3 Xrotation Yrotation Zrotation\n"
            "    End Site\n    {\n      OFFSET 0.0 -8.0 1.0\n    }\n  }\n}\n"
            f"MOTION\nFrames: {T}\nFrame Time: 0.0333333\n"
            + "".join(" ".join(f"{v:.5f}" for v in row) + "\n" for row in frames))
    with open(path, "w") as f:
        f.write(text)
    return path


@pytest.fixture(scope="module")
def bvh_pair(tmp_path_factory):
    path = write_seeded_bvh(str(tmp_path_factory.mktemp("bvh") / "seeded.bvh"))
    return bvh.parse_bvh(path), jax_bvh.parse_bvh(path)


def test_bvh_parse_and_write_match_jax(bvh_pair, tmp_path):
    got, want = bvh_pair
    assert [(j.name, j.parent, j.channels, j.channel_offset) for j in got.joints] == \
        [(j.name, j.parent, j.channels, j.channel_offset) for j in want.joints]
    np.testing.assert_array_equal(got.frames, want.frames)
    np.testing.assert_array_equal(got.offsets, want.offsets)
    np.testing.assert_array_equal(got.parents, want.parents)
    assert got.frame_time == want.frame_time
    np.testing.assert_array_equal(got.joint_channels("LeftLeg"), want.joint_channels("LeftLeg"))
    outs = []
    for writer, data in ((mocap, got), (jax_mocap, want), (mocap, want), (jax_mocap, got)):
        outs.append(open(writer.write_bvh(data, str(tmp_path / f"{len(outs)}.bvh")), "rb").read())
    assert all(o == outs[0] for o in outs)
    # the written file parses back to the same frames (6 decimals)
    back = bvh.parse_bvh(str(tmp_path / "0.bvh"))
    np.testing.assert_allclose(back.frames, got.frames, atol=1e-5)


def _mocap_calls(m, data):
    P = m.forward_kinematics(data)
    height = P[:, 4, 1]
    sel, cols = m.select_joints(data, ["Spine", "LeftLeg"])
    reduced, kept, const = m.remove_constants(data.frames)
    return {
        "joint_rotations": m.joint_rotations(data),
        "root_positions": m.root_positions(data),
        "forward_kinematics": P,
        "euler_to_expmap": m.euler_to_expmap(data),
        "select_joints": [sel.frames, cols, sel.parents, sel.offsets],
        "root_centric_positions": m.root_centric_positions(P),
        "root_deltas": m.root_deltas(P, fps=30.0),
        "downsample": m.downsample(data.frames, 3),
        "constant_channels": m.constant_channels(data.frames),
        "remove_constants": [reduced, kept, const],
        "expmap_to_euler_ZXY": m.expmap_to_euler(m.euler_to_expmap(data), "ZXY"),
        "expmap_to_euler_XYZ": m.expmap_to_euler(m.euler_to_expmap(data), "XYZ"),
        "standard_scale": list(m.standard_scale(data.frames)),
        "standard_scale_stored": list(m.standard_scale(data.frames[:5], data.frames.mean(0),
                                                       data.frames.std(0) + 1.0)),
        "peak_indexes": [m.peak_indexes(height, 0.3, 1), m.peak_indexes(height, 0.1, 4),
                         m.peak_indexes(np.ones(5)), m.peak_indexes(height[:2])],
        "foot_contact_idxs": list(m.foot_contact_idxs(height, t=0.02, min_dist=3)),
        "foot_contact_signal": m.foot_contact_signal(height, t=0.02, min_dist=3),
    }


MOCAP_FUNCTIONS = ["joint_rotations", "root_positions", "forward_kinematics", "euler_to_expmap",
                   "select_joints", "root_centric_positions", "root_deltas", "downsample",
                   "constant_channels", "remove_constants", "expmap_to_euler_ZXY",
                   "expmap_to_euler_XYZ", "standard_scale", "standard_scale_stored",
                   "peak_indexes", "foot_contact_idxs", "foot_contact_signal"]


@pytest.fixture(scope="module")
def mocap_results(bvh_pair):
    got, want = bvh_pair
    return _mocap_calls(mocap, got), _mocap_calls(jax_mocap, want)


@pytest.mark.parametrize("name", MOCAP_FUNCTIONS)
def test_mocap_function_matches_jax(mocap_results, name):
    got, want = (r[name] for r in mocap_results)
    got, want = (v if isinstance(v, list) else [v] for v in (got, want))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype, (name, g.shape, w.shape)
        if w.dtype.kind == "f":
            assert_close_scaled(g, w, REL, name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)
    if name == "foot_contact_signal":
        assert 0 < got[0].sum() < len(got[0])  # contacts both made and lost


# -------------------------------------------------------------------- prep
@pytest.fixture(scope="module")
def prep_tree(tmp_path_factory):
    """A Motion-X HumanML3D layout (two motions, spans and full captions),
    raw FineDance files and a motion directory, one copy a package."""
    root = tmp_path_factory.mktemp("prep")
    rng = np.random.RandomState(10)
    motions = {"000001": rng.randn(150, 322), "000002": rng.randn(90, 322),
               "000003": rng.randn(20, 322)}
    captions = {"000001": ["a person walks#walk/VERB#0.0#0.0",
                           "a person jumps#jump/VERB#0.5#3.0",
                           "a person turns#turn/VERB#1.0#1.5",  # 15 frames: dropped
                           "a person waits#wait/VERB#nan#nan"],
                "000002": ["a person spins#spin/VERB#0.2#2.9",
                           "a person spins#spin/VERB#0.0#2.0", "bad line"],
                "000003": ["too short#x#0#0"]}
    raw = [np.concatenate([rng.randn(40, 3), rng.randn(40, 312)], 1) for _ in range(2)]
    raw[1][:, :3] = 0.0  # a still root: some feet in contact
    stats_in = [rng.randn(7, 5).astype(np.float32) for _ in range(2)]
    for pkg in ("port", "jax"):
        base = root / pkg
        for sub in ("motion_data/smplx_322/humanml", "texts/semantic_labels/humanml", "raw",
                    "motions"):
            (base / sub).mkdir(parents=True)
        for mid, m in motions.items():
            np.save(base / "motion_data/smplx_322/humanml" / f"{mid}.npy", m.astype(np.float32))
            (base / "texts/semantic_labels/humanml" / f"{mid}.txt").write_text(
                "\n".join(captions[mid]) + "\n")
        (base / "ann.txt").write_text("000001\n000002\n000003\n000004\nbad\n")
        for i, r in enumerate(raw):
            np.save(base / "raw" / f"{i + 1:03d}.npy", (r * 0.5).astype(np.float32))
            np.save(base / "motions" / f"{i}.npy", stats_in[i])
    return root


def tree_files(base):
    return sorted(os.path.relpath(os.path.join(d, f), base)
                  for d, _, fs in os.walk(base) for f in fs)


def test_prep_matches_jax(prep_tree, jit_jax_6d):
    for m, pkg in ((prep, "port"), (jax_prep, "jax")):
        base = str(prep_tree / pkg)
        random.seed(11)
        m.humanml3d_clip_align(base, "aligned", os.path.join(base, "ann.txt"))
        kw = {"device": "cpu"} if m is prep else {}
        assert m.finedance_motion_feats(os.path.join(base, "raw"),
                                        os.path.join(base, "feats"), **kw) == 2
        m.compute_norm_stats(os.path.join(base, "motions"), os.path.join(base, "stats"))
    port, want = prep_tree / "port", prep_tree / "jax"
    assert tree_files(port) == tree_files(want)
    assert len(os.listdir(port / "motion_data/smplx_322/aligned")) == 4
    for rel in tree_files(port):
        if rel.endswith(".npy"):
            assert_close_scaled(np.load(port / rel), np.load(want / rel), REL, rel)
        else:
            assert (port / rel).read_bytes() == (want / rel).read_bytes(), rel
    contacts = np.load(port / "feats" / "002.npy")[:, :4]
    assert 0 < contacts.sum() < contacts.size


def test_prep_cli_norm_stats(prep_tree, monkeypatch, capsys):
    base = prep_tree / "port"
    monkeypatch.setattr(sys, "argv", ["prep", "norm_stats", "--motion-dir", str(base / "motions"),
                                      "--out-dir", str(base / "cli_stats")])
    runpy.run_module("motioncraft_tpu_torch.data.prep", run_name="__main__")
    assert capsys.readouterr().out == "stats written\n"
    np.testing.assert_array_equal(np.load(base / "cli_stats" / "std.npy"),
                                  np.load(prep_tree / "jax" / "stats" / "std.npy"))
    monkeypatch.setattr(sys, "argv", ["prep", "finedance_feats", "--inputs-dir",
                                      str(base / "raw"), "--outputs-dir", str(base / "cli_feats"),
                                      "--device", "cpu"])
    runpy.run_module("motioncraft_tpu_torch.data.prep", run_name="__main__")
    assert capsys.readouterr().out == "wrote 2 files\n"


# --------------------------------------------------------------- rendering
def test_split_frames_matches_jax():
    for total, n in ((10, 3), (1, 4), (8, 8), (100, 7), (5, 0)):
        assert fast_render.split_frames(total, n) == jax_fast_render.split_frames(total, n)


@pytest.mark.parametrize("n_workers", [1, 2])
def test_render_frames_multiprocess(tmp_path, n_workers):
    import imageio.v2 as imageio

    vertices = np.random.RandomState(12).randn(7, 12, 3).astype(np.float32)
    faces = np.array([[0, 1, 2], [2, 3, 4]], np.int32)
    frames = []
    for m in (fast_render, jax_fast_render):
        path = m.render_frames_multiprocess(vertices, faces, str(tmp_path / f"{m.__name__}.gif"),
                                            fps=5, n_workers=n_workers, width=32, height=24,
                                            frame_renderer_factory=stub_factory)
        frames.append(np.stack(imageio.mimread(path)))
    assert len(frames[0]) == 7
    np.testing.assert_array_equal(frames[0], frames[1])


@pytest.fixture(scope="module")
def smplx_dir(tmp_path_factory):
    """A models directory in the render layout, holding a fabricated SMPL-X
    model (tests/test_smplx_lbs.py's)."""
    d = tmp_path_factory.mktemp("models")
    (d / "smplx").mkdir()
    np.savez(d / "smplx" / "SMPLX_NEUTRAL_2020.npz", **fabricate_model())
    return d


def test_smplx_vertices_for_render_matches_jax(smplx_dir):
    rng = np.random.RandomState(13)
    args = (rng.randn(5, 165).astype(np.float32) * 0.1, rng.randn(5, 3).astype(np.float32))
    kw = dict(expressions=rng.randn(5, 100).astype(np.float32) * 0.1,
              betas=rng.randn(300).astype(np.float32) * 0.1,
              model_path=str(smplx_dir / "smplx" / "SMPLX_NEUTRAL_2020.npz"))
    got, faces = fast_render.smplx_vertices_for_render(*args, device="cpu", **kw)
    want, want_faces = jax_fast_render.smplx_vertices_for_render(*args, **kw)
    assert got.shape == (5, 40, 3)
    assert_close_scaled(got, want, REL, "LBS vertices")
    np.testing.assert_array_equal(faces, want_faces)


def test_render_one_sequence_mesh_route(smplx_dir, tmp_path, monkeypatch):
    """With pyrender taken as present and the models directory given: the
    mesh route's vertices go to the frame renderer as the JAX package's do."""
    export.s2g_export_npz(CLIP[:6], str(tmp_path / "clip.npz"),
                          betas=np.random.RandomState(14).randn(300) * 0.1)
    seen = {}
    for m, fr in ((render, fast_render), (jax_render, jax_fast_render)):
        def capture(vertices, faces, out_video, fps=30, audio_path=None, _m=m):
            seen[_m.__name__] = (vertices, faces, fps, audio_path)
            return out_video
        monkeypatch.setattr(m, "have_mesh_renderer", lambda: True)
        monkeypatch.setattr(fr, "render_frames_multiprocess", capture)
        kw = {"device": "cpu"} if m is render else {}
        out = m.render_one_sequence(str(tmp_path / "clip.npz"), str(tmp_path / "clip.mp4"),
                                    audio_path="speech.wav", model_path=str(smplx_dir), fps=15,
                                    **kw)
        assert out == str(tmp_path / "clip.mp4")
    (gv, gf, gfps, gwav), (wv, wf, wfps, wwav) = seen[render.__name__], seen[jax_render.__name__]
    assert gv.shape == (6, 40, 3) and (gfps, gwav) == (wfps, wwav) == (15, "speech.wav")
    assert_close_scaled(gv, wv, REL, "mesh route vertices")
    np.testing.assert_array_equal(gf, wf)
    assert render.have_smplx_model(str(smplx_dir)) == str(smplx_dir)
    assert render.have_smplx_model(str(tmp_path / "none")) == jax_render.have_smplx_model(
        str(tmp_path / "none"))
    assert render.have_mesh_renderer() == jax_render.have_mesh_renderer()


def test_render_one_sequence_skeleton_route(tmp_path, monkeypatch):
    pytest.importorskip("matplotlib")
    export.gt_export_npz(CLIP[:3], str(tmp_path / "clip.npz"))
    monkeypatch.setattr(render, "have_mesh_renderer", lambda: False)
    out = render.render_one_sequence(str(tmp_path / "clip.npz"), str(tmp_path / "clip.mp4"),
                                     fps=10, device="cpu")
    assert out in (str(tmp_path / "clip.mp4"), str(tmp_path / "clip.gif"))
    assert os.path.getsize(out) > 0
    hml = humanml3d.recover_from_ric((np.random.RandomState(15).randn(3, 263) * 0.1)
                                     .astype(np.float32))
    out = humanml3d.plot_3d_motion(str(tmp_path / "hml.mp4"), hml, title="walk", fps=10)
    assert out in (str(tmp_path / "hml.mp4"), str(tmp_path / "hml.gif"))
    assert os.path.getsize(out) > 0
