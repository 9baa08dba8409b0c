"""tools/torch_{visualize,m2d_visualize,s2g_visualize}.py against the JAX
package's tools/{visualize,m2d_visualize,s2g_visualize}.py on the CPU, on
configs/tests/tiny_{t2m,m2d,s2g}.py over one tools/make_tiny_data.py tree
(seeded, non-trivial mean / std, so that the de-normalisation shows):

- each pair of CLIs runs in this process on the same seeded ``params.npz``
  (written in the JAX layout), the port on the JAX CLI's normal draws
  replayed (torch_port_util.jax_sample_draws / jax_windowed_draws): the
  same files, every npz array within 1e-4 x max |JAX| (the strings equal),
  every HTML player's joints within 1e-4 and the rest of the file equal,
  and the same printed lines (their output directory and the S2G tool's
  seconds masked);
- the T2M pair with two prompts of two lengths and --smooth, the M2D pair
  on a labelled track (a window of the trimmed music) and on a missing one
  (the generic caption, zero music) with --no-smooth (the 6d smoothing is
  held in tests/test_torch_host_tools.py, where the JAX package's eager
  rotations compile once), the S2G pair on a recording of two windows,
  RePaint outpainting the second, smoothed;
- --device cuda without a card is refused by each port CLI;
- --plot's stick figure is written, an mp4 or its gif fallback.

The JAX CLIs initialise a model they then replace by --checkpoint; that
initialisation (a jit compile of the flax init, most of a JAX CLI's time
here) is stood in by a no-op, which changes none of their outputs.
"""

import importlib.util
import json
import os
import re
import sys

import jax
import numpy as np
import pytest
import torch

import motioncraft_tpu.models  # noqa: F401  (registers the flax classes)
from motioncraft_tpu.diffusion.sampling import RepaintConfig as JaxRepaintConfig
from motioncraft_tpu.models.architecture import MotionDiffusion as JaxMotionDiffusion
from motioncraft_tpu.utils.checkpoint import save_params as jax_save_params
from motioncraft_tpu_torch.config import Config
from motioncraft_tpu_torch.registry import build_architecture
from motioncraft_tpu_torch.utils.convert import to_jax_variables
from torch_port_util import (Replay, jax_sample_draws, jax_windowed_draws,
                             own_jax_native_build, seeded_batch_stats, seeded_params)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = {k: os.path.join(REPO, "configs", "tests", f"tiny_{k}.py") for k in ("t2m", "m2d", "s2g")}
BEAT2_YAML = os.path.join(REPO, "configs", "tests", "tiny_beat2.yaml")
REL = 1e-4
ROUNDING = 1e-4  # the web player's joints are written to 4 decimals
S2G_FRAMES = 28  # two windows of 16 overlapping by 4


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def steps_of(kind):
    """The DDIM steps of a tiny config (its respacing is one number)."""
    return int(Config.fromfile(CONFIGS[kind]).model["diffusion_test"]["respace"])


def tool(name):
    return _load(name, os.path.join(REPO, "tools", name + ".py"))


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """./data_tiny (Motion-X, FineDance, BEAT2 with one test recording of
    S2G_FRAMES), each dataset's mean / std seeded, and a seeded snapshot of
    each tiny config's denoiser (the port's parameter tree in the JAX
    layout, with seeded values)."""
    root = tmp_path_factory.mktemp("vis")
    make = _load("make_tiny_data", os.path.join(REPO, "tools", "make_tiny_data.py"))
    rng = np.random.RandomState(0)
    data = root / "data_tiny"
    make.make_motionx(str(data), rng, n=2, t=16)
    make.make_finedance(str(data), rng, t=400)
    make.make_beat2(str(data), rng, t=S2G_FRAMES)
    for d in ("datasets/motionx", "datasets/finedance", "stats"):
        np.save(data / d / "mean.npy", (rng.randn(322) * 0.2).astype(np.float32))
        np.save(data / d / "std.npy", rng.uniform(0.5, 1.5, 322).astype(np.float32))
    for i, (kind, path) in enumerate(sorted(CONFIGS.items())):
        model = build_architecture(Config.fromfile(path).model, device="cpu").model
        tree = to_jax_variables(model.state_dict())
        variables = {"params": seeded_params(tree["params"], 10 + i)}
        if tree.get("batch_stats"):
            variables["batch_stats"] = seeded_batch_stats(tree["batch_stats"], 20 + i)
        jax_save_params(str(root / f"{kind}.npz"), variables)
    return root


@pytest.fixture
def in_workdir(workdir, monkeypatch):
    monkeypatch.chdir(workdir)
    monkeypatch.setattr(JaxMotionDiffusion, "init", lambda self, rng, batch: None)
    return workdir


def run_jax_cli(name, argv, monkeypatch, capsys):
    """tools/<name>.py of the JAX package in this process: its printed lines."""
    capsys.readouterr()
    monkeypatch.setattr(sys, "argv", [name] + argv)
    tool(name).main()
    return capsys.readouterr().out.splitlines()


def run_port_cli(name, argv, randn, capsys):
    capsys.readouterr()
    res = tool(name).main(argv + ["--device", "cpu"], randn=randn)
    return res, capsys.readouterr().out.splitlines()


HTML_DATA = re.compile(r'(<script id="motion-data" type="application/json">)(.*?)(</script>)',
                       re.S)


def assert_same_outputs(got_dir, want_dir):
    """The same file names; npz arrays within REL x max |JAX| (strings
    equal); HTML players' joints within REL, the rest equal."""
    names = sorted(os.listdir(want_dir))
    assert sorted(os.listdir(got_dir)) == names and names
    for name in names:
        got, want = os.path.join(got_dir, name), os.path.join(want_dir, name)
        if name.endswith(".npz"):
            g, w = np.load(got, allow_pickle=True), np.load(want, allow_pickle=True)
            assert sorted(g.files) == sorted(w.files), name
            for key in w.files:
                assert g[key].shape == w[key].shape and g[key].dtype == w[key].dtype, (name, key)
                if w[key].dtype.kind == "f" and w[key].size:
                    diff = float(np.abs(g[key] - w[key]).max())
                    limit = REL * float(np.abs(w[key]).max())
                    assert diff <= limit, f"{name}:{key}: max diff {diff} > {limit}"
                else:
                    np.testing.assert_array_equal(g[key], w[key], err_msg=f"{name}:{key}")
        else:
            g, w = open(got).read(), open(want).read()
            gj, wj = (np.asarray(json.loads(HTML_DATA.search(h).group(2))["joints"])
                      for h in (g, w))
            # the player rounds to 4 decimals: a difference far below REL can
            # still move a value by one unit of that rounding
            limit = REL * float(np.abs(wj).max()) + ROUNDING
            assert gj.shape == wj.shape and float(np.abs(gj - wj).max()) <= limit, name
            assert HTML_DATA.sub("", g) == HTML_DATA.sub("", w), name


def test_t2m_cli_matches_the_jax_cli(in_workdir, monkeypatch, capsys):
    texts, lengths = ["a person waves", "a person jumps then turns"], [16, 12]
    common = [CONFIGS["t2m"], "--checkpoint", str(in_workdir / "t2m.npz"), "--text", *texts,
              "--motion_length", *map(str, lengths), "--seed", "3", "--smooth", "1.5",
              "--fps", "20"]
    want = run_jax_cli("visualize", common + ["--out", "jax_t2m"], monkeypatch, capsys)
    draws = jax_sample_draws(steps_of("t2m"), None, jax.random.PRNGKey(3 + 1), (2, 16, 322))
    source = Replay(draws)
    res, got = run_port_cli("torch_visualize", common + ["--out", "port_t2m"], source, capsys)
    assert source.done()
    assert [s.replace("port_t2m", "jax_t2m") for s in got] == want
    assert want == [f"[0] {texts[0]!r} -> jax_t2m/sample_0.npz (16 frames)",
                    f"[1] {texts[1]!r} -> jax_t2m/sample_1.npz (12 frames)"]
    assert_same_outputs("port_t2m", "jax_t2m")
    d = np.load("port_t2m/sample_1.npz")
    assert d["poses"].shape == (12, 165) and int(d["mocap_frame_rate"]) == 20
    # de-normalised with the config's Normalize stats
    assert abs(float(res["pred"].mean())) > 1e-3 and res["pred"].shape == (2, 16, 322)


def test_m2d_cli_matches_the_jax_cli(in_workdir, monkeypatch, capsys):
    L = 16
    common = [CONFIGS["m2d"], "--checkpoint", str(in_workdir / "m2d.npz"), "--track", "063",
              "404", "--motion_length", str(L), "--slice-idx", "2", "--seed", "5", "--web",
              "--no-smooth"]
    want = run_jax_cli("m2d_visualize", common + ["--out", "jax_m2d"], monkeypatch, capsys)
    steps = steps_of("m2d")
    rng, draws = jax.random.PRNGKey(5), []
    for _ in range(2):
        rng, sub = jax.random.split(rng)
        draws += jax_sample_draws(steps, None, sub, (1, L, 322))
    source = Replay(draws)
    res, got = run_port_cli("torch_m2d_visualize", common + ["--out", "port_m2d"], source,
                            capsys)
    assert source.done()
    assert [s.replace("port_m2d", "jax_m2d") for s in got] == want
    assert want[0].startswith(f"warning: motion_length={L} outside the FineDance range")
    assert any("using generic caption" in s for s in want)
    assert any("conditioning on zeros" in s for s in want)
    assert_same_outputs("port_m2d", "jax_m2d")
    assert sorted(os.listdir("port_m2d")) == [f"res_{t}_{L}_2.{e}" for t in ("063", "404")
                                               for e in ("html", "npz")]
    d = np.load("port_m2d/res_063_16_2.npz")
    assert np.abs(d["poses"][:, 66:75]).max() == 0 and np.abs(d["expressions"]).max() == 0


def test_s2g_cli_matches_the_jax_cli(in_workdir, monkeypatch, capsys, tmp_path_factory):
    own_jax_native_build(monkeypatch, tmp_path_factory.getbasetemp() / "native")
    cfg = Config.fromfile(CONFIGS["s2g"])
    window, pre = cfg.windowed["window"], cfg.windowed["pre_frames"]
    common = [CONFIGS["s2g"], "--checkpoint", str(in_workdir / "s2g.npz"), "--beats2-args",
              BEAT2_YAML, "--seed", "7", "--limit", "1", "--web"]
    want = run_jax_cli("s2g_visualize", common + ["--out", "jax_s2g"], monkeypatch, capsys)
    steps = steps_of("s2g")
    _, sub = jax.random.split(jax.random.PRNGKey(7))
    draws = jax_windowed_draws(steps, JaxRepaintConfig(overlap_len=pre), sub, (1, window, 322),
                               2, pre)
    source = Replay(draws)
    res, got = run_port_cli("torch_s2g_visualize", common + ["--out", "port_s2g"], source,
                            capsys)
    assert source.done()
    mask = re.compile(r"\(\d+\.\ds\)$")
    assert [mask.sub("(s)", s.replace("port_s2g", "jax_s2g")) for s in got] == \
        [mask.sub("(s)", s) for s in want]
    assert want[0].startswith(f"[1/1] 2_alice_0_2_2: T={S2G_FRAMES} -> jax_s2g/res_")
    assert_same_outputs("port_s2g", "jax_s2g")
    assert sorted(os.listdir("port_s2g")) == ["gt_2_alice_0_2_2.npz", "res_2_alice_0_2_2.html",
                                              "res_2_alice_0_2_2.npz"]
    assert res["preds"][0].shape == (S2G_FRAMES, 322)


@pytest.mark.parametrize("name", ["torch_visualize", "torch_m2d_visualize",
                                  "torch_s2g_visualize"])
def test_cuda_without_a_card_is_refused(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = {"torch_visualize": [CONFIGS["t2m"], "--text", "a person waves"],
            "torch_m2d_visualize": [CONFIGS["m2d"], "--track", "063"],
            "torch_s2g_visualize": [CONFIGS["s2g"]]}[name]
    with pytest.raises(SystemExit, match="no CUDA device: pass --device cpu"):
        tool(name).main(argv)


def test_plot_skeleton_writes_a_video(tmp_path):
    """--plot's stick figure: an mp4 through ffmpeg, else a gif, as the JAX
    tool's chain falls back; the line it prints names the file."""
    pytest.importorskip("matplotlib")
    clip = (np.random.RandomState(1).randn(3, 322) * 0.2).astype(np.float32)
    lines = []
    tool("torch_visualize").plot_skeleton(clip, str(tmp_path / "clip.mp4"), 10, "cpu",
                                          lines.append)
    written = [p for p in ("clip.mp4", "clip.gif") if (tmp_path / p).is_file()]
    assert written and lines == [f"  skeleton video -> {tmp_path / written[0]}"]
