"""The port's ControlNet and mixed training data against the JAX package's,
on the CPU:

- ``Beat2WindowDataset`` on the committed BEAT2 fixture
  (configs/tests/fixture_beat2.yaml): the same windows in the same order,
  and a window cache written by either package read back by the other;
  a reference LMDB cache is refused (the port cannot read one) unless
  ``new_cache`` is set;
- ``SpeechMotionDataset`` over it, sample for sample through the speech
  pipeline (Normalize, ContrlCrop, ToTensor, Collect);
- ``ContrlCrop`` on a seeded generator: long and short inputs, with and
  without ``stride``;
- ``FinedanceMotionDataset`` on the cross-genre train split;
- ``build_mixed_dataset`` on tools/make_tiny_data.py trees (Motion-X,
  FineDance with train tracks, BEAT2) with the flagship's mixed schema,
  every sample of the merged set in order for one numpy seed;
- ``collate`` of a mixed batch whose samples disagree on ``c``: the JAX
  package raises KeyError when the first sample has it, the port leaves
  ``c`` out (ROADMAP queue 3, departures); both leave it out when the first
  sample lacks it.

Values compare exactly: both packages run the same numpy on the same
inputs.
"""

import copy
import importlib.util
import json
import os
from types import SimpleNamespace

import numpy as np
import pytest

import motioncraft_tpu.data  # noqa: F401  (registers the JAX datasets)
from motioncraft_tpu.data import beat2 as jax_beat2
from motioncraft_tpu.data.datasets import build_mixed_dataset as jax_build_mixed
from motioncraft_tpu.data.loader import collate as jax_collate
from motioncraft_tpu.data.pipelines import ContrlCrop as JaxContrlCrop
from motioncraft_tpu.registry import DATASETS as JAX_DATASETS
from motioncraft_tpu_torch.data import beat2, build_mixed_dataset, collate
from motioncraft_tpu_torch.data.pipelines import ContrlCrop
from motioncraft_tpu_torch.registry import build_dataset
from torch_port_util import own_jax_native_build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE_YAML = os.path.join(REPO, "configs", "tests", "fixture_beat2.yaml")
FINEDANCE_TRAIN = ("001", "002", "003")  # cross_genre train tracks
CROP = 48  # the mixed set's crop


def assert_same(a, b, what=""):
    """Two samples (dicts of arrays, scalars, strings and dicts) equal."""
    assert set(a) == set(b), (what, sorted(a), sorted(b))
    for k in a:
        if isinstance(a[k], dict):
            assert_same(a[k], b[k], f"{what}.{k}")
        elif isinstance(a[k], (np.ndarray, np.generic)):
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{what}.{k}")
            assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, (what, k)
        else:
            assert a[k] == b[k], (what, k, a[k], b[k])


def load_make_tiny_data():
    spec = importlib.util.spec_from_file_location(
        "make_tiny_data", os.path.join(REPO, "tools", "make_tiny_data.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def jax_native_build(monkeypatch, tmp_path_factory):
    """The JAX package's onset extractor from a build of this process's own
    (torch_port_util.own_jax_native_build): the BEAT2 windows hold onsets,
    which the port always takes from its native build."""
    own_jax_native_build(monkeypatch, tmp_path_factory.getbasetemp() / "native")


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """tools/make_tiny_data.py's tree (Motion-X, FineDance, BEAT2), with
    three FineDance tracks of the cross-genre train split beside its two
    test tracks."""
    root = tmp_path_factory.mktemp("data_tiny")
    mod = load_make_tiny_data()
    rng = np.random.RandomState(0)
    mod.make_motionx(str(root), rng, n=5, t=48)
    mod.make_finedance(str(root), rng, t=400)
    mod.make_beat2(str(root), rng, t=200)
    d = os.path.join(root, "datasets", "finedance")
    for i, name in enumerate(FINEDANCE_TRAIN):
        n = 360 + 150 + 40 * i
        np.save(os.path.join(d, "motion_fea163", name + ".npy"),
                (rng.randn(n, 319) * 0.1).astype(np.float32))
        np.save(os.path.join(d, "music_npy", name + ".npy"),
                (rng.randn(n + 5, 163) * 0.1).astype(np.float32))
        with open(os.path.join(d, "label_json", name + ".json"), "w") as f:
            json.dump({"name": f"song{name}", "style1": "Popping", "style2": "old"}, f)
    with open(os.path.join(root, "beat2.yaml"), "w") as f:
        f.write(f"data_path: {root}/beat2/\npose_length: 16\nstride: 8\npose_fps: 30\n"
                "audio_sr: 16000\naudio_rep: onset+amplitude\npose_rep: smplxflame_30\n"
                "training_speakers: [2]\n")
    return root


def fixture_args(monkeypatch, **kw):
    """Both packages' BEAT2 arguments of the committed fixture (its
    data_path is relative to the repository)."""
    monkeypatch.chdir(REPO)
    a, b = jax_beat2.load_beat2_args(FIXTURE_YAML), beat2.load_beat2_args(FIXTURE_YAML)
    assert vars(a) == vars(b)
    for ns in (a, b):
        vars(ns).update(kw)
    return a, b


# ------------------------------------------------------------------- BEAT2
def test_beat2_windows_and_cache(monkeypatch, tmp_path, jax_native_build):
    ja, pa = fixture_args(monkeypatch)
    want = jax_beat2.Beat2WindowDataset(ja, "train")
    got = beat2.Beat2WindowDataset(pa, "train")
    assert len(got) == len(want) == (96 - 16) // 8 + 1
    for i in range(len(want)):
        assert_same(got[i], want[i], f"window {i}")
    assert any(got[i]["words"] for i in range(len(got)))
    assert got[0]["audio"].shape == (16 * 533, 2)

    # the window cache: each package reads the file the other wrote
    for writer, reader in ((beat2, jax_beat2), (jax_beat2, beat2)):
        cache = tmp_path / writer.__name__.replace(".", "_")
        w_args, r_args = (fixture_args(monkeypatch, cache_path=str(cache)) if writer is jax_beat2
                          else fixture_args(monkeypatch, cache_path=str(cache))[::-1])
        written = writer.Beat2WindowDataset(w_args, "train")
        files = os.listdir(cache)
        assert len(files) == 1 and files[0].startswith("beat2_train_"), files
        r_args.data_path = str(tmp_path / "nowhere")  # read from the cache alone
        read = reader.Beat2WindowDataset(r_args, "train")
        assert len(read) == len(written) == len(want)
        for i in range(len(want)):
            assert_same(read[i], want[i], f"cached window {i}")
    assert (beat2.Beat2WindowDataset(pa, "train").cache_file() is None)


def test_beat2_lmdb_cache_refused(monkeypatch, tmp_path):
    ja, pa = fixture_args(monkeypatch, cache_path=str(tmp_path))
    lmdb_dir = tmp_path / "train" / "smplxflame_30_cache"
    lmdb_dir.mkdir(parents=True)
    (lmdb_dir / "data.mdb").write_bytes(b"")
    assert beat2.find_lmdb_cache(pa, "train") == jax_beat2.find_lmdb_cache(ja, "train") \
        == str(lmdb_dir)
    assert beat2.find_lmdb_cache(pa, "test") == jax_beat2.find_lmdb_cache(ja, "test")
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1: the rest of training"):
        beat2.Beat2WindowDataset(pa, "train")
    pa.new_cache = True  # builds the windows (and the npz cache) instead
    assert len(beat2.Beat2WindowDataset(pa, "train")) == (96 - 16) // 8 + 1


def speech_cfg(yaml_path, stats, crop=12):
    return dict(type="SpeechMotionDataset", dataset_name="beats2", data_prefix="./data",
                ann_file="train.txt", motion_dir="motions", text_dir="texts",
                ann_config=yaml_path,
                pipeline=[dict(type="Normalize", mean_path=f"{stats}/mean.npy",
                               std_path=f"{stats}/std.npy"),
                          dict(type="ContrlCrop", crop_size=crop),
                          dict(type="ToTensor", keys=["motion", "motion_mask"]),
                          dict(type="Collect", keys=["motion", "motion_mask", "motion_length"],
                               meta_keys=["text"])])


def test_speech_motion_dataset(monkeypatch, jax_native_build):
    monkeypatch.chdir(REPO)
    cfg = speech_cfg(FIXTURE_YAML, os.path.join(REPO, "tests", "fixtures", "mini", "stats"))
    want, got = JAX_DATASETS.build(copy.deepcopy(cfg)), build_dataset(copy.deepcopy(cfg))
    assert len(got) == len(want) == 11
    for i, (a, b) in enumerate(zip(got.data_infos, want.data_infos)):
        assert_same(a, b, f"info {i}")
    assert got.data_infos[0]["text"][0].startswith(
        "A person is doing a speech, and the speech content is hello")
    for i in range(len(want)):
        np.random.seed(100 + i)
        b = want[i]
        np.random.seed(100 + i)
        assert_same(got[i], b, f"sample {i}")
    assert got[0]["c"].shape == (12, 2) and got[0]["motion"].shape == (12, 322)


@pytest.mark.parametrize("length,stride", [(300, None), (300, 30), (40, 30)],
                         ids=["long", "long_stride", "short"])
def test_contrl_crop(length, stride):
    rng = np.random.RandomState(3)
    results = {"motion": rng.randn(length, 322).astype(np.float32),
               "c": rng.randn(length + 7, 163).astype(np.float64), "text": "x"}
    outs = []
    for crop in (JaxContrlCrop(196, stride), ContrlCrop(196, stride)):
        r = copy.deepcopy(results)
        r["_rng"] = np.random.RandomState(11)
        outs.append({k: v for k, v in crop(r).items() if k != "_rng"})
    assert_same(outs[1], outs[0])
    if length >= 196:
        start = int(np.where((results["motion"] == outs[1]["motion"][0]).all(1))[0][0])
        assert stride is None or start % stride == 0
        np.testing.assert_array_equal(outs[1]["c"],
                                      results["c"][start:start + 196].astype(np.float32))
    else:
        assert outs[1]["motion_length"] == length and outs[1]["c"].shape == (length + 7 + 156,
                                                                             163)


def finedance_cfg(root, crop=120):
    stats = os.path.join(root, "datasets", "finedance")
    return dict(type="FinedanceMotionDataset", dataset_name="finedance", data_prefix=str(root),
                ann_file="train.txt", motion_dir="motion_fea163", text_dir="label_json",
                datasplit="cross_genre", music_dir="music_npy",
                pipeline=[dict(type="Normalize", mean_path=f"{stats}/mean.npy",
                               std_path=f"{stats}/std.npy"),
                          dict(type="ContrlCrop", crop_size=crop, stride=30),
                          dict(type="ToTensor", keys=["motion", "motion_mask"]),
                          dict(type="Collect", keys=["motion", "motion_mask", "motion_length"],
                               meta_keys=["text"])])


def test_finedance_train_split(tree):
    cfg = finedance_cfg(tree)
    want, got = JAX_DATASETS.build(copy.deepcopy(cfg)), build_dataset(copy.deepcopy(cfg))
    assert [i["name"] for i in got.data_infos] == [i["name"] for i in want.data_infos] \
        == list(FINEDANCE_TRAIN)
    for i in range(len(want)):
        np.random.seed(7 + i)
        b = want[i]
        np.random.seed(7 + i)
        assert_same(got[i], b, f"track {i}")
        assert got[i]["c"].shape == (120, 163)


def mixed_cfg(root):
    """The flagship's mixed train schema (configs/_base_/datasets/
    motionx_mix_bs128.py) over the tiny tree, the repeats cut, every crop
    48 frames (the flagship's are all 196)."""
    motionx = os.path.join(root, "datasets", "motionx")
    text = dict(type="TextMotionDataset", dataset_name="motionx", data_prefix=str(root),
                ann_file="ann.txt", motion_dir="motions", text_dir="texts",
                pipeline=[dict(type="Normalize", mean_path=f"{motionx}/mean.npy",
                               std_path=f"{motionx}/std.npy"),
                          dict(type="Crop", crop_size=CROP),
                          dict(type="ToTensor", keys=["motion", "motion_mask"]),
                          dict(type="Collect", keys=["motion", "motion_mask", "motion_length"],
                               meta_keys=["text"])])
    speech = speech_cfg(os.path.join(root, "beat2.yaml"), os.path.join(root, "stats"), CROP)
    speech["data_prefix"] = str(root)
    return dict(base=dict(type="TextMixMotionDataset"),
                text=dict(type="RepeatDataset", dataset=text, times=2),
                music=dict(type="RepeatDataset", dataset=finedance_cfg(root, CROP), times=3),
                speech=dict(type="RepeatDataset", dataset=speech, times=1))


def test_build_mixed_dataset(tree, jax_native_build):
    want = jax_build_mixed(copy.deepcopy(mixed_cfg(tree)))
    got = build_mixed_dataset(copy.deepcopy(mixed_cfg(tree)))
    assert type(build_dataset(copy.deepcopy(mixed_cfg(tree)))) is type(got)
    n_speech = (200 - 16) // 8 + 1
    assert len(got) == len(want) == 5 * 2 + 3 * 3 + n_speech
    assert sorted(got.pipelines) == sorted(want.pipelines) == ["beats2", "finedance", "motionx"]
    np.random.seed(21)
    samples_j = [want[i] for i in range(len(want))]
    np.random.seed(21)
    for i, b in enumerate(samples_j):
        assert_same(got[i], b, f"mixed sample {i}")
    names = [s.get("dataset_name") for s in samples_j]
    assert names == ["motionx"] * 10 + ["finedance"] * 9 + ["beats2"] * n_speech


def test_collate_mixed_batch_disagreeing_on_c(tree):
    """The first sample's keys decide in both; where a later sample lacks
    ``c`` the JAX package raises and the port leaves ``c`` out."""
    mix = build_mixed_dataset(copy.deepcopy(mixed_cfg(tree)))
    np.random.seed(0)
    text, music, speech = mix[0], mix[10], mix[-1]
    assert "c" not in text and music["c"].shape == (CROP, 163) and speech["c"].shape[1] == 2
    batch = [music, text, speech]
    with pytest.raises(KeyError):
        jax_collate(batch)
    got = collate(batch)
    assert "c" not in got and got["motion"].shape == (3, CROP, 322)
    want = jax_collate(batch[1:2] + batch[:1] + batch[2:])  # the text sample first
    assert "c" not in want
    assert_same({k: v for k, v in got.items() if k != "motion_metas"},
                {k: np.stack([want[k][1], want[k][0], want[k][2]]) if k != "dataset_name"
                 else [want[k][1], want[k][0], want[k][2]]
                 for k in want if k != "motion_metas"})
    # samples of one kind: c stacked, the same in both
    pair = [music, mix[11]]
    a, b = collate(pair), jax_collate(pair)
    np.testing.assert_array_equal(a["c"], b["c"])
    assert a["c"].shape == (2, CROP, 163)


def test_speech_args_namespace_defaults():
    """The flat-yaml reader's defaults match the JAX package's for the
    keys the window dataset reads."""
    assert isinstance(beat2.load_beat2_args(None), SimpleNamespace)
    for key in ("pose_length", "stride", "pose_fps", "audio_sr", "audio_rep", "pose_rep",
                "training_speakers", "cache_path", "new_cache"):
        assert getattr(beat2.load_beat2_args(None), key) == \
            getattr(jax_beat2.load_beat2_args(None), key), key
