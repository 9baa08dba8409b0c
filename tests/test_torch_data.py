"""The port's T2M data path against the JAX package's: on a synthetic
Motion-X tree (tools/make_tiny_data.py's layout), ``TextMotionDataset`` and
``build_dataloader`` of both give identical eval indexes and identical
batches for the same numpy seed, in test mode (shuffled replications, the
last batch short) and in training mode (shuffled), without and with
prefetch threads.  The threads draw each sample's crop from the global
numpy generator in no fixed order, in both packages, so their tree holds no
clip longer than the crop."""

import copy
import importlib.util
import os

import numpy as np
import pytest

import motioncraft_tpu.data  # noqa: F401  (registers the JAX datasets)
from motioncraft_tpu.config import Config
from motioncraft_tpu.data import build_dataloader as jax_build_dataloader
from motioncraft_tpu.registry import DATASETS as JAX_DATASETS
from motioncraft_tpu_torch.data import build_dataloader, collate
from motioncraft_tpu_torch.registry import build_dataset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = ("motion", "motion_mask", "motion_length", "text_ids")


def make_tree(root, t):
    """tools/make_tiny_data.py's Motion-X tree, 11 clips of ``t`` frames (3
    of them shorter than the crop, so the crop pads them)."""
    spec = importlib.util.spec_from_file_location(
        "make_tiny_data", os.path.join(REPO, "tools", "make_tiny_data.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    rng = np.random.RandomState(0)
    mod.make_motionx(str(root), rng, n=11, t=t)
    for i in (2, 5, 9):
        np.save(os.path.join(root, "datasets", "motionx", "motions", f"clip{i:03d}.npy"),
                rng.randn(6 + i, 322).astype(np.float32))


def data_cfg(root, split):
    cfg = Config.fromfile(os.path.join(REPO, "configs", "tests", "tiny_t2m.py"))
    d = copy.deepcopy(dict(cfg.data[split]))
    d["data_prefix"] = str(root)
    stats = os.path.join(str(root), "datasets", "motionx")
    d["pipeline"] = [dict(p, mean_path=os.path.join(stats, "mean.npy"),
                          std_path=os.path.join(stats, "std.npy"))
                     if p["type"] == "Normalize" else dict(p) for p in d["pipeline"]]
    return d


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """frames per clip -> tree: 24 (random crops), 16 (the crop's size)."""
    out = {}
    for t in (24, 16):
        out[t] = tmp_path_factory.mktemp(f"data_tiny_{t}")
        make_tree(out[t], t)
    return out


def _epoch(build, dataset_cfg, np_seed, **loader_kw):
    np.random.seed(np_seed)
    ds = build(dataset_cfg)
    loader = (jax_build_dataloader if build is JAX_DATASETS.build else build_dataloader)(
        ds, **loader_kw)
    loader.drop_last = loader_kw.get("shuffle", False)
    return ds, list(loader)


@pytest.mark.parametrize("split,shuffle,workers", [("test", False, 0), ("test", False, 2),
                                                   ("train", True, 0), ("train", True, 2)])
def test_datasets_and_loaders_match_jax(trees, split, shuffle, workers):
    tree = trees[16 if workers else 24]
    jax_cfg = data_cfg(tree, split)
    port_cfg = copy.deepcopy(jax_cfg)
    if split == "test":
        port_cfg["eval_cfg"]["evaluator_model"]["device"] = "cpu"
    kw = dict(samples_per_gpu=4, shuffle=shuffle, workers_per_gpu=workers, round_up=False,
              seed=5)
    jds, want = _epoch(JAX_DATASETS.build, jax_cfg, 3, **kw)
    pds, got = _epoch(build_dataset, port_cfg, 3, **kw)
    assert len(pds) == len(jds)
    if split == "test":
        np.testing.assert_array_equal(pds.eval_indexes, jds.eval_indexes)
        assert len(pds.eval_indexes) == 22 and [len(b["motion"]) for b in got][-1] == 2
        assert [type(e).__name__ for e in pds.evaluators] == [
            type(e).__name__ for e in jds.evaluators]
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        for k in KEYS:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k])
        assert g["motion_metas"] == w["motion_metas"]
    # the short clips came padded out of the crop
    lengths = np.concatenate([b["motion_length"].reshape(-1) for b in got])
    assert lengths.min() < 16 and lengths.max() == 16


def test_collate_and_cut_options():
    batch = collate([{"motion": np.zeros((3, 2), np.float32), "motion_length": 3,
                      "motion_metas": {"text": "a person walks"}},
                     {"motion": np.ones((3, 2), np.float32), "motion_length": 2,
                      "motion_metas": {"text": "jumps"}}])
    assert batch["motion"].shape == (2, 3, 2) and batch["motion_length"].shape == (2, 1)
    assert batch["text_ids"].shape == (2, 77) and batch["motion_length"].dtype == np.int32
    # several processes need the process group, or the replicas named
    with pytest.raises(RuntimeError, match="needs the process group"):
        build_dataloader([], 2, dist=True)
