"""The music-to-dance evaluation path of the port against the JAX package:
the FineDance dataset (its splits, the 319 -> 322 remap, the head trim, the
caption) on the committed real-format fixture and on a tools/make_tiny_data.py
tree, and tools/torch_m2d_test.py's metric stage (150-frame chunks, the
hands mask, FID whole-body and hands, Diversity) on the same predictions and
evaluator weights as tools/m2d_test.py's.

Tolerances: data exact; evaluator embeddings 1e-5 x max(1, max |JAX|); the
metric math on the same embeddings 1e-6 relative; the whole stage, whose
FIDs carry the embeddings' difference through a matrix square root, 1e-4
relative.
"""

import importlib.util
import os

import jax
import numpy as np
import pytest

import motioncraft_tpu.data  # noqa: F401  (registers the JAX datasets)
from motioncraft_tpu.data.datasets import finedance_split as jax_split
from motioncraft_tpu.eval import metrics as jax_metrics
from motioncraft_tpu.eval.models import T2MContrastiveModel_SMPLX as JaxEvaluator
from motioncraft_tpu.registry import DATASETS as JAX_DATASETS
from motioncraft_tpu.utils.checkpoint import save_params as jax_save_params
from motioncraft_tpu_torch.config import Config
from motioncraft_tpu_torch.data import finedance_split
from motioncraft_tpu_torch.eval import metrics
from motioncraft_tpu_torch.eval.models import T2MContrastiveModel_SMPLX
from motioncraft_tpu_torch.registry import build_dataset
from torch_port_util import assert_close_scaled, seeded_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EVALUATOR = dict(motion_encoder=dict(nfeats=322, vae=True, num_layers=1, latent_dim=32,
                                     ff_size=32, num_heads=2),
                 text_encoder=dict(num_layers=1, latent_dim=32, ff_size=32, num_heads=2,
                                   bert_cfg=dict(dim=32, n_layers=1, n_heads=2,
                                                 hidden_dim=64)))


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


torch_m2d_test = _load("torch_m2d_test", os.path.join(REPO, "tools", "torch_m2d_test.py"))


@pytest.mark.parametrize("split", ["cross_genre", "cross_dancer"])
def test_finedance_split(split):
    assert finedance_split(split) == jax_split(split)
    with pytest.raises(ValueError):
        finedance_split("by_song")


def _same_infos(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            if isinstance(w[k], np.ndarray):
                assert g[k].dtype == w[k].dtype
                np.testing.assert_array_equal(g[k], w[k])
            else:
                assert g[k] == w[k], k


@pytest.mark.parametrize("root", ["fixture", "tiny"])
def test_finedance_dataset_matches_jax(root, tmp_path):
    cfg = dict(Config.fromfile(os.path.join(REPO, "configs", "tests", "fixture_m2d.py"))
               .data["test"])
    if root == "tiny":
        make = _load("make_tiny_data", os.path.join(REPO, "tools", "make_tiny_data.py"))
        make.make_finedance(str(tmp_path), np.random.RandomState(0))
        cfg["data_prefix"] = str(tmp_path)
        cfg["pipeline"] = [dict(type="Normalize", mean_path=str(
            tmp_path / "datasets" / "finedance" / "mean.npy"), std_path=str(
            tmp_path / "datasets" / "finedance" / "std.npy"))]
    else:
        cfg["data_prefix"] = os.path.join(REPO, "tests", "fixtures", "mini")
        cfg["pipeline"] = [dict(p, **{k: os.path.join(REPO, p[k]) for k in p
                                      if k.endswith("_path")}) for p in cfg["pipeline"]]
    got, want = build_dataset(dict(cfg)), JAX_DATASETS.build(dict(cfg))
    _same_infos(got.data_infos, want.data_infos)
    assert [i["name"] for i in got.data_infos] == (["063"] if root == "fixture"
                                                   else ["063", "132"])
    info = got.data_infos[0]
    assert info["motion"].shape[1] == 322 and info["c"].shape[1] == 163
    assert len(info["motion"]) == len(info["c"]) == (64 if root == "fixture" else 40)
    assert "Jazz dance" in info["text"][0]
    np.testing.assert_array_equal(got.pipeline.transforms[0].mean,
                                  want.pipeline.transforms[0].mean)
    train = build_dataset(dict(cfg, ann_file="train.txt"))
    assert train.data_infos == [] and JAX_DATASETS.build(dict(cfg, ann_file="train.txt")
                                                         ).data_infos == []


@pytest.fixture(scope="module")
def evaluators(tmp_path_factory):
    """The JAX and the port's SMPL-X evaluator on one seeded .npz."""
    path = str(tmp_path_factory.mktemp("ev") / "evaluator.npz")
    shapes = JaxEvaluator(**EVALUATOR)
    motion = seeded_params(jax.tree_util.tree_map(np.asarray, shapes.motion_params["params"]), 1)
    text = seeded_params(jax.tree_util.tree_map(np.asarray, shapes.text_params["params"]), 2)
    jax_save_params(path, {"motion": {"params": motion}, "text": {"params": text}})
    init = dict(type="Pretrained", checkpoint=path)
    return (JaxEvaluator(**EVALUATOR, init_cfg=init),
            T2MContrastiveModel_SMPLX(**EVALUATOR, init_cfg=init, device="cpu"))


def _jax_metric_stage(ev, preds, gts):
    """tools/m2d_test.py's metric stage, as written there, on JAX."""
    hands_only = torch_m2d_test.hands_only
    chunk_size = min(150, min(len(p) for p in preds))

    def chunk_embed(seqs, mask_fn=None):
        chunks = []
        for s in seqs:
            s = mask_fn(s) if mask_fn is not None else s
            for i in range(0, len(s) - chunk_size + 1, chunk_size):
                chunks.append(s[i:i + chunk_size])
        arr = np.stack(chunks)
        return np.asarray(ev.encode_motion(arr, np.full(len(arr), chunk_size)))

    out, embs = {}, {}
    for name, mask_fn in (("whole", None), ("hands", hands_only)):
        pe, ge = chunk_embed(preds, mask_fn), chunk_embed(gts, mask_fn)
        embs[name] = (pe, ge)
        mu_p, cov_p = jax_metrics.calculate_activation_statistics(pe)
        mu_g, cov_g = jax_metrics.calculate_activation_statistics(ge)
        out[f"FID_{name}"] = float(jax_metrics.calculate_frechet_distance(mu_g, cov_g,
                                                                          mu_p, cov_p))
    n_div = min(len(pe) - 1, 300)
    if n_div > 1:
        out["Diversity"] = float(jax_metrics.calculate_diversity(pe, n_div))
    return out, embs


def test_metric_stage_matches_jax(evaluators):
    ev_j, ev_t = evaluators
    rng = np.random.RandomState(0)
    # three tracks: 7 chunks of 150 frames, the tails dropped
    preds = [rng.randn(n, 322).astype(np.float32) * 0.5 for n in (320, 310, 450)]
    gts = [p + rng.randn(*p.shape).astype(np.float32) * 0.3 for p in preds]
    np.random.seed(0)
    want, embs = _jax_metric_stage(ev_j, preds, gts)
    np.random.seed(0)
    got = torch_m2d_test.metric_stage(ev_t, preds, gts)
    assert sorted(got) == sorted(want) == ["Diversity", "FID_hands", "FID_whole"]
    for name, (pe, ge) in embs.items():
        mask = None if name == "whole" else torch_m2d_test.hands_only
        assert pe.shape == (7, 32)
        assert_close_scaled(torch_m2d_test.chunk_embed(ev_t, preds, 150, mask), pe, 1e-5, name)
        assert_close_scaled(torch_m2d_test.chunk_embed(ev_t, gts, 150, mask), ge, 1e-5, name)
        # the port's metric math on JAX's embeddings
        stats = [metrics.calculate_activation_statistics(e) for e in (ge, pe)]
        fid = metrics.calculate_frechet_distance(*stats[0], *stats[1])
        np.testing.assert_allclose(fid, want[f"FID_{name}"], rtol=1e-6)
    np.random.seed(0)
    np.testing.assert_allclose(metrics.calculate_diversity(embs["hands"][0], 6),
                               want["Diversity"], rtol=1e-6)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)


def test_hands_mask_keeps_orientation_hands_and_translation():
    s = np.arange(2 * 322, dtype=np.float32).reshape(2, 322) + 1
    m = torch_m2d_test.hands_only(s)
    kept = np.zeros(322, bool)
    kept[0:3] = kept[66:156] = kept[309:312] = True
    np.testing.assert_array_equal(m[:, kept], s[:, kept])
    assert not m[:, ~kept].any()
