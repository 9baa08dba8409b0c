"""The port's T2M evaluation against the JAX package's: the metric math on
the same arrays (1e-6 relative), the SMPL-X contrastive evaluator at tiny
widths on the same weights (1e-5 x max(1, max |JAX|); tokenizer ids
identical), and every evaluator's metric dict on the same results, the
same evaluator model and the same numpy seed."""

import jax
import numpy as np
import pytest
import torch

from motioncraft_tpu.eval import evaluators as jax_evaluators
from motioncraft_tpu.eval import metrics as jax_metrics
from motioncraft_tpu.eval.models import T2MContrastiveModel_SMPLX as JaxEvaluator
from motioncraft_tpu.eval.models import _WordPieceTokenizer as JaxTokenizer
from motioncraft_tpu.utils.checkpoint import save_params as jax_save_params
from motioncraft_tpu_torch.eval import evaluators, metrics
from motioncraft_tpu_torch.eval.models import T2MContrastiveModel_SMPLX, _WordPieceTokenizer
from torch_port_util import assert_close_scaled, seeded_params

REL = 1e-6
EVAL_REL = 1e-5
TINY = dict(
    motion_encoder=dict(nfeats=322, vae=True, num_layers=2, latent_dim=16, ff_size=24,
                        num_heads=2),
    text_encoder=dict(num_layers=2, latent_dim=16, ff_size=24, num_heads=2,
                      bert_cfg=dict(dim=16, n_layers=2, n_heads=2, hidden_dim=32)))


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=REL, atol=0)


def _cases():
    rng = np.random.RandomState(0)
    a, b = rng.randn(40, 8), rng.randn(40, 8) + 0.3
    dist = jax_metrics.euclidean_distance_matrix(a, b)
    return {
        "get_metric_statistics": lambda m: m.get_metric_statistics(a, 20),
        "euclidean_distance_matrix": lambda m: m.euclidean_distance_matrix(a, b),
        "calculate_top_k": lambda m: m.calculate_top_k(np.argsort(dist, axis=1), 3),
        "calculate_top_k_short": lambda m: m.calculate_top_k(np.argsort(dist[:2, :2]), 3),
        "calculate_activation_statistics": lambda m: m.calculate_activation_statistics(
            a, 2.0),
        "calculate_frechet_distance": lambda m: m.calculate_frechet_distance(
            *m.calculate_activation_statistics(a), *m.calculate_activation_statistics(b)),
        "calculate_frechet_distance_singular": lambda m: m.calculate_frechet_distance(
            *m.calculate_activation_statistics(a[:4]),
            *m.calculate_activation_statistics(b[:4])),
        "calculate_diversity": lambda m: m.calculate_diversity(
            a, 30, 1.5, 0.5, rng=np.random.RandomState(1)),
        "calculate_multimodality": lambda m: m.calculate_multimodality(
            a.reshape(4, 10, 8), 5, rng=np.random.RandomState(2)),
    }


@pytest.mark.parametrize("name", list(_cases()))
def test_metric_math_matches_jax(name):
    fn = _cases()[name]
    got, want = fn(metrics), fn(jax_metrics)
    if isinstance(want, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w)
    else:
        _close(got, want)


def test_diversity_draws_from_the_global_generator():
    emb = np.random.RandomState(3).randn(50, 6)
    np.random.seed(7)
    want = jax_metrics.calculate_diversity(emb, 20)
    np.random.seed(7)
    _close(metrics.calculate_diversity(emb, 20), want)


@pytest.mark.parametrize("vocab", [False, True])
def test_wordpiece_tokenizer_ids_are_identical(vocab, tmp_path):
    path = None
    if vocab:
        path = str(tmp_path / "vocab.txt")
        with open(path, "w") as f:
            f.write("\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "a", "person", "walk",
                               "##s", "jump", "##ing", "up", "'", "-"]) + "\n")
    texts = ["A person walks", "jumping up-and-down!", "", "someone's unknownword " * 20]
    got, want = _WordPieceTokenizer(path)(texts), JaxTokenizer(path)(texts)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.fixture(scope="module")
def evaluator_pair(tmp_path_factory):
    """The JAX evaluator and the port's on one seeded flax tree, carried
    through the native .npz snapshot both load."""
    shapes = JaxEvaluator(**TINY)
    motion = seeded_params(jax.tree_util.tree_map(np.asarray, shapes.motion_params["params"]), 1)
    text = seeded_params(jax.tree_util.tree_map(np.asarray, shapes.text_params["params"]), 2)
    path = str(tmp_path_factory.mktemp("evaluator") / "evaluator.npz")
    jax_save_params(path, {"motion": {"params": motion}, "text": {"params": text}})
    init_cfg = dict(type="Pretrained", checkpoint=path)
    return (JaxEvaluator(**TINY, init_cfg=init_cfg),
            T2MContrastiveModel_SMPLX(**TINY, init_cfg=init_cfg, device="cpu"))


def test_evaluator_encodes_like_jax(evaluator_pair):
    jax_ev, ev = evaluator_pair
    assert jax_ev.pretrained_loaded and ev.pretrained_loaded
    rng = np.random.RandomState(4)
    motion = rng.randn(5, 12, 322).astype(np.float32)
    lengths = np.array([12, 9, 5, 1, 12])
    texts = ["a person walks", "someone jumps up and down twice", "waves", "", "turns"]
    got_m = ev.encode_motion(motion, motion_length=lengths)
    assert got_m.device.type == "cpu" and got_m.shape == (5, 16)
    assert_close_scaled(got_m.numpy(), jax_ev.encode_motion(motion, motion_length=lengths),
                        EVAL_REL, "encode_motion")
    assert_close_scaled(ev.encode_motion(motion).numpy(), jax_ev.encode_motion(motion),
                        EVAL_REL, "encode_motion, full length")
    assert_close_scaled(ev.encode_text(texts).numpy(), jax_ev.encode_text(texts),
                        EVAL_REL, "encode_text")


def test_evaluator_without_weights_is_seeded_and_flagged():
    a = T2MContrastiveModel_SMPLX(**TINY, device="cpu", seed=3)
    b = T2MContrastiveModel_SMPLX(**TINY, device="cpu", seed=3,
                                  init_cfg=dict(type="Pretrained", checkpoint="missing.ckpt"))
    assert not a.pretrained_loaded and not b.pretrained_loaded
    for x, y in ((a.motion_module, b.motion_module), (a.text_module, b.text_module)):
        sa, sb = x.state_dict(), y.state_dict()
        assert all(torch.equal(sa[k], sb[k]) for k in sa)


class StubEvaluatorModel:
    """A fixed numpy embedding of motions and texts, shared by both
    packages' evaluators so that only the evaluator logic is compared."""

    def __init__(self):
        rng = np.random.RandomState(5)
        self.w = rng.randn(322, 6)

    def encode_motion(self, motion, motion_length=None, motion_mask=None, **kw):
        m = np.asarray(motion, np.float64)
        mask = np.asarray(motion_mask, np.float64)[..., None]
        return (m * mask).sum(1) / np.maximum(mask.sum(1), 1) @ self.w

    def encode_text(self, text, token=None, **kw):
        return np.stack([np.random.RandomState(sum(map(ord, s)) % 1000).randn(6) + len(s)
                         for s in text])


def _results(n=60, T=10, seed=6):
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        length = int(rng.randint(3, T + 1))
        mask = (np.arange(T) < length).astype(np.float32)
        out.append({"motion": rng.randn(T, 322).astype(np.float32),
                    "pred_motion": rng.randn(T, 322).astype(np.float32),
                    "motion_length": np.array([length]), "motion_mask": mask,
                    "pred_motion_length": np.array([length]), "pred_motion_mask": mask,
                    "text": f"text number {i % 17}"})
    return out


METRICS = {
    "R Precision": dict(type="R Precision", batch_size=8, top_k=3),
    "Matching Score": dict(type="Matching Score", batch_size=8),
    "FID": dict(type="FID", emb_scale=1.0),
    "Diversity": dict(type="Diversity", num_samples=10),
    "MultiModality": dict(type="MultiModality", num_samples=4, num_repeats=3, num_picks=2),
}


@pytest.mark.parametrize("metric", list(METRICS))
def test_evaluator_metric_dicts_match_jax(metric):
    model = StubEvaluatorModel()
    eval_cfg = dict(replication_times=2, replication_reduction="statistics",
                    evaluator_model=model, metrics=[METRICS[metric]])
    data_len = 24
    outs = []
    for mod in (jax_evaluators, evaluators):
        np.random.seed(11)
        idx = [np.arange(data_len) for _ in range(2)]
        ev, idx = mod.build_evaluator(METRICS[metric], eval_cfg, data_len, idx)
        results = _results(n=sum(len(i) for i in idx))
        outs.append((ev.evaluate(results), idx))
    (want, want_idx), (got, got_idx) = outs
    assert sorted(got) == sorted(want)
    for k in want:
        _close(got[k], want[k])
    for g, w in zip(got_idx, want_idx):
        np.testing.assert_array_equal(g, w)


def test_evaluators_read_embeddings_from_the_device(evaluator_pair):
    """The port's evaluator model returns tensors on its device; the
    evaluators bring them to the host."""
    _, ev = evaluator_pair
    fid = evaluators.FIDEvaluator(data_len=12, evaluator_model=ev)
    res = _results(n=12, T=8)
    assert np.isfinite(fid.evaluate(res)["FID (mean)"])
    assert isinstance(evaluators.build_evaluator_model(None), type(None))
    assert evaluators.build_evaluator_model(ev) is ev
