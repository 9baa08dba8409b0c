"""Evaluators: replication loop + per-metric computations (a copy of
motioncraft_tpu/eval/evaluators.py).

BaseEvaluator replication slicing and batched evaluator-model encoding;
R-Precision top-k, Matching score (re-standardized embeddings), FID
(per-replication re-standardization), Diversity, MultiModality (extra
appended eval indexes).  Registered under the metric names the reference
configs use ('R Precision', 'FID', ...).  The evaluator model encodes on its
device (the card unless it was built for the CPU); its embeddings come back
to the host for the metric math.
"""

from __future__ import annotations

import copy
from typing import List, Optional

import numpy as np
import torch

from ..registry import EVALUATORS, SUBMODULES
from .metrics import (calculate_activation_statistics, calculate_diversity,
                      calculate_frechet_distance, calculate_multimodality,
                      calculate_top_k, euclidean_distance_matrix,
                      get_metric_statistics)


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _standardize(emb):
    mean = np.mean(emb, axis=0)
    std = np.std(emb, axis=0)
    std[std == 0] = 1e-8
    return (emb - mean) / std


class BaseEvaluator:
    """Replication loop: slice results per replication, optionally batch,
    reduce to mean ± conf (base_evaluator.py:7-165)."""

    append_indexes = None

    def __init__(self, batch_size=None, drop_last=False, replication_times=1,
                 replication_reduction="statistics", eval_begin_idx=None,
                 eval_end_idx=None, evaluator_model=None):
        assert replication_reduction in ("statistics", "mean", "concat")
        self.batch_size = batch_size
        self.drop_last = drop_last
        self.replication_times = replication_times
        self.replication_reduction = replication_reduction
        self.eval_begin_idx = eval_begin_idx
        self.eval_end_idx = eval_end_idx
        self.evaluator_model = evaluator_model

    def evaluate(self, results: List[dict]):
        total_len = len(results)
        partial_len = total_len // self.replication_times
        all_metrics = []
        for rep in range(self.replication_times):
            partial = results[rep * partial_len:(rep + 1) * partial_len]
            if self.batch_size is not None:
                batch_metrics = []
                for start in range(self.eval_begin_idx, self.eval_end_idx, self.batch_size):
                    batch = partial[start:start + self.batch_size]
                    if len(batch) < self.batch_size and self.drop_last:
                        continue
                    batch_metrics.append(self.single_evaluate(batch))
                all_metrics.append(self.concat_batch_metrics(batch_metrics))
            else:
                all_metrics.append(self.single_evaluate(
                    partial[self.eval_begin_idx:self.eval_end_idx]))
        all_metrics = np.stack(all_metrics, axis=0)
        if self.replication_reduction == "statistics":
            values = get_metric_statistics(all_metrics, self.replication_times)
        elif self.replication_reduction == "mean":
            values = np.mean(all_metrics, axis=0)
        else:
            values = all_metrics
        return self.parse_values(values)

    # ------------------------------------------------------------------
    def prepare_results(self, results: List[dict]):
        """Pad per-sample results to the batch max length and stack (numpy)."""
        T = max(r["motion"].shape[0] for r in results)

        def pad(a, target):
            if a.shape[0] < target:
                width = [(0, target - a.shape[0])] + [(0, 0)] * (a.ndim - 1)
                a = np.pad(a, width)
            return a

        out = {
            "motion": np.stack([pad(np.asarray(r["motion"], np.float32), T) for r in results]),
            "pred_motion": np.stack([pad(np.asarray(r["pred_motion"], np.float32), T)
                                     for r in results]),
            "motion_mask": np.stack([pad(np.asarray(r["motion_mask"], np.float32), T)
                                     for r in results]),
            "pred_motion_mask": np.stack([pad(np.asarray(r["pred_motion_mask"], np.float32), T)
                                          for r in results]),
            "motion_length": np.asarray([int(np.asarray(r["motion_length"]).reshape(-1)[0])
                                         for r in results], np.int64),
            "pred_motion_length": np.asarray(
                [int(np.asarray(r["pred_motion_length"]).reshape(-1)[0]) for r in results],
                np.int64),
            "text": [r.get("text") for r in results if "text" in r],
            "token": [r.get("token") for r in results if "token" in r],
        }
        return out

    def encode_motion(self, motion, motion_length, motion_mask, batch_size=32):
        embs = []
        for i in range(0, motion.shape[0], batch_size):
            embs.append(_host(self.evaluator_model.encode_motion(
                motion=motion[i:i + batch_size],
                motion_length=motion_length[i:i + batch_size],
                motion_mask=motion_mask[i:i + batch_size])))
        return np.concatenate(embs, axis=0)

    def encode_text(self, text, token=None, batch_size=32):
        embs = []
        for i in range(0, len(text), batch_size):
            embs.append(_host(self.evaluator_model.encode_text(
                text=text[i:i + batch_size],
                token=None if not token else token[i:i + batch_size])))
        return np.concatenate(embs, axis=0)


@EVALUATORS.register_module(name="R Precision")
class PrecisionEvaluator(BaseEvaluator):
    def __init__(self, data_len=0, evaluator_model=None, top_k=3, batch_size=32,
                 drop_last=False, replication_times=1,
                 replication_reduction="statistics", **kwargs):
        super().__init__(batch_size, drop_last, replication_times,
                         replication_reduction, 0, data_len, evaluator_model)
        self.top_k = top_k

    def single_evaluate(self, results):
        r = self.prepare_results(results)
        word_emb = self.encode_text(r["text"], r["token"])
        motion_emb = self.encode_motion(r["pred_motion"], r["pred_motion_length"],
                                        r["pred_motion_mask"])
        dist = euclidean_distance_matrix(word_emb, motion_emb)
        top_k_mat = calculate_top_k(np.argsort(dist, axis=1), self.top_k)
        return top_k_mat.sum(axis=0), word_emb.shape[0]

    def concat_batch_metrics(self, batch_metrics):
        count = sum(m[0] for m in batch_metrics)
        size = sum(m[1] for m in batch_metrics)
        return count / size

    def parse_values(self, values):
        out = {}
        for k in range(self.top_k):
            out[f"R_precision Top {k + 1} (mean)"] = values[0][k]
            out[f"R_precision Top {k + 1} (conf)"] = values[1][k]
        return out


@EVALUATORS.register_module(name="Matching Score")
class MatchingScoreEvaluator(BaseEvaluator):
    def __init__(self, data_len=0, evaluator_model=None, top_k=3, batch_size=32,
                 drop_last=False, replication_times=1,
                 replication_reduction="statistics", **kwargs):
        super().__init__(batch_size, drop_last, replication_times,
                         replication_reduction, 0, data_len, evaluator_model)

    def single_evaluate(self, results):
        r = self.prepare_results(results)
        word_emb = _standardize(self.encode_text(r["text"], r["token"]))
        motion_emb = _standardize(self.encode_motion(
            r["pred_motion"], r["pred_motion_length"], r["pred_motion_mask"]))
        dist = euclidean_distance_matrix(word_emb, motion_emb)
        return dist.trace(), word_emb.shape[0]

    def concat_batch_metrics(self, batch_metrics):
        total = sum(m[0] for m in batch_metrics)
        size = sum(m[1] for m in batch_metrics)
        return total / size

    def parse_values(self, values):
        return {"Matching Score (mean)": values[0], "Matching Score (conf)": values[1]}


@EVALUATORS.register_module(name="FID")
class FIDEvaluator(BaseEvaluator):
    def __init__(self, data_len=0, evaluator_model=None, batch_size=None,
                 drop_last=False, replication_times=1, emb_scale=1,
                 replication_reduction="statistics", **kwargs):
        super().__init__(batch_size, drop_last, replication_times,
                         replication_reduction, 0, data_len, evaluator_model)
        self.emb_scale = emb_scale

    def single_evaluate(self, results):
        r = self.prepare_results(results)
        pred_emb = _standardize(self.encode_motion(
            r["pred_motion"], r["pred_motion_length"], r["pred_motion_mask"]))
        gt_emb = _standardize(self.encode_motion(
            r["motion"], r["motion_length"], r["motion_mask"]))
        gt_mu, gt_cov = calculate_activation_statistics(gt_emb, self.emb_scale)
        pr_mu, pr_cov = calculate_activation_statistics(pred_emb, self.emb_scale)
        return calculate_frechet_distance(gt_mu, gt_cov, pr_mu, pr_cov)

    def parse_values(self, values):
        return {"FID (mean)": values[0], "FID (conf)": values[1]}


@EVALUATORS.register_module(name="Diversity")
class DiversityEvaluator(BaseEvaluator):
    def __init__(self, data_len=0, evaluator_model=None, num_samples=300,
                 batch_size=None, drop_last=False, replication_times=1,
                 replication_reduction="statistics", emb_scale=1, norm_scale=1,
                 **kwargs):
        super().__init__(batch_size, drop_last, replication_times,
                         replication_reduction, 0, data_len, evaluator_model)
        self.num_samples = num_samples
        self.emb_scale = emb_scale
        self.norm_scale = norm_scale

    def single_evaluate(self, results):
        r = self.prepare_results(results)
        emb = self.encode_motion(r["pred_motion"], r["pred_motion_length"],
                                 r["pred_motion_mask"])
        return calculate_diversity(emb, self.num_samples, self.emb_scale, self.norm_scale)

    def parse_values(self, values):
        return {"Diversity (mean)": values[0], "Diversity (conf)": values[1]}


@EVALUATORS.register_module(name="MultiModality")
class MultiModalityEvaluator(BaseEvaluator):
    """Evaluates diversity across repeated generations of the same prompts;
    appends num_samples x num_repeats extra eval indexes per replication."""

    def __init__(self, data_len=0, evaluator_model=None, num_samples=100,
                 num_repeats=30, num_picks=10, batch_size=None, drop_last=False,
                 replication_times=1, replication_reduction="statistics", **kwargs):
        super().__init__(batch_size, drop_last, replication_times,
                         replication_reduction, data_len,
                         data_len + num_samples * num_repeats, evaluator_model)
        self.num_samples = num_samples
        self.num_repeats = num_repeats
        self.num_picks = num_picks
        self.append_indexes = []
        for _ in range(replication_times):
            selected = np.random.choice(data_len, num_samples)
            self.append_indexes.append(np.repeat(selected, num_repeats))

    def single_evaluate(self, results):
        r = self.prepare_results(results)
        emb = self.encode_motion(r["pred_motion"], r["pred_motion_length"],
                                 r["pred_motion_mask"])
        emb = emb.reshape(self.num_samples, self.num_repeats, -1)
        return calculate_multimodality(emb, self.num_picks)

    def parse_values(self, values):
        return {"MultiModality (mean)": values[0], "MultiModality (conf)": values[1]}


def build_evaluator(metric: dict, eval_cfg: dict, data_len: int, eval_indexes):
    """The metric dict merged over eval_cfg; MultiModality appends repeated
    indexes."""
    cfg = copy.deepcopy({k: v for k, v in eval_cfg.items() if k != "metrics"})
    cfg.update(metric)
    cfg["data_len"] = data_len
    evaluator = EVALUATORS.build(cfg)
    if evaluator.append_indexes is not None:
        for i in range(eval_cfg["replication_times"]):
            eval_indexes[i] = np.concatenate(
                (eval_indexes[i], evaluator.append_indexes[i]), axis=0)
    return evaluator, eval_indexes


def build_evaluator_model(cfg: Optional[dict]):
    if cfg is None:
        return None
    if not isinstance(cfg, dict) or "type" not in cfg:
        return cfg  # already an instance
    return SUBMODULES.build(cfg)
