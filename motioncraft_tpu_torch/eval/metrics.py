"""Metric math (numpy/scipy) — R-Precision, Matching, FID, Diversity,
MultiModality, and the 20-replication mean ± 1.96σ/√n statistics.

A copy of motioncraft_tpu/eval/metrics.py: the port imports nothing of the
JAX package.  The matrices are small and ``scipy.linalg.sqrtm`` has no
device counterpart, so this stays on the host; the evaluator model's
embedding, the expensive part, runs on the card (eval/models.py).
"""

from __future__ import annotations

import sys

import numpy as np
from scipy import linalg


def get_metric_statistics(values, replication_times):
    mean = np.mean(values, axis=0)
    std = np.std(values, axis=0)
    conf_interval = 1.96 * std / np.sqrt(replication_times)
    return mean, conf_interval


def euclidean_distance_matrix(matrix1, matrix2):
    d1 = -2 * np.dot(matrix1, matrix2.T)
    d2 = np.sum(np.square(matrix1), axis=1, keepdims=True)
    d3 = np.sum(np.square(matrix2), axis=1)
    return np.sqrt(np.maximum(d1 + d2 + d3, 0.0))


def calculate_top_k(argsort_mat, top_k):
    """argsort_mat [N, N]: per-row ranked indices; hit when diag index appears
    in the first k columns (cumulative-or over columns).  When N < top_k (a
    `--limit` smoke run's last slice), columns beyond N stay at the saturated
    value: after all N candidates each row has found its own index, so
    top-k accuracy is exactly 1 from column N on."""
    size = argsort_mat.shape[0]
    gt = np.arange(size)[:, None]
    bool_mat = argsort_mat == gt
    correct = np.zeros(size, dtype=bool)
    cols = []
    for i in range(top_k):
        if i < size:
            correct = correct | bool_mat[:, i]
        cols.append(correct[:, None].copy())
    return np.concatenate(cols, axis=1)


def calculate_activation_statistics(activations, emb_scale=1.0):
    activations = activations * emb_scale
    mu = np.mean(activations, axis=0)
    cov = np.cov(activations, rowvar=False)
    return mu, cov


def calculate_frechet_distance(mu1, sigma1, mu2, sigma2, eps=1e-6):
    """Frechet distance between two gaussians (Dougal Sutherland's stable
    formulation, as used by the reference)."""
    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    diff = mu1 - mu2
    covmean = np.asarray(linalg.sqrtm(sigma1.dot(sigma2)))
    bad_imag = (np.iscomplexobj(covmean)
                and not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3))
    if not np.isfinite(covmean).all() or bad_imag:
        # rank-deficient covariances (e.g. a --limit smoke run with fewer
        # samples than embedding dims) make sqrtm non-finite or heavily
        # complex; the standard eps-offset regularization recovers a finite
        # value.  Well-conditioned protocol runs never take this branch —
        # warn loudly (as the reference does) so a regularized FID is never
        # mistaken for an exact one.
        print(f"FID: sqrtm produced singular/complex product; adding "
              f"{eps} to the covariance diagonals", file=sys.stderr)
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = np.asarray(linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset)))
    if np.iscomplexobj(covmean):
        if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
            raise ValueError(f"Imaginary component {np.max(np.abs(covmean.imag))}")
        covmean = covmean.real
    return diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2) - 2 * np.trace(covmean)


def calculate_diversity(activation, diversity_times, emb_scale=1.0, norm_scale=1.0,
                        rng=None):
    assert activation.ndim == 2 and activation.shape[0] > diversity_times
    rng = rng or np.random
    activation = activation * emb_scale
    n = activation.shape[0]
    first = rng.choice(n, diversity_times, replace=False)
    second = rng.choice(n, diversity_times, replace=False)
    dist = linalg.norm((activation[first] - activation[second]) * norm_scale, axis=1)
    return dist.mean()


def calculate_multimodality(activation, multimodality_times, rng=None):
    assert activation.ndim == 3 and activation.shape[1] > multimodality_times
    rng = rng or np.random
    per = activation.shape[1]
    first = rng.choice(per, multimodality_times, replace=False)
    second = rng.choice(per, multimodality_times, replace=False)
    dist = linalg.norm(activation[:, first] - activation[:, second], axis=2)
    return dist.mean()
