"""Shared helpers of the tests that hold the PyTorch port against the JAX
package: seeded flax parameter trees made with numpy, and numpy <-> torch."""

import math

import numpy as np
import pytest
import torch


def seeded_params(tree, seed=0):
    """A flax ``params`` tree of the same structure with seeded N(0, 1) /
    sqrt(fan-in) values (numpy): gate temperatures 0 (logit scale 1), MoE
    position embeddings scaled by 8 so routing spreads across experts."""
    rng = np.random.RandomState(seed)

    def walk(node, path):
        out = {}
        for key, val in sorted(node.items()):
            if isinstance(val, dict) or hasattr(val, "items"):
                out[key] = walk(dict(val), path + [key])
                continue
            shape = np.shape(val)
            if key == "kernel":
                fan_in = shape[0]
            elif key in ("expert_w1", "expert_w2", "w1", "w2"):
                fan_in = shape[-2]
            else:
                fan_in = shape[-1]
            v = rng.randn(*shape) / math.sqrt(max(fan_in, 4))
            if key == "temperature":
                v = np.zeros(shape)
            elif key == "embedding" and path[-1:] != ["token_embedding"]:
                v = v * 8.0
            out[key] = v.astype(np.float32)
        return out

    return walk(dict(tree), [])


def t(a, dtype=None):
    """numpy -> CPU torch tensor."""
    x = torch.from_numpy(np.array(a))
    return x.to(dtype) if dtype is not None else x


def assert_close_scaled(got, want, rel, what=""):
    """max |got - want| <= rel * max(1, max |want|)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    diff = float(np.abs(got - want).max())
    assert diff <= rel * scale, f"{what}: max diff {diff} > {rel} * {scale}"


@pytest.fixture(autouse=True)
def grad_mode_on():
    """Some test modules of the JAX package turn torch's grad mode off when
    they are imported (and every xdist worker imports them all); the tests
    that use this fixture take gradients."""
    with torch.enable_grad():
        yield


def check_route_invariants(route, capacity):
    """What every MoE routing (ops/moe_positions.py:Route) must satisfy: each
    kept (token, k) choice owns exactly one row and that row names its token;
    every other row (padding) holds 0; dropped choices have r == M and gate
    0; each expert keeps min(count, capacity) choices; block_expert is
    non-decreasing within [0, E); a token's row of ge holds its K gates and
    zeros."""
    gates, r, tfr, be, ge, counts = (a.cpu().numpy() for a in route)
    (N, K), E, M = r.shape, ge.shape[1], tfr.shape[0]
    assert ((r >= 0) & (r <= M)).all()
    kept = r < M
    assert (gates[~kept] == 0).all()
    rows = r[kept]
    assert np.unique(rows).size == rows.size, "two choices share a row"
    assert (tfr[rows] == np.broadcast_to(np.arange(N)[:, None], (N, K))[kept]).all()
    pad = np.ones(M, bool)
    pad[rows] = False
    assert (tfr[pad] == 0).all(), "a padding row is not 0"
    assert kept.sum() == np.minimum(counts, capacity).sum()
    assert counts.sum() == N * K
    assert (np.diff(be) >= 0).all() and be.min() >= 0 and be.max() < E
    assert (np.count_nonzero(ge, axis=1) <= K).all()
    # gates are >= 0, so a row's K largest entries are its gates
    np.testing.assert_array_equal(np.sort(ge, axis=1)[:, E - K:], np.sort(gates, axis=1))


def route_logits(N, E, kind, seed=0):
    """Gate logits [N, E] (numpy f32) of one kind: "balanced" N(0, 1);
    "skewed", every token leaning to expert 0, so that it overflows its
    capacity; "ties", small integers, so that equal logits are common (the
    lower index must win)."""
    rng = np.random.RandomState(seed)
    if kind == "ties":
        return rng.randint(-2, 3, (N, E)).astype(np.float32)
    lg = rng.randn(N, E).astype(np.float32)
    if kind == "skewed":
        lg[:, 0] += 3.0
    return lg


def tutel_capacity(N, E, K, factor=1.5):
    """MoELayer.capacity: Tutel's K * int(factor * ceil(N / E)), within [1, N]."""
    return max(1, min(K * int(factor * ((N + E - 1) // E)), N))
