"""Shared helpers of the tests that hold the PyTorch port against the JAX
package: seeded flax parameter trees made with numpy, and numpy <-> torch."""

import math

import numpy as np
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
