"""Data transform pipelines (numpy, host-side; a copy of
motioncraft_tpu/data/pipelines.py).

Compose, Crop (random crop to fixed size + zero-pad + motion_mask, optional
stride alignment), ContrlCrop (motion+condition synchronized), RandomCrop,
Normalize ((x - mean) / (std + eps)), and the formatting steps.  Everything is
numpy: batching happens in loader.py, the copy to the card in the test and
train loops.  Randomness comes from
an explicit ``np.random.Generator`` carried in ``results['_rng']`` (falls back
to the global numpy RNG like the reference's ``random`` module usage).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from ..registry import PIPELINES


def _rand(results):
    return results.get("_rng", np.random)


@PIPELINES.register_module()
class Compose:
    def __init__(self, transforms: Sequence):
        self.transforms = []
        for t in transforms:
            if isinstance(t, dict):
                self.transforms.append(PIPELINES.build(t))
            elif callable(t):
                self.transforms.append(t)
            else:
                raise TypeError(f"transform must be callable or dict, got {type(t)}")

    def __call__(self, results):
        for t in self.transforms:
            results = t(results)
            if results is None:
                return None
        return results

    def __repr__(self):
        return f"Compose({self.transforms})"


@PIPELINES.register_module()
class Crop:
    """Random crop to ``crop_size`` with zero padding + motion_mask; ``stride``
    aligns the crop start (used by music data, stride=30)."""

    def __init__(self, crop_size: int, stride: Optional[int] = None):
        self.crop_size = crop_size
        self.stride = stride

    def _crop_start(self, results, length):
        idx = int(_rand(results).randint(0, length - self.crop_size + 1))
        if idx > 0 and self.stride is not None:
            idx -= idx % self.stride
        return idx

    def __call__(self, results):
        motion = results["motion"]
        length = len(motion)
        cs = self.crop_size
        if length >= cs:
            idx = self._crop_start(results, length)
            motion = motion[idx:idx + cs]
            results["motion_length"] = cs
            results["motion_mask"] = np.ones(cs, np.float32)
        else:
            pad = np.zeros((cs - length,) + motion.shape[1:], np.float32)
            motion = np.concatenate([motion, pad], axis=0)
            results["motion_length"] = length
            results["motion_mask"] = np.concatenate(
                [np.ones(length, np.float32), np.zeros(cs - length, np.float32)])
        results["motion"] = motion.astype(np.float32)
        results["motion_shape"] = motion.shape
        return results


@PIPELINES.register_module()
class ContrlCrop(Crop):
    """Crop that keeps motion and the condition stream ``c`` in sync."""

    def __call__(self, results):
        motion, c = results["motion"], results["c"]
        length = len(motion)
        cs = self.crop_size
        if length >= cs:
            idx = self._crop_start(results, length)
            results["motion"] = motion[idx:idx + cs].astype(np.float32)
            results["c"] = c[idx:idx + cs].astype(np.float32)
            results["motion_length"] = cs
            results["motion_mask"] = np.ones(cs, np.float32)
        else:
            pad_m = np.zeros((cs - length,) + motion.shape[1:], np.float32)
            pad_c = np.zeros((cs - length,) + c.shape[1:], np.float32)
            results["motion"] = np.concatenate([motion, pad_m], 0).astype(np.float32)
            results["c"] = np.concatenate([c, pad_c], 0).astype(np.float32)
            results["motion_length"] = length
            results["motion_mask"] = np.concatenate(
                [np.ones(length, np.float32), np.zeros(cs - length, np.float32)])
        results["motion_shape"] = results["motion"].shape
        return results


@PIPELINES.register_module()
class RandomCrop:
    """Crop to a random size in [min_size, max_size], pad to max_size."""

    def __init__(self, min_size: int, max_size: int):
        self.min_size = min_size
        self.max_size = max_size

    def __call__(self, results):
        motion = results["motion"]
        length = len(motion)
        rng = _rand(results)
        crop_size = int(rng.randint(self.min_size, self.max_size + 1))
        if length > crop_size:
            idx = int(rng.randint(0, length - crop_size + 1))
            motion = motion[idx:idx + crop_size]
            results["motion_length"] = crop_size
        else:
            results["motion_length"] = length
        valid = min(length, crop_size)
        pad = self.max_size - valid
        if pad > 0:
            motion = np.concatenate(
                [motion[:valid], np.zeros((pad,) + motion.shape[1:], np.float32)], 0)
        results["motion"] = motion.astype(np.float32)
        results["motion_shape"] = motion.shape
        results["motion_mask"] = np.concatenate(
            [np.ones(valid, np.float32), np.zeros(self.max_size - valid, np.float32)])
        return results


@PIPELINES.register_module()
class Normalize:
    def __init__(self, mean_path: Optional[str] = None, std_path: Optional[str] = None,
                 eps: float = 1e-9, keys=("motion",),
                 mean: Optional[np.ndarray] = None, std: Optional[np.ndarray] = None):
        self.mean = np.load(mean_path) if mean_path else np.asarray(mean)
        self.std = np.load(std_path) if std_path else np.asarray(std)
        self.eps = eps
        self.keys = list(keys)

    def __call__(self, results):
        for k in self.keys:
            results[k] = (results[k] - self.mean) / (self.std + self.eps)
        return results


@PIPELINES.register_module()
class ToTensor:
    """Formatting step: ensure float32 numpy arrays (batches stay numpy on
    the host; the test and train loops copy them to the device)."""

    def __init__(self, keys: List[str]):
        self.keys = keys

    def __call__(self, results):
        for k in self.keys:
            v = results[k]
            results[k] = np.asarray(v, np.float32) if not np.isscalar(v) else np.float32(v)
        return results


@PIPELINES.register_module()
class Transpose:
    def __init__(self, keys: List[str], order: Sequence[int]):
        self.keys = keys
        self.order = tuple(order)

    def __call__(self, results):
        for k in self.keys:
            results[k] = np.transpose(results[k], self.order)
        return results


@PIPELINES.register_module()
class Collect:
    """Keep ``keys`` plus a ``motion_metas`` dict built from ``meta_keys``."""

    def __init__(self, keys: List[str], meta_keys: Sequence[str] = ()):
        self.keys = keys
        self.meta_keys = list(meta_keys)

    def __call__(self, results):
        out = {k: results[k] for k in self.keys}
        out["motion_metas"] = {k: results[k] for k in self.meta_keys if k in results}
        for passthrough in ("c", "clip_feat", "dataset_name", "sample_idx"):
            if passthrough in results and passthrough not in out:
                out[passthrough] = results[passthrough]
        return out
