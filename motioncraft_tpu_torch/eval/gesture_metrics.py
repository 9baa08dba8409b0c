"""Speech-to-gesture metrics (a copy of motioncraft_tpu/eval/gesture_metrics.py;
host-side numpy and scipy).

  - L1div: mean L1 deviation from the temporal mean pose
  - SRGR: semantic-relevant gesture recall
  - BeatAlign: audio onsets against motion beats (local minima of joint
    speed) over the upper-body joints, scored by a Gaussian kernel (GAHR)
  - facial L2 (MSE) and LVD (L1 of velocity differences) of the face

Audio onsets come from the native extractor (data/beat2.py:onset_amplitude),
the branch the JAX package takes without librosa.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import numpy as np
from scipy.signal import argrelextrema

from ..data.beat2 import onset_amplitude


class L1div:
    """Streaming mean L1 deviation from the mean pose."""

    def __init__(self):
        self.counter = 0
        self.sum = 0.0

    def run(self, results: np.ndarray):
        results = np.asarray(results, np.float64)
        self.counter += results.shape[0]
        mean = results.mean(axis=0, keepdims=True)
        self.sum += np.abs(results - mean).sum()

    def avg(self):
        return self.sum / max(self.counter, 1)

    def reset(self):
        self.counter, self.sum = 0, 0.0


class SRGR:
    """Semantic-relevant gesture recall (EMAGE_2024/utils/metric.py:29-50):
    the share of joints within ``threshold`` (L1 over xyz) of the target,
    weighted by each frame's semantic score / 0.165."""

    def __init__(self, threshold: float = 0.1, joints: int = 47):
        self.threshold = threshold
        self.joints = joints
        self.counter = 0
        self.sum = 0.0

    def run(self, results, targets, semantic):
        results = np.asarray(results).reshape(-1, self.joints, 3)
        targets = np.asarray(targets).reshape(-1, self.joints, 3)
        semantic = np.asarray(semantic).reshape(-1)
        diff = np.abs(results - targets).sum(axis=2)
        success = np.where(diff < self.threshold, 1.0, 0.0)
        success *= semantic[:, None] * (1 / 0.165)
        rate = success.sum() / (success.shape[0] * success.shape[1])
        self.counter += success.shape[0]
        self.sum += rate * success.shape[0]
        return rate

    def avg(self):
        return self.sum / max(self.counter, 1)


def audio_onsets_seconds(wav: np.ndarray, sr: int = 16000) -> np.ndarray:
    """Onset times in seconds."""
    feat = onset_amplitude(wav, sr)
    return np.nonzero(feat[:, 1])[0] / sr


def motion_beats(joints: np.ndarray, pose_fps: int = 30, order: int = 7,
                 threshold: float = 0.3, mmae=1.0,
                 joint_subset: Optional[Sequence[int]] = None,
                 t_start: int = 0, t_end: Optional[int] = None) -> List[np.ndarray]:
    """Per-joint local minima of speed ('motion beats').

    joints: [T, J, 3] global positions.  Velocity by central differences,
    divided by mmae (a scalar or the dataset's per-joint [J] mean maximum
    velocity); beats are the local minima of speed within [t_start, t_end)
    whose window-relative index lies in the set of full-sequence indices
    above the threshold: the reference compares a relative index with
    absolute ones, and so does this."""
    T = joints.shape[0]
    t_end = T if t_end is None else t_end
    dt = 1.0 / pose_fps
    pos = joints.reshape(T, -1, 3)
    vel = np.empty_like(pos)
    vel[0] = (pos[1] - pos[0]) / dt
    vel[-1] = (pos[-1] - pos[-2]) / dt
    vel[1:-1] = (pos[2:] - pos[:-2]) / (2 * dt)
    speed = np.linalg.norm(vel, axis=2) / np.asarray(mmae)  # [T, J]
    beats = []
    idxs = range(speed.shape[1]) if joint_subset is None else joint_subset
    for j in idxs:
        mins = argrelextrema(speed[t_start:t_end, j], np.less, order=order)[0]
        mask = set(np.nonzero(speed[:, j] > threshold)[0].tolist())
        beats.append(np.asarray([m for m in mins if m in mask]))
    return beats


def gahr(a: Sequence[float], b: Sequence[float], sigma: float) -> float:
    """Gaussian-kernel alignment hit rate of b against a."""
    if len(b) == 0:
        return 0.0
    total = 0.0
    a = np.asarray(a, np.float64)
    for b_each in b:
        l2_min = np.min(np.abs(a - b_each)) if len(a) else np.inf
        total += math.exp(-(l2_min ** 2) / (2 * sigma ** 2))
    return total / len(b)


# the upper-body joints BeatAlign scores
UPPER_BODY = [3, 6, 9, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21]


class BeatAlign:
    """Audio-onset / motion-beat alignment.  With ``align_mask`` > 0 (the
    protocol's 60 frames) both streams are cut: the audio onsets over
    ``wav[mask spf : full_len - mask spf]``, the motion beats over frames
    [mask, T - mask).  ``mmae`` is a scalar or a per-joint [J] array
    (``mean_vel_<pose_rep>.npy``)."""

    def __init__(self, sigma: float = 0.3, order: int = 7, mmae=1.0,
                 upper_body: Sequence[int] = tuple(UPPER_BODY),
                 threshold: float = 0.3, align_mask: int = 0):
        self.sigma = sigma
        self.order = order
        self.mmae = mmae
        self.upper_body = list(upper_body)
        self.threshold = threshold
        self.align_mask = align_mask

    def score(self, wav: np.ndarray, joints: np.ndarray, sr: int = 16000,
              pose_fps: int = 30, full_wav_len: Optional[int] = None) -> float:
        """wav: the audio cut to T frames (T sr / fps samples); joints
        [T, J, 3]; ``full_wav_len``: the whole recording's samples, from
        which the audio window's end is taken."""
        T = joints.shape[0]
        a_off = int(self.align_mask * (sr / pose_fps))
        a_end = (full_wav_len if full_wav_len is not None else len(wav)) - a_off
        onset_t = audio_onsets_seconds(wav[a_off:a_end], sr)
        beats = motion_beats(joints, pose_fps, self.order, self.threshold, self.mmae,
                             joint_subset=None, t_start=self.align_mask,
                             t_end=T - self.align_mask)
        scores = [gahr(beat / pose_fps, onset_t, self.sigma)
                  for j, beat in enumerate(beats) if j in self.upper_body]
        return float(np.mean(scores)) if scores else 0.0


def facial_mse(pred_face: np.ndarray, gt_face: np.ndarray) -> float:
    """Facial L2: the mean squared elementwise difference (torch MSELoss)."""
    d = np.asarray(pred_face, np.float64) - np.asarray(gt_face, np.float64)
    return float(np.mean(d * d))


def facial_lvd(pred_face: np.ndarray, gt_face: np.ndarray) -> float:
    """Facial LVD: L1 between the prediction's and the target's frame
    velocities, with the reference's pairing vel_rec = rec[1:] - tar[:-1]."""
    pred = np.asarray(pred_face, np.float64)
    gt = np.asarray(gt_face, np.float64)
    return float(np.mean(np.abs((pred[1:] - gt[:-1]) - (gt[1:] - gt[:-1]))))


def facial_l2(pred_face: np.ndarray, gt_face: np.ndarray) -> float:
    """Mean L2 distance of the face region (a diagnostic, not the
    protocol's metric, which is ``facial_mse``)."""
    return float(np.linalg.norm(pred_face - gt_face, axis=-1).mean())
