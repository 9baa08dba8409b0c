"""SMPL-X npz export with the per-task temporal smoothing of the visualizers
(PyTorch port of motioncraft_tpu/utils/export.py).

The visualizers write pyrender-compatible SMPL-X npz files (poses [T, 165]
axis-angle, expressions [T, 100], trans [T, 3], betas) after task-specific
gaussian smoothing:
  - S2G: body and jaw axis-angle with sigma 3.5, hands with sigma 1.0,
    translation with sigma 3.5, then the vertical translation recentred to
    a 1.3 m mean.
  - M2D: body (22 joints) and hands (30 joints) in 6d-rotation space with
    sigma 3.0 (through ``ax_to_6v`` / ``ax_from_6v``), translation with
    sigma 3.0; jaw and expressions zero (FineDance has no face data).

Both read the 322-d layout (body 0:66, hands 66:156, jaw 156:159,
expressions 209:309, trans 309:312).  The smoothing is host work (numpy,
scipy, CPU tensors); ``fk_joints_322`` runs the FK on ``device``.
"""

from __future__ import annotations

import numpy as np
import torch


def temporal_filter(x: np.ndarray, sigma: float) -> np.ndarray:
    """A gaussian along time, each channel on its own."""
    if sigma <= 0:
        return x
    from scipy.ndimage import gaussian_filter1d
    return gaussian_filter1d(x, sigma, axis=0, mode="nearest").astype(x.dtype)


def smooth_axis_angle_6d(aa_flat: np.ndarray, sigma: float) -> np.ndarray:
    """Smooth [T, J*3] axis-angle in the continuous 6d-rotation space, which
    has no axis-angle wrap-around."""
    from ..ops.rotation import ax_from_6v, ax_to_6v

    T = aa_flat.shape[0]
    J = aa_flat.shape[1] // 3
    d6 = ax_to_6v(torch.as_tensor(np.asarray(aa_flat, np.float32).reshape(T, J, 3))).numpy()
    d6 = temporal_filter(d6.reshape(T, -1), sigma).reshape(T, J, 6)
    return ax_from_6v(torch.as_tensor(d6)).numpy().reshape(T, J * 3)


def _savez(path: str, poses, expressions, trans, betas, fps: int) -> None:
    np.savez(path,
             poses=poses.astype(np.float32),
             expressions=expressions.astype(np.float32),
             trans=trans.astype(np.float32),
             betas=np.asarray(betas, np.float32),
             mocap_frame_rate=np.asarray(fps),
             gender="neutral", model="smplx2020")


def s2g_export_npz(motion322: np.ndarray, path: str, betas=None,
                   fps: int = 30, smooth: bool = True) -> None:
    """A speech-gesture clip."""
    T = motion322.shape[0]
    poses = np.zeros((T, 165), np.float32)
    poses[:, :66] = motion322[:, :66]
    poses[:, 66:69] = motion322[:, 156:159]       # jaw
    poses[:, 75:165] = motion322[:, 66:156]       # hands
    trans = motion322[:, 309:312].copy()
    if smooth:
        poses[:, :69] = temporal_filter(poses[:, :69], 3.5)
        poses[:, 75:165] = temporal_filter(poses[:, 75:165], 1.0)
        trans = temporal_filter(trans, 3.5)
    trans[:, 1] -= np.mean(trans[:, 1]) - 1.3
    _savez(path, poses, motion322[:, 209:309], trans,
           betas if betas is not None else np.zeros(300), fps)


def m2d_export_npz(motion322: np.ndarray, path: str, fps: int = 30,
                   smooth: bool = True) -> None:
    """A dance clip: no jaw or face, 6d smoothing."""
    T = motion322.shape[0]
    poses = np.zeros((T, 165), np.float32)
    body = motion322[:, :66]
    hands = motion322[:, 66:156]
    trans = motion322[:, 309:312].copy()
    if smooth:
        body = smooth_axis_angle_6d(body, 3.0)
        hands = smooth_axis_angle_6d(hands, 3.0)
        trans = temporal_filter(trans, 3.0)
    poses[:, :66] = body
    poses[:, 75:165] = hands
    _savez(path, poses, np.zeros((T, 100)), trans, np.zeros(300), fps)


def gt_export_npz(motion322: np.ndarray, path: str, betas=None,
                  fps: int = 30) -> None:
    """The unsmoothed ground truth beside a generated clip."""
    T = motion322.shape[0]
    poses = np.zeros((T, 165), np.float32)
    poses[:, :66] = motion322[:, :66]
    poses[:, 66:69] = motion322[:, 156:159]
    poses[:, 75:165] = motion322[:, 66:156]
    _savez(path, poses, motion322[:, 209:309], motion322[:, 309:312],
           betas if betas is not None else np.zeros(300), fps)


def fk_joints_322(motion322: np.ndarray, device="cuda") -> np.ndarray:
    """FK joint trajectories [T, 55, 3] of a 322-d clip, the skeleton that
    the stick-figure video and the web player draw: the SMPL-X rest joints
    where the asset is found, the approximate skeleton otherwise
    (ops/fk.py:SMPLXSkeleton), on ``device`` (the card unless told)."""
    from ..ops.fk import SMPLXSkeleton

    T = motion322.shape[0]
    pose165 = np.zeros((T, 165), np.float32)
    pose165[:, :66] = motion322[:, :66]
    pose165[:, 66:69] = motion322[:, 156:159]
    pose165[:, 75:165] = motion322[:, 66:156]
    fk = SMPLXSkeleton(device=device)
    return fk.forward(pose165, np.asarray(motion322[:, 309:312], np.float32)).cpu().numpy()
