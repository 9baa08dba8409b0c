"""Mocap preprocessing over parsed BVH data (port of
motioncraft_tpu/data/mocap.py: numpy, with the port's rotations).

Each step of the pymo pipeline is a function over (BVHData, [T, C] frame
arrays), with no pandas or sklearn:

  MocapParameterizer('position')   -> forward_kinematics
  MocapParameterizer('expmap')     -> euler_to_expmap (+ expmap_to_euler)
  MocapParameterizer('euler')      -> joint_rotations / root_positions
  JointSelector                    -> select_joints
  RootTransformer('pos_rot_deltas')-> root_deltas
  RootCentricPositionNormalizer    -> root_centric_positions
  DownSampler                      -> downsample
  ConstantsRemover                 -> constant_channels / remove_constants
  StandardScaler (sklearn)         -> standard_scale
  writers.BVHWriter                -> write_bvh
  features.get_foot_contact_idxs   -> foot_contact_idxs (+ peak_indexes)
  features.create_foot_contact_signal -> foot_contact_signal
  mocapplayer (three.js web player)-> utils/web_player.py
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from .bvh import BVHData, BVHJoint


def _euler_axis_matrix(angles_rad: np.ndarray, axis: str) -> np.ndarray:
    """[...,] angles -> [..., 3, 3] rotations about a fixed axis."""
    c, s = np.cos(angles_rad), np.sin(angles_rad)
    o, z = np.ones_like(c), np.zeros_like(c)
    if axis == "X":
        rows = [o, z, z, z, c, -s, z, s, c]
    elif axis == "Y":
        rows = [c, z, s, z, o, z, -s, z, c]
    else:
        rows = [c, -s, z, s, c, z, z, z, o]
    return np.stack(rows, axis=-1).reshape(angles_rad.shape + (3, 3))


def joint_rotations(data: BVHData, frames: Optional[np.ndarray] = None
                    ) -> np.ndarray:
    """Per-joint local rotation matrices [T, J, 3, 3] from the BVH euler
    channels, honoring each joint's channel order (pymo rotation_tools
    euler2mat with per-file order)."""
    frames = data.frames if frames is None else frames
    T = len(frames)
    J = len(data.joints)
    rots = np.broadcast_to(np.eye(3), (T, J, 3, 3)).copy()
    for ji, joint in enumerate(data.joints):
        R = np.broadcast_to(np.eye(3), (T, 3, 3))
        for ci, ch in enumerate(joint.channels):
            if not ch.endswith("rotation"):
                continue
            ang = np.deg2rad(frames[:, joint.channel_offset + ci])
            R = R @ _euler_axis_matrix(ang, ch[0].upper())
        rots[:, ji] = R
    return rots


def root_positions(data: BVHData, frames: Optional[np.ndarray] = None
                   ) -> np.ndarray:
    """Root translation channels [T, 3] (Xposition/Yposition/Zposition)."""
    frames = data.frames if frames is None else frames
    root = data.joints[0]
    pos = np.zeros((len(frames), 3), frames.dtype)
    for ci, ch in enumerate(root.channels):
        if ch.endswith("position"):
            pos[:, "XYZ".index(ch[0].upper())] = frames[:, root.channel_offset + ci]
    return pos


def forward_kinematics(data: BVHData, frames: Optional[np.ndarray] = None
                       ) -> np.ndarray:
    """BVH euler frames -> global joint positions [T, J, 3]
    (MocapParameterizer('position'), preprocessing.py:14-120)."""
    rots = joint_rotations(data, frames)
    T, J = rots.shape[:2]
    offsets = data.offsets
    parents = data.parents
    G = np.empty((T, J, 3, 3))
    P = np.empty((T, J, 3))
    G[:, 0] = rots[:, 0]
    P[:, 0] = root_positions(data, frames) + offsets[0]
    for j in range(1, J):
        p = int(parents[j])
        P[:, j] = P[:, p] + np.einsum("tik,k->ti", G[:, p], offsets[j])
        G[:, j] = G[:, p] @ rots[:, j]
    return P


def euler_to_expmap(data: BVHData, frames: Optional[np.ndarray] = None
                    ) -> np.ndarray:
    """Per-joint exponential-map (axis-angle) parameterization [T, J, 3]
    (MocapParameterizer('expmap'))."""
    R = joint_rotations(data, frames)
    tr = np.clip((np.trace(R, axis1=-2, axis2=-1) - 1) / 2, -1.0, 1.0)
    theta = np.arccos(tr)
    v = np.stack([R[..., 2, 1] - R[..., 1, 2],
                  R[..., 0, 2] - R[..., 2, 0],
                  R[..., 1, 0] - R[..., 0, 1]], axis=-1)
    s = 2 * np.sin(theta)
    axis = v / np.where(np.abs(s) < 1e-8, 1.0, s)[..., None]
    return axis * theta[..., None]


def select_joints(data: BVHData, names: Sequence[str],
                  include_root_position: bool = True
                  ) -> Tuple[BVHData, np.ndarray]:
    """Keep only the named joints' channels (JointSelector,
    preprocessing.py:227-264).  Returns (new BVHData, kept channel idxs)."""
    keep = set(names)
    cols: List[int] = []
    joints: List[BVHJoint] = []
    offset = 0
    name_to_new = {}
    for ji, j in enumerate(data.joints):
        if j.name not in keep and not (ji == 0 and include_root_position):
            continue
        chans = list(j.channels)
        if ji == 0 and j.name not in keep:
            chans = [c for c in chans if c.endswith("position")]
        base = j.channel_offset
        for ci, ch in enumerate(j.channels):
            if ch in chans:
                cols.append(base + ci)
        parent_new = name_to_new.get(
            data.joints[j.parent].name if j.parent is not None else None)
        name_to_new[j.name] = len(joints)
        joints.append(BVHJoint(j.name, parent_new, j.offset, chans, offset))
        offset += len(chans)
    cols_arr = np.asarray(cols, np.int64)
    return (BVHData(joints=joints, frames=data.frames[:, cols_arr],
                    frame_time=data.frame_time), cols_arr)


def root_centric_positions(positions: np.ndarray) -> np.ndarray:
    """Subtract the root's XZ trajectory from all joints, keep root height
    (RootCentricPositionNormalizer, preprocessing.py:510-578)."""
    out = positions.copy()
    traj = positions[:, :1].copy()
    traj[..., 1] = 0.0  # keep Y
    return out - traj


def root_deltas(positions: np.ndarray, fps: float = 30.0) -> np.ndarray:
    """Root XZ velocity + yaw-free forward motion features [T, 3]:
    (dx, dz, dy_height) — the RootTransformer('pos_rot_deltas') capability in
    a rotation-free simplification."""
    root = positions[:, 0]
    vel = np.diff(root, axis=0, prepend=root[:1]) * fps
    return np.stack([vel[:, 0], vel[:, 2], root[:, 1]], axis=1)


def downsample(frames: np.ndarray, rate: int) -> np.ndarray:
    """Every rate-th frame (DownSampler, preprocessing.py:682-711)."""
    return frames[::rate]


def constant_channels(frames: np.ndarray, eps: float = 1e-6) -> np.ndarray:
    """Boolean mask of channels with (near-)zero variance (ConstantsRemover,
    preprocessing.py:591-629)."""
    return frames.std(axis=0) <= eps


def remove_constants(frames: np.ndarray, eps: float = 1e-6
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (reduced frames, kept idxs, constant values per channel)."""
    const = constant_channels(frames, eps)
    kept = np.nonzero(~const)[0]
    return frames[:, kept], kept, frames[0] * const


def write_bvh(data: BVHData, path: str,
              frames: Optional[np.ndarray] = None) -> str:
    """Serialize hierarchy + frames back to a BVH file (pymo writers.py)."""
    frames = data.frames if frames is None else frames
    lines = ["HIERARCHY"]
    children: List[List[int]] = [[] for _ in data.joints]
    for ji, j in enumerate(data.joints):
        if j.parent is not None:
            children[j.parent].append(ji)

    def emit(ji: int, depth: int):
        j = data.joints[ji]
        ind = "  " * depth
        if not j.channels:  # end site
            lines.append(f"{ind}End Site")
            lines.append(f"{ind}{{")
            lines.append(f"{ind}  OFFSET {j.offset[0]:.6f} {j.offset[1]:.6f} "
                         f"{j.offset[2]:.6f}")
            lines.append(f"{ind}}}")
            return
        kw = "ROOT" if j.parent is None else "JOINT"
        lines.append(f"{ind}{kw} {j.name}")
        lines.append(f"{ind}{{")
        lines.append(f"{ind}  OFFSET {j.offset[0]:.6f} {j.offset[1]:.6f} "
                     f"{j.offset[2]:.6f}")
        lines.append(f"{ind}  CHANNELS {len(j.channels)} {' '.join(j.channels)}")
        for c in children[ji]:
            emit(c, depth + 1)
        lines.append(f"{ind}}}")

    emit(0, 0)
    lines.append("MOTION")
    lines.append(f"Frames: {len(frames)}")
    lines.append(f"Frame Time: {data.frame_time:.8f}")
    for row in frames:
        lines.append(" ".join(f"{v:.6f}" for v in row))
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


def expmap_to_euler(expmaps: np.ndarray, order: str = "ZXY") -> np.ndarray:
    """[T, J, 3] exponential maps -> euler angles (deg) in the given
    rotation order (pymo rotation_tools expmap2euler equivalent; inverse of
    euler_to_expmap for writing generated motion back to BVH)."""
    import torch

    from ..ops.rotation import axis_angle_to_matrix

    R = axis_angle_to_matrix(torch.as_tensor(
        np.asarray(expmaps, np.float32).reshape(-1, 3))).numpy()
    R = R.reshape(expmaps.shape[:-1] + (3, 3))
    out = np.zeros_like(expmaps)
    if order.upper() == "ZXY":
        # R = Rz @ Rx @ Ry (pymo's euler2mat with order 'ZXY' applies
        # channels left to right)
        x = np.arcsin(np.clip(R[..., 2, 1], -1.0, 1.0))
        cx = np.cos(x)
        z = np.arctan2(-R[..., 0, 1] / np.where(cx == 0, 1, cx),
                       R[..., 1, 1] / np.where(cx == 0, 1, cx))
        y = np.arctan2(-R[..., 2, 0] / np.where(cx == 0, 1, cx),
                       R[..., 2, 2] / np.where(cx == 0, 1, cx))
        out[..., 0], out[..., 1], out[..., 2] = z, x, y
    elif order.upper() == "XYZ":
        # R = Rx @ Ry @ Rz (channels applied left to right)
        y = np.arcsin(np.clip(R[..., 0, 2], -1.0, 1.0))
        x = np.arctan2(-R[..., 1, 2], R[..., 2, 2])
        z = np.arctan2(-R[..., 0, 1], R[..., 0, 0])
        out[..., 0], out[..., 1], out[..., 2] = x, y, z
    else:
        raise ValueError(f"unsupported order {order}")
    return np.degrees(out)


def standard_scale(frames: np.ndarray, mean: Optional[np.ndarray] = None,
                   std: Optional[np.ndarray] = None):
    """Per-channel standardization (pymo ListStandardScaler): returns
    (scaled, mean, std); pass stored stats to apply, None to fit."""
    if mean is None:
        mean = frames.reshape(-1, frames.shape[-1]).mean(axis=0)
        std = frames.reshape(-1, frames.shape[-1]).std(axis=0) + 1e-8
    return (frames - mean) / std, mean, std


def peak_indexes(y: np.ndarray, thres: float = 0.3,
                 min_dist: int = 1) -> np.ndarray:
    """1-D peak detection with peakutils.indexes semantics (the dependency
    pymo/features.py:13-14 pulls in): `thres` is normalized to the signal's
    [min, max] span; peaks closer than `min_dist` are suppressed keeping the
    highest first.  Pure numpy — no peakutils dependency."""
    y = np.asarray(y, np.float64)
    if y.size < 3:
        return np.array([], np.int64)
    level = thres * (y.max() - y.min()) + y.min()
    dy = np.diff(y)
    # resolve zero-slope plateaus by propagating the neighboring slope, so a
    # flat-topped peak is detected once (peakutils does the same fill)
    zeros = np.where(dy == 0)[0]
    if len(zeros) == len(dy):
        return np.array([], np.int64)
    if len(zeros):
        filled = dy.copy()
        # forward pass: a zero takes the previous non-zero slope
        for i in zeros:
            filled[i] = filled[i - 1] if i > 0 else 0.0
        # any leading zeros take the next non-zero slope
        for i in zeros[::-1]:
            if filled[i] == 0.0:
                filled[i] = filled[i + 1] if i + 1 < len(filled) else 0.0
        dy = filled
    peaks = np.where((np.hstack([dy, 0.0]) < 0.0)
                     & (np.hstack([0.0, dy]) > 0.0)
                     & (y > level))[0]
    if peaks.size and min_dist > 1:
        keep = np.zeros(y.size, bool)
        keep[peaks] = True
        for p in peaks[np.argsort(y[peaks])][::-1]:  # highest first
            if keep[p]:
                lo = max(0, p - min_dist)
                keep[lo:p + min_dist + 1] = False
                keep[p] = True
        peaks = np.where(keep)[0]
    return peaks.astype(np.int64)


def foot_contact_idxs(signal: np.ndarray, t: float = 0.02,
                      min_dist: int = 120) -> Tuple[np.ndarray, np.ndarray]:
    """(up_idxs, down_idxs) peaks of a foot-height/velocity track — pymo
    features.get_foot_contact_idxs (features.py:12-16), thresholds included
    (up: t/max(signal), down: t/min(signal) on the negated track)."""
    signal = np.asarray(signal, np.float64)
    up = peak_indexes(signal, thres=t / signal.max(), min_dist=min_dist)
    down = peak_indexes(-signal, thres=t / signal.min(), min_dist=min_dist)
    return up, down


def foot_contact_signal(signal: np.ndarray, t: float = 0.02,
                        min_dist: int = 120, start: int = 1) -> np.ndarray:
    """Binary per-frame contact track: 0 from each down-peak, 1 from each
    up-peak, `start` before the first event — pymo
    features.create_foot_contact_signal (features.py:19-35)."""
    up, down = foot_contact_idxs(signal, t=t, min_dist=min_dist)
    up_set, down_set = set(up.tolist()), set(down.tolist())
    out, c = np.empty(len(signal), np.int64), start
    for f in range(len(signal)):
        if f in down_set:
            c = 0
        elif f in up_set:
            c = 1
        out[f] = c
    return out
