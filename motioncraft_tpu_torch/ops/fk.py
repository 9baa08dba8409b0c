"""Batched SMPL-X forward kinematics (PyTorch port of
motioncraft_tpu/ops/fk.py).

Axis-angle pose [N, 165] (or [N, 156], without jaw and eyes) and a root
translation [N, 3] -> the 55 global joint positions, by Rodrigues and a
rigid-transform chain over the static SMPL-X kinematic tree, carried as
(R, t) pairs.  The batch carries the work; the 55-step chain is a Python
loop of small batched products.

Rest-pose joints come from the SMPL-X neutral asset (``smplx_neu_J_1.npy``)
where one is found, else from ``default_rest_joints``, an approximate
skeleton: the gesture CLI then flags its numbers as not comparable with the
protocol's.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from .rotation import axis_angle_to_matrix

# the SMPL-X 55-joint kinematic tree
SMPLX_PARENTS = np.array([
    -1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17, 18, 19,
    15, 15, 15,
    20, 25, 26, 20, 28, 29, 20, 31, 32, 20, 34, 35, 20, 37, 38,
    21, 40, 41, 21, 43, 44, 21, 46, 47, 21, 49, 50, 21, 52, 53], dtype=np.int32)

NUM_JOINTS = 55


def default_rest_joints() -> np.ndarray:
    """Approximate neutral SMPL-X rest joints [55, 3] (metres, y up), from
    standard proportions: good for smoke runs and relative-motion metrics,
    not for vertex-level parity."""
    J = np.zeros((NUM_JOINTS, 3), np.float32)
    J[0] = [0, 0, 0]                  # pelvis
    J[1] = [0.06, -0.09, 0]           # left hip
    J[2] = [-0.06, -0.09, 0]          # right hip
    J[3] = [0, 0.11, 0]               # spine1
    J[4] = [0.1, -0.47, 0]            # left knee
    J[5] = [-0.1, -0.47, 0]           # right knee
    J[6] = [0, 0.25, 0]               # spine2
    J[7] = [0.09, -0.87, -0.03]       # left ankle
    J[8] = [-0.09, -0.87, -0.03]      # right ankle
    J[9] = [0, 0.31, 0]               # spine3
    J[10] = [0.11, -0.93, 0.1]        # left foot
    J[11] = [-0.11, -0.93, 0.1]       # right foot
    J[12] = [0, 0.46, 0]              # neck
    J[13] = [0.08, 0.4, 0]            # left collar
    J[14] = [-0.08, 0.4, 0]           # right collar
    J[15] = [0, 0.54, 0.02]           # head
    J[16] = [0.17, 0.44, 0]           # left shoulder
    J[17] = [-0.17, 0.44, 0]          # right shoulder
    J[18] = [0.42, 0.44, 0]           # left elbow
    J[19] = [-0.42, 0.44, 0]          # right elbow
    J[20] = [0.68, 0.44, 0]           # left wrist
    J[21] = [-0.68, 0.44, 0]          # right wrist
    J[22] = [0, 0.52, 0.05]           # jaw
    J[23] = [0.03, 0.56, 0.08]        # left eye
    J[24] = [-0.03, 0.56, 0.08]       # right eye
    # fingers: 5 fingers x 3 joints a hand, splayed along +-x
    offs = (0.76, 0.80, 0.84)
    for f in range(5):
        dz = (f - 2) * 0.012
        for k in range(3):
            J[25 + f * 3 + k] = [offs[k] + f * 0.004, 0.44, dz]
            J[40 + f * 3 + k] = [-(offs[k] + f * 0.004), 0.44, dz]
    return J


def load_rest_joints(path: Optional[str] = None) -> np.ndarray:
    """The rest joints [55, 3]: the file at ``path``, else
    ``$MOTIONCRAFT_SMPLX_J``, else ``data/smplx_neu_J_1.npy`` of the
    checkout, else the approximate ones."""
    here = os.path.dirname(os.path.abspath(__file__))
    for cand in (path, os.environ.get("MOTIONCRAFT_SMPLX_J"),
                 os.path.join(here, "..", "..", "data", "smplx_neu_J_1.npy")):
        if cand and os.path.isfile(cand):
            return np.load(cand).astype(np.float32).reshape(NUM_JOINTS, 3)
    return default_rest_joints()


def rigid_transform(rot_mats: torch.Tensor, joints: torch.Tensor,
                    parents: np.ndarray) -> torch.Tensor:
    """Local rotations [N, J, 3, 3] + rest joints [N, J, 3] -> posed joint
    positions [N, J, 3], accumulating (R, t) pairs down the tree."""
    rel = torch.cat([joints[:, :1], joints[:, 1:] - joints[:, parents[1:]]], dim=1)
    Rs, ts = [rot_mats[:, 0]], [rel[:, 0]]
    for i in range(1, len(parents)):
        p = int(parents[i])
        Rs.append(Rs[p] @ rot_mats[:, i])
        ts.append(ts[p] + torch.einsum("nij,nj->ni", Rs[p], rel[:, i]))
    return torch.stack(ts, dim=1)


class SMPLXSkeleton:
    """FK over the rest skeleton (``load_rest_joints(rest_joints_path)``), on
    ``device`` (the card unless told)."""

    def __init__(self, rest_joints_path: Optional[str] = None, device="cuda"):
        self.device = torch.device(device)
        self.rest_joints = torch.as_tensor(load_rest_joints(rest_joints_path),
                                           device=self.device)
        self.parents = SMPLX_PARENTS

    def forward(self, rotations, root_positions) -> torch.Tensor:
        """rotations [N, 165] (or [N, 156], jaw and eyes left out and taken
        as identity) + root translation [N, 3] -> joints [N, 55, 3]."""
        rotations = torch.as_tensor(rotations, dtype=torch.float32, device=self.device)
        root = torch.as_tensor(root_positions, dtype=torch.float32, device=self.device)
        N = rotations.shape[0]
        if rotations.shape[1] == 156:
            rotations = torch.cat([rotations[:, :66], rotations.new_zeros(N, 9),
                                   rotations[:, 66:]], dim=1)
        rot_mats = axis_angle_to_matrix(rotations.reshape(N, NUM_JOINTS, 3))
        rest = self.rest_joints.expand(N, NUM_JOINTS, 3)
        return rigid_transform(rot_mats, rest, self.parents) + root[:, None, :]

    __call__ = forward


# the SMPL body's first 22 joints (pelvis to wrists) share the SMPL-X tree
SMPL_PARENTS = SMPLX_PARENTS[:22]


class SMPLSkeleton:
    """FK of the 22-joint SMPL body over axis-angle pose [N, 72] (the body's
    first 66 values; the hands, joints 22-23, are left out), on ``device``
    (the card unless told)."""

    def __init__(self, rest_joints_path: Optional[str] = None, device="cuda"):
        self.device = torch.device(device)
        self.rest_joints = torch.as_tensor(load_rest_joints(rest_joints_path)[:22],
                                           device=self.device)
        self.parents = SMPL_PARENTS

    def forward(self, rotations, root_positions) -> torch.Tensor:
        rotations = torch.as_tensor(rotations, dtype=torch.float32, device=self.device)
        root = torch.as_tensor(root_positions, dtype=torch.float32, device=self.device)
        N = rotations.shape[0]
        mats = axis_angle_to_matrix(rotations[:, :66].reshape(N, 22, 3))
        return rigid_transform(mats, self.rest_joints.expand(N, 22, 3),
                               self.parents) + root[:, None, :]

    __call__ = forward


def mean_max_velocity(joint_sequences, pose_fps: int = 30) -> float:
    """The mean over sequences of each one's largest joint speed (the
    normalizer of BeatAlign's motion beats); 1.0 when no sequence has two
    frames."""
    maxes = []
    for joints in joint_sequences:
        joints = joints.cpu().numpy() if torch.is_tensor(joints) else np.asarray(joints)
        vel = np.linalg.norm(np.diff(joints, axis=0) * pose_fps, axis=-1)
        if vel.size:
            maxes.append(vel.max())
    return float(np.mean(maxes)) if maxes else 1.0
