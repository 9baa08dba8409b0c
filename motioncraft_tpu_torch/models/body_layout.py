"""Static body-part index layouts for motion feature vectors.

These tables define which feature dims belong to which body part for each
dataset format, mirroring the slice functions in
reference mogen/models/transformers/stmogen.py:13-118.  They are pure
host-side data: the encoder gathers with them, the decoder scatters through a
precomputed inverse permutation — no dynamic indexing reaches the device.

Layouts:
  smplx322 ('motionx'):  322-d SMPL-X = 3 global orient + 63 body pose +
    90 hand pose + 3 jaw + 50 expr-ish + 100 face + 3 trans + 10 shape
  t2m ('human_ml3d'): 263-d HumanML3D; kit_ml: 251-d KIT-ML
  rot6d: 425-d 6d-rotation variant; openpose17: 34-d 2D keypoints

A copy of the JAX package's module of the same name: the port imports
nothing of motioncraft_tpu.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def _t2m_joint(idx: int) -> List[int]:
    if idx == 0:
        return [0, 1, 2, 3, 193, 194, 195, 259, 260, 261, 262]
    return ([4 + (idx - 1) * 3 + k for k in range(3)]
            + [67 + (idx - 1) * 6 + k for k in range(6)]
            + [193 + idx * 3 + k for k in range(3)])


def _kit_joint(idx: int) -> List[int]:
    if idx == 0:
        return [0, 1, 2, 3, 184, 185, 186, 247, 248, 249, 250]
    return ([4 + (idx - 1) * 3 + k for k in range(3)]
            + [64 + (idx - 1) * 6 + k for k in range(6)]
            + [184 + idx * 3 + k for k in range(3)])


def _smplx_part(name: str) -> List[int]:
    j3 = lambda *joints: [j * 3 + k for j in joints for k in range(3)]
    table = {
        "root": [0, 1, 2] + list(range(312, 322)),
        "trans": [309, 310, 311],
        "head": j3(12, 15) + [156, 157, 158],  # neck, head, jaw (66+90..)
        "stem": j3(3, 6, 9),
        "larm": j3(14, 17, 19, 21),
        "rarm": j3(13, 16, 18, 20),
        "lleg": j3(2, 5, 8, 11),
        "rleg": j3(1, 4, 7, 10),
        "face": list(range(159, 309)),
        "lhand": list(range(66, 111)),
        "rhand": list(range(111, 156)),
    }
    return table[name]


def _rot6d_part(name: str) -> List[int]:
    j6 = lambda *joints: [7 + j * 6 + k for j in joints for k in range(6)]
    table = {
        "root": j6(0),
        "trans": [0, 1, 2, 3, 4, 5, 6],
        "head": j6(12, 15) + list(range(319, 325)),
        "stem": j6(3, 6, 9),
        "larm": j6(14, 17, 19, 21),
        "rarm": j6(13, 16, 18, 20),
        "lleg": j6(2, 5, 8, 11),
        "rleg": j6(1, 4, 7, 10),
        "face": list(range(325, 425)),
        "lhand": list(range(7 + 22 * 6, 7 + 22 * 6 + 15 * 6)),
        "rhand": list(range(7 + 22 * 6 + 15 * 6, 7 + 22 * 6 + 30 * 6)),
    }
    return table[name]


def _openpose17_part(name: str) -> List[int]:
    table = {
        "head": [0, 1, 2, 3, 4],
        "rarm": [6, 8, 10],
        "larm": [5, 7, 9],
        "rleg": [12, 14, 16],
        "lleg": [11, 13, 15],
    }
    kps = table[name]
    return [i * 2 for i in kps] + [i * 2 + 1 for i in kps]


def _joints(func, joints: List[int]) -> List[int]:
    out: List[int] = []
    for j in joints:
        out.extend(func(j))
    return out


def part_slices(dataset_name: str) -> Dict[str, List[int]]:
    """Ordered part -> feature-index lists (matching reference part order)."""
    if dataset_name == "human_ml3d":
        f = _t2m_joint
        return {
            "head": _joints(f, [12, 15]), "stem": _joints(f, [3, 6, 9]),
            "larm": _joints(f, [14, 17, 19, 21]), "rarm": _joints(f, [13, 16, 18, 20]),
            "lleg": _joints(f, [2, 5, 8, 11]), "rleg": _joints(f, [1, 4, 7, 10]),
            "root": f(0),
        }
    if dataset_name == "kit_ml":
        f = _kit_joint
        return {
            "head": f(4), "stem": _joints(f, [1, 2, 3]),
            "larm": _joints(f, [8, 9, 10]), "rarm": _joints(f, [5, 6, 7]),
            "lleg": _joints(f, [16, 17, 18, 19, 20]), "rleg": _joints(f, [11, 12, 13, 14, 15]),
            "root": f(0),
        }
    if dataset_name in ("motionx", "rot6d"):
        f = _smplx_part if dataset_name == "motionx" else _rot6d_part
        order = ["head", "stem", "larm", "rarm", "lleg", "rleg", "root",
                 "trans", "face", "lhand", "rhand"]
        return {name: f(name) for name in order}
    if dataset_name == "openpose17":
        return {name: _openpose17_part(name) for name in ["head", "larm", "rarm", "lleg", "rleg"]}
    raise NotImplementedError(dataset_name)


def joint_slices(dataset_name: str) -> List[List[int]]:
    """Fine-grained per-joint layout (PoseEncoder joints=True mode)."""
    if dataset_name == "human_ml3d":
        return [_t2m_joint(i) for i in range(22)]
    if dataset_name == "motionx":
        out = [[i * 3, i * 3 + 1, i * 3 + 2] for i in range(53)]
        out.append([309, 310, 311])
        out.append(list(range(159, 209)))
        out.append(list(range(209, 309)))
        out.append(list(range(312, 322)))
        return out
    raise NotImplementedError(dataset_name)


def body_slice(dataset_name: str) -> List[int]:
    """The full-body gather order = concatenation of part slices."""
    if dataset_name == "human_ml3d":
        return _joints(_t2m_joint, list(range(22)))
    if dataset_name == "kit_ml":
        return _joints(_kit_joint, list(range(21)))
    if dataset_name == "motionx":
        order = ["head", "stem", "larm", "rarm", "lleg", "rleg", "root",
                 "trans", "face", "lhand", "rhand"]
        return sum((_smplx_part(n) for n in order), [])
    if dataset_name == "rot6d":
        order = ["head", "stem", "larm", "rarm", "lleg", "rleg", "root",
                 "trans", "face", "lhand", "rhand"]
        return sum((_rot6d_part(n) for n in order), [])
    if dataset_name == "openpose17":
        return sum((_openpose17_part(n) for n in ["head", "larm", "rarm", "lleg", "rleg"]), [])
    raise NotImplementedError(dataset_name)


def joints_body_slice(dataset_name: str) -> List[int]:
    if dataset_name == "human_ml3d":
        return _joints(_t2m_joint, list(range(22)))
    if dataset_name == "motionx":
        return (list(range(66 + 93)) + [309, 310, 311] + list(range(159, 209))
                + list(range(209, 309)) + list(range(312, 322)))
    raise NotImplementedError(dataset_name)


def inverse_permutation(indices: List[int], total: int) -> np.ndarray:
    """inv such that out[..., indices] = parts  <=>  out = parts[..., inv]."""
    if sorted(indices) != list(range(total)):
        raise ValueError("part slices must form a permutation of the feature dims")
    inv = np.empty(total, dtype=np.int32)
    inv[np.asarray(indices)] = np.arange(len(indices), dtype=np.int32)
    return inv


# SMPL-X 322 semantic regions used by loss masking and evaluation
SMPLX_FACE_DIMS = (159, 309)   # expression+face coeffs (face_no_loss, GT-align)
SMPLX_HAND_DIMS = (66, 156)    # both hands' pose
SMPLX_TRANS_DIMS = (309, 312)
SMPLX_SHAPE_DIMS = (312, 322)
