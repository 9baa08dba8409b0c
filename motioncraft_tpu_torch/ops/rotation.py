"""Axis-angle <-> rotation matrix on tensors (PyTorch port of the part of
motioncraft_tpu/ops/rotation.py that the gesture metrics use).

  - ``axis_angle_to_matrix``: the Rodrigues formula, the angle taken as
    |aa + 1e-8| as the JAX package takes it
  - ``matrix_to_axis_angle``: through the quaternion, picked branchlessly
    from the four diagonal-dominance candidates (Shepperd), sign w >= 0
"""

from __future__ import annotations

import torch


def axis_angle_to_matrix(aa: torch.Tensor) -> torch.Tensor:
    """[..., 3] axis-angle -> [..., 3, 3]."""
    angle = torch.linalg.norm(aa + 1e-8, dim=-1, keepdim=True)
    axis = aa / angle
    x, y, z = axis[..., 0], axis[..., 1], axis[..., 2]
    zeros = torch.zeros_like(x)
    K = torch.stack([torch.stack([zeros, -z, y], dim=-1),
                     torch.stack([z, zeros, -x], dim=-1),
                     torch.stack([-y, x, zeros], dim=-1)], dim=-2)
    cos = torch.cos(angle)[..., None]
    sin = torch.sin(angle)[..., None]
    eye = torch.eye(3, dtype=aa.dtype, device=aa.device).expand(K.shape)
    return eye + sin * K + (1 - cos) * (K @ K)


def matrix_to_quaternion(R: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] -> [..., 4] (w, x, y, z), w >= 0."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    qw = torch.stack([1 + m00 + m11 + m22, m21 - m12, m02 - m20, m10 - m01], -1)
    qx = torch.stack([m21 - m12, 1 + m00 - m11 - m22, m01 + m10, m02 + m20], -1)
    qy = torch.stack([m02 - m20, m01 + m10, 1 - m00 + m11 - m22, m12 + m21], -1)
    qz = torch.stack([m10 - m01, m02 + m20, m12 + m21, 1 - m00 - m11 + m22], -1)
    cands = torch.stack([qw, qx, qy, qz], dim=-2)  # [..., 4, 4]
    traces = torch.stack([1 + m00 + m11 + m22, 1 + m00 - m11 - m22,
                          1 - m00 + m11 - m22, 1 - m00 - m11 + m22], dim=-1)
    best = torch.argmax(traces, dim=-1)
    q = torch.take_along_dim(cands, best[..., None, None].expand(best.shape + (1, 4)),
                             dim=-2)[..., 0, :]
    q = q / (torch.linalg.norm(q, dim=-1, keepdim=True) + 1e-12)
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def quaternion_to_axis_angle(q: torch.Tensor) -> torch.Tensor:
    w = torch.clamp(q[..., 0], -1.0, 1.0)
    xyz = q[..., 1:]
    norm = torch.linalg.norm(xyz, dim=-1)
    angle = 2 * torch.atan2(norm, w)
    scale = torch.where(norm > 1e-6, angle / (norm + 1e-12), 2.0 / torch.clamp(w, min=1e-6))
    return xyz * scale[..., None]


def matrix_to_axis_angle(R: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] -> [..., 3]."""
    return quaternion_to_axis_angle(matrix_to_quaternion(R))
