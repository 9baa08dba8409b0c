"""Rotation representations on tensors (PyTorch port of
motioncraft_tpu/ops/rotation.py): axis-angle <-> matrix <-> quaternion
(w, x, y, z) <-> 6d, and slerp, with the JAX package's formulas.

  - ``axis_angle_to_matrix``: the Rodrigues formula, the angle taken as
    |aa + 1e-8| as the JAX package takes it
  - ``matrix_to_quaternion``: picked branchlessly from the four
    diagonal-dominance candidates (Shepperd), sign w >= 0
  - 6d: the first two rows of the matrix (pytorch3d's convention, Zhou et
    al.), back by Gram-Schmidt
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


def quaternion_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """[..., 4] (w, x, y, z) -> [..., 3, 3]."""
    q = q / (torch.linalg.norm(q, dim=-1, keepdim=True) + 1e-12)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], dim=-2)


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


def axis_angle_to_quaternion(aa: torch.Tensor) -> torch.Tensor:
    angle = torch.linalg.norm(aa + 1e-12, dim=-1, keepdim=True)
    half = angle / 2
    return torch.cat([torch.cos(half), aa / angle * torch.sin(half)], dim=-1)


def matrix_to_rotation_6d(R: torch.Tensor) -> torch.Tensor:
    """The first two ROWS of R, flattened: [..., 6]."""
    return R[..., :2, :].reshape(R.shape[:-2] + (6,))


def rotation_6d_to_matrix(d6: torch.Tensor) -> torch.Tensor:
    """Gram-Schmidt on the two rows (row vectors)."""
    a1, a2 = d6[..., :3], d6[..., 3:]
    b1 = a1 / (torch.linalg.norm(a1, dim=-1, keepdim=True) + 1e-12)
    a2 = a2 - torch.sum(b1 * a2, dim=-1, keepdim=True) * b1
    b2 = a2 / (torch.linalg.norm(a2, dim=-1, keepdim=True) + 1e-12)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-2)


def quat_to_6v(q):
    return matrix_to_rotation_6d(quaternion_to_matrix(q))


def quat_from_6v(d6):
    return matrix_to_quaternion(rotation_6d_to_matrix(d6))


def ax_to_6v(aa):
    return matrix_to_rotation_6d(axis_angle_to_matrix(aa))


def ax_from_6v(d6):
    return matrix_to_axis_angle(rotation_6d_to_matrix(d6))


def quat_slerp(x, y, a):
    """Spherical linear interpolation from x to y by a, through the shorter
    arc; linear where the two are within 0.01 of parallel."""
    dot = torch.sum(x * y, dim=-1)
    y = torch.where(dot[..., None] < 0, -y, y)
    dot = torch.abs(dot)
    a = torch.zeros_like(x[..., 0]) + a
    linear = (1.0 - dot) < 0.01
    omega = torch.arccos(torch.clamp(dot, -1.0, 1.0))
    sinom = torch.where(linear, torch.ones_like(omega), torch.sin(omega))
    amt0 = torch.where(linear, 1.0 - a, torch.sin((1.0 - a) * omega) / sinom)
    amt1 = torch.where(linear, a, torch.sin(a * omega) / sinom)
    return amt0[..., None] * x + amt1[..., None] * y
