"""HumanML3D 263-d feature recovery and skeleton plotting (PyTorch port of
motioncraft_tpu/ops/humanml3d.py).

The 263-d HumanML3D vector (root yaw velocity, root xz velocity, root
height, root-relative joint positions, 6d rotations, velocities, foot
contacts) -> the 22 global joint positions, on the tensors' device.
"""

from __future__ import annotations

import numpy as np
import torch

# HumanML3D / KIT kinematic chains for plotting (Guo et al. conventions)
T2M_KINEMATIC_CHAIN = [[0, 2, 5, 8, 11], [0, 1, 4, 7, 10], [0, 3, 6, 9, 12, 15],
                       [9, 14, 17, 19, 21], [9, 13, 16, 18, 20]]
KIT_KINEMATIC_CHAIN = [[0, 11, 12, 13, 14, 15], [0, 16, 17, 18, 19, 20],
                       [0, 1, 2, 3, 4], [3, 5, 6, 7], [3, 8, 9, 10]]


def qinv(q: torch.Tensor) -> torch.Tensor:
    return q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype, device=q.device)


def qrot(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate v [..., 3] by quaternion q [..., 4] (w, x, y, z)."""
    qvec = q[..., 1:]
    uv = torch.linalg.cross(qvec, v, dim=-1)
    uuv = torch.linalg.cross(qvec, uv, dim=-1)
    return v + 2 * (q[..., :1] * uv + uuv)


def recover_root_rot_pos(data: torch.Tensor):
    """Integrate the root's yaw velocity and xz velocity: (root rotation
    quaternions [..., T, 4], root positions [..., T, 3])."""
    rot_vel = data[..., 0]
    r_rot_ang = torch.cumsum(
        torch.cat([torch.zeros_like(rot_vel[..., :1]), rot_vel[..., :-1]], -1), -1)
    zeros = torch.zeros_like(r_rot_ang)
    r_rot_quat = torch.stack([torch.cos(r_rot_ang), zeros, torch.sin(r_rot_ang), zeros], -1)

    r_xz = torch.cat([torch.zeros_like(data[..., :1, 1:3]), data[..., :-1, 1:3]], dim=-2)
    r_pos = torch.stack([r_xz[..., 0], torch.zeros_like(r_xz[..., 0]), r_xz[..., 1]], -1)
    r_pos = qrot(qinv(r_rot_quat), r_pos)
    r_pos = torch.cumsum(r_pos, dim=-2)
    r_pos = torch.cat([r_pos[..., :1], data[..., 3:4], r_pos[..., 2:]], -1)
    return r_rot_quat, r_pos


def recover_from_ric(data, joints_num: int = 22) -> torch.Tensor:
    """263-d features [..., T, 263] -> joints [..., T, J, 3]."""
    data = torch.as_tensor(data, dtype=torch.float32)
    r_rot_quat, r_pos = recover_root_rot_pos(data)
    positions = data[..., 4:(joints_num - 1) * 3 + 4]
    positions = positions.reshape(positions.shape[:-1] + (joints_num - 1, 3))
    rot = qinv(r_rot_quat)[..., None, :].expand(positions.shape[:-1] + (4,))
    positions = qrot(rot, positions)
    positions = positions + torch.stack([r_pos[..., 0:1], torch.zeros_like(r_pos[..., 0:1]),
                                         r_pos[..., 2:3]], -1)
    return torch.cat([r_pos[..., None, :], positions], dim=-2)


def plot_3d_motion(save_path: str, joints: np.ndarray, title: str = "",
                   kinematic_chain=T2M_KINEMATIC_CHAIN, fps: int = 20):
    """A matplotlib 3D skeleton animation of HumanML3D joints [T, J, 3]:
    ``save_path`` by ffmpeg, else a gif beside it; returns the path
    written."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib import animation

    joints = joints.cpu().numpy() if torch.is_tensor(joints) else np.asarray(joints)
    fig = plt.figure(figsize=(6, 6))
    ax = fig.add_subplot(projection="3d")
    radius = max(1.0, float(np.abs(joints).max()))

    def draw(t):
        ax.cla()
        ax.set_xlim(-radius, radius); ax.set_ylim(-radius, radius)
        ax.set_zlim(0, 2 * radius)
        ax.set_title(title[:60])
        j = joints[t]
        for chain in kinematic_chain:
            ax.plot(j[chain, 0], j[chain, 2], j[chain, 1], lw=2)

    anim = animation.FuncAnimation(fig, draw, frames=len(joints),
                                   interval=1000 / fps)
    try:
        anim.save(save_path, fps=fps)
    except Exception:
        save_path = save_path.rsplit(".", 1)[0] + ".gif"
        anim.save(save_path, writer="pillow", fps=fps)
    plt.close(fig)
    return save_path
