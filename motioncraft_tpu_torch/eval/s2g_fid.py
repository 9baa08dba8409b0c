"""Skeleton-convolution VAE encoder (VAESKConv), the EMAGE S2G embedding
model (a copy of motioncraft_tpu/eval/s2g_fid.py;
EMAGE_2024/models/motion_representation.py:67-76).

The skeleton-aware convolution (Aberman et al.) is a dense convolution
whose kernel is multiplied by a fixed binary neighbourhood mask, and the
skeleton pooling a fixed pooling matrix, both computed on the host from the
SMPL-X kinematic tree; cuDNN runs the convolutions (TF32 off) on the
model's device: the card unless the caller asks for the CPU.  The modules
carry the flax names, so a flax tree maps onto them through
``utils/convert.py:from_jax_params`` and the released checkpoint through
``utils/torch_convert.py:convert_vaeskconv``.  ``MaskedConv1d`` keeps its
kernel as flax does, [k, in, out] under the name ``weight``.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..models.architecture import exact_f32, resolve_device
from ..models.blocks import Linear, promote_dtype
from ..ops.fk import SMPLX_PARENTS
from ..registry import SUBMODULES


# ------------------------------------------------------------- host topology
def build_edge_topology(parents: Sequence[int]) -> List[Tuple[int, int]]:
    """(parent, child) edges + a virtual root edge (skeleton.py:316-323)."""
    joint_num = len(parents)
    edges = [(0, joint_num)]
    for i in range(1, joint_num):
        edges.append((int(parents[i]), i))
    return edges


def calc_edge_mat(edges):
    n = len(edges)
    mat = np.full((n, n), 100000, dtype=np.int64)
    np.fill_diagonal(mat, 0)
    for i, a in enumerate(edges):
        for j, b in enumerate(edges):
            if a[0] in b or a[1] in b:
                mat[i, j] = 1
    for k in range(n):
        mat = np.minimum(mat, mat[:, k:k + 1] + mat[k:k + 1, :])
    return mat


def find_neighbor(edges, d: int) -> List[List[int]]:
    mat = calc_edge_mat(edges)
    return [list(np.nonzero(mat[i] <= d)[0]) for i in range(len(edges))]


def skeleton_pooling(edges, last_pool: bool = False):
    """Edge-chain mean pooling lists + pooled edges (skeleton.py:160-227)."""
    degree = [0] * 200
    for e in edges:
        degree[e[0]] += 1
        degree[e[1]] += 1
    seq_list: List[List[int]] = []

    def find_seq(j, seq):
        if degree[j] > 2 and j != 0:
            seq_list.append(seq)
            seq = []
        if degree[j] == 1:
            seq_list.append(seq)
            return
        for idx, e in enumerate(edges):
            if e[0] == j:
                find_seq(e[1], seq + [idx])

    find_seq(0, [])
    pooling_list, new_edges = [], []
    for seq in seq_list:
        if last_pool:
            pooling_list.append(seq)
            continue
        if len(seq) % 2 == 1:
            pooling_list.append([seq[0]])
            new_edges.append(edges[seq[0]])
            seq = seq[1:]
        for i in range(0, len(seq), 2):
            pooling_list.append([seq[i], seq[i + 1]])
            new_edges.append((edges[seq[i]][0], edges[seq[i + 1]][1]))
    return pooling_list, new_edges


def pooling_matrix(pooling_list, edge_num, channels_per_edge) -> np.ndarray:
    W = np.zeros((len(pooling_list) * channels_per_edge,
                  edge_num * channels_per_edge), np.float32)
    for i, pair in enumerate(pooling_list):
        for j in pair:
            for c in range(channels_per_edge):
                W[i * channels_per_edge + c, j * channels_per_edge + c] = 1.0 / len(pair)
    return W


def neighbor_mask(neighbour_list, in_per_joint, out_per_joint, kernel_size) -> np.ndarray:
    """Binary [out, in, k] mask implementing SkeletonConv's weight masking."""
    J = len(neighbour_list)
    mask = np.zeros((J * out_per_joint, J * in_per_joint, kernel_size), np.float32)
    for i, nbrs in enumerate(neighbour_list):
        cols = [k * in_per_joint + c for k in nbrs for c in range(in_per_joint)]
        mask[i * out_per_joint:(i + 1) * out_per_joint, cols, :] = 1
    return mask


# ------------------------------------------------------------------- modules
class MaskedConv1d(nn.Module):
    """Conv1d with a fixed binary kernel mask (SkeletonConv, skeleton.py:9-113)
    on [B, T, C]; the kernel in flax's layout [k, in, out] (``weight``), the
    mask a buffer that the state_dict leaves out (it is structure)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, stride: int,
                 padding: int, mask: np.ndarray):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.weight = nn.Parameter(torch.empty(kernel_size, in_channels, out_channels))
        self.bias = nn.Parameter(torch.zeros(out_channels))
        nn.init.kaiming_uniform_(self.weight)
        self.register_buffer("mask", torch.from_numpy(np.ascontiguousarray(
            np.transpose(mask, (2, 1, 0)))), persistent=False)

    def forward(self, x):
        x, w, b = promote_dtype(x, self.weight, self.bias)
        kernel = (w * self.mask.to(w.dtype)).permute(2, 1, 0)  # [out, in, k]
        y = F.conv1d(x.transpose(1, 2), kernel, b, stride=self.stride, padding=self.padding)
        return y.transpose(1, 2)


class SkeletonResidualBlock(nn.Module):
    """(conv + GroupNorm(10)) + 1x1 shortcut -> pool -> tanh
    (skeleton.py:547-585)."""

    def __init__(self, neighbour_list, in_per_joint: int, out_per_joint: int,
                 kernel_size: int, stride: int, pool_matrix: Optional[np.ndarray]):
        super().__init__()
        J = len(neighbour_list)
        c_in, c_out = J * in_per_joint, J * out_per_joint
        self.conv = MaskedConv1d(c_in, c_out, kernel_size, stride, (kernel_size - 1) // 2,
                                 neighbor_mask(neighbour_list, in_per_joint, out_per_joint,
                                               kernel_size))
        # flax GroupNorm's epsilon
        self.gn = nn.GroupNorm(10, c_out, eps=1e-6)
        self.shortcut = MaskedConv1d(c_in, c_out, 1, stride, 0, neighbor_mask(
            neighbour_list, in_per_joint, out_per_joint, 1))
        self.register_buffer("pool", None if pool_matrix is None else
                             torch.from_numpy(pool_matrix), persistent=False)

    def forward(self, x):
        res = self.conv(x)
        res = self.gn(res.transpose(1, 2)).transpose(1, 2)
        y = res + self.shortcut(x)
        if self.pool is not None:
            y = y @ self.pool.t()
        return torch.tanh(y)


class LocalEncoderModule(nn.Module):
    """Skeleton-conv encoder stack (motion_encoder.py LocalEncoder:698-789):
    with the reference's eval settings (vae_layer 4, grow [1, 1, 2, 1]) the
    SMPL-X topology pools 55 -> 35 -> 20 edges and the output is 20 x 12 =
    240 = vae_length; ``out_proj`` exists only where another layer count
    leaves a width mismatch."""

    def __init__(self, parents: Sequence[int] = tuple(int(p) for p in SMPLX_PARENTS),
                 channel_base: int = 6, num_layers: int = 4, grow: Sequence[int] = (1, 1, 2, 1),
                 kernel_size: int = 4, skeleton_dist: int = 2, vae_length: int = 240):
        super().__init__()
        self.num_layers = num_layers
        topologies = [build_edge_topology(list(parents))]
        channels = [channel_base]
        for i in range(num_layers):
            channels.append(channels[-1] * grow[i])
        for i in range(num_layers):
            edges = topologies[i]
            nbrs = [list(n) for n in find_neighbor(edges, skeleton_dist)]
            last_pool = i == num_layers - 1
            pooling_list, new_edges = skeleton_pooling(edges, last_pool)
            pool = pooling_matrix(pooling_list, len(edges), channels[i + 1])
            self.add_module(f"layer_{i}", SkeletonResidualBlock(
                nbrs, channels[i], channels[i + 1], kernel_size, 2,
                pool if len(pooling_list) != len(edges) else None))
            topologies.append(new_edges if not last_pool else edges)
        last = getattr(self, f"layer_{num_layers - 1}")
        width = (last.pool.shape[0] if last.pool is not None else last.conv.bias.numel())
        self.out_proj = Linear(width, vae_length) if width != vae_length else None

    def forward(self, x):  # x [B, T, edges x channel_base]
        for i in range(self.num_layers):
            x = getattr(self, f"layer_{i}")(x)
        return x if self.out_proj is None else self.out_proj(x)


def smplx322_to_rot6d(motion322) -> torch.Tensor:
    """[B, T, 322] -> [B, T, 55 * 6] per-joint rot6d (the VAESKConv input),
    on the input's device: the 55-joint axis-angle layout (body 0:66, jaw at
    66:69 from the 322-d 156:159, hands at 75:165 from 66:156) through the
    continuous 6d representation."""
    from ..ops.rotation import ax_to_6v

    m = motion322 if torch.is_tensor(motion322) else torch.from_numpy(
        np.asarray(motion322, np.float32))
    B, T = m.shape[:2]
    pose = m.new_zeros(B, T, 165)
    pose[..., :66] = m[..., :66]
    pose[..., 66:69] = m[..., 156:159]
    pose[..., 75:165] = m[..., 66:156]
    return ax_to_6v(pose.reshape(B, T, 55, 3)).reshape(B, T, 330)


@SUBMODULES.register_module()
class VAESKConv:
    """Skeleton-conv VAE embedding model (motion_representation.py:31-76):
    ``map2latent`` returns the per-frame latent used for S2G FID, on the
    model's device (the card unless ``device`` says otherwise).  Without
    ``init_cfg`` its weights are the modules' own initialisation, seeded by
    ``seed``.  ``variational=False`` (the reference's AESKConv eval setting)
    skips fc_mu, as VAEConv.map2latent does."""

    def __init__(self, vae_length: int = 240, vae_layer: int = 4, vae_test_dim: int = 330,
                 vae_grow=(1, 1, 2, 1), variational: bool = False,
                 init_cfg: Optional[dict] = None, seed: int = 0, device=None, **kwargs):
        exact_f32()
        self.device = resolve_device(device)
        self.variational = variational
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            self.encoder = LocalEncoderModule(num_layers=vae_layer, grow=tuple(vae_grow),
                                              vae_length=vae_length)
            self.fc_mu = Linear(vae_length, vae_length)
        if init_cfg and init_cfg.get("type") == "Pretrained":
            if os.path.isfile(init_cfg["checkpoint"]):
                from ..utils.torch_convert import load_vaeskconv_ckpt
                load_vaeskconv_ckpt(init_cfg["checkpoint"], self.encoder, self.fc_mu,
                                    num_layers=vae_layer)
            else:
                print(f"[VAESKConv] checkpoint {init_cfg['checkpoint']} not found; "
                      "random weights")
        self.encoder.to(self.device).eval()
        self.fc_mu.to(self.device).eval()

    @torch.no_grad()
    def map2latent(self, x) -> torch.Tensor:
        """x [B, T, vae_test_dim] (per-edge rot6d features) -> [B, T', latent]."""
        x = (x if torch.is_tensor(x) else torch.from_numpy(np.asarray(x, np.float32)))
        h = self.encoder(x.to(device=self.device, dtype=torch.float32))
        return self.fc_mu(h) if self.variational else h

    @torch.no_grad()
    def encode_motion(self, motion, motion_length=None, motion_mask=None, **kw):
        """Drop-in harness evaluator: raw 322-d SMPL-X motion converted to the
        55-joint rot6d the torch model was trained on, trimmed to a multiple
        of the temporal downsampling (2^layers), the latent's time mean
        [B, latent]."""
        motion = (motion if torch.is_tensor(motion) else
                  torch.from_numpy(np.asarray(motion, np.float32))).to(self.device)
        if motion.shape[-1] != 330:
            motion = smplx322_to_rot6d(motion)
        step = 2 ** self.encoder.num_layers
        T = (motion.shape[1] // step) * step
        return self.map2latent(motion[:, :T] if T else motion).mean(dim=1)
