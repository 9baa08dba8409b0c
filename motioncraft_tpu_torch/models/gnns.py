"""Spatio-temporal GCN over body-part tokens, the PoseEncoder's optional
body graph (PyTorch port of motioncraft_tpu/models/gnns.py).

The graph's adjacency is built on the host (numpy), as there: ``Graph``
stacks the subsets [K, V, V] of a layout (``smpl_parts``: 8 part tokens,
``smpl_joints``: 22 SMPL joints) in the ``spatial``, ``stgcn_spatial`` or
``binary_adj`` mode.  The layers keep the JAX package's channels-last
layout [N, T, V, C] and its module and parameter names:

  - ``UnitGCN``: a Linear ``conv`` to K x C_out channels, the adjacency
    contraction (``adaptive``: the adjacency as a parameter ``A``, plus an
    offset ``PA``, or times an importance ``PA``), BatchNorm ``bn``, the
    residual (``down_conv`` / ``down_bn`` where the width changes), ReLU
  - ``UnitTCN``: flax's Conv of kernel (k, 1) over T, here a Conv2d of
    kernel (1, k) over [N, C, V, T], so that flax's kernel [k, 1, C_in,
    C_out] maps onto torch's [C_out, C_in, 1, k] by reversing its axes
    (utils/convert.py); BatchNorm ``bn`` and dropout
  - ``MSTCN``: dilated branches, a max-pool branch and a 1 x 1 branch
  - ``STGCNBlock`` (gcn -> tcn + residual) and ``STGCN``, the stage stack
    behind a ``data_bn`` over the V x C features

Every BatchNorm is flax's (``blocks.FlaxBatchNorm1d``: momentum 0.99, eps
1e-5, the biased variance): in ``eval()`` it normalises with its running
statistics (the ``batch_stats`` collection, carried by utils/convert.py),
in ``train()`` with the batch's, moving the running statistics towards them,
as flax's ``use_running_average=not train``.  The int8 audit leaves this
stack alone (``/gnn/``, ops/quant.py).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .blocks import FlaxBatchNorm1d, Linear, dropout, promote_dtype

EPS = 1e-4


# --------------------------------------------------------------------- graph
def edge2mat(link, num_node):
    A = np.zeros((num_node, num_node))
    for i, j in link:
        A[j, i] = 1
    return A


def normalize_digraph(A, dim=0):
    Dl = A.sum(dim)
    w = A.shape[1]
    Dn = np.zeros((w, w))
    for i in range(w):
        if Dl[i] > 0:
            Dn[i, i] = Dl[i] ** -1
    return A @ Dn


def get_hop_distance(num_node, edge, max_hop=1):
    A = np.eye(num_node)
    for i, j in edge:
        A[i, j] = 1
        A[j, i] = 1
    hop_dis = np.full((num_node, num_node), np.inf)
    transfer = [np.linalg.matrix_power(A, d) for d in range(max_hop + 1)]
    arrive = np.stack(transfer) > 0
    for d in range(max_hop, -1, -1):
        hop_dis[arrive[d]] = d
    return hop_dis


LAYOUTS = {
    # 8 body-part tokens: head stem larm rarm lleg rleg root body
    "smpl_parts": dict(
        num_node=8,
        inward=[(0, 1), (2, 1), (3, 1), (4, 1), (5, 1), (1, 6)],
        center=6),
    # 22 SMPL body joints
    "smpl_joints": dict(
        num_node=22,
        inward=[(11, 8), (8, 5), (5, 2), (10, 7), (7, 4), (4, 1), (21, 19),
                (19, 17), (17, 14), (20, 18), (18, 16), (16, 13), (15, 12),
                (12, 9), (14, 9), (13, 9), (9, 6), (6, 3), (3, 0), (2, 0), (1, 0)],
        center=0),
}


class Graph:
    """A skeleton layout's stacked adjacency subsets ``A`` [K, V, V]."""

    def __init__(self, layout="smpl_parts", mode="spatial", max_hop=1, **kwargs):
        spec = LAYOUTS[layout]
        self.num_node = spec["num_node"]
        self.inward = spec["inward"]
        self.center = spec["center"]
        self.outward = [(j, i) for i, j in self.inward]
        self.self_link = [(i, i) for i in range(self.num_node)]
        self.max_hop = max_hop
        self.hop_dis = get_hop_distance(self.num_node, self.inward, max_hop)
        self.A = getattr(self, mode)()

    def spatial(self):
        iden = edge2mat(self.self_link, self.num_node)
        inw = normalize_digraph(edge2mat(self.inward, self.num_node))
        outw = normalize_digraph(edge2mat(self.outward, self.num_node))
        return np.stack([iden, inw, outw])

    def stgcn_spatial(self):
        adj = np.zeros((self.num_node, self.num_node))
        adj[self.hop_dis <= self.max_hop] = 1
        norm_adj = normalize_digraph(adj)
        A = []
        for hop in range(self.max_hop + 1):
            close = np.zeros_like(adj)
            further = np.zeros_like(adj)
            for i in range(self.num_node):
                for j in range(self.num_node):
                    if self.hop_dis[j, i] == hop:
                        if self.hop_dis[j, self.center] >= self.hop_dis[i, self.center]:
                            close[j, i] = norm_adj[j, i]
                        else:
                            further[j, i] = norm_adj[j, i]
            A.append(close)
            if hop > 0:
                A.append(further)
        return np.stack(A)

    def binary_adj(self):
        return edge2mat(self.inward + self.outward, self.num_node)[None]


# -------------------------------------------------------------------- layers
class BatchNormLast(FlaxBatchNorm1d):
    """flax's BatchNorm over the last axis of [..., C] (the statistics over
    every other axis)."""

    def forward(self, x):
        shape = x.shape
        return super().forward(x.reshape(-1, shape[-1], 1)).reshape(shape)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` that promotes its input, weight and bias to one dtype,
    as flax's Conv does."""

    def forward(self, x):
        x, w, b = promote_dtype(x, self.weight, self.bias)
        return self._conv_forward(x, w, b)


def temporal_conv(conv: Conv2d, x):
    """flax's Conv of kernel (k, 1) over T of [N, T, V, C], as ``conv``'s
    kernel (1, k) over [N, C, V, T]."""
    return conv(x.permute(0, 3, 2, 1)).permute(0, 3, 2, 1)


class UnitGCN(nn.Module):
    """Graph conv with an adaptive adjacency; x [N, T, V, C]."""

    def __init__(self, in_channels: int, out_channels: int, A: np.ndarray,
                 adaptive: Optional[str] = "importance", conv_pos: str = "pre",
                 with_res: bool = True):
        super().__init__()
        K = A.shape[0]
        self.adaptive, self.conv_pos, self.out_channels = adaptive, conv_pos, out_channels
        A0 = torch.as_tensor(A, dtype=torch.float32)
        self.register_buffer("A0", A0, persistent=False)
        if adaptive == "init":
            self.A = nn.Parameter(A0.clone())
        elif adaptive == "offset":
            self.PA = nn.Parameter(torch.empty_like(A0).uniform_(0.0, 1e-6))
        elif adaptive == "importance":
            self.PA = nn.Parameter(torch.ones_like(A0))
        self.res = with_res and in_channels != out_channels
        self.with_res = with_res
        if self.res:
            self.down_conv = Linear(in_channels, out_channels)
            self.down_bn = BatchNormLast(out_channels)
        self.conv = (Linear(in_channels, out_channels * K) if conv_pos == "pre"
                     else Linear(in_channels * K, out_channels))
        self.bn = BatchNormLast(out_channels)

    def adjacency(self):
        if self.adaptive == "init":
            return self.A
        if self.adaptive == "offset":
            return self.A0 + self.PA
        if self.adaptive == "importance":
            return self.A0 * self.PA
        return self.A0

    def forward(self, x):
        N, T, V, C = x.shape
        A = self.adjacency()
        K = A.shape[0]
        res = 0
        if self.with_res:
            res = self.down_bn(self.down_conv(x)) if self.res else x
        if self.conv_pos == "pre":
            h = self.conv(x).reshape(N, T, V, K, self.out_channels)
            h = torch.einsum("ntvkc,kvw->ntwc", *promote_dtype(h, A))
        else:
            h = torch.einsum("ntvc,kvw->ntwkc", *promote_dtype(x, A)).reshape(N, T, V, K * C)
            h = self.conv(h)
        return F.relu(self.bn(h) + res)


class UnitTCN(nn.Module):
    """Temporal conv over T: kernel (k, 1), stride (s, 1), dilation (d, 1),
    'same' padding, BatchNorm, dropout."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 9,
                 stride: int = 1, dilation: int = 1, dropout: float = 0.0):
        super().__init__()
        pad = (kernel_size + (kernel_size - 1) * (dilation - 1) - 1) // 2
        self.dropout = dropout
        self.conv = Conv2d(in_channels, out_channels, (1, kernel_size), stride=(1, stride),
                           padding=(0, pad), dilation=(1, dilation))
        self.bn = BatchNormLast(out_channels)

    def forward(self, x):
        return dropout(self.bn(temporal_conv(self.conv, x)), self.dropout, self.training)


class MSTCN(nn.Module):
    """Multi-scale temporal conv: dilated branches, a max-pool branch and a
    1 x 1 branch, joined along the channels."""

    def __init__(self, in_channels: int, out_channels: int, stride: int = 1,
                 dilations: Sequence[int] = (1, 2, 3, 4), dropout: float = 0.0):
        super().__init__()
        self.stride, self.dilations, self.dropout = stride, tuple(dilations), dropout
        num_branches = len(self.dilations) + 2
        bc = out_channels // num_branches
        rem = out_channels - bc * (num_branches - 1)
        for i, d in enumerate(self.dilations):
            self.add_module(f"branch_{i}_in", Linear(in_channels, bc))
            self.add_module(f"branch_{i}_tcn", UnitTCN(bc, bc, kernel_size=3, stride=stride,
                                                       dilation=d))
        self.pool_in = Linear(in_channels, bc)
        self.pool_bn = BatchNormLast(bc)
        self.one_by_one = Conv2d(in_channels, rem, (1, 1), stride=(1, stride))
        self.one_bn = BatchNormLast(rem)

    def forward(self, x):
        outs = [getattr(self, f"branch_{i}_tcn")(getattr(self, f"branch_{i}_in")(F.relu(x)))
                for i in range(len(self.dilations))]
        h = self.pool_in(F.relu(x)).permute(0, 3, 1, 2)  # [N, C, T, V]
        h = F.max_pool2d(h, (3, 1), stride=(self.stride, 1), padding=(1, 0))
        outs.append(self.pool_bn(h.permute(0, 2, 3, 1)))
        outs.append(self.one_bn(temporal_conv(self.one_by_one, x)))
        return dropout(torch.cat(outs, dim=-1), self.dropout, self.training)


class STGCNBlock(nn.Module):
    """gcn -> tcn, plus the residual, then ReLU."""

    def __init__(self, in_channels: int, out_channels: int, A: np.ndarray, stride: int = 1,
                 residual: bool = True, tcn_type: str = "unit_tcn",
                 gcn_adaptive: Optional[str] = "importance", tcn_dropout: float = 0.0):
        super().__init__()
        self.residual = None
        self.identity = residual and in_channels == out_channels and stride == 1
        if residual and not self.identity:
            self.residual = UnitTCN(in_channels, out_channels, kernel_size=1, stride=stride)
        self.use_residual = residual
        self.gcn = UnitGCN(in_channels, out_channels, A, adaptive=gcn_adaptive)
        self.tcn = (MSTCN(out_channels, out_channels, stride=stride, dropout=tcn_dropout)
                    if tcn_type == "mstcn" else
                    UnitTCN(out_channels, out_channels, stride=stride, dropout=tcn_dropout))

    def forward(self, x):
        res = 0
        if self.use_residual:
            res = x if self.identity else self.residual(x)
        return F.relu(self.tcn(self.gcn(x)) + res)


class STGCN(nn.Module):
    """The stage stack: x [N, T, V, C] -> [N, T, V, base_channels]."""

    def __init__(self, graph_cfg: dict, in_channels: int = 3, base_channels: int = 64,
                 data_bn_type: str = "VC", ch_ratio: int = 2, num_stages: int = 10,
                 inflate_stages: Sequence[int] = (5, 8), down_stages: Sequence[int] = (5, 8),
                 tcn_type: str = "unit_tcn", gcn_adaptive: Optional[str] = "importance",
                 pretrained: Optional[str] = None):
        super().__init__()
        graph = Graph(**dict(graph_cfg))
        A = graph.A
        self.num_node = graph.num_node
        self.data_bn = (FlaxBatchNorm1d(graph.num_node * in_channels)
                        if data_bn_type in ("VC", "MVC") else None)
        blocks = []
        base, cur_in = base_channels, in_channels
        if cur_in != base:
            blocks.append((base, 1, False))
            cur_in = base
        inflate = 0
        for i in range(2, num_stages):
            if i in inflate_stages:
                inflate += 1
            blocks.append((int(base_channels * ch_ratio ** inflate + EPS), 1, True))
        blocks.append((base_channels, 1, True))
        c_in = in_channels
        self.num_blocks = len(blocks)
        for bi, (oc, stride, residual) in enumerate(blocks):
            self.add_module(f"stage_{bi}", STGCNBlock(
                c_in, oc, A, stride=stride, residual=residual, tcn_type=tcn_type,
                gcn_adaptive=gcn_adaptive))
            c_in = oc

    def forward(self, x):
        N, T, V, C = x.shape
        if self.data_bn is not None:
            flat = self.data_bn(x.permute(0, 2, 3, 1).reshape(N, V * C, T))
            x = flat.reshape(N, V, C, T).permute(0, 3, 1, 2)
        for bi in range(self.num_blocks):
            x = getattr(self, f"stage_{bi}")(x)
        return x
