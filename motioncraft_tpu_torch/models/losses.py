"""Reconstruction losses (PyTorch port of ``MSELoss`` and its reduction
helpers in motioncraft_tpu/models/losses.py)."""

from __future__ import annotations

from typing import Optional

from ..registry import LOSSES


def reduce_loss(loss, reduction: str):
    if reduction == "none":
        return loss
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    raise ValueError(reduction)


def weight_reduce_loss(loss, weight=None, reduction="mean", avg_factor=None):
    if weight is not None:
        loss = loss * weight
    if avg_factor is None:
        return reduce_loss(loss, reduction)
    if reduction == "mean":
        return loss.sum() / avg_factor
    if reduction == "none":
        return loss
    raise ValueError('avg_factor can not be used with reduction="sum"')


@LOSSES.register_module()
class MSELoss:
    """Elementwise MSE with optional weight/avg_factor reduction semantics."""

    def __init__(self, reduction="mean", loss_weight=1.0):
        self.reduction = "none" if reduction is None else reduction
        self.loss_weight = loss_weight

    def __call__(self, pred, target, weight=None, avg_factor=None,
                 reduction_override: Optional[str] = None):
        reduction = reduction_override or self.reduction
        loss = (pred - target) ** 2
        return self.loss_weight * weight_reduce_loss(loss, weight, reduction, avg_factor)
