"""Losses (PyTorch port of motioncraft_tpu/models/losses.py): ``MSELoss``
and its reduction helpers, ``MSELossWithGMOF`` (the Geman-McClure robust
error of the squared error) and the functional ``GANLoss`` (vanilla, lsgan,
wgan, hinge)."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

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


def gmof(x, sigma):
    """Geman-McClure robust error."""
    x2, s2 = x ** 2, sigma ** 2
    return (s2 * x2) / (s2 + x2)


@LOSSES.register_module()
class MSELossWithGMOF(MSELoss):
    """MSELoss with the squared error passed through ``gmof``."""

    def __init__(self, reduction="mean", loss_weight=1.0, sigma=1.0):
        super().__init__(reduction, loss_weight)
        self.sigma = sigma

    def __call__(self, pred, target, weight=None, avg_factor=None,
                 reduction_override: Optional[str] = None):
        reduction = reduction_override or self.reduction
        loss = gmof((pred - target) ** 2, self.sigma)
        return self.loss_weight * weight_reduce_loss(loss, weight, reduction, avg_factor)


@LOSSES.register_module()
class GANLoss:
    """vanilla (BCE with logits) / lsgan / wgan / hinge GAN losses; the
    discriminator's (``is_disc``) unweighted."""

    def __init__(self, gan_type, real_label_val=1.0, fake_label_val=0.0, loss_weight=1.0):
        if gan_type not in ("vanilla", "lsgan", "wgan", "hinge"):
            raise NotImplementedError(f"GAN type {gan_type} is not implemented.")
        self.gan_type = gan_type
        self.real_label_val = real_label_val
        self.fake_label_val = fake_label_val
        self.loss_weight = loss_weight

    def __call__(self, x, target_is_real: bool, is_disc: bool = False):
        if self.gan_type == "wgan":
            loss = -x.mean() if target_is_real else x.mean()
        elif self.gan_type == "hinge":
            if is_disc:
                loss = F.relu(1 + (-x if target_is_real else x)).mean()
            else:
                loss = -x.mean()
        else:
            target = torch.full_like(x, self.real_label_val if target_is_real
                                     else self.fake_label_val)
            if self.gan_type == "vanilla":
                loss = torch.mean(x.clamp(min=0) - x * target + torch.log1p(torch.exp(-x.abs())))
            else:  # lsgan
                loss = torch.mean((x - target) ** 2)
        return loss if is_disc else loss * self.loss_weight
