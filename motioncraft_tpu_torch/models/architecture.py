"""MotionDiffusion: a denoiser coupled with its train and test diffusions
(PyTorch port of motioncraft_tpu/models/architecture.py).

``sample`` (in ``eval()`` mode): text encoding runs once per batch outside
the sampling loop, and so do every layer's text MoE
(``precompute_text_feats``) and a ControlNet's condition encoder
(``encode_condition``, unless the batch brings ``c_enc``); the loop calls the
denoiser's CFG-doubled test forward once per DDIM step.  With an
``outpainting`` mask it is RePaint's harmonized DDIM (``repaint=``), with a
``pre_seq`` the leading frames are seeded from it.

``loss`` (in ``train()`` mode): timesteps from the schedule sampler, q_sample,
the 90/10 text/unconditional ``cond_type``, one training forward, the masked
reconstruction loss (face/hand masking, hand factor, frame or batch
reduction) plus the weighted MoE aux loss.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..diffusion import (Outpainting, RepaintConfig, build_diffusion,
                         create_named_schedule_sampler, ddim_sample_loop, generator_randn,
                         training_losses)
from ..diffusion.sampling import Randn
from ..registry import ARCHITECTURES, build_loss, build_submodule
from .body_layout import SMPLX_FACE_DIMS, SMPLX_HAND_DIMS


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller asks
    for another.  Without a card and without an explicit device, raise."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                               "plain PyTorch versions of the kernels on the CPU")
        device = "cuda"
    return torch.device(device)


def exact_f32() -> None:
    """Match the reference's exact f32: no TF32 in matmuls or convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@ARCHITECTURES.register_module()
class MotionDiffusion(nn.Module):
    """Text-to-motion: ``loss`` trains the denoiser, ``sample`` turns noise
    into motion."""

    def __init__(self, model: Optional[dict] = None,
                 loss_recon: Optional[dict] = None,
                 loss_reduction: str = "frame",
                 diffusion_train: Optional[dict] = None,
                 diffusion_test: Optional[dict] = None,
                 sampler_type: str = "uniform",
                 init_cfg: Optional[dict] = None,
                 inference_type: str = "ddpm", device=None,
                 hand_loss_factor: float = 1.0,
                 face_no_loss: bool = False,
                 hand_no_loss: bool = False,
                 repaint: Optional[dict] = None):
        super().__init__()
        if inference_type not in ("ddim", "gt"):
            raise NotImplementedError(f"inference_type {inference_type!r}")
        exact_f32()
        self.device = resolve_device(device)
        self.inference_type = inference_type
        self.loss_reduction = loss_reduction
        self.hand_loss_factor = hand_loss_factor
        self.face_no_loss, self.hand_no_loss = face_no_loss, hand_no_loss
        self.repaint_cfg = RepaintConfig(**repaint) if isinstance(repaint, dict) else repaint
        self.model = build_submodule(model) if inference_type != "gt" else None
        self.loss_recon = build_loss(loss_recon) if loss_recon else None
        self.diffusion_train = (build_diffusion(diffusion_train, device=self.device)
                                if diffusion_train else None)
        self.diffusion_test = (build_diffusion(diffusion_test, device=self.device)
                               if diffusion_test else None)
        self.sampler = (create_named_schedule_sampler(sampler_type,
                                                      self.diffusion_train.num_timesteps)
                        if self.diffusion_train is not None else None)
        post = (model or {}).get("post_process_cfg") or {}
        self.post = None
        if post.get("unnormalized_infer", False):
            self.post = tuple(torch.as_tensor(np.load(post[k]).astype(np.float32),
                                              device=self.device)
                              for k in ("mean_path", "std_path"))
        self.to(self.device)
        self.eval()

    def _tensor(self, a, dtype=None) -> torch.Tensor:
        t = a if torch.is_tensor(a) else torch.from_numpy(np.asarray(a))
        return t.to(device=self.device, dtype=dtype)

    @torch.no_grad()
    def encode_text(self, text_ids) -> torch.Tensor:
        return self.model.encode_text(self._tensor(text_ids, torch.long))

    def loss(self, batch: Dict[str, Any], *, generator: Optional[torch.Generator] = None,
             t: Optional[torch.Tensor] = None, noise: Optional[torch.Tensor] = None,
             cond_type: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Training loss of one batch (``motion`` [B, T, D], ``motion_mask``,
        ``motion_length``, ``text_ids``) -> (total, logs).  The timesteps
        ``t`` [B], the ``noise`` and the ``cond_type`` [B, 1, 1] (text on
        where ``cond_type % 10 > 0``: 90 of 100 values) are drawn from
        ``generator`` unless given, and so is the MoE gate noise.  Needs
        ``train()`` mode: the JAX package's loss always runs the training
        forward."""
        if not self.training:
            raise RuntimeError("MotionDiffusion.loss runs the training forward: call .train()")
        motion = self._tensor(batch["motion"], torch.float32)
        motion_mask = self._tensor(batch["motion_mask"], torch.float32)
        B = motion.shape[0]
        t = (self.sampler.sample(B, generator, self.device)[0] if t is None
             else self._tensor(t, torch.long))
        noise = (torch.randn(motion.shape, generator=generator, device=self.device)
                 if noise is None else self._tensor(noise, torch.float32))
        cond_type = (torch.randint(0, 100, (B, 1, 1), generator=generator, device=self.device)
                     if cond_type is None else self._tensor(cond_type))
        # the frozen CLIP runs under no_grad inside; the two text layers train
        xf_out = self.model.encode_text(self._tensor(batch["text_ids"], torch.long))
        aux_losses = []

        def model_fn(x_t, t_model):
            return self.model(x_t, t_model, motion_mask=motion_mask, xf_out=xf_out,
                              mode="train", cond_type=cond_type, generator=generator,
                              aux_losses=aux_losses)

        out = training_losses(self.diffusion_train, model_fn, motion, t, noise)
        pred, target = out["pred"], out["target"]
        D = pred.shape[-1]
        for drop, (lo, hi) in ((self.face_no_loss, SMPLX_FACE_DIMS),
                               (self.hand_no_loss, SMPLX_HAND_DIMS)):
            if drop and D == 322:
                keep = torch.ones(D, device=pred.device)
                keep[lo:hi] = 0
                pred, target = pred * keep, target * keep
        recon = self.loss_recon(pred, target, reduction_override="none")
        if self.hand_loss_factor > 1.0 and D == 322:
            scale = torch.ones(D, device=pred.device)
            scale[SMPLX_HAND_DIMS[0]:SMPLX_HAND_DIMS[1]] = self.hand_loss_factor
            recon = recon * scale
        recon = recon.mean(dim=-1) * motion_mask
        recon_batch = recon.sum(dim=1) / motion_mask.sum(dim=1).clamp(min=1e-8)
        recon_frame = recon.sum() / motion_mask.sum().clamp(min=1e-8)
        logs = {"recon_loss": recon_frame if self.loss_reduction == "frame"
                else recon_batch.mean()}
        if aux_losses:
            weights = self.model.aux_loss_weights()
            logs["moe_route_loss"] = sum(aux_losses) * weights.get("moe_route_loss", 1.0)
        total = sum(v for k, v in logs.items() if "loss" in k)
        logs["loss"] = total
        return total, {**logs, "t_mean": t.float().mean(), "recon_loss_batch": recon_batch,
                       "timesteps": t}

    @torch.no_grad()
    def sample(self, batch: Dict[str, Any], *, generator: Optional[torch.Generator] = None,
               noise: Optional[torch.Tensor] = None, randn: Optional[Randn] = None,
               inference_type: Optional[str] = None,
               outpainting: Optional[Outpainting] = None,
               pre_seq: Optional[torch.Tensor] = None):
        """Motion [B, T, D] for one batch (numpy arrays or tensors):
        ``motion`` (read for its shape, and returned as it is under
        ``inference_type='gt'``), ``motion_mask``, ``motion_length``,
        ``text_ids`` and, for a ControlNet, the condition ``c`` or its
        encoding ``c_enc``.  Every standard-normal draw (the initial noise
        unless ``noise`` is given, then the loop's) comes from ``randn(shape)``
        if given, else from ``generator``.  With ``outpainting`` and a
        ``repaint`` config that keeps the noisy tails (same_overlap_noisy),
        returns (motion, noisy_tail).  Needs ``eval()`` mode, the inference
        path."""
        if self.training:
            raise RuntimeError("MotionDiffusion.sample runs the inference path: call .eval()")
        motion = self._tensor(batch["motion"], torch.float32)
        B, T, D = motion.shape
        inference_type = inference_type or self.inference_type
        if inference_type == "gt":
            return motion
        if inference_type != "ddim":
            raise NotImplementedError(f"inference_type {inference_type!r}")
        motion_mask = self._tensor(batch["motion_mask"], torch.float32)
        motion_length = self._tensor(batch["motion_length"])
        xf_out = self.encode_text(batch["text_ids"])
        text_feats = self.model.precompute_text_feats(xf_out)
        cond = {}
        if hasattr(self.model, "encode_condition"):
            if batch.get("c_enc") is not None:
                cond["c_enc"] = self._tensor(batch["c_enc"], torch.float32)
            elif batch.get("c") is not None:
                cond["c_enc"] = self.model.encode_condition(
                    self._tensor(batch["c"], torch.float32), T)

        def model_fn(x, t_model):
            return self.model(x, t_model, motion_mask=motion_mask,
                              motion_length=motion_length, xf_out=xf_out,
                              text_feats=text_feats, **cond)

        randn = randn or generator_randn(generator, self.device)
        if noise is None:
            noise = randn((B, T, D))
        else:
            noise = self._tensor(noise, torch.float32)
            if noise.shape != (B, T, D):
                raise ValueError(f"noise shape {tuple(noise.shape)} != {(B, T, D)}")
        result = ddim_sample_loop(
            self.diffusion_test, model_fn, noise, eta=0.0, randn=randn,
            pre_seq=None if pre_seq is None else self._tensor(pre_seq, torch.float32),
            outpainting=outpainting, repaint=self.repaint_cfg)
        out = self.post_process(result.sample)
        return out if result.noisy_tail is None else (out, result.noisy_tail)

    def post_process(self, motion: torch.Tensor) -> torch.Tensor:
        """De-normalize when the model config asks for unnormalized inference."""
        if self.post is not None:
            mean, std = self.post
            motion = motion * std + mean
        return motion

    @staticmethod
    def split_results(results: Dict[str, Any]):
        """Batched results -> list of per-sample host dicts."""
        def to_host(x):
            return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)

        out = []
        for i in range(results["motion"].shape[0]):
            item = {k: to_host(results[k][i])
                    for k in ("motion", "pred_motion", "motion_length", "motion_mask")}
            item["pred_motion_length"] = to_host(
                results.get("pred_motion_length", results["motion_length"])[i])
            item["pred_motion_mask"] = to_host(
                results.get("pred_motion_mask", results["motion_mask"])[i])
            metas = results.get("motion_metas")
            if metas is not None:
                for key in ("text", "token"):
                    if key in metas[i]:
                        item[key] = metas[i][key]
            out.append(item)
        return out
