"""MotionDiffusion: a denoiser coupled with its train and test diffusions
(PyTorch port of motioncraft_tpu/models/architecture.py).

``sample`` (in ``eval()`` mode): text encoding runs once per batch outside
the sampling loop, and so do every layer's text MoE
(``precompute_text_feats``) and a ControlNet's condition encoder
(``encode_condition``, unless the batch brings ``c_enc``); the loop calls the
denoiser's test forward (STMoGen's CFG-doubled one) once per step of the
DDIM loop or, under ``inference_type='ddpm'``, of the ancestral DDPM chain
(the baselines' configs).  The text condition is whatever the denoiser's
``encode_text`` gives: xf_out, (xf_proj, xf_out) with ``use_text_proj``,
or MDM's pooled text; the model's own ``post_process`` runs last.  With an
``outpainting`` mask it is RePaint's harmonized DDIM (``repaint=``), with a
``pre_seq`` the leading frames are seeded from it.  ``compute_dtype=
torch.bfloat16`` runs the denoiser in bf16 on a bf16-cast model
(apis/factory.py:bf16_cast_): its input, the text features and the
condition's encoding are cast to bf16 and its output back to f32; the noise,
the schedule and the DDIM update stay f32.

``loss`` (in ``train()`` mode): timesteps from the schedule sampler, q_sample,
the 90/10 text/unconditional ``cond_type``, the text condition as sampling
takes it (xf_out, the pair (xf_proj, xf_out) split, or MDM's pooled text),
one training forward (with the motion lengths and ``num_intervals`` = 1,
which SAMI reads; a ControlNet's with the batch's condition ``c``), the
masked reconstruction loss (face/hand masking, hand factor, frame or batch
reduction) plus the weighted MoE aux loss (``moe_route_loss``) and the
weighted KL of SAMI's template times (``template_kl_loss``), each summed
over the layers that add to it.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..diffusion import (Outpainting, RepaintConfig, build_diffusion,
                         create_named_schedule_sampler, ddim_sample_loop, generator_randn,
                         p_sample_loop, training_losses)
from ..diffusion.sampling import Randn
from ..diffusion.stepcache import StepCacheConfig
from ..parallel.mesh import draw_rows
from ..registry import ARCHITECTURES, build_loss, build_submodule
from ..utils.dist_utils import all_reduce_sum
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
    """Match the reference's exact f32: no TF32 in matmuls or convolutions;
    and bf16 and f16 products accumulate in f32 throughout, as XLA's do
    (cuBLAS may otherwise reduce split-K partial sums in bf16 or f16)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = False


@ARCHITECTURES.register_module()
class MotionDiffusion(nn.Module):
    """Text-to-motion: ``loss`` trains the denoiser, ``sample`` turns noise
    into motion."""

    mesh = None  # the data mesh of training (parallel/mesh.py:attach_mesh)

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
        if inference_type not in ("ddpm", "ddim", "gt"):
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
    def encode_text(self, text_ids):
        """The denoiser's text condition: xf_out [B, 77, C], (xf_proj,
        xf_out) for a model with ``use_text_proj``, or MDM's pooled text
        [B, clip_dim]."""
        return self.model.encode_text(self._tensor(text_ids, torch.long))

    def loss(self, batch: Dict[str, Any], *, generator: Optional[torch.Generator] = None,
             t: Optional[torch.Tensor] = None, noise: Optional[torch.Tensor] = None,
             cond_type: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Training loss of one batch (``motion`` [B, T, D], ``motion_mask``,
        ``motion_length``, ``text_ids`` and, for a ControlNet, the condition
        ``c``) -> (total, logs).  The timesteps
        ``t`` [B], the ``noise`` and the ``cond_type`` [B, 1, 1] (text on
        where ``cond_type % 10 > 0``: 90 of 100 values) are drawn from
        ``generator`` unless given, and so are the MoE gate noise and the
        dropout masks.  Needs
        ``train()`` mode: the JAX package's loss always runs the training
        forward."""
        if not self.training:
            raise RuntimeError("MotionDiffusion.loss runs the training forward: call .train()")
        motion = self._tensor(batch["motion"], torch.float32)
        motion_mask = self._tensor(batch["motion_mask"], torch.float32)
        B = motion.shape[0]
        mesh, dev = self.mesh, self.device
        t = (draw_rows(mesh, lambda s: self.sampler.sample(s[0], generator, dev)[0], (B,))
             if t is None else self._tensor(t, torch.long))
        noise = (draw_rows(mesh, lambda s: torch.randn(s, generator=generator, device=dev),
                           motion.shape)
                 if noise is None else self._tensor(noise, torch.float32))
        cond_type = (draw_rows(mesh, lambda s: torch.randint(0, 100, s, generator=generator,
                                                             device=dev), (B, 1, 1))
                     if cond_type is None else self._tensor(cond_type))
        # the frozen CLIP runs under no_grad inside; the text layers train
        enc = self.model.encode_text(self._tensor(batch["text_ids"], torch.long),
                                     generator=generator)
        xf_proj, xf_out = enc if isinstance(enc, tuple) else (None, enc)
        motion_length = self._tensor(batch["motion_length"])
        aux_losses, kl_losses = [], []
        # a denoiser with a condition branch (a ControlNet) gets the batch's
        # condition; the others take none, and ignore it in the JAX package
        cond = {}
        if hasattr(self.model, "encode_condition") and batch.get("c") is not None:
            cond["c"] = self._tensor(batch["c"], torch.float32)

        def model_fn(x_t, t_model):
            return self.model(x_t, t_model, motion_mask=motion_mask,
                              motion_length=motion_length, xf_out=xf_out, xf_proj=xf_proj,
                              num_intervals=1, mode="train", cond_type=cond_type,
                              generator=generator, aux_losses=aux_losses,
                              kl_losses=kl_losses, **cond)

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
        # the batch's reductions over the global batch on a data mesh (the
        # MoEs' aux losses are global already)
        if mesh is None:
            recon_frame = recon.sum() / motion_mask.sum().clamp(min=1e-8)
            recon_mean, t_mean = recon_batch.mean(), t.float().mean()
        else:
            recon_frame = (all_reduce_sum(recon.sum(), mesh)
                           / all_reduce_sum(motion_mask.sum(), mesh).clamp(min=1e-8))
            recon_mean = all_reduce_sum(recon_batch.sum(), mesh) / (B * mesh.world)
            with torch.no_grad():
                t_mean = all_reduce_sum(t.float().sum(), mesh) / (B * mesh.world)
            if kl_losses:  # SAMI's template KL is a sum over the rows
                kl_losses = [all_reduce_sum(sum(kl_losses), mesh)]
        logs = {"recon_loss": recon_frame if self.loss_reduction == "frame" else recon_mean}
        for key, terms in (("moe_route_loss", aux_losses), ("template_kl_loss", kl_losses)):
            if terms:
                logs[key] = sum(terms) * self.model.aux_loss_weights().get(key, 1.0)
        total = sum(v for k, v in logs.items() if "loss" in k)
        logs["loss"] = total
        return total, {**logs, "t_mean": t_mean, "recon_loss_batch": recon_batch,
                       "timesteps": t}

    @torch.no_grad()
    def sample(self, batch: Dict[str, Any], *, generator: Optional[torch.Generator] = None,
               noise: Optional[torch.Tensor] = None, randn: Optional[Randn] = None,
               inference_type: Optional[str] = None,
               outpainting: Optional[Outpainting] = None,
               pre_seq: Optional[torch.Tensor] = None,
               compute_dtype: Optional[torch.dtype] = None,
               step_cache: Optional[StepCacheConfig] = None, num_intervals: int = 1,
               extra_model_kwargs: Optional[Dict[str, Any]] = None):
        """Motion [B, T, D] for one batch (numpy arrays or tensors):
        ``motion`` (read for its shape, and returned as it is under
        ``inference_type='gt'``), ``motion_mask``, ``motion_length``,
        ``text_ids`` and, for a ControlNet, the condition ``c`` or its
        encoding ``c_enc``.  Every standard-normal draw (the initial noise
        unless ``noise`` is given, then the loop's) comes from ``randn(shape)``
        if given, else from ``generator``.  With ``outpainting`` and a
        ``repaint`` config that keeps the noisy tails (same_overlap_noisy),
        returns (motion, noisy_tail).  ``compute_dtype`` (default f32) is
        the denoiser's dtype and must be the model's: bf16 needs
        ``bf16_cast_`` first.  ``step_cache`` turns on layer-residual reuse;
        with ``collect_errors`` it returns (motion, errors [steps, layers]
        as a host numpy array).  ``num_intervals`` reaches every denoiser
        call: FineMoGen's SAMI reads each run of that many rows as one
        sequence of intervals; the other families ignore it.
        ``extra_model_kwargs`` reach every denoiser call as they are, their
        arrays on the model's device (ReMoDiffuse's ``re_dict``, from
        ``model.encode_retrieval``).  Needs ``eval()`` mode, the inference
        path."""
        if self.training:
            raise RuntimeError("MotionDiffusion.sample runs the inference path: call .eval()")
        motion = self._tensor(batch["motion"], torch.float32)
        B, T, D = motion.shape
        inference_type = inference_type or self.inference_type
        if inference_type == "gt":
            return motion
        if step_cache is not None:
            self._check_step_cache(step_cache, inference_type, outpainting)
        if inference_type == "ddpm" and outpainting is not None:
            raise ValueError("outpainting runs the DDIM loops: inference_type='ddim'")
        dtype = compute_dtype or torch.float32
        # the stack's dtype (bf16_cast_ keeps the modules that flax promotes
        # in f32)
        wdtype = getattr(self.model, "base_model", self.model).stack_dtype()
        if wdtype != dtype:
            raise ValueError(f"sample(compute_dtype={dtype}) on a model in {wdtype}: "
                             "cast the model first (apis.bf16_cast_ for bf16)")
        motion_mask = self._tensor(batch["motion_mask"], torch.float32)
        motion_length = self._tensor(batch["motion_length"])
        enc = self.encode_text(batch["text_ids"])
        xf_proj, xf_out = enc if isinstance(enc, tuple) else (None, enc)
        kw = {"motion_mask": motion_mask, "motion_length": motion_length,
              "xf_out": xf_out.to(dtype), "num_intervals": num_intervals}
        if xf_proj is not None:
            kw["xf_proj"] = xf_proj.to(dtype)
        if hasattr(self.model, "precompute_text_feats"):
            kw["text_feats"] = self.model.precompute_text_feats(kw["xf_out"])
        for name, value in (extra_model_kwargs or {}).items():
            kw[name] = ({k: self._tensor(v) for k, v in value.items()}
                        if isinstance(value, dict) else value)
        if hasattr(self.model, "encode_condition"):
            if batch.get("c_enc") is not None:
                kw["c_enc"] = self._tensor(batch["c_enc"], dtype)
            elif batch.get("c") is not None:
                kw["c_enc"] = self.model.encode_condition(
                    self._tensor(batch["c"], torch.float32), T).to(dtype)

        def model_fn(x, t_model, cache=None, flags=None):
            if cache is None:
                return self.model(x.to(dtype), t_model, **kw).float()
            out, new_cache = self.model(x.to(dtype), t_model, step_cache=cache,
                                        cache_flags=flags, **kw)
            return out.float(), new_cache

        randn = randn or generator_randn(generator, self.device)
        if noise is None:
            noise = randn((B, T, D))
        else:
            noise = self._tensor(noise, torch.float32)
            if noise.shape != (B, T, D):
                raise ValueError(f"noise shape {tuple(noise.shape)} != {(B, T, D)}")
        pre_seq = None if pre_seq is None else self._tensor(pre_seq, torch.float32)
        if inference_type == "ddpm":
            result = p_sample_loop(self.diffusion_test, model_fn, noise, randn=randn,
                                   pre_seq=pre_seq)
        else:
            result = ddim_sample_loop(
                self.diffusion_test, model_fn, noise, eta=0.0, randn=randn, pre_seq=pre_seq,
                outpainting=outpainting, repaint=self.repaint_cfg,
                step_cache0=(None if step_cache is None
                             else self.model.make_step_cache(B, T, dtype)),
                cache_cfg=step_cache)
        out = self.post_process(result.sample)
        if result.cache_errors is not None:
            return out, result.cache_errors.cpu().numpy()  # the one copy of the errors
        return out if result.noisy_tail is None else (out, result.noisy_tail)

    def _check_step_cache(self, step_cache, inference_type, outpainting):
        """The step cache's guards, as the JAX package's sample has them."""
        if inference_type != "ddim":
            raise ValueError("step caching requires inference_type='ddim'")
        if (step_cache.collect_errors and outpainting is not None
                and self.repaint_cfg is not None and self.repaint_cfg.same_overlap_noisy):
            # both results would take the second slot of the return value
            raise ValueError(
                "collect_errors cannot be combined with a tail-tracking repaint "
                "config (same_overlap_noisy): the calibration errors would replace "
                "the noisy_tail return; calibrate on a plain run instead")
        if not getattr(self.model, "supports_step_cache", False):
            raise ValueError(f"{type(self.model).__name__} does not support step caching")

    def post_process(self, motion: torch.Tensor) -> torch.Tensor:
        """De-normalize when the model config asks for unnormalized inference;
        then the model's own post-processing, where it has one (MDM's
        official-checkpoint root rescale)."""
        if self.post is not None:
            mean, std = self.post
            motion = motion * std + mean
        pp = getattr(self.model, "post_process", None)
        return motion if pp is None else pp(motion)

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
