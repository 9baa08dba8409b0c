"""MotionDiffusion: a denoiser coupled with its test diffusion (PyTorch port
of the sampling side of motioncraft_tpu/models/architecture.py).

Text encoding runs once per batch outside the sampling loop, and so does
every layer's text MoE (``precompute_text_feats``); the loop calls the
denoiser's CFG-doubled test forward once per DDIM step.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

from ..diffusion import build_diffusion, ddim_sample_loop
from ..registry import ARCHITECTURES, build_submodule

# settings of the training half of a config: sampling reads none of them
TRAIN_KEYS = ("loss_recon", "loss_reduction", "diffusion_train", "sampler_type",
              "hand_loss_factor", "face_no_loss", "hand_no_loss", "init_cfg")


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
    """Text-to-motion sampling: ``sample`` turns noise into motion."""

    def __init__(self, model: Optional[dict] = None,
                 diffusion_test: Optional[dict] = None,
                 inference_type: str = "ddpm", device=None,
                 repaint: Optional[dict] = None, **train_cfg):
        super().__init__()
        unknown = sorted(set(train_cfg) - set(TRAIN_KEYS))
        if unknown:
            raise TypeError(f"MotionDiffusion: unknown config keys {unknown}")
        if inference_type not in ("ddim", "gt"):
            raise NotImplementedError(f"inference_type {inference_type!r}")
        if repaint is not None:
            raise NotImplementedError("repaint (windowed outpainting)")
        exact_f32()
        self.device = resolve_device(device)
        self.inference_type = inference_type
        self.train_cfg = train_cfg
        self.model = build_submodule(model) if inference_type != "gt" else None
        self.diffusion_test = (build_diffusion(diffusion_test, device=self.device)
                               if diffusion_test else None)
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

    @torch.no_grad()
    def sample(self, batch: Dict[str, Any], *, generator: Optional[torch.Generator] = None,
               noise: Optional[torch.Tensor] = None,
               inference_type: Optional[str] = None) -> torch.Tensor:
        """Motion [B, T, D] for one batch (numpy arrays or tensors):
        ``motion`` (read for its shape, and returned as it is under
        ``inference_type='gt'``), ``motion_mask``, ``motion_length`` and
        ``text_ids``.  The initial noise is ``noise`` if given, else drawn
        from ``generator``."""
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

        def model_fn(x, t_model):
            return self.model(x, t_model, motion_mask=motion_mask,
                              motion_length=motion_length, xf_out=xf_out,
                              text_feats=text_feats)

        if noise is None:
            noise = torch.randn((B, T, D), generator=generator, device=self.device)
        else:
            noise = self._tensor(noise, torch.float32)
            if noise.shape != (B, T, D):
                raise ValueError(f"noise shape {tuple(noise.shape)} != {(B, T, D)}")
        result = ddim_sample_loop(self.diffusion_test, model_fn, noise, eta=0.0)
        return self.post_process(result.sample)

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
