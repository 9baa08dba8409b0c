"""Canonical model configs and batch factories (copies of the config functions
of motioncraft_tpu/apis/factory.py, plus a seeded synthetic training batch).

``flagship_m2d_cfg`` is the music-to-dance ControlNet over that base.

``flagship_t2m_cfg`` is the 0.125B STMoGen T2M config
(configs/stmogen/t2m_motionx_0_125b.py): 4 layers, 12 heads x 128, MoE with
16 experts top-2 cosine gate, CLIP ViT-B/32 text tower, DDIM-50
('15,15,8,6,6') eval sampler, CFG scale 6.5.
"""

from __future__ import annotations

import copy
from typing import Optional

import numpy as np
import torch

from ..models.tokenizer import tokenize


def flagship_t2m_cfg(*, num_layers: int = 4, latent_dim: int = 128, num_heads: int = 12,
                     max_seq_len: int = 196, input_feats: int = 322,
                     text_latent_dim: int = 256, ff_size: int = 512,
                     time_embed_dim: int = 2048, num_experts: int = 16,
                     clip_width: int = 512, clip_layers: int = 12,
                     respace: str = "15,15,8,6,6", expert_axis: Optional[str] = None,
                     dropout: float = 0.0) -> dict:
    return dict(
        type="MotionDiffusion",
        model=dict(
            type="STMoGenTransformer",
            input_feats=input_feats,
            max_seq_len=max_seq_len,
            latent_dim=latent_dim * num_heads,
            time_embed_dim=time_embed_dim,
            num_layers=num_layers,
            ca_block_cfg=dict(type="STMA", latent_dim=latent_dim,
                              text_latent_dim=text_latent_dim, num_heads=num_heads,
                              num_text_heads=1, num_experts=num_experts, topk=2,
                              gate_type="cosine_top", gate_noise=1.0, ffn_dim=ff_size,
                              time_embed_dim=time_embed_dim, max_seq_len=max_seq_len,
                              max_text_seq_len=77, temporal_comb=False,
                              dropout=dropout, dynamic_body=True,
                              expert_axis=expert_axis),
            ffn_cfg=dict(latent_dim=latent_dim, ffn_dim=ff_size, dropout=dropout,
                         time_embed_dim=time_embed_dim, num_heads=num_heads),
            text_encoder=dict(pretrained_model="clip", latent_dim=text_latent_dim,
                              num_layers=2, ff_size=2048, dropout=dropout,
                              use_text_proj=False, clip_width=clip_width,
                              clip_layers=clip_layers),
            pose_encoder_cfg=dict(dataset_name="motionx", latent_dim=latent_dim,
                                  input_dim=input_feats),
            pose_decoder_cfg=dict(dataset_name="motionx", latent_dim=latent_dim,
                                  output_dim=input_feats),
            scale_func_cfg=dict(scale=6.5),
            moe_route_loss_weight=10.0,
            template_kl_loss_weight=0.0001,
            use_pos_embedding=True,
        ),
        loss_recon=dict(type="MSELoss", loss_weight=1, reduction="none"),
        face_no_loss=True,
        diffusion_train=dict(beta_scheduler="linear", diffusion_steps=1000,
                             model_mean_type="start_x", model_var_type="fixed_large"),
        diffusion_test=dict(beta_scheduler="linear", diffusion_steps=1000,
                            model_mean_type="start_x", model_var_type="fixed_large",
                            respace=respace),
        inference_type="ddim",
        loss_reduction="batch",
    )


def tiny_t2m_cfg(expert_axis: Optional[str] = None, max_seq_len: int = 16) -> dict:
    """Scaled-down flagship for tests (same topology, tiny dims)."""
    return flagship_t2m_cfg(num_layers=2, latent_dim=8, max_seq_len=max_seq_len,
                            text_latent_dim=16, ff_size=16, time_embed_dim=32,
                            clip_width=32, clip_layers=1, respace="4",
                            expert_axis=expert_axis)


def build_flagship(cfg: Optional[dict] = None, device=None,
                   expert_axis: Optional[str] = None):
    """The MotionDiffusion of ``cfg`` (default the flagship's) on
    ``device`` (default the card).  ``expert_axis`` (set into a copy of
    ``cfg``'s ``ca_block_cfg``) shards its MoEs' experts over that mesh
    axis and routes inference through the slot path, as the JAX
    package's ``flagship_t2m_cfg(expert_axis=)`` does."""
    from ..registry import build_architecture

    cfg = copy.deepcopy(cfg or flagship_t2m_cfg())
    if expert_axis is not None:
        cfg["model"]["ca_block_cfg"]["expert_axis"] = expert_axis
    return build_architecture(cfg, device=device)


def flagship_m2d_cfg(window: int = 120, **kw) -> dict:
    """Flagship M2D: the ControlNet branch (2 copied blocks) over the 0.125B
    base at 120-frame windows, conditioned on raw 163-d music features with
    no pre-encoder, RePaint over a 30-frame overlap
    (configs/stmogen/m2d_finedance_0125b.py schema)."""
    cfg = flagship_t2m_cfg(max_seq_len=window, **kw)
    cfg["model"] = dict(
        type="ControlT2MHalf", base_model=cfg["model"], copy_blocks_num=2,
        control_cond_feats=163,
        condition_encode_cfg=dict(dataset_name="nothing", condition_pre_encode=False,
                                  condition_pre_encode_type="nothing",
                                  control_cond_feats=163, condition_cfg=True))
    cfg["repaint"] = dict(overlap_len=30, add_blend=True, same_overlap_noisy=False,
                          jump_length=3, jump_n_sample=2)
    return cfg


# submodules that flax runs in f32 under bf16 weights: an f32 input meets
# them and promotes the call (the time MLP, each MoE gate's projector, the
# ControlNet's condition encoder)
PROMOTED_MODULES = ("time_embed", "cosine_projector", "condition_pre_encoder",
                    "control_cond_input")


def bf16_cast_(arch):
    """Round every floating parameter and buffer of ``arch``'s model to bf16,
    in place (the JAX package's ``bf16_cast_variables`` casts every floating
    leaf); returns ``arch``.  The ``PROMOTED_MODULES`` keep f32 tensors
    holding the bf16-rounded values, the numbers flax computes with when it
    promotes their calls; everything else is bf16.  Sample with
    ``compute_dtype=torch.bfloat16``: the noise, the schedule and the DDIM
    update stay f32."""
    if arch.model is not None:
        arch.model.to(torch.bfloat16)
        for name, module in arch.model.named_modules():
            if name.rpartition(".")[2] in PROMOTED_MODULES:
                module.to(torch.float32)
    return arch


def int8_quantize_(arch, weight_only: bool = False, **kwargs):
    """Rewrite the audited denoiser weights of ``arch``'s model to int8 in
    place (ops/quant.py:quantize_; W8A8 dynamic, or W8 with
    ``weight_only``); returns ``arch``.  Apply after loading the weights and
    after ``bf16_cast_``, as the JAX package's int8_quantize_variables: the
    scales stay f32, and the modules that ``bf16_cast_`` keeps in f32 (the
    time MLP, ``PROMOTED_MODULES``) quantize their f32 activations.
    Inference only."""
    from ..ops.quant import quantize_
    if arch.model is not None:
        quantize_(arch.model, weight_only=weight_only, **kwargs)
    return arch


def make_text_batch(texts, max_seq_len: int = 196, input_feats: int = 322,
                    motion: Optional[np.ndarray] = None,
                    lengths: Optional[np.ndarray] = None) -> dict:
    """One request batch as numpy arrays: zero motion (only its shape is
    read by sampling), the frame mask from ``lengths`` and CLIP token ids."""
    B = len(texts)
    if motion is None:
        motion = np.zeros((B, max_seq_len, input_feats), np.float32)
    if lengths is None:
        lengths = np.full((B, 1), max_seq_len, np.int32)
    mask = (np.arange(max_seq_len)[None, :] < lengths).astype(np.float32)
    return {
        "motion": np.asarray(motion, np.float32),
        "motion_mask": mask,
        "motion_length": np.asarray(lengths, np.int32),
        "text_ids": tokenize(list(texts)),
    }


_VERBS = ("walks", "jumps", "waves", "dances", "kicks", "turns", "sits down",
          "runs in a circle", "crouches", "claps")


def make_train_batch(batch_size: int, *, seed: int = 0, max_seq_len: int = 196,
                     input_feats: int = 322) -> dict:
    """A seeded synthetic training batch (numpy): normalized motion (N(0, 1)
    per feature, zero past each clip's length), lengths in [40, max_seq_len]
    (MotionX clips are 40-196 frames), the frame mask and CLIP token ids of
    short descriptions.  It stands in for a dataset until one is in the
    repository; it teaches the model nothing about motion."""
    rng = np.random.RandomState(seed)
    lengths = rng.randint(min(40, max_seq_len), max_seq_len + 1,
                          (batch_size, 1)).astype(np.int32)
    mask = np.arange(max_seq_len)[None, :] < lengths
    motion = rng.randn(batch_size, max_seq_len, input_feats).astype(np.float32)
    motion *= mask[..., None]
    texts = [f"a person {_VERBS[a]} then {_VERBS[b]}"
             for a, b in rng.randint(0, len(_VERBS), (batch_size, 2))]
    return make_text_batch(texts, max_seq_len, input_feats, motion=motion, lengths=lengths)
