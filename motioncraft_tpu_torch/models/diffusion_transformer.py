"""Shared denoiser skeleton (PyTorch port of
motioncraft_tpu/models/diffusion_transformer.py).

Joint embedding, learned sequence position embedding, sinusoidal timestep
embedding -> SiLU MLP, CLIP text conditioning, a stack of decoder blocks and
a zero-init output.  Subclasses provide the joint embedding and output
(``joint_embed``, ``out``), ``forward_train`` and ``forward_test``.

The stack runs in the dtype of the joint embedding's output (bf16 for a
bf16-cast model on bf16 motion): the timestep embedding is f32, its MLP
runs in f32 as flax promotes it (bf16_cast_ keeps its tensors f32), and the
embedding is then cast to the stack's dtype.  The 0/1 frame mask stays f32:
at inference only K3 reads it, and K3 takes it in f32.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .blocks import timestep_embedding
from .text_encoder import TextEncoder


class DiffusionTransformerBase(nn.Module):
    def __init__(self, input_feats: int = 263, max_seq_len: int = 240,
                 latent_dim: int = 512, time_embed_dim: int = 2048,
                 num_layers: int = 8, text_encoder: Optional[dict] = None,
                 use_pos_embedding: bool = True):
        super().__init__()
        self.input_feats, self.max_seq_len = input_feats, max_seq_len
        self.latent_dim, self.time_embed_dim = latent_dim, time_embed_dim
        self.num_layers = num_layers
        te = dict(text_encoder or {})
        te.pop("pretrained_model", None)
        self.text_enc = TextEncoder(
            latent_dim=te.get("latent_dim", 256), num_layers=te.get("num_layers", 2),
            ff_size=te.get("ff_size", 2048), num_heads=te.get("num_heads", 4),
            dropout=te.get("dropout", 0.0), activation=te.get("activation", "gelu"),
            use_text_proj=te.get("use_text_proj", False), time_embed_dim=time_embed_dim,
            clip_width=te.get("clip_width", 512), clip_layers=te.get("clip_layers", 12))
        self.use_pos_embedding = use_pos_embedding
        if use_pos_embedding:
            self.sequence_embedding = nn.Parameter(torch.randn(max_seq_len, latent_dim))
        self.time_embed = nn.Sequential(nn.Linear(latent_dim, time_embed_dim), nn.SiLU(),
                                        nn.Linear(time_embed_dim, time_embed_dim))

    def encode_text(self, text_ids):
        return self.text_enc(text_ids)

    def _embed(self, motion, timesteps):
        T = motion.shape[1]
        emb = self.time_embed(timestep_embedding(timesteps, self.latent_dim))
        h = self.joint_embed(motion)
        if self.use_pos_embedding:
            h = h + self.sequence_embedding[None, :T, :]
        return h, emb

    def forward(self, motion, timesteps, motion_mask=None, motion_length=None,
                xf_out=None, text_feats=None, *, mode: str = "test", cond_type=None,
                generator=None, aux_losses=None, step_cache=None, cache_flags=None):
        """``motion`` [B, T, D] at original-scale ``timesteps`` [B] -> model
        output [B, T, D].  ``mode="test"``: the CFG-guided test forward.
        ``mode="train"``: one pass at ``cond_type`` [B, 1, 1] (text on where
        ``cond_type % 10 > 0``), the MoE gate noise drawn from ``generator``
        and their aux losses appended to ``aux_losses``.  With a
        ``step_cache`` and the step's host ``cache_flags`` (test mode),
        returns (output, new cache)."""
        src_mask = motion_mask[..., None] if motion_mask.dim() == 2 else motion_mask
        h, emb = self._embed(motion, timesteps)
        emb = emb.to(h.dtype)
        if mode == "train":
            return self.forward_train(h=h, src_mask=src_mask, emb=emb, xf_out=xf_out,
                                      cond_type=cond_type, generator=generator,
                                      aux_losses=aux_losses)
        if mode != "test":
            raise ValueError(f"mode {mode!r}")
        return self.forward_test(h=h, src_mask=src_mask, emb=emb,
                                 xf_out=xf_out, motion_length=motion_length,
                                 timesteps=timesteps, text_feats=text_feats,
                                 step_cache=step_cache, cache_flags=cache_flags)
