"""Shared denoiser skeleton (PyTorch port of the sampling side of
motioncraft_tpu/models/diffusion_transformer.py).

Joint embedding, learned sequence position embedding, sinusoidal timestep
embedding -> SiLU MLP, CLIP text conditioning, a stack of decoder blocks and
a zero-init output.  Subclasses provide ``build_io``, ``build_blocks`` and
``forward_test``.
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
                xf_out=None, text_feats=None):
        """The CFG test forward: ``motion`` [B, T, D] at original-scale
        ``timesteps`` [B] -> guided model output [B, T, D]."""
        src_mask = motion_mask[..., None] if motion_mask.dim() == 2 else motion_mask
        h, emb = self._embed(motion, timesteps)
        return self.forward_test(h=h, src_mask=src_mask.to(h.dtype), emb=emb,
                                 xf_out=xf_out, motion_length=motion_length,
                                 timesteps=timesteps, text_feats=text_feats)
