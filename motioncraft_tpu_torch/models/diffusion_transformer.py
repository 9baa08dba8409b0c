"""Shared denoiser skeleton (PyTorch port of
motioncraft_tpu/models/diffusion_transformer.py).

Joint embedding, learned sequence position embedding, sinusoidal timestep
embedding -> SiLU MLP, CLIP text conditioning (with ``use_text_proj`` the
pooled text projection added to the time embedding), a stack of decoder
blocks and a zero-init output.  ``setup_io`` (a Linear joint embedding and a
zero-init Linear output) and ``build_temporal_blocks`` (``block_{i}``
GenericDecoderLayers: sa -> ca -> FFN) build the generic families' stack
(models/baselines.py), whose test forward is ``forward_test`` below and
whose training forward, ``forward_train``, is one pass of the same stack at
the batch's ``cond_type``; STMoGen builds its own (models/stmogen.py) and
overrides the forwards.

``remat`` (the JAX package's field) rematerializes each decoder layer of
the training forward in the backward pass (``call_layer``:
``torch.utils.checkpoint``), as ``nn.remat`` wraps STMoGen's layers: the
STMoGen stacks and a ControlNet's base blocks read it, the generic stack
ignores it, as in the JAX package.  The recompute replays the layer's draws
from the step's generator (MoE gate noise) by restoring that generator's
state, and the layer's aux and KL losses come out of the checkpointed
function, so the recompute adds none: the loss and every gradient equal
those without remat.

The stack runs in the dtype of the joint embedding's output (bf16 for a
bf16-cast model on bf16 motion): the timestep embedding is f32, its MLP
runs in f32 as flax promotes it (bf16_cast_ keeps its tensors f32), and the
embedding and the 0/1 frame mask are then cast to the stack's dtype, as the
JAX package's ``__call__`` casts them, so that a masked key stays bf16 (K3
takes the mask widened back to f32, exact for 0 and 1).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.utils.checkpoint
from torch import nn

from ..registry import ATTENTIONS
from .blocks import FFN, Linear, ZeroDense, timestep_embedding
from .text_encoder import TextEncoder


def ffn_from_cfg(ffn_cfg: Optional[dict]) -> Optional[nn.Module]:
    """The FFN of a layer config (its ``num_heads``, which the STMoGen
    configs carry, is not the FFN's), or None."""
    if ffn_cfg is None:
        return None
    return FFN(**{k: v for k, v in dict(ffn_cfg).items() if k != "num_heads"})


class GenericDecoderLayer(nn.Module):
    """sa_block -> ca_block -> ffn, each where its config is given; every
    attention gets every condition (ReMoDiffuse's ``re_dict`` too) and uses
    what it needs."""

    def __init__(self, sa_block_cfg: Optional[dict] = None,
                 ca_block_cfg: Optional[dict] = None, ffn_cfg: Optional[dict] = None):
        super().__init__()
        self.sa_block = ATTENTIONS.build(sa_block_cfg)
        self.ca_block = ATTENTIONS.build(ca_block_cfg)
        self.ffn = ffn_from_cfg(ffn_cfg)

    def forward(self, x, xf, emb, src_mask, cond_type=None, **kwargs):
        for block in (self.sa_block, self.ca_block):
            if block is not None:
                x = block(x, xf=xf, emb=emb, src_mask=src_mask, cond_type=cond_type, **kwargs)
        return x if self.ffn is None else self.ffn(x, emb)


class DiffusionTransformerBase(nn.Module):
    def __init__(self, input_feats: int = 263, max_seq_len: int = 240,
                 latent_dim: int = 512, time_embed_dim: int = 2048,
                 num_layers: int = 8, text_encoder: Optional[dict] = None,
                 use_pos_embedding: bool = True, remat: bool = False):
        super().__init__()
        self.remat = remat
        self.input_feats, self.max_seq_len = input_feats, max_seq_len
        self.latent_dim, self.time_embed_dim = latent_dim, time_embed_dim
        self.num_layers = num_layers
        te = dict(text_encoder or {})
        te.pop("pretrained_model", None)
        self.use_text_proj = te.get("use_text_proj", False)
        self.text_enc = TextEncoder(
            latent_dim=te.get("latent_dim", 256), num_layers=te.get("num_layers", 2),
            ff_size=te.get("ff_size", 2048), num_heads=te.get("num_heads", 4),
            dropout=te.get("dropout", 0.0), activation=te.get("activation", "gelu"),
            use_text_proj=self.use_text_proj, time_embed_dim=time_embed_dim,
            clip_width=te.get("clip_width", 512), clip_layers=te.get("clip_layers", 12))
        self.use_pos_embedding = use_pos_embedding
        if use_pos_embedding:
            self.sequence_embedding = nn.Parameter(torch.randn(max_seq_len, latent_dim))
        self.time_embed = nn.Sequential(Linear(latent_dim, time_embed_dim), nn.SiLU(),
                                        Linear(time_embed_dim, time_embed_dim))

    # the generic families' stack ------------------------------------
    def setup_io(self):
        """A Linear joint embedding and a zero-init Linear output."""
        self.joint_embed = Linear(self.input_feats, self.latent_dim)
        self.out = ZeroDense(self.latent_dim, self.input_feats)

    def make_layer(self, sa_block_cfg, ca_block_cfg, ffn_cfg) -> nn.Module:
        return GenericDecoderLayer(sa_block_cfg, ca_block_cfg, ffn_cfg)

    def build_temporal_blocks(self, sa_block_cfg, ca_block_cfg, ffn_cfg):
        """``block_{i}`` = ``make_layer`` for every layer."""
        for i in range(self.num_layers):
            self.add_module(f"block_{i}", self.make_layer(sa_block_cfg, ca_block_cfg,
                                                          ffn_cfg))

    def call_layer(self, layer, *args, generator=None, aux_losses=None, kl_losses=None,
                   **kwargs):
        """``layer(*args, generator=, aux_losses=, kl_losses=, **kwargs)``;
        with ``remat`` in training, its activations are recomputed in the
        backward pass instead of kept.  The recompute sets ``generator`` back
        to its state before the layer (so it draws the gate noise it drew)
        and then forward again, and appends no loss term: the layer's terms
        are outputs of the checkpointed function, appended here once."""
        if not (self.remat and self.training and torch.is_grad_enabled()):
            return layer(*args, generator=generator, aux_losses=aux_losses,
                         kl_losses=kl_losses, **kwargs)
        start = None if generator is None else generator.get_state()
        runs = []

        def run(*a):
            replay = bool(runs) and generator is not None
            runs.append(None)
            if replay:
                after = generator.get_state()
                generator.set_state(start)
            aux, kl = [], []
            try:
                out = layer(*a, generator=generator, aux_losses=aux, kl_losses=kl, **kwargs)
            finally:
                if replay:
                    generator.set_state(after)
            return out, aux, kl

        out, aux, kl = torch.utils.checkpoint.checkpoint(run, *args, use_reentrant=False)
        for terms, into in ((aux, aux_losses), (kl, kl_losses)):
            if into is not None:
                into.extend(terms)
        return out

    @property
    def blocks(self):
        return [getattr(self, f"block_{i}") for i in range(self.num_layers)]

    def stack_dtype(self) -> torch.dtype:
        """The dtype the stack computes in: its joint embedding's."""
        return next(self.joint_embed.parameters()).dtype

    def encode_text(self, text_ids, generator=None):
        """xf_out, or (xf_proj, xf_out) with ``use_text_proj``; in training
        the text layers' dropout draws from ``generator``."""
        return self.text_enc(text_ids, generator=generator)

    def _embed(self, motion, timesteps):
        T = motion.shape[1] // getattr(self, "patch_size", 1)  # the stack's tokens
        emb = self.time_embed(timestep_embedding(timesteps, self.latent_dim))
        h = self.joint_embed(motion)
        if self.use_pos_embedding:
            h = h + self.sequence_embedding[None, :T, :]
        return h, emb

    def forward(self, motion, timesteps, motion_mask=None, motion_length=None,
                xf_out=None, text_feats=None, *, xf_proj=None, mode: str = "test",
                cond_type=None, generator=None, aux_losses=None, kl_losses=None,
                step_cache=None, cache_flags=None, num_intervals: int = 1, re_dict=None):
        """``motion`` [B, T, D] at original-scale ``timesteps`` [B] -> model
        output [B, T, D].  ``mode="test"``: the test forward (STMoGen's
        CFG-guided).  ``mode="train"``: one pass at ``cond_type`` [B, 1, 1]
        (text on where ``cond_type % 10 > 0``), the MoE gate noise drawn from
        ``generator``, their aux losses appended to ``aux_losses`` and SAMI's
        template KL terms to ``kl_losses``.  With ``use_text_proj``,
        ``xf_proj`` [B, time_embed_dim] is added to the time embedding.
        With a ``step_cache`` and the step's host ``cache_flags`` (test
        mode), returns (output, new cache).  ``motion_length`` and
        ``num_intervals`` go to both forwards, whose SAMI layers (FineMoGen)
        read them; every other family ignores them.  ``re_dict``
        (ReMoDiffuse's encoded retrieval, ``encode_retrieval``) goes to the
        test forward of the families that read it."""
        src_mask = motion_mask[..., None] if motion_mask.dim() == 2 else motion_mask
        h, emb = self._embed(motion, timesteps)
        emb, src_mask = emb.to(h.dtype), src_mask.to(h.dtype)
        if self.use_text_proj and xf_proj is not None:
            emb = emb + xf_proj.to(h.dtype)
        if mode == "train":
            return self.forward_train(h=h, src_mask=src_mask, emb=emb, xf_out=xf_out,
                                      cond_type=cond_type, motion_length=motion_length,
                                      num_intervals=num_intervals, generator=generator,
                                      aux_losses=aux_losses, kl_losses=kl_losses)
        if mode != "test":
            raise ValueError(f"mode {mode!r}")
        return self.forward_test(h=h, src_mask=src_mask, emb=emb,
                                 xf_out=xf_out, motion_length=motion_length,
                                 timesteps=timesteps, text_feats=text_feats,
                                 step_cache=step_cache, cache_flags=cache_flags,
                                 num_intervals=num_intervals, re_dict=re_dict)

    def forward_test(self, h, src_mask, emb, xf_out, **kwargs):
        """The generic families' test forward: one pass of the stack, no
        classifier-free guidance."""
        B, T = h.shape[:2]
        for block in self.blocks:
            h = block(h, xf_out, emb, src_mask)
        return self.out(h).reshape(B, T, -1)

    def forward_train(self, h, src_mask, emb, xf_out, cond_type, **kwargs):
        """The generic families' training forward: one pass of the stack at
        ``cond_type`` [B, 1, 1] (each cross-attention masks the text of a
        row where ``cond_type % 10 == 0``); the layers take what else they
        read of ``kwargs`` and ignore the rest, as in the JAX package."""
        B, T = h.shape[:2]
        for block in self.blocks:
            h = block(h, xf_out, emb, src_mask, cond_type, **kwargs)
        return self.out(h).reshape(B, T, -1)
