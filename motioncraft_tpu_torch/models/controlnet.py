"""The ControlNet branch for music-to-dance and speech-to-gesture (PyTorch
port of motioncraft_tpu/models/controlnet.py, over an STMoGen or an MCM
base).

  - The base model (``base_model``: an STMoGenTransformer, or for
    ``ControlT2MHalfMCM`` an MCMTransformer) runs as it is.
  - The first ``copy_blocks_num`` decoder layers are copied as control
    blocks (``controlnet_N.copied_block``) with zero-initialised projections
    around them (``before_proj`` on block 0, ``after_proj`` on each), so that
    at initialisation the branch changes nothing.
  - The condition stream (163-d music features, or raw 16 kHz onset and
    amplitude through the ``condition_pre_encoder``: the WavEncoder, or
    with ``condition_pre_encode_type='wav2vec'`` a Wav2Vec2 tower over the
    waveform lane interpolated to the window, models/wav2vec.py) enters
    through a zero-initialised input projection (``control_cond_input``),
    is padded or cut to the window, gets the base's sequence embedding over
    its own length, and is injected as ``c_skip`` residuals into base blocks
    1..copy_blocks_num.
  - Condition-CFG zeroes ``c`` on the unconditional half of the CFG batch.

The STMoGen test forward is the base's CFG test forward with the control blocks
between its block 0 and block copy_blocks_num + 1: block 0 still sees two
identical halves, so its layer-0 dedup applies as in the base model.  The
control blocks' text MoEs are hoisted with the base's
(``precompute_text_feats``: ``{"base": ..., "ctrl": ...}``), on the
CFG-doubled text batch so that MoE capacity is the in-layer one.  The
condition (the WavEncoder's 84 GFLOP a 64-frame window at full width)
depends on no timestep: ``encode_condition`` runs once per sampling call,
never per denoiser step.

The step cache (diffusion/stepcache.py) is a dict, ``{"h": [L, 2B, T, D],
"c": [copy_blocks_num, 2B, T, D]}``: layer i's residual and, for a
control-injected layer (1..copy_blocks_num), the control block's ``c``
output.  Such a layer is cached as the compound of its control block and its
base block: reusing it replays both its h-residual (the c_skip injection
included) and its ``c``, so the control chain downstream stays consistent.

The MCM test forward (``block_type="mcm"``, the JAX package's
controlnet_mcm.py) runs no classifier-free guidance: one pass of the base's
MCMDecoderLayers at ``cond_type=None`` (the cross-attention unmasked), the
copied blocks MCMDecoderLayers too, the pooled text projection ``xf_proj``
added to the time embedding, and the base's zero-init output.  It has no
text MoE to hoist (``precompute_text_feats`` is None), no layer-0 dedup and
no step cache.  Its attentions are K5 (ops/linear_attention.py); under
bf16 it keeps the f32 time embedding, as the JAX package's does, so the
stream is f32 after the first stylized residual and the later K5 calls
meet f32 queries beside bf16 text keys (K5's f32 instantiation on the
widened operands).

The training forward (``mode="train"``, either block type) is one pass at
the batch's ``cond_type``: the condition zeroed where the text is off
(``cond_type % 10 == 0``, condition-CFG), block 0, the control blocks
injecting into blocks 1..copy_blocks_num, the rest, the base's output;
the MCM type adds ``xf_proj`` to the time embedding and its blocks mask
the text by ``cond_type`` (their attentions through K5); every STMoGen
block's MoEs draw their gate noise from ``generator`` and append their aux
losses, and the WavEncoder normalises with the batch's statistics.
Training freezes the base (``controlnet_frozen_prefixes``: flax paths,
which the port's '/'-joined parameter names match) apart from the
body-part heads that ``joint_embed_unfreeze`` / ``unfreeze_mode`` leave
trainable (an MCM base has a Linear joint embedding and output, which
train whole or stay frozen whole); ``init_control_blocks_from_base``
copies base blocks 0..copy_blocks_num - 1 into the control blocks.

With ``patch_size`` p > 1 (the base's too) the condition is patched as the
motion (``condition_patch``, a PatchEmbed1D after the input projection), the
stack and the step cache run on T / p patches and the output has T frames.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..registry import SUBMODULES
from .baselines import MCMDecoderLayer
from .blocks import Linear, PatchEmbed1D, WavEncoder, ZeroDense
from .stmogen import STMoGenDecoderLayer
from .wav2vec import Wav2Vec2Conditioner

BASE_TYPES = {"stmogen": "STMoGenTransformer", "mcm": "MCMTransformer"}  # block type -> base


class ControlT2MBlock(nn.Module):
    """A copied decoder layer (an STMoGenDecoderLayer, or for
    ``block_type="mcm"`` an MCMDecoderLayer) with zero-initialised in/out
    projections."""

    def __init__(self, ca_block_cfg: dict, ffn_cfg: dict, block_index: int, latent_dim: int,
                 block_type: str = "stmogen", sa_block_cfg: Optional[dict] = None):
        super().__init__()
        self.block_index = block_index
        if block_index == 0:
            self.before_proj = Linear(latent_dim, latent_dim)
            nn.init.zeros_(self.before_proj.weight)
            nn.init.zeros_(self.before_proj.bias)
        self.copied_block = (MCMDecoderLayer(sa_block_cfg, ca_block_cfg, ffn_cfg)
                             if block_type == "mcm" else STMoGenDecoderLayer(ca_block_cfg, ffn_cfg))
        self.after_proj = ZeroDense(latent_dim, latent_dim)

    def forward(self, x, c, xf, emb, src_mask, cond_type, text_feat=None, **train_kw):
        """(c, c_skip): the block's new control state and its injection into
        the next base block.  Block 0 reads the base stream plus the
        projected condition; the later ones the previous control state.
        ``train_kw`` (``generator``, ``aux_losses``) go to the copied
        block."""
        inp = x + self.before_proj(c) if self.block_index == 0 else c
        c = self.copied_block(inp, xf, emb, src_mask, cond_type, text_feat=text_feat,
                              **train_kw)
        return c, self.after_proj(c)


@SUBMODULES.register_module()
class ControlT2MHalf(nn.Module):
    """Base model + control branch."""

    def __init__(self, base_model: Optional[dict] = None, copy_blocks_num: int = 2,
                 control_cond_feats: int = 438, condition_encode_cfg: Optional[dict] = None,
                 joint_embed_unfreeze: bool = True, unfreeze_mode: str = "all",
                 patch_size: int = 1, block_type: str = "stmogen",
                 init_cfg: Optional[dict] = None):
        super().__init__()
        base_cfg = dict(base_model or {})
        base_type = base_cfg.setdefault("type", "STMoGenTransformer")
        if BASE_TYPES.get(block_type) != base_type:
            raise NotImplementedError(
                f"ControlNet of block type {block_type!r} over {base_type}: only "
                f"{BASE_TYPES}, whose copied blocks are their base's own layers")
        self.block_type = block_type
        # training's freezing (controlnet_frozen_prefixes) reads these two
        # from the config; a mode it does not know is refused here
        if unfreeze_mode != "all" and unfreeze_mode not in UNFREEZE_MODE_PARTS:
            raise ValueError(f"unfreeze_mode {unfreeze_mode!r}: 'all' or one of "
                             f"{sorted(UNFREEZE_MODE_PARTS)}")
        if patch_size != base_cfg.get("patch_size", 1):
            raise ValueError(f"ControlNet of patch_size {patch_size} over a base of patch_size "
                             f"{base_cfg.get('patch_size', 1)}: the condition is patched "
                             "as the motion only where both agree (the JAX package's "
                             "output shape breaks on any other pair)")
        self.patch_size = patch_size
        cc = dict(condition_encode_cfg or {})
        cond_width = control_cond_feats
        self.condition_pre_encode_type = cc.get("condition_pre_encode_type", "wav")
        if cc.get("condition_pre_encode", False):
            cond_width = cc.get("condition_latent_dim", 512)
            if self.condition_pre_encode_type == "wav":
                self.condition_pre_encoder = WavEncoder(
                    cond_width, audio_in=cc.get("control_cond_feats", control_cond_feats))
            elif self.condition_pre_encode_type == "wav2vec":
                # the Wav2Vec2 tower interpolated to the motion frame count
                # (EMAGE wav2vec.py:72-146 semantics; the reference's
                # ConditionEncoder reserves the type but raises)
                self.condition_pre_encoder = Wav2Vec2Conditioner(
                    cond_width, wav2vec_cfg=cc.get("wav2vec_cfg"))
            else:
                raise NotImplementedError(self.condition_pre_encode_type)
        else:
            self.condition_pre_encoder = None
        self.base_model = SUBMODULES.build(base_cfg)
        base = self.base_model
        if copy_blocks_num >= base.num_layers:
            raise ValueError(f"copy_blocks_num ({copy_blocks_num}) must be < the base "
                             f"model's num_layers ({base.num_layers}): each control "
                             "block injects into the NEXT base block")
        self.copy_blocks_num = copy_blocks_num
        self.condition_cfg_enabled = cc.get("condition_cfg", True)
        ffn_cfg = base_cfg["ffn_cfg"]
        for i in range(copy_blocks_num):
            self.add_module(f"controlnet_{i}", ControlT2MBlock(
                base_cfg["ca_block_cfg"],
                ffn_cfg[i] if isinstance(ffn_cfg, (list, tuple)) else ffn_cfg, i,
                base.latent_dim, block_type, base_cfg.get("sa_block_cfg")))
        # after a pre-encoder the projection reads its features (flax infers
        # the width)
        self.control_cond_input = ZeroDense(cond_width, base.latent_dim)
        self.condition_patch = (PatchEmbed1D(base.latent_dim, patch_size, base.latent_dim)
                                if patch_size > 1 else None)

    @property
    def num_layers(self):
        return self.base_model.num_layers

    @property
    def controlnet(self):
        return [getattr(self, f"controlnet_{i}") for i in range(self.copy_blocks_num)]

    def encode_text(self, text_ids, generator=None):
        return self.base_model.encode_text(text_ids, generator=generator)

    def aux_loss_weights(self):
        """The base's weights of the aux losses."""
        return self.base_model.aux_loss_weights()

    def encode_condition(self, c, seq_len: int):
        """The condition [B, Tc, F] (for the WavEncoder and Wav2Vec2,
        audio samples [B, L, 2]) -> [B, seq_len, latent] (``seq_len``: the
        stack's tokens, patches of ``patch_size`` frames): the pre-encoder
        if any (Wav2Vec2 interpolates its frames to ``seq_len`` itself), the
        zero-initialised input projection, with ``patch_size`` > 1 the
        ``condition_patch`` PatchEmbed1D, then padded with zeros or cut to
        ``seq_len``, with the base's sequence embedding added over the
        encoded condition's length.  It depends on no timestep, so sampling
        encodes it once per call (or per chunk of windows).  It runs in f32
        in a bf16-cast model too (bf16_cast_ keeps the encoder's tensors
        f32, holding the bf16-rounded values), as flax promotes an f32
        condition; the caller casts the encoding to the compute dtype."""
        if self.condition_pre_encoder is not None:
            c = (self.condition_pre_encoder(c, seq_len)
                 if self.condition_pre_encode_type == "wav2vec" else self.condition_pre_encoder(c))
        c = self.control_cond_input(c)
        if self.condition_patch is not None:
            c = self.condition_patch(c)
        n = min(c.shape[1], seq_len)
        pad = seq_len - c.shape[1]
        if pad > 0:
            c = torch.cat([c, c.new_zeros(c.shape[0], pad, c.shape[2])], dim=1)
        return torch.cat([c[:, :n] + self.base_model.sequence_embedding[None, :n],
                          c[:, n:seq_len]], dim=1)

    def precompute_text_feats(self, xf_out):
        """The base's per-layer text features plus one per control block,
        on the CFG-doubled batch; None when the base's hoist is off, and
        for the MCM block type, which has no text MoE."""
        if self.block_type != "stmogen":
            return None
        base_feats = self.base_model.precompute_text_feats(xf_out)
        if base_feats is None:
            return None
        xf2 = torch.cat([xf_out, xf_out], dim=0)
        return {"base": base_feats,
                "ctrl": tuple(blk.copied_block.text_branch(xf2) for blk in self.controlnet)}

    @property
    def supports_step_cache(self) -> bool:
        """The STMoGen block type only, as in the JAX package."""
        return self.block_type == "stmogen"

    def make_step_cache(self, B: int, T: int, dtype=torch.float32) -> dict:
        """The zero dict cache of the CFG-doubled test forward (module
        docstring), on the model's device."""
        base = self.base_model
        dev = next(self.parameters()).device
        Tp = T // self.patch_size
        return {"h": torch.zeros((base.num_layers, 2 * B, Tp, base.latent_dim), dtype=dtype,
                                 device=dev),
                "c": torch.zeros((self.copy_blocks_num, 2 * B, Tp, base.latent_dim), dtype=dtype,
                                 device=dev)}

    def forward(self, motion, timesteps, motion_mask=None, motion_length=None, xf_out=None,
                text_feats=None, *, xf_proj=None, c=None, c_enc=None, mode: str = "test",
                cond_type=None, generator=None, aux_losses=None, kl_losses=None,
                step_cache=None, cache_flags=None, num_intervals: int = 1):
        """The forward of ``motion`` [B, T, D] at original-scale
        ``timesteps`` [B], with the condition ``c`` [B, Tc, F] or its
        encoding ``c_enc`` [B, T, latent] (none: the base alone).
        ``mode="test"``: STMoGen's CFG-guided one, or MCM's single pass
        (``xf_proj`` [B, time_embed_dim], the pooled text, added to the time
        embedding); with a ``step_cache`` and the step's host
        ``cache_flags`` (STMoGen), returns (output, new cache).
        ``mode="train"``: one pass at ``cond_type`` [B, 1, 1] (module
        docstring), the gate noise from ``generator``, the aux losses
        appended to ``aux_losses``.  ``motion_length``, ``num_intervals``
        and ``kl_losses`` are ignored: no block of either type reads or adds
        to them, as in the JAX package."""
        if mode not in ("test", "train"):
            raise ValueError(f"mode {mode!r}")
        base = self.base_model
        src_mask = motion_mask[..., None] if motion_mask.dim() == 2 else motion_mask
        h, emb = base._embed(motion, timesteps)
        if self.block_type == "stmogen":
            emb = emb.to(h.dtype)
        # the MCM type keeps the time MLP's f32 embedding, as the JAX
        # package's ControlNet does: under bf16 its stylized residuals then
        # promote the stream to f32 after the first attention
        if c_enc is not None:
            c = c_enc.to(h.dtype)
        elif c is not None:
            # encoded in f32 as sampling encodes it (flax's forward would
            # encode a raw condition in the compute dtype)
            c = self.encode_condition(c.float(), h.shape[1]).to(h.dtype)
        if base.use_text_proj and xf_proj is not None:
            emb = emb + xf_proj.to(h.dtype)
        if mode == "train":
            return self._forward_train(h, emb, xf_out, src_mask, cond_type, c, generator,
                                       aux_losses)
        if self.block_type == "mcm":
            return self._forward_mcm(h, emb, xf_out, src_mask, c)
        h2, xf2, emb2, mask2, all_cond = base.cfg_batch(h, xf_out, emb, src_mask)
        c2 = None
        if c is not None:
            c2 = torch.cat([c, c])
            if self.condition_cfg_enabled:
                c2 = c2 * all_cond
        tfb = (lambda i: None) if text_feats is None else (lambda i: text_feats["base"][i])
        tfc = (lambda i: None) if text_feats is None else (lambda i: text_feats["ctrl"][i])
        kw = dict(xf=xf2, emb=emb2, src_mask=mask2, cond_type=all_cond)
        # with a step cache, a layer computes (its output as it is, so
        # all-compute flags give the uncached stack bit for bit) or replays
        # its cached residual and, for a control-injected layer, its cached
        # ``c``; every branch's output is pinned to h's dtype
        caching, dt = step_cache is not None, h2.dtype
        residuals, new_c = [], []
        for i, block in enumerate(base.blocks):
            ctrl = c2 is not None and 1 <= i <= self.copy_blocks_num
            if caching and cache_flags[i]:  # reuse: nothing launches
                r = step_cache["h"][i].to(dt)
                h2 = h2 + r
                if ctrl:
                    c2 = step_cache["c"][i - 1].to(dt)
            else:
                inp = h2
                if ctrl:
                    c2, c_skip = self.controlnet[i - 1](h2, c2, **kw, text_feat=tfc(i - 1))
                    c2 = c2.to(dt)
                    inp = h2 + c_skip
                out = block(inp, **kw, cfg_dedup=base.cfg_layer0_dedup and i == 0,
                            text_feat=tfb(i)).to(dt)
                if caching:
                    r = out - h2
                h2 = out
            if caching:
                residuals.append(r)
                if ctrl:
                    new_c.append(c2)
        mixed = base.cfg_mix(h2, timesteps)
        if not caching:
            return mixed
        return mixed, {"h": torch.stack(residuals),
                       "c": torch.stack(new_c) if new_c else torch.zeros_like(step_cache["c"])}

    def _forward_train(self, h, emb, xf_out, src_mask, cond_type, c, generator, aux_losses):
        """The training forward (module docstring) of the embedded ``h``."""
        base = self.base_model
        B, T = h.shape[:2]
        if c is not None and self.condition_cfg_enabled:
            c = c * ((cond_type % 10) > 0).to(c.dtype)
        kw = dict(xf=xf_out, emb=emb, src_mask=src_mask, cond_type=cond_type,
                  generator=generator, aux_losses=aux_losses)
        for i, block in enumerate(base.blocks):
            if c is not None and 1 <= i <= self.copy_blocks_num:
                c, c_skip = self.controlnet[i - 1](h, c, **kw)
                h = h + c_skip
            h = base.call_layer(block, h, **kw)  # rematerialized with the base's remat
        return base.out(h).reshape(B, T * self.patch_size, -1)

    def _forward_mcm(self, h, emb, xf_out, src_mask, c):
        """MCM's test forward: block 0, the control blocks injecting into
        blocks 1..copy_blocks_num, the rest, then the base's output; no
        CFG, the text unmasked (``cond_type=None``)."""
        base = self.base_model
        B, T = h.shape[:2]
        kw = dict(xf=xf_out, emb=emb, src_mask=src_mask, cond_type=None)
        for i, block in enumerate(base.blocks):
            if c is not None and 1 <= i <= self.copy_blocks_num:
                c, c_skip = self.controlnet[i - 1](h, c, **kw)
                h = h + c_skip
            h = block(h, **kw)
        return base.out(h).reshape(B, T * self.patch_size, -1)


def init_control_blocks_from_base(state_dict: dict, copy_blocks_num: int) -> dict:
    """A copy of a ControlT2MHalf ``state_dict`` whose
    ``controlnet_{i}.copied_block`` entries are clones of
    ``base_model.block_{i}``'s, i < copy_blocks_num (the JAX package's
    function on the flax params tree)."""
    out = dict(state_dict)
    for i in range(copy_blocks_num):
        src, dst = f"base_model.block_{i}.", f"controlnet_{i}.copied_block."
        copied = {dst + k[len(src):]: v.clone() for k, v in state_dict.items()
                  if k.startswith(src)}
        if not copied or set(copied) != {k for k in state_dict if k.startswith(dst)}:
            raise KeyError(f"controlnet_{i}.copied_block does not match base_model.block_{i}")
        out.update(copied)
    return out


# the reference's selective-unfreeze modes: the body-part embed / out heads
# that stay trainable under each
UNFREEZE_MODE_PARTS = {
    "root": {"trans", "root", "body"},
    "root_face": {"trans", "root", "body", "face"},
    "root_hand": {"trans", "root", "body", "lhand", "rhand"},
    "root_face_hand": {"trans", "root", "body", "face", "lhand", "rhand"},
}

_ALL_PARTS = ("head", "stem", "larm", "rarm", "lleg", "rleg",
              "root", "trans", "face", "lhand", "rhand", "body")


def controlnet_frozen_prefixes(joint_embed_unfreeze: bool = True,
                               unfreeze_mode: str = "all") -> list:
    """The prefixes (flax paths, as the JAX package's) of the parameters
    that ControlNet training freezes: the base's text towers, time
    embedding, sequence embedding and decoder blocks, and unless
    ``joint_embed_unfreeze`` its joint embedding and output; with a partial
    ``unfreeze_mode``, the embed / out heads of the other body parts."""
    frozen = ["base_model/text_enc", "base_model/time_embed",
              "base_model/sequence_embedding", "base_model/block_"]
    if not joint_embed_unfreeze:
        frozen += ["base_model/joint_embed", "base_model/out"]
    elif unfreeze_mode != "all":
        keep = UNFREEZE_MODE_PARTS[unfreeze_mode]
        frozen += [f"base_model/joint_embed/{p}_embed" for p in _ALL_PARTS if p not in keep]
        frozen += [f"base_model/out/{p}_out" for p in _ALL_PARTS if p not in keep]
    return frozen


@SUBMODULES.register_module()
class ControlT2MHalfMCM(ControlT2MHalf):
    """The MCM ControlNet: the same scheme over MCMTransformer blocks."""

    def __init__(self, *args, block_type: str = "mcm", **kwargs):
        super().__init__(*args, block_type=block_type, **kwargs)
