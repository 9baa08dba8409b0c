"""STMoGenTransformer, MotionCraft's flagship denoiser (PyTorch port of
motioncraft_tpu/models/stmogen.py).

  - PoseEncoder / PoseDecoder: per-body-part linear projections through
    static index tables; the decoder scatters the part heads back through an
    inverse permutation and averages them with the whole-body head, which is
    added as it is.
  - The decoder stack is STMoGenDecoderLayer (a ca_block, STMA or
    FineMoGen's SAMI, + SFFN); every layer gets the CFG-doubled motion
    lengths and ``num_intervals``, which STMA ignores and SAMI reads.
  - forward_test: classifier-free guidance on the doubled batch (text, then
    unconditional; ``cfg_batch``), the blocks, then ``cfg_mix``: decoded and
    mixed by w = (1 - (1000 - t) / 1000) * scale + 1 (the ControlNet of
    models/controlnet.py runs the same pieces around its control blocks);
    layer 0 computes its motion branch once for both halves (cfg_dedup), and
    the text MoE of every layer comes precomputed once per sampling call
    (precompute_text_feats, on the doubled batch so MoE capacity matches;
    none for a ca_block without a text branch, SAMI, which computes its
    text MoE in every layer and both CFG halves in layer 0).
    Each of the two is a switch, on by default as in the JAX package
    (``cfg_layer0_dedup``, ``text_hoist``); with MoE capacity drops the
    dedup routes B tokens where the plain path routes 2B, so "off" is the
    reference's strict drop semantics.
  - The step cache (diffusion/stepcache.py): ``forward_test(step_cache=,
    cache_flags=)`` runs the stack layer by layer on the host's flags, each
    layer either computing (its output returned as it is, so all-compute
    flags give the uncached stack bit for bit) or replaying its cached
    residual without a launch, and returns ``(mixed, new_cache)``.
  - forward_train: one pass of the stack at the batch's ``cond_type`` with
    the motion lengths and ``num_intervals`` (SAMI reads them), the text
    MoE computed in every layer, the MoE aux losses and SAMI's template KL
    terms collected; with ``remat`` each layer is rematerialized in the
    backward pass (``DiffusionTransformerBase.call_layer``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..registry import ATTENTIONS, SUBMODULES
from . import body_layout
from .blocks import SFFN, Linear
from .diffusion_transformer import DiffusionTransformerBase


class PoseEncoder(nn.Module):
    """Per-body-part linear embedding plus the whole-body embedding."""

    def __init__(self, dataset_name: str = "human_ml3d", latent_dim: int = 64,
                 input_dim: int = 263, patch_size: int = 1, joints: bool = False,
                 body_graph: bool = False):
        super().__init__()
        if patch_size != 1 or joints or body_graph:
            raise NotImplementedError("PoseEncoder with patch_size > 1, joints or body_graph")
        parts = body_layout.part_slices(dataset_name)
        body = body_layout.body_slice(dataset_name)
        if len(set(body)) != input_dim:
            raise ValueError(f"{dataset_name} body layout does not cover {input_dim} dims")
        self.names = list(parts)
        for name, sl in parts.items():
            self.register_buffer(f"{name}_index", torch.as_tensor(sl), persistent=False)
            self.add_module(f"{name}_embed", Linear(len(sl), latent_dim))
        self.register_buffer("body_index", torch.as_tensor(body), persistent=False)
        self.body_embed = Linear(len(body), latent_dim)

    def forward(self, motion):
        feats = [getattr(self, f"{n}_embed")(motion[..., getattr(self, f"{n}_index")])
                 for n in self.names]
        feats.append(self.body_embed(motion[..., self.body_index]))
        return torch.cat(feats, dim=-1)


class PoseDecoder(nn.Module):
    """Per-part linear heads scattered back through an inverse permutation,
    averaged with the whole-body head."""

    def __init__(self, dataset_name: str = "human_ml3d", latent_dim: int = 64,
                 output_dim: int = 263, patch_size: int = 1, joints: bool = False,
                 zero_init: bool = True):
        super().__init__()
        if patch_size != 1 or joints:
            raise NotImplementedError("PoseDecoder with patch_size > 1 or joints")
        parts = body_layout.part_slices(dataset_name)
        self.names = list(parts)
        self.latent_dim = latent_dim
        flat = sum(parts.values(), [])
        self.register_buffer("inv", torch.as_tensor(
            body_layout.inverse_permutation(flat, output_dim), dtype=torch.long),
            persistent=False)
        for name, sl in parts.items():
            self.add_module(f"{name}_out", Linear(latent_dim, len(sl)))
        self.body_out = Linear(latent_dim, output_dim)
        if zero_init:
            for p in self.parameters():
                nn.init.zeros_(p)

    def forward(self, motion):
        D = self.latent_dim
        outs = [getattr(self, f"{n}_out")(motion[:, :, i * D:(i + 1) * D])
                for i, n in enumerate(self.names)]
        scattered = torch.cat(outs, dim=-1)[..., self.inv]
        body = self.body_out(motion[:, :, len(self.names) * D:])
        return (scattered + body) / 2.0


class STMoGenDecoderLayer(nn.Module):
    """ca_block (STMA or SAMI) + ffn (SFFN)."""

    def __init__(self, ca_block_cfg: dict, ffn_cfg: dict):
        super().__init__()
        self.ca_block = ATTENTIONS.build(ca_block_cfg)
        cfg = dict(ffn_cfg)
        self.ffn = SFFN(latent_dim=cfg.pop("latent_dim"), ffn_dim=cfg.pop("ffn_dim"),
                        num_heads=cfg.pop("num_heads"), dropout=cfg.pop("dropout", 0.0),
                        time_embed_dim=cfg.pop("time_embed_dim", 2048))
        if cfg:
            raise TypeError(f"unknown ffn_cfg keys {sorted(cfg)}")

    def text_branch(self, xf):
        """The layer's step-invariant text features (STMA.text_branch)."""
        return self.ca_block.text_branch(xf)

    def forward(self, x, xf, emb, src_mask, cond_type, motion_length=None,
                num_intervals: int = 1, cfg_dedup=False, text_feat=None, generator=None,
                aux_losses=None, kl_losses=None):
        x = self.ca_block(x, xf=xf, emb=emb, src_mask=src_mask, cond_type=cond_type,
                          motion_length=motion_length, num_intervals=num_intervals,
                          cfg_dedup=cfg_dedup, text_feat=text_feat, generator=generator,
                          aux_losses=aux_losses, kl_losses=kl_losses)
        return self.ffn(x, emb)


@SUBMODULES.register_module()
class STMoGenTransformer(DiffusionTransformerBase):
    """MotionCraft main model: body-part PoseEncoder/Decoder + STMA/SFFN
    stack."""

    def __init__(self, input_feats: int = 263, max_seq_len: int = 240,
                 latent_dim: int = 512, time_embed_dim: int = 2048, num_layers: int = 8,
                 ca_block_cfg: Optional[dict] = None, ffn_cfg: Optional[dict] = None,
                 text_encoder: Optional[dict] = None, use_pos_embedding: bool = True,
                 pose_encoder_cfg: Optional[dict] = None,
                 pose_decoder_cfg: Optional[dict] = None, patch_size: int = 1,
                 scale_func_cfg: Optional[dict] = None,
                 moe_route_loss_weight: float = 1.0,
                 template_kl_loss_weight: float = 0.0001,
                 pipeline_axis: Optional[str] = None,
                 cfg_layer0_dedup: bool = True, text_hoist: bool = True,
                 remat: bool = False):
        super().__init__(input_feats, max_seq_len, latent_dim, time_embed_dim,
                         num_layers, text_encoder, use_pos_embedding, remat)
        if pipeline_axis is not None:
            from ..parallel.mesh import PIPELINE

            raise NotImplementedError(f"pipeline_axis (pipeline parallelism): {PIPELINE}")
        if ca_block_cfg is None or ffn_cfg is None or isinstance(ffn_cfg, (list, tuple)):
            raise NotImplementedError("STMoGenTransformer needs one ca_block_cfg and "
                                      "one ffn_cfg for every layer")
        self.moe_route_loss_weight = moe_route_loss_weight
        self.cfg_layer0_dedup, self.text_hoist = cfg_layer0_dedup, text_hoist
        self.template_kl_loss_weight = template_kl_loss_weight
        self.scale = (scale_func_cfg or {}).get("scale", 6.5)
        self.joint_embed = PoseEncoder(**(pose_encoder_cfg or {}), patch_size=patch_size)
        self.out = PoseDecoder(**(pose_decoder_cfg or {}), patch_size=patch_size)
        for i in range(num_layers):
            self.add_module(f"block_{i}", STMoGenDecoderLayer(ca_block_cfg, ffn_cfg))

    def scale_func(self, timestep: torch.Tensor):
        """Timestep-dependent CFG weights (text, unconditional)."""
        w = (1 - (1000 - timestep.to(torch.float32)) / 1000) * self.scale + 1
        return w, 1 - w

    def aux_loss_weights(self):
        return {"moe_route_loss": self.moe_route_loss_weight,
                "template_kl_loss": self.template_kl_loss_weight}

    def forward_train(self, h, src_mask, emb, xf_out, cond_type, motion_length=None,
                      num_intervals: int = 1, generator=None, aux_losses=None,
                      kl_losses=None):
        B, T = h.shape[:2]
        for block in self.blocks:
            h = self.call_layer(block, h, xf_out, emb, src_mask, cond_type, motion_length,
                                num_intervals, generator=generator, aux_losses=aux_losses,
                                kl_losses=kl_losses)
        return self.out(h).reshape(B, T, -1)

    def precompute_text_feats(self, xf_out):
        """Per-layer text features [2B, 77, 1, 2L], computed once per sampling
        call on the CFG-doubled batch: MoE capacity and drops depend on the
        token count, so an undoubled batch would route differently.  None
        when ``text_hoist`` is off or the ca_block has no text branch
        (SAMI): every layer then computes its own."""
        if not self.text_hoist or not hasattr(self.block_0.ca_block, "text_branch"):
            return None
        xf2 = torch.cat([xf_out, xf_out], dim=0)
        return tuple(block.text_branch(xf2) for block in self.blocks)

    def cfg_batch(self, h, xf_out, emb, src_mask):
        """The CFG-doubled test batch (text half, then unconditional half)
        and its cond_type [2B, 1, 1], made on the device of ``h``."""
        B = h.shape[0]
        all_cond = torch.cat([h.new_ones(B, 1, 1), h.new_zeros(B, 1, 1)])
        return (torch.cat([h, h]), torch.cat([xf_out, xf_out]), torch.cat([emb, emb]),
                torch.cat([src_mask, src_mask]), all_cond)

    def cfg_mix(self, h2, timesteps):
        """Decode the doubled batch and mix its halves by scale_func, in f32
        (a bf16 stack's output meets f32 weights there, as in flax)."""
        B2, T = h2.shape[:2]
        out = self.out(h2).reshape(B2, T, -1).float()
        text_coef, none_coef = self.scale_func(timesteps[0])
        return out[:B2 // 2] * text_coef + out[B2 // 2:] * none_coef

    # ------------------------------------------------------- step caching
    supports_step_cache = True

    def make_step_cache(self, B: int, T: int, dtype=torch.float32) -> torch.Tensor:
        """The zero per-layer residual cache of the CFG-doubled test forward,
        [num_layers, 2B, T, latent_dim] on the model's device: step 0 of any
        schedule computes every layer (the reuse tables enforce it)."""
        return torch.zeros((self.num_layers, 2 * B, T, self.latent_dim), dtype=dtype,
                           device=next(self.parameters()).device)

    def forward_test(self, h, src_mask, emb, xf_out, motion_length=None,
                     timesteps=None, text_feats=None, step_cache=None, cache_flags=None,
                     num_intervals: int = 1, **kwargs):
        h2, xf2, emb2, mask2, all_cond = self.cfg_batch(h, xf_out, emb, src_mask)
        ml2 = None if motion_length is None else torch.cat([motion_length, motion_length])
        residuals = []
        for i, block in enumerate(self.blocks):
            if step_cache is not None and cache_flags[i]:
                r = step_cache[i].to(h2.dtype)  # reuse: nothing launches
                h2 = h2 + r
            else:
                out = block(h2, xf2, emb2, mask2, all_cond, ml2, num_intervals,
                            cfg_dedup=self.cfg_layer0_dedup and i == 0,
                            text_feat=None if text_feats is None else text_feats[i])
                if step_cache is not None:
                    r = out - h2
                h2 = out
            if step_cache is not None:
                residuals.append(r)
        mixed = self.cfg_mix(h2, timesteps)
        return mixed if step_cache is None else (mixed, torch.stack(residuals))
