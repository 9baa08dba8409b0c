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
  - ``pipeline_axis`` (the JAX package's field; parallel/pp.py): both
    forwards run the stack as a GPipe pipeline of ``pipeline_microbatches``
    microbatches over the attached mesh's ``pipe`` axis, each stage holding
    its own layers (``pipeline_stage_``; they keep their global names
    ``block_{i}``), each microbatch routing its MoEs on its own; with no
    pipe axis (one process), the layers run per microbatch in sequence.
    The step cache, dropout in training and per-layer ``ffn_cfg`` lists
    are refused in the JAX package's words, and the text hoist and the
    layer-0 CFG dedup are off, as there.  ``remat`` is not read (the JAX
    package's stacked layers are not rematerialized).  The gate noise of (layer, microbatch) draws
    from the step's generator folded by the global layer id and the
    microbatch's first global row (``pp.fold_generator``), so that S stages
    draw what one process draws.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..parallel.mesh import PIPE_AXIS
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

    mesh = None  # the pipe mesh of a pipelined stack (parallel/mesh.py:attach_mesh)

    def __init__(self, input_feats: int = 263, max_seq_len: int = 240,
                 latent_dim: int = 512, time_embed_dim: int = 2048, num_layers: int = 8,
                 ca_block_cfg: Optional[dict] = None, ffn_cfg: Optional[dict] = None,
                 text_encoder: Optional[dict] = None, use_pos_embedding: bool = True,
                 pose_encoder_cfg: Optional[dict] = None,
                 pose_decoder_cfg: Optional[dict] = None, patch_size: int = 1,
                 scale_func_cfg: Optional[dict] = None,
                 moe_route_loss_weight: float = 1.0,
                 template_kl_loss_weight: float = 0.0001,
                 pipeline_axis: Optional[str] = None, pipeline_microbatches: int = 2,
                 cfg_layer0_dedup: bool = True, text_hoist: bool = True,
                 remat: bool = False):
        super().__init__(input_feats, max_seq_len, latent_dim, time_embed_dim,
                         num_layers, text_encoder, use_pos_embedding, remat)
        if pipeline_axis is not None and isinstance(ffn_cfg, (list, tuple)):
            raise ValueError("pipeline_axis requires homogeneous layers "
                             "(per-layer ffn_cfg lists cannot be stacked)")
        self.pipeline_axis = pipeline_axis
        self.pipeline_microbatches = int(pipeline_microbatches)
        self.layer_ids = list(range(num_layers))  # the layers this module holds
        if ca_block_cfg is None or ffn_cfg is None or isinstance(ffn_cfg, (list, tuple)):
            raise NotImplementedError("STMoGenTransformer needs one ca_block_cfg and "
                                      "one ffn_cfg for every layer")
        self.ca_block_cfg, self.ffn_cfg = dict(ca_block_cfg), dict(ffn_cfg)
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

    @property
    def blocks(self):
        return [getattr(self, f"block_{i}") for i in self.layer_ids]

    # ------------------------------------------------- pipeline parallelism
    def pipeline_stage_(self, stage: int, stages: int) -> None:
        """Keep the layers of pipeline stage ``stage`` of ``stages`` and drop
        the others (their parameters go with them)."""
        from ..parallel.pp import stage_layers

        keep = stage_layers(self.num_layers, stages, stage)
        for i in self.layer_ids:
            if i not in keep:
                delattr(self, f"block_{i}")
        self.layer_ids = list(keep)

    def _pipe_mesh(self):
        mesh = self.mesh
        return mesh if mesh is not None and mesh.size(PIPE_AXIS) > 1 else None

    def _decode(self, h, train: bool):
        """The output decoder; in training on a stage other than the last,
        on its weights detached: the last stage alone computes the loss's
        share of their gradient (and of the stack output's)."""
        pipe = self._pipe_mesh()
        if not train or pipe is None or pipe.coords[PIPE_AXIS] == pipe.size(PIPE_AXIS) - 1:
            return self.out(h)
        detached = {n: p.detach() for n, p in self.out.named_parameters()}
        return torch.func.functional_call(self.out, detached, (h,))

    def _pipeline(self, h, xf, emb, src_mask, cond_type, motion_length, num_intervals,
                  train: bool, generator=None, aux_losses=None, kl_losses=None):
        """The stack as a GPipe pipeline (parallel/pp.py:gpipe) of this
        module's layers, each (data shard, microbatch) routing on its own;
        in training the aux losses are the mean over microbatches of the
        per-microbatch layer sums, summed over the stages and averaged
        over ``data`` (the MoE's appended to ``aux_losses``, SAMI's KL to
        ``kl_losses`` with the loss's data sum in mind)."""
        from ..parallel.mesh import sampling
        from ..parallel.pp import fold_generator, gpipe
        from ..utils.dist_utils import all_reduce_sum

        mesh = self.mesh
        if train and (self.ca_block_cfg.get("dropout", 0.0) or self.ffn_cfg.get("dropout", 0.0)):
            raise ValueError("pipeline_axis training path does not thread "
                             "dropout rngs; set dropout=0")
        M = self.pipeline_microbatches
        mb = h.shape[0] // M
        first = 0 if mesh is None else mesh.rank * h.shape[0]
        noisy = (train and generator is not None
                 and self.ca_block_cfg.get("gate_noise", 0) > 0)
        layers = list(zip(self.layer_ids, self.blocks))

        def stage_fn(x, c, k):
            xf_, emb_, mask_, cond_, ml_ = c
            aux, kl = [], []
            for i, layer in layers:
                g = fold_generator(generator, i, first + k * mb) if noisy else None
                x = layer(x, xf_, emb_, mask_, cond_, ml_, num_intervals, generator=g,
                          aux_losses=aux if train else None,
                          kl_losses=kl if train else None)
            terms = {}
            if aux:
                terms["aux_loss"] = sum(aux)
            if kl:
                terms["kl_loss"] = sum(kl)
            return x, terms

        params = [p for layer in self.blocks for p in layer.parameters() if p.requires_grad]
        # the layers route each microbatch on its own: no mesh in them
        with sampling(nn.ModuleList(self.blocks), None, 0):
            out, aux = gpipe(stage_fn, params, h, (xf, emb, src_mask, cond_type, motion_length),
                             n_microbatch=M, mesh=mesh)
        W = 1 if mesh is None else mesh.world
        if "aux_loss" in aux and aux_losses is not None:
            aux_losses.append(all_reduce_sum(aux["aux_loss"], mesh) / W)
        if "kl_loss" in aux and kl_losses is not None:
            kl_losses.append(aux["kl_loss"] / W)  # MotionDiffusion.loss sums it over data
        return out

    def _pipeline_test(self, h, src_mask, emb, xf_out, motion_length, num_intervals):
        """The CFG-doubled batch through the pipeline as the JAX package
        lays it out: on a data mesh the global doubled batch (every rank's
        text rows, then their unconditional rows) split over ``data``, each
        rank's share in microbatches, and the output's rows of this rank's
        two halves gathered back."""
        from ..utils.dist_utils import all_gather_rows

        mesh = self.mesh
        W = 1 if mesh is None else mesh.world
        local = (h, xf_out, emb, src_mask, motion_length)
        if W > 1:
            local = tuple(None if t is None else all_gather_rows(t.contiguous(), mesh)
                          for t in local)
        h2, xf2, emb2, mask2, all_cond = self.cfg_batch(*local[:4])
        ml2 = None if local[4] is None else torch.cat([local[4], local[4]])
        b = h.shape[0]
        if W > 1:
            share = slice(2 * b * mesh.rank, 2 * b * (mesh.rank + 1))
            h2, xf2, emb2, mask2, all_cond, ml2 = (
                None if t is None else t[share] for t in (h2, xf2, emb2, mask2, all_cond, ml2))
        y = self._pipeline(h2, xf2, emb2, mask2, all_cond, ml2, num_intervals, False)
        if W == 1:
            return y
        y = all_gather_rows(y.contiguous(), mesh)
        r = mesh.rank
        return torch.cat([y[r * b:(r + 1) * b], y[(W + r) * b:(W + r + 1) * b]])

    def forward_train(self, h, src_mask, emb, xf_out, cond_type, motion_length=None,
                      num_intervals: int = 1, generator=None, aux_losses=None,
                      kl_losses=None):
        B, T = h.shape[:2]
        if self.pipeline_axis is not None:
            h = self._pipeline(h, xf_out, emb, src_mask, cond_type, motion_length,
                               num_intervals, True, generator, aux_losses, kl_losses)
            return self._decode(h, True).reshape(B, T, -1)
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
        if (not self.text_hoist or self.pipeline_axis is not None
                or not hasattr(self.blocks[0].ca_block, "text_branch")):
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
        if self.pipeline_axis is not None:
            if step_cache is not None:
                raise ValueError("step caching is not supported with pipeline_axis")
            h2 = self._pipeline_test(h, src_mask, emb, xf_out, motion_length, num_intervals)
            return self.cfg_mix(h2, timesteps)
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
