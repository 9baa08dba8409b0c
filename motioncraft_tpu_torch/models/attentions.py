"""STMA, MotionCraft's spatio-temporal MoE attention, and the baselines'
linear attentions (PyTorch port of the ``STMA`` and ``Efficient{Self,Cross,
Mixed}Attention`` modules of motioncraft_tpu/models/attentions.py).

The Efficient attentions (MotionDiffuse, MCM): LayerNorm, query / key /
value projections, masked keys and values, kernel K5
(ops/linear_attention.py) over the [B, T, H, d] head views, and a stylized
residual.  STMA's dynamic body graph runs EfficientSelfAttention's
merged-lanes form, without K5.

STMA: per-head body-part features -> MoE projections of text (2L lanes:
key, value) and motion (4L lanes: body value, key, value, query); static
body graph = learned softmax(H x H) mix of per-part values; dynamic body
graph = linear self-attention across the H part tokens of each frame; global
linear attention over the joint text + motion sequence.  At inference that
attention is kernel K3 (ops/stma_attention.py), on the interleaved layout;
in training (``train()``) it is the JAX package's training path: the text
branch computed in the layer, masked keys and values joined along the
sequence, and the generic linear attention, kernel K5
(ops/linear_attention.py).  The MoEs' aux losses go to ``aux_losses``.

SAMI, FineMoGen's attention: the same text and motion MoEs (text 2L lanes:
key, value; motion 3L: body value, key, value) and static body graph, a
linear-attention template per (batch, head) from the joint text + motion
keys and values, a Gaussian time kernel over each interval's template
times, and a third-order Taylor basis (state, velocity, acceleration, jerk
FFNs of the template) mixed at each frame's time.  Its template products
are plain einsums, as in the JAX package (no Pallas kernel there); its MoEs
run K4's route and K1 at inference, and in training the slot path (gate
noise from the step's generator, K4's positions, the slot buffer through
K6), their aux losses going to ``aux_losses`` and the KL of the template
times' logits (over the L template rows of each (batch, head): the
population standard deviation, as ``jnp.std``) to ``kl_losses``.

SemanticsModulatedAttention, ReMoDiffuse's: the motion queries against one
key set of the text tokens, the retrieved motions (each retrieved frame's
feature joined with its caption's feature) and the motion itself; the dual
version (MoMatMoGen) adds the other person's motion and runs each person
with the same weights.  The keys carry additive -1e6 masks: the text off
where ``cond_type % 10 == 0``, the retrieval off where ``cond_type // 10 ==
0`` and on its padded frames (``re_mask``; a key masked both ways carries
-2e6), the motion off on padded frames.  The values are masked alike,
multiplicatively, and ``value_retr`` is zero-initialised.  The function
after the projections is K5's (ops/linear_attention.py).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.linear_attention import fused_linear_attention
from ..ops.stma_attention import NEG_INF, stma_linear_attention
from ..registry import ATTENTIONS
from .blocks import LayerNorm, Linear, StylizationBlock, ZeroDense, promote_dtype
from .moe import MOE


def _text_cond(cond_type, B):
    """cond_type [B, 1, 1] ints -> [B, 1, 1] f32: text on where cond_type %
    10 > 0."""
    return ((cond_type % 10) > 0).to(torch.float32).reshape(B, 1, 1)


@ATTENTIONS.register_module()
class EfficientSelfAttention(nn.Module):
    """MotionDiffuse linear self-attention: keys masked by ``src_mask`` [B, T,
    1] (additively at -1e6) and values by it (multiplicatively), K5 over the
    [B, T, H, d] head views, then ``x +`` the ``proj_out`` StylizationBlock
    of the result (with ``time_embed_dim``) or the result itself.  The JAX
    package's ``merged_lanes`` form (softmax in the [.., D] layout, one
    [D, D] product masked to the block diagonal) is a TPU layout of the same
    function; STMA's dynamic body graph runs it as the per-head products of
    the plain einsums.  Conditions it does not use are accepted and ignored,
    as in the JAX package."""

    def __init__(self, latent_dim: int, num_heads: int, dropout: float = 0.0,
                 time_embed_dim=None, merged_lanes: bool = False):
        super().__init__()
        self.num_heads, self.merged_lanes = num_heads, merged_lanes
        self.norm = LayerNorm(latent_dim)
        self.query = Linear(latent_dim, latent_dim)
        self.key = Linear(latent_dim, latent_dim)
        self.value = Linear(latent_dim, latent_dim)
        self.proj_out = (None if time_embed_dim is None else
                         StylizationBlock(latent_dim, time_embed_dim, dropout))

    def forward(self, x, src_mask, emb=None, **kwargs):
        B, T, D = x.shape
        H = self.num_heads
        xn = self.norm(x)
        k_logits = self.key(xn) + (1 - src_mask) * NEG_INF
        v = self.value(xn) * src_mask
        if self.merged_lanes:
            q = self.query(xn).reshape(B, T, H, -1).softmax(dim=-1)
            k = k_logits.softmax(dim=1).reshape(B, T, H, -1)
            att = torch.einsum("bnhd,bnhl->bhdl", k, v.reshape(B, T, H, -1))
            y = torch.einsum("bthd,bhdl->bthl", q, att).reshape(B, T, D)
        else:
            y = fused_linear_attention(self.query(xn).reshape(B, T, H, -1),
                                       k_logits.reshape(B, T, H, -1),
                                       v.reshape(B, T, H, -1)).reshape(B, T, D)
        return x + (y if self.proj_out is None else self.proj_out(y, emb))


@ATTENTIONS.register_module()
class EfficientCrossAttention(nn.Module):
    """MotionDiffuse linear cross-attention: T motion queries against the N
    text tokens ``xf`` through K5; with ``cond_type`` [B, 1, 1] the text of
    an unconditional row is masked (keys at -1e6, values 0)."""

    def __init__(self, latent_dim: int, text_latent_dim: int, num_heads: int,
                 dropout: float = 0.0, time_embed_dim: int = 2048):
        super().__init__()
        self.num_heads = num_heads
        self.norm = LayerNorm(latent_dim)
        self.text_norm = LayerNorm(text_latent_dim)
        self.query = Linear(latent_dim, latent_dim)
        self.key = Linear(text_latent_dim, latent_dim)
        self.value = Linear(text_latent_dim, latent_dim)
        self.proj_out = StylizationBlock(latent_dim, time_embed_dim, dropout)

    def forward(self, x, xf=None, emb=None, cond_type=None, **kwargs):
        B, T, D = x.shape
        N, H = xf.shape[1], self.num_heads
        xn, tn = self.norm(x), self.text_norm(xf)
        key = self.key(tn)
        if cond_type is None:
            value = self.value(tn)
        else:
            tc = _text_cond(cond_type, B)
            key, value = key + (1 - tc) * NEG_INF, self.value(tn * tc)
        y = fused_linear_attention(self.query(xn).reshape(B, T, H, -1),
                                   key.reshape(B, N, H, -1),
                                   value.reshape(B, N, H, -1)).reshape(B, T, D)
        return x + self.proj_out(y, emb)


@ATTENTIONS.register_module()
class EfficientMixedAttention(nn.Module):
    """Linear attention of the motion queries over the text and the motion
    tokens joined (text first), each with its own key and value projections
    and masks, through K5.  Its training with dropout (the key softmax
    dropped out before the contraction, in the JAX package: inside K5)
    raises; no config builds this attention (ROADMAP queue 1: the rest of
    the baseline zoo)."""

    def __init__(self, latent_dim: int, text_latent_dim: int, num_heads: int,
                 dropout: float = 0.0, time_embed_dim: int = 2048):
        super().__init__()
        self.num_heads, self.dropout = num_heads, dropout
        self.norm = LayerNorm(latent_dim)
        self.text_norm = LayerNorm(text_latent_dim)
        self.query = Linear(latent_dim, latent_dim)
        self.key_text = Linear(text_latent_dim, latent_dim)
        self.value_text = Linear(text_latent_dim, latent_dim)
        self.key_motion = Linear(latent_dim, latent_dim)
        self.value_motion = Linear(latent_dim, latent_dim)
        self.proj_out = StylizationBlock(latent_dim, time_embed_dim, dropout)

    def forward(self, x, xf=None, emb=None, src_mask=None, cond_type=None, **kwargs):
        B, T, D = x.shape
        N, H = xf.shape[1] + T, self.num_heads
        xn, tn = self.norm(x), self.text_norm(xf)
        tc, sm = _text_cond(cond_type, B), src_mask.reshape(B, T, 1)
        key = torch.cat([self.key_text(tn) + (1 - tc) * NEG_INF,
                         self.key_motion(xn) + (1 - sm) * NEG_INF], dim=1).reshape(B, N, H, -1)
        value = torch.cat([self.value_text(tn) * tc, self.value_motion(xn) * sm],
                          dim=1).reshape(B, N, H, -1)
        query = self.query(xn).reshape(B, T, H, -1)
        if self.training and self.dropout > 0:
            raise NotImplementedError("EfficientMixedAttention with dropout in training: "
                                      "ROADMAP queue 1: the rest of the baseline zoo")
        y = fused_linear_attention(query, key, value)
        return x + self.proj_out(y.reshape(B, T, D), emb)


@ATTENTIONS.register_module()
class STMA(nn.Module):
    """MotionCraft MC-Attn."""

    def __init__(self, latent_dim: int, text_latent_dim: int, num_heads: int,
                 num_text_heads: int, num_experts: int, topk: int,
                 gate_type: str = "cosine_top", gate_noise: float = 1.0,
                 ffn_dim: int = 512, time_embed_dim: int = 2048,
                 max_seq_len: int = 196, max_text_seq_len: int = 77,
                 temporal_comb: bool = False, dropout: float = 0.0,
                 static_body: bool = True, dynamic_body: bool = False,
                 patch_size: int = 1, expert_axis=None):
        super().__init__()
        if patch_size != 1:
            raise NotImplementedError("STMA with patch_size > 1")
        if num_text_heads != 1:
            raise NotImplementedError("STMA with more than one text head")
        L, H = latent_dim, num_heads
        self.latent_dim, self.num_heads = L, H
        self.num_text_heads = num_text_heads
        self.static_body, self.dynamic_body = static_body, dynamic_body
        self.norm = LayerNorm(L)
        self.text_norm = LayerNorm(text_latent_dim)
        self.text_moe = MOE(num_experts, topk, text_latent_dim, text_latent_dim * 4,
                            2 * L, num_text_heads, max_text_seq_len, gate_type,
                            gate_noise, expert_axis=expert_axis)
        self.motion_moe = MOE(num_experts, topk, L, L * 4, 4 * L, H, max_seq_len,
                              gate_type, gate_noise, expert_axis=expert_axis)
        self.body_weight = nn.Parameter(torch.randn(H, H))
        if dynamic_body:
            self.body_d_attn = EfficientSelfAttention(L, 8, dropout, time_embed_dim=None,
                                                      merged_lanes=True)
        self.proj_out = StylizationBlock(H * L, time_embed_dim, dropout)

    def text_branch(self, xf, generator=None, aux_losses=None):
        """LayerNorm + text MoE of the text features: depends only on ``xf``,
        so at inference the caller computes it once per sampling call
        (STMoGenTransformer.precompute_text_feats)."""
        text_in = xf.reshape(xf.shape[0], xf.shape[1], self.num_text_heads, -1)
        return self.text_moe(self.text_norm(text_in), generator, aux_losses)

    def forward(self, x, xf=None, emb=None, src_mask=None, cond_type=None,
                cfg_dedup: bool = False, text_feat=None, generator=None,
                aux_losses=None, **kwargs):
        """``kwargs`` takes the conditions STMA does not use (the motion
        lengths and ``num_intervals``, which SAMI reads), as in the JAX
        package."""
        B, T, D = x.shape
        H, L = self.num_heads, self.latent_dim
        # CFG layer-0 dedup: the two batch halves are the same x/xf/emb, so the
        # motion MoE and the body graph run on the first half and are tiled
        dedup = cfg_dedup and not self.training and B % 2 == 0 and B > 1
        Bc = B // 2 if dedup else B
        xh = x.reshape(B, T, H, L)
        if text_feat is None:
            text_feat = self.text_branch(xf, generator, aux_losses)
        motion_feat = self.motion_moe(self.norm(xh[:Bc]), generator, aux_losses)

        body_value = motion_feat[..., :L]
        body_feat = body_value
        if self.static_body:
            body_feat = torch.einsum("hl,bnld->bnhd", *promote_dtype(
                self.body_weight.softmax(dim=1), body_value))
        body_feat = body_feat.reshape(Bc, T, D)
        if self.dynamic_body:
            d_in = body_value.reshape(Bc * T, H, L)
            d_mask = torch.ones(Bc * T, H, 1, dtype=x.dtype, device=x.device)
            body_feat = body_feat + self.body_d_attn(d_in, d_mask).reshape(Bc, T, D)
        if dedup:
            motion_feat = torch.cat([motion_feat, motion_feat], dim=0)
            body_feat = torch.cat([body_feat, body_feat], dim=0)

        text_cond = ((cond_type % 10) > 0).to(torch.float32).reshape(B, 1, 1)
        if self.training:
            tc, mask = text_cond[..., None], src_mask.reshape(B, T, 1, 1)
            TXT = text_feat.shape[1]
            key = torch.cat([
                (text_feat[..., :L] + (1 - tc) * NEG_INF).expand(B, TXT, H, L),
                motion_feat[..., L:2 * L] + (1 - mask) * NEG_INF], dim=1)
            value = torch.cat([(text_feat[..., L:] * tc).expand(B, TXT, H, L),
                               motion_feat[..., 2 * L:3 * L] * mask], dim=1)
            y_t = fused_linear_attention(motion_feat[..., 3 * L:], key, value)
        else:
            y_t = stma_linear_attention(motion_feat, text_feat.reshape(B, -1, 2 * L),
                                        src_mask.reshape(B, T, 1), text_cond)
        return x + self.proj_out(body_feat + y_t.reshape(B, T, D), emb)


def _interval_ffn(latent_dim: int, ffn_dim: int, out_dim: int) -> nn.Sequential:
    """SAMI's template FFN: Linear -> exact-erf GELU -> Linear (flax
    ``layers_0`` / ``layers_2``, the Sequential's 0 and 2)."""
    return nn.Sequential(Linear(latent_dim, ffn_dim), nn.GELU(),
                         Linear(ffn_dim, out_dim))


@ATTENTIONS.register_module()
class SAMI(nn.Module):
    """FineMoGen's spatio-temporal MoE attention.  With
    ``num_intervals`` NI, each run of NI consecutive batch rows is one
    sequence of intervals: row i's frame times and template times are offset
    by the lengths of the rows before it in its run."""

    def __init__(self, latent_dim: int, text_latent_dim: int, num_heads: int,
                 num_text_heads: int, num_experts: int, topk: int,
                 gate_type: str = "cosine_top", gate_noise: float = 1.0,
                 ffn_dim: int = 512, time_embed_dim: int = 2048,
                 max_seq_len: int = 196, max_text_seq_len: int = 77,
                 temporal_comb: bool = False, dropout: float = 0.0, expert_axis=None):
        super().__init__()
        L, H = latent_dim, num_heads
        self.latent_dim, self.num_heads = L, H
        self.num_text_heads, self.max_seq_len = num_text_heads, max_seq_len
        self.text_norm = LayerNorm(text_latent_dim)
        self.text_moe = MOE(num_experts, topk, text_latent_dim, text_latent_dim * 4,
                            2 * L, num_text_heads, max_text_seq_len, gate_type,
                            gate_noise, expert_axis=expert_axis)
        self.norm = LayerNorm(L)
        self.motion_moe = MOE(num_experts, topk, L, L * 4, 3 * L, H, max_seq_len,
                              gate_type, gate_noise, expert_axis=expert_axis)
        self.body_weight = nn.Parameter(torch.randn(H, H))
        self.sigma = nn.Parameter(torch.full((1,), 100.0))
        self.t_sigma = nn.Parameter(torch.ones(1))
        self.template_t = _interval_ffn(L, ffn_dim, 1)
        for name in ("template_s", "template_v", "template_a", "template_j"):
            self.add_module(name, _interval_ffn(L, ffn_dim, L))
        self.proj_out = StylizationBlock(H * L, time_embed_dim, dropout)

    def forward(self, x, xf=None, emb=None, src_mask=None, cond_type=None,
                motion_length=None, num_intervals: int = 1, generator=None,
                aux_losses=None, kl_losses=None, **kwargs):
        """``kwargs`` takes what the stack hands every ca_block and SAMI does
        not use (``cfg_dedup``: SAMI computes both CFG halves, so its MoEs
        route 2B rows as the JAX package's do; ``text_feat``, which is
        always None: SAMI has no text branch to hoist).  In ``train()``
        mode the MoEs draw their gate noise from ``generator`` and append
        their aux losses to ``aux_losses``, and the template times' KL is
        appended to ``kl_losses``."""
        B, T, D = x.shape
        H, L, S, NI = self.num_heads, self.latent_dim, self.max_seq_len, num_intervals
        xh = x.reshape(B, T, H, L)
        text_feat = self.text_moe(self.text_norm(
            xf.reshape(B, xf.shape[1], self.num_text_heads, -1)), generator, aux_losses)
        motion_feat = self.motion_moe(self.norm(xh), generator, aux_losses)
        body_feat = torch.einsum("hl,bnld->bnhd", *promote_dtype(
            self.body_weight.softmax(dim=1), motion_feat[..., :L])).reshape(B, T, D)

        tc = ((cond_type % 10) > 0).to(x.dtype).reshape(B, 1, 1, 1)
        mask = src_mask.reshape(B, T, 1, 1)
        TXT = text_feat.shape[1]
        key = torch.cat([(text_feat[..., :L] + (1 - tc) * NEG_INF).expand(B, TXT, H, L),
                         motion_feat[..., L:2 * L] + (1 - mask) * NEG_INF], dim=1)
        value = torch.cat([(text_feat[..., L:] * tc).expand(B, TXT, H, L),
                           motion_feat[..., 2 * L:] * mask], dim=1)
        template = torch.einsum("bnhd,bnhl->bhdl", key.softmax(dim=1), value)  # [B, H, L, L]

        template_t_feat = self.template_t(template)                     # [B, H, L, 1]
        template_t = torch.sigmoid(template_t_feat / self.t_sigma)
        if self.training and kl_losses is not None:
            feat = template_t_feat.squeeze(-1)
            mu = feat.mean(dim=-1)
            logvar = torch.log(feat.std(dim=-1, correction=0) + 1e-12)
            kl_losses.append(-0.5 * torch.sum(1 + logvar - mu * mu - torch.exp(logvar)))
        template_t = template_t * motion_length.reshape(B, 1, 1, 1).to(x.dtype) / S
        org_t = torch.arange(T, dtype=x.dtype, device=x.device) / S
        # each interval's frames start where the intervals before it in its
        # run of NI rows end
        ml = motion_length.reshape(B // NI, NI).to(x.dtype)
        offsets = torch.cumsum(ml, dim=1) - ml
        t = org_t[None, None, :] + offsets[:, :, None] / S              # [B/NI, NI, T]
        tt = template_t.reshape(B // NI, NI, H, L) + offsets[:, :, None, None] / S
        tt = tt.transpose(1, 2)[:, None].expand(B // NI, NI, H, NI, L).reshape(B, 1, H, NI * L)
        time_delta = (t.reshape(B, T, 1, 1) - tt) * S                  # [B, T, H, NI*L]
        time_coef = (-(time_delta * time_delta) / self.sigma).softmax(dim=-1)

        tmpl = template.reshape(B // NI, NI, H, L, L).transpose(1, 2)[:, None]
        tmpl = tmpl.expand(B // NI, NI, H, NI, L, L).reshape(B, H, NI * L, L)
        ts_, tv_, ta_, tj_ = (getattr(self, f"template_{k}")(tmpl) for k in "svaj")
        tt1 = tt.reshape(B, H, NI * L, 1)
        tt2 = tt1 * tt1
        a0 = ts_ - tv_ * tt1 + ta_ * tt2 - tj_ * (tt2 * tt1)
        a1 = tv_ - 2 * ta_ * tt1 + 3 * tj_ * tt2
        a2 = ta_ - 3 * tj_ * tt1

        def mix(a):
            return torch.einsum("bnhd,bhdl->bnhl", time_coef, a).reshape(B, T, D)

        tb = t.reshape(B, T, 1)
        tb2 = tb * tb
        y_t = mix(a0) + mix(a1) * tb + mix(a2) * tb2 + mix(tj_) * (tb2 * tb)
        return x + self.proj_out(body_feat + y_t, emb)


class _SemanticsModulatedBase(nn.Module):
    """The projections ReMoDiffuse's attentions share, and their text and
    retrieval keys and values."""

    def __init__(self, latent_dim: int, text_latent_dim: int, num_heads: int,
                 dropout: float = 0.0, time_embed_dim: int = 2048):
        super().__init__()
        D = latent_dim
        self.latent_dim, self.num_heads = D, num_heads
        self.norm = LayerNorm(D)
        self.text_norm = LayerNorm(text_latent_dim)
        self.query = Linear(D, D)
        self.key_text = Linear(text_latent_dim, D)
        self.value_text = Linear(text_latent_dim, D)
        self.key_motion = Linear(D, D)
        self.value_motion = Linear(D, D)
        self.retr_norm1 = LayerNorm(2 * D)
        self.retr_norm2 = LayerNorm(D)
        self.key_retr = Linear(2 * D, D)
        self.value_retr = ZeroDense(D, D)
        self.proj_out = StylizationBlock(D, time_embed_dim, dropout)

    def text_and_retrieval(self, xf, cond_type, re_dict):
        """(keys, values) of the text tokens and the retrieved frames,
        masked: [B, N_text + R x Tr, D] each."""
        re_motion, re_text = re_dict["re_motion"], re_dict["re_text"]  # [B, R, Tr|1, D]
        B, R, Tr, D = re_motion.shape
        re_mask = re_dict["re_mask"].reshape(B, R * Tr, 1)
        tn = self.text_norm(xf)
        cond_type = cond_type.reshape(B, 1, 1)
        text_cond = ((cond_type % 10) > 0).to(xf.dtype)
        retr_cond = ((cond_type // 10) > 0).to(xf.dtype)
        re_feat_key = torch.cat([re_motion, re_text.expand(B, R, Tr, D)],
                                dim=-1).reshape(B, R * Tr, 2 * D)
        keys = torch.cat([
            self.key_text(tn) + (1 - text_cond) * NEG_INF,
            self.key_retr(self.retr_norm1(re_feat_key)) + (1 - retr_cond) * NEG_INF
            + (1 - re_mask) * NEG_INF], dim=1)
        values = torch.cat([
            self.value_text(tn) * text_cond,
            self.value_retr(self.retr_norm2(re_motion.reshape(B, R * Tr, D)))
            * retr_cond * re_mask], dim=1)
        return keys, values

    def attend(self, xn, key, value):
        """K5 of the normalised motion's queries over ``key`` / ``value``
        [B, N, D] -> [B, T, D]."""
        B, T, D = xn.shape
        N, H = key.shape[1], self.num_heads
        return fused_linear_attention(self.query(xn).reshape(B, T, H, -1),
                                      key.reshape(B, N, H, -1),
                                      value.reshape(B, N, H, -1)).reshape(B, T, D)


@ATTENTIONS.register_module()
class SemanticsModulatedAttention(_SemanticsModulatedBase):
    """ReMoDiffuse's retrieval-conditioned linear attention over text,
    retrieval and motion keys (N = N_text + R x Tr + T)."""

    def forward(self, x, xf=None, emb=None, src_mask=None, cond_type=None, re_dict=None,
                **kwargs):
        xn = self.norm(x)
        kv_key, kv_value = self.text_and_retrieval(xf, cond_type, re_dict)
        key = torch.cat([kv_key, self.key_motion(xn) + (1 - src_mask) * NEG_INF], dim=1)
        value = torch.cat([kv_value, self.value_motion(xn) * src_mask], dim=1)
        return x + self.proj_out(self.attend(xn, key, value), emb)


@ATTENTIONS.register_module()
class DualSemanticsModulatedAttention(_SemanticsModulatedBase):
    """MoMatMoGen's two-person version: x [B, T, 2 x latent], each person's
    queries over the text, the retrieval, its own motion and the other
    person's (``key_inter`` / ``value_inter``), with one set of weights
    (N = N_text + R x Tr + 2 T)."""

    def __init__(self, latent_dim: int, text_latent_dim: int, num_heads: int,
                 dropout: float = 0.0, time_embed_dim: int = 2048):
        super().__init__(latent_dim, text_latent_dim, num_heads, dropout, time_embed_dim)
        self.key_inter = Linear(latent_dim, latent_dim)
        self.value_inter = Linear(latent_dim, latent_dim)

    def forward(self, x, xf=None, emb=None, src_mask=None, cond_type=None, re_dict=None,
                **kwargs):
        L = self.latent_dim
        x1, x2 = x[:, :, :L], x[:, :, L:]
        kt, vt = self.text_and_retrieval(xf, cond_type, re_dict)
        n1, n2 = self.norm(x1), self.norm(x2)

        def person(nx, nother):
            key = torch.cat([kt, self.key_motion(nx) + (1 - src_mask) * NEG_INF,
                             self.key_inter(nother) + (1 - src_mask) * NEG_INF], dim=1)
            value = torch.cat([vt, self.value_motion(nx) * src_mask,
                               self.value_inter(nother) * src_mask], dim=1)
            return self.attend(nx, key, value)

        y1 = x1 + self.proj_out(person(n1, n2), emb)
        y2 = x2 + self.proj_out(person(n2, n1), emb)
        return torch.cat([y1, y2], dim=-1)
