"""Reference PyTorch checkpoints into the port (a copy of the converters of
motioncraft_tpu/utils/torch_convert.py that the flagship and its evaluator
need).

A reference checkpoint names its tensors after the reference's modules
(mmcv / tutel / HuggingFace naming).  Each ``convert_*`` maps such a state
dict onto the flax parameter tree of the JAX package (and, for BatchNorm,
its ``batch_stats`` tree), exactly as the JAX package does;
``utils/convert.py:from_jax_variables`` then maps those trees onto the
port's ``state_dict``, and ``load_into`` loads it with ``strict=True``.  So
a reference file takes one route into both packages.

Conventions: torch Linear weight [out, in] -> flax Dense kernel [in, out]
(transpose); Conv1d weight [out, in, k] -> Conv kernel [k, in, out];
LayerNorm / BatchNorm weight, bias -> scale, bias; BatchNorm running_mean,
running_var -> batch_stats mean, var.

The baselines' converters (MCM and its ControlNet, MotionDiffuse, MDM in
both its namings, FineMoGen, ReMoDiffuse / MoMatMoGen with the retrieval
encoder), the HumanML3D / KIT-ML BiGRU evaluator's, the S2G embedding
model's (VAESKConv) and HuggingFace Wav2Vec2's are here too.  The
evaluator's modules are torch ones laid out as the reference's, so its
checkpoint loads by renaming keys.
"""

from __future__ import annotations

import re
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .convert import from_jax_variables


def load_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict):
        # "model_state" is the EMAGE trainer format
        for key in ("state_dict", "model_state", "model", "module"):
            if key in obj and isinstance(obj[key], dict):
                obj = obj[key]
                break
    return {k: v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)
            for k, v in obj.items()}


def load_into(module: torch.nn.Module, tree: dict,
              stats: Optional[dict] = None) -> Dict[str, torch.Tensor]:
    """Carry a flax ``params`` tree (and a ``batch_stats`` tree) into
    ``module``: every leaf must name one of its tensors with the same shape
    (the JAX package's ``_tree_update``); tensors the trees leave out keep
    their values.  Loaded with ``strict=True``; returns the state_dict
    loaded."""
    sd = {k: v.detach().cpu() for k, v in module.state_dict().items()}
    for name, value in from_jax_variables({"params": tree,
                                           "batch_stats": stats or {}}).items():
        if name not in sd:
            raise KeyError(f"{name} is not a tensor of {type(module).__name__}")
        if tuple(sd[name].shape) != tuple(value.shape):
            raise ValueError(f"shape mismatch for {name}: port {tuple(sd[name].shape)} "
                             f"vs checkpoint {tuple(value.shape)}")
        sd[name] = value
    module.load_state_dict(sd, strict=True)
    return sd


def _k(prefix, name):
    return f"{prefix}.{name}" if prefix else name


def t_linear(sd, prefix):
    out = {"kernel": sd[_k(prefix, "weight")].T}
    if _k(prefix, "bias") in sd:
        out["bias"] = sd[_k(prefix, "bias")]
    return out


def t_layernorm(sd, prefix):
    return {"scale": sd[_k(prefix, "weight")], "bias": sd[_k(prefix, "bias")]}


def t_conv1d(sd, prefix):
    # [out, in, k] -> [k, in, out]
    out = {"kernel": np.transpose(sd[_k(prefix, "weight")], (2, 1, 0))}
    if _k(prefix, "bias") in sd:
        out["bias"] = sd[_k(prefix, "bias")]
    return out


def t_bn(sd, prefix):
    """torch BatchNorm1d -> (flax params, flax batch_stats)."""
    return ({"scale": sd[_k(prefix, "weight")], "bias": sd[_k(prefix, "bias")]},
            {"mean": sd[_k(prefix, "running_mean")], "var": sd[_k(prefix, "running_var")]})


def t_wav_encoder(sd, prefix):
    """The reference WavEncoder (six BasicBlocks under feat_extractor.N; the
    shortcut as downsample.0 / .1) -> (params, batch_stats) trees of the
    port's WavEncoder (block0..block5)."""
    params, stats = {}, {}
    for i in range(6):
        base = _k(prefix, f"feat_extractor.{i}")
        bp, bs = {"conv1": t_conv1d(sd, f"{base}.conv1"),
                  "conv2": t_conv1d(sd, f"{base}.conv2")}, {}
        for bn in ("bn1", "bn2"):
            bp[bn], bs[bn] = t_bn(sd, f"{base}.{bn}")
        if f"{base}.downsample.0.weight" in sd:
            bp["down_conv"] = t_conv1d(sd, f"{base}.downsample.0")
            bp["down_bn"], bs["down_bn"] = t_bn(sd, f"{base}.downsample.1")
        params[f"block{i}"], stats[f"block{i}"] = bp, bs
    return params, stats


def t_embedding(sd, prefix):
    return {"embedding": sd[_k(prefix, "weight")]}


def t_mha(sd, prefix):
    """torch nn.MultiheadAttention -> ClipAttention (fused in_proj)."""
    return {
        "in_proj": {"kernel": sd[_k(prefix, "in_proj_weight")].T,
                    "bias": sd[_k(prefix, "in_proj_bias")]},
        "out_proj": {"kernel": sd[_k(prefix, "out_proj.weight")].T,
                     "bias": sd[_k(prefix, "out_proj.bias")]},
    }


def t_postln_layer(sd, prefix):
    """torch nn.TransformerEncoderLayer -> PostLNEncoderLayer."""
    return {
        "self_attn": t_mha(sd, _k(prefix, "self_attn")),
        "linear1": t_linear(sd, _k(prefix, "linear1")),
        "linear2": t_linear(sd, _k(prefix, "linear2")),
        "norm1": t_layernorm(sd, _k(prefix, "norm1")),
        "norm2": t_layernorm(sd, _k(prefix, "norm2")),
    }


# -------------------------------------------------------------- evaluator
def convert_actor_agnostic(sd: Dict[str, np.ndarray], num_layers: int = 4) -> dict:
    out = {"skel_embedding": t_linear(sd, "skel_embedding"),
           "mu_token": sd["mu_token"], "logvar_token": sd["logvar_token"]}
    for i in range(num_layers):
        out[f"layer_{i}"] = t_postln_layer(sd, f"seqTransEncoder.layers.{i}")
    return out


def convert_distilbert(sd: Dict[str, np.ndarray], prefix: str = "text_model.") -> dict:
    g = lambda name: f"{prefix}{name}"  # noqa: E731
    out = {
        "word_embeddings": t_embedding(sd, g("embeddings.word_embeddings")),
        "position_embeddings": t_embedding(sd, g("embeddings.position_embeddings")),
        "emb_ln": t_layernorm(sd, g("embeddings.LayerNorm")),
    }
    for i in range(6):
        lp = g(f"transformer.layer.{i}")
        qw, kw, vw = (sd[f"{lp}.attention.{n}.weight"] for n in ("q_lin", "k_lin", "v_lin"))
        qb, kb, vb = (sd[f"{lp}.attention.{n}.bias"] for n in ("q_lin", "k_lin", "v_lin"))
        out[f"layer_{i}"] = {
            "self_attn": {
                "in_proj": {"kernel": np.concatenate([qw, kw, vw], axis=0).T,
                            "bias": np.concatenate([qb, kb, vb])},
                "out_proj": t_linear(sd, f"{lp}.attention.out_lin"),
            },
            "linear1": t_linear(sd, f"{lp}.ffn.lin1"),
            "linear2": t_linear(sd, f"{lp}.ffn.lin2"),
            "norm1": t_layernorm(sd, f"{lp}.sa_layer_norm"),
            "norm2": t_layernorm(sd, f"{lp}.output_layer_norm"),
        }
    return out


def convert_smplx_evaluator(sd: Dict[str, np.ndarray], num_layers: int = 4
                            ) -> Tuple[dict, dict]:
    """epoch=199.ckpt ('motionencoder.*' / 'textencoder.*' keys) -> the
    motion and text encoders' flax ``params`` trees."""
    msd = {k[len("motionencoder."):]: v for k, v in sd.items()
           if k.startswith("motionencoder.")}
    tsd = {k[len("textencoder."):]: v for k, v in sd.items()
           if k.startswith("textencoder.")}
    text = {"projection": t_linear(tsd, "projection.1"),
            "mu_token": tsd["mu_token"], "logvar_token": tsd["logvar_token"],
            "text_model": convert_distilbert(tsd)}
    for i in range(num_layers):
        text[f"layer_{i}"] = t_postln_layer(tsd, f"seqTransEncoder.layers.{i}")
    return convert_actor_agnostic(msd, num_layers), text


def load_smplx_evaluator_ckpt(path: str, motion_module: torch.nn.Module,
                              text_module: torch.nn.Module, num_layers: int = 4):
    """Load the SMPL-X evaluator's reference checkpoint into the port's
    motion and text encoders; returns their two state_dicts."""
    motion, text = convert_smplx_evaluator(load_torch_state_dict(path), num_layers)
    return load_into(motion_module, motion), load_into(text_module, text)



def convert_vaeskconv(sd: Dict[str, np.ndarray], num_layers: int = 4) -> Tuple[dict, dict]:
    """EMAGE VAESKConv (``AESKConv_240_100.bin``) -> the flax param trees of
    the encoder and of fc_mu.  The reference's layout: each encoder layer a
    Sequential(SkeletonResidual) with ``residual.0`` the masked conv [out,
    in, k], ``residual.1`` GroupNorm(10), ``shortcut`` the 1x1 masked conv;
    ``fc_mu`` a Linear.  The neighbourhood masks and pooling matrices are
    structure, recomputed from the kinematic tree, and skipped (the raw
    weights are zero outside the mask); the decoder is not needed for the
    embedding."""
    def masked_conv(prefix):
        # MaskedConv1d names its [k, in, out] kernel "weight"
        c = t_conv1d(sd, prefix)
        return {"weight": c["kernel"], "bias": c["bias"]}

    enc = {}
    for i in range(num_layers):
        p = f"encoder.layers.{i}.0"
        enc[f"layer_{i}"] = {
            "conv": masked_conv(f"{p}.residual.0"),
            "gn": {"scale": sd[f"{p}.residual.1.weight"], "bias": sd[f"{p}.residual.1.bias"]},
            "shortcut": masked_conv(f"{p}.shortcut"),
        }
    return enc, t_linear(sd, "fc_mu")


def load_vaeskconv_ckpt(path: str, encoder: torch.nn.Module, fc_mu: torch.nn.Module,
                        num_layers: int = 4):
    """Load the EMAGE S2G embedding model's checkpoint (``module.``
    prefixes dropped) into the port's encoder and fc_mu; returns their two
    state_dicts."""
    sd = {k.removeprefix("module."): v for k, v in load_torch_state_dict(path).items()}
    enc, mu = convert_vaeskconv(sd, num_layers)
    return load_into(encoder, enc), load_into(fc_mu, mu)

def _renamed(sd, names):
    """The tensors of ``sd`` under each (reference prefix, port prefix) of
    ``names``, moved under the port's prefix ('' for none)."""
    return {_k(port, k[len(ref) + 1:]): v.detach().cpu() for ref, port in names
            for k, v in sd.items() if k.startswith(ref + ".")}


def load_t2m_evaluator_ckpt(path: str, movement: torch.nn.Module, motion_gru: torch.nn.Module,
                            text_gru: torch.nn.Module, pos_emb: torch.nn.Module):
    """Load the HumanML3D / KIT-ML evaluator's reference checkpoint
    (``finest.tar``: the ``movement_encoder``, ``motion_encoder`` and
    ``text_encoder`` state dicts) into the port's four modules
    (``strict=True``): ``main.0`` / ``main.3`` -> ``conv1`` / ``conv2``,
    ``output_net.{0,1,3}`` -> ``out1`` / ``out_ln`` / ``out2``, ``hidden``
    [2, 1, H] -> [2, H], the GRU's and the rest's keys as they are.  Returns
    their state_dicts."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    mov, mot, txt = (obj[k] for k in ("movement_encoder", "motion_encoder", "text_encoder"))

    def bigru(sd):
        out = _renamed(sd, (("input_emb", "input_emb"), ("gru", "gru"), ("output_net.0", "out1"),
                            ("output_net.1", "out_ln"), ("output_net.3", "out2")))
        out["hidden"] = sd["hidden"].detach().cpu().reshape(2, -1)
        return out

    loaded = []
    for module, sd in ((movement, _renamed(mov, (("main.0", "conv1"), ("main.3", "conv2"),
                                                 ("out_net", "out_net")))),
                       (motion_gru, bigru(mot)), (text_gru, bigru(txt)),
                       (pos_emb, _renamed(txt, (("pos_emb", ""),)))):
        module.load_state_dict(sd, strict=True)
        loaded.append(sd)
    return tuple(loaded)


# ------------------------------------------------------------------ CLIP
def convert_clip_text(sd: Dict[str, np.ndarray], layers: int = 12) -> dict:
    """OpenAI CLIP state dict -> ClipTextModel params."""
    out = {
        "token_embedding": {"embedding": sd["token_embedding.weight"]},
        "positional_embedding": sd["positional_embedding"],
        "ln_final": t_layernorm(sd, "ln_final"),
    }
    for i in range(layers):
        p = f"transformer.resblocks.{i}"
        out[f"resblock_{i}"] = {
            "attn": t_mha(sd, f"{p}.attn"),
            "ln_1": t_layernorm(sd, f"{p}.ln_1"),
            "ln_2": t_layernorm(sd, f"{p}.ln_2"),
            "mlp_fc": t_linear(sd, f"{p}.mlp.c_fc"),
            "mlp_proj": t_linear(sd, f"{p}.mlp.c_proj"),
        }
    return out


def strip_base_block_keys(sd: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """'temporal_decoder_blocks.N.base_block.xxx' -> 'temporal_decoder_blocks.N.xxx':
    the base model of a merged ControlNet checkpoint in the layout of a
    base-only one.  (The JAX package's loader maps the other way, every
    block key under base_block, and so cannot read a base-only file.)"""
    pat = re.compile(r"^((?:model\.)?temporal_decoder_blocks\.\d+\.)base_block\.")
    return {pat.sub(r"\1", k): v for k, v in sd.items()}


# ----------------------------------------------------------------- STMoGen
def t_stylization(sd, prefix):
    """StylizationBlock: emb_layers(Sequential[SiLU, Linear]), norm,
    out_layers(Sequential[SiLU, Dropout, Linear])."""
    return {
        "emb_layers": t_linear(sd, _k(prefix, "emb_layers.1")),
        "norm": t_layernorm(sd, _k(prefix, "norm")),
        "out_layers": {"linear": t_linear(sd, _k(prefix, "out_layers.2"))},
    }


def t_moe(sd, prefix):
    """Reference MOE wrapper + tutel moe_layer -> the MOE/MoELayer tree.

    tutel stores batched_fc1_w as [E, F, D] (nn.Linear convention) and
    batched_fc2_w as [E, F, D_out]; biases are [E, 1, *].  The tree's
    expert_w1 is [E, D, F] and expert_w2 [E, F, D], so fc1 transposes and
    fc2 passes through; F is read from fc1_bias so the mapping holds even
    where D == F."""
    g = lambda n: _k(prefix, n)  # noqa: E731
    out = {"embedding": sd[g("embedding")], "proj": t_linear(sd, g("proj"))}
    gate_prefix = g("model.gates.0")  # the cosine gate; the port has no linear one
    gate = {"cosine_projector": t_linear(sd, f"{gate_prefix}.cosine_projector"),
            "sim_matrix": sd[f"{gate_prefix}.sim_matrix"],
            "temperature": sd[f"{gate_prefix}.temperature"].reshape(1)}
    b1 = sd[g("model.experts.batched_fc1_bias")]
    b2 = sd[g("model.experts.batched_fc2_bias")]
    w1 = sd[g("model.experts.batched_fc1_w")]
    hidden = b1.reshape(b1.shape[0], -1).shape[1]
    if (w1.shape[1] == hidden and w1.shape[2] != hidden) or w1.shape[1] == w1.shape[2]:
        w1 = w1.transpose(0, 2, 1)  # tutel [E, F, D] -> [E, D, F]
    out["model"] = {
        "gate": gate,
        "expert_w1": w1,
        "expert_b1": b1.reshape(b1.shape[0], -1),
        "expert_w2": sd[g("model.experts.batched_fc2_w")],
        "expert_b2": b2.reshape(b2.shape[0], -1),
    }
    return out


def t_stma(sd, prefix):
    """STMA attention params."""
    g = lambda n: _k(prefix, n)  # noqa: E731
    out = {
        "norm": t_layernorm(sd, g("norm")),
        "text_norm": t_layernorm(sd, g("text_norm")),
        "text_moe": t_moe(sd, g("text_moe")),
        "motion_moe": t_moe(sd, g("motion_moe")),
        "body_weight": sd[g("body_weight")],
        "proj_out": t_stylization(sd, g("proj_out")),
    }
    if f"{g('body_d_attn')}.query.weight" in sd:
        out["body_d_attn"] = {
            "norm": t_layernorm(sd, g("body_d_attn.norm")),
            "query": t_linear(sd, g("body_d_attn.query")),
            "key": t_linear(sd, g("body_d_attn.key")),
            "value": t_linear(sd, g("body_d_attn.value")),
        }
    return out


def t_sffn(sd, prefix, num_heads):
    """SFFN per-head Linear lists -> stacked [H, d, f] weights."""
    g = lambda n: _k(prefix, n)  # noqa: E731
    w1 = np.stack([sd[g(f"linear1_list.{i}.weight")].T for i in range(num_heads)])
    b1 = np.stack([sd[g(f"linear1_list.{i}.bias")] for i in range(num_heads)])
    w2 = np.stack([sd[g(f"linear2_list.{i}.weight")].T for i in range(num_heads)])
    b2 = np.stack([sd[g(f"linear2_list.{i}.bias")] for i in range(num_heads)])
    return {"w1": w1, "b1": b1, "w2": w2, "b2": b2,
            "proj_out": t_stylization(sd, g("proj_out"))}


def t_pose_io(sd, prefix, suffix):
    """PoseEncoder/Decoder: one Linear per body part, or with patch_size > 1
    a PatchEmbed1D's conv (``{part}_embed.proj``)."""
    parts = {}
    for name in ("head", "stem", "larm", "rarm", "lleg", "rleg", "root",
                 "trans", "face", "lhand", "rhand", "body"):
        key = _k(prefix, f"{name}_{suffix}")
        if f"{key}.weight" in sd:
            parts[f"{name}_{suffix}"] = t_linear(sd, key)
        elif f"{key}.proj.weight" in sd:  # PatchEmbed1D
            parts[f"{name}_{suffix}"] = {"proj": t_conv1d(sd, f"{key}.proj")}
    return parts


def convert_stmogen(sd: Dict[str, np.ndarray], num_layers: int, num_heads: int,
                    text_num_layers: int = 2, clip_layers: int = 12) -> dict:
    """Full STMoGenTransformer checkpoint -> flax param tree.  Accepts the
    released mmcv checkpoints ('model.' prefixed keys from
    MotionDiffusion)."""
    if any(k.startswith("model.") for k in sd):
        sd = {k[len("model."):]: v for k, v in sd.items() if k.startswith("model.")}

    out: dict = {
        "sequence_embedding": sd["sequence_embedding"],
        "time_embed": {"layers_0": t_linear(sd, "time_embed.0"),
                       "layers_2": t_linear(sd, "time_embed.2")},
        "joint_embed": t_pose_io(sd, "joint_embed", "embed"),
        "out": t_pose_io(sd, "out", "out"),
    }
    text = {"text_ln": t_layernorm(sd, "text_ln")}
    if "text_pre_proj.weight" in sd:
        text["text_pre_proj"] = t_linear(sd, "text_pre_proj")
    for i in range(text_num_layers):
        text[f"textTransEncoder_{i}"] = t_postln_layer(sd, f"textTransEncoder.layers.{i}")
    if "clip.token_embedding.weight" in sd:
        clip_sd = {k[len("clip."):]: v for k, v in sd.items() if k.startswith("clip.")}
        text["clip"] = convert_clip_text(clip_sd, clip_layers)
    out["text_enc"] = text

    for i in range(num_layers):
        p = f"temporal_decoder_blocks.{i}"
        out[f"block_{i}"] = {
            "ca_block": t_stma(sd, f"{p}.ca_block"),
            "ffn": t_sffn(sd, f"{p}.ffn", num_heads),
        }
    return out


def load_stmogen_ckpt(path: str, model: torch.nn.Module, num_layers: int, num_heads: int,
                      text_num_layers: int = 2, clip_layers: int = 12
                      ) -> Dict[str, torch.Tensor]:
    """Load a released STMoGen .pth (base-only, or the base of a merged
    ControlNet one) into the port's STMoGenTransformer (shape-checked,
    ``strict=True``); returns the state_dict loaded."""
    sd = strip_base_block_keys(load_torch_state_dict(path))
    tree = convert_stmogen(sd, num_layers, num_heads, text_num_layers, clip_layers)
    return load_into(model, tree)


# -------------------------------------------------------------- ControlNet
def convert_controlnet(sd: Dict[str, np.ndarray], num_layers: int, num_heads: int,
                       copy_blocks_num: int, text_num_layers: int = 2,
                       clip_layers: int = 12, block_type: str = "stmogen") -> Tuple[dict, dict]:
    """Merged base+control checkpoint (the released format: keys
    base_model.* / controlnet.N.* / control_cond_input.*, and for speech the
    WavEncoder's condition_pre_encoder.pre_encoder.feat_extractor.N.*) ->
    the ControlT2MHalf flax (params, batch_stats) trees; batch_stats is
    empty without a WavEncoder.  ``block_type="mcm"``: the base is an MCM
    (``convert_mcm``) and so is each copied block (``t_mcm_layer``)."""
    if any(k.startswith("model.") for k in sd):
        sd = {k[len("model."):]: v for k, v in sd.items() if k.startswith("model.")}
    base_sd = {k[len("base_model."):]: v for k, v in sd.items() if k.startswith("base_model.")}
    params: dict = {"base_model": _convert_base(base_sd, num_layers, num_heads,
                                                text_num_layers, clip_layers, block_type)}
    for i in range(copy_blocks_num):
        p = f"controlnet.{i}"
        if block_type == "mcm":
            copied = t_mcm_layer(sd, f"{p}.copied_block")
        else:
            copied = {"ca_block": t_stma(sd, f"{p}.copied_block.ca_block"),
                      "ffn": t_sffn(sd, f"{p}.copied_block.ffn", num_heads)}
        blk = {"copied_block": copied, "after_proj": {"linear": t_linear(sd, f"{p}.after_proj")}}
        if i == 0:
            blk["before_proj"] = t_linear(sd, f"{p}.before_proj")
        params[f"controlnet_{i}"] = blk
    stats: dict = {}
    if any(k.startswith("condition_pre_encoder.") for k in sd):
        params["condition_pre_encoder"], stats["condition_pre_encoder"] = t_wav_encoder(
            sd, "condition_pre_encoder.pre_encoder")
    params["control_cond_input"] = {"linear": t_linear(sd, "control_cond_input")}
    return params, stats


def _convert_base(sd, num_layers, num_heads, text_num_layers, clip_layers, block_type):
    """A ControlNet's base: MCM's tree or STMoGen's."""
    if block_type == "mcm":
        return convert_mcm(sd, num_layers, text_num_layers, clip_layers)
    return convert_stmogen(sd, num_layers, num_heads, text_num_layers, clip_layers)


def load_controlnet_ckpt(path: str, model: torch.nn.Module, num_layers: int, num_heads: int,
                         copy_blocks_num: int, text_num_layers: int = 2,
                         clip_layers: int = 12, block_type: str = "stmogen"
                         ) -> Dict[str, torch.Tensor]:
    """Load a released merged base+control .pth into the port's
    ControlT2MHalf (``block_type`` "stmogen" or "mcm").  A base-only file
    (no base_model.* keys) fills the base and leaves the control branch as
    it is.  Returns the state_dict loaded."""
    sd = load_torch_state_dict(path)
    flat = {k[len("model."):] if k.startswith("model.") else k: v for k, v in sd.items()}
    if any(k.startswith("base_model.") for k in flat):
        tree, stats = convert_controlnet(flat, num_layers, num_heads, copy_blocks_num,
                                         text_num_layers, clip_layers, block_type)
        return load_into(model, tree, stats)
    tree = {"base_model": _convert_base(strip_base_block_keys(flat), num_layers, num_heads,
                                        text_num_layers, clip_layers, block_type)}
    return load_into(model, tree)


# ------------------------------------------------------ MCM / MotionDiffuse
def t_eff_attention(sd, prefix):
    """Efficient/Base self- or cross-attention: norm [+ text_norm],
    query/key/value (or the mixed attention's text and motion pairs),
    optional StylizationBlock."""
    out = {"norm": t_layernorm(sd, _k(prefix, "norm"))}
    if f"{_k(prefix, 'text_norm')}.weight" in sd:
        out["text_norm"] = t_layernorm(sd, _k(prefix, "text_norm"))
    for name in ("query", "key", "value", "key_text", "key_motion",
                 "value_text", "value_motion"):
        if f"{_k(prefix, name)}.weight" in sd:
            out[name] = t_linear(sd, _k(prefix, name))
    if f"{_k(prefix, 'proj_out')}.norm.weight" in sd:
        out["proj_out"] = t_stylization(sd, _k(prefix, "proj_out"))
    return out


def t_ffn(sd, prefix):
    """The baselines' FFN: linear1, the zero-init linear2, proj_out."""
    return {"linear1": t_linear(sd, _k(prefix, "linear1")),
            "linear2": {"linear": t_linear(sd, _k(prefix, "linear2"))},
            "proj_out": t_stylization(sd, _k(prefix, "proj_out"))}


def t_mcm_layer(sd, prefix):
    """MCM's decoder layer: channel sa, two FFNs, text ca."""
    return {"sa_block": t_eff_attention(sd, _k(prefix, "sa_block")),
            "ca_block": t_eff_attention(sd, _k(prefix, "ca_block")),
            "ffn_channel": t_ffn(sd, _k(prefix, "ffn_channel")),
            "ffn_temporal": t_ffn(sd, _k(prefix, "ffn_temporal"))}


def _convert_text_enc(sd, text_num_layers, clip_layers):
    """The text encoder: text_ln, text_pre_proj, the pooled text_proj (mogen
    wraps it in an nn.Sequential: text_proj.0), the post-LN layers and
    CLIP where the file holds it."""
    text = {"text_ln": t_layernorm(sd, "text_ln")}
    if "text_pre_proj.weight" in sd:
        text["text_pre_proj"] = t_linear(sd, "text_pre_proj")
    if "text_proj.0.weight" in sd:
        text["text_proj"] = t_linear(sd, "text_proj.0")
    elif "text_proj.weight" in sd:
        text["text_proj"] = t_linear(sd, "text_proj")
    for i in range(text_num_layers):
        text[f"textTransEncoder_{i}"] = t_postln_layer(sd, f"textTransEncoder.layers.{i}")
    if "clip.token_embedding.weight" in sd:
        clip_sd = {k[len("clip."):]: v for k, v in sd.items() if k.startswith("clip.")}
        text["clip"] = convert_clip_text(clip_sd, clip_layers)
    return text


def _skeleton(sd, text_num_layers, clip_layers):
    """The generic skeleton's tensors: time MLP, Linear joint embedding,
    zero-init output, text encoder, sequence embedding."""
    out = {"time_embed": {"layers_0": t_linear(sd, "time_embed.0"),
                          "layers_2": t_linear(sd, "time_embed.2")},
           "joint_embed": t_linear(sd, "joint_embed"),
           "out": {"linear": t_linear(sd, "out")},
           "text_enc": _convert_text_enc(sd, text_num_layers, clip_layers)}
    if "sequence_embedding" in sd:
        out["sequence_embedding"] = sd["sequence_embedding"]
    return out


def _strip_model(sd):
    if any(k.startswith("model.") for k in sd):
        sd = {k[len("model."):]: v for k, v in sd.items() if k.startswith("model.")}
    return sd


def convert_mcm(sd: Dict[str, np.ndarray], num_layers: int, text_num_layers: int = 4,
                clip_layers: int = 12) -> dict:
    """MCMTransformer checkpoint -> flax param tree."""
    sd = _strip_model(sd)
    out = _skeleton(sd, text_num_layers, clip_layers)
    for i in range(num_layers):
        out[f"block_{i}"] = t_mcm_layer(sd, f"temporal_decoder_blocks.{i}")
    return out


def load_mcm_ckpt(path: str, model: torch.nn.Module, num_layers: int,
                  text_num_layers: int = 4, clip_layers: int = 12) -> Dict[str, torch.Tensor]:
    """Load a reference MCM .pth into the port's MCMTransformer; returns the
    state_dict loaded."""
    tree = convert_mcm(load_torch_state_dict(path), num_layers, text_num_layers, clip_layers)
    return load_into(model, tree)


def convert_motiondiffuse(sd: Dict[str, np.ndarray], num_layers: int,
                          text_num_layers: int = 4, clip_layers: int = 12) -> dict:
    """MotionDiffuseTransformer checkpoint (Efficient self + cross attention
    blocks + FFN) -> flax param tree."""
    sd = _strip_model(sd)
    out = _skeleton(sd, text_num_layers, clip_layers)
    for i in range(num_layers):
        p = f"temporal_decoder_blocks.{i}"
        blk = {}
        if f"{p}.sa_block.norm.weight" in sd:
            blk["sa_block"] = t_eff_attention(sd, f"{p}.sa_block")
        if f"{p}.ca_block.norm.weight" in sd:
            blk["ca_block"] = t_eff_attention(sd, f"{p}.ca_block")
        if f"{p}.ffn.linear1.weight" in sd:
            blk["ffn"] = t_ffn(sd, f"{p}.ffn")
        out[f"block_{i}"] = blk
    return out


def load_motiondiffuse_ckpt(path: str, model: torch.nn.Module, num_layers: int,
                            text_num_layers: int = 4, clip_layers: int = 12
                            ) -> Dict[str, torch.Tensor]:
    """Load a reference MotionDiffuse .pth into the port's
    MotionDiffuseTransformer; returns the state_dict loaded."""
    tree = convert_motiondiffuse(load_torch_state_dict(path), num_layers, text_num_layers,
                                 clip_layers)
    return load_into(model, tree)


# ----------------------------------------------------------------- MDM
def convert_mdm(sd: Dict[str, np.ndarray], num_layers: int, clip_layers: int = 12) -> dict:
    """MDMTransformer checkpoint -> flax param tree, in either naming: the
    reference's (poseEmbedding / seqTransEncoder.layers.N /
    embed_timestep.time_embed / embed_text / poseFinal, CLIP as clip_model.*)
    or the official released one (input_process.poseEmbedding /
    output_process.poseFinal, usually without CLIP, which then keeps the
    weights it has)."""
    alias = {}
    for k, v in _strip_model(sd).items():
        if k.startswith("input_process."):
            k = k[len("input_process."):]
        elif k.startswith("output_process."):
            k = k[len("output_process."):]
        elif k.startswith("clip_model."):
            k = "clip." + k[len("clip_model."):]
        alias[k] = v
    sd = alias
    out: dict = {
        "poseEmbedding": t_linear(sd, "poseEmbedding"),
        "poseFinal": t_linear(sd, "poseFinal"),
        "embed_text": t_linear(sd, "embed_text"),
        "time_embed": {"layers_0": t_linear(sd, "embed_timestep.time_embed.0"),
                       "layers_2": t_linear(sd, "embed_timestep.time_embed.2")},
    }
    for i in range(num_layers):
        out[f"layer_{i}"] = t_postln_layer(sd, f"seqTransEncoder.layers.{i}")
    if "clip.token_embedding.weight" in sd:
        clip_sd = {k[len("clip."):]: v for k, v in sd.items() if k.startswith("clip.")}
        out["clip"] = convert_clip_text(clip_sd, clip_layers)
        if "text_projection" in clip_sd:
            out["clip"]["text_projection"] = clip_sd["text_projection"]
    return out


def load_mdm_ckpt(path: str, model: torch.nn.Module, num_layers: int,
                  clip_layers: int = 12) -> Dict[str, torch.Tensor]:
    """Load a reference or official MDM .pth into the port's MDMTransformer;
    returns the state_dict loaded."""
    return load_into(model, convert_mdm(load_torch_state_dict(path), num_layers, clip_layers))


# ------------------------------------------------------------- FineMoGen
def t_interval_ffn(sd, prefix):
    """SAMI's template FFN, an nn.Sequential(Linear, GELU, Linear) ->
    ``layers_0`` / ``layers_2``."""
    return {"layers_0": t_linear(sd, _k(prefix, "0")),
            "layers_2": t_linear(sd, _k(prefix, "2"))}


def t_sami(sd, prefix):
    """SAMI attention params.  The reference's ``key_motion`` parameter is
    declared but unused in its forward; skipped."""
    g = lambda n: _k(prefix, n)  # noqa: E731
    out = {"norm": t_layernorm(sd, g("norm")),
           "text_norm": t_layernorm(sd, g("text_norm")),
           "text_moe": t_moe(sd, g("text_moe")),
           "motion_moe": t_moe(sd, g("motion_moe")),
           "body_weight": sd[g("body_weight")],
           "sigma": sd[g("sigma")].reshape(1),
           "t_sigma": sd[g("t_sigma")].reshape(1),
           "proj_out": t_stylization(sd, g("proj_out"))}
    for name in ("template_s", "template_v", "template_a", "template_j", "template_t"):
        out[name] = t_interval_ffn(sd, g(name))
    return out


def convert_finemogen(sd: Dict[str, np.ndarray], num_layers: int, num_heads: int,
                      text_num_layers: int = 2, clip_layers: int = 12) -> dict:
    """FineMoGenTransformer checkpoint (PoseEncoder / PoseDecoder + SAMI /
    SFFN stack, STMoGen's skeleton) -> flax param tree."""
    sd = _strip_model(sd)
    out: dict = {
        "sequence_embedding": sd["sequence_embedding"],
        "time_embed": {"layers_0": t_linear(sd, "time_embed.0"),
                       "layers_2": t_linear(sd, "time_embed.2")},
        "joint_embed": t_pose_io(sd, "joint_embed", "embed"),
        "out": t_pose_io(sd, "out", "out"),
        "text_enc": _convert_text_enc(sd, text_num_layers, clip_layers),
    }
    for i in range(num_layers):
        p = f"temporal_decoder_blocks.{i}"
        out[f"block_{i}"] = {"ca_block": t_sami(sd, f"{p}.ca_block"),
                             "ffn": t_sffn(sd, f"{p}.ffn", num_heads)}
    return out


def load_finemogen_ckpt(path: str, model: torch.nn.Module, num_layers: int, num_heads: int,
                        text_num_layers: int = 2, clip_layers: int = 12
                        ) -> Dict[str, torch.Tensor]:
    """Load a reference FineMoGen .pth into the port's FineMoGenTransformer;
    returns the state_dict loaded."""
    tree = convert_finemogen(load_torch_state_dict(path), num_layers, num_heads,
                             text_num_layers, clip_layers)
    return load_into(model, tree)


# ----------------------------------------------------- ReMoDiffuse family
def t_semantics_modulated(sd, prefix):
    """(Dual)SemanticsModulatedAttention: the norms, the text / retrieval /
    motion projections, the zero-init ``value_retr`` (a flax ZeroDense),
    proj_out; ``key_inter`` / ``value_inter`` where the file has them (the
    two-person version)."""
    g = lambda n: _k(prefix, n)  # noqa: E731
    out = {name: t_layernorm(sd, g(name))
           for name in ("norm", "text_norm", "retr_norm1", "retr_norm2")}
    for name in ("query", "key_text", "value_text", "key_motion", "value_motion", "key_retr"):
        out[name] = t_linear(sd, g(name))
    out["value_retr"] = {"linear": t_linear(sd, g("value_retr"))}
    out["proj_out"] = t_stylization(sd, g("proj_out"))
    for name in ("key_inter", "value_inter"):
        if f"{g(name)}.weight" in sd:
            out[name] = t_linear(sd, g(name))
    return out


def t_retrieval_encoder(sd, num_motion_layers: int, num_text_layers: int):
    """The retrieval database's learned re-encoders (``database.*``) ->
    RetrievalEncoder's tree; the bank itself stays the host-side .npz."""
    out = {"motion_proj": t_linear(sd, "database.motion_proj"),
           "motion_pos_embedding": sd["database.motion_pos_embedding"]}
    for i in range(num_motion_layers):
        p = f"database.motion_encoder_blocks.{i}"
        out[f"motion_sa_{i}"] = t_eff_attention(sd, f"{p}.sa_block")
        out[f"motion_ffn1_{i}"] = t_linear(sd, f"{p}.ffn.linear1")
        out[f"motion_ffn2_{i}"] = {"linear": t_linear(sd, f"{p}.ffn.linear2")}
    for i in range(num_text_layers):
        out[f"text_layer_{i}"] = t_postln_layer(sd, f"database.text_encoder.layers.{i}")
    return out


def convert_remodiffuse(sd: Dict[str, np.ndarray], num_layers: int,
                        num_motion_layers: int = 4, retr_text_layers: int = 2,
                        text_num_layers: int = 2, clip_layers: int = 12) -> dict:
    """ReMoDiffuseTransformer / MoMatMoGenTransformer checkpoint -> flax
    param tree: the skeleton, the retrieval encoder and per layer the
    semantics-modulated ca_block and the FFN (MoMatMoGen's, shared by both
    persons, nests as ``ffn/ffn``)."""
    sd = _strip_model(sd)
    out = _skeleton(sd, text_num_layers, clip_layers)
    out["retrieval_encoder"] = t_retrieval_encoder(sd, num_motion_layers, retr_text_layers)
    dual = any(".ca_block.key_inter.weight" in k for k in sd)
    for i in range(num_layers):
        p = f"temporal_decoder_blocks.{i}"
        ffn = t_ffn(sd, f"{p}.ffn")
        out[f"block_{i}"] = {"ca_block": t_semantics_modulated(sd, f"{p}.ca_block"),
                             "ffn": {"ffn": ffn} if dual else ffn}
    return out


def load_remodiffuse_ckpt(path: str, model: torch.nn.Module, num_layers: int,
                          num_motion_layers: int = 4, retr_text_layers: int = 2,
                          text_num_layers: int = 2, clip_layers: int = 12
                          ) -> Dict[str, torch.Tensor]:
    """Load a reference ReMoDiffuse / MoMatMoGen .pth into the port's
    transformer; returns the state_dict loaded."""
    tree = convert_remodiffuse(load_torch_state_dict(path), num_layers, num_motion_layers,
                               retr_text_layers, text_num_layers, clip_layers)
    return load_into(model, tree)



# --------------------------------------------------------------- wav2vec2
def _t_weight_norm_conv1d(sd, prefix):
    """torch ``nn.utils.weight_norm(Conv1d, dim=2)`` (the Wav2Vec2 positional
    convolution): the folded kernel w = g * v / ||v|| (the norm over the
    output and input axes, in float64) as a Conv kernel.  Both the legacy
    ``weight_g`` / ``weight_v`` keys and the parametrize-era
    ``parametrizations.weight.original0`` / ``original1``."""
    if _k(prefix, "weight_g") in sd:
        g, v = sd[_k(prefix, "weight_g")], sd[_k(prefix, "weight_v")]
    else:
        g = sd[_k(prefix, "parametrizations.weight.original0")]
        v = sd[_k(prefix, "parametrizations.weight.original1")]
    norm = np.sqrt((np.asarray(v, np.float64) ** 2).sum(axis=(0, 1), keepdims=True))
    w = np.asarray(g) * np.asarray(v) / norm  # [out, in / groups, k]
    return {"kernel": np.transpose(w, (2, 1, 0)).astype(np.float32),
            "bias": sd[_k(prefix, "bias")]}


def convert_wav2vec2(sd: Dict[str, np.ndarray], num_layers: int = 12,
                     num_conv_layers: int = 7) -> dict:
    """A HuggingFace torch Wav2Vec2Model ('group'-norm base layout) -> the
    flax params of Wav2Vec2Module (models/wav2vec.py).  Reference
    capability: EMAGE_2024/models/utils/wav2vec.py:72-146."""
    fe = {"group_norm": t_layernorm(sd, "feature_extractor.conv_layers.0.layer_norm")}
    for i in range(num_conv_layers):
        fe[f"conv_{i}"] = t_conv1d(sd, f"feature_extractor.conv_layers.{i}.conv")
    out = {
        "feature_extractor": fe,
        "fp_layer_norm": t_layernorm(sd, "feature_projection.layer_norm"),
        "fp_projection": t_linear(sd, "feature_projection.projection"),
        "pos_conv": _t_weight_norm_conv1d(sd, "encoder.pos_conv_embed.conv"),
        "encoder_layer_norm": t_layernorm(sd, "encoder.layer_norm"),
    }
    for i in range(num_layers):
        p = f"encoder.layers.{i}"
        out[f"layer_{i}"] = {
            "attention": {n: t_linear(sd, f"{p}.attention.{n}")
                          for n in ("q_proj", "k_proj", "v_proj", "out_proj")},
            "layer_norm": t_layernorm(sd, f"{p}.layer_norm"),
            "intermediate_dense": t_linear(sd, f"{p}.feed_forward.intermediate_dense"),
            "output_dense": t_linear(sd, f"{p}.feed_forward.output_dense"),
            "final_layer_norm": t_layernorm(sd, f"{p}.final_layer_norm"),
        }
    return out


def load_wav2vec2_params(path: str, module: torch.nn.Module, num_layers: int = 12,
                         num_conv_layers: int = 7) -> Dict[str, torch.Tensor]:
    """Load a HuggingFace torch Wav2Vec2Model checkpoint into the port's
    Wav2Vec2Module (shape-checked, ``strict=True``); returns the state_dict
    loaded."""
    tree = convert_wav2vec2(load_torch_state_dict(path), num_layers, num_conv_layers)
    return load_into(module, tree)
