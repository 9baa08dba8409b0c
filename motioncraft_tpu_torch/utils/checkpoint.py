"""Parameter snapshots, evaluation weights and training checkpoints
(PyTorch port of motioncraft_tpu/utils/checkpoint.py).

- ``save_params`` / ``load_params``: the JAX package's flat ``.npz``
  layout, one array per '/'-joined flax path (``params/block_0/...``, and
  ``batch_stats/...`` for a model with BatchNorm, the speech encoder).  A
  snapshot written by the JAX package evaluates in the port, and one the
  port writes (``to_jax_variables`` of its state_dict) evaluates in the JAX
  package.
- ``load_eval_variables``: the weights an evaluation runs with, from a
  reference ``.pth`` (STMoGen, or a merged base+control ControlT2MHalf) or
  a ``.npz`` snapshot.
- ``save_checkpoint`` / ``load_checkpoint``: a training state (model, the
  optimizer's moments, the update count, the step's ``torch.Generator``,
  the global torch and numpy generators and the timestep sampler's history)
  with ``torch.save``, one file per epoch, so that a resumed run goes on as
  the uninterrupted one would.
"""

from __future__ import annotations

import glob
import os
import re
from typing import Any, Dict, Optional

import numpy as np
import torch

from .convert import from_jax_params, from_jax_variables, to_jax_variables


def save_params(path: str, variables: Any) -> None:
    """Flat-file snapshot: a nested dict of arrays, or an ``nn.Module`` (then
    ``to_jax_variables`` of its state_dict: ``params`` and, with BatchNorm,
    ``batch_stats``), as one ``.npz``."""
    if isinstance(variables, torch.nn.Module):
        variables = to_jax_variables(variables.state_dict())
    flat = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(f"{prefix}/{k}" if prefix else k, v)
        else:
            flat[prefix] = (node.detach().cpu().numpy() if torch.is_tensor(node)
                            else np.asarray(node))

    walk("", variables)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **flat)


def load_params(path: str) -> dict:
    data = np.load(path, allow_pickle=False)
    tree: dict = {}
    for key in data.files:
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = data[key]
    return tree


def align_block_layout(model_cfg: dict, tree):
    """The per-layer ``block_{i}`` storage of a model without pipeline
    parallelism.  A snapshot of a pipelined model (its blocks stacked under
    ``stacked_blocks``) and a model with ``pipeline_axis`` raise: pipeline
    parallelism is not ported."""
    sub = model_cfg.get("model", {}) if isinstance(model_cfg, dict) else {}
    params = tree.get("params", tree) if isinstance(tree, dict) else tree
    if sub.get("pipeline_axis") is not None or (isinstance(params, dict)
                                                and "stacked_blocks" in params):
        raise NotImplementedError("pipeline_axis (pipeline parallelism): stacked "
                                  "decoder blocks")
    return tree


def load_eval_variables(model_cfg: dict, model: torch.nn.Module, checkpoint=None,
                        torch_checkpoint=None) -> Optional[Dict[str, torch.Tensor]]:
    """Load evaluation weights into ``model`` (the denoiser): a reference
    ``.pth`` (``torch_checkpoint``, STMoGen or ControlT2MHalf) or the flat
    ``.npz`` of ``save_params`` (``checkpoint``: its ``params``,
    ``batch_stats`` and, for an int8 snapshot, ``quant``: the model is then
    quantized alike first), ``strict=True``.  Returns the state_dict loaded, or
    None when neither file is given."""
    sub = model_cfg["model"]
    if torch_checkpoint and sub["type"] == "ControlT2MHalf":
        from .torch_convert import load_controlnet_ckpt
        bm = sub["base_model"]
        te = bm.get("text_encoder", {})
        return load_controlnet_ckpt(torch_checkpoint, model, bm["num_layers"],
                                    bm.get("ffn_cfg", {}).get("num_heads", 1),
                                    sub.get("copy_blocks_num", 2), te.get("num_layers", 2),
                                    te.get("clip_layers", 12))
    if torch_checkpoint:
        if sub["type"] != "STMoGenTransformer":
            raise NotImplementedError(
                f"reference checkpoints of {sub['type']}: the other families' converters "
                "(ROADMAP queue 1: what slice 6 left out of the evaluation path)")
        from .torch_convert import load_stmogen_ckpt
        ffn = sub.get("ffn_cfg", {})
        te = sub.get("text_encoder", {})
        return load_stmogen_ckpt(torch_checkpoint, model, sub["num_layers"],
                                 ffn.get("num_heads", 1), te.get("num_layers", 2),
                                 te.get("clip_layers", 12))
    if checkpoint:
        tree = align_block_layout(model_cfg, load_params(checkpoint))
        if "quant" in tree:
            from ..ops.quant import quantize_like
            quantize_like(model, tree["quant"])
        sd = from_jax_variables(tree) if "params" in tree else from_jax_params(tree)
        model.load_state_dict(sd, strict=True)
        return sd
    return None


# ------------------------------------------------------------ training state
def save_checkpoint(ckpt_dir: str, state, epoch: int) -> str:
    """Write ``state`` (a ``parallel.TrainState`` that ``train_model`` gave
    its ``generator`` and ``sampler``) after ``epoch`` to
    ``ckpt_dir/epoch_{epoch}.pth``; returns the path."""
    sampler = getattr(state, "sampler", None)
    generator = getattr(state, "generator", None)
    payload = {
        "epoch": int(epoch),
        "step": int(state.step),
        "model": state.model.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        "generator": None if generator is None else generator.get_state(),
        "generator_device": None if generator is None else str(generator.device),
        "torch_rng": torch.get_rng_state(),
        "cuda_rng": torch.cuda.get_rng_state_all() if torch.cuda.is_available() else None,
        "numpy_rng": np.random.get_state(),
        "sampler": None if sampler is None else sampler_state(sampler),
    }
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"epoch_{epoch}.pth")
    torch.save(payload, path)
    return path


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    """The ``epoch_{N}.pth`` of ``ckpt_dir`` with the largest N, or None."""
    found = []
    for p in glob.glob(os.path.join(ckpt_dir, "epoch_*.pth")):
        m = re.fullmatch(r"epoch_(\d+)\.pth", os.path.basename(p))
        if m:
            found.append((int(m.group(1)), p))
    return max(found)[1] if found else None


def load_checkpoint(path: str, state) -> int:
    """Restore what ``save_checkpoint`` wrote into ``state`` (and its
    generator and sampler); returns the epoch it was saved after."""
    payload = torch.load(path, map_location="cpu", weights_only=False)
    state.model.load_state_dict(payload["model"], strict=True)
    state.optimizer.load_state_dict(payload["optimizer"])
    state.step = payload["step"]
    generator = getattr(state, "generator", None)
    if generator is not None and payload["generator"] is not None:
        generator.set_state(payload["generator"])
    torch.set_rng_state(payload["torch_rng"])
    if payload["cuda_rng"] is not None and torch.cuda.is_available():
        torch.cuda.set_rng_state_all(payload["cuda_rng"])
    np.random.set_state(payload["numpy_rng"])
    sampler = getattr(state, "sampler", None)
    if sampler is not None and payload["sampler"] is not None:
        load_sampler_state(sampler, payload["sampler"])
    return payload["epoch"]


def sampler_state(sampler) -> dict:
    """The tensors and counters of a timestep sampler (its loss history,
    for the loss-second-moment sampler)."""
    return {k: (v.detach().cpu().clone() if torch.is_tensor(v)
                else np.array(v) if isinstance(v, np.ndarray) else v)
            for k, v in vars(sampler).items()}


def load_sampler_state(sampler, saved: dict) -> None:
    for k, v in saved.items():
        cur = getattr(sampler, k, None)
        if torch.is_tensor(cur):
            cur.copy_(v)
        else:
            setattr(sampler, k, v)
