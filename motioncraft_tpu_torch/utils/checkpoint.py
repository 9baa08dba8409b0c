"""Parameter snapshots, evaluation weights and training checkpoints
(PyTorch port of motioncraft_tpu/utils/checkpoint.py).

- ``save_params`` / ``load_params``: the JAX package's flat ``.npz``
  layout, one array per '/'-joined flax path (``params/block_0/...``, and
  ``batch_stats/...`` for a model with BatchNorm, the speech encoder; a
  model with ``pipeline_axis`` writes its blocks stacked under
  ``params/stacked_blocks/...``, as the JAX package stores them).  A
  snapshot written by the JAX package evaluates in the port, and one the
  port writes (``to_jax_variables`` of its state_dict) evaluates in the JAX
  package; ``align_block_layout`` converts either block layout to a
  config's.
- ``load_eval_variables``: the weights an evaluation runs with, from a
  reference ``.pth`` (STMoGen, a merged base+control ControlT2MHalf, MCM,
  MotionDiffuse or MDM) or a ``.npz`` snapshot.
- ``save_checkpoint`` / ``load_checkpoint``: a training state (model, the
  optimizer's moments, the update count, the step's ``torch.Generator``,
  the global torch and numpy generators and the timestep sampler's history)
  with ``torch.save``, one file per epoch, so that a resumed run goes on as
  the uninterrupted one would.  A file is written under a temporary name
  and renamed into place, so a run killed while it writes leaves no
  partial ``epoch_N.pth``; ``max_to_keep`` prunes the oldest (the JAX
  package's orbax manager does both).  ``save_state_params`` writes a
  training state's model as ``save_params`` does.
- Under ``torch.distributed`` every rank calls the savers: a sharded state's
  (``state.sharding``, the model across cards) shards are gathered whole
  (a pipeline's stages' layers on global rank 0), and global rank 0 alone
  writes (``writes``) the file that one process would write.  Every rank
  reads the whole file and keeps its shards.
"""

from __future__ import annotations

import glob
import os
import re
import tempfile
import zipfile
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from .convert import from_jax_params, from_jax_variables, to_jax_variables


def jax_layout(model: torch.nn.Module, sd: Dict[str, torch.Tensor]) -> dict:
    """``to_jax_variables(sd)`` (the whole state_dict of ``model``) in the
    layout the JAX package stores ``model``'s config in: with
    ``pipeline_axis``, the blocks stacked under ``stacked_blocks``."""
    variables = to_jax_variables(sd)
    if getattr(model, "pipeline_axis", None) is not None:
        from ..parallel.pp import stack_block_params

        variables["params"] = stack_block_params(variables["params"], model.num_layers)
    return variables


def save_params(path: str, variables: Any) -> None:
    """Flat-file snapshot: a nested dict of arrays, or an ``nn.Module`` (then
    ``jax_layout`` of its state_dict: ``params`` and, with BatchNorm,
    ``batch_stats``), as one ``.npz``."""
    if isinstance(variables, torch.nn.Module):
        variables = jax_layout(variables, variables.state_dict())
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
    """A snapshot's block storage in the layout of ``model_cfg``'s model
    (the JAX package's function): a ``pipeline_axis`` model's blocks
    stacked ``[num_layers, ...]`` under ``stacked_blocks``, a plain
    model's per-layer ``block_{i}`` subtrees; a tree in the other layout is
    converted, so that a pipeline-trained snapshot evaluates in the plain
    model and the other way round.  The port's modules store per-layer
    blocks either way (``from_jax_params`` unstacks)."""
    from ..parallel.pp import stack_block_params, unstack_block_params

    sub = model_cfg.get("model", {}) if isinstance(model_cfg, dict) else {}
    want_stacked = sub.get("pipeline_axis") is not None
    params = tree.get("params", tree) if isinstance(tree, dict) else tree
    if not isinstance(params, dict):
        return tree
    if want_stacked and "block_0" in params and "stacked_blocks" not in params:
        new = stack_block_params(dict(params), sub["num_layers"])
    elif not want_stacked and "stacked_blocks" in params:
        new = unstack_block_params(dict(params))
    else:
        return tree
    if isinstance(tree, dict) and "params" in tree:
        return {**tree, "params": new}
    return new


def load_eval_variables(model_cfg: dict, model: torch.nn.Module, checkpoint=None,
                        torch_checkpoint=None) -> Optional[Dict[str, torch.Tensor]]:
    """Load evaluation weights into ``model`` (the denoiser): a reference
    ``.pth`` (``torch_checkpoint``: STMoGen, either ControlNet, MCM,
    MotionDiffuse, MDM, FineMoGen, ReMoDiffuse or MoMatMoGen) or the flat
    ``.npz`` of ``save_params`` (``checkpoint``: its ``params``,
    ``batch_stats`` and, for an int8 snapshot, ``quant``: the model is then
    quantized alike first), ``strict=True``.  Returns the state_dict loaded, or
    None when neither file is given."""
    sub = model_cfg["model"]
    if torch_checkpoint and sub["type"] in ("ControlT2MHalf", "ControlT2MHalfMCM"):
        from .torch_convert import load_controlnet_ckpt
        bm = sub["base_model"]
        te = bm.get("text_encoder", {})
        return load_controlnet_ckpt(torch_checkpoint, model, bm["num_layers"],
                                    bm.get("ffn_cfg", {}).get("num_heads", 1),
                                    sub.get("copy_blocks_num", 2), te.get("num_layers", 2),
                                    te.get("clip_layers", 12),
                                    block_type="mcm" if "MCM" in sub["type"] else "stmogen")
    if torch_checkpoint:
        from . import torch_convert as tc
        te = sub.get("text_encoder", {})
        if sub["type"] == "MCMTransformer":
            return tc.load_mcm_ckpt(torch_checkpoint, model, sub["num_layers"],
                                    te.get("num_layers", 4), te.get("clip_layers", 12))
        if sub["type"] == "MotionDiffuseTransformer":
            return tc.load_motiondiffuse_ckpt(torch_checkpoint, model, sub["num_layers"],
                                              te.get("num_layers", 4),
                                              te.get("clip_layers", 12))
        if sub["type"] == "MDMTransformer":
            return tc.load_mdm_ckpt(torch_checkpoint, model, sub.get("num_layers", 8),
                                    sub.get("clip_layers", 12))
        if sub["type"] == "FineMoGenTransformer":
            return tc.load_finemogen_ckpt(torch_checkpoint, model, sub["num_layers"],
                                          sub.get("ffn_cfg", {}).get("num_heads", 1),
                                          te.get("num_layers", 2), te.get("clip_layers", 12))
        if sub["type"] in ("ReMoDiffuseTransformer", "MoMatMoGenTransformer"):
            rc = sub.get("retrieval_cfg", {})
            return tc.load_remodiffuse_ckpt(torch_checkpoint, model, sub["num_layers"],
                                            rc.get("num_motion_layers", 4),
                                            rc.get("num_layers", 2), te.get("num_layers", 2),
                                            te.get("clip_layers", 12))
        if sub["type"] != "STMoGenTransformer":
            raise NotImplementedError(
                f"reference checkpoints of {sub['type']}: the other families' converters "
                "(ROADMAP queue 1: the rest of the baseline zoo)")
        ffn = sub.get("ffn_cfg", {})
        return tc.load_stmogen_ckpt(torch_checkpoint, model, sub["num_layers"],
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
def writes() -> bool:
    """True on the process that writes files: the only one, or global
    rank 0 of a process group (its ranks hold equal or gathered states)."""
    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


def _whole_model(state) -> Dict[str, torch.Tensor]:
    """The model's state_dict, a sharded one's shards gathered (every rank
    calls it)."""
    from ..parallel.tp import full_state_dict

    sharding = getattr(state, "sharding", None)
    return (state.model.state_dict() if sharding is None
            else full_state_dict(state.model, sharding))


def save_state_params(path: str, state) -> None:
    """``save_params`` of a training state's whole model, by the writer."""
    sd = _whole_model(state)
    if writes():
        save_params(path, jax_layout(state.model, sd))


def save_checkpoint(ckpt_dir: str, state, epoch: int,
                    max_to_keep: Optional[int] = None) -> str:
    """Write ``state`` (a ``parallel.TrainState`` that ``train_model`` gave
    its ``generator`` and ``sampler``) after ``epoch`` to
    ``ckpt_dir/epoch_{epoch}.pth``: into a temporary file of ``ckpt_dir``
    first, renamed into place once whole.  With ``max_to_keep``, only that
    many of the newest epochs' files stay.  Returns the path."""
    from ..parallel.tp import full_optimizer_state

    sampler = getattr(state, "sampler", None)
    generator = getattr(state, "generator", None)
    model = _whole_model(state)
    optimizer = full_optimizer_state(state.optimizer, state.params,
                                     getattr(state, "sharding", None))
    path = os.path.join(ckpt_dir, f"epoch_{epoch}.pth")
    if not writes():
        return path
    payload = {
        "epoch": int(epoch),
        "step": int(state.step),
        "model": model,
        "optimizer": optimizer,
        "generator": None if generator is None else generator.get_state(),
        "generator_device": None if generator is None else str(generator.device),
        "torch_rng": torch.get_rng_state(),
        "cuda_rng": torch.cuda.get_rng_state_all() if torch.cuda.is_available() else None,
        "numpy_rng": np.random.get_state(),
        "sampler": None if sampler is None else sampler_state(sampler),
    }
    os.makedirs(ckpt_dir, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=f".epoch_{epoch}.", suffix=".tmp", dir=ckpt_dir)
    try:
        with os.fdopen(fd, "wb") as f:
            torch.save(payload, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    if max_to_keep:
        for _, old in _epoch_files(ckpt_dir)[:-max_to_keep]:
            os.remove(old)
    return path


def _epoch_files(ckpt_dir: str):
    """(epoch, path) of every ``epoch_{N}.pth`` of ``ckpt_dir``, oldest first."""
    found = []
    for p in glob.glob(os.path.join(ckpt_dir, "epoch_*.pth")):
        m = re.fullmatch(r"epoch_(\d+)\.pth", os.path.basename(p))
        if m:
            found.append((int(m.group(1)), p))
    return sorted(found)


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    """The whole ``epoch_{N}.pth`` of ``ckpt_dir`` with the largest N, or
    None.  A file that is not a whole ``torch.save`` archive (cut short by
    a killed write outside ``save_checkpoint``) is passed over."""
    for _, p in reversed(_epoch_files(ckpt_dir)):
        if zipfile.is_zipfile(p):
            return p
    return None


def load_checkpoint(path: str, state) -> int:
    """Restore what ``save_checkpoint`` wrote into ``state`` (and its
    generator and sampler); returns the epoch it was saved after."""
    from ..parallel.tp import load_local_optimizer_state, load_local_state_dict

    payload = torch.load(path, map_location="cpu", weights_only=False)
    sharding = getattr(state, "sharding", None)
    load_local_state_dict(state.model, payload["model"], sharding)
    load_local_optimizer_state(state.optimizer, state.params, payload["optimizer"], sharding)
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
