"""Training API: the train step and the training loop (PyTorch port of
motioncraft_tpu/apis/train.py).

One device, eager PyTorch: a feeder thread prepares and copies the next
batches while the step runs, the step is ``MotionDiffusion.loss``, autograd
and one optimizer update (``parallel/train_state.py``), and the loop runs
epochs with the checkpoint / eval hooks and the loss-aware timestep sampler's
feedback.  ``resume_dir`` resumes from the last ``utils/checkpoint.py``
checkpoint written there.  ``fp16`` trains in bf16 against the f32
master parameters (``make_train_step``).

Data parallelism (``mesh``, a ``parallel.mesh.DataMesh``): one process a
rank, each with its rows of the global batch (``parallel/mesh.py`` says
which), computes what one process computes on the global batch, as the
JAX package's sharded step does: the per-row draws, the MoE's routing,
the BatchNorm statistics and the loss's reductions are global (the step
attaches the mesh to the modules that compute over the batch), and after the
microbatch loop the trainable gradients' mean over the ranks
(``utils/dist_utils.py:allreduce_grads``) goes into the clip and the
update, so every rank takes the same step.  No DDP wrapper: the explicit
all-reduce leaves ``cast_parameters``' swap, remat's recompute and the
frozen prefixes as one process has them.

On a mesh with an ``expert`` or ``tensor`` axis (the model across cards)
every rank starts from rank 0's whole weights and keeps its shards
(``parallel/tp.py:shard_module_``): the experts split over ``expert``,
the FFNs' hidden dims over ``tensor``.  The step still computes the
one-process step on the global batch: the MoE exchanges its slot buffers
over the expert group and the FFNs sum their partial products over the
tensor group (models/moe.py, models/blocks.py), each gradient is reduced
over the ranks that hold the same shard, and the clip and the optimizers
take whole-leaf statistics (parallel/train_state.py, parallel/optim.py).

On a mesh with a ``pipe`` axis (a model with ``pipeline_axis``) every rank
keeps the layers of its pipeline stage (the same cut); the stack runs as a
GPipe pipeline over the stages (parallel/pp.py), each (data shard,
microbatch) routing on its own, and the stages' replicated leaves'
gradients, each stage's share, are summed over ``pipe``.
"""

from __future__ import annotations

import contextlib
import itertools
import queue
import threading
import time
from typing import Any, Callable, Dict, Iterable, Optional

import numpy as np
import torch

from ..parallel import TrainState, build_lr_schedule
from ..parallel.mesh import attach_mesh, broadcast_module, gather_rows
from ..parallel.tp import shard_module_
from ..utils.dist_utils import allreduce_grads, mean_across_hosts


def set_random_seed(seed: int, device="cpu") -> torch.Generator:
    """Seed numpy and torch's global generators (the blocks' ``F.dropout``
    draws from those) and return a generator on ``device`` for the step's
    own draws (timesteps, noise, cond_type, MoE gate noise, the post-LN
    encoder layers' dropout masks)."""
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator(device=device).manual_seed(seed)


def device_prefetch(batch_iter: Iterable[Dict[str, Any]], device, depth: int = 2):
    """Yield each batch's numeric arrays as tensors on ``device``, prepared
    by a feeder thread up to ``depth`` batches ahead: host arrays are pinned
    and copied with ``non_blocking``, on the consumer's stream, so the host
    work overlaps the device's.  A feeder error is raised here."""
    device = torch.device(device)
    q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
    sentinel = object()
    stop = threading.Event()
    errors = []

    def to_device(batch):
        out = {}
        for k, v in batch.items():
            if torch.is_tensor(v) or (isinstance(v, np.ndarray)
                                      and np.issubdtype(v.dtype, np.number)):
                t = torch.as_tensor(v)
                if device.type == "cuda" and t.device.type == "cpu":
                    t = t.pin_memory()
                out[k] = t.to(device, non_blocking=True)
        return out

    def feeder():
        try:
            for batch in batch_iter:
                if stop.is_set():
                    break
                q.put(to_device(batch))
        except BaseException as e:  # raised on the consumer side
            errors.append(e)
        finally:
            q.put(sentinel)

    thread = threading.Thread(target=feeder, daemon=True)
    thread.start()
    try:
        while (item := q.get()) is not sentinel:
            yield item
    finally:
        stop.set()
        while thread.is_alive():  # a feeder blocked on a full queue needs room
            try:
                q.get_nowait()
            except queue.Empty:
                thread.join(0.01)
    if errors:
        raise errors[0]


@contextlib.contextmanager
def cast_parameters(module: torch.nn.Module, dtype: torch.dtype):
    """Within the block every floating parameter of ``module`` reads as a
    ``dtype`` copy made by a differentiable cast, so the backward hands the
    f32 parameter the gradient of its copy widened to f32 (the JAX
    package's ``astype`` inside the differentiated function).  Buffers
    (BatchNorm statistics) stay as they are, as flax's extra variables do.
    The parameters are put back on exit."""
    swapped = []
    try:
        for m in module.modules():
            for name, p in list(m._parameters.items()):
                if p is not None and p.is_floating_point() and p.dtype != dtype:
                    # the copy stands in the module's parameter dict, so
                    # that parameters() and attribute reads both see it
                    m._parameters[name] = p.to(dtype)
                    swapped.append((m, name, p))
        yield module
    finally:
        for m, name, p in swapped:
            m._parameters[name] = p


def _resolved(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def half_dtype(fp16: dict) -> torch.dtype:
    """The compute dtype that an ``fp16`` option names: bfloat16 (its
    default).  float16 needs an f16 instantiation of K6 (queued)."""
    name = str(fp16.get("dtype", "bfloat16")).removeprefix("torch.")
    if name == "float16":
        raise NotImplementedError("fp16 training in float16 (an f16 K6): "
                                  "ROADMAP queue 1: the rest of training")
    if name != "bfloat16":
        raise ValueError(f"fp16 dtype {name!r}: bfloat16")
    return torch.bfloat16


def make_train_step(arch, state: TrainState, fp16: Optional[dict] = None,
                    grad_accum: int = 1, mesh=None) -> Callable:
    """``step(batch, generator=None, **loss_kw) -> logs``: the loss, its
    gradient and one optimizer update.  ``grad_accum`` > 1 splits the batch
    (and any per-sample ``loss_kw`` override) into that many microbatches
    and averages their gradients before the update, as the JAX package's
    scan does.  The logs hold the scalars (means over microbatches) and, for
    the loss-aware sampler, ``_timesteps`` and ``_loss_batch`` in input
    order.

    On a data mesh (``mesh``, which this attaches to ``arch``'s modules)
    the batch and the ``loss_kw`` overrides are this rank's rows in the
    mesh's layout, the gradients are averaged over the ranks before the update,
    the scalars are means over the ranks and the two vectors come back
    gathered, in the global batch's order.

    ``fp16`` (the JAX package's option, mmcv's Fp16OptimizerHook): the
    forward and backward run on bf16 copies of every floating parameter
    (``fp16["dtype"]``, default and only 'bfloat16'; the frozen CLIP's
    too); the f32 parameters stay the master copy and take the gradients
    widened to f32.  Each
    module computes in the promoted dtype of its input and its weights, as
    flax does (models/blocks.py:promote_dtype): the text tower and the text
    MoEs run in bf16, the motion path in f32 on the rounded weights.  The
    loss is taken in f32 and multiplied by a numeric ``loss_scale``, the
    gradients divided by it; a string ``loss_scale`` (mmcv's 'dynamic')
    counts as 1.0, as in the JAX package."""
    half, loss_scale = None, 1.0
    if fp16 is not None:
        half = half_dtype(fp16)
        ls = fp16.get("loss_scale", 1.0)
        loss_scale = 1.0 if isinstance(ls, str) else float(ls)
    cast = ((lambda: cast_parameters(arch.model, half)) if half is not None
            else contextlib.nullcontext)
    attach_mesh(arch, mesh)

    def train_step(batch: Dict[str, Any], generator=None, **loss_kw):
        B = batch["motion"].shape[0]
        if B % grad_accum:
            raise ValueError(f"grad_accum={grad_accum} must divide the batch size {B}")
        m = B // grad_accum
        scalars: Dict[str, torch.Tensor] = {}
        timesteps, loss_batch = [], []
        for i in range(grad_accum):
            part = slice(i * m, (i + 1) * m)
            micro = {k: v[part] if getattr(v, "ndim", 0) and v.shape[0] == B else v
                     for k, v in batch.items()}
            kw = {k: v[part] for k, v in loss_kw.items()}
            with torch.enable_grad(), cast():  # whatever the caller's grad mode
                loss, logs = arch.loss(micro, generator=generator, **kw)
                (loss.float() * (loss_scale / grad_accum)).backward()
            for k, v in logs.items():
                if v.ndim == 0:
                    scalars[k] = scalars.get(k, 0.0) + v.detach().float() / grad_accum
            timesteps.append(logs["timesteps"])
            loss_batch.append(logs["recon_loss_batch"].detach())
        sharding = getattr(state, "sharding", None)
        allreduce_grads(state.params, mesh, None if sharding is None else
                        {p: sharding.axes_of(p) for p in state.params})
        if loss_scale != 1.0:
            for p in state.params:
                if p.grad is not None:
                    p.grad.div_(loss_scale)
        state.apply_gradients()
        scalars = mean_across_hosts(scalars, mesh)
        scalars["_timesteps"] = gather_rows(mesh, torch.cat(timesteps), grad_accum)
        scalars["_loss_batch"] = gather_rows(mesh, torch.cat(loss_batch), grad_accum)
        return scalars

    return train_step


def train_model(arch, dataloader: Iterable[Dict[str, Any]], *,
                optimizer_cfg: Optional[dict] = None,
                lr_config: Optional[dict] = None,
                grad_clip: Optional[dict] = None,
                max_epochs: int = 1,
                steps_per_epoch: Optional[int] = None,
                seed: int = 0,
                mesh=None,
                log_interval: int = 50,
                logger: Optional[Callable[[str], None]] = None,
                checkpoint_fn: Optional[Callable] = None,
                eval_fn: Optional[Callable] = None,
                frozen_prefixes=("text_enc/clip",),
                resume_dir: Optional[str] = None,
                model_transform: Optional[Callable] = None,
                fp16: Optional[dict] = None,
                grad_accum: int = 1) -> TrainState:
    """Train ``arch`` (a MotionDiffusion, on its device) for ``max_epochs``
    passes over ``dataloader`` (an iterable of batches of numpy arrays or
    tensors, iterated anew each epoch; at most ``steps_per_epoch`` batches
    an epoch when given, which also sets the epoch length of the lr
    schedule).  Adam + step decay by default (the reference recipe).  The
    model trains in ``train()`` mode and is left in ``eval()`` mode, which
    ``checkpoint_fn(state, epoch)`` and ``eval_fn(state, epoch)`` also see.
    Every ``log_interval`` steps ``logger`` gets the step's scalars and the
    mean wall ms per step since the last line (the scalars' read waits for
    the device).

    The state carries the step's ``generator`` and the timestep ``sampler``,
    so ``checkpoint_fn = lambda state, epoch: save_checkpoint(dir, state,
    epoch)`` saves all a resume needs; ``resume_dir`` restores the latest
    such file and goes on at the epoch after it, the next step computing
    what the uninterrupted run's would.

    ``model_transform(arch.model)`` (the JAX package's
    ``variables_transform``) edits the denoiser's weights in place before
    the optimizer is made: ControlNet training grafts a pretrained base
    into it there.  ``frozen_prefixes`` are matched against the
    '/'-joined parameter names (``parallel/train_state.py:freeze``).

    ``mesh`` (a ``parallel.mesh.DataMesh``): data-parallel training, this
    process one rank; ``dataloader`` yields this rank's rows
    (``data/loader.py:RankRows``, or a ``dist=True`` loader), ``arch`` lives
    on the mesh's device, every rank starts from rank 0's weights
    (broadcast after ``model_transform``, then cut to this rank's shards
    on an expert or tensor axis, or to its stage's layers on a pipe axis)
    and the same seed, and the caller's
    ``checkpoint_fn`` / ``eval_fn`` run on every rank (the CLI writes on
    rank 0 alone)."""
    optimizer_cfg = optimizer_cfg or {"type": "Adam"}
    generator = set_random_seed(seed, arch.device)
    if model_transform is not None:
        with torch.no_grad():
            model_transform(arch.model)
    if mesh is not None and _resolved(mesh.device) != _resolved(arch.device):
        raise ValueError(f"arch lives on {arch.device}, its rank on {mesh.device}")
    broadcast_module(arch.model, mesh)
    sharding = shard_module_(arch.model, mesh)
    schedule = build_lr_schedule(optimizer_cfg.get("lr", 2e-4), lr_config,
                                 steps_per_epoch or 1)
    state = TrainState(arch.model, optimizer_cfg, schedule, grad_clip, frozen_prefixes,
                       sharding=sharding)
    sampler = getattr(arch, "sampler", None)
    state.generator, state.sampler = generator, sampler
    step_fn = make_train_step(arch, state, fp16=fp16, grad_accum=grad_accum, mesh=mesh)
    log = logger or (lambda msg: print(msg, flush=True))
    start_epoch = 0
    if resume_dir is not None:
        from ..utils.checkpoint import latest_checkpoint, load_checkpoint
        path = latest_checkpoint(resume_dir)
        if path is not None:
            start_epoch = load_checkpoint(path, state) + 1
            # the JAX package's line: the epoch named is the one saved
            log(f"resumed from {path} at epoch {start_epoch - 1} (step {state.step})")
    global_step = state.step
    try:
        for epoch in range(start_epoch, max_epochs):
            if hasattr(getattr(dataloader, "sampler", None), "set_epoch"):
                dataloader.sampler.set_epoch(epoch)
            arch.train()
            t0 = t_line = time.perf_counter()
            n_line = 0
            batches = iter(dataloader)
            if steps_per_epoch:
                batches = itertools.islice(batches, steps_per_epoch)
            for batch in device_prefetch(batches, arch.device):
                logs = step_fn(batch, generator)
                # loss-second-moment sampler feedback
                if hasattr(sampler, "update_with_local_losses"):
                    sampler.update_with_local_losses(logs["_timesteps"], logs["_loss_batch"])
                global_step += 1
                n_line += 1
                if global_step % log_interval == 0:
                    scal = {k: float(v) for k, v in logs.items() if not k.startswith("_")}
                    now = time.perf_counter()
                    ms = (now - t_line) / n_line * 1e3
                    t_line, n_line = now, 0
                    log(f"epoch {epoch} step {global_step}: "
                        + " ".join(f"{k}={v:.5f}" for k, v in sorted(scal.items()))
                        + f" step_ms={ms:.1f}")
            log(f"epoch {epoch} done in {time.perf_counter() - t0:.3f}s")
            arch.eval()
            if checkpoint_fn is not None:
                checkpoint_fn(state, epoch)
            if eval_fn is not None:
                eval_fn(state, epoch)
    finally:
        arch.eval()
    return state
