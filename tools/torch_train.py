"""Training entry point of the PyTorch port (the counterpart of
tools/train.py, which runs the JAX package), on one card.

config -> train dataset (a mixed ``data.train.base`` set through
``build_mixed_dataset``) -> shuffled, seeded loader -> train_model (the
config's optimizer, lr schedule, gradient clip and cumulative_iters; CLIP
frozen, MDM's at ``clip`` as the others' at ``text_enc/clip``; a
ControlNet's base frozen as ``controlnet_frozen_prefixes`` says, its
``joint_embed_unfreeze`` / ``unfreeze_mode`` heads trainable) ->
per-epoch checkpoints (``checkpoint_config.interval`` /
``max_keep_ckpts``, written whole or not at all) with ``params.npz`` in the
JAX package's layout, which tools/test.py and tools/torch_test.py
--checkpoint both read -> ``EvalHook`` when the config has ``evaluation``.
``train.log`` in the work dir holds tools/train.py's lines (``dataset: N
samples, M steps/epoch``, ``epoch E step S: loss=...``, ``epoch E done in
Xs``, ``saved checkpoint at epoch E``, ``resumed from ... at epoch E``,
``loaded base checkpoint ...``) and grows across ``--resume``.  Runs on
the card unless ``--device cpu``.

It trains the flagship and every STMoGen config, the baselines
MotionDiffuse, MCM, MDM and FineMoGen, and both ControlNet block types
(STMoGen and MCM).  ``--base-checkpoint`` takes a ``params.npz`` of either
package's training CLI (its ``params``): for a ControlNet config it
becomes ``base_model`` and its first ``copy_blocks_num`` blocks are copied
into the control blocks (tools/train.py's ``variables_transform``); for
any other model it is the starting weights.

Usage:
  python tools/torch_train.py configs/tests/protocol_learn.py \\
      --work-dir outputs/soak_torch --grad-accum 2 [--resume] [--max-epochs N]
  python tools/torch_train.py configs/tests/tiny_t2m.py --device cpu \\
      --work-dir out --max-epochs 1         # after tools/make_tiny_data.py
  python tools/torch_train.py configs/stmogen/s2g_beats2_0125b.py \\
      --work-dir outputs/s2g --base-checkpoint outputs/t2m_0_125b/params.npz
  python tools/torch_train.py configs/mcm/mcm_t2m_smplx.py --work-dir outputs/mcm
  python tools/torch_train.py configs/mcm/mcm_m2d_finedance.py \\
      --work-dir outputs/mcm_m2d --base-checkpoint outputs/mcm/params.npz

A resumed epoch draws the batches the uninterrupted run draws when the
loader has no worker threads (``data.workers_per_gpu=0``): threads take
the samples' random crops and captions in the order they run.
The config's ``fp16`` (e.g. ``fp16 = dict(loss_scale=512.)``; the
compute dtype bfloat16) trains in bf16 against the f32 master parameters,
``model.remat`` rematerializes the decoder layers in the backward pass, and
``optimizer.type`` may be Adam, AdamW, SGD, Adafactor, AdaBelief or Lamb;
each also through ``--cfg-options`` (``fp16.loss_scale=8.0
model.model.remat=True optimizer.type=Adafactor``), as tools/train.py
passes them.
Data parallelism, as tools/train.py's options mean it: ``--devices N``
trains on N cards of this host, one process a rank (spawned here, NCCL;
``--device cpu`` runs N gloo processes on the CPU), the config's
``samples_per_gpu`` the global batch, each rank reading its rows of the
one-process loader's batches; ``--multihost`` makes this process one rank
of ``--num-processes`` (``--coordinator host:port``, ``--process-id``, or
torchrun's environment), one card each, loading its interleaved slice at
``samples_per_gpu``.  Either way each step computes what one process
computes on the global batch (apis/train.py), rank 0 writes train.log,
the checkpoints and params.npz while the others wait, and ``--resume``
loads the same checkpoint on every rank.

  python tools/torch_train.py configs/stmogen/t2m_motionx_0_125b.py --devices 8
  python tools/torch_train.py CONFIG --multihost --coordinator host0:29500 \
      --num-processes 16 --process-id $RANK
  python tools/torch_train.py configs/tests/tiny_t2m.py --device cpu --devices 2

Tensor parallelism, as tools/train.py's ``--tensor-parallel T`` means it:
the N ranks (``--devices N``, default one a visible card) form the mesh
``(data N / (T * ep), expert ep, tensor T)`` with ``ep`` 2 where N / T is
even, else 1; each rank keeps its shards of the experts (over ``expert``)
and of the FFNs' hidden dims (over ``tensor``), the rows of a batch split
over data x expert (parallel/mesh.py, parallel/tp.py).  Checkpoints and
params.npz are written whole (the shards gathered on rank 0), and
``--resume`` reads the whole file on every rank; the evaluation hook runs
on rank 0 over a whole copy of the weights.

  python tools/torch_train.py configs/stmogen/t2m_motionx_0_125b.py --devices 8 \
      --tensor-parallel 2
  python tools/torch_train.py configs/tests/tiny_t2m.py --device cpu --devices 2 \
      --tensor-parallel 2

Pipeline parallelism, as tools/train.py's ``--pipeline-parallel P``
means it: the N ranks form the mesh ``(data N / P, pipe P)`` and the
config's model gets ``pipeline_axis='pipe'`` and ``pipeline_microbatches``
(``--pipeline-microbatches``, default 2); each rank holds the layers of
its stage, the decoder stack runs as a GPipe pipeline over them, each
(data shard, microbatch) routing its MoEs on its own (parallel/pp.py).
params.npz holds the blocks stacked under ``stacked_blocks`` (the JAX
package's layout for that config; tools/test.py and tools/torch_test.py
read either layout), and the evaluation hook samples rank 0's whole copy
of the weights with the pipelined config's per-microbatch routing.  As in
tools/train.py it composes with the data axis alone and trains
STMoGenTransformer stacks alone.

  python tools/torch_train.py configs/stmogen/t2m_motionx_0_125b.py --devices 8 \
      --pipeline-parallel 2
  python tools/torch_train.py configs/tests/tiny_t2m.py --device cpu --devices 2 \
      --pipeline-parallel 2

Refused rather than ignored: ``--tensor-parallel`` or ``--multihost`` with
``--pipeline-parallel``, and ``--tensor-parallel`` with ``--multihost``, in
tools/train.py's words; fp16 in float16 (an f16 K6, ROADMAP queue 1: the
rest of training); ReMoDiffuse and MoMatMoGen, which the JAX package's loss
cannot train (it passes them no retrieval; ROADMAP queue 3).
"""

import argparse
import logging
import os
import sys
import types

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

CONTROLNETS = ("ControlT2MHalf", "ControlT2MHalfMCM")
RETRIEVAL_MODELS = ("ReMoDiffuseTransformer", "MoMatMoGenTransformer")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train a motion diffusion model with the "
                                            "PyTorch port")
    p.add_argument("config")
    p.add_argument("--work-dir", default=None)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the model trains; cuda raises without a card")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--max-epochs", type=int, default=None)
    p.add_argument("--grad-accum", type=int, default=None,
                   help="split each loader batch into N microbatches and average their "
                        "gradients before one optimizer step; default: the config's "
                        "optimizer_config.cumulative_iters, else 1")
    p.add_argument("--cfg-options", nargs="*", default=None)
    p.add_argument("--base-checkpoint", default=None,
                   help="pretrained base params (.npz) for ControlNet training")
    p.add_argument("--devices", type=int, default=None,
                   help="data-parallel ranks on this host, one card each; the config's "
                        "samples_per_gpu is the global batch")
    p.add_argument("--multihost", action="store_true",
                   help="this process is one rank of --num-processes (one card each), "
                        "its loader the interleaved slice at samples_per_gpu")
    p.add_argument("--coordinator", default=None, help="host:port of process 0")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--dist-backend", choices=["nccl", "gloo"], default=None,
                   help="default: nccl on the card, gloo on the CPU")
    p.add_argument("--tensor-parallel", type=int, default=1,
                   help="shard the FFNs' hidden dims over T ranks (and the experts over "
                        "2 where the rest is even), as tools/train.py's option")
    p.add_argument("--pipeline-parallel", type=int, default=1,
                   help="GPipe the decoder stack over a 'pipe' mesh axis of this size, as "
                        "tools/train.py's option; sets model.pipeline_axis")
    p.add_argument("--pipeline-microbatches", type=int, default=2)
    args = p.parse_args(argv)
    if args.pipeline_parallel > 1 and (args.multihost or args.tensor_parallel > 1):
        raise SystemExit("--pipeline-parallel composes only with the data axis for now")
    if args.tensor_parallel > 1 and args.multihost:
        raise SystemExit("--tensor-parallel with --multihost is not supported yet (tensor "
                         "collectives stay within a host; shard tp within it)")
    if args.multihost and (args.devices or 1) > 1:
        raise SystemExit("--multihost runs one rank a process, one card each: start one "
                         "process a card (--devices counts this host's ranks without it)")
    if args.dist_backend == "nccl" and args.device == "cpu":
        raise SystemExit("--dist-backend nccl moves CUDA tensors: gloo on the CPU")
    return args


def check_config(cfg) -> None:
    """Refuse what the config asks for and the port does not train, before
    anything is built."""
    model_type = cfg.model["model"].get("type")
    if model_type in RETRIEVAL_MODELS:
        from motioncraft_tpu_torch.models.baselines import RETRIEVAL_TRAINING

        raise SystemExit(f"{model_type}: {RETRIEVAL_TRAINING}")
    if cfg.get("fp16") is not None:
        from motioncraft_tpu_torch.apis.train import half_dtype

        try:
            half_dtype(cfg.fp16)
        except NotImplementedError as e:
            raise SystemExit(f"fp16: {e}")


def frozen_prefixes(model_cfg: dict) -> tuple:
    """What training freezes: CLIP (MDM's at ``clip``, which the JAX
    package's ``stop_gradient`` keeps where it is: a zero gradient moves
    no Adam parameter); for a ControlNet, its base as
    controlnet_frozen_prefixes says (tools/train.py's choice)."""
    if model_cfg.get("type") == "MDMTransformer":
        return ("clip/",)
    if model_cfg.get("type") not in CONTROLNETS:
        return ("text_enc/clip",)
    from motioncraft_tpu_torch.models.controlnet import controlnet_frozen_prefixes

    return tuple(controlnet_frozen_prefixes(model_cfg.get("joint_embed_unfreeze", True),
                                            model_cfg.get("unfreeze_mode", "all"))
                 ) + ("base_model/text_enc/clip",)


def base_graft(path: str, copy_blocks_num: int, log=print):
    """``train_model``'s ``model_transform`` for ``--base-checkpoint``: the
    ``params`` of ``path`` (either package's params.npz) loaded, strictly,
    into ``base_model`` with the first ``copy_blocks_num`` blocks copied
    into the control blocks; into the whole model when it has no
    ``base_model``.  Logs the load to ``log``."""
    from motioncraft_tpu_torch.models.controlnet import init_control_blocks_from_base
    from motioncraft_tpu_torch.utils.checkpoint import load_params
    from motioncraft_tpu_torch.utils.convert import from_jax_params

    def transform(model):
        base = from_jax_params(load_params(path)["params"])
        if hasattr(model, "base_model"):
            model.base_model.load_state_dict(base, strict=True)
            model.load_state_dict(init_control_blocks_from_base(model.state_dict(),
                                                                copy_blocks_num), strict=True)
        else:
            model.load_state_dict(base, strict=True)
        log(f"loaded base checkpoint {path}")

    return transform


def keeping_rng(fn):
    """``fn`` with numpy's and torch's global generators put back after it:
    on a mesh rank 0 alone runs the evaluation hook, whose data pipeline
    draws from them, and every rank's loader must go on drawing the same
    crops."""
    def wrapped(*args, **kwargs):
        import numpy as np
        import torch

        saved = (np.random.get_state(), torch.get_rng_state(),
                 torch.cuda.get_rng_state_all() if torch.cuda.is_available() else None)
        try:
            return fn(*args, **kwargs)
        finally:
            np.random.set_state(saved[0])
            torch.set_rng_state(saved[1])
            if saved[2] is not None:
                torch.cuda.set_rng_state_all(saved[2])
    return wrapped


def file_logger(path: str) -> logging.Logger:
    """A logger to stdout and, appended, to ``path``, in the JAX package's
    line format (motioncraft_tpu/utils/logger.py)."""
    logger = logging.getLogger(f"motioncraft_torch.train.{os.path.abspath(path)}")
    logger.setLevel(logging.INFO)
    logger.propagate = False
    fmt = logging.Formatter("%(asctime)s - motioncraft - %(levelname)s - %(message)s")
    for handler in (logging.StreamHandler(sys.stdout), logging.FileHandler(path)):
        handler.setFormatter(fmt)
        logger.addHandler(handler)
    return logger


def silent_logger(rank: int) -> logging.Logger:
    """The logger of a rank other than 0: rank 0 writes train.log."""
    logger = logging.getLogger(f"motioncraft_torch.train.rank{rank}")
    logger.propagate = False
    return logger


def close_logger(logger: logging.Logger) -> None:
    for handler in list(logger.handlers):
        handler.close()
        logger.removeHandler(handler)


def backend(args) -> str:
    return args.dist_backend or ("nccl" if args.device == "cuda" else "gloo")


def load_config(args):
    """The config file with ``--cfg-options`` merged in, checked."""
    from motioncraft_tpu_torch.config import Config, cfg_options_from_args

    cfg = Config.fromfile(args.config)
    cfg.merge_from_dict(cfg_options_from_args(args.cfg_options))
    check_config(cfg)
    if args.pipeline_parallel > 1:
        if cfg.model["model"].get("type") != "STMoGenTransformer":
            raise SystemExit("--pipeline-parallel is implemented for "
                             "STMoGenTransformer decoder stacks")
        cfg.model["model"]["pipeline_axis"] = "pipe"
        cfg.model["model"]["pipeline_microbatches"] = args.pipeline_microbatches
    return cfg


def run(args):
    """Train as ``args`` say; returns the final ``TrainState`` (with
    ``--devices N`` > 1, rank 0's update count: the ranks ran in their own
    processes)."""
    import torch

    from motioncraft_tpu_torch.parallel.mesh import (create_mesh, init_distributed, launch,
                                                     local_device)

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run on the CPU")
    load_config(args)  # refused before any rank starts
    if args.multihost:
        rank = init_distributed(args.coordinator, args.num_processes, args.process_id,
                                backend=backend(args))
        device = local_device(rank) if args.device == "cuda" else "cpu"
        return train(args, create_mesh(device=device))
    tp, pp = args.tensor_parallel, args.pipeline_parallel
    n = args.devices or (torch.cuda.device_count() if max(tp, pp) > 1 and args.device == "cuda"
                         else 1)
    if tp > 1 and n % tp:
        raise SystemExit(f"--tensor-parallel {tp} does not divide {n} devices")
    if pp > 1 and n % pp:
        raise SystemExit(f"--pipeline-parallel {pp} does not divide {n} devices")
    if n == 1:
        return train(args, None)
    if args.device == "cuda" and n > torch.cuda.device_count():
        raise SystemExit(f"--devices {n}: this host has {torch.cuda.device_count()} "
                         "CUDA device(s), one a rank")
    return launch(_rank, n, args=(args, n), backend=backend(args))[0]


def mesh_axes(n: int, tp: int, pp: int = 1):
    """(axes, shape) of ``n`` ranks at ``--tensor-parallel tp`` or
    ``--pipeline-parallel pp``: tools/train.py's mesh, data alone without
    either."""
    if pp > 1:
        return ("data", "pipe"), (n // pp, pp)
    if tp <= 1:
        return ("data",), (n,)
    ep = 2 if (n // tp) % 2 == 0 and n // tp >= 2 else 1
    return ("data", "expert", "tensor"), (n // (tp * ep), ep, tp)


def _rank(rank: int, args, n: int) -> int:
    """One rank of ``--devices N``: its card (or the CPU), the mesh of the
    N spawned ranks, the training; returns the update count."""
    from motioncraft_tpu_torch.parallel.mesh import create_mesh, local_device

    device = local_device(rank) if args.device == "cuda" else "cpu"
    axes, shape = mesh_axes(n, args.tensor_parallel, args.pipeline_parallel)
    return int(train(args, create_mesh(n, axes=axes, shape=shape, device=device)).step)


def train(args, mesh):
    """Train as ``args`` say on this process: one process, or one rank of
    ``mesh``."""
    import torch

    from motioncraft_tpu_torch.apis import train_model
    from motioncraft_tpu_torch.config import Config
    from motioncraft_tpu_torch.data import RankRows, build_dataloader
    from motioncraft_tpu_torch.registry import build_architecture, build_dataset
    from motioncraft_tpu_torch.utils.checkpoint import save_checkpoint, save_state_params

    cfg = load_config(args)
    work_dir = args.work_dir or os.path.join(
        "outputs", os.path.splitext(os.path.basename(args.config))[0])
    sharded = mesh is not None and mesh.model_sharded
    lead = mesh is None or mesh.lead
    if lead:
        os.makedirs(work_dir, exist_ok=True)
    logger = (file_logger(os.path.join(work_dir, "train.log")) if lead
              else silent_logger(mesh.global_rank))
    device = args.device if mesh is None else mesh.device
    optimizer_config = cfg.get("optimizer_config", {}) or {}
    grad_accum = args.grad_accum or optimizer_config.get("cumulative_iters", 1)
    try:
        logger.info(f"config: {args.config}\nwork_dir: {work_dir}")
        torch.manual_seed(args.seed)  # the model's initial weights
        arch = build_architecture(cfg.model, device=device)
        dataset = build_dataset(cfg.data["train"])  # a mixed set too
        loader = build_dataloader(dataset, samples_per_gpu=cfg.data["samples_per_gpu"],
                                  shuffle=True, seed=args.seed,
                                  dist=args.multihost and mesh is not None,
                                  workers_per_gpu=cfg.data.get("workers_per_gpu", 2))
        if mesh is not None and not args.multihost:
            loader = RankRows(loader, mesh, grad_accum)
        ranks = "" if mesh is None else f"; mesh: {mesh.shape} over {mesh.backend}"
        logger.info(f"device: {args.device}{ranks}; dataset: {len(dataset)} samples, "
                    f"{len(loader)} steps/epoch")

        ckpt_dir = os.path.join(work_dir, "ckpt")
        ckpt_cfg = cfg.get("checkpoint_config", {}) or {}
        interval = ckpt_cfg.get("interval", 1)
        max_keep = ckpt_cfg.get("max_keep_ckpts")

        def on_lead(fn):
            """``fn`` on rank 0 alone (the ranks' states are equal); the
            others wait for it."""
            def wrapped(state, epoch):
                if lead:
                    fn(state, epoch)
                if mesh is not None:
                    mesh.barrier()
            return wrapped

        def whole(state):
            """The model's whole state_dict, its shards gathered (every
            rank calls it on a sharded mesh)."""
            from motioncraft_tpu_torch.parallel.tp import full_state_dict

            return full_state_dict(state.model, state.sharding)

        def checkpoint_fn(state, epoch):
            if (epoch + 1) % interval:
                return
            # every rank: a sharded state is gathered, rank 0 writes
            save_checkpoint(ckpt_dir, state, epoch, max_to_keep=max_keep)
            save_state_params(os.path.join(work_dir, "params.npz"), state)
            logger.info(f"saved checkpoint at epoch {epoch}")
            if mesh is not None:
                mesh.barrier()

        eval_fn = None
        if cfg.get("evaluation") and cfg.data.get("test"):
            from motioncraft_tpu_torch.apis import EvalHook

            test_cfg = Config.fromdict(cfg.data["test"])
            ev_cfg = test_cfg.get("eval_cfg", {}).get("evaluator_model")
            if isinstance(ev_cfg, dict):
                ev_cfg["device"] = device
            ev = dict(cfg["evaluation"])
            test_set = build_dataset(test_cfg)
            # on a sharded mesh rank 0 evaluates a whole copy of the weights
            eval_arch = (build_architecture(cfg.model, device=device) if sharded and lead
                         else arch)
            hook = EvalHook(test_set, eval_arch,
                            batch_size=ev.get("batch_size", 32),
                            interval=ev.get("interval", 1), limit=ev.get("limit"),
                            save_best=ev.get("save_best"), work_dir=work_dir,
                            logger=logger.info)
            eval_fn = on_lead(hook if mesh is None else keeping_rng(hook))
            if sharded:
                @keeping_rng
                def whole_hook(sd, epoch):
                    eval_arch.model.load_state_dict(sd, strict=True)
                    eval_arch.eval()
                    hook(types.SimpleNamespace(model=eval_arch.model), epoch)

                def eval_fn(state, epoch):
                    if (epoch + 1) % hook.interval:
                        return
                    sd = whole(state)
                    if lead:
                        whole_hook(sd, epoch)
                    mesh.barrier()

        transform = None
        if args.base_checkpoint:
            transform = base_graft(args.base_checkpoint,
                                   cfg.model["model"].get("copy_blocks_num", 2), logger.info)
        state = train_model(
            arch, loader,
            optimizer_cfg=dict(cfg.get("optimizer", {"type": "Adam", "lr": 2e-4})),
            lr_config=dict(cfg.get("lr_config", {})) or None,
            grad_clip=optimizer_config.get("grad_clip"),
            max_epochs=args.max_epochs or cfg.get("runner", {}).get("max_epochs", 1),
            steps_per_epoch=len(loader), seed=args.seed,
            log_interval=cfg.get("log_config", {}).get("interval", 50),
            logger=logger.info, checkpoint_fn=checkpoint_fn, eval_fn=eval_fn,
            frozen_prefixes=frozen_prefixes(cfg.model["model"]),
            resume_dir=ckpt_dir if args.resume else None, model_transform=transform,
            fp16=cfg.get("fp16"), grad_accum=grad_accum, mesh=mesh)
        logger.info(f"training done at step {int(state.step)}")
        if args.device == "cuda":
            logger.info(f"max memory allocated "
                        f"{torch.cuda.max_memory_allocated(device) / 2**30:.3f} GiB")
        return state
    finally:
        close_logger(logger)


def main(argv=None):
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
