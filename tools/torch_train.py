"""Training entry point of the PyTorch port (the counterpart of
tools/train.py, which runs the JAX package), on one card.

config -> train dataset -> shuffled, seeded loader -> train_model (the
config's optimizer, lr schedule, gradient clip and cumulative_iters; CLIP
frozen) -> per-epoch checkpoints (``checkpoint_config.interval`` /
``max_keep_ckpts``, written whole or not at all) with ``params.npz`` in the
JAX package's layout, which tools/test.py and tools/torch_test.py
--checkpoint both read -> ``EvalHook`` when the config has ``evaluation``.
``train.log`` in the work dir holds tools/train.py's lines (``dataset: N
samples, M steps/epoch``, ``epoch E step S: loss=...``, ``epoch E done in
Xs``, ``saved checkpoint at epoch E``, ``resumed from ... at epoch E``) and
grows across ``--resume``.  Runs on the card unless ``--device cpu``.

Usage:
  python tools/torch_train.py configs/tests/protocol_learn.py \\
      --work-dir outputs/soak_torch --grad-accum 2 [--resume] [--max-epochs N]
  python tools/torch_train.py configs/tests/tiny_t2m.py --device cpu \\
      --work-dir out --max-epochs 1         # after tools/make_tiny_data.py

A resumed epoch draws the batches the uninterrupted run draws when the
loader has no worker threads (``data.workers_per_gpu=0``): threads take
the samples' random crops and captions in the order they run.
Not ported yet, and refused rather than ignored: several devices, tensor
and pipeline parallelism and several hosts; a base checkpoint, ControlNet
configs, a mixed train set and fp16 (each names its ROADMAP queue 1 item).
"""

import argparse
import logging
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

MULTI = "ROADMAP queue 1: multi-GPU, serving and the host-side tools"
TRAINING = "ROADMAP queue 1: the rest of training"
CONTROLNETS = ("ControlT2MHalf", "ControlT2MHalfMCM")


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
    # tools/train.py's options that the port does not run yet
    p.add_argument("--base-checkpoint", default=None)
    p.add_argument("--devices", type=int, default=None)
    p.add_argument("--tensor-parallel", type=int, default=1)
    p.add_argument("--pipeline-parallel", type=int, default=1)
    p.add_argument("--multihost", action="store_true")
    p.add_argument("--coordinator", default=None)
    args = p.parse_args(argv)
    if ((args.devices or 1) > 1 or args.tensor_parallel > 1 or args.pipeline_parallel > 1
            or args.multihost or args.coordinator):
        raise SystemExit("--devices > 1, --tensor-parallel, --pipeline-parallel, "
                         f"--multihost and --coordinator: one card only ({MULTI})")
    if args.base_checkpoint:
        raise SystemExit(f"--base-checkpoint: ControlNet training ({TRAINING})")
    return args


def check_config(cfg) -> None:
    """Refuse what the config asks for and the port does not train yet."""
    if cfg.model["model"].get("type") in CONTROLNETS:
        raise SystemExit(f"{cfg.model['model']['type']}: ControlNet training ({TRAINING})")
    if "base" in cfg.data["train"]:
        raise SystemExit(f"a mixed train set (data.train.base) ({TRAINING})")
    if cfg.get("fp16"):
        raise SystemExit(f"fp16: half-precision training ({TRAINING})")


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


def close_logger(logger: logging.Logger) -> None:
    for handler in list(logger.handlers):
        handler.close()
        logger.removeHandler(handler)


def run(args):
    """Train as ``args`` say; returns the final ``TrainState``."""
    import torch

    from motioncraft_tpu_torch.apis import train_model
    from motioncraft_tpu_torch.config import Config, cfg_options_from_args
    from motioncraft_tpu_torch.data import build_dataloader
    from motioncraft_tpu_torch.registry import build_architecture, build_dataset
    from motioncraft_tpu_torch.utils.checkpoint import save_checkpoint, save_params

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run on the CPU")
    cfg = Config.fromfile(args.config)
    cfg.merge_from_dict(cfg_options_from_args(args.cfg_options))
    check_config(cfg)
    work_dir = args.work_dir or os.path.join(
        "outputs", os.path.splitext(os.path.basename(args.config))[0])
    os.makedirs(work_dir, exist_ok=True)
    logger = file_logger(os.path.join(work_dir, "train.log"))
    try:
        logger.info(f"config: {args.config}\nwork_dir: {work_dir}")
        torch.manual_seed(args.seed)  # the model's initial weights
        arch = build_architecture(cfg.model, device=args.device)
        dataset = build_dataset(cfg.data["train"])
        loader = build_dataloader(dataset, samples_per_gpu=cfg.data["samples_per_gpu"],
                                  shuffle=True, seed=args.seed,
                                  workers_per_gpu=cfg.data.get("workers_per_gpu", 2))
        logger.info(f"device: {args.device}; dataset: {len(dataset)} samples, "
                    f"{len(loader)} steps/epoch")

        ckpt_dir = os.path.join(work_dir, "ckpt")
        ckpt_cfg = cfg.get("checkpoint_config", {}) or {}
        interval = ckpt_cfg.get("interval", 1)
        max_keep = ckpt_cfg.get("max_keep_ckpts")

        def checkpoint_fn(state, epoch):
            if (epoch + 1) % interval:
                return
            save_checkpoint(ckpt_dir, state, epoch, max_to_keep=max_keep)
            save_params(os.path.join(work_dir, "params.npz"), state.model)
            logger.info(f"saved checkpoint at epoch {epoch}")

        eval_fn = None
        if cfg.get("evaluation") and cfg.data.get("test"):
            from motioncraft_tpu_torch.apis import EvalHook

            test_cfg = Config.fromdict(cfg.data["test"])
            ev_cfg = test_cfg.get("eval_cfg", {}).get("evaluator_model")
            if isinstance(ev_cfg, dict):
                ev_cfg["device"] = args.device
            ev = dict(cfg["evaluation"])
            eval_fn = EvalHook(build_dataset(test_cfg), arch,
                               batch_size=ev.get("batch_size", 32),
                               interval=ev.get("interval", 1), limit=ev.get("limit"),
                               save_best=ev.get("save_best"), work_dir=work_dir,
                               logger=logger.info)

        optimizer_config = cfg.get("optimizer_config", {}) or {}
        state = train_model(
            arch, loader,
            optimizer_cfg=dict(cfg.get("optimizer", {"type": "Adam", "lr": 2e-4})),
            lr_config=dict(cfg.get("lr_config", {})) or None,
            grad_clip=optimizer_config.get("grad_clip"),
            max_epochs=args.max_epochs or cfg.get("runner", {}).get("max_epochs", 1),
            steps_per_epoch=len(loader), seed=args.seed,
            log_interval=cfg.get("log_config", {}).get("interval", 50),
            logger=logger.info, checkpoint_fn=checkpoint_fn, eval_fn=eval_fn,
            resume_dir=ckpt_dir if args.resume else None,
            grad_accum=args.grad_accum or optimizer_config.get("cumulative_iters", 1))
        logger.info(f"training done at step {int(state.step)}")
        if args.device == "cuda":
            logger.info(f"max memory allocated "
                        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
        return state
    finally:
        close_logger(logger)


def main(argv=None):
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
