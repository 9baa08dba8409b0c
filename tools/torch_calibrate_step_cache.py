"""Calibrate a step-cache reuse table with the PyTorch port (the counterpart
of tools/calibrate_step_cache.py, which runs the JAX package).

SmoothCache's offline calibration (diffusion/stepcache.py): one exact DDIM
probe (``StepCacheConfig(collect_errors=True)``: every layer computes) over a
few batches of the config's test set records each decoder layer's relative
L1 residual change per step, on the device, copied to the host once a batch;
the mean over the batches is thresholded into a per-(step, layer) reuse
table.  It is saved as ``.npz`` (``errors``, ``flags``, ``threshold``,
``max_consecutive``) and, with ``--json``, in the schema of
artifacts/step_cache_flagship.json, for ``--step-cache-table`` of
tools/torch_test.py.  Runs on the card unless ``--device cpu``.

Usage:
  python tools/torch_calibrate_step_cache.py CONFIG out.npz \\
      [--checkpoint params.npz | --torch-checkpoint model.pth] \\
      [--threshold 0.15] [--max-consecutive 3] [--batches 2] [--bf16] [--json out.json]
  python tools/torch_calibrate_step_cache.py configs/tests/tiny_t2m.py out.npz \\
      --device cpu --batches 1 --batch-size 4 --perturb 0.05   # after make_tiny_data.py
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np  # noqa: E402


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Calibrate a step-cache reuse table "
                                            "with the PyTorch port")
    p.add_argument("config")
    p.add_argument("out", help="output .npz (errors + flags)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the probe runs; cuda raises without a card")
    p.add_argument("--checkpoint", default=None,
                   help=".npz params snapshot (save_params of either package)")
    p.add_argument("--torch-checkpoint", default=None, help="released .pth")
    p.add_argument("--threshold", type=float, default=0.15,
                   help="reuse a layer when its previous step's relative L1 residual "
                        "change is below this")
    p.add_argument("--max-consecutive", type=int, default=3)
    p.add_argument("--tail", type=int, default=2)
    p.add_argument("--batches", type=int, default=2, help="probe batches to average over")
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--perturb", type=float, default=0.0, metavar="SCALE",
                   help="add SCALE x N(0, 1) to every float weight first: an untouched "
                        "random-init model's zero-initialised output projections give "
                        "identically zero residuals; leave 0 for trained weights")
    p.add_argument("--bf16", action="store_true",
                   help="probe with the weights cast to bf16 and the denoiser in bf16")
    p.add_argument("--note", default=None, help="provenance note for the --json artifact")
    p.add_argument("--json", default=None, metavar="PATH",
                   help="also write the JSON artifact (error profile, flags, threshold, "
                        "provenance)")
    p.add_argument("--cfg-options", nargs="*", default=None)
    return p.parse_args(argv)


def run(args, logger=print) -> dict:
    """Probe and write the table; returns {"errors", "flags", "artifact"}."""
    import torch

    from motioncraft_tpu_torch.apis import bf16_cast_
    from motioncraft_tpu_torch.config import Config, cfg_options_from_args
    from motioncraft_tpu_torch.data import build_dataloader
    from motioncraft_tpu_torch.diffusion import StepCacheConfig, flags_from_errors
    from motioncraft_tpu_torch.registry import build_architecture, build_dataset
    from motioncraft_tpu_torch.utils.checkpoint import load_eval_variables

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run on the CPU")
    cfg = Config.fromfile(args.config)
    cfg.merge_from_dict(cfg_options_from_args(args.cfg_options))
    np.random.seed(args.seed)
    arch = build_architecture(cfg.model, device=args.device)
    if not getattr(arch.model, "supports_step_cache", False):
        raise SystemExit(f"{type(arch.model).__name__} has no step-cache support")
    test_cfg = Config.fromdict(cfg.data["test"])
    ev_cfg = test_cfg.get("eval_cfg", {}).get("evaluator_model")
    if isinstance(ev_cfg, dict):  # the dataset builds its evaluator: on this device
        ev_cfg["device"] = args.device
    dataset = build_dataset(test_cfg)
    bs = args.batch_size or cfg.data["samples_per_gpu"]
    loader = build_dataloader(dataset, samples_per_gpu=bs, shuffle=False, round_up=False,
                              workers_per_gpu=0)
    load_eval_variables(cfg.model, arch.model, checkpoint=args.checkpoint,
                        torch_checkpoint=args.torch_checkpoint)
    if args.perturb:
        g = torch.Generator().manual_seed(args.seed + 7)
        with torch.no_grad():
            for p in arch.model.parameters():
                if p.is_floating_point():
                    p.add_(args.perturb * torch.randn(p.shape, generator=g).to(p.device))
    compute_dtype = None
    if args.bf16:
        bf16_cast_(arch)
        compute_dtype = torch.bfloat16

    probe = StepCacheConfig(collect_errors=True)
    generator = torch.Generator(device=args.device).manual_seed(args.seed + 1)
    errs = []
    for i, batch in enumerate(loader):
        if i == args.batches:
            break
        nb = {k: v for k, v in batch.items()
              if isinstance(v, np.ndarray) and np.issubdtype(v.dtype, np.number)}
        errs.append(arch.sample(nb, generator=generator, compute_dtype=compute_dtype,
                                step_cache=probe)[1])
        logger(f"probe batch {i + 1}/{args.batches} done")
    errors = np.mean(errs, axis=0)
    if not (errors[1:] > 0).any():
        raise SystemExit("vacuous error profile: every layer residual is zero from step 1 "
                         "on (zero-initialised output projections); pass --perturb 0.05 "
                         "for a mechanics run, or trained weights for a table to deploy")
    flags = flags_from_errors(errors, threshold=args.threshold,
                              max_consecutive=args.max_consecutive, tail=args.tail)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    np.savez(args.out, errors=errors, flags=flags, threshold=args.threshold,
             max_consecutive=args.max_consecutive)
    artifact = {
        "config": os.path.relpath(args.config),
        "platform": "gpu" if args.device == "cuda" else "cpu",
        "device": (torch.cuda.get_device_name(0) if args.device == "cuda" else "cpu"),
        "threshold": args.threshold,
        "max_consecutive": args.max_consecutive,
        "tail": args.tail,
        "batches": len(errs),
        "batch_size": bs,
        "seed": args.seed,
        "bf16": bool(args.bf16),
        # with no weights given the probe runs on seeded random weights: it
        # checks the mechanics, not a table to deploy
        "random_weights": args.checkpoint is None and args.torch_checkpoint is None,
        "perturb": args.perturb,
        "checkpoint": args.checkpoint or args.torch_checkpoint,
        "note": args.note,
        "steps": int(errors.shape[0]),
        "layers": int(errors.shape[1]),
        "reuse_fraction": float(flags.mean()),
        "per_step_mean_error": [round(float(x), 6) for x in errors.mean(axis=1)],
        "errors": [[round(float(x), 6) for x in row] for row in errors],
        "flags": flags.astype(int).tolist(),
    }
    if args.json:
        with open(args.json, "w") as f:
            json.dump(artifact, f, indent=1)
        logger(f"json artifact -> {args.json}")
    logger(f"steps={errors.shape[0]} layers={errors.shape[1]} reuse fraction "
           f"{flags.mean():.1%} of the decoder-layer computes\nsaved -> {args.out}")
    return {"errors": errors, "flags": flags, "artifact": artifact}


def main(argv=None):
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
