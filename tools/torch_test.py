"""T2M evaluation entry point of the PyTorch port (the counterpart of
tools/test.py, which runs the JAX package).

config -> test dataset (+ evaluator model, shuffled replications) -> the
loader's batches -> DDIM sampling on the card (or GT pass-through) ->
dataset.evaluate -> metrics.json, with the same honesty flags as
tools/test.py.  Runs on the card unless ``--device cpu``.

Usage:
  python tools/torch_test.py configs/stmogen/t2m_motionx_0_125b.py work_dir \\
      --checkpoint params.npz          # a save_params snapshot of either package
  python tools/torch_test.py CONFIG work_dir --torch-checkpoint released.pth
  python tools/torch_test.py configs/tests/tiny_t2m.py out --device cpu \\
      --cfg-options model.inference_type=gt          # FID must be ~0

Not ported yet, and refused rather than ignored: --bf16, --int8 and the step
cache, --dispatch-batches > 1 and the RePaint knobs (each names its ROADMAP
queue 1 item).
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np  # noqa: E402

REPAINT_DEFAULTS = dict(no_repaint=False, no_resample=False, addBlend=True,
                        same_overlap_noisy=False, overlap_len=4, jump_n_sample=2,
                        jump_length=3)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Evaluate a motion model with the PyTorch port")
    p.add_argument("config")
    p.add_argument("work_dir", nargs="?", default="outputs/eval")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the model and the evaluator run; cuda raises "
                        "without a card")
    p.add_argument("--checkpoint", default=None,
                   help=".npz params snapshot (utils/checkpoint.py:save_params of "
                        "either package)")
    p.add_argument("--torch-checkpoint", default=None, help="released STMoGen .pth")
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--limit", type=int, default=None,
                   help="evaluate only the first N results (smoke runs)")
    p.add_argument("--dump-samples", default=None, metavar="PATH",
                   help="save the generated motions (loader order, before "
                        "evaluation) to PATH.npz")
    p.add_argument("--dump-samples-limit", type=int, default=1024,
                   help="cap the number of dumped motions (file size)")
    p.add_argument("--cfg-options", nargs="*", default=None)
    # tools/test.py's options that the port does not run yet
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--int8", nargs="?", const="w8a8", default=None, choices=["w8a8", "w8"])
    p.add_argument("--int8-mode", default=None, choices=["w8a8", "w8"])
    p.add_argument("--step-cache", type=int, default=0, metavar="N")
    p.add_argument("--step-cache-table", default=None, metavar="PATH")
    p.add_argument("--dispatch-batches", type=int, default=1, metavar="K")
    p.add_argument("--no_repaint", action="store_true")
    p.add_argument("--no_resample", action="store_true")
    p.add_argument("--addBlend", action="store_true", default=True)
    p.add_argument("--same_overlap_noisy", action="store_true")
    p.add_argument("--overlap_len", type=int, default=4)
    p.add_argument("--jump_n_sample", type=int, default=2)
    p.add_argument("--jump_length", type=int, default=3)
    args = p.parse_args(argv)
    if args.bf16 or args.int8 or args.int8_mode:
        raise SystemExit("--bf16 / --int8: low-precision inference is not ported "
                         "(ROADMAP queue 1: step cache and bf16/int8 inference)")
    if args.step_cache or args.step_cache_table:
        raise SystemExit("--step-cache / --step-cache-table: the step cache is not "
                         "ported (ROADMAP queue 1: step cache and bf16/int8 inference)")
    if args.dispatch_batches != 1:
        raise SystemExit("--dispatch-batches > 1: grouped dispatch is not ported "
                         "(ROADMAP queue 1: multi-GPU, serving and the host-side tools)")
    if any(getattr(args, k) != v for k, v in REPAINT_DEFAULTS.items()):
        raise SystemExit("RePaint options: windowed outpainting is not ported "
                         "(ROADMAP queue 1: S2G/M2D and ControlNet)")
    return args


def run(args, logger=print) -> dict:
    """Evaluate as ``args`` say; returns the metrics.json content (``out``)
    with the model, the dataset, the results and the wall seconds of
    sampling and of evaluation."""
    import torch

    from motioncraft_tpu_torch.config import Config, cfg_options_from_args
    from motioncraft_tpu_torch.data import build_dataloader
    from motioncraft_tpu_torch.models.tokenizer import find_bpe_asset
    from motioncraft_tpu_torch.registry import build_architecture, build_dataset
    from motioncraft_tpu_torch.utils.checkpoint import load_eval_variables

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run on the CPU")
    cfg = Config.fromfile(args.config)
    cfg.merge_from_dict(cfg_options_from_args(args.cfg_options))
    os.makedirs(args.work_dir, exist_ok=True)
    # the protocol's replication shuffles, each sample's caption and crop,
    # and the Diversity evaluator draw from the global numpy generator, as in
    # tools/test.py: the same --seed gives the same draws in both tools
    np.random.seed(args.seed)
    torch.manual_seed(args.seed)

    arch = build_architecture(cfg.model, device=args.device)
    test_cfg = Config.fromdict(cfg.data["test"])
    ev_cfg = test_cfg.get("eval_cfg", {}).get("evaluator_model")
    if isinstance(ev_cfg, dict):
        ev_cfg["device"] = args.device
    dataset = build_dataset(test_cfg)
    bs = args.batch_size or cfg.data["samples_per_gpu"]
    loader = build_dataloader(dataset, samples_per_gpu=bs, shuffle=False, round_up=False,
                              workers_per_gpu=cfg.data.get("workers_per_gpu", 0))
    loader.drop_last = False
    if arch.inference_type != "gt":
        # tools/test.py reads one batch to initialise its model; reading it
        # here too keeps the two tools' numpy draws (captions, crops) alike
        next(iter(loader))
        load_eval_variables(cfg.model, arch.model, checkpoint=args.checkpoint,
                            torch_checkpoint=args.torch_checkpoint)

    from motioncraft_tpu_torch.apis.test import single_device_test
    t0 = time.perf_counter()
    results = single_device_test(arch, loader, seed=args.seed, limit=args.limit,
                                 device=args.device, logger=lambda m: logger("  " + m))
    sample_s = time.perf_counter() - t0
    logger(f"sampled {len(results)} results in {sample_s:.1f}s")
    if args.dump_samples:
        n = min(len(results), args.dump_samples_limit)
        os.makedirs(os.path.dirname(os.path.abspath(args.dump_samples)), exist_ok=True)
        np.savez_compressed(
            args.dump_samples,
            pred_motion=np.stack([np.asarray(r["pred_motion"], np.float32)
                                  for r in results[:n]]),
            motion_length=np.stack([np.asarray(r["motion_length"]).reshape(-1)[:1]
                                    for r in results[:n]]).reshape(-1))
        logger(f"dumped {n} samples -> {args.dump_samples}")
    t1 = time.perf_counter()
    metrics = dataset.evaluate(results[:args.limit] if args.limit else results,
                               args.work_dir)
    eval_s = time.perf_counter() - t1
    for k, v in metrics.items():
        logger(f"{k}: {float(v):.4f}")
    out = {k: float(v) for k, v in metrics.items()}
    ev = getattr(dataset, "evaluator_model", None)
    flags = {
        "untrained_evaluator": not getattr(ev, "pretrained_loaded", False),
        "hash_tokenizer": find_bpe_asset() is None,
        "int8_weights": False,
        "step_cache": 0,
        "step_cache_table": None,
    }
    approx = ("int8_weights", "step_cache", "step_cache_table")
    out["protocol"] = not any(v for k, v in flags.items() if k not in approx)
    out["flags"] = flags
    if not out["protocol"]:
        logger(f"WARNING: run is NOT protocol-comparable: {flags}")
    with open(os.path.join(args.work_dir, "metrics.json"), "w") as f:
        json.dump(out, f, indent=2)
    return {"out": out, "arch": arch, "dataset": dataset, "results": results,
            "sample_s": sample_s, "eval_s": eval_s}


def main(argv=None):
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
