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
  python tools/torch_test.py configs/finemogen/finemogen_t2m.py out \\
      --torch-checkpoint finemogen_t2m.pth     # FineMoGen (SAMI)
  python tools/torch_test.py configs/motiondiffuse/motiondiffuse_t2m_smplx.py out \
      --checkpoint params.npz --bf16 --int8-mode w8   # any baseline, DDPM included

The HumanML3D and KIT-ML configs (stmogen/t2m_humanml3d.py, the
MotionDiffuse, MDM, MCM and FineMoGen ones) evaluate through the BiGRU
evaluator (eval/models.py:T2MContrastiveModel): its ./data/evaluators
checkpoint and ./data/glove word vectors where they exist, else seeded
weights (flagged untrained_evaluator) and md5-hashed word vectors (not
flagged, as in tools/test.py).  The JAX
package's tools/test.py samples FineMoGen only with --cfg-options
model.model.text_hoist=False; this tool computes the same at the default.

``--bf16`` casts the weights to bf16 and samples with the denoiser in bf16
(the metric math stays f32), as tools/test.py does.  ``--int8 [w8a8|w8]``
(or ``--int8-mode``) quantizes the denoiser's audited weights after the cast
(ops/quant.py), ``--step-cache N`` reuses each layer's residual on all but
every N-th DDIM step and ``--step-cache-table PATH`` on a calibrated table
(e.g. artifacts/step_cache_flagship.json): approximate modes, stamped into
metrics.json.  Every baseline config takes ``--bf16`` and ``--int8`` (their
attentions run K5's bf16 instantiation); of them only FineMoGen takes the
step cache; on the others (and under DDPM) the sampler refuses it with the
JAX package's words.  The RePaint knobs set ``arch.repaint_cfg`` as tools/test.py
does (a T2M sample does not outpaint, so they leave it unchanged).
``--dispatch-batches K`` groups K batches into one wait for the card (the
same predictions).  ReMoDiffuse (remodiffuse/remodiffuse_t2m.py)
samples only with a retrieval, which neither this tool nor tools/test.py
builds: it exits saying so (GT mode runs).

  python tools/torch_test.py CONFIG out --checkpoint params.npz --bf16 --int8
  python tools/torch_test.py CONFIG out --step-cache-table \
      artifacts/step_cache_flagship.json

Several processes (tools/test.py's multi-host evaluation): one process a
rank, joined through torchrun's environment (``torchrun --nproc-per-node N
tools/torch_test.py ...``) or ``--coordinator host:port --num-processes N
--process-id R``, one card a rank over NCCL, or gloo with
``--dist-backend gloo`` (several ranks on one card, or ``--device cpu``).
Each rank samples its interleaved slice of the test set (rounded up, seed
+ rank), the results are gathered in dataset order, and rank 0 evaluates
and writes metrics.json and the dump.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np  # noqa: E402

from tools.torch_lowprec import (add_lowprec_args, apply_lowprec_,  # noqa: E402
                                 lowprec_from_args, step_cache_from_args)


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
    p.add_argument("--torch-checkpoint", default=None,
                   help="a reference .pth (STMoGen, ControlNet, MotionDiffuse, MCM, MDM, "
                        "FineMoGen)")
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
    p.add_argument("--bf16", action="store_true",
                   help="bf16 denoiser compute (weights cast, compute_dtype bf16; the "
                        "metric math stays f32)")
    add_lowprec_args(p, table=True)
    p.add_argument("--dispatch-batches", type=int, default=1, metavar="K",
                   help="copy the predictions of K batches to the host at once")
    # several processes (else torchrun's environment)
    p.add_argument("--coordinator", default=None, help="host:port of process 0")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--dist-backend", choices=["nccl", "gloo"], default=None,
                   help="default: nccl on the card, gloo on the CPU")
    # the RePaint knobs (repaint_cfg)
    p.add_argument("--no_repaint", action="store_true")
    p.add_argument("--no_resample", action="store_true")
    p.add_argument("--addBlend", action="store_true", default=True)
    p.add_argument("--same_overlap_noisy", action="store_true")
    p.add_argument("--overlap_len", type=int, default=4)
    p.add_argument("--jump_n_sample", type=int, default=2)
    p.add_argument("--jump_length", type=int, default=3)
    args = lowprec_from_args(p.parse_args(argv))
    if args.dispatch_batches < 1:
        raise SystemExit("--dispatch-batches must be >= 1")
    if args.dist_backend == "nccl" and args.device == "cpu":
        raise SystemExit("--dist-backend nccl moves CUDA tensors: gloo on the CPU")
    return args


def repaint_cfg(args):
    """The ``RepaintConfig`` of the parsed RePaint knobs, as tools/test.py
    builds it."""
    from motioncraft_tpu_torch.diffusion.sampling import RepaintConfig

    return RepaintConfig(overlap_len=args.overlap_len, add_blend=args.addBlend,
                         same_overlap_noisy=args.same_overlap_noisy,
                         no_repaint=args.no_repaint, no_resample=args.no_resample,
                         jump_length=args.jump_length, jump_n_sample=args.jump_n_sample)


def refuse_retrieval(cfg, jax_tool: str = "tools/test.py") -> None:
    """Exit on a retrieval-augmented denoiser that would sample: its every
    call needs the ``re_dict`` of a retrieval bank, and this tool, like
    ``jax_tool`` (the JAX package's counterpart), builds none."""
    kind = cfg.model.get("model", {}).get("type")
    if kind in ("ReMoDiffuseTransformer", "MoMatMoGenTransformer") and \
            cfg.model.get("inference_type") != "gt":
        raise SystemExit(
            f"{kind} samples with a retrieval, which this tool does not build (nor does "
            f"{jax_tool}): make one with models.baselines.RetrievalDatabase and "
            "model.encode_retrieval, and pass it to MotionDiffusion.sample("
            "extra_model_kwargs={'re_dict': ...})")


def run(args, logger=print) -> dict:
    """Evaluate as ``args`` say; returns the metrics.json content (``out``)
    with the model, the dataset, the results and the wall seconds of
    sampling and of evaluation."""
    import torch
    import torch.distributed

    from motioncraft_tpu_torch.config import Config, cfg_options_from_args
    from motioncraft_tpu_torch.parallel.mesh import create_mesh, init_distributed, local_device

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run on the CPU")
    cfg = Config.fromfile(args.config)
    cfg.merge_from_dict(cfg_options_from_args(args.cfg_options))
    refuse_retrieval(cfg)
    ours = not torch.distributed.is_initialized()  # the group this run joins, it leaves
    rank = init_distributed(args.coordinator, args.num_processes, args.process_id,
                            backend=args.dist_backend or ("nccl" if args.device == "cuda"
                                                          else "gloo"))
    joined = torch.distributed.is_initialized()
    device = local_device(rank) if joined and args.device == "cuda" else args.device
    mesh = create_mesh(device=device)
    try:
        return _run(args, cfg, device, mesh if mesh is not None and mesh.world > 1 else None,
                    logger)
    finally:
        if joined and ours:
            torch.distributed.destroy_process_group()


def _run(args, cfg, device, mesh, logger) -> dict:
    import torch

    from motioncraft_tpu_torch.config import Config
    from motioncraft_tpu_torch.data import build_dataloader
    from motioncraft_tpu_torch.models.tokenizer import find_bpe_asset
    from motioncraft_tpu_torch.registry import build_architecture, build_dataset
    from motioncraft_tpu_torch.utils.checkpoint import load_eval_variables

    dist = mesh is not None
    os.makedirs(args.work_dir, exist_ok=True)
    # the protocol's replication shuffles, each sample's caption and crop,
    # and the Diversity evaluator draw from the global numpy generator, as in
    # tools/test.py: the same --seed gives the same draws in both tools
    np.random.seed(args.seed)
    torch.manual_seed(args.seed)

    arch = build_architecture(cfg.model, device=device)
    arch.repaint_cfg = repaint_cfg(args)
    test_cfg = Config.fromdict(cfg.data["test"])
    ev_cfg = test_cfg.get("eval_cfg", {}).get("evaluator_model")
    if isinstance(ev_cfg, dict):
        ev_cfg["device"] = device
    dataset = build_dataset(test_cfg)
    bs = args.batch_size or cfg.data["samples_per_gpu"]
    # several processes: each its interleaved slice, rounded up so that the
    # ranks sample as many batches; merged back in dataset order below
    loader = build_dataloader(dataset, samples_per_gpu=bs, shuffle=False, round_up=dist,
                              dist=dist, workers_per_gpu=cfg.data.get("workers_per_gpu", 0))
    loader.drop_last = False
    if arch.inference_type != "gt":
        # tools/test.py reads one batch to initialise its model; reading it
        # here too keeps the two tools' numpy draws (captions, crops) alike
        next(iter(loader))
        load_eval_variables(cfg.model, arch.model, checkpoint=args.checkpoint,
                            torch_checkpoint=args.torch_checkpoint)
    compute_dtype = apply_lowprec_(arch, args, logger)
    step_cache = step_cache_from_args(args, logger)

    from motioncraft_tpu_torch.apis.test import multi_host_test, single_device_test
    t0 = time.perf_counter()
    kw = dict(seed=args.seed, limit=args.limit, device=device,
              logger=lambda m: logger("  " + m), compute_dtype=compute_dtype,
              step_cache=step_cache, dispatch_batches=args.dispatch_batches)
    if dist:
        results = multi_host_test(arch, loader, mesh=mesh, **kw)
    else:
        results = single_device_test(arch, loader, **kw)
    sample_s = time.perf_counter() - t0
    logger(f"sampled {len(results)} results in {sample_s:.1f}s")
    if dist and mesh.rank != 0:
        return {"out": None, "arch": arch, "dataset": dataset, "results": results,
                "sample_s": sample_s, "eval_s": 0.0}
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
        "int8_weights": args.int8 or False,  # False | "w8a8" | "w8"
        "step_cache": int(args.step_cache),
        "step_cache_table": args.step_cache_table,
    }
    approx = ("int8_weights", "step_cache", "step_cache_table")
    out["protocol"] = not any(v for k, v in flags.items() if k not in approx)
    out["flags"] = flags
    if not out["protocol"]:
        logger(f"WARNING: run is NOT protocol-comparable: {flags}")
    elif any(flags[k] for k in approx):
        logger(f"NOTE: approximate sampling mode ({', '.join(f'{k}={flags[k]}' for k in approx)})"
               "; metric deltas against the exact run are expected: compare against an "
               "exact run before quoting numbers")
    with open(os.path.join(args.work_dir, "metrics.json"), "w") as f:
        json.dump(out, f, indent=2)
    return {"out": out, "arch": arch, "dataset": dataset, "results": results,
            "sample_s": sample_s, "eval_s": eval_s}


def main(argv=None):
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
