"""Music-to-dance evaluation entry point of the PyTorch port (the counterpart
of tools/m2d_test.py, which runs the JAX package).

Per FineDance test track: windowed generation (120-frame windows, 30-frame
overlap; the first window plain DDIM, each later one RePaint-harmonized DDIM
outpainted from the previous window's tail), de-normalise, then FID
whole-body and hands and Diversity in the SMPL-X contrastive evaluator's
embedding space over 150-frame chunks -> metrics.json, with the same keys and
honesty flags as tools/m2d_test.py.  Runs on the card unless ``--device cpu``.

Usage:
  python tools/torch_m2d_test.py configs/stmogen/m2d_finedance_0125b.py \\
      --checkpoint params.npz                  # a save_params snapshot of either package
  python tools/torch_m2d_test.py CONFIG --torch-checkpoint released.pth
  python tools/torch_m2d_test.py configs/tests/tiny_m2d.py --device cpu   # after make_tiny_data.py

``--recording-batch R`` samples R tracks in lockstep (windowed_sample_batch).
``--bf16`` casts the weights to bf16 and runs the denoiser in bf16 (the
metric math stays f32), as tools/m2d_test.py does.  ``--int8 [w8a8|w8]``
(or ``--int8-mode``) quantizes the denoiser's audited weights after the cast
(ops/quant.py); ``--step-cache N`` (N >= 2) reuses each layer's residual on
all but every N-th DDIM step of every window (diffusion/stepcache.py; in an
outpainted window the first step after each re-noising jump computes):
approximate modes, stamped into metrics.json.  Diversity's picks draw from
the global numpy generator, which this tool seeds with --seed.
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
    p = argparse.ArgumentParser(description="Evaluate music-to-dance with the PyTorch port")
    p.add_argument("config")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the model and the evaluator run; cuda raises without a card")
    p.add_argument("--checkpoint", default=None,
                   help=".npz params snapshot (save_params of either package)")
    p.add_argument("--torch-checkpoint", default=None,
                   help="released merged base+control .pth")
    p.add_argument("--work-dir", default="outputs/m2d_eval")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--no_repaint", action="store_true")
    p.add_argument("--recording-batch", type=int, default=1,
                   help="sample this many tracks in lockstep, one batch per window "
                        "(1 = the reference's sequential protocol)")
    p.add_argument("--cfg-options", nargs="*", default=None)
    p.add_argument("--bf16", action="store_true",
                   help="bf16 denoiser compute in the windowed sampler (weights cast, "
                        "compute_dtype bf16; the metric math stays f32)")
    add_lowprec_args(p)
    return lowprec_from_args(p.parse_args(argv))


def make_window_batch_fn(music, text, window):
    """One track's window batches: ``(start, end)`` -> the batch of frames
    [start, end) with the aligned music slice, zero-padded past its end."""
    from motioncraft_tpu_torch.models.tokenizer import tokenize

    text_ids = tokenize([text])

    def make_window_batch(start, end):
        seg = music[start:end]
        if len(seg) < end - start:
            seg = np.pad(seg, ((0, end - start - len(seg)), (0, 0)))
        return {"motion": np.zeros((1, window, 322), np.float32),
                "motion_mask": np.ones((1, window), np.float32),
                "motion_length": np.full((1, 1), window, np.int32),
                "text_ids": text_ids,
                "c": seg.astype(np.float32)[None]}

    return make_window_batch


def hands_only(s):
    """The hands-FID masking: keep the global orientation, both hands and
    the translation; zero the body, jaw and face."""
    m = np.zeros_like(s)
    m[:, 0:3] = s[:, 0:3]
    m[:, 66:156] = s[:, 66:156]
    m[:, 309:312] = s[:, 309:312]
    return m


def chunk_embed(ev, seqs, size, mask_fn=None):
    """The evaluator's motion embeddings of every whole ``size``-frame chunk
    of every sequence, in order."""
    chunks = []
    for s in seqs:
        s = mask_fn(s) if mask_fn is not None else s
        for i in range(0, len(s) - size + 1, size):
            chunks.append(s[i:i + size])
    arr = np.stack(chunks)
    return ev.encode_motion(arr, np.full(len(arr), size)).cpu().numpy()


def metric_stage(ev, preds, gts):
    """FID whole-body and hands over chunks of min(150, shortest) frames,
    and Diversity (at most 300 pairs) of the last embeddings computed, the
    hands-masked predictions', as tools/m2d_test.py computes them."""
    from motioncraft_tpu_torch.eval.metrics import (calculate_activation_statistics,
                                                    calculate_diversity,
                                                    calculate_frechet_distance)

    size = min(150, min(len(p) for p in preds))
    metrics = {}
    for name, mask_fn in (("whole", None), ("hands", hands_only)):
        pe = chunk_embed(ev, preds, size, mask_fn)
        ge = chunk_embed(ev, gts, size, mask_fn)
        mu_p, cov_p = calculate_activation_statistics(pe)
        mu_g, cov_g = calculate_activation_statistics(ge)
        metrics[f"FID_{name}"] = float(calculate_frechet_distance(mu_g, cov_g, mu_p, cov_p))
    n_div = min(len(pe) - 1, 300)
    if n_div > 1:
        metrics["Diversity"] = float(calculate_diversity(pe, n_div))
    return metrics


def run(args, logger=print) -> dict:
    """Evaluate as ``args`` say; returns the metrics.json content (``out``)
    with the model, the dataset's tracks, the de-normalised predictions, the
    window batches sampled and the wall seconds of sampling and of
    evaluation."""
    import torch

    from motioncraft_tpu_torch.apis.windowed import (denormalize, num_windows,
                                                     windowed_sample, windowed_sample_batch)
    from motioncraft_tpu_torch.config import Config, cfg_options_from_args
    from motioncraft_tpu_torch.diffusion import RepaintConfig, generator_randn
    from motioncraft_tpu_torch.eval import build_evaluator_model
    from motioncraft_tpu_torch.models.tokenizer import find_bpe_asset
    from motioncraft_tpu_torch.registry import build_architecture, build_dataset
    from motioncraft_tpu_torch.utils.checkpoint import load_eval_variables

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run on the CPU")
    cfg = Config.fromfile(args.config)
    cfg.merge_from_dict(cfg_options_from_args(args.cfg_options))
    os.makedirs(args.work_dir, exist_ok=True)
    np.random.seed(args.seed)
    randn = generator_randn(torch.Generator(device=args.device).manual_seed(args.seed),
                            args.device)

    win_cfg = cfg.get("windowed", {})
    window, pre = win_cfg.get("window", 120), win_cfg.get("pre_frames", 30)
    arch = build_architecture(cfg.model, device=args.device)
    arch.repaint_cfg = RepaintConfig(overlap_len=pre, no_repaint=args.no_repaint)

    test_cfg = dict(cfg.data["test"])
    test_cfg.pop("eval_cfg", None)
    test_cfg["test_mode"] = False
    dataset = build_dataset(test_cfg)
    norm = dataset.pipeline.transforms[0]  # Normalize
    mean, std = np.asarray(norm.mean), np.asarray(norm.std)
    infos = dataset.data_infos[:args.limit]
    if not infos:
        logger("no FineDance test tracks found")
        return {"out": None}
    load_eval_variables(cfg.model, arch.model, checkpoint=args.checkpoint,
                        torch_checkpoint=args.torch_checkpoint)

    def make_mwb(info):
        return make_window_batch_fn(info["c"], info["text"][0], window)

    compute_dtype = apply_lowprec_(arch, args, logger)
    kw = dict(window=window, pre_frames=pre, use_repaint=not args.no_repaint,
              repaint=arch.repaint_cfg, randn=randn, compute_dtype=compute_dtype,
              step_cache=step_cache_from_args(args, logger))
    R = max(1, args.recording_batch)
    lengths = [len(info["motion"]) for info in infos]
    t0 = time.perf_counter()
    norm_preds, windows = [], 0
    for g0 in range(0, len(infos), R):
        group = infos[g0:g0 + R]
        if R > 1:
            norm_preds += windowed_sample_batch(arch, [make_mwb(i) for i in group],
                                                lengths[g0:g0 + R], **kw)
            windows += max(num_windows(n, window, pre) for n in lengths[g0:g0 + R])
        else:
            norm_preds.append(windowed_sample(arch, make_mwb(group[0]),
                                              total_frames=lengths[g0], **kw))
            windows += num_windows(lengths[g0], window, pre)
        logger(f"[{min(g0 + R, len(infos))}/{len(infos)}] "
               f"{', '.join(str(i.get('name')) for i in group)} "
               f"({time.perf_counter() - t0:.1f}s)")
    sample_s = time.perf_counter() - t0
    preds = [denormalize(p, mean, std) for p in norm_preds]
    gts = [info["motion"][:len(p)] for info, p in zip(infos, preds)]

    t1 = time.perf_counter()
    ev_cfg = dict(cfg.data.get("eval_model") or dict(
        type="T2MContrastiveModel_SMPLX",
        motion_encoder=dict(nfeats=322, vae=True, num_layers=4),
        text_encoder=dict(num_layers=4)))
    ev_cfg["device"] = args.device
    ev = build_evaluator_model(ev_cfg)
    metrics = metric_stage(ev, preds, gts)
    eval_s = time.perf_counter() - t1
    flags = {"untrained_evaluator": not getattr(ev, "pretrained_loaded", False),
             "hash_tokenizer": find_bpe_asset() is None,
             "int8_weights": args.int8 or False,  # False | "w8a8" | "w8"
             "step_cache": int(args.step_cache)}
    metrics["protocol"] = not any(v for k, v in flags.items()
                                  if k not in ("int8_weights", "step_cache"))
    metrics["flags"] = flags
    if not metrics["protocol"]:
        logger(f"WARNING: run is NOT protocol-comparable: {flags}")
    if flags["int8_weights"] or flags["step_cache"]:
        logger("NOTE: approximate sampling mode (int8/step-cache); compare against an "
               "exact run before quoting metric numbers")
    logger(json.dumps(metrics, indent=2))
    with open(os.path.join(args.work_dir, "metrics.json"), "w") as f:
        json.dump(metrics, f, indent=2)
    return {"out": metrics, "arch": arch, "infos": infos, "preds": preds,
            "windows": windows, "sample_s": sample_s, "eval_s": eval_s}


def main(argv=None):
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
