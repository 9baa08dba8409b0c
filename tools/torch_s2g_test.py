"""Speech-to-gesture evaluation entry point of the PyTorch port (the
counterpart of tools/s2g_test.py, which runs the JAX package).

Per BEAT2 test recording: windowed long-form generation (64-frame windows
overlapping by 4; the first window plain DDIM, each later one
RePaint-harmonized DDIM outpainted from the previous window's tail), the
condition the recording's onset + amplitude at 16 kHz through the
ControlNet's WavEncoder and the caption of each window the TextGrid words
spoken in it; de-normalise, then the protocol's metrics:

  - L1div over the SMPL-X LBS joints (55 x 3, the recording's betas, zero
    translation)
  - BeatAlign: audio onsets against joint-velocity beats, 60-frame align
    mask, per-joint mean-velocity normalisation
  - facial L2 (MSE) and LVD over the SMPL-X face vertices (expression and
    jaw posed, body zeroed)
  - FID whole-body and hands over whole sequences in the SMPL-X contrastive
    evaluator's embedding space

-> metrics.json with tools/s2g_test.py's keys and honesty flags.  Without
the SMPL-X body model npz (not in the repository) the joints come from the
approximate FK skeleton and the facial metrics from the expression
coefficients, and metrics.json says ``"protocol": false``.  The model, the
skinning and the evaluator run on the card unless ``--device cpu``.

Usage:
  python tools/torch_s2g_test.py configs/stmogen/s2g_beats2_0125b.py \\
      --checkpoint params.npz --beats2-args configs/beat2/st_mogen_emage.yaml
  python tools/torch_s2g_test.py configs/tests/tiny_s2g.py --device cpu \\
      --beats2-args configs/tests/fixture_beat2.yaml       # the committed fixture

``--recording-batch R`` samples R recordings in lockstep
(windowed_sample_batch).  Not ported yet, and refused rather than ignored:
--bf16, --int8 / --int8-mode and --step-cache (ROADMAP queue 1: step cache
and bf16/int8 inference).  Every draw of the sampler comes from one
generator seeded with --seed.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np  # noqa: E402

LOW_PRECISION = "ROADMAP queue 1: step cache and bf16/int8 inference"
CAPTION = "A person is doing a speech, and the speech content is "


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Evaluate speech-to-gesture with the PyTorch port")
    p.add_argument("config")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the model, the body model and the evaluator run; cuda "
                        "raises without a card")
    p.add_argument("--checkpoint", default=None,
                   help=".npz snapshot (save_params of either package: params and "
                        "batch_stats)")
    p.add_argument("--torch-checkpoint", default=None,
                   help="released merged base+control .pth")
    p.add_argument("--beats2-args", default="configs/beat2/st_mogen_emage.yaml")
    p.add_argument("--work-dir", default="outputs/s2g_eval")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--limit", type=int, default=None, help="max recordings")
    p.add_argument("--no_repaint", action="store_true")
    p.add_argument("--same_overlap_noisy", action="store_true")
    p.add_argument("--save-npz", action="store_true")
    p.add_argument("--recording-batch", type=int, default=1,
                   help="sample this many recordings in lockstep, one batch per window "
                        "(1 = the reference's sequential protocol)")
    p.add_argument("--cfg-options", nargs="*", default=None)
    # tools/s2g_test.py's options that the port does not run yet
    p.add_argument("--step-cache", type=int, default=0, metavar="N")
    p.add_argument("--int8", nargs="?", const="w8a8", default=None, choices=["w8a8", "w8"])
    p.add_argument("--int8-mode", default=None, choices=["w8a8", "w8"])
    p.add_argument("--bf16", action="store_true")
    args = p.parse_args(argv)
    if args.bf16 or args.int8 or args.int8_mode:
        raise SystemExit("--bf16 / --int8: low-precision inference is not ported "
                         f"({LOW_PRECISION})")
    if args.step_cache not in (0, 1):  # 0 and 1 are off, as in tools/s2g_test.py
        raise SystemExit(f"--step-cache: the step cache is not ported ({LOW_PRECISION})")
    return args


def caption(spans, start, end, fps):
    """The window [start, end)'s caption: each word spoken in it, once, in
    order."""
    words = []
    for s, e, w in spans:
        if w and s < end / fps and e > start / fps and w not in words:
            words.append(w)
    return CAPTION + " ".join(words)


def make_window_batch_fn(rec, window, spf, fps):
    """One recording's window batches: ``(start, end)`` -> the batch of
    frames [start, end) with the audio features of its samples, zero-padded
    past the recording's end, and its caption."""
    from motioncraft_tpu_torch.models.tokenizer import tokenize

    audio, spans = rec["audio"], rec["word_spans"]

    def make_window_batch(start, end):
        seg = audio[start * spf:end * spf]
        if len(seg) < (end - start) * spf:
            seg = np.pad(seg, ((0, (end - start) * spf - len(seg)), (0, 0)))
        return {"motion": np.zeros((1, window, 322), np.float32),
                "motion_mask": np.ones((1, window), np.float32),
                "motion_length": np.full((1, 1), window, np.int32),
                "text_ids": tokenize([caption(spans, start, end, fps)]),
                "c": np.asarray(seg, np.float32)[None]}

    return make_window_batch


def hands_only(m322):
    """The hands-FID masking: keep the global orientation, both hands and
    the translation."""
    out = np.zeros_like(m322)
    out[:, 0:3] = m322[:, 0:3]
    out[:, 66:156] = m322[:, 66:156]
    out[:, 309:312] = m322[:, 309:312]
    return out


def pose165_of(m322):
    """SMPL-X 322 -> the smplxflame 165-d pose (eyes zero): body, jaw from
    156:159, hands from 66:156."""
    pose = np.zeros((len(m322), 165), np.float32)
    pose[:, :66] = m322[:, :66]
    pose[:, 66:69] = m322[:, 156:159]
    pose[:, 75:165] = m322[:, 66:156]
    return pose


def run(args, logger=print) -> dict:
    """Evaluate as ``args`` say; returns the metrics.json content (``out``)
    with the model, the recordings, the de-normalised predictions, the
    window batches sampled, the wall seconds of sampling and of the metric
    stage and the body model (None on the FK route)."""
    import torch

    from motioncraft_tpu_torch.apis.windowed import (denormalize, num_windows,
                                                     windowed_sample, windowed_sample_batch)
    from motioncraft_tpu_torch.config import Config, cfg_options_from_args
    from motioncraft_tpu_torch.data.beat2 import load_beat2_args, load_recordings
    from motioncraft_tpu_torch.data.datasets import beat2_pose_to_smplx322
    from motioncraft_tpu_torch.diffusion import RepaintConfig, generator_randn
    from motioncraft_tpu_torch.eval import build_evaluator_model
    from motioncraft_tpu_torch.eval.gesture_metrics import (BeatAlign, L1div, facial_lvd,
                                                            facial_mse)
    from motioncraft_tpu_torch.eval.metrics import (calculate_activation_statistics,
                                                    calculate_frechet_distance)
    from motioncraft_tpu_torch.models.tokenizer import find_bpe_asset
    from motioncraft_tpu_torch.ops.fk import SMPLXSkeleton
    from motioncraft_tpu_torch.ops.smplx_lbs import SMPLXModel, find_model_path, pose165_parts
    from motioncraft_tpu_torch.registry import build_architecture
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
    window, pre = win_cfg.get("window", 64), win_cfg.get("pre_frames", 4)
    fps, sr = win_cfg.get("pose_fps", 30), win_cfg.get("audio_sr", 16000)
    spf = sr // fps
    arch = build_architecture(cfg.model, device=args.device)
    arch.repaint_cfg = RepaintConfig(overlap_len=pre, same_overlap_noisy=args.same_overlap_noisy,
                                     no_repaint=args.no_repaint)

    bargs = load_beat2_args(args.beats2_args)
    recordings = load_recordings(bargs, "test")[:args.limit]
    if not recordings:
        logger(f"no BEAT2 test recordings found under {bargs.data_path}")
        return {"out": None}
    mean = (np.load(bargs.mean_pose_path) if bargs.mean_pose_path
            and os.path.isfile(bargs.mean_pose_path) else np.zeros(322, np.float32))
    std = (np.load(bargs.std_pose_path) if bargs.std_pose_path
           and os.path.isfile(bargs.std_pose_path) else np.ones(322, np.float32))
    load_eval_variables(cfg.model, arch.model, checkpoint=args.checkpoint,
                        torch_checkpoint=args.torch_checkpoint)

    # generation: the reference's sequential protocol (R = 1) or lockstep
    # batches of R recordings
    kw = dict(window=window, pre_frames=pre, use_repaint=not args.no_repaint,
              repaint=arch.repaint_cfg, randn=randn)
    R = max(1, args.recording_batch)
    lengths = [len(r["pose"]) for r in recordings]
    t0 = time.perf_counter()
    norm_preds, windows = [], 0
    for g0 in range(0, len(recordings), R):
        group = recordings[g0:g0 + R]
        mwbs = [make_window_batch_fn(r, window, spf, fps) for r in group]
        if R > 1:
            norm_preds += windowed_sample_batch(arch, mwbs, lengths[g0:g0 + R], **kw)
            windows += max(num_windows(n, window, pre) for n in lengths[g0:g0 + R])
        else:
            norm_preds.append(windowed_sample(arch, mwbs[0], total_frames=lengths[g0], **kw))
            windows += num_windows(lengths[g0], window, pre)
        logger(f"[{min(g0 + R, len(recordings))}/{len(recordings)}] "
               f"{', '.join(r['name'] for r in group)} ({time.perf_counter() - t0:.1f}s)")
    sample_s = time.perf_counter() - t0

    t1 = time.perf_counter()
    # the SMPL-X body model (the protocol's) or the approximate FK, flagged
    smplx_path = find_model_path(getattr(bargs, "smplx_model_path", None))
    body_model = SMPLXModel.from_npz(smplx_path, device=args.device) if smplx_path else None
    if body_model is None:
        logger("WARNING: SMPL-X model npz not found: joints from the approximate FK "
               "skeleton, facial metrics on expression coefficients. Numbers are NOT "
               "protocol-comparable.")
        fk = SMPLXSkeleton(device=args.device)
    # the per-joint mean-velocity normaliser (a scalar 1.0 without it is not
    # the protocol's)
    mmae_path = os.path.join(bargs.data_path, "weights",
                             f"mean_vel_{getattr(bargs, 'pose_rep', 'smplxflame_30')}.npy")
    mmae = np.load(mmae_path) if os.path.isfile(mmae_path) else 1.0
    align_mask = int(getattr(bargs, "align_mask", 60))
    l1div = L1div()
    beat = BeatAlign(sigma=0.3, order=7, mmae=mmae, align_mask=align_mask)
    align_sum, l2_sum, lvd_sum, total_length = 0.0, 0.0, 0.0, 0
    ev_cfg = dict(cfg.get("eval_model") or dict(
        type="T2MContrastiveModel_SMPLX",
        motion_encoder=dict(nfeats=322, vae=True, num_layers=4),
        text_encoder=dict(num_layers=4)))
    ev_cfg["device"] = args.device
    fid_model = build_evaluator_model(ev_cfg)
    embs = {k: [] for k in ("pred", "gt", "pred_hands", "gt_hands")}
    preds = []
    with torch.no_grad():
        for ri, (rec, norm_pred) in enumerate(zip(recordings, norm_preds)):
            pred322 = denormalize(norm_pred, mean, std)
            # the windows cover num_windows (window - pre) + pre frames: cut
            # the ground truth to match
            T = len(pred322)
            gt322 = beat2_pose_to_smplx322(rec["pose"], rec["facial"], rec["trans"])[:T]
            preds.append(pred322)
            for key, seq in (("pred", pred322), ("gt", gt322),
                             ("pred_hands", hands_only(pred322)), ("gt_hands", hands_only(gt322))):
                embs[key].append(fid_model.encode_motion(seq[None], np.asarray([T]))
                                 .cpu().numpy())
            pose165 = pose165_of(pred322)
            if body_model is not None:
                # protocol joints: LBS with the recording's betas, zero
                # translation and expression; face vertices: expression and
                # jaw posed, body zero
                nb = body_model.num_betas
                betas = np.broadcast_to(rec.get("betas", np.zeros(nb, np.float32))[:nb]
                                        .reshape(1, -1), (T, nb))
                joints = body_model.forward_chunked(return_verts=False, betas=betas,
                                                    **pose165_parts(pose165))["joints"]
                facial_rec, facial_tar = (
                    body_model.forward_chunked(betas=betas, expression=m[:, 209:309],
                                               jaw_pose=m[:, 156:159])["vertices"].reshape(T, -1)
                    for m in (pred322, gt322))
            else:
                joints = fk(pose165, np.zeros((T, 3), np.float32)).cpu().numpy()
                facial_rec, facial_tar = pred322[:, 209:309], gt322[:, 209:309]
            joints_rec = np.asarray(joints).reshape(T, -1)[:, :55 * 3]
            l1div.run(joints_rec.copy())
            score = beat.score(rec["wav"][:T * spf], joints_rec.reshape(T, 55, 3), sr=sr,
                               pose_fps=fps, full_wav_len=len(rec["wav"]))
            align_sum += score * (T - 2 * align_mask)
            l2_sum += facial_mse(facial_rec, facial_tar) * T
            lvd_sum += facial_lvd(facial_rec, facial_tar) * T
            total_length += T
            if args.save_npz:
                np.savez(os.path.join(args.work_dir, f"{rec['name']}.npz"),
                         pred=pred322, gt=gt322)
            logger(f"[{ri + 1}/{len(recordings)}] {rec['name']}: T={T} align={score:.4f}")

    def fid(pred_list, gt_list):
        mu_p, cov_p = calculate_activation_statistics(np.concatenate(pred_list))
        mu_g, cov_g = calculate_activation_statistics(np.concatenate(gt_list))
        return float(calculate_frechet_distance(mu_g, cov_g, mu_p, cov_p))

    n_seq = len(recordings)
    # weighted sums as the reference accumulates them
    metrics = {
        "L1div": l1div.avg(),
        "BeatAlign": align_sum / max(total_length - 2 * n_seq * align_mask, 1),
        "facial_L2": l2_sum / max(total_length, 1),
        "facial_LVD": lvd_sum / max(total_length, 1),
    }
    if n_seq > 1:
        metrics["FID_whole"] = fid(embs["pred"], embs["gt"])
        metrics["FID_hands"] = fid(embs["pred_hands"], embs["gt_hands"])
    eval_s = time.perf_counter() - t1
    flags = {
        "smplx_vertices": body_model is not None,
        "mmae_asset": not np.isscalar(mmae),
        "untrained_evaluator": not getattr(fid_model, "pretrained_loaded", False),
        "hash_tokenizer": find_bpe_asset() is None,
        "int8_weights": False,
        "step_cache": 0,
    }
    metrics["protocol"] = (flags["smplx_vertices"] and flags["mmae_asset"]
                           and not flags["untrained_evaluator"] and not flags["hash_tokenizer"])
    metrics["flags"] = flags
    if not metrics["protocol"]:
        logger(f"WARNING: run is NOT protocol-comparable: {flags}")
    logger(json.dumps(metrics, indent=2))
    with open(os.path.join(args.work_dir, "metrics.json"), "w") as f:
        json.dump(metrics, f, indent=2)
    return {"out": metrics, "arch": arch, "recordings": recordings, "preds": preds,
            "windows": windows, "sample_s": sample_s, "eval_s": eval_s,
            "body_model": body_model}


def main(argv=None):
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
