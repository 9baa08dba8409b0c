"""Speech-to-gesture inference and SMPL-X npz / video export with the
PyTorch port (the counterpart of tools/s2g_visualize.py, which runs the JAX
package).

For each BEAT2 test recording: windowed long-form generation on the card
(the RePaint machinery of tools/torch_s2g_test.py: 64-frame windows
overlapping by 4, the first plain DDIM, each later one outpainted from the
previous window's tail; each window's caption the words spoken in it),
de-normalised, then a smoothed result and an unsmoothed ground-truth
SMPL-X npz with the recording's betas, and optionally a video (a mesh where
pyrender and the SMPL-X assets exist, the FK stick figure otherwise, with
the recording's wav) and a standalone HTML player.  Runs on the card unless
``--device cpu``.

Usage:
  python tools/torch_s2g_visualize.py configs/stmogen/s2g_beats2_0125b.py \\
      --checkpoint outputs/s2g/params.npz --out outputs/s2g_vis --limit 1
  python tools/torch_s2g_visualize.py configs/tests/tiny_s2g.py --device cpu \\
      --beats2-args configs/tests/fixture_beat2.yaml     # the committed fixture

``--checkpoint`` is a ``save_params`` snapshot of either package; without
one the weights are the port's own initialisation, seeded with --seed.
Every draw of the sampler comes from one generator on the device seeded
with --seed.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np  # noqa: E402


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Speech-to-gesture samples with the PyTorch port")
    p.add_argument("config")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the model and the FK run; cuda raises without a card")
    p.add_argument("--checkpoint", default=None,
                   help=".npz snapshot (save_params of either package: params and "
                        "batch_stats)")
    p.add_argument("--beats2-args", default="configs/beat2/st_mogen_emage.yaml")
    p.add_argument("--out", default="outputs/s2g_vis")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--limit", type=int, default=None, help="max recordings")
    p.add_argument("--no_repaint", action="store_true")
    p.add_argument("--same_overlap_noisy", action="store_true")
    p.add_argument("--no-smooth", action="store_true",
                   help="skip the export-time temporal gaussian filters")
    p.add_argument("--render", action="store_true",
                   help="also render a video per clip (mesh if assets exist, "
                        "FK stick-figure otherwise)")
    p.add_argument("--web", action="store_true",
                   help="standalone HTML skeleton player per clip "
                        "(motioncraft_tpu_torch/utils/web_player.py)")
    p.add_argument("--cfg-options", nargs="*", default=None)
    return p.parse_args(argv)


def run(args, randn=None, logger=print) -> dict:
    """Sample and export each recording as ``args`` say; every draw of the
    sampler from ``randn`` (diffusion/sampling.py) if given.  Returns the
    model (``arch``), the recordings, each one's de-normalised prediction
    (``preds``) and ground truth (``gts``), the files written (``paths``)
    and the sampling's wall seconds (``sample_s``)."""
    import torch

    from motioncraft_tpu_torch.apis.windowed import denormalize, windowed_sample
    from motioncraft_tpu_torch.config import Config, cfg_options_from_args
    from motioncraft_tpu_torch.data.beat2 import load_beat2_args, load_recordings
    from motioncraft_tpu_torch.data.datasets import beat2_pose_to_smplx322
    from motioncraft_tpu_torch.diffusion import RepaintConfig, generator_randn
    from motioncraft_tpu_torch.registry import build_architecture
    from motioncraft_tpu_torch.utils.checkpoint import load_eval_variables
    from motioncraft_tpu_torch.utils.export import gt_export_npz, s2g_export_npz
    from tools.torch_s2g_test import make_window_batch_fn

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run on the CPU")
    cfg = Config.fromfile(args.config)
    cfg.merge_from_dict(cfg_options_from_args(args.cfg_options))
    os.makedirs(args.out, exist_ok=True)

    win_cfg = cfg.get("windowed", {})
    window = win_cfg.get("window", 64)
    pre = win_cfg.get("pre_frames", 4)
    fps = win_cfg.get("pose_fps", 30)
    sr = win_cfg.get("audio_sr", 16000)
    spf = sr // fps

    torch.manual_seed(args.seed)
    arch = build_architecture(cfg.model, device=args.device)
    arch.repaint_cfg = RepaintConfig(overlap_len=pre,
                                     same_overlap_noisy=args.same_overlap_noisy,
                                     no_repaint=args.no_repaint)

    bargs = load_beat2_args(args.beats2_args)
    recordings = load_recordings(bargs, "test")[: args.limit]
    if not recordings:
        logger(f"no BEAT2 test recordings found under {bargs.data_path}")
        return {"arch": arch, "recordings": [], "preds": [], "gts": [], "paths": [],
                "sample_s": 0.0}
    mean = np.load(bargs.mean_pose_path) if bargs.mean_pose_path and os.path.isfile(
        bargs.mean_pose_path) else np.zeros(322, np.float32)
    std = np.load(bargs.std_pose_path) if bargs.std_pose_path and os.path.isfile(
        bargs.std_pose_path) else np.ones(322, np.float32)
    load_eval_variables(cfg.model, arch.model, checkpoint=args.checkpoint)
    randn = randn or generator_randn(
        torch.Generator(device=args.device).manual_seed(args.seed), args.device)

    preds, gts, paths, sample_s = [], [], [], 0.0
    t0 = time.time()
    for ri, rec in enumerate(recordings):
        T = len(rec["pose"])
        gt322 = beat2_pose_to_smplx322(rec["pose"], rec["facial"], rec["trans"])
        t1 = time.perf_counter()
        norm_pred = windowed_sample(arch, make_window_batch_fn(rec, window, spf, fps),
                                    total_frames=T, window=window, pre_frames=pre,
                                    randn=randn, use_repaint=not args.no_repaint,
                                    repaint=arch.repaint_cfg)
        sample_s += time.perf_counter() - t1
        pred322 = denormalize(norm_pred, mean, std)
        gt322 = gt322[: len(pred322)]
        preds.append(pred322)
        gts.append(gt322)

        betas = rec.get("betas")
        res_path = os.path.join(args.out, f"res_{rec['name']}.npz")
        gt_path = os.path.join(args.out, f"gt_{rec['name']}.npz")
        s2g_export_npz(pred322, res_path, betas=betas, fps=fps,
                       smooth=not args.no_smooth)
        gt_export_npz(gt322, gt_path, betas=betas, fps=fps)
        paths += [res_path, gt_path]
        logger(f"[{ri + 1}/{len(recordings)}] {rec['name']}: T={len(pred322)} "
               f"-> {res_path} ({time.time() - t0:.1f}s)")
        if args.render:
            from motioncraft_tpu_torch.utils.render import render_one_sequence
            paths.append(render_one_sequence(
                res_path, os.path.join(args.out, f"res_{rec['name']}.mp4"),
                audio_path=rec.get("wav_path"), fps=fps, device=args.device))
        if args.web:
            from motioncraft_tpu_torch.ops.fk import SMPLX_PARENTS
            from motioncraft_tpu_torch.utils.export import fk_joints_322
            from motioncraft_tpu_torch.utils.web_player import export_web_player
            paths.append(export_web_player(
                fk_joints_322(pred322, args.device), SMPLX_PARENTS,
                os.path.join(args.out, f"res_{rec['name']}.html"), fps=fps,
                title=rec["name"]))
    return {"arch": arch, "recordings": recordings, "preds": preds, "gts": gts,
            "paths": paths, "sample_s": sample_s}


def main(argv=None, **kw):
    return run(parse_args(argv), **kw)


if __name__ == "__main__":
    main()
