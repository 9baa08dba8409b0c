"""Music-to-dance inference and SMPL-X npz / video export with the PyTorch
port (the counterpart of tools/m2d_visualize.py, which runs the JAX
package).

Given FineDance track ids: the style caption from the label json ("A dancer
is performing a {style1} dance in the {style2} style to the rhythm of the
{name} song.", a generic one without it), the 163-d music features (the
first 360 frames trimmed, then the ``--slice-idx``-th window of
``--motion_length`` frames, zero-padded past the end), one DDIM sample of
that window on the card, de-normalised, exported as an SMPL-X npz with
6d-rotation-space gaussian smoothing.  Runs on the card unless
``--device cpu``.

Usage:
  python tools/torch_m2d_visualize.py configs/stmogen/m2d_finedance_0125b.py \\
      --checkpoint outputs/m2d/params.npz --track 063 --motion_length 120
  python tools/torch_m2d_visualize.py configs/tests/tiny_m2d.py --device cpu \\
      --track 063 --motion_length 16            # after make_tiny_data.py

``--checkpoint`` is a ``save_params`` snapshot of either package; without
one the weights are the port's own initialisation, seeded with --seed.  The
sampler's draws come from one generator on the device seeded with --seed.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np  # noqa: E402


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Music-to-dance samples with the PyTorch port")
    p.add_argument("config")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the model and the FK run; cuda raises without a card")
    p.add_argument("--checkpoint", default=None,
                   help=".npz params snapshot (save_params of either package)")
    p.add_argument("--track", nargs="+", required=True,
                   help="FineDance track ids (label/music npy basenames)")
    p.add_argument("--motion_length", type=int, default=120,
                   help="frames per generated window (120..196)")
    p.add_argument("--slice-idx", type=int, default=0,
                   help="which motion_length-sized music window to condition on")
    p.add_argument("--out", default="outputs/m2d_vis")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--fps", type=int, default=30)
    p.add_argument("--no-smooth", action="store_true")
    p.add_argument("--render", action="store_true",
                   help="also render a video (mesh if assets exist, FK "
                        "stick-figure otherwise)")
    p.add_argument("--web", action="store_true",
                   help="standalone HTML skeleton player per clip "
                        "(motioncraft_tpu_torch/utils/web_player.py)")
    p.add_argument("--cfg-options", nargs="*", default=None)
    return p.parse_args(argv)


def run(args, randn=None, logger=print) -> dict:
    """Sample and export each track as ``args`` say; every draw of the
    sampler from ``randn`` (diffusion/sampling.py) if given.  Returns the
    model (``arch``), each track's de-normalised window (``preds``), the
    files written (``paths``) and the sampling calls' wall seconds
    (``sample_s``)."""
    import time

    import torch

    from motioncraft_tpu_torch.config import Config, cfg_options_from_args
    from motioncraft_tpu_torch.diffusion import generator_randn
    from motioncraft_tpu_torch.registry import build_architecture
    from motioncraft_tpu_torch.utils.checkpoint import load_eval_variables
    from motioncraft_tpu_torch.utils.export import m2d_export_npz
    from tools.torch_m2d_test import make_window_batch_fn

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run on the CPU")
    cfg = Config.fromfile(args.config)
    cfg.merge_from_dict(cfg_options_from_args(args.cfg_options))
    os.makedirs(args.out, exist_ok=True)

    test_cfg = cfg.data["test"]
    data_prefix = test_cfg.get("data_prefix", "./data")
    dname = test_cfg.get("dataset_name", "finedance")
    droot = os.path.join(data_prefix, "datasets", dname)
    L = args.motion_length
    if not 120 <= L <= 196:
        logger(f"warning: motion_length={L} outside the FineDance range "
               "[120, 196] (reference m2d_visualize.py:180)")

    # de-normalisation stats
    mean_path = os.path.join(droot, "mean.npy")
    mean = np.load(mean_path) if os.path.isfile(mean_path) else np.zeros(322, np.float32)
    std_path = os.path.join(droot, "std.npy")
    std = np.load(std_path) if os.path.isfile(std_path) else np.ones(322, np.float32)

    torch.manual_seed(args.seed)
    arch = build_architecture(cfg.model, device=args.device)
    load_eval_variables(cfg.model, arch.model, checkpoint=args.checkpoint)
    randn = randn or generator_randn(
        torch.Generator(device=args.device).manual_seed(args.seed), args.device)

    preds, paths, sample_s = [], [], 0.0
    for track in args.track:
        label_path = os.path.join(droot, "label_json", track + ".json")
        if os.path.isfile(label_path):
            with open(label_path) as f:
                label = json.load(f)
            text = (f"A dancer is performing a {label['style1']} dance in the "
                    f"{label['style2']} style to the rhythm of the "
                    f"{label['name']} song.")
        else:
            text = f"A dancer is performing to the rhythm of song {track}."
            logger(f"  (no label json at {label_path}; using generic caption)")

        music_path = os.path.join(droot, "music_npy", track + ".npy")
        if os.path.isfile(music_path):
            music = np.load(music_path).astype(np.float32)[360:]
            music = music[args.slice_idx * L:(args.slice_idx + 1) * L]
        else:
            logger(f"  (no music features at {music_path}; conditioning on zeros)")
            music = np.zeros((L, cfg.get("control_cond_feats", 163)), np.float32)
        # the window's batch, the music zero-padded to L frames
        batch = make_window_batch_fn(music, text, L)(0, L)

        t0 = time.perf_counter()
        pred = arch.sample(batch, randn=randn).cpu().numpy()[0]
        sample_s += time.perf_counter() - t0
        pred = pred * (std + 1e-9) + mean
        preds.append(pred)

        out_path = os.path.join(args.out, f"res_{track}_{L}_{args.slice_idx}.npz")
        m2d_export_npz(pred, out_path, fps=args.fps, smooth=not args.no_smooth)
        paths.append(out_path)
        logger(f"{track!r} ({text[:60]}...) -> {out_path} ({L} frames)")
        if args.render:
            from motioncraft_tpu_torch.utils.render import render_one_sequence
            paths.append(render_one_sequence(out_path, out_path.replace(".npz", ".mp4"),
                                             fps=args.fps, device=args.device))
        if args.web:
            from motioncraft_tpu_torch.ops.fk import SMPLX_PARENTS
            from motioncraft_tpu_torch.utils.export import fk_joints_322
            from motioncraft_tpu_torch.utils.web_player import export_web_player
            paths.append(export_web_player(fk_joints_322(pred, args.device), SMPLX_PARENTS,
                                           out_path.replace(".npz", ".html"),
                                           fps=args.fps, title=track))
    return {"arch": arch, "preds": preds, "paths": paths, "sample_s": sample_s}


def main(argv=None, **kw):
    return run(parse_args(argv), **kw)


if __name__ == "__main__":
    main()
