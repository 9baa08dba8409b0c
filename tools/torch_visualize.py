"""Text-to-motion inference and export with the PyTorch port (the
counterpart of tools/visualize.py, which runs the JAX package).

Builds the model, samples the prompts in one DDIM call on the card,
de-normalises with the test pipeline's Normalize stats where they exist and
writes one SMPL-X .npz a prompt (the 322-d layout remapped to poses [T, 165],
expressions, trans, betas; optional temporal gaussian smoothing), or the raw
features (``motion``) for a model of another width, such as MCM's 263-d.
``--plot`` adds a matplotlib FK stick-figure video and ``--web`` a
standalone HTML player a prompt.  Runs on the card unless ``--device cpu``.

Usage:
  python tools/torch_visualize.py configs/stmogen/t2m_motionx_0_125b.py \\
      --checkpoint params.npz --text "a person walks in a circle" \\
      --motion_length 120 --out outputs/vis
  python tools/torch_visualize.py configs/tests/tiny_t2m.py --device cpu \\
      --text "a person waves" --motion_length 12   # after make_tiny_data.py

``--checkpoint`` is a ``save_params`` snapshot of either package.  Without
one the weights are the port's own initialisation, seeded with --seed (not
the JAX package's ``arch.init`` at that seed).  The sampler's draws come
from a generator on the device seeded with --seed + 1.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np  # noqa: E402


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Text-to-motion samples with the PyTorch port")
    p.add_argument("config")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the model and the FK run; cuda raises without a card")
    p.add_argument("--checkpoint", default=None,
                   help=".npz params snapshot (save_params of either package)")
    p.add_argument("--text", nargs="+", required=True)
    p.add_argument("--motion_length", type=int, nargs="+", default=None)
    p.add_argument("--out", default="outputs/vis")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--fps", type=int, default=30)
    p.add_argument("--smooth", type=float, default=0.0,
                   help="temporal gaussian smoothing sigma (frames)")
    p.add_argument("--plot", action="store_true", help="matplotlib FK skeleton video")
    p.add_argument("--web", action="store_true",
                   help="standalone HTML skeleton player per sample "
                        "(motioncraft_tpu_torch/utils/web_player.py, no server or JS deps)")
    p.add_argument("--cfg-options", nargs="*", default=None)
    return p.parse_args(argv)


def smplx322_to_npz(motion: np.ndarray, path: str, fps: int = 30,
                    smooth_sigma: float = 0.0):
    """322-d vector -> SMPL-X npz (poses [T, 165], expressions, trans,
    betas)."""
    if smooth_sigma > 0:
        from scipy.ndimage import gaussian_filter1d
        motion = gaussian_filter1d(motion, smooth_sigma, axis=0)
    T = motion.shape[0]
    poses = np.zeros((T, 165), np.float32)
    poses[:, :66] = motion[:, :66]
    poses[:, 66:69] = motion[:, 156:159]
    poses[:, 75:165] = motion[:, 66:156]
    np.savez(path,
             poses=poses,
             expressions=motion[:, 209:309],
             trans=motion[:, 309:312],
             betas=np.zeros(300, np.float32),
             mocap_frame_rate=np.asarray(fps),
             gender="neutral", model="smplx2020")


def run(args, randn=None, logger=print) -> dict:
    """Sample and export as ``args`` say; every draw of the sampler from
    ``randn`` (diffusion/sampling.py) if given.  Returns the model
    (``arch``), the de-normalised batch (``pred`` [B, T, D]), the lengths,
    the files written (``paths``) and the sampling call's wall seconds
    (``sample_s``)."""
    import time

    import torch

    from motioncraft_tpu_torch.apis.factory import make_text_batch
    from motioncraft_tpu_torch.config import Config, cfg_options_from_args
    from motioncraft_tpu_torch.diffusion import generator_randn
    from motioncraft_tpu_torch.registry import build_architecture
    from motioncraft_tpu_torch.utils.checkpoint import load_eval_variables

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run on the CPU")
    cfg = Config.fromfile(args.config)
    cfg.merge_from_dict(cfg_options_from_args(args.cfg_options))
    os.makedirs(args.out, exist_ok=True)

    max_seq_len = cfg.model["model"].get("max_seq_len", 196)
    input_feats = cfg.model["model"].get("input_feats", 322)
    lengths = args.motion_length or [max_seq_len] * len(args.text)
    lengths = np.asarray(lengths, np.int32).reshape(-1, 1)

    torch.manual_seed(args.seed)
    arch = build_architecture(cfg.model, device=args.device)
    batch = make_text_batch(args.text, max_seq_len=max_seq_len,
                            input_feats=input_feats, lengths=lengths)
    load_eval_variables(cfg.model, arch.model, checkpoint=args.checkpoint)
    randn = randn or generator_randn(
        torch.Generator(device=args.device).manual_seed(args.seed + 1), args.device)

    t0 = time.perf_counter()
    pred = arch.sample(batch, randn=randn).cpu().numpy()
    sample_s = time.perf_counter() - t0

    # de-normalise with the dataset stats where they exist
    norm_cfg = None
    for step in (cfg.get("data", {}).get("test", {}) or {}).get("pipeline", []):
        if step.get("type") == "Normalize":
            norm_cfg = step
    if norm_cfg and os.path.isfile(norm_cfg["mean_path"]):
        mean, std = np.load(norm_cfg["mean_path"]), np.load(norm_cfg["std_path"])
        pred = pred * (std + 1e-9) + mean

    paths = []
    for i, text in enumerate(args.text):
        T = int(lengths[i, 0])
        clip = pred[i, :T]
        path = os.path.join(args.out, f"sample_{i}.npz")
        if input_feats == 322:
            smplx322_to_npz(clip, path, args.fps, args.smooth)
        else:
            np.savez(path, motion=clip)
        paths.append(path)
        logger(f"[{i}] {text!r} -> {path} ({T} frames)")
        if args.plot and input_feats == 322:
            plot_skeleton(clip, os.path.join(args.out, f"sample_{i}.mp4"), args.fps,
                          args.device, logger)
        if args.web and input_feats == 322:
            from motioncraft_tpu_torch.ops.fk import SMPLX_PARENTS
            from motioncraft_tpu_torch.utils.export import fk_joints_322
            from motioncraft_tpu_torch.utils.web_player import export_web_player
            html = export_web_player(fk_joints_322(clip, args.device), SMPLX_PARENTS,
                                     os.path.join(args.out, f"sample_{i}.html"),
                                     fps=args.fps, title=text)
            paths.append(html)
            logger(f"  web player -> {html}")
    return {"arch": arch, "pred": pred, "lengths": lengths[:, 0], "paths": paths,
            "sample_s": sample_s}


def plot_skeleton(motion322: np.ndarray, path: str, fps: int, device="cuda", logger=print):
    """A matplotlib 3D stick-figure video of the FK joints: ``path`` by
    ffmpeg, else a gif beside it, else a note that no video was written."""
    from motioncraft_tpu_torch.ops.fk import SMPLX_PARENTS
    from motioncraft_tpu_torch.utils.export import fk_joints_322
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib import animation

    T = motion322.shape[0]
    joints = fk_joints_322(motion322, device)

    fig = plt.figure(figsize=(5, 5))
    ax = fig.add_subplot(projection="3d")

    def draw(t):
        ax.cla()
        ax.set_xlim(-1, 1); ax.set_ylim(-1, 1); ax.set_zlim(-1, 1)
        j = joints[t]
        for i, p in enumerate(SMPLX_PARENTS):
            if p < 0:
                continue
            ax.plot([j[i, 0], j[p, 0]], [j[i, 2], j[p, 2]], [j[i, 1], j[p, 1]],
                    "b-", lw=1)
        ax.set_title(f"frame {t}")

    anim = animation.FuncAnimation(fig, draw, frames=T, interval=1000 / fps)
    try:
        anim.save(path, fps=fps)
        logger(f"  skeleton video -> {path}")
    except Exception as e:  # no ffmpeg
        alt = path.replace(".mp4", ".gif")
        try:
            anim.save(alt, writer="pillow", fps=fps)
            logger(f"  skeleton video -> {alt}")
        except Exception:
            logger(f"  video export unavailable ({e}); npz saved")
    plt.close(fig)


def main(argv=None, **kw):
    return run(parse_args(argv), **kw)


if __name__ == "__main__":
    main()
