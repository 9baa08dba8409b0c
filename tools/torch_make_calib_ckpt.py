"""Train a short synthetic-data checkpoint for step-cache calibration with the
PyTorch port (the counterpart of tools/make_calib_ckpt.py, which trains the
JAX package).

SmoothCache's calibration (tools/torch_calibrate_step_cache.py) needs the
residual dynamics of a trained denoiser: an untrained one has exactly-zero
layer residuals (zero-initialised output heads) or, perturbed, noise-like
ones.  This overfits the config's model on the JAX tool's bank of smooth
synthetic motions (one sinusoid mixture a prompt, at the config's T x 322)
with train_model and Adam, then saves a ``save_params`` snapshot in the JAX
package's layout for ``--checkpoint``.  Not a released-quality model.  Runs
on the card unless ``--device cpu``.

Usage:
  python tools/torch_make_calib_ckpt.py configs/tests/flagship_calib.py out.npz \\
      [--steps 400] [--batch-size 8] [--lr 2e-4] [--seed 0]
"""

import argparse
import math
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

PROMPTS = [
    "a person walks forward slowly",
    "a person waves both hands in the air",
    "a person jumps up and down in place",
    "a person sits down on the ground",
    "a person runs in a circle",
    "a person stretches both arms overhead",
    "a person crouches and stands back up",
    "a person turns around and walks away",
]


def make_dataset(T: int, D: int, n: int, seed: int):
    """Smooth per-prompt motions: sinusoid banks the denoiser can memorise
    (tools/make_calib_ckpt.py's, draw for draw)."""
    rng = np.random.RandomState(seed)
    t = np.linspace(0.0, 1.0, T, dtype=np.float32)
    K = len(PROMPTS)
    freqs = rng.uniform(0.5, 3.0, size=(K, D)).astype(np.float32)
    phase = rng.uniform(0, 2 * np.pi, size=(K, D)).astype(np.float32)
    amp = rng.uniform(0.3, 1.0, size=(K, D)).astype(np.float32)
    patterns = amp[:, None, :] * np.sin(
        2 * np.pi * freqs[:, None, :] * t[None, :, None] + phase[:, None, :])

    class DS:
        def __len__(self):
            return n

        def __getitem__(self, i):
            k = i % K
            return {"motion": patterns[k],
                    "motion_mask": np.ones((T,), np.float32),
                    "motion_length": T,
                    "motion_metas": {"text": PROMPTS[k]}}

    return DS()


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("config")
    p.add_argument("out", help="output .npz param snapshot")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the model trains; cuda raises without a card")
    p.add_argument("--steps", type=int, default=400)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--seed", type=int, default=0)
    return p.parse_args(argv)


def run(args, logger=print) -> dict:
    """Train and save as ``args`` say; returns {"losses", "steps", "arch"}."""
    import torch

    from motioncraft_tpu_torch.apis import train_model
    from motioncraft_tpu_torch.config import Config
    from motioncraft_tpu_torch.data.loader import DataLoader
    from motioncraft_tpu_torch.registry import build_architecture
    from motioncraft_tpu_torch.utils.checkpoint import save_params

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run on the CPU")
    cfg = Config.fromfile(args.config)
    torch.manual_seed(args.seed)  # the model's initial weights
    arch = build_architecture(cfg.model, device=args.device)
    T = cfg.model["model"].get("max_seq_len", 196)
    D = cfg.model["model"].get("input_feats", 322)
    ds = make_dataset(T, D, n=args.batch_size * 8, seed=args.seed)
    loader = DataLoader(ds, batch_size=args.batch_size, shuffle=True, num_workers=0,
                        seed=args.seed)
    steps_per_epoch = len(ds) // args.batch_size
    epochs = max(1, math.ceil(args.steps / steps_per_epoch))
    losses = []

    def log(msg):
        logger(msg)
        for tok in msg.split():
            if tok.startswith("loss="):
                losses.append(float(tok.split("=")[1]))

    train_model(arch, loader, optimizer_cfg={"type": "Adam", "lr": args.lr},
                max_epochs=epochs, seed=args.seed, log_interval=steps_per_epoch,
                logger=log)
    if losses and not losses[-1] < losses[0]:
        logger(f"WARNING: loss did not decrease ({losses[0]} -> {losses[-1]})")
    save_params(args.out, arch.model)
    steps = epochs * steps_per_epoch
    print(f"{steps} steps, loss {losses[0] if losses else float('nan'):.4f} -> "
          f"{losses[-1] if losses else float('nan'):.4f}; saved -> {args.out}")
    return {"losses": losses, "steps": steps, "arch": arch}


def main(argv=None):
    return run(parse_args(argv), logger=lambda m: print(m, file=sys.stderr))


if __name__ == "__main__":
    main()
