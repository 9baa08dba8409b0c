"""Summarize a training soak of the PyTorch port into a committed artifact
(the counterpart of tools/soak_report.py, which reads the JAX package's
train.log).

Parses the work dir's train.log that tools/torch_train.py writes (it grows
across --resume restarts) into artifacts/train_soak_torch.json: the loss
curve, the resume events, the checkpoints saved, per-epoch seconds, samples
per second and the largest device memory a run allocated.

Both packages' ``--grad-accum N`` split each loader batch into N
microbatches for one optimizer step, so the optimizer steps of an epoch are
the loader's steps and the recipe's global batch is the loader batch.
tools/soak_report.py divides the steps by N and multiplies the batch by it;
this report does neither.

Usage:
  python tools/torch_soak_report.py --work-dir outputs/soak_torch \\
      --out artifacts/train_soak_torch.json --note "killed at epoch 13 mid-write"
"""

import argparse
import json
import os
import re
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from motioncraft_tpu_torch.utils.card import card_line  # noqa: E402


def parse_log(text: str, batch: int) -> dict:
    """The soak's numbers from a train.log; ``batch`` is the loader batch."""
    losses = [
        {"epoch": int(e), "step": int(s), "loss": float(v), "moe_route_loss": float(m),
         "recon_loss": float(r)}
        for e, s, v, m, r in re.findall(
            r"epoch (\d+) step (\d+): loss=([\d.]+) moe_route_loss=([\d.]+) "
            r"recon_loss=([\d.]+)", text)]
    epochs = [{"epoch": int(e), "seconds": float(s)}
              for e, s in re.findall(r"epoch (\d+) done in ([\d.]+)s", text)]
    resumes = [int(r) for r in re.findall(r"resumed from \S+ at epoch (\d+)", text)]
    saves = re.findall(r"saved checkpoint at epoch (\d+)", text)
    memory = [float(x) for x in re.findall(r"max memory allocated ([\d.]+) GiB", text)]
    m = re.search(r"dataset: (\d+) samples, (\d+) steps/epoch", text)
    steps_per_epoch = int(m.group(2)) if m else None
    # epoch 0 of each process builds the kernels and warms the allocator
    steady = sorted(e["seconds"] for e in epochs if e["epoch"] > 0)
    median = steady[len(steady) // 2] if steady else None
    out = {
        "optimizer_steps": max((x["step"] for x in losses), default=0),
        "epochs_completed": max((e["epoch"] for e in epochs), default=-1) + 1,
        "resume_events": resumes,
        "checkpoints_saved": len(saves),
        "loss_first": losses[0]["loss"] if losses else None,
        "loss_last": losses[-1]["loss"] if losses else None,
        "loss_curve": losses,
        "epoch_seconds": epochs,
        "steady_epoch_seconds_median": median,
        "steps_per_epoch": steps_per_epoch,
        "first_epoch_seconds": next((e["seconds"] for e in epochs if e["epoch"] == 0), None),
        "max_memory_allocated_gib": max(memory) if memory else None,
    }
    if median and steps_per_epoch:
        out["steady_samples_per_s"] = batch * steps_per_epoch / median
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--work-dir", default="outputs/soak_torch")
    p.add_argument("--out", default="artifacts/train_soak_torch.json")
    p.add_argument("--config", default="configs/tests/protocol_learn.py")
    p.add_argument("--note", default=None)
    p.add_argument("--batch", type=int, default=32, help="the loader batch")
    p.add_argument("--grad-accum", type=int, default=2)
    p.add_argument("--command", default=None, help="the training command, for the record")
    p.add_argument("--git-rev", default=None, help="the commit trained, for the record")
    args = p.parse_args(argv)

    with open(os.path.join(args.work_dir, "train.log")) as f:
        parsed = parse_log(f.read(), args.batch)
    out = {
        "config": args.config,
        "work_dir": args.work_dir,
        "model": "0.125B STMoGen flagship topology (t2m_motionx_0_125b base)",
        "recipe": f"Adam 2e-4 step-decay@10 (reference recipe), global batch {args.batch} "
                  f"(the loader batch), split into {args.grad_accum} microbatches of "
                  f"{args.batch // args.grad_accum} (--grad-accum {args.grad_accum})",
        "data": "learnable 32-class protocol tree "
                "(make_tiny_data --protocol-learnable, 1024 x 196 x 322)",
        "card": card_line(),
        "git_rev": args.git_rev,
        "command": args.command,
        **parsed,
        "note": args.note,
    }
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=2)
    print(json.dumps({k: v for k, v in out.items()
                      if k not in ("loss_curve", "epoch_seconds")}, indent=2))
    print(f"wrote {args.out} ({len(out['loss_curve'])} loss points)", file=sys.stderr)
    return out


if __name__ == "__main__":
    main()
