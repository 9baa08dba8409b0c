"""Measure the end-to-end metric drift of the approximate sampling modes with
the PyTorch port (the counterpart of tools/measure_approx_drift.py, which
runs the JAX package's tools/test.py).

Runs the T2M protocol evaluation of tools/torch_test.py (its ``run``, in this
process) once per mode on the same checkpoint, seed and trained evaluator,
every mode in bf16 like the JAX tool's: ``exact``, ``step_cache_2``
(``--step-cache 2``), ``step_cache_table`` (``--step-cache-table``, with
``--table``), ``int8w`` (bf16 + W8) and ``int8`` (bf16 + W8A8).  Each mode
has its own work dir under ``--workroot`` with its metrics.json and
samples.npz (``--dump-samples``); a mode whose dir holds both, and whose
drift_mode.json records the inputs of this run (config, checkpoint and
table digests, seed, batch size, limit, replications), is reused, not
sampled again, so a cut-off run goes on where it stopped; a dir measured on
other inputs is sampled anew.  The model is freed between modes.  Reports each mode's metrics, its deltas against
exact and the sample-space relative error against exact (same seed, same
noise), in the JAX tool's JSON schema, plus the card's name and power
limit and the command.  Runs on the card unless ``--device cpu``.

Usage:
  python tools/torch_measure_approx_drift.py --config configs/tests/protocol_learn.py \\
      --checkpoint outputs/soak_torch/params.npz \\
      --table artifacts/step_cache_flagship_torch.json \\
      --out artifacts/approx_drift_torch.json --replications 6 [--modes int8w] [--limit N]
"""

import argparse
import gc
import hashlib
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np  # noqa: E402

from motioncraft_tpu_torch.utils.card import card_line  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
METRIC_KEYS = [
    "R_precision Top 1 (mean)", "R_precision Top 2 (mean)",
    "R_precision Top 3 (mean)", "Matching Score (mean)", "FID (mean)",
    "Diversity (mean)",
]
MODE_NAMES = ("exact", "step_cache_2", "step_cache_table", "int8w", "int8")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", default="configs/tests/protocol_learn.py")
    p.add_argument("--checkpoint", default="outputs/soak_torch/params.npz")
    p.add_argument("--table", default=None,
                   help="calibrated step-cache table (the table mode is skipped without)")
    p.add_argument("--out", default="artifacts/approx_drift_torch.json")
    p.add_argument("--workroot", default="outputs/drift_torch")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the modes run; cuda raises without a card")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--dispatch-batches", type=int, default=1,
                   help="K loader batches a wait for the card (the same predictions)")
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--replications", type=int, default=None,
                   help="eval_cfg.replication_times (default: the config's, 20 = protocol)")
    p.add_argument("--modes", nargs="*", default=None, choices=MODE_NAMES,
                   help="the modes to run besides exact, which always runs")
    p.add_argument("--git-rev", default=None,
                   help="the commit measured, where the tree is no git checkout")
    p.add_argument("--note", default=None)
    args = p.parse_args(argv)
    if args.dispatch_batches < 1:
        raise SystemExit("--dispatch-batches must be >= 1")
    return args


def modes_of(args):
    """(name, tools/torch_test.py flags) of each mode to run, exact first."""
    modes = [("exact", []), ("step_cache_2", ["--step-cache", "2"])]
    if args.table:
        modes.append(("step_cache_table", ["--step-cache-table", args.table]))
    modes += [("int8w", ["--int8-mode", "w8"]), ("int8", ["--int8-mode", "w8a8"])]
    if args.modes is not None:
        keep = set(args.modes) | {"exact"}
        modes = [m for m in modes if m[0] in keep]
    return modes


def test_argv(args, workdir, extra):
    """tools/torch_test.py's arguments for one mode."""
    argv = [args.config, workdir, "--device", args.device, "--checkpoint", args.checkpoint,
            "--seed", str(args.seed), "--bf16",
            "--dump-samples", os.path.join(workdir, "samples.npz")] + extra
    if args.batch_size:
        argv += ["--batch-size", str(args.batch_size)]
    if args.dispatch_batches > 1:
        argv += ["--dispatch-batches", str(args.dispatch_batches)]
    if args.limit:
        argv += ["--limit", str(args.limit)]
    if args.replications:
        argv += ["--cfg-options", f"data.test.eval_cfg.replication_times={args.replications}"]
    return argv


def file_digest(path):
    """sha256 of a file's bytes."""
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 24), b""):
            h.update(chunk)
    return h.hexdigest()


def mode_inputs(args, extra, digests):
    """What one mode's result depends on besides the code: the config, the
    checkpoint's and (table mode) the table's digests, and the options that
    tools/torch_test.py is given."""
    flags = [digests.get(a, a) for a in extra]
    return {"config": args.config, "checkpoint_sha256": digests[args.checkpoint],
            "seed": args.seed, "batch_size": args.batch_size, "limit": args.limit,
            "replications": args.replications, "flags": flags}


def run_mode(name, extra, args, workdir, inputs, logger=print):
    """One mode's metrics.json content and record ({"wall_s", "sample_s",
    "eval_s", "launches", "inputs", "reused"}): read back when its dir holds
    metrics.json, samples.npz and a drift_mode.json of the same ``inputs``,
    else sampled and evaluated through tools/torch_test.py."""
    import torch

    from motioncraft_tpu_torch.ops import launch_counts, reset_launch_counts

    metrics_path = os.path.join(workdir, "metrics.json")
    record_path = os.path.join(workdir, "drift_mode.json")
    if all(os.path.isfile(p) for p in (metrics_path, record_path,
                                        os.path.join(workdir, "samples.npz"))):
        with open(record_path) as f:
            record = json.load(f)
        if record.get("inputs") == inputs:
            logger(f"[{name}] already complete, reusing {workdir}")
            with open(metrics_path) as f:
                metrics = json.load(f)
            return metrics, dict(record, reused=True)
        logger(f"[{name}] {workdir} was measured on other inputs ({record.get('inputs')}); "
               "sampling it anew")
    torch_test = load_tool("torch_test")
    argv = test_argv(args, workdir, extra)
    logger(f"[{name}] tools/torch_test.py {' '.join(argv)}")
    reset_launch_counts()
    t0 = time.perf_counter()
    result = torch_test.run(torch_test.parse_args(argv), logger=logger)
    wall = time.perf_counter() - t0
    record = {"wall_s": wall, "sample_s": result["sample_s"], "eval_s": result["eval_s"],
              "clips": len(result["results"]), "launches": launch_counts(), "inputs": inputs}
    metrics = result["out"]
    del result  # the model, the dataset and the samples
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    with open(record_path, "w") as f:
        json.dump(record, f, indent=2)
    return metrics, dict(record, reused=False)


def load_tool(name):
    """tools/<name>.py as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "tools",
                                                                     name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def sample_err(exact_npz, mode_npz):
    """Per-clip relative L2 error over valid frames; mean / p95 / max
    (tools/measure_approx_drift.py's)."""
    a = np.load(exact_npz)
    b = np.load(mode_npz)
    xa, xb = a["pred_motion"], b["pred_motion"]
    n = min(len(xa), len(xb))
    errs = []
    for i in range(n):
        t = int(a["motion_length"][i])
        va, vb = xa[i, :t].ravel(), xb[i, :t].ravel()
        denom = float(np.linalg.norm(va)) or 1.0
        errs.append(float(np.linalg.norm(va - vb)) / denom)
    errs = np.asarray(errs)
    return {"mean": float(errs.mean()), "p95": float(np.percentile(errs, 95)),
            "max": float(errs.max()), "n_clips": int(n)}


def git_rev(args):
    if args.git_rev:
        return args.git_rev
    try:
        return subprocess.run(["git", "rev-parse", "--short", "HEAD"], cwd=REPO,
                              capture_output=True, text=True, check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        return None


def run(args, logger=print, command=None) -> dict:
    """Every mode as ``args`` say, then the report (``command``: the command
    line, for the record); returns {"out": the JSON written, "records": each
    mode's record}."""
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run on the CPU")
    results, records, dumps = {}, {}, {}
    digests = {p: file_digest(p) for p in (args.checkpoint, args.table) if p}
    for name, extra in modes_of(args):
        wd = os.path.join(args.workroot, name)
        os.makedirs(wd, exist_ok=True)
        metrics, record = run_mode(name, extra, args, wd, mode_inputs(args, extra, digests),
                                   logger)
        results[name] = {"metrics": {k: metrics[k] for k in METRIC_KEYS if k in metrics},
                         "flags": metrics.get("flags"), "wall_s": record["wall_s"]}
        records[name] = record
        dumps[name] = os.path.join(wd, "samples.npz")
    exact = results["exact"]["metrics"]
    for name in results:
        if name == "exact":
            continue
        m = results[name]["metrics"]
        results[name]["delta_vs_exact"] = {k: m[k] - exact[k] for k in m if k in exact}
        results[name]["sample_rel_err"] = sample_err(dumps["exact"], dumps[name])
    out = {
        "config": args.config, "checkpoint": args.checkpoint, "table": args.table,
        "seed": args.seed, "limit": args.limit, "replications_override": args.replications,
        "git_rev": git_rev(args),
        "card": card_line() if args.device == "cuda" else None,
        "device": args.device,
        "command": command,
        "note": args.note or (
            "deltas are mode - exact on the SAME trained checkpoint, same seed, same "
            "protocol eval, every mode with bf16 weights and bf16 denoiser compute; the "
            "evaluator is the small TRAINED contrastive model "
            "(tools/torch_train_protocol_evaluator.py), so ranking metrics are "
            "discriminative (chance top-1 = 1/32)"),
        "modes": results,
    }
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=2)
    logger(json.dumps(out, indent=2))
    logger(f"wrote {args.out}")
    return {"out": out, "records": records}


def main(argv=None):
    command = None if argv is not None else " ".join(["python"] + sys.argv)
    return run(parse_args(argv), command=command)


if __name__ == "__main__":
    main()
