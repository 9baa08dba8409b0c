"""Run the port's trained-weights quality harness end to end on one card and
write its three artifacts.

Every step is a process of its own that runs in ``--out-dir`` (which must
be empty or new), so the config's relative paths (./data_protocol_learn,
./outputs/protocol_evaluator.npz) and every output land there:

1. the learnable 32-class tree (tools/make_tiny_data.py --protocol-learnable)
   -> data_protocol_learn/;
2. the training soak: tools/torch_train.py CONFIG --grad-accum 2 for
   ``--epochs`` epochs -> soak_torch/, killed (SIGKILL) while it writes
   its checkpoint after epoch ``--kill-epoch`` (a later epoch's if that
   write was missed), then --resume to the end; tools/torch_soak_report.py
   -> train_soak_torch.json;
3. the evaluator: tools/torch_train_protocol_evaluator.py at its defaults
   -> outputs/protocol_evaluator.npz, which the config's evaluator loads;
4. the step-cache table: tools/torch_calibrate_step_cache.py on the soak's
   params.npz, bf16, 2 batches of 32, threshold 0.15 and 3 consecutive
   reuses at most (those of artifacts/step_cache_flagship.json)
   -> step_cache_flagship_torch.json;
5. the drift: tools/torch_measure_approx_drift.py with that table and
   ``--replications``, one mode more each call (exact first, W8A8 last;
   each call reuses the modes done) -> drift_torch/ and
   approx_drift_torch.json after each.

The artifacts carry the card's name and power limit, ``--git-rev`` and
their commands (paths relative to the out dir).  ``run.json`` there holds
each step's command and wall seconds, and the kill.

Usage:
  python tools/torch_quality_run.py --out-dir outputs/quality --git-rev REV
"""

import argparse
import glob
import json
import os
import signal
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from motioncraft_tpu_torch.config import Config  # noqa: E402
from motioncraft_tpu_torch.utils.card import card_line  # noqa: E402

CONFIG = os.path.join(REPO, "configs", "tests", "protocol_learn.py")
TREE = "data_protocol_learn"
SOAK = "soak_torch"
TABLE = "step_cache_flagship_torch.json"
DRIFT_MODES = ("step_cache_2", "step_cache_table", "int8w", "int8")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--out-dir", default="outputs/quality",
                   help="where every step runs and writes; must be empty or new")
    p.add_argument("--git-rev", default=None, help="the commit run, for the record")
    p.add_argument("--epochs", type=int, default=50)
    p.add_argument("--kill-epoch", type=int, default=13)
    p.add_argument("--replications", type=int, default=6)
    p.add_argument("--max-keep-ckpts", type=int, default=2)
    p.add_argument("--config", default=CONFIG,
                   help="the harness config (a rehearsal on the CPU takes a narrow one)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where every step runs; cuda raises without a card")
    return p.parse_args(argv)


def tool(out, name, *args):
    """The command of tools/<name>.py, run from ``out``."""
    return [sys.executable, os.path.relpath(os.path.join(REPO, "tools", name + ".py"), out),
            *args]


def run_step(cmd, out, log_path):
    """Run ``cmd`` in ``out`` to its end with its output in ``log_path``;
    raise on failure.  Returns the wall seconds."""
    t0 = time.perf_counter()
    with open(log_path, "w") as log:
        rc = subprocess.run(cmd, cwd=out, stdout=log, stderr=subprocess.STDOUT).returncode
    if rc:
        raise SystemExit(f"{' '.join(cmd)} exited {rc}; see {log_path}")
    return time.perf_counter() - t0


def train_killed_mid_write(cmd, out, log_path, kill_epoch, last_epoch):
    """Start the training ``cmd`` in ``out``; once an epoch >= ``kill_epoch``
    is done, SIGKILL it while its checkpoint's temporary file is being
    written.  Returns the kill's record."""
    ckpt = os.path.join(out, SOAK, "ckpt")
    train_log = os.path.join(out, SOAK, "train.log")
    t0 = time.perf_counter()
    with open(log_path, "w") as log:
        proc = subprocess.Popen(cmd, cwd=out, stdout=log, stderr=subprocess.STDOUT)
        try:
            while proc.poll() is None:
                partial = [p for p in glob.glob(os.path.join(ckpt, ".epoch_*.tmp"))
                           if int(os.path.basename(p).split(".")[1].split("_")[1])
                           >= kill_epoch]
                sizes = [os.path.getsize(p) for p in partial if os.path.exists(p)]
                if sizes and max(sizes) > 0:
                    proc.send_signal(signal.SIGKILL)
                    proc.wait()
                    left = sorted(os.listdir(ckpt))  # the partial file included
                    with open(train_log) as f:
                        done = [ln for ln in f if " done in " in ln]
                    return {"killed_while_writing": os.path.basename(partial[0]),
                            "bytes_written_at_kill": max(sizes),
                            "last_epoch_done": done[-1].split(" - INFO - ")[1].strip(),
                            "files_left": left,
                            "seconds": time.perf_counter() - t0}
                time.sleep(0.002)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    raise SystemExit(f"training ended (rc {proc.returncode}) before a checkpoint write of "
                     f"an epoch in {kill_epoch}..{last_epoch} could be killed")


def main(argv=None):
    args = parse_args(argv)
    out = os.path.abspath(args.out_dir)
    if os.path.isdir(out) and os.listdir(out):
        raise SystemExit(f"{args.out_dir} is not empty: give a new or empty --out-dir")
    os.makedirs(out, exist_ok=True)
    card = card_line()
    config = os.path.relpath(os.path.abspath(args.config), out)
    batch = Config.fromfile(args.config).data["samples_per_gpu"]
    record = {"card": card, "git_rev": args.git_rev, "steps": {}}

    def save_record():
        with open(os.path.join(out, "run.json"), "w") as f:
            json.dump(record, f, indent=2)

    def step(name, cmd):
        print(f"[quality] {name}: {' '.join(cmd)}", flush=True)
        record["steps"][name] = {"command": " ".join(cmd), "seconds": run_step(
            cmd, out, os.path.join(out, name + ".log"))}
        save_record()
        print(f"[quality] {name}: {record['steps'][name]['seconds']:.1f} s", flush=True)

    device = ["--device", args.device]
    step("data", tool(out, "make_tiny_data", "--root", TREE, "--protocol-learnable"))
    train = tool(out, "torch_train", config, "--work-dir", SOAK, "--grad-accum", "2",
                 "--max-epochs", str(args.epochs), *device, "--cfg-options",
                 f"checkpoint_config.max_keep_ckpts={args.max_keep_ckpts}")
    print(f"[quality] soak: {' '.join(train)}", flush=True)
    kill = train_killed_mid_write(train, out, os.path.join(out, "soak_first.log"),
                                  args.kill_epoch, args.epochs - 1)
    record["kill"] = kill
    save_record()
    print(f"[quality] killed: {json.dumps(kill)}", flush=True)
    step("soak_resume", train + ["--resume"])
    params = os.path.join(SOAK, "params.npz")
    if not os.path.exists(os.path.join(out, params)):
        raise SystemExit("the soak wrote no params.npz")
    note = (f"killed (SIGKILL) while writing {kill['killed_while_writing']} "
            f"({kill['bytes_written_at_kill']} bytes written) after '{kill['last_epoch_done']}'"
            f"; files left in ckpt/: {kill['files_left']}; then --resume to epoch "
            f"{args.epochs}; card {card}")
    step("soak_report", tool(out, "torch_soak_report", "--work-dir", SOAK, "--out",
                             "train_soak_torch.json", "--config", config, "--batch",
                             str(batch), "--grad-accum", "2", "--note", note,
                             "--command", " ".join(["python"] + train[1:]),
                             "--git-rev", str(args.git_rev)))
    step("evaluator", tool(out, "torch_train_protocol_evaluator", *device))
    calib_note = (f"calibrated on the port's training soak ({SOAK}: {args.epochs} epochs of "
                  f"{config}, --grad-accum 2) on {card}, commit {args.git_rev}; not a "
                  "released or real-data model")
    step("calibrate", tool(out, "torch_calibrate_step_cache", config, "step_cache_torch.npz",
                           "--checkpoint", params, "--bf16", "--batches", "2",
                           "--batch-size", "32", "--threshold", "0.15", "--max-consecutive",
                           "3", "--json", TABLE, "--note", calib_note, *device))
    for i in range(len(DRIFT_MODES)):
        step(f"drift_{DRIFT_MODES[i]}", tool(
            out, "torch_measure_approx_drift", "--config", config, "--checkpoint", params,
            "--table", TABLE, "--replications", str(args.replications),
            "--out", "approx_drift_torch.json", "--workroot", "drift_torch",
            "--git-rev", str(args.git_rev), *device, "--modes", *DRIFT_MODES[:i + 1]))
    print(f"[quality] done: {json.dumps(record['steps'])}", flush=True)


if __name__ == "__main__":
    main()
