#!/usr/bin/env python3
"""Where chip_smoke.py's wall time goes on the host: run its main() with a
thread that samples the main thread's Python stack every ``--dt`` seconds
(and, in every rank that phases 21-23 spawn, the rank's own), then write
the seconds each function, each chip_smoke.py line and each innermost
stack was seen in.

    python3 tools/profile_chip_smoke.py --out outputs/chip_smoke_profile

``--out`` gets ``main.txt`` and one ``rank_<pid>.txt`` a spawned rank.  A
line's seconds are inclusive (its callees' too); the device's time shows
as the host line that waits for it.
"""

from __future__ import annotations

import argparse
import atexit
import collections
import os
import sys
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT_ENV = "PROFILE_CHIP_SMOKE_OUT"  # tells the spawned ranks where to write


def start_sampler(out_dir, name, dt):
    """Sample the calling thread's stack every ``dt`` s; write the counts
    to ``out_dir``/``name`` at exit."""
    target = threading.get_ident()
    funcs, lines, stacks = (collections.Counter() for _ in range(3))
    stop = threading.Event()
    t0 = time.perf_counter()

    def sample():
        while not stop.wait(dt):
            frame = sys._current_frames().get(target)
            seen, chain, inner = set(), [], None
            while frame is not None:
                code = frame.f_code
                where = os.path.basename(code.co_filename)
                fn = f"{where}:{code.co_name}:{code.co_firstlineno}"
                if fn not in seen:
                    seen.add(fn)
                    funcs[fn] += 1
                if where == "chip_smoke.py":
                    line = f"{where}:{code.co_name}:{frame.f_lineno}"
                    if line not in seen:
                        seen.add(line)
                        lines[line] += 1
                    inner = inner or line
                if len(chain) < 4:
                    chain.append(f"{where}:{code.co_name}:{frame.f_lineno}")
                frame = frame.f_back
            stacks[f"{inner} | {' <- '.join(chain)}"] += 1

    thread = threading.Thread(target=sample, daemon=True)
    thread.start()

    def write():
        stop.set()
        thread.join()
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, name), "w") as f:
            f.write(f"wall {time.perf_counter() - t0:.1f} s, a sample every {dt} s\n")
            for title, counts, n in (("functions", funcs, 300), ("chip_smoke.py lines", lines,
                                                                  500),
                                     ("innermost stacks", stacks, 200)):
                f.write(f"\n## {title} (s)\n")
                for key, v in counts.most_common(n):
                    f.write(f"{v * dt:8.1f} {key}\n")

    atexit.register(write)


if __name__ == "__mp_main__" and os.environ.get(OUT_ENV):  # a rank spawned by a phase
    out, _, dt = os.environ[OUT_ENV].rpartition("|")
    start_sampler(out, f"rank_{os.getpid()}.txt", float(dt))


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", default=os.path.join("outputs", "chip_smoke_profile"))
    p.add_argument("--dt", type=float, default=0.1, help="seconds between samples")
    args = p.parse_args()
    out = os.path.abspath(args.out)
    os.environ[OUT_ENV] = f"{out}|{args.dt}"
    sys.path.insert(0, ROOT)
    os.chdir(ROOT)
    start_sampler(out, "main.txt", args.dt)
    import chip_smoke

    return chip_smoke.main()


if __name__ == "__main__":
    sys.exit(main())
