#!/usr/bin/env python3
"""Profile one flagship text-to-motion sampling batch of the PyTorch port on
the card: device time by kernel, the port's own kernels summed, and the
device's idle share over the batch.

    python3 tools/profile_torch_sample.py [--batch 16] [--trace out.json]

The weights are seeded and fabricated (no checkpoint is needed).  One batch
warms up, the next is traced with torch.profiler.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

OWN = {"grouped_ffn_kernel": "K1 grouped_ffn", "head_ffn_kernel": "K2 head_ffn",
       "stma_attention_kernel": "K3 stma_linear_attention",
       "count_kernel": "K4 moe_positions", "rank_kernel": "K4 moe_positions"}


def busy_us(intervals):
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--trace", default=None, help="write a Chrome trace here")
    args = ap.parse_args()

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from motioncraft_tpu_torch.apis import make_text_batch
    from motioncraft_tpu_torch.config import Config
    from motioncraft_tpu_torch.registry import build_architecture
    from motioncraft_tpu_torch.utils.convert import fabricate_state_dict

    if not torch.cuda.is_available():
        sys.exit("profile_torch_sample: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())
    cfg = Config.fromfile(os.path.join(ROOT, "configs/stmogen/t2m_motionx_0_125b.py"))
    arch = build_architecture(cfg["model"], device="cuda")
    arch.model.load_state_dict(fabricate_state_dict(arch.model, seed=0), strict=True)
    rng = np.random.RandomState(0)
    texts = [f"a person walks and turns {i}" for i in range(args.batch)]
    batch = make_text_batch(texts, lengths=rng.randint(40, 197, (args.batch, 1)))
    g = torch.Generator(device="cuda").manual_seed(0)

    arch.sample(batch, generator=g)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        arch.sample(batch, generator=g)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    if args.trace:
        prof.export_chrome_trace(args.trace)

    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = busy_us([(e.time_range.start, e.time_range.end) for e in kernels])
    by_name = {}
    for e in kernels:
        by_name.setdefault(e.name, [0.0, 0])
        by_name[e.name][0] += e.time_range.end - e.time_range.start
        by_name[e.name][1] += 1
    own = {}
    for name, (us, n) in by_name.items():
        for key, label in OWN.items():
            if key in name:
                own.setdefault(label, [0.0, 0])
                own[label][0] += us
                own[label][1] += n
    steps = arch.diffusion_test.num_timesteps
    print(f"batch {args.batch}, {steps} steps: wall {wall_us / 1e3:.1f} ms, device busy "
          f"{busy / 1e3:.1f} ms, idle share {1 - busy / wall_us:.3f}, "
          f"{len(kernels)} kernel launches")
    total = sum(us for us, _ in by_name.values())
    print(f"{'device ms':>10} {'share':>6} {'calls':>6}  kernel")
    for name, (us, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:25]:
        print(f"{us / 1e3:10.2f} {us / total:6.3f} {n:6d}  {name[:110]}")
    print("the port's own kernels:")
    for label, (us, n) in sorted(own.items()):
        print(f"{us / 1e3:10.2f} {us / total:6.3f} {n:6d}  {label}")


if __name__ == "__main__":
    main()
