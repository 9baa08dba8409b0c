#!/usr/bin/env python3
"""Profile one text-to-motion sampling batch of the PyTorch port on the card
(the flagship, or another T2M config's model): device time by kernel, the
port's own kernels summed, and the device's idle share over the batch.

    python3 tools/profile_torch_sample.py [--batch 16] [--bf16] [--trace out.json]
    python3 tools/profile_torch_sample.py --config configs/finemogen/finemogen_t2m_smplx.py

The weights are seeded and fabricated (no checkpoint is needed); ``--bf16``
casts them to bf16 and samples with the denoiser in bf16.  One batch warms
up, the next runs untraced (its wall time), the one after is traced with
torch.profiler.
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
       "route_kernel<16>": "K4 moe_route", "route_kernel<64>": "K4 moe_route",
       "route_kernel<0>": "K4 moe_positions",
       "grouped_ffn_bf16_kernel": "K1 grouped_ffn bf16", "head_ffn_bf16_kernel": "K2 head_ffn bf16"}


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
    ap.add_argument("--bf16", action="store_true",
                    help="bf16 weights and denoiser compute (apis.bf16_cast_)")
    ap.add_argument("--trace", default=None, help="write a Chrome trace here")
    ap.add_argument("--config", default="configs/stmogen/t2m_motionx_0_125b.py",
                    help="the config whose model samples (relative to the repository)")
    args = ap.parse_args()

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from motioncraft_tpu_torch.apis import bf16_cast_, make_text_batch
    from motioncraft_tpu_torch.config import Config
    from motioncraft_tpu_torch.registry import build_architecture
    from motioncraft_tpu_torch.utils.convert import fabricate_state_dict

    if not torch.cuda.is_available():
        sys.exit("profile_torch_sample: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())
    cfg = Config.fromfile(os.path.join(ROOT, args.config))
    arch = build_architecture(cfg["model"], device="cuda")
    arch.model.load_state_dict(fabricate_state_dict(arch.model, seed=0), strict=True)
    dtype = None
    if args.bf16:
        bf16_cast_(arch)
        dtype = torch.bfloat16
    rng = np.random.RandomState(0)
    texts = [f"a person walks and turns {i}" for i in range(args.batch)]
    m = cfg["model"]["model"]
    batch = make_text_batch(texts, max_seq_len=m["max_seq_len"], input_feats=m["input_feats"],
                            lengths=rng.randint(40, m["max_seq_len"] + 1, (args.batch, 1)))
    g = torch.Generator(device="cuda").manual_seed(0)

    arch.sample(batch, generator=g, compute_dtype=dtype)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    arch.sample(batch, generator=g, compute_dtype=dtype)
    torch.cuda.synchronize()
    untraced_us = (time.perf_counter() - t0) * 1e6
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        arch.sample(batch, generator=g, compute_dtype=dtype)
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
    print(f"batch {args.batch} ({'bf16' if args.bf16 else 'f32'}), {steps} steps: wall "
          f"{wall_us / 1e3:.1f} ms traced, {untraced_us / 1e3:.1f} ms untraced; device busy "
          f"{busy / 1e3:.1f} ms, idle share {1 - busy / wall_us:.3f} traced, "
          f"{1 - busy / untraced_us:.3f} untraced; {len(kernels)} kernel launches")
    total = sum(us for us, _ in by_name.values())
    print(f"{'device ms':>10} {'share':>6} {'calls':>6}  kernel")
    for name, (us, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:25]:
        print(f"{us / 1e3:10.2f} {us / total:6.3f} {n:6d}  {name[:110]}")
    sorts = [v for name, v in by_name.items() if "sort" in name.lower()]
    print(f"sort kernels: {sum(us for us, _ in sorts) / 1e3:.2f} ms over "
          f"{sum(n for _, n in sorts)} calls")
    print("the port's own kernels:")
    for label, (us, n) in sorted(own.items()):
        print(f"{us / 1e3:10.2f} {us / total:6.3f} {n:6d}  {label}")


if __name__ == "__main__":
    main()
