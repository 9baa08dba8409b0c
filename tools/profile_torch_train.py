#!/usr/bin/env python3
"""Profile one flagship STMoGen training step of the PyTorch port on the
card: device time by kernel, the port's own kernels summed, the device's
idle share over the step, the step's wall time and the max memory
allocated; then whether one step at a larger batch fits the card.

    python3 tools/profile_torch_train.py [--batch 32] [--fit 128] [--trace out.json]
                                         [--fp16] [--remat]

``--fp16`` trains in bf16 against the f32 master parameters (the config's
``fp16``, ``dict(dtype='bfloat16')``); ``--remat`` rematerializes the
decoder layers in the backward pass (``model.remat``): the counterparts of
tools/profile_train.py's flags.

The weights are seeded and fabricated, the batches seeded and synthetic
(apis/factory.py make_train_batch).  One step warms up, the next is traced
with torch.profiler.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

OWN = {"expert_ffn_kernel": "K6 fused_expert_ffn",
       "expert_ffn_bf16_kernel": "K6 fused_expert_ffn_bf16",
       "linear_attention_kernel": "K5 fused_linear_attention",
       "route_kernel<0>": "K4 moe_positions", "route_kernel<16>": "K4 moe_route",
       "route_kernel<64>": "K4 moe_route",
       "grouped_ffn_kernel": "K1 grouped_ffn", "head_ffn_kernel": "K2 head_ffn",
       "stma_attention_kernel": "K3 stma_linear_attention"}


def busy_us(intervals):
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--fit", type=int, default=128,
                    help="also run one step at this batch and report whether it fits (0: skip)")
    ap.add_argument("--trace", default=None, help="write a Chrome trace here")
    ap.add_argument("--fp16", action="store_true", help="bf16 forward and backward")
    ap.add_argument("--remat", action="store_true",
                    help="rematerialize the decoder layers (torch.utils.checkpoint)")
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    from motioncraft_tpu_torch.apis import make_train_batch, make_train_step, set_random_seed
    from motioncraft_tpu_torch.config import Config
    from motioncraft_tpu_torch.parallel import TrainState
    from motioncraft_tpu_torch.registry import build_architecture
    from motioncraft_tpu_torch.utils.convert import fabricate_state_dict

    if not torch.cuda.is_available():
        sys.exit("profile_torch_train: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())
    cfg = Config.fromfile(os.path.join(ROOT, "configs/stmogen/t2m_motionx_0_125b.py"))
    if args.remat:
        cfg["model"]["model"]["remat"] = True
    arch = build_architecture(cfg["model"], device="cuda")
    arch.model.load_state_dict(fabricate_state_dict(arch.model, seed=0), strict=True)
    state = TrainState(arch.model, cfg["optimizer"])
    step = make_train_step(arch, state, fp16=dict(dtype="bfloat16") if args.fp16 else None)
    g = set_random_seed(0, "cuda")
    T = arch.model.max_seq_len
    arch.train()

    def run(batch_size, seed):
        batch = make_train_batch(batch_size, seed=seed, max_seq_len=T)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logs = step(batch, g)
        loss = float(logs["loss"])  # waits for the device
        return (time.perf_counter() - t0) * 1e3, loss

    run(args.batch, 0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall_ms, loss = run(args.batch, 1)
    peak = torch.cuda.max_memory_allocated()
    if args.trace:
        prof.export_chrome_trace(args.trace)
    untraced_ms, _ = run(args.batch, 2)

    # device events less the annotations that span them (Adam's step)
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.is_user_annotation]
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
    print(f"fp16={args.fp16} remat={args.remat}")
    print(f"batch {args.batch}: traced step wall {wall_ms:.1f} ms (untraced {untraced_ms:.1f} ms), "
          f"device busy {busy / 1e3:.1f} ms, idle share {1 - busy / (wall_ms * 1e3):.3f}, "
          f"{len(kernels)} kernel launches, loss {loss:.5f}, "
          f"max memory allocated {peak / 2**30:.3f} GiB")
    total = sum(us for us, _ in by_name.values())
    print(f"{'device ms':>10} {'share':>6} {'calls':>6}  kernel")
    for name, (us, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:25]:
        print(f"{us / 1e3:10.2f} {us / total:6.3f} {n:6d}  {name[:110]}")
    print("the port's own kernels:")
    for label, (us, n) in sorted(own.items()):
        print(f"{us / 1e3:10.2f} {us / total:6.3f} {n:6d}  {label}")

    if args.fit:
        torch.cuda.reset_peak_memory_stats()
        try:
            ms, _ = run(args.fit, 3)
            ms, _ = run(args.fit, 4)
            print(f"batch {args.fit}: fits; step wall {ms:.1f} ms, max memory allocated "
                  f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB of "
                  f"{torch.cuda.get_device_properties(0).total_memory / 2**30:.1f} GiB")
        except torch.cuda.OutOfMemoryError as e:
            print(f"batch {args.fit}: does not fit ({str(e).splitlines()[0]}); max memory "
                  f"allocated before the failure {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")


if __name__ == "__main__":
    main()
