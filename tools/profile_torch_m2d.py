#!/usr/bin/env python3
"""Profile one outpainted long-form window of the PyTorch port's ControlNet
on the card, music-to-dance (configs/stmogen/m2d_finedance_0125b.py, the
default) or speech-to-gesture (--config configs/stmogen/s2g_beats2_0125b.py),
or the MCM ControlNet's (--config configs/mcm/mcm_{m2d_finedance,s2g_beats2}.py:
no CFG, R rows a denoiser call), at full width with seeded fabricated weights: RePaint-harmonized DDIM, 84
steps of which 57 call the ControlNet denoiser, for R recordings in
lockstep.  Prints the window's wall time, the device's busy time and idle
share, the kernel launches, device time by kernel and the port's own
kernels; for S2G also the device time of the WavEncoder, which the window
runs once (the condition encoded once a sampling call).

    python3 tools/profile_torch_m2d.py [--config CONFIG] [--recordings 1 4] [--trace out]

Per R: one plain and one outpainted window warm up; the same outpainted
window then runs twice untraced (its wall time, the mean) and once traced
with torch.profiler (the device's busy time).  The idle share is 1 - busy /
untraced wall: one window, one process.
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
CONFIG = os.path.join(ROOT, "configs", "stmogen", "m2d_finedance_0125b.py")


def _sample_profiler():
    spec = importlib.util.spec_from_file_location(
        "profile_torch_sample", os.path.join(ROOT, "tools", "profile_torch_sample.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default=CONFIG,
                    help="an M2D or S2G ControlNet config (the condition's shape follows it)")
    ap.add_argument("--recordings", type=int, nargs="+", default=[1, 4])
    ap.add_argument("--trace", default=None, help="write a Chrome trace per R here (R.json)")
    args = ap.parse_args()

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from motioncraft_tpu_torch.config import Config
    from motioncraft_tpu_torch.diffusion import (Outpainting, RepaintConfig, generator_randn,
                                                 harmonize_schedule)
    from motioncraft_tpu_torch.models.tokenizer import tokenize
    from motioncraft_tpu_torch.registry import build_architecture
    from motioncraft_tpu_torch.utils.convert import fabricate_state_dict

    if not torch.cuda.is_available():
        sys.exit("profile_torch_m2d: no CUDA device")
    prof_sample = _sample_profiler()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())
    cfg = Config.fromfile(args.config)
    win = cfg["windowed"]
    window, pre = win["window"], win["pre_frames"]
    arch = build_architecture(cfg["model"], device="cuda")
    arch.model.load_state_dict(fabricate_state_dict(arch.model, seed=0), strict=True)
    arch.repaint_cfg = RepaintConfig(overlap_len=pre)
    calls = sum(d for _, d in harmonize_schedule(arch.diffusion_test.num_timesteps,
                                                 arch.repaint_cfg))
    speech = arch.model.condition_pre_encoder is not None
    randn = generator_randn(torch.Generator(device="cuda").manual_seed(0), "cuda")
    rng = np.random.RandomState(0)

    def condition(R):
        """R windows' condition: onset + amplitude at the audio rate for
        speech, 163-d music features a frame for dance."""
        if not speech:
            return rng.randn(R, window, 163).astype(np.float32)
        n = window * (win["audio_sr"] // win["pose_fps"])
        return np.stack([np.abs(rng.randn(R, n)) * 0.3, rng.rand(R, n) < 2e-4],
                        axis=-1).astype(np.float32)

    for R in args.recordings:
        batch = {k: torch.as_tensor(v, device="cuda") for k, v in {
            "motion": np.zeros((R, window, 322), np.float32),
            "motion_mask": np.ones((R, window), np.float32),
            "motion_length": np.full((R, 1), window, np.int32),
            "text_ids": tokenize([f"A person is moving {i}" for i in range(R)]),
            "c": condition(R)}.items()}
        last = arch.sample(batch, randn=randn)
        mask = (torch.arange(window, device="cuda") < pre).reshape(1, window, 1)
        gt = torch.cat([last[:, -pre:], torch.zeros_like(last[:, pre:])], dim=1)
        op = Outpainting(mask=mask, gt=gt)
        arch.sample(batch, randn=randn, outpainting=op)
        torch.cuda.synchronize()
        walls = []
        for _ in range(2):
            t0 = time.perf_counter()
            arch.sample(batch, randn=randn, outpainting=op)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e6)
        wall_us = sum(walls) / len(walls)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            arch.sample(batch, randn=randn, outpainting=op)
            torch.cuda.synchronize()
            traced_us = (time.perf_counter() - t0) * 1e6
        if args.trace:
            prof.export_chrome_trace(f"{args.trace}.R{R}.json")

        kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        busy = prof_sample.busy_us([(e.time_range.start, e.time_range.end) for e in kernels])
        by_name = {}
        for e in kernels:
            by_name.setdefault(e.name, [0.0, 0])
            by_name[e.name][0] += e.time_range.end - e.time_range.start
            by_name[e.name][1] += 1
        own = {}
        for name, (us, n) in by_name.items():
            for key, label in prof_sample.OWN.items():
                if key in name:
                    own.setdefault(label, [0.0, 0])
                    own[label][0] += us
                    own[label][1] += n
        print(f"R={R}: one outpainted window ({window} frames, "
              f"{len(harmonize_schedule(arch.diffusion_test.num_timesteps, arch.repaint_cfg))} "
              f"RePaint steps, {calls} denoiser calls): wall {wall_us / 1e3:.1f} ms untraced "
              f"(runs {', '.join(f'{w / 1e3:.1f}' for w in walls)}), {traced_us / 1e3:.1f} ms "
              f"traced; device busy {busy / 1e3:.1f} ms; idle share {1 - busy / wall_us:.3f} "
              f"(busy / untraced wall); {len(kernels)} kernel launches "
              f"({len(kernels) / calls:.0f} a denoiser call)")
        if speech:
            with torch.no_grad(), profile(activities=[ProfilerActivity.CPU,
                                                      ProfilerActivity.CUDA]) as enc_prof:
                arch.model.encode_condition(batch["c"], window)
                torch.cuda.synchronize()
            enc = [e for e in enc_prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
            enc_busy = prof_sample.busy_us([(e.time_range.start, e.time_range.end)
                                            for e in enc])
            print(f"  WavEncoder (once in the window, {tuple(batch['c'].shape)}): device busy "
                  f"{enc_busy / 1e3:.2f} ms in {len(enc)} kernels, "
                  f"{enc_busy / busy:.3f} of the window's")
        total = sum(us for us, _ in by_name.values())
        print(f"{'device ms':>10} {'share':>6} {'calls':>6}  kernel")
        for name, (us, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:20]:
            print(f"{us / 1e3:10.2f} {us / total:6.3f} {n:6d}  {name[:110]}")
        print("the port's own kernels:")
        for label, (us, n) in sorted(own.items()):
            print(f"{us / 1e3:10.2f} {us / total:6.3f} {n:6d}  {label}")


if __name__ == "__main__":
    main()
