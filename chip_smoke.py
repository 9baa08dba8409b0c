#!/usr/bin/env python3
"""Drive the PyTorch port's flagship text-to-motion sampling on one NVIDIA
GPU and hold each of its CUDA kernels against its plain PyTorch version.

Run from the root of the repository, on a machine with one card and the CUDA
toolkit:

    python3 chip_smoke.py

Phases; any failure exits non-zero:
  1. the card's name and power limit; build the kernels from
     motioncraft_tpu_torch/csrc/ with nvcc for sm_90a
  2. each kernel against its plain version on the same inputs, at the
     shapes of phase 4: max abs error against its tolerance; kernel and
     plain times from CUDA events; the least time the card could take
  3. the flagship MotionDiffusion (configs/stmogen/t2m_motionx_0_125b.py) on
     the card, with seeded fabricated weights
  4. two batches of 16 requests (T = 196, varied lengths) through
     single_device_test: DDIM-50 with CFG 6.5; finite [16, 196, 322] outputs
  5. per-batch wall time, and each kernel's launches, which must equal the
     count that 50 steps x 4 layers imply
  6. one flagship forward_test on the card against the same weights and
     inputs on the CPU (plain versions), B = 2, the CPU's MoE gates fed the
     card's gate logits so that a near-tie cannot route a token differently
  7. one JSON line of the kernels' numbers, and last the device line

The script imports nothing of JAX and nothing of motioncraft_tpu.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(ROOT, "configs", "stmogen", "t2m_motionx_0_125b.py")
F32_PEAK = 67e12      # H100 SXM CUDA-core f32, FLOP/s (exact f32: no TF32)
HBM_PEAK = 3.35e12    # H100 SXM device memory, bytes/s
KERNEL_REL_TOL = 1e-4   # kernel vs plain: max abs err <= tol * max |plain|
MODEL_REL_TOL = 1e-4    # card vs CPU forward: <= tol * max(1, max |CPU|)
BATCH, BATCHES, SEED = 16, 2, 0

PALLAS = {
    "moe_positions": "motioncraft_tpu/ops/pallas_moe.py:54",
    "grouped_ffn": "motioncraft_tpu/ops/pallas_moe_ffn.py:46",
    "head_ffn": "motioncraft_tpu/ops/pallas_sffn.py:41",
    "stma_linear_attention": "motioncraft_tpu/ops/pallas_stma_attention.py:74",
}
SOURCES = {
    "moe_positions": "motioncraft_tpu_torch/csrc/moe_positions.cu",
    "grouped_ffn": "motioncraft_tpu_torch/csrc/moe_ffn.cu",
    "head_ffn": "motioncraft_tpu_torch/csrc/sffn.cu",
    "stma_linear_attention": "motioncraft_tpu_torch/csrc/stma_attention.cu",
}


class PhaseError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


def time_ms(torch, fn, reps=20):
    """Mean device time of one call over ``reps`` back-to-back calls."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(flops, nbytes):
    t_ops, t_bytes = flops / F32_PEAK * 1e3, nbytes / HBM_PEAK * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def flagship_inputs(torch, cfg, dev):
    """Inputs of every kernel at the shapes the phase-4 batches give them."""
    from motioncraft_tpu_torch.ops.moe_ffn import BLOCK

    g = torch.Generator(device=dev).manual_seed(SEED)
    m = cfg["model"]
    ca = m["ca_block_cfg"]
    B2, T, H, L = 2 * BATCH, m["max_seq_len"], ca["num_heads"], ca["latent_dim"]
    E, K, TXT = ca["num_experts"], ca["topk"], ca["max_text_seq_len"]
    f = m["ffn_cfg"]["ffn_dim"]
    r = lambda *s: torch.randn(*s, generator=g, device=dev)  # noqa: E731

    def moe_case(n_tokens, d, hid):
        ids = torch.randint(0, E, (K * n_tokens,), generator=g, device=dev,
                            dtype=torch.int32)
        cap = K * int(1.5 * ((n_tokens + E - 1) // E))
        fill = torch.bincount(ids.long(), minlength=E).clamp(max=cap)
        aligned = (fill + BLOCK - 1) // BLOCK * BLOCK
        M = (n_tokens * K + BLOCK - 1) // BLOCK * BLOCK + E * BLOCK
        starts = torch.arange(M // BLOCK, device=dev) * BLOCK
        be = torch.searchsorted(torch.cumsum(aligned, 0), starts, right=True)
        be = be.clamp(max=E - 1).to(torch.int32)
        ffn = (be, r(M, d), r(E, d, hid) / math.sqrt(d), r(E, hid) * 0.1,
               r(E, hid, d) / math.sqrt(hid))
        return (ids, E), ffn

    pos_motion, ffn_motion = moe_case(B2 * T * H, L, 4 * L)
    pos_text, ffn_text = moe_case(B2 * TXT, ca["text_latent_dim"], 4 * ca["text_latent_dim"])
    lengths = torch.randint(min(40, T), T + 1, (B2,), generator=g, device=dev)
    mask = (torch.arange(T, device=dev)[None] < lengths[:, None]).float()[..., None]
    tcond = torch.cat([torch.ones(B2 // 2), torch.zeros(B2 // 2)]).to(dev).reshape(B2, 1, 1)
    return {
        "moe_positions": [pos_motion, pos_text],
        "grouped_ffn": [ffn_motion, ffn_text],
        "head_ffn": [(r(B2 * T, H * L), r(H, L, f) / math.sqrt(L), r(H, f) * 0.1,
                      r(H, f, L) / math.sqrt(f), r(H, L) * 0.1)],
        "stma_linear_attention": [(r(B2, T, H, 4 * L), r(B2, TXT, 2 * L), mask, tcond)],
    }


def kernel_bound(name, args):
    """(ms, 'bytes' | 'operations'): each input read once, each output
    written once, the operations the function needs, at the card's peaks."""
    if name == "moe_positions":
        M = args[0].numel()
        return bound(M, 8 * M + 4 * args[1])
    if name == "grouped_ffn":
        be, xs, w1, b1, w2 = args
        (m_pad, d), hid = xs.shape, w1.shape[2]
        nbytes = 4 * (2 * xs.numel() + be.numel() + w1.numel() + b1.numel() + w2.numel())
        return bound(4 * m_pad * d * hid, nbytes)
    if name == "head_ffn":
        x, w1, b1, w2, b2 = args
        n, hd = x.shape
        f = w1.shape[2]
        nbytes = 4 * (2 * x.numel() + w1.numel() + b1.numel() + w2.numel() + b2.numel())
        return bound(4 * n * hd * f, nbytes)
    mot, txt, mask, tcond = args
    B, T, H, d4 = mot.shape
    d, TXT = d4 // 4, txt.shape[1]
    flops = B * H * (2 * (T + TXT) * d * d + 2 * T * d * d)
    nbytes = 4 * (mot.numel() + txt.numel() + mask.numel() + tcond.numel() + B * T * H * d)
    return bound(flops, nbytes)


def phase_kernels(torch, cfg, dev):
    """Phase 2: every kernel against its plain version, with times."""
    from motioncraft_tpu_torch.ops import KERNELS

    rows = {}
    for name, cases in flagship_inputs(torch, cfg, dev).items():
        wrapper, plain = KERNELS[name]
        for i, args in enumerate(cases):
            got, want = wrapper(*args), plain(*args)
            torch.cuda.synchronize()
            if name == "moe_positions":
                err = max(float((a - b).abs().max()) for a, b in zip(got, want))
                ok, tol = err == 0, "exact"
            else:
                err = float((got - want).abs().max())
                scale = float(want.abs().max())
                ok, tol = err <= KERNEL_REL_TOL * scale, f"{KERNEL_REL_TOL} x {scale:.4g}"
            shapes = [tuple(a.shape) for a in args if hasattr(a, "shape")]
            print(f"[kernel] {name} case {i} {shapes}: max_abs_err {err:.3e} (tol {tol})")
            check(ok, f"{name} disagrees with its plain version: {err} (tol {tol})")
            if i:
                continue  # times are taken at the first (dominant) shape
            ms = time_ms(torch, lambda: wrapper(*args))
            plain_ms = time_ms(torch, lambda: plain(*args))
            bound_ms, bound_by = kernel_bound(name, args)
            print(f"[kernel] {name}: {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                  f"bound {bound_ms:.4f} ms ({bound_by})")
            rows[name] = {"name": name, "route": "cuda", "source": SOURCES[name],
                          "replaces": PALLAS[name], "max_abs_err": err, "ms": ms,
                          "plain_ms": plain_ms, "bound_ms": bound_ms,
                          "bound_by": bound_by, "library_ms": None}
    return rows


def requests(num, seed, T):
    import numpy as np
    from motioncraft_tpu_torch.apis import make_text_batch

    verbs = ["walks", "jumps", "waves", "dances", "kicks", "turns", "sits down",
             "runs in a circle"]
    rng = np.random.RandomState(seed)
    texts = [f"a person {verbs[i % len(verbs)]} then {verbs[(3 * i + 1) % len(verbs)]}"
             for i in range(num)]
    lengths = rng.randint(min(40, T), T + 1, (num, 1)).astype(np.int32)
    batch = make_text_batch(texts, max_seq_len=T, lengths=lengths)
    batch["motion_metas"] = [{"text": s} for s in texts]
    return batch


def phase_e2e(torch, arch):
    """Phases 4-5: the batches through single_device_test, with counts."""
    import numpy as np
    from motioncraft_tpu_torch.apis import single_device_test
    from motioncraft_tpu_torch.ops import launch_counts, reset_launch_counts

    T, D = arch.model.max_seq_len, arch.model.input_feats
    batches = [requests(BATCH, SEED + i, T) for i in range(BATCHES)]
    reset_launch_counts()
    t0 = time.perf_counter()
    results = single_device_test(arch, batches, seed=SEED, device=arch.device,
                                 logger=lambda s: print(f"[e2e] {s}"))
    wall = time.perf_counter() - t0
    counts = launch_counts()
    print(f"[e2e] {len(results)} samples in {wall:.3f} s; launches {counts}")
    check(len(results) == BATCH * BATCHES, f"{len(results)} results")
    for item in results:
        check(item["pred_motion"].shape == (T, D), f"shape {item['pred_motion'].shape}")
        check(np.isfinite(item["pred_motion"]).all(), "non-finite motion")
    steps, layers = arch.diffusion_test.num_timesteps, arch.model.num_layers
    # per sampling call: the text MoE once per layer, then per step and layer
    # one motion MoE, one SFFN and one global attention
    want = {"moe_positions": BATCHES * layers * (steps + 1),
            "grouped_ffn": BATCHES * layers * (steps + 1),
            "head_ffn": BATCHES * layers * steps,
            "stma_linear_attention": BATCHES * layers * steps}
    check(counts == want, f"launch counts {counts} != expected {want}")
    spread = float(np.std([r["pred_motion"] for r in results], axis=0).mean())
    print(f"[e2e] steps {steps}, layers {layers}; mean spread across samples {spread:.4g}")
    return counts


def phase_parity(torch, cfg, arch, sd):
    """Phase 6: forward_test on the card against the CPU (plain kernels).

    A token whose top-2 gate logits are a near-tie (gaps of 1e-8 occur at
    this size) can pick another expert on another device: both runs are
    right, yet that token's output and, through the global attention, its
    whole sequence differ.  So the CPU's MoE gates are fed the card's gate
    logits; every other op, each kernel's plain version included, runs on
    the CPU's own inputs.  The gates' own difference and the tokens that
    would have flipped are printed."""
    from motioncraft_tpu_torch.models.moe import CosineTopGate
    from motioncraft_tpu_torch.registry import build_architecture

    cpu = build_architecture(cfg, device="cpu")
    cpu.model.load_state_dict(sd, strict=True)
    batch = requests(2, SEED + 100, arch.model.max_seq_len)
    g = torch.Generator().manual_seed(SEED + 7)
    x = torch.randn(batch["motion"].shape, generator=g)
    ts = torch.full((2,), 499, dtype=torch.long)
    card_logits, gate_diff, flips = [], [0.0], [0]
    k = cfg["model"]["ca_block_cfg"]["topk"]

    def record(mod, inp, out):
        card_logits.append(out.cpu())

    def replay(mod, inp, out):
        want = card_logits[len(replayed)]
        replayed.append(out)
        gate_diff[0] = max(gate_diff[0], float((out - want).abs().max()))
        own, card = (torch.sort(v, dim=1, descending=True, stable=True).indices[:, :k]
                     .sort(dim=1).values for v in (out, want))
        flips[0] += int((own != card).any(dim=1).sum())
        return want

    replayed = []
    outs = {}
    for label, a, hook in (("cuda", arch, record), ("cpu", cpu, replay)):
        handles = [m.register_forward_hook(hook) for m in a.modules()
                   if isinstance(m, CosineTopGate)]
        with torch.no_grad():
            xf = a.encode_text(batch["text_ids"])
            out = a.model(x.to(a.device), ts.to(a.device),
                          motion_mask=torch.as_tensor(batch["motion_mask"], device=a.device),
                          motion_length=torch.as_tensor(batch["motion_length"],
                                                        device=a.device),
                          xf_out=xf, text_feats=a.model.precompute_text_feats(xf))
        for h in handles:
            h.remove()
        outs[label] = (xf.cpu(), out.cpu())
    check(len(replayed) == len(card_logits) > 0, "gate calls differ between devices")
    over, gap = [], float("inf")
    for lg in card_logits:
        top = torch.sort(lg, dim=1, descending=True, stable=True)
        gap = min(gap, float((top.values[:, k - 1] - top.values[:, k]).min()))
        N, E = lg.shape
        cap = max(1, min(k * int(1.5 * ((N + E - 1) // E)), N))
        load = int(torch.bincount(top.indices[:, :k].reshape(-1), minlength=E).max())
        if load > cap:
            over.append(f"{load}>{cap}")
    print(f"[parity] MoE calls over capacity (largest expert load > capacity): "
          f"{len(over)} of {len(card_logits)} {over}; smallest gap between the "
          f"top-{k} and the next gate logit: {gap:.3e}")
    print(f"[parity] {len(card_logits)} gate calls: card vs CPU gate logits max abs diff "
          f"{gate_diff[0]:.3e}; tokens whose top-2 experts would differ: {flips[0]}")
    for what, i in (("encode_text", 0), ("forward_test", 1)):
        got, want = outs["cuda"][i], outs["cpu"][i]
        scale = max(1.0, float(want.abs().max()))
        diff = float((got - want).abs().max())
        print(f"[parity] {what} B=2: card vs CPU max abs diff {diff:.3e} "
              f"(tol {MODEL_REL_TOL} x {scale:.4g})")
        check(diff <= MODEL_REL_TOL * scale, f"{what} card vs CPU: {diff} > tol")


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from motioncraft_tpu_torch.config import Config
        from motioncraft_tpu_torch.ops import _build, launch_counts  # noqa: F401
        from motioncraft_tpu_torch.registry import build_architecture
        from motioncraft_tpu_torch.utils.convert import fabricate_state_dict
    except ImportError as e:
        print(f"chip_smoke: the port is not next to this script ({e})", file=sys.stderr)
        return 2
    if not os.path.isfile(CONFIG):
        print(f"chip_smoke: missing {CONFIG}", file=sys.stderr)
        return 2

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    print(f"[card] {smi}")
    print(f"[card] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    seconds = _build.build()
    print(f"[build] kernels built in {seconds:.1f} s into {_build.BUILD_DIR}")

    cfg = Config.fromfile(CONFIG)["model"]
    dev = torch.device("cuda")
    rows = phase_kernels(torch, cfg, dev)

    t0 = time.perf_counter()
    arch = build_architecture(cfg, device="cuda")
    sd = fabricate_state_dict(arch.model, seed=SEED)
    arch.model.load_state_dict(sd, strict=True)
    print(f"[model] flagship built in {time.perf_counter() - t0:.1f} s, "
          f"{sum(p.numel() for p in arch.parameters()) / 1e6:.1f} M parameters")

    counts = phase_e2e(torch, arch)
    phase_parity(torch, cfg, arch, sd)

    for name, row in rows.items():
        row["launches"] = counts[name]
    print(json.dumps({"kernels": list(rows.values())}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
