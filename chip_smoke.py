#!/usr/bin/env python3
"""Drive the PyTorch port's flagship text-to-motion sampling and training on
one NVIDIA GPU and hold each of its CUDA kernels against its plain PyTorch
version.

Run from the root of the repository, on a machine with one card and the CUDA
toolkit:

    python3 chip_smoke.py

Phases; any failure exits non-zero:
  1. the card's name and power limit; build the kernels from
     motioncraft_tpu_torch/csrc/ with nvcc for sm_90a
  2. each kernel against its plain version on the same inputs, at every
     shape of phase 4 (K1-K4's route) and of phase 7 (K4's positions, K5,
     K6, at B = 32): max abs error against its tolerance (K4 exact in its
     integers, its route's gates within 1e-6; a route case leaning to one
     expert must drop choices); the kernel's device time from torch.profiler
     (ms: its kernels' own durations, which a back-to-back timing of a
     kernel of a few microseconds does not give, the host issuing the calls
     slower than the card runs them), and from CUDA events the time of a
     back-to-back call (call_ms) and of the plain version;
     the least time the card could take (bound_ms: f32 products in 3xTF32
     on the tensor cores, which K1-K3, K5 and K6 run; K4's work on the CUDA
     cores), and the f32 bound on the CUDA cores as a second note
     (bound_f32_ms); how many of K3's clusters fit on the card at once
  3. the flagship MotionDiffusion (configs/stmogen/t2m_motionx_0_125b.py) on
     the card, with seeded fabricated weights
  4. two batches of 16 requests (T = 196, varied lengths) through
     single_device_test: DDIM-50 with CFG 6.5; finite [16, 196, 322] outputs
  5. per-batch wall time, and each kernel's launches, which must equal the
     count that 50 steps x 4 layers imply (each MoE routes in one
     moe_route launch; no positions-only launch)
  6. one flagship forward_test on the card against the same weights and
     inputs on the CPU (plain versions), B = 2, the CPU's MoE gates fed the
     card's gate logits so that a near-tie cannot route a token differently
  7. train_model on the same flagship (Adam lr 2e-4, the config's recipe):
     1 warm-up + 3 steps of B = 32 seeded synthetic batches (T = 196,
     lengths 40-196); finite losses, every trainable parameter moved, CLIP
     unchanged bit for bit; per-step wall ms, max memory allocated, and the
     launches per step (K5 = 4, K6 = K4's positions = 8, K1-K3 and K4's
     route none)
  8. one flagship training loss and every parameter's gradient on the card
     against the CPU, B = 2, gate noise 0, the CPU's gate logits pinned to
     the card's as in phase 6
  9. the T2M protocol evaluation through tools/torch_test.py on the same
     flagship config: a synthetic Motion-X tree of 320 clips (196 x 322,
     written here in tools/make_tiny_data.py's layout), phase 3's weights
     saved with save_params and loaded back by --checkpoint, a full-width
     SMPL-X evaluator (DistilBERT 6 x 768, ActorAgnostic 4 x 256) saved as
     its .npz; one replication at batch 16: DDIM-50 CFG through K1-K4, the
     evaluator on the card, R-Precision / Matching / FID / Diversity.  The
     loaded model's forward equals the in-memory one's bit for bit, every
     metric is finite, K1-K4's launches are what 50 steps x 4 layers x 20
     batches imply, GT mode on the same tree gives FID <= 1e-3, and the
     evaluator's embeddings on the card agree with the CPU's; wall seconds of
     sampling and of evaluation, samples per second
 10. one JSON line of the kernels' numbers, and last the device line

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
F32_PEAK = 67e12      # H100 SXM CUDA-core f32, FLOP/s
TF32_PEAK = 495e12    # H100 SXM dense TF32 tensor cores, FLOP/s; 3xTF32 takes 3 passes
HBM_PEAK = 3.35e12    # H100 SXM device memory, bytes/s
KERNEL_REL_TOL = 1e-4   # kernel vs plain: max abs err <= tol * max |plain|
# moe_route's gates and ge against the plain version's: a softmax over 16
# terms summed in another order moves a gate in [0, 1] by a few f32 ulps
GATE_ATOL = 1e-6
MODEL_REL_TOL = 1e-4    # card vs CPU forward: <= tol * max(1, max |CPU|)
# card vs CPU gradient, per tensor: <= tol * max(1, max |CPU|); a gradient
# sums the whole batch, the card's MoE gathers add theirs back with atomics
# in a varying order, and the f32 products sum in other orders
GRAD_REL_TOL = 1e-3
BATCH, BATCHES, SEED = 16, 2, 0
TRAIN_BATCH, TRAIN_STEPS = 32, 4  # 1 warm-up + 3 timed
EVAL_CLIPS = 320        # one replication; the Diversity metric draws 300 samples
GT_FID_TOL = 1e-3

PALLAS = {
    "moe_route": "motioncraft_tpu/ops/pallas_moe.py:54",
    "moe_positions": "motioncraft_tpu/ops/pallas_moe.py:54",
    "grouped_ffn": "motioncraft_tpu/ops/pallas_moe_ffn.py:46",
    "head_ffn": "motioncraft_tpu/ops/pallas_sffn.py:41",
    "stma_linear_attention": "motioncraft_tpu/ops/pallas_stma_attention.py:74",
    "fused_linear_attention": "motioncraft_tpu/ops/pallas_attention.py:111",
    "fused_expert_ffn": "motioncraft_tpu/ops/pallas_ffn.py:86",
}
SOURCES = {
    "moe_route": "motioncraft_tpu_torch/csrc/moe_positions.cu",
    "moe_positions": "motioncraft_tpu_torch/csrc/moe_positions.cu",
    "grouped_ffn": "motioncraft_tpu_torch/csrc/moe_ffn.cu",
    "head_ffn": "motioncraft_tpu_torch/csrc/sffn.cu",
    "stma_linear_attention": "motioncraft_tpu_torch/csrc/stma_attention.cu",
    "fused_linear_attention": "motioncraft_tpu_torch/csrc/linear_attention.cu",
    "fused_expert_ffn": "motioncraft_tpu_torch/csrc/expert_ffn.cu",
}


class PhaseError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


def time_ms(torch, fn, reps=20):
    """Mean time of one call over ``reps`` back-to-back calls, between two
    CUDA events: the device's time, or the host's where issuing a call
    takes longer than running it."""
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


def device_ms(torch, fn, reps=20):
    """Mean device time of one call over ``reps`` calls: the summed
    durations of the kernels it ran, from torch.profiler, without the gaps
    in which the card waited for the host."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.end - e.time_range.start for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    check(us > 0, "the profiler saw no device time")
    return us / 1e3 / reps


def bound(flops, nbytes, peak):
    """(ms, 'bytes' | 'operations'): the larger of bytes over the memory
    rate and flops over ``peak``."""
    t_ops, t_bytes = flops / peak * 1e3, nbytes / HBM_PEAK * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def flagship_inputs(torch, cfg, dev):
    """Inputs of every kernel at the shapes the phase-4 batches (K1, K2, K3,
    K4's route) and the phase-7 training steps (K4's positions, K5, K6) give
    them."""
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

    def route_case(n_tokens, skew=0.0):
        logits = r(n_tokens, E)
        logits[:, 0] += skew  # every token leans to expert 0: it overflows
        return logits, K, K * int(1.5 * ((n_tokens + E - 1) // E)), BLOCK

    pos_motion, ffn_motion = moe_case(B2 * T * H, L, 4 * L)
    pos_text, ffn_text = moe_case(B2 * TXT, ca["text_latent_dim"], 4 * ca["text_latent_dim"])
    route = [route_case(B2 * T * H), route_case(B2 * T * H, skew=3.0), route_case(B2 * TXT)]
    lengths = torch.randint(min(40, T), T + 1, (B2,), generator=g, device=dev)
    mask = (torch.arange(T, device=dev)[None] < lengths[:, None]).float()[..., None]
    tcond = torch.cat([torch.ones(B2 // 2), torch.zeros(B2 // 2)]).to(dev).reshape(B2, 1, 1)

    # training at B = 32: STMA's global attention over 77 text + T motion
    # keys (masked past each length, text off for 1 in 10), and the slot
    # buffers of the motion and the text MoE (filled up to their loads)
    Bt = TRAIN_BATCH
    t_len = torch.randint(min(40, T), T + 1, (Bt,), generator=g, device=dev)
    key_mask = torch.cat([(torch.rand(Bt, 1, generator=g, device=dev) > 0.1).float()
                          .expand(Bt, TXT),
                          (torch.arange(T, device=dev)[None] < t_len[:, None]).float()],
                         dim=1)[:, :, None, None]
    la = (r(Bt, T, H, L), r(Bt, TXT + T, H, L) + (1 - key_mask) * -1e6,
          r(Bt, TXT + T, H, L) * key_mask)

    def slots_case(n_tokens, d, hid):
        cap = K * int(1.5 * ((n_tokens + E - 1) // E))
        ids = torch.randint(0, E, (K * n_tokens,), generator=g, device=dev)
        fill = torch.bincount(ids, minlength=E).clamp(max=cap)
        xe = r(E, cap, d) * (torch.arange(cap, device=dev)[None] < fill[:, None])[..., None]
        return (xe, r(E, d, hid) / math.sqrt(d), r(E, hid) * 0.1,
                r(E, hid, d) / math.sqrt(hid), r(E, d) * 0.1)

    return {
        "fused_linear_attention": [la],
        "fused_expert_ffn": [slots_case(Bt * T * H, L, 4 * L),
                             slots_case(Bt * TXT, ca["text_latent_dim"],
                                        4 * ca["text_latent_dim"])],
        "moe_route": route,
        "moe_positions": [pos_motion, pos_text],
        "grouped_ffn": [ffn_motion, ffn_text],
        "head_ffn": [(r(B2 * T, H * L), r(H, L, f) / math.sqrt(L), r(H, f) * 0.1,
                      r(H, f, L) / math.sqrt(f), r(H, L) * 0.1)],
        "stma_linear_attention": [(r(B2, T, H, 4 * L), r(B2, TXT, 2 * L), mask, tcond)],
    }


def kernel_work(name, args):
    """(flops, bytes) of one call: the operations the function needs, each
    input read once, each output written once."""
    if name == "moe_positions":
        M = args[0].numel()
        return M, 8 * M + 4 * args[1]
    if name == "moe_route":
        from motioncraft_tpu_torch.ops.moe_positions import route_rows

        logits, K, _, block = args
        N, E = logits.shape
        M = route_rows(N, K, E, block)
        # per logit: max, subtract, exp, sum and a compare per pick; the
        # logits in, gates, r, ge, token_for_rank, block_expert, counts out
        return N * E * (4 + K), 4 * (2 * N * E + 2 * N * K + M + M // block + E)
    if name == "grouped_ffn":
        be, xs, w1, b1, w2 = args
        (m_pad, d), hid = xs.shape, w1.shape[2]
        nbytes = 4 * (2 * xs.numel() + be.numel() + w1.numel() + b1.numel() + w2.numel())
        return 4 * m_pad * d * hid, nbytes
    if name == "head_ffn":
        x, w1, b1, w2, b2 = args
        n, hd = x.shape
        f = w1.shape[2]
        nbytes = 4 * (2 * x.numel() + w1.numel() + b1.numel() + w2.numel() + b2.numel())
        return 4 * n * hd * f, nbytes
    if name == "fused_linear_attention":
        q, k, v = args
        B, T, H, d = q.shape
        N = k.shape[1]
        return 2 * B * H * (N + T) * d * d, 4 * (2 * q.numel() + k.numel() + v.numel())
    if name == "fused_expert_ffn":
        xe, w1, b1, w2, b2 = args
        E, C, d = xe.shape
        nbytes = 4 * (2 * xe.numel() + w1.numel() + b1.numel() + w2.numel() + b2.numel())
        return 4 * E * C * d * w1.shape[2], nbytes
    mot, txt, mask, tcond = args
    B, T, H, d4 = mot.shape
    d, TXT = d4 // 4, txt.shape[1]
    flops = B * H * (2 * (T + TXT) * d * d + 2 * T * d * d)
    # of mot's four lanes the function reads key, value and query, not the
    # body value
    nbytes = 4 * (3 * mot.numel() // 4 + txt.numel() + mask.numel() + tcond.numel()
                  + B * T * H * d)
    return flops, nbytes


def phase_kernels(torch, cfg, dev):
    """Phase 2: every kernel against its plain version, with times."""
    from motioncraft_tpu_torch.ops import KERNELS
    from motioncraft_tpu_torch.ops.stma_attention import max_active_clusters

    print(f"[kernel] stma_linear_attention d=128: {max_active_clusters()} clusters of 4 "
          f"CTAs resident at once (cudaOccupancyMaxActiveClusters)")

    rows = {}
    for name, cases in flagship_inputs(torch, cfg, dev).items():
        wrapper, plain = KERNELS[name]
        for i, args in enumerate(cases):
            got, want = wrapper(*args), plain(*args)
            torch.cuda.synchronize()
            if name == "moe_route":
                err = max(float((a - b).abs().max()) for a, b in zip(got, want)
                          if a.dtype == torch.float32)
                ints = [f for f, a, b in zip(got._fields, got, want)
                        if a.dtype != torch.float32 and not torch.equal(a, b)]
                ok, tol = err <= GATE_ATOL and not ints, f"{GATE_ATOL}; integers exact"
                dropped = int((got.r == got.token_for_rank.numel()).sum())
                print(f"[kernel] {name} case {i}: {dropped} of {got.r.numel()} choices "
                      f"dropped; integer outputs that differ: {ints}")
                check(dropped > 0 or i != 1, "the skewed route case dropped nothing")
            elif name == "moe_positions":
                err = max(float((a - b).abs().max()) for a, b in zip(got, want))
                ok, tol = err == 0, "exact"
            else:
                err = float((got - want).abs().max())
                scale = float(want.abs().max())
                ok, tol = err <= KERNEL_REL_TOL * scale, f"{KERNEL_REL_TOL} x {scale:.4g}"
            shapes = [tuple(a.shape) for a in args if hasattr(a, "shape")]
            print(f"[kernel] {name} case {i} {shapes}: max_abs_err {err:.3e} (tol {tol})")
            check(ok, f"{name} disagrees with its plain version: {err} (tol {tol})")
            ms = device_ms(torch, lambda: wrapper(*args))
            call_ms = time_ms(torch, lambda: wrapper(*args))
            plain_ms = time_ms(torch, lambda: plain(*args))
            flops, nbytes = kernel_work(name, args)
            if name in ("moe_positions", "moe_route"):  # on the CUDA cores only
                bound_ms, bound_by = f32_ms, f32_by = bound(flops, nbytes, F32_PEAK)
            else:  # f32 products: 3xTF32 on the tensor cores is the fastest exact way
                bound_ms, bound_by = bound(3 * flops, nbytes, TF32_PEAK)
                f32_ms, f32_by = bound(flops, nbytes, F32_PEAK)
            print(f"[kernel] {name} case {i}: {ms:.4f} ms on the device ({call_ms:.4f} ms a "
                  f"back-to-back call), plain {plain_ms:.4f} ms, "
                  f"bound {bound_ms:.4f} ms ({bound_by}, share {bound_ms / ms:.3f}); "
                  f"f32 CUDA-core bound {f32_ms:.4f} ms ({f32_by}, share {f32_ms / ms:.3f})")
            case = {"shape": shapes, "ms": ms, "call_ms": call_ms, "bound_ms": bound_ms}
            if i:  # the row's own numbers are the first (dominant) case's
                rows[name]["cases"].append(case)
                continue
            rows[name] = {"name": name, "route": "cuda", "source": SOURCES[name],
                          "replaces": PALLAS[name], "max_abs_err": err, "ms": ms,
                          "call_ms": call_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                          "bound_by": bound_by, "bound_f32_ms": f32_ms,
                          "bound_f32_by": f32_by, "library_ms": None, "cases": [case]}
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
    want = {"moe_route": BATCHES * layers * (steps + 1), "moe_positions": 0,
            "grouped_ffn": BATCHES * layers * (steps + 1),
            "head_ffn": BATCHES * layers * steps,
            "stma_linear_attention": BATCHES * layers * steps,
            "fused_linear_attention": 0, "fused_expert_ffn": 0}
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


def phase_train(torch, full_cfg, arch):
    """Phase 7: train_model on the flagship, B = 32, with counts."""
    import numpy as np
    from motioncraft_tpu_torch.apis import make_train_batch, train_model
    from motioncraft_tpu_torch.ops import launch_counts, reset_launch_counts

    T = arch.model.max_seq_len
    batches = [make_train_batch(TRAIN_BATCH, seed=SEED + i, max_seq_len=T)
               for i in range(TRAIN_STEPS)]
    before = {k: v.clone() for k, v in arch.model.state_dict().items()}
    lines = []

    def log(msg):
        lines.append(msg)
        print(f"[train] {msg}")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    state = train_model(arch, batches, optimizer_cfg=full_cfg["optimizer"],
                        lr_config=full_cfg["lr_config"], max_epochs=1,
                        steps_per_epoch=TRAIN_STEPS, seed=SEED, log_interval=1, logger=log)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    check(state.step == TRAIN_STEPS and not arch.training, "train_model did not finish")
    losses = [float(m.split(" loss=")[1].split()[0]) for m in lines if " loss=" in m]
    step_ms = [float(m.split("step_ms=")[1]) for m in lines if "step_ms=" in m]
    check(len(losses) == TRAIN_STEPS and np.isfinite(losses).all(), f"losses {losses}")
    after = arch.model.state_dict()
    trainable = {n for n, p in arch.model.named_parameters() if p.requires_grad}
    frozen = [n for n in before if n.startswith("text_enc.clip.")]
    moved = [n for n in trainable if not torch.equal(after[n], before[n])]
    check(frozen and all(torch.equal(after[n], before[n]) for n in frozen),
          "a frozen CLIP parameter changed")
    # face_no_loss masks the face features out of the loss, so the face head
    # gets an exactly zero gradient and Adam leaves it where it is
    still = sorted(trainable - set(moved))
    check(all(n.startswith("out.face_out.") for n in still),
          f"trainable parameters that did not move: {still[:5]}")
    layers = arch.model.num_layers
    per_step = {"moe_route": 0, "moe_positions": 2 * layers, "grouped_ffn": 0,
                "head_ffn": 0, "stma_linear_attention": 0, "fused_linear_attention": layers,
                "fused_expert_ffn": 2 * layers}
    want = {k: v * TRAIN_STEPS for k, v in per_step.items()}
    print(f"[train] {TRAIN_STEPS} steps of B={TRAIN_BATCH} in {wall:.3f} s; step wall ms "
          f"{step_ms} (first = warm-up); max memory allocated {peak / 2**30:.3f} GiB; "
          f"{len(moved)} of {len(trainable)} trainable tensors moved (not: {still}), "
          f"{len(frozen)} CLIP tensors unchanged; launches {counts}")
    check(counts == want, f"training launch counts {counts} != expected {want}")
    return counts


def phase_train_parity(torch, cfg, sd):
    """Phase 8: one training loss and its gradients, card vs CPU, B = 2,
    gate noise 0 on both; the CPU's gates take the card's gate logits (as
    values; the gradient flows through its own gate), so a near-tie cannot
    route a token differently."""
    import copy
    from motioncraft_tpu_torch.apis import make_train_batch
    from motioncraft_tpu_torch.models.moe import CosineTopGate
    from motioncraft_tpu_torch.registry import build_architecture

    tcfg = copy.deepcopy(cfg)
    tcfg["model"]["ca_block_cfg"]["gate_noise"] = 0.0
    batch = make_train_batch(2, seed=SEED + 200, max_seq_len=cfg["model"]["max_seq_len"])
    g = torch.Generator().manual_seed(SEED + 8)
    draws = dict(t=torch.randint(0, 1000, (2,), generator=g),
                 noise=torch.randn(batch["motion"].shape, generator=g),
                 cond_type=torch.tensor([37, 4]).reshape(2, 1, 1))  # text on, text off
    class Pin(torch.autograd.Function):
        """The card's value, the identity's gradient."""

        @staticmethod
        def forward(ctx, out, value):
            return value.clone()

        @staticmethod
        def backward(ctx, grad):
            return grad, None

    card_logits, replayed, results = [], [], {}

    def record(mod, inp, out):
        card_logits.append(out.detach().cpu())

    def replay(mod, inp, out):
        want = card_logits[len(replayed)]
        replayed.append(out)
        return Pin.apply(out, want)

    for label, dev, hook in (("cuda", "cuda", record), ("cpu", "cpu", replay)):
        a = build_architecture(tcfg, device=dev)
        a.model.load_state_dict(sd, strict=True)
        handles = [m.register_forward_hook(hook) for m in a.modules()
                   if isinstance(m, CosineTopGate)]
        a.train()
        total, logs = a.loss(batch, **draws)
        total.backward()
        a.eval()
        for h in handles:
            h.remove()
        results[label] = ({k: float(logs[k].detach())
                           for k in ("loss", "recon_loss", "moe_route_loss")},
                          {n: p.grad.cpu() for n, p in a.model.named_parameters()
                           if p.grad is not None})
        del a
    check(len(replayed) == len(card_logits) > 0, "gate calls differ between devices")
    (lc, gc), (lp, gp) = results["cuda"], results["cpu"]
    for k in lc:
        diff, scale = abs(lc[k] - lp[k]), max(1.0, abs(lp[k]))
        print(f"[train-parity] {k}: card {lc[k]:.7f} CPU {lp[k]:.7f} diff {diff:.3e} "
              f"(tol {MODEL_REL_TOL} x {scale:.4g})")
        check(diff <= MODEL_REL_TOL * scale, f"training {k} card vs CPU: {diff}")
    check(set(gc) == set(gp) and gc, "the gradients cover other parameters on the two devices")
    worst = max(((float((gc[n] - gp[n]).abs().max()) / max(1.0, float(gp[n].abs().max())), n)
                 for n in gp))
    print(f"[train-parity] {len(gp)} gradient tensors; worst max|card - CPU| / max(1, "
          f"max|CPU|) = {worst[0]:.3e} at {worst[1]} (tol {GRAD_REL_TOL})")
    check(worst[0] <= GRAD_REL_TOL, f"gradient {worst[1]} card vs CPU: {worst[0]}")


def write_motionx_tree(root, n, T, seed):
    """A synthetic Motion-X tree in tools/make_tiny_data.py's layout:
    datasets/motionx/{motions/<name>.npy [T, 322], texts/<name>.txt, ann.txt,
    mean.npy, std.npy}."""
    import numpy as np

    rng = np.random.RandomState(seed)
    d = os.path.join(root, "datasets", "motionx")
    for sub in ("motions", "texts"):
        os.makedirs(os.path.join(d, sub), exist_ok=True)
    np.save(os.path.join(d, "mean.npy"), np.zeros(322, np.float32))
    np.save(os.path.join(d, "std.npy"), np.ones(322, np.float32))
    verbs = ["walks", "jumps", "waves", "dances", "kicks", "turns", "sits down",
             "runs in a circle", "crouches", "claps"]
    names = [f"clip{i:04d}" for i in range(n)]
    for i, name in enumerate(names):
        np.save(os.path.join(d, "motions", name + ".npy"),
                (rng.randn(T, 322) * 0.5).astype(np.float32))
        with open(os.path.join(d, "texts", name + ".txt"), "w") as f:
            f.write(f"a person {verbs[i % len(verbs)]} then {verbs[(7 * i + 3) % len(verbs)]}"
                    f" {i // len(verbs)} times\n")
    with open(os.path.join(d, "ann.txt"), "w") as f:
        f.write("\n".join(names) + "\n")


def load_torch_test():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "torch_test", os.path.join(ROOT, "tools", "torch_test.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_eval(torch, full_cfg, sd, dev="cuda", config=CONFIG, clips=EVAL_CLIPS):
    """Phase 9: the protocol evaluation of tools/torch_test.py on ``config``
    (whose model ``full_cfg`` is), with checks."""
    import tempfile

    import numpy as np
    from motioncraft_tpu_torch.eval.models import T2MContrastiveModel_SMPLX
    from motioncraft_tpu_torch.ops import launch_counts, reset_launch_counts
    from motioncraft_tpu_torch.registry import build_architecture
    from motioncraft_tpu_torch.utils.checkpoint import save_params
    from motioncraft_tpu_torch.utils.convert import to_jax_params

    torch_test = load_torch_test()
    cfg = full_cfg["model"]
    T = cfg["model"]["max_seq_len"]
    ev_cfg = {k: v for k, v in full_cfg["data"]["test"]["eval_cfg"]["evaluator_model"].items()
              if k not in ("type", "init_cfg")}
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        tree = os.path.join(tmp, "data")
        write_motionx_tree(tree, clips, T, SEED)
        mem = build_architecture(cfg, device=dev)
        mem.model.load_state_dict(sd, strict=True)
        params = os.path.join(tmp, "params.npz")
        save_params(params, mem.model)
        # a full-width evaluator, seeded, as the native .npz snapshot
        ev = T2MContrastiveModel_SMPLX(**ev_cfg, seed=SEED, device="cpu")
        evaluator = os.path.join(tmp, "evaluator.npz")
        save_params(evaluator, {"motion": {"params": to_jax_params(ev.motion_module.state_dict())},
                                "text": {"params": to_jax_params(ev.text_module.state_dict())}})
        n_ev = sum(p.numel() for m in (ev.motion_module, ev.text_module) for p in m.parameters())
        print(f"[eval] {clips} clips of {T} x 322, the flagship's weights "
              f"({os.path.getsize(params) / 2**20:.0f} MiB) and a {n_ev / 1e6:.1f} M-parameter "
              f"evaluator written in {time.perf_counter() - t0:.1f} s")
        opts = [f"data.test.data_prefix={tree}", "data.test.ann_file=ann.txt",
                "data.test.motion_dir=motions", "data.test.text_dir=texts",
                "data.test.eval_cfg.replication_times=1",
                "data.test.eval_cfg.evaluator_model.init_cfg="
                + repr(dict(type="Pretrained", checkpoint=evaluator))]
        argv = [config, os.path.join(tmp, "ddim"), "--device", dev, "--batch-size", str(BATCH),
                "--checkpoint", params, "--seed", str(SEED), "--cfg-options", *opts]
        reset_launch_counts()
        run = torch_test.main(argv)
        counts = launch_counts()
        out, loaded = run["out"], run["arch"]
        n = len(run["results"])
        metric = {k: v for k, v in out.items() if k not in ("flags", "protocol")}
        print(f"[eval] metrics {json.dumps(metric)}; flags {json.dumps(out['flags'])}")
        print(f"[eval] {n} samples: sampling {run['sample_s']:.3f} s "
              f"({n / run['sample_s']:.3f} samples/s), evaluation {run['eval_s']:.3f} s; "
              f"sampling share {run['sample_s'] / (run['sample_s'] + run['eval_s']):.3f}; "
              f"launches {counts}")
        check(n == clips and len(metric) == 12, f"{n} results, metrics {sorted(metric)}")
        check(all(np.isfinite(v) for v in metric.values()), f"non-finite metrics {metric}")
        batches = -(-clips // BATCH)
        steps, layers = loaded.diffusion_test.num_timesteps, loaded.model.num_layers
        want = {"moe_route": batches * layers * (steps + 1), "moe_positions": 0,
                "grouped_ffn": batches * layers * (steps + 1),
                "head_ffn": batches * layers * steps,
                "stma_linear_attention": batches * layers * steps,
                "fused_linear_attention": 0, "fused_expert_ffn": 0}
        check(counts == want, f"eval launch counts {counts} != expected {want}")

        # the loaded model against the in-memory one: one forward, same noise
        batch = requests(BATCH, SEED + 300, T)
        g = torch.Generator(device=dev).manual_seed(SEED + 9)
        x = torch.randn(batch["motion"].shape, generator=g, device=dev)
        ts = torch.full((BATCH,), 499, dtype=torch.long, device=dev)
        outs = []
        for a in (loaded, mem):
            with torch.no_grad():
                xf = a.encode_text(batch["text_ids"])
                outs.append(a.model(x, ts, motion_mask=a._tensor(batch["motion_mask"]),
                                    motion_length=a._tensor(batch["motion_length"]),
                                    xf_out=xf, text_feats=a.model.precompute_text_feats(xf)))
        diff = float((outs[0] - outs[1]).abs().max())
        print(f"[eval] loaded vs in-memory flagship forward, B={BATCH}: max abs diff {diff:.3e}"
              f" (bit for bit: {torch.equal(outs[0], outs[1])})")
        check(torch.equal(outs[0], outs[1]), "the loaded weights do not give the in-memory output")
        del mem, loaded, outs

        # the evaluator on the card against the CPU, one batch of results
        card_ev = run["dataset"].evaluator_model
        cpu_ev = T2MContrastiveModel_SMPLX(**ev_cfg, device="cpu",
                                           init_cfg=dict(type="Pretrained", checkpoint=evaluator))
        check(card_ev.device.type == dev and card_ev.pretrained_loaded, "evaluator not loaded")
        res = run["results"][:BATCH]
        motion = np.stack([r["pred_motion"] for r in res])
        lengths = np.array([int(r["motion_length"].reshape(-1)[0]) for r in res])
        texts = [r["text"] for r in res]
        for what, a, b in (("encode_motion", card_ev.encode_motion(motion, lengths),
                            cpu_ev.encode_motion(motion, lengths)),
                           ("encode_text", card_ev.encode_text(texts), cpu_ev.encode_text(texts))):
            scale = max(1.0, float(b.abs().max()))
            diff = float((a.cpu() - b).abs().max())
            print(f"[eval] evaluator {what} B={BATCH}: card vs CPU max abs diff {diff:.3e} "
                  f"(tol {MODEL_REL_TOL} x {scale:.4g})")
            check(diff <= MODEL_REL_TOL * scale, f"evaluator {what} card vs CPU: {diff}")
        del run

        gt_argv = [config, os.path.join(tmp, "gt"), "--device", dev, "--batch-size", str(BATCH),
                   "--seed", str(SEED), "--cfg-options", "model.inference_type=gt", *opts]
        gt = torch_test.main(gt_argv)
        fid = gt["out"]["FID (mean)"]
        print(f"[eval] GT mode: FID (mean) {fid:.3e} (tol {GT_FID_TOL}); evaluation "
              f"{gt['eval_s']:.3f} s")
        check(abs(fid) <= GT_FID_TOL, f"GT-mode FID {fid}")
    print(f"[eval] phase 9 took {time.perf_counter() - t_phase:.1f} s")
    return counts


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
        from motioncraft_tpu_torch.ops import _build
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

    full_cfg = Config.fromfile(CONFIG)
    cfg = full_cfg["model"]
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
    train_counts = phase_train(torch, full_cfg, arch)
    del arch
    phase_train_parity(torch, cfg, sd)
    eval_counts = phase_eval(torch, full_cfg, sd)

    for name, row in rows.items():
        # each kernel's count on the path it serves: sampling for K1-K3 and
        # K4's route, training for K4's positions, K5 and K6; and on the
        # evaluation path of phase 9
        row["launches"] = counts[name] or train_counts[name]
        row["eval_launches"] = eval_counts[name]
    print(json.dumps({"kernels": list(rows.values())}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
