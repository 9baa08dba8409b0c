#!/usr/bin/env python3
"""Drive the PyTorch port's flagship text-to-motion sampling, training and
evaluation and its music-to-dance and speech-to-gesture long-form
evaluations on one NVIDIA GPU, and hold each of its CUDA kernels against its
plain PyTorch version.

Run from the root of the repository, on a machine with one card and the CUDA
toolkit:

    python3 chip_smoke.py

Phases; any failure exits non-zero:
  1. the card's name and power limit; build the kernels from
     motioncraft_tpu_torch/csrc/ with nvcc for sm_90a
  2. each kernel against its plain version on the same inputs, at every
     shape of phase 4 (K1-K4's route; K1 and K4 also at layer 0, whose
     motion MoE routes one CFG half), of phase 7 (K4's positions, K5, K6,
     at B = 32), of phase 10 (K1-K4 at the M2D shapes: a CFG-doubled
     batch of 2 x 120 frames for one recording and 8 x 120 for 4 in
     lockstep, and layer 0's half of each) and of phase 11 (the same at the
     S2G shapes, 2 x 64 and 8 x 64): max abs error against its
     tolerance (K4 exact in its
     integers, its route's gates within 1e-6; on every path a route case
     leaning to one expert must drop choices); the kernel's device time from
     torch.profiler
     (ms: its kernels' own durations, which a back-to-back timing of a
     kernel of a few microseconds does not give, the host issuing the calls
     slower than the card runs them), and from CUDA events the time of a
     back-to-back call (call_ms) and of the plain version;
     the least time the card could take (bound_ms: f32 products in 3xTF32
     on the tensor cores, which K1-K3, K5 and K6 run; K4's work on the CUDA
     cores; K1's work is the rows that carry a choice, not the padding of
     each expert's group), and the f32 bound on the CUDA cores as a second note
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
 10. the M2D long-form evaluation through tools/torch_m2d_test.py on
     configs/stmogen/m2d_finedance_0125b.py (the ControlNet over the
     flagship base, 2 control blocks, 163-d music): seeded fabricated
     weights saved and loaded back by --checkpoint, a synthetic FineDance
     tree of 4 cross-genre test tracks of 360 + 300 frames (3 windows of
     120 overlapping by 30 after the head trim), sampled at R = 1 and at
     --recording-batch 4: window 0 DDIM-50, each later window RePaint's
     harmonized DDIM (84 steps, 57 denoiser calls); per-window wall ms,
     windows per minute, the sampling share; K1-K4's launches equal the
     count the code implies; metrics.json carries tools/m2d_test.py's keys;
     windowed_sample_batch at R = 1 equals windowed_sample bit for bit on
     the card with the same draws, and neither waits for the device inside
     its window loop (CUDA sync debug mode); one ControlNet CFG forward
     (c on, 2 x 120) and one whole outpainted window at R = 1 and at R = 4
     (the condition encoded once for the batch, as windowed_sample_batch
     encodes a chunk's), card against CPU with the gate logits pinned as in
     phase 6 and the same draws
 11. the S2G long-form evaluation through tools/torch_s2g_test.py on
     configs/stmogen/s2g_beats2_0125b.py (the same ControlNet over the
     flagship base, its condition raw onset + amplitude at 16 kHz through
     the WavEncoder, out_dim 1536): seeded fabricated weights with sane
     BatchNorm statistics saved and loaded back by --checkpoint, a
     synthetic BEAT2 tree of 4 test recordings of 244 frames (4 windows of
     64 overlapping by 4) with onsets that fire, TextGrid words and a
     mean-velocity file, and an SMPL-X npz at the real sizes written here;
     sampled at R = 1 and at --recording-batch 4: per-window wall ms,
     windows per minute, the sampling share; K1-K4's launches equal the
     count the code implies, and the WavEncoder runs once a window (R = 1)
     or once a chunk (R = 4), never a denoiser step; metrics.json carries
     tools/s2g_test.py's keys with LBS joints and face vertices; the
     encoder's device time on one window against its f32 bound; the
     samplers at R = 1 agree and wait for the device only for their result
     (CUDA sync debug mode); the WavEncoder, one ControlNet CFG forward and
     one whole outpainted window card against CPU with the gate logits
     pinned
 12. one JSON line of the kernels' numbers, and last the device line

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
M2D_CONFIG = os.path.join(ROOT, "configs", "stmogen", "m2d_finedance_0125b.py")
S2G_CONFIG = os.path.join(ROOT, "configs", "stmogen", "s2g_beats2_0125b.py")
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
# phase 10: 4 FineDance test tracks of the cross-genre split, 360 frames
# trimmed + 300 kept: 3 windows of 120 overlapping by 30 (a window costs
# the same at any track length; 1290 frames, 14 windows, keep phase 10
# over two minutes)
M2D_TRACKS, M2D_FRAMES, M2D_REC_BATCH = ["063", "132", "143", "036"], 300, 4
# phase 11: 4 BEAT2 test recordings of 244 frames: 4 windows of 64
# overlapping by 4 (a window costs the same at any recording length)
S2G_RECORDINGS, S2G_FRAMES, S2G_REC_BATCH = 4, 244, 4
# the SMPL-X neutral body model's sizes: vertices, faces, shape and
# expression directions, pose-corrective directions
SMPLX_SIZES = dict(vertices=10475, faces=20908, shapedirs=400, posedirs=486)

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


class FfnArgs(tuple):
    """grouped_ffn's arguments, and ``kept``: how many of xs's rows carry a
    choice (the others pad each expert's group to BLOCK rows)."""

    def __new__(cls, args, kept):
        self = super().__new__(cls, args)
        self.kept = kept
        return self


def flagship_inputs(torch, cfg, dev, B2=2 * BATCH, T=None, training=True, layer0=False):
    """Inputs of every kernel at the shapes the phase-4 batches (K1, K2, K3,
    K4's route: B2 CFG-doubled rows of T frames) and, with ``training``, the
    phase-7 training steps (K4's positions, K5, K6) give them.  With
    ``layer0``, K1's and K4's route at layer 0, whose motion MoE routes
    one CFG half (cfg_layer0_dedup)."""
    from motioncraft_tpu_torch.ops.moe_ffn import BLOCK

    g = torch.Generator(device=dev).manual_seed(SEED)
    m = cfg["model"]
    ca = m["ca_block_cfg"]
    T = T or m["max_seq_len"]
    H, L = ca["num_heads"], ca["latent_dim"]
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
        ffn = FfnArgs((be, r(M, d), r(E, d, hid) / math.sqrt(d), r(E, hid) * 0.1,
                       r(E, hid, d) / math.sqrt(hid)), kept=int(fill.sum()))
        return (ids, E), ffn

    def route_case(n_tokens, skew=0.0):
        logits = r(n_tokens, E)
        logits[:, 0] += skew  # every token leans to expert 0: it overflows
        return logits, K, K * int(1.5 * ((n_tokens + E - 1) // E)), BLOCK

    if layer0:
        n = B2 // 2 * T * H
        return {"moe_route": [route_case(n), route_case(n, skew=3.0)],
                "grouped_ffn": [moe_case(n, L, 4 * L)[1]]}
    pos_motion, ffn_motion = moe_case(B2 * T * H, L, 4 * L)
    pos_text, ffn_text = moe_case(B2 * TXT, ca["text_latent_dim"], 4 * ca["text_latent_dim"])
    route = [route_case(B2 * T * H), route_case(B2 * T * H, skew=3.0), route_case(B2 * TXT)]
    lengths = torch.randint(min(40, T), T + 1, (B2,), generator=g, device=dev)
    mask = (torch.arange(T, device=dev)[None] < lengths[:, None]).float()[..., None]
    tcond = torch.cat([torch.ones(B2 // 2), torch.zeros(B2 // 2)]).to(dev).reshape(B2, 1, 1)
    sampling = {
        "moe_route": route,
        "grouped_ffn": [ffn_motion, ffn_text],
        "head_ffn": [(r(B2 * T, H * L), r(H, L, f) / math.sqrt(L), r(H, f) * 0.1,
                      r(H, f, L) / math.sqrt(f), r(H, L) * 0.1)],
        "stma_linear_attention": [(r(B2, T, H, 4 * L), r(B2, TXT, 2 * L), mask, tcond)],
    }
    if not training:
        return sampling

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
        "moe_positions": [pos_motion, pos_text],
        **sampling,
    }


def kernel_paths(torch, cfg, m2d_cfg, dev, s2g_cfg=None):
    """(path, inputs) for phase 2: the T2M shapes (with training's), the
    M2D ones and the S2G ones; R recordings in lockstep are a CFG-doubled
    batch of 2R x window frames (120 for M2D, 64 for S2G: the base blocks
    past layer 0 and the control blocks), and layer 0's motion MoE routes
    its first half."""
    paths = [("t2m", flagship_inputs(torch, cfg, dev)),
             ("t2m layer 0", flagship_inputs(torch, cfg, dev, training=False, layer0=True))]
    for tag, lf_cfg, batch in (("m2d", m2d_cfg, M2D_REC_BATCH),
                               ("s2g", s2g_cfg, S2G_REC_BATCH)):
        if lf_cfg is None:
            continue
        base = {"model": lf_cfg["model"]["model"]["base_model"]}
        win = lf_cfg["windowed"]["window"]
        for R in (1, batch):
            paths += [(f"{tag} R={R}", flagship_inputs(torch, base, dev, B2=2 * R, T=win,
                                                       training=False)),
                      (f"{tag} R={R} layer 0", flagship_inputs(
                          torch, base, dev, B2=2 * R, T=win, training=False, layer0=True))]
    return paths


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
        # the rows that carry a choice; the padding of each expert's group
        # to BLOCK rows is the kernel's layout, not the function's work
        be, xs, w1, b1, w2 = args
        n, d, hid = args.kept, xs.shape[1], w1.shape[2]
        nbytes = 4 * (2 * n * d + be.numel() + w1.numel() + b1.numel() + w2.numel())
        return 4 * n * d * hid, nbytes
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


def phase_kernels(torch, cfg, m2d_cfg, dev, s2g_cfg=None):
    """Phase 2: every kernel against its plain version, with times, at the
    T2M shapes and at the M2D and S2G ones."""
    from motioncraft_tpu_torch.ops import KERNELS
    from motioncraft_tpu_torch.ops.stma_attention import max_active_clusters

    print(f"[kernel] stma_linear_attention d=128: {max_active_clusters()} clusters of 4 "
          f"CTAs resident at once (cudaOccupancyMaxActiveClusters)")

    rows = {}
    for path, inputs in kernel_paths(torch, cfg, m2d_cfg, dev, s2g_cfg):
        for name, cases in inputs.items():
            for i, args in enumerate(cases):
                kernel_case(torch, rows, path, name, i, args, KERNELS[name])
    return rows


def kernel_case(torch, rows, path, name, i, args, fns):
    """One phase-2 case: check it, time it and add it to its kernel's row."""
    wrapper, plain = fns
    got, want = wrapper(*args), plain(*args)
    torch.cuda.synchronize()
    label = f"{name} {path} case {i}"
    if name == "moe_route":
        err = max(float((a - b).abs().max()) for a, b in zip(got, want)
                  if a.dtype == torch.float32)
        ints = [f for f, a, b in zip(got._fields, got, want)
                if a.dtype != torch.float32 and not torch.equal(a, b)]
        ok, tol = err <= GATE_ATOL and not ints, f"{GATE_ATOL}; integers exact"
        dropped = int((got.r == got.token_for_rank.numel()).sum())
        print(f"[kernel] {label}: {dropped} of {got.r.numel()} choices "
              f"dropped; integer outputs that differ: {ints}")
        check(dropped > 0 or i != 1, f"the skewed route case ({label}) dropped nothing")
    elif name == "moe_positions":
        err = max(float((a - b).abs().max()) for a, b in zip(got, want))
        ok, tol = err == 0, "exact"
    else:
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        ok, tol = err <= KERNEL_REL_TOL * scale, f"{KERNEL_REL_TOL} x {scale:.4g}"
    shapes = [tuple(a.shape) for a in args if hasattr(a, "shape")]
    kept = f"; {args.kept} of {shapes[1][0]} rows carry a choice" if name == "grouped_ffn" else ""
    print(f"[kernel] {label} {shapes}: max_abs_err {err:.3e} (tol {tol}){kept}")
    check(ok, f"{label} disagrees with its plain version: {err} (tol {tol})")
    ms = device_ms(torch, lambda: wrapper(*args))
    call_ms = time_ms(torch, lambda: wrapper(*args))
    plain_ms = time_ms(torch, lambda: plain(*args))
    flops, nbytes = kernel_work(name, args)
    if name in ("moe_positions", "moe_route"):  # on the CUDA cores only
        bound_ms, bound_by = f32_ms, f32_by = bound(flops, nbytes, F32_PEAK)
    else:  # f32 products: 3xTF32 on the tensor cores is the fastest exact way
        bound_ms, bound_by = bound(3 * flops, nbytes, TF32_PEAK)
        f32_ms, f32_by = bound(flops, nbytes, F32_PEAK)
    print(f"[kernel] {label}: {ms:.4f} ms on the device ({call_ms:.4f} ms a "
          f"back-to-back call), plain {plain_ms:.4f} ms, "
          f"bound {bound_ms:.4f} ms ({bound_by}, share {bound_ms / ms:.3f}); "
          f"f32 CUDA-core bound {f32_ms:.4f} ms ({f32_by}, share {f32_ms / ms:.3f})")
    case = {"path": path, "shape": shapes, "ms": ms, "call_ms": call_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "max_abs_err": err}
    if name in rows:  # the row's own numbers are the first (the T2M) case's
        rows[name]["cases"].append(case)
        return
    rows[name] = {"name": name, "route": "cuda", "source": SOURCES[name],
                  "replaces": PALLAS[name], "max_abs_err": err, "ms": ms,
                  "call_ms": call_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                  "bound_by": bound_by, "bound_f32_ms": f32_ms,
                  "bound_f32_by": f32_by, "library_ms": None, "cases": [case]}


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


def load_tool(name):
    """tools/<name>.py as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, "tools",
                                                                     name + ".py"))
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

    torch_test = load_tool("torch_test")
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


def write_finedance_tree(root, names, frames, seed):
    """A synthetic FineDance tree in tools/make_tiny_data.py's layout:
    datasets/finedance/{motion_fea163/<name>.npy [360 + frames, 319],
    music_npy/<name>.npy [360 + frames, 163], label_json/<name>.json}."""
    import numpy as np

    rng = np.random.RandomState(seed)
    d = os.path.join(root, "datasets", "finedance")
    for sub in ("motion_fea163", "music_npy", "label_json"):
        os.makedirs(os.path.join(d, sub), exist_ok=True)
    styles = ["Jazz", "Hiphop", "Breaking", "Locking", "Popping", "Dai"]
    for i, name in enumerate(names):
        n = 360 + frames
        np.save(os.path.join(d, "motion_fea163", name + ".npy"),
                (rng.randn(n, 319) * 0.3).astype(np.float32))
        np.save(os.path.join(d, "music_npy", name + ".npy"),
                rng.randn(n, 163).astype(np.float32))
        with open(os.path.join(d, "label_json", name + ".json"), "w") as f:
            json.dump({"name": f"song{name}", "style1": styles[i % len(styles)],
                       "style2": styles[(i + 2) % len(styles)]}, f)


def count_syncs(torch, fn):
    """(fn's result, the places where it waited for the device): CUDA sync
    debug mode warns at every synchronising call."""
    import warnings

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            out = fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return out, [f"{os.path.basename(w.filename)}:{w.lineno}" for w in seen
                 if "synchroniz" in str(w.message)]


def phase_m2d(torch, full_cfg, dev="cuda", config=M2D_CONFIG, tracks=M2D_TRACKS,
              frames=M2D_FRAMES):
    """Phase 10: the M2D long-form evaluation of tools/torch_m2d_test.py on
    ``config`` (whose content ``full_cfg`` is), at R = 1 and at R =
    M2D_REC_BATCH, with checks."""
    import tempfile

    import numpy as np
    from motioncraft_tpu_torch.apis.windowed import (_concat_parts, num_windows,
                                                     windowed_sample, windowed_sample_batch)
    from motioncraft_tpu_torch.diffusion import (RepaintConfig, generator_randn,
                                                 harmonize_schedule)
    from motioncraft_tpu_torch.ops import launch_counts, reset_launch_counts
    from motioncraft_tpu_torch.registry import build_architecture
    from motioncraft_tpu_torch.utils.checkpoint import save_params
    from motioncraft_tpu_torch.utils.convert import fabricate_state_dict

    tool = load_tool("torch_m2d_test")
    cfg = full_cfg["model"]
    window, pre = full_cfg["windowed"]["window"], full_cfg["windowed"]["pre_frames"]
    t_phase = time.perf_counter()
    arch = build_architecture(cfg, device=dev)
    sd = fabricate_state_dict(arch.model, seed=SEED)
    arch.model.load_state_dict(sd, strict=True)
    model = arch.model
    print(f"[m2d] {type(model).__name__}: {model.num_layers} base layers + "
          f"{model.copy_blocks_num} control blocks, "
          f"{sum(p.numel() for p in model.parameters()) / 1e6:.1f} M parameters")
    # per sampling call: the text MoE of every base and control layer once,
    # then per denoiser call each layer's motion MoE, SFFN and attention
    layers = model.num_layers + model.copy_blocks_num
    steps = arch.diffusion_test.num_timesteps
    rp = RepaintConfig(overlap_len=pre)
    outpaint_calls = sum(d for _, d in harmonize_schedule(steps, rp))
    wins = num_windows(frames, window, pre)
    calls = steps + (wins - 1) * outpaint_calls  # denoiser calls a track

    def want_counts(groups):
        per = {"moe_route": groups * layers * (calls + wins),
               "grouped_ffn": groups * layers * (calls + wins),
               "head_ffn": groups * layers * calls,
               "stma_linear_attention": groups * layers * calls}
        return {k: per.get(k, 0) for k in launch_counts()}

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        tree = os.path.join(tmp, "data")
        write_finedance_tree(tree, tracks, frames, SEED)
        params = os.path.join(tmp, "params.npz")
        save_params(params, model)
        print(f"[m2d] {len(tracks)} tracks of 360 + {frames} frames and the weights "
              f"({os.path.getsize(params) / 2**20:.0f} MiB) written in "
              f"{time.perf_counter() - t0:.1f} s; {wins} windows a track, "
              f"{calls} denoiser calls ({steps} + {wins - 1} x {outpaint_calls})")
        runs = {}
        for R in (1, M2D_REC_BATCH):
            argv = [config, "--device", dev, "--checkpoint", params, "--seed", str(SEED),
                    "--work-dir", os.path.join(tmp, f"R{R}"), "--recording-batch", str(R),
                    "--cfg-options", f"data.test.data_prefix={tree}"]
            reset_launch_counts()
            run = tool.main(argv)
            counts = launch_counts()
            out = run["out"]
            groups = -(-len(tracks) // R)
            n_win = run["windows"] * R  # track windows sampled
            print(f"[m2d] R={R}: {run['windows']} window batches ({n_win} track windows) in "
                  f"{run['sample_s']:.3f} s: {run['sample_s'] / run['windows'] * 1e3:.1f} ms "
                  f"a window batch, {n_win * 60 / run['sample_s']:.1f} windows per minute; "
                  f"evaluation {run['eval_s']:.3f} s, sampling share "
                  f"{run['sample_s'] / (run['sample_s'] + run['eval_s']):.3f}; launches {counts}")
            metric = {k: v for k, v in out.items() if k not in ("flags", "protocol")}
            print(f"[m2d] R={R} metrics {json.dumps(metric)}; flags {json.dumps(out['flags'])}")
            check(set(out) == {"FID_whole", "FID_hands", "Diversity", "protocol", "flags"}
                  and set(out["flags"]) == {"untrained_evaluator", "hash_tokenizer",
                                            "int8_weights", "step_cache"},
                  f"metrics.json keys {sorted(out)} / {sorted(out['flags'])}")
            check(all(np.isfinite(v) for v in metric.values()), f"non-finite metrics {metric}")
            check(len(run["preds"]) == len(tracks)
                  and all(p.shape == (frames, 322) and np.isfinite(p).all()
                          for p in run["preds"]), "predictions of the wrong shape or not finite")
            want = want_counts(groups)
            check(counts == want, f"R={R} launch counts {counts} != expected {want}")
            runs[R] = {"counts": counts, "sample_s": run["sample_s"], "eval_s": run["eval_s"],
                       "windows": run["windows"]}
            infos = run["infos"]
            del run

    # windowed_sample_batch at R = 1 against windowed_sample, same draws,
    # over the first windows of one track; neither waits for the device in
    # its window loop (the one wait is the copy of the result)
    arch.repaint_cfg = rp
    music = infos[0]["c"]
    short = window + 2 * (window - pre)
    mwb = tool.make_window_batch_fn(music, infos[0]["text"][0], window)
    kw = dict(window=window, pre_frames=pre, repaint=rp)
    outs = {}
    for label, fn in (("single", lambda r: windowed_sample(arch, mwb, total_frames=short,
                                                           randn=r, **kw)),
                      ("batch", lambda r: windowed_sample_batch(
                          arch, [mwb], [short], randn=r, precompute_condition=False,
                          **kw)[0])):
        randn = generator_randn(torch.Generator(device=dev).manual_seed(SEED + 11), dev)
        outs[label], syncs = count_syncs(torch, lambda: fn(randn))
        print(f"[m2d] {label} sampler, {num_windows(short, window, pre)} windows: "
              f"{len(syncs)} waits for the device {syncs}")
        check(len(syncs) <= 1, f"the {label} window loop waits for the device: {syncs}")
    check(np.array_equal(outs["single"], outs["batch"]),
          "windowed_sample_batch (R = 1) differs from windowed_sample")
    print("[m2d] windowed_sample_batch at R = 1 equals windowed_sample bit for bit")

    def window_batch(R, w):
        mwbs = [tool.make_window_batch_fn(i["c"], i["text"][0], window) for i in infos[:R]]
        start = w * (window - pre)
        return {k: torch.as_tensor(v) for k, v in
                _concat_parts([m(start, start + window) for m in mwbs]).items()}

    window_parity(torch, cfg, arch, sd, window_batch, window, pre, "m2d", (1, M2D_REC_BATCH))
    print(f"[m2d] phase 10 took {time.perf_counter() - t_phase:.1f} s")
    return runs


def window_parity(torch, cfg, arch, sd, window_batch, window, pre, tag, rec_batches,
                  extras=()):
    """Card vs CPU on a long-form path, the CPU's MoE gates fed the card's
    gate logits (as phase 6), both devices on the same draws: ``extras``
    ((what, fn(arch)) without gate calls, such as a condition encoder), one
    ControlNet CFG forward (c on, one recording), then one whole outpainted
    window (window 1 of its recordings, outpainted from a seeded previous
    window) for each R of ``rec_batches`` in lockstep, the condition of R > 1
    encoded once for the batch as windowed_sample_batch encodes a chunk's
    (``c_enc``).  ``window_batch(R, w)`` is window w of the first R
    recordings as CPU tensors."""
    from motioncraft_tpu_torch.diffusion import Outpainting, Replay, harmonize_schedule
    from motioncraft_tpu_torch.models.moe import CosineTopGate
    from motioncraft_tpu_torch.registry import build_architecture

    cpu = build_architecture(cfg, device="cpu")
    cpu.model.load_state_dict(sd, strict=True)
    cpu.repaint_cfg = arch.repaint_cfg
    g = torch.Generator().manual_seed(SEED + 12)
    card_logits, replayed = [], []

    def record(mod, inp, out):
        card_logits.append(out.cpu())

    def replay(mod, inp, out):
        want = card_logits[len(replayed)]
        replayed.append(out)
        return want

    def compare(what, fn, gates=True):
        """fn(arch) on the card, then on the CPU; the results within tol."""
        outs, pinned = {}, len(card_logits)
        for label, a, hook in (("cuda", arch, record), ("cpu", cpu, replay)):
            handles = [m.register_forward_hook(hook) for m in a.modules()
                       if isinstance(m, CosineTopGate)]
            try:
                with torch.no_grad():
                    outs[label] = fn(a).cpu()
            finally:
                for h in handles:
                    h.remove()
        check(len(replayed) == len(card_logits) > pinned or not gates,
              "gate calls differ between devices")
        got, want = outs["cuda"], outs["cpu"]
        check(got.shape == want.shape and torch.isfinite(got).all(), f"{what}: {got.shape}")
        scale = max(1.0, float(want.abs().max()))
        diff = float((got - want).abs().max())
        print(f"[{tag}-parity] {what}: card vs CPU max abs diff {diff:.3e} "
              f"(tol {MODEL_REL_TOL} x {scale:.4g}; {len(card_logits) - pinned} gate "
              f"calls pinned)")
        check(diff <= MODEL_REL_TOL * scale, f"{what} card vs CPU: {diff} > tol")

    for what, fn in extras:
        compare(what, fn, gates=False)
    batch = window_batch(1, 0)
    x = torch.randn(1, window, 322, generator=g)

    def forward(a):
        b = {k: v.to(a.device) for k, v in batch.items()}
        xf = a.encode_text(b["text_ids"])
        return a.model(x.to(a.device), torch.full((1,), 499, device=a.device),
                       motion_mask=b["motion_mask"], xf_out=xf,
                       text_feats=a.model.precompute_text_feats(xf), c=b["c"])

    compare(f"ControlNet CFG forward, 2 x {window}, c on", forward)

    # a window's draws: its noise, then one a step (57 outpainting and 27
    # re-noising ones at DDIM-50)
    steps = len(harmonize_schedule(arch.diffusion_test.num_timesteps, arch.repaint_cfg))
    mask = (torch.arange(window) < pre).reshape(1, window, 1)
    for R in rec_batches:
        batch_r = window_batch(R, 1)
        last = torch.randn(R, window, 322, generator=g)
        gt = torch.cat([last[:, -pre:], torch.zeros(R, window - pre, 322)], dim=1)
        draws = [torch.randn(R, window, 322, generator=g) for _ in range(1 + steps)]

        def outpaint(a):
            b = {k: v.to(a.device) for k, v in batch_r.items()}
            if R > 1:
                b["c_enc"] = a.model.encode_condition(b.pop("c"), window)
            source = Replay(draws, a.device)
            out = a.sample(b, randn=source, outpainting=Outpainting(
                mask=mask.to(a.device), gt=gt.to(a.device)))
            check(source.done(), f"the window took {source.used} of {len(draws)} draws")
            return out

        compare(f"outpainted window, R = {R} ({2 * R} x {window}), {steps} RePaint steps"
                + (", condition encoded for the batch" if R > 1 else ""), outpaint)


def write_smplx_npz(path, seed):
    """An SMPL-X body model npz at the neutral model's sizes (SMPLX_SIZES;
    55 joints, the SMPL-X tree, hand means), seeded: the real asset is not
    in the repository."""
    import numpy as np
    from motioncraft_tpu_torch.ops.fk import SMPLX_PARENTS

    rng = np.random.RandomState(seed)
    V, J = SMPLX_SIZES["vertices"], len(SMPLX_PARENTS)
    regressor = rng.rand(J, V)
    weights = rng.rand(V, J) ** 8  # each vertex led by a few joints
    np.savez(path,
             v_template=(rng.randn(V, 3) * 0.3).astype(np.float32),
             shapedirs=(rng.randn(V, 3, SMPLX_SIZES["shapedirs"]) * 0.01).astype(np.float32),
             posedirs=(rng.randn(V, 3, SMPLX_SIZES["posedirs"]) * 0.001).astype(np.float32),
             J_regressor=regressor / regressor.sum(1, keepdims=True),
             weights=weights / weights.sum(1, keepdims=True),
             kintree_table=np.stack([np.where(SMPLX_PARENTS < 0, 2 ** 32 - 1, SMPLX_PARENTS),
                                     np.arange(J)]).astype(np.int64),
             hands_meanl=rng.randn(45) * 0.1, hands_meanr=rng.randn(45) * 0.1,
             f=rng.randint(0, V, (SMPLX_SIZES["faces"], 3)).astype(np.int64))


def write_beat2_tree(root, n, frames, seed):
    """A synthetic BEAT2 tree in the layout data/beat2.py reads, n test
    recordings of speaker 2: smplxflame_30/<name>.npz (poses [frames, 165],
    expressions [frames, 100], trans, betas [300]), wave16k/<name>.wav (16
    kHz speech-like noise with a syllable burst every 0.2-0.4 s, so that
    onsets fire), textgrid/<name>.TextGrid (a word every 0.4 s),
    weights/mean_vel_smplxflame_30.npy, the split csv, mean/std stats and an
    SMPL-X npz; returns the path of its st_mogen_emage-schema yaml."""
    import numpy as np
    from scipy.io import wavfile

    rng = np.random.RandomState(seed)
    d = os.path.join(root, "beat2")
    for sub in ("smplxflame_30", "wave16k", "textgrid", "weights"):
        os.makedirs(os.path.join(d, sub), exist_ok=True)
    names = [f"2_scott_0_{i + 1}_{i + 1}" for i in range(n)]
    with open(os.path.join(d, "train_test_split.csv"), "w") as f:
        f.write("id,type\n" + "".join(f"{name},test\n" for name in names))
    vocab = ["so", "the", "point", "is", "that", "we", "really", "need", "to", "talk",
             "about", "gestures", "and", "speech", "today"]
    sr = 16000
    for i, name in enumerate(names):
        np.savez(os.path.join(d, "smplxflame_30", name + ".npz"),
                 poses=(rng.randn(frames, 165) * 0.2).astype(np.float32),
                 expressions=(rng.randn(frames, 100) * 0.3).astype(np.float32),
                 trans=(rng.randn(frames, 3) * 0.05).astype(np.float32),
                 betas=(rng.randn(300) * 0.5).astype(np.float32))
        n_samples = int(frames / 30 * sr)
        wav = rng.randn(n_samples) * 0.01
        at = int(rng.randint(1000, 4000))
        while at < n_samples:
            span = min(2400, n_samples - at)
            wav[at:at + span] += (rng.randn(span) * 0.4 * np.exp(-np.arange(span) / 600))
            at += int(rng.randint(3200, 6400))
        wavfile.write(os.path.join(d, "wave16k", name + ".wav"), sr,
                      (np.clip(wav, -1, 1) * 32767).astype(np.int16))
        seconds = frames / 30
        words = [(k * 0.4, min((k + 1) * 0.4, seconds), vocab[(i + k) % len(vocab)])
                 for k in range(int(seconds / 0.4))]
        with open(os.path.join(d, "textgrid", name + ".TextGrid"), "w") as f:
            f.write('File type = "ooTextFile"\nObject class = "TextGrid"\n\nxmin = 0\n'
                    f'xmax = {seconds}\ntiers? <exists>\nsize = 1\nitem []:\n'
                    f'    item [1]:\n        class = "IntervalTier"\n        name = "words"\n'
                    f'        xmin = 0\n        xmax = {seconds}\n'
                    f'        intervals: size = {len(words)}\n')
            for k, (a, b, w) in enumerate(words):
                f.write(f"        intervals [{k + 1}]:\n            xmin = {a}\n"
                        f'            xmax = {b}\n            text = "{w}"\n')
    np.save(os.path.join(d, "weights", "mean_vel_smplxflame_30.npy"),
            rng.uniform(0.3, 0.8, 55).astype(np.float32))
    np.save(os.path.join(root, "mean.npy"), np.zeros(322, np.float32))
    np.save(os.path.join(root, "std.npy"), np.ones(322, np.float32))
    smplx = os.path.join(root, "SMPLX_NEUTRAL_2020.npz")
    write_smplx_npz(smplx, seed)
    path = os.path.join(root, "beat2.yaml")
    with open(path, "w") as f:
        f.write(f"data_path: {d}/\npose_length: 64\nstride: 20\npre_frames: 4\n"
                "pose_fps: 30\naudio_sr: 16000\naudio_rep: onset+amplitude\n"
                "pose_rep: smplxflame_30\ntraining_speakers: [2]\n"
                f"smplx_model_path: {smplx}\nmean_pose_path: {root}/mean.npy\n"
                f"std_pose_path: {root}/std.npy\n")
    return path


def wav_encoder_flops(torch, encoder, wav):
    """The multiply-adds x 2 of ``encoder``'s convolutions on ``wav``,
    counted from each Conv1d's output shape."""
    flops = [0]

    def count(mod, inp, out):
        flops[0] += 2 * out.numel() * mod.in_channels * mod.kernel_size[0]

    handles = [m.register_forward_hook(count) for m in encoder.modules()
               if isinstance(m, torch.nn.Conv1d)]
    with torch.no_grad():
        encoder(wav)
    for h in handles:
        h.remove()
    return flops[0]


def phase_s2g(torch, full_cfg, dev="cuda", config=S2G_CONFIG, recordings=S2G_RECORDINGS,
              frames=S2G_FRAMES):
    """Phase 11: the S2G long-form evaluation of tools/torch_s2g_test.py on
    ``config`` (whose content ``full_cfg`` is), at R = 1 and at R =
    S2G_REC_BATCH, with checks."""
    import tempfile

    import numpy as np
    from motioncraft_tpu_torch.apis.windowed import (_concat_parts, num_windows,
                                                     windowed_sample, windowed_sample_batch)
    from motioncraft_tpu_torch.diffusion import (RepaintConfig, generator_randn,
                                                 harmonize_schedule)
    from motioncraft_tpu_torch.models.blocks import WavEncoder
    from motioncraft_tpu_torch.ops import launch_counts, reset_launch_counts
    from motioncraft_tpu_torch.registry import build_architecture
    from motioncraft_tpu_torch.utils.checkpoint import save_params
    from motioncraft_tpu_torch.utils.convert import fabricate_state_dict

    tool = load_tool("torch_s2g_test")
    cfg = full_cfg["model"]
    win_cfg = full_cfg["windowed"]
    window, pre = win_cfg["window"], win_cfg["pre_frames"]
    fps, spf = win_cfg["pose_fps"], win_cfg["audio_sr"] // win_cfg["pose_fps"]
    t_phase = time.perf_counter()
    arch = build_architecture(cfg, device=dev)
    sd = fabricate_state_dict(arch.model, seed=SEED)
    arch.model.load_state_dict(sd, strict=True)
    model = arch.model
    enc = model.condition_pre_encoder
    print(f"[s2g] {type(model).__name__}: {model.num_layers} base layers + "
          f"{model.copy_blocks_num} control blocks, "
          f"{sum(p.numel() for p in model.parameters()) / 1e6:.1f} M parameters "
          f"({sum(p.numel() for p in enc.parameters()) / 1e6:.1f} M in the WavEncoder, "
          f"{sum(1 for k in sd if k.endswith('running_var'))} BatchNorm statistics)")
    layers = model.num_layers + model.copy_blocks_num
    steps = arch.diffusion_test.num_timesteps
    rp = RepaintConfig(overlap_len=pre)
    outpaint_calls = sum(d for _, d in harmonize_schedule(steps, rp))
    wins = num_windows(frames, window, pre)
    calls = steps + (wins - 1) * outpaint_calls  # denoiser calls a recording

    def want_counts(groups):
        per = {"moe_route": groups * layers * (calls + wins),
               "grouped_ffn": groups * layers * (calls + wins),
               "head_ffn": groups * layers * calls,
               "stma_linear_attention": groups * layers * calls}
        return {k: per.get(k, 0) for k in launch_counts()}

    # the WavEncoder's calls: once a sampling call (R = 1: a window), or once
    # a chunk of windows for a lockstep batch, never a denoiser step
    enc_calls, encoder_forward = [0], WavEncoder.forward

    def counted_forward(self, wav):
        enc_calls[0] += 1
        return encoder_forward(self, wav)

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        yaml_path = write_beat2_tree(tmp, recordings, frames, SEED)
        params = os.path.join(tmp, "params.npz")
        save_params(params, model)
        print(f"[s2g] {recordings} recordings of {frames} frames, an SMPL-X npz "
              f"({SMPLX_SIZES['vertices']} vertices) and the weights "
              f"({os.path.getsize(params) / 2**20:.0f} MiB) written in "
              f"{time.perf_counter() - t0:.1f} s; {wins} windows a recording, "
              f"{calls} denoiser calls ({steps} + {wins - 1} x {outpaint_calls})")
        runs = {}
        for R in (1, S2G_REC_BATCH):
            argv = [config, "--device", dev, "--checkpoint", params, "--seed", str(SEED),
                    "--beats2-args", yaml_path, "--work-dir", os.path.join(tmp, f"R{R}"),
                    "--recording-batch", str(R)]
            reset_launch_counts()
            enc_calls[0] = 0
            WavEncoder.forward = counted_forward
            try:
                run = tool.main(argv)
            finally:
                WavEncoder.forward = encoder_forward
            counts = launch_counts()
            out = run["out"]
            groups = -(-recordings // R)
            n_win = run["windows"] * R  # recording windows sampled
            print(f"[s2g] R={R}: {run['windows']} window batches ({n_win} recording windows) "
                  f"in {run['sample_s']:.3f} s: {run['sample_s'] / run['windows'] * 1e3:.1f} ms "
                  f"a window batch, {n_win * 60 / run['sample_s']:.1f} windows per minute; "
                  f"metric stage {run['eval_s']:.3f} s, sampling share "
                  f"{run['sample_s'] / (run['sample_s'] + run['eval_s']):.3f}; WavEncoder "
                  f"calls {enc_calls[0]}; launches {counts}")
            metric = {k: v for k, v in out.items() if k not in ("flags", "protocol")}
            print(f"[s2g] R={R} metrics {json.dumps(metric)}; flags {json.dumps(out['flags'])}")
            check(set(out) == {"L1div", "BeatAlign", "facial_L2", "facial_LVD", "FID_whole",
                               "FID_hands", "protocol", "flags"}
                  and set(out["flags"]) == {"smplx_vertices", "mmae_asset",
                                            "untrained_evaluator", "hash_tokenizer",
                                            "int8_weights", "step_cache"},
                  f"metrics.json keys {sorted(out)} / {sorted(out['flags'])}")
            check(out["flags"]["smplx_vertices"] and out["flags"]["mmae_asset"]
                  and run["body_model"] is not None, "the SMPL-X route did not run")
            check(all(np.isfinite(v) for v in metric.values()), f"non-finite metrics {metric}")
            check(len(run["preds"]) == recordings
                  and all(p.shape == (frames, 322) and np.isfinite(p).all()
                          for p in run["preds"]), "predictions of the wrong shape or not finite")
            want = want_counts(groups)
            check(counts == want, f"R={R} launch counts {counts} != expected {want}")
            check(enc_calls[0] == (recordings * wins if R == 1 else groups),
                  f"R={R}: the WavEncoder ran {enc_calls[0]} times")
            runs[R] = {"counts": counts, "sample_s": run["sample_s"], "eval_s": run["eval_s"],
                       "windows": run["windows"], "encoder_calls": enc_calls[0]}
            recs = run["recordings"]
            del run

    def window_batch(R, w):
        mwbs = [tool.make_window_batch_fn(r, window, spf, fps) for r in recs[:R]]
        start = w * (window - pre)
        return {k: torch.as_tensor(v) for k, v in
                _concat_parts([m(start, start + window) for m in mwbs]).items()}

    # the encoder on one window: its device time against the f32 bound of
    # its convolutions (cuDNN, TF32 off)
    c1 = window_batch(1, 0)["c"].to(dev)
    with torch.no_grad():
        flops = wav_encoder_flops(torch, enc, c1)
        enc_ms = device_ms(torch, lambda: enc(c1), reps=5)
        enc_call_ms = time_ms(torch, lambda: enc(c1), reps=5)
    bound_ms, bound_by = bound(flops, 4 * (c1.numel() + window * enc.block5.conv1.out_channels
                                           + sum(p.numel() for p in enc.parameters())),
                               F32_PEAK)
    print(f"[s2g] WavEncoder on one window {tuple(c1.shape)}: {flops / 1e9:.2f} GFLOP, "
          f"{enc_ms:.3f} ms on the device ({enc_call_ms:.3f} ms a back-to-back call), "
          f"f32 bound {bound_ms:.3f} ms ({bound_by}, share {bound_ms / enc_ms:.3f})")

    # the samplers at R = 1 over the first windows of one recording, same
    # draws: windowed_sample_batch with the condition per window equals
    # windowed_sample bit for bit; encoded per chunk, within tolerance; none
    # waits for the device in its window loop (the one wait is the copy of
    # the result)
    arch.repaint_cfg = rp
    short = window + 2 * (window - pre)
    mwb = tool.make_window_batch_fn(recs[0], window, spf, fps)
    kw = dict(window=window, pre_frames=pre, repaint=rp)
    outs = {}
    for label, fn in (("single", lambda r: windowed_sample(arch, mwb, total_frames=short,
                                                           randn=r, **kw)),
                      ("batch", lambda r: windowed_sample_batch(
                          arch, [mwb], [short], randn=r, precompute_condition=False,
                          **kw)[0]),
                      ("batch encoded", lambda r: windowed_sample_batch(
                          arch, [mwb], [short], randn=r, **kw)[0])):
        randn = generator_randn(torch.Generator(device=dev).manual_seed(SEED + 11), dev)
        outs[label], syncs = count_syncs(torch, lambda: fn(randn))
        print(f"[s2g] {label} sampler, {num_windows(short, window, pre)} windows: "
              f"{len(syncs)} waits for the device {syncs}")
        check(len(syncs) <= 1, f"the {label} window loop waits for the device: {syncs}")
    check(np.array_equal(outs["single"], outs["batch"]),
          "windowed_sample_batch (R = 1) differs from windowed_sample")
    scale = max(1.0, float(np.abs(outs["single"]).max()))
    diff = float(np.abs(outs["batch encoded"] - outs["single"]).max())
    print(f"[s2g] windowed_sample_batch at R = 1 equals windowed_sample bit for bit; with "
          f"the condition encoded per chunk: max abs diff {diff:.3e} "
          f"(tol {MODEL_REL_TOL} x {scale:.4g})")
    check(diff <= MODEL_REL_TOL * scale, f"condition encoded per chunk: {diff}")

    def encode(a):
        return a.model.condition_pre_encoder(window_batch(1, 0)["c"].to(a.device))

    window_parity(torch, cfg, arch, sd, window_batch, window, pre, "s2g", (1,),
                  extras=[(f"WavEncoder, one window of {window * spf} samples", encode)])
    runs["encoder"] = {"flops": flops, "ms": enc_ms, "call_ms": enc_call_ms,
                       "bound_ms": bound_ms}
    print(f"[s2g] phase 11 took {time.perf_counter() - t_phase:.1f} s")
    return runs


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
    for path in (CONFIG, M2D_CONFIG, S2G_CONFIG):
        if not os.path.isfile(path):
            print(f"chip_smoke: missing {path}", file=sys.stderr)
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
    m2d_cfg = Config.fromfile(M2D_CONFIG)
    s2g_cfg = Config.fromfile(S2G_CONFIG)
    cfg = full_cfg["model"]
    dev = torch.device("cuda")
    rows = phase_kernels(torch, cfg, m2d_cfg, dev, s2g_cfg)

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
    m2d = phase_m2d(torch, m2d_cfg)
    s2g = phase_s2g(torch, s2g_cfg)

    for name, row in rows.items():
        # each kernel's count on the path it serves: sampling for K1-K3 and
        # K4's route, training for K4's positions, K5 and K6; and on the
        # evaluation paths of phases 9, 10 and 11 (R = 1, then R = 4)
        row["launches"] = counts[name] or train_counts[name]
        row["eval_launches"] = eval_counts[name]
        row["m2d_launches"] = [m2d[R]["counts"][name] for R in sorted(m2d)]
        row["s2g_launches"] = [s2g[R]["counts"][name] for R in (1, S2G_REC_BATCH)]
    print(json.dumps({"kernels": list(rows.values())}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
