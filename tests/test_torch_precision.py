"""The arithmetic of the redesigned CUDA kernels, K1/K2/K6 (one FFN tile)
and K3/K5 (one attention cell), transcribed into numpy and held, on the CPU,
against the references they must meet.

(a) K1 runs both of its products in 3xTF32 on the tensor cores: each f32
    operand v is split into hi = tf32(v) and lo = tf32(v - hi), TF32 being
    f32 rounded to 10 explicit mantissa bits (round to nearest, ties away,
    as ``cvt.rna.tf32.f32``), and the products lo*hi + hi*lo + hi*hi are
    summed in f32, one m16n8k8 step (8 products) at a time.  It must hold
    1e-5 x max |product| against an f64 product; one TF32 pass must not.
(b) K3 and K5 split the key softmax over the G CTAs of a cluster, each
    walking its row chunk in steps of 32 rows with an online per-channel
    max and sum, and merge the chunks as m = max m_j, den = sum exp(m_j - m)
    den_j, A = sum exp(m_j - m) A_j / den.  It must equal the JAX package's
    STMA reference and the port's plain version to 1e-5 x max |reference|,
    for every cluster size, with masked rows, text off and chunks made only
    of masked keys.
(c) K1, K2 and K6 run one FFN tile (csrc/common.cuh ffn_tile_tc): the first
    product in 3xTF32 summed in K blocks of 64, the hidden in chunks of HC
    columns (a part-filled last chunk zero-filled), each chunk's product
    with w2 summed apart and added to the output, then b2 (K2, K6; none for
    K1); rows past a ragged edge are zeros.  It must hold 1e-5 x max |out|
    against an f64 reference for each caller's tile.

The CUDA kernels themselves are held against the plain versions on the card
by tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from motioncraft_tpu.ops.pallas_stma_attention import stma_linear_attention_reference
from motioncraft_tpu_torch.ops.stma_attention import stma_linear_attention_plain

REL = 1e-5
NEG = np.float32(-1e6)
STEP_ROWS = 32  # key/value rows a CTA stages per step (csrc/common.cuh LA_RS)


def tf32(x):
    """f32 -> TF32 (10 explicit mantissa bits), round to nearest, ties away,
    by integer masking of the f32 bits."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def tf32_matmul(a, b, passes):
    """a [M, K] @ b [K, N] as the tensor cores run it: TF32 operands (split
    into hi and lo for passes == 3), exact products, f32 sums over k-steps
    of 8 in the kernel's order (lo*hi, hi*lo, hi*hi per step)."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    a_hi, b_hi = tf32(a), tf32(b)
    a_lo, b_lo = tf32(a - a_hi), tf32(b - b_hi)
    terms = [(a_hi, b_hi)] if passes == 1 else [(a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi)]
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for k0 in range(0, a.shape[1], 8):
        for x, y in terms:
            for k in range(k0, min(k0 + 8, a.shape[1])):
                # a TF32 x TF32 product is exact in f32 (11 x 11 bits)
                acc = (acc + x[:, k, None] * y[None, k, :]).astype(np.float32)
    return acc


def test_tf32_rounds_to_nearest_ties_away():
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)  # one TF32 ulp at 1
    x = np.array([one + ulp * 0.49, one + ulp * 0.5, -(one + ulp * 0.5),
                  one + ulp * 0.51, np.float32(3.0)], np.float32)
    np.testing.assert_array_equal(tf32(x), [one, one + ulp, -(one + ulp), one + ulp, 3.0])
    v = np.random.RandomState(0).randn(1000).astype(np.float32)
    hi = tf32(v)
    assert np.all(np.abs(v - hi) <= np.abs(v) * 2.0 ** -11)
    # hi + lo keeps about 22 bits
    assert np.all(np.abs(v - (hi + tf32(v - hi))) <= np.abs(v) * 2.0 ** -21)


@pytest.mark.parametrize("K", [128, 512])
def test_3xtf32_product_holds_f32_tolerance(K):
    rng = np.random.RandomState(K)
    a = rng.randn(32, K).astype(np.float32)
    b = (rng.randn(K, 24) / np.sqrt(K)).astype(np.float32)
    want = a.astype(np.float64) @ b.astype(np.float64)
    scale = float(np.abs(want).max())
    err3 = float(np.abs(tf32_matmul(a, b, 3) - want).max())
    err1 = float(np.abs(tf32_matmul(a, b, 1) - want).max())
    assert err3 <= REL * scale, (err3, scale)
    assert err1 > REL * scale, (err1, scale)  # why the kernel takes three passes
    assert err3 < err1 / 100


def chunked_cell(key, value, query, G):
    """One (batch, head) cell the way the cluster computes it: key, value
    [N, d] (masked), query [T, d] -> [T, d]."""
    N, d = key.shape
    parts = []
    for r in range(G):
        lo, hi = N * r // G, N * (r + 1) // G
        m = np.full(d, -np.inf, np.float32)
        den = np.zeros(d, np.float32)
        acc = np.zeros((d, d), np.float32)
        for n0 in range(lo, hi, STEP_ROWS):
            k = key[n0:min(n0 + STEP_ROWS, hi)]
            now = np.maximum(m, k.max(axis=0))
            with np.errstate(invalid="ignore"):
                rescale = np.where(m == -np.inf, np.float32(0), np.exp(m - now))
            e = np.exp(k - now).astype(np.float32)
            den = (den * rescale + e.sum(axis=0)).astype(np.float32)
            acc = (acc * rescale[:, None] + e.T @ value[n0:n0 + len(k)]).astype(np.float32)
            m = now
        parts.append((m, den, acc))
    m = np.max([p[0] for p in parts], axis=0)
    total = sum(np.where(mj == -np.inf, np.float32(0), np.exp(mj - m)) * dj
                for mj, dj, _ in parts)
    A = np.zeros((d, d), np.float32)
    for mj, _, aj in parts:
        coef = np.where(mj == -np.inf, np.float32(0), np.exp(mj - m)) / total
        A = (A + coef[:, None].astype(np.float32) * aj).astype(np.float32)
    q = np.exp(query - query.max(axis=1, keepdims=True))
    q = q / q.sum(axis=1, keepdims=True)
    return (q @ A).astype(np.float32)


def chunked_stma(motion_feat, text_feat, src_mask, text_cond, G):
    B, T, H, d4 = motion_feat.shape
    d = d4 // 4
    out = np.zeros((B, T, H, d), np.float32)
    for b in range(B):
        tc, mask = text_cond[b, 0, 0], src_mask[b, :, 0][:, None]
        for h in range(H):
            mot = motion_feat[b, :, h]
            key = np.concatenate([text_feat[b, :, :d] + (1 - tc) * NEG,
                                  mot[:, d:2 * d] + (1 - mask) * NEG]).astype(np.float32)
            value = np.concatenate([text_feat[b, :, d:] * tc,
                                    mot[:, 2 * d:3 * d] * mask]).astype(np.float32)
            out[b, :, h] = chunked_cell(key, value, mot[:, 3 * d:], G)
    return out


def stma_inputs(kind, B=3, T=80, H=2, d=16, TXT=7, seed=0):
    rng = np.random.RandomState(seed)
    mask = np.ones((B, T, 1), np.float32)
    tcond = np.ones((B, 1, 1), np.float32)
    if kind == "lengths":  # masked rows past each length; text off for one
        for b, n in enumerate([T, T // 2, 1]):
            mask[b, n:] = 0
        tcond[2] = 0
    elif kind == "text_off":
        tcond[:] = 0
    elif kind == "masked_chunk":  # the last chunks hold only masked keys
        mask[:, TXT:] = 0
        tcond[1] = 0
    return (rng.randn(B, T, H, 4 * d).astype(np.float32),
            rng.randn(B, TXT, 2 * d).astype(np.float32), mask, tcond)


@pytest.mark.parametrize("kind", ["lengths", "text_off", "masked_chunk"])
@pytest.mark.parametrize("G", [1, 2, 4, 8])
def test_chunked_key_softmax_merge(G, kind):
    args = stma_inputs(kind)
    got = chunked_stma(*args, G)
    ref = np.asarray(stma_linear_attention_reference(*(jnp.asarray(a) for a in args)))
    plain = stma_linear_attention_plain(*(torch.from_numpy(a) for a in args)).numpy()
    scale = float(np.abs(ref).max())
    np.testing.assert_allclose(got, ref, rtol=0, atol=REL * scale)
    np.testing.assert_allclose(plain, ref, rtol=0, atol=REL * scale)


def ffn_tile(x, w1, b1, w2, b2, HC, BM):
    """One FFN tile the way a CTA computes it: x [rows, D] (zero-filled to BM
    rows), w1 [D, F], w2 [F, D], b2 [D] or None -> [rows, D]."""
    rows, D = x.shape
    Fh = w1.shape[1]
    xt = np.zeros((BM, D), np.float32)
    xt[:rows] = x
    acc = np.zeros((BM, D), np.float32)
    for f0 in range(0, Fh, HC):
        n = min(HC, Fh - f0)  # a chunk past F is zero-filled
        w1c, b1c, w2c = (np.zeros((D, HC), np.float32), np.zeros(HC, np.float32),
                         np.zeros((HC, D), np.float32))
        w1c[:, :n], b1c[:n], w2c[:n] = w1[:, f0:f0 + n], b1[f0:f0 + n], w2[f0:f0 + n]
        h = np.zeros((BM, HC), np.float32)
        for k0 in range(0, D, 64):
            h = (h + tf32_matmul(xt[:, k0:k0 + 64], w1c[k0:k0 + 64], 3)).astype(np.float32)
        h = F.gelu(torch.from_numpy((h + b1c).astype(np.float32))).numpy()
        acc = (acc + tf32_matmul(h, w2c, 3)).astype(np.float32)
    if b2 is not None:
        acc = (acc + b2).astype(np.float32)
    return acc[:rows]


# each caller's tile: K1 full tiles without b2; K2 a ragged last tile with
# b2; K6 an expert with fewer slots than one warp's 16 rows, with b2
CALLERS = {"K1": (0, False), "K2": (5, True), "K6": (None, True)}


@pytest.mark.parametrize("D,Fh", [(128, 512), (256, 1024), (64, 96)])
@pytest.mark.parametrize("caller", list(CALLERS))
def test_ffn_tile_holds_f32_tolerance(caller, D, Fh):
    BM, HC = (128, 64) if D <= 128 else (64, 32)  # csrc/common.cuh TcFfn
    short, with_b2 = CALLERS[caller]
    rows = 9 if short is None else BM - short
    rng = np.random.RandomState(D + Fh + rows)
    x = rng.randn(rows, D).astype(np.float32)
    w1 = (rng.randn(D, Fh) / np.sqrt(D)).astype(np.float32)
    b1 = (rng.randn(Fh) * 0.1).astype(np.float32)
    w2 = (rng.randn(Fh, D) / np.sqrt(Fh)).astype(np.float32)
    b2 = (rng.randn(D) * 0.1).astype(np.float32) if with_b2 else None
    hd = torch.from_numpy(x.astype(np.float64) @ w1 + b1)
    want = F.gelu(hd).numpy() @ w2.astype(np.float64) + (0.0 if b2 is None else b2)
    got = ffn_tile(x, w1, b1, w2, b2, HC, BM)
    err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
    assert got.shape == want.shape
    assert err <= REL * scale, (err, scale)
