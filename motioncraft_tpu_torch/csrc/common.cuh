// Shared pieces of the port's kernels: the C error hook every library
// exports, exact-erf GELU, the FFN tile that the grouped expert FFN
// (moe_ffn.cu), the per-head FFN (sffn.cu) and the slot expert FFN
// (expert_ffn.cu) run, and the linear-attention cell of the STMA attention
// (stma_attention.cu) and the generic linear attention (linear_attention.cu).
#pragma once

#include <cuda_runtime.h>

#include <cmath>

extern "C" const char* mc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

namespace mc {

// exact (erf) GELU, as torch's F.gelu and jax.nn.gelu(approximate=False)
__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.0f + erff(v * 0.70710678118654752440f));
}

constexpr int FFN_BM = 64;        // rows of one CTA tile
constexpr int FFN_HC = 32;        // hidden columns per chunk (one per lane)
constexpr int FFN_THREADS = 256;  // 8 warps; warp w owns tile rows 8w..8w+7
constexpr int FFN_RPW = FFN_BM / (FFN_THREADS / 32);

template <int D>
constexpr int ffn_smem_floats() {
  return FFN_BM * D + D * FFN_HC + FFN_HC * D + FFN_BM * FFN_HC;
}

// out[r, :] = gelu(x[r, :] @ w1 + b1) @ w2 (+ b2) for the rows r < rows of
// one tile.  x and out are row-major with row strides ldx / ldo floats (the
// per-head FFN reads one head's column slice of the interleaved [N, H*D]
// layout in place).  w1 is [D, F], w2 is [F, D], both row-major.  The hidden
// activation lives only in shared memory, FFN_HC columns at a time: each
// chunk's product with w2 is added into per-thread registers at once.
// Requires D % 32 == 0 (D <= 256), F % FFN_HC == 0, ldx, ldo % 4 == 0 and
// 16-byte aligned x, out, w1, w2.
template <int D>
__device__ __forceinline__ void ffn_tile(
    const float* __restrict__ x, long ldx, float* __restrict__ out, long ldo,
    int rows, const float* __restrict__ w1, const float* __restrict__ b1,
    const float* __restrict__ w2, const float* __restrict__ b2, int F,
    float* smem) {
  static_assert(D % 32 == 0 && D <= 256, "D must be a multiple of 32, <= 256");
  constexpr int ND = D / 32;  // output columns per lane: lane + 32 j
  float* xs = smem;                    // [FFN_BM][D]
  float* w1s = xs + FFN_BM * D;        // [D][FFN_HC]
  float* w2s = w1s + D * FFN_HC;       // [FFN_HC][D]
  float* hs = w2s + FFN_HC * D;        // [FFN_BM][FFN_HC]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r0 = warp * FFN_RPW;

  for (int i = tid; i < FFN_BM * D / 4; i += FFN_THREADS) {
    const int r = i / (D / 4), c4 = i % (D / 4);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < rows) v = *reinterpret_cast<const float4*>(x + r * ldx + c4 * 4);
    reinterpret_cast<float4*>(xs)[i] = v;
  }

  float acc[FFN_RPW][ND];
#pragma unroll
  for (int r = 0; r < FFN_RPW; ++r)
#pragma unroll
    for (int j = 0; j < ND; ++j) acc[r][j] = 0.f;

  for (int f0 = 0; f0 < F; f0 += FFN_HC) {
    __syncthreads();  // the previous chunk's reads of w1s/w2s/hs are done
    for (int i = tid; i < D * FFN_HC / 4; i += FFN_THREADS) {
      const int k = i / (FFN_HC / 4), c4 = i % (FFN_HC / 4);
      reinterpret_cast<float4*>(w1s)[i] =
          *reinterpret_cast<const float4*>(w1 + (long)k * F + f0 + c4 * 4);
    }
    for (int i = tid; i < FFN_HC * D / 4; i += FFN_THREADS)
      reinterpret_cast<float4*>(w2s)[i] =
          *reinterpret_cast<const float4*>(w2 + (long)f0 * D + i * 4);
    __syncthreads();

    // hidden chunk: lane owns hidden column f0 + lane of the warp's rows
    float h[FFN_RPW];
#pragma unroll
    for (int r = 0; r < FFN_RPW; ++r) h[r] = 0.f;
#pragma unroll 4
    for (int k = 0; k < D; k += 4) {
      const float a0 = w1s[(k + 0) * FFN_HC + lane];
      const float a1 = w1s[(k + 1) * FFN_HC + lane];
      const float a2 = w1s[(k + 2) * FFN_HC + lane];
      const float a3 = w1s[(k + 3) * FFN_HC + lane];
#pragma unroll
      for (int r = 0; r < FFN_RPW; ++r) {
        const float4 xv = *reinterpret_cast<const float4*>(xs + (r0 + r) * D + k);
        h[r] = fmaf(xv.x, a0, h[r]);
        h[r] = fmaf(xv.y, a1, h[r]);
        h[r] = fmaf(xv.z, a2, h[r]);
        h[r] = fmaf(xv.w, a3, h[r]);
      }
    }
    const float bias = b1[f0 + lane];
#pragma unroll
    for (int r = 0; r < FFN_RPW; ++r)
      hs[(r0 + r) * FFN_HC + lane] = gelu_erf(h[r] + bias);
    __syncwarp();  // a warp reads back only its own rows of hs

    // out rows of this warp += hidden chunk @ w2 chunk
#pragma unroll 2
    for (int k = 0; k < FFN_HC; k += 4) {
      float wv[4][ND];
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int j = 0; j < ND; ++j) wv[q][j] = w2s[(k + q) * D + lane + 32 * j];
#pragma unroll
      for (int r = 0; r < FFN_RPW; ++r) {
        const float4 hv = *reinterpret_cast<const float4*>(hs + (r0 + r) * FFN_HC + k);
#pragma unroll
        for (int j = 0; j < ND; ++j) {
          acc[r][j] = fmaf(hv.x, wv[0][j], acc[r][j]);
          acc[r][j] = fmaf(hv.y, wv[1][j], acc[r][j]);
          acc[r][j] = fmaf(hv.z, wv[2][j], acc[r][j]);
          acc[r][j] = fmaf(hv.w, wv[3][j], acc[r][j]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < FFN_RPW; ++r) {
    if (r0 + r >= rows) break;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      const int c = lane + 32 * j;
      out[(r0 + r) * ldo + c] = acc[r][j] + (b2 ? b2[c] : 0.f);
    }
  }
}

constexpr int LA_THREADS = 256;  // threads of a linear-attention cell
constexpr int LA_ROWS = 32;      // sequence rows staged per chunk

template <int D>
constexpr int la_smem_floats() {
  // A [D][D] + two staging tiles [LA_ROWS][D] + kmax/den [D] + partials
  return D * D + 2 * LA_ROWS * D + 2 * D + 2 * LA_THREADS;
}

// One (batch, head) cell of the linear attention, run by a whole CTA of
// LA_THREADS threads:
//   A[c, l]      = sum_n softmax_n(key(n, .))[c] * value(n, l)      (D x D)
//   out[t, l]    = sum_c softmax_c(q[t, :])[c] * A[c, l]            (t < T)
// key(n, c) and value(n, l) (n < N) are device functors: the callers apply
// their masks and join their sequences there.  q and out point at the
// cell's row 0, with row strides ldq and ldo floats.  The key softmax is per
// channel over the whole sequence (max, then sum of exp); A accumulates in
// registers over staged row chunks (thread (ty, tx) of a 16 x 16 grid owns
// A[ty + 16 i][tx + 16 j]), then lives in shared memory for the Q A product.
// smem holds la_smem_floats<D>() floats.  D in {16, 32, 64, 128}.
template <int D, class Key, class Value>
__device__ __forceinline__ void linear_attention_cell(
    int N, const Key& key, const Value& value, int T,
    const float* __restrict__ q, long ldq, float* __restrict__ out, long ldo,
    float* smem) {
  static_assert(D % 16 == 0 && D <= 128 && LA_THREADS % D == 0, "unsupported D");
  constexpr int P = LA_THREADS / D;   // row partitions of the key reduction
  constexpr int TI = D / 16;          // A micro-tile: rows ty + 16 i
  constexpr int OI = LA_ROWS / 16;    // output micro-tile rows ty + 16 i
  float* As = smem;                   // [D][D]
  float* s0 = As + D * D;             // [LA_ROWS][D]  keys, then queries
  float* s1 = s0 + LA_ROWS * D;       // [LA_ROWS][D]  values
  float* kmax = s1 + LA_ROWS * D;     // [D]
  float* den = kmax + D;              // [D]
  float* part = den + D;              // [2 * LA_THREADS]
  const int tid = threadIdx.x;

  // 1. per-channel max and sum of exp of the keys over the sequence
  {
    const int c = tid % D, p = tid / D;
    float m = -INFINITY;
    for (int n = p; n < N; n += P) m = fmaxf(m, key(n, c));
    part[tid] = m;
    __syncthreads();
    if (p == 0) {
      for (int k = 1; k < P; ++k) m = fmaxf(m, part[k * D + c]);
      kmax[c] = m;
    }
    __syncthreads();
    const float mx = kmax[c];
    float s = 0.f;
    for (int n = p; n < N; n += P) s += expf(key(n, c) - mx);
    part[LA_THREADS + tid] = s;
    __syncthreads();
    if (p == 0) {
      for (int k = 1; k < P; ++k) s += part[LA_THREADS + k * D + c];
      den[c] = s;
    }
    __syncthreads();
  }

  // 2. A = softmax(K)^T V over staged row chunks
  const int ty = tid / 16, tx = tid % 16;
  float acc[TI][TI];
#pragma unroll
  for (int i = 0; i < TI; ++i)
#pragma unroll
    for (int j = 0; j < TI; ++j) acc[i][j] = 0.f;
  for (int n0 = 0; n0 < N; n0 += LA_ROWS) {
    for (int i = tid; i < LA_ROWS * D; i += LA_THREADS) {
      const int r = i / D, c = i % D, n = n0 + r;
      float e = 0.f, v = 0.f;
      if (n < N) {
        e = expf(key(n, c) - kmax[c]) / den[c];
        v = value(n, c);
      }
      s0[i] = e;
      s1[i] = v;
    }
    __syncthreads();
    for (int r = 0; r < LA_ROWS; ++r) {
      float ev[TI], vv[TI];
#pragma unroll
      for (int i = 0; i < TI; ++i) ev[i] = s0[r * D + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TI; ++j) vv[j] = s1[r * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TI; ++i)
#pragma unroll
        for (int j = 0; j < TI; ++j) acc[i][j] = fmaf(ev[i], vv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < TI; ++i)
#pragma unroll
    for (int j = 0; j < TI; ++j) As[(ty + 16 * i) * D + tx + 16 * j] = acc[i][j];
  __syncthreads();

  // 3. per query row: channel softmax, then Q A
  const int warp = tid / 32, lane = tid % 32;
  for (int t0 = 0; t0 < T; t0 += LA_ROWS) {
    for (int i = tid; i < LA_ROWS * D; i += LA_THREADS) {
      const int r = i / D, c = i % D, t = t0 + r;
      s0[i] = t < T ? q[t * ldq + c] : 0.f;
    }
    __syncthreads();
    for (int r = warp; r < LA_ROWS; r += LA_THREADS / 32) {
      float m = -INFINITY;
      for (int c = lane; c < D; c += 32) m = fmaxf(m, s0[r * D + c]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
      float s = 0.f;
      for (int c = lane; c < D; c += 32) {
        const float e = expf(s0[r * D + c] - m);
        s0[r * D + c] = e;
        s += e;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      for (int c = lane; c < D; c += 32) s0[r * D + c] /= s;
    }
    __syncthreads();
    // thread (ty, tx) computes rows ty + 16 i, columns tx + 16 j
    float o[OI][TI];
#pragma unroll
    for (int i = 0; i < OI; ++i)
#pragma unroll
      for (int j = 0; j < TI; ++j) o[i][j] = 0.f;
    for (int c = 0; c < D; ++c) {
      float av[TI];
#pragma unroll
      for (int j = 0; j < TI; ++j) av[j] = As[c * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < OI; ++i) {
        const float qv = s0[(ty + 16 * i) * D + c];
#pragma unroll
        for (int j = 0; j < TI; ++j) o[i][j] = fmaf(qv, av[j], o[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < OI; ++i) {
      const int t = t0 + ty + 16 * i;
      if (t < T) {
#pragma unroll
        for (int j = 0; j < TI; ++j) out[t * ldo + tx + 16 * j] = o[i][j];
      }
    }
    __syncthreads();
  }
}

}  // namespace mc
