// Shared pieces of the port's kernels: the C error hook every library
// exports, exact-erf GELU, and the FFN tile that the grouped expert FFN
// (moe_ffn.cu) and the per-head FFN (sffn.cu) both run.
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

}  // namespace mc
