// Shared pieces of the port's kernels: the C error hook every library
// exports, exact-erf GELU, the 3xTF32 tensor-core FFN tile that the grouped
// expert FFN (moe_ffn.cu), the per-head FFN (sffn.cu) and the slot expert
// FFN (expert_ffn.cu) run, its bf16 counterpart for bf16 inference (K1 and
// K2), and the split-sequence linear-attention cell of the STMA attention
// (stma_attention.cu, f32 or bf16 storage) and the generic linear attention
// (linear_attention.cu) with its thread-block cluster launch.
//
// Exact f32 does not rule out the tensor cores.  3xTF32 splits each f32
// operand v into hi = tf32(v) and lo = tf32(v - hi) (round to nearest, ties
// away) and sums lo*hi + hi*lo + hi*hi in f32 on the TF32 tensor cores; the
// dropped lo*lo term and the rounding of lo leave about 22 of f32's 24
// mantissa bits, against 11 for one TF32 pass (tests/test_torch_precision.py
// transcribes the split and holds it against an f64 product).
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <type_traits>

extern "C" const char* mc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

namespace mc {

// exact (erf) GELU, as torch's F.gelu and jax.nn.gelu(approximate=False)
__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.0f + erff(v * 0.70710678118654752440f));
}

// ---------------------------------------------------------------------------
// 3xTF32 on the tensor cores, and asynchronous copies

// an f32 value as the TF32 operand pair (hi, lo) of mma.sync: hi + lo equals
// v to about 22 mantissa bits.  hi is cvt.rna.tf32.f32 written as integer
// operations (add half a TF32 ulp to the magnitude, clear the 13 low bits:
// round to nearest, ties away), which run on the integer pipes rather than
// the conversion unit.  lo is v - hi with
// the half ulp added and the low bits left for mma.sync, which ignores them:
// the same rounding.
struct Tf32x2 {
  unsigned hi, lo;
};

__device__ __forceinline__ Tf32x2 split_tf32(float v) {
  Tf32x2 s;
  s.hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  s.lo = __float_as_uint(v - __uint_as_float(s.hi)) + 0x1000u;
  return s;
}

// c += a b for one m16n8k8 TF32 tile: a holds the A fragment (rows g, g+8;
// columns t, t+4 of the lane's group g = lane / 4 and t = lane % 4), b0/b1
// the B fragment (rows t, t+4; column g), c the f32 C fragment (rows g, g+8;
// columns 2t, 2t+1)
__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c[c0 + n] += a b[n] in 3xTF32 for N tiles that share one A fragment: the
// two cross terms first, then hi * hi, each pass over all N tiles so that
// consecutive mma.sync instructions never wait on one another's accumulator
template <int N, int M>
__device__ __forceinline__ void mma_3xtf32(float (&c)[M][4], int c0,
                                           const unsigned (&ahi)[4],
                                           const unsigned (&alo)[4],
                                           const Tf32x2 (&b0)[N], const Tf32x2 (&b1)[N]) {
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(c[c0 + n], alo, b0[n].hi, b1[n].hi);
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(c[c0 + n], ahi, b0[n].lo, b1[n].lo);
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(c[c0 + n], ahi, b0[n].hi, b1[n].hi);
}

__device__ __forceinline__ void split_fragment(const float (&v)[4], unsigned (&hi)[4],
                                               unsigned (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const Tf32x2 s = split_tf32(v[i]);
    hi[i] = s.hi;
    lo[i] = s.lo;
  }
}

// 16 bytes from device to shared memory without registers; zeros when !full
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool full) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s), "l"(src),
               "r"(full ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(PENDING) : "memory");
}

// ---------------------------------------------------------------------------
// The tensor-core FFN tile of K1, K2 and K6.  A CTA of WARPS warps owns
// BM = 16 WARPS rows; warp w owns rows 16w..16w+15 and all D output columns,
// in registers (D / 2 f32 per thread).  w1/w2 stream through shared memory
// HC hidden columns at a time, double-buffered with cp.async so chunk j+1
// loads while chunk j computes.  Row pitches are padded so the fragment
// loads hit 32 distinct banks (A: pitch = 4 mod 32, B: 8 mod 32).
template <int D>
struct TcFfn {
  static constexpr int WARPS = D <= 128 ? 8 : 4;  // D = 256: 128 accumulators
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int BM = 16 * WARPS;
  static constexpr int HC = D <= 128 ? 64 : 32;
  static constexpr int LDX = D + 4, LDW1 = HC + 8, LDW2 = D + 8;
  static constexpr int STAGE = D * LDW1 + HC * LDW2;  // one chunk of w1 and w2
  static constexpr int SMEM_FLOATS = BM * LDX + 2 * STAGE;
};

// out[r, :] = gelu(x[r, :] @ w1 + b1) @ w2 (+ b2) for the rows r < rows of
// one tile.  x and out are row-major with row strides ldx and ldo floats (K2
// reads and writes one head's D columns of the interleaved [N, H*D] matrix
// in place); w1 is [D, F], w2 [F, D].  Both products run in 3xTF32 on
// mma.sync: operands are split in registers as their fragments are read, so
// shared memory holds plain f32 once.  The hidden chunk stays in registers:
// its C fragments are bias-added and GELU'd in place, then permuted into
// A-fragment order with shuffles for the second product.  A chunk past F
// (F % HC != 0) is zero-filled, which adds gelu(0) * 0 = 0; b2 is added in
// the epilogue.  Rows past `rows` load as zeros from row 0's address and are
// never stored; a warp whose 16 rows all lie past it skips its products but
// keeps to every barrier and copy group.
//
// Partial sums: the tensor cores add each m16n8k8 result into C with
// truncation, an error of up to one ulp of C that leans toward zero, so
// adding 3 F / 8 products straight into the output accumulator loses about
// log2(3 F / 8) bits, past 1e-5 x max |out| at D = 256, F = 1024.  So each
// 64-column output slice (32 at D = 256) of a hidden chunk, and each 64-deep
// K block of the first product, is summed from zero in its own fragment and
// then added to the running sum with a rounded f32 add.
//
// Requires D % 32 == 0, D <= 256, 1 <= rows <= BM, F % 4 == 0,
// ldx % 4 == ldo % 4 == 0 and 16-byte aligned x, out, w1, w2 (b2 may be
// null).  smem holds TcFfn<D>::SMEM_FLOATS floats.
template <int D>
__device__ __forceinline__ void ffn_tile_tc(
    const float* __restrict__ x, long ldx, float* __restrict__ out, long ldo,
    int rows, const float* __restrict__ w1, const float* __restrict__ b1,
    const float* __restrict__ w2, const float* __restrict__ b2, int F, float* smem) {
  using C = TcFfn<D>;
  static_assert(D % 32 == 0 && D <= 256, "D must be a multiple of 32, <= 256");
  constexpr int HC = C::HC, NH = HC / 8, NO = D / 8;
  // n-tiles of one output slice: 8, and 4 at D = 256, whose 128 output
  // accumulators leave no room for a 32-register partial
  constexpr int NS = NO < 8 ? NO : (D > 128 ? 4 : 8);
  constexpr unsigned FULL = 0xffffffffu;
  float* xs = smem;                         // [BM][LDX]
  float* stages = xs + C::BM * C::LDX;      // 2 x ([D][LDW1] w1, [HC][LDW2] w2)
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int chunks = (F + HC - 1) / HC;
  const bool active = warp * 16 < rows;

  auto load_weights = [&](int chunk) {
    float* w1s = stages + (chunk & 1) * C::STAGE;
    float* w2s = w1s + D * C::LDW1;
    const int f0 = chunk * HC;
    for (int i = tid; i < D * HC / 4; i += C::THREADS) {
      const int k = i / (HC / 4), j = i % (HC / 4) * 4;
      const bool in = f0 + j < F;
      cp_async16(w1s + k * C::LDW1 + j, in ? w1 + (long)k * F + f0 + j : w1, in);
    }
    for (int i = tid; i < HC * D / 4; i += C::THREADS) {
      const int j = i / (D / 4), c = i % (D / 4) * 4;
      const bool in = f0 + j < F;
      cp_async16(w2s + j * C::LDW2 + c, in ? w2 + (long)(f0 + j) * D + c : w2, in);
    }
  };

  for (int i = tid; i < C::BM * D / 4; i += C::THREADS) {
    const int r = i / (D / 4), c = i % (D / 4) * 4;
    const bool in = r < rows;  // a row past the edge reads from row 0, a valid address
    cp_async16(xs + r * C::LDX + c, in ? x + r * ldx + c : x, in);
  }
  load_weights(0);
  cp_async_commit();

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  const float* xw = xs + warp * 16 * C::LDX + g * C::LDX + t;  // A fragment base
  // lanes that hold columns t and t + 4 of a hidden C fragment
  const int src0 = (lane & ~3) | (t >> 1), src1 = src0 + 2;
  const bool odd = t & 1;

  for (int chunk = 0; chunk < chunks; ++chunk) {
    if (chunk + 1 < chunks) {
      load_weights(chunk + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* w1s = stages + (chunk & 1) * C::STAGE;
    const float* w2s = w1s + D * C::LDW1;

    if (active) {  // a warp of rows past the edge only keeps to the barriers
      // hidden chunk [16, HC] of the warp's rows: x @ w1[:, f0:f0+HC], summed
      // in K blocks of 64 (see the note on partial sums above)
      float h[NH][4];
#pragma unroll
      for (int n = 0; n < NH; ++n) h[n][0] = h[n][1] = h[n][2] = h[n][3] = 0.f;
      for (int k0 = 0; k0 < D; k0 += 64) {
        float hp[NH][4];
#pragma unroll
        for (int n = 0; n < NH; ++n) hp[n][0] = hp[n][1] = hp[n][2] = hp[n][3] = 0.f;
#pragma unroll 2
        for (int k = k0; k < k0 + 64 && k < D; k += 8) {
          const float* xa = xw + k;
          const float av[4] = {xa[0], xa[8 * C::LDX], xa[4], xa[8 * C::LDX + 4]};
          unsigned ahi[4], alo[4];
          split_fragment(av, ahi, alo);
          const float* wb = w1s + (k + t) * C::LDW1 + g;
          Tf32x2 b0[NH], b1[NH];
#pragma unroll
          for (int n = 0; n < NH; ++n) {
            b0[n] = split_tf32(wb[8 * n]);
            b1[n] = split_tf32(wb[4 * C::LDW1 + 8 * n]);
          }
          mma_3xtf32(hp, 0, ahi, alo, b0, b1);
        }
#pragma unroll
        for (int n = 0; n < NH; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) h[n][i] += hp[n][i];
      }

      // bias and GELU on the C fragments (columns f0 + 8n + 2t, + 1)
      const int f0 = chunk * HC;
#pragma unroll
      for (int n = 0; n < NH; ++n) {
        const int f = f0 + 8 * n + 2 * t;
        const float bb0 = f < F ? b1[f] : 0.f, bb1 = f + 1 < F ? b1[f + 1] : 0.f;
        h[n][0] = gelu_erf(h[n][0] + bb0);
        h[n][1] = gelu_erf(h[n][1] + bb1);
        h[n][2] = gelu_erf(h[n][2] + bb0);
        h[n][3] = gelu_erf(h[n][3] + bb1);
      }

      // out += hidden chunk @ w2[f0:f0+HC, :], 64 output columns at a time,
      // each slice summed over the chunk apart and then added to acc; hidden
      // k-step j is C fragment j, permuted into A-fragment order
#pragma unroll
      for (int s0 = 0; s0 < NO; s0 += NS) {
        float part[NS][4];
#pragma unroll
        for (int n = 0; n < NS; ++n) part[n][0] = part[n][1] = part[n][2] = part[n][3] = 0.f;
#pragma unroll
        for (int j = 0; j < NH; ++j) {
          const float c0 = __shfl_sync(FULL, h[j][0], src0), c1 = __shfl_sync(FULL, h[j][1], src0);
          const float c2 = __shfl_sync(FULL, h[j][2], src0), c3 = __shfl_sync(FULL, h[j][3], src0);
          const float d0 = __shfl_sync(FULL, h[j][0], src1), d1 = __shfl_sync(FULL, h[j][1], src1);
          const float d2 = __shfl_sync(FULL, h[j][2], src1), d3 = __shfl_sync(FULL, h[j][3], src1);
          const float av[4] = {odd ? c1 : c0, odd ? c3 : c2, odd ? d1 : d0, odd ? d3 : d2};
          unsigned ahi[4], alo[4];
          split_fragment(av, ahi, alo);
          const float* wb = w2s + (8 * j + t) * C::LDW2 + 8 * s0 + g;
          Tf32x2 b0[NS], b1[NS];
#pragma unroll
          for (int n = 0; n < NS; ++n) {
            b0[n] = split_tf32(wb[8 * n]);
            b1[n] = split_tf32(wb[4 * C::LDW2 + 8 * n]);
          }
          mma_3xtf32(part, 0, ahi, alo, b0, b1);
        }
#pragma unroll
        for (int n = 0; n < NS; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[s0 + n][i] += part[n][i];
      }
    }
    __syncthreads();  // every warp is done with this stage before its refill
  }

  const int r_lo = warp * 16 + g;
  float* o = out + r_lo * ldo + 2 * t;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    float2 lo = make_float2(acc[n][0], acc[n][1]), hi = make_float2(acc[n][2], acc[n][3]);
    if (b2) {
      const float bb0 = b2[8 * n + 2 * t], bb1 = b2[8 * n + 2 * t + 1];
      lo.x += bb0, lo.y += bb1, hi.x += bb0, hi.y += bb1;
    }
    if (r_lo < rows) *reinterpret_cast<float2*>(o + 8 * n) = lo;
    if (r_lo + 8 < rows) *reinterpret_cast<float2*>(o + 8 * ldo + 8 * n) = hi;
  }
}

// ---------------------------------------------------------------------------
// bf16 operands on the tensor cores (bf16 inference: K1 and K2 run on bf16
// activations and weights, as the Pallas kernels do under a bf16 cast)

using bf16 = __nv_bfloat16;

// c += a b for one m16n8k16 bf16 tile with f32 accumulation: a holds the A
// fragment (rows g, g+8; column pairs 2t and 2t+8 of the lane's group
// g = lane / 4 and t = lane % 4, two bf16 a register, the lower column in
// the low half), b0/b1 the B fragment (row pairs 2t and 2t+8; column g), c
// the f32 C fragment (rows g, g+8; columns 2t, 2t+1).  bf16 operands are
// exact inputs: no split as in 3xTF32.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 bf16 matrices from shared memory, lane l giving the address of
// row l % 8 of matrix l / 8.  Without .trans, lane (g, t) receives row g,
// columns 2t and 2t+1 of each: with rows r0 + (l & 15) and columns
// k0 + 8 (l >> 4), the A fragment of a row-major [M][K] tile.  With .trans
// it receives rows 2t and 2t+1 of column g: with rows k0 + (l & 15) and
// columns n0 + 8 (l >> 4), the B fragments of two n-tiles (n0, n0 + 8) of a
// row-major [K][N] tile, r[0..1] and r[2..3].
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const bf16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const bf16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// two f32 values rounded to nearest-even bf16, the first in the low half
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// The bf16 FFN tile of K1 and K2: TcFfn's structure with bf16 operands.  A
// CTA of WARPS warps owns BM = 16 WARPS rows; warp w owns rows 16w..16w+15
// and all D output columns in f32 registers.  w1/w2 stream through shared
// memory HC hidden columns at a time, double-buffered with cp.async.  Row
// pitches (in bf16) are 16 bytes past a multiple of 128, so the eight rows
// an ldmatrix reads fall in distinct banks.
template <int D>
struct TcFfnBf16 {
  static constexpr int WARPS = D <= 128 ? 8 : 4;  // D = 256: 128 accumulators
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int BM = 16 * WARPS;
  static constexpr int HC = D <= 128 ? 64 : 32;
  static constexpr int LDX = D + 8, LDW1 = HC + 8, LDW2 = D + 8;
  static constexpr int STAGE = D * LDW1 + HC * LDW2;  // one chunk of w1 and w2
  static constexpr int SMEM_BYTES = (BM * LDX + 2 * STAGE) * 2;
};

// out[r, :] = bf16(gelu(x[r, :] @ w1 + b1) @ w2 (+ b2)) for the rows r < rows
// of one tile, all operands bf16, as the Pallas kernels compute it: both
// products on mma.sync m16n8k16 with f32 accumulation, b1 and the erf GELU
// in f32, the hidden rounded to bf16 before the second product (it is then
// already the second product's A fragment: the C fragment of hidden columns
// 16s..16s+15 is, lane for lane, the A fragment of k-step s), b2 added in
// f32 and the output rounded to bf16.  x and out are row-major with row
// strides ldx and ldo elements; w1 is [D, F], w2 [F, D].  A chunk past F is
// zero-filled (gelu(0) * 0 = 0).  Rows past `rows` load as zeros from row
// 0's address and are never stored; a warp whose rows all lie past it skips
// its products but keeps to every barrier and copy group.  The tensor cores'
// truncating accumulation costs a few f32 bits, far below the bf16 output's
// rounding, so no partial sums are kept (TcFfn keeps them for f32).
//
// Requires D % 32 == 0, D <= 256, 1 <= rows <= BM, F % 8 == 0,
// ldx % 8 == ldo % 8 == 0 and 16-byte aligned x, out, w1, w2 (b2 may be
// null).  smem holds TcFfnBf16<D>::SMEM_BYTES bytes, 16-byte aligned.
template <int D>
__device__ __forceinline__ void ffn_tile_bf16(
    const bf16* __restrict__ x, long ldx, bf16* __restrict__ out, long ldo, int rows,
    const bf16* __restrict__ w1, const bf16* __restrict__ b1, const bf16* __restrict__ w2,
    const bf16* __restrict__ b2, int F, bf16* smem) {
  using C = TcFfnBf16<D>;
  static_assert(D % 32 == 0 && D <= 256, "D must be a multiple of 32, <= 256");
  constexpr int HC = C::HC, NH = HC / 8, NO = D / 8;
  bf16* xs = smem;                          // [BM][LDX]
  bf16* stages = xs + C::BM * C::LDX;       // 2 x ([D][LDW1] w1, [HC][LDW2] w2)
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int chunks = (F + HC - 1) / HC;
  const bool active = warp * 16 < rows;

  auto load_weights = [&](int chunk) {
    bf16* w1s = stages + (chunk & 1) * C::STAGE;
    bf16* w2s = w1s + D * C::LDW1;
    const int f0 = chunk * HC;
    for (int i = tid; i < D * HC / 8; i += C::THREADS) {
      const int k = i / (HC / 8), j = i % (HC / 8) * 8;
      const bool in = f0 + j < F;
      cp_async16(w1s + k * C::LDW1 + j, in ? w1 + (long)k * F + f0 + j : w1, in);
    }
    for (int i = tid; i < HC * D / 8; i += C::THREADS) {
      const int j = i / (D / 8), c = i % (D / 8) * 8;
      const bool in = f0 + j < F;
      cp_async16(w2s + j * C::LDW2 + c, in ? w2 + (long)(f0 + j) * D + c : w2, in);
    }
  };

  for (int i = tid; i < C::BM * D / 8; i += C::THREADS) {
    const int r = i / (D / 8), c = i % (D / 8) * 8;
    const bool in = r < rows;  // a row past the edge reads from row 0, a valid address
    cp_async16(xs + r * C::LDX + c, in ? x + r * ldx + c : x, in);
  }
  load_weights(0);
  cp_async_commit();

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  // the lane's ldmatrix row and column offsets (see ldmatrix_x4)
  const int lr = lane & 15, lc = (lane >> 4) * 8;
  const bf16* xa = xs + (warp * 16 + lr) * C::LDX + lc;

  for (int chunk = 0; chunk < chunks; ++chunk) {
    if (chunk + 1 < chunks) {
      load_weights(chunk + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* w1s = stages + (chunk & 1) * C::STAGE;
    const bf16* w2s = w1s + D * C::LDW1;

    if (active) {  // a warp of rows past the edge only keeps to the barriers
      // hidden chunk [16, HC] of the warp's rows: x @ w1[:, f0:f0+HC]
      float h[NH][4];
#pragma unroll
      for (int n = 0; n < NH; ++n) h[n][0] = h[n][1] = h[n][2] = h[n][3] = 0.f;
#pragma unroll 2
      for (int k = 0; k < D; k += 16) {
        unsigned a[4];
        ldmatrix_x4(a, xa + k);
        const bf16* wb = w1s + (k + lr) * C::LDW1 + lc;
#pragma unroll
        for (int n = 0; n < NH; n += 2) {
          unsigned b[4];
          ldmatrix_x4_trans(b, wb + 8 * n);
          mma_bf16(h[n], a, b[0], b[1]);
          mma_bf16(h[n + 1], a, b[2], b[3]);
        }
      }

      // bias and GELU in f32 on the C fragments (columns f0 + 8n + 2t, + 1),
      // rounded to bf16 into the A fragments of the second product
      const int f0 = chunk * HC;
      unsigned ha[NH / 2][4];
#pragma unroll
      for (int n = 0; n < NH; ++n) {
        const int f = f0 + 8 * n + 2 * t;
        const float bb0 = f < F ? __bfloat162float(b1[f]) : 0.f;
        const float bb1 = f + 1 < F ? __bfloat162float(b1[f + 1]) : 0.f;
        ha[n / 2][(n & 1) * 2] = pack_bf16(gelu_erf(h[n][0] + bb0), gelu_erf(h[n][1] + bb1));
        ha[n / 2][(n & 1) * 2 + 1] =
            pack_bf16(gelu_erf(h[n][2] + bb0), gelu_erf(h[n][3] + bb1));
      }

      // out += bf16(hidden chunk) @ w2[f0:f0+HC, :]
#pragma unroll
      for (int s = 0; s < NH / 2; ++s) {
        const bf16* wb = w2s + (16 * s + lr) * C::LDW2 + lc;
#pragma unroll
        for (int n = 0; n < NO; n += 2) {
          unsigned b[4];
          ldmatrix_x4_trans(b, wb + 8 * n);
          mma_bf16(acc[n], ha[s], b[0], b[1]);
          mma_bf16(acc[n + 1], ha[s], b[2], b[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage before its refill
  }

  const int r_lo = warp * 16 + g;
  bf16* o = out + r_lo * ldo + 2 * t;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    float lo0 = acc[n][0], lo1 = acc[n][1], hi0 = acc[n][2], hi1 = acc[n][3];
    if (b2) {
      const float bb0 = __bfloat162float(b2[8 * n + 2 * t]);
      const float bb1 = __bfloat162float(b2[8 * n + 2 * t + 1]);
      lo0 += bb0, lo1 += bb1, hi0 += bb0, hi1 += bb1;
    }
    if (r_lo < rows) *reinterpret_cast<unsigned*>(o + 8 * n) = pack_bf16(lo0, lo1);
    if (r_lo + 8 < rows) *reinterpret_cast<unsigned*>(o + 8 * ldo + 8 * n) = pack_bf16(hi0, hi1);
  }
}

// ---------------------------------------------------------------------------
// The split-sequence linear-attention cell of K3 and K5.  One (batch, head)
// cell is one thread-block cluster of G CTAs of LA_THREADS threads:
//   A[c, l]   = sum_n softmax_n(key(n, .))[c] * value(n, l)      (D x D)
//   out[t, l] = sum_c softmax_c(q[t, :])[c] * A[c, l]            (t < T)
// The key softmax is per channel over the whole sequence, so it splits over
// row chunks like an online softmax.  CTA r of the cluster takes rows
// [rN/G, (r+1)N/G) and keeps, per channel c, m_r[c] = max key, den_r[c] =
// sum exp(key - m_r) and A_r[c, :] = sum exp(key - m_r) value, staging
// LA_RS key and value rows at a time in shared memory: each key is read
// from device memory once and exponentiated once.  The CTAs then exchange
// m_r and den_r through distributed shared memory and reduce-scatter A by
// column block: CTA r sums the rescaled partials exp(m_j - m) A_j[:, cols_r]
// / den of every CTA j.  Then every CTA gathers the other column blocks and
// takes a quarter of the query rows, [rT/G, (r+1)T/G): channel softmax, then
// out = q A.  Splitting the queries rather than the output columns reads
// each query once and computes its softmax once.  An empty chunk has
// m_j = -inf and weighs 0; masked keys (-1e6) are finite, so exp(m_j - m)
// underflows to 0 and never meets inf - inf.
//
// A_r = E^T V and q A run in 3xTF32 on mma.sync: the fragments need far
// fewer shared-memory loads per multiply-add than a SIMT micro-tile.
constexpr int LA_THREADS = 256;
constexpr int LA_RS = 32;  // key/value rows staged per step

template <int D>
struct LaCell {
  static constexpr int G = D >= 32 ? 4 : 2;  // CTAs per cluster
  static constexpr int DG = D / G;           // columns of A each CTA reduces
  static constexpr int RQ = 64;              // query rows staged per step
  // pitches: B-like fragment reads (row t, column g) want 8 mod 32, A-like
  // reads (row g, column t) 4 mod 32
  static constexpr int LDK = D + 8;   // staged keys / their exp, values
  static constexpr int LDA = D + 8;   // A_r, then the gathered A
  static constexpr int LDQ = D + 4;   // staged queries
  static constexpr int LDR = DG + 8;  // the reduced A[:, cols_r]
  static constexpr int SPAN = D * LDA > 2 * LA_RS * LDK ? D * LDA : 2 * LA_RS * LDK;
  static constexpr int REDUCED = D * LDR > RQ * LDQ ? D * LDR : RQ * LDQ;
  // span (keys+values, then A_r, then A), A[:, cols_r] then queries, m,
  // den, rescale, G coefficients and one partial per thread
  static constexpr int SMEM_FLOATS = SPAN + REDUCED + (3 + G) * D + LA_THREADS;
  // phase 1 warp tiling of the D x D A_r: m-tile wm = warp % MT, NPW n-tiles
  // from (warp / MT) NPW; warps past the last n-tile (D = 16) idle
  static constexpr int MT = D / 16;
  static constexpr int NPW = D * D / 128 / 8 > 0 ? D * D / 128 / 8 : 1;
  static_assert(DG % 8 == 0 && LA_THREADS % D == 0 && MT <= 8 &&
                LA_THREADS % RQ == 0 && RQ == 64, "unsupported D");
};

// Four consecutive values of a row as f32, and two stored from f32: the
// cell's query and output are f32 (K5, K3 in f32) or bf16 (K3 under bf16
// inference, which loads bf16 and computes in f32, as the Pallas kernel
// upcasts its operands).
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<unsigned*>(p) = pack_bf16(a, b);
}

// key(n, c) / value(n, c) return channels c..c+3 (c % 4 == 0) of row n < N
// as a float4: the callers apply their masks and join their sequences there.
// q and out point at the cell's row 0, with row strides ldq and ldo elements
// (multiples of 4, 16-byte aligned f32 rows or 8-byte aligned bf16 rows);
// TQ and TO are float or bf16.  D in {16, 32, 64, 128}.  Both products,
// A_r = E^T V over the chunk and q A over the CTA's query rows, run in
// 3xTF32 on mma.sync like K1's tile, from f32 in shared memory.
template <int D, class Key, class Value, class TQ, class TO>
__device__ __forceinline__ void linear_attention_cell(
    int N, const Key& key, const Value& value, int T,
    const TQ* __restrict__ q, long ldq, TO* __restrict__ out, long ldo,
    float* smem) {
  using L = LaCell<D>;
  constexpr int G = L::G, DG = L::DG, P = LA_THREADS / D;
  constexpr int LDK = L::LDK, LDA = L::LDA, LDQ = L::LDQ, LDR = L::LDR;
  constexpr int MT = L::MT, NPW = L::NPW, NB = NPW < 8 ? NPW : 8;
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  float* span = smem;
  float* ar = span + L::SPAN;      // [D][LDR] the reduced A[:, cols_r]
  float* mrun = ar + L::REDUCED;   // [D] running max of the chunk
  float* den = mrun + D;           // [D] running sum of exp(key - mrun)
  float* rescale = den + D;        // [D] exp(old max - new max)
  float* coef = rescale + D;       // [G][D] exp(m_j - m) / den
  float* part = coef + G * D;      // [LA_THREADS]
  float* ks = span;                // [LA_RS][LDK] keys, then their exp
  float* vs = span + LA_RS * LDK;  // [LA_RS][LDK] values
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int c_own = tid % D, p_own = tid / D;

  // 1. this CTA's chunk: running max, sum of exp and A_r = E^T V, where the
  // warp owns rows c0..c0+15 of A_r and NPW n-tiles from column l0
  for (int c = tid; c < D; c += LA_THREADS) {
    mrun[c] = -INFINITY;
    den[c] = 0.f;
  }
  const int c0 = (warp % MT) * 16, l0 = (warp / MT) * NPW * 8;
  const bool mma_warp = l0 < D;
  float acc[NPW][4];
#pragma unroll
  for (int n = 0; n < NPW; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  const int n_begin = static_cast<int>((long)N * rank / G);
  const int n_end = static_cast<int>((long)N * (rank + 1) / G);
  for (int n0 = n_begin; n0 < n_end; n0 += LA_RS) {
    const int rows = min(LA_RS, n_end - n0);
    {  // every load of the step starts before the first store
      constexpr int IT = (LA_RS * D / 4 + LA_THREADS - 1) / LA_THREADS;
      float4 k4[IT], v4[IT];
#pragma unroll
      for (int u = 0; u < IT; ++u) {
        const int i = tid + u * LA_THREADS, r = i / (D / 4), c = i % (D / 4) * 4;
        k4[u] = make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY);
        v4[u] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (i < LA_RS * D / 4 && r < rows) {
          k4[u] = key(n0 + r, c);
          v4[u] = value(n0 + r, c);
        }
      }
#pragma unroll
      for (int u = 0; u < IT; ++u) {
        const int i = tid + u * LA_THREADS, r = i / (D / 4), c = i % (D / 4) * 4;
        if (i < LA_RS * D / 4) {
          *reinterpret_cast<float4*>(ks + r * LDK + c) = k4[u];
          *reinterpret_cast<float4*>(vs + r * LDK + c) = v4[u];
        }
      }
    }
    __syncthreads();
    float m = -INFINITY;
    for (int r = p_own; r < rows; r += P) m = fmaxf(m, ks[r * LDK + c_own]);
    part[tid] = m;
    __syncthreads();
    if (tid < D) {
      for (int k = 1; k < P; ++k) m = fmaxf(m, part[k * D + tid]);
      const float old = mrun[tid], now = fmaxf(old, m);
      rescale[tid] = old == -INFINITY ? 0.f : expf(old - now);
      mrun[tid] = now;
    }
    __syncthreads();
    const float mx = mrun[c_own];
    float s = 0.f;
    for (int r = p_own; r < LA_RS; r += P) {
      const float e = expf(ks[r * LDK + c_own] - mx);  // padded rows: exp(-inf) = 0
      ks[r * LDK + c_own] = e;
      s += e;
    }
    part[tid] = s;
    __syncthreads();
    if (tid < D) {
      for (int k = 1; k < P; ++k) s += part[k * D + tid];
      den[tid] = den[tid] * rescale[tid] + s;
    }
    if (mma_warp) {
      const float sc0 = rescale[c0 + g], sc1 = rescale[c0 + g + 8];
#pragma unroll
      for (int n = 0; n < NPW; ++n) {
        acc[n][0] *= sc0, acc[n][1] *= sc0;
        acc[n][2] *= sc1, acc[n][3] *= sc1;
      }
      // A fragment (c, n) = E[n, c]; B fragment (n, l) = V[n, l]
      for (int k = 0; k < rows; k += 8) {
        const float* ea = ks + (k + t) * LDK + c0 + g;
        const float av[4] = {ea[0], ea[8], ea[4 * LDK], ea[4 * LDK + 8]};
        unsigned ahi[4], alo[4];
        split_fragment(av, ahi, alo);
        const float* vb = vs + (k + t) * LDK + l0 + g;
#pragma unroll
        for (int nb = 0; nb < NPW; nb += NB) {
          Tf32x2 b0[NB], b1[NB];
#pragma unroll
          for (int n = 0; n < NB; ++n) {
            b0[n] = split_tf32(vb[8 * (nb + n)]);
            b1[n] = split_tf32(vb[4 * LDK + 8 * (nb + n)]);
          }
          mma_3xtf32(acc, nb, ahi, alo, b0, b1);
        }
      }
    }
    __syncthreads();  // the staging tiles are refilled next
  }
  float* as = span;  // [D][LDA] A_r, unnormalized, relative to mrun
  if (mma_warp) {
#pragma unroll
    for (int n = 0; n < NPW; ++n) {
      float* o = as + (c0 + g) * LDA + l0 + 8 * n + 2 * t;
      *reinterpret_cast<float2*>(o) = make_float2(acc[n][0], acc[n][1]);
      *reinterpret_cast<float2*>(o + 8 * LDA) = make_float2(acc[n][2], acc[n][3]);
    }
  }

  // 2. merge: m = max_j m_j, den = sum_j exp(m_j - m) den_j; CTA r sums the
  // rescaled partials of its column block from every CTA of the cluster
  // (reduce-scatter), then gathers the other blocks (all-gather)
  cluster.sync();
  if (tid < D) {
    float mj[G], m = -INFINITY;
#pragma unroll
    for (int j = 0; j < G; ++j) {
      mj[j] = *cluster.map_shared_rank(mrun + tid, j);
      m = fmaxf(m, mj[j]);
    }
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < G; ++j) {
      mj[j] = mj[j] == -INFINITY ? 0.f : expf(mj[j] - m);
      sum += mj[j] * *cluster.map_shared_rank(den + tid, j);
    }
    const float inv = sum > 0.f ? 1.f / sum : 0.f;
#pragma unroll
    for (int j = 0; j < G; ++j) coef[j * D + tid] = mj[j] * inv;
  }
  __syncthreads();
  {
    constexpr int IT = (D * DG / 4 + LA_THREADS - 1) / LA_THREADS;
#pragma unroll
    for (int u = 0; u < IT; ++u) {
      const int i = tid + u * LA_THREADS;
      if (i >= D * DG / 4) break;
      const int c = i / (DG / 4), l = i % (DG / 4) * 4;
      float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int j = 0; j < G; ++j) {
        const float4 a = *reinterpret_cast<const float4*>(
            cluster.map_shared_rank(as, j) + c * LDA + rank * DG + l);
        const float w = coef[j * D + c];
        s.x = fmaf(w, a.x, s.x), s.y = fmaf(w, a.y, s.y);
        s.z = fmaf(w, a.z, s.z), s.w = fmaf(w, a.w, s.w);
      }
      *reinterpret_cast<float4*>(ar + c * LDR + l) = s;
    }
  }
  cluster.sync();  // every block of A is reduced; no CTA reads A_r any more
  float* af = span;  // [D][LDA] the whole A, gathered over the span
  {
    constexpr int IT = D * D / 4 / LA_THREADS > 0 ? D * D / 4 / LA_THREADS : 1;
#pragma unroll 4
    for (int u = 0; u < IT; ++u) {
      const int i = tid + u * LA_THREADS;
      if (i >= D * D / 4) break;
      const int c = i / (D / 4), l = i % (D / 4) * 4, j = l / DG;
      *reinterpret_cast<float4*>(af + c * LDA + l) = *reinterpret_cast<const float4*>(
          cluster.map_shared_rank(ar, j) + c * LDR + l - j * DG);
    }
  }
  cluster.sync();  // past here no CTA reads another's shared memory

  // 3. CTA r takes query rows [rT/G, (r+1)T/G), RQ at a time: channel
  // softmax (TPR threads a row), then out = q A; warp w
  // computes rows 16 (w % 4).. of the step and columns (w / 4) D/2.., summed
  // in K blocks of 64 (see ffn_tile_tc on partial sums)
  constexpr int RQ = L::RQ, TPR = LA_THREADS / RQ, CPT = D / TPR, NQ = D / 16;
  constexpr int NQB = NQ < 4 ? NQ : 4;
  float* qs = ar;  // [RQ][LDQ]
  const int t_begin = static_cast<int>((long)T * rank / G);
  const int t_end = static_cast<int>((long)T * (rank + 1) / G);
  for (int t0 = t_begin; t0 < t_end; t0 += RQ) {
    const int nrows = min(RQ, t_end - t0);
    for (int i = tid; i < RQ * D / 4; i += LA_THREADS) {
      const int r = i / (D / 4), c = i % (D / 4) * 4;
      const bool in = r < nrows;
      if constexpr (std::is_same<TQ, float>::value) {
        cp_async16(qs + r * LDQ + c, in ? q + (t0 + r) * ldq + c : q, in);
      } else {  // bf16 rows are widened to f32 on their way through registers
        *reinterpret_cast<float4*>(qs + r * LDQ + c) =
            in ? load4(q + (t0 + r) * ldq + c) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    {  // TPR threads a row, channels p, p + TPR, ... (conflict-free)
      float* row = qs + (tid / TPR) * LDQ + tid % TPR;
      float m = -INFINITY;
#pragma unroll
      for (int c = 0; c < CPT; ++c) m = fmaxf(m, row[c * TPR]);
#pragma unroll
      for (int o = 1; o < TPR; o <<= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
      float e[CPT], s = 0.f;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        e[c] = expf(row[c * TPR] - m);
        s += e[c];
      }
#pragma unroll
      for (int o = 1; o < TPR; o <<= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      const float inv = 1.f / s;
#pragma unroll
      for (int c = 0; c < CPT; ++c) row[c * TPR] = e[c] * inv;
    }
    __syncthreads();
    const int r0 = 16 * (warp % 4), n0 = (warp / 4) * (D / 2);
    if (r0 < nrows) {
      float o[NQ][4];
#pragma unroll
      for (int n = 0; n < NQ; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
      for (int k0 = 0; k0 < D; k0 += 64) {
        float op[NQ][4];
#pragma unroll
        for (int n = 0; n < NQ; ++n) op[n][0] = op[n][1] = op[n][2] = op[n][3] = 0.f;
#pragma unroll 2
        for (int k = k0; k < k0 + 64 && k < D; k += 8) {
          const float* qa = qs + (r0 + g) * LDQ + k + t;
          const float av[4] = {qa[0], qa[8 * LDQ], qa[4], qa[8 * LDQ + 4]};
          unsigned ahi[4], alo[4];
          split_fragment(av, ahi, alo);
          const float* rb = af + (k + t) * LDA + n0 + g;
#pragma unroll
          for (int nb = 0; nb < NQ; nb += NQB) {
            Tf32x2 b0[NQB], b1[NQB];
#pragma unroll
            for (int n = 0; n < NQB; ++n) {
              b0[n] = split_tf32(rb[8 * (nb + n)]);
              b1[n] = split_tf32(rb[4 * LDA + 8 * (nb + n)]);
            }
            mma_3xtf32(op, nb, ahi, alo, b0, b1);
          }
        }
#pragma unroll
        for (int n = 0; n < NQ; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) o[n][i] += op[n][i];
      }
      const int r_lo = r0 + g, r_hi = r_lo + 8;
#pragma unroll
      for (int n = 0; n < NQ; ++n) {
        const int col = n0 + 8 * n + 2 * t;
        if (r_lo < nrows) store2(out + (t0 + r_lo) * ldo + col, o[n][0], o[n][1]);
        if (r_hi < nrows) store2(out + (t0 + r_hi) * ldo + col, o[n][2], o[n][3]);
      }
    }
    __syncthreads();  // qs is refilled next
  }
}

// The launch of a cell kernel over B x H cells: grid (G B, H), clusters of
// G CTAs along x, the cell's dynamic shared memory.  *cluster is the
// configuration's one attribute and must outlive it.
template <int D, class... Params>
cudaLaunchConfig_t cell_config(void (*kernel)(Params...), int B, int H,
                               cudaStream_t stream, cudaLaunchAttribute* cluster) {
  constexpr int smem = LaCell<D>::SMEM_FLOATS * sizeof(float);
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  cluster->id = cudaLaunchAttributeClusterDimension;
  cluster->val.clusterDim.x = LaCell<D>::G;
  cluster->val.clusterDim.y = 1;
  cluster->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(LaCell<D>::G * B, H, 1);
  cfg.blockDim = dim3(LA_THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  return cfg;
}

// Launch a cell kernel over B x H cells.  Returns cudaGetLastError() after
// the launch.
template <int D, class... Params, class... Args>
int launch_cells(void (*kernel)(Params...), int B, int H, cudaStream_t stream,
                 Args... args) {
  cudaLaunchAttribute cluster;
  const cudaLaunchConfig_t cfg = cell_config<D>(kernel, B, H, stream, &cluster);
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The number of clusters of a cell kernel that can be resident at once on
// the current device.  Returns the CUDA error code.
template <int D, class... Params>
int max_active_cells(void (*kernel)(Params...), int* clusters) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute cluster;
  const cudaLaunchConfig_t cfg = cell_config<D>(kernel, sms, 1, nullptr, &cluster);
  return static_cast<int>(
      cudaOccupancyMaxActiveClusters(clusters, reinterpret_cast<void*>(kernel), &cfg));
}

}  // namespace mc
