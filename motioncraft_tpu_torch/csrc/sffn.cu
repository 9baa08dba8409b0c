// Per-head (body-part) FFN over the interleaved [N, H*d] layout (kernel K2).
//
// Replaces the Pallas kernel head_ffn of motioncraft_tpu/ops/pallas_sffn.py.
// Per head h and row n:
//     y[n, h*d:(h+1)*d] = gelu_erf(x_h @ w1[h] + b1[h]) @ w2[h] + b2[h]
//
// Bound: 4*d*f = 262k flops per (row, head) at the flagship (d=128, f=512)
// against 1 KB moved, so operations bound it: 0.12 ms for x [6272, 12*128]
// in 3xTF32 on the tensor cores (f32 accuracy, see common.cuh).  Design: K1's
// tile (common.cuh ffn_tile_tc) on a (row tile, head) grid.  A CTA reads its
// head's d columns of 128 rows (64 at d=256) straight out of the interleaved
// layout (row stride H*d, no transpose), runs both products in 3xTF32 on
// mma.sync with that head's w1/w2 streamed through shared memory in
// double-buffered chunks, keeps the hidden chunk in registers, and writes
// the same column slice of the output; the last row tile is ragged.  What
// holds it from the bound is K1's (moe_ffn.cu): mma.sync short of the TF32
// peak, and fragment loads and splits that one CTA of 8 warps an SM cannot
// hide.
//
// bf16 (bf16 inference, the Pallas kernel on bf16 operands): the same grid
// on common.cuh ffn_tile_bf16 (mma.sync m16n8k16, f32 accumulation, the
// hidden rounded to bf16, b2 added in f32, the output stored in bf16); its
// bound is the dense bf16 tensor-core rate.
#include "common.cuh"

namespace {

template <int D>
__global__ void __launch_bounds__(mc::TcFfn<D>::THREADS, 1)
head_ffn_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                const float* __restrict__ b1, const float* __restrict__ w2,
                const float* __restrict__ b2, float* __restrict__ out, int n,
                int heads, int F) {
  extern __shared__ __align__(16) float smem[];
  constexpr int BM = mc::TcFfn<D>::BM;
  const int h = blockIdx.y;
  const long row0 = (long)blockIdx.x * BM;
  const long ld = (long)heads * D;
  const int rows = n - row0 < BM ? static_cast<int>(n - row0) : BM;
  mc::ffn_tile_tc<D>(x + row0 * ld + h * D, ld, out + row0 * ld + h * D, ld, rows,
                     w1 + (long)h * D * F, b1 + (long)h * F, w2 + (long)h * F * D,
                     b2 + (long)h * D, F, smem);
}

template <int D>
int launch(const float* x, const float* w1, const float* b1, const float* w2,
           const float* b2, float* out, int n, int heads, int F,
           cudaStream_t stream) {
  using T = mc::TcFfn<D>;
  const int smem = T::SMEM_FLOATS * sizeof(float);
  cudaFuncSetAttribute(head_ffn_kernel<D>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const dim3 grid((n + T::BM - 1) / T::BM, heads);
  head_ffn_kernel<D><<<grid, T::THREADS, smem, stream>>>(
      x, w1, b1, w2, b2, out, n, heads, F);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
__global__ void __launch_bounds__(mc::TcFfnBf16<D>::THREADS, 1)
head_ffn_bf16_kernel(const mc::bf16* __restrict__ x, const mc::bf16* __restrict__ w1,
                     const mc::bf16* __restrict__ b1, const mc::bf16* __restrict__ w2,
                     const mc::bf16* __restrict__ b2, mc::bf16* __restrict__ out, int n,
                     int heads, int F) {
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  constexpr int BM = mc::TcFfnBf16<D>::BM;
  const int h = blockIdx.y;
  const long row0 = (long)blockIdx.x * BM;
  const long ld = (long)heads * D;
  const int rows = n - row0 < BM ? static_cast<int>(n - row0) : BM;
  mc::ffn_tile_bf16<D>(x + row0 * ld + h * D, ld, out + row0 * ld + h * D, ld, rows,
                       w1 + (long)h * D * F, b1 + (long)h * F, w2 + (long)h * F * D,
                       b2 + (long)h * D, F, reinterpret_cast<mc::bf16*>(smem_bytes));
}

template <int D>
int launch_bf16(const mc::bf16* x, const mc::bf16* w1, const mc::bf16* b1,
                const mc::bf16* w2, const mc::bf16* b2, mc::bf16* out, int n, int heads,
                int F, cudaStream_t stream) {
  using T = mc::TcFfnBf16<D>;
  cudaFuncSetAttribute(head_ffn_bf16_kernel<D>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM_BYTES);
  const dim3 grid((n + T::BM - 1) / T::BM, heads);
  head_ffn_bf16_kernel<D><<<grid, T::THREADS, T::SMEM_BYTES, stream>>>(
      x, w1, b1, w2, b2, out, n, heads, F);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x [n, heads*d]; w1 [heads, d, f]; b1 [heads, f]; w2 [heads, f, d];
// b2 [heads, d]; out [n, heads*d].  d in {32, 64, 128, 256}, f % 32 == 0,
// heads <= 65535.  Returns cudaGetLastError() after the launch.
extern "C" int mc_head_ffn(const void* x, const void* w1, const void* b1,
                           const void* w2, const void* b2, void* out, int n,
                           int heads, int d, int f, void* stream) {
  auto xp = static_cast<const float*>(x);
  auto a = static_cast<const float*>(w1);
  auto b = static_cast<const float*>(b1);
  auto c = static_cast<const float*>(w2);
  auto e = static_cast<const float*>(b2);
  auto o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32: return launch<32>(xp, a, b, c, e, o, n, heads, f, s);
    case 64: return launch<64>(xp, a, b, c, e, o, n, heads, f, s);
    case 128: return launch<128>(xp, a, b, c, e, o, n, heads, f, s);
    case 256: return launch<256>(xp, a, b, c, e, o, n, heads, f, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The same on bf16 operands and output.  Returns cudaGetLastError() after
// the launch.
extern "C" int mc_head_ffn_bf16(const void* x, const void* w1, const void* b1,
                                const void* w2, const void* b2, void* out, int n,
                                int heads, int d, int f, void* stream) {
  auto xp = static_cast<const mc::bf16*>(x);
  auto a = static_cast<const mc::bf16*>(w1);
  auto b = static_cast<const mc::bf16*>(b1);
  auto c = static_cast<const mc::bf16*>(w2);
  auto e = static_cast<const mc::bf16*>(b2);
  auto o = static_cast<mc::bf16*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32: return launch_bf16<32>(xp, a, b, c, e, o, n, heads, f, s);
    case 64: return launch_bf16<64>(xp, a, b, c, e, o, n, heads, f, s);
    case 128: return launch_bf16<128>(xp, a, b, c, e, o, n, heads, f, s);
    case 256: return launch_bf16<256>(xp, a, b, c, e, o, n, heads, f, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
