// Grouped expert FFN over rank-compact MoE rows (kernel K1).
//
// Replaces the Pallas kernel grouped_ffn of
// motioncraft_tpu/ops/pallas_moe_ffn.py.  The rows of xs [M_pad, D] are sorted
// by expert in groups padded to 512 rows, so every 512-row block belongs to
// one expert, block_expert[block].  Per block:
//     out = gelu_erf(x @ w1[e] + b1[e]) @ w2[e]        (no b2, no gate)
//
// Bound: at the flagship (D=128, F=512) the two products are 4*D*F = 262k
// flops per row against 2*D*4 = 1 KB moved per row, so the kernel is bound by
// operations.  On the CUDA cores' f32 rate (67 TFLOP/s) that bound is
// 0.62 ms; in 3xTF32 on the tensor cores (three TF32 products at 495
// TFLOP/s, exact to about 22 mantissa bits, see common.cuh) it is 0.25 ms.
// Design (common.cuh ffn_tile_tc): one CTA per 128-row quarter of an expert
// block (64 rows at D=256) reads its expert id and keeps its x tile in
// shared memory; both products run as mma.sync m16n8k8 TF32 in 3xTF32, each
// warp owning 16 rows x all D output columns in registers; w1/w2 stream in
// 64-hidden-column chunks (32 at D=256), double-buffered with cp.async; the
// hidden chunk stays in registers (bias and erf-GELU on the accumulator),
// so the [M_pad, F] hidden activation never reaches device memory.
//
// What holds it from the 3xTF32 bound: mma.sync does not reach the tensor
// cores' TF32 peak, and the fragment loads and splits are more than 8 warps
// an SM can hide.  wgmma would, but it reads TF32 only K-major from shared
// memory: w1 and w2 would have to be transposed and split into hi/lo copies
// before they are staged.
//
// bf16 (bf16 inference, the Pallas kernel on bf16 operands): the same grid
// on common.cuh ffn_tile_bf16, mma.sync m16n8k16 with f32 accumulation, the
// hidden rounded to bf16 before the second product and the output stored in
// bf16.  It moves half the bytes and its bound is the dense bf16 tensor-core
// rate (989 TFLOP/s), a sixth of the 3xTF32 bound (three passes at 495).
#include "common.cuh"

namespace {

constexpr int GROUP_ROWS = 512;  // rows of one expert-aligned block

template <int D>
__global__ void __launch_bounds__(mc::TcFfn<D>::THREADS, 1)
grouped_ffn_kernel(const int* __restrict__ block_expert,
                   const float* __restrict__ xs, const float* __restrict__ w1,
                   const float* __restrict__ b1, const float* __restrict__ w2,
                   float* __restrict__ out, int F) {
  static_assert(GROUP_ROWS % mc::TcFfn<D>::BM == 0, "a tile spans one block");
  extern __shared__ __align__(16) float smem[];
  const long row0 = (long)blockIdx.x * mc::TcFfn<D>::BM;
  const int e = block_expert[row0 / GROUP_ROWS];
  mc::ffn_tile_tc<D>(xs + row0 * D, D, out + row0 * D, D, mc::TcFfn<D>::BM,
                     w1 + (long)e * D * F, b1 + (long)e * F, w2 + (long)e * F * D,
                     nullptr, F, smem);
}

template <int D>
int launch(const int* be, const float* xs, const float* w1, const float* b1,
           const float* w2, float* out, int m_pad, int F, cudaStream_t stream) {
  using C = mc::TcFfn<D>;
  const int smem = C::SMEM_FLOATS * sizeof(float);
  cudaFuncSetAttribute(grouped_ffn_kernel<D>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  grouped_ffn_kernel<D><<<m_pad / C::BM, C::THREADS, smem, stream>>>(
      be, xs, w1, b1, w2, out, F);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
__global__ void __launch_bounds__(mc::TcFfnBf16<D>::THREADS, 1)
grouped_ffn_bf16_kernel(const int* __restrict__ block_expert,
                        const mc::bf16* __restrict__ xs, const mc::bf16* __restrict__ w1,
                        const mc::bf16* __restrict__ b1, const mc::bf16* __restrict__ w2,
                        mc::bf16* __restrict__ out, int F) {
  static_assert(GROUP_ROWS % mc::TcFfnBf16<D>::BM == 0, "a tile spans one block");
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  const long row0 = (long)blockIdx.x * mc::TcFfnBf16<D>::BM;
  const int e = block_expert[row0 / GROUP_ROWS];
  mc::ffn_tile_bf16<D>(xs + row0 * D, D, out + row0 * D, D, mc::TcFfnBf16<D>::BM,
                       w1 + (long)e * D * F, b1 + (long)e * F, w2 + (long)e * F * D,
                       nullptr, F, reinterpret_cast<mc::bf16*>(smem_bytes));
}

template <int D>
int launch_bf16(const int* be, const mc::bf16* xs, const mc::bf16* w1, const mc::bf16* b1,
                const mc::bf16* w2, mc::bf16* out, int m_pad, int F, cudaStream_t stream) {
  using C = mc::TcFfnBf16<D>;
  cudaFuncSetAttribute(grouped_ffn_bf16_kernel<D>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM_BYTES);
  grouped_ffn_bf16_kernel<D><<<m_pad / C::BM, C::THREADS, C::SMEM_BYTES, stream>>>(
      be, xs, w1, b1, w2, out, F);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// xs [m_pad, d] with m_pad % 512 == 0; w1 [E, d, f]; b1 [E, f]; w2 [E, f, d];
// block_expert [m_pad / 512] int32 in [0, E).  d in {32, 64, 128, 256},
// f % 32 == 0.  Returns cudaGetLastError() after the launch.
extern "C" int mc_grouped_ffn(const void* block_expert, const void* xs,
                              const void* w1, const void* b1, const void* w2,
                              void* out, int m_pad, int d, int f, void* stream) {
  auto be = static_cast<const int*>(block_expert);
  auto x = static_cast<const float*>(xs);
  auto a = static_cast<const float*>(w1);
  auto b = static_cast<const float*>(b1);
  auto c = static_cast<const float*>(w2);
  auto o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32: return launch<32>(be, x, a, b, c, o, m_pad, f, s);
    case 64: return launch<64>(be, x, a, b, c, o, m_pad, f, s);
    case 128: return launch<128>(be, x, a, b, c, o, m_pad, f, s);
    case 256: return launch<256>(be, x, a, b, c, o, m_pad, f, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The same on bf16 xs, w1, b1, w2 and out.  Returns cudaGetLastError() after
// the launch.
extern "C" int mc_grouped_ffn_bf16(const void* block_expert, const void* xs,
                                   const void* w1, const void* b1, const void* w2,
                                   void* out, int m_pad, int d, int f, void* stream) {
  auto be = static_cast<const int*>(block_expert);
  auto x = static_cast<const mc::bf16*>(xs);
  auto a = static_cast<const mc::bf16*>(w1);
  auto b = static_cast<const mc::bf16*>(b1);
  auto c = static_cast<const mc::bf16*>(w2);
  auto o = static_cast<mc::bf16*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32: return launch_bf16<32>(be, x, a, b, c, o, m_pad, f, s);
    case 64: return launch_bf16<64>(be, x, a, b, c, o, m_pad, f, s);
    case 128: return launch_bf16<128>(be, x, a, b, c, o, m_pad, f, s);
    case 256: return launch_bf16<256>(be, x, a, b, c, o, m_pad, f, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
