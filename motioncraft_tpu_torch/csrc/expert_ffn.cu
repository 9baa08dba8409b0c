// Expert FFN over the MoE slot buffers (kernel K6).
//
// Replaces the Pallas kernel fused_expert_ffn of
// motioncraft_tpu/ops/pallas_ffn.py.  xe [E, C, D] holds each expert's C
// capacity slots (empty slots are zero rows); per expert e and slot c:
//     out[e, c, :] = gelu_erf(xe[e, c, :] @ w1[e] + b1[e]) @ w2[e] + b2[e]
//
// Bound: the two products are 4*D*F flops per slot row against 8*D bytes
// moved per row (F = 4D: 2 Kflop per byte at D=128), so operations bound it;
// in 3xTF32 on the tensor cores (f32 accuracy, see common.cuh) that is
// 0.36 ms for the flagship's motion slots [16, 14112, 128].  Design: the
// TPU kernel's point, the [rows, F] hidden activation never reaching device
// memory, with K1's tile (common.cuh ffn_tile_tc) on a (slot tile, expert)
// grid: the x tile in shared memory, both products in 3xTF32 on mma.sync,
// w1/w2 streamed in double-buffered chunks, the hidden chunk and the output
// in registers, b2 added in the epilogue and the ragged last tile of each
// expert masked (C need not be a multiple of the tile).  What holds it from
// the bound is K1's (moe_ffn.cu); at D=256 a CTA has only 4 warps (128
// accumulators a thread) to hide it.
//
// bf16 (bf16 training's text MoEs, the Pallas kernel on bf16 operands): the
// same grid on common.cuh ffn_tile_16, mma.sync m16n8k16 with f32
// accumulation, b1 and the erf GELU in f32, the hidden rounded to bf16
// before the second product, b2 added in f32 and the output stored in bf16.
// It moves half the bytes and its bound is the dense bf16 tensor-core rate
// (989 TFLOP/s), a sixth of the 3xTF32 bound.  The tile's ragged row count
// masks each expert's last slot tile, as the f32 tile's does.
//
// f16 (float16 training's text MoEs, the Pallas kernel on float16
// operands): the same tile on f16 operands (common.cuh ffn_tile_16 with
// mma.sync m16n8k16 .f16), the same f32 accumulation and f32 b1, GELU and
// b2; the hidden and the output round to nearest f16, so a value past f16's
// 65504 becomes +-inf as the Pallas body's astype makes it (no clamp).  Its
// bound is the dense f16 tensor-core rate, the bf16 one's 989 TFLOP/s.
#include "common.cuh"

namespace {

template <int D>
__global__ void __launch_bounds__(mc::TcFfn<D>::THREADS, 1)
expert_ffn_kernel(const float* __restrict__ xe, const float* __restrict__ w1,
                  const float* __restrict__ b1, const float* __restrict__ w2,
                  const float* __restrict__ b2, float* __restrict__ out, int C,
                  int F) {
  extern __shared__ __align__(16) float smem[];
  constexpr int BM = mc::TcFfn<D>::BM;
  const int e = blockIdx.y;
  const int row0 = blockIdx.x * BM;
  const long base = ((long)e * C + row0) * D;
  mc::ffn_tile_tc<D>(xe + base, D, out + base, D, min(BM, C - row0),
                     w1 + (long)e * D * F, b1 + (long)e * F, w2 + (long)e * F * D,
                     b2 + (long)e * D, F, smem);
}

template <int D>
int launch(const float* xe, const float* w1, const float* b1, const float* w2,
           const float* b2, float* out, int E, int C, int F, cudaStream_t stream) {
  using T = mc::TcFfn<D>;
  const int smem = T::SMEM_FLOATS * sizeof(float);
  cudaFuncSetAttribute(expert_ffn_kernel<D>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const dim3 grid((C + T::BM - 1) / T::BM, E);
  expert_ffn_kernel<D><<<grid, T::THREADS, smem, stream>>>(
      xe, w1, b1, w2, b2, out, C, F);
  return static_cast<int>(cudaGetLastError());
}

template <int D, class T>
__global__ void __launch_bounds__(mc::TcFfn16<D>::THREADS, 1)
expert_ffn_16_kernel(const T* __restrict__ xe, const T* __restrict__ w1,
                     const T* __restrict__ b1, const T* __restrict__ w2,
                     const T* __restrict__ b2, T* __restrict__ out, int C, int F) {
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  constexpr int BM = mc::TcFfn16<D>::BM;
  const int e = blockIdx.y;
  const int row0 = blockIdx.x * BM;
  const long base = ((long)e * C + row0) * D;
  mc::ffn_tile_16<D, T>(xe + base, D, out + base, D, min(BM, C - row0),
                        w1 + (long)e * D * F, b1 + (long)e * F, w2 + (long)e * F * D,
                        b2 + (long)e * D, F, reinterpret_cast<T*>(smem_bytes));
}

template <int D, class T>
int launch_16(const T* xe, const T* w1, const T* b1, const T* w2, const T* b2, T* out,
              int E, int C, int F, cudaStream_t stream) {
  using S = mc::TcFfn16<D>;
  cudaFuncSetAttribute(expert_ffn_16_kernel<D, T>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM_BYTES);
  const dim3 grid((C + S::BM - 1) / S::BM, E);
  expert_ffn_16_kernel<D, T><<<grid, S::THREADS, S::SMEM_BYTES, stream>>>(
      xe, w1, b1, w2, b2, out, C, F);
  return static_cast<int>(cudaGetLastError());
}

// the 16-bit launch of one element type T, dispatched on d
template <class T>
int launch_16_d(const void* xe, const void* w1, const void* b1, const void* w2,
                const void* b2, void* out, int E, int C, int d, int f, void* stream) {
  auto x = static_cast<const T*>(xe);
  auto a = static_cast<const T*>(w1);
  auto b = static_cast<const T*>(b1);
  auto c = static_cast<const T*>(w2);
  auto bb = static_cast<const T*>(b2);
  auto o = static_cast<T*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32: return launch_16<32, T>(x, a, b, c, bb, o, E, C, f, s);
    case 64: return launch_16<64, T>(x, a, b, c, bb, o, E, C, f, s);
    case 128: return launch_16<128, T>(x, a, b, c, bb, o, E, C, f, s);
    case 256: return launch_16<256, T>(x, a, b, c, bb, o, E, C, f, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// xe [E, C, d]; w1 [E, d, f]; b1 [E, f]; w2 [E, f, d]; b2 [E, d]; out
// [E, C, d]; all contiguous f32.  d in {32, 64, 128, 256}, f % 32 == 0,
// C >= 1, E <= 65535.  Returns cudaGetLastError() after the launch.
extern "C" int mc_expert_ffn(const void* xe, const void* w1, const void* b1,
                             const void* w2, const void* b2, void* out, int E,
                             int C, int d, int f, void* stream) {
  auto x = static_cast<const float*>(xe);
  auto a = static_cast<const float*>(w1);
  auto b = static_cast<const float*>(b1);
  auto c = static_cast<const float*>(w2);
  auto bb = static_cast<const float*>(b2);
  auto o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32: return launch<32>(x, a, b, c, bb, o, E, C, f, s);
    case 64: return launch<64>(x, a, b, c, bb, o, E, C, f, s);
    case 128: return launch<128>(x, a, b, c, bb, o, E, C, f, s);
    case 256: return launch<256>(x, a, b, c, bb, o, E, C, f, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The same on bf16 xe, w1, b1, w2, b2 and out.  Returns cudaGetLastError()
// after the launch.
extern "C" int mc_expert_ffn_bf16(const void* xe, const void* w1, const void* b1,
                                  const void* w2, const void* b2, void* out, int E,
                                  int C, int d, int f, void* stream) {
  return launch_16_d<mc::bf16>(xe, w1, b1, w2, b2, out, E, C, d, f, stream);
}

// The same on f16 xe, w1, b1, w2, b2 and out.  Returns cudaGetLastError()
// after the launch.
extern "C" int mc_expert_ffn_f16(const void* xe, const void* w1, const void* b1,
                                 const void* w2, const void* b2, void* out, int E,
                                 int C, int d, int f, void* stream) {
  return launch_16_d<mc::f16>(xe, w1, b1, w2, b2, out, E, C, d, f, stream);
}
