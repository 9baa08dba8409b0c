// Expert FFN over the MoE slot buffers (kernel K6).
//
// Replaces the Pallas kernel fused_expert_ffn of
// motioncraft_tpu/ops/pallas_ffn.py.  xe [E, C, D] holds each expert's C
// capacity slots (empty slots are zero rows); per expert e and slot c:
//     out[e, c, :] = gelu_erf(xe[e, c, :] @ w1[e] + b1[e]) @ w2[e] + b2[e]
//
// Bound: the two products are 4*D*F flops per slot row against 8*D bytes
// moved per row (F = 4D: 2 Kflop per byte at D=128), so f32 operations bound
// it; exact f32 rules out TF32 tensor cores, so the ceiling is the CUDA
// cores' f32 rate.  Design: the TPU kernel's point, the [rows, F] hidden
// activation never reaching device memory, with K1's tile (common.cuh
// ffn_tile): one CTA per (64-row tile of an expert's slots, expert), the x
// tile in shared memory, w1/w2 streamed through it 32 hidden columns at a
// time, the output accumulated in registers.  Unlike K1 it adds b2 and masks
// the ragged last tile (C need not be a multiple of 64).
#include "common.cuh"

namespace {

template <int D>
__global__ void __launch_bounds__(mc::FFN_THREADS)
expert_ffn_kernel(const float* __restrict__ xe, const float* __restrict__ w1,
                  const float* __restrict__ b1, const float* __restrict__ w2,
                  const float* __restrict__ b2, float* __restrict__ out, int C,
                  int F) {
  extern __shared__ __align__(16) float smem[];
  const int e = blockIdx.y;
  const int row0 = blockIdx.x * mc::FFN_BM;
  const long base = ((long)e * C + row0) * D;
  mc::ffn_tile<D>(xe + base, D, out + base, D, min(mc::FFN_BM, C - row0),
                  w1 + (long)e * D * F, b1 + (long)e * F, w2 + (long)e * F * D,
                  b2 + (long)e * D, F, smem);
}

template <int D>
int launch(const float* xe, const float* w1, const float* b1, const float* w2,
           const float* b2, float* out, int E, int C, int F, cudaStream_t stream) {
  const int smem = mc::ffn_smem_floats<D>() * sizeof(float);
  cudaFuncSetAttribute(expert_ffn_kernel<D>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const dim3 grid((C + mc::FFN_BM - 1) / mc::FFN_BM, E);
  expert_ffn_kernel<D><<<grid, mc::FFN_THREADS, smem, stream>>>(
      xe, w1, b1, w2, b2, out, C, F);
  return static_cast<int>(cudaGetLastError());
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
