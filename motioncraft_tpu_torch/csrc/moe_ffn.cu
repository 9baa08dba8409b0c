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
// f32 operations; exact f32 rules out TF32 tensor cores, so the ceiling is the
// CUDA cores' f32 rate.  Design: one CTA per 64-row tile (8 per block); the
// CTA reads its own expert id, keeps its x tile in shared memory and streams
// w1/w2 through it 32 hidden columns at a time, so the [M_pad, F] hidden
// activation never reaches device memory (common.cuh ffn_tile).
#include "common.cuh"

namespace {

constexpr int GROUP_ROWS = 512;  // rows of one expert-aligned block

template <int D>
__global__ void __launch_bounds__(mc::FFN_THREADS)
grouped_ffn_kernel(const int* __restrict__ block_expert,
                   const float* __restrict__ xs, const float* __restrict__ w1,
                   const float* __restrict__ b1, const float* __restrict__ w2,
                   float* __restrict__ out, int F) {
  extern __shared__ __align__(16) float smem[];
  const long row0 = (long)blockIdx.x * mc::FFN_BM;
  const int e = block_expert[row0 / GROUP_ROWS];
  mc::ffn_tile<D>(xs + row0 * D, D, out + row0 * D, D, mc::FFN_BM,
                  w1 + (long)e * D * F, b1 + (long)e * F,
                  w2 + (long)e * F * D, nullptr, F, smem);
}

template <int D>
int launch(const int* be, const float* xs, const float* w1, const float* b1,
           const float* w2, float* out, int m_pad, int F, cudaStream_t stream) {
  const int smem = mc::ffn_smem_floats<D>() * sizeof(float);
  cudaFuncSetAttribute(grouped_ffn_kernel<D>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  grouped_ffn_kernel<D><<<m_pad / mc::FFN_BM, mc::FFN_THREADS, smem, stream>>>(
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
