// Per-head (body-part) FFN over the interleaved [N, H*d] layout (kernel K2).
//
// Replaces the Pallas kernel head_ffn of motioncraft_tpu/ops/pallas_sffn.py.
// Per head h and row n:
//     y[n, h*d:(h+1)*d] = gelu_erf(x_h @ w1[h] + b1[h]) @ w2[h] + b2[h]
//
// Bound: 4*d*f = 262k flops per (row, head) at the flagship (d=128, f=512)
// against 1 KB moved, so f32 operations bound it (exact f32: no TF32 tensor
// cores).  Design: the grid is (row tile, head); a CTA reads its head's d
// columns of 64 rows straight out of the interleaved layout (row stride H*d,
// no transpose), keeps them in shared memory, streams that head's weights 32
// hidden columns at a time and writes the same column slice of the output.
// The [N, H, f] hidden activation never reaches device memory.
#include "common.cuh"

namespace {

template <int D>
__global__ void __launch_bounds__(mc::FFN_THREADS)
head_ffn_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                const float* __restrict__ b1, const float* __restrict__ w2,
                const float* __restrict__ b2, float* __restrict__ out, int n,
                int heads, int F) {
  extern __shared__ __align__(16) float smem[];
  const int h = blockIdx.y;
  const long row0 = (long)blockIdx.x * mc::FFN_BM;
  const long ld = (long)heads * D;
  const int rows = min(mc::FFN_BM, (int)(n - row0));
  mc::ffn_tile<D>(x + row0 * ld + h * D, ld, out + row0 * ld + h * D, ld, rows,
                  w1 + (long)h * D * F, b1 + (long)h * F, w2 + (long)h * F * D,
                  b2 + (long)h * D, F, smem);
}

template <int D>
int launch(const float* x, const float* w1, const float* b1, const float* w2,
           const float* b2, float* out, int n, int heads, int F,
           cudaStream_t stream) {
  const int smem = mc::ffn_smem_floats<D>() * sizeof(float);
  cudaFuncSetAttribute(head_ffn_kernel<D>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const dim3 grid((n + mc::FFN_BM - 1) / mc::FFN_BM, heads);
  head_ffn_kernel<D><<<grid, mc::FFN_THREADS, smem, stream>>>(
      x, w1, b1, w2, b2, out, n, heads, F);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x [n, heads*d]; w1 [heads, d, f]; b1 [heads, f]; w2 [heads, f, d];
// b2 [heads, d]; out [n, heads*d].  d in {32, 64, 128, 256}, f % 32 == 0.
// Returns cudaGetLastError() after the launch.
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
