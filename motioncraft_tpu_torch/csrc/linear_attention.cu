// Masked linear attention per (batch, head) (kernel K5).
//
// Replaces the Pallas kernel fused_linear_attention of
// motioncraft_tpu/ops/pallas_attention.py.  For one (batch b, head h), with
// the masks already applied by the caller (keys additively at -1e6, values
// multiplicatively):
//   A[c, l]         = sum_n softmax_n(k[b, n, h, :])[c] * v[b, n, h, l]   (d x d)
//   out[b, t, h, :] = softmax_c(q[b, t, h, :]) @ A
//
// Bound: at the flagship training step (B=32, T=196 queries, N=273 keys =
// 77 text + 196 motion, 12 heads, d=128) the two products are
// 2*(N+T)*d*d = 15 Mflop per cell against 4*(T+2N+T)*d = 0.48 MB moved,
// about 32 flops per byte: above the card's ridge for CUDA-core f32
// (67 TFLOP/s over 3.35 TB/s, 20 flops per byte), so f32 operations bound it.
// Design: the Pallas wrapper's transposes to [B*H, N, d] and (8, 128)
// padding are a TPU layout; here one CTA per (b, h) reads its head's rows of
// the [B, N, H, d] tensors in place through their strides (a column slice
// such as STMA's query lanes needs no copy), and loops over the real N only.
// The cell (common.cuh linear_attention_cell, shared with K3) keeps A in
// registers, then in shared memory; nothing but the output reaches device
// memory.  One CTA per cell is 384 CTAs at the flagship, K3's known
// weakness: few cells of long serial work fill the 132 SMs unevenly.
#include "common.cuh"

namespace {

template <int D>
__global__ void __launch_bounds__(mc::LA_THREADS)
linear_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, float* __restrict__ out,
                        int T, int N, int H, long long qsb, long long qsn,
                        long long qsh, long long ksb, long long ksn, long long ksh,
                        long long vsb, long long vsn, long long vsh) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.x, h = blockIdx.y;
  const float* kb = k + b * ksb + h * ksh;
  const float* vb = v + b * vsb + h * vsh;
  auto key = [&](int n, int c) -> float { return kb[n * ksn + c]; };
  auto value = [&](int n, int c) -> float { return vb[n * vsn + c]; };
  mc::linear_attention_cell<D>(N, key, value, T, q + b * qsb + h * qsh, (long)qsn,
                               out + ((long)b * T * H + h) * D, (long)H * D, smem);
}

template <int D>
int launch(const float* q, const float* k, const float* v, float* out, int B,
           int T, int N, int H, const long long* s, cudaStream_t stream) {
  const int smem = mc::la_smem_floats<D>() * sizeof(float);
  cudaFuncSetAttribute(linear_attention_kernel<D>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  linear_attention_kernel<D><<<dim3(B, H), mc::LA_THREADS, smem, stream>>>(
      q, k, v, out, T, N, H, s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8]);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q [B, T, H, d], k and v [B, N, H, d], each with unit stride on d and the
// element strides of its batch, row and head dims in strides[0..8] (q's,
// then k's, then v's); out [B, T, H, d] contiguous.  d in {16, 32, 64, 128}.
// Returns cudaGetLastError() after the launch.
extern "C" int mc_linear_attention(const void* q, const void* k, const void* v,
                                   void* out, int B, int T, int N, int H, int d,
                                   const long long* strides, void* stream) {
  auto qp = static_cast<const float*>(q);
  auto kp = static_cast<const float*>(k);
  auto vp = static_cast<const float*>(v);
  auto o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16: return launch<16>(qp, kp, vp, o, B, T, N, H, strides, s);
    case 32: return launch<32>(qp, kp, vp, o, B, T, N, H, strides, s);
    case 64: return launch<64>(qp, kp, vp, o, B, T, N, H, strides, s);
    case 128: return launch<128>(qp, kp, vp, o, B, T, N, H, strides, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
