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
// 2*(N+T)*d*d = 15 Mflop per cell against 4*(T+2N+T)*d = 0.48 MB moved; in
// 3xTF32 on the tensor cores bytes bound it: 0.055 ms.
// Design: the Pallas wrapper's transposes to [B*H, N, d] and (8, 128)
// padding are a TPU layout; here the CTAs of a cell read its head's rows of
// the [B, N, H, d] tensors in place through their strides (a column slice
// such as STMA's query lanes needs no copy), and loop over the real N only.
// The cell is K3's (common.cuh linear_attention_cell): one cluster of 4 CTAs
// per (b, h), each reading a quarter of the keys and values once, merged
// through distributed shared memory, each CTA then a quarter of the query
// rows, both products in 3xTF32 on mma.sync; nothing but the output reaches
// device memory.
#include "common.cuh"

namespace {

template <int D>
__global__ void __launch_bounds__(mc::LA_THREADS, 2)
linear_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, float* __restrict__ out,
                        int T, int N, int H, long long qsb, long long qsn,
                        long long qsh, long long ksb, long long ksn, long long ksh,
                        long long vsb, long long vsn, long long vsh) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.x / mc::LaCell<D>::G, h = blockIdx.y;
  const float* kb = k + b * ksb + h * ksh;
  const float* vb = v + b * vsb + h * vsh;
  auto key = [&](int n, int c) -> float4 {
    return *reinterpret_cast<const float4*>(kb + n * ksn + c);
  };
  auto value = [&](int n, int c) -> float4 {
    return *reinterpret_cast<const float4*>(vb + n * vsn + c);
  };
  mc::linear_attention_cell<D>(N, key, value, T, q + b * qsb + h * qsh, (long)qsn,
                               out + ((long)b * T * H + h) * D, (long)H * D, smem);
}

template <int D>
int launch(const float* q, const float* k, const float* v, float* out, int B,
           int T, int N, int H, const long long* s, cudaStream_t stream) {
  return mc::launch_cells<D>(linear_attention_kernel<D>, B, H, stream, q, k, v, out,
                             T, N, H, s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7],
                             s[8]);
}

}  // namespace

// q [B, T, H, d], k and v [B, N, H, d], each with unit stride on d, 16-byte
// aligned, and the element strides of its batch, row and head dims (each a
// multiple of 4) in strides[0..8] (q's, then k's, then v's); out
// [B, T, H, d] contiguous.  d in {16, 32, 64, 128}.
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
