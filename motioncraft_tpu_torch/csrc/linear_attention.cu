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
//
// bf16 (bf16 inference of the baselines, whose Efficient and
// semantics-modulated attentions hand K5 bf16 q, k and v): the storage type S
// of q, k, v and out is a template parameter.  The kernel loads bf16 through
// the same strides, widens to f32 and stores bf16; bytes bound K5, so bf16
// storage halves its bound.  It rounds where the Pallas kernel rounds on a
// bf16 value (pallas_attention.py _kernel: the merged A and the query softmax
// to bf16, then q A accumulated in f32) except for the key softmax, which
// stays the cell's unrounded online softmax (common.cuh, RB): rounding it
// needs the sequence's max and sum before the first product, a second read
// of the keys.  q A then multiplies bf16-exact operands and runs as one TF32
// pass instead of 3xTF32.
#include "common.cuh"

namespace {

template <int D, class S, bool RB>
__global__ void __launch_bounds__(mc::LA_THREADS, 2)
linear_attention_kernel(const S* __restrict__ q, const S* __restrict__ k,
                        const S* __restrict__ v, S* __restrict__ out,
                        int T, int N, int H, long long qsb, long long qsn,
                        long long qsh, long long ksb, long long ksn, long long ksh,
                        long long vsb, long long vsn, long long vsh) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.x / mc::LaCell<D>::G, h = blockIdx.y;
  const S* kb = k + b * ksb + h * ksh;
  const S* vb = v + b * vsb + h * vsh;
  auto key = [&](int n, int c) -> float4 { return mc::load4(kb + n * ksn + c); };
  auto value = [&](int n, int c) -> float4 { return mc::load4(vb + n * vsn + c); };
  mc::linear_attention_cell<D, RB>(N, key, value, T, q + b * qsb + h * qsh, (long)qsn,
                                   out + ((long)b * T * H + h) * D, (long)H * D, smem);
}

template <int D, class S, bool RB>
int launch(const S* q, const S* k, const S* v, S* out, int B, int T, int N, int H,
           const long long* s, cudaStream_t stream) {
  return mc::launch_cells<D>(linear_attention_kernel<D, S, RB>, B, H, stream, q, k, v, out,
                             T, N, H, s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7],
                             s[8]);
}

template <class S, bool RB>
int dispatch(const void* q, const void* k, const void* v, void* out, int B, int T, int N,
             int H, int d, const long long* strides, void* stream) {
  auto qp = static_cast<const S*>(q);
  auto kp = static_cast<const S*>(k);
  auto vp = static_cast<const S*>(v);
  auto o = static_cast<S*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16: return launch<16, S, RB>(qp, kp, vp, o, B, T, N, H, strides, s);
    case 32: return launch<32, S, RB>(qp, kp, vp, o, B, T, N, H, strides, s);
    case 64: return launch<64, S, RB>(qp, kp, vp, o, B, T, N, H, strides, s);
    case 128: return launch<128, S, RB>(qp, kp, vp, o, B, T, N, H, strides, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
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
  return dispatch<float, false>(q, k, v, out, B, T, N, H, d, strides, stream);
}

// The same on bf16 q, k, v and out (8-byte aligned; strides multiples of 4),
// rounding as the Pallas kernel does on bf16 (above).  Returns
// cudaGetLastError() after the launch.
extern "C" int mc_linear_attention_bf16(const void* q, const void* k, const void* v,
                                        void* out, int B, int T, int N, int H, int d,
                                        const long long* strides, void* stream) {
  return dispatch<mc::bf16, true>(q, k, v, out, B, T, N, H, d, strides, stream);
}
