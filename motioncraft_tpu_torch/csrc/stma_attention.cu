// STMA global linear attention over the joint text + motion sequence
// (kernel K3).
//
// Replaces the Pallas kernel stma_linear_attention of
// motioncraft_tpu/ops/pallas_stma_attention.py.  For one (batch b, head h):
//   keys    k_txt[j] = txt[b, j, :d]      + (1 - tcond[b]) * -1e6
//           k_mot[t] = mot[b, t, h, d:2d] + (1 - mask[b, t]) * -1e6
//   values  v_txt[j] = txt[b, j, d:]  * tcond[b]
//           v_mot[t] = mot[b, t, h, 2d:3d] * mask[b, t]
//   key softmax over the joint sequence, per channel c
//   A[c, l] = sum_n softmax(k)[n, c] * v[n, l]                 (d x d)
//   out[b, t, h, :] = softmax_c(mot[b, t, h, 3d:]) @ A
//
// Bound: at the flagship (T=196, 77 text rows, d=128, 32 x 12 cells) the
// products are 5.9 Gflop in 3xTF32 on the tensor cores against about 157 MB
// moved (the key, value and query lanes of mot, txt, the output), so bytes
// bound it: 0.047 ms.  Design: one thread-block cluster of 4 CTAs per
// (b, h), 1536 CTAs that fill the card (common.cuh linear_attention_cell,
// shared with linear_attention.cu): each CTA reads a quarter of the joint
// sequence once, keeps an online per-channel softmax of its chunk, and the
// cluster merges the chunks through distributed shared memory, each CTA then
// producing a quarter of the query rows.  The products run in 3xTF32 on
// mma.sync.  The functors below read the head's lanes of the interleaved
// projection in place and join text and motion rows (no transposes, no
// concatenation); nothing but the output reaches device memory.
//
// bf16 (bf16 inference): the storage type S of mot, txt and out is a
// template parameter.  The kernel loads bf16, widens to f32 and runs the
// same f32 cell (cluster split, online softmax, 3xTF32 products), as the
// Pallas kernel upcasts its operands, and stores bf16.  Bytes bound it, so
// bf16 storage halves its bound.
#include "common.cuh"

namespace {

constexpr float NEG = -1000000.0f;

template <int D, class S>
__global__ void __launch_bounds__(mc::LA_THREADS, 2)
stma_attention_kernel(const S* __restrict__ mot,       // [B, T, H, 4D]
                      const S* __restrict__ txt,       // [B, TXT, 2D]
                      const float* __restrict__ mask,  // [B, T]
                      const float* __restrict__ tcond, // [B]
                      S* __restrict__ out,             // [B, T, H, D]
                      int T, int TXT, int H) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.x / mc::LaCell<D>::G, h = blockIdx.y;
  const long mrow = (long)H * 4 * D;  // stride of a motion row
  const S* motb = mot + (long)b * T * mrow + (long)h * 4 * D;
  const S* txtb = txt + (long)b * TXT * 2 * D;
  const float* maskb = mask + (long)b * T;
  const float tc = tcond[b];
  const float tneg = (1.0f - tc) * NEG;

  // the joint sequence: text rows, then motion rows; channels c..c+3
  auto key = [&](int n, int c) -> float4 {
    float4 k;
    float add;
    if (n < TXT) {
      k = mc::load4(txtb + (long)n * 2 * D + c);
      add = tneg;
    } else {
      const int t = n - TXT;
      k = mc::load4(motb + t * mrow + D + c);
      add = (1.0f - maskb[t]) * NEG;
    }
    return make_float4(k.x + add, k.y + add, k.z + add, k.w + add);
  };
  auto value = [&](int n, int c) -> float4 {
    float4 v;
    float mul;
    if (n < TXT) {
      v = mc::load4(txtb + (long)n * 2 * D + D + c);
      mul = tc;
    } else {
      const int t = n - TXT;
      v = mc::load4(motb + t * mrow + 2 * D + c);
      mul = maskb[t];
    }
    return make_float4(v.x * mul, v.y * mul, v.z * mul, v.w * mul);
  };
  mc::linear_attention_cell<D>(TXT + T, key, value, T, motb + 3 * D, mrow,
                               out + ((long)b * T * H + h) * D, (long)H * D, smem);
}

template <int D, class S>
int launch(const S* mot, const S* txt, const float* mask, const float* tcond, S* out,
           int B, int T, int TXT, int H, cudaStream_t stream) {
  return mc::launch_cells<D>(stma_attention_kernel<D, S>, B, H, stream, mot, txt,
                             mask, tcond, out, T, TXT, H);
}

template <class S>
int dispatch(const void* motion_feat, const void* text_feat, const void* src_mask,
             const void* text_cond, void* out, int B, int T, int TXT, int H, int d,
             void* stream) {
  auto m = static_cast<const S*>(motion_feat);
  auto t = static_cast<const S*>(text_feat);
  auto k = static_cast<const float*>(src_mask);
  auto c = static_cast<const float*>(text_cond);
  auto o = static_cast<S*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16: return launch<16>(m, t, k, c, o, B, T, TXT, H, s);
    case 32: return launch<32>(m, t, k, c, o, B, T, TXT, H, s);
    case 64: return launch<64>(m, t, k, c, o, B, T, TXT, H, s);
    case 128: return launch<128>(m, t, k, c, o, B, T, TXT, H, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// motion_feat [B, T, H, 4d]; text_feat [B, TXT, 2d]; src_mask [B, T] (1 =
// valid); text_cond [B] (1 = text on); out [B, T, H, d].  d in {16, 32, 64,
// 128}.  Returns cudaGetLastError() after the launch.
extern "C" int mc_stma_attention(const void* motion_feat, const void* text_feat,
                                 const void* src_mask, const void* text_cond,
                                 void* out, int B, int T, int TXT, int H, int d,
                                 void* stream) {
  return dispatch<float>(motion_feat, text_feat, src_mask, text_cond, out, B, T, TXT, H, d,
                         stream);
}

// The same with motion_feat, text_feat and out in bf16 (src_mask and
// text_cond stay f32).  Returns cudaGetLastError() after the launch.
extern "C" int mc_stma_attention_bf16(const void* motion_feat, const void* text_feat,
                                      const void* src_mask, const void* text_cond,
                                      void* out, int B, int T, int TXT, int H, int d,
                                      void* stream) {
  return dispatch<mc::bf16>(motion_feat, text_feat, src_mask, text_cond, out, B, T, TXT, H,
                            d, stream);
}

// The clusters of the d = 128 kernel that fit on the card at once
// (cudaOccupancyMaxActiveClusters).  Returns the CUDA error code.
extern "C" int mc_stma_max_active_clusters(int* clusters) {
  return mc::max_active_cells<128>(stma_attention_kernel<128, float>, clusters);
}
