// STMA global linear attention over the joint text + motion sequence
// (kernel K3).
//
// Replaces the Pallas kernel stma_linear_attention of
// motioncraft_tpu/ops/pallas_stma_attention.py.  For one (batch b, head h):
//   keys    k_txt[j] = txt[b, j, :d]      + (1 - tcond[b]) * -1e6
//           k_mot[t] = mot[b, t, h, d:2d] + (1 - mask[b, t]) * -1e6
//   values  v_txt[j] = txt[b, j, d:]  * tcond[b]
//           v_mot[t] = mot[b, t, h, 2d:3d] * mask[b, t]
//   key softmax over the joint sequence, per channel c (two-part max/sum)
//   A[c, l] = sum_n softmax(k)[n, c] * v[n, l]                 (d x d)
//   out[b, t, h, :] = softmax_c(mot[b, t, h, 3d:]) @ A
//
// Bound: at the flagship (T=196, 77 text rows, d=128) one cell does
// 2*(T+TXT)*d*d + 2*T*d*d = 15 Mflop against 0.6 MB moved, about 26 flops
// per byte: just above the card's ridge for CUDA-core f32 (67 TFLOP/s over
// 3.35 TB/s, 20 flops per byte), so f32 operations bound it, narrowly.
// Design: one CTA per (b, h) reads its head's lanes of the interleaved
// projection directly (no transposes, no concatenation: the joint softmax is
// a two-part normalization).  A lives in registers while it accumulates
// (8x8 per thread at d=128), then in dynamic shared memory (64 KB) for the
// Q A product; nothing but the output reaches device memory.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int ROWS = 32;          // sequence rows staged per chunk
constexpr float NEG = -1000000.0f;

template <int D>
constexpr int smem_floats() {
  // A [D][D] + two staging tiles [ROWS][D] + kmax/den [D] + partials
  return D * D + 2 * ROWS * D + 2 * D + 2 * THREADS;
}

template <int D>
__global__ void __launch_bounds__(THREADS)
stma_attention_kernel(const float* __restrict__ mot,   // [B, T, H, 4D]
                      const float* __restrict__ txt,   // [B, TXT, 2D]
                      const float* __restrict__ mask,  // [B, T]
                      const float* __restrict__ tcond, // [B]
                      float* __restrict__ out,         // [B, T, H, D]
                      int T, int TXT, int H) {
  static_assert(D % 16 == 0 && D <= 128 && THREADS % D == 0, "unsupported D");
  constexpr int P = THREADS / D;      // row partitions of the key reduction
  constexpr int TI = D / 16;          // A micro-tile: rows ty + 16 i
  constexpr int OI = ROWS / 16;       // output micro-tile rows ty + 16 i
  extern __shared__ __align__(16) float smem[];
  float* As = smem;                   // [D][D]
  float* s0 = As + D * D;             // [ROWS][D]  keys, then queries
  float* s1 = s0 + ROWS * D;          // [ROWS][D]  values
  float* kmax = s1 + ROWS * D;        // [D]
  float* den = kmax + D;              // [D]
  float* part = den + D;              // [2 * THREADS]

  const int b = blockIdx.x, h = blockIdx.y, tid = threadIdx.x;
  const int N = TXT + T;
  const long mrow = (long)H * 4 * D;  // stride of a motion row
  const float* motb = mot + (long)b * T * mrow + (long)h * 4 * D;
  const float* txtb = txt + (long)b * TXT * 2 * D;
  const float* maskb = mask + (long)b * T;
  const float tc = tcond[b];
  const float tneg = (1.0f - tc) * NEG;

  // masked key n of channel c, n over text rows then motion rows
  auto key = [&](int n, int c) -> float {
    if (n < TXT) return txtb[(long)n * 2 * D + c] + tneg;
    const int t = n - TXT;
    return motb[t * mrow + D + c] + (1.0f - maskb[t]) * NEG;
  };

  // 1. per-channel max and sum of exp over the joint sequence
  {
    const int c = tid % D, p = tid / D;
    float m = -INFINITY;
    for (int n = p; n < N; n += P) m = fmaxf(m, key(n, c));
    part[tid] = m;
    __syncthreads();
    if (p == 0) {
      for (int q = 1; q < P; ++q) m = fmaxf(m, part[q * D + c]);
      kmax[c] = m;
    }
    __syncthreads();
    const float mx = kmax[c];
    float s = 0.f;
    for (int n = p; n < N; n += P) s += expf(key(n, c) - mx);
    part[THREADS + tid] = s;
    __syncthreads();
    if (p == 0) {
      for (int q = 1; q < P; ++q) s += part[THREADS + q * D + c];
      den[c] = s;
    }
    __syncthreads();
  }

  // 2. A = softmax(K)^T V, accumulated in registers over staged row chunks;
  //    thread (ty, tx) of the 16 x 16 grid owns A[ty + 16 i][tx + 16 j]
  const int ty = tid / 16, tx = tid % 16;
  float acc[TI][TI];
#pragma unroll
  for (int i = 0; i < TI; ++i)
#pragma unroll
    for (int j = 0; j < TI; ++j) acc[i][j] = 0.f;
  for (int n0 = 0; n0 < N; n0 += ROWS) {
    for (int i = tid; i < ROWS * D; i += THREADS) {
      const int r = i / D, c = i % D, n = n0 + r;
      float e = 0.f, v = 0.f;
      if (n < N) {
        e = expf(key(n, c) - kmax[c]) / den[c];
        if (n < TXT) {
          v = txtb[(long)n * 2 * D + D + c] * tc;
        } else {
          const int t = n - TXT;
          v = motb[t * mrow + 2 * D + c] * maskb[t];
        }
      }
      s0[i] = e;
      s1[i] = v;
    }
    __syncthreads();
    for (int r = 0; r < ROWS; ++r) {
      float ev[TI], vv[TI];
#pragma unroll
      for (int i = 0; i < TI; ++i) ev[i] = s0[r * D + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TI; ++j) vv[j] = s1[r * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TI; ++i)
#pragma unroll
        for (int j = 0; j < TI; ++j) acc[i][j] = fmaf(ev[i], vv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < TI; ++i)
#pragma unroll
    for (int j = 0; j < TI; ++j) As[(ty + 16 * i) * D + tx + 16 * j] = acc[i][j];
  __syncthreads();

  // 3. per motion row: channel softmax of the query, then Q A
  const int warp = tid / 32, lane = tid % 32;
  for (int t0 = 0; t0 < T; t0 += ROWS) {
    for (int i = tid; i < ROWS * D; i += THREADS) {
      const int r = i / D, c = i % D, t = t0 + r;
      s0[i] = t < T ? motb[t * mrow + 3 * D + c] : 0.f;
    }
    __syncthreads();
    for (int r = warp; r < ROWS; r += THREADS / 32) {
      float m = -INFINITY;
      for (int c = lane; c < D; c += 32) m = fmaxf(m, s0[r * D + c]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
      float s = 0.f;
      for (int c = lane; c < D; c += 32) {
        const float e = expf(s0[r * D + c] - m);
        s0[r * D + c] = e;
        s += e;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      for (int c = lane; c < D; c += 32) s0[r * D + c] /= s;
    }
    __syncthreads();
    // thread (ty, tx) computes rows ty + 16 i, columns tx + 16 j
    float o[OI][TI];
#pragma unroll
    for (int i = 0; i < OI; ++i)
#pragma unroll
      for (int j = 0; j < TI; ++j) o[i][j] = 0.f;
    for (int c = 0; c < D; ++c) {
      float av[TI];
#pragma unroll
      for (int j = 0; j < TI; ++j) av[j] = As[c * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < OI; ++i) {
        const float q = s0[(ty + 16 * i) * D + c];
#pragma unroll
        for (int j = 0; j < TI; ++j) o[i][j] = fmaf(q, av[j], o[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < OI; ++i) {
      const int t = t0 + ty + 16 * i;
      if (t < T) {
        float* orow = out + (((long)b * T + t) * H + h) * D;
#pragma unroll
        for (int j = 0; j < TI; ++j) orow[tx + 16 * j] = o[i][j];
      }
    }
    __syncthreads();
  }
}

template <int D>
int launch(const float* mot, const float* txt, const float* mask,
           const float* tcond, float* out, int B, int T, int TXT, int H,
           cudaStream_t stream) {
  const int smem = smem_floats<D>() * sizeof(float);
  cudaFuncSetAttribute(stma_attention_kernel<D>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  stma_attention_kernel<D><<<dim3(B, H), THREADS, smem, stream>>>(
      mot, txt, mask, tcond, out, T, TXT, H);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// motion_feat [B, T, H, 4d]; text_feat [B, TXT, 2d]; src_mask [B, T] (1 =
// valid); text_cond [B] (1 = text on); out [B, T, H, d].  d in {16, 32, 64,
// 128}.  Returns cudaGetLastError() after the launch.
extern "C" int mc_stma_attention(const void* motion_feat, const void* text_feat,
                                 const void* src_mask, const void* text_cond,
                                 void* out, int B, int T, int TXT, int H, int d,
                                 void* stream) {
  auto m = static_cast<const float*>(motion_feat);
  auto t = static_cast<const float*>(text_feat);
  auto k = static_cast<const float*>(src_mask);
  auto c = static_cast<const float*>(text_cond);
  auto o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16: return launch<16>(m, t, k, c, o, B, T, TXT, H, s);
    case 32: return launch<32>(m, t, k, c, o, B, T, TXT, H, s);
    case 64: return launch<64>(m, t, k, c, o, B, T, TXT, H, s);
    case 128: return launch<128>(m, t, k, c, o, B, T, TXT, H, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
