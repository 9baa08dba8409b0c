// MoE routing and slot ranks in one launch (kernel K4).
//
// Replaces the Pallas kernel _positions_pallas of
// motioncraft_tpu/ops/pallas_moe.py:54 (Tutel's fast_cumsum_sub_one) and,
// in route mode, the routing around it in motioncraft_tpu/models/moe.py:
// 145-260 (softmax, top-k, gate normalisation, capacity drops, the
// rank-compact dispatch tables).  For the k-major choice list
// flat = k * N + n:
//     pos[flat]  = #{ j < flat : id[j] == id[flat] }   (0 for ids outside [0, E))
//     counts[e]  = #{ j : id[j] == e }
// Positions mode takes the ids as given (K = 1).  Route mode takes the gate
// logits [N, E] and, per token, picks the top K by logit (descending, the
// lower index first on equal logits: a stable sort), the softmax over all E
// (expf) and the K gates over their sum + 1e-9; then, with capacity C and
// groups of `block` rows,
//     fill = min(counts, C),  aligned = fill rounded up to `block`,
//     ends = cumsum(aligned), offset = ends - aligned,
//     r[n, k]   = offset[e] + pos  if pos < C, else M (dropped; gate 0),
//     token_for_rank[r] = n on kept rows, 0 on the padding rows,
//     block_expert[b]   = #{ e : ends[e] <= b * block }, at most E - 1,
//     ge[n, e]  = the masked gate of the choice of e, else 0.
//
// The TPU kernel walks the list in order, carrying running counts from one
// grid step to the next.  Hopper's blocks run in no order, and the order is
// k-major, so a (token, k = 1) rank needs the totals of every k = 0 choice
// and the offsets need every count: a single-pass look-back cannot have
// them.  So this is one cooperative launch of a persistent grid (no more
// blocks than are resident at once) with one grid-wide barrier:
//   before  each block takes tiles of TILE tokens: per token, the routing in
//           registers; per (k, expert), the choices' ranks inside the tile
//           (__match_any_sync in a warp, scanned over the warps in shared
//           memory) and the tile's count into a table [tile][K][E];
//   after   each block sums the table's columns (all tiles, and the tiles
//           before its own) in parallel, derives the E-long fill, offsets
//           and ends itself (cheaper than a second barrier) and writes its
//           tokens' outputs, its share of block_expert and of the padding
//           rows of token_for_rank (disjoint from the kept rows).
// Integer arithmetic for the ranks: exact, bit for bit the JAX ranks, which
// the drops depend on.  Bound: bytes (logits in, the routing out: about
// 12 MB, 3.5 us at the flagship's 75264 motion tokens); the design spends one
// launch, sorts nothing and keeps every intermediate of the routing out of
// device memory but the per-choice rank and the [tiles, K, E] table.
#include "common.cuh"

namespace {

constexpr int TILE = 512;  // tokens (route) or ids (positions) per tile; one a thread
constexpr int WARPS = TILE / 32;
constexpr unsigned FULL = 0xffffffffu;

struct Params {
  const float* logits;  // route: [N, E]
  const int* idx;       // positions: [N] ids
  int N, E, K, capacity, block, M;
  float* gates;         // route: [N, K]
  int* r;               // route: [N, K]; positions: pos [N].  Holds each
                        // choice's (rank in its tile << 8 | expert) until the barrier
  int* token_for_rank;  // route: [M]
  int* block_expert;    // route: [M / block]
  float* ge;            // route: [N, E]
  int* counts;          // [E]
  int* table;           // [tiles][K][E] counts per tile
};

// the next of the top-K experts by logit: the largest logit not yet taken,
// the lower index first on equal logits
template <int ECAP>
__device__ __forceinline__ int pick(const float (&l)[ECAP], int E, unsigned long long& taken,
                                    float& value) {
  int best = -1;
  float v = 0.f;
#pragma unroll
  for (int e = 0; e < ECAP; ++e) {
    if (e < E && !((taken >> e) & 1ull) && (best < 0 || l[e] > v)) {
      best = e;
      v = l[e];
    }
  }
  taken |= 1ull << best;
  value = v;
  return best;
}

// ECAP = 0: positions mode; else route mode with E <= ECAP
template <int ECAP>
__global__ void __launch_bounds__(TILE) route_kernel(Params p) {
  constexpr bool ROUTE = ECAP > 0;
  constexpr int LCAP = ROUTE ? ECAP : 1;
  extern __shared__ int sm[];
  const int E = p.E, K = ROUTE ? p.K : 1, C = K * E, P = C > TILE ? C : TILE;
  int* warp_cnt = sm;                  // [WARPS][E], then its scan over the warps
  int* before = warp_cnt + WARPS * E;  // [P] partial sums, then [K][E] ranks' bases
  int* total = before + P;             // [P] partial sums, then [K][E] totals
  int* cnt = total + P;                // [E] counts
  int* fill = cnt + E;                 // [E] min(counts, capacity)
  int* offset = fill + E;              // [E] first row of each expert
  int* ends = offset + E;              // [E] its aligned end
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tiles = (p.N + TILE - 1) / TILE;

  // 1. route the tile's tokens and rank their choices inside the tile
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int n = tile * TILE + tid;
    const bool in = n < p.N;
    float l[LCAP];
    float mx = 0.f, sum = 0.f, ksum = 0.f;
    if constexpr (ROUTE) {
      const long end = (long)min(p.N, (tile + 1) * TILE) * E;
      for (long i = (long)tile * TILE * E + tid; i < end; i += TILE) p.ge[i] = 0.f;
      mx = -INFINITY;
#pragma unroll
      for (int e = 0; e < ECAP; ++e) {
        l[e] = in && e < E ? __ldg(p.logits + (long)n * E + e) : -INFINITY;
        mx = fmaxf(mx, l[e]);
      }
#pragma unroll
      for (int e = 0; e < ECAP; ++e)
        if (e < E) sum += expf(l[e] - mx);
      unsigned long long taken = 0;
      for (int k = 0; k < K; ++k) {
        float v;
        pick(l, E, taken, v);
        ksum += expf(v - mx) / sum;
      }
    }
    unsigned long long taken = 0;
    for (int k = 0; k < K; ++k) {
      int e;
      if constexpr (ROUTE) {
        float v;
        e = pick(l, E, taken, v);
        if (in) p.gates[(long)n * K + k] = expf(v - mx) / sum / (ksum + 1e-9f);
        if (!in) e = -1;
      } else {
        const int raw = in ? p.idx[n] : -1;
        e = raw >= 0 && raw < E ? raw : -1;  // ids outside [0, E) rank as one group
      }
      for (int i = tid; i < WARPS * E; i += TILE) warp_cnt[i] = 0;
      __syncthreads();
      const unsigned peers = __match_any_sync(FULL, e);
      if (e >= 0 && lane == __ffs(peers) - 1) warp_cnt[warp * E + e] = __popc(peers);
      __syncthreads();
      for (int x = tid; x < E; x += TILE) {
        int run = 0;
        for (int w = 0; w < WARPS; ++w) {
          const int c = warp_cnt[w * E + x];
          warp_cnt[w * E + x] = run;
          run += c;
        }
        p.table[((long)tile * K + k) * E + x] = run;
      }
      __syncthreads();
      if (in) {
        const int rank = e < 0 ? 0 : warp_cnt[warp * E + e] + __popc(peers & ((1u << lane) - 1u));
        p.r[(long)n * K + k] = e < 0 ? -1 : rank << 8 | e;
      }
      __syncthreads();  // warp_cnt is cleared next
    }
  }

  cooperative_groups::this_grid().sync();

  // 2. per own tile: the counts of every tile and of the tiles before it,
  // column (k, e) of the table summed by S threads in parallel
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int S = C >= TILE ? 1 : TILE / C;
    for (int i = tid; i < C * S; i += TILE) {
      const int c = i % C, s = i / C;
      int b = 0, t = 0;
      for (int row = s; row < tiles; row += S) {
        const int v = __ldcg(p.table + (long)row * C + c);  // other blocks' writes: not via L1
        t += v;
        b += row < tile ? v : 0;
      }
      before[i] = b;
      total[i] = t;
    }
    __syncthreads();
    for (int c = tid; c < C; c += TILE)
      for (int s = 1; s < S; ++s) {
        before[c] += before[s * C + c];
        total[c] += total[s * C + c];
      }
    __syncthreads();
    if (tid < E) {  // k-major: choice k of expert e follows every choice k' < k
      int run = 0;
      for (int k = 0; k < K; ++k) {
        const int t = total[k * E + tid];
        before[k * E + tid] += run;
        run += t;
      }
      cnt[tid] = run;
      if (blockIdx.x == 0 && tile == 0) p.counts[tid] = run;
    }
    __syncthreads();
    if (ROUTE && tid == 0) {
      int end = 0;
      for (int e = 0; e < E; ++e) {
        const int f = min(cnt[e], p.capacity);
        fill[e] = f;
        offset[e] = end;
        end += (f + p.block - 1) / p.block * p.block;
        ends[e] = end;
      }
    }
    __syncthreads();

    const int n = tile * TILE + tid;
    if (n < p.N) {
      if constexpr (ROUTE) {
        for (int k = 0; k < K; ++k) {
          const long j = (long)n * K + k;
          const int code = p.r[j], e = code & 0xff;
          const int pos = before[k * E + e] + (code >> 8);
          const bool keep = pos < p.capacity;
          const int row = keep ? offset[e] + pos : p.M;
          const float g = p.gates[j] * (keep ? 1.f : 0.f);
          p.r[j] = row;
          p.gates[j] = g;
          p.ge[(long)n * E + e] = g;
          if (keep) p.token_for_rank[row] = n;
        }
      } else {
        const int code = p.r[n];
        p.r[n] = code < 0 ? 0 : before[code & 0xff] + (code >> 8);
      }
    }
    __syncthreads();  // the shared sums are rewritten for the next tile
  }

  // 3. route mode: block_expert and the padding rows of token_for_rank, a
  // grid-stride share each (every block has the E-long arrays)
  if constexpr (ROUTE) {
    const int nb = p.M / p.block;
    for (long i = (long)blockIdx.x * TILE + tid; i < p.M; i += (long)gridDim.x * TILE) {
      int e = 0;
      for (int x = 0; x < E; ++x) e += ends[x] <= i;
      if (e >= E || i >= offset[e] + fill[e]) p.token_for_rank[i] = 0;
      if (i < nb) {
        int be = 0;
        for (int x = 0; x < E; ++x) be += ends[x] <= i * p.block;
        p.block_expert[i] = min(be, E - 1);
      }
    }
  }
}

template <int ECAP>
int launch(Params p, cudaStream_t stream) {
  const int C = (ECAP > 0 ? p.K : 1) * p.E;
  const int smem = (WARPS * p.E + 2 * (C > TILE ? C : TILE) + 4 * p.E) * sizeof(int);
  // resident blocks per SM for this shared-memory size, cached per device
  static int cached_dev = -1, cached_smem = -1, cached_blocks = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev != cached_dev || smem != cached_smem) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, route_kernel<ECAP>, TILE,
                                                          smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    cached_dev = dev, cached_smem = smem, cached_blocks = per_sm * sms;
  }
  const int tiles = (p.N + TILE - 1) / TILE;
  const int grid = tiles < cached_blocks ? tiles : cached_blocks;
  void* args[] = {&p};
  // refused (cudaErrorCooperativeLaunchTooLarge) unless every block is resident
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(route_kernel<ECAP>), dim3(grid),
                                    dim3(TILE), args, smem, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Route mode.  logits [N, E] f32; outputs gates [N, K] f32, r [N, K],
// token_for_rank [M], block_expert [M / block], ge [N, E] f32, counts [E]
// (int32); table [ceil(N / 512) * K * E] int32 scratch.  N >= 1,
// 1 <= K <= E <= 64, capacity >= 1, block >= 1, M >= the aligned rows.
// Returns the CUDA error code of the launch.
extern "C" int mc_moe_route(const void* logits, int N, int E, int K, int capacity, int block,
                            int M, void* gates, void* r, void* token_for_rank,
                            void* block_expert, void* ge, void* counts, void* table,
                            void* stream) {
  Params p = {};
  p.logits = static_cast<const float*>(logits);
  p.N = N, p.E = E, p.K = K, p.capacity = capacity, p.block = block, p.M = M;
  p.gates = static_cast<float*>(gates);
  p.r = static_cast<int*>(r);
  p.token_for_rank = static_cast<int*>(token_for_rank);
  p.block_expert = static_cast<int*>(block_expert);
  p.ge = static_cast<float*>(ge);
  p.counts = static_cast<int*>(counts);
  p.table = static_cast<int*>(table);
  auto s = static_cast<cudaStream_t>(stream);
  return E <= 16 ? launch<16>(p, s) : launch<64>(p, s);
}

// Positions mode.  idx [M] int32 expert ids; table [ceil(M / 512) * E]
// int32 scratch; pos [M] and counts [E] int32 outputs.  M >= 1,
// 1 <= E <= 256.  Returns the CUDA error code of the launch.
extern "C" int mc_moe_positions(const void* idx, int M, int E, void* table, void* pos,
                                void* counts, void* stream) {
  Params p = {};
  p.idx = static_cast<const int*>(idx);
  p.N = M, p.E = E, p.K = 1;
  p.r = static_cast<int*>(pos);
  p.counts = static_cast<int*>(counts);
  p.table = static_cast<int*>(table);
  return launch<0>(p, static_cast<cudaStream_t>(stream));
}
