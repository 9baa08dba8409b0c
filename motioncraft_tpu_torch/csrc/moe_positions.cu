// MoE slot ranks: the arrival rank of every (token, k) choice within its
// expert, and per-expert counts (kernel K4).
//
// Replaces the Pallas kernel _positions_pallas of
// motioncraft_tpu/ops/pallas_moe.py (Tutel's fast_cumsum_sub_one): for the
// flat k-major id list idx [M],
//     pos[i]    = #{ j < i : idx[j] == idx[i] }   (0 for ids outside [0, E))
//     counts[e] = #{ j : idx[j] == e }
// The TPU kernel walks the list in order, carrying running counts from one
// grid step to the next; Hopper's blocks run in no order, so this is a
// parallel two-pass block scan instead:
//   pass 1  each block of 1024 ids counts its ids per expert;
//   pass 2  each block sums the counts of the blocks before it (the
//           exclusive scan over blocks), ranks its ids inside each warp with
//           __match_any_sync, scans the per-warp counts, and writes
//           block offset + warp offset + lane rank.  The last block writes
//           the totals.
// Integer arithmetic throughout: the ranks are exact, and equal the JAX
// ranks bit for bit, which the capacity drops depend on.
// Bound: 4 bytes read and 4 written per id and a few integer operations, so
// device-memory bytes bound it; at the flagship M = 150k ids the work is a
// few microseconds and the two launches dominate.
#include "common.cuh"

namespace {

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;

__global__ void __launch_bounds__(THREADS)
count_kernel(const int* __restrict__ idx, int M, int E,
             int* __restrict__ block_counts) {
  extern __shared__ int cnt[];  // [E]
  for (int e = threadIdx.x; e < E; e += THREADS) cnt[e] = 0;
  __syncthreads();
  const long i = (long)blockIdx.x * THREADS + threadIdx.x;
  if (i < M) {
    const int e = idx[i];
    if (e >= 0 && e < E) atomicAdd(&cnt[e], 1);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < E; e += THREADS)
    block_counts[(long)blockIdx.x * E + e] = cnt[e];
}

__global__ void __launch_bounds__(THREADS)
rank_kernel(const int* __restrict__ idx, int M, int E,
            const int* __restrict__ block_counts, int* __restrict__ pos,
            int* __restrict__ counts) {
  extern __shared__ int sm[];
  int* base = sm;           // [E]  ids of this expert in earlier blocks
  int* warp_cnt = sm + E;   // [WARPS][E], then its exclusive scan over warps
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int blk = blockIdx.x;

  for (int e = tid; e < E; e += THREADS) {
    int s = 0;
    for (int b = 0; b < blk; ++b) s += block_counts[(long)b * E + e];
    base[e] = s;
  }
  for (int k = tid; k < WARPS * E; k += THREADS) warp_cnt[k] = 0;
  __syncthreads();

  const long i = (long)blk * THREADS + tid;
  const int raw = i < M ? idx[i] : -1;
  const bool valid = raw >= 0 && raw < E;
  const int e = valid ? raw : -1;  // every invalid id ranks as one group
  const unsigned peers = __match_any_sync(0xffffffffu, e);
  const int rank = __popc(peers & ((1u << lane) - 1u));
  if (valid && lane == __ffs(peers) - 1) warp_cnt[warp * E + e] = __popc(peers);
  __syncthreads();

  for (int x = tid; x < E; x += THREADS) {
    int run = 0;
    for (int w = 0; w < WARPS; ++w) {
      const int c = warp_cnt[w * E + x];
      warp_cnt[w * E + x] = run;
      run += c;
    }
  }
  __syncthreads();

  if (i < M) pos[i] = valid ? base[e] + warp_cnt[warp * E + e] + rank : 0;
  if (blk == gridDim.x - 1)
    for (int x = tid; x < E; x += THREADS)
      counts[x] = base[x] + block_counts[(long)blk * E + x];
}

}  // namespace

// idx [M] int32 expert ids; scratch [ceil(M / 1024) * E] int32; pos [M] and
// counts [E] int32 outputs.  M >= 1, 1 <= E <= 256.  Returns
// cudaGetLastError() after the two launches.
extern "C" int mc_moe_positions(const void* idx, int M, int E, void* scratch,
                                void* pos, void* counts, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto ids = static_cast<const int*>(idx);
  auto bc = static_cast<int*>(scratch);
  const int blocks = (M + THREADS - 1) / THREADS;
  count_kernel<<<blocks, THREADS, E * sizeof(int), s>>>(ids, M, E, bc);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  rank_kernel<<<blocks, THREADS, (E + WARPS * E) * sizeof(int), s>>>(
      ids, M, E, bc, static_cast<int*>(pos), static_cast<int*>(counts));
  return static_cast<int>(cudaGetLastError());
}
