// bucket_scatter: the stable within-bucket slot of every row at its original
// position, plus per-bucket counts, for bucket ids in [0, P] (P, and any id
// outside [0, P), marks an invalid row: slot 0, counted nowhere).
//
// Replaces the TPU kernel kernels/hash_partition/hash_partition.py
// (bucket_ranks_pallas).  That kernel walks 1024-row blocks in order,
// ranking each block with a (1024, P) one-hot cumsum and carrying the (P,)
// histogram in VMEM; Hopper blocks run in parallel and in no order.
// Design: a stable radix-partition step over 4096-row tiles, P <= 256.
//   pass 1  per-tile P-bin histograms (shared-memory atomics), stored
//           bucket-major: hist[b * ntiles + tile];
//   pass 2  one block per bucket scans its row of tile counts (exclusive)
//           and writes the bucket's total;
//   pass 3  each tile ranks its rows in 16 rounds of 256 in row order.
//           Inside a warp, __match_any_sync finds the lanes with the same
//           bucket and popc of the lower ones gives the rank; across the 8
//           warps of a round a shared per-warp histogram gives the offset;
//           a shared running histogram carries the tile's earlier rounds.
// Stability is the contract (the exchange preserves source row order):
// every term above counts only rows that come earlier in the input.
// Bound: bytes (read dest twice, write ranks once).

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ROUNDS = 16;
constexpr int TILE = THREADS * ROUNDS;
constexpr int MAX_P = 256;
constexpr int SCAN_THREADS = 1024;

__global__ void __launch_bounds__(THREADS)
tile_hist(const int* __restrict__ dest, int* __restrict__ hist, long long n,
          int P, int ntiles) {
  __shared__ int h[MAX_P];
  for (int b = threadIdx.x; b < P; b += THREADS) h[b] = 0;
  __syncthreads();
  const long long base = (long long)blockIdx.x * TILE;
  for (int k = 0; k < ROUNDS; ++k) {
    const long long g = base + k * THREADS + threadIdx.x;
    if (g < n) {
      const int d = dest[g];
      if (d >= 0 && d < P) atomicAdd(&h[d], 1);
    }
  }
  __syncthreads();
  for (int b = threadIdx.x; b < P; b += THREADS)
    hist[(long long)b * ntiles + blockIdx.x] = h[b];
}

__global__ void __launch_bounds__(SCAN_THREADS)
scan_buckets(int* __restrict__ hist, int* __restrict__ counts, int ntiles) {
  __shared__ int warp_sums[32];
  int* row = hist + (long long)blockIdx.x * ntiles;
  int carry = 0;
  for (int base = 0; base < ntiles; base += SCAN_THREADS) {
    const int i = base + threadIdx.x;
    const int v = i < ntiles ? row[i] : 0;
    int total;
    const int excl = block_exclusive_scan<int, SCAN_THREADS>(v, warp_sums, total);
    if (i < ntiles) row[i] = carry + excl;
    carry += total;
  }
  if (threadIdx.x == 0) counts[blockIdx.x] = carry;
}

__global__ void __launch_bounds__(THREADS)
tile_rank(const int* __restrict__ dest, int* __restrict__ ranks,
          const int* __restrict__ offsets, long long n, int P, int ntiles) {
  __shared__ int run[MAX_P];             // rows of this tile already ranked
  __shared__ int tile_off[MAX_P];        // rows of earlier tiles
  __shared__ int warp_hist[WARPS][MAX_P];
  for (int b = threadIdx.x; b < P; b += THREADS) {
    run[b] = 0;
    tile_off[b] = offsets[(long long)b * ntiles + blockIdx.x];
#pragma unroll
    for (int w = 0; w < WARPS; ++w) warp_hist[w][b] = 0;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const unsigned lower = (1u << lane) - 1u;
  const long long base = (long long)blockIdx.x * TILE;
  for (int r = 0; r < ROUNDS; ++r) {
    const long long row0 = base + (long long)r * THREADS;
    if (row0 >= n) break;                // uniform across the block
    const long long g = row0 + threadIdx.x;
    const int d = g < n ? dest[g] : -1;
    const bool valid = d >= 0 && d < P;
    const unsigned peers = __match_any_sync(FULL_MASK, valid ? d : -1);
    const int in_warp = __popc(peers & lower);
    if (valid && in_warp == 0) warp_hist[wid][d] = __popc(peers);
    __syncthreads();
    if (g < n) {
      int rank = 0;
      if (valid) {
        rank = tile_off[d] + run[d] + in_warp;
        for (int w = 0; w < wid; ++w) rank += warp_hist[w][d];
      }
      ranks[g] = rank;
    }
    __syncthreads();
    for (int b = threadIdx.x; b < P; b += THREADS) {
      int s = 0;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        s += warp_hist[w][b];
        warp_hist[w][b] = 0;
      }
      run[b] += s;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

int bucket_scatter_tile() { return TILE; }

int bucket_scatter_max_p() { return MAX_P; }

// scratch: P * ceil(n / TILE) int32 cells.
int bucket_scatter(const void* dest, void* ranks, void* counts, void* scratch,
                   long long n, int P, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ntiles = static_cast<int>((n + TILE - 1) / TILE);
  const int* d = static_cast<const int*>(dest);
  int* hist = static_cast<int*>(scratch);
  tile_hist<<<ntiles, THREADS, 0, s>>>(d, hist, n, P, ntiles);
  scan_buckets<<<P, SCAN_THREADS, 0, s>>>(hist, static_cast<int*>(counts),
                                          ntiles);
  tile_rank<<<ntiles, THREADS, 0, s>>>(d, static_cast<int*>(ranks), hist, n,
                                       P, ntiles);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
