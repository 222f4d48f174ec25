// prefix_sum: inclusive, dtype-preserving prefix sum of a 1-D int32 or
// float32 array.
//
// Replaces the TPU kernel kernels/stream_compact/stream_compact.py
// (prefix_sum_pallas).  That kernel walks 2048-row blocks in order and
// carries the running total in one VMEM cell; Hopper runs blocks in
// parallel and in no order, so nothing can be carried from block to block.
// Design: reduce-then-scan over 4096-row tiles.
//   pass 1  one block per tile sums its tile;
//   pass 2  one block of 1024 threads scans the tile sums in place, looping
//           with a carry (2^27 rows are 32768 tiles: 32 rounds);
//   pass 3  one block per tile scans its tile (16 consecutive rows per
//           thread, then a block scan of the thread totals) and adds the
//           tile's offset.
// Bound: bytes.  The function reads n values and writes n values; the kernel
// reads the input twice (passes 1 and 3).  A single-pass decoupled look-back
// would read it once and is the later, faster design.
//
// int32 sums run in uint32 arithmetic, so wrap-around is defined and the
// result is exact modulo 2^32 like the reference.  float32 sums are taken in
// another order than a sequential scan; they agree within rounding.

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int ITEMS = 16;
constexpr int TILE = THREADS * ITEMS;
constexpr int SCAN_THREADS = 1024;

template <typename T>
__global__ void __launch_bounds__(THREADS)
tile_sums(const T* __restrict__ x, T* __restrict__ sums, long long n) {
  __shared__ T warp_sums[32];
  const long long base = (long long)blockIdx.x * TILE;
  T acc = T(0);
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const long long g = base + k * THREADS + threadIdx.x;
    if (g < n) acc += x[g];
  }
  const T total = block_sum<T, THREADS>(acc, warp_sums);
  if (threadIdx.x == 0) sums[blockIdx.x] = total;
}

template <typename T>
__global__ void __launch_bounds__(SCAN_THREADS)
scan_sums(T* __restrict__ sums, int ntiles) {
  __shared__ T warp_sums[32];
  T carry = T(0);
  for (int base = 0; base < ntiles; base += SCAN_THREADS) {
    const int i = base + threadIdx.x;
    const T v = i < ntiles ? sums[i] : T(0);
    T total;
    const T excl = block_exclusive_scan<T, SCAN_THREADS>(v, warp_sums, total);
    if (i < ntiles) sums[i] = carry + excl;
    carry += total;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
tile_scan(const T* __restrict__ x, T* __restrict__ out,
          const T* __restrict__ offsets, long long n) {
  __shared__ T tile[TILE + TILE / 32];
  __shared__ T warp_sums[32];
  const long long base = (long long)blockIdx.x * TILE;
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const int i = k * THREADS + threadIdx.x;
    const long long g = base + i;
    tile[pad(i)] = g < n ? x[g] : T(0);
  }
  __syncthreads();
  T run[ITEMS];
  T acc = T(0);
  const int first = threadIdx.x * ITEMS;
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    acc += tile[pad(first + j)];
    run[j] = acc;
  }
  T total;
  const T off = offsets[blockIdx.x] +
                block_exclusive_scan<T, THREADS>(acc, warp_sums, total);
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) tile[pad(first + j)] = off + run[j];
  __syncthreads();
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const int i = k * THREADS + threadIdx.x;
    const long long g = base + i;
    if (g < n) out[g] = tile[pad(i)];
  }
}

template <typename T>
int launch(const void* x, void* out, void* scratch, long long n,
           void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ntiles = static_cast<int>((n + TILE - 1) / TILE);
  const T* xt = static_cast<const T*>(x);
  T* sums = static_cast<T*>(scratch);
  tile_sums<T><<<ntiles, THREADS, 0, s>>>(xt, sums, n);
  scan_sums<T><<<1, SCAN_THREADS, 0, s>>>(sums, ntiles);
  tile_scan<T><<<ntiles, THREADS, 0, s>>>(xt, static_cast<T*>(out), sums, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Rows per tile; the caller allocates ceil(n / TILE) scratch cells.
int prefix_sum_tile() { return TILE; }

int prefix_sum_i32(const void* x, void* out, void* scratch, long long n,
                   void* stream) {
  return launch<uint32_t>(x, out, scratch, n, stream);
}

int prefix_sum_f32(const void* x, void* out, void* scratch, long long n,
                   void* stream) {
  return launch<float>(x, out, scratch, n, stream);
}

}  // extern "C"
