// Reduce-then-scan over tiles under any associative operator: the skeleton
// of the scans (prefix_sum.cu, segment_scan.cu, segment_rank.cu).
//
// A TPU kernel of this kind walks its blocks in order and carries the
// running value from one block to the next in VMEM.  Hopper runs blocks in
// parallel and in no order, so the carry becomes three passes:
//   pass 1  one block per TILE rows combines its tile into one aggregate;
//   pass 2  one block of 1024 threads scans the tile aggregates in place
//           (exclusive, looping with a carry), giving each tile its carry-in;
//   pass 3  one block per tile scans its tile (ITEMS consecutive rows per
//           thread, then a block scan of the thread aggregates), combines
//           the carry-in in front, and stores every row.
// The rows are read twice (passes 1 and 3) and written once.
//
// An operator `Op` supplies the monoid and its I/O:
//   using T                        the scanned value (words of 4 bytes)
//   static constexpr bool commutative
//                                  true if combine commutes: pass 1 then
//                                  combines rows in load order, straight
//                                  from global memory, without staging
//   T identity()                   neutral element
//   T combine(T earlier, T later)  associative
//   T load(long long g)            row g's element
//   void store(long long g, T v)   row g's inclusive result
#pragma once

#include "common.cuh"

namespace scan {

constexpr int THREADS = 256;
constexpr int ITEMS = 16;
constexpr int TILE = THREADS * ITEMS;
constexpr int SCAN_THREADS = 1024;

template <class Op>
__device__ __forceinline__ void stage(const Op& op, typename Op::T* tile,
                                      long long base, long long n) {
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const int i = k * THREADS + threadIdx.x;
    const long long g = base + i;
    tile[pad(i)] = g < n ? op.load(g) : op.identity();
  }
}

template <class Op>
__global__ void __launch_bounds__(THREADS)
tile_reduce(Op op, typename Op::T* __restrict__ aggs, long long n) {
  using T = typename Op::T;
  __shared__ T warp_buf[32];
  const long long base = (long long)blockIdx.x * TILE;
  T acc = op.identity();
  if constexpr (Op::commutative) {
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      const long long g = base + k * THREADS + threadIdx.x;
      if (g < n) acc = op.combine(acc, op.load(g));
    }
  } else {
    __shared__ T tile[TILE + TILE / 32];
    stage(op, tile, base, n);
    __syncthreads();
    const int first = threadIdx.x * ITEMS;
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) acc = op.combine(acc, tile[pad(first + j)]);
  }
  T total;
  block_exclusive_scan<T, THREADS>(acc, warp_buf, total, op);
  if (threadIdx.x == 0) aggs[blockIdx.x] = total;
}

template <class Op>
__global__ void __launch_bounds__(SCAN_THREADS)
scan_aggregates(Op op, typename Op::T* __restrict__ aggs, int ntiles) {
  using T = typename Op::T;
  __shared__ T warp_buf[32];
  T carry = op.identity();
  for (int base = 0; base < ntiles; base += SCAN_THREADS) {
    const int i = base + threadIdx.x;
    const T v = i < ntiles ? aggs[i] : op.identity();
    T total;
    const T excl = block_exclusive_scan<T, SCAN_THREADS>(v, warp_buf, total, op);
    if (i < ntiles) aggs[i] = op.combine(carry, excl);
    carry = op.combine(carry, total);
  }
}

template <class Op>
__global__ void __launch_bounds__(THREADS)
tile_scan(Op op, const typename Op::T* __restrict__ carry_in, long long n) {
  using T = typename Op::T;
  __shared__ T tile[TILE + TILE / 32];
  __shared__ T warp_buf[32];
  const long long base = (long long)blockIdx.x * TILE;
  stage(op, tile, base, n);
  __syncthreads();
  const int first = threadIdx.x * ITEMS;
  T run[ITEMS];
  T acc = op.identity();
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    acc = op.combine(acc, tile[pad(first + j)]);
    run[j] = acc;
  }
  T total;
  const T excl = block_exclusive_scan<T, THREADS>(acc, warp_buf, total, op);
  const T pre = op.combine(carry_in[blockIdx.x], excl);
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) tile[pad(first + j)] = op.combine(pre, run[j]);
  __syncthreads();
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const int i = k * THREADS + threadIdx.x;
    const long long g = base + i;
    if (g < n) op.store(g, tile[pad(i)]);
  }
}

// Launch the three passes on `stream`; `scratch` holds ceil(n / TILE)
// values of Op::T.  Returns cudaGetLastError().
template <class Op>
int run(const Op& op, void* scratch, long long n, void* stream) {
  using T = typename Op::T;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n > 0) {
    const int ntiles = static_cast<int>((n + TILE - 1) / TILE);
    T* aggs = static_cast<T*>(scratch);
    tile_reduce<Op><<<ntiles, THREADS, 0, s>>>(op, aggs, n);
    scan_aggregates<Op><<<1, SCAN_THREADS, 0, s>>>(op, aggs, ntiles);
    tile_scan<Op><<<ntiles, THREADS, 0, s>>>(op, aggs, n);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace scan
