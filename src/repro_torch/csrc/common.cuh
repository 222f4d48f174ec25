// Shared device helpers for the hand-written kernels of repro_torch.
//
// Every kernel stages a tile in shared memory with coalesced loads and then
// lets each thread walk ITEMS consecutive rows of it.  Consecutive rows of
// one thread sit ITEMS words apart, which would put a warp's reads on two
// banks; `pad` inserts one word every 32 so they spread over all 32.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define FULL_MASK 0xffffffffu

__device__ __forceinline__ int pad(int i) { return i + (i >> 5); }

// Exclusive scan of one value per thread across a block of NT threads
// (NT a multiple of 32, at most 1024).  `warp_sums` is shared scratch of 32
// entries.  `total` receives the sum over the block.  The block must reach
// this call together; it synchronises internally and on exit.
template <typename T, int NT>
__device__ __forceinline__ T block_exclusive_scan(T v, T* warp_sums, T& total) {
  constexpr int NW = NT / 32;
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  T x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    T y = __shfl_up_sync(FULL_MASK, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[wid] = x;
  __syncthreads();
  if (wid == 0) {
    T w = lane < NW ? warp_sums[lane] : T(0);
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      T y = __shfl_up_sync(FULL_MASK, w, o);
      if (lane >= o) w += y;
    }
    if (lane < NW) warp_sums[lane] = w;
  }
  __syncthreads();
  const T warp_off = wid > 0 ? warp_sums[wid - 1] : T(0);
  total = warp_sums[NW - 1];
  __syncthreads();  // warp_sums may be reused by the caller
  return warp_off + x - v;
}

// Sum of one value per thread across a block of NT threads; every thread
// receives the result.
template <typename T, int NT>
__device__ __forceinline__ T block_sum(T v, T* warp_sums) {
  T total;
  block_exclusive_scan<T, NT>(v, warp_sums, total);
  return total;
}
