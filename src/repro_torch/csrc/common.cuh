// Shared device helpers for the hand-written kernels of repro_torch.
//
// Every kernel stages a tile in shared memory with coalesced loads and then
// lets each thread walk ITEMS consecutive rows of it.  Consecutive rows of
// one thread sit ITEMS words apart, which would put a warp's reads on two
// banks; `pad` inserts one word every 32 so they spread over all 32.
#pragma once

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

#define FULL_MASK 0xffffffffu

__device__ __forceinline__ int pad(int i) { return i + (i >> 5); }

// A warp shuffle of any trivially copyable value whose size is a multiple
// of 4 bytes (scalars and the small structs of the scan monoids), one
// 32-bit word at a time; `shfl(word)` shuffles one word.
template <typename T, typename Shfl>
__device__ __forceinline__ T shfl_words(T v, Shfl shfl) {
  static_assert(sizeof(T) % 4 == 0, "shuffled values are whole 32-bit words");
  constexpr int W = sizeof(T) / 4;
  int w[W];
  memcpy(w, &v, sizeof(T));
#pragma unroll
  for (int i = 0; i < W; ++i) w[i] = shfl(w[i]);
  memcpy(&v, w, sizeof(T));
  return v;
}

template <typename T>
__device__ __forceinline__ T shfl_up_any(T v, int o) {
  return shfl_words(v, [o](int w) { return __shfl_up_sync(FULL_MASK, w, o); });
}

template <typename T>
__device__ __forceinline__ T shfl_down_any(T v, int o) {
  return shfl_words(v, [o](int w) { return __shfl_down_sync(FULL_MASK, w, o); });
}

template <typename T>
__device__ __forceinline__ T shfl_idx_any(T v, int lane) {
  return shfl_words(v, [lane](int w) { return __shfl_sync(FULL_MASK, w, lane); });
}

// TMA bulk copies into shared memory, completing on an mbarrier (the
// look-back scans and the stencils stage their tiles this way).
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One thread: make `bar` an mbarrier that completes a phase on one arrival.
__device__ __forceinline__ void bar_init(void* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
               ::"r"(smem_addr(bar)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// The same thread, once per phase: arrive on `bar` and expect `bytes` of
// bulk copies to complete on it.
__device__ __forceinline__ void bar_expect(void* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// One TMA bulk copy of `bytes` (a multiple of 16, both addresses 16-byte
// aligned) into shared memory, completing on the mbarrier `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          int bytes, void* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)), "l"(src), "r"(bytes),
      "r"(smem_addr(bar)) : "memory");
}

// Order this thread's earlier accesses to shared memory, and those the block
// barrier before it made visible, before its later bulk copies: a block
// that refills a buffer it has read calls this before the copies.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Wait until the phase of `bar` with this parity (0 for its first, then
// alternating) has completed.
__device__ __forceinline__ void bar_wait(void* bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;"
        " selp.u32 %0, 1, 0, p; }"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  }
}

// The sum monoid: the operator of the plain prefix sums.
template <typename T>
struct SumOp {
  __device__ __forceinline__ T identity() const { return T(0); }
  __device__ __forceinline__ T combine(T a, T b) const { return a + b; }
};

// Exclusive scan of one value per thread across a block of NT threads
// (NT a multiple of 32, at most 1024) under the associative operator `op`
// (`op.identity()`, `op.combine(earlier, later)`; it need not commute).
// `warp_buf` is shared scratch of 32 entries.  `total` receives the
// combination over the whole block.  The block must reach this call
// together; it synchronises internally and on exit.
template <typename T, int NT, typename Op>
__device__ __forceinline__ T block_exclusive_scan(T v, T* warp_buf, T& total,
                                                  const Op& op) {
  constexpr int NW = NT / 32;
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  T x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const T y = shfl_up_any(x, o);
    if (lane >= o) x = op.combine(y, x);
  }
  if (lane == 31) warp_buf[wid] = x;
  __syncthreads();
  if (wid == 0) {
    T w = lane < NW ? warp_buf[lane] : op.identity();
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const T y = shfl_up_any(w, o);
      if (lane >= o) w = op.combine(y, w);
    }
    if (lane < NW) warp_buf[lane] = w;
  }
  __syncthreads();
  T excl = shfl_up_any(x, 1);
  if (lane == 0) excl = op.identity();
  if (wid > 0) excl = op.combine(warp_buf[wid - 1], excl);
  total = warp_buf[NW - 1];
  __syncthreads();  // warp_buf may be reused by the caller
  return excl;
}

// The same under the sum monoid.
template <typename T, int NT>
__device__ __forceinline__ T block_exclusive_scan(T v, T* warp_sums, T& total) {
  return block_exclusive_scan<T, NT>(v, warp_sums, total, SumOp<T>{});
}
