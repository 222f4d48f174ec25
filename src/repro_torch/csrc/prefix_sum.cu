// prefix_sum: inclusive, dtype-preserving prefix sum of a 1-D int32 or
// float32 array.
//
// Replaces the TPU kernel src/repro/kernels/stream_compact/stream_compact.py:36
// (prefix_sum_pallas).  That kernel walks 2048-row blocks in order and
// carries the running total in one VMEM cell; Hopper runs blocks in
// parallel and in no order, so nothing can be carried from block to block.
// Design: the single-pass decoupled look-back scan of lookback.cuh over
// 5120-row tiles under the sum monoid.  Each tile's 32-bit sum is published
// in one 64-bit status word beside its flag; the look-back adds the sums of
// the tiles before it until it meets an inclusive prefix.  Forward progress
// comes from the atomic tile ticket, ordering from the packed word's
// release store and acquire loads (see lookback.cuh).
// Bound: bytes, 8 a row (the input read once, the output written once),
// which is what this kernel moves.  The reduce-then-scan it replaces read
// the input twice in three launches.
//
// int32 sums run in uint32 arithmetic, so wrap-around is defined and the
// result is exact modulo 2^32 like the reference.  float32 sums are taken in
// another order than a sequential scan (in each chunk, then across the
// chunks of a warp, the warps of a tile and the tiles in order); they agree
// within rounding, and the order is fixed, so every call gives the same
// bits (the operator is ORDERED: see lookback.cuh).

#include <type_traits>

#include "lookback.cuh"

namespace {

template <typename V>
struct PrefixSumOp : SumOp<V> {
  using T = V;
  static constexpr int INPUTS = 1;
  static constexpr bool ORDERED = std::is_floating_point<V>::value;
  // -0.0 for floats: x + -0.0 is x for every x, +0.0 included
  __device__ __forceinline__ T identity() const {
    return T(ORDERED ? -0.0f : 0.0f);
  }
  __device__ __forceinline__ T load(uint32_t a, uint32_t, long long) const {
    T v;
    memcpy(&v, &a, 4);
    return v;
  }
  __device__ __forceinline__ uint32_t store(T v, long long) const {
    uint32_t r;
    memcpy(&r, &v, 4);
    return r;
  }
  __device__ __forceinline__ bool restarts(T) const { return false; }
  __device__ __forceinline__ unsigned long long pack(T v) const {
    return store(v, 0);
  }
  __device__ __forceinline__ T unpack(unsigned long long w) const {
    return load(static_cast<uint32_t>(w), 0u, 0);
  }
};

}  // namespace

extern "C" {

// Bytes of scratch a call over n rows needs.
long long prefix_sum_scratch_bytes(long long n) {
  return lookback::scratch_bytes(n);
}

int prefix_sum_i32(const void* x, void* out, void* scratch, long long n,
                   int load, void* stream) {
  return lookback::run(PrefixSumOp<uint32_t>{}, x, nullptr, out, scratch, n,
                       load, stream);
}

int prefix_sum_f32(const void* x, void* out, void* scratch, long long n,
                   int load, void* stream) {
  return lookback::run(PrefixSumOp<float>{}, x, nullptr, out, scratch, n,
                       load, stream);
}

}  // extern "C"
