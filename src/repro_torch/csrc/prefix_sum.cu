// prefix_sum: inclusive, dtype-preserving prefix sum of a 1-D int32 or
// float32 array.
//
// Replaces the TPU kernel kernels/stream_compact/stream_compact.py
// (prefix_sum_pallas).  That kernel walks 2048-row blocks in order and
// carries the running total in one VMEM cell; Hopper runs blocks in
// parallel and in no order, so nothing can be carried from block to block.
// Design: the reduce-then-scan skeleton of scan.cuh over 4096-row tiles
// under the sum monoid (tile sums, a scan of the tile sums, then the in-tile
// scan with the tile's offset in front).  The sum commutes, so pass 1 sums
// its tile straight from global memory without staging it.
// Bound: bytes.  The function reads n values and writes n values; the kernel
// reads the input twice (passes 1 and 3).  A single-pass decoupled look-back
// would read it once and is the later, faster design.
//
// int32 sums run in uint32 arithmetic, so wrap-around is defined and the
// result is exact modulo 2^32 like the reference.  float32 sums are taken in
// another order than a sequential scan; they agree within rounding.

#include "scan.cuh"

namespace {

template <typename V>
struct PrefixSumOp : SumOp<V> {
  using T = V;
  static constexpr bool commutative = true;
  const V* x;
  V* out;
  __device__ __forceinline__ T load(long long g) const { return x[g]; }
  __device__ __forceinline__ void store(long long g, T v) const { out[g] = v; }
};

template <typename V>
int launch(const void* x, void* out, void* scratch, long long n,
           void* stream) {
  PrefixSumOp<V> op;
  op.x = static_cast<const V*>(x);
  op.out = static_cast<V*>(out);
  return scan::run(op, scratch, n, stream);
}

}  // namespace

extern "C" {

// Rows per tile; the caller allocates ceil(n / tile) scratch cells.
int prefix_sum_tile() { return scan::TILE; }

int prefix_sum_i32(const void* x, void* out, void* scratch, long long n,
                   void* stream) {
  return launch<uint32_t>(x, out, scratch, n, stream);
}

int prefix_sum_f32(const void* x, void* out, void* scratch, long long n,
                   void* stream) {
  return launch<float>(x, out, scratch, n, stream);
}

}  // extern "C"
