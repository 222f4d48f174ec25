// segment_scan: segmented inclusive sum of a 1-D int32 or float32 array;
// boundary[i] != 0 starts a new segment at row i.  The output keeps the
// input's dtype.
//
// Replaces the TPU kernel kernels/segment_scan/segment_scan.py
// (segment_scan_pallas).  That kernel runs a Hillis-Steele ladder of the
// segmented monoid inside each 2048-row block and carries the last row's
// value to the next block in one VMEM cell, which needs the TPU's in-order
// grid.  Here the same monoid
//     (v1, f1) + (v2, f2) = (f2 ? v2 : v1 + v2, f1 | f2)
// runs through the reduce-then-scan skeleton of scan.cuh: tile aggregates
// (sum since the tile's last head, and whether it holds a head), a scan of
// the aggregates, then the in-tile scan with the carry-in combined in front,
// which adds it only to rows before the tile's first head.
// Bound: bytes (x and boundary read, the output written: 12 bytes a row);
// the kernel reads its inputs twice.
//
// int32 sums run in uint32 arithmetic, so wrap-around is defined and the
// result is exact modulo 2^32.  float32 sums are taken in another order than
// the plain version's (a global cumsum minus the running total before each
// segment); they agree within rounding of the running sum of |x|.

#include "scan.cuh"

namespace {

template <typename V>
struct Seg {
  V v;          // sum since the last segment head (or since the start)
  uint32_t f;   // 1 if a segment head lies in the span
};

template <typename V>
struct SegScanOp {
  using T = Seg<V>;
  static constexpr bool commutative = false;
  const V* x;
  const int* boundary;
  V* out;
  __device__ __forceinline__ T identity() const { return T{V(0), 0u}; }
  __device__ __forceinline__ T combine(T a, T b) const {
    return T{b.f ? b.v : a.v + b.v, a.f | b.f};
  }
  __device__ __forceinline__ T load(long long g) const {
    return T{x[g], boundary[g] != 0 ? 1u : 0u};
  }
  __device__ __forceinline__ void store(long long g, T t) const { out[g] = t.v; }
};

template <typename V>
int launch(const void* x, const void* boundary, void* out, void* scratch,
           long long n, void* stream) {
  const SegScanOp<V> op{static_cast<const V*>(x),
                        static_cast<const int*>(boundary), static_cast<V*>(out)};
  return scan::run(op, scratch, n, stream);
}

}  // namespace

extern "C" {

// Rows per tile and bytes per tile aggregate: the caller allocates
// ceil(n / tile) aggregates of scratch.
int segment_scan_tile() { return scan::TILE; }
int segment_scan_scratch_bytes() { return static_cast<int>(sizeof(Seg<float>)); }

int segment_scan_i32(const void* x, const void* boundary, void* out,
                     void* scratch, long long n, void* stream) {
  return launch<uint32_t>(x, boundary, out, scratch, n, stream);
}

int segment_scan_f32(const void* x, const void* boundary, void* out,
                     void* scratch, long long n, void* stream) {
  return launch<float>(x, boundary, out, scratch, n, stream);
}

}  // extern "C"
