// segment_scan: segmented inclusive sum of a 1-D int32 or float32 array;
// boundary[i] != 0 starts a new segment at row i.  The output keeps the
// input's dtype.
//
// Replaces the TPU kernel src/repro/kernels/segment_scan/segment_scan.py:48
// (segment_scan_pallas).  That kernel runs a Hillis-Steele ladder of the
// segmented monoid inside each 2048-row block and carries the last row's
// value to the next block in one VMEM cell, which needs the TPU's in-order
// grid.  Here the same monoid
//     (v1, f1) + (v2, f2) = (f2 ? v2 : v1 + v2, f1 | f2)
// runs through the single-pass decoupled look-back scan of lookback.cuh:
// each tile publishes its aggregate (the sum since its last head, and
// whether it holds a head) in one 64-bit status word, 32 value bits beside
// the flag bit.  A tile holding a head needs nothing from before it
// (`restarts`), so it publishes its inclusive prefix at once; the longest
// look-back is one head at row 0.  Forward progress comes from the atomic
// tile ticket, ordering from the packed word's release store and acquire
// loads (see lookback.cuh).
// Bound: bytes, 12 a row (x and boundary read once, the output written
// once), which is what this kernel moves.
//
// int32 sums run in uint32 arithmetic, so wrap-around is defined and the
// result is exact modulo 2^32.  float32 sums are taken in another order
// than the plain version's (a global cumsum minus the running total before
// each segment); they agree within rounding of the running sum of |x|.  The
// float32 operator is ORDERED, so every call gives the same bits.

#include <type_traits>

#include "lookback.cuh"

namespace {

template <typename V>
struct Seg {
  V v;          // sum since the last segment head (or since the start)
  uint32_t f;   // 1 if a segment head lies in the span
};

template <typename V>
struct SegScanOp {
  using T = Seg<V>;
  static constexpr int INPUTS = 2;
  static constexpr bool ORDERED = std::is_floating_point<V>::value;
  // -0.0 for floats: x + -0.0 is x for every x, +0.0 included
  __device__ __forceinline__ T identity() const {
    return T{V(ORDERED ? -0.0f : 0.0f), 0u};
  }
  __device__ __forceinline__ T combine(T a, T b) const {
    return T{b.f ? b.v : a.v + b.v, a.f | b.f};
  }
  __device__ __forceinline__ T load(uint32_t x, uint32_t boundary,
                                    long long) const {
    V v;
    memcpy(&v, &x, 4);
    return T{v, boundary != 0u ? 1u : 0u};
  }
  __device__ __forceinline__ uint32_t store(T t, long long) const {
    uint32_t r;
    memcpy(&r, &t.v, 4);
    return r;
  }
  __device__ __forceinline__ bool restarts(T a) const { return a.f != 0u; }
  __device__ __forceinline__ unsigned long long pack(T t) const {
    return static_cast<unsigned long long>(store(t, 0)) |
           static_cast<unsigned long long>(t.f) << 32;
  }
  __device__ __forceinline__ T unpack(unsigned long long w) const {
    T t = load(static_cast<uint32_t>(w), 0u, 0);
    t.f = static_cast<uint32_t>(w >> 32) & 1u;
    return t;
  }
};

}  // namespace

extern "C" {

// Bytes of scratch a call over n rows needs.
long long segment_scan_scratch_bytes(long long n) {
  return lookback::scratch_bytes(n);
}

int segment_scan_i32(const void* x, const void* boundary, void* out,
                     void* scratch, long long n, int load, void* stream) {
  return lookback::run(SegScanOp<uint32_t>{}, x, boundary, out, scratch, n,
                       load, stream);
}

int segment_scan_f32(const void* x, const void* boundary, void* out,
                     void* scratch, long long n, int load, void* stream) {
  return lookback::run(SegScanOp<float>{}, x, boundary, out, scratch, n,
                       load, stream);
}

}  // extern "C"
