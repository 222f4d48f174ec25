// segment_rank: 1-based int32 row_number, rank or dense_rank within
// segments, from two head masks: seg_b[i] != 0 starts a segment, ord_b[i]
// != 0 starts a run of equal order keys (every segment head heads a run).
//
// Replaces the TPU kernel src/repro/kernels/segment_rank/segment_rank.py:67
// (segment_rank_pallas), which runs segmented sum and max ladders in each
// 2048-row block and carries two cells (the count and the running max) from
// block to block; that carry needs the TPU's in-order grid.  Here each kind
// runs through the single-pass decoupled look-back scan of lookback.cuh, in
// the carry-free form of the plain version (the reference's cummax
// composition):
//   row_number = i - seg_first + 1
//   rank       = ord_first - seg_first + 1
//   dense_rank = 1 + (number of run heads in (seg_first, i])
// seg_first and ord_first are running maxima of head indices (0 before the
// first head): `Heads`, packed into a status word as two 31-bit indices.
// dense_rank is the segmented sum of the run heads, counting neither the
// segment's own head nor row 0: `Runs`, a 31-bit count and a head flag.
// The wrapper keeps n < 2^31, so both fit the status word's 62 bits.  In
// all three kinds a tile holding a segment head needs nothing from before
// it (`restarts`), so it publishes its inclusive prefix at once; the worst
// case is one head at row 0, where every tile looks back as prefix_sum's do.
// Forward progress comes from the atomic tile ticket, ordering from the
// packed word's release store and acquire loads (see lookback.cuh).  The
// kernel takes n rows exactly: no padding.
// Bound: bytes, 12 a row (seg_b and ord_b read once, the ranks written
// once); row_number does not read ord_b: 8 a row.  That is what this kernel
// moves; the reduce-then-scan it replaces read its inputs twice in three
// launches.

#include "lookback.cuh"

namespace {

enum Kind { ROW_NUMBER = 0, RANK = 1, DENSE_RANK = 2 };

constexpr uint32_t LOW31 = 0x7fffffffu;

struct Heads {
  int s;   // index of the latest segment head (0 if none yet)
  int o;   // index of the latest run head (0 if none yet)
};

template <bool USE_ORD>
struct HeadOp {
  using T = Heads;
  static constexpr int INPUTS = USE_ORD ? 2 : 1;
  static constexpr bool ORDERED = false;   // integers: any order is exact
  __device__ __forceinline__ T identity() const { return T{0, 0}; }
  __device__ __forceinline__ T combine(T a, T b) const {
    return T{max(a.s, b.s), max(a.o, b.o)};
  }
  __device__ __forceinline__ T load(uint32_t seg, uint32_t ord,
                                    long long g) const {
    const int i = static_cast<int>(g);
    return T{seg != 0u ? i : 0, USE_ORD && ord != 0u ? i : 0};
  }
  __device__ __forceinline__ uint32_t store(T t, long long g) const {
    return static_cast<uint32_t>(USE_ORD ? t.o - t.s + 1
                                         : static_cast<int>(g) - t.s + 1);
  }
  // a head inside a tile past row 0 has an index above every earlier one
  __device__ __forceinline__ bool restarts(T a) const {
    return a.s > 0 && (!USE_ORD || a.o > 0);
  }
  __device__ __forceinline__ unsigned long long pack(T t) const {
    return static_cast<unsigned long long>(t.s) |
           static_cast<unsigned long long>(t.o) << 31;
  }
  __device__ __forceinline__ T unpack(unsigned long long w) const {
    return T{static_cast<int>(w & LOW31), static_cast<int>((w >> 31) & LOW31)};
  }
};

struct Runs {
  uint32_t v;   // run heads since the last segment head
  uint32_t f;   // 1 if a segment head lies in the span
};

struct DenseOp {
  using T = Runs;
  static constexpr int INPUTS = 2;
  static constexpr bool ORDERED = false;
  __device__ __forceinline__ T identity() const { return T{0u, 0u}; }
  __device__ __forceinline__ T combine(T a, T b) const {
    return T{b.f ? b.v : a.v + b.v, a.f | b.f};
  }
  __device__ __forceinline__ T load(uint32_t seg, uint32_t ord,
                                    long long g) const {
    const bool head = seg != 0u;
    return T{head || g == 0 ? 0u : (ord != 0u ? 1u : 0u), head ? 1u : 0u};
  }
  __device__ __forceinline__ uint32_t store(T t, long long) const {
    return t.v + 1u;
  }
  __device__ __forceinline__ bool restarts(T a) const { return a.f != 0u; }
  __device__ __forceinline__ unsigned long long pack(T t) const {
    return static_cast<unsigned long long>(t.v) |
           static_cast<unsigned long long>(t.f) << 31;
  }
  __device__ __forceinline__ T unpack(unsigned long long w) const {
    return T{static_cast<uint32_t>(w & LOW31), static_cast<uint32_t>(w >> 31) & 1u};
  }
};

}  // namespace

extern "C" {

// Bytes of scratch a call over n rows needs.
long long segment_rank_scratch_bytes(long long n) {
  return lookback::scratch_bytes(n);
}

int segment_rank(const void* seg_b, const void* ord_b, void* out,
                 void* scratch, long long n, int kind, int load,
                 void* stream) {
  switch (kind) {
    case ROW_NUMBER:
      return lookback::run(HeadOp<false>{}, seg_b, nullptr, out, scratch, n,
                           load, stream);
    case RANK:
      return lookback::run(HeadOp<true>{}, seg_b, ord_b, out, scratch, n,
                           load, stream);
    case DENSE_RANK:
      return lookback::run(DenseOp{}, seg_b, ord_b, out, scratch, n, load,
                           stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
