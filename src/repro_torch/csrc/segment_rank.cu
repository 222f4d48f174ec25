// segment_rank: 1-based int32 row_number, rank or dense_rank within
// segments, from two head masks: seg_b[i] != 0 starts a segment, ord_b[i]
// != 0 starts a run of equal order keys (every segment head heads a run).
//
// Replaces the TPU kernel kernels/segment_rank/segment_rank.py
// (segment_rank_pallas), which runs segmented sum and max ladders in each
// 2048-row block and carries two cells (the count and the running max) from
// block to block; that carry needs the TPU's in-order grid.  Here each kind
// runs through the reduce-then-scan skeleton of scan.cuh, in the carry-free
// form of the plain version (the reference's cummax composition):
//   row_number = i - seg_first + 1
//   rank       = ord_first - seg_first + 1
//   dense_rank = 1 + (number of run heads in (seg_first, i])
// seg_first and ord_first are running maxima of head indices (0 before the
// first head); max is associative and commutative, so tiles combine with a
// max-scan of tile maxima.  dense_rank is the segmented sum of the run
// heads, counting neither the segment's own head nor row 0.  The kernel
// takes n rows exactly: no padding.
// Bound: bytes (seg_b and ord_b read, the ranks written: 12 bytes a row;
// row_number does not read ord_b).

#include "scan.cuh"

namespace {

enum Kind { ROW_NUMBER = 0, RANK = 1, DENSE_RANK = 2 };

struct Heads {
  int s;   // index of the latest segment head (0 if none yet)
  int o;   // index of the latest run head (0 if none yet)
};

template <bool USE_ORD>
struct HeadOp {
  using T = Heads;
  static constexpr bool commutative = true;   // componentwise max
  const int* seg_b;
  const int* ord_b;
  int* out;
  __device__ __forceinline__ T identity() const { return T{0, 0}; }
  __device__ __forceinline__ T combine(T a, T b) const {
    return T{max(a.s, b.s), max(a.o, b.o)};
  }
  __device__ __forceinline__ T load(long long g) const {
    const int i = static_cast<int>(g);
    return T{seg_b[g] != 0 ? i : 0, USE_ORD && ord_b[g] != 0 ? i : 0};
  }
  __device__ __forceinline__ void store(long long g, T t) const {
    out[g] = USE_ORD ? t.o - t.s + 1 : static_cast<int>(g) - t.s + 1;
  }
};

struct Runs {
  uint32_t v;   // run heads since the last segment head
  uint32_t f;   // 1 if a segment head lies in the span
};

struct DenseOp {
  using T = Runs;
  static constexpr bool commutative = false;
  const int* seg_b;
  const int* ord_b;
  int* out;
  __device__ __forceinline__ T identity() const { return T{0u, 0u}; }
  __device__ __forceinline__ T combine(T a, T b) const {
    return T{b.f ? b.v : a.v + b.v, a.f | b.f};
  }
  __device__ __forceinline__ T load(long long g) const {
    const bool head = seg_b[g] != 0;
    return T{head || g == 0 ? 0u : (ord_b[g] != 0 ? 1u : 0u), head ? 1u : 0u};
  }
  __device__ __forceinline__ void store(long long g, T t) const {
    out[g] = static_cast<int>(t.v) + 1;
  }
};

}  // namespace

extern "C" {

// Rows per tile and bytes per tile aggregate: the caller allocates
// ceil(n / tile) aggregates of scratch.
int segment_rank_tile() { return scan::TILE; }
int segment_rank_scratch_bytes() { return static_cast<int>(sizeof(Heads)); }

int segment_rank(const void* seg_b, const void* ord_b, void* out,
                 void* scratch, long long n, int kind, void* stream) {
  const int* s = static_cast<const int*>(seg_b);
  const int* o = static_cast<const int*>(ord_b);
  int* r = static_cast<int*>(out);
  switch (kind) {
    case ROW_NUMBER: return scan::run(HeadOp<false>{s, o, r}, scratch, n, stream);
    case RANK: return scan::run(HeadOp<true>{s, o, r}, scratch, n, stream);
    case DENSE_RANK: return scan::run(DenseOp{s, o, r}, scratch, n, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
