// Single-pass scan with decoupled look-back under any associative operator:
// the skeleton of prefix_sum.cu, segment_scan.cu and segment_rank.cu, and
// the pieces segment_sums.cu and bucket_scatter.cu build their own on.
//
// The TPU kernels it serves (src/repro/kernels/stream_compact/
// stream_compact.py:36, src/repro/kernels/segment_scan/segment_scan.py:48,
// src/repro/kernels/segment_rank/segment_rank.py:67) walk their blocks in
// order and carry the running value from one block to the next in VMEM.
// Hopper runs blocks in parallel and in no order.  Here one launch reads
// every input row once and writes every output row once, which is what
// bounds these scans (bytes: 8 a row for prefix_sum, 12 for segment_scan and
// segment_rank, 8 for its row_number).
//
// Each block scans one tile of TILE rows:
//   1. It takes its tile id from an atomic ticket, not from blockIdx: every
//      tile before it then belongs to a block that has already started and
//      publishes its aggregate without waiting on anything, so the
//      look-back below always finishes (forward progress, whatever order
//      the hardware schedules blocks in).
//   2. It fetches the tile (see Load below).  Each thread owns CHUNKS
//      chunks of VEC consecutive rows; chunk k of lane l of warp w starts at
//      row w * WARP_ROWS + (k * 32 + l) * VEC of the tile, so a warp's
//      16-byte accesses cover 512 contiguous bytes.  A thread combines each
//      chunk serially, the warp scans the chunk aggregates with shuffles,
//      and one shared word per warp joins the warps.
//   3. Thread 0 publishes the tile's aggregate; warp 0 looks back over the
//      status words of the tiles before it, 32 at a time, combining
//      aggregates until it meets an inclusive prefix; thread 0 publishes
//      the tile's inclusive prefix.  A tile whose aggregate `restarts` (it
//      needs nothing from before it) publishes its inclusive prefix at once.
//   4. Every thread combines the tile's exclusive prefix in front of its
//      rows and stores them, 16 bytes a chunk.
//
// Repeatable float sums (Op::ORDERED).  Float addition does not associate,
// so the bits of a float scan depend on the order of its additions.  Inside
// a tile that order is fixed (steps 2 and 4).  Across tiles, an ORDERED
// operator's look-back folds left to right, serially: from the latest
// inclusive prefix it finds, P(s), it combines the aggregates A(s+1), ...,
// A(t-1) one after another in tile order, and the tile publishes
// P(t) = combine(P(t-1), A(t)).  By induction every published inclusive
// prefix is the serial fold A(0) + A(1) + ... + A(t), whichever tile a
// look-back stopped at (a tile that restarts publishes A(t), which equals
// combine(P(t-1), A(t)) for such an operator), and a look-back that meets
// a later tile's inclusive prefix while folding takes it, since it holds
// the same bits.  So every call gives the same bits, whatever order the
// hardware runs the tiles in.  The fold walks back first, keeping the
// status words it passes, then forward; it needs an identity that is
// exact on either side (-0.0 for float sums).  Integer operators (ORDERED
// false) are exact under any association and combine each window of 32
// status words with a shuffle tree instead, which is shorter.
//
// Load: a block waits in the look-back for the tiles before it to publish
// (microseconds on a loaded H100), holding its tile all the while, so what
// keeps the memory busy is how many tiles the SMs hold at once, and shared
// memory holds more of them than registers do: the tile is staged there,
// not loaded into registers (tools/lookback_study.py times both).  BULK
// (16-byte aligned data) has thread 0 start one TMA bulk copy per input as
// soon as it holds the ticket; the rows are read from shared memory in
// steps 2 and 4 and stored with 16-byte stores.  WORDS (data not 16-byte
// aligned) stages the tile with 4-byte loads and stores 4 bytes at a time.
// The last, partial tile always takes guarded 4-byte accesses.  A tile of
// 5 warps x 1024 rows let an SM hold the most tiles of one and of two
// inputs among the shapes timed (PERF.md, PR 15).
//
// Memory ordering: a tile's status is ONE 64-bit word, 2 bits of status
// (none / aggregate / inclusive prefix) above 62 bits of packed value,
// written with one st.release.gpu and read with ld.acquire.gpu.  A reader
// therefore never sees a flag without its value.  The words and the ticket
// live in caller scratch (scratch_bytes(n)), cleared by cudaMemsetAsync on
// the caller's stream before every launch: the allocator hands the same
// block to the next call, and a stale "inclusive" word would be read as
// valid.
//
// An operator `Op` supplies the monoid, its I/O and its status packing:
//   using T                        the scanned value
//   static constexpr int INPUTS    4-byte input arrays read (1 or 2)
//   static constexpr bool ORDERED  fold the look-back serially (float sums)
//   T identity()                   neutral element (ORDERED: bit for bit,
//                                  combine(x, identity()) == x and back)
//   T combine(T earlier, T later)  associative
//   T load(uint32_t a, uint32_t b, long long g)
//                                  row g's element from its input words
//                                  (b is 0 when INPUTS is 1)
//   uint32_t store(T v, long long g)
//                                  row g's output word from its inclusive
//                                  value
//   bool restarts(T aggregate)     combine(anything, aggregate) == aggregate
//   uint64_t pack(T) / T unpack(uint64_t)
//                                  to and from at most 62 bits
#pragma once

#include <type_traits>

#include "common.cuh"

namespace lookback {

constexpr int THREADS = 160;
constexpr int WARPS = THREADS / 32;
constexpr int VEC = 4;                      // rows per 16-byte access
constexpr int CHUNKS = 8;                   // chunks per thread
constexpr int WARP_ROWS = 32 * CHUNKS * VEC;
constexpr int TILE = WARPS * WARP_ROWS;     // 5120 rows

enum Load { BULK = 0, WORDS = 1 };

constexpr unsigned long long AGGREGATE = 1ull << 62;
constexpr unsigned long long INCLUSIVE = 2ull << 62;
constexpr unsigned long long VALUE = AGGREGATE - 1;

// Status words, one per tile, then the ticket.
inline long long scratch_bytes(long long n) {
  return ((n + TILE - 1) / TILE + 1) * 8;
}

__device__ __forceinline__ void publish(unsigned long long* p,
                                        unsigned long long w) {
  asm volatile("st.release.gpu.u64 [%0], %1;" ::"l"(p), "l"(w) : "memory");
}

__device__ __forceinline__ unsigned long long observe(
    const unsigned long long* p) {
  unsigned long long w;
  asm volatile("ld.acquire.gpu.u64 %0, [%1];" : "=l"(w) : "l"(p) : "memory");
  return w;
}

// The same for 32-bit status words that carry their whole value
// (bucket_scatter.cu's): a reader needs nothing that the writer stored
// before the word, so relaxed accesses do, and a thread may keep several
// loads in flight (an acquire load holds back every later load of the
// thread until it completes).
__device__ __forceinline__ void publish(unsigned* p, unsigned w) {
  asm volatile("st.relaxed.gpu.u32 [%0], %1;" ::"l"(p), "r"(w) : "memory");
}

__device__ __forceinline__ unsigned observe(const unsigned* p) {
  unsigned w;
  asm volatile("ld.relaxed.gpu.u32 %0, [%1];" : "=r"(w) : "l"(p) : "memory");
  return w;
}

// Warp 0: the status words of the window of 32 tiles ending at tile j (lane
// l watches tile j - 31 + l; tiles before 0 read as an inclusive
// identity), re-read until every tile after the window's latest inclusive
// prefix has published.  `inc` receives the lanes holding an inclusive
// prefix; lanes below the latest are not waited for.
template <class Op>
__device__ __forceinline__ unsigned long long window(
    const Op& op, const unsigned long long* status, int j, unsigned& inc) {
  const int idx = j - 31 + static_cast<int>(threadIdx.x & 31);
  unsigned long long w = idx >= 0 ? observe(status + idx)
                                  : INCLUSIVE | op.pack(op.identity());
  for (;;) {
    inc = __ballot_sync(FULL_MASK, (w >> 62) == 2);
    const unsigned none = __ballot_sync(FULL_MASK, (w >> 62) == 0);
    const int hi = inc ? 31 - __clz(inc) : -1;
    if (hi == 31 || (none >> (hi + 1)) == 0u) return w;
    if ((w >> 62) == 0) w = observe(status + idx);
  }
}

// Warp 0, for an ORDERED operator: fold the 32 status words `w` of one
// window into `acc` in tile order, starting afresh from the window's latest
// inclusive prefix if `inc` shows one.  Lanes before it give the identity,
// which is exact on either side (for floats -0.0: x + -0.0 == x for every
// x), so the fold is one fixed chain of 32 combines, its shuffles free to
// run ahead.
template <class Op>
__device__ __forceinline__ typename Op::T fold(const Op& op,
                                               typename Op::T acc,
                                               unsigned long long w,
                                               unsigned inc) {
  using T = typename Op::T;
  const int lane = threadIdx.x & 31;
  const int start = inc ? 31 - __clz(inc) : -1;
  const T v = lane < start ? op.identity() : op.unpack(w & VALUE);
  if (start >= 0) acc = op.identity();
#pragma unroll
  for (int i = 0; i < 32; ++i) acc = op.combine(acc, shfl_idx_any(v, i));
  return acc;
}

// Warp 0 of tile `tile` > 0: the combination of every row before the tile,
// the same in every lane.
template <class Op>
__device__ typename Op::T look_back(const Op& op,
                                    const unsigned long long* status,
                                    int tile) {
  using T = typename Op::T;
  const int lane = threadIdx.x & 31;
  unsigned inc;
  if constexpr (Op::ORDERED) {
    // back to the latest window holding an inclusive prefix, keeping the
    // words of the first SAVED windows passed, then forward from it: the
    // serial fold, whose bits do not depend on where it starts
    constexpr int SAVED = 4;
    __shared__ unsigned long long s_saved[SAVED][32];
    int j = tile - 1, k = 0;
    unsigned long long w;
    for (;; j -= 32, ++k) {
      w = window(op, status, j, inc);
      if (inc) break;
      if (k < SAVED) s_saved[k][lane] = w;
    }
    T acc = op.identity();
    for (;;) {
      acc = fold(op, acc, w, inc);
      j += 32;
      if (j >= tile) return acc;
      if (--k < SAVED) {   // a window passed: every tile in it had published
        w = s_saved[k][lane];
        inc = 0u;
      } else {
        w = window(op, status, j, inc);
      }
    }
  } else {
    T excl = op.identity();
    for (int j = tile - 1;; j -= 32) {
      const unsigned long long w = window(op, status, j, inc);
      const int start = inc ? 31 - __clz(inc) : 0;
      T v = lane >= start ? op.unpack(w & VALUE) : op.identity();
      // ordered reduction: lane i ends with lanes [i, i + 2o) combined
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const T y = shfl_down_any(v, o);
        if (lane + o < 32) v = op.combine(v, y);
      }
      excl = op.combine(shfl_idx_any(v, 0), excl);
      if (inc) return excl;
    }
  }
}

// The segmented sum monoid of segment_scan.cu and segment_sums.cu,
//     (v1, f1) + (v2, f2) = (f2 ? v2 : v1 + v2, f1 | f2):
// the sum since the span's last segment head, and whether it holds one.
// INPUTS, load and store serve scan_tiles (x and a boundary word a row);
// the status word packs the 32 value bits beside the flag bit.
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

template <class Op, int LOAD>
__global__ void __launch_bounds__(THREADS)
scan_tiles(Op op, const uint32_t* in0, const uint32_t* in1,
           uint32_t* __restrict__ out, unsigned long long* status,
           unsigned int* ticket, long long n) {
  using T = typename Op::T;
  constexpr int NIN = Op::INPUTS;
  __shared__ __align__(128) uint32_t s_in[NIN][TILE];
  __shared__ __align__(8) unsigned long long s_bar;
  __shared__ int s_tile;
  __shared__ T s_warp[WARPS];
  __shared__ T s_prefix;
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const uint32_t* in[2] = {in0, in1};
  if (threadIdx.x == 0) {
    const int t = static_cast<int>(atomicAdd(ticket, 1u));
    s_tile = t;
    const long long tb = static_cast<long long>(t) * TILE;
    if (LOAD == BULK && tb + TILE <= n) {   // 2. (BULK) the copies go out
      bar_init(&s_bar);
      bar_expect(&s_bar, NIN * TILE * 4);
#pragma unroll
      for (int p = 0; p < NIN; ++p)
        bulk_copy(s_in[p], in[p] + tb, TILE * 4, &s_bar);
    }
  }
  __syncthreads();
  const int tile = s_tile;
  const long long tile_base = static_cast<long long>(tile) * TILE;
  const bool full = tile_base + TILE <= n;
  const int row0 = wid * WARP_ROWS + lane * VEC;   // chunk 0's, in the tile

  // 2. fetch the tile into shared memory
  if (LOAD == BULK && full) {
    bar_wait(&s_bar, 0);
  } else {
    for (int i = threadIdx.x; i < TILE; i += THREADS) {
      const long long g = tile_base + i;
#pragma unroll
      for (int p = 0; p < NIN; ++p)
        s_in[p][i] = full || g < n ? __ldg(in[p] + g) : 0u;
    }
    __syncthreads();
  }
  // the elements of chunk k (the identity past n)
  auto chunk = [&](int k, T (&e)[VEC]) {
    const int r0 = row0 + k * 32 * VEC;
    uint32_t a[2][VEC] = {};
#pragma unroll
    for (int p = 0; p < NIN; ++p) {
      const uint4 v = *reinterpret_cast<const uint4*>(&s_in[p][r0]);
      a[p][0] = v.x; a[p][1] = v.y; a[p][2] = v.z; a[p][3] = v.w;
    }
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const long long g = tile_base + r0 + j;
      e[j] = full || g < n ? op.load(a[0][j], a[1][j], g) : op.identity();
    }
  };

  // chunk aggregates, the warp's scan of them
  T chunk_pre[CHUNKS];
  T warp_acc = op.identity();
#pragma unroll
  for (int k = 0; k < CHUNKS; ++k) {
    T e[VEC];
    chunk(k, e);
    T s = e[0];
#pragma unroll
    for (int j = 1; j < VEC; ++j) s = op.combine(s, e[j]);
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const T y = shfl_up_any(s, o);
      if (lane >= o) s = op.combine(y, s);
    }
    T x = shfl_up_any(s, 1);
    if (lane == 0) x = op.identity();
    chunk_pre[k] = op.combine(warp_acc, x);
    warp_acc = op.combine(warp_acc, shfl_idx_any(s, 31));
  }
  if (lane == 0) s_warp[wid] = warp_acc;
  __syncthreads();
  T warp_pre = op.identity();
  T agg = op.identity();
#pragma unroll
  for (int v = 0; v < WARPS; ++v) {
    if (v == wid) warp_pre = agg;
    agg = op.combine(agg, s_warp[v]);
  }

  // 3. publish, look back, publish
  if (wid == 0) {
    T excl = op.identity();
    unsigned long long* mine = status + tile;
    if (tile == 0) {
      if (lane == 0) publish(mine, INCLUSIVE | op.pack(agg));
    } else {
      const bool restart = op.restarts(agg);
      if (lane == 0)
        publish(mine, (restart ? INCLUSIVE : AGGREGATE) | op.pack(agg));
      excl = look_back(op, status, tile);
      if (!restart && lane == 0)
        publish(mine, INCLUSIVE | op.pack(op.combine(excl, agg)));
    }
    if (lane == 0) s_prefix = excl;
  }
  __syncthreads();

  // 4. store
  const T pre = op.combine(s_prefix, warp_pre);
#pragma unroll
  for (int k = 0; k < CHUNKS; ++k) {
    const long long g0 = tile_base + row0 + k * 32 * VEC;
    T e[VEC];
    chunk(k, e);
    T run = op.combine(pre, chunk_pre[k]);
    uint32_t r[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      run = op.combine(run, e[j]);
      r[j] = op.store(run, g0 + j);
    }
    if (LOAD == BULK && full) {
      *reinterpret_cast<uint4*>(out + g0) = make_uint4(r[0], r[1], r[2], r[3]);
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        if (full || g0 + j < n) out[g0 + j] = r[j];
    }
  }
}

// Clear the status words and the ticket, then launch one block per tile, on
// `stream`.  `in1` may be null when Op::INPUTS is 1; `load` is a Load: BULK
// needs every pointer to be a multiple of 16 bytes.  Returns
// the first CUDA error, or cudaGetLastError() after the launch.
template <class Op>
int run(const Op& op, const void* in0, const void* in1, void* out,
        void* scratch, long long n, int load, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const int ntiles = static_cast<int>((n + TILE - 1) / TILE);
  const cudaError_t e = cudaMemsetAsync(scratch, 0, scratch_bytes(n), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  auto* status = static_cast<unsigned long long*>(scratch);
  auto* ticket = reinterpret_cast<unsigned int*>(status + ntiles);
  const auto* a = static_cast<const uint32_t*>(in0);
  const auto* b = static_cast<const uint32_t*>(in1);
  auto* o = static_cast<uint32_t*>(out);
  switch (load) {
    case BULK:
      scan_tiles<Op, BULK><<<ntiles, THREADS, 0, s>>>(op, a, b, o, status, ticket, n);
      break;
    case WORDS:
      scan_tiles<Op, WORDS><<<ntiles, THREADS, 0, s>>>(op, a, b, o, status, ticket, n);
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace lookback
