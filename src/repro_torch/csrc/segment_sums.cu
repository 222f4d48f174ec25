// segment_sums: float32 sums of the runs of a sorted segment id over the
// valid prefix.  The rows read are i < m, m = min(n, *count) (n when count
// is null).  A run is a maximal stretch of rows with one seg_id; its total
// adds values[i] over its rows with valid[i] (+0.0 for the others, so a run
// of invalid rows sums to 0) and is written to out[seg_id] when
// 0 <= seg_id < num_segments, else nowhere.  Slots that no run names are
// not written: they are undefined, as in the reference's Pallas wrapper.
//
// Replaces the TPU kernel src/repro/kernels/segment_reduce/segment_reduce.py:33
// (value_scan_pallas) with its scan-difference wrapper ops.py:11
// (segment_sums).  That kernel is a prefix sum whose running total is
// carried from block to block in VMEM through the TPU's in-order grid; the
// wrapper takes differences of the scan at run ends.  Hopper runs blocks in
// parallel and in no order, and a difference of two large prefix sums loses
// the small run sums' low bits.  Here the runs are summed directly.
//
// Bound: bytes, 9 a row read over the prefix (value, id, valid byte) and 4 a
// run written.  The kernel reads nothing past m and writes nothing but run
// totals: no output memset, no atomics.
//
// Design: ONE launch, a single-pass decoupled look-back on the pieces of
// lookback.cuh under segment_scan's monoid (lookback::SegScanOp<float>:
// the sum since the last head, and whether a head lies in the span), the
// heads derived in the kernel from seg_id[i] != seg_id[i - 1]:
//   1. As many blocks as the card holds at once take tiles of 5120 rows
//      from an atomic ticket, one after another.  A ticket at or past m
//      ends the block: tickets are taken in order, so no tile that is
//      still to come needs the ones it skips, and a prefix far shorter than
//      n costs one ticket a block.
//   2. Thread 0 stages the tile in shared memory by three TMA bulk copies
//      (values, ids, valid bytes; BULK, every input 16-byte aligned) and
//      reads the ids on either side of it (a one-row halo); the rows of a
//      partial tile past its last whole 16 bytes, and every row of a view
//      not 16-byte aligned (WORDS), take guarded loads of 4 and 1 bytes.
//   3. The chunk, warp and block scans of lookback::scan_tiles give the
//      tile's aggregate, which thread 0 publishes (as its inclusive prefix
//      at once if a head lies in the tile).
//   4. The thread holding the last row of a run that starts in the tile
//      (its next row has another id, or is row m) stores the run's total:
//      one 4-byte store, or one 16-byte store for four aligned runs of one
//      row each.  The tile's FIRST run, which began before it, needs the
//      tile's exclusive prefix: its sum over the tile's rows waits in
//      shared memory.
//   5. The buffers are free: thread 0 takes the next ticket and its copies
//      go out.  Then warp 0 looks back over the status words, publishes
//      the tile's inclusive prefix and stores the first run's total, while
//      the next tile loads.  A tile whose first row starts a run skips the
//      look-back.
// Forward progress: a block publishes each tile's aggregate before it takes
// another ticket, and a look-back waits only on tiles with smaller tickets,
// whose blocks are running; by induction over the tickets every aggregate
// is published.
// Repeatable: the operator is ORDERED (lookback.cuh), so a run that spans
// tiles is the serial fold of its tile partials in tile order, and every
// call gives the same bits.  Status words and the ticket live in caller
// scratch (segment_sums_scratch_bytes), cleared on the caller's stream
// before every launch.

#include <algorithm>

#include "lookback.cuh"

namespace {

using lookback::AGGREGATE;
using lookback::INCLUSIVE;
using lookback::publish;
using Op = lookback::SegScanOp<float>;
using T = Op::T;

// lookback::scan_tiles' tile: 5 warps of 32 lanes x 8 chunks x 4 rows
constexpr int THREADS = lookback::THREADS;
constexpr int WARPS = lookback::WARPS;
constexpr int VEC = lookback::VEC;
constexpr int CHUNKS = lookback::CHUNKS;
constexpr int WARP_ROWS = 32 * CHUNKS * VEC;
constexpr int TILE = WARPS * WARP_ROWS;

inline long long tiles_of(long long n) { return (n + TILE - 1) / TILE; }

// Status words, one per tile, then the ticket.
inline long long scratch_bytes(long long n) { return (tiles_of(n) + 1) * 8; }

template <int LOAD>
__global__ void __launch_bounds__(THREADS)
sum_tiles(const float* values, const int* seg_id, const uint8_t* valid,
          const int* count, float* __restrict__ out,
          unsigned long long* status, unsigned int* ticket, long long n,
          int num_segments) {
  __shared__ __align__(128) float s_val[TILE];
  __shared__ __align__(128) int s_id[TILE];
  __shared__ __align__(128) uint8_t s_ok[TILE];
  __shared__ __align__(8) unsigned long long s_bar;
  __shared__ int s_tile, s_before, s_after;
  __shared__ int s_first, s_first_id;   // the tile's first run ends in it
  __shared__ float s_first_sum;         // its sum over the tile's rows
  __shared__ T s_warp[WARPS];
  const Op op{};
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const int row0 = wid * WARP_ROWS + lane * VEC;   // chunk 0's, in the tile
  const long long m =
      count ? min(n, max(0LL, static_cast<long long>(__ldg(count)))) : n;

  // thread 0: the next ticket; the tile's copies go out (BULK: every row
  // up to the last whole 16 bytes of each input), its halo is read
  auto take = [&]() {
    const int t = static_cast<int>(atomicAdd(ticket, 1u));
    const long long tb = static_cast<long long>(t) * TILE;
    s_tile = t;
    s_first = 0;
    if (tb >= m) return;
    if (LOAD == lookback::BULK) {
      const int rows =
          static_cast<int>(min(static_cast<long long>(TILE), m - tb));
      const int r4 = rows & ~3, r16 = rows & ~15;
      fence_proxy_async();   // the last tile's reads of the buffers
      bar_expect(&s_bar, 8 * r4 + r16);
      if (r4 > 0) {
        bulk_copy(s_val, values + tb, 4 * r4, &s_bar);
        bulk_copy(s_id, seg_id + tb, 4 * r4, &s_bar);
      }
      if (r16 > 0) bulk_copy(s_ok, valid + tb, r16, &s_bar);
    }
    s_before = tb > 0 ? __ldg(seg_id + tb - 1) : 0;
    s_after = tb + TILE < m ? __ldg(seg_id + tb + TILE) : 0;
  };
  if (threadIdx.x == 0) {
    if (LOAD == lookback::BULK) bar_init(&s_bar);
    take();
  }
  __syncthreads();

  for (unsigned parity = 0u;; parity ^= 1u) {
    const int tile = s_tile;
    const long long tile_base = static_cast<long long>(tile) * TILE;
    if (tile_base >= m) return;
    const int rows = static_cast<int>(min(static_cast<long long>(TILE),
                                          m - tile_base));
    const bool full = rows == TILE;
    // 2. the rest of the tile: the rows past the bulk copies
    if (LOAD == lookback::BULK) bar_wait(&s_bar, parity);
    if (LOAD == lookback::WORDS || !full) {
      const int r4 = LOAD == lookback::BULK ? rows & ~3 : 0;
      const int r16 = LOAD == lookback::BULK ? rows & ~15 : 0;
#pragma unroll 4
      for (int i = r16 + threadIdx.x; i < rows; i += THREADS) {
        const long long g = tile_base + i;
        if (i >= r4) {
          s_val[i] = __ldg(values + g);
          s_id[i] = __ldg(seg_id + g);
        }
        s_ok[i] = __ldg(valid + g);
      }
      __syncthreads();
    }
    // the tile's first row starts a run: it needs nothing from before it
    const bool first_head = tile == 0 || s_id[0] != s_before;

    // the rows of chunk k: elements (the identity at or past m), ids, and
    // whether each row ends its run
    auto chunk = [&](int k, T (&e)[VEC], int (&id)[VEC], bool (&end)[VEC]) {
      const int r0 = row0 + k * 32 * VEC;
      const int4 iv = *reinterpret_cast<const int4*>(&s_id[r0]);
      const float4 vv = *reinterpret_cast<const float4*>(&s_val[r0]);
      const uint32_t ok = *reinterpret_cast<const uint32_t*>(&s_ok[r0]);
      const int before = r0 == 0 ? s_before : s_id[r0 - 1];
      const int after = r0 + VEC == TILE ? s_after : s_id[r0 + VEC];
      id[0] = iv.x; id[1] = iv.y; id[2] = iv.z; id[3] = iv.w;
      const float v[VEC] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const int r = r0 + j;
        const bool head = tile_base + r == 0 ||
                          id[j] != (j == 0 ? before : id[j - 1]);
        const float x = (ok >> (8 * j)) & 0xffu ? v[j] : 0.0f;
        e[j] = r < rows ? T{x, head ? 1u : 0u} : op.identity();
        end[j] = r < rows && (tile_base + r == m - 1 ||
                              id[j] != (j == VEC - 1 ? after : id[j + 1]));
      }
    };

    // 3. chunk aggregates, the warp's scan of them, the tile's aggregate,
    // published
    T chunk_pre[CHUNKS];
    T warp_acc = op.identity();
#pragma unroll
    for (int k = 0; k < CHUNKS; ++k) {
      T e[VEC];
      int id[VEC];
      bool end[VEC];
      chunk(k, e, id, end);
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
    unsigned long long* mine = status + tile;
    const bool restart = tile == 0 || op.restarts(agg);
    if (threadIdx.x == 0)
      publish(mine, (restart ? INCLUSIVE : AGGREGATE) | op.pack(agg));

    // 4. the totals of the runs that start in the tile, at their last
    // rows; the tile's first run, if it ends here, waits for the look-back
#pragma unroll
    for (int k = 0; k < CHUNKS; ++k) {
      T e[VEC];
      int id[VEC];
      bool end[VEC];
      chunk(k, e, id, end);
      T run = op.combine(warp_pre, chunk_pre[k]);
      float r[VEC];
      bool mid[VEC];   // a head lies in the tile at or before the row
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        run = op.combine(run, e[j]);
        r[j] = run.v;
        mid[j] = run.f != 0u;
        if (end[j] && !mid[j]) {
          s_first = 1;
          s_first_id = id[j];
          s_first_sum = r[j];
        }
      }
      if (end[0] && end[1] && end[2] && end[3] && mid[0] &&
          (id[0] & 3) == 0 && id[0] >= 0 && id[0] + 3 < num_segments &&
          id[1] == id[0] + 1 && id[2] == id[0] + 2 && id[3] == id[0] + 3) {
        *reinterpret_cast<float4*>(out + id[0]) =
            make_float4(r[0], r[1], r[2], r[3]);
      } else {
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          if (end[j] && mid[j] && id[j] >= 0 && id[j] < num_segments)
            out[id[j]] = r[j];
      }
    }
    __syncthreads();   // every read of the buffers is done

    // 5. the next tile's copies go out, then warp 0 looks back for this one,
    // publishes its inclusive prefix and stores its first run's total
    if (wid == 0) {
      const bool first = s_first != 0;
      const int first_id = s_first_id;
      const float first_sum = s_first_sum;
      __syncwarp();
      if (lane == 0) take();
      if (!first_head) {
        const T excl = lookback::look_back(op, status, tile);
        if (lane == 0) {
          if (!restart)
            publish(mine, INCLUSIVE | op.pack(op.combine(excl, agg)));
          if (first && first_id >= 0 && first_id < num_segments)
            out[first_id] = op.combine(excl, T{first_sum, 0u}).v;
        }
      }
    }
    __syncthreads();
  }
}

// Blocks of sum_tiles<LOAD> the card holds at once (the grid), found once.
template <int LOAD>
cudaError_t resident(int& blocks) {
  static int cached = 0;
  if (cached == 0) {
    int dev, sms, per;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per, sum_tiles<LOAD>, THREADS, 0);
    if (e != cudaSuccess) return e;
    cached = sms * std::max(per, 1);
  }
  blocks = cached;
  return cudaSuccess;
}

template <int LOAD>
cudaError_t go(const float* v, const int* id, const uint8_t* ok,
               const int* count, float* out, unsigned long long* status,
               unsigned int* ticket, long long n, int num_segments,
               cudaStream_t s) {
  int blocks;
  const cudaError_t e = resident<LOAD>(blocks);
  if (e != cudaSuccess) return e;
  const int grid = static_cast<int>(std::min<long long>(tiles_of(n), blocks));
  sum_tiles<LOAD><<<grid, THREADS, 0, s>>>(v, id, ok, count, out, status,
                                           ticket, n, num_segments);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of scratch a call over n rows needs.
long long segment_sums_scratch_bytes(long long n) {
  return scratch_bytes(n);
}

// values: n float32; seg_id: n int32; valid: n bytes (0 or 1); count: null
// or one int32 on the card (the valid prefix); out: num_segments float32
// (16-byte aligned).  `load` is a lookback::Load: BULK needs values, seg_id
// and valid 16-byte aligned.  Returns the first CUDA error, or
// cudaGetLastError() after the launch.
int segment_sums(const void* values, const void* seg_id, const void* valid,
                 const void* count, void* out, void* scratch, long long n,
                 int num_segments, int load, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0 || num_segments <= 0) return static_cast<int>(cudaGetLastError());
  const cudaError_t e = cudaMemsetAsync(scratch, 0, scratch_bytes(n), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  auto* status = static_cast<unsigned long long*>(scratch);
  auto* ticket = reinterpret_cast<unsigned int*>(status + tiles_of(n));
  const auto* v = static_cast<const float*>(values);
  const auto* id = static_cast<const int*>(seg_id);
  const auto* ok = static_cast<const uint8_t*>(valid);
  const auto* c = static_cast<const int*>(count);
  auto* o = static_cast<float*>(out);
  switch (load) {
    case lookback::BULK:
      return static_cast<int>(go<lookback::BULK>(v, id, ok, c, o, status,
                                                 ticket, n, num_segments, s));
    case lookback::WORDS:
      return static_cast<int>(go<lookback::WORDS>(v, id, ok, c, o, status,
                                                  ticket, n, num_segments, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
