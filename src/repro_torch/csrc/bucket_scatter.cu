// bucket_scatter: the stable within-bucket slot of every row at its original
// position, plus per-bucket counts, for bucket ids in [0, P] (P, and any id
// outside [0, P), marks an invalid row: slot 0, counted nowhere), P up to
// MAX_P = 2048.
//
// Replaces the TPU kernel src/repro/kernels/hash_partition/hash_partition.py:44
// (bucket_ranks_pallas).  That kernel walks 1024-row blocks in order,
// ranking each block with a (1024, P) one-hot cumsum and carrying the (P,)
// histogram from block to block in VMEM.  Hopper runs blocks in parallel
// and in no order, so nothing can be carried.
//
// Bound: bytes, 8 a row (dest read once, slot written once).  The kernel
// also writes and reads 4P status bytes a tile (4P / TILE a row: 0.08 at
// P = 256).
//
// Design: ONE launch, a single-pass decoupled look-back over P counts on the
// skeleton of lookback.cuh (its ticket, tile staging and publish / observe):
//   1. Each block takes its tile from an atomic ticket, so every tile before
//      it belongs to a block that has started and publishes its counts
//      without waiting on anything: the look-back always finishes.
//   2. BULK (dest 16-byte aligned): thread 0 stages the tile in shared memory
//      with one TMA bulk copy.  WORDS (a view not 16-byte aligned) and the
//      last, partial tile stage it with guarded 4-byte loads.
//   3. Ranking, warp-private, no block barrier: warp w owns rows
//      [w * SPAN, (w + 1) * SPAN) of the tile and reads them from shared
//      memory 32 at a time, in row order.  Each lane sets its bit in its
//      bucket's mask word in the warp's shared masks (one atomicOr) and
//      reads the word back: the lanes of its bucket; popc of the lower ones
//      is its rank among them.  Its rank in the warp adds the warp's count
//      of the bucket so far, which the bucket's first lane then advances
//      (clearing the mask).  The rank and the bucket go back into the row's
//      shared word.  (__match_any_sync gives the same masks but slows down
//      with the number of buckets in a round; a ballot per bit of the id is
//      slower too: tools/bucket_scatter_study.py.)
//   4. One block barrier; per bucket, the warps' counts are scanned (P x
//      WARPS cells) into each warp's offset within the tile and the tile's
//      count, which is published at once: thread b % THREADS owns bucket b.
//   5. Each thread walks back over its buckets' status words, one tile a
//      step (at P > THREADS its OWN buckets at once), adding counts until it
//      meets an inclusive prefix, then publishes the tile's inclusive
//      prefix.  Counts are integers: the order of the sums does not matter.
//      The tile that holds the last ticket writes `counts`.
//   6. slot = the tile's exclusive prefix of the bucket + the warp's offset
//      + the rank in the warp, read back from shared memory and stored 16
//      bytes at a time.
// Stability is the contract (the exchange preserves source row order):
// every term above counts only rows that come earlier in the input.
//
// Status words: one 32-bit word per tile and bucket (tile-major), 0 until
// published, then the tile's count + 1, then INCLUSIVE | its inclusive
// prefix.  A word carries its whole value, so relaxed loads and stores do
// (lookback.cuh's 32-bit publish / observe), and a thread keeps its loads of
// one step in flight together.  The words and the ticket live in caller
// scratch (bucket_scatter_scratch_bytes), cleared by cudaMemsetAsync on the
// caller's stream before every launch: the allocator hands the same block to
// the next call, and a stale inclusive word would be read as valid.
// Tiles: 12288 rows up to P = THREADS, 16384 above (fewer tiles, so fewer
// status words, against more tiles in flight; the study times both).
// Shared memory: the tile (4 TILE bytes) and the warps' masks and counts
// (8 WARPS P bytes): 192 KB at P = MAX_P.

#include "lookback.cuh"

namespace {

using lookback::observe;
using lookback::publish;

// A status word (32 bits, one per tile and bucket): 0 while unpublished;
// the tile's count + 1 (its aggregate); or INCLUSIVE | the count of every
// row up to the tile's end (at most n < 2^31).
constexpr unsigned INCLUSIVE = 1u << 31;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_P = 2048;
constexpr int GROUP = 4;                    // rounds of 32 rows ranked together
// a staged row after ranking: its rank in the warp above its bucket code
// (0 .. MAX_P, MAX_P marking an invalid row)
constexpr int CODE_BITS = 12;
constexpr unsigned CODE = (1u << CODE_BITS) - 1u;

// Rows a tile at P <= THREADS (one bucket a thread) and above.
constexpr int NARROW_TILE = 12288;
constexpr int WIDE_TILE = 16384;

template <bool WIDE>
struct Shape {
  static constexpr int TILE = WIDE ? WIDE_TILE : NARROW_TILE;
  static constexpr int SPAN = TILE / WARPS;  // rows a warp ranks
  static constexpr int OWN = WIDE ? MAX_P / THREADS : 1;  // buckets a thread owns
  static_assert(SPAN % (32 * GROUP) == 0 && SPAN % 128 == 0, "warp span");
  static_assert(SPAN < (1 << (32 - CODE_BITS)), "rank bits");
};
static_assert(MAX_P % THREADS == 0 && MAX_P <= CODE, "P");

inline bool wide(int P) { return P > THREADS; }

inline int tile_rows(int P) {
  return wide(P) ? Shape<true>::TILE : Shape<false>::TILE;
}

inline long long tiles_of(long long n, int P) {
  return (n + tile_rows(P) - 1) / tile_rows(P);
}

// Status words of P buckets for every tile, then the ticket.
inline long long scratch_bytes(long long n, int P) {
  return (tiles_of(n, P) * P + 1) * 4;
}

// The staged tile, then each warp's counts and mask words of P buckets.
template <bool WIDE>
inline int smem_bytes(int P) {
  return (Shape<WIDE>::TILE + 2 * WARPS * P) * 4;
}

// Walk back over the status words of the OWN buckets of this thread
// (b = k * THREADS + threadIdx.x, those below P), one tile a step, all of
// them at once, until each meets an inclusive prefix: the bucket's count
// over every tile before `tile` (> 0).  The loads are relaxed: a step's
// OWN loads are in flight together.
template <int OWN>
__device__ __forceinline__ void walk_back(const unsigned* status, int tile,
                                          int P, unsigned (&excl)[OWN]) {
  int j[OWN];
  unsigned pending = 0u;
#pragma unroll
  for (int k = 0; k < OWN; ++k) {
    excl[k] = 0u;
    j[k] = tile - 1;
    if (k * THREADS + static_cast<int>(threadIdx.x) < P) pending |= 1u << k;
  }
  while (pending) {
    unsigned w[OWN];
#pragma unroll
    for (int k = 0; k < OWN; ++k)
      w[k] = pending >> k & 1u
          ? observe(status + static_cast<long long>(j[k]) * P + k * THREADS +
                    threadIdx.x)
          : 0u;
#pragma unroll
    for (int k = 0; k < OWN; ++k) {
      if (w[k] == 0u) continue;     // done, or not published yet: read again
      if (w[k] & INCLUSIVE) {
        excl[k] += w[k] & ~INCLUSIVE;
        pending &= ~(1u << k);
      } else {
        excl[k] += w[k] - 1u;
        --j[k];
      }
    }
  }
}

template <int LOAD, bool WIDE>
__global__ void __launch_bounds__(THREADS)
scatter_tiles(const uint32_t* dest, uint32_t* __restrict__ slot,
              int* __restrict__ counts, unsigned* status,
              unsigned int* ticket, long long n, int P) {
  using S = Shape<WIDE>;
  constexpr int TILE = S::TILE, SPAN = S::SPAN, OWN = S::OWN;
  extern __shared__ __align__(128) uint32_t smem[];
  uint32_t* s_rows = smem;                                  // TILE
  unsigned* s_count = smem + TILE;                          // WARPS x P
  __shared__ __align__(8) unsigned long long s_bar;
  __shared__ int s_tile;
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const unsigned lower = (1u << lane) - 1u;
  const unsigned invalid = static_cast<unsigned>(P);

  // 1.-2. ticket, then the tile into shared memory
  if (threadIdx.x == 0) {
    const int t = static_cast<int>(atomicAdd(ticket, 1u));
    s_tile = t;
    const long long tb = static_cast<long long>(t) * TILE;
    if (LOAD == lookback::BULK && tb + TILE <= n) {
      bar_init(&s_bar);
      bar_expect(&s_bar, TILE * 4);
      bulk_copy(s_rows, dest + tb, TILE * 4, &s_bar);
    }
  }
  __syncthreads();
  const int tile = s_tile;
  const long long tile_base = static_cast<long long>(tile) * TILE;
  const bool full = tile_base + TILE <= n;
  uint32_t* rows = s_rows + wid * SPAN;
  unsigned* count = s_count + wid * P;
  unsigned* mask = s_count + (WARPS + wid) * P;
  for (int b = lane; b < P; b += 32) {
    count[b] = 0u;
    mask[b] = 0u;
  }
  if (LOAD == lookback::BULK && full) {
    bar_wait(&s_bar, 0);
  } else {
    for (int i = threadIdx.x; i < TILE; i += THREADS) {
      const long long g = tile_base + i;
      s_rows[i] = full || g < n ? __ldg(dest + g) : invalid;
    }
    __syncthreads();
  }
  __syncwarp();

  // 3. rank the warp's span, 32 rows a round, GROUP rounds at a time
  for (int r0 = 0; r0 < SPAN; r0 += 32 * GROUP) {
    unsigned c[GROUP], peers[GROUP], rank[GROUP];
#pragma unroll
    for (int k = 0; k < GROUP; ++k) {
      const uint32_t raw = rows[r0 + k * 32 + lane];
      c[k] = raw < invalid ? raw : invalid;
    }
#pragma unroll
    for (int k = 0; k < GROUP; ++k) {
      const bool valid = c[k] < invalid;
      if (valid) atomicOr(&mask[c[k]], 1u << lane);
      __syncwarp();
      peers[k] = valid ? mask[c[k]] : 0u;       // the lanes of its bucket
      const unsigned below = peers[k] & lower;
      const unsigned before = valid ? count[c[k]] : 0u;
      __syncwarp();
      if (valid && below == 0u) {   // the bucket's first lane: advance it
        count[c[k]] = before + __popc(peers[k]);
        mask[c[k]] = 0u;            // and clear its mask
      }
      __syncwarp();
      rank[k] = valid ? before + __popc(below) : 0u;
    }
#pragma unroll
    for (int k = 0; k < GROUP; ++k)
      rows[r0 + k * 32 + lane] = (rank[k] << CODE_BITS) | c[k];
  }
  __syncthreads();

  // 4. the warps' offsets per bucket, the tile's counts, published
  unsigned* mine = status + static_cast<long long>(tile) * P;
  unsigned agg[OWN], excl[OWN];
#pragma unroll
  for (int k = 0; k < OWN; ++k) {
    const int b = k * THREADS + threadIdx.x;
    agg[k] = 0u;
    excl[k] = 0u;
    if (b < P) {
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        const unsigned v = s_count[w * P + b];
        s_count[w * P + b] = agg[k];
        agg[k] += v;
      }
      publish(mine + b, tile == 0 ? INCLUSIVE | agg[k] : agg[k] + 1u);
    }
  }
  // 5. look back; the tile's exclusive prefix goes into every warp's offset
  if (tile > 0) walk_back<OWN>(status, tile, P, excl);
#pragma unroll
  for (int k = 0; k < OWN; ++k) {
    const int b = k * THREADS + threadIdx.x;
    if (b < P) {
      if (tile > 0) publish(mine + b, INCLUSIVE | (excl[k] + agg[k]));
#pragma unroll
      for (int w = 0; w < WARPS; ++w) s_count[w * P + b] += excl[k];
      if (tile_base + TILE >= n) counts[b] = static_cast<int>(excl[k] + agg[k]);
    }
  }
  __syncthreads();

  // 6. slots, 4 rows a lane at a time
  const long long row0 = tile_base + static_cast<long long>(wid) * SPAN;
  for (int i = lane * 4; i < SPAN; i += 128) {
    const uint4 v = *reinterpret_cast<const uint4*>(rows + i);
    const uint32_t words[4] = {v.x, v.y, v.z, v.w};
    uint32_t o[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const unsigned c = words[j] & CODE;
      o[j] = c < invalid ? count[c] + (words[j] >> CODE_BITS) : 0u;
    }
    const long long g = row0 + i;
    if (full) {
      *reinterpret_cast<uint4*>(slot + g) = make_uint4(o[0], o[1], o[2], o[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (g + j < n) slot[g + j] = o[j];
    }
  }
}

template <int LOAD, bool WIDE>
cudaError_t go(const uint32_t* d, uint32_t* slot, int* counts,
               unsigned* status, unsigned int* ticket, long long n,
               int P, cudaStream_t s) {
  const int smem = smem_bytes<WIDE>(P);
  // above the default 48 KB (the static words count too), a block must ask
  if (smem + 1024 > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        scatter_tiles<LOAD, WIDE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  const int ntiles = static_cast<int>(tiles_of(n, P));
  scatter_tiles<LOAD, WIDE><<<ntiles, THREADS, smem, s>>>(
      d, slot, counts, status, ticket, n, P);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Rows a tile at P buckets.
int bucket_scatter_tile(int P) { return tile_rows(P); }

int bucket_scatter_max_p() { return MAX_P; }

// Bytes of scratch a call over n rows and P buckets needs.
long long bucket_scatter_scratch_bytes(long long n, int P) {
  return scratch_bytes(n, P);
}

// dest: n int32 bucket ids; slot: n int32 (16-byte aligned); counts: P
// int32.  `load` is a lookback::Load: BULK needs dest 16-byte aligned.
// Returns the first CUDA error, or cudaGetLastError() after the launch.
int bucket_scatter(const void* dest, void* slot, void* counts, void* scratch,
                   long long n, int P, int load, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  if (P < 1 || P > MAX_P) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = cudaMemsetAsync(scratch, 0, scratch_bytes(n, P), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  auto* status = static_cast<unsigned*>(scratch);
  auto* ticket = status + tiles_of(n, P) * P;
  const auto* d = static_cast<const uint32_t*>(dest);
  auto* o = static_cast<uint32_t*>(slot);
  auto* c = static_cast<int*>(counts);
  const bool w = wide(P);
  switch (load) {
    case lookback::BULK:
      return static_cast<int>(
          w ? go<lookback::BULK, true>(d, o, c, status, ticket, n, P, s)
            : go<lookback::BULK, false>(d, o, c, status, ticket, n, P, s));
    case lookback::WORDS:
      return static_cast<int>(
          w ? go<lookback::WORDS, true>(d, o, c, status, ticket, n, P, s)
            : go<lookback::WORDS, false>(d, o, c, status, ticket, n, P, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
