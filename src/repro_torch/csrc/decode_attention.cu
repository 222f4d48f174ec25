// decode_attention: single-token grouped-query attention over a KV cache.
// q (B, Hkv, G, hd), k and v (B, S, Hkv, hd), length (B,) int32; query head
// kv * G + g attends over the rows [0, length[b]) of KV head kv; scores,
// softmax and accumulation in float32; out (B, Hkv, G, hd) in q's type.
//
// Replaces the TPU kernel kernels/decode_attention/decode_attention.py
// (decode_attention_pallas).  There the S blocks of one batch row run in
// order on one core and carry the online softmax (running max, denominator
// and numerator) in VMEM from block to block.
//
// Bound: bytes.  K and V rows below length are read once (2 * length * hd
// values per (b, kv head)) against 4 * G * hd * length float32 operations,
// so the card streams at 3.35 TB/s only with megabytes of loads in flight,
// spread over all 132 SMs.  One block per (b, kv head) (the first design)
// left 100 SMs idle at qwen2-vl-2b's B * Hkv = 32 and held ~16 KB a block in
// flight: a tenth of the bound.  Here:
//   * a split over S (flash-decoding): block (b, kv head, split) walks the
//     rows [split * rows, (split + 1) * rows) below length.  The wrapper's
//     split_plan picks the splits from the shapes alone, never from length:
//     one where B * Hkv already covers the SMs, else about two blocks an
//     SM, each split long enough that its partial is a few percent of its
//     bytes.  A split whose first row is at or past length reads nothing and
//     writes an empty partial (max -1e30, sum 0);
//   * each of a block's WARPS warps owns a ring of DEPTH stages, each TILE
//     rows of K and of V, filled by TMA tensor copies that complete on the
//     stage's mbarrier: a 4-D tensor map (hd, Hkv, S, B) a tensor, one box
//     of TILE rows by 128 bytes of a row (64 in bf16 at hd 32) a copy, laid
//     out with the 128-byte swizzle (64-byte), so the 8 rows an ldmatrix or
//     a quarter warp reads hit all 32 banks.  A warp takes the tiles warp,
//     warp + WARPS, ... of its split and refills a stage as soon as it has
//     read it; no block barrier in the loop.  The box reads columns past hd
//     as zeros (zamba2's 112 in the 128-wide layout).  A split's last tile,
//     when short of TILE rows, comes by cp.async of its rows' 16-byte
//     pieces instead, so no row at or past its end is read.  (One bulk copy a row, 128-256 bytes, held
//     the small-grid shapes at the TMA unit's issue rate: the study);
//   * in bfloat16 the tile's products run on tensor cores (mma.sync
//     m16n8k16): S = Q K^T with the group's query heads as the rows of A
//     (rows past G, and 8-15, zero) and the tile's rows as two 8-wide
//     blocks of B (ldmatrix); the softmax runs in the mma's C registers,
//     which are already P's A layout for O += P V (V through a transposed
//     ldmatrix).  P is split into three bf16 terms, p = p1 + p2 + p3 + e
//     with |e| <= 2^-24 p, and bf16 products are exact in the float32
//     accumulator, so P . V keeps float32's accuracy (P rounded once to
//     bf16 would miss the 2e-5 absolute tolerance where an output is near
//     0); only the order of the sums differs.  In float32 (TF32 would break
//     the tolerance) the CUDA-core product: hd / 4 lanes a row, 4 values of
//     16 bytes each, reduced by shuffles, scores and P through shared
//     memory;
//   * a tile's softmax is warp-wide: one running max and sum per query
//     head for the whole warp, so the numerators need no per-lane
//     rescaling;
//   * at the end the warps merge in order through shared memory; with one
//     split the block writes the output, else its partial (the float32
//     numerator of each query head, then its max and sum: hd + 2 values a
//     row) to a float32 workspace that the wrapper allocates, and a second
//     launch folds the splits of each (b, kv head, query head) in split
//     order with the log-sum-exp merge.  Every sum has a fixed order and
//     nothing is atomic, so the same inputs give the same bits on every
//     call;
//   * two more entries serve a cache sharded along S over ranks (the
//     reference's cache_spec_for; GSPMD's flash-decoding combine across
//     devices): decode_attention_partial writes a rank's block's partial,
//     (B, Hkv, G, hd + 2) float32, whatever the split plan (with one split
//     the split kernel writes it; with more the combine folds the splits
//     into it without dividing), and decode_attention_merge folds M such
//     partials, gathered in rank order as (M, B, Hkv, G, hd + 2), into the
//     output with the same combine kernel, in index order.  A block with
//     no row below its length contributes max -1e30 and sum 0, which
//     weighs 0 against any real max (exp(-1e30 - m) underflows) and never
//     gives NaN;
//   * any hd that is a multiple of VEC up to 128 (zamba2's 112, 96, 40)
//     takes the layout of width HDP = 128, the lanes past hd idle; hd 32,
//     64 and 128 are their own HDP (FULL).  In bfloat16 one instance a
//     layout serves every G (the tensor-core path only masks with it);
//     float32's registers need one for each G;
//   * rows at or past min(length, S) are never read (they contribute
//     exactly 0 in the reference, exp(-1e30 - m) underflowing); a tile's
//     rows past its end are masked in the softmax and skipped in P . V.
//     length <= 0 (outside the contract) gives 0.

#include "common.cuh"

#include <climits>
#include <type_traits>
#include <unordered_map>

#include <cuda.h>
#include <cuda_bf16.h>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int TILE = 16;        // rows of K (and of V) a warp stages at once
constexpr int STAGES = 2;       // a warp's ring depth, at most
constexpr int MAXG = 8;         // query heads a group may have
constexpr int MAX_SMEM = 232448;    // dynamic shared memory a block may use
constexpr int MAX_SPLITS = 512;
static_assert(WARPS * STAGES * 8 <= 128, "the mbarriers fit their 128 bytes");

// Shared memory of a block: the warps' mbarriers (128 bytes), each warp's
// scores P (TILE x MAXG floats) and rescale factors (MAXG floats), then, from
// the next 1024 bytes (the swizzle's period), the warps' rings.  A stage
// holds NSEG boxes of K, then NSEG of V, each TILE rows of SEGB bytes.
template <typename T, int HDP>
struct Layout {
  static constexpr int RB = HDP * static_cast<int>(sizeof(T));  // a row
  static constexpr int SEGB = RB < 128 ? RB : 128;   // a box's row
  static constexpr int NSEG = RB / SEGB;
  static constexpr int SWZ = SEGB == 128 ? 7 : 3;     // the swizzle's row bits
  static constexpr int BOX = TILE * SEGB;
  static constexpr int STAGE = 2 * NSEG * BOX;
  static constexpr int SCORES = (TILE + 1) * MAXG;    // floats a warp
  static constexpr int HEAD = (128 + WARPS * SCORES * 4 + 1023) / 1024 * 1024;
  static constexpr int FIT = (MAX_SMEM - 1024 - HEAD) / (WARPS * STAGE);
  static constexpr int DEPTH = STAGES < FIT ? STAGES : FIT;
  static constexpr int SMEM = 1024 + HEAD + WARPS * DEPTH * STAGE;  // + alignment
  static_assert(DEPTH >= 2, "two stages a warp fit");
  static_assert(SEGB == 64 || SEGB == 128, "rows of 64 bytes or more");

  // The byte offset in a stage's K (or V) half of the 16-byte piece c of
  // row r, as the swizzled box holds it.
  __device__ static __forceinline__ int piece(int r, int c) {
    constexpr int PER = SEGB / 16;                    // pieces a box row
    const int o = r * SEGB + (c % PER) * 16;
    return (c / PER) * BOX + (o ^ (((o >> 7) & SWZ) << 4));
  }
};

// 16 loaded bytes as floats
__device__ __forceinline__ void unpack(const uint4& r, float (&f)[4]) {
  f[0] = __uint_as_float(r.x);
  f[1] = __uint_as_float(r.y);
  f[2] = __uint_as_float(r.z);
  f[3] = __uint_as_float(r.w);
}

__device__ __forceinline__ void unpack(const uint4& r, float (&f)[8]) {
  const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {          // bf16 is the high half of a float
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// One TMA copy of the box at coordinates (c0, c1, c2, c3) of `map` into
// shared memory, completing on the mbarrier `bar`.
__device__ __forceinline__ void tensor_copy(void* dst, const CUtensorMap* map,
                                            int c0, int c1, int c2, int c3,
                                            void* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];"
      ::"r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0),
        "r"(c1), "r"(c2), "r"(c3), "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];"
               ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// 16 bytes into shared memory by the thread, tracked as its own; and the
// wait for all of the thread's such copies.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
               ::"r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// bar_wait, bounded: a copy that never lands traps (an error the wrapper
// raises) after about a second instead of hanging the card.
__device__ __forceinline__ void bar_wait_bounded(void* bar, unsigned parity) {
  const long long start = clock64();
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;"
        " selp.u32 %0, 1, 0, p; }"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
    if (!done && clock64() - start > (1LL << 31)) __trap();
  }
}

// Four 8 x 8 bf16 matrices from shared memory, lane i giving the address
// of row i % 8 of matrix i / 8.
__device__ __forceinline__ void ldsm_x4(uint32_t (&a)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(smem_addr(p)));
}

// The same, each matrix transposed.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&a)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 x) {
  uint32_t u;
  memcpy(&u, &x, sizeof u);
  return u;
}

// c += A (16 x 16, row-major) * B (16 x 8, column-major), float32 sums
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// HDP: the row layout's width (32, 64 or 128); FULL: hd == HDP, else the
// row holds hd_arg < HDP values and the lanes past them are idle.  G, the
// group's query heads, sizes the CUDA-core path's registers; the
// tensor-core path only masks with it and takes g_arg instead (one
// instance for every G).  Block
// bh * splits + split; with splits == 1 and not `partial` it writes out,
// else its partial to ws: the B * Hkv * splits * G parts' rows of hd + 2
// floats, the numerator, then the max and the sum.
template <typename T, int HDP, int G, bool FULL>
__global__ void __launch_bounds__(THREADS)
decode_attention_split(const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap,
                       const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const int* __restrict__ length,
                       T* __restrict__ out, float* __restrict__ ws, int S,
                       int Hkv, int hd_arg, int g_arg, int splits,
                       int rows_per_split, float scale, int partial) {
  using L = Layout<T, HDP>;
  constexpr int VEC = 16 / sizeof(T);    // values per lane per row
  constexpr int LPR = HDP / VEC;         // lanes per row
  constexpr int RPW = 32 / LPR;          // rows per warp per step
  constexpr int DEPTH = L::DEPTH;
  constexpr bool MMA = std::is_same<T, __nv_bfloat16>::value;
  static_assert(HDP % VEC == 0 && 32 % LPR == 0 && TILE % RPW == 0,
                "HDP 32, 64 or 128");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const int HD = FULL ? HDP : hd_arg;    // the row's values
  const int GQ = MMA ? g_arg : G;        // the group's query heads

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int bh = blockIdx.x / splits;    // (b, kv head)
  const int split = blockIdx.x - bh * splits;
  const int b = bh / Hkv;
  const int h = bh - b * Hkv;
  const int len = min(length[b], S);
  const int r0 = split * rows_per_split;
  const int r1 = min(r0 + rows_per_split, len);
  const int tiles = r1 > r0 ? (r1 - r0 + TILE - 1) / TILE : 0;
  const int mine = tiles > warp ? (tiles - warp + WARPS - 1) / WARPS : 0;

  uint64_t* bars = reinterpret_cast<uint64_t*>(smem) + warp * DEPTH;
  float* P = reinterpret_cast<float*>(smem + 128) + warp * L::SCORES;
  float* A = P + TILE * MAXG;            // this tile's rescale, per head
  unsigned char* ring = smem + L::HEAD + warp * DEPTH * L::STAGE;

  if (lane == 0) {
    if (r1 - r0 >= TILE) {               // a whole tile: the maps are read
      prefetch_map(&kmap);
      prefetch_map(&vmap);
    }
    for (int i = 0; i < DEPTH; ++i) bar_init(&bars[i]);
  }
  if (!MMA)                              // scores and P in shared memory
    for (int i = lane; i < L::SCORES; i += 32) P[i] = 0.0f;
  __syncwarp();

  const size_t stride = static_cast<size_t>(Hkv) * HD;   // one S row
  const size_t base = (static_cast<size_t>(b) * S * Hkv + h) * HD;
  auto first_row = [&](int i) { return r0 + (warp + WARPS * i) * TILE; };
  // Tile i of this warp into stage i % DEPTH.  A whole tile: lane 0 arms
  // the mbarrier with the boxes' bytes, then lane j < 2 NSEG copies box j
  // (K's, then V's); the fence orders the lanes' earlier reads of the stage
  // before the copies overwrite it.  The split's last tile, short of TILE
  // rows: cp.async of its rows' 16-byte pieces into their swizzled places
  // and zeros past hd and past its rows (a zero P times a stale NaN of V
  // would still give NaN), so no row at or past its end is read.
  auto issue = [&](int i) {
    const int row0 = first_row(i);
    const int rows = min(TILE, r1 - row0);
    unsigned char* st = ring + (i % DEPTH) * L::STAGE;
    if (rows < TILE) {
      for (int c = lane; c < 2 * TILE * LPR; c += 32) {
        const bool is_v = c >= TILE * LPR;
        const int rc = is_v ? c - TILE * LPR : c;
        const int r = rc / LPR;
        const int pc = rc - r * LPR;
        unsigned char* dst = st + (is_v ? L::NSEG * L::BOX : 0) + L::piece(r, pc);
        if (r < rows && pc * VEC < HD)
          cp_async16(dst, (is_v ? v : k) + base + (row0 + r) * stride + pc * VEC);
        else
          *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
      }
      cp_async_commit();
      return;
    }
    fence_proxy_async();
    if (lane == 0) bar_expect(&bars[i % DEPTH], L::STAGE);
    __syncwarp();
    if (lane < 2 * L::NSEG) {
      const int seg = lane % L::NSEG;
      tensor_copy(st + lane * L::BOX, lane < L::NSEG ? &kmap : &vmap,
                  seg * (L::SEGB / static_cast<int>(sizeof(T))), h, row0, b,
                  &bars[i % DEPTH]);
    }
  };
  for (int i = 0; i < min(mine, DEPTH); ++i) issue(i);

  const int sub = lane % LPR;            // which VEC slice of the row
  const int rig = lane / LPR;            // which row of a step
  const bool live = FULL || sub * VEC < HD;   // the lane holds row values
  const int t4 = lane & 3;

  // q: in bfloat16 the A operand of the mma, the query heads as its rows
  // (lane: head lane / 4, values 2 (lane % 4) + {0, 1, 8, 9} of each 16;
  // rows 8-15 zero); in float32 VEC values a lane for the CUDA-core product
  constexpr int KS = MMA ? HDP / 16 : 1;
  uint32_t qa[KS][2];
  float qf[MMA ? 1 : G][VEC];
  if constexpr (MMA) {
    const int n = lane >> 2;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int d = ks * 16 + half * 8 + 2 * t4;
        qa[ks][half] = n < GQ && d < HD
            ? __ldg(reinterpret_cast<const unsigned*>(
                  q + (static_cast<size_t>(bh) * GQ + n) * HD + d))
            : 0u;
      }
  } else {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const uint4 r = live ? __ldg(reinterpret_cast<const uint4*>(
          q + (static_cast<size_t>(bh) * G + g) * HD + sub * VEC))
                           : make_uint4(0, 0, 0, 0);
      unpack(r, qf[g]);
    }
  }

  // running max and sum of one query head: lane / 4's in bfloat16, lane %
  // 8's in float32
  float m_h = -1e30f, l_h = 0.0f;
  // numerators: in bfloat16 the mma's C, o[nb][0..1] = O[head lane / 4][8 nb
  // + 2 (lane % 4) + {0, 1}] (o[nb][2..3], its rows 8-15, stay 0); in
  // float32 acc[g][e], VEC values of each head
  constexpr int NB = MMA ? HDP / 8 : 1;
  float o[NB][4];
  float acc[MMA ? 1 : G][VEC];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nb][e] = 0.0f;
#pragma unroll
  for (int g = 0; g < (MMA ? 1 : G); ++g)
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[g][e] = 0.0f;

  for (int i = 0; i < mine; ++i) {
    const int row0 = first_row(i);
    const int rows = min(TILE, r1 - row0);
    unsigned char* ks_ = ring + (i % DEPTH) * L::STAGE;
    const unsigned char* vs_ = ks_ + L::NSEG * L::BOX;
    if (rows == TILE) {
      bar_wait_bounded(&bars[i % DEPTH], (i / DEPTH) & 1);
    } else {                             // the lanes' cp.async, then the warp's
      cp_async_wait_all();
      __syncwarp();
    }

    if constexpr (MMA) {
      // S = Q K^T: the tile's rows 0-7 and 8-15 as two 8-wide blocks, K's
      // rows as B (ldmatrix); lane: S[head lane / 4][rows 2 t, 2 t + 1 in
      // s0, 8 + 2 t, 9 + 2 t in s1], t = lane % 4
      float s0[4] = {0.0f, 0.0f, 0.0f, 0.0f}, s1[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      const int krow = (lane & 7) + (lane >> 4) * 8;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        if (!FULL && ks * 16 >= HD) break;
        uint32_t kb[4];
        ldsm_x4(kb, ks_ + L::piece(krow, 2 * ks + ((lane >> 3) & 1)));
        const uint32_t a[4] = {qa[ks][0], 0u, qa[ks][1], 0u};
        mma_bf16(s0, a, kb[0], kb[1]);
        mma_bf16(s1, a, kb[2], kb[3]);
      }
      // the tile's softmax in registers: max and sum over the lane's 4 rows
      // and the 4 lanes of its head
      const int rr[4] = {2 * t4, 2 * t4 + 1, 8 + 2 * t4, 9 + 2 * t4};
      float sv[4] = {s0[0] * scale, s0[1] * scale, s1[0] * scale, s1[1] * scale};
      float tmax = -1e30f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sv[j] = rr[j] < rows ? sv[j] : -1e30f;
        tmax = fmaxf(tmax, sv[j]);
      }
      tmax = fmaxf(tmax, __shfl_xor_sync(FULL_MASK, tmax, 1));
      tmax = fmaxf(tmax, __shfl_xor_sync(FULL_MASK, tmax, 2));
      const float mn = fmaxf(m_h, tmax);
      const float alpha = expf(m_h - mn);
      float pr[4], ps = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        pr[j] = rr[j] < rows ? expf(sv[j] - mn) : 0.0f;
        ps += pr[j];
      }
      ps += __shfl_xor_sync(FULL_MASK, ps, 1);
      ps += __shfl_xor_sync(FULL_MASK, ps, 2);
      l_h = l_h * alpha + ps;
      m_h = mn;
      // P as the A operand in three bfloat16 terms, p = p1 + p2 + p3 + e
      // with |e| <= 2^-24 p: each term rounds what the earlier ones left
      uint32_t pa[3][2];
#pragma unroll
      for (int term = 0; term < 3; ++term) {
        const __nv_bfloat162 x = __floats2bfloat162_rn(pr[0], pr[1]);
        const __nv_bfloat162 y = __floats2bfloat162_rn(pr[2], pr[3]);
        pa[term][0] = bf16x2_bits(x);
        pa[term][1] = bf16x2_bits(y);
        pr[0] -= __low2float(x);
        pr[1] -= __high2float(x);
        pr[2] -= __low2float(y);
        pr[3] -= __high2float(y);
      }
      // O += P V: V's rows as B (ldmatrix, transposed), 16 columns a load
      const int vrow = (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        o[nb][0] *= alpha;
        o[nb][1] *= alpha;
      }
#pragma unroll
      for (int db = 0; db < NB / 2; ++db) {
        if (!FULL && db * 16 >= HD) break;
        uint32_t vb[4];
        ldsm_x4_trans(vb, vs_ + L::piece(vrow, 2 * db + (lane >> 4)));
#pragma unroll
        for (int term = 0; term < 3; ++term) {
          const uint32_t a[4] = {pa[term][0], 0u, pa[term][1], 0u};
          mma_bf16(o[2 * db], a, vb[0], vb[1]);
          mma_bf16(o[2 * db + 1], a, vb[2], vb[3]);
        }
      }
    } else {
      // scaled scores of the tile's rows into P[row][head]
      const int hh = lane & (MAXG - 1);  // the head whose softmax it keeps
      const int rq = lane >> 3;          // and its rows rq, rq + 4, ...
#pragma unroll
      for (int j = 0; j < TILE / RPW; ++j) {
        const int r = j * RPW + rig;
        float kf[VEC];
        unpack(live ? *reinterpret_cast<const uint4*>(ks_ + L::piece(r, sub))
                    : make_uint4(0, 0, 0, 0), kf);
        float s[G];
#pragma unroll
        for (int g = 0; g < G; ++g) {
          float d = 0.0f;
#pragma unroll
          for (int e = 0; e < VEC; ++e) d = fmaf(qf[g][e], kf[e], d);
          s[g] = d;
        }
#pragma unroll
        for (int o_ = LPR / 2; o_ > 0; o_ >>= 1)
#pragma unroll
          for (int g = 0; g < G; ++g) s[g] += __shfl_xor_sync(FULL_MASK, s[g], o_);
        if (sub == 0)
#pragma unroll
          for (int g = 0; g < G; ++g) P[r * MAXG + g] = s[g] * scale;
      }
      __syncwarp();

      // the tile's softmax, head hh over rows rq + 4 j: max and sum over
      // the 8 lanes of the head, P[row][hh] = exp(s - m), A[hh] the rescale
      float sv[TILE / 4];
      float tmax = -1e30f;
#pragma unroll
      for (int j = 0; j < TILE / 4; ++j) {
        const int r = rq + 4 * j;
        sv[j] = r < rows ? P[r * MAXG + hh] : -1e30f;
        tmax = fmaxf(tmax, sv[j]);
      }
      tmax = fmaxf(tmax, __shfl_xor_sync(FULL_MASK, tmax, 8));
      tmax = fmaxf(tmax, __shfl_xor_sync(FULL_MASK, tmax, 16));
      const float mn = fmaxf(m_h, tmax);
      const float alpha = expf(m_h - mn);
      float ps = 0.0f;
#pragma unroll
      for (int j = 0; j < TILE / 4; ++j) {
        const int r = rq + 4 * j;
        const float p = r < rows ? expf(sv[j] - mn) : 0.0f;
        P[r * MAXG + hh] = p;
        ps += p;
      }
      ps += __shfl_xor_sync(FULL_MASK, ps, 8);
      ps += __shfl_xor_sync(FULL_MASK, ps, 16);
      l_h = l_h * alpha + ps;
      m_h = mn;
      if (lane < MAXG) A[lane] = alpha;
      __syncwarp();

      // P . V in float32: VEC values of rows rig, rig + RPW, ... below rows
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float a = A[g];
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[g][e] *= a;
      }
      for (int r = rig; r < rows; r += RPW) {
        float vf[VEC];
        unpack(live ? *reinterpret_cast<const uint4*>(vs_ + L::piece(r, sub))
                    : make_uint4(0, 0, 0, 0), vf);
        const float4 p0 = *reinterpret_cast<const float4*>(P + r * MAXG);
        const float4 p1 = *reinterpret_cast<const float4*>(P + r * MAXG + 4);
        const float pg[MAXG] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
#pragma unroll
        for (int g = 0; g < G; ++g)
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[g][e] = fmaf(pg[g], vf[e], acc[g][e]);
      }
    }
    __syncwarp();                        // every lane is done with the stage
    if (i + DEPTH < mine) issue(i + DEPTH);
  }

  __syncthreads();                       // every ring is read: reuse it
  float* sm_m = reinterpret_cast<float*>(smem + L::HEAD);
  float* sm_l = sm_m + WARPS * MAXG;
  float* sm_acc = sm_l + WARPS * MAXG;   // [WARPS][G][HDP]
  if constexpr (MMA) {
    const int n = lane >> 2;
    if (t4 == 0) {
      sm_m[warp * MAXG + n] = m_h;
      sm_l[warp * MAXG + n] = l_h;
    }
    if (n < GQ)
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
        *reinterpret_cast<float2*>(sm_acc + (warp * GQ + n) * HDP + nb * 8 +
                                   2 * t4) = make_float2(o[nb][0], o[nb][1]);
  } else {
    // the row groups of a warp share its max: their numerators add
#pragma unroll
    for (int o_ = LPR; o_ < 32; o_ <<= 1)
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          acc[g][e] += __shfl_xor_sync(FULL_MASK, acc[g][e], o_);
    if (lane < MAXG) {
      sm_m[warp * MAXG + lane] = m_h;
      sm_l[warp * MAXG + lane] = l_h;
    }
    if (lane < LPR)
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          sm_acc[(warp * G + g) * HDP + sub * VEC + e] = acc[g][e];
  }
  __syncthreads();

  // merge the warps in order; one output value per thread and step
  for (int i = threadIdx.x; i < GQ * HD; i += THREADS) {
    const int g = i / HD;
    const int d = i - g * HD;
    float mm = sm_m[g];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) mm = fmaxf(mm, sm_m[w * MAXG + g]);
    float den = 0.0f, num = 0.0f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float a = expf(sm_m[w * MAXG + g] - mm);
      den += sm_l[w * MAXG + g] * a;
      num += sm_acc[(w * GQ + g) * HDP + d] * a;
    }
    if (splits == 1 && !partial) {
      store(out + (static_cast<size_t>(bh) * GQ + g) * HD + d,
            num / fmaxf(den, 1e-30f));
    } else {
      float* row = ws + (static_cast<size_t>(blockIdx.x) * GQ + g) * (HD + 2);
      row[d] = num;
      if (d == 0) {
        row[HD] = mm;
        row[HD + 1] = den;
      }
    }
  }
}

// Fold the parts of (b, kv head, query head) = (blockIdx.x, blockIdx.y) in
// index order: part sp of them is the row (bh * bh_stride + sp * sp_stride
// + g) of hd + 2 floats in `parts` (a split's partial in the workspace:
// bh_stride splits * G, sp_stride G; a rank's in the merge: bh_stride G,
// sp_stride B * Hkv * G).  Warp 0 merges their maxima and sums (each lane
// the parts lane, lane + 32, ... in order, then a fixed shuffle tree), then
// each thread d < hd sums the numerators' column d with the parts' weights
// exp(m - max) and writes the output value; with PARTIAL, the undivided
// numerator, the max and the sum, a partial of its own, (B, Hkv, G, hd + 2).
template <typename T, bool PARTIAL>
__global__ void __launch_bounds__(128)
decode_attention_combine(const float* __restrict__ parts,
                         typename std::conditional<PARTIAL, float, T>::type*
                             __restrict__ out,
                         int n, int HD, long long bh_stride,
                         long long sp_stride) {
  __shared__ float s_w[MAX_SPLITS];      // a part's max, then its weight
  __shared__ float s_m, s_den;
  const int G = gridDim.y;
  const int bh = blockIdx.x;
  const int g = blockIdx.y;
  const size_t W = static_cast<size_t>(HD) + 2;
  const float* p0 = parts + (static_cast<size_t>(bh) * bh_stride + g) * W;
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    float mm = -1e30f;
    for (int sp = lane; sp < n; sp += 32) {
      s_w[sp] = p0[static_cast<size_t>(sp) * sp_stride * W + HD];
      mm = fmaxf(mm, s_w[sp]);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      mm = fmaxf(mm, __shfl_xor_sync(FULL_MASK, mm, o));
    float den = 0.0f;
    for (int sp = lane; sp < n; sp += 32) {
      const float a = expf(s_w[sp] - mm);
      s_w[sp] = a;
      den += p0[static_cast<size_t>(sp) * sp_stride * W + HD + 1] * a;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) den += __shfl_xor_sync(FULL_MASK, den, o);
    if (lane == 0) {
      s_m = mm;
      s_den = den;
    }
  }
  __syncthreads();
  const int d = threadIdx.x;
  const size_t row = static_cast<size_t>(bh) * G + g;
  if (d < HD) {
    const float* num_of = p0 + d;
    float num = 0.0f;
#pragma unroll 8
    for (int sp = 0; sp < n; ++sp)
      num += num_of[static_cast<size_t>(sp) * sp_stride * W] * s_w[sp];
    if constexpr (PARTIAL) {
      out[row * W + d] = num;
    } else {
      store(out + row * HD + d, num / fmaxf(s_den, 1e-30f));
    }
  }
  if constexpr (PARTIAL) {
    if (d == 0) {
      out[row * W + HD] = s_m;
      out[row * W + HD + 1] = s_den;
    }
  }
}

// cuTensorMapEncodeTiled, found once through cudaGetDriverEntryPoint, so
// the library links against the runtime alone.
using EncodeTiled = decltype(&cuTensorMapEncodeTiled);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The 4-D map (hd, Hkv, S, B) of a K or V cache, boxes of TILE rows by
// SEGB bytes of one head's row, swizzled as Layout::piece reads them.
template <typename T, int HDP>
cudaError_t tensor_map(CUtensorMap* map, const void* base, int B, int S,
                       int Hkv, int HD) {
  using L = Layout<T, HDP>;
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  constexpr cuuint64_t e = sizeof(T);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(HD),
                              static_cast<cuuint64_t>(Hkv),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {HD * e, Hkv * HD * e,
                                 static_cast<cuuint64_t>(S) * Hkv * HD * e};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(L::SEGB / e), 1, TILE, 1};
  const cuuint32_t steps[4] = {1, 1, 1, 1};
  const CUresult r = fn(
      map, std::is_same<T, float>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                         : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      4, const_cast<void*>(base), dims, strides, box, steps,
      CU_TENSOR_MAP_INTERLEAVE_NONE,
      L::SEGB == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The same, from a cache of the maps this host thread has encoded, keyed by
// the full address (a map is a function of the address and the shape
// alone).  The decode path passes the layers' views of stacked caches, the
// same views at every step, so from the second step on every call finds its
// two maps here; the cache is emptied when it holds MAPS of them.
template <typename T, int HDP>
cudaError_t cached_map(CUtensorMap* map, const void* base, int B, int S,
                       int Hkv, int HD) {
  struct Entry {
    CUtensorMap map;
    int B, S, Hkv, HD;
  };
  constexpr size_t MAPS = 4096;
  static thread_local std::unordered_map<const void*, Entry> cache;
  auto it = cache.find(base);
  if (it == cache.end() || it->second.B != B || it->second.S != S ||
      it->second.Hkv != Hkv || it->second.HD != HD) {
    Entry e;
    const cudaError_t err = tensor_map<T, HDP>(&e.map, base, B, S, Hkv, HD);
    if (err != cudaSuccess) return err;
    e.B = B;
    e.S = S;
    e.Hkv = Hkv;
    e.HD = HD;
    if (it != cache.end()) {
      it->second = e;
    } else {
      if (cache.size() >= MAPS) cache.clear();
      it = cache.emplace(base, e).first;
    }
  }
  *map = it->second.map;
  return cudaSuccess;
}

// With `pout` (decode_attention_partial) the block's partial goes there:
// written by the split kernel with one split, folded by the combine into it
// with more.
template <typename T, int HDP, int GT, bool FULL>
cudaError_t launch(int G, const void* q, const void* k, const void* v,
                   const void* length, void* out, void* ws, void* pout, int B,
                   int S, int Hkv, int HD, float scale, int splits, int rows,
                   cudaStream_t s) {
  using L = Layout<T, HDP>;
  // above the default 48 KB a block must ask for its shared memory, once a
  // card (the cards seen so far, one bit each)
  static unsigned long long asked = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 64 || !(asked >> dev & 1)) {
    e = cudaFuncSetAttribute(decode_attention_split<T, HDP, GT, FULL>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             L::SMEM);
    if (e != cudaSuccess) return e;
    if (dev < 64) asked |= 1ull << dev;
  }
  CUtensorMap kmap, vmap;               // a cache shorter than a tile has
  memset(&kmap, 0, sizeof kmap);        // no whole tile: no map is read
  memset(&vmap, 0, sizeof vmap);
  if (S >= TILE) {
    e = cached_map<T, HDP>(&kmap, k, B, S, Hkv, HD);
    if (e == cudaSuccess) e = cached_map<T, HDP>(&vmap, v, B, S, Hkv, HD);
    if (e != cudaSuccess) return e;
  }
  const bool partial = pout != nullptr;
  decode_attention_split<T, HDP, GT, FULL>
      <<<B * Hkv * splits, THREADS, L::SMEM, s>>>(
          kmap, vmap, static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<const int*>(length),
          static_cast<T*>(out),
          static_cast<float*>(partial && splits == 1 ? pout : ws), S, Hkv,
          HD, G, splits, rows, scale, partial);
  const dim3 grid(B * Hkv, G);
  const long long bh_stride = static_cast<long long>(splits) * G;
  if (splits > 1 && partial)
    decode_attention_combine<T, true><<<grid, 128, 0, s>>>(
        static_cast<const float*>(ws), static_cast<float*>(pout), splits, HD,
        bh_stride, G);
  else if (splits > 1)
    decode_attention_combine<T, false><<<grid, 128, 0, s>>>(
        static_cast<const float*>(ws), static_cast<T*>(out), splits, HD,
        bh_stride, G);
  return cudaGetLastError();
}

template <typename T, int HDP, bool FULL>
cudaError_t launch_g(int G, const void* q, const void* k, const void* v,
                     const void* length, void* out, void* ws, void* pout,
                     int B, int S, int Hkv, int HD, float scale, int splits,
                     int rows, cudaStream_t s) {
#define DA_CASE(g)                                                          \
  case g:                                                                   \
    return launch<T, HDP, g, FULL>(G, q, k, v, length, out, ws, pout, B, S, \
                                   Hkv, HD, scale, splits, rows, s);
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {   // G only masks
    if (G < 1 || G > MAXG) return cudaErrorInvalidValue;
    return launch<T, HDP, MAXG, FULL>(G, q, k, v, length, out, ws, pout, B, S,
                                      Hkv, HD, scale, splits, rows, s);
  } else {
    switch (G) {
      DA_CASE(1) DA_CASE(2) DA_CASE(3) DA_CASE(4)
      DA_CASE(5) DA_CASE(6) DA_CASE(7) DA_CASE(8)
      default: return cudaErrorInvalidValue;
    }
  }
#undef DA_CASE
}

// hd 32, 64, 128 in their own layout; any other multiple of VEC up to 128
// in the 128-wide one
template <typename T>
cudaError_t launch_hd(int HD, int G, const void* q, const void* k,
                      const void* v, const void* length, void* out, void* ws,
                      void* pout, int B, int S, int Hkv, float scale,
                      int splits, int rows, cudaStream_t s) {
  constexpr int VEC = 16 / sizeof(T);
#define DA_ARGS \
  G, q, k, v, length, out, ws, pout, B, S, Hkv, HD, scale, splits, rows, s
  switch (HD) {
    case 32: return launch_g<T, 32, true>(DA_ARGS);
    case 64: return launch_g<T, 64, true>(DA_ARGS);
    case 128: return launch_g<T, 128, true>(DA_ARGS);
    default: break;
  }
  if (HD <= 0 || HD > 128 || HD % VEC) return cudaErrorInvalidValue;
  return launch_g<T, 128, false>(DA_ARGS);
#undef DA_ARGS
}

// The plan's checks, shared by the two entries over a cache: `splits`
// blocks per (b, kv head), each over `rows_per_split` rows (a multiple of
// TILE, 16, with splits * rows_per_split >= S > (splits - 1) *
// rows_per_split, at most 512 splits), and with splits > 1 a workspace.
bool plan_ok(int B, int S, int Hkv, int splits, int rows_per_split,
             const void* ws) {
  const long long blocks = static_cast<long long>(B) * Hkv * splits;
  return splits >= 1 && rows_per_split >= TILE && rows_per_split % TILE == 0 &&
         static_cast<long long>(splits) * rows_per_split >= S &&
         static_cast<long long>(splits - 1) * rows_per_split < S &&
         blocks <= INT_MAX && splits <= MAX_SPLITS &&
         (splits == 1 || ws != nullptr);
}

}  // namespace

extern "C" {

// Launch on `stream` the split kernel and, with splits > 1, the combine
// over `ws`, float32 workspace of B * Hkv * splits * G * (hd + 2) values
// (plan_ok's plan).  Returns cudaGetLastError() after the launches, or
// cudaErrorInvalidValue for a shape or plan the kernel does not take (hd
// not a multiple of 16 bytes' values up to 128, G outside [1, 8]).
int decode_attention(const void* q, const void* k, const void* v,
                     const void* length, void* out, void* ws, int B, int S,
                     int Hkv, int G, int HD, int bf16, float scale, int splits,
                     int rows_per_split, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B * Hkv == 0) return 0;
  if (!plan_ok(B, S, Hkv, splits, rows_per_split, ws))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e =
      bf16 ? launch_hd<__nv_bfloat16>(HD, G, q, k, v, length, out, ws, nullptr,
                                      B, S, Hkv, scale, splits, rows_per_split,
                                      s)
           : launch_hd<float>(HD, G, q, k, v, length, out, ws, nullptr, B, S,
                              Hkv, scale, splits, rows_per_split, s);
  return static_cast<int>(e);
}

// The same over one rank's block of a cache sharded along S (`length` the
// rows of this block each batch row attends, 0 .. S), writing the block's
// partial to `pout`, float32 (B, Hkv, G, hd + 2): the numerators, the max
// and the sum of each query head.
int decode_attention_partial(const void* q, const void* k, const void* v,
                             const void* length, void* pout, void* ws, int B,
                             int S, int Hkv, int G, int HD, int bf16,
                             float scale, int splits, int rows_per_split,
                             void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B * Hkv == 0) return 0;
  if (!plan_ok(B, S, Hkv, splits, rows_per_split, ws) || pout == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e =
      bf16 ? launch_hd<__nv_bfloat16>(HD, G, q, k, v, length, nullptr, ws,
                                      pout, B, S, Hkv, scale, splits,
                                      rows_per_split, s)
           : launch_hd<float>(HD, G, q, k, v, length, nullptr, ws, pout, B, S,
                              Hkv, scale, splits, rows_per_split, s);
  return static_cast<int>(e);
}

// Fold M partials, (M, B * Hkv, G, hd + 2) float32 in rank order, into
// `out` (B * Hkv, G, hd) of float32 or bfloat16, each (b, kv head, query
// head) in index order by the combine kernel.
int decode_attention_merge(const void* parts, void* out, int M, int BH, int G,
                           int HD, int bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (BH == 0) return 0;
  if (M < 1 || M > MAX_SPLITS || BH < 0 || G < 1 || G > 65535 || HD < 1 ||
      HD > 128)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(BH, G);
  const long long sp_stride = static_cast<long long>(BH) * G;
  if (bf16)
    decode_attention_combine<__nv_bfloat16, false><<<grid, 128, 0, s>>>(
        static_cast<const float*>(parts), static_cast<__nv_bfloat16*>(out), M,
        HD, G, sp_stride);
  else
    decode_attention_combine<float, false><<<grid, 128, 0, s>>>(
        static_cast<const float*>(parts), static_cast<float*>(out), M, HD, G,
        sp_stride);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
