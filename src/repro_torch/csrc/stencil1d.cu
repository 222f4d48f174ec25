// stencil1d: the 1-D weighted window (SMA, WMA, lag, lead, rolling sums and
// means) over a halo-extended float32 array, in four modes of one template:
//   plain          out[i] = sum_j w[j] * ext[i + j]
//   exact          the same, renormalized by total / mass, where mass[i] =
//                  sum_j w[j] * ext_m[i + j]; 0 where the mass is 0
//   segment        tap j counts only where ext_s[i + j] == ext_s[i + center]
//   segment+exact  the segment taps, renormalized by their own weight mass
// for i in [0, n), n = len(ext) - K + 1.  Three C entry points:
// stencil1d, stencil1d_exact and segment_stencil.
//
// Replaces the TPU kernels src/repro/kernels/stencil1d/stencil1d.py:48, :86
// and :138 (stencil1d_pallas, stencil1d_exact_pallas,
// segment_stencil_pallas).  Those fold the K weights in as compile-time
// constants and give each 2048-row block a (K - 1)-row tail table.  Here the
// weights arrive at run time as a device array and K is whatever the caller
// asks for.
//
// Design.  A block of THREADS threads computes one tile of TILE outputs,
// GROUPS groups of VEC = 4 consecutive outputs for each thread.  It stages
// in shared memory the TILE + J - 1 rows of ext (and of ext_m or ext_s)
// that a chunk of J <= CHUNK taps reads, and the chunk's weights; the
// buffers are sized to the actual J (dynamic shared memory, at most 44 KB),
// so several tiles of 16 to 32 KB are in flight on each SM, which is what
// keeps the memory busy.  BULK (16-byte aligned pointers) stages each array
// with one TMA bulk copy, started by thread 0 and completing on an
// mbarrier; WORDS (not aligned), and a tile whose copy would run past
// len(ext), stages with 4-byte loads.  A thread takes its groups one after
// another (registers hold one group's sums): it slides an 8-row register
// window along the staged rows, reading 4 rows (one 16-byte shared load per
// array) for every 4 taps, so shared-memory reads grow as K / 4 + 1 words
// an output and array, not K; the segment modes read each output's centre
// id from the staged ext_s.  A window longer than CHUNK taps is staged
// again for each further chunk (and each group).  A BULK launch stores a
// group's 4 outputs with one 16-byte store where all 4 lie below n.  The
// kernel never reads past len(ext).
// Bound: bytes, 8 a row for plain and 12 for exact and segment (each input
// read once, the output written once), while K is small.
//
// Rounding: taps accumulate in the order j = 0 .. K-1 with separate
// float32 multiplies and adds (__fmul_rn / __fadd_rn, never contracted into
// a fused multiply-add), and the renormalize is (acc * total) / mass, so the
// kernel computes the same float32 operations as its plain version and
// matches it bit for bit.

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int VEC = 4;                       // consecutive outputs per group
constexpr int GROUPS = 4;                    // groups per thread
constexpr int GROUP_ROWS = THREADS * VEC;
constexpr int TILE = GROUPS * GROUP_ROWS;    // outputs per block: 4096
constexpr int CHUNK = 1024;                  // taps staged per round

enum Mode { PLAIN = 0, EXACT = 1, SEGMENT = 2, SEGMENT_EXACT = 3 };
enum Load { BULK = 0, WORDS = 1 };

__host__ __device__ constexpr int round4(int v) { return (v + 3) & ~3; }

// Rows of one staging buffer for a chunk of J taps: the TILE + J - 1 rows
// the chunk's taps read, and the rows the last thread's window reads past
// them (never used).
__host__ __device__ constexpr int buffer_rows(int J) {
  return TILE + round4(J);
}

// Shared bytes of a block: one or two buffers, and the weights.
constexpr int smem_bytes(int arrays, int J) {
  return (arrays * buffer_rows(J) + round4(J)) * 4;
}
static_assert(smem_bytes(2, CHUNK) <= 227 * 1024,
              "more shared memory than a block can have");

__device__ __forceinline__ void load8(uint32_t (&v)[8], const uint32_t* p) {
  const uint4 a = *reinterpret_cast<const uint4*>(p);
  const uint4 b = *reinterpret_cast<const uint4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// Drop the window's first 4 rows and append the 4 at p.
__device__ __forceinline__ void slide(uint32_t (&v)[8], const uint32_t* p) {
  const uint4 a = *reinterpret_cast<const uint4*>(p);
  v[0] = v[4]; v[1] = v[5]; v[2] = v[6]; v[3] = v[7];
  v[4] = a.x; v[5] = a.y; v[6] = a.z; v[7] = a.w;
}

// x holds ext; y holds ext_m (EXACT) or ext_s (the segment modes).
template <int MODE, int LOAD>
__global__ void __launch_bounds__(THREADS)
stencil_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ y,
               const float* __restrict__ w, float* __restrict__ out,
               long long n, int K, int center, float total) {
  constexpr bool SEG = MODE == SEGMENT || MODE == SEGMENT_EXACT;
  constexpr bool MASS = MODE == EXACT || MODE == SEGMENT_EXACT;
  constexpr int ARRAYS = MODE == PLAIN ? 1 : 2;
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ __align__(8) unsigned long long s_bar;
  const int rows = buffer_rows(min(K, CHUNK));
  uint32_t* sx = smem;
  uint32_t* sy = smem + rows;
  float* sw = reinterpret_cast<float*>(smem + ARRAYS * rows);
  const long long base = static_cast<long long>(blockIdx.x) * TILE;
  const long long len = n + K - 1;
  if (LOAD == BULK && threadIdx.x == 0) bar_init(&s_bar);
  unsigned phase = 0;
  bool staged = false;

  // stage the chunk of J taps from tap j0: its rows and its weights
  auto stage = [&](int j0, int J) {
    const int span = TILE + J - 1;            // rows the chunk's taps read
    const long long g0 = base + j0;
    const bool bulk = LOAD == BULK && g0 + round4(span) <= len;
    if (staged) __syncthreads();              // the last chunk's reads are done
    staged = true;
    if (bulk) {
      if (threadIdx.x == 0) {
        const int bytes = round4(span) * 4;
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        bar_expect(&s_bar, ARRAYS * bytes);
        bulk_copy(sx, x + g0, bytes, &s_bar);
        if (ARRAYS == 2) bulk_copy(sy, y + g0, bytes, &s_bar);
      }
    } else {
#pragma unroll 4
      for (int i = threadIdx.x; i < span; i += THREADS) {
        const long long g = g0 + i;
        const bool in = g < len;
        sx[i] = in ? __ldg(x + g) : 0u;
        if (ARRAYS == 2) sy[i] = in ? __ldg(y + g) : (SEG ? ~1u : 0u);  // -2
      }
    }
    for (int j = threadIdx.x; j < round4(J); j += THREADS)
      sw[j] = j < J ? w[j0 + j] : 0.0f;
    __syncthreads();
    if (bulk) {
      bar_wait(&s_bar, phase);
      phase ^= 1u;
    }
  };

  const bool one_chunk = K <= CHUNK;
  if (one_chunk) stage(0, K);
  for (int gi = 0; gi < GROUPS; ++gi) {
    const int o = gi * GROUP_ROWS + VEC * threadIdx.x;   // in the tile
    float acc[VEC] = {}, mass[VEC] = {};
    int sid[VEC] = {};
    for (int j0 = 0; j0 < K; j0 += CHUNK) {
      const int J = min(CHUNK, K - j0);
      if (!one_chunk) stage(j0, J);
      if (SEG && j0 == 0) {   // the centre ids: rows o + center + i
        if (center < J) {
          uint32_t v[8];
          load8(v, sy + o + (center & ~3));
          const int c3 = center & 3;
#pragma unroll
          for (int i = 0; i < VEC; ++i)
            sid[i] = static_cast<int>(
                c3 == 0 ? v[i] : c3 == 1 ? v[i + 1] : c3 == 2 ? v[i + 2] : v[i + 3]);
        } else {              // beyond the first chunk: from global memory
#pragma unroll
          for (int i = 0; i < VEC; ++i) {
            const long long g = base + o + center + i;
            sid[i] = g < len ? static_cast<int>(__ldg(y + g)) : -2;
          }
        }
      }
      uint32_t xa[8], ya[8];
      load8(xa, sx + o);
      if (ARRAYS == 2) load8(ya, sy + o);
      for (int jb = 0; jb < J; jb += 4) {
        const float4 w4 = *reinterpret_cast<const float4*>(sw + jb);
        const float wv[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
        for (int d = 0; d < 4; ++d) {
          if (jb + d < J) {
            const float wj = wv[d];
#pragma unroll
            for (int i = 0; i < VEC; ++i) {
              const float xv = __uint_as_float(xa[i + d]);
              if constexpr (SEG) {
                const bool same = static_cast<int>(ya[i + d]) == sid[i];
                acc[i] = __fadd_rn(acc[i], __fmul_rn(wj, same ? xv : 0.0f));
                if constexpr (MASS)
                  mass[i] = __fadd_rn(mass[i], __fmul_rn(wj, same ? 1.0f : 0.0f));
              } else {
                acc[i] = __fadd_rn(acc[i], __fmul_rn(wj, xv));
                if constexpr (MASS)
                  mass[i] = __fadd_rn(mass[i],
                                      __fmul_rn(wj, __uint_as_float(ya[i + d])));
              }
            }
          }
        }
        if (jb + 4 < J) {   // slide the window 4 rows
          slide(xa, sx + o + jb + 8);
          if (ARRAYS == 2) slide(ya, sy + o + jb + 8);
        }
      }
    }

    const long long g = base + o;
    float r[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      r[i] = acc[i];
      if constexpr (MASS) {
        r[i] = 0.0f;
        if (mass[i] != 0.0f) r[i] = __fdiv_rn(__fmul_rn(acc[i], total), mass[i]);
      }
    }
    if (LOAD == BULK && g + VEC <= n) {
      *reinterpret_cast<float4*>(out + g) = make_float4(r[0], r[1], r[2], r[3]);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        if (g + i < n) out[g + i] = r[i];
    }
  }
}

// One launch, a block a tile.
template <int MODE, int LOAD>
cudaError_t go(const uint32_t* x, const uint32_t* y, const float* w,
               float* out, long long n, int K, int center, float total,
               int smem, cudaStream_t s) {
  if (smem > 48 * 1024) {   // above the default, a block must ask for it
    const cudaError_t e = cudaFuncSetAttribute(
        stencil_kernel<MODE, LOAD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return e;
  }
  const int nblocks = static_cast<int>((n + TILE - 1) / TILE);
  stencil_kernel<MODE, LOAD><<<nblocks, THREADS, smem, s>>>(x, y, w, out, n, K,
                                                            center, total);
  return cudaGetLastError();
}

// Launch on `stream`; `load` is a Load: BULK needs every pointer to be a
// multiple of 16 bytes.  Returns the first CUDA error, or
// cudaGetLastError() after the launch.
template <int MODE>
int launch(const void* x, const void* y, const void* w, void* out,
           long long n, int K, int center, float total, int load,
           void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const int smem = smem_bytes(MODE == PLAIN ? 1 : 2, min(K, CHUNK));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* a = static_cast<const uint32_t*>(x);
  const auto* b = static_cast<const uint32_t*>(y);
  const auto* wd = static_cast<const float*>(w);
  auto* o = static_cast<float*>(out);
  switch (load) {
    case BULK:
      return static_cast<int>(
          go<MODE, BULK>(a, b, wd, o, n, K, center, total, smem, s));
    case WORDS:
      return static_cast<int>(
          go<MODE, WORDS>(a, b, wd, o, n, K, center, total, smem, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

int stencil1d(const void* ext, const void* w, void* out, long long n, int K,
              int load, void* stream) {
  return launch<PLAIN>(ext, nullptr, w, out, n, K, 0, 0.0f, load, stream);
}

int stencil1d_exact(const void* ext, const void* ext_m, const void* w,
                    void* out, long long n, int K, float total, int load,
                    void* stream) {
  return launch<EXACT>(ext, ext_m, w, out, n, K, 0, total, load, stream);
}

int segment_stencil(const void* ext, const void* ext_s, const void* w,
                    void* out, long long n, int K, int center, int exact,
                    float total, int load, void* stream) {
  if (exact)
    return launch<SEGMENT_EXACT>(ext, ext_s, w, out, n, K, center, total,
                                 load, stream);
  return launch<SEGMENT>(ext, ext_s, w, out, n, K, center, total, load,
                         stream);
}

}  // extern "C"
