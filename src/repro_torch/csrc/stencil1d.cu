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
// Replaces the TPU kernels kernels/stencil1d/stencil1d.py
// (stencil1d_pallas, stencil1d_exact_pallas, segment_stencil_pallas).
// Those fold the K weights in as compile-time constants and give each
// 2048-row block a (K - 1)-row tail table.  Here the weights arrive at run
// time as a device array and K is whatever the caller asks for: each block
// computes TILE outputs, staging in shared memory its span of ext (and of
// ext_m or ext_s) together with up to CHUNK - 1 halo rows and CHUNK
// weights, then runs those taps from shared memory; a window longer than
// CHUNK taps is staged again for each further chunk.  Thread t owns outputs
// t, t + THREADS, ... of the tile, so a warp reads consecutive words.  The
// kernel never reads past len(ext).
// Bound: bytes (8 bytes a row for plain, 12 for exact and segment) while K
// is small; shared-memory reads grow with K.
//
// Rounding: taps accumulate in the order j = 0 .. K-1 with separate
// float32 multiplies and adds (__fmul_rn / __fadd_rn, never contracted into
// a fused multiply-add), and the renormalize is (acc * total) / mass, so the
// kernel computes the same float32 operations as its plain version.

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int ITEMS = 8;
constexpr int TILE = THREADS * ITEMS;   // outputs per block
constexpr int CHUNK = 1024;             // taps staged per round
constexpr int SPAN = TILE + CHUNK - 1;  // staged rows per round

enum Mode { PLAIN = 0, EXACT = 1, SEGMENT = 2, SEGMENT_EXACT = 3 };

template <int MODE>
__global__ void __launch_bounds__(THREADS)
stencil_kernel(const float* __restrict__ ext, const float* __restrict__ ext_m,
               const int* __restrict__ ext_s, const float* __restrict__ w,
               float* __restrict__ out, long long n, int K, int center,
               float total) {
  constexpr bool SEG = MODE == SEGMENT || MODE == SEGMENT_EXACT;
  constexpr bool MASS = MODE == EXACT || MODE == SEGMENT_EXACT;
  constexpr bool MARR = MODE == EXACT;    // the mass comes from ext_m
  __shared__ float sx[SPAN];
  __shared__ float sm[MARR ? SPAN : 1];
  __shared__ int ss[SEG ? SPAN : 1];
  __shared__ float sw[CHUNK];
  const long long base = (long long)blockIdx.x * TILE;
  const long long len = n + K - 1;

  float acc[ITEMS], mass[ITEMS];
  int sid[ITEMS];
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    acc[k] = 0.0f;
    mass[k] = 0.0f;
    const long long g = base + k * THREADS + threadIdx.x;
    sid[k] = SEG && g < n ? ext_s[g + center] : 0;
  }

  for (int j0 = 0; j0 < K; j0 += CHUNK) {
    const int J = min(CHUNK, K - j0);
    __syncthreads();  // the previous chunk's reads are done
    for (int i = threadIdx.x; i < TILE + J - 1; i += THREADS) {
      const long long g = base + j0 + i;
      const bool in = g < len;
      sx[i] = in ? ext[g] : 0.0f;
      if constexpr (MARR) sm[i] = in ? ext_m[g] : 0.0f;
      if constexpr (SEG) ss[i] = in ? ext_s[g] : -2;
    }
    for (int j = threadIdx.x; j < J; j += THREADS) sw[j] = w[j0 + j];
    __syncthreads();
    for (int j = 0; j < J; ++j) {
      const float wj = sw[j];
#pragma unroll
      for (int k = 0; k < ITEMS; ++k) {
        const int i = k * THREADS + threadIdx.x + j;
        if constexpr (SEG) {
          const bool same = ss[i] == sid[k];
          acc[k] = __fadd_rn(acc[k], __fmul_rn(wj, same ? sx[i] : 0.0f));
          if constexpr (MASS) mass[k] = __fadd_rn(mass[k], __fmul_rn(wj, same ? 1.0f : 0.0f));
        } else {
          acc[k] = __fadd_rn(acc[k], __fmul_rn(wj, sx[i]));
          if constexpr (MASS) mass[k] = __fadd_rn(mass[k], __fmul_rn(wj, sm[i]));
        }
      }
    }
  }

#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const long long g = base + k * THREADS + threadIdx.x;
    if (g >= n) continue;
    float r = acc[k];
    if constexpr (MASS) r = mass[k] != 0.0f ? __fdiv_rn(__fmul_rn(acc[k], total), mass[k]) : 0.0f;
    out[g] = r;
  }
}

template <int MODE>
int launch(const void* ext, const void* ext_m, const void* ext_s,
           const void* w, void* out, long long n, int K, int center,
           float total, void* stream) {
  if (n > 0) {
    const int nblocks = static_cast<int>((n + TILE - 1) / TILE);
    stencil_kernel<MODE><<<nblocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(ext), static_cast<const float*>(ext_m),
        static_cast<const int*>(ext_s), static_cast<const float*>(w),
        static_cast<float*>(out), n, K, center, total);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int stencil1d(const void* ext, const void* w, void* out, long long n, int K,
              void* stream) {
  return launch<PLAIN>(ext, nullptr, nullptr, w, out, n, K, 0, 0.0f, stream);
}

int stencil1d_exact(const void* ext, const void* ext_m, const void* w,
                    void* out, long long n, int K, float total, void* stream) {
  return launch<EXACT>(ext, ext_m, nullptr, w, out, n, K, 0, total, stream);
}

int segment_stencil(const void* ext, const void* ext_s, const void* w,
                    void* out, long long n, int K, int center, int exact,
                    float total, void* stream) {
  if (exact)
    return launch<SEGMENT_EXACT>(ext, nullptr, ext_s, w, out, n, K, center,
                                 total, stream);
  return launch<SEGMENT>(ext, nullptr, ext_s, w, out, n, K, center, total,
                         stream);
}

}  // extern "C"
