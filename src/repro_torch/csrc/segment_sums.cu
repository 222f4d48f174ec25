// segment_sums: float32 sums of the runs of a sorted segment id.  Row i adds
// values[i] (0 where valid[i] is false) to slot seg_id[i]; ids outside
// [0, num_segments) are dropped.  Slots no row names stay 0.
//
// Replaces the TPU kernel kernels/segment_reduce/segment_reduce.py
// (value_scan_pallas, with the scan-difference wrapper ops.py
// segment_sums).  That kernel is a carried prefix scan walked in block
// order, whose differences at run ends give the sums; the scan-difference
// form is a TPU idiom and the carry needs an in-order grid.  Here the runs
// are reduced directly over 2048-row tiles:
//   * each thread sums 8 consecutive rows, restarting at every id change;
//   * a block scan of (saw an id change, sum since the last change) over the
//     threads hands each thread the partial of the run it starts inside;
//   * the thread holding a run's last row writes its total.  A run that
//     lies wholly inside the tile is written with a plain store; the two
//     runs that touch the tile's first or last row may continue in the
//     neighbouring tiles and are added with atomicAdd into the zeroed output.
// Bound: bytes (4 + 4 + 1 bytes read per row, 4 written per segment).

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int ITEMS = 8;
constexpr int TILE = THREADS * ITEMS;

struct Carry {
  bool head;   // an id change lies in the span (after the tile's first row)
  float sum;   // sum of the span's rows since its last id change
};

__device__ __forceinline__ Carry combine(Carry a, Carry b) {
  return Carry{a.head || b.head, b.head ? b.sum : a.sum + b.sum};
}

__device__ __forceinline__ Carry shfl_up(Carry c, int o) {
  const int h = __shfl_up_sync(FULL_MASK, c.head ? 1 : 0, o);
  const float s = __shfl_up_sync(FULL_MASK, c.sum, o);
  return Carry{h != 0, s};
}

__global__ void __launch_bounds__(THREADS)
tile_segment_sums(const float* __restrict__ values,
                  const int* __restrict__ seg_id,
                  const uint8_t* __restrict__ valid, float* __restrict__ out,
                  long long n, int num_segments) {
  __shared__ float sv[TILE + TILE / 32];
  __shared__ int ss[TILE + TILE / 32];
  __shared__ bool wh[32];
  __shared__ float ws[32];
  const long long base = (long long)blockIdx.x * TILE;
  const int rows = static_cast<int>(min((long long)TILE, n - base));
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const int i = k * THREADS + threadIdx.x;
    if (i < rows) {
      const long long g = base + i;
      sv[pad(i)] = valid[g] ? values[g] : 0.0f;
      ss[pad(i)] = seg_id[g];
    }
  }
  __syncthreads();

  // this thread's (head, sum) over its rows
  const int first = threadIdx.x * ITEMS;
  Carry mine{false, 0.0f};
  for (int j = 0; j < ITEMS; ++j) {
    const int i = first + j;
    if (i >= rows) break;
    if (i > 0 && ss[pad(i)] != ss[pad(i - 1)]) mine = Carry{true, 0.0f};
    mine.sum += sv[pad(i)];
  }

  // exclusive scan of the carries over the block
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  Carry inc = mine;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const Carry y = shfl_up(inc, o);
    if (lane >= o) inc = combine(y, inc);
  }
  if (lane == 31) {
    wh[wid] = inc.head;
    ws[wid] = inc.sum;
  }
  __syncthreads();
  if (wid == 0) {
    Carry w = lane < THREADS / 32 ? Carry{wh[lane], ws[lane]}
                                  : Carry{false, 0.0f};
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const Carry y = shfl_up(w, o);
      if (lane >= o) w = combine(y, w);
    }
    if (lane < THREADS / 32) {
      wh[lane] = w.head;
      ws[lane] = w.sum;
    }
  }
  __syncthreads();
  Carry excl = shfl_up(inc, 1);
  if (lane == 0) excl = Carry{false, 0.0f};
  if (wid > 0) excl = combine(Carry{wh[wid - 1], ws[wid - 1]}, excl);

  // walk the rows again and write every run that ends here
  float run = excl.sum;
  bool changed = excl.head;
  for (int j = 0; j < ITEMS; ++j) {
    const int i = first + j;
    if (i >= rows) break;
    const int s = ss[pad(i)];
    if (i > 0 && s != ss[pad(i - 1)]) {
      run = 0.0f;
      changed = true;
    }
    run += sv[pad(i)];
    const bool last = i == rows - 1;
    if ((last || ss[pad(i + 1)] != s) && s >= 0 && s < num_segments) {
      if (!changed || last)
        atomicAdd(&out[s], run);   // may continue in a neighbouring tile
      else
        out[s] = run;              // wholly inside this tile
    }
  }
}

}  // namespace

extern "C" {

int segment_sums(const void* values, const void* seg_id, const void* valid,
                 void* out, long long n, int num_segments, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(out, 0, sizeof(float) * (size_t)num_segments, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (n > 0) {
    const int ntiles = static_cast<int>((n + TILE - 1) / TILE);
    tile_segment_sums<<<ntiles, THREADS, 0, s>>>(
        static_cast<const float*>(values), static_cast<const int*>(seg_id),
        static_cast<const uint8_t*>(valid), static_cast<float*>(out), n,
        num_segments);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
