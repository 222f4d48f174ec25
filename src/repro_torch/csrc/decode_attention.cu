// decode_attention: single-token grouped-query attention over a KV cache.
// q (B, Hkv, G, hd), k and v (B, S, Hkv, hd), length (B,) int32; query head
// kv * G + g attends over the rows [0, length[b]) of KV head kv; scores,
// softmax and accumulation in float32; out (B, Hkv, G, hd) in q's type.
//
// Replaces the TPU kernel kernels/decode_attention/decode_attention.py
// (decode_attention_pallas).  There the S blocks of one batch row run in
// order on one core and carry the online softmax (running max, denominator
// and numerator) in VMEM from block to block.  Here one block of 4 warps
// owns one (b, kv head) pair, and the carry is a loop inside the block:
//   * a row's hd values are split over hd / VEC lanes, VEC values of 16
//     bytes each (8 bf16 or 4 float32), so every K and V load is one
//     16-byte vector load; a warp walks 32 / (hd / VEC) rows at a time, and
//     each lane keeps UNROLL rows of K and V in flight before it computes;
//   * the G query heads of the KV head are held in registers, so each K and
//     V row is read once for the whole group (the TPU kernel's grouped
//     dot_general);
//   * every group of lanes keeps its own running (max, denominator,
//     numerator) per query head; at the end the groups of a warp merge by
//     shuffles and the warps through shared memory, each merge the
//     log-sum-exp combine of two partial softmaxes;
//   * the walk stops at min(length, S): rows past it are never read (they
//     contribute exactly 0 in the reference, exp(-1e30 - m) underflowing),
//     and no padding of S is needed.  length <= 0 (outside the contract)
//     gives 0.
// Bound: bytes.  K and V rows below length are read once (2 * length * hd
// values per (b, kv head)) against 4 * G * hd * length float32 operations.
// B * Hkv blocks fill the card when B * Hkv >= 132 (the LM decode path has
// 256); below that SMs idle, and a split over S with a second combine pass
// (flash-decoding) is the later design.

#include "common.cuh"

#include <cuda_bf16.h>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int UNROLL = 4;

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

template <typename T, int HD, int G>
__global__ void __launch_bounds__(THREADS)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const int* __restrict__ length,
                        T* __restrict__ out, int S, int Hkv, float scale) {
  constexpr int VEC = 16 / sizeof(T);    // values per lane per row
  constexpr int LPR = HD / VEC;          // lanes per row
  constexpr int RPW = 32 / LPR;          // rows per warp per step
  constexpr int NG = WARPS * RPW;        // row groups per block
  static_assert(HD % VEC == 0 && 32 % LPR == 0, "hd 32, 64 or 128");
  __shared__ float sm_m[WARPS][G];
  __shared__ float sm_l[WARPS][G];
  __shared__ float sm_acc[WARPS][G][HD];

  const int bh = blockIdx.x;             // (b, kv head)
  const int b = bh / Hkv;
  const int h = bh - b * Hkv;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int sub = lane % LPR;            // which VEC slice of the row
  const int row_in_step = lane / LPR;
  const int len = min(length[b], S);

  float qf[G][VEC];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const uint4 r = __ldg(reinterpret_cast<const uint4*>(
        q + ((size_t)bh * G + g) * HD + sub * VEC));
    unpack(r, qf[g]);
  }
  float m[G], l[G], acc[G][VEC];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = -1e30f;
    l[g] = 0.0f;
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[g][e] = 0.0f;
  }

  const size_t stride = (size_t)Hkv * HD;          // one S row
  const size_t off = (size_t)b * S * stride + (size_t)h * HD + sub * VEC;
  const T* kb = k + off;
  const T* vb = v + off;
  // every lane of a warp runs the same iterations (the shuffles below need
  // the whole warp); rows past len are masked per lane
  for (int base = warp * RPW; base < len; base += UNROLL * NG) {
    uint4 kr[UNROLL], vr[UNROLL];
    bool ok[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int r = base + row_in_step + u * NG;
      ok[u] = r < len;
      kr[u] = vr[u] = make_uint4(0, 0, 0, 0);
      if (ok[u]) {
        kr[u] = __ldg(reinterpret_cast<const uint4*>(kb + r * stride));
        vr[u] = __ldg(reinterpret_cast<const uint4*>(vb + r * stride));
      }
    }
    float s[UNROLL][G];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      float kf[VEC];
      unpack(kr[u], kf);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float d = 0.0f;
#pragma unroll
        for (int e = 0; e < VEC; ++e) d = fmaf(qf[g][e], kf[e], d);
        s[u][g] = d;
      }
    }
#pragma unroll
    for (int o = LPR / 2; o > 0; o >>= 1)
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
#pragma unroll
        for (int g = 0; g < G; ++g)
          s[u][g] += __shfl_xor_sync(FULL_MASK, s[u][g], o);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float mx = m[g];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        if (ok[u]) mx = fmaxf(mx, s[u][g] * scale);
      const float alpha = expf(m[g] - mx);
      l[g] *= alpha;
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[g][e] *= alpha;
      m[g] = mx;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (!ok[u]) continue;
      float vf[VEC];
      unpack(vr[u], vf);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float p = expf(s[u][g] * scale - m[g]);
        l[g] += p;
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[g][e] = fmaf(p, vf[e], acc[g][e]);
      }
    }
  }

  // merge the row groups of the warp (lanes `sub` apart by multiples of LPR)
#pragma unroll
  for (int o = LPR; o < 32; o <<= 1) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float mo = __shfl_xor_sync(FULL_MASK, m[g], o);
      const float lo = __shfl_xor_sync(FULL_MASK, l[g], o);
      const float mm = fmaxf(m[g], mo);
      const float a = expf(m[g] - mm);
      const float c = expf(mo - mm);
      l[g] = l[g] * a + lo * c;
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        acc[g][e] = acc[g][e] * a + __shfl_xor_sync(FULL_MASK, acc[g][e], o) * c;
      m[g] = mm;
    }
  }
  if (lane < LPR) {                      // the warp's first row group
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (lane == 0) {
        sm_m[warp][g] = m[g];
        sm_l[warp][g] = l[g];
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) sm_acc[warp][g][sub * VEC + e] = acc[g][e];
    }
  }
  __syncthreads();

  // merge the warps; one output value per thread and step
  for (int i = threadIdx.x; i < G * HD; i += THREADS) {
    const int g = i / HD;
    const int d = i - g * HD;
    float mm = sm_m[0][g];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) mm = fmaxf(mm, sm_m[w][g]);
    float den = 0.0f, num = 0.0f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float a = expf(sm_m[w][g] - mm);
      den += sm_l[w][g] * a;
      num += sm_acc[w][g][d] * a;
    }
    store(out + ((size_t)bh * G + g) * HD + d, num / fmaxf(den, 1e-30f));
  }
}

template <typename T, int HD, int G>
void launch(const void* q, const void* k, const void* v, const void* length,
            void* out, int B, int S, int Hkv, float scale, cudaStream_t s) {
  decode_attention_kernel<T, HD, G><<<B * Hkv, THREADS, 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(length),
      static_cast<T*>(out), S, Hkv, scale);
}

template <typename T, int HD>
bool launch_g(int G, const void* q, const void* k, const void* v,
              const void* length, void* out, int B, int S, int Hkv,
              float scale, cudaStream_t s) {
  switch (G) {
    case 1: launch<T, HD, 1>(q, k, v, length, out, B, S, Hkv, scale, s); return true;
    case 2: launch<T, HD, 2>(q, k, v, length, out, B, S, Hkv, scale, s); return true;
    case 3: launch<T, HD, 3>(q, k, v, length, out, B, S, Hkv, scale, s); return true;
    case 4: launch<T, HD, 4>(q, k, v, length, out, B, S, Hkv, scale, s); return true;
    case 5: launch<T, HD, 5>(q, k, v, length, out, B, S, Hkv, scale, s); return true;
    case 6: launch<T, HD, 6>(q, k, v, length, out, B, S, Hkv, scale, s); return true;
    case 7: launch<T, HD, 7>(q, k, v, length, out, B, S, Hkv, scale, s); return true;
    case 8: launch<T, HD, 8>(q, k, v, length, out, B, S, Hkv, scale, s); return true;
    default: return false;
  }
}

template <typename T>
bool launch_hd(int HD, int G, const void* q, const void* k, const void* v,
               const void* length, void* out, int B, int S, int Hkv,
               float scale, cudaStream_t s) {
  switch (HD) {
    case 32: return launch_g<T, 32>(G, q, k, v, length, out, B, S, Hkv, scale, s);
    case 64: return launch_g<T, 64>(G, q, k, v, length, out, B, S, Hkv, scale, s);
    case 128: return launch_g<T, 128>(G, q, k, v, length, out, B, S, Hkv, scale, s);
    default: return false;
  }
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// a shape the kernel does not take (hd not 32/64/128, G outside [1, 8]).
int decode_attention(const void* q, const void* k, const void* v,
                     const void* length, void* out, int B, int S, int Hkv,
                     int G, int HD, int bf16, float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B * Hkv == 0) return 0;
  const bool ok =
      bf16 ? launch_hd<__nv_bfloat16>(HD, G, q, k, v, length, out, B, S, Hkv, scale, s)
           : launch_hd<float>(HD, G, q, k, v, length, out, B, S, Hkv, scale, s);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
