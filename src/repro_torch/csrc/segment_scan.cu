// segment_scan: segmented inclusive sum of a 1-D int32 or float32 array;
// boundary[i] != 0 starts a new segment at row i.  The output keeps the
// input's dtype.
//
// Replaces the TPU kernel src/repro/kernels/segment_scan/segment_scan.py:48
// (segment_scan_pallas).  That kernel runs a Hillis-Steele ladder of the
// segmented monoid inside each 2048-row block and carries the last row's
// value to the next block in one VMEM cell, which needs the TPU's in-order
// grid.  Here the same monoid
//     (v1, f1) + (v2, f2) = (f2 ? v2 : v1 + v2, f1 | f2)
// (lookback::SegScanOp, shared with segment_sums.cu) runs through the
// single-pass decoupled look-back scan of lookback.cuh:
// each tile publishes its aggregate (the sum since its last head, and
// whether it holds a head) in one 64-bit status word, 32 value bits beside
// the flag bit.  A tile holding a head needs nothing from before it
// (`restarts`), so it publishes its inclusive prefix at once; the longest
// look-back is one head at row 0.  Forward progress comes from the atomic
// tile ticket, ordering from the packed word's release store and acquire
// loads (see lookback.cuh).
// Bound: bytes, 12 a row (x and boundary read once, the output written
// once), which is what this kernel moves.
//
// int32 sums run in uint32 arithmetic, so wrap-around is defined and the
// result is exact modulo 2^32.  float32 sums are taken in another order
// than the plain version's (a global cumsum minus the running total before
// each segment); they agree within rounding of the running sum of |x|.  The
// float32 operator is ORDERED, so every call gives the same bits.

#include "lookback.cuh"

extern "C" {

// Bytes of scratch a call over n rows needs.
long long segment_scan_scratch_bytes(long long n) {
  return lookback::scratch_bytes(n);
}

int segment_scan_i32(const void* x, const void* boundary, void* out,
                     void* scratch, long long n, int load, void* stream) {
  return lookback::run(lookback::SegScanOp<uint32_t>{}, x, boundary, out,
                       scratch, n, load, stream);
}

int segment_scan_f32(const void* x, const void* boundary, void* out,
                     void* scratch, long long n, int load, void* stream) {
  return lookback::run(lookback::SegScanOp<float>{}, x, boundary, out,
                       scratch, n, load, stream);
}

}  // extern "C"
