"""End-to-end smoke run of the PyTorch/CUDA package on one NVIDIA card.

    python3 chip_smoke.py            # from the root of a checkout

Phases, in order; any failure raises and the exit code is not 0:

1. Report and build: the card's name and power limit, the nvcc build of
   every kernel in ``src/repro_torch/csrc`` (one process per source, in
   parallel), TF32 off for matmuls and cuDNN.
2. Kernel phases: each of the nine hand-written kernels against its plain
   PyTorch version on the card, at sizes 0 .. 2^27 (segment lengths 1, 64
   and 2^16; stencils of 1, 3, 5, 7 and 20 taps at centres 0, K // 2 and
   the main path's K - 1; decode_attention at the reference's test shapes
   in float32 and bfloat16 and at the LM path's shape with lengths 1 ..
   2304), then held again and timed on the main path's inputs with CUDA
   events (median of 15 runs, each the mean of back-to-back calls filling
   ~2 ms) beside the plain version, one PyTorch library
   call where there is one, and its bound (the larger of bytes moved /
   3.35 TB/s and operations / 67 TFLOP/s).  The three look-back scans
   (prefix_sum, segment_scan, segment_rank) are also held on their hazards:
   sizes around the 5120-row tile and the 4-row vector, views not 16-byte
   aligned, two calls back to back, int32 sums past 2^31, one segment head
   at row 0 of 2^27 rows; torch.profiler shows each call running one
   kernel and at most one memset; 20 calls of the float32 scans on
   non-integer values give the same bits.  segment_sums (a look-back that
   reads only the valid prefix below its count and writes only run totals)
   is held on the slots the runs name, on the hazards of that contract
   around its 5120-row tile, on misaligned views and back to back, profiled
   as one kernel plus one memset, 20 calls with the same bits, and timed at
   the aggregate's partial and final stages and with every row its own run
   beside torch.segment_reduce.  bucket_scatter (a look-back
   over P counts) is held exactly at P = 1 .. 2048, around its tile, on one
   bucket, all rows invalid, an invalid tail, misaligned views and back to
   back calls, profiled as one kernel plus one memset, and timed at P = 8
   and 256 beside torch.sort(stable=True).  The stencils are held bitwise
   (0 ulps) in every mode, also around their 4096-output tile, on ragged
   ends, on views not 16-byte aligned and past the 1024 taps staged at
   once.
3. The six main paths, each with the launch counters zeroed just before
   it and read just after:
   - relational, through ``hf`` at P = 1: Fig. 8a filter, join and
     aggregate and TPCx-BB Q26 / Q26-multikey against numpy oracles;
     prefix_sum and segment_sums must have launched;
   - windows, through ``hf``: Fig. 8b cumsum, SMA, WMA and exact rolling
     mean at 2^27 rows, a partitioned WMA after a join and five chained
     grouped windows (cumsum, exact rolling mean, rank, dense_rank,
     row_number) over 2^27 rows in 11585 groups, against numpy oracles;
     prefix_sum, segment_scan, segment_rank, stencil1d, stencil1d_exact and
     segment_stencil must have launched;
   - sort, through ``hf`` at P = 1: a global sort of Fig. 8a's table (2^27
     rows) and its descending head of 1000, bench_validate.py's group-by ->
     join -> sort, rank / dense_rank / row_number over Fig. 8b's series by
     its values, an SMA after a filter (a Rebalance under the stencil), a
     concat of two halves feeding the Fig. 8a aggregate, and Fig. 12's Q26
     against a persisted and a cold item dimension, each twice, with the
     reference's plan counts; against numpy and scipy oracles; prefix_sum,
     segment_sums and stencil1d must have launched;
   - frame, through ``hf`` at P = 1 on bench_tpcx.py's string inputs at
     scale 64 (25.6 M web clicks over Zipf-skewed items, 1.28 M items with
     a category name, 25.6 M store sales with a channel and a discount, 2 %
     of each null): Q05 over category names (its plan the int-category
     Q05's), the Q09 channel rollup, dropna -> fillna -> assign -> astype
     -> rename -> drop and a column from a string predicate feeding a
     group-by, the rows where either nullable column is null, a concat of
     two halves whose dictionaries differ, and a merge on category keys
     whose dictionaries only overlap; against numpy, the host's dictionary
     encoding timed apart; prefix_sum and segment_sums must have launched;
   - exchange_p2, two ranks on the one card joined by gloo (NCCL refuses
     two ranks on one card; gloo stages CUDA tensors through the host):
     Fig. 8a join at 2^24 x 2^20 rows, Q26, a sort of Fig. 8a's table and
     a global rank of the series at 2^24 rows, the SMA after a filter,
     Fig. 12's two Q26 legs, and the frame path's Q05 over category names
     and merge on category keys (each rank encoding the host tables
     itself, the dictionaries equal on both), through ``hf`` at P = 2,
     rows against numpy
     oracles, all_to_all calls against the plan's shuffle census (the
     persisted leg's fewer than the cold leg's), each rank of the sort
     holding a quarter of the rows or more; bucket_scatter must have
     launched in each rank, prefix_sum in the sum over the ranks;
   - lm, through ``repro_torch.launch.steps`` as examples/serve_lm.py
     drives the reference: qwen3-0.6b (28 layers, bf16, random weights from
     a seed) serves 32 prompts of 2048 tokens with 256 greedy new tokens;
     decode_attention must have launched exactly 28 x 256 times.  After the
     path, the served logits of two requests are held against the port's
     own no-cache forward (within 0.1), and the same path at 2 layers in
     float32 (within 1e-3).
4. Report: a JSON line of query wall times, LM serving times, peak memory
   and the checks' largest differences (with a digest of the bytes of the
   float32 cumsums, fig8b_cumsum's and the grouped one's, and of
   fig8a_aggregate's sums and means, to compare two runs), a JSON line of
   the nine kernel records, and a last line
   ``{"ok": true, "device": {...}}``.

``--quick`` stops after phase 2 at sizes up to 1_000_003 and prints ptxas's
register and shared-memory report: a short first check of new kernels.
``--profile DIR`` runs every query a second time under ``torch.profiler``
and writes its per-op device-time table to ``DIR/profile_<query>.txt``, and
profiles 4 LM decode steps (``DIR/profile_lm_decode.txt``).  These traces
come minutes after the process's first profiler session and may miss
device events (see ``one_call_profiles``).
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet
F32_OPS_PER_S = 67e12           # H100 SXM, float32 outside the tensor cores
REPEATS = 15


def log(*a):
    print(*a, flush=True)


def nvidia_smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def time_ms(fn, torch) -> float:
    """Median milliseconds of one ``fn()`` over REPEATS runs (CUDA events),
    after one warm-up run.  A run calls ``fn`` back to back as many times
    as fill about 2 ms (at least once) and counts the mean, so the host's
    work of launching a short kernel overlaps the device's, as in a stream
    of calls, and is not timed as device time."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    inner = max(1, min(50, int(2e-3 / max(time.perf_counter() - t0, 1e-6))))
    times = []
    for _ in range(REPEATS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return float(np.median(times))


def bound_ms(bytes_moved: float, ops: float) -> tuple[float, str]:
    tb, to = bytes_moved / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def traced(torch, fn, margin: float = 0.02):
    """Run ``fn()`` once under torch.profiler, ``margin`` seconds inside the
    traced window.  Returns the profile, the device events it holds (name
    -> count) and the number of host events."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(margin)
        fn()
        torch.cuda.synchronize()
        time.sleep(margin)
    seen: dict = {}
    host = 0
    for e in prof.key_averages():
        if not str(e.device_type).endswith("CUDA"):
            host += e.count
        elif not e.key.startswith("Activity Buffer"):
            seen[e.key[:80]] = seen.get(e.key[:80], 0) + e.count
    return prof, seen, host


def one_launch(torch, fn, kernel: str, tag: str) -> dict:
    """Profile one ``fn()`` (torch.profiler) and assert that the card ran
    exactly one kernel whose name holds ``kernel``, at most one memset and
    nothing else.  Returns the device events seen, name -> count.  The call
    sits 20 ms inside the traced window.  A trace that holds no device
    event at all, not even the memset, is taken again, up to five times:
    the count is asserted on the first trace that holds any."""
    for _ in range(5):
        _, seen, host = traced(torch, fn)
        if seen:
            break
        log(f"{tag}: the profiler recorded no device event ({host} host "
            f"events); again")
    mine = sum(c for k, c in seen.items() if kernel in k)
    memsets = sum(c for k, c in seen.items() if "memset" in k.lower())
    assert mine == 1 and memsets <= 1 and mine + memsets == sum(seen.values()), \
        f"{tag}: one call ran {seen}"
    return seen


# The look-back scans of csrc/lookback.cuh (prefix_sum, segment_scan,
# segment_rank): ragged sizes around the 5120-row tile and the 4-row vector,
# and one size whose tiles look back past a window of 32.
LOOKBACK_KERNEL = "scan_tiles"
LOOKBACK_SIZES = (1, 3, 4, 5, 5119, 5120, 5121, 10239, 10241, 33 * 5120 + 5)


def misaligned(t):
    """A contiguous view of ``t``'s data one element in: not 16-byte
    aligned, so the wrapper picks the kernel's WORDS fetch (4-byte loads)."""
    v = t[1:]
    assert v.data_ptr() % 16 != 0
    return v


def wrapped(x):
    """The int32 prefix sums of ``x`` modulo 2^32, from int64."""
    c = x.long().cumsum(0)
    return ((c + 2**31) % 2**32 - 2**31).int()


def same_bits(torch, call, tag: str, times: int = 20) -> int:
    """Call ``call()`` ``times`` times and assert that every float32 result
    has the bits of the first; returns ``times``."""
    bits = call().view(torch.int32)
    for i in range(times - 1):
        assert torch.equal(call().view(torch.int32), bits), \
            f"{tag}: call {i + 2} of {times} differs from the first"
    return times


def digest(a: np.ndarray) -> str:
    """A short hash of an array's bytes, to compare two runs' results."""
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()[:16]


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def one_call_profiles(torch, n: int) -> dict:
    """One call of each look-back wrapper under torch.profiler (prefix_sum
    and segment_scan in int32 and float32, the three rank kinds,
    bucket_scatter at P = 8 and 256, segment_sums at its partial and final
    stages; n rows): one scan_tiles (or scatter_tiles, sum_tiles) kernel and
    at most one memset each.  These must be the process's first
    torch.profiler sessions, and are taken within a second of each other:
    on an H100 (torch 2.11, CUDA 12.8) the device timestamps of a trace
    drift from its host timeline from about 10 s after the process's first
    session on, and within a minute most traces hold no device event at
    all, with or without work in between (tools/profiler_probe.py)."""
    from repro_torch.kernels.hash_partition import hash_partition as hp
    from repro_torch.kernels.segment_rank import segment_rank as rk
    from repro_torch.kernels.segment_reduce import segment_reduce as sr
    from repro_torch.kernels.segment_scan import segment_scan as ss
    from repro_torch.kernels.stream_compact import stream_compact as sc
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2)
    x = torch.randint(-8, 9, (n,), device=dev, generator=g, dtype=torch.int32)
    seg = (torch.rand(n, device=dev, generator=g) < 1 / 64).int()
    seg[:1] = 1
    ordb = seg | (torch.rand(n, device=dev, generator=g) < 0.3).int()
    out = {"prefix_sum": {str(v.dtype): one_launch(
        torch, lambda: sc.prefix_sum_cuda(v), LOOKBACK_KERNEL,
        f"prefix_sum {v.dtype}") for v in (x, x.float())}}
    out["segment_scan"] = {str(v.dtype): one_launch(
        torch, lambda: ss.segment_scan_cuda(v, seg), LOOKBACK_KERNEL,
        f"segment_scan {v.dtype}") for v in (x, x.float())}
    out["segment_rank"] = {kind: one_launch(
        torch, lambda: rk.segment_rank_cuda(seg, ordb, kind), LOOKBACK_KERNEL,
        f"segment_rank {kind}") for kind in rk.KINDS}
    dest = {P: torch.randint(0, P + 1, (n,), device=dev, generator=g,
                             dtype=torch.int32) for P in BUCKET_TIMED_PS}
    out["bucket_scatter"] = {f"P={P}": one_launch(
        torch, lambda: hp.bucket_scatter_cuda(dest[P], P), BUCKET_KERNEL,
        f"bucket_scatter P={P}") for P in BUCKET_TIMED_PS}
    # the partial stage's shape (sorted ids in 4096 groups, count = n) and
    # the final stage's (4096 rows of n, count = 4096)
    sid = (torch.arange(n, device=dev) * SUMS_GROUPS // n).to(torch.int32)
    vals = x.float()
    every = torch.ones(n, dtype=torch.bool, device=dev)
    counts = {stage: torch.tensor(c, dtype=torch.int32, device=dev)
              for stage, c in (("partial", n), ("final", SUMS_GROUPS))}
    out["segment_sums"] = {stage: one_launch(
        torch, lambda: sr.segment_sums_cuda(vals, sid, every, n, c),
        SUMS_KERNEL, f"segment_sums {stage}") for stage, c in counts.items()}
    log(f"one call each: {out}")
    return out


# bucket_scatter (csrc/bucket_scatter.cu): the bucket counts it is held at,
# and the two it is timed at (a node of 8 cards; a 256-rank deployment)
BUCKET_PS = (1, 2, 8, 255, 256, 1024, 2048)
BUCKET_TIMED_PS = (8, 256)
BUCKET_KERNEL = "scatter_tiles"


def bucket_scatter_phases(torch, sizes, record: dict):
    """bucket_scatter against its plain version: counts exact, slots exact
    wherever dest < P (the rest are don't-care), at every P of BUCKET_PS,
    at ``sizes`` and around the kernel's tile (T - 1, T, T + 1, a few tiles
    and 40 tiles with ragged ends); on its hazards: every row in one
    bucket, every row invalid, invalid rows scattered and as a tail, a view
    not 16-byte aligned (the WORDS fetch), two calls back to back (the
    second gets the first's freed status words, which the kernel must
    clear).  Then timed at n = sizes[-1] for P in BUCKET_TIMED_PS beside
    the plain version, its bound and torch.sort(stable=True) (a reference
    point: it sorts, and is not the same function)."""
    from repro_torch.kernels import cuda
    from repro_torch.kernels.hash_partition import hash_partition as hp

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(3)
    lib = cuda.load("bucket_scatter")
    tiles = {P: lib.bucket_scatter_tile(P) for P in BUCKET_PS}

    def held(dest, P, tag, got=None):
        r1, c1 = got if got is not None else hp.bucket_scatter_cuda(dest, P)
        r2, c2 = hp.bucket_scatter_plain(dest, P)
        ok = (dest >= 0) & (dest < P)
        assert torch.equal(c1, c2), f"bucket_scatter counts P={P} {tag}"
        assert torch.equal(r1[ok], r2[ok]), f"bucket_scatter slots P={P} {tag}"

    def ids(n, P, invalid=0.0):
        """Bucket ids in [0, P), a share ``invalid`` of them P."""
        d = torch.randint(0, P, (n,), device=dev, generator=g, dtype=torch.int32)
        if invalid:
            d[torch.rand(n, device=dev, generator=g) < invalid] = P
        return d

    for P in BUCKET_PS:
        tile = tiles[P]
        edges = (tile - 1, tile, tile + 1, 3 * tile + 5, 40 * tile + 3)
        for n in sizes + list(edges):
            held(ids(n, P, 1 / (P + 1)), P, f"n={n}")
        for n in edges + (sizes[-2],):
            held(torch.full((n,), P - 1, dtype=torch.int32, device=dev), P,
                 f"one bucket n={n}")
            held(torch.full((n,), P, dtype=torch.int32, device=dev), P,
                 f"all invalid n={n}")
            d = ids(n, P, 1 / 6)
            d[n - n // 5:] = P
            held(d, P, f"invalid scattered and as a tail n={n}")
            held(misaligned(ids(n + 1, P, 1 / 6)), P, f"misaligned n={n}")
            a, b = ids(n, P, 1 / 6), ids(n, P)
            ga, gb = hp.bucket_scatter_cuda(a, P), hp.bucket_scatter_cuda(b, P)
            held(a, P, f"back to back (first) n={n}", ga)
            held(b, P, f"back to back (second) n={n}", gb)
        log(f"bucket_scatter P={P}: ok at sizes {sizes} and {edges}, one "
            f"bucket, all invalid, invalid tail, misaligned, back to back")

    n = sizes[-1]
    by_p = {}
    for P in BUCKET_TIMED_PS:
        dest = ids(n, P)
        held(dest, P, f"timed inputs n={n}")
        k = {"ms": time_ms(lambda: hp.bucket_scatter_cuda(dest, P), torch),
             "plain_ms": time_ms(lambda: hp.bucket_scatter_plain(dest, P),
                                 torch),
             "stable_sort_ms": time_ms(
                 lambda: torch.sort(dest, stable=True), torch)}
        k["bound_ms"], k["bound_by"] = bound_ms(8.0 * n + 4 * P, n)
        by_p[P] = k
        del dest
    rec = {"name": "bucket_scatter", "route": "cuda",
           "source": "src/repro_torch/csrc/bucket_scatter.cu",
           "replaces": "src/repro/kernels/hash_partition/hash_partition.py:44",
           "shape": f"int32 dest, n={n}, P=256", "max_abs_err": 0.0,
           **by_p[256], "library_ms": None, "library_call": None,
           "library_note": "no one-call equivalent; stable_sort_ms is "
                           "torch.sort(dest, stable=True), a reference point",
           "tile_rows_by_p": tiles, "by_p": by_p}
    record["bucket_scatter"] = rec


def kernel_phases(torch, sizes, record: dict):
    from repro_torch.kernels import cuda
    from repro_torch.kernels.stream_compact import stream_compact as sc

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    # -- prefix_sum: int32 exact; float32 with integer values exact (every
    # partial sum is an integer below 2^24); float32 normal values within
    # 1e-5 of the running sum of |x|.
    err = 0.0
    for n in sizes:
        xi = torch.randint(-1000, 1000, (n,), device=dev, generator=g,
                           dtype=torch.int32)
        got, want = sc.prefix_sum_cuda(xi), sc.prefix_sum_plain(xi)
        assert torch.equal(got, want), f"prefix_sum int32 n={n}"
        xf = torch.randint(-8, 9, (n,), device=dev, generator=g).float()
        got, want = sc.prefix_sum_cuda(xf), sc.prefix_sum_plain(xf)
        assert torch.equal(got, want), f"prefix_sum f32 (integer values) n={n}"
        if 0 < n <= 1 << 22:
            xn = torch.randn(n, device=dev, generator=g)
            got, want = sc.prefix_sum_cuda(xn), sc.prefix_sum_plain(xn)
            tol = 1e-5 * torch.cumsum(xn.abs().double(), 0) + 1e-4
            d = (got.double() - want.double()).abs()
            assert bool((d <= tol).all()), f"prefix_sum f32 n={n}"
            err = max(err, float(d.max()))
        log(f"prefix_sum n={n}: ok")
    # the look-back hazards: ragged sizes; views not 16-byte aligned (the
    # WORDS fetch); two calls back to back on other inputs of one length
    # (the second gets the first's freed status words from the allocator,
    # which the kernel must clear); int32 sums that wrap past 2^31 (exact
    # modulo 2^32).
    for n in LOOKBACK_SIZES + (sizes[-2],):
        for dt in (torch.int32, torch.float32):
            xs = [torch.randint(-8, 9, (n + 1,), device=dev, generator=g).to(dt)
                  for _ in range(2)]
            x = misaligned(xs[0])
            assert torch.equal(sc.prefix_sum_cuda(x), sc.prefix_sum_plain(x)), \
                f"prefix_sum {dt} misaligned n={n}"
            a, b = (v[:n] for v in xs)
            ga = sc.prefix_sum_cuda(a)
            gb = sc.prefix_sum_cuda(b)
            assert torch.equal(ga, sc.prefix_sum_plain(a)) and \
                torch.equal(gb, sc.prefix_sum_plain(b)), \
                f"prefix_sum {dt} back to back n={n}"
    for n in LOOKBACK_SIZES + (sizes[-2], sizes[-1]):
        xw = torch.randint(-2**30, 2**30, (n,), device=dev, generator=g,
                           dtype=torch.int32)
        got = sc.prefix_sum_cuda(xw)
        assert torch.equal(got, wrapped(xw)), f"prefix_sum int32 wrap n={n}"
        assert torch.equal(got, sc.prefix_sum_plain(xw)), \
            f"prefix_sum int32 wrap against plain n={n}"
    del xw, got
    log(f"prefix_sum hazards: ok at sizes {LOOKBACK_SIZES}")

    n = sizes[-1]
    xi = (torch.rand(n, device=dev, generator=g) < 0.5).to(torch.int32)
    xf = xi.float()
    rec = {"name": "prefix_sum", "route": "cuda",
           "source": "src/repro_torch/csrc/prefix_sum.cu",
           "replaces": "src/repro/kernels/stream_compact/stream_compact.py:36",
           "shape": f"int32 keep flags, n={n}", "max_abs_err": err,
           "ms": time_ms(lambda: sc.prefix_sum_cuda(xi), torch),
           "plain_ms": time_ms(lambda: sc.prefix_sum_plain(xi), torch),
           "library_ms": time_ms(
               lambda: torch.cumsum(xi, 0, dtype=torch.int32), torch),
           "library_call": "torch.cumsum(dtype=torch.int32)",
           "f32_ms": time_ms(lambda: sc.prefix_sum_cuda(xf), torch),
           "f32_library_ms": time_ms(lambda: torch.cumsum(xf, 0), torch)}
    rec["bound_ms"], rec["bound_by"] = bound_ms(8.0 * n, n)
    record["prefix_sum"] = rec
    del xi, xf

    bucket_scatter_phases(torch, sizes, record)

    segment_sums_phases(torch, sizes, record)
    cuda.reset_launches()


# segment_sums (csrc/segment_sums.cu): the main path's shapes, n = 2^27 rows
# in 4096 groups.  The partial stage of Fig. 8a's aggregate reduces n sorted
# rows (num_segments = cap_out = n); the final stage, after the exchange,
# 4096 partial rows at the front of an n-row buffer (count = 4096).
SUMS_KERNEL = "sum_tiles"
SUMS_GROUPS = 4096
SUMS_HAZARDS = ("count_0", "count_short", "count_past", "no_count",
                "padding_valid", "one_run", "each_row", "all_invalid",
                "overflow", "holes")


def sums_case(torch, g, hazard: str, n: int):
    """One hazard of segment_sums' contract on the card: (values, seg_id,
    valid, num_segments, count) with sorted ids consecutive from 0 (a run
    every ~50 rows) and count a 0-d int32 tensor or None: the prefix empty,
    ending inside a run, past n, not given; padding rows after the groups,
    valid but with id num_segments; one run; every row its own run; every
    row invalid; fewer slots than runs; invalid rows inside runs and runs of
    invalid rows only."""
    dev = torch.device("cuda")
    vals = torch.randn(n, device=dev, generator=g)
    head = torch.rand(n, device=dev, generator=g) < 0.02
    head[:1] = True
    seg = torch.cumsum(head.int(), 0, dtype=torch.int32) - 1
    nseg = int(seg[-1]) + 1 if n else 0
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    num, count = nseg + 3, n
    if hazard == "count_0":
        count = 0
    elif hazard == "count_short":
        count = n - n // 3 - 1 if n > 1 else n
    elif hazard == "count_past":
        count = n + 5
    elif hazard == "no_count":
        count = None
    elif hazard == "padding_valid":
        pad = n // 5
        if n - pad:
            num = int(seg[n - pad - 1]) + 1
        seg[n - pad:] = num
    elif hazard == "one_run":
        seg.zero_()
        num = 1
    elif hazard == "each_row":
        seg = torch.arange(n, dtype=torch.int32, device=dev)
        num = max(n, 1)
    elif hazard == "all_invalid":
        valid.zero_()
    elif hazard == "overflow":
        num = max(nseg // 2, 1)
    elif hazard == "holes":
        valid = (torch.rand(n, device=dev, generator=g) < 0.7) & (seg % 5 != 2)
    c = None if count is None else torch.tensor(count, dtype=torch.int32,
                                                device=dev)
    return vals, seg, valid, num, c


def sums_named(torch, seg, num: int, count):
    """The slots a row of the prefix names (the rest are undefined)."""
    m = seg.numel() if count is None else max(0, min(int(count), seg.numel()))
    ids = seg[:m]
    return torch.unique(ids[(ids >= 0) & (ids < num)]).long()


def sums_held(torch, args, tag: str, got=None) -> float:
    """segment_sums' kernel against its plain version on the named slots:
    within 1e-4 of the run's sum of |x| (+1e-5).  Returns the largest
    difference."""
    from repro_torch.kernels.segment_reduce import segment_reduce as sr
    vals, seg, valid, num, count = args
    if got is None:
        got = sr.segment_sums_cuda(*args)
    slots = sums_named(torch, seg, num, count)
    want = sr.segment_sums_plain(*args)[slots]
    mag = sr.segment_sums_plain(vals.abs(), seg, valid, num, count)[slots]
    d = (got[slots] - want).abs()
    assert bool((d <= 1e-4 * mag + 1e-5).all()), f"segment_sums {tag}"
    return float(d.max()) if slots.numel() else 0.0


def segment_sums_phases(torch, sizes, record: dict):
    """segment_sums against its plain version on the named slots: at
    ``sizes`` in 4096 and 2^20 groups, with and without count; on its
    hazards (sums_case) around the 5120-row tile, on views not 16-byte
    aligned and back to back; at the main path's partial and final stages
    (the final stage with count, and without: the padding then dropped by
    its id, invalid as the main path gives it and valid); 20 calls of the
    partial stage and of one run over 2^27 rows with the same bits; timed at
    the partial stage (count = n, as segment_aggregate passes it), the final
    stage (count = 4096) and with every row its own run, beside the plain
    version, index_add_ and torch.segment_reduce (its lengths built outside
    the timed call), each shape's bound from the bytes the contract moves: 9
    a row of the prefix read, 4 a run written."""
    from repro_torch.kernels.segment_reduce import segment_reduce as sr
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(4)
    err = 0.0
    for groups in (SUMS_GROUPS, 1 << 20):
        for n in sizes:
            seg = torch.sort(torch.randint(0, groups, (n,), device=dev,
                                           generator=g)).values
            # renumber to consecutive ids, like segment_aggregate's seg_id
            head = torch.ones(n, dtype=torch.bool, device=dev)
            head[1:] = seg[1:] != seg[:-1]
            seg = torch.cumsum(head.int(), 0, dtype=torch.int32) - 1
            n_seg = int(seg[-1]) + 1 if n else 0
            valid = torch.rand(n, device=dev, generator=g) < 0.9
            vals = torch.randn(n, device=dev, generator=g)
            for c in (None, torch.tensor(n, dtype=torch.int32, device=dev)):
                err = max(err, sums_held(torch, (vals, seg, valid, n_seg + 7, c),
                                         f"groups={groups} n={n}"))
        log(f"segment_sums groups={groups}: ok at sizes {sizes}")
    for n in LOOKBACK_SIZES + (sizes[-2],):
        for hazard in SUMS_HAZARDS:
            args = sums_case(torch, g, hazard, n)
            err = max(err, sums_held(torch, args, f"{hazard} n={n}"))
            vals, seg, valid, num, c = args
            views = [torch.cat([t[:1], t])[1:] for t in (vals, seg, valid)]
            assert views[0].data_ptr() % 16 != 0
            sums_held(torch, (*views, num, c), f"{hazard} misaligned n={n}")
            other = sums_case(torch, g, hazard, n)
            ga, gb = sr.segment_sums_cuda(*args), sr.segment_sums_cuda(*other)
            sums_held(torch, args, f"{hazard} back to back n={n}", ga)
            sums_held(torch, other, f"{hazard} back to back n={n}", gb)
    log(f"segment_sums hazards {SUMS_HAZARDS}: ok at sizes "
        f"{LOOKBACK_SIZES + (sizes[-2],)}")

    n, groups = sizes[-1], SUMS_GROUPS
    vals = torch.randn(n, device=dev, generator=g)
    rows = torch.arange(n, device=dev)
    every = torch.ones(n, dtype=torch.bool, device=dev)
    count_n = torch.tensor(n, dtype=torch.int32, device=dev)
    count_g = torch.tensor(groups, dtype=torch.int32, device=dev)
    final = torch.full((n,), n, dtype=torch.int32, device=dev)
    final[:groups] = torch.arange(groups, dtype=torch.int32, device=dev)
    for c, pad_valid in ((count_g, False), (None, False), (None, True)):
        err = max(err, sums_held(
            torch, (vals, final, (rows < groups) | pad_valid, n, c),
            f"final stage n={n} count={c is not None} pad_valid={pad_valid}"))
    log(f"segment_sums final-stage shape n={n}: ok")
    seg = (rows * groups // n).to(torch.int32)
    partial = (vals, seg, every, n, count_n)
    err = max(err, sums_held(torch, partial, f"partial stage n={n}"))
    # one run of 2^27 rows: held within its own tolerance (1e-4 of the sum
    # of |x|, ~1.1e4), its difference kept apart from the others
    zeros = torch.zeros(n, dtype=torch.int32, device=dev)
    one_run = (vals, zeros, every, n, count_n)
    one_run_err = sums_held(torch, one_run, f"one run n={n}")
    each_row = (vals, rows.to(torch.int32), every, n, count_n)
    err = max(err, sums_held(torch, each_row, f"each row n={n}"))
    repeats = {tag: same_bits(torch, lambda a=a, k=k: sr.segment_sums_cuda(*a)[:k],
                              f"segment_sums {tag}")
               for tag, a, k in (("partial", partial, groups),
                                 ("one_run", one_run, 1))}
    log(f"segment_sums partial-stage shape n={n}: ok; same bits {repeats}")
    # one-call yardsticks at the partial stage: a contended-atomic index_add_
    # into num slots, and torch.segment_reduce over the sorted segments'
    # lengths (its 4096 sums held against the kernel's)
    idx = seg.long()
    lengths = torch.bincount(idx, minlength=groups)
    reduce = torch.segment_reduce(vals, "sum", lengths=lengths, unsafe=True)
    mine = sr.segment_sums_cuda(*partial)[:groups]
    mag = sr.segment_sums_plain(vals.abs(), seg, every, n)[:groups]
    assert bool(((reduce - mine).abs() <= 1e-4 * mag + 1e-5).all()), \
        "segment_sums against torch.segment_reduce"
    yard = {"Tensor.index_add_": time_ms(
                lambda: torch.zeros(n, device=dev).index_add_(0, idx, vals),
                torch),
            "torch.segment_reduce(sum, lengths, unsafe=True)": time_ms(
                lambda: torch.segment_reduce(vals, "sum", lengths=lengths,
                                             unsafe=True), torch)}
    fastest = min(yard, key=yard.get)
    final_args = (vals, final, rows < groups, n, count_g)
    rec = {"name": "segment_sums", "route": "cuda",
           "source": "src/repro_torch/csrc/segment_sums.cu",
           "replaces": "src/repro/kernels/segment_reduce/segment_reduce.py:33",
           "shape": f"partial stage: f32 values, n={n}, {groups} groups, "
                    f"num_segments={n}, count={n}",
           "max_abs_err": err,
           "ms": time_ms(lambda: sr.segment_sums_cuda(*partial), torch),
           "plain_ms": time_ms(lambda: sr.segment_sums_plain(*partial), torch),
           "library_ms": yard[fastest], "library_call": fastest,
           "library_calls_ms": yard,
           "segment_reduce_max_abs_diff": float((reduce - mine).abs().max()),
           "final_stage_ms": time_ms(lambda: sr.segment_sums_cuda(*final_args),
                                     torch),
           "each_row_ms": time_ms(lambda: sr.segment_sums_cuda(*each_row),
                                  torch),
           "same_bits_of_calls": repeats, "one_run_max_abs_err": one_run_err}
    rec["bound_ms"], rec["bound_by"] = bound_ms(9.0 * n + 4.0 * groups, n)
    rec["final_stage_bound_ms"] = bound_ms(13.0 * groups, groups)[0]
    rec["each_row_bound_ms"] = bound_ms(13.0 * n, n)[0]
    record["segment_sums"] = rec

def ulps(torch, a, b) -> int:
    """Largest distance of two float32 or bfloat16 tensors (of one dtype) in
    units in the last place of that dtype (+0 and -0 equal)."""
    bits, mag = ((torch.int16, 0x7FFF) if a.dtype == torch.bfloat16
                 else (torch.int32, 0x7FFFFFFF))

    def ordered(t):
        i = t.contiguous().view(bits).long()
        return torch.where(i < 0, -(i & mag), i)
    if a.numel() == 0:
        return 0
    return int((ordered(a) - ordered(b)).abs().max())


# The main path's shapes of the window kernels: 2^27 rows; the partitioned
# queries' groups hold 2^27 / 11585 ~ 11585 rows on average.
GROUPS = 11585


def window_kernel_phases(torch, sizes, record: dict):
    from repro_torch.kernels import cuda
    from repro_torch.kernels.segment_rank import segment_rank as rk
    from repro_torch.kernels.segment_scan import segment_scan as ss
    from repro_torch.kernels.stencil1d import stencil1d as st
    from repro_torch.kernels.stream_compact import stream_compact as sc

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    wrng = np.random.default_rng(5)

    def heads(n, mean_len):
        """int32 segment-head mask, row 0 a head, one head per mean_len rows
        on average."""
        h = (torch.rand(n, device=dev, generator=g) < 1.0 / mean_len)
        h[:1] = True
        return h.to(torch.int32)

    # -- segment_scan: int32 exact; float32 of integer values exact (every
    # partial sum of the plain version's global cumsum is an integer below
    # 2^24); float32 normal values within 1e-5 of the running sum of |x|
    # (+1e-4), the plain version's own rounding (a global cumsum minus the
    # segment's base).
    err = 0.0
    for mean_len in (1, 64, 1 << 16):
        for n in sizes:
            b = heads(n, mean_len)
            xi = torch.randint(-1000, 1000, (n,), device=dev, generator=g,
                               dtype=torch.int32)
            assert torch.equal(ss.segment_scan_cuda(xi, b),
                               ss.segment_scan_plain(xi, b)), \
                f"segment_scan int32 n={n} L={mean_len}"
            xf = torch.randint(-8, 9, (n,), device=dev, generator=g).float()
            assert torch.equal(ss.segment_scan_cuda(xf, b),
                               ss.segment_scan_plain(xf, b)), \
                f"segment_scan f32 (integer values) n={n} L={mean_len}"
            if 0 < n <= 1 << 22:
                xn = torch.randn(n, device=dev, generator=g)
                got, want = ss.segment_scan_cuda(xn, b), ss.segment_scan_plain(xn, b)
                tol = 1e-5 * torch.cumsum(xn.abs().double(), 0) + 1e-4
                d = (got.double() - want.double()).abs()
                assert bool((d <= tol).all()), f"segment_scan f32 n={n} L={mean_len}"
                err = max(err, float(d.max()))
        log(f"segment_scan mean segment {mean_len}: ok at sizes {sizes}")
    # the timed inputs, held like the normal values above
    n = sizes[-1]
    b = heads(n, GROUPS)
    xn = torch.randn(n, device=dev, generator=g)
    got, want = ss.segment_scan_cuda(xn, b), ss.segment_scan_plain(xn, b)
    tol = 1e-5 * torch.cumsum(xn.abs().double(), 0) + 1e-4
    d = (got.double() - want.double()).abs()
    assert bool((d <= tol).all()), f"segment_scan f32 timed inputs n={n}"
    err = max(err, float(d.max()))
    del got, want, tol, d
    rec = {"name": "segment_scan", "route": "cuda",
           "source": "src/repro_torch/csrc/segment_scan.cu",
           "replaces": "src/repro/kernels/segment_scan/segment_scan.py:48",
           "shape": f"f32 x, n={n}, mean segment {GROUPS}", "max_abs_err": err,
           "ms": time_ms(lambda: ss.segment_scan_cuda(xn, b), torch),
           "plain_ms": time_ms(lambda: ss.segment_scan_plain(xn, b), torch),
           "library_ms": None, "library_call": None,
           "library_note": "no one-call equivalent"}
    rec["bound_ms"], rec["bound_by"] = bound_ms(12.0 * n, n)
    record["segment_scan"] = rec
    del b, xn

    # the look-back hazards, as prefix_sum's and segment_rank's: ragged
    # sizes; views not 16-byte aligned; two calls back to back on other
    # inputs of one length; int32 sums that wrap past 2^31 (exact modulo
    # 2^32); one segment head at row 0 and none after it (no tile restarts:
    # the longest look-back chains), up to 2^27 rows.  Integer values, so
    # the float32 sums are exact too: every comparison is bitwise.
    def scans_equal(x, b, tag):
        assert torch.equal(ss.segment_scan_cuda(x, b),
                           ss.segment_scan_plain(x, b)), f"segment_scan {tag}"

    for n in LOOKBACK_SIZES + (sizes[-2],):
        for mean_len in (1, 64, 1 << 16):
            for dt in (torch.int32, torch.float32):
                tag = f"{dt} n={n} L={mean_len}"
                bs = [heads(n + 1, mean_len) for _ in range(2)]
                xs = [torch.randint(-8, 9, (n + 1,), device=dev,
                                    generator=g).to(dt) for _ in range(2)]
                scans_equal(misaligned(xs[0]), misaligned(bs[0]),
                            f"misaligned {tag}")
                a = [ss.segment_scan_cuda(x[:n], h[:n]) for x, h in zip(xs, bs)]
                want = [ss.segment_scan_plain(x[:n], h[:n])
                        for x, h in zip(xs, bs)]
                assert all(map(torch.equal, a, want)), \
                    f"segment_scan back to back {tag}"
    for n in LOOKBACK_SIZES + (sizes[-2], sizes[-1]):
        one = torch.zeros(n, dtype=torch.int32, device=dev)
        one[0] = 1
        xw = torch.randint(-2**30, 2**30, (n,), device=dev, generator=g,
                           dtype=torch.int32)
        got = ss.segment_scan_cuda(xw, one)
        assert torch.equal(got, wrapped(xw)), f"segment_scan int32 wrap n={n}"
        scans_equal(xw, one, f"int32 wrap, one head at row 0, n={n}")
        scans_equal(xw, heads(n, 64), f"int32 wrap n={n}")
        xf = torch.randint(-8, 9, (n,), device=dev, generator=g).float()
        scans_equal(xf, one, f"f32 one head at row 0, n={n}")
    xn = torch.randn(n, device=dev, generator=g)
    record["segment_scan"]["one_head_at_row_0_ms"] = time_ms(
        lambda: ss.segment_scan_cuda(xn, one), torch)
    del one, xw, got, xf, xn
    log(f"segment_scan hazards: ok at sizes {LOOKBACK_SIZES}")

    # float32 look-back scans give the same bits on every call: 20 calls
    # each on normal values, prefix_sum and segment_scan (heads of the main
    # path's mean length and one head at row 0)
    repeats = {"prefix_sum": {}, "segment_scan": {}}
    for n in (LOOKBACK_SIZES[-1], sizes[-1]):
        xn = torch.randn(n, device=dev, generator=g)
        b = heads(n, GROUPS)
        one = torch.zeros(n, dtype=torch.int32, device=dev)
        one[0] = 1
        repeats["prefix_sum"][n] = same_bits(
            torch, lambda: sc.prefix_sum_cuda(xn), f"prefix_sum f32 n={n}")
        repeats["segment_scan"][n] = min(
            same_bits(torch, lambda: ss.segment_scan_cuda(xn, b),
                      f"segment_scan f32 n={n}"),
            same_bits(torch, lambda: ss.segment_scan_cuda(xn, one),
                      f"segment_scan f32 one head n={n}"))
        log(f"f32 prefix_sum, segment_scan n={n}: 20 calls each, the same bits")
    for name, r in repeats.items():
        record[name]["f32_calls_bitwise_equal"] = r
    del xn, b, one

    # -- segment_rank: all three kinds exact, ties in the order key (run
    # heads ~ 3 rows apart inside segments).
    for mean_len in (1, 64, 1 << 16):
        for n in sizes:
            seg = heads(n, mean_len)
            ordb = seg | (torch.rand(n, device=dev, generator=g) < 0.3).int()
            for kind in rk.KINDS:
                assert torch.equal(rk.segment_rank_cuda(seg, ordb, kind),
                                   rk.segment_rank_plain(seg, ordb, kind)), \
                    f"segment_rank {kind} n={n} L={mean_len}"
        log(f"segment_rank mean segment {mean_len}: ok at sizes {sizes}")

    # the look-back hazards, every kind: ragged sizes; views not 16-byte
    # aligned; two calls back to back on other inputs of one length; one
    # segment head at row 0 and none after it (no tile restarts: the
    # longest look-back chains), up to 2^27 rows.
    def ranks_equal(seg, ordb, tag):
        for kind in rk.KINDS:
            assert torch.equal(rk.segment_rank_cuda(seg, ordb, kind),
                               rk.segment_rank_plain(seg, ordb, kind)), \
                f"segment_rank {kind} {tag}"

    for n in LOOKBACK_SIZES + (sizes[-2],):
        for mean_len in (1, 64, 1 << 16):
            segs = [heads(n + 1, mean_len) for _ in range(2)]
            ords = [s | (torch.rand(n + 1, device=dev, generator=g) < 0.3).int()
                    for s in segs]
            ranks_equal(misaligned(segs[0]), misaligned(ords[0]),
                        f"misaligned n={n} L={mean_len}")
            a = [rk.segment_rank_cuda(segs[i][:n], ords[i][:n], kind)
                 for i in range(2) for kind in rk.KINDS]
            b = [rk.segment_rank_plain(segs[i][:n], ords[i][:n], kind)
                 for i in range(2) for kind in rk.KINDS]
            assert all(map(torch.equal, a, b)), \
                f"segment_rank back to back n={n} L={mean_len}"
    for n in LOOKBACK_SIZES + (sizes[-2], sizes[-1]):
        seg = torch.zeros(n, dtype=torch.int32, device=dev)
        seg[0] = 1
        ordb = seg | (torch.rand(n, device=dev, generator=g) < 0.125).int()
        ranks_equal(seg, ordb, f"one head at row 0, n={n}")
    single_head_ms = {kind: time_ms(
        lambda: rk.segment_rank_cuda(seg, ordb, kind), torch)
        for kind in rk.KINDS}
    del seg, ordb
    log(f"segment_rank hazards: ok at sizes {LOOKBACK_SIZES}")

    n = sizes[-1]
    seg = heads(n, GROUPS)
    ordb = seg | (torch.rand(n, device=dev, generator=g) < 0.125).int()
    ranks_equal(seg, ordb, f"timed inputs n={n}")
    by_kind = {}
    for kind in rk.KINDS:
        k = {"ms": time_ms(lambda: rk.segment_rank_cuda(seg, ordb, kind), torch),
             "plain_ms": time_ms(lambda: rk.segment_rank_plain(seg, ordb, kind),
                                 torch),
             "one_head_at_row_0_ms": single_head_ms[kind]}
        k["bound_ms"], k["bound_by"] = bound_ms(
            (8.0 if kind == "row_number" else 12.0) * n, n)
        by_kind[kind] = k
    rec = {"name": "segment_rank", "route": "cuda",
           "source": "src/repro_torch/csrc/segment_rank.cu",
           "replaces": "src/repro/kernels/segment_rank/segment_rank.py:67",
           "shape": f"rank, n={n}, mean segment {GROUPS}, runs of ~8",
           "max_abs_err": 0.0, **by_kind["rank"],
           "library_ms": None, "library_call": None,
           "library_note": "no one-call equivalent",
           "by_kind": by_kind}
    record["segment_rank"] = rec
    del seg, ordb

    # -- the stencils: K in {1, 3, 5, 7, 20} at centres 0 and K // 2, and
    # the main path's (K, centre) pairs: (3, 1) of the SMA, the WMA and the
    # partitioned WMA, (20, 19) of the exact rolling mean, (7, 6) of the
    # grouped exact rolling mean.  Every mode bitwise equal to the plain
    # version (the same float32 operations in the same order, the exact
    # modes' divide too): 0 ulps.
    centres = {1: (0,), 3: (0, 1), 5: (0, 2), 7: (0, 3, 6), 20: (0, 10, 19)}

    def layout(n, k, c, mean_len=64):
        """ext as stencil1d / segment_stencil1d build it: zero halos of c
        and k - 1 - c rows around n values; ext_s with -2 halos, segment
        ids (one head per mean_len rows on average) and the last n // 7
        rows invalid (-1)."""
        ext = torch.zeros(n + k - 1, device=dev)
        ext[c:c + n] = torch.randn(n, device=dev, generator=g)
        ext_m = torch.zeros(n + k - 1, device=dev)
        ext_m[c:c + n] = 1.0
        sid = torch.cumsum(heads(n, mean_len), 0, dtype=torch.int32) - 1
        sid[n - n // 7:] = -1
        ext_s = torch.full((n + k - 1,), -2, dtype=torch.int32, device=dev)
        ext_s[c:c + n] = sid
        return ext, ext_m, ext_s

    errs = {"stencil1d": 0.0, "stencil1d_exact": 0.0, "segment_stencil": 0.0}
    worst = {"stencil1d": 0, "stencil1d_exact": 0, "segment_stencil": 0}

    def held(name, got, want, tag):
        """One kernel call against its plain version: bitwise, folded into
        the kernel's own record."""
        u = ulps(torch, got, want)
        worst[name] = max(worst[name], u)
        assert torch.equal(got, want), f"{tag}: {u} ulps"
        if got.numel():
            errs[name] = max(errs[name], float((got - want).abs().max()))

    def all_modes(ext, ext_m, ext_s, w, wpos, c, tag):
        held("stencil1d", st.stencil1d_cuda(ext, w),
             st.stencil1d_plain(ext, w), f"stencil1d {tag}")
        held("stencil1d_exact", st.stencil1d_exact_cuda(ext, ext_m, wpos),
             st.stencil1d_exact_plain(ext, ext_m, wpos), f"stencil1d_exact {tag}")
        for exact, ww in ((False, w), (True, wpos)):
            held("segment_stencil",
                 st.segment_stencil_cuda(ext, ext_s, ww, c, exact),
                 st.segment_stencil_plain(ext, ext_s, ww, c, exact),
                 f"segment_stencil exact={exact} {tag}")

    for k, cs in centres.items():
        w = [float(v) for v in wrng.normal(size=k)]
        wpos = [abs(v) + 0.05 for v in w]
        for n in sizes:
            ext = torch.randn(n + k - 1, device=dev, generator=g)
            held("stencil1d", st.stencil1d_cuda(ext, w),
                 st.stencil1d_plain(ext, w), f"stencil1d K={k} n={n}")
            for c in cs:
                all_modes(*layout(n, k, c), w, wpos, c, f"K={k} c={c} n={n}")
        log(f"stencils K={k} centres {cs}: ok at sizes {sizes}")
    # around the kernel's 4096-output tile and at a few tiles, ragged ends,
    # and views not 16-byte aligned (the WORDS fetch); K = 4 (one whole step
    # of the register window) and K = 1100 (staged again past the 1024 taps
    # a block holds at once, with a centre beyond them)
    edges = (4095, 4096, 4097, 3 * 4096 + 5, 10 * 4096 + 3)
    for k, cs in {**centres, 4: (0, 2, 3), 1100: (0, 550, 1099)}.items():
        w = [float(v) for v in wrng.normal(size=k)]
        wpos = [abs(v) + 0.05 for v in w]
        for n in edges:
            for c in cs:
                arrays = layout(n, k, c)
                all_modes(*arrays, w, wpos, c, f"K={k} c={c} n={n}")
                views = [misaligned(torch.cat([t[:1], t])) for t in arrays]
                all_modes(*views, w, wpos, c, f"misaligned K={k} c={c} n={n}")
        log(f"stencils K={k}: ok around the tile, on ragged ends and "
            f"misaligned views at sizes {edges}")
    log(f"stencils: every mode within {worst} ulps")

    # The main path's calls at 2^27 rows, each held against its plain
    # version on the timed inputs.  fig8b_wma's: K = 3.
    n = sizes[-1]
    ext = torch.randn(n + 2, device=dev, generator=g)
    w3 = [0.25, 0.5, 0.25]
    wt = torch.tensor(w3, device=dev).view(1, 1, 3)
    conv = torch.nn.functional.conv1d
    got = st.stencil1d_cuda(ext, w3)
    held("stencil1d", got, st.stencil1d_plain(ext, w3),
         f"stencil1d timed inputs K=3 n={n}")
    lib = conv(ext.view(1, 1, -1), wt).view(-1)
    rec = {"name": "stencil1d", "route": "cuda",
           "source": "src/repro_torch/csrc/stencil1d.cu",
           "replaces": "src/repro/kernels/stencil1d/stencil1d.py:48",
           "shape": f"K=3, n={n}", "max_abs_err": errs["stencil1d"],
           "library_max_abs_diff": float((got - lib).abs().max()),
           "ms": time_ms(lambda: st.stencil1d_cuda(ext, w3), torch),
           "plain_ms": time_ms(lambda: st.stencil1d_plain(ext, w3), torch),
           "library_ms": time_ms(lambda: conv(ext.view(1, 1, -1), wt), torch),
           "library_call": "torch.nn.functional.conv1d (TF32 off)"}
    rec["bound_ms"], rec["bound_by"] = bound_ms(8.0 * n, 2.0 * 3 * n)
    record["stencil1d"] = rec
    del ext, got, lib

    # fig8b_rolling_mean_exact's call: K = 20, centre 19
    ext, ext_m, _s = layout(n, 20, 19)
    del _s
    w20 = [0.05] * 20
    held("stencil1d_exact", st.stencil1d_exact_cuda(ext, ext_m, w20),
         st.stencil1d_exact_plain(ext, ext_m, w20),
         f"stencil1d_exact timed inputs K=20 c=19 n={n}")
    rec = {"name": "stencil1d_exact", "route": "cuda",
           "source": "src/repro_torch/csrc/stencil1d.cu",
           "replaces": "src/repro/kernels/stencil1d/stencil1d.py:86",
           "shape": f"K=20, centre 19, n={n}",
           "max_abs_err": errs["stencil1d_exact"],
           "max_ulps": worst["stencil1d_exact"],
           "ms": time_ms(lambda: st.stencil1d_exact_cuda(ext, ext_m, w20), torch),
           "plain_ms": time_ms(lambda: st.stencil1d_exact_plain(ext, ext_m, w20),
                               torch),
           "library_ms": None, "library_call": None,
           "library_note": "no one-call equivalent"}
    rec["bound_ms"], rec["bound_by"] = bound_ms(12.0 * n, 4.0 * 20 * n + 2.0 * n)
    record["stencil1d_exact"] = rec
    del ext, ext_m

    # segment_stencil: the partitioned WMA's call (K = 3, centre 1, not
    # exact) is the record's; the grouped exact rolling mean's (K = 7,
    # centre 6) goes beside it under "exact_k7".  Segment ids of groups of
    # the main path's mean length.
    ext, _m, ext_s = layout(n, 3, 1, GROUPS)
    del _m
    held("segment_stencil", st.segment_stencil_cuda(ext, ext_s, w3, 1),
         st.segment_stencil_plain(ext, ext_s, w3, 1),
         f"segment_stencil timed inputs K=3 c=1 n={n}")
    rec = {"name": "segment_stencil", "route": "cuda",
           "source": "src/repro_torch/csrc/stencil1d.cu",
           "replaces": "src/repro/kernels/stencil1d/stencil1d.py:138",
           "shape": f"K=3, centre 1, not exact, n={n}, mean segment {GROUPS}",
           "ms": time_ms(lambda: st.segment_stencil_cuda(ext, ext_s, w3, 1), torch),
           "plain_ms": time_ms(lambda: st.segment_stencil_plain(ext, ext_s, w3, 1),
                               torch),
           "library_ms": None, "library_call": None,
           "library_note": "no one-call equivalent"}
    rec["bound_ms"], rec["bound_by"] = bound_ms(12.0 * n, 3.0 * 3 * n)
    del ext, ext_s
    ext, _m, ext_s = layout(n, 7, 6, GROUPS)
    del _m
    w7 = [1.0 / 7] * 7
    held("segment_stencil", st.segment_stencil_cuda(ext, ext_s, w7, 6, True),
         st.segment_stencil_plain(ext, ext_s, w7, 6, True),
         f"segment_stencil timed inputs K=7 c=6 exact n={n}")
    k7 = {"shape": f"K=7, centre 6, exact, n={n}, mean segment {GROUPS}",
          "ms": time_ms(lambda: st.segment_stencil_cuda(ext, ext_s, w7, 6, True),
                        torch),
          "plain_ms": time_ms(
              lambda: st.segment_stencil_plain(ext, ext_s, w7, 6, True), torch)}
    k7["bound_ms"], k7["bound_by"] = bound_ms(12.0 * n, 5.0 * 7 * n + 2.0 * n)
    rec.update(max_abs_err=errs["segment_stencil"],
               max_ulps=worst["segment_stencil"], exact_k7=k7)
    record["segment_stencil"] = rec
    del ext, ext_s
    cuda.reset_launches()


# The LM serving path: qwen3-0.6b at its published widths and depth, 32
# requests of 2048 prompt tokens and 256 greedy new tokens (the cache holds
# 2048 + 256 rows and fills exactly).  decode_attention is timed at the
# middle of the decode, 2176 rows.
LM_ARCH = "qwen3-0.6b"
LM_BATCH, LM_PROMPT, LM_NEW = 32, 2048, 256
LM_MID = LM_PROMPT + LM_NEW // 2


def decode_attention_phases(torch, record: dict):
    """decode_attention against its plain version: the reference's test
    shapes (random and full lengths) in float32 and bfloat16, and the LM
    decode path's shape with per-row lengths 1, 511, 512, 513, 2048, 2304
    and random ones.  Both compute in float32 and round once to q's dtype,
    so an element may differ by 2e-5 (the reference's float32 tolerance
    between its kernel and its oracle) plus, in bfloat16, one rounding
    step of the output: |got - want| <= 2^-7 |want| + 2e-5."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import cuda
    from repro_torch.kernels.decode_attention import decode_attention as da

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2)
    f32, bf16 = torch.float32, torch.bfloat16
    rel = {f32: 0.0, bf16: 2.0 ** -7}
    err = {f32: 0.0, bf16: 0.0}
    of_bound = {f32: 0.0, bf16: 0.0}     # largest |got - want| / its bound
    worst_bf16 = [0]

    def inputs(b, s, hkv, gq, hd, dt):
        q = torch.randn((b, hkv, gq, hd), device=dev, generator=g).to(dt)
        k, v = (torch.randn((b, s, hkv, hd), device=dev, generator=g).to(dt)
                for _ in range(2))
        return q, k, v

    def held(q, k, v, length, tag):
        got = da.decode_attention_cuda(q, k, v, length)
        want = da.decode_attention_plain(q, k, v, length)
        assert got.dtype == q.dtype and got.shape == q.shape, tag
        diff = (got.float() - want.float()).abs()
        share = float((diff / (rel[q.dtype] * want.float().abs() + 2e-5)).max())
        assert share <= 1, f"decode_attention {tag}: {share} of the bound"
        of_bound[q.dtype] = max(of_bound[q.dtype], share)
        d = float(diff.max())
        err[q.dtype] = max(err[q.dtype], d)
        if q.dtype == bf16:
            worst_bf16[0] = max(worst_bf16[0], ulps(torch, got, want))
        return got

    for b, s, hkv, gq, hd in ((1, 128, 2, 2, 32), (2, 512, 2, 4, 64),
                              (4, 1024, 8, 7, 64), (2, 700, 4, 1, 32)):
        for dt in (f32, bf16):
            q, k, v = inputs(b, s, hkv, gq, hd, dt)
            length = torch.randint(1, s + 1, (b,), device=dev, generator=g,
                                   dtype=torch.int32)
            for lens, what in ((length, "random"),
                               (torch.full_like(length, s), "full")):
                held(q, k, v, lens, f"{(b, s, hkv, gq, hd)} {dt} {what} lengths")
        log(f"decode_attention {(b, s, hkv, gq, hd)}: ok in float32 and bfloat16")

    cfg = get_config(LM_ARCH)
    b, s = LM_BATCH, LM_PROMPT + LM_NEW
    hkv, gq, hd = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.hd
    edges = torch.tensor([1, 511, 512, 513, 2048, 2304], dtype=torch.int32)
    for dt in (bf16, f32):
        q, k, v = inputs(b, s, hkv, gq, hd, dt)
        length = torch.randint(1, s + 1, (b,), device=dev, generator=g,
                               dtype=torch.int32)
        length[:len(edges)] = edges
        held(q, k, v, length, f"main path shape {dt}")
        log(f"decode_attention main path shape {(b, s, hkv, gq, hd)} {dt}: ok")
        del q, k, v

    # timed at the main path's shape in bfloat16, all rows at LM_MID
    q, k, v = inputs(b, s, hkv, gq, hd, bf16)
    mid = torch.full((b,), LM_MID, dtype=torch.int32, device=dev)
    got = held(q, k, v, mid, "timed inputs")
    # the yardstick, never called by the port: SDPA on inputs already laid
    # out (B, H, 1, hd) / (B, Hkv, S, hd), a boolean length mask, GQA
    # grouping h = kv * G + g as the kernel's
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qs = q.reshape(b, hkv * gq, 1, hd)
    ks, vs = (t.permute(0, 2, 1, 3).contiguous() for t in (k, v))
    mask = (torch.arange(s, device=dev) < LM_MID).expand(b, 1, 1, s)
    lib = sdpa(qs, ks, vs, attn_mask=mask, enable_gqa=True)
    rec = {"name": "decode_attention", "route": "cuda",
           "source": "src/repro_torch/csrc/decode_attention.cu",
           "replaces": "src/repro/kernels/decode_attention/decode_attention.py:67",
           "shape": f"bf16 q ({b}, {hkv}, {gq}, {hd}), k/v ({b}, {s}, {hkv}, "
                    f"{hd}), all lengths {LM_MID}",
           "max_abs_err": max(err.values()), "max_abs_err_f32": err[f32],
           "max_abs_err_bf16": err[bf16], "max_ulps_bf16": worst_bf16[0],
           "max_share_of_tolerance": {"f32": of_bound[f32], "bf16": of_bound[bf16]},
           "library_max_abs_diff": float(
               (got.float().reshape(b, hkv * gq, 1, hd) - lib.float()).abs().max()),
           "ms": time_ms(lambda: da.decode_attention_cuda(q, k, v, mid), torch),
           "plain_ms": time_ms(lambda: da.decode_attention_plain(q, k, v, mid),
                               torch),
           "library_ms": time_ms(
               lambda: sdpa(qs, ks, vs, attn_mask=mask, enable_gqa=True), torch),
           "library_call": "torch.nn.functional.scaled_dot_product_attention"
                           "(enable_gqa=True, boolean mask)"}
    kv_bytes = 2.0 * b * LM_MID * hkv * hd * 2
    rec["bound_ms"], rec["bound_by"] = bound_ms(
        kv_bytes + 2.0 * q.numel() * 2 + 4.0 * b, 4.0 * b * hkv * gq * hd * LM_MID)
    record["decode_attention"] = rec
    del q, k, v, ks, vs, qs, lib, got
    cuda.reset_launches()


# ---------------------------------------------------------------------------
# phase 3: the main path through hf, against numpy oracles
# ---------------------------------------------------------------------------

def q26(hf, ss, it, min_count=4):
    """TPCx-BB Q26 (benchmarks/bench_tpcx.py:20)."""
    store_sales, item = hf.table(ss, "ss"), hf.table(it, "it")
    sale_items = hf.join(store_sales, item, on=("ss_item_sk", "i_item_sk"))
    c_i = hf.aggregate(
        sale_items, "ss_customer_sk",
        c_i_count=hf.count(),
        id1=hf.sum_(sale_items["i_class_id"] == 1),
        id2=hf.sum_(sale_items["i_class_id"] == 2),
        id3=hf.sum_(sale_items["i_class_id"] == 3))
    return c_i[c_i["c_i_count"] > min_count]


def q26_multikey(hf, ss, dim, min_count=4):
    """Q26 on the composite (item, region) key (benchmarks/bench_tpcx.py:32)."""
    store_sales, d = hf.table(ss, "ss"), hf.table(dim, "dim")
    sale_items = hf.join(
        store_sales, d,
        on=[("ss_item_sk", "i_item_sk"), ("ss_region", "i_region")])
    per_key = hf.aggregate(
        sale_items, by=("ss_item_sk", "ss_region"),
        n=hf.count(),
        paid=hf.sum_(sale_items["ss_net_paid"]),
        id1=hf.sum_(sale_items["i_class_id"] == 1),
        id2=hf.sum_(sale_items["i_class_id"] == 2))
    return per_key[per_key["n"] > min_count]


def join_tables(n_left: int, n_right: int):
    """Fig. 8a join's tables (bench_relational.py:43): every left id in
    [0, n_right), the right ids an arange."""
    rng = np.random.default_rng(1)
    left = {"id": rng.integers(0, n_right, n_left).astype(np.int32),
            "x": rng.normal(size=n_left).astype(np.float32)}
    right = {"cid": np.arange(n_right, dtype=np.int32),
             "w": rng.normal(size=n_right).astype(np.float32)}
    return left, right


def join_want(left, right) -> dict:
    """Every left row matches right row id (cid is an arange), in left
    order."""
    return {"id": left["id"], "x": left["x"], "w": right["w"][left["id"]]}


# TPCx-BB Q26 at scale 64 of bench_tpcx.run (bench_tpcx.py:126)
Q26_SCALE = 64


def q26_tables(synth, sf: int = Q26_SCALE):
    """store_sales and item at scale ``sf``, and the number of customers."""
    n_sales, n_items, n_cust = 400_000 * sf, 20_000 * sf, 50_000 * sf
    ss = synth.store_sales(n_sales, n_items, n_cust, seed=10)
    it = synth.item(n_items, seed=11)
    return ss, it, n_cust


def q26_want(ss, it, n_cust: int) -> dict:
    """Q26's rows from numpy bincounts, in customer order."""
    cls = it["i_class_id"][ss["ss_item_sk"]]
    cust = ss["ss_customer_sk"]
    n_c = np.bincount(cust, minlength=n_cust)
    want = {"ss_customer_sk": np.flatnonzero(n_c > 4).astype(np.int32)}
    k = want["ss_customer_sk"]
    want["c_i_count"] = n_c[k].astype(np.int32)
    for c in (1, 2, 3):
        want[f"id{c}"] = np.bincount(cust, weights=(cls == c),
                                     minlength=n_cust)[k].astype(np.int32)
    return want


def sorted_rows(cols: dict, by) -> dict:
    """The rows of ``cols`` ordered by the columns ``by`` (lexicographic,
    the first most significant), to compare results whose row order
    depends on P."""
    order = np.lexsort([cols[k] for k in reversed(by)])
    return {k: v[order] for k, v in cols.items()}


def region_tables(ss, it, n_regions=4, seed=13):
    """The region column and (item, region) dimension of bench_tpcx.py:50."""
    rng = np.random.default_rng(seed)
    ss = dict(ss)
    ss["ss_region"] = rng.integers(0, n_regions,
                                   len(ss["ss_item_sk"])).astype(np.int32)
    n_items = len(it["i_item_sk"])
    dim = {"i_item_sk": np.tile(it["i_item_sk"], n_regions),
           "i_region": np.repeat(np.arange(n_regions, dtype=np.int32), n_items),
           "i_class_id": np.tile(it["i_class_id"], n_regions)}
    return ss, dim


def check_equal(got: dict, want: dict, tag: str, float_tol=None):
    """Exact on every column, except float columns named in ``float_tol``
    (column -> (rtol, atol))."""
    float_tol = float_tol or {}
    assert set(got) == set(want), (tag, sorted(got), sorted(want))
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape, (tag, k, g.shape, w.shape)
        if k in float_tol and np.issubdtype(g.dtype, np.floating):
            rtol, atol = float_tol[k]
            np.testing.assert_allclose(g, w, rtol=rtol, atol=atol,
                                       err_msg=f"{tag}.{k}")
        else:
            assert np.array_equal(g, w), f"{tag}.{k} differs"


def profile_run(torch, fn, path: str) -> dict:
    """Run ``fn()`` once under torch.profiler; write the per-op table to
    ``path`` and return device-time totals in ms: kernels, copies, wall."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ka = prof.key_averages()
    sort = "self_device_time_total"
    with open(path, "w") as f:
        f.write(ka.table(sort_by=sort, row_limit=40))
    # device-side events only (kernels, copies): the aten ops that launch
    # them report the same time again
    dev = {"kernels": 0.0, "copies": 0.0}
    top = []
    for e in ka:
        t = getattr(e, sort, 0.0) / 1e3
        if t <= 0 or not str(e.device_type).endswith("CUDA"):
            continue
        kind = "copies" if "memcpy" in e.key.lower() or \
            "memset" in e.key.lower() else "kernels"
        dev[kind] += t
        top.append((t, e.key[:60]))
    top.sort(reverse=True)
    busy = dev["kernels"] + dev["copies"]
    return {"wall_ms": round(wall * 1e3, 3),
            "kernel_ms": round(dev["kernels"], 3),
            "copy_ms": round(dev["copies"], 3),
            "idle_share": round(max(0.0, 1 - busy / (wall * 1e3)), 4),
            "top": [[round(t, 3), k] for t, k in top[:6]]}


def query_runner(torch, hf, queries: dict, profile_dir: str | None):
    """``run(tag, frame)``: collect ``frame`` on the card, record its wall
    time, peak memory and rows out under ``queries[tag]`` (and a profile
    with ``profile_dir``), and return its columns as numpy."""
    cfg = hf.ExecConfig()          # the card

    def run(tag, frame):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        t = frame.collect(cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        assert not t.overflow, f"{tag}: capacity overflow {t.overflow_ops}"
        out = t.to_numpy()
        queries[tag] = {"wall_s": round(wall, 4),
                        "peak_gib": round(torch.cuda.max_memory_allocated()
                                          / 2**30, 3),
                        "rows_out": int(len(next(iter(out.values()))))}
        log(f"{tag}: {queries[tag]}")
        if profile_dir:
            prof = profile_run(torch, lambda: frame.collect(cfg), os.path.join(
                profile_dir, f"profile_{tag}.txt"))
            queries[tag]["profile"] = prof
            log(f"{tag} profile: {prof}")
        return out
    return run


def main_path(torch, hf, synth, queries: dict, profile_dir: str | None = None,
              checks: dict | None = None):
    """The relational path: Fig. 8a and TPCx-BB Q26; the digest of the
    aggregate's float sums and means goes into ``checks``."""
    run = query_runner(torch, hf, queries, profile_dir)
    checks = {} if checks is None else checks
    n8a = 2**27

    # Fig. 8a filter (bench_relational.py:27)
    t = synth.relational_tables(n8a, 1000, seed=0)
    df = hf.table(t)
    out = run("fig8a_filter", df[df.x < 0.5])
    m = t["x"] < np.float32(0.5)
    check_equal(out, {k: v[m] for k, v in t.items()}, "filter")
    queries["fig8a_filter"]["rows_in"] = n8a
    del t, df, out, m

    # Fig. 8a join (bench_relational.py:43): 2^26 left rows, 2^22 right
    left, right = join_tables(2**26, 2**22)
    out = run("fig8a_join", hf.join(hf.table(left, "l"), hf.table(right, "r"),
                                     on=("id", "cid")))
    # left order kept at P = 1
    check_equal(out, join_want(left, right), "join")
    queries["fig8a_join"]["rows_in"] = 2**26 + 2**22
    del left, right, out

    # Fig. 8a aggregate (bench_relational.py:64): sum(x), mean(y) by id
    t = synth.relational_tables(n8a, 4096, seed=2)
    df = hf.table(t)
    out = run("fig8a_aggregate",
              hf.aggregate(df, "id", s=hf.sum_(df["x"]), m=hf.mean(df["y"])))
    cnt = np.bincount(t["id"], minlength=4096)
    keys = np.flatnonzero(cnt).astype(np.int32)
    sx = np.bincount(t["id"], weights=t["x"].astype(np.float64), minlength=4096)
    sy = np.bincount(t["id"], weights=t["y"].astype(np.float64), minlength=4096)
    # float32 sums of ~32768 N(0,1) values (|s| ~ 180) against a float64
    # oracle; their means (|m| ~ 0.005) are held 10x tighter than the
    # change one missing row would make (~3e-5)
    check_equal(out, {"id": keys, "s": sx[keys].astype(np.float32),
                      "m": (sy[keys] / cnt[keys]).astype(np.float32)},
                "aggregate", float_tol={"s": (1e-4, 1e-2), "m": (1e-4, 1e-6)})
    # segment_sums folds its tiles in order, so the bits are the same in
    # every run
    checks["fig8a_aggregate_digest"] = digest(np.concatenate([out["s"],
                                                              out["m"]]))
    queries["fig8a_aggregate"]["rows_in"] = n8a
    del t, df, out

    # TPCx-BB Q26 at scale 64 of bench_tpcx.run (bench_tpcx.py:126)
    ss, it, n_cust = q26_tables(synth)
    out = run("fig11_q26", q26(hf, ss, it))
    check_equal(out, q26_want(ss, it, n_cust), "q26")
    queries["fig11_q26"]["rows_in"] = len(ss["ss_item_sk"]) + len(it["i_item_sk"])
    del out

    ssr, dim = region_tables(ss, it)
    out = run("fig11_q26_multikey", q26_multikey(hf, ssr, dim))
    key = ssr["ss_item_sk"].astype(np.int64) * 4 + ssr["ss_region"]
    nk = len(it["i_item_sk"]) * 4
    n_k = np.bincount(key, minlength=nk)
    sel = np.flatnonzero(n_k > 4)
    cls = it["i_class_id"][ssr["ss_item_sk"]]
    want = {"ss_item_sk": (sel // 4).astype(np.int32),
            "ss_region": (sel % 4).astype(np.int32),
            "n": n_k[sel].astype(np.int32),
            "paid": np.bincount(key, weights=ssr["ss_net_paid"].astype(np.float64),
                                minlength=nk)[sel].astype(np.float32)}
    for c in (1, 2):
        want[f"id{c}"] = np.bincount(key, weights=(cls == c),
                                     minlength=nk)[sel].astype(np.int32)
    # ~20 gamma(2, 30) values per key: float32 sums within 1e-4 relative
    check_equal(out, want, "q26_multikey", float_tol={"paid": (1e-4, 1e-2)})
    queries["fig11_q26_multikey"]["rows_in"] = len(key) + len(dim["i_item_sk"])


def check_close(tag, got, want, rtol, atol) -> float:
    """|got - want| <= atol + rtol |want| elementwise; the largest
    difference."""
    d = np.abs(got.astype(np.float64) - want)
    bad = d > atol + rtol * np.abs(want)
    assert not bad.any(), (f"{tag}: {int(bad.sum())} rows off, first at "
                           f"{int(np.argmax(bad))}, max diff {d.max()}")
    return float(d.max()) if d.size else 0.0


def stencil_f32(v, weights, center, prev_ok=None, next_ok=None):
    """The stencil's float32 operations in numpy, tap by tap: zero halos,
    and (partitioned) taps across a group edge zeroed through the masks
    ``prev_ok`` / ``next_ok`` of a 3-tap window."""
    n, k = len(v), len(weights)
    ext = np.concatenate([np.zeros(center, np.float32), v,
                          np.zeros(k - 1 - center, np.float32)])
    acc = np.zeros(n, np.float32)
    for j, w in enumerate(weights):
        tap = ext[j:j + n]
        if prev_ok is not None and j != center:
            tap = np.where(prev_ok if j < center else next_ok, tap,
                           np.float32(0))
        acc = acc + np.float32(w) * tap
    return acc


def window_path(torch, hf, synth, queries: dict, profile_dir: str | None = None,
                checks: dict | None = None, n: int = 2**27, groups: int = GROUPS):
    """The window path: Fig. 8b (bench_analytics.py:29-62) and the
    partitioned windows (bench_analytics.py:64-76) at n = 2^27 rows; the
    largest difference of each float check goes into ``checks``."""
    run = query_runner(torch, hf, queries, profile_dir)
    checks = {} if checks is None else checks
    x = synth.series(n, seed=3)
    df = hf.table({"x": x})
    x64 = x.astype(np.float64)
    csum = np.cumsum(x64)

    # fig8b_cumsum: float32 look-back scan against a float64 oracle.  The
    # scan adds in another order; its error grows with the magnitude of the
    # partial sums (|S| reaches ~3.5e4), so: within 1e-5 of the running max
    # |S| (+1e-3), ~40 float32 roundings of that magnitude.  The order is
    # fixed, so the digest of the result is the same in every run.
    out = run("fig8b_cumsum", hf.cumsum(df, df["x"], out="c"))
    assert np.array_equal(out["x"], x)
    scale = np.maximum.accumulate(np.abs(csum))
    checks["fig8b_cumsum"] = check_close("fig8b_cumsum", out["c"], csum,
                                         0.0, 1e-5 * scale + 1e-3)
    checks["fig8b_cumsum_digest"] = digest(out["c"])
    queries["fig8b_cumsum"]["rows_in"] = n
    del out, scale

    # fig8b_sma / fig8b_wma: the float32 tap operations replayed in numpy;
    # the kernel does the same operations, so equal within 1e-6
    for tag, frame, w in (
            ("fig8b_sma", hf.sma(df, df["x"], 3, out="s"), [1.0 / 3] * 3),
            ("fig8b_wma", hf.wma(df, df["x"], [1, 2, 1], out="s"),
             [0.25, 0.5, 0.25])):
        out = run(tag, frame)
        want = stencil_f32(x, w, 1)
        checks[tag] = check_close(tag, out["s"], want, 1e-6, 1e-6)
        checks[tag + "_bitwise"] = bool(np.array_equal(out["s"], want))
        queries[tag]["rows_in"] = n
        del out, want

    # fig8b_rolling_mean_exact: the mean of the min(i + 1, 20) rows that
    # exist, from float64 cumsum differences.  The kernel sums 20 taps of
    # |x| < 6 with weight 1/20 and divides by the summed weights: ~40
    # float32 roundings of values below 6, so atol 2e-5, rtol 1e-5.
    out = run("fig8b_rolling_mean_exact",
              hf.rolling_mean(df, df["x"], 20, out="m", exact=True))
    c0 = np.concatenate([[0.0], csum])
    i = np.arange(n)
    lo = np.maximum(i - 19, 0)
    want = (c0[i + 1] - c0[lo]) / (i + 1 - lo)
    checks["fig8b_rolling_mean_exact"] = check_close(
        "fig8b_rolling_mean_exact", out["m"], want, 1e-5, 2e-5)
    queries["fig8b_rolling_mean_exact"]["rows_in"] = n
    del out, c0, i, lo, want, df, csum, x64

    # the partitioned fact table: ~sqrt(n) groups, t a permutation
    rng = np.random.default_rng(7)
    g = rng.integers(0, groups, n).astype(np.int32)
    t = rng.permutation(n).astype(np.int32)
    t8 = (t // 8).astype(np.int32)
    w0 = rng.normal(size=groups).astype(np.float32)
    # the oracle's order: sort once by (g, t) (unique keys)
    perm = np.argsort((g.astype(np.int64) << 32) | t)
    gs, ts, xs = g[perm], t[perm], x[perm]
    head = np.ones(n, bool)
    head[1:] = gs[1:] != gs[:-1]
    idx = np.arange(n)
    first = np.maximum.accumulate(np.where(head, idx, 0))
    nxt = np.ones(n, bool)
    nxt[:-1] = ~head[1:]             # row i + 1 is in row i's group
    nxt[-1] = False

    # partitioned WMA after a join on g (bench_analytics.py:64-76): the
    # exchanges (compactions at P = 1), the merge join, the local sort and
    # segment_stencil.  The value x * w0 and the three taps replayed in
    # float32 numpy: equal within 1e-6.
    j = hf.join(hf.table({"g": g, "t": t, "x": x}, "fact"),
                hf.table({"g": np.arange(groups, dtype=np.int32), "w0": w0},
                         "dim"), on="g")
    out = run("partitioned_wma", hf.wma(j, j["x"] * j["w0"], [1, 2, 1],
                                        out="ww", partition_by="g",
                                        order_by="t"))
    for k, v in (("g", gs), ("t", ts), ("x", xs), ("w0", w0[gs])):
        assert np.array_equal(out[k], v), f"partitioned_wma.{k} differs"
    want = stencil_f32(xs * w0[gs], [0.25, 0.5, 0.25], 1, ~head, nxt)
    checks["partitioned_wma"] = check_close("partitioned_wma", out["ww"],
                                            want, 1e-6, 1e-6)
    checks["partitioned_wma_bitwise"] = bool(np.array_equal(out["ww"], want))
    queries["partitioned_wma"]["rows_in"] = n + groups
    del out, want, j

    # grouped_windows: one frame chaining five windows over the groups
    fact = hf.table({"g": g, "t": t, "t8": t8, "x": x}, "fact")
    a = fact.over("g", order_by="t").cumsum(fact["x"], out="c")
    b = a.over("g", order_by="t").rolling_mean(a["x"], 7, out="m", exact=True)
    c = b.over("g", order_by="t8").rank(out="r")
    d = c.over("g", order_by="t8").dense_rank(out="dr")
    e = d.over("g", order_by="t8").row_number(out="rn")
    out = run("grouped_windows", e)
    for k, v in (("g", gs), ("t", ts), ("t8", ts // 8), ("x", xs)):
        assert np.array_equal(out[k], v), f"grouped_windows.{k} differs"
    # segmented cumsum from float64: within 1e-5 of the group's running sum
    # of |x| (+1e-4), as in phase 2
    cs = np.cumsum(xs.astype(np.float64))
    base = np.where(first > 0, cs[np.maximum(first - 1, 0)], 0.0)
    ca = np.cumsum(np.abs(xs.astype(np.float64)))
    abase = np.where(first > 0, ca[np.maximum(first - 1, 0)], 0.0)
    checks["grouped_cumsum"] = check_close("grouped_cumsum", out["c"],
                                           cs - base, 0.0,
                                           1e-5 * (ca - abase) + 1e-4)
    checks["grouped_cumsum_digest"] = digest(out["c"])
    # exact rolling mean over the min(pos + 1, 7) rows of the group: 7 taps
    lo = np.maximum(first, idx - 6)
    win = cs - np.where(lo > 0, cs[np.maximum(lo - 1, 0)], 0.0)
    checks["grouped_rolling_mean"] = check_close(
        "grouped_rolling_mean", out["m"], win / (idx - lo + 1), 1e-5, 1e-5)
    del cs, base, ca, abase, lo, win
    # the ranks over (g, t8): exact
    run_head = head.copy()
    run_head[1:] |= (ts[1:] // 8) != (ts[:-1] // 8)
    run_first = np.maximum.accumulate(np.where(run_head, idx, 0))
    runs = np.cumsum(run_head)
    for k, want in (("rn", idx - first + 1), ("r", run_first - first + 1),
                    ("dr", runs - runs[first] + 1)):
        assert np.array_equal(out[k], want.astype(np.int32)), \
            f"grouped_windows.{k} differs"
    queries["grouped_windows"]["rows_in"] = n


# ---------------------------------------------------------------------------
# the sort path: global sort, limit, rebalance, concat and persist at P = 1
# ---------------------------------------------------------------------------

# Fig. 12's two legs as the reference plans them at P = 1 (shuffles,
# all_to_all): Q26 against the cold item dimension, and against the one
# persisted hash-partitioned on i_item_sk, whose side needs no exchange.
# tests/test_torch_sort.py holds both packages' plans to these numbers.
Q26_LEGS = {"cold": (3, 6), "persisted": (2, 4)}


def q26_fluent(ss, item, min_count=4):
    """TPCx-BB Q26 over any item-dimension frame (bench_tpcx.py:65-74)."""
    si = ss.merge(item, on=("ss_item_sk", "i_item_sk"))
    c = si.groupby("ss_customer_sk").agg(
        c_i_count="count", id1=(si["i_class_id"] == 1, "sum"),
        id2=(si["i_class_id"] == 2, "sum"), id3=(si["i_class_id"] == 3, "sum"))
    return c[c["c_i_count"] > min_count]


def persisted_dim(hf, it, cfg):
    """bench_tpcx.py:178-181: the item dimension deduplicated by a
    first-aggregate on its key, persisted hash-partitioned on it."""
    return (hf.table(it, "it").groupby("i_item_sk")
            .agg(i_class_id=("i_class_id", "first")).persist(cfg))


def stable_order(x: np.ndarray) -> np.ndarray:
    """``np.argsort(x, kind="stable")`` of a float32 array without NaNs, as
    one sort of 64-bit keys: the order-preserving bits of x (with -0.0
    taken as 0.0, as the sort compares them) above the row index."""
    u = (x + np.float32(0)).view(np.uint32)
    s = np.where(u >> np.uint32(31), ~u, u | np.uint32(0x80000000))
    key = (s.astype(np.uint64) << np.uint64(32)) \
        | np.arange(len(x), dtype=np.uint64)
    key.sort()
    return (key & np.uint64(0xFFFFFFFF)).astype(np.int64)


def fig14_inputs(synth, n: int):
    """bench_validate.py:20-32's tables: n fact rows with keys in
    [0, n / 16), and the dimension over those keys."""
    rng = np.random.default_rng(14)
    nk = n // 16
    fact = {"k": rng.integers(0, nk, n).astype(np.int32),
            "v": synth.series(n, seed=14)}
    kdim = {"k": np.arange(nk, dtype=np.int32),
            "w": rng.normal(size=nk).astype(np.float32)}
    return fact, kdim


def fig14_frame(hf, fact, kdim):
    """bench_validate.py:20-32: group-by sum/count -> join -> sort."""
    agg = hf.aggregate(hf.table(fact, "fact"), by="k", v_sum=("v", "sum"),
                       v_cnt=("v", "count"))
    return hf.join(agg, hf.table(kdim, "dim"), on="k").sort_values("v_sum")


def global_rank_frame(hf, x, kinds=("rank", "dense_rank", "row_number")):
    """The global rank kinds of the series ``x`` by its values, chained
    (columns r, dr, rn): one sample sort under the first."""
    frame = hf.table({"x": x})
    for kind, col in zip(kinds, ("r", "dr", "rn")):
        frame = getattr(hf, kind)(frame, None, "x", out=col)
    return frame


def sma_after_filter_frame(hf, x):
    """An SMA of 3 over the positive values of ``x``: the filter makes the
    input 1D_VAR, so a Rebalance comes before the stencil."""
    f = hf.table({"x": x})
    f = f[f["x"] > 0.0]
    return hf.sma(f, f["x"], 3, out="s")


def concat_aggregate_frame(hf, t):
    """``t`` in two halves, concatenated, then Fig. 8a's sum by id."""
    h = len(t["id"]) // 2
    both = hf.concat(hf.table({k: v[:h] for k, v in t.items()}, "a"),
                     hf.table({k: v[h:] for k, v in t.items()}, "b"))
    return hf.aggregate(both, "id", s=hf.sum_(both["x"]))


def sort_path(torch, hf, synth, queries: dict, profile_dir: str | None = None,
              checks: dict | None = None, n: int = 2**27):
    """The sort path at P = 1: a global sort of Fig. 8a's table and its
    descending head, bench_validate.py's group-by -> join -> sort, the
    global rank kinds over Fig. 8b's series, an SMA after a filter (a
    Rebalance under the stencil), a concat feeding the Fig. 8a aggregate,
    and Fig. 12's Q26 against a persisted and a cold item dimension, each
    twice; every query against numpy."""
    run = query_runner(torch, hf, queries, profile_dir)
    checks = {} if checks is None else checks
    cfg = hf.ExecConfig()

    # sort_fig8a: the sorted x bitwise, every row whole: at P = 1 the sort
    # is stable, so the rows are the input's in numpy's stable order
    t = synth.relational_tables(n, 1000, seed=0)
    df = hf.table(t)
    out = run("sort_fig8a", df.sort_values("x"))
    order = stable_order(t["x"])
    assert np.array_equal(out["x"], np.sort(t["x"])), "sort_fig8a.x"
    check_equal(out, {k: v[order] for k, v in t.items()}, "sort_fig8a")
    queries["sort_fig8a"]["rows_in"] = n
    # the descending sort is the stable ascending order reversed
    out = run("sort_desc_head", df.sort_values("x", ascending=False).head(1000))
    check_equal(out, {k: v[order[::-1][:1000]] for k, v in t.items()},
                "sort_desc_head")
    queries["sort_desc_head"]["rows_in"] = n
    del t, df, out, order

    # fig14_pipeline: sums within the aggregate's tolerance, in order
    fact, kdim = fig14_inputs(synth, n)
    nk = len(kdim["k"])
    out = run("fig14_pipeline", fig14_frame(hf, fact, kdim))
    assert np.all(np.diff(out["v_sum"]) >= 0), "fig14_pipeline order"
    cnt = np.bincount(fact["k"], minlength=nk)
    keys = np.flatnonzero(cnt)
    s = np.bincount(fact["k"], weights=fact["v"].astype(np.float64),
                    minlength=nk)
    by_k = np.argsort(out["k"])
    check_equal({c: v[by_k] for c, v in out.items()},
                {"k": keys.astype(np.int32), "v_sum": s[keys].astype(np.float32),
                 "v_cnt": cnt[keys].astype(np.int32), "w": kdim["w"][keys]},
                "fig14_pipeline", float_tol={"v_sum": (1e-4, 1e-3)})
    queries["fig14_pipeline"]["rows_in"] = n + nk
    del fact, kdim, out, cnt, keys, s, by_k

    # global_rank over Fig. 8b's series: a SampleSort, then the ranks of the
    # sorted keys, exact against scipy
    from scipy.stats import rankdata
    x = synth.series(n, seed=3)
    out = run("global_rank", global_rank_frame(hf, x))
    xs = np.sort(x)
    assert np.array_equal(out["x"], xs), "global_rank.x"
    # rankdata may give ranks in its input's float dtype: float64 holds
    # every rank of 2^27 rows exactly, float32 not past 2^24
    x64 = xs.astype(np.float64)
    for col, method in (("r", "min"), ("dr", "dense"), ("rn", "ordinal")):
        assert np.array_equal(out[col], rankdata(x64, method=method)), \
            f"global_rank.{col}"
    queries["global_rank"]["rows_in"] = n
    del out, xs, x64

    # sma_after_filter: the filter makes the series 1D_VAR, so a Rebalance
    # (a compaction at P = 1) comes before the stencil; held as Fig. 8b's
    # SMA is, against the float32 taps replayed in numpy
    out = run("sma_after_filter", sma_after_filter_frame(hf, x))
    xf = x[x > np.float32(0)]
    assert np.array_equal(out["x"], xf), "sma_after_filter.x"
    want = stencil_f32(xf, [1.0 / 3] * 3, 1)
    checks["sma_after_filter"] = check_close("sma_after_filter", out["s"],
                                             want, 1e-6, 1e-6)
    checks["sma_after_filter_bitwise"] = bool(np.array_equal(out["s"], want))
    queries["sma_after_filter"]["rows_in"] = n
    del x, out, xf, want

    # concat_aggregate: Fig. 8a's aggregate table in two halves, concatenated
    # and aggregated; fig8a_aggregate's oracle and tolerance
    t = synth.relational_tables(n, 4096, seed=2)
    out = run("concat_aggregate", concat_aggregate_frame(hf, t))
    cnt = np.bincount(t["id"], minlength=4096)
    keys = np.flatnonzero(cnt).astype(np.int32)
    sx = np.bincount(t["id"], weights=t["x"].astype(np.float64), minlength=4096)
    check_equal(out, {"id": keys, "s": sx[keys].astype(np.float32)},
                "concat_aggregate", float_tol={"s": (1e-4, 1e-2)})
    queries["concat_aggregate"]["rows_in"] = n
    del t, out

    # fig12_q26_persisted (bench_tpcx.py:169-190): Q26 against the persisted
    # and the cold item dimension, each twice; the plans are the reference's
    ss, it, n_cust = q26_tables(synth)
    want = q26_want(ss, it, n_cust)
    t0 = time.perf_counter()
    pdim = persisted_dim(hf, it, cfg)
    queries["fig12_persist_dim_s"] = round(time.perf_counter() - t0, 4)
    ss_df = hf.table(ss, "ss")
    for leg, item in (("cold", hf.table(it, "it")), ("persisted", pdim)):
        frame = q26_fluent(ss_df, item)
        plan = frame.physical_plan(cfg)
        got = (plan.shuffle_count(), plan.collective_count())
        assert got == Q26_LEGS[leg], f"fig12 {leg}: plan {got}"
        for i in (1, 2):
            tag = f"fig12_q26_{leg}_{i}"
            check_equal(run(tag, frame), want, tag)
            queries[tag]["rows_in"] = len(ss["ss_item_sk"]) + len(it["i_item_sk"])
            queries[tag]["shuffles"], queries[tag]["all_to_all"] = got


# The frame path: TPCx-BB's string queries (bench_tpcx.py:100-125, 192-210)
# and the frame, null and dtype verbs, at Q26's scale 64.
FRAME_SCALE = Q26_SCALE
# a dimension keyed by category name: four of synth.CATEGORY_NAMES, two new
FRAME_DIM_NAMES = ("bikes", "books", "garden", "music", "toys", "wine")


def frame_tables(synth, sf: int = FRAME_SCALE):
    """bench_tpcx.run's string inputs at scale ``sf``: web clicks over
    Zipf-skewed items, the item table with its category name, and store
    sales with a string channel and a discount, each with 2 % nulls."""
    n_sales, n_items, n_cust = 400_000 * sf, 20_000 * sf, 50_000 * sf
    wcs = synth.web_clickstream(n_sales, n_items, n_cust, seed=12, skew=1.1)
    itx = synth.item_ext(n_items, seed=11)
    ssx = synth.store_sales_ext(n_sales, n_items, n_cust, seed=10)
    return wcs, itx, ssx


def category_dim():
    rng = np.random.default_rng(21)
    return {"i_category_name": np.asarray(FRAME_DIM_NAMES, dtype=object),
            "w": rng.normal(size=len(FRAME_DIM_NAMES)).astype(np.float32)}


def q05_frame(wcs_df, item_df, books, media):
    """TPCx-BB Q05 (bench_tpcx.py:100): clicks per user on one category,
    on two others, and all clicks."""
    j = wcs_df.merge(item_df, on=("wcs_item_sk", "i_item_sk"))
    return j.groupby("wcs_user_sk").agg(
        clicks_books=(j["i_category_name"] == books, "sum"),
        clicks_media=(j["i_category_name"].isin(media), "sum"),
        total="count")


def q09_channel_frame(ss_df):
    """bench_tpcx.py:113: a string isin filter, the nullable channel as the
    group key, skipna sum/mean/count over the nullable discount."""
    f = ss_df[ss_df["ss_channel"].isin(["web", "catalog"])]
    return f.groupby("ss_channel").agg(
        revenue=("ss_net_paid", "sum"), avg_disc=("ss_discount", "mean"),
        n_disc=("ss_discount", "count"), n="count")


def frame_verbs_frame(ss_df):
    """dropna, fillna, assign, astype, rename, drop, a column assigned from
    a string predicate, then a group-by on the renamed channel."""
    v = (ss_df.dropna(subset="ss_channel").fillna({"ss_discount": 0.0})
         .assign(net=lambda d: d.ss_net_paid - d.ss_discount)
         .astype({"ss_customer_sk": np.float32})
         .rename(columns={"ss_channel": "channel"})
         .drop("ss_ticket_number"))
    v["is_web"] = v["channel"] == "web"
    return v.groupby("channel").agg(
        net=("net", "sum"), cust=("ss_customer_sk", "mean"),
        web=("is_web", "sum"), n="count")


def null_rows_frame(ss_df):
    """The sales whose channel or discount is null: a category isna and a
    float isna, one int column out."""
    null = ss_df.ss_channel.isna() | ss_df.ss_discount.isna()
    return ss_df[null][["ss_ticket_number"]]


def sales_halves(ssx: dict, code: np.ndarray) -> tuple[dict, dict]:
    """The two halves of the sales for concat_channels: the first keeps
    only its catalog and store rows (``code`` 0 and 1), so its dictionary
    differs from the second's."""
    h = len(code) // 2
    keep = np.flatnonzero((code[:h] == 0) | (code[:h] == 1))
    return ({k: v[:h][keep] for k, v in ssx.items()},
            {k: v[h:] for k, v in ssx.items()})


def concat_channels_frame(hf, a_df, b_df):
    both = hf.concat(a_df, b_df)
    return both.groupby("ss_channel").agg(
        n="count", revenue=("ss_net_paid", "sum"))


def merge_category_frame(itx_df, dim_df):
    j = itx_df.merge(dim_df, on="i_category_name")
    return j.groupby("i_category_name").agg(
        n="count", w=("w", "max"), cls=("i_class_id", "sum"))


def channel_codes(channels: np.ndarray, synth) -> np.ndarray:
    """The sales channels as codes into synth.CHANNELS (sorted), -1 for
    None: the dictionary ingest builds, without its per-row loop."""
    code = np.full(len(channels), -1, np.int32)
    for i, c in enumerate(synth.CHANNELS):
        code[channels == c] = i
    return code


def q05_want(wcs, itx, synth) -> dict:
    """Q05's rows from numpy bincounts over category ids, in user order
    (the names map from i_category_id, synth.item_ext)."""
    names = list(synth.CATEGORY_NAMES)
    cat = itx["i_category_id"][wcs["wcs_item_sk"]] - 1
    user = wcs["wcs_user_sk"]
    n_u = np.bincount(user)
    keys = np.flatnonzero(n_u)
    media = (cat == names.index("electronics")) | (cat == names.index("music"))
    return {"wcs_user_sk": keys.astype(np.int32),
            "clicks_books": np.bincount(user, weights=cat == names.index("books"),
                                        minlength=len(n_u))[keys].astype(np.int32),
            "clicks_media": np.bincount(user, weights=media,
                                        minlength=len(n_u))[keys].astype(np.int32),
            "total": n_u[keys].astype(np.int32)}


def merge_category_want(itx, dim, synth) -> dict:
    """The merged names' rows in the union dictionary's code order."""
    union = sorted(set(synth.CATEGORY_NAMES) | set(dim["i_category_name"]))
    cat = itx["i_category_id"] - 1
    out = {c: [] for c in ("i_category_name", "n", "w", "cls")}
    for name, w in zip(dim["i_category_name"], dim["w"]):
        if name not in synth.CATEGORY_NAMES:
            continue
        m = cat == list(synth.CATEGORY_NAMES).index(name)
        out["i_category_name"].append(union.index(name))
        out["n"].append(int(m.sum()))
        out["w"].append(w)
        out["cls"].append(int(itx["i_class_id"][m].sum()))
    order = np.argsort(out["i_category_name"])
    return {"i_category_name": np.asarray(out["i_category_name"], np.int32)[order],
            "n": np.asarray(out["n"], np.int32)[order],
            "w": np.asarray(out["w"], np.float32)[order],
            "cls": np.asarray(out["cls"], np.int32)[order]}


def max_rel(got: dict, want: dict, cols) -> float:
    """The largest |got - want| / |want| over the float columns ``cols``."""
    return max(float(np.max(np.abs(got[c].astype(np.float64) - want[c])
                            / np.abs(want[c].astype(np.float64))))
               for c in cols)


def per_channel(code: np.ndarray, cols: dict) -> tuple[np.ndarray, dict]:
    """The channels with rows (code >= 0) and, per column, its float64 sum
    per channel."""
    ok = code >= 0
    n = np.bincount(code[ok], minlength=3)
    keys = np.flatnonzero(n)
    return keys.astype(np.int32), {
        c: np.bincount(code[ok], weights=np.asarray(v)[ok].astype(np.float64),
                       minlength=3)[keys] for c, v in cols.items()}


def frame_path(torch, hf, synth, queries: dict, profile_dir: str | None = None,
               checks: dict | None = None, sf: int = FRAME_SCALE):
    """The frame path at P = 1: Q05 over string category names (its plan
    the int-category Q05's), the Q09 channel rollup, the frame, null and
    dtype verbs, the null-row filter, a concat that recodes its parts'
    dictionaries and a merge on category keys; every query against numpy.
    Host-side ingest (dictionary encoding) is timed apart from the
    queries."""
    run = query_runner(torch, hf, queries, profile_dir)
    checks = {} if checks is None else checks
    cfg = hf.ExecConfig()
    wcs, itx, ssx = frame_tables(synth, sf)
    n_sales = len(ssx["ss_channel"])
    ingest = {}
    t0 = time.perf_counter()
    wcs_df, itx_df = hf.table(wcs, "wcs"), hf.table(itx, "itx")
    ingest["wcs_itx_s"] = round(time.perf_counter() - t0, 4)
    t0 = time.perf_counter()
    ss_df = hf.table(ssx, "ssx")
    ingest["ssx_s"] = round(time.perf_counter() - t0, 4)
    code = channel_codes(ssx["ss_channel"], synth)
    assert np.array_equal(ss_df.node.columns["ss_channel"], code)

    # q05_string: the string predicates plan as the int-category Q05's
    names = list(synth.CATEGORY_NAMES)
    itx_int = {k: v for k, v in itx.items() if k != "i_category_name"}
    itx_int["i_category_name"] = (itx["i_category_id"] - 1).astype(np.int32)
    frame = q05_frame(wcs_df, itx_df, "books", ["electronics", "music"])
    plans = [f.physical_plan(cfg) for f in (frame, q05_frame(
        wcs_df, hf.table(itx_int, "itx"), names.index("books"),
        [names.index("electronics"), names.index("music")]))]
    got = [(p.counts(), p.shuffle_census(P=2), p.shuffle_row_bytes())
           for p in plans]
    assert got[0] == got[1], f"q05_string plans {got[0]}, int {got[1]}"
    out = run("q05_string", frame)
    check_equal(out, q05_want(wcs, itx, synth), "q05_string")
    queries["q05_string"]["rows_in"] = len(wcs["wcs_user_sk"]) \
        + len(itx["i_item_sk"])
    queries["q05_string"]["plan_like_int"] = True

    # q09_channel: the web and catalog codes, skipna over the discount
    out = run("q09_channel", q09_channel_frame(ss_df))
    disc = ssx["ss_discount"]
    ok = ~np.isnan(disc)
    sel = np.where((code == 0) | (code == 2), code, -1)
    keys, s = per_channel(sel, {"revenue": ssx["ss_net_paid"],
                                "disc": np.where(ok, disc, 0), "n_disc": ok,
                                "n": np.ones(n_sales)})
    tol = {"revenue": (1e-4, 1e-2), "avg_disc": (1e-4, 1e-5)}
    want = {"ss_channel": keys, "revenue": s["revenue"].astype(np.float32),
            "avg_disc": (s["disc"] / s["n_disc"]).astype(np.float32),
            "n_disc": s["n_disc"].astype(np.int32),
            "n": s["n"].astype(np.int32)}
    check_equal(out, want, "q09_channel", tol)
    checks["q09_channel_max_rel"] = max_rel(out, want, tol)
    queries["q09_channel"]["rows_in"] = n_sales

    # frame_verbs: dropna -> fillna -> assign -> astype -> rename -> drop,
    # a string-predicate column, and the group-by on the renamed channel
    out = run("frame_verbs", frame_verbs_frame(ss_df))
    net = ssx["ss_net_paid"] - np.where(ok, disc, np.float32(0))
    keys, s = per_channel(code, {
        "net": net, "n": np.ones(n_sales), "web": code == 2,
        "cust": ssx["ss_customer_sk"].astype(np.float32)})
    tol = {"net": (1e-4, 1e-2), "cust": (1e-4, 1e-2)}
    want = {"channel": keys, "net": s["net"].astype(np.float32),
            "cust": (s["cust"] / s["n"]).astype(np.float32),
            "web": s["web"].astype(np.int32), "n": s["n"].astype(np.int32)}
    check_equal(out, want, "frame_verbs", tol)
    checks["frame_verbs_max_rel"] = max_rel(out, want, tol)
    queries["frame_verbs"]["rows_in"] = n_sales

    out = run("null_rows", null_rows_frame(ss_df))
    want = ssx["ss_ticket_number"][(code < 0) | ~ok]
    check_equal({"ss_ticket_number": np.sort(out["ss_ticket_number"])},
                {"ss_ticket_number": np.sort(want)}, "null_rows")
    queries["null_rows"]["rows_in"] = n_sales
    del out, want, net, sel, disc, ok

    # concat_channels: the first half's dictionary (2 names, no null)
    # differs from the second's
    a, b = sales_halves(ssx, code)
    t0 = time.perf_counter()
    parts = (hf.table(a, "a"), hf.table(b, "b"))
    ingest["concat_halves_s"] = round(time.perf_counter() - t0, 4)
    assert parts[0].schema["ss_channel"] != parts[1].schema["ss_channel"]
    out = run("concat_channels", concat_channels_frame(hf, *parts))
    cc = channel_codes(np.concatenate([a["ss_channel"], b["ss_channel"]]),
                       synth)
    paid = np.concatenate([a["ss_net_paid"], b["ss_net_paid"]])
    keys, s = per_channel(cc, {"n": np.ones(len(cc)), "revenue": paid})
    want = {"ss_channel": keys, "n": s["n"].astype(np.int32),
            "revenue": s["revenue"].astype(np.float32)}
    check_equal(out, want, "concat_channels", {"revenue": (1e-4, 1e-2)})
    checks["concat_channels_max_rel"] = max_rel(out, want, ("revenue",))
    queries["concat_channels"]["rows_in"] = len(cc)
    del a, b, parts, cc, paid

    # merge_category_keys: the item table's 8 names against a dimension
    # of 6 (4 shared), both recoded onto the union dictionary
    dim = category_dim()
    frame = merge_category_frame(itx_df, hf.table(dim, "cdim"))
    union = tuple(sorted(set(synth.CATEGORY_NAMES) | set(FRAME_DIM_NAMES)))
    assert frame.schema["i_category_name"].categories == union
    out = run("merge_category_keys", frame)
    check_equal(out, merge_category_want(itx, dim, synth),
                "merge_category_keys")
    queries["merge_category_keys"]["rows_in"] = len(itx["i_item_sk"]) \
        + len(FRAME_DIM_NAMES)
    queries["frame_ingest"] = ingest
    log(f"frame ingest (host dictionary encoding): {ingest}")


# The exchange path: two ranks on the one card, joined by gloo (NCCL refuses
# two ranks on one card; gloo stages CUDA tensors through the host, so the
# walls are gloo's, not NCCL's).  Fig. 8a join at a quarter of the
# relational path's rows, cut for that staging, and Q26 at its scale.
P2_JOIN = (2**24, 2**20)
P2_WORLD = 2


P2_SORT = 2**24


def exchange_rank(rank: int, world: int, port: int, out_dir: str) -> None:
    """One rank of the exchange path (started by torch.multiprocessing):
    the queries through ``hf`` on the card at P = world, each with the
    all_to_all calls counted against the plan's census; rank 0 holds the
    rows against the numpy oracles.  Writes its walls, counts and launches
    to out_dir."""
    import torch
    import torch.distributed as dist
    from scipy.stats import rankdata

    from repro_torch import hiframes as hf
    from repro_torch.core import ir
    from repro_torch.data import synth
    from repro_torch.kernels import cuda

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    calls = [0]
    a2a = dist.all_to_all_single

    def counted(*a, **k):
        calls[0] += 1
        return a2a(*a, **k)
    dist.all_to_all_single = counted
    cfg = hf.ExecConfig()          # the card
    left, right = join_tables(*P2_JOIN)
    ss, it, n_cust = q26_tables(synth)
    t8a = synth.relational_tables(P2_SORT, 1000, seed=0)
    x = synth.series(P2_SORT, seed=3)
    wcs, itx, _ = frame_tables(synth)
    cdim = category_dim()

    def as_rows(key, want):
        def check(tag, out, t):
            check_equal(sorted_rows(out, key), sorted_rows(want(), key), tag)
        return check

    def check_sort(tag, out, t):
        # the rank-concatenated rows are the input's in stable order, and
        # each rank took at least a quarter of them: the splitters split
        order = stable_order(t8a["x"])
        check_equal(out, {k: v[order] for k, v in t8a.items()}, tag)
        assert int(t.counts.min()) >= P2_SORT // 4, \
            f"{tag}: {t.counts.tolist()}"

    def check_rank(tag, out, t):
        xs = np.sort(x)
        assert np.array_equal(out["x"], xs), f"{tag}.x"
        assert np.array_equal(out["r"], rankdata(xs.astype(np.float64),
                                                 method="min")), tag

    def check_sma(tag, out, t):
        xf = x[x > np.float32(0)]
        assert np.array_equal(out["x"], xf), f"{tag}.x"
        check_close(tag, out["s"], stencil_f32(xf, [1.0 / 3] * 3, 1),
                    1e-6, 1e-6)

    q26_rows = len(ss["ss_item_sk"]) + len(it["i_item_sk"])
    runs = {"p2_fig8a_join": (
                lambda: hf.join(hf.table(left, "l"), hf.table(right, "r"),
                                on=("id", "cid")),
                as_rows(("id", "x"), lambda: join_want(left, right)),
                sum(P2_JOIN)),
            "p2_fig11_q26": (lambda: q26(hf, ss, it),
                             as_rows(("ss_customer_sk",),
                                     lambda: q26_want(ss, it, n_cust)),
                             q26_rows),
            "p2_sort": (lambda: hf.table(t8a).sort_values("x"), check_sort,
                        P2_SORT),
            "p2_global_rank": (lambda: global_rank_frame(hf, x, ("rank",)),
                               check_rank, P2_SORT),
            "p2_sma_after_filter": (lambda: sma_after_filter_frame(hf, x),
                                    check_sma, P2_SORT),
            "p2_fig12_q26_cold": (
                lambda: q26_fluent(hf.table(ss, "ss"), hf.table(it, "it")),
                as_rows(("ss_customer_sk",), lambda: q26_want(ss, it, n_cust)),
                q26_rows),
            "p2_fig12_q26_persisted": (
                lambda: q26_fluent(hf.table(ss, "ss"),
                                   persisted_dim(hf, it, cfg)),
                as_rows(("ss_customer_sk",), lambda: q26_want(ss, it, n_cust)),
                q26_rows),
            # each rank encodes the whole host table itself
            "p2_q05_string": (
                lambda: q05_frame(hf.table(wcs, "wcs"), hf.table(itx, "itx"),
                                  "books", ["electronics", "music"]),
                as_rows(("wcs_user_sk",), lambda: q05_want(wcs, itx, synth)),
                len(wcs["wcs_user_sk"]) + len(itx["i_item_sk"])),
            "p2_merge_category_keys": (
                lambda: merge_category_frame(hf.table(itx, "itx"),
                                             hf.table(cdim, "cdim")),
                as_rows(("i_category_name",),
                        lambda: merge_category_want(itx, cdim, synth)),
                len(itx["i_item_sk"]) + len(FRAME_DIM_NAMES))}
    res = {"rank": rank, "queries": {}}
    torch.cuda.synchronize()
    cuda.reset_launches()
    for tag, (build, check, rows_in) in runs.items():
        frame = build()
        calls[0] = 0
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        t = frame.collect(cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        assert not t.overflow, f"{tag}: capacity overflow {t.overflow_ops}"
        out = t.to_numpy()
        census = frame.physical_plan(cfg).shuffle_census(P=world)["all_to_all"]
        assert calls[0] == census, f"{tag}: {calls[0]} all_to_all, census {census}"
        if rank == 0:
            check(tag, out, t)
        # every dictionary of the plan, inputs and recodings included
        dicts = sorted({dt.categories for n in ir.topo_order(frame.node)
                        for dt in n.schema.values()
                        if getattr(dt, "categories", None) is not None})
        res["queries"][tag] = {
            "dictionaries": hashlib.sha256(repr(dicts).encode()).hexdigest()[:16],
            "wall_s": round(wall, 4), "rows_in": rows_in,
            "rows_out": int(len(next(iter(out.values())))),
            "rows_by_rank": t.counts.cpu().tolist(),
            "all_to_all": calls[0], "census": census, "nshards": t.nshards}
    q = res["queries"]
    assert q["p2_fig12_q26_persisted"]["all_to_all"] \
        < q["p2_fig12_q26_cold"]["all_to_all"], q
    torch.cuda.synchronize()
    res["launches"] = dict(cuda.launches)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()


def exchange_path(torch, queries: dict) -> dict:
    """The exchange path: P2_WORLD processes on the one card, each running
    ``exchange_rank``; bucket_scatter must have launched in every rank.
    Returns the launch counts summed over the ranks."""
    import socket
    import tempfile

    import torch.multiprocessing as mp
    torch.cuda.empty_cache()       # leave the card's memory to the ranks
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    with tempfile.TemporaryDirectory() as out_dir:
        mp.spawn(exchange_rank, args=(P2_WORLD, port, out_dir),
                 nprocs=P2_WORLD, join=True)
        ranks = []
        for r in range(P2_WORLD):
            with open(os.path.join(out_dir, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    for r in ranks:
        assert r["launches"]["bucket_scatter"] > 0, \
            f"bucket_scatter never launched in rank {r['rank']}"
    for tag in ranks[0]["queries"]:
        per = [r["queries"][tag] for r in ranks]
        # the same codes on every rank, so recoded keys hash alike
        assert len({q["dictionaries"] for q in per}) == 1, (tag, per)
        queries[tag] = {**per[0], "wall_s_by_rank": [q["wall_s"] for q in per],
                        "wall_s": max(q["wall_s"] for q in per),
                        "transport": f"gloo over tcp://localhost, {P2_WORLD} "
                                     f"ranks on one card (host staging)"}
        log(f"{tag}: {queries[tag]}")
    queries["exchange_p2_launches_by_rank"] = [r["launches"] for r in ranks]
    return {k: sum(r["launches"][k] for r in ranks) for k in ranks[0]["launches"]}


def lm_serve(torch, cfg, keep: list, seed: int = 0) -> dict:
    """Serve ``cfg`` as examples/serve_lm.py does, through the port's entry
    points (launch/steps.py): random weights from ``seed`` on the card,
    LM_BATCH prompts of LM_PROMPT token ids from numpy, one prefill into a
    cache of LM_PROMPT + LM_NEW rows, then LM_NEW greedy decode steps.
    Returns timings, the tokens, and the logits of requests ``keep`` at the
    prefill's last position and at every decode step."""
    from repro_torch.launch import steps
    from repro_torch.models import lm

    dev = torch.device("cuda")
    b, s, t = LM_BATCH, LM_PROMPT, LM_NEW
    model = lm.init_params(cfg, seed=seed, device=dev)
    prompts = np.random.default_rng(seed).integers(0, cfg.vocab, (b, s))
    tokens = torch.from_numpy(prompts.astype(np.int32)).to(dev)
    prefill = steps.make_prefill_step(cfg, s + t)
    step = steps.make_decode_step(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    logits, caches = prefill(model, {"tokens": tokens})
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    peak_prefill = torch.cuda.max_memory_allocated()
    kept, gen = [logits[keep]], []
    tok = logits.argmax(-1)[:, None].to(torch.int32)
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(t + 1)]
    t0 = time.perf_counter()
    for i in range(t):
        marks[i].record()
        gen.append(tok)
        logits, caches = step(model, tok, caches)
        kept.append(logits[keep])
        tok = logits.argmax(-1)[:, None].to(torch.int32)
    marks[t].record()
    torch.cuda.synchronize()
    t_decode = time.perf_counter() - t0
    step_ms = [marks[i].elapsed_time(marks[i + 1]) for i in range(t)]
    assert caches["host_index"] == s + t
    assert bool((caches["layers"]["index"] == s + t).all())
    return {"model": model, "tokens": tokens, "gen": torch.cat(gen, 1),
            "kept": torch.stack(kept, 1), "keep": keep,
            "stats": {
                "prefill_ms": round(t_prefill * 1e3, 3),
                "prefill_tok_s": round(b * s / t_prefill, 1),
                "decode_ms": round(t_decode * 1e3, 3),
                "decode_step_median_ms": round(float(np.median(step_ms)), 4),
                "decode_step_min_ms": round(float(np.min(step_ms)), 4),
                "decode_tok_s": round(b * t / t_decode, 1),
                "peak_prefill_gib": round(peak_prefill / 2**30, 3),
                "peak_gib": round(torch.cuda.max_memory_allocated() / 2**30, 3)}}


def lm_against_full_forward(torch, cfg, run: dict) -> float:
    """The served logits of the kept requests (the prefill's last position
    and every decode step) against the port's own no-cache full forward
    over prompt + generated tokens; the largest absolute difference.  Also
    holds the outputs' shapes, finiteness and token range."""
    from repro_torch.models import lm

    keep, gen, kept = run["keep"], run["gen"], run["kept"]
    assert gen.shape == (LM_BATCH, LM_NEW)
    assert bool(((gen >= 0) & (gen < cfg.vocab)).all())
    assert kept.shape == (len(keep), LM_NEW + 1, cfg.vocab)
    assert bool(torch.isfinite(kept.float()).all())
    seq = torch.cat([run["tokens"][keep], gen[keep]], 1)
    full = lm.forward(run["model"], seq, cfg)[0]
    want = full[:, LM_PROMPT - 1:]
    assert bool(torch.isfinite(want.float()).all())
    return float((kept.float() - want.float()).abs().max())


def lm_path(torch, queries: dict, runs: dict):
    """The LM serving path: qwen3-0.6b as published (bf16 weights and
    compute, 28 layers), random weights, requests 0 and LM_BATCH - 1 kept
    for the checks after the path."""
    from repro_torch.configs import get_config
    cfg = get_config(LM_ARCH)
    run = lm_serve(torch, cfg, keep=[0, LM_BATCH - 1])
    queries["lm_serve"] = {"model": cfg.name, "requests": LM_BATCH,
                           "prompt_tokens": LM_PROMPT, "new_tokens": LM_NEW,
                           **run["stats"]}
    log(f"lm_serve: {queries['lm_serve']}")
    runs["lm"] = run


def lm_checks(torch, run: dict, queries: dict, checks: dict,
              profile_dir: str | None):
    """After the counted path: (a) its bf16 logits against the no-cache
    forward within 0.1 (the reference's own bound for its bf16 decode path,
    tests/test_kernels_decode_attention.py:67); with ``profile_dir``, a
    profile of a few decode steps; (b) the same path at qwen3-0.6b's widths
    with 2 layers in float32 within 1e-3."""
    from repro_torch.configs import get_config
    from repro_torch.launch import steps

    cfg = get_config(LM_ARCH)
    d = lm_against_full_forward(torch, cfg, run)
    checks["lm_bf16_28l_vs_full_forward"] = d
    assert d <= 0.1, f"lm bf16: decode logits differ from the full forward by {d}"
    log(f"lm bf16, {cfg.n_layers} layers: max |decode - full forward| = {d}")
    if profile_dir:
        # a fresh prefill, 4 warm decode steps, then 4 profiled ones
        model, tokens = run["model"], run["tokens"]
        logits, caches = steps.make_prefill_step(cfg, LM_PROMPT + 8)(
            model, {"tokens": tokens})
        step = steps.make_decode_step(cfg)
        tok = logits.argmax(-1)[:, None].to(torch.int32)
        state = {"tok": tok, "caches": caches}

        def decode(n):
            for _ in range(n):
                lg, state["caches"] = step(model, state["tok"], state["caches"])
                state["tok"] = lg.argmax(-1)[:, None].to(torch.int32)
        decode(4)
        prof = profile_run(torch, lambda: decode(4),
                           os.path.join(profile_dir, "profile_lm_decode.txt"))
        queries["lm_serve"]["profile_4_decode_steps"] = prof
        log(f"lm decode profile (4 steps): {prof}")
        del state, caches, logits
    run.clear()
    torch.cuda.empty_cache()

    cfg32 = cfg.replace(n_layers=2, param_dtype="float32",
                        compute_dtype="float32")
    run32 = lm_serve(torch, cfg32, keep=[0, LM_BATCH - 1], seed=1)
    d = lm_against_full_forward(torch, cfg32, run32)
    checks["lm_f32_2l_vs_full_forward"] = d
    queries["lm_serve_f32_2l"] = run32["stats"]
    assert d <= 1e-3, f"lm float32: decode logits differ from the full forward by {d}"
    log(f"lm float32, 2 layers: max |decode - full forward| = {d}; "
        f"{run32['stats']}")
    run32.clear()
    torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--profile", metavar="DIR", default=None)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(here, "src"))
    try:
        from repro_torch import hiframes as hf
        from repro_torch.configs import get_config
        from repro_torch.data import synth
        from repro_torch.kernels import cuda
    except ImportError as e:
        print(f"chip_smoke: run from the root of a checkout ({e})",
              file=sys.stderr)
        return 3

    # phase 1: report and build
    smi = nvidia_smi_line()
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    secs, ptxas = cuda.build_all(force=True, verbose=args.quick)
    log(f"kernel build: {secs:.1f} s for {len(cuda.SOURCES)} sources")
    if args.quick:
        log(ptxas)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")

    # phase 2: kernels against their plain versions
    sizes = [0, 1, 2047, 2048, 2049, 1_000_003]
    if not args.quick:
        sizes.append(1 << 27)
    record: dict = {}
    profiled = one_call_profiles(torch, sizes[-2])
    kernel_phases(torch, sizes, record)
    window_kernel_phases(torch, sizes, record)
    decode_attention_phases(torch, record)
    for name, seen in profiled.items():
        record[name]["one_call"] = seen
    torch.cuda.synchronize()
    for r in record.values():
        log(f"{r['name']} [{r['shape']}]: kernel {r['ms']:.3f} ms, plain "
            f"{r['plain_ms']:.3f} ms, library {r['library_ms']}, bound "
            f"{r['bound_ms']:.3f} ms ({r['bound_by']})")

    queries: dict = {}
    checks: dict = {}
    if not args.quick:
        # phase 3: the main paths, each with the counters zeroed just
        # before it and read just after
        if args.profile:
            os.makedirs(args.profile, exist_ok=True)
        # kernels each path must launch: None for at least once, a number
        # for exactly that many (the LM path: one per layer and decode step)
        lm_runs: dict = {}
        paths = {
            "relational": (lambda: main_path(torch, hf, synth, queries,
                                             args.profile, checks),
                           dict.fromkeys(("prefix_sum", "segment_sums"))),
            "windows": (lambda: window_path(torch, hf, synth, queries,
                                            args.profile, checks),
                        dict.fromkeys(("prefix_sum", "segment_scan",
                                       "segment_rank", "stencil1d",
                                       "stencil1d_exact", "segment_stencil"))),
            "sort": (lambda: sort_path(torch, hf, synth, queries,
                                       args.profile, checks),
                     dict.fromkeys(("prefix_sum", "segment_sums",
                                    "stencil1d"))),
            "frame": (lambda: frame_path(torch, hf, synth, queries,
                                         args.profile, checks),
                      dict.fromkeys(("prefix_sum", "segment_sums"))),
            # counted in its ranks (each must launch bucket_scatter) and
            # summed over them; Q26's sums are integer (no segment_sums)
            "exchange_p2": (lambda: exchange_path(torch, queries),
                            dict.fromkeys(("bucket_scatter", "prefix_sum"))),
            "lm": (lambda: lm_path(torch, queries, lm_runs),
                   {"decode_attention": get_config(LM_ARCH).n_layers * LM_NEW})}
        launched = {}
        for path, (drive, must) in paths.items():
            t0 = time.perf_counter()
            cuda.reset_launches()
            counted = drive()
            torch.cuda.synchronize()
            launched[path] = counted or dict(cuda.launches)
            log(f"{path} path: {time.perf_counter() - t0:.1f} s, launches "
                f"{launched[path]}")
            for name, count in must.items():
                assert launched[path][name] > 0, \
                    f"{name} never launched on the {path} path"
                assert count is None or launched[path][name] == count, \
                    f"{name}: {launched[path][name]} launches on the {path} " \
                    f"path, expected {count}"
        t0 = time.perf_counter()
        lm_checks(torch, lm_runs["lm"], queries, checks, args.profile)
        log(f"lm checks: {time.perf_counter() - t0:.1f} s")
        log(f"checks (max abs diff; bitwise): {checks}")
        for r in record.values():
            by_path = {p: c[r["name"]] for p, c in launched.items()}
            r["launches"] = sum(by_path.values())
            r["launches_by_path"] = by_path
    assert "jax" not in sys.modules and "repro" not in sys.modules

    # phase 4: report
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kern = [{**{k: r.get(k) for k in keys},
             **{k: v for k, v in r.items() if k not in keys}}
            for r in record.values()]
    log(json.dumps({"queries": queries, "checks": checks, "card": smi}))
    log(json.dumps({"kernels": kern}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
