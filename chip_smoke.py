"""End-to-end smoke run of the PyTorch/CUDA package on one NVIDIA card.

    python3 chip_smoke.py            # from the root of a checkout

Phases, in order; any failure raises and the exit code is not 0:

1. Report and build: the card's name and power limit, the nvcc build of
   every kernel in ``src/repro_torch/csrc`` (one process per source, in
   parallel), TF32 off for matmuls and cuDNN.
2. Kernel phases: each hand-written kernel against its plain PyTorch
   version on the card, at sizes 0 .. 2^27, then timed with CUDA events
   (median of 15) beside the plain version, one PyTorch library call where
   there is one, and its bound (bytes moved / 3.35 TB/s).
3. The relational main path through ``hf`` at P = 1: Fig. 8a filter, join
   and aggregate and TPCx-BB Q26 / Q26-multikey, each checked against a
   vectorised numpy oracle.  The launch counters are zeroed just before and
   read just after; prefix_sum and segment_sums must have launched.
   (bucket_scatter runs only in exchanges at P > 1, which one card cannot
   host; phase 2 holds it.)
4. Report: one JSON line of kernel records, query wall times and peak
   memory, and a last line ``{"ok": true, "device": {...}}``.

``--quick`` stops after phase 2 at sizes up to 1_000_003 and prints ptxas's
register and shared-memory report: a short first check of new kernels.
``--profile DIR`` runs every query a second time under ``torch.profiler``
and writes its per-op device-time table to ``DIR/profile_<query>.txt``.
"""
from __future__ import annotations

import argparse
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
    """Median milliseconds of ``fn()`` over REPEATS runs (CUDA events),
    after one warm-up run."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPEATS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def bound_ms(bytes_moved: float, ops: float) -> tuple[float, str]:
    tb, to = bytes_moved / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def kernel_phases(torch, sizes, record: dict):
    from repro_torch.kernels import cuda
    from repro_torch.kernels.hash_partition import hash_partition as hp
    from repro_torch.kernels.segment_reduce import segment_reduce as sr
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
    n = sizes[-1]
    xi = (torch.rand(n, device=dev, generator=g) < 0.5).to(torch.int32)
    rec = {"name": "prefix_sum", "route": "cuda",
           "source": "src/repro_torch/csrc/prefix_sum.cu",
           "replaces": "src/repro/kernels/stream_compact/stream_compact.py:36",
           "shape": f"int32 keep flags, n={n}", "max_abs_err": err,
           "ms": time_ms(lambda: sc.prefix_sum_cuda(xi), torch),
           "plain_ms": time_ms(lambda: sc.prefix_sum_plain(xi), torch),
           "library_ms": time_ms(
               lambda: torch.cumsum(xi, 0, dtype=torch.int32), torch),
           "library_call": "torch.cumsum(dtype=torch.int32)"}
    rec["bound_ms"], rec["bound_by"] = bound_ms(8.0 * n, n)
    record["prefix_sum"] = rec
    del xi

    # -- bucket_scatter: ranks exact where dest < P, counts exact.
    err = 0
    for P in (2, 8, 256):
        for n in sizes:
            dest = torch.randint(0, P + 1, (n,), device=dev, generator=g,
                                 dtype=torch.int32)        # P = invalid row
            r1, c1 = hp.bucket_scatter_cuda(dest, P)
            r2, c2 = hp.bucket_scatter_plain(dest, P)
            ok = dest < P
            assert torch.equal(c1, c2), f"bucket_scatter counts P={P} n={n}"
            assert torch.equal(r1[ok], r2[ok]), f"bucket_scatter P={P} n={n}"
            err = max(err, int((c1 - c2).abs().max()))
            if bool(ok.any()):
                err = max(err, int((r1[ok] - r2[ok]).abs().max()))
        log(f"bucket_scatter P={P}: ok at sizes {sizes}")
    n, P = sizes[-1], 256
    dest = torch.randint(0, P, (n,), device=dev, generator=g, dtype=torch.int32)
    rec = {"name": "bucket_scatter", "route": "cuda",
           "source": "src/repro_torch/csrc/bucket_scatter.cu",
           "replaces": "src/repro/kernels/hash_partition/hash_partition.py:44",
           "shape": f"int32 dest, n={n}, P={P}", "max_abs_err": float(err),
           "ms": time_ms(lambda: hp.bucket_scatter_cuda(dest, P), torch),
           "plain_ms": time_ms(lambda: hp.bucket_scatter_plain(dest, P), torch),
           "library_ms": None, "library_call": None,
           "main_path": "exchange at P > 1 only; not run at P = 1"}
    rec["bound_ms"], rec["bound_by"] = bound_ms(8.0 * n + 4 * P, n)
    record["bucket_scatter"] = rec
    del dest

    # -- segment_sums: every slot within 1e-4 of the segment's sum of |x|
    # (+1e-5); slots past the last segment exactly 0.
    def check_sums(vals, seg, valid, num, n_seg, tag) -> float:
        got = sr.segment_sums_cuda(vals, seg, valid, num)
        want = sr.segment_sums_plain(vals, seg, valid, num)
        mag = sr.segment_sums_plain(vals.abs(), seg, valid, num)
        d = (got - want).abs()
        assert bool((d <= 1e-4 * mag + 1e-5).all()), f"segment_sums {tag}"
        assert bool((got[n_seg:] == 0).all()), f"segment_sums {tag} tail"
        return float(d.max()) if num else 0.0

    err = 0.0
    for groups in (4096, 1 << 20):
        for n in sizes:
            seg = torch.sort(torch.randint(0, max(groups, 1), (n,), device=dev,
                                           generator=g)).values
            # renumber to consecutive ids, like segment_aggregate's seg_id
            head = torch.ones(n, dtype=torch.bool, device=dev)
            head[1:] = seg[1:] != seg[:-1]
            seg = (torch.cumsum(head.int(), 0, dtype=torch.int32) - 1)
            n_seg = int(seg[-1]) + 1 if n else 0
            valid = torch.rand(n, device=dev, generator=g) < 0.9
            vals = torch.randn(n, device=dev, generator=g)
            err = max(err, check_sums(vals, seg, valid, n_seg + 7, n_seg,
                                      f"groups={groups} n={n}"))
        log(f"segment_sums groups={groups}: ok at sizes {sizes}")
    # The main path's shapes, num_segments = cap_out = n.  The final stage
    # of the aggregate (segment_aggregate after the exchange) sees a sorted
    # prefix of 4096 partial rows, one per group, then padding rows whose
    # seg_id is num_segments, which the kernel must drop: the padding is
    # tried invalid, as the main path gives it, and valid, so that only its
    # id drops it.
    n, groups = sizes[-1], 4096
    num = n
    seg = torch.full((n,), num, dtype=torch.int32, device=dev)
    seg[:groups] = torch.arange(groups, dtype=torch.int32, device=dev)
    vals = torch.randn(n, device=dev, generator=g)
    prefix = torch.arange(n, device=dev) < groups
    for pad_valid in (False, True):
        valid = prefix | pad_valid
        err = max(err, check_sums(vals, seg, valid, num, groups,
                                  f"final stage n={n} pad_valid={pad_valid}"))
    log(f"segment_sums final-stage shape n={n}: ok")
    # the partial stage: n sorted rows of 4096 groups; also the timed inputs
    seg = (torch.arange(n, device=dev, dtype=torch.int64) * groups // n
           ).to(torch.int32)
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    err = max(err, check_sums(vals, seg, valid, num, groups,
                              f"partial stage n={n}"))
    log(f"segment_sums partial-stage shape n={n}: ok")
    del prefix
    idx = seg.long()
    rec = {"name": "segment_sums", "route": "cuda",
           "source": "src/repro_torch/csrc/segment_sums.cu",
           "replaces": "src/repro/kernels/segment_reduce/segment_reduce.py:33",
           "shape": f"f32 values, n={n}, {groups} groups, num_segments={num}",
           "max_abs_err": err,
           "ms": time_ms(lambda: sr.segment_sums_cuda(vals, seg, valid, num),
                         torch),
           "plain_ms": time_ms(
               lambda: sr.segment_sums_plain(vals, seg, valid, num), torch),
           "library_ms": time_ms(
               lambda: torch.zeros(num, device=dev).index_add_(0, idx, vals),
               torch),
           "library_call": "Tensor.index_add_"}
    rec["bound_ms"], rec["bound_by"] = bound_ms(9.0 * n + 4.0 * num, n)
    record["segment_sums"] = rec
    del seg, valid, vals, idx
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


def profile_query(torch, frame, cfg, path: str) -> dict:
    """Run ``frame`` once under torch.profiler; write the per-op table to
    ``path`` and return device-time totals in ms: kernels, copies, wall."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        frame.collect(cfg)
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


def main_path(torch, hf, synth, queries: dict, profile_dir: str | None = None):
    cfg = hf.ExecConfig()          # the card
    n8a = 2**27

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
            prof = profile_query(torch, frame, cfg, os.path.join(
                profile_dir, f"profile_{tag}.txt"))
            queries[tag]["profile"] = prof
            log(f"{tag} profile: {prof}")
        return out

    # Fig. 8a filter (bench_relational.py:27)
    t = synth.relational_tables(n8a, 1000, seed=0)
    df = hf.table(t)
    out = run("fig8a_filter", df[df.x < 0.5])
    m = t["x"] < np.float32(0.5)
    check_equal(out, {k: v[m] for k, v in t.items()}, "filter")
    queries["fig8a_filter"]["rows_in"] = n8a
    del t, df, out, m

    # Fig. 8a join (bench_relational.py:43): 2^26 left rows, 2^22 right
    n_left, n_right = 2**26, 2**22
    rng = np.random.default_rng(1)
    left = {"id": rng.integers(0, n_right, n_left).astype(np.int32),
            "x": rng.normal(size=n_left).astype(np.float32)}
    right = {"cid": np.arange(n_right, dtype=np.int32),
             "w": rng.normal(size=n_right).astype(np.float32)}
    out = run("fig8a_join", hf.join(hf.table(left, "l"), hf.table(right, "r"),
                                     on=("id", "cid")))
    # every left row matches right row id (cid is arange); left order kept
    check_equal(out, {"id": left["id"], "x": left["x"],
                      "w": right["w"][left["id"]]}, "join")
    queries["fig8a_join"]["rows_in"] = n_left + n_right
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
    queries["fig8a_aggregate"]["rows_in"] = n8a
    del t, df, out

    # TPCx-BB Q26 at scale 64 of bench_tpcx.run (bench_tpcx.py:126)
    sf = 64
    n_sales, n_items, n_cust = 400_000 * sf, 20_000 * sf, 50_000 * sf
    ss = synth.store_sales(n_sales, n_items, n_cust, seed=10)
    it = synth.item(n_items, seed=11)
    out = run("fig11_q26", q26(hf, ss, it))
    cls = it["i_class_id"][ss["ss_item_sk"]]
    cust = ss["ss_customer_sk"]
    n_c = np.bincount(cust, minlength=n_cust)
    want = {"ss_customer_sk": np.flatnonzero(n_c > 4).astype(np.int32)}
    k = want["ss_customer_sk"]
    want["c_i_count"] = n_c[k].astype(np.int32)
    for c in (1, 2, 3):
        want[f"id{c}"] = np.bincount(cust, weights=(cls == c),
                                     minlength=n_cust)[k].astype(np.int32)
    check_equal(out, want, "q26")
    queries["fig11_q26"]["rows_in"] = n_sales + n_items
    del out, cls, cust

    ssr, dim = region_tables(ss, it)
    out = run("fig11_q26_multikey", q26_multikey(hf, ssr, dim))
    key = ssr["ss_item_sk"].astype(np.int64) * 4 + ssr["ss_region"]
    nk = n_items * 4
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
    kernel_phases(torch, sizes, record)
    torch.cuda.synchronize()
    for r in record.values():
        log(f"{r['name']} [{r['shape']}]: kernel {r['ms']:.3f} ms, plain "
            f"{r['plain_ms']:.3f} ms, library {r['library_ms']}, bound "
            f"{r['bound_ms']:.3f} ms ({r['bound_by']})")

    queries: dict = {}
    if not args.quick:
        # phase 3: the main path, counters zeroed just before
        cuda.reset_launches()
        if args.profile:
            os.makedirs(args.profile, exist_ok=True)
        main_path(torch, hf, synth, queries, args.profile)
        torch.cuda.synchronize()
        launched = dict(cuda.launches)
        log(f"main-path launches: {launched}")
        for name in ("prefix_sum", "segment_sums"):
            assert launched[name] > 0, f"{name} never launched on the main path"
        for r in record.values():
            r["launches"] = launched[r["name"]]
    assert "jax" not in sys.modules and "repro" not in sys.modules

    # phase 4: report
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kern = [{**{k: r.get(k) for k in keys},
             **{k: v for k, v in r.items() if k not in keys}}
            for r in record.values()]
    log(json.dumps({"queries": queries, "card": smi}))
    log(json.dumps({"kernels": kern}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
