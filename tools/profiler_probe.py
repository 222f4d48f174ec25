"""Find when torch.profiler loses the device events of a single call:

    python tools/profiler_probe.py [--out DIR] [--quick]
                                   [--idle SECONDS [--delay SECONDS]]

Takes single-call traces of ``prefix_sum`` and ``segment_rank`` (rank) the
way ``chip_smoke.py`` gates them (``chip_smoke.traced``: one call between
two margins, here 20 ms and 500 ms) at four points of one process: at the
start, after ``chip_smoke.py``'s kernel checks of the relational kernels
(``kernel_phases``), after those of the window kernels
(``window_kernel_phases``), and after 30 s idle.  With ``--idle`` it runs
no checks and takes one pair of traces every 5 s for that long instead,
the first ``--delay`` seconds after the card was first used.
For each trace it prints one JSON line: seconds since the start, the
margin, the device events ``key_averages`` shows, and from the exported
Chrome trace the kernels, memsets and launch calls (runtime and driver
API) it holds, with each device event's start minus its launch call's
(``skew_us``: the device clock against the host's, plus the launch
latency) and where the device events lie against the host events of the
trace.  Beside each it reads the card's global timer (``%globaltimer``, ns)
in a one-thread kernel between two reads of the host's realtime clock:
``timer_offset_us`` is the timer minus the host clock's midpoint, less
the first such offset of the run, within ``timer_rtt_us``.
``TEARDOWN_CUPTI`` in the environment is reported beside, since the
profiler reads it.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

import chip_smoke  # noqa: E402

DEVICE_CATS = ("kernel", "gpu_memset")
TIMER_CU = r"""
extern "C" __global__ void read_timer(unsigned long long* out) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
  *out = t;
}
extern "C" int global_timer(void* out, void* stream) {
  read_timer<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned long long*>(out));
  return static_cast<int>(cudaGetLastError());
}
"""


def timer_reader(cuda, build: Path):
    """A function returning (card timer - host realtime, round trip), in
    ns, from a one-thread kernel built into ``build``."""
    import ctypes
    import subprocess
    src, lib = build / "global_timer.cu", build / "libglobal_timer.so"
    src.write_text(TIMER_CU)
    subprocess.run(cuda.nvcc_command(src, lib), check=True)
    fn = ctypes.CDLL(str(lib)).global_timer
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    buf = torch.zeros(1, dtype=torch.int64, device="cuda")

    def read():
        torch.cuda.synchronize()
        a = time.time_ns()
        cuda.check(fn(buf.data_ptr(), cuda.stream_of(buf)), "global_timer")
        torch.cuda.synchronize()
        b = time.time_ns()
        return int(buf.item()) - (a + b) // 2, b - a

    return read
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def trace_record(path: Path) -> dict:
    """Device events, launch calls and their skew in a Chrome trace."""
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X"]
    dev = [e for e in events if e.get("cat") in DEVICE_CATS]
    launches = {e["args"]["correlation"]: e for e in events
                if e.get("cat") in LAUNCH_CATS
                and "correlation" in e.get("args", {})}
    host = [e for e in events if e.get("cat") not in DEVICE_CATS]
    lo = min((e["ts"] for e in host), default=0.0)
    hi = max((e["ts"] + e.get("dur", 0) for e in host), default=0.0)
    skew = [round(e["ts"] - launches[e["args"]["correlation"]]["ts"], 1)
            for e in dev if e.get("args", {}).get("correlation") in launches]
    return {"kernels": sum(e["cat"] == "kernel" for e in dev),
            "memsets": sum(e["cat"] == "gpu_memset" for e in dev),
            "launch_calls": sorted({e["name"] for e in launches.values()}),
            "skew_us": skew,
            "device_after_host_start_us": [round(e["ts"] - lo, 1) for e in dev],
            "host_span_us": round(hi - lo, 1)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="chiprun_out/profiler_probe")
    ap.add_argument("--quick", action="store_true",
                    help="kernel checks without the 2^27-row size")
    ap.add_argument("--traces", type=int, default=8)
    ap.add_argument("--idle", type=float, default=0.0,
                    help="no checks: a pair of traces every 5 s this long")
    ap.add_argument("--delay", type=float, default=0.0,
                    help="with --idle: seconds before the first trace")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profiler_probe: needs a CUDA card")
    from repro_torch.kernels import cuda
    from repro_torch.kernels.segment_rank import segment_rank as rk
    from repro_torch.kernels.stream_compact import stream_compact as sc

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    print(chip_smoke.nvidia_smi_line(), torch.__version__, torch.version.cuda,
          flush=True)
    cuda.build_all()
    n = 1_000_003
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2)
    x = torch.randint(-8, 9, (n,), device=dev, generator=g, dtype=torch.int32)
    seg = (torch.rand(n, device=dev, generator=g) < 1 / 64).int()
    seg[:1] = 1
    ordb = seg | (torch.rand(n, device=dev, generator=g) < 0.3).int()
    fns = {"prefix_sum": lambda: sc.prefix_sum_cuda(x),
           "segment_rank": lambda: rk.segment_rank_cuda(seg, ordb, "rank")}
    teardown = os.environ.get("TEARDOWN_CUPTI")
    timer = timer_reader(cuda, out)
    first = timer()[0]

    def probe(stage: str, traces: int):
        for i in range(traces):
            for margin in (0.02, 0.5) if i % 4 == 3 else (0.02,):
                for name, fn in fns.items():
                    t = time.perf_counter() - t0
                    offset, rtt = timer()
                    prof, seen, host = chip_smoke.traced(torch, fn, margin)
                    path = out / f"{stage}_{i}_{name}_{margin}.json"
                    prof.export_chrome_trace(str(path))
                    rec = {"stage": stage, "t_s": round(t, 2), "call": name,
                           "margin_s": margin, "teardown_cupti": teardown,
                           "key_averages_device": sum(seen.values()),
                           "host_events": host,
                           "timer_offset_us": round((offset - first) / 1e3, 1),
                           "timer_rtt_us": round(rtt / 1e3, 1),
                           **trace_record(path)}
                    print(json.dumps(rec), flush=True)
                    if seen and i:
                        path.unlink()   # keep the first and the empty ones

    sizes = [0, 1, 2047, 2048, 2049, 1_000_003]
    if not args.quick:
        sizes.append(1 << 27)
    record: dict = {}
    if args.idle:
        time.sleep(args.delay)
        while time.perf_counter() - t0 < args.idle:
            probe("idle", 1)
            time.sleep(5)
        return 0
    probe("start", args.traces)
    chip_smoke.kernel_phases(torch, sizes, record)
    probe("after_kernel_phases", args.traces)
    chip_smoke.window_kernel_phases(torch, sizes, record)
    probe("after_window_kernel_phases", args.traces)
    time.sleep(30)
    probe("after_30s_idle", args.traces)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
