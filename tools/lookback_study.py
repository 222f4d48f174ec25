"""Time shapes of the look-back scan skeleton (``csrc/lookback.cuh``) on a
card, against each other and against ``torch.cumsum``:

    python tools/lookback_study.py [--n N]

Each variant is the shipped source with a few lines replaced (the tile's
warps and chunks, the fetch, the status loads, the float look-back's
serial fold, no look-back at all), built with nvcc into its own directory
under the build directory and called through its own C entry points, apart
from the libraries the package loads.  The variants run in turns, forward
then backward, on one set of inputs: int32 keep flags and normal float32
values for ``prefix_sum``, the float32 values with a segment head every
11585 rows for ``segment_scan``, and the timed masks of ``chip_smoke.py``
(the same heads, run heads every ~8) for the three ``segment_rank`` kinds.
Every variant but ``no_lookback`` (whose answers are wrong by design: it
measures what the look-back costs) is held against the plain versions
first: the integer scans bitwise, the float32 ones within 1e-5 of the
running sum of |x|.  In the first round each variant's float32 scans are
called 20 times: ``differing_of_20`` counts the calls whose bits differ
from the first (0 with the shipped serial fold; ``tree``, which combines
float windows with the integer scans' shuffle tree, shows why it is not
shipped).  Prints the card's name and power limit, then one JSON line per
variant and round: milliseconds per call, timed as ``chip_smoke.time_ms``
times them.
"""
from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

from chip_smoke import nvidia_smi_line, time_ms  # noqa: E402
from repro_torch.kernels import cuda  # noqa: E402
from repro_torch.kernels.segment_rank import segment_rank as rk  # noqa: E402
from repro_torch.kernels.segment_scan import segment_scan as ss  # noqa: E402
from repro_torch.kernels.stream_compact import stream_compact as sc  # noqa: E402

WARPS = "constexpr int THREADS = 160;"
CHUNKS = "constexpr int CHUNKS = 8; "
# The first design: each thread loads its chunks with one 16-byte load each
# into registers and keeps them there through the look-back; the tile is
# not staged, and the rows are stored 16 bytes at a time (run with BULK).
REGISTERS = (
    ("__shared__ __align__(128) uint32_t s_in[NIN][TILE];",
     "__shared__ __align__(128) uint32_t s_in[NIN][4];"),
    ("if (LOAD == BULK && tb + TILE <= n) {", "if (false) {"),
    ("""  if (LOAD == BULK && full) {
    bar_wait(&s_bar, 0);
  } else {
    for (int i = threadIdx.x; i < TILE; i += THREADS) {
      const long long g = tile_base + i;
#pragma unroll
      for (int p = 0; p < NIN; ++p)
        s_in[p][i] = full || g < n ? __ldg(in[p] + g) : 0u;
    }
    __syncthreads();
  }
""", """  uint32_t w[CHUNKS][2][VEC];
#pragma unroll
  for (int k = 0; k < CHUNKS; ++k) {
    const long long g0 = tile_base + row0 + k * 32 * VEC;
#pragma unroll
    for (int p = 0; p < NIN; ++p) {
      if (full) {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(in[p] + g0));
        w[k][p][0] = v.x; w[k][p][1] = v.y; w[k][p][2] = v.z; w[k][p][3] = v.w;
      } else {
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          w[k][p][j] = g0 + j < n ? __ldg(in[p] + g0 + j) : 0u;
      }
    }
  }
"""),
    ("const uint4 v = *reinterpret_cast<const uint4*>(&s_in[p][r0]);",
     "const uint4 v = make_uint4(w[k][p][0], w[k][p][1], w[k][p][2], w[k][p][3]);"),
)
EIGHT_BY_FOUR = ((WARPS, "constexpr int THREADS = 256;"),
                 (CHUNKS, "constexpr int CHUNKS = 4; "))
# name -> (replacements in lookback.cuh, fetch)
VARIANTS = {
    "bulk": ((), cuda.BULK),
    "registers": (REGISTERS, cuda.BULK),
    "words": ((), cuda.WORDS),
    "bulk_3_warps": (((WARPS, "constexpr int THREADS = 96;"),), cuda.BULK),
    "bulk_4_warps": (((WARPS, "constexpr int THREADS = 128;"),), cuda.BULK),
    "bulk_8_warps_4_chunks": (EIGHT_BY_FOUR, cuda.BULK),
    "registers_8_warps_4_chunks": (EIGHT_BY_FOUR + REGISTERS, cuda.BULK),
    "bulk_relaxed_loads": ((("ld.acquire.gpu.u64", "ld.relaxed.gpu.u64"),),
                           cuda.BULK),
    "no_lookback": ((("excl = look_back(op, status, tile);", ""),), cuda.BULK),
    "tree": ((("if constexpr (Op::ORDERED) {", "if constexpr (false) {"),),
             cuda.BULK),
}
LIBS = ("prefix_sum", "segment_scan", "segment_rank")
# the float32 scans, called 20 times each in a variant's first round
F32 = ("prefix_sum_f32", "segment_scan_f32")


def build(root: Path) -> dict:
    """One nvcc per variant and library, all at once; name -> libraries."""
    procs = []
    for name, (subs, _load) in VARIANTS.items():
        d = root / name
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(cuda.CSRC, d)
        src = (d / "lookback.cuh").read_text()
        for old, new in subs:
            if src.count(old) != 1:
                raise RuntimeError(f"{name}: {old!r} not once in lookback.cuh")
            src = src.replace(old, new)
        (d / "lookback.cuh").write_text(src)
        for lib in LIBS:
            cmd = cuda.nvcc_command(d / f"{lib}.cu", d / f"lib{lib}.so")
            procs.append((name, lib, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
    for name, lib, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}/{lib}:\n{log}")
    return {name: {lib: cuda.bind(root / name / f"lib{lib}.so", lib)
                   for lib in LIBS} for name in VARIANTS}


def calls(libs: dict, load: int, x, xf, seg, ordb) -> dict:
    """The variant's seven scans as the wrappers make them: fresh output and
    scratch each call, on the current stream."""
    ps, sg, sr = libs["prefix_sum"], libs["segment_scan"], libs["segment_rank"]
    stream = cuda.stream_of(x)

    def prefix_sum(v):
        out = torch.empty_like(v)
        scratch = torch.empty(ps.prefix_sum_scratch_bytes(v.numel()),
                              dtype=torch.uint8, device=v.device)
        fn = ps.prefix_sum_i32 if v.dtype == torch.int32 else ps.prefix_sum_f32
        cuda.check(fn(v.data_ptr(), out.data_ptr(), scratch.data_ptr(),
                      v.numel(), load, stream), "prefix_sum")
        return out

    def segment_scan():
        out = torch.empty_like(xf)
        scratch = torch.empty(sg.segment_scan_scratch_bytes(xf.numel()),
                              dtype=torch.uint8, device=xf.device)
        cuda.check(sg.segment_scan_f32(xf.data_ptr(), seg.data_ptr(),
                                       out.data_ptr(), scratch.data_ptr(),
                                       xf.numel(), load, stream),
                   "segment_scan")
        return out

    def rank(kind):
        out = torch.empty_like(seg)
        scratch = torch.empty(sr.segment_rank_scratch_bytes(seg.numel()),
                              dtype=torch.uint8, device=seg.device)
        cuda.check(sr.segment_rank(seg.data_ptr(), ordb.data_ptr(),
                                   out.data_ptr(), scratch.data_ptr(),
                                   seg.numel(), rk.KINDS.index(kind), load,
                                   stream), "segment_rank")
        return out

    fns = {"prefix_sum": lambda: prefix_sum(x),
           "prefix_sum_f32": lambda: prefix_sum(xf),
           "segment_scan_f32": segment_scan}
    fns.update({k: (lambda k=k: rank(k)) for k in rk.KINDS})
    return fns


def differing(fn, times: int = 20) -> int:
    """How many of ``times`` float32 results differ in their bits from the
    first."""
    bits = fn().view(torch.int32)
    return sum(not torch.equal(fn().view(torch.int32), bits)
               for _ in range(times - 1))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=1 << 27)
    n = ap.parse_args(argv).n
    if not torch.cuda.is_available():
        raise SystemExit("lookback_study: needs a CUDA card")
    print(nvidia_smi_line(), flush=True)
    libs = build(cuda.build_dir() / "lookback_study")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    x = (torch.rand(n, device=dev, generator=g) < 0.5).to(torch.int32)
    xf = torch.randn(n, device=dev, generator=g)
    seg = (torch.rand(n, device=dev, generator=g) < 1 / 11585).int()
    seg[0] = 1
    ordb = seg | (torch.rand(n, device=dev, generator=g) < 0.125).int()
    want = {"prefix_sum": sc.prefix_sum_plain(x),
            "prefix_sum_f32": sc.prefix_sum_plain(xf),
            "segment_scan_f32": ss.segment_scan_plain(xf, seg)}
    want.update({k: rk.segment_rank_plain(seg, ordb, k) for k in rk.KINDS})
    tol = 1e-5 * torch.cumsum(xf.abs().double(), 0) + 1e-4
    order = list(VARIANTS) + list(VARIANTS)[::-1]
    for rnd, name in enumerate(order):
        fns = calls(libs[name], VARIANTS[name][1], x, xf, seg, ordb)
        rec = {"variant": name, "round": rnd // len(VARIANTS)}
        if name != "no_lookback":
            for k, fn in fns.items():
                got = fn()
                if k in F32:
                    d = (got.double() - want[k].double()).abs()
                    assert bool((d <= tol).all()), f"{name}: {k} off"
                else:
                    assert torch.equal(got, want[k]), f"{name}: {k} differs"
            if rec["round"] == 0:
                rec["differing_of_20"] = {k: differing(fns[k]) for k in F32}
        rec.update({k: time_ms(fn, torch) for k, fn in fns.items()})
        rec["torch.cumsum"] = time_ms(
            lambda: torch.cumsum(x, 0, dtype=torch.int32), torch)
        rec["torch.cumsum_f32"] = time_ms(lambda: torch.cumsum(xf, 0), torch)
        print(json.dumps(rec), flush=True)
    return 0



if __name__ == "__main__":
    raise SystemExit(main())
