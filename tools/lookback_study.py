"""Time shapes of the look-back scan skeleton (``csrc/lookback.cuh``) on a
card, against each other and against ``torch.cumsum``:

    python tools/lookback_study.py [--n N]

Each variant is the shipped source with a few lines replaced (the tile's
warps and chunks, the fetch, the status loads, no look-back at all), built
with nvcc into its own directory under the build directory and called
through its own C entry points, apart from the libraries the package
loads.  The variants run in turns, forward then backward, on one set of
inputs: int32 keep flags for ``prefix_sum`` and the timed masks of
``chip_smoke.py`` (a segment head every 11585 rows, run heads every ~8) for
the three ``segment_rank`` kinds.  Every variant but ``no_lookback`` (whose
answers are wrong by design: it measures what the look-back costs) is held
bitwise against the plain versions first.  Prints the card's name and power
limit, then one JSON line per variant and round: milliseconds per call,
timed as ``chip_smoke.time_ms`` times them.
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
    wait_phase0(&s_bar);
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
}
LIBS = ("prefix_sum", "segment_rank")


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


def calls(libs: dict, load: int, x, seg, ordb) -> dict:
    """The variant's four scans as the wrappers make them: fresh output and
    scratch each call, on the current stream."""
    ps, sr = libs["prefix_sum"], libs["segment_rank"]
    stream = cuda.stream_of(x)

    def prefix_sum():
        out = torch.empty_like(x)
        scratch = torch.empty(ps.prefix_sum_scratch_bytes(x.numel()),
                              dtype=torch.uint8, device=x.device)
        cuda.check(ps.prefix_sum_i32(x.data_ptr(), out.data_ptr(),
                                     scratch.data_ptr(), x.numel(), load,
                                     stream), "prefix_sum")
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

    fns = {"prefix_sum": prefix_sum}
    fns.update({k: (lambda k=k: rank(k)) for k in rk.KINDS})
    return fns


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
    seg = (torch.rand(n, device=dev, generator=g) < 1 / 11585).int()
    seg[0] = 1
    ordb = seg | (torch.rand(n, device=dev, generator=g) < 0.125).int()
    want = {"prefix_sum": sc.prefix_sum_plain(x)}
    want.update({k: rk.segment_rank_plain(seg, ordb, k) for k in rk.KINDS})
    order = list(VARIANTS) + list(VARIANTS)[::-1]
    for rnd, name in enumerate(order):
        fns = calls(libs[name], VARIANTS[name][1], x, seg, ordb)
        if name != "no_lookback":
            for k, fn in fns.items():
                assert torch.equal(fn(), want[k]), f"{name}: {k} differs"
        rec = {"variant": name, "round": rnd // len(VARIANTS)}
        rec.update({k: time_ms(fn, torch) for k, fn in fns.items()})
        rec["torch.cumsum"] = time_ms(
            lambda: torch.cumsum(x, 0, dtype=torch.int32), torch)
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
