"""Time variants of the segment_sums kernel (``csrc/segment_sums.cu``) on a
card, against each other, against ``torch.segment_reduce`` and, with
``--parent``, against the kernel of another tree:

    python tools/segment_sums_study.py [--n N] [--parent DIR] [--only NAME ...]

Each variant is the shipped source with a few lines replaced (the tile's
chunks, the fetch of the valid bytes, one block a tile instead of as many as
the card holds, no look-back at all, 4-byte stores only), built with nvcc into its own
directory under the build directory and called through its own C entry
point, apart from the library the package loads.  ``--parent DIR`` adds the
``segment_sums.cu`` of the tree at DIR (a checkout or ``git archive`` of an
earlier commit), called through the interface it had before the valid
prefix (``values, seg_id, valid, out, n, num_segments, stream``: no count,
no scratch; it zeroes every slot and adds run totals at tile edges with
atomics).

The inputs, n rows (2^27 by default), float32 values from one seed:

- ``partial``: the partial stage of Fig. 8a's aggregate, n sorted rows in
  4096 groups, all valid, num_segments = n, count = n;
- ``final``: the final stage, 4096 partial rows then padding (invalid, id =
  num_segments), num_segments = n, count = 4096 (the parent reads all n);
- ``each_row``: every row its own run, num_segments = n;
- ``one_run``: one run over every row (only held and repeated, not timed).

Every variant but ``no_lookback`` (wrong by design: it measures what the
look-back costs) is held against the plain version on the slots the runs
name, within 1e-4 of the run's sum of |x| (+1e-5), and its 20 calls on the
``partial``, ``each_row`` and ``one_run`` inputs are compared bitwise with
its first: ``differing_of_20`` counts the calls whose bits differ.  The
variants run in turns, forward then backward; each prints one JSON line per
round, milliseconds per call as ``chip_smoke.time_ms`` times them.  The
card's name and power limit come first.
"""
from __future__ import annotations

import argparse
import ctypes
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
from repro_torch.kernels.segment_reduce import segment_reduce as sr  # noqa: E402

GROUPS = 4096
CHUNKS = "constexpr int CHUNKS = lookback::CHUNKS;"
# the valid bytes of a whole tile fetched by the threads with 4-byte loads
# once the bulk copies of values and ids have landed, instead of a third
# bulk copy (a partial tile: 1-byte loads)
VALID_WORDS = (
    ("bar_expect(&s_bar, 8 * r4 + r16);", "bar_expect(&s_bar, 8 * r4);"),
    ("if (r16 > 0) bulk_copy(s_ok, valid + tb, r16, &s_bar);", ""),
    ("if (LOAD == lookback::WORDS || !full) {", "if (true) {"),
    ("const int r16 = LOAD == lookback::BULK ? rows & ~15 : 0;",
     "const int r16 = 0;"),
    ("""        s_ok[i] = __ldg(valid + g);
      }""", """        if (!full) s_ok[i] = __ldg(valid + g);
      }
      for (int i = threadIdx.x * 4; full && i < TILE; i += THREADS * 4)
        *reinterpret_cast<uint32_t*>(&s_ok[i]) =
            __ldg(reinterpret_cast<const uint32_t*>(valid + tile_base + i));"""),
)
# name -> (replacements in segment_sums.cu, fetch)
VARIANTS = {
    "shipped": ((), cuda.BULK),
    "words": ((), cuda.WORDS),
    "valid_words": (VALID_WORDS, cuda.BULK),
    "chunks_6": (((CHUNKS, "constexpr int CHUNKS = 6;"),), cuda.BULK),
    "chunks_7": (((CHUNKS, "constexpr int CHUNKS = 7;"),), cuda.BULK),
    "one_block_a_tile": (((
        "std::min<long long>(tiles_of(n), blocks)", "tiles_of(n)"),),
        cuda.BULK),
    "no_lookback": ((("const T excl = lookback::look_back(op, status, tile);",
                      "const T excl = op.identity();"),), cuda.BULK),
    # every run total by a 4-byte store, without the 16-byte store of four
    # aligned runs of one row each
    "scalar_stores": ((("if (end[0] && end[1] && end[2] && end[3] && mid[0] &&",
                        "if (false && end[0] && end[1] && end[2] && end[3] &&"
                        " mid[0] &&"),), cuda.BULK),
}
TIMED = ("partial", "final", "each_row")
REPEATED = ("partial", "each_row", "one_run")


def build(root: Path, names, parent: Path | None) -> dict:
    """One nvcc per variant, all at once; name -> library."""
    procs = []
    for name in names:
        d = root / name
        shutil.rmtree(d, ignore_errors=True)
        src_dir = (parent / "src/repro_torch/csrc") if name == "parent" \
            else cuda.CSRC
        shutil.copytree(src_dir, d)
        src = (d / "segment_sums.cu").read_text()
        for old, new in ([] if name == "parent" else VARIANTS[name][0]):
            if src.count(old) != 1:
                raise RuntimeError(f"{name}: {old!r} not once in segment_sums.cu")
            src = src.replace(old, new)
        (d / "segment_sums.cu").write_text(src)
        cmd = cuda.nvcc_command(d / "segment_sums.cu", d / "libsegment_sums.so")
        procs.append((name, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    for name, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
    libs = {}
    for name in names:
        path = root / name / "libsegment_sums.so"
        if name == "parent":
            lib = ctypes.CDLL(str(path))
            lib.segment_sums.argtypes = [ctypes.c_void_p] * 4 + [
                ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
            lib.segment_sums.restype = ctypes.c_int
            libs[name] = lib
        else:
            libs[name] = cuda.bind(path, "segment_sums")
    return libs


def caller(name: str, lib, load: int):
    """The variant as the wrapper calls it: fresh output and scratch each
    call, on the current stream."""
    def call(vals, seg, valid, num, count):
        out = torch.empty(num, dtype=torch.float32, device=vals.device)
        stream = cuda.stream_of(vals)
        n = vals.numel()
        if name == "parent":
            cuda.check(lib.segment_sums(vals.data_ptr(), seg.data_ptr(),
                                        valid.data_ptr(), out.data_ptr(), n,
                                        num, stream), name)
            return out
        scratch = torch.empty(lib.segment_sums_scratch_bytes(n),
                              dtype=torch.uint8, device=vals.device)
        cuda.check(lib.segment_sums(vals.data_ptr(), seg.data_ptr(),
                                    valid.data_ptr(), count.data_ptr(),
                                    out.data_ptr(), scratch.data_ptr(), n, num,
                                    load, stream), name)
        return out
    return call


def inputs(n: int, dev) -> dict:
    """name -> (values, seg_id, valid, num_segments, count, named slots)."""
    g = torch.Generator(device=dev).manual_seed(0)
    vals = torch.randn(n, device=dev, generator=g)
    every = torch.ones(n, dtype=torch.bool, device=dev)
    c = torch.tensor(n, dtype=torch.int32, device=dev)
    ids = torch.arange(n, device=dev, dtype=torch.int64)
    final = torch.full((n,), n, dtype=torch.int32, device=dev)
    final[:GROUPS] = torch.arange(GROUPS, dtype=torch.int32, device=dev)
    return {
        "partial": (vals, (ids * GROUPS // n).int(), every, n, c, GROUPS),
        "final": (vals, final, ids < GROUPS, n,
                  torch.tensor(GROUPS, dtype=torch.int32, device=dev), GROUPS),
        "each_row": (vals, ids.int(), every, n, c, n),
        "one_run": (vals, torch.zeros(n, dtype=torch.int32, device=dev), every,
                    n, c, 1),
    }


def differing(fn, times: int = 20) -> int:
    """How many of ``times`` results differ in their bits from the first."""
    bits = fn().view(torch.int32)
    return sum(not torch.equal(fn().view(torch.int32), bits)
               for _ in range(times - 1))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=1 << 27)
    ap.add_argument("--parent", type=Path, default=None,
                    help="a tree whose segment_sums.cu is timed beside")
    ap.add_argument("--only", nargs="*", default=None,
                    help="variants to run (default: all, and parent)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("segment_sums_study: needs a CUDA card")
    print(nvidia_smi_line(), flush=True)
    names = list(VARIANTS) + (["parent"] if args.parent else [])
    if args.only is not None:
        names = [v for v in names if v in args.only]
    libs = build(cuda.build_dir() / "segment_sums_study", names, args.parent)
    dev = torch.device("cuda")
    data = inputs(args.n, dev)
    want = {}
    for k, (vals, seg, valid, num, count, named) in data.items():
        want[k] = (sr.segment_sums_plain(vals, seg, valid, num, count)[:named],
                   sr.segment_sums_plain(vals.abs(), seg, valid, num,
                                         count)[:named])
    order = names + names[::-1]
    for rnd, name in enumerate(order):
        call = caller(name, libs[name], VARIANTS.get(name, ((), 0))[1])
        # the named slots only: the others are undefined
        fns = {k: (lambda a=a: call(*a[:5])[:a[5]]) for k, a in data.items()}
        rec = {"variant": name, "round": rnd // len(names)}
        if name != "no_lookback":
            for k, fn in fns.items():
                got = fn()
                sums, mag = want[k]
                d = (got - sums).abs()
                assert bool((d <= 1e-4 * mag + 1e-5).all()), f"{name}: {k} off"
                rec.setdefault("max_abs_err", {})[k] = float(d.max())
            if rec["round"] == 0:
                rec["differing_of_20"] = {k: differing(fns[k])
                                          for k in REPEATED}
        rec.update({k: time_ms(fns[k], torch) for k in TIMED})
        vals, seg, _valid, _num, _count, _named = data["partial"]
        lengths = torch.bincount(seg.long(), minlength=GROUPS)
        rec["torch.segment_reduce"] = time_ms(
            lambda: torch.segment_reduce(vals, "sum", lengths=lengths,
                                         unsafe=True), torch)
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
