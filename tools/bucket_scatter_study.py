"""Time variants of the bucket_scatter kernel (``csrc/bucket_scatter.cu``) on
a card, against each other and against ``torch.sort(stable=True)``:

    python tools/bucket_scatter_study.py [--n N] [--ps 8,256,2048]

Each variant is the shipped source with a line or two replaced (the tile's
rows; how a warp finds the rows of each bucket: shared OR masks, a ballot
per bit of the bucket id or __match_any_sync; acquire in place of relaxed
status loads; no look-back or no ranking at all), built with
nvcc into its own directory under the build directory and called through
its own C entry points, apart from the libraries the package loads;
``words`` is the shipped source called with the 4-byte fetch that views not
16-byte aligned take.  The variants run in turns, forward then backward, on
one set of inputs per P: n bucket ids drawn uniformly from [0, P), as
``chip_smoke.py`` times them.  Every variant but ``no_lookback`` and
``no_ranking`` (whose slots are wrong by design: they measure what the
look-back and the ranking in the warps cost) is held exactly against the
plain version first.  Prints the card's name and power
limit, then one JSON line per variant and round: milliseconds per call at
each P, timed as ``chip_smoke.time_ms`` times them, and the stable sort's.
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
from repro_torch.kernels.hash_partition import hash_partition as hp  # noqa: E402

SOURCES = ("bucket_scatter.cu", "lookback.cuh")


def sub(name: str, old: str, new: str) -> tuple:
    """Replace the value of one ``constexpr int`` of the kernel."""
    return (f"constexpr int {name} = {old};", f"constexpr int {name} = {new};")


# how a warp finds the lanes of each row's bucket: the shipped shared OR
# masks, __match_any_sync, or a ballot per bit of the bucket id
OR_MASKS = """      if (valid) atomicOr(&mask[c[k]], 1u << lane);
      __syncwarp();
      peers[k] = valid ? mask[c[k]] : 0u;       // the lanes of its bucket
"""
MATCH_ANY = """      peers[k] = __match_any_sync(FULL_MASK, c[k]);
"""
BIT_BALLOTS = """      peers[k] = __ballot_sync(FULL_MASK, valid);
      for (int bit = 0; (1 << bit) < P; ++bit) {
        const bool one = (c[k] >> bit) & 1u;
        const unsigned m = __ballot_sync(FULL_MASK, one);
        peers[k] &= one ? m : ~m;
      }
"""

# name -> (replacements in bucket_scatter.cu or lookback.cuh, fetch): P <=
# 256 is "narrow" (one bucket a thread), above it "wide"
VARIANTS = {
    "shipped": ((), cuda.BULK),
    "words": ((), cuda.WORDS),
    "narrow_tile_8192": ((sub("NARROW_TILE", "12288", "8192"),), cuda.BULK),
    "narrow_tile_16384": ((sub("NARROW_TILE", "12288", "16384"),), cuda.BULK),
    "wide_tile_8192": ((sub("WIDE_TILE", "16384", "8192"),), cuda.BULK),
    "match_any": (((OR_MASKS, MATCH_ANY),), cuda.BULK),
    "bit_ballots": (((OR_MASKS, BIT_BALLOTS),), cuda.BULK),
    "acquire_loads": ((("ld.relaxed.gpu.u32", "ld.acquire.gpu.u32"),),
                      cuda.BULK),
    "no_lookback": ((("if (tile > 0) walk_back<OWN>(status, tile, P, excl);",
                      ""),), cuda.BULK),
    "no_ranking": ((("for (int r0 = 0; r0 < SPAN; r0 += 32 * GROUP) {",
                     "for (int r0 = 0; r0 < 0; r0 += 32 * GROUP) {"),),
                   cuda.BULK),
}
# variants whose slots are wrong by design (timing only)
WRONG = ("no_lookback", "no_ranking")


def build(root: Path) -> dict:
    """One nvcc per variant, all at once; name -> library."""
    procs = []
    for name, (subs, _load) in VARIANTS.items():
        d = root / name
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(cuda.CSRC, d)
        files = {f: (d / f).read_text() for f in SOURCES}
        for old, new in subs:
            where = [f for f, s in files.items() if s.count(old) == 1]
            if len(where) != 1 or sum(s.count(old) for s in files.values()) != 1:
                raise RuntimeError(f"{name}: {old!r} not once in {SOURCES}")
            files[where[0]] = files[where[0]].replace(old, new)
        for f, s in files.items():
            (d / f).write_text(s)
        cmd = cuda.nvcc_command(d / "bucket_scatter.cu", d / "libbucket_scatter.so")
        procs.append((name, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    for name, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
    return {name: cuda.bind(root / name / "libbucket_scatter.so",
                            "bucket_scatter") for name in VARIANTS}


def call(lib, load: int, dest: torch.Tensor, P: int):
    """The variant's call as the wrapper makes it: fresh slots, counts and
    scratch each call, on the current stream."""
    n = dest.numel()
    slot = torch.empty(n, dtype=torch.int32, device=dest.device)
    counts = torch.empty(P, dtype=torch.int32, device=dest.device)
    scratch = torch.empty(lib.bucket_scatter_scratch_bytes(n, P),
                          dtype=torch.uint8, device=dest.device)
    cuda.check(lib.bucket_scatter(dest.data_ptr(), slot.data_ptr(),
                                  counts.data_ptr(), scratch.data_ptr(), n, P,
                                  load, cuda.stream_of(dest)), "bucket_scatter")
    return slot, counts


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=1 << 27)
    ap.add_argument("--ps", default="8,256,2048")
    args = ap.parse_args(argv)
    n, ps = args.n, [int(p) for p in args.ps.split(",")]
    if not torch.cuda.is_available():
        raise SystemExit("bucket_scatter_study: needs a CUDA card")
    print(nvidia_smi_line(), flush=True)
    libs = build(cuda.build_dir() / "bucket_scatter_study")
    g = torch.Generator(device="cuda").manual_seed(0)
    dest = {P: torch.randint(0, P, (n,), device="cuda", generator=g,
                             dtype=torch.int32) for P in ps}
    want = {P: hp.bucket_scatter_plain(dest[P], P) for P in ps}
    order = list(VARIANTS) + list(VARIANTS)[::-1]
    for rnd, name in enumerate(order):
        lib, load = libs[name], VARIANTS[name][1]
        rec = {"variant": name, "round": rnd // len(VARIANTS)}
        for P in ps:
            if name not in WRONG:
                slot, counts = call(lib, load, dest[P], P)
                assert torch.equal(counts, want[P][1]) and \
                    torch.equal(slot, want[P][0]), f"{name}: P={P} differs"
            rec[f"P={P}"] = time_ms(lambda: call(lib, load, dest[P], P), torch)
            if rnd == 0:
                rec[f"stable_sort_P={P}"] = time_ms(
                    lambda: torch.sort(dest[P], stable=True), torch)
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
