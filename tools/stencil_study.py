"""Time shapes of the stencil kernel (``csrc/stencil1d.cu``) on a card,
against each other and against ``conv1d``:

    python tools/stencil_study.py [--n N]

Each variant is the shipped source with a line or two replaced (threads a
block, output groups a thread, hence the tile), built with nvcc into its
own directory under the build directory and called through its own C
entry points, apart from the libraries the package loads; ``words`` is the
shipped source called with the 4-byte fetch that views not 16-byte aligned
take.  The variants run in turns, forward then backward, on the main
path's four calls as ``chip_smoke.py`` times them (n rows): stencil1d K = 3
(the SMA / WMA), stencil1d_exact K = 20 centre 19 (the exact rolling mean),
segment_stencil K = 3 centre 1 (the partitioned WMA) and exact K = 7
centre 6 (the grouped rolling mean), segment ids of groups of 11585 rows on
average.  Every variant is held bitwise against the plain versions first.
Prints the card's name and power limit, then one JSON line per variant and
round: milliseconds per call, timed as ``chip_smoke.time_ms`` times them.
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

from chip_smoke import GROUPS as MEAN_SEGMENT  # noqa: E402
from chip_smoke import nvidia_smi_line, time_ms  # noqa: E402
from repro_torch.kernels import cuda  # noqa: E402
from repro_torch.kernels.stencil1d import stencil1d as st  # noqa: E402

THREADS = "constexpr int THREADS = 256;"
GROUPS_A_THREAD = "constexpr int GROUPS = 4; "


def groups(k: int) -> tuple:
    return (GROUPS_A_THREAD, f"constexpr int GROUPS = {k}; ")


# name -> (replacements in stencil1d.cu, fetch); the tile is THREADS x 4 x
# GROUPS outputs
VARIANTS = {
    "shipped": ((), cuda.BULK),
    "words": ((), cuda.WORDS),
    "tile_1024": ((groups(1),), cuda.BULK),
    "tile_2048": ((groups(2),), cuda.BULK),
    "tile_8192": ((groups(8),), cuda.BULK),
    "threads_128_tile_4096": (((THREADS, "constexpr int THREADS = 128;"),
                               groups(8)), cuda.BULK),
}


def build(root: Path) -> dict:
    """One nvcc per variant, all at once; name -> library."""
    procs = []
    for name, (subs, _load) in VARIANTS.items():
        d = root / name
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(cuda.CSRC, d)
        src = (d / "stencil1d.cu").read_text()
        for old, new in subs:
            if src.count(old) != 1:
                raise RuntimeError(f"{name}: {old!r} not once in stencil1d.cu")
            src = src.replace(old, new)
        (d / "stencil1d.cu").write_text(src)
        cmd = cuda.nvcc_command(d / "stencil1d.cu", d / "libstencil1d.so")
        procs.append((name, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    for name, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
    return {name: cuda.bind(root / name / "libstencil1d.so", "stencil1d")
            for name in VARIANTS}


def calls(lib, load: int, inputs: dict) -> dict:
    """The variant's four main-path calls as the wrappers make them: fresh
    output and weights each call, on the current stream."""
    def call(fn, name, arrays, w, *tail):
        ext = arrays[0]
        n = ext.numel() - len(w) + 1
        out = torch.empty(n, dtype=torch.float32, device=ext.device)
        wd = torch.tensor(w, dtype=torch.float32, device=ext.device)
        cuda.check(fn(*(a.data_ptr() for a in arrays), wd.data_ptr(),
                      out.data_ptr(), n, len(w), *tail, load,
                      cuda.stream_of(ext)), name)
        return out

    (e3, w3), (e20, m20, w20), (s3e, s3s), (s7e, s7s, w7) = (
        inputs["k3"], inputs["exact_k20"], inputs["segment_k3"],
        inputs["segment_exact_k7"])
    return {
        "stencil1d_k3": lambda: call(lib.stencil1d, "stencil1d", (e3,), w3),
        "stencil1d_exact_k20": lambda: call(
            lib.stencil1d_exact, "stencil1d_exact", (e20, m20), w20,
            st._total(w20)),
        "segment_stencil_k3": lambda: call(
            lib.segment_stencil, "segment_stencil", (s3e, s3s), w3, 1, 0,
            st._total(w3)),
        "segment_stencil_exact_k7": lambda: call(
            lib.segment_stencil, "segment_stencil", (s7e, s7s), w7, 6, 1,
            st._total(w7)),
    }


def layout(n, k, c, g):
    """ext, ext_m and ext_s as the operators build them (chip_smoke's
    layout): zero halos, ids of groups of MEAN_SEGMENT rows on average,
    the last n // 7 rows invalid."""
    dev = torch.device("cuda")
    ext = torch.zeros(n + k - 1, device=dev)
    ext[c:c + n] = torch.randn(n, device=dev, generator=g)
    ext_m = torch.zeros(n + k - 1, device=dev)
    ext_m[c:c + n] = 1.0
    head = torch.rand(n, device=dev, generator=g) < 1.0 / MEAN_SEGMENT
    head[0] = True
    sid = torch.cumsum(head.int(), 0, dtype=torch.int32) - 1
    sid[n - n // 7:] = -1
    ext_s = torch.full((n + k - 1,), -2, dtype=torch.int32, device=dev)
    ext_s[c:c + n] = sid
    return ext, ext_m, ext_s


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=1 << 27)
    n = ap.parse_args(argv).n
    if not torch.cuda.is_available():
        raise SystemExit("stencil_study: needs a CUDA card")
    print(nvidia_smi_line(), flush=True)
    torch.backends.cudnn.allow_tf32 = False
    libs = build(cuda.build_dir() / "stencil_study")
    g = torch.Generator(device="cuda").manual_seed(0)
    w3, w20, w7 = [0.25, 0.5, 0.25], [0.05] * 20, [1.0 / 7] * 7
    e3 = torch.randn(n + 2, device="cuda", generator=g)
    e20, m20, _ = layout(n, 20, 19, g)
    s3e, _, s3s = layout(n, 3, 1, g)
    s7e, _, s7s = layout(n, 7, 6, g)
    inputs = {"k3": (e3, w3), "exact_k20": (e20, m20, w20),
              "segment_k3": (s3e, s3s), "segment_exact_k7": (s7e, s7s, w7)}
    want = {"stencil1d_k3": st.stencil1d_plain(e3, w3),
            "stencil1d_exact_k20": st.stencil1d_exact_plain(e20, m20, w20),
            "segment_stencil_k3": st.segment_stencil_plain(s3e, s3s, w3, 1),
            "segment_stencil_exact_k7": st.segment_stencil_plain(
                s7e, s7s, w7, 6, True)}
    wt = torch.tensor(w3, device="cuda").view(1, 1, 3)
    order = list(VARIANTS) + list(VARIANTS)[::-1]
    for rnd, name in enumerate(order):
        fns = calls(libs[name], VARIANTS[name][1], inputs)
        for k, fn in fns.items():
            assert torch.equal(fn(), want[k]), f"{name}: {k} differs"
        rec = {"variant": name, "round": rnd // len(VARIANTS)}
        rec.update({k: time_ms(fn, torch) for k, fn in fns.items()})
        rec["conv1d_k3"] = time_ms(
            lambda: torch.nn.functional.conv1d(e3.view(1, 1, -1), wt), torch)
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
