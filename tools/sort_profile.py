"""Where the time of the sort, frame and segmentation paths' queries goes,
one fresh process each:

    python tools/sort_profile.py [--out DIR] [QUERY ...]
    python tools/sort_profile.py q05_string q09_channel frame_verbs ...
    python tools/sort_profile.py seg_features seg_matrix seg_transform ...

For each query (default: all of ``QUERIES``, the sort path's; the frame
path's are ``FRAME_QUERIES``, the segmentation path's ``SEG_QUERIES``) a
new process builds the query's inputs as ``chip_smoke.py`` does (2^27 rows;
the frame path's at scale 64, their dictionary encoding before the run; the
cluster profile's after the program's Q26 stage, matrix and K-means), runs it
once through ``hf`` on the card, then once more under torch.profiler
(``chip_smoke.profile_run``: the first profiler session of the process,
before the profiler starts losing device events), and prints one JSON line:
wall, kernel and copy ms, the device's idle share and the six largest
device items.  The per-op table goes to ``DIR/profile_<query>.txt``
(default ``build/sort_profile``, which git ignores).  ``rank_only`` is
global_rank's first window alone.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke  # noqa: E402

QUERIES = ("sort_fig8a", "global_rank", "rank_only", "fig14_pipeline",
           "sma_after_filter", "concat_aggregate")
FRAME_QUERIES = ("q05_string", "q09_channel", "frame_verbs", "null_rows",
                 "concat_channels", "merge_category_keys")
SEG_QUERIES = ("seg_features", "seg_matrix", "seg_profile_size",
               "seg_profile_mean", "seg_profile_sum", "seg_transform",
               "seg_head", "fig10_builtin", "fig10_udf")
N = 2**27


class _Matrix:
    """``collect_matrix`` of a frame behind ``collect(cfg)``."""

    def __init__(self, frame, cols):
        self.frame, self.cols = frame, cols

    def collect(self, cfg):
        return self.frame.collect_matrix(self.cols, cfg)


def seg_frame(hf, synth, name: str):
    """The segmentation path's query ``name`` over its inputs, as
    chip_smoke.py builds them: the cluster profile's frames after the Q26
    stage, the matrix and 20 K-means iterations."""
    import torch
    z = chip_smoke.seg_queries()
    if name.startswith("fig10"):
        df = hf.table(synth.relational_tables(chip_smoke.FIG10_ROWS, 100,
                                              seed=4))
        return z[name](hf, df)
    ss, it, _ = chip_smoke.q26_tables(synth)
    frame = z["q26_features"](hf, {"ss": ss, "it": it})
    cols = list(z["FEATURES"])
    if name == "seg_features":
        return frame
    if name == "seg_matrix":
        return _Matrix(frame, cols)
    cfg = hf.ExecConfig()
    feats = frame.to_numpy(cfg)
    mat, counts, _ = frame.collect_matrix(cols, cfg)
    x = mat[:int(counts[0])]
    cent = chip_smoke.kmeans_run(torch, z, x)[0][-1]
    cluster = z["kmeans_step"](x, cent)[1].to(torch.int32)
    return chip_smoke.seg_profile_frames(hf.table(feats, "features"),
                                         cluster)[name]


def frame_path_frame(hf, synth, name: str):
    """The frame path's frame ``name`` over its inputs, as chip_smoke.py
    builds them."""
    wcs, itx, ssx = chip_smoke.frame_tables(synth)
    if name == "q05_string":
        return chip_smoke.q05_frame(hf.table(wcs, "wcs"), hf.table(itx, "itx"),
                                    "books", ["electronics", "music"])
    if name == "merge_category_keys":
        return chip_smoke.merge_category_frame(
            hf.table(itx, "itx"), hf.table(chip_smoke.category_dim(), "cdim"))
    if name == "concat_channels":
        a, b = chip_smoke.sales_halves(
            ssx, chip_smoke.channel_codes(ssx["ss_channel"], synth))
        return chip_smoke.concat_channels_frame(hf, hf.table(a, "a"),
                                                hf.table(b, "b"))
    ss = hf.table(ssx, "ssx")
    if name == "q09_channel":
        return chip_smoke.q09_channel_frame(ss)
    if name == "frame_verbs":
        return chip_smoke.frame_verbs_frame(ss)
    if name == "null_rows":
        return chip_smoke.null_rows_frame(ss)
    raise ValueError(f"unknown query {name!r}; known: "
                     f"{QUERIES + FRAME_QUERIES + SEG_QUERIES}")


def frame(hf, synth, name: str):
    """The sort or frame path's frame ``name`` over its inputs, as
    chip_smoke.py builds them."""
    if name in FRAME_QUERIES:
        return frame_path_frame(hf, synth, name)
    if name in SEG_QUERIES:
        return seg_frame(hf, synth, name)
    if name == "sort_fig8a":
        return hf.table(synth.relational_tables(N, 1000, seed=0)).sort_values("x")
    if name in ("global_rank", "rank_only"):
        kinds = ("rank",) if name == "rank_only" else \
            ("rank", "dense_rank", "row_number")
        return chip_smoke.global_rank_frame(hf, synth.series(N, seed=3), kinds)
    if name == "sma_after_filter":
        return chip_smoke.sma_after_filter_frame(hf, synth.series(N, seed=3))
    if name == "fig14_pipeline":
        return chip_smoke.fig14_frame(hf, *chip_smoke.fig14_inputs(synth, N))
    if name == "concat_aggregate":
        return chip_smoke.concat_aggregate_frame(
            hf, synth.relational_tables(N, 4096, seed=2))
    raise ValueError(f"unknown query {name!r}; known: "
                     f"{QUERIES + FRAME_QUERIES + SEG_QUERIES}")


def profile_one(name: str, out: str) -> dict:
    import torch

    from repro_torch import hiframes as hf
    from repro_torch.data import synth

    cfg = hf.ExecConfig()
    q = frame(hf, synth, name)
    q.collect(cfg)
    torch.cuda.synchronize()
    os.makedirs(out, exist_ok=True)
    return chip_smoke.profile_run(torch, lambda: q.collect(cfg),
                                  os.path.join(out, f"profile_{name}.txt"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=str(ROOT / "build" / "sort_profile"))
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("queries", nargs="*", default=list(QUERIES))
    args = ap.parse_args(argv)
    if args.one:
        name = args.queries[0]
        print(json.dumps({"query": name, **profile_one(name, args.out)}),
              flush=True)
        return 0
    from repro_torch.kernels import cuda
    cuda.build_all()
    print(chip_smoke.nvidia_smi_line(), flush=True)
    for name in args.queries:
        subprocess.run([sys.executable, __file__, "--one", "--out", args.out,
                        name], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
