"""Time variants of the decode_attention kernel (``csrc/decode_attention.cu``)
on a card, against each other, against ``scaled_dot_product_attention``
and, with ``--parent``, against the kernel of another tree:

    python tools/decode_attention_study.py [--parent DIR] [--only NAME ...]

Source variants are the shipped source with a line replaced (the ring's
depth, the CUDA-core product in bfloat16 too), each built with nvcc
into its own directory under the build directory and called through its own
C entry point, apart from the library the package loads.  Plan variants call
the shipped library with another split plan (``split_plan``'s rule with
one block an SM, one split, two blocks an SM also where the (b, kv head)
pairs cover the SMs).  ``--parent DIR`` adds the ``decode_attention.cu`` of the tree
at DIR (a ``git archive`` of an earlier commit), called through the
interface it had before the split (``q, k, v, length, out, B, S, Hkv, G,
hd, bf16, scale, stream``: one block per (b, kv head)).

The inputs are the decode shapes of the LM paths in bfloat16 (B, S, Hkv, G,
hd), every row at length S: qwen2-vl-2b, qwen3-0.6b, deepseek-moe-16b,
zamba2-7b (hd 112), whisper-base's cross-attention over 1500 frames and its
self-attention over 128 rows.  First, each variant's device time a call at
each shape: its kernels summed over one torch.profiler window of 20 calls
(split and combine apart).  Then each variant is held against the plain
version at full and random lengths (|got - want| <= 2^-7 |want| + 2e-5)
and timed as ``chip_smoke.time_ms`` times a call (CUDA events over calls
back to back; the arguments are made before, so the host's share of a call
is the C call alone).  The variants run in turns, forward then backward,
three times; each prints one JSON line per round, and the medians over the
rounds come last.  SDPA (``enable_gqa``, a boolean
mask) is timed at each shape in each round.  With ``--parent``, the host
microseconds and the stream ms of one call of each tree's own wrapper
(checks, allocation, the C call; the parent's loaded beside this tree's)
are measured last, as a decode step calls it: a call a layer, each on its
own layer's view of stacked caches, in the order parent, this, this,
parent.  The card's name and power limit come first.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

from chip_smoke import host_us, nvidia_smi_line, time_ms  # noqa: E402
from repro_torch.kernels import cuda  # noqa: E402
from repro_torch.kernels.decode_attention import decode_attention as da  # noqa: E402

SHAPES = {
    "qwen2-vl-2b": (16, 2176, 2, 6, 128),
    "qwen3-0.6b": (32, 2176, 8, 2, 128),
    "deepseek-moe-16b": (16, 2176, 16, 1, 128),
    "zamba2-7b": (8, 2112, 32, 1, 112),
    "whisper-cross": (32, 1500, 8, 1, 64),
    "whisper-self": (32, 128, 8, 1, 64),
}
STAGES = "constexpr int STAGES = 2;"
MMA = "constexpr bool MMA = std::is_same<T, __nv_bfloat16>::value;"
# the one bfloat16 instance a layout (G at run time) serves the tensor-core
# path only; the CUDA-core product needs an instance for each G
DISPATCH = ("if constexpr (std::is_same<T, __nv_bfloat16>::value) {   "
            "// G only masks")
# library -> replacements in decode_attention.cu
L2 = "CU_TENSOR_MAP_L2_PROMOTION_L2_256B"
LIBS = {
    "shipped": (),
    "stages_3": ((STAGES, "constexpr int STAGES = 3;"),),
    "cuda_cores": ((MMA, "constexpr bool MMA = false;"),
                   (DISPATCH, "if constexpr (false) {")),
    "l2_none": ((L2, "CU_TENSOR_MAP_L2_PROMOTION_NONE"),),
}
# variant -> (library, split plan: "plan" for split_plan's, (blocks an SM,
# whether also where the pairs cover the SMs) for its rule with another
# target, None for one split)
VARIANTS = {
    "shipped": ("shipped", "plan"),
    "stages_3": ("stages_3", "plan"),
    "cuda_cores": ("cuda_cores", "plan"),
    "l2_none": ("l2_none", "plan"),
    "split_all": ("shipped", (da.BLOCKS_PER_SM, True)),
    "plan_x1": ("shipped", (1, False)),
    "one_split": ("shipped", None),
}
# the calls a decode step makes at each shape, each on its own layer's view
# of stacked caches: a layer each (whisper: each of self and cross), the
# hybrid's 14 shared applications
LAYER_VIEWS = {"qwen2-vl-2b": 28, "qwen3-0.6b": 28, "deepseek-moe-16b": 28,
               "zamba2-7b": 14, "whisper-cross": 6, "whisper-self": 6}
REPEATS = 6                  # rounds: forward, backward, three times each


def library(name: str) -> str:
    """The directory whose library variant ``name`` calls."""
    return "parent" if name == "parent" else VARIANTS[name][0]


def build(root: Path, names, parent: Path | None) -> dict:
    """One nvcc per library, all at once; directory name -> library."""
    dirs = sorted({library(n) for n in names})
    procs = []
    for d_name in dirs:
        d = root / d_name
        shutil.rmtree(d, ignore_errors=True)
        src_dir = (parent / "src/repro_torch/csrc") if d_name == "parent" \
            else cuda.CSRC
        shutil.copytree(src_dir, d)
        src = (d / "decode_attention.cu").read_text()
        for old, new in ([] if d_name == "parent" else LIBS[d_name]):
            if src.count(old) != 1:
                raise RuntimeError(f"{d_name}: {old!r} not once in the source")
            src = src.replace(old, new)
        (d / "decode_attention.cu").write_text(src)
        cmd = cuda.nvcc_command(d / "decode_attention.cu",
                                d / "libdecode_attention.so")
        procs.append((d_name, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    for d_name, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {d_name}:\n{log}")
    libs = {}
    for d_name in dirs:
        path = root / d_name / "libdecode_attention.so"
        if d_name == "parent":
            lib = ctypes.CDLL(str(path))
            lib.decode_attention.argtypes = [ctypes.c_void_p] * 5 + [
                ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p]
            lib.decode_attention.restype = ctypes.c_int
            libs[d_name] = lib
        else:
            libs[d_name] = cuda.bind(path, "decode_attention")
    return libs


def plan_of(name: str, q, k) -> tuple[int, int]:
    b, hkv, g, hd = q.shape
    s = k.shape[1]
    if name == "parent":
        return 1, s
    plan = VARIANTS[name][1]
    sms = da.sm_count(q.get_device())
    if plan is None:
        return 1, -(-s // da.TILE) * da.TILE
    if plan == "plan":
        return da.split_plan(b, hkv, s, g, hd, q.element_size(), sms)
    per_sm, always = plan                # split_plan's rule, another target
    want = 1 if b * hkv >= sms and not always else -(-per_sm * sms // (b * hkv))
    rows = max(da.min_split_rows(g, hd, q.element_size()), -(-s // want),
               -(-s // da.MAX_SPLITS))
    rows = -(-rows // da.TILE) * da.TILE
    return -(-s // rows), rows


def caller(name: str, lib, q, k, v, length):
    """The variant's C call on these inputs, its arguments made once (the
    output and workspace reused)."""
    b, hkv, g, hd = q.shape
    s = k.shape[1]
    bf16 = int(q.dtype == torch.bfloat16)
    scale = 1.0 / math.sqrt(hd)
    out = torch.empty_like(q)
    stream = cuda.stream_of(q)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), length.data_ptr(),
            out.data_ptr())
    ws = None
    if name == "parent":
        args = (*ptrs, b, s, hkv, g, hd, bf16, scale, stream)
    else:
        splits, rows = plan_of(name, q, k)
        if splits > 1:
            ws = torch.empty(b * hkv * splits * g * (hd + 2),
                             dtype=torch.float32, device=q.device)
        args = (*ptrs, None if ws is None else ws.data_ptr(), b, s, hkv, g,
                hd, bf16, scale, splits, rows, stream)
    fn = lib.decode_attention

    def call():
        cuda.check(fn(*args), name)
        return out
    call.workspace = ws                  # alive as long as the call
    return call


def inputs(dev) -> dict:
    g = torch.Generator(device=dev).manual_seed(3)
    data = {}
    for name, (b, s, hkv, gq, hd) in SHAPES.items():
        q = torch.randn((b, hkv, gq, hd), device=dev, generator=g).bfloat16()
        k, v = (torch.randn((b, s, hkv, hd), device=dev, generator=g).bfloat16()
                for _ in range(2))
        full = torch.full((b,), s, dtype=torch.int32, device=dev)
        rand = torch.randint(1, s + 1, (b,), device=dev, generator=g,
                             dtype=torch.int32)
        data[name] = (q, k, v, full, rand)
    return data


def sdpa_call(q, k, v):
    b, hkv, g, hd = q.shape
    s = k.shape[1]
    qs = q.reshape(b, hkv * g, 1, hd)
    ks, vs = (t.permute(0, 2, 1, 3).contiguous() for t in (k, v))
    mask = torch.ones((b, 1, 1, s), dtype=torch.bool, device=q.device)
    f = torch.nn.functional.scaled_dot_product_attention
    return lambda: f(qs, ks, vs, attn_mask=mask, enable_gqa=True)


def device_ms(fn, n: int = 20) -> dict:
    """One torch.profiler window over n calls: the device ms a call of the
    split kernel (the parent's one kernel) and of the combine, and the
    kernels a call launches."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):               # a window may come back without events
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        ms = {"split": 0.0, "combine": 0.0}
        launches = 0
        for e in prof.key_averages():
            if "decode_attention" in e.key and \
                    str(e.device_type).endswith("CUDA"):
                kind = "combine" if "combine" in e.key else "split"
                ms[kind] += getattr(e, "self_device_time_total", 0.0) / 1e3 / n
                launches += e.count
        if launches:
            break
    return {**ms, "total": ms["split"] + ms["combine"],
            "launches_a_call": launches / n}


def share_of_tolerance(got, want) -> float:
    d = (got.float() - want.float()).abs()
    return float((d / (2.0 ** -7 * want.float().abs() + 2e-5)).max())


def parent_wrapper(tree: Path, lib):
    """The wrapper ``decode_attention_cuda`` of the tree at ``tree``, loaded
    beside this tree's as the package ``parent_kernels`` (its ``cuda``
    module and its wrapper module, nothing else), calling ``lib``."""
    import importlib.util
    import types
    kernels = tree / "src/repro_torch/kernels"
    for name in ("parent_kernels", "parent_kernels.decode_attention"):
        pkg = types.ModuleType(name)
        pkg.__path__ = []
        sys.modules[name] = pkg

    def load(name, path):
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
        return mod
    pcuda = load("parent_kernels.cuda", kernels / "cuda.py")
    sys.modules["parent_kernels"].cuda = pcuda
    pcuda._libs["decode_attention"] = lib
    pda = load("parent_kernels.decode_attention.decode_attention",
               kernels / "decode_attention/decode_attention.py")
    return pda.decode_attention_cuda


def step_calls(data: dict, parent_fn, shipped) -> None:
    """Each tree's own wrapper called as a decode step calls it: a call a
    layer, each on its layer's view of stacked (L, B, S, Hkv, hd) caches
    (L = LAYER_VIEWS; the values are not read for the time), after one such
    step.  For each tree, in the order parent, this, this, parent, the host
    microseconds a call (``chip_smoke.host_us``) and the stream ms a call
    (``chip_smoke.time_ms``) at each shape; the larger of each tree's two
    turns last."""
    import itertools
    cuda._libs["decode_attention"] = shipped
    wrappers = {"parent": parent_fn, "this": da.decode_attention_cuda}
    turns: dict = {}
    for shape, (q, k, _v, full, _rand) in data.items():
        views = LAYER_VIEWS[shape]
        kst, vst = (torch.empty((views, *k.shape), dtype=k.dtype,
                                device=k.device) for _ in range(2))
        for who in ("parent", "this", "this", "parent"):
            fn, layer = wrappers[who], itertools.cycle(range(views))

            def step_call():
                i = next(layer)
                return fn(q, kst[i], vst[i], full)
            for _ in range(views):
                step_call()
            rec = {"step_calls": who, "shape": shape, "layer_views": views,
                   "host_us_a_call": host_us(torch, step_call),
                   "stream_ms_a_call": time_ms(step_call, torch)}
            print(json.dumps(rec), flush=True)
            turns.setdefault(who, {}).setdefault(shape, []).append(rec)
        del kst, vst
    print(json.dumps({"step_calls_larger": {
        who: {shape: {key: max(r[key] for r in recs)
                      for key in ("host_us_a_call", "stream_ms_a_call")}
              for shape, recs in by_shape.items()}
        for who, by_shape in turns.items()}}), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="a tree whose decode_attention.cu is timed beside")
    ap.add_argument("--only", nargs="*", default=None,
                    help="variants to run (default: all, and parent)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("decode_attention_study: needs a CUDA card")
    print(nvidia_smi_line(), flush=True)
    names = list(VARIANTS) + (["parent"] if args.parent else [])
    if args.only is not None:
        names = [v for v in names if v in args.only]
    root = cuda.build_dir() / "decode_attention_study"
    libs = build(root, names, args.parent)
    dev = torch.device("cuda")
    data = inputs(dev)
    want = {k: (da.decode_attention_plain(q, kk, v, full),
                da.decode_attention_plain(q, kk, v, rand))
            for k, (q, kk, v, full, rand) in data.items()}
    sdpa = {k: sdpa_call(q, kk, v) for k, (q, kk, v, _f, _r) in data.items()}
    # device times first: a process's later torch.profiler windows may
    # hold no device event (tools/profiler_probe.py)
    for name in names:
        lib = libs[library(name)]
        rec = {"variant": name, "device_ms": {}}
        for shape, (q, k, v, full, _rand) in data.items():
            rec["device_ms"][shape] = device_ms(caller(name, lib, q, k, v, full))
        print(json.dumps(rec), flush=True)
    order = (names + names[::-1]) * (REPEATS // 2)
    rounds: dict = {}
    for rnd, name in enumerate(order):
        lib = libs[library(name)]
        rec = {"variant": name, "round": rnd // len(names), "ms": {},
               "splits": {}, "max_share_of_tolerance": 0.0}
        for shape, (q, k, v, full, rand) in data.items():
            for lens, w in zip((full, rand), want[shape]):
                got = caller(name, lib, q, k, v, lens)()
                rec["max_share_of_tolerance"] = max(
                    rec["max_share_of_tolerance"], share_of_tolerance(got, w))
            assert rec["max_share_of_tolerance"] <= 1, (name, shape, rec)
            rec["splits"][shape] = plan_of(name, q, k)[0]
            rec["ms"][shape] = time_ms(caller(name, lib, q, k, v, full), torch)
        rec["sdpa_ms"] = {shape: time_ms(fn, torch) for shape, fn in sdpa.items()}
        print(json.dumps(rec), flush=True)
        rounds.setdefault(name, []).append(rec["ms"])
    # each variant's median over its rounds
    print(json.dumps({"median_ms": {
        name: {shape: sorted(r[shape] for r in recs)[len(recs) // 2]
               for shape in SHAPES} for name, recs in rounds.items()}}),
        flush=True)
    if args.parent:
        step_calls(data, parent_wrapper(args.parent, libs["parent"]),
                   libs["shipped"])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
