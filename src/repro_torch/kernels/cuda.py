"""Build, load and launch the hand-written CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface, loaded through ``ctypes``: no PyTorch
headers, so a build takes seconds.  Libraries are built at first use into
``build/kernels`` at the root of the checkout (``$REPRO_TORCH_BUILD``
overrides it) and rebuilt when their source is newer.  :func:`build_all`
starts one ``nvcc`` per source, all at once, and waits for them;
:func:`start_builds` only starts them, and :func:`load` waits for the one
it needs.

Every C entry point returns ``cudaGetLastError()`` after its launches;
:func:`check` raises on anything but 0, so a refused launch never passes
silently.  :data:`launches` counts, per registry name, the wrapper calls
that launched the kernel on the card (one source may hold several kernels:
``stencil1d.cu`` holds stencil1d, stencil1d_exact and segment_stencil).
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("prefix_sum", "bucket_scatter", "segment_sums", "segment_scan",
           "segment_rank", "stencil1d", "decode_attention")
# registry names, one launch counter each
KERNELS = ("prefix_sum", "bucket_scatter", "segment_sums", "segment_scan",
           "segment_rank", "stencil1d", "stencil1d_exact", "segment_stencil",
           "decode_attention", "decode_attention_partial",
           "decode_attention_merge")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

launches: dict[str, int] = {name: 0 for name in KERNELS}
_libs: dict[str, ctypes.CDLL] = {}

_VP = ctypes.c_void_p
_LL = ctypes.c_longlong
_INT = ctypes.c_int
_F32 = ctypes.c_float
# C signatures (argument types; every function returns int, except the
# scratch sizes in _LONG)
_SIGNATURES = {
    "prefix_sum": {"prefix_sum_scratch_bytes": (_LL,),
                   "prefix_sum_i32": (_VP, _VP, _VP, _LL, _INT, _VP),
                   "prefix_sum_f32": (_VP, _VP, _VP, _LL, _INT, _VP)},
    "bucket_scatter": {"bucket_scatter_tile": (_INT,),
                       "bucket_scatter_max_p": (),
                       "bucket_scatter_scratch_bytes": (_LL, _INT),
                       "bucket_scatter": (_VP, _VP, _VP, _VP, _LL, _INT, _INT,
                                          _VP)},
    "segment_sums": {"segment_sums_scratch_bytes": (_LL,),
                     "segment_sums": (_VP, _VP, _VP, _VP, _VP, _VP, _LL, _INT,
                                      _INT, _VP)},
    "segment_scan": {"segment_scan_scratch_bytes": (_LL,),
                     "segment_scan_i32": (_VP, _VP, _VP, _VP, _LL, _INT, _VP),
                     "segment_scan_f32": (_VP, _VP, _VP, _VP, _LL, _INT, _VP)},
    "segment_rank": {"segment_rank_scratch_bytes": (_LL,),
                     "segment_rank": (_VP, _VP, _VP, _VP, _LL, _INT, _INT,
                                      _VP)},
    "stencil1d": {"stencil1d": (_VP, _VP, _VP, _LL, _INT, _INT, _VP),
                  "stencil1d_exact": (_VP, _VP, _VP, _VP, _LL, _INT, _F32, _INT,
                                      _VP),
                  "segment_stencil": (_VP, _VP, _VP, _VP, _LL, _INT, _INT, _INT,
                                      _F32, _INT, _VP)},
    "decode_attention": {"decode_attention": (_VP, _VP, _VP, _VP, _VP, _VP, _INT,
                                              _INT, _INT, _INT, _INT, _INT, _F32,
                                              _INT, _INT, _VP),
                         "decode_attention_partial": (_VP, _VP, _VP, _VP, _VP,
                                                      _VP, _INT, _INT, _INT,
                                                      _INT, _INT, _INT, _F32,
                                                      _INT, _INT, _VP),
                         "decode_attention_merge": (_VP, _VP, _INT, _INT, _INT,
                                                    _INT, _INT, _VP)},
}
_LONG = ("prefix_sum_scratch_bytes", "segment_scan_scratch_bytes",
         "segment_rank_scratch_bytes", "bucket_scatter_scratch_bytes",
         "segment_sums_scratch_bytes")


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD")
    if env:
        return Path(env)
    return CSRC.parents[2] / "build" / "kernels"


def _nvcc() -> str:
    # torch's lookup: $CUDA_HOME / $CUDA_PATH, then nvcc on PATH, then the
    # toolkit's default install location
    from torch.utils.cpp_extension import CUDA_HOME
    nvcc = Path(CUDA_HOME or "") / "bin" / "nvcc"
    if not CUDA_HOME or not nvcc.exists():
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return str(nvcc)


def _lib_path(name: str) -> Path:
    return build_dir() / f"lib{name}.so"


def _stale(name: str) -> bool:
    lib = _lib_path(name)
    if not lib.exists():
        return True
    newest = max(p.stat().st_mtime for p in
                 (CSRC / f"{name}.cu", *CSRC.glob("*.cuh")))
    return lib.stat().st_mtime < newest


def nvcc_command(src: Path, lib: Path, extra: tuple = ()) -> list[str]:
    """The ``nvcc`` command that builds the library ``lib`` from the source
    ``src``, with the headers beside it."""
    return [_nvcc(), *NVCC_FLAGS, *extra, "-I", str(src.parent), "-o",
            str(lib), str(src)]


def _start_build(name: str, extra: tuple = ()) -> tuple[subprocess.Popen, Path]:
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    tmp = out / f"lib{name}.so.{os.getpid()}.tmp"
    cmd = nvcc_command(CSRC / f"{name}.cu", tmp, extra)
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp


def _finish_build(name: str, proc: subprocess.Popen, tmp: Path) -> str:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    tmp.replace(_lib_path(name))
    return log


# builds started by start_builds and not yet waited for: name -> (process,
# temporary library); the compilers' output of those finished
_pending: dict[str, tuple[subprocess.Popen, Path]] = {}
_build_logs: list[str] = []


def start_builds(force: bool = False, verbose: bool = False) -> None:
    """Start one ``nvcc`` per stale source, all at once, without waiting:
    :func:`load` waits for a library's own build when it is first needed,
    so the other kernels can run while the longest source compiles.  With
    ``verbose``, ptxas reports registers and shared memory per kernel."""
    extra = ("-Xptxas", "-v") if verbose else ()
    for name in SOURCES:
        if name not in _pending and (force or _stale(name)):
            _pending[name] = _start_build(name, extra)


def finish_builds() -> str:
    """Wait for every started build; the compilers' output so far."""
    for name in list(_pending):
        _build_logs.append(_finish_build(name, *_pending.pop(name)))
    return "".join(_build_logs)


def build_all(force: bool = False, verbose: bool = False) -> tuple[float, str]:
    """Build every stale kernel library, one ``nvcc`` per source in
    parallel.  Returns the wall seconds spent and the compiler's output
    (with ``verbose``, ptxas's registers and shared memory per kernel)."""
    t0 = time.perf_counter()
    start_builds(force, verbose)
    logs = finish_builds()
    return time.perf_counter() - t0, logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed (or its
    started build waited for)."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    if name in _pending:
        _build_logs.append(_finish_build(name, *_pending.pop(name)))
    elif _stale(name):
        _finish_build(name, *_start_build(name))
    lib = bind(_lib_path(name), name)
    _libs[name] = lib
    return lib


def bind(path: Path, name: str) -> ctypes.CDLL:
    """Load the library at ``path`` with the C signatures of kernel
    ``name``."""
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in _SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = list(argtypes)
        f.restype = _LL if fn in _LONG else ctypes.c_int
    return lib


def check(code: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if code != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: error "
                           f"{code} ({torch.cuda.get_device_name()})")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def require(name: str, t: torch.Tensor, dtypes: tuple, what: str,
            ndim: int = 1) -> None:
    """Check a kernel input: one of ``dtypes``, ``ndim`` dimensions,
    contiguous, on the card (in this order, so that every refusal but the
    last shows without a card)."""
    if t.dtype not in dtypes:
        raise ValueError(f"{name}: {what} dtype {t.dtype} not in {dtypes}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: {what} must be {ndim}-D, got shape "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: {what} must be contiguous")
    if t.device.type != "cuda":
        raise ValueError(f"{name}: {what} must be a CUDA tensor, got {t.device}")


# how the look-back scans (csrc/lookback.cuh), segment_sums, bucket_scatter
# and the stencils (csrc/stencil1d.cu) fetch a tile into shared memory: TMA
# bulk copies (16-byte aligned data) or guarded loads of 4 (1) bytes
BULK, WORDS = 0, 1


def scan_load(ts: tuple) -> int:
    """The fetch of a kernel over ``ts``: BULK if every tensor's data starts
    on a 16-byte boundary, else WORDS."""
    return BULK if all(t.data_ptr() % 16 == 0 for t in ts) else WORDS


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0
