"""Build, load and launch the hand-written CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface, loaded through ``ctypes``: no PyTorch
headers, so a build takes seconds.  Libraries are built at first use into
``build/kernels`` at the root of the checkout (``$REPRO_TORCH_BUILD``
overrides it) and rebuilt when their source is newer.  :func:`build_all`
starts one ``nvcc`` per source, all at once.

Every C entry point returns ``cudaGetLastError()`` after its launches;
:func:`check` raises on anything but 0, so a refused launch never passes
silently.  :data:`launches` counts, per kernel name, the wrapper calls that
launched the kernel on the card.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("prefix_sum", "bucket_scatter", "segment_sums")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

launches: dict[str, int] = {name: 0 for name in SOURCES}
_libs: dict[str, ctypes.CDLL] = {}

_VP = ctypes.c_void_p
_LL = ctypes.c_longlong
_INT = ctypes.c_int
# C signatures (argument types; every function returns int)
_SIGNATURES = {
    "prefix_sum": {"prefix_sum_tile": (),
                   "prefix_sum_i32": (_VP, _VP, _VP, _LL, _VP),
                   "prefix_sum_f32": (_VP, _VP, _VP, _LL, _VP)},
    "bucket_scatter": {"bucket_scatter_tile": (),
                       "bucket_scatter_max_p": (),
                       "bucket_scatter": (_VP, _VP, _VP, _VP, _LL, _INT, _VP)},
    "segment_sums": {"segment_sums": (_VP, _VP, _VP, _VP, _LL, _INT, _VP)},
}


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
                 (CSRC / f"{name}.cu", CSRC / "common.cuh"))
    return lib.stat().st_mtime < newest


def _start_build(name: str, extra: tuple = ()) -> tuple[subprocess.Popen, Path]:
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    tmp = out / f"lib{name}.so.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, *extra, "-I", str(CSRC), "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp


def _finish_build(name: str, proc: subprocess.Popen, tmp: Path) -> str:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    tmp.replace(_lib_path(name))
    return log


def build_all(force: bool = False, verbose: bool = False) -> tuple[float, str]:
    """Build every stale kernel library, one ``nvcc`` per source in
    parallel.  Returns the wall seconds spent and the compiler's output
    (with ``verbose``, ptxas's registers and shared memory per kernel)."""
    t0 = time.perf_counter()
    extra = ("-Xptxas", "-v") if verbose else ()
    todo = [n for n in SOURCES if force or _stale(n)]
    started = [(n, *_start_build(n, extra)) for n in todo]
    logs = [_finish_build(name, proc, tmp) for name, proc, tmp in started]
    return time.perf_counter() - t0, "".join(logs)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    if _stale(name):
        _finish_build(name, *_start_build(name))
    lib = ctypes.CDLL(str(_lib_path(name)))
    for fn, argtypes in _SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = list(argtypes)
        f.restype = ctypes.c_int
    _libs[name] = lib
    return lib


def check(code: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if code != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: error "
                           f"{code} ({torch.cuda.get_device_name()})")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def require(name: str, t: torch.Tensor, dtypes: tuple, what: str) -> None:
    """Check a kernel input: on the card, 1-D, contiguous, one of ``dtypes``."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: {what} must be a CUDA tensor, got {t.device}")
    if t.dim() != 1:
        raise ValueError(f"{name}: {what} must be 1-D, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: {what} must be contiguous")
    if t.dtype not in dtypes:
        raise ValueError(f"{name}: {what} dtype {t.dtype} not in {dtypes}")


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0
