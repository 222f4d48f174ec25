"""stencil1d: the paper's 1-D weighted window (SMA, WMA, lag, lead, rolling
sums and means) over a halo-extended float32 array, in three primitives:

  stencil1d(ext, weights)                out[i] = sum_j w[j] * ext[i + j]
  stencil1d_exact(ext, ext_m, weights)   the same, renormalized by
                                         sum(w) / mass, mass the same stencil
                                         of ``ext_m``; 0 where the mass is 0
  segment_stencil(ext, ext_s, weights, center, exact)
                                         tap j counts only where
                                         ext_s[i + j] == ext_s[i + center]
                                         (optionally renormalized likewise)

for i in [0, len(ext) - K + 1), K = len(weights).

Replace the TPU kernels ``stencil1d_pallas``, ``stencil1d_exact_pallas`` and
``segment_stencil_pallas`` of the reference package's
``kernels/stencil1d/stencil1d.py``.  All three CUDA kernels are one template
in ``csrc/stencil1d.cu``, with the weights as a run-time device array, so K
is unbounded; each block stages its span by TMA bulk copies (16-byte aligned
data) or 4-byte loads (views that are not) and slides a register window
along it (see its header).  The plain versions are the reference's tap
loops in the same tap order, each tap a separate float32 multiply and add,
and the kernels compute the same operations, bit for bit.  The registry
hands CPU executors the plain versions and CUDA executors the kernels, which
raise on anything but CUDA tensors.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .. import cuda


def _taps(weights: Sequence[float]) -> list[float]:
    """The weights rounded to float32 (as Python floats, exactly)."""
    w = [float(np.float32(v)) for v in weights]
    if not w:
        raise ValueError("stencil: at least one weight")
    return w


def _total(weights: Sequence[float]) -> float:
    """sum(w) in float64, rounded once to float32 (the reference's)."""
    return float(np.float32(sum(float(v) for v in weights)))


def _renorm(acc: torch.Tensor, mass: torch.Tensor, total: float) -> torch.Tensor:
    safe = torch.where(mass != 0.0, mass, 1.0)
    return torch.where(mass != 0.0, acc * total / safe, 0.0)


def _out_len(ext: torch.Tensor, k: int) -> int:
    n = ext.shape[0] - (k - 1)
    if n < 0:
        raise ValueError(f"stencil: {ext.shape[0]} extended rows cannot hold "
                         f"a {k}-tap window")
    return n


def stencil1d_plain(ext: torch.Tensor, weights: Sequence[float]) -> torch.Tensor:
    """The plain PyTorch version: K shifted multiply-adds."""
    w = _taps(weights)
    n = _out_len(ext, len(w))
    ext = ext.to(torch.float32)
    out = torch.zeros(n, dtype=torch.float32, device=ext.device)
    for j, wj in enumerate(w):
        out = out + ext[j:j + n] * wj
    return out


def stencil1d_exact_plain(ext: torch.Tensor, ext_m: torch.Tensor,
                          weights: Sequence[float]) -> torch.Tensor:
    """Two plain stencils (values and mask mass) and a renormalize."""
    return _renorm(stencil1d_plain(ext, weights),
                   stencil1d_plain(ext_m, weights), _total(weights))


def segment_stencil_plain(ext: torch.Tensor, ext_s: torch.Tensor,
                          weights: Sequence[float], center: int,
                          exact: bool = False) -> torch.Tensor:
    """The tap loop with segment-id equality masking."""
    w = _taps(weights)
    n = _out_len(ext, len(w))
    ext = ext.to(torch.float32)
    sid = ext_s[center:center + n]
    acc = torch.zeros(n, dtype=torch.float32, device=ext.device)
    mass = torch.zeros(n, dtype=torch.float32, device=ext.device)
    for j, wj in enumerate(w):
        same = ext_s[j:j + n] == sid
        acc = acc + torch.where(same, ext[j:j + n], 0.0) * wj
        if exact:
            mass = mass + same.to(torch.float32) * wj
    return _renorm(acc, mass, _total(weights)) if exact else acc


def _weights_on(w: list[float], device) -> torch.Tensor:
    """The K weights as a float32 array on the card, copied per launch."""
    return torch.tensor(w, dtype=torch.float32, device=device)


def stencil1d_cuda(ext: torch.Tensor, weights: Sequence[float]) -> torch.Tensor:
    """Launch the CUDA kernel on a float32 extended array."""
    cuda.require("stencil1d", ext, (torch.float32,), "ext")
    w = _taps(weights)
    n = _out_len(ext, len(w))
    out = torch.empty(n, dtype=torch.float32, device=ext.device)
    if n == 0:
        return out
    lib = cuda.load("stencil1d")
    wd = _weights_on(w, ext.device)
    cuda.check(lib.stencil1d(ext.data_ptr(), wd.data_ptr(), out.data_ptr(), n,
                             len(w), cuda.scan_load((ext, out)),
                             cuda.stream_of(ext)), "stencil1d")
    cuda.launches["stencil1d"] += 1
    return out


def stencil1d_exact_cuda(ext: torch.Tensor, ext_m: torch.Tensor,
                         weights: Sequence[float]) -> torch.Tensor:
    """Launch the fused stencil-and-renormalize kernel."""
    cuda.require("stencil1d_exact", ext, (torch.float32,), "ext")
    cuda.require("stencil1d_exact", ext_m, (torch.float32,), "ext_m")
    if ext_m.numel() != ext.numel():
        raise ValueError("stencil1d_exact: ext and ext_m differ in length")
    w = _taps(weights)
    n = _out_len(ext, len(w))
    out = torch.empty(n, dtype=torch.float32, device=ext.device)
    if n == 0:
        return out
    lib = cuda.load("stencil1d")
    wd = _weights_on(w, ext.device)
    cuda.check(lib.stencil1d_exact(ext.data_ptr(), ext_m.data_ptr(),
                                   wd.data_ptr(), out.data_ptr(), n, len(w),
                                   _total(weights),
                                   cuda.scan_load((ext, ext_m, out)),
                                   cuda.stream_of(ext)),
               "stencil1d_exact")
    cuda.launches["stencil1d_exact"] += 1
    return out


def segment_stencil_cuda(ext: torch.Tensor, ext_s: torch.Tensor,
                         weights: Sequence[float], center: int,
                         exact: bool = False) -> torch.Tensor:
    """Launch the partition-masked stencil kernel (int32 segment ids)."""
    cuda.require("segment_stencil", ext, (torch.float32,), "ext")
    cuda.require("segment_stencil", ext_s, (torch.int32,), "ext_s")
    if ext_s.numel() != ext.numel():
        raise ValueError("segment_stencil: ext and ext_s differ in length")
    w = _taps(weights)
    if not 0 <= center < len(w):
        raise ValueError(f"segment_stencil: center {center} outside the "
                         f"{len(w)} taps")
    n = _out_len(ext, len(w))
    out = torch.empty(n, dtype=torch.float32, device=ext.device)
    if n == 0:
        return out
    lib = cuda.load("stencil1d")
    wd = _weights_on(w, ext.device)
    cuda.check(lib.segment_stencil(ext.data_ptr(), ext_s.data_ptr(),
                                   wd.data_ptr(), out.data_ptr(), n, len(w),
                                   int(center), int(bool(exact)),
                                   _total(weights),
                                   cuda.scan_load((ext, ext_s, out)),
                                   cuda.stream_of(ext)),
               "segment_stencil")
    cuda.launches["segment_stencil"] += 1
    return out
