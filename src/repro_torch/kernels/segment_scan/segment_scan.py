"""segment_scan: segmented inclusive sum (the partitioned-cumsum backbone).

``out[i]`` is the running sum of ``x`` within the segment holding row i;
``boundary[i] != 0`` starts a segment.  The output keeps the dtype of ``x``
(int32 exact modulo 2^32, or float32).

Replaces the TPU kernel ``kernels/segment_scan/segment_scan.py``
(``segment_scan_pallas``) of the reference package.  The CUDA kernel is
``csrc/segment_scan.cu``: the segmented monoid in one launch of the
single-pass decoupled look-back scan of ``csrc/lookback.cuh``, which reads
x and boundary once and writes the sums once (see its header).  Its float32
sums come out with the same bits on every call.  The registry hands CPU
executors the plain version and CUDA executors the kernel, which raises on
anything but CUDA tensors.
"""
from __future__ import annotations

import torch

from .. import cuda

DTYPES = (torch.int32, torch.float32)


def segment_scan_plain(x: torch.Tensor, boundary: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version, the reference's composition: an inclusive
    cumsum minus the running total just before each row's segment head,
    whose index is a running max of head indices."""
    n = x.shape[0]
    if n == 0:
        return x.clone()
    incl = torch.cumsum(x, 0, dtype=x.dtype)
    idx = torch.arange(n, dtype=torch.int64, device=x.device)
    first = torch.cummax(torch.where(boundary != 0, idx, 0), 0).values
    base = torch.where(first > 0, incl[(first - 1).clamp(min=0)],
                       torch.zeros((), dtype=x.dtype, device=x.device))
    return incl - base


def segment_scan_cuda(x: torch.Tensor, boundary: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel: int32/float32 ``x``, int32 ``boundary``.
    Views whose data is not 16-byte aligned run the same kernel with 4-byte
    loads in place of its TMA bulk copies."""
    cuda.require("segment_scan", x, DTYPES, "x")
    cuda.require("segment_scan", boundary, (torch.int32,), "boundary")
    n = x.numel()
    if boundary.numel() != n:
        raise ValueError("segment_scan: x and boundary differ in length")
    out = torch.empty_like(x)
    if n == 0:
        return out
    lib = cuda.load("segment_scan")
    # tile status words and the ticket; the kernel clears them on the stream
    scratch = torch.empty(lib.segment_scan_scratch_bytes(n), dtype=torch.uint8,
                          device=x.device)
    fn = lib.segment_scan_i32 if x.dtype == torch.int32 else lib.segment_scan_f32
    cuda.check(fn(x.data_ptr(), boundary.data_ptr(), out.data_ptr(),
                  scratch.data_ptr(), n, cuda.scan_load((x, boundary, out)),
                  cuda.stream_of(x)), "segment_scan")
    cuda.launches["segment_scan"] += 1
    return out
