"""segment_sums: per-segment sums over sorted runs (group-by backend).

After the shuffle and the local sort, rows with equal keys form contiguous
runs numbered 0, 1, ... by ``seg_id``; every float sum and mean of a
group-by is a per-run sum of the valid rows.

Replaces the TPU kernel ``kernels/segment_reduce/segment_reduce.py``
(``value_scan_pallas`` and its scan-difference wrapper ``ops.py``) of the
reference package.  The CUDA kernel is ``csrc/segment_sums.cu``, which
reduces the runs directly (see its header).  Only slots ``[0, n_groups)`` are
meaningful to callers, who mask the rest by count; the kernel leaves them 0.
The registry hands CPU executors the plain version and CUDA executors the
kernel, which raises on anything but CUDA tensors.
"""
from __future__ import annotations

import torch

from .. import cuda


def segment_sums_plain(values: torch.Tensor, seg_id: torch.Tensor,
                       valid: torch.Tensor, num_segments: int) -> torch.Tensor:
    """The plain PyTorch version: ``index_add_`` into ``num_segments + 1``
    slots (the last one collects dropped rows), dtype-preserving like the
    reference's ``segment_sums_exact``."""
    v = torch.where(valid, values, torch.zeros((), dtype=values.dtype,
                                               device=values.device))
    drop = (seg_id < 0) | (seg_id > num_segments)
    idx = torch.where(drop, num_segments, seg_id).long()
    out = torch.zeros(num_segments + 1, dtype=values.dtype,
                      device=values.device)
    return out.index_add_(0, idx, v)[:num_segments]


def segment_sums_cuda(values: torch.Tensor, seg_id: torch.Tensor,
                      valid: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Launch the CUDA kernel: float32 values, int32 ids, bool validity."""
    cuda.require("segment_sums", values, (torch.float32,), "values")
    cuda.require("segment_sums", seg_id, (torch.int32,), "seg_id")
    cuda.require("segment_sums", valid, (torch.bool,), "valid")
    n = values.numel()
    if seg_id.numel() != n or valid.numel() != n:
        raise ValueError("segment_sums: values, seg_id and valid differ in "
                         "length")
    out = torch.empty(num_segments, dtype=torch.float32, device=values.device)
    if n == 0 or num_segments == 0:
        return out.zero_()
    lib = cuda.load("segment_sums")
    cuda.check(lib.segment_sums(values.data_ptr(), seg_id.data_ptr(),
                                valid.data_ptr(), out.data_ptr(), n,
                                num_segments, cuda.stream_of(values)),
               "segment_sums")
    cuda.launches["segment_sums"] += 1
    return out
