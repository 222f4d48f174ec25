"""segment_sums: per-segment sums over sorted runs (group-by backend).

After the shuffle and the local sort, rows with equal keys form contiguous
runs numbered 0, 1, ... by ``seg_id``; every float sum and mean of a
group-by is a per-run sum of the valid rows.

Contract: rows at or past ``count`` (a 0-d int32 tensor on the values'
device, the valid prefix; ``None`` means every row) contribute nothing and
are not read.  Every slot in ``[0, num_segments)`` that a row of the prefix
names gets its run's sum over the valid rows (0 for a run of invalid rows);
ids outside that range are dropped.  Slots no row names are undefined, as in
the reference's Pallas wrapper; callers mask them by their group count.

Replaces the TPU kernel ``kernels/segment_reduce/segment_reduce.py``
(``value_scan_pallas`` and its scan-difference wrapper ``ops.py``) of the
reference package.  The CUDA kernel is ``csrc/segment_sums.cu``: one launch
of a single-pass decoupled look-back that reads only the prefix, writes only
the run totals and gives the same bits on every call (see its header).  The
registry hands CPU executors the plain version and CUDA executors the kernel,
which raises on anything but CUDA tensors.
"""
from __future__ import annotations

import torch

from .. import cuda


def segment_sums_plain(values: torch.Tensor, seg_id: torch.Tensor,
                       valid: torch.Tensor, num_segments: int,
                       count: torch.Tensor | None = None) -> torch.Tensor:
    """The plain PyTorch version: ``index_add_`` into ``num_segments + 1``
    slots (the last one collects dropped rows and the rows past ``count``),
    dtype-preserving like the reference's ``segment_sums_exact``.  Slots no
    row names are 0."""
    keep = valid
    drop = (seg_id < 0) | (seg_id > num_segments)
    if count is not None:
        live = torch.arange(values.shape[0], device=values.device) < count
        keep = keep & live
        drop = drop | ~live
    v = torch.where(keep, values, torch.zeros((), dtype=values.dtype,
                                              device=values.device))
    idx = torch.where(drop, num_segments, seg_id).long()
    out = torch.zeros(num_segments + 1, dtype=values.dtype,
                      device=values.device)
    return out.index_add_(0, idx, v)[:num_segments]


def segment_sums_cuda(values: torch.Tensor, seg_id: torch.Tensor,
                      valid: torch.Tensor, num_segments: int,
                      count: torch.Tensor | None = None) -> torch.Tensor:
    """Launch the CUDA kernel: float32 values, int32 ids, bool validity, an
    optional 0-d int32 ``count`` on the same card.  Views whose data is not
    16-byte aligned run the same kernel with guarded loads in place of its
    TMA bulk copies."""
    if count is not None:
        cuda.require("segment_sums", count, (torch.int32,), "count", ndim=0)
    cuda.require("segment_sums", values, (torch.float32,), "values")
    cuda.require("segment_sums", seg_id, (torch.int32,), "seg_id")
    cuda.require("segment_sums", valid, (torch.bool,), "valid")
    n = values.numel()
    if seg_id.numel() != n or valid.numel() != n:
        raise ValueError("segment_sums: values, seg_id and valid differ in "
                         "length")
    if count is not None and count.device != values.device:
        raise ValueError(f"segment_sums: count on {count.device}, values on "
                         f"{values.device}")
    out = torch.empty(num_segments, dtype=torch.float32, device=values.device)
    if n == 0 or num_segments == 0:
        return out
    lib = cuda.load("segment_sums")
    # tile status words and the ticket; the kernel clears them on the stream
    scratch = torch.empty(lib.segment_sums_scratch_bytes(n), dtype=torch.uint8,
                          device=values.device)
    cuda.check(lib.segment_sums(
        values.data_ptr(), seg_id.data_ptr(), valid.data_ptr(),
        None if count is None else count.data_ptr(), out.data_ptr(),
        scratch.data_ptr(), n, num_segments,
        cuda.scan_load((values, seg_id, valid)), cuda.stream_of(values)),
        "segment_sums")
    cuda.launches["segment_sums"] += 1
    return out
