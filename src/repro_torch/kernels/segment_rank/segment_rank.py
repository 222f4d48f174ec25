"""segment_rank: 1-based in-segment ``row_number``, ``rank`` or
``dense_rank`` (int32) from two head masks.

``seg_b[i] != 0`` starts a segment (a partition group); ``ord_b[i] != 0``
starts a run of equal order keys.  Every segment head also heads a run (the
physical layer's ``run_starts`` gives that), so ties share a rank.

Replaces the TPU kernel ``kernels/segment_rank/segment_rank.py``
(``segment_rank_pallas``) of the reference package.  The CUDA kernel is
``csrc/segment_rank.cu``: carry-free running maxima and a segmented count,
in one launch of the single-pass decoupled look-back scan of
``csrc/lookback.cuh``, which reads each mask once and writes the ranks once
(see its header).  The registry hands CPU executors the plain version and
CUDA executors the kernel, which raises on anything but CUDA tensors.
"""
from __future__ import annotations

import torch

from .. import cuda

KINDS = ("row_number", "rank", "dense_rank")


def _first_index(heads: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Index of the latest head at or before each row (0 before the first)."""
    return torch.cummax(torch.where(heads != 0, idx, 0), 0).values


def segment_rank_plain(seg_b: torch.Tensor, ord_b: torch.Tensor,
                       kind: str) -> torch.Tensor:
    """The plain PyTorch version: the reference's absolute-index
    composition from running maxima of head indices."""
    if kind not in KINDS:
        raise ValueError(f"unknown rank kind: {kind!r}")
    n = seg_b.shape[0]
    if n == 0:
        return torch.zeros(0, dtype=torch.int32, device=seg_b.device)
    idx = torch.arange(n, dtype=torch.int32, device=seg_b.device)
    seg_first = _first_index(seg_b, idx)
    if kind == "row_number":
        return idx - seg_first + 1
    if kind == "dense_rank":
        runs = torch.cumsum((ord_b != 0).to(torch.int32), 0, dtype=torch.int32)
        return runs - runs[seg_first.long()] + 1
    return _first_index(ord_b, idx) - seg_first + 1


def segment_rank_cuda(seg_b: torch.Tensor, ord_b: torch.Tensor,
                      kind: str) -> torch.Tensor:
    """Launch the CUDA kernel on two int32 head masks.  Views whose data is
    not 16-byte aligned run the same kernel with 4-byte loads in place of
    its TMA bulk copies."""
    if kind not in KINDS:
        raise ValueError(f"unknown rank kind: {kind!r}")
    cuda.require("segment_rank", seg_b, (torch.int32,), "seg_b")
    cuda.require("segment_rank", ord_b, (torch.int32,), "ord_b")
    n = seg_b.numel()
    if ord_b.numel() != n:
        raise ValueError("segment_rank: seg_b and ord_b differ in length")
    if n >= 2**31:
        raise ValueError("segment_rank: at most 2^31 - 1 rows (int32 ranks)")
    out = torch.empty(n, dtype=torch.int32, device=seg_b.device)
    if n == 0:
        return out
    lib = cuda.load("segment_rank")
    # tile status words and the ticket; the kernel clears them on the stream
    scratch = torch.empty(lib.segment_rank_scratch_bytes(n), dtype=torch.uint8,
                          device=seg_b.device)
    cuda.check(lib.segment_rank(seg_b.data_ptr(), ord_b.data_ptr(),
                                out.data_ptr(), scratch.data_ptr(), n,
                                KINDS.index(kind),
                                cuda.scan_load((seg_b, ord_b, out)),
                                cuda.stream_of(seg_b)), "segment_rank")
    cuda.launches["segment_rank"] += 1
    return out
