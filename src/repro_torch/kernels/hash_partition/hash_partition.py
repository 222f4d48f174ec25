"""bucket_scatter: stable within-bucket slots for the shuffle.

The exchange places row i into slot ``rank(i)`` of bucket ``dest(i)``, where
the rank is the row's stable position among the rows of its bucket, so rows
scatter straight into the send buffer with source order preserved.  Bucket
ids lie in [0, P]; ``dest == P`` marks an invalid row, whose slot is
don't-care and which is counted nowhere.

Replaces the TPU kernel ``kernels/hash_partition/hash_partition.py``
(``bucket_ranks_pallas``) of the reference package.  The CUDA kernel is
``csrc/bucket_scatter.cu``: one launch of a single-pass decoupled look-back
over P counts, which reads ``dest`` once and writes the slots once, for P up
to :data:`MAX_P` (see its header for the design and the bound).  The
registry hands CPU executors the plain version and CUDA executors the
kernel, which raises on anything but a CUDA tensor.
"""
from __future__ import annotations

import torch

from .. import cuda

# the most buckets the kernel takes (csrc/bucket_scatter.cu MAX_P)
MAX_P = 2048


def bucket_scatter_plain(dest: torch.Tensor, P: int):
    """The plain PyTorch version: a stable argsort plus a bincount, as the
    reference's ``bucket_ranks_argsort``.  Returns ``(slot, counts)``."""
    n = dest.shape[0]
    order = torch.argsort(dest, stable=True)
    sdest = dest[order]
    counts = torch.bincount(dest, minlength=P + 1)[:P].to(torch.int32)
    offs = torch.cumsum(counts, 0, dtype=torch.int32) - counts
    slot_sorted = (torch.arange(n, dtype=torch.int32, device=dest.device)
                   - offs[sdest.clamp(0, max(P - 1, 0)).long()])
    ranks = torch.zeros(n, dtype=torch.int32, device=dest.device)
    ranks[order] = slot_sorted
    return ranks, counts


def bucket_scatter_cuda(dest: torch.Tensor, P: int):
    """Launch the CUDA kernel on a 1-D int32 CUDA tensor (contiguous, or a
    slice of one: a view whose data is not 16-byte aligned is staged with
    4-byte loads in place of the TMA bulk copy), for 1 <= P <= MAX_P."""
    if not 1 <= P <= MAX_P:
        raise ValueError(f"bucket_scatter: P={P} outside [1, {MAX_P}]")
    cuda.require("bucket_scatter", dest, (torch.int32,), "dest")
    n = dest.numel()
    if n >= 2**31:
        raise ValueError(f"bucket_scatter: {n} rows; int32 slots hold < 2^31")
    slot = torch.empty(n, dtype=torch.int32, device=dest.device)
    counts = torch.empty(P, dtype=torch.int32, device=dest.device)
    if n == 0:
        return slot, counts.zero_()
    lib = cuda.load("bucket_scatter")
    # status words of P buckets a tile and the ticket; the kernel clears
    # them on the stream
    scratch = torch.empty(lib.bucket_scatter_scratch_bytes(n, P),
                          dtype=torch.uint8, device=dest.device)
    cuda.check(lib.bucket_scatter(dest.data_ptr(), slot.data_ptr(),
                                  counts.data_ptr(), scratch.data_ptr(), n, P,
                                  cuda.scan_load((dest,)),
                                  cuda.stream_of(dest)), "bucket_scatter")
    cuda.launches["bucket_scatter"] += 1
    return slot, counts
