"""bucket_scatter: stable within-bucket slots for the shuffle.

The exchange places row i into slot ``rank(i)`` of bucket ``dest(i)``, where
the rank is the row's stable position among the rows of its bucket, so rows
scatter straight into the send buffer with source order preserved.  Bucket
ids lie in [0, P]; ``dest == P`` marks an invalid row, whose slot is
don't-care and which is counted nowhere.

Replaces the TPU kernel ``kernels/hash_partition/hash_partition.py``
(``bucket_ranks_pallas``) of the reference package.  The CUDA kernel is
``csrc/bucket_scatter.cu`` (a stable radix-partition step, P <= 256; see its
header).  The registry hands CPU executors the plain version and CUDA
executors the kernel, which raises on anything but a CUDA tensor.
"""
from __future__ import annotations

import torch

from .. import cuda


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
    """Launch the CUDA kernel on a 1-D int32 CUDA tensor."""
    cuda.require("bucket_scatter", dest, (torch.int32,), "dest")
    lib = cuda.load("bucket_scatter")
    if not 1 <= P <= lib.bucket_scatter_max_p():
        raise ValueError(f"bucket_scatter: P={P} outside "
                         f"[1, {lib.bucket_scatter_max_p()}]")
    n = dest.numel()
    ranks = torch.empty(n, dtype=torch.int32, device=dest.device)
    counts = torch.empty(P, dtype=torch.int32, device=dest.device)
    if n == 0:
        return ranks, counts.zero_()
    tile = lib.bucket_scatter_tile()
    scratch = torch.empty(P * -(-n // tile), dtype=torch.int32,
                          device=dest.device)
    cuda.check(lib.bucket_scatter(dest.data_ptr(), ranks.data_ptr(),
                                  counts.data_ptr(), scratch.data_ptr(), n, P,
                                  cuda.stream_of(dest)), "bucket_scatter")
    cuda.launches["bucket_scatter"] += 1
    return ranks, counts
