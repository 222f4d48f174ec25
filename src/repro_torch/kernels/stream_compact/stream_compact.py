"""prefix_sum: inclusive, dtype-preserving prefix sum (stream compaction).

Filter is the paper's no-communication operator: each shard moves its kept
rows into a dense prefix, and the prefix sum of the keep flags assigns their
slots.  The same scan runs at the receive side of every exchange.

Replaces the TPU kernel ``kernels/stream_compact/stream_compact.py``
(``prefix_sum_pallas``) of the reference package.  The CUDA kernel is
``csrc/prefix_sum.cu``: one launch of the single-pass decoupled look-back
scan of ``csrc/lookback.cuh``, which reads the input once and writes the
output once (see its header for the design and the bound).  The registry
hands CPU executors the plain version and CUDA executors the kernel, which
raises on anything but a CUDA tensor.
"""
from __future__ import annotations

import torch

from .. import cuda

DTYPES = (torch.int32, torch.float32)


def prefix_sum_plain(x: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version (``torch.cumsum`` keeping the dtype)."""
    return torch.cumsum(x, 0, dtype=x.dtype)


def prefix_sum_cuda(x: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on a 1-D int32/float32 CUDA tensor.  A view
    whose data is not 16-byte aligned runs the same kernel with 4-byte
    loads in place of its TMA bulk copies."""
    cuda.require("prefix_sum", x, DTYPES, "x")
    out = torch.empty_like(x)
    n = x.numel()
    if n == 0:
        return out
    lib = cuda.load("prefix_sum")
    # tile status words and the ticket; the kernel clears them on the stream
    scratch = torch.empty(lib.prefix_sum_scratch_bytes(n), dtype=torch.uint8,
                          device=x.device)
    fn = lib.prefix_sum_i32 if x.dtype == torch.int32 else lib.prefix_sum_f32
    cuda.check(fn(x.data_ptr(), out.data_ptr(), scratch.data_ptr(), n,
                  cuda.scan_load((x, out)),
                  cuda.stream_of(x)), "prefix_sum")
    cuda.launches["prefix_sum"] += 1
    return out
