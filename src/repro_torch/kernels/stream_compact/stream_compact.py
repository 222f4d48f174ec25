"""prefix_sum: inclusive, dtype-preserving prefix sum (stream compaction).

Filter is the paper's no-communication operator: each shard moves its kept
rows into a dense prefix, and the prefix sum of the keep flags assigns their
slots.  The same scan runs at the receive side of every exchange.

Replaces the TPU kernel ``kernels/stream_compact/stream_compact.py``
(``prefix_sum_pallas``) of the reference package.  The CUDA kernel is
``csrc/prefix_sum.cu`` (reduce-then-scan; see its header for the design and
the bound).  The registry hands CPU executors the plain version and CUDA
executors the kernel, which raises on anything but a CUDA tensor.
"""
from __future__ import annotations

import torch

from .. import cuda

DTYPES = (torch.int32, torch.float32)


def prefix_sum_plain(x: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version (``torch.cumsum`` keeping the dtype)."""
    return torch.cumsum(x, 0, dtype=x.dtype)


def prefix_sum_cuda(x: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on a 1-D int32/float32 CUDA tensor."""
    cuda.require("prefix_sum", x, DTYPES, "x")
    out = torch.empty_like(x)
    n = x.numel()
    if n == 0:
        return out
    lib = cuda.load("prefix_sum")
    tile = lib.prefix_sum_tile()
    scratch = torch.empty(-(-n // tile), dtype=x.dtype, device=x.device)
    fn = lib.prefix_sum_i32 if x.dtype == torch.int32 else lib.prefix_sum_f32
    cuda.check(fn(x.data_ptr(), out.data_ptr(), scratch.data_ptr(), n,
                  cuda.stream_of(x)), "prefix_sum")
    cuda.launches["prefix_sum"] += 1
    return out
