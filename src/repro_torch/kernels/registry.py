"""Typed kernel registry: the execution hot-path primitives, by device.

Each primitive is registered once with its ``plain`` PyTorch version and its
hand-written CUDA ``kernel`` wrapper.  :func:`resolve` picks the whole table
for one device: a CPU executor gets the plain versions, a CUDA executor the
kernels.  A kernel wrapper given a CPU tensor raises, so a CUDA run never
falls back to a plain version.  The physical planner never sees the device:
plans are identical either way.

Contracts (the same names and contracts as the reference package's
``kernels/registry.py``; only the primitives of the relational main path are
registered here):

  prefix_sum(x)                         dtype-preserving inclusive scan
                                        (int32 / float32)
  segment_sums(values, seg_id, valid, num_segments)
                                        per-segment sums of the valid rows
                                        (float32 on the card)
  bucket_scatter(dest, P)               (slot, send_counts): stable
                                        within-bucket slot of every row at
                                        its ORIGINAL position; dest == P
                                        marks invalid rows (slot garbage,
                                        masked by callers)
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable

from .hash_partition import hash_partition as _hp
from .segment_reduce import segment_reduce as _sr
from .stream_compact import stream_compact as _sc

DEVICES = ("cpu", "cuda")


@dataclass(frozen=True)
class KernelSpec:
    """One named primitive: its plain version and its CUDA kernel wrapper."""
    name: str
    plain: Callable
    kernel: Callable


_REGISTRY: dict[str, KernelSpec] = {}


def register(name: str, *, plain: Callable, kernel: Callable) -> None:
    if name in _REGISTRY:
        raise ValueError(f"kernel {name!r} already registered")
    _REGISTRY[name] = KernelSpec(name, plain, kernel)


def names() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def get(name: str) -> KernelSpec:
    return _REGISTRY[name]


class KernelSet:
    """The registry resolved for one device type: primitives are attributes,
    ``kernels.prefix_sum(x)``, so call sites are device-oblivious."""

    def __init__(self, device: str):
        if device not in DEVICES:
            raise ValueError(f"device type must be one of {DEVICES}, "
                             f"got {device!r}")
        self.device = device
        self._fns = {name: (spec.plain if device == "cpu" else spec.kernel)
                     for name, spec in _REGISTRY.items()}

    def __getattr__(self, name):
        try:
            return self.__dict__["_fns"][name]
        except KeyError:
            raise AttributeError(
                f"no kernel {name!r} registered (have: {names()})") from None

    def __repr__(self):
        return f"KernelSet(device={self.device!r}, kernels={names()})"


@functools.lru_cache(maxsize=None)
def resolve(device: str) -> KernelSet:
    """The KernelSet for a device type ("cpu" or "cuda"); one per type."""
    return KernelSet(device)


register("prefix_sum", plain=_sc.prefix_sum_plain, kernel=_sc.prefix_sum_cuda)
register("segment_sums", plain=_sr.segment_sums_plain,
         kernel=_sr.segment_sums_cuda)
register("bucket_scatter", plain=_hp.bucket_scatter_plain,
         kernel=_hp.bucket_scatter_cuda)
