"""DTable — the runtime carrier of a distributed data frame.

The paper's 1D_VAR distribution ("variable-length chunks per rank") is
carried as **static per-shard capacity + dynamic valid-prefix counts**:
every column is a torch tensor of shape ``(P * capacity,)`` whose shard r
occupies rows ``[r * capacity, (r + 1) * capacity)``, plus a ``(P,)`` int32
count tensor, both on the executing device.  Rows ``[count, capacity)`` of
each shard are padding.  A rank-local table (``shard`` set, what
``persist()`` keeps) holds only its own rank's ``(capacity,)`` shard and
still every rank's count.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from . import distribution as D
from .dtypes import canonical


@dataclass(eq=False)
class DTable:
    """A materialized distributed table."""

    columns: dict[str, torch.Tensor]   # each of shape (P * capacity,)
    counts: torch.Tensor               # (P,) int32 valid rows per shard
    capacity: int                      # per-shard row capacity
    nshards: int
    dist: str = D.ONE_D                # lattice element this table satisfies
    overflow: Any = None               # bool; True => a capacity site overflowed
    # per-op failure attribution: physical-plan op id -> {"kind", "op",
    # "cap", "bucket", "cap_req", "bucket_req", "strategy", "req_shards"}
    # for every capacity site whose flag fired.  Empty dict on a clean run.
    overflow_ops: dict = None          # type: ignore[assignment]
    # ExecConfig.validate: the InvariantFailure records of the run (empty
    # when every check held or validate is off)
    invariant_failures: tuple = ()
    # the RetryEvents of the collect() that produced this table
    events: tuple = ()
    # None: the columns hold every rank's shard; a rank: they hold only
    # that rank's (capacity,) shard (Lowered.__call__(gather=False))
    shard: int | None = None

    def __post_init__(self):
        if self.overflow_ops is None:
            self.overflow_ops = {}

    @classmethod
    def from_numpy_state(cls, columns: dict[str, Any], counts, capacity: int,
                         nshards: int, dist: str = D.ONE_D,
                         device: Any = "cuda") -> "DTable":
        """Carry a table's state over from numpy arrays: ``(P * capacity,)``
        columns and ``(P,)`` counts, as the reference package's ``DTable``
        holds them (``np.asarray(t.columns[c])``, ``np.asarray(t.counts)``).
        64-bit columns narrow to 32 bits, as at ingest."""
        dev = torch.device(device)
        cols = {}
        for name, v in columns.items():
            a = canonical(np.asarray(v))
            if a.shape != (nshards * capacity,):
                raise ValueError(f"column {name!r} has shape {a.shape}, "
                                 f"expected ({nshards * capacity},)")
            cols[name] = torch.from_numpy(np.array(a, copy=True)).to(dev)
        cnt = torch.from_numpy(np.asarray(counts, dtype=np.int32).reshape(
            nshards).copy()).to(dev)
        return cls(columns=cols, counts=cnt, capacity=int(capacity),
                   nshards=int(nshards), dist=dist)

    @property
    def schema(self) -> dict[str, np.dtype]:
        return {k: v.cpu()[:0].numpy().dtype for k, v in self.columns.items()}

    def num_rows(self) -> int:
        counts = self.counts.cpu().numpy()
        if self.dist == D.REP:           # every shard holds the full table
            return int(counts[0])
        return int(np.sum(counts))

    def to_numpy(self) -> dict[str, np.ndarray]:
        """Gather valid rows to host (drops padding); a rank-local table
        gives its own shard's valid rows."""
        counts = self.counts.cpu().numpy()
        if self.shard is not None:
            n = int(counts[self.shard])
            return {name: col.cpu().numpy()[:n]
                    for name, col in self.columns.items()}
        shards = 1 if self.dist == D.REP else self.nshards
        out: dict[str, np.ndarray] = {}
        for name, col in self.columns.items():
            a = col.cpu().numpy().reshape(self.nshards, self.capacity)
            out[name] = np.concatenate(
                [a[r, : counts[r]] for r in range(shards)]) if shards else a[:0]
        return out

    def column(self, name: str) -> torch.Tensor:
        """The raw padded column tensor, for array code."""
        return self.columns[name]

    def __repr__(self):
        cols = ", ".join(f"{k}:{v.dtype}" for k, v in self.columns.items())
        return (f"DTable[{self.dist}] P={self.nshards} cap={self.capacity} "
                f"rows={self.num_rows()} ({cols})")
