"""On-device resharding of persisted frames: P -> P' without a host gather.

A persisted frame whose columns hold every shard, ``(nshards * cap,)``
tensors with per-shard valid prefixes (the 1D_VAR carrier of
``hf.from_persisted_state`` or of a ``persist()`` at P = 1), re-enters at
another shard count P' through one ``index_select`` on the device:

  * the **index map** comes from the layout's ``counts`` alone (host
    metadata, O(P) ints in, one int per output row out); no row leaves the
    device;
  * the new geometry is the order-preserving balanced re-block: the global
    valid-row stream (shard 0's prefix, then shard 1's, ...) is cut into P'
    near-equal contiguous prefixes; for divisible ratios this is the natural
    split (each old shard becomes k new ones) or merge (k old shards
    concatenate into one);
  * global row order is preserved, so a globally sorted layout keeps its
    ordering claims; a shard-local order survives only where every new
    shard comes from one old shard (a split).  Hash and range claims are
    bound to the shard count (``hash % P``, data-dependent splitters) and
    are dropped; with a ``cfg`` a hash claim is re-established by ONE
    exchange at P' (``repartition(keys).persist(cfg)`` over the resharded
    scan, which is device-valid at P', so the planner starts from device
    shards).

The port keeps a persisted frame rank-local (each rank its own
``(capacity,)`` shard, ROADMAP §3), so where the rows go depends on ``cfg``:

  * with a ``cfg``, P' is its world size and each rank takes its own
    re-blocked shard with its slice of the index map: no host copy and no
    collective (the re-establishing exchange aside);
  * without one, the result holds all P' shards on this device.

A frame that holds only one rank's shard of a different shard count cannot
reshard inside one process group (the other shards live in other
processes); it raises ``ValueError``, as a host or REP frame (no device
shards) does.  Capacity overflow cannot occur: the new capacity is sized
from the true row count.
"""
from __future__ import annotations

import dataclasses as _dc

import numpy as np
import torch
import torch.distributed as dist

from ..core import ir


def _index_map(counts: np.ndarray, cap_old: int, P_new: int
               ) -> tuple[np.ndarray, np.ndarray, int]:
    """(flat gather indices, new per-shard counts, new capacity) for the
    order-preserving balanced re-block.  Pure counts metadata — no row data.
    """
    cnts = np.asarray(counts, dtype=np.int64)
    P_old = cnts.shape[0]
    total = int(cnts.sum())
    base, rem = divmod(total, P_new)
    counts_new = base + (np.arange(P_new) < rem).astype(np.int64)
    cap_new = max(int(counts_new.max(initial=0)), 1)
    cum = np.concatenate([[0], np.cumsum(cnts)])
    cumn = np.concatenate([[0], np.cumsum(counts_new)])
    pos = np.arange(P_new * cap_new, dtype=np.int64)
    r_new, j = pos // cap_new, pos % cap_new
    # global rank of each output slot's row (invalid slots clamp to a valid
    # rank — their gathered value is masked off by the count vector anyway)
    q = cumn[r_new] + np.minimum(j, np.maximum(counts_new[r_new] - 1, 0))
    q = np.clip(q, 0, max(total - 1, 0))
    src_shard = np.clip(np.searchsorted(cum, q, side="right") - 1, 0,
                        max(P_old - 1, 0))
    idx = src_shard * cap_old + (q - cum[src_shard])
    return idx.astype(np.int32), counts_new.astype(np.int32), cap_new


def _order_survives(lay: ir.ScanLayout, idx: np.ndarray, counts_new,
                    cap_new: int) -> bool:
    """Does each new shard's valid prefix keep the layout's order?  Yes
    when the stream is globally sorted; else only when every new shard
    takes its rows from one old shard."""
    if lay.globally_sorted or not lay.sorted_by:
        return True
    for r, c in enumerate(np.asarray(counts_new)):
        if c > 1:
            src = idx[r * cap_new:r * cap_new + c] // int(lay.capacity)
            if src[0] != src[-1]:
                return False
    return True


def reshard(df, P_new: int, cfg=None, *, reestablish: bool = True,
            name: str | None = None):
    """Re-enter a persisted frame's device shards at shard count ``P_new``.

    ``df`` is a persisted DataFrame (its node an ``ir.Scan`` whose layout
    carries counts) whose columns hold every shard.  With ``cfg`` (an
    ExecConfig whose world size is ``P_new``) the result is this rank's
    shard of a frame persisted at ``P_new``, and a hash claim is
    re-established by one exchange when ``reestablish``; without it the
    result holds all ``P_new`` shards on the columns' device and its hash
    or range claim is dropped.
    """
    from ..core.api import DataFrame

    node = df.node if isinstance(df, DataFrame) else df
    if not isinstance(node, ir.Scan) or node.layout is None:
        raise ValueError("reshard: input must be a persisted frame "
                         "(df.persist()) whose scan carries a layout")
    lay = node.layout
    if lay.counts is None:
        raise ValueError(
            "reshard: frame has no device shards (host/REP table) — "
            "re-enter it directly; only device layouts need resharding")
    P_new = int(P_new)
    if P_new < 1:
        raise ValueError(f"reshard: invalid shard count {P_new}")
    if lay.nshards == P_new:
        return df if isinstance(df, DataFrame) else DataFrame(node)
    cap = int(lay.capacity)
    short = sorted(c for c, v in node.columns.items()
                   if len(v) != lay.nshards * cap)
    if short:
        raise ValueError(
            f"reshard: {node.name!r} holds one rank's shard of "
            f"{lay.nshards} (columns {short}), not every shard: a rank-local "
            "shard re-enters only at the shard count it was persisted at, "
            "and the other shards live in other processes (persisted "
            "columns are rank-local in this package)")

    idx, counts_new, cap_new = _index_map(lay.counts, cap, P_new)
    if cfg is not None:
        P = cfg.nshards()
        if P != P_new:
            raise ValueError(
                f"reshard: cfg runs on {P} rank(s), target is {P_new}")
        rank = dist.get_rank() if P > 1 else 0
        sel, dev = idx[rank * cap_new:(rank + 1) * cap_new], cfg.torch_device()
    else:
        first = next(iter(node.columns.values()))
        sel = idx
        dev = first.device if isinstance(first, torch.Tensor) \
            else torch.device("cpu")
    index = torch.from_numpy(sel).to(dev)
    cols = {c: torch.index_select(
                (v if isinstance(v, torch.Tensor)
                 else torch.from_numpy(np.asarray(v))).to(dev), 0, index)
            for c, v in node.columns.items()}

    keep_part = lay.kind in ("hash", "range") and bool(lay.partitioned_by)
    ordered = _order_survives(lay, idx, counts_new, cap_new)
    new_lay = _dc.replace(
        lay,
        kind="block" if keep_part else lay.kind,
        partitioned_by=() if keep_part else lay.partitioned_by,
        sorted_by=lay.sorted_by if ordered else (),
        globally_sorted=lay.globally_sorted and ordered,
        counts=counts_new, capacity=int(cap_new), nshards=P_new,
        dist="1D_VAR")
    out = DataFrame(ir.Scan(name or f"{node.name}@P{P_new}", cols,
                            node.schema, layout=new_lay))
    if keep_part and reestablish and cfg is not None and lay.kind == "hash":
        # one on-device hash exchange re-establishes the partitioning claim
        # at P_new (the intermediate scan is device-valid, so the planner
        # feeds device shards straight through — no host round-trip).
        q = out.repartition(list(lay.partitioned_by))
        if lay.sorted_by:
            q = q.sort_within_partitions(list(lay.sorted_by))
        out = q.persist(cfg, name=out.node.name)
    return out
