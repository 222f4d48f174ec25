"""Sampled statistics pass + realized-stats feedback store.

The property-driven planner (core/physical_plan.py) decides WHERE exchanges
and sorts go; this module tells it how much data moves and how it is
distributed, from two sources:

  * **Sampled estimates**: per base-table key statistics from a small
    evenly-spaced row sample (the even-position idiom
    ``physical.sample_sort`` uses for its splitters).  Host tables index
    their numpy columns; a persisted scan holds each rank's own
    ``(capacity,)`` device shard, so each rank gathers only the sampled
    positions of its shard on the device, copies those few rows to the
    host, and at P > 1 one small ``all_gather`` gives every rank every
    rank's sampled rows: every rank plans from the same sample.  Only an
    ``adaptive_stats`` pass samples such a shard at P > 1; a pass that
    only annotates ``explain()`` stays local to the rank.  Per key
    tuple we estimate the distinct count (GEE: ``sqrt(n/r)*f1 + (d - f1)``)
    and the heavy hitters (sample frequency per distinct tuple).  Column
    provenance (optimizer.column_provenance) maps interior-node key
    columns back to the scan columns the sample describes.

  * **Realized feedback**: ``collect()``/``persist()`` record the ROOT
    result's per-rank counts under a structural fingerprint of the
    (optimized) plan.  A repeated query self-tunes: an aggregate whose
    fingerprint has realized counts sizes its partial-aggregation buffers
    from the exact group count instead of the sample estimate, and a join
    whose previous run showed shard-occupancy skew lowers its salting
    threshold on replan.  Fingerprints are structural (node kinds, key
    names, expression shapes, scan names/schemas/row counts); node ids are
    process-local and never participate.  Counts are gathered on every
    rank, so every rank records the same.

The planner consumes a :class:`StatsContext` in three places (ExecConfig
``adaptive_stats``): automatic ``agg_group_cap`` for PartialAgg, cheaper-side
re-exchange for mixed-alignment joins, and salted skew joins.  Every
estimate is advisory: a missing or wrong estimate degrades to the static
rules plus the overflow retry, never to a wrong answer.
"""
from __future__ import annotations

import hashlib
import json
import os
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from . import ir
from .dtypes import categories_of, is_category, is_nullable
from .expr import BinOp, ColRef, Const, Expr, ExternalArray, UnOp
from .lower import _host
from .optimizer import column_provenance

# Estimated frequency above which residual skew is worth salting away even
# when it costs re-exchanging an otherwise-aligned build side.
_OCCUPANCY_TRIGGER = 2.0        # realized max/mean shard ratio that flags skew
_MAX_HOT = 16                   # cap on tracked heavy hitters per key tuple


# ---------------------------------------------------------------------------
# sampling (even-position, per shard — the sample_sort splitter idiom)
# ---------------------------------------------------------------------------


def _even_positions(n: int, k: int) -> np.ndarray:
    """k evenly spaced positions in [0, n) (sample_sort's splitter spacing)."""
    k = max(0, min(int(n), int(k)))
    if k == 0:
        return np.zeros(0, np.int64)
    return (np.arange(k, dtype=np.int64) * n) // k


def _rank_sample(col, idx: np.ndarray) -> np.ndarray:
    """Rows ``idx`` of a column, gathered where the column lives: on the
    device for a tensor (only those rows come to the host)."""
    if isinstance(col, torch.Tensor):
        return col[torch.from_numpy(idx).to(col.device)].cpu().numpy()
    return np.asarray(col)[idx]


def _gather_samples(parts: np.ndarray, ks: list[int],
                    like) -> np.ndarray:
    """Every rank's sampled rows, concatenated in rank order: this rank's
    ``parts`` padded to the longest rank's sample and all-gathered once
    (the tensors stay on the column's device, as the exchanges'); every
    rank then holds the same sample."""
    import torch.distributed as dist
    P, kmax = len(ks), max(ks)
    buf = torch.zeros(kmax, dtype=like.dtype, device=like.device)
    buf[:len(parts)] = torch.from_numpy(parts).to(like.device)
    got = [torch.empty_like(buf) for _ in range(P)]
    dist.all_gather(got, buf)
    return np.concatenate([got[r][:ks[r]].cpu().numpy() for r in range(P)])


def sample_scan(scan: ir.Scan, columns: tuple[str, ...],
                sample: int) -> dict[str, np.ndarray]:
    """Evenly-spaced row sample of ``columns`` from a scan.

    Host tables index numpy directly.  Persisted layouts sample each
    shard's valid prefix proportionally, at the same positions as the
    reference's global arrays: a column that holds every shard (a carried
    state) is indexed at the sampled positions; a column that holds this
    rank's own shard gathers its own positions on the device and, at
    P > 1, all-gathers them with every other rank's.
    """
    lay = scan.layout
    if lay is not None and lay.counts is not None:
        cnts = np.asarray(lay.counts, dtype=np.int64)
        total = int(cnts.sum())
        if total == 0:
            return {c: np.zeros(0) for c in columns}
        P, cap = int(lay.nshards), int(lay.capacity)
        ks = [-(-sample * int(cnts[r]) // max(total, 1))    # proportional
              for r in range(P)]
        pos = [_even_positions(int(cnts[r]), ks[r]) for r in range(P)]
        ks = [len(p) for p in pos]
        out = {}
        for c in columns:
            col = scan.columns[c]
            if len(col) == P * cap:         # every shard: global positions
                idx = np.concatenate([r * cap + pos[r] for r in range(P)])
                out[c] = _rank_sample(col, idx) if idx.size else np.zeros(0)
                continue
            import torch.distributed as dist
            world = (dist.get_world_size()
                     if dist.is_available() and dist.is_initialized() else 1)
            if len(col) != cap or world != P:
                raise ValueError(
                    f"persisted scan {scan.name!r} holds one rank's shard of "
                    f"{P}; it is sampled only at P = {P} (here P = {world})")
            rank = dist.get_rank() if P > 1 else 0
            mine = _rank_sample(col, pos[rank])
            out[c] = _gather_samples(mine, ks, col) if P > 1 else mine
        return out
    n = len(next(iter(scan.columns.values()))) if scan.columns else 0
    idx = _even_positions(n, sample)
    return {c: _host(scan.columns[c])[idx] for c in columns}


def shard_local(scan: ir.Scan, columns: tuple[str, ...]) -> bool:
    """Does sampling ``columns`` of ``scan`` take :func:`sample_scan`'s
    ``all_gather``: a layout persisted over P > 1 ranks with a column that
    holds this rank's own shard only?"""
    lay = scan.layout
    if lay is None or lay.counts is None or int(lay.nshards) <= 1:
        return False
    full = int(lay.nshards) * int(lay.capacity)
    return any(len(scan.columns[c]) != full for c in columns)


class ShardSampleError(RuntimeError):
    """Sampling a rank-local persisted shard failed.  The other ranks may
    already wait in the sample's ``all_gather``, so lowering raises this
    instead of degrading to static planning on this rank alone."""


# ---------------------------------------------------------------------------
# estimators
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class KeyStats:
    """Estimates for one key tuple at one plan node."""

    rows: int                                   # total rows the sample covers
    sampled: int                                # sample size
    distinct: int                               # GEE distinct-count estimate
    # conservative sizing estimate: sample singletons extrapolate LINEARLY
    # (each may represent n/r unseen distinct values) instead of GEE's
    # sqrt(n/r).  GEE minimizes ratio error (best for join-row estimates);
    # the linear bound is what buffer sizing wants — a heavy-tailed (zipf)
    # key column under-samples its tail and would otherwise overflow.
    distinct_cap: int = 0
    heavy: tuple[tuple[tuple, float], ...] = ()  # (key values, sample freq)
    source: str = "sample"                      # "sample" | "realized"


def _tuple_counts(cols: list[np.ndarray]) -> dict[tuple, int]:
    counts: dict[tuple, int] = {}
    for row in zip(*(np.asarray(c).tolist() for c in cols)):
        counts[row] = counts.get(row, 0) + 1
    return counts


def estimate_keys(cols: list[np.ndarray], total_rows: int) -> KeyStats:
    """Distinct-count (GEE) + heavy-hitter estimates from a sample."""
    r = len(cols[0]) if cols else 0
    n = max(total_rows, 1)
    if r == 0:
        return KeyStats(total_rows, 0, n, n, ())
    counts = _tuple_counts(cols)
    d = len(counts)
    f1 = sum(1 for c in counts.values() if c == 1)
    est = int(np.sqrt(n / r) * f1 + (d - f1))
    est = max(d, min(est, n))
    cap_est = max(d, min(int((n / r) * f1 + (d - f1)), n))
    heavy = sorted(((k, c / r) for k, c in counts.items()),
                   key=lambda kv: -kv[1])[:_MAX_HOT]
    return KeyStats(total_rows, r, est, cap_est, tuple(heavy))


# ---------------------------------------------------------------------------
# realized-stats feedback store (per-plan-fingerprint)
# ---------------------------------------------------------------------------


@dataclass
class StatsStore:
    """The per-fingerprint feedback store: realized per-shard counts
    (consumed by :class:`StatsContext`) plus the retry/degradation event log
    (``runtime/retry.py``), unified so one sidecar persists both.

    The module holds one CURRENT store (process default); a long-lived
    caller installs its own via :func:`use_store` and persists it as a JSON
    sidecar (:meth:`save` / :meth:`load`), so a restarted process plans
    warm.
    """

    realized: dict[str, dict] = field(default_factory=dict)
    events: dict[str, tuple] = field(default_factory=dict)

    # -- disk sidecar --------------------------------------------------------

    def save(self, path: str) -> None:
        """Atomically write the store as a JSON sidecar (tmp + rename, so a
        crashed writer leaves either the old file or a ``.tmp`` orphan —
        never a torn sidecar at ``path`` itself)."""
        from ..runtime.retry import RetryEvent
        doc = {"version": 1,
               "realized": self.realized,
               "events": {fp: [{"kind": e.kind, "attempt": e.attempt,
                                "op_id": e.op_id, "detail": e.detail}
                               for e in evs if isinstance(e, RetryEvent)]
                          for fp, evs in self.events.items()}}
        tmp = f"{path}.tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=1)
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: str) -> "StatsStore":
        """Load a sidecar written by :meth:`save`.

        A corrupt or partial file (truncated JSON, wrong shape, bad record
        types) raises a typed :class:`~repro_torch.core.errors.StatsError`:
        the caller decides whether to start cold or surface the failure."""
        from ..runtime.retry import RetryEvent
        from .errors import StatsError
        try:
            with open(path) as f:
                doc = json.load(f)
            if not isinstance(doc, dict) or doc.get("version") != 1:
                raise ValueError(f"unrecognized sidecar shape: "
                                 f"{type(doc).__name__}")
            realized = {}
            for fp, rec in dict(doc.get("realized", {})).items():
                realized[str(fp)] = {"rows": int(rec["rows"]),
                                     "max": int(rec["max"]),
                                     "mean": float(rec["mean"]),
                                     "nshards": int(rec["nshards"])}
            events = {}
            for fp, evs in dict(doc.get("events", {})).items():
                events[str(fp)] = tuple(
                    RetryEvent(kind=str(e["kind"]), attempt=int(e["attempt"]),
                               op_id=int(e["op_id"]), detail=str(e["detail"]))
                    for e in evs)
        except OSError:
            raise
        except Exception as e:
            raise StatsError(
                f"corrupt stats sidecar {path!r}: {e} — delete the file "
                "to plan cold"
            ) from e
        st = cls()
        st.realized = realized
        st.events = events
        return st


_STORE = StatsStore()


def current_store() -> StatsStore:
    return _STORE


def use_store(store: StatsStore) -> StatsStore:
    """Install ``store`` as the process-current feedback store; returns the
    previous one (a caller scoping its own store swaps it in)."""
    global _STORE
    prev = _STORE
    _STORE = store
    return prev


def _expr_sig(e: Optional[Expr]) -> str:
    if e is None:
        return "-"
    if isinstance(e, ColRef):
        return f"c:{e.name}"
    if isinstance(e, Const):
        v = e.value
        try:
            a = _host(v)
            body = str(a.item()) if a.size == 1 else f"arr{a.shape}"
        except Exception:
            body = type(v).__name__
        return f"k:{body}"
    if isinstance(e, ExternalArray):
        a = e.array
        return f"x:{tuple(a.shape) if isinstance(a, torch.Tensor) else np.asarray(a).shape}"
    if isinstance(e, (BinOp, UnOp)):
        kids = ",".join(_expr_sig(c) for c in e.children)
        return f"{e.op}({kids})"
    kids = ",".join(_expr_sig(c) for c in e.children)
    return f"{type(e).__name__}({kids})"


def _dtype_sig(d) -> str:
    """LOGICAL dtype signature: category columns hash their dictionary (two
    tables with the same int32 codes but different categories must never
    share a fingerprint — plan constants are code-space rewrites), and
    nullability marks with ``?``."""
    if is_category(d):
        cats = categories_of(d)
        h = hashlib.sha1("\x00".join(map(str, cats)).encode()).hexdigest()[:12]
        return f"cat[{len(cats)}:{h}]" + ("?" if is_nullable(d) else "")
    return np.dtype(d).str + ("?" if is_nullable(d) else "")


def _layout_sig(lay: Optional[ir.ScanLayout]) -> str:
    """The plan-shaping part of a ScanLayout: partitioning/ordering claims
    (they seed the physical planner) plus the device-carrier geometry
    (capacity/nshards fix the buffer shapes)."""
    if lay is None:
        return "-"
    dev = (f"{lay.capacity}x{lay.nshards}" if lay.counts is not None
           else "host")
    return (f"{lay.kind}|{','.join(lay.partitioned_by)}|{int(lay.ascending)}"
            f"|{int(lay.globally_sorted)}|{','.join(lay.sorted_by)}"
            f"|{int(lay.order_ascending)}|{dev}|{lay.dist}")


def _scan_sig(n: ir.Scan, scans: str) -> str:
    sch = ",".join(f"{k}:{_dtype_sig(d)}" for k, d in n.schema.items())
    device = n.layout is not None and n.layout.counts is not None
    if scans == "shape":
        # identity-free: NO scan name, and no row count for device layouts
        # (per-shard counts ride in as runtime inputs; only the capacity
        # geometry shapes the plan).  Two tables with the same schema +
        # layout shape therefore share a fingerprint.
        rows = ("-" if device
                else len(next(iter(n.columns.values()))) if n.columns else 0)
        return f"Scan[{sch}|{_layout_sig(n.layout)}|{rows}]"
    rows = (n.layout.rows() if device
            else len(next(iter(n.columns.values()))) if n.columns else 0)
    return f"Scan[{n.name}|{sch}|{rows}]"


def _node_sig(n: ir.Node, scans: str = "identity") -> str:
    if isinstance(n, ir.Scan):
        return _scan_sig(n, scans)
    if isinstance(n, ir.Filter):
        return f"Filter[{_expr_sig(n.pred)}]"
    if isinstance(n, ir.Project):
        cols = ",".join(f"{k}={_expr_sig(e)}" for k, e in n.cols.items())
        return f"Project[{cols}]"
    if isinstance(n, ir.Join):
        return (f"Join[{','.join(n.left_on)}|{','.join(n.right_on)}"
                f"|{n.how}|{n.suffix}]")
    if isinstance(n, ir.Aggregate):
        aggs = ",".join(f"{k}:{a.fn}:{_expr_sig(a.expr)}"
                        for k, a in n.aggs.items())
        return f"Agg[{','.join(n.key)}|{aggs}]"
    if isinstance(n, ir.Window):
        return (f"Win[{n.kind}|{_expr_sig(n.expr)}|{n.out}|{n.weights}"
                f"|{n.center}|{','.join(n.partition_by)}"
                f"|{','.join(n.order_by)}]")
    if isinstance(n, ir.Sort):
        return f"Sort[{','.join(n.by)}|{n.ascending}]"
    if isinstance(n, ir.Limit):
        return f"Limit[{n.n}]"
    if isinstance(n, ir.Repartition):
        return f"Repart[{','.join(n.by)}|{','.join(n.sort_by)}]"
    return type(n).__name__


def plan_fingerprint(node: ir.Node, scans: str = "identity") -> str:
    """Structural hash of the subplan rooted at ``node`` — stable across
    processes (node ids never participate).

    ``scans="identity"`` (default) keys scans by name + schema + row count —
    the realized-stats / retry-event store keying.  ``scans="shape"`` keys
    scans by schema (dictionary-aware) + layout geometry only, so
    same-shaped tables share a fingerprint.
    """
    parts = []

    def rec(n: ir.Node):
        parts.append(_node_sig(n, scans))
        parts.append("(")
        for c in n.children:
            rec(c)
        parts.append(")")

    rec(node)
    return hashlib.sha1("".join(parts).encode()).hexdigest()


def record_realized(root: ir.Node, counts: np.ndarray) -> None:
    """Feed a finished execution's per-shard valid counts back into the
    store (called by collect()/persist() under ``adaptive_stats``)."""
    while isinstance(root, ir.Rebalance):
        root = root.child
    counts = np.asarray(counts, dtype=np.int64).reshape(-1)
    if counts.size == 0:
        return
    _STORE.realized[plan_fingerprint(root)] = {
        "rows": int(counts.sum()),
        "max": int(counts.max()),
        "mean": float(counts.mean()),
        "nshards": int(counts.size),
    }


def record_failure(node: ir.Node, reqs: np.ndarray) -> None:
    """Record an OVERFLOW's observed per-shard buffer requirements under the
    failing op's logical-node fingerprint (runtime/retry.py calls this when
    a PartialAgg site exhausts its retry budget).

    The record has the realized-feedback shape, so the next adaptive run of
    the same plan sizes the site from it with ``ndv_src == "realized"`` —
    exact sizing, no slack, no retry.  ``rows`` is the summed per-shard
    requirement: local distinct groups can double-count a key across shards,
    so the sum is a safe upper bound on the per-shard capacity it feeds.
    """
    while isinstance(node, ir.Rebalance):
        node = node.child
    reqs = np.asarray(reqs, dtype=np.int64).reshape(-1)
    if reqs.size == 0:
        return
    _STORE.realized[plan_fingerprint(node)] = {
        "rows": int(reqs.sum()),
        "max": int(reqs.max()),
        "mean": float(reqs.mean()),
        "nshards": int(reqs.size),
    }


def realized_for(node: ir.Node) -> Optional[dict]:
    while isinstance(node, ir.Rebalance):
        node = node.child
    return _STORE.realized.get(plan_fingerprint(node))


def clear_realized() -> None:
    _STORE.realized.clear()


# ---------------------------------------------------------------------------
# the per-plan analysis context
# ---------------------------------------------------------------------------


def _scan_rows(n: ir.Scan) -> int:
    if n.layout is not None and n.layout.counts is not None:
        return n.layout.rows()
    return len(next(iter(n.columns.values()))) if n.columns else 0


class StatsContext:
    """Per-plan statistics: row estimates per node plus key-tuple stats on
    demand.  Built once per planning pass by :func:`analyze`."""

    def __init__(self, root: ir.Node, sample: int = 256,
                 collective: bool = True):
        self.root = root
        self.sample = int(sample)
        # may a rank-local persisted shard be sampled (one all_gather that
        # every rank must enter)?  Without it such a scan has no sample and
        # its estimates fall back to the layout's row counts.
        self.collective = collective
        self.prov = column_provenance(root)
        self.scans = {n.id: n for n in ir.topo_order(root)
                      if isinstance(n, ir.Scan)}
        self._samples: dict[tuple, dict[str, np.ndarray]] = {}
        self._key_cache: dict[tuple, Optional[KeyStats]] = {}
        self.rows_est: dict[int, float] = {}
        self._estimate_rows(root)

    # -- base-table sampling -------------------------------------------------

    def _scan_sample(self, scan_id: int,
                     cols: tuple[str, ...]) -> Optional[dict[str, np.ndarray]]:
        key = (scan_id, tuple(sorted(cols)))
        if key in self._samples:
            return self._samples[key]
        scan = self.scans[scan_id]
        if not shard_local(scan, key[1]):
            try:
                self._samples[key] = sample_scan(scan, key[1], self.sample)
            except Exception:
                self._samples[key] = None
        elif not self.collective:
            self._samples[key] = None
        else:
            try:
                self._samples[key] = sample_scan(scan, key[1], self.sample)
            except Exception as e:
                raise ShardSampleError(
                    f"sampling the persisted shard of {scan.name!r} "
                    f"failed: {e}") from e
        return self._samples[key]

    def _trace(self, node: ir.Node,
               cols: tuple[str, ...]) -> Optional[tuple[int, tuple[str, ...]]]:
        """Resolve ``cols`` at ``node`` to columns of ONE scan, or None."""
        p = self.prov.get(node.id, {})
        srcs = [p.get(c) for c in cols]
        if any(s is None for s in srcs):
            return None
        sids = {s[0] for s in srcs}
        if len(sids) != 1:
            return None
        return srcs[0][0], tuple(s[1] for s in srcs)

    # -- public estimates ----------------------------------------------------

    def key_stats(self, node: ir.Node,
                  keys: tuple[str, ...]) -> Optional[KeyStats]:
        """Sampled stats for the ``keys`` tuple at ``node`` (provenance-
        traced to one base table), or None when untraceable."""
        ck = (node.id, tuple(keys))
        if ck in self._key_cache:
            return self._key_cache[ck]
        out = None
        traced = self._trace(node, tuple(keys))
        if traced is not None:
            sid, scols = traced
            smp = self._scan_sample(sid, scols)
            if smp is not None and len(next(iter(smp.values()), ())) > 0:
                out = estimate_keys([smp[c] for c in scols],
                                    _scan_rows(self.scans[sid]))
        self._key_cache[ck] = out
        return out

    def ndv(self, node: ir.Node, keys: tuple[str, ...]) -> Optional[int]:
        """Distinct-count estimate for ``keys`` at ``node``, clamped by the
        node's row estimate (a filtered/joined stream can't grow NDV)."""
        ks = self.key_stats(node, keys)
        if ks is None:
            return None
        est = ks.distinct
        rows = self.rows_est.get(node.id)
        if rows is not None:
            est = min(est, max(1, int(rows)))
        return max(1, est)

    def ndv_cap(self, node: ir.Node, keys: tuple[str, ...]) -> Optional[int]:
        """CONSERVATIVE distinct-count bound for buffer sizing (linear
        singleton extrapolation — see KeyStats.distinct_cap)."""
        ks = self.key_stats(node, keys)
        if ks is None:
            return None
        est = ks.distinct_cap
        rows = self.rows_est.get(node.id)
        if rows is not None:
            est = min(est, max(1, int(rows)))
        return max(1, est)

    def hot_keys(self, node: ir.Node, keys: tuple[str, ...],
                 threshold: float) -> tuple[tuple[tuple, float], ...]:
        """Heavy hitters of ``keys`` at ``node``: sampled frequency >=
        ``threshold`` (frequencies are scan-level; filters are assumed
        skew-preserving — a wrong call costs balance, never correctness)."""
        ks = self.key_stats(node, keys)
        if ks is None:
            return ()
        return tuple((k, f) for k, f in ks.heavy if f >= threshold)

    def hot_fraction(self, node: ir.Node, keys: tuple[str, ...],
                     hot: tuple[tuple[tuple, float], ...]) -> Optional[float]:
        """Estimated fraction of ``node``'s rows whose key tuple is in the
        ``hot`` set (sizes the build side's replication buffer)."""
        if not hot:
            return 0.0
        ks = self.key_stats(node, keys)
        if ks is None:
            return None
        want = {k for k, _f in hot}
        frac = sum(f for k, f in ks.heavy if k in want)
        # one-sided sampling error margin so a small sample can't undersize
        # the replication buffer into a guaranteed overflow-retry.
        return min(1.0, frac + 1.0 / np.sqrt(max(ks.sampled, 1)))

    def realized(self, node: ir.Node) -> Optional[dict]:
        return realized_for(node)

    def skewed_before(self, node: ir.Node) -> bool:
        """Did a previous run of this exact subplan realize shard-occupancy
        skew (max/mean above the trigger)?  Drives the self-tuning salting
        threshold on replan."""
        rl = realized_for(node)
        return bool(rl and rl["nshards"] > 1 and rl["mean"] > 0
                    and rl["max"] / rl["mean"] >= _OCCUPANCY_TRIGGER)

    def layout_skewed(self, node: ir.Node, keys: tuple[str, ...]) -> bool:
        """Skew evidence a REGISTERED table carries for free: when ``keys``
        at ``node`` trace to a persisted scan that is hash-partitioned on
        (a subsequence of) those keys, its ScanLayout per-shard counts ARE
        the realized key distribution under hash routing — shard occupancy
        above the trigger means heavy hitters, with no sampling pass and no
        prior run of this plan."""
        traced = self._trace(node, tuple(keys))
        if traced is None:
            return False
        sid, scols = traced
        lay = self.scans[sid].layout
        if (lay is None or lay.counts is None or lay.nshards <= 1
                or lay.kind != "hash" or not lay.partitioned_by):
            return False
        # the hash routing must be BY the traced keys (subsequence rule,
        # physical_plan.colocates): counts then reflect key-group sizes.
        it = iter(scols)
        if not all(k in it for k in lay.partitioned_by):
            return False
        cnts = np.asarray(lay.counts, dtype=np.float64).reshape(-1)
        mean = float(cnts.mean()) if cnts.size else 0.0
        return bool(mean > 0 and float(cnts.max()) / mean
                    >= _OCCUPANCY_TRIGGER)

    # -- row estimation (one forward pass) -----------------------------------

    def _filter_selectivity(self, n: ir.Filter) -> float:
        """Sampled selectivity: evaluate the predicate over the base-table
        sample when every referenced column traces to one scan."""
        names = tuple(sorted({c for (_t, c) in n.pred.columns()}))
        if not names:
            return 1.0
        traced = self._trace(n.child, names)
        if traced is None:
            return 1.0
        sid, scols = traced
        smp = self._scan_sample(sid, scols)
        if smp is None:
            return 1.0
        r = len(next(iter(smp.values()), ()))
        if r == 0:
            return 1.0
        try:
            from .expr import evaluate
            env = {name: torch.from_numpy(np.ascontiguousarray(smp[sc]))
                   for name, sc in zip(names, scols)}
            mask = evaluate(n.pred, env).cpu().numpy()
            return float(np.mean(mask.astype(np.float64)))
        except Exception:
            return 1.0

    def _estimate_rows(self, root: ir.Node) -> None:
        est = self.rows_est
        for n in ir.topo_order(root):
            if isinstance(n, ir.Scan):
                est[n.id] = float(_scan_rows(n))
            elif isinstance(n, ir.Filter):
                est[n.id] = est[n.child.id] * self._filter_selectivity(n)
            elif isinstance(n, ir.Limit):
                est[n.id] = min(float(n.n), est[n.child.id])
            elif isinstance(n, ir.Join):
                lr, rr = est[n.left.id], est[n.right.id]
                ndv_l = self.ndv(n.left, n.left_on)
                ndv_r = self.ndv(n.right, n.right_on)
                if ndv_l and ndv_r:
                    out = lr * rr / max(ndv_l, ndv_r)
                else:
                    out = max(lr, rr)
                if n.how == "left":
                    out = max(out, lr)
                est[n.id] = out
            elif isinstance(n, ir.Aggregate):
                d = self.ndv(n.child, n.key)
                est[n.id] = float(d) if d else est[n.child.id]
            elif isinstance(n, ir.Concat):
                est[n.id] = sum(est[c.id] for c in n.parts)
            elif n.children:
                est[n.id] = est[n.children[0].id]
            else:
                est[n.id] = 0.0


def analyze(root: ir.Node, cfg) -> StatsContext:
    """Build the per-plan statistics context (planner entry point).

    Only an ``adaptive_stats`` pass, whose decisions every rank must share,
    samples a rank-local persisted shard at P > 1 (one ``all_gather``);
    otherwise the context annotates only, and such a scan is estimated from
    its layout's row counts with no collective.

    Fault injection (``cfg.fault_inject.poison_stats``, armed only under
    ``adaptive_stats``): ``"raise"`` raises a typed StatsError — lowering
    degrades to static planning; ``"ndv"`` clamps the buffer-sizing
    distinct-count bound to 1 — an undersized PartialAgg the per-op overflow
    retry must heal (tests/test_faults.py).
    """
    fault = getattr(cfg, "fault_inject", None)
    poison = (getattr(fault, "poison_stats", "")
              if getattr(cfg, "adaptive_stats", False) else "")
    if poison == "raise":
        from .errors import StatsError
        raise StatsError("injected stats failure (fault_inject.poison_stats)")
    ctx = StatsContext(root, sample=getattr(cfg, "stats_sample", 256),
                       collective=bool(getattr(cfg, "adaptive_stats", False)))
    if poison == "ndv":
        ctx.ndv_cap = lambda node, keys: 1      # type: ignore[method-assign]
    return ctx
