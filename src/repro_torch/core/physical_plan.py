"""Property-driven physical planning — the exchange-elision layer.

The logical plan (ir.py) says WHAT relational result to compute; the
distribution pass (distribution.py) says WHERE rows may live (the lattice of
paper §4.4).  This module decides HOW rows move: it walks the
distribution-annotated logical plan and emits a linear physical plan of
operators (HashExchange, LocalSort, MergeJoin, SegmentAgg, SampleSort,
Compact, Map, ...), each carrying the *physical properties* its output
provides:

  * ``Partitioning`` — how rows are placed across shards:
      - ``hash(keys)``  equal key TUPLES co-locate (value-deterministic
        combined hash, so it aligns across tables),
      - ``range(keys)`` equal key tuples co-locate and shards are globally
        ordered (sample-sort output; splitters are data-dependent, so it
        does NOT align across tables),
      - ``rep``         every shard holds all rows,
      - ``block``       no co-location guarantee (scans, rebalance).
  * ``Ordering`` — the key prefix each shard's valid rows are sorted by.

Exchanges and sorts are inserted only where a consumer's REQUIRED property is
not already PROVIDED — the paper's "communicate only when the distribution
analysis demands it" (§4.5–4.6) made explicit.  The satisfaction rules are
deliberately conservative and composite-key-aware:

  * co-location on K is satisfied by hash/range partitioning on S iff S is an
    ordered subsequence of K (equal K-tuples are then equal S-tuples, hence
    co-located).  A superset or reordering of K does NOT satisfy K.
  * grouping/ordering on K is satisfied iff K is a prefix of the provided
    ordering keys (order-sensitive).
  * REP satisfies every co-location requirement (each shard is total).

Capacity planning (static per-shard buffer sizes, DESIGN.md §2) also lives
here and operates on physical ops: exchanges get (src,dst) buckets,
pass-through ops inherit their input's capacity, and an elided exchange means
the downstream op keeps the (smaller) local capacity.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np

from . import distribution as D
from . import ir
from .expr import infer_dtype, nulltag_for
from .physical import (AGG_DECOMP, PACK_WORD_BYTES, SALT_COL, col_words,
                       decomposable)


# ---------------------------------------------------------------------------
# physical properties
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Partitioning:
    """Row placement across shards; ``keys`` only meaningful for hash/range.

    ``ascending`` records the DIRECTION of range shard boundaries (shard 0
    holds the smallest tuples iff True).  Co-location never depends on it,
    but global-sortedness checks do: a locally ascending ordering over
    descending shard ranges is NOT globally sorted.  Meaningless (always
    True) for hash/rep/block.

    ``globally_sorted`` marks a BLOCK partitioning whose shard boundaries
    follow the op's Ordering: the concatenation of shard valid prefixes is
    globally sorted by the ordering keys (a Rebalance of a globally sorted
    stream).  It gives no key co-location — an equal-key run may straddle a
    boundary — but lets a downstream Sort on an ordering prefix plan a full
    no-op instead of paying splitter routing.
    """

    kind: str                       # "hash" | "range" | "rep" | "block"
    keys: tuple[str, ...] = ()
    ascending: bool = True
    globally_sorted: bool = False   # block-only: shard order follows Ordering

    def short(self) -> str:
        if not self.keys:
            return self.kind + (" sorted" if self.globally_sorted else "")
        d = "" if self.ascending else " desc"
        return f"{self.kind}({','.join(self.keys)}){d}"


@dataclass(frozen=True)
class Ordering:
    """Per-shard valid-prefix sort order; () means unordered."""

    keys: tuple[str, ...] = ()
    ascending: bool = True

    def short(self) -> str:
        if not self.keys:
            return "-"
        return f"({','.join(self.keys)}){'' if self.ascending else ' desc'}"


BLOCK = Partitioning("block")
REPL = Partitioning("rep")
UNORDERED = Ordering()


def subsequence_indices(sub: tuple[str, ...],
                        seq: tuple[str, ...]) -> Optional[tuple[int, ...]]:
    """Indices I with seq[I] == sub (greedy), or None if not a subsequence."""
    out = []
    j = 0
    for s in sub:
        while j < len(seq) and seq[j] != s:
            j += 1
        if j == len(seq):
            return None
        out.append(j)
        j += 1
    return tuple(out)


def colocates(part: Partitioning, keys: tuple[str, ...]) -> bool:
    """Does ``part`` already co-locate rows with equal ``keys`` tuples?

    hash/range partitioning on S co-locates K-groups iff S is an ordered
    subsequence of K: equal K-tuples are equal on S (same column order), so
    the value-deterministic routing sends them to one shard.  A superset or
    reordering of K gives no such guarantee and is rejected.
    """
    if part.kind == "rep":
        return True
    if part.kind in ("hash", "range") and part.keys:
        return subsequence_indices(part.keys, keys) is not None
    return False


def grouped(order: Ordering, keys: tuple[str, ...]) -> bool:
    """Are equal ``keys`` tuples contiguous?  True iff keys is an ordering
    prefix (rows sorted by a key prefix have contiguous key groups)."""
    return len(order.keys) >= len(keys) and order.keys[: len(keys)] == keys


# ---------------------------------------------------------------------------
# physical operators
# ---------------------------------------------------------------------------


@dataclass(eq=False)
class POp:
    """Base physical operator.

    ``node`` is the logical node this op realizes (inserted exchanges/sorts
    anchor to their consumer).  ``cap``/``bucket`` are filled by
    :func:`plan_capacities`.
    """

    node: ir.Node
    inputs: tuple[int, ...]         # op ids
    part: Partitioning
    order: Ordering
    dist: str                       # lattice element (axes selection)
    op_id: int = -1                 # assigned by the plan
    cap: int = 0
    bucket: int = 0
    # output schema estimate (name -> np.dtype), filled by annotate_schemas;
    # drives the collective/byte census of the packed exchange.
    schema: dict = field(default_factory=dict)
    # display-only annotations from the sampled statistics pass (core/stats):
    # estimated OUTPUT rows, and a free-text planner note (e.g. which side a
    # cheap-side decision picked).  Never consulted by capacity planning or
    # the census — plans stay byte-identical whether they are set or not.
    rows_est: Optional[float] = None
    note: str = ""

    def short(self) -> str:
        return type(self).__name__


@dataclass(eq=False)
class Source(POp):
    pass


@dataclass(eq=False)
class Compact(POp):
    """Filter backend: predicate + stable compaction (no communication)."""


@dataclass(eq=False)
class Map(POp):
    """Project: evaluate output expressions (no communication)."""


@dataclass(eq=False)
class WindowOp(POp):
    """cumsum / stencil / rank (row-preserving).

    Global: exscan or halo exchange.  Partitioned (``partition_by`` on the
    logical node): collective-free segment kernels over the grouped layout
    the planner establishes upstream (hash exchange + local sort, both
    elided when already provided)."""

    def short(self):
        n = self.node
        if n.partition_by:
            ob = f"; {','.join(n.order_by)}" if n.order_by else ""
            return f"WindowOp({n.kind} over {','.join(n.partition_by)}{ob})"
        return f"WindowOp({n.kind})"


@dataclass(eq=False)
class HashExchange(POp):
    keys: tuple[str, ...] = ()

    def short(self):
        return f"HashExchange({','.join(self.keys)})"


@dataclass(eq=False)
class LocalSort(POp):
    keys: tuple[str, ...] = ()

    def short(self):
        return f"LocalSort({','.join(self.keys)})"


@dataclass(eq=False)
class SaltOp(POp):
    """Skew-salting prologue (adaptive_stats only; docs/adaptive_planning.md).

    Injects a ``__salt__`` column so the ``hot`` heavy-hitter key tuples
    spread over ``R`` sub-partitions of the downstream keys+salt exchange.
    ``build=False`` (probe side): hot rows get salt ``position % R``, others
    salt 0.  ``build=True``: hot rows are replicated to every salt 0..R-1,
    others keep a single salt-0 copy — each (probe row, build row) key match
    then agrees on exactly one salt, so the join result is exactly the
    unsalted one.  The ``hot`` set is a static plan constant shared by both
    sides; a wrong estimate costs balance, never correctness.
    """

    keys: tuple[str, ...] = ()
    hot: tuple[tuple, ...] = ()     # heavy-hitter key VALUE tuples
    R: int = 2
    build: bool = False
    hot_frac: float = 0.0           # est. input fraction that is hot (+margin)

    def short(self):
        side = "build" if self.build else "probe"
        return f"Salt[{side}](R={self.R}, hot={len(self.hot)})"


@dataclass(eq=False)
class MergeJoin(POp):
    """Rank-based merge join of co-partitioned (NOT necessarily sorted)
    inputs; one fused union sort internally (physical.merge_join)."""

    broadcast: bool = False
    # salted: both inputs carry a __salt__ column (SaltOp) — join on
    # keys+salt, strip the salt from the output.
    salted: bool = False

    def short(self):
        n = self.node
        pairs = ",".join(f"{l}=={r}" for l, r in zip(n.left_on, n.right_on))
        tag = ", broadcast" if self.broadcast else ""
        tag += ", salted" if self.salted else ""
        return f"MergeJoin({pairs}{tag})"


@dataclass(eq=False)
class AggPrep(POp):
    """Evaluate aggregation input expressions into __v_* columns and narrow
    to key + value columns (keys keep their names: properties flow through)."""


@dataclass(eq=False)
class PartialAgg(POp):
    """Map-side partial aggregation: reduce local key runs to decomposable
    partial statistics BEFORE the hash exchange, so the wire carries at most
    this shard's distinct key tuples (physical.partial_aggregate)."""

    # adaptive_stats: distinct-group estimate that sizes this op's capacity
    # (and thereby the post-partial exchange bucket) when the user declared
    # no agg_group_cap.  ndv_src records where it came from ("sample" or
    # "realized" — the per-fingerprint feedback store).
    ndv_est: Optional[int] = None
    ndv_src: str = ""

    def short(self):
        tag = (f", ndv~{self.ndv_est} ({self.ndv_src})"
               if self.ndv_est is not None else "")
        return f"PartialAgg(by={','.join(self.node.key)}{tag})"


@dataclass(eq=False)
class SegmentAgg(POp):
    # from_partials: combine PartialAgg statistics (physical.final_aggregate)
    # instead of aggregating raw rows.
    from_partials: bool = False
    # aux-sort elision: name of the nunique agg whose value column rode the
    # planner-inserted LocalSort as a trailing key (skips one lax.sort).
    nunique_ride: Optional[str] = None

    def short(self):
        tag = ", combine" if self.from_partials else ""
        if self.nunique_ride:
            tag += f", nunique_ride={self.nunique_ride}"
        return f"SegmentAgg(by={','.join(self.node.key)}{tag})"


@dataclass(eq=False)
class SampleSort(POp):
    pre_sorted: bool = False        # input already sorted: skip the pre-sort

    def short(self):
        n = self.node
        tag = ", pre_sorted" if self.pre_sorted else ""
        return f"SampleSort({','.join(n.by)}{'' if n.ascending else ' desc'}{tag})"


@dataclass(eq=False)
class LimitOp(POp):
    """First n rows globally: per-shard count clamp off an exclusive scan of
    counts — no data movement, partitioning AND ordering pass through (a
    subset of co-located groups stays co-located; a sorted prefix stays
    sorted)."""

    def short(self):
        return f"Limit({self.node.n})"


@dataclass(eq=False)
class RebalanceOp(POp):
    pass


@dataclass(eq=False)
class ConcatOp(POp):
    pass


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------


def _row_words(schema: dict) -> int:
    """uint32 words one packed row of ``schema`` occupies (physical.col_words)."""
    return sum(col_words(dt) for dt in schema.values())


def _row_bytes_unpacked(schema: dict) -> int:
    """Native bytes per row when each column ships as its own collective."""
    return sum(np.dtype(dt).itemsize for dt in schema.values())


@dataclass
class PhysicalPlan:
    ops: list[POp] = field(default_factory=list)
    op_of: dict[int, int] = field(default_factory=dict)  # logical id -> op id
    root_id: int = -1
    packed: bool = True             # cfg.packed_exchange at plan time
    cfg: Any = None                 # the ExecConfig the plan was built under

    def add(self, op: POp) -> POp:
        op.op_id = len(self.ops)
        self.ops.append(op)
        return op

    @property
    def root_op(self) -> POp:
        return self.ops[self.root_id]

    def final_op(self, node: ir.Node) -> POp:
        return self.ops[self.op_of[node.id]]

    def counts(self) -> dict[str, int]:
        """Data-movement / sort census used by tests, explain and benches."""
        c = {"hash_exchanges": 0, "local_sorts": 0, "sample_sorts": 0,
             "rebalances": 0, "merge_joins": 0, "segment_aggs": 0,
             "partial_aggs": 0, "salt_ops": 0}
        for op in self.ops:
            if isinstance(op, HashExchange):
                c["hash_exchanges"] += 1
            elif isinstance(op, SaltOp):
                c["salt_ops"] += 1
            elif isinstance(op, LocalSort):
                c["local_sorts"] += 1
            elif isinstance(op, SampleSort):
                c["sample_sorts"] += 1
            elif isinstance(op, RebalanceOp):
                c["rebalances"] += 1
            elif isinstance(op, MergeJoin):
                c["merge_joins"] += 1
            elif isinstance(op, PartialAgg):
                c["partial_aggs"] += 1
            elif isinstance(op, SegmentAgg):
                c["segment_aggs"] += 1
        return c

    def shuffle_count(self) -> int:
        """All-to-all communication rounds (hash + range + rebalance)."""
        c = self.counts()
        return c["hash_exchanges"] + c["sample_sorts"] + c["rebalances"]

    # -- collective / byte census (the packed-exchange regression gate) ------

    def _exchange_ops(self) -> list[POp]:
        return [op for op in self.ops
                if isinstance(op, (HashExchange, SampleSort, RebalanceOp))]

    def op_collectives(self, op: POp) -> int:
        """all_to_all collectives ONE exchange issues at P>1: the count
        vector plus either one packed payload or one payload per column."""
        return 2 if self.packed else 1 + len(op.schema)

    def op_row_bytes(self, op: POp) -> int:
        """Wire bytes one row of this exchange costs (packed: 4 bytes per
        uint32 word incl. sub-word padding; unpacked: native itemsizes)."""
        return (_row_words(op.schema) * PACK_WORD_BYTES if self.packed
                else _row_bytes_unpacked(op.schema))

    def collective_count(self) -> int:
        """Total all_to_all collectives the plan issues per execution (P>1).
        A packed plan pays exactly 2 per exchange regardless of width."""
        return sum(self.op_collectives(op) for op in self._exchange_ops())

    def shuffle_row_bytes(self) -> int:
        """Wire bytes ONE row costs summed over every exchange it crosses —
        a shard-count-free volume estimate."""
        return sum(self.op_row_bytes(op) for op in self._exchange_ops())

    def buffer_bytes(self, P: int | None = None) -> int:
        """Total bytes of row buffers the LIVE capacity plan allocates across
        all shards: every op's (cap,) output columns plus each exchange's
        (P, bucket) send staging, at native column widths.

        The retry-quality metric (docs/robustness.md): per-op escalation must
        heal skew with strictly fewer total bytes than global slack-doubling,
        and this is the number tests/test_faults.py compares.
        """
        if P is None:
            P = self.cfg.nshards()
        total = 0
        for op in self.ops:
            rb = _row_bytes_unpacked(op.schema)
            rows = op.cap + (P * op.bucket if op.bucket else 0)
            total += P * rows * rb
        return total

    def source_rows(self) -> dict[int, int]:
        """Scan id -> VALID row count, read off the Source ops' bound arrays
        (persisted scans: the layout's summed counts, not the padded
        buffer length)."""
        return {op.node.id: scan_rows(op.node)
                for op in self.ops if isinstance(op, Source)}

    def shuffle_census(self, P: int = 8) -> dict:
        """Deterministic collective + byte census at a FIXED shard count.

        Uses a scratch capacity pass at shard count ``P`` (never the live
        device count, so census regression gates stay environment-stable).
        Per exchange: ``collectives`` (all_to_all issued), ``row_bytes``
        (wire cost of one row) and ``payload_bytes`` (the full per-shard
        payload buffer, P * bucket * row_bytes — the count vector's P*4
        bytes are omitted as noise).  Map-side partial aggregation shows up
        as the post-partial exchange carrying ``__p_*`` statistic columns
        with a bucket sized by the (smaller) PartialAgg capacity.
        """
        caps = compute_capacities(self, P, self.cfg, self.source_rows())
        entries = []
        for op in self._exchange_ops():
            rb = self.op_row_bytes(op)
            _cap, bucket = caps[op.op_id]
            entries.append({"op": op.short(), "ncols": len(op.schema),
                            "row_bytes": rb,
                            "collectives": self.op_collectives(op),
                            "payload_bytes": P * bucket * rb})
        return {"P": P, "packed": self.packed,
                "all_to_all": sum(e["collectives"] for e in entries),
                "payload_bytes": sum(e["payload_bytes"] for e in entries),
                "exchanges": entries}

    def render(self) -> str:
        c = self.counts()
        lines = [f"physical plan: {self.shuffle_count()} shuffles "
                 f"({c['hash_exchanges']} hash exchanges, "
                 f"{c['sample_sorts']} sample sorts, "
                 f"{c['rebalances']} rebalances), "
                 f"{c['local_sorts']} local sorts, "
                 f"{c['partial_aggs']} partial aggs; "
                 f"{self.collective_count()} all_to_all "
                 f"({'packed' if self.packed else 'per-column'}), "
                 f"~{self.shuffle_row_bytes()} B/row shuffled"]
        for op in self.ops:
            src = ",".join(f"#{i}" for i in op.inputs)
            cap = f" cap={op.cap}" if op.cap else ""
            bkt = f" bucket={op.bucket}" if op.bucket else ""
            wire = ""
            if isinstance(op, (HashExchange, SampleSort, RebalanceOp)):
                wire = (f" wire={self.op_collectives(op)}coll/"
                        f"{self.op_row_bytes(op)}B-row")
                if op.rows_est is not None:
                    est_b = int(op.rows_est) * self.op_row_bytes(op)
                    wire += f" est~{int(op.rows_est)}r/~{est_b}B"
            note = f"  [{op.note}]" if op.note else ""
            lines.append(
                f"  #{op.op_id} {op.short()}  <- [{src}]  "
                f"part={op.part.short()} order={op.order.short()}"
                f"  [{op.dist}]{cap}{bkt}{wire}{note}")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# property transfer helpers
# ---------------------------------------------------------------------------


def _remap_props(part: Partitioning, order: Ordering,
                 passthrough: dict[str, str]) -> tuple[Partitioning, Ordering]:
    """Push properties through a projection.

    ``passthrough`` maps output name -> input column for pure renames.
    Partitioning survives iff EVERY partition key survives (renamed);
    ordering keeps its longest surviving prefix (a dropped middle column
    breaks lexicographic order below it).
    """
    inv: dict[str, str] = {}
    for out_name, in_name in passthrough.items():
        inv.setdefault(in_name, out_name)
    new_part = part
    if part.kind in ("hash", "range"):
        if all(k in inv for k in part.keys):
            new_part = Partitioning(part.kind,
                                    tuple(inv[k] for k in part.keys),
                                    part.ascending)
        else:
            new_part = BLOCK
    prefix: list[str] = []
    for k in order.keys:
        if k not in inv:
            break
        prefix.append(inv[k])
    new_order = Ordering(tuple(prefix), order.ascending) if prefix else UNORDERED
    return new_part, new_order


def _restrict_props(part: Partitioning, order: Ordering,
                    surviving: set[str]) -> tuple[Partitioning, Ordering]:
    """Properties after dropping every column not in ``surviving``."""
    return _remap_props(part, order, {c: c for c in surviving})


# ---------------------------------------------------------------------------
# the planner
# ---------------------------------------------------------------------------


def plan_physical(root: ir.Node, dists: dict[int, str], cfg,
                  stats=None) -> PhysicalPlan:
    """Walk the distribution-annotated logical plan; insert exchanges and
    sorts only where a required property is not provided.

    ``cfg`` is an ExecConfig (broadcast_join / elide_exchanges /
    partial_agg / packed_exchange are read).  With ``elide_exchanges=False``
    provided properties are ignored and every Join/Aggregate/Sort pays its
    full exchange+sort — the pre-elision baseline, kept as an A/B lever for
    benchmarks.  With ``partial_agg=True`` (default) an aggregate whose
    exchange survives and whose agg fns are all decomposable splits into
    PartialAgg -> HashExchange -> LocalSort -> SegmentAgg(combine), so each
    shard ships at most its distinct local key groups.

    ``stats`` is an optional :class:`core.stats.StatsContext`.  When passed
    it always ANNOTATES (per-op ``rows_est`` estimates for explain), but it
    only changes planner DECISIONS — salted joins, cheaper-side
    re-exchange, PartialAgg ndv sizing — under ``cfg.adaptive_stats``, so a
    plan built with adaptive off is structurally byte-identical with or
    without a stats context (docs/adaptive_planning.md).
    """
    plan = PhysicalPlan(packed=getattr(cfg, "packed_exchange", True), cfg=cfg)
    elide = getattr(cfg, "elide_exchanges", True)
    partial_agg = getattr(cfg, "partial_agg", True)
    adaptive = stats is not None and getattr(cfg, "adaptive_stats", False)

    # Live shard count, resolved lazily: persisted-scan hash/range claims are
    # only valid at the shard count they were produced under (routing is
    # hash % P / data-dependent splitters), so property seeding gates on it.
    _P_live: list = []

    def live_shards() -> int:
        if not _P_live:
            _P_live.append(cfg.nshards())
        return _P_live[0]

    def emit(cls, node, inputs, part, order, **kw) -> POp:
        d = dists[node.id]
        op = plan.add(cls(node=node, inputs=tuple(i.op_id for i in inputs),
                          part=part, order=order, dist=d, **kw))
        if stats is not None:
            op.rows_est = stats.rows_est.get(node.id)
        return op

    def hash_exchange(node, src: POp, keys: tuple[str, ...]) -> POp:
        op = emit(HashExchange, node, (src,), Partitioning("hash", keys),
                  UNORDERED, keys=keys)
        op.rows_est = src.rows_est      # an exchange moves its INPUT's rows
        return op

    def local_sort(node, src: POp, keys: tuple[str, ...]) -> POp:
        op = emit(LocalSort, node, (src,), src.part, Ordering(keys, True),
                  keys=keys)
        op.rows_est = src.rows_est
        return op

    def _est_shuffle_bytes(node: ir.Node) -> Optional[float]:
        """Estimated wire bytes of re-exchanging ``node``'s output: rows
        estimate x packed row width (mirrors shuffle_row_bytes)."""
        rows = stats.rows_est.get(node.id) if stats is not None else None
        if rows is None:
            return None
        return rows * _row_words(node.schema) * PACK_WORD_BYTES

    for n in ir.topo_order(root):
        if isinstance(n, ir.Scan):
            # lattice -> property seed: REP tables are whole on every shard
            # (satisfying every co-location requirement for free); 1D
            # elements place rows positionally — no key co-location.  A
            # PERSISTED scan (df.persist()) instead seeds the partitioning
            # and ordering its producing plan materialized, so downstream
            # groupby/merge/over/sort on the persisted keys start elided —
            # the repeated-query payoff.  Hash/range claims need the same
            # shard count they were produced under; ordering-only claims
            # (and REP re-entry) don't depend on routing.
            part = REPL if dists[n.id] == D.REP else BLOCK
            order = UNORDERED
            lay = n.layout
            if lay is not None and elide:
                dev = lay.device_valid(live_shards())
                if part.kind != "rep" and dev:
                    if lay.kind == "hash" and lay.partitioned_by:
                        part = Partitioning("hash", lay.partitioned_by)
                    elif lay.kind == "range" and lay.partitioned_by:
                        part = Partitioning("range", lay.partitioned_by,
                                            lay.ascending)
                    elif (lay.kind == "block" and lay.globally_sorted
                          and lay.sorted_by):
                        part = Partitioning("block", (), lay.order_ascending,
                                            globally_sorted=True)
                # Ordering claims hold only where the re-entry path preserves
                # per-shard order: the direct device path (dev, non-REP), or
                # a host-persisted table (counts is None — its rows ARE the
                # ordered valid prefix, whether replicated or block-split).
                # A device layout forced to REP (or at a foreign shard
                # count) re-enters via gather_host, whose shard-order concat
                # is NOT sorted — no claim there.
                host_ordered = lay.counts is None
                if lay.sorted_by and (host_ordered
                                      or (dev and part.kind != "rep")):
                    order = Ordering(lay.sorted_by, lay.order_ascending)
            op = emit(Source, n, (), part, order)

        elif isinstance(n, ir.Filter):
            c = plan.final_op(n.child)
            op = emit(Compact, n, (c,), c.part, c.order)

        elif isinstance(n, ir.Project):
            c = plan.final_op(n.child)
            part, order = _remap_props(c.part, c.order, n.passthrough())
            op = emit(Map, n, (c,), part, order)

        elif isinstance(n, ir.Window):
            c = plan.final_op(n.child)
            if n.partition_by:
                # Partitioned window: require hash(partition_by) co-location
                # plus (partition_by, order_by) ascending grouping; insert
                # the exchange/sort only where the input doesn't already
                # provide them.  join -> window over the join keys therefore
                # plans ZERO extra shuffles, and aggregate -> window on the
                # same keys reuses the grouped layout entirely.
                src = c
                if dists[n.id] != D.REP and \
                        not (elide and colocates(src.part, n.partition_by)):
                    src = hash_exchange(n, src, n.partition_by)
                skeys = n.sort_keys()
                if not (elide and grouped(src.order, skeys)
                        and src.order.ascending):
                    src = local_sort(n, src, skeys)
                part, order = src.part, src.order
            else:
                # global window: row-preserving pass-through.  Global RANK
                # kinds additionally need equal order-key tuples adjacent
                # across the WHOLE stream (a tie straddling a shard boundary
                # would rank wrong): provided by REP, by key co-location
                # (hash/range on an order-key subsequence), or by a
                # globally-sorted block layout.  api.rank inserts the Sort
                # that guarantees it (a full no-op on already-sorted
                # inputs), so this is a plan invariant, not a user surface.
                part, order = c.part, c.order
                src = c
                if n.kind in ("rank", "dense_rank") and n.order_by:
                    adjacent = (grouped(c.order, n.order_by)
                                and (dists[n.id] == D.REP
                                     or colocates(c.part, n.order_by)
                                     or (c.part.kind == "block"
                                         and c.part.globally_sorted)))
                    if not adjacent:
                        raise ValueError(
                            f"global {n.kind} requires equal "
                            f"{n.order_by} tuples adjacent across shards: "
                            "sort(by=order_by) first (api.rank does)")
            # adds column n.out (may shadow an existing one)
            if n.out in part.keys:
                part = BLOCK
            if n.out in order.keys:
                order = Ordering(order.keys[: order.keys.index(n.out)],
                                 order.ascending)
            op = emit(WindowOp, n, (src,), part, order)

        elif isinstance(n, ir.Limit):
            c = plan.final_op(n.child)
            op = emit(LimitOp, n, (c,), c.part, c.order)

        elif isinstance(n, ir.Rebalance):
            c = plan.final_op(n.child)
            # Positional exchange: key co-location is lost (an equal-key run
            # may now straddle a shard boundary, so even a range input can't
            # keep its partitioning).  Ordering is another story: rebalance
            # preserves the GLOBAL concatenated row order, so when the input
            # was globally sorted — range-partitioned with the range keys
            # and local ordering agreeing prefix-wise, or an already
            # globally-sorted block stream — every output shard receives a
            # contiguous slice of a sorted sequence and stays locally
            # sorted.  Per-shard-only ordering (e.g. hash + sort) does NOT
            # survive: a shard may receive [tail of s0, head of s1].  A
            # preserved ordering additionally marks the output partitioning
            # ``globally_sorted``: shard boundaries still follow the global
            # order, so a downstream Sort on an ordering prefix is a full
            # no-op (no splitter routing).
            order = UNORDERED
            part = BLOCK
            range_sorted = (c.part.kind == "range"
                            and c.part.ascending == c.order.ascending and (
                                c.part.keys == c.order.keys[: len(c.part.keys)]
                                or c.order.keys == c.part.keys[: len(c.order.keys)]))
            block_sorted = c.part.kind == "block" and c.part.globally_sorted
            if elide and c.order.keys and (range_sorted or block_sorted):
                order = c.order
                part = Partitioning("block", (), order.ascending,
                                    globally_sorted=True)
            op = emit(RebalanceOp, n, (c,), part, order)

        elif isinstance(n, ir.Concat):
            parts = [plan.final_op(p) for p in n.parts]
            if all(p.part.kind == "rep" for p in parts):
                part = REPL
            elif (all(p.part.kind == "hash" for p in parts)
                  and len({p.part.keys for p in parts}) == 1):
                part = parts[0].part    # same hash fn everywhere: still aligned
            else:
                part = BLOCK
            op = emit(ConcatOp, n, tuple(parts), part, UNORDERED)

        elif isinstance(n, ir.Sort):
            c = plan.final_op(n.child)
            sorted_already = (elide and grouped(c.order, n.by)
                              and c.order.ascending == n.ascending)
            # globally sorted iff locally sorted AND shard ranges follow the
            # requested keys: range keys a prefix of `by` (ties of the range
            # tuple co-locate; minor keys order locally) or `by` a prefix of
            # the range keys (lexicographic order implies order on any key
            # prefix, and eliding preserves the stable tie order a re-sort
            # would produce).  Shard-range DIRECTION must agree too: an
            # ascending local order over descending shard ranges (e.g. a
            # planner-inserted ascending LocalSort downstream of a
            # descending sample sort) is not globally sorted.
            range_ok = c.part.kind == "range" \
                and c.part.ascending == n.ascending and (
                    c.part.keys == n.by[: len(c.part.keys)]
                    or n.by == c.part.keys[: len(n.by)])
            # a globally-sorted block stream (rebalanced sorted data) is
            # sorted by any prefix of its ordering keys; ``sorted_already``
            # checks exactly that prefix + direction, so the flag alone
            # upgrades the local check to a global one.
            block_ok = c.part.kind == "block" and c.part.globally_sorted
            globally_sorted = sorted_already and (c.part.kind == "rep"
                                                  or range_ok or block_ok)
            if globally_sorted:
                plan.op_of[n.id] = c.op_id      # full no-op: reuse child
                op = c
            else:
                pre = (elide and grouped(c.order, n.by) and c.order.ascending)
                op = emit(SampleSort, n, (c,),
                          Partitioning("range", n.by, n.ascending),
                          Ordering(n.by, n.ascending), pre_sorted=pre)

        elif isinstance(n, ir.Repartition):
            # Pure layout request: the node itself computes nothing, it just
            # demands properties — hash(by) co-location and/or sort_by
            # per-shard ordering — and the usual insertion rules pay only
            # for what the input doesn't already provide.  Fully provided
            # layout => complete no-op (reuse the child op), so a redundant
            # repartition costs nothing.
            c = plan.final_op(n.child)
            src = c
            if n.by and dists[n.id] != D.REP and \
                    not (elide and colocates(src.part, n.by)):
                src = hash_exchange(n, src, n.by)
            if n.sort_by and not (elide and grouped(src.order, n.sort_by)
                                  and src.order.ascending):
                src = local_sort(n, src, n.sort_by)
            op = src

        elif isinstance(n, ir.Join):
            l, r = plan.final_op(n.left), plan.final_op(n.right)
            broadcast = dists[n.right.id] == D.REP and cfg.broadcast_join
            rep_join = dists[n.id] == D.REP and not broadcast
            salted = False
            if not broadcast and not rep_join:
                il = _hash_alignment(l.part, n.left_on) if elide else None
                ir_ = _hash_alignment(r.part, n.right_on) if elide else None
                # --- adaptive: salted skew join (docs/adaptive_planning.md).
                # Heavy-hitter probe keys spread over R keys+salt
                # sub-partitions; the build side replicates its hot rows
                # R-ways so every (probe, build) match agrees on exactly one
                # salt.  Free when both sides pay an exchange anyway; when
                # only the build side is pre-aligned we salt iff its
                # estimated re-exchange bytes are below the probe side's.
                # Never when the PROBE side is aligned — salting would
                # forfeit that elision.
                hot: tuple = ()
                R = int(getattr(cfg, "salt_factor", 8))
                if adaptive and R > 1:
                    thr = float(getattr(cfg, "salt_threshold", 0.1))
                    # realized skew from a previous run of this plan, OR
                    # skew a REGISTERED table's persisted ScanLayout counts
                    # show for free (hash-partitioned on the join keys: the
                    # shard occupancy IS the key distribution — no
                    # re-sampling pass; docs/serving.md): salt more eagerly.
                    if stats.skewed_before(n) or stats.layout_skewed(
                            n.left, n.left_on):
                        thr /= 2.0
                    hot = stats.hot_keys(n.left, n.left_on, thr)
                if hot:
                    lb = _est_shuffle_bytes(n.left)
                    rb = _est_shuffle_bytes(n.right)
                    salted = (il is None and ir_ is None) or (
                        il is None and ir_ is not None
                        and lb is not None and rb is not None and rb <= lb)
                if salted:
                    hf = stats.hot_fraction(n.right, n.right_on, hot)
                    vals = tuple(k for k, _f in hot)
                    sp = emit(SaltOp, n, (l,), l.part, l.order,
                              keys=n.left_on, hot=vals, R=R, build=False)
                    sp.rows_est = l.rows_est
                    l = hash_exchange(n, sp, n.left_on + (SALT_COL,))
                    sb = emit(SaltOp, n, (r,), r.part, r.order,
                              keys=n.right_on, hot=vals, R=R, build=True,
                              hot_frac=1.0 if hf is None else hf)
                    sb.rows_est = r.rows_est
                    r = hash_exchange(n, sb, n.right_on + (SALT_COL,))
                    # salt is stripped post-join, so a full-key group may
                    # straddle shards: the output provides NO co-location.
                    part = BLOCK
                elif il is not None and il == ir_:
                    idx = il
                    part = Partitioning("hash",
                                        tuple(n.left_on[i] for i in idx))
                elif il is not None and ir_ is not None and adaptive:
                    # both sides aligned on DIFFERENT key subsequences: one
                    # must re-hash.  The static rule keeps the left; stats
                    # pick whichever side ships fewer estimated bytes.
                    lb = _est_shuffle_bytes(n.left)
                    rb = _est_shuffle_bytes(n.right)
                    if lb is not None and rb is not None and lb < rb:
                        idx = ir_
                        l = hash_exchange(n, l,
                                          tuple(n.left_on[i] for i in idx))
                        l.note = (f"cheap side: re-hash left "
                                  f"~{int(lb)}B < ~{int(rb)}B")
                    else:
                        idx = il
                        r = hash_exchange(n, r,
                                          tuple(n.right_on[i] for i in idx))
                        if lb is not None and rb is not None:
                            r.note = (f"cheap side: re-hash right "
                                      f"~{int(rb)}B <= ~{int(lb)}B")
                    part = Partitioning("hash",
                                        tuple(n.left_on[i] for i in idx))
                elif il is not None:
                    idx = il
                    r = hash_exchange(n, r, tuple(n.right_on[i] for i in idx))
                    part = Partitioning("hash",
                                        tuple(n.left_on[i] for i in idx))
                elif ir_ is not None:
                    idx = ir_
                    l = hash_exchange(n, l, tuple(n.left_on[i] for i in idx))
                    part = Partitioning("hash",
                                        tuple(n.left_on[i] for i in idx))
                else:
                    l = hash_exchange(n, l, n.left_on)
                    r = hash_exchange(n, r, n.right_on)
                    part = Partitioning("hash", n.left_on)
            else:
                part = l.part
            # output rows follow left row order (each left row repeated per
            # match), so the left ordering survives verbatim.
            op = emit(MergeJoin, n, (l, r), part, l.order,
                      broadcast=broadcast, salted=salted)

        elif isinstance(n, ir.Aggregate):
            c = plan.final_op(n.child)
            part, order = _restrict_props(c.part, c.order, set(n.key))
            prep = emit(AggPrep, n, (c,), part, order)
            src: POp = prep
            # REP aggregates never exchange (each shard aggregates the whole
            # table) — independent of elision, like the join/sort rep guards.
            needs_exchange = dists[n.id] != D.REP and \
                not (elide and colocates(src.part, n.key))
            ch_schema = n.child.schema
            decomp = all(decomposable(a.fn, a.skipna,
                                      nulltag_for(a.expr, ch_schema))
                         for a in n.aggs.values())
            if needs_exchange and decomp and partial_agg:
                # Map-side partial aggregation: pre-reduce local key runs so
                # the exchange ships at most this shard's DISTINCT key
                # tuples.  A pre-partitioned input (needs_exchange False)
                # skips the partial stage entirely — the elision rules and
                # this rewrite compose rather than stack.
                if not (elide and grouped(src.order, n.key)
                        and src.order.ascending):
                    src = local_sort(n, src, n.key)
                # adaptive: size the partial-agg buckets (and thereby the
                # post-partial exchange) from a distinct-group estimate —
                # realized feedback from a previous run of this exact plan
                # wins over the sampled estimate.  Only consulted by
                # compute_capacities when the user declared no agg_group_cap.
                nd, nsrc = None, ""
                if adaptive:
                    rl = stats.realized(n)
                    if rl is not None:
                        nd, nsrc = int(rl["rows"]), "realized"
                    else:
                        d = stats.ndv_cap(n.child, n.key)
                        if d is not None:
                            nd, nsrc = int(d), "sample"
                src = emit(PartialAgg, n, (src,), src.part,
                           Ordering(n.key, True), ndv_est=nd, ndv_src=nsrc)
                src = hash_exchange(n, src, n.key)
                src = local_sort(n, src, n.key)
                op = emit(SegmentAgg, n, (src,), src.part,
                          Ordering(n.key, True), from_partials=True)
            else:
                if needs_exchange:
                    src = hash_exchange(n, src, n.key)
                nu_names = [name for name, a in n.aggs.items()
                            if a.fn == "nunique"]
                has_first = any(a.fn == "first" for a in n.aggs.values())
                pre_grouped = (elide and grouped(src.order, n.key)
                               and (src.order.ascending or not nu_names))
                ride = None
                if not pre_grouped:
                    skeys = n.key
                    if nu_names and not has_first:
                        # aux-sort elision: the FIRST nunique column rides
                        # this LocalSort as a trailing key, so
                        # segment_aggregate skips its own lax.sort for it.
                        # ("first" pins the in-group arrival order, which a
                        # trailing value key would scramble — no ride then.)
                        ride = nu_names[0]
                        skeys = n.key + ("__v_" + ride,)
                    src = local_sort(n, src, skeys)
                op = emit(SegmentAgg, n, (src,), src.part,
                          Ordering(n.key, src.order.ascending),
                          nunique_ride=ride)

        else:
            raise TypeError(n)

        plan.op_of[n.id] = op.op_id

    plan.root_id = plan.op_of[root.id]
    annotate_schemas(plan)
    return plan


def annotate_schemas(plan: PhysicalPlan) -> None:
    """Fill every op's output ``schema`` estimate (name -> np.dtype).

    One forward pass (ops are emitted in topo order): inserted exchanges and
    sorts pass their input schema through; AggPrep narrows to keys + __v_*
    value columns (dtype via expr.infer_dtype over the child schema — same
    inference ir.Project uses); PartialAgg replaces values with the
    decomposed __p_* statistics.  The estimates drive the collective/byte
    census of the packed exchange.
    """
    f32 = np.dtype(np.float32)
    i32 = np.dtype(np.int32)
    for op in plan.ops:
        n = op.node
        if isinstance(op, (HashExchange, LocalSort)):
            op.schema = dict(plan.ops[op.inputs[0]].schema)
        elif isinstance(op, SaltOp):
            op.schema = dict(plan.ops[op.inputs[0]].schema)
            op.schema[SALT_COL] = i32
        elif isinstance(op, AggPrep):
            base = plan.ops[op.inputs[0]].schema
            sch = {k: base.get(k, f32) for k in n.key}
            for name, agg in n.aggs.items():
                if agg.expr is None:
                    dt = i32            # bare count rides a zeros placeholder
                else:
                    dt = np.dtype(infer_dtype(agg.expr, base))
                sch["__v_" + name] = dt
            op.schema = sch
        elif isinstance(op, PartialAgg):
            # wire schema straight off the decomposition table — the same
            # single source of truth partial_decompose/final_aggregate use.
            base = plan.ops[op.inputs[0]].schema
            sch = {k: base.get(k, f32) for k in n.key}
            for name, agg in n.aggs.items():
                vd = np.dtype(base.get("__v_" + name, f32))
                for spec in AGG_DECOMP[agg.fn][0]:
                    sch[f"__p_{name}__{spec.suffix}"] = spec.dtype(vd)
            op.schema = sch
        else:
            op.schema = {k: np.dtype(dt) for k, dt in n.schema.items()}


def _hash_alignment(part: Partitioning,
                    on: tuple[str, ...]) -> Optional[tuple[int, ...]]:
    """If ``part`` is hash partitioning on a subsequence of the join keys,
    return the key-position indices it covers (the other side can then be
    exchanged on ITS columns at the same positions and the two sides align,
    because the combined hash is value-deterministic).  Else None."""
    if part.kind != "hash" or not part.keys:
        return None
    return subsequence_indices(part.keys, on)


# ---------------------------------------------------------------------------
# capacity planning (moved from lower.py; operates on physical ops)
# ---------------------------------------------------------------------------


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def scan_rows(n: ir.Scan) -> int:
    """Valid rows of a Scan: persisted device layouts count their valid
    prefixes (the columns are padded ``(nshards * capacity,)`` buffers)."""
    if n.layout is not None and n.layout.counts is not None:
        return n.layout.rows()
    return len(next(iter(n.columns.values())))


def compute_capacities(plan: PhysicalPlan, P: int, cfg,
                       source_rows: dict[int, int]) -> dict[int, tuple[int, int]]:
    """Capacity plan as a pure map op_id -> (cap, bucket) — shared by
    :func:`plan_capacities` (which writes the live fields) and the
    shuffle-byte census (which probes a FIXED P without touching them).

    Exchanges get (src,dst) bucket capacities and a post-exchange capacity;
    pass-through ops inherit their input capacity.  An elided exchange means
    the consumer keeps the local capacity — smaller buffers, not just fewer
    collectives.  Policy matches the original lower.py planner: "safe" bounds
    every buffer by the worst case; otherwise capacities are input*slack and
    overflow is flagged (collect() retries, DESIGN.md §2).  A PartialAgg holds at
    most its input rows, and ``cfg.agg_group_cap`` (a user bound on distinct
    groups per shard) tightens it further — shrinking the bucket of the
    post-partial exchange, not just its row count.
    """
    safe = getattr(cfg, "safe_capacities", True)
    slack = getattr(cfg, "shuffle_slack", 2.0)
    join_exp = getattr(cfg, "join_expansion", 1.5)
    group_cap = getattr(cfg, "agg_group_cap", None)
    # per-op capacity overrides (runtime/retry.py escalation): op_id ->
    # (cap, bucket) FLOORS applied after the normal rule, so a retry grows
    # exactly the overflowed site and downstream ops inherit the growth
    # through this forward pass — no global slack-doubling.
    overrides = getattr(cfg, "cap_overrides", None) or {}
    caps: dict[int, tuple[int, int]] = {}

    def shuffle_plan(cap_in: int) -> tuple[int, int]:
        if safe:
            bucket = cap_in                 # worst case: all rows to one shard
            out = P * bucket
        else:
            bucket = max(32, _ceil_div(int(cap_in * slack), P))
            out = max(32, int(cap_in * slack))
        return bucket, out

    for op in plan.ops:
        ins = [caps[i] for i in op.inputs]
        cap, bucket = 0, 0
        if isinstance(op, Source):
            lay = op.node.layout
            # device shards only re-enter at their own capacity when the
            # runtime takes the device path (lower.dev_scans): matching
            # shard count AND a non-REP distribution — a force-replicated
            # persisted frame gathers to the host and re-pads per REP rules.
            if lay is not None and lay.device_valid(P) and op.dist != D.REP:
                cap = int(lay.capacity)
            else:
                rows = source_rows[op.node.id]
                cap = rows if op.dist == D.REP else max(1, _ceil_div(rows, P))
        elif isinstance(op, LimitOp):
            cap = max(1, min(ins[0][0], op.node.n))
        elif isinstance(op, (HashExchange, SampleSort)):
            bucket, cap = shuffle_plan(ins[0][0])
        elif isinstance(op, MergeJoin):
            lcap, rcap = ins[0][0], ins[1][0]
            cap = max(1, int(max(join_exp, 1.0) * (lcap + rcap)))
        elif isinstance(op, ConcatOp):
            cap = sum(i[0] for i in ins)
        elif isinstance(op, RebalanceOp):
            bucket = ins[0][0]
            cap = ins[0][0]
        elif isinstance(op, SaltOp):
            cap = ins[0][0]
            if op.build:
                # hot build rows gain R-1 replicas.  Safe mode bounds by the
                # all-hot worst case; otherwise size replicas off the
                # estimated hot fraction (overflow-retry backstops a lie).
                if safe:
                    cap = max(1, op.R * cap)
                else:
                    extra = max(32, int(np.ceil(cap * op.hot_frac * slack)))
                    cap = cap + (op.R - 1) * min(extra, cap)
        elif isinstance(op, PartialAgg):
            cap = ins[0][0]
            if group_cap is not None:
                cap = max(1, min(cap, int(group_cap)))
            elif op.ndv_est is not None:
                # adaptive auto-cap: local distinct groups never exceed the
                # GLOBAL group count, so realized feedback is an exact bound;
                # a sampled estimate gets stats_cap_slack headroom (the
                # overflow-retry loop widens it further if the sample lied).
                slk = getattr(cfg, "stats_cap_slack", 2.0)
                est = (int(op.ndv_est) if op.ndv_src == "realized"
                       else int(np.ceil(op.ndv_est * slk)))
                cap = max(1, min(cap, max(64, est)))
        else:   # Compact / Map / WindowOp / AggPrep / LocalSort / SegmentAgg
            cap = ins[0][0]
        if op.op_id in overrides:
            o_cap, o_bucket = overrides[op.op_id]
            cap = max(cap, int(o_cap))
            if bucket:
                bucket = max(bucket, int(o_bucket))
        caps[op.op_id] = (cap, bucket)
    return caps


def plan_capacities(plan: PhysicalPlan, P: int, cfg,
                    source_rows: dict[int, int]) -> None:
    """Fill ``cap``/``bucket`` on every op (see :func:`compute_capacities`)."""
    for op_id, (cap, bucket) in compute_capacities(plan, P, cfg,
                                                   source_rows).items():
        plan.ops[op_id].cap = cap
        plan.ops[op_id].bucket = bucket
