"""Logical plan IR — the Domain-Pass analogue.

The paper encapsulates relational operations into first-class AST nodes
(``Expr(:aggregate, ...)``) so that the whole-program compiler can see and
transform them.  Here each node is an explicit dataclass; a DataFrame wraps a
node, and ``collect()`` triggers optimize → distribute → lower → jit.

Node ids are globally unique; expression ColRefs name columns as
(node_id, column_name), which gives the optimizer exact column provenance
(needed for predicate pushdown through join and for column pruning).
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field, replace
from typing import Any, Optional

import numpy as np

from .expr import AggExpr, ColRef, Expr, expr_nullable, infer_dtype
from .dtypes import as_nullable, is_category, is_nullable

_ids = itertools.count()


def fresh_id() -> int:
    return next(_ids)


def as_keys(x) -> tuple[str, ...]:
    """Normalize a key spec (scalar name or sequence of names) to a tuple.

    Composite (multi-column) keys are carried as tuples everywhere in the IR;
    single-key call sites stay source-compatible via this normalization.
    """
    if isinstance(x, str):
        return (x,)
    keys = tuple(x)
    if not keys or not all(isinstance(k, str) for k in keys):
        raise TypeError(f"key columns must be non-empty str names, got {x!r}")
    return keys


@dataclass(eq=False)
class Node:
    """Base logical node.  ``schema`` maps column name -> numpy dtype."""

    id: int = field(default_factory=fresh_id, init=False)

    @property
    def children(self) -> tuple["Node", ...]:
        return ()

    @property
    def schema(self) -> dict[str, np.dtype]:
        raise NotImplementedError

    def with_children(self, children: tuple["Node", ...]) -> "Node":
        raise NotImplementedError

    def short(self) -> str:
        return type(self).__name__


@dataclass(frozen=True)
class ScanLayout:
    """Physical layout a MATERIALIZED scan carries (``df.persist()``).

    A persisted frame's Scan is not a plain host table: its columns may be
    device shards laid out by the plan that produced them, and this record
    is the contract that lets downstream planning start from those
    properties instead of "block, unordered":

      * ``kind``/``partitioned_by``/``ascending`` — the Partitioning the
        producing plan's root op provided (hash/range/rep/block);
        ``globally_sorted`` marks a block layout whose shard boundaries
        follow ``sorted_by`` (rebalanced sorted stream).
      * ``sorted_by``/``order_ascending`` — each shard's valid-prefix
        ordering.
      * ``counts``/``capacity``/``nshards`` — the 1D_VAR carrier: every
        rank's valid-row count and the per-rank capacity.  The columns are
        each rank's OWN ``(capacity,)`` device shard, which ``persist()``
        keeps on the rank that computed it (the reference package keeps
        ``(nshards * capacity,)`` global arrays instead); a state carried
        over from the reference may hold every shard, of which each rank
        takes its own rows.  ``counts is None`` means the columns are plain
        host arrays (REP results re-enter that way) and only the ordering
        claims apply.
      * ``dist`` — the lattice element the table satisfies (seeds
        distribution inference).

    Hash/range claims are only valid at the shard count they were produced
    under (routing is ``hash % P`` / data-dependent splitters), so every
    consumer gates on :meth:`device_valid`.
    """

    kind: str = "block"                  # "hash" | "range" | "rep" | "block"
    partitioned_by: tuple[str, ...] = ()
    ascending: bool = True
    globally_sorted: bool = False
    sorted_by: tuple[str, ...] = ()
    order_ascending: bool = True
    counts: Any = None                   # (nshards,) np.int32, or None (host)
    capacity: int = 0
    nshards: int = 1
    dist: str = "1D_VAR"

    def device_valid(self, P: int) -> bool:
        """Do the device shards (and the partitioning claims that depend on
        shard routing) re-enter directly at shard count ``P``?"""
        return self.counts is not None and self.nshards == P

    def rows(self) -> int:
        return int(np.sum(self.counts)) if self.counts is not None else -1

    def restrict(self, live: set[str]) -> "ScanLayout":
        """Layout after pruning to ``live`` columns: partitioning survives
        iff every key survives; ordering keeps its longest surviving prefix
        (same rules as the physical planner's property restriction)."""
        kind, pkeys, gs = self.kind, self.partitioned_by, self.globally_sorted
        if kind in ("hash", "range") and not all(k in live for k in pkeys):
            kind, pkeys, gs = "block", (), False
        prefix = []
        for k in self.sorted_by:
            if k not in live:
                break
            prefix.append(k)
        if not prefix:
            gs = False
        return replace(self, kind=kind, partitioned_by=pkeys,
                       globally_sorted=gs, sorted_by=tuple(prefix))

    def gather_host(self, columns: dict[str, Any]) -> dict[str, np.ndarray]:
        """Fallback re-entry at a DIFFERENT shard count: concatenate every
        shard's valid prefix on the host (the round-trip ``device_valid``
        re-entry avoids).  The columns must hold every shard,
        ``(nshards * capacity,)`` host arrays: one rank's shard of several
        cannot re-enter this way."""
        cnts = np.asarray(self.counts)
        out = {}
        for name, col in columns.items():
            a = np.asarray(col).reshape(self.nshards, self.capacity)
            out[name] = np.concatenate(
                [a[r, : cnts[r]] for r in range(self.nshards)])
        return out


@dataclass(eq=False)
class Scan(Node):
    """Leaf: a source table (in-memory arrays or a named dataset).

    ``layout`` is set for persisted/cached frames (see :class:`ScanLayout`):
    the columns are then device shards whose partitioning/ordering seed the
    physical planner, letting whole downstream pipelines start elided.
    """

    name: str
    columns: dict[str, Any]          # name -> array (host or device)
    _schema: dict[str, np.dtype] = None
    layout: Optional[ScanLayout] = None

    def __post_init__(self):
        if self._schema is None:
            self._schema = {k: np.asarray(v[:0] if hasattr(v, "__getitem__") else v).dtype
                            for k, v in self.columns.items()}

    @property
    def schema(self):
        return dict(self._schema)

    def with_children(self, children):
        assert not children
        return self

    def short(self):
        if self.layout is not None and self.layout.kind != "block":
            return f"Scan({self.name}|{self.layout.kind})"
        return f"Scan({self.name})"


@dataclass(eq=False)
class Filter(Node):
    child: Node
    pred: Expr

    @property
    def children(self):
        return (self.child,)

    @property
    def schema(self):
        return self.child.schema

    def with_children(self, children):
        n = replace(self)
        n.child = children[0]
        return n

    def short(self):
        return f"Filter({self.pred})"


@dataclass(eq=False)
class Project(Node):
    """Column selection / renaming / derived columns.

    ``cols`` maps output name -> Expr over child columns.  Covers projection,
    column assignment (``df[:id3] = ...``) and renames.
    """

    child: Node
    cols: dict[str, Expr]
    dtypes: dict[str, np.dtype] = None  # resolved lazily at lowering

    @property
    def children(self):
        return (self.child,)

    @property
    def schema(self):
        if self.dtypes:
            return dict(self.dtypes)
        child_schema = self.child.schema
        out = {}
        for name, e in self.cols.items():
            if isinstance(e, ColRef) and e.name in child_schema:
                out[name] = child_schema[e.name]  # logical dtype rides along
            else:
                dt = infer_dtype(e, child_schema)
                out[name] = (as_nullable(dt)
                             if expr_nullable(e, child_schema) else dt)
        return out

    def passthrough(self) -> dict[str, str]:
        """Output columns that are pure renames: out name -> child column.

        The physical planner uses this to push partitioning/ordering
        properties through projections; computed columns provide nothing.
        """
        return {name: e.name for name, e in self.cols.items()
                if isinstance(e, ColRef)}

    def with_children(self, children):
        n = replace(self)
        n.child = children[0]
        return n

    def short(self):
        return f"Project({list(self.cols)})"


@dataclass(eq=False)
class Join(Node):
    """Equi-join (inner or left-outer) on one or more key column pairs.

    ``left_on``/``right_on`` are equal-length tuples; position i of each pair
    is compared for equality.  Scalar names normalize to 1-tuples.
    """

    left: Node
    right: Node
    left_on: tuple[str, ...]
    right_on: tuple[str, ...]
    suffix: str = "_r"
    how: str = "inner"

    def __post_init__(self):
        self.left_on = as_keys(self.left_on)
        self.right_on = as_keys(self.right_on)
        if len(self.left_on) != len(self.right_on):
            raise ValueError(f"key arity mismatch: {self.left_on} vs {self.right_on}")

    @property
    def children(self):
        return (self.left, self.right)

    @property
    def schema(self):
        ls, rs = self.left.schema, self.right.schema
        out = dict(ls)
        for name, dt in rs.items():
            if name in self.right_on:
                continue  # keys are unified into left_on
            if self.how == "left" and (
                    is_category(dt) or np.issubdtype(np.dtype(dt), np.floating)):
                # unmatched left rows null-fill the right columns (NaN /
                # null code); int payloads keep zero-fill + _matched
                dt = as_nullable(dt)
            out[name + self.suffix if name in out else name] = dt
        if self.how == "left":
            out["_matched"] = np.dtype(np.int32)
        return out

    def right_out_name(self, name: str) -> str:
        return name + self.suffix if name in self.left.schema else name

    def with_children(self, children):
        n = replace(self)
        n.left, n.right = children
        return n

    def short(self):
        pairs = ",".join(f"{l}=={r}" for l, r in zip(self.left_on, self.right_on))
        return f"Join({pairs})"


@dataclass(eq=False)
class Aggregate(Node):
    """Group-by ``key`` (one or more columns) with named aggregations."""

    child: Node
    key: tuple[str, ...]
    aggs: dict[str, AggExpr]

    def __post_init__(self):
        self.key = as_keys(self.key)

    @property
    def children(self):
        return (self.child,)

    @property
    def schema(self):
        cs = self.child.schema
        out = {k: cs[k] for k in self.key}
        for name, agg in self.aggs.items():
            nullable = agg.expr is not None and (
                expr_nullable(agg.expr, cs)
                or (isinstance(agg.expr, ColRef)
                    and is_nullable(cs.get(agg.expr.name))))
            if agg.fn in ("count", "nunique"):
                out[name] = np.dtype(np.int32)
            elif agg.fn in ("any", "all"):
                out[name] = np.dtype(np.bool_)
            elif agg.fn in ("mean", "var", "std"):
                dt = np.dtype(np.float32)
                out[name] = as_nullable(dt) if nullable else dt
            elif agg.fn in ("min", "max", "first"):
                # value dtype passes through — category min/max/first stay
                # category (sorted dictionaries make code order string order)
                dt = infer_dtype(agg.expr, cs)
                if isinstance(agg.expr, ColRef) and is_category(cs.get(agg.expr.name)):
                    dt = cs[agg.expr.name]
                out[name] = as_nullable(dt) if nullable else dt
            elif agg.fn in ("sum", "prod"):
                dt = infer_dtype(agg.expr, cs)
                if dt == np.dtype(bool):
                    dt = np.dtype(np.int32)  # segment sums cast bool up
                out[name] = dt  # skipna sum/prod of all-null = 0/1, not null
            else:
                out[name] = np.dtype(np.float32)
        return out

    def with_children(self, children):
        n = replace(self)
        n.child = children[0]
        return n

    def short(self):
        by = self.key[0] if len(self.key) == 1 else list(self.key)
        return f"Aggregate(by={by}, {list(self.aggs)})"


@dataclass(eq=False)
class Concat(Node):
    """Vertical concatenation (UNION ALL); schemas must match."""

    parts: tuple[Node, ...]

    @property
    def children(self):
        return tuple(self.parts)

    @property
    def schema(self):
        return self.parts[0].schema

    def with_children(self, children):
        n = replace(self)
        n.parts = tuple(children)
        return n


# Window kinds whose output is an integer position within the group (they
# take no input expression — ``expr`` is None).
RANK_KINDS = ("rank", "dense_rank", "row_number")
WINDOW_KINDS = ("cumsum", "stencil") + RANK_KINDS


@dataclass(eq=False)
class Window(Node):
    """Analytics window ops: cumsum, 1-D stencil (SMA/WMA) or rank.

    kind='cumsum'      -> out = prefix sums of ``expr``
    kind='stencil'     -> out[i] = sum_j weights[j] * x[i + j - center]
    kind='rank' / 'dense_rank' / 'row_number'
                       -> SQL ranking over ``order_by`` (requires
                          ``partition_by``); ``expr`` is None.

    ``partition_by`` non-empty makes the window PARTITIONED (SQL
    ``OVER (PARTITION BY ... ORDER BY ...)``): the computation restarts at
    every group boundary and stencil taps never cross one.  The physical
    planner realizes it as hash(partition_by) co-location plus a
    (partition_by + order_by) local sort, both elided when the input
    already provides them.  Output rows come back in that grouped layout
    (not input order).  Adds column ``out`` to the child's schema.
    """

    child: Node
    kind: str
    expr: Optional[Expr]
    out: str
    weights: tuple[float, ...] = ()
    center: int = 0
    partition_by: tuple[str, ...] = ()
    order_by: tuple[str, ...] = ()
    # stencil-only: renormalize border windows by the realized weight mass
    # (divide by the weights of the taps that actually contributed instead
    # of the full window) — pandas' min_periods=1 exact rolling mean.
    exact: bool = False

    def __post_init__(self):
        if self.kind not in WINDOW_KINDS:
            raise ValueError(f"unknown window kind {self.kind!r}")
        if self.exact:
            # exact borders renormalize by the realized weight MASS, which
            # is only meaningful for nonnegative windows with positive
            # total weight (rolling means, SMA/WMA); a difference stencil
            # would divide by (near-)zero everywhere.
            if self.kind != "stencil":
                raise ValueError("exact= applies only to stencil windows")
            if any(w < 0 for w in self.weights) or sum(self.weights) <= 0:
                raise ValueError(
                    "exact=True requires nonnegative weights with a "
                    "positive sum (border renormalization divides by the "
                    "realized weight mass)")
        self.partition_by = as_keys(self.partition_by) if self.partition_by else ()
        self.order_by = as_keys(self.order_by) if self.order_by else ()
        if self.kind in RANK_KINDS:
            # row_number without order_by is well-defined: 1-based position
            # in post-exchange arrival order (segment_rank ignores order
            # keys for it) — the per-group top-k fusion relies on this.
            # rank/dense_rank compare order-key values, so they require one.
            # partition_by may be EMPTY: the window is then GLOBAL, lowered
            # as a per-shard-count exscan plus (for rank/dense_rank)
            # boundary-run reconciliation — the physical planner requires
            # equal order-key tuples adjacent across the global stream
            # (api.rank sorts first; already-sorted inputs plan a no-op).
            need_order = self.kind != "row_number"
            if need_order and not self.order_by:
                raise ValueError(f"{self.kind} requires order_by keys")
        elif self.order_by and not self.partition_by:
            # A global ORDER BY (no PARTITION BY) would need a global
            # re-sort before the scan/stencil; silently computing in
            # arrival order instead would be wrong — sort first.
            raise ValueError(
                f"{self.kind} with order_by requires partition_by; for a "
                f"globally ordered window, sort(by=order_by) first")

    def sort_keys(self) -> tuple[str, ...]:
        """Keys the grouped layout must be ordered by: partition keys first,
        then order keys (dropping duplicates already in the partition)."""
        return self.partition_by + tuple(
            k for k in self.order_by if k not in self.partition_by)

    @property
    def children(self):
        return (self.child,)

    @property
    def schema(self):
        s = self.child.schema
        if self.kind in RANK_KINDS:
            s[self.out] = np.dtype(np.int32)
        elif self.kind == "cumsum" and self.expr is not None:
            dt = infer_dtype(self.expr, s)
            if dt == np.dtype(bool):
                dt = np.dtype(np.int32)  # cumsum promotes bool
            s[self.out] = (as_nullable(dt)
                           if expr_nullable(self.expr, s) else dt)
        else:
            s[self.out] = np.dtype(np.float32)  # stencils compute in float
        return s

    def with_children(self, children):
        n = replace(self)
        n.child = children[0]
        return n

    def short(self):
        over = ""
        if self.partition_by:
            over = f" over({','.join(self.partition_by)}"
            if self.order_by:
                over += f"; {','.join(self.order_by)}"
            over += ")"
        return f"Window({self.kind}->{self.out}{over})"


@dataclass(eq=False)
class Limit(Node):
    """First ``n`` rows in global (shard-concatenation) order — the backend
    of ``df.head(n)`` / ``df.limit(n)``.

    No data moves: each shard clamps its valid count to the slice of
    ``[0, n)`` it owns (one exclusive scan of counts).  Partitioning and
    ordering both survive — a subset of co-located key groups is still
    co-located, and a prefix of sorted rows is still sorted.
    """

    child: Node
    n: int

    def __post_init__(self):
        if int(self.n) < 0:
            raise ValueError(f"limit must be >= 0, got {self.n}")
        self.n = int(self.n)

    @property
    def children(self):
        return (self.child,)

    @property
    def schema(self):
        return self.child.schema

    def with_children(self, children):
        m = replace(self)
        m.child = children[0]
        return m

    def short(self):
        return f"Limit({self.n})"


@dataclass(eq=False)
class Sort(Node):
    """Global sample-sort, lexicographic over one or more key columns."""

    child: Node
    by: tuple[str, ...]
    ascending: bool = True

    def __post_init__(self):
        self.by = as_keys(self.by)

    @property
    def children(self):
        return (self.child,)

    @property
    def schema(self):
        return self.child.schema

    def with_children(self, children):
        n = replace(self)
        n.child = children[0]
        return n


@dataclass(eq=False)
class Repartition(Node):
    """Layout-only verb: hash-partition by ``by`` and/or sort each shard by
    ``sort_by`` — same rows, new placement/order (``df.repartition()`` /
    ``df.sort_within_partitions()``).

    Purely a property request to the physical planner: it inserts a hash
    exchange (for ``by``) and/or a shard-local sort (for ``sort_by``), each
    elided when the input already provides the property.  Chained with
    ``persist()`` the produced layout is captured in the Scan, which is the
    point — pre-staging a hot table so later queries plan zero exchanges.
    """

    child: Node
    by: tuple[str, ...] = ()
    sort_by: tuple[str, ...] = ()

    def __post_init__(self):
        self.by = as_keys(self.by) if self.by else ()
        self.sort_by = as_keys(self.sort_by) if self.sort_by else ()
        if not self.by and not self.sort_by:
            raise ValueError("Repartition requires by= and/or sort_by= keys")

    @property
    def children(self):
        return (self.child,)

    @property
    def schema(self):
        return self.child.schema

    def with_children(self, children):
        n = replace(self)
        n.child = children[0]
        return n

    def short(self):
        parts = []
        if self.by:
            parts.append(f"by={','.join(self.by)}")
        if self.sort_by:
            parts.append(f"sort={','.join(self.sort_by)}")
        return f"Repartition({'; '.join(parts)})"


@dataclass(eq=False)
class Rebalance(Node):
    """Inserted by the distribution pass: 1D_VAR -> 1D_BLOCK."""

    child: Node

    @property
    def children(self):
        return (self.child,)

    @property
    def schema(self):
        return self.child.schema

    def with_children(self, children):
        n = replace(self)
        n.child = children[0]
        return n


# ---------------------------------------------------------------------------
# DAG utilities
# ---------------------------------------------------------------------------


def node_exprs(n: Node) -> list:
    """The expressions ``n`` evaluates over its child's rows: a filter's
    predicate, a project's columns, a window's input, an aggregate's
    inputs."""
    if isinstance(n, Filter):
        return [n.pred]
    if isinstance(n, Project):
        return list(n.cols.values())
    if isinstance(n, Window):
        return [n.expr] if n.expr is not None else []
    if isinstance(n, Aggregate):
        return [a.expr for a in n.aggs.values() if a.expr is not None]
    return []


def topo_order(root: Node) -> list[Node]:
    seen: dict[int, Node] = {}
    order: list[Node] = []

    def visit(n: Node):
        if n.id in seen:
            return
        seen[n.id] = n
        for c in n.children:
            visit(c)
        order.append(n)

    visit(root)
    return order


def plan_str(root: Node, dists: dict[int, str] | None = None) -> str:
    """Pretty-printer used by EXPLAIN and the optimizer tests."""
    lines: list[str] = []

    def rec(n: Node, depth: int):
        d = f"  [{dists[n.id]}]" if dists and n.id in dists else ""
        lines.append("  " * depth + f"{n.short()} #{n.id}{d}")
        for c in n.children:
            rec(c, depth + 1)

    rec(root, 0)
    return "\n".join(lines)
