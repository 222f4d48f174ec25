"""HiFrames user API on PyTorch — the relational main path and windows.

The same fluent, pandas-flavored surface as the reference package, for the
verbs ported so far:

    from repro_torch import hiframes as hf
    df = hf.table({"id": ids, "x": xs, "y": ys})        # host arrays
    out = (df[df.x < 0.5]                                # filter
             .merge(dim, on=("id", "cid"))               # equi-join
             .groupby("id")                              # group-by
             .agg(total=("x", "sum"), ym=hf.mean(df.y))
             .collect(hf.ExecConfig(device="cpu")))      # plan + run

Window functions, global or PARTITIONED (SQL ``OVER (PARTITION BY ...
ORDER BY ...)``), as in the reference:

    d0 = hf.wma(df, df.x, [1, 2, 1])               # global WMA (halo stencil)
    w = df.over("g", order_by="t")                 # the OVER clause
    d1 = w.cumsum(df.x)                            # per-group running total
    d2 = w.rolling_mean(df.x, 5, exact=True)       # pandas min_periods=1 mode
    d3 = w.rank()                                  # SQL RANK()

``hf.cumsum``, ``stencil``, ``sma``, ``wma``, ``lag``, ``lead``,
``rolling_sum``, ``rolling_mean``, ``rank``, ``dense_rank`` and
``row_number`` take ``partition_by=`` / ``order_by=`` keywords; a
partitioned window returns rows in the grouped layout (hash-partitioned on
the group keys, sorted by group and order keys within each rank).

Global sorts, limits, layouts and materialization, as in the reference:

    top = agg.sort_values("total", ascending=False).head(10)   # sample sort
    both = hf.concat(df_a, df_b)                               # UNION ALL
    hot = dim.groupby("k").agg(s=("x", "sum")).persist(cfg)   # run once
    hot.merge(fact, on="k")                # zero exchanges on the kept keys

``repartition(by)`` hash-partitions, ``sort_within_partitions(by)`` sorts
each rank, ``replicate()`` pins a frame to REP (broadcast), and a global
``rank``/``dense_rank``/``row_number`` with ``order_by`` sorts first.  A
persisted frame keeps each rank's shard on its device and re-enters later
plans by identity.

Column, null and dtype verbs, and strings, as in the reference:

    df["r"] = df.x / df.y                                  # column assignment
    v = (df.dropna(subset="ch").fillna({"disc": 0.0})
           .assign(net=lambda d: d.paid - d.disc)
           .rename(columns={"ch": "channel"}).drop("t"))
    web = v[v["channel"] == "web"]                         # string predicate
    both = hf.concat(a, b)                # category dictionaries unify

String comparisons and ``isin`` against a category column rewrite into
dictionary-code space when the expression attaches to the plan, so strings
never reach the device; ``merge`` on category keys and ``concat`` recode
both sides onto the union dictionary first.

``collect`` runs on the card unless the config says ``device="cpu"``.
Composite keys work as in the reference: ``merge(on=[("a", "ca"), "b"])``,
``groupby(("k1", "k2"))``.

GroupBy sugar, UDFs, free arrays and matrix assembly, as in the reference
(the paper's customer-segmentation program is written in these):

    g = df.groupby("k")
    g.size(); g.mean(); g[["x", "y"]].sum()       # pandas sugar
    g.transform("mean"); g.head(3)                # stats per row, first rows
    df[hf.udf(lambda x, y: x * 2.0 + y > 0.5, df.x, df.y)]   # a torch lambda
    df.assign(cluster=labels)                     # a free 1-D array
    mat, counts, cap = df.collect_matrix(["x", "y"])   # float32, 1D_BLOCK
"""
from __future__ import annotations

import dataclasses as _dc
import functools as _ft
from typing import Any, Mapping, Sequence

import numpy as np
import torch

from . import distribution as D
from . import ir
from . import optimizer as opt
from . import physical_plan as pp
from .dtypes import (CODE_DTYPE, NULL_CODE, DType, as_nullable, categories_of,
                     coerce_column, dict_decode, is_category, is_nullable,
                     physical_dtype, recode_map, union_categories)
from .expr import (AGG_FNS, UDF, AggExpr, BinOp, Cast, ColRef, Const, Expr,
                   IsIn, UnOp, all_, any_, as_expr, count, first, fn_expr,
                   max_, mean, min_, nunique, numpy_dtype, prod, std, sum_,
                   var)
from .lower import ExecConfig, Lowered, execute, lower
from .table import DTable

__all__ = [
    "DataFrame", "GroupBy", "table", "join", "aggregate", "sum_", "mean",
    "count", "min_", "max_", "prod", "any_", "all_", "var", "std", "first",
    "nunique", "ExecConfig", "explain", "DTable", "Over", "cumsum",
    "stencil", "sma", "wma", "lag", "lead", "rolling_sum", "rolling_mean",
    "rank", "dense_rank", "row_number", "concat", "from_persisted_state",
    "from_pandas", "DType", "udf",
]


# ---------------------------------------------------------------------------
# string/null expression rewriting
#
# Strings never reach the device: comparisons and membership tests against a
# category column are rewritten into code space when the expression attaches
# to a plan (filter/assign/agg construction).  Dictionaries are sorted, so
# code order is lexicographic order: equality maps to a code constant,
# ranges to searchsorted thresholds, and isna() to the dtype's in-band null
# test (code < 0, isnan) or a constant False.
# ---------------------------------------------------------------------------

_CMP_SWAP = {"lt": "gt", "le": "ge", "gt": "lt", "ge": "le",
             "eq": "eq", "ne": "ne"}


def _cat_dtype_of(e: Expr, schemas: dict[int, dict]):
    if isinstance(e, ColRef):
        dt = schemas.get(e.table_id, {}).get(e.name)
        if is_category(dt):
            return dt
    return None


def _code_const(code: int) -> Const:
    return Const(np.int32(code))


def _rewrite_cat_cmp(col: ColRef, dt, op: str, v: str) -> Expr:
    """One string comparison against a sorted dictionary, in code space.
    Nulls (code -1) compare False except under ``ne`` (pandas semantics)."""
    cats = categories_of(dt)
    if op in ("eq", "ne"):
        if v in cats:
            return BinOp(op, col, _code_const(cats.index(v)))
        return Const(op == "ne")            # absent value: eq False, ne True
    arr = np.asarray(cats)
    if op in ("lt", "le"):
        t = int(np.searchsorted(arr, v, side="left" if op == "lt" else "right"))
        if t == 0:
            return Const(False)
        return BinOp("and", BinOp("ge", col, _code_const(0)),
                     BinOp("lt", col, _code_const(t)))
    # gt / ge: codes >= threshold; null (-1) can never satisfy it
    t = int(np.searchsorted(arr, v, side="right" if op == "gt" else "left"))
    return BinOp("ge", col, _code_const(max(t, 0)))


def _rewrite_strings(e: Expr, schemas: dict[int, dict]) -> Expr:
    if e.children:
        kids = tuple(_rewrite_strings(c, schemas) for c in e.children)
        if any(k is not o for k, o in zip(kids, e.children)):
            e = e.with_children(kids)
    if isinstance(e, UnOp) and e.op == "isna":
        c = e.children[0]
        if _cat_dtype_of(c, schemas) is not None:
            return BinOp("lt", c, _code_const(0))
        if isinstance(c, ColRef):
            dt = schemas.get(c.table_id, {}).get(c.name)
            if dt is not None and not is_nullable(dt) and \
                    not np.issubdtype(physical_dtype(dt), np.floating):
                return Const(False)         # int/bool columns hold no nulls
        return e
    if isinstance(e, IsIn):
        dt = _cat_dtype_of(e.children[0], schemas)
        if dt is None or not any(isinstance(v, str) for v in e.values):
            return e
        bad = [v for v in e.values if not isinstance(v, str)]
        if bad:
            raise TypeError(
                f"isin on a category column mixes strings and {bad!r}; "
                "pass homogeneous string values")
        lut = {v: i for i, v in enumerate(categories_of(dt))}
        codes = tuple(np.int32(lut[v]) for v in e.values if v in lut)
        return IsIn(e.children[0], codes) if codes else Const(False)
    if isinstance(e, BinOp) and e.op in _CMP_SWAP:
        a, b = e.children
        da, db = _cat_dtype_of(a, schemas), _cat_dtype_of(b, schemas)
        if da is not None and db is not None:
            if categories_of(da) != categories_of(db):
                raise TypeError(
                    "cannot compare category columns with different "
                    "dictionaries; merge/concat unify them, or ingest the "
                    "columns together")
            return e
        if da is None and db is None:
            for x in (a, b):
                if isinstance(x, Const) and isinstance(x.value, str):
                    raise TypeError(
                        f"string constant {x.value!r} compared against a "
                        "non-category column: strings only compare against "
                        "dictionary-encoded (category) columns")
            return e
        col, const, op = (a, b, e.op) if da is not None \
            else (b, a, _CMP_SWAP[e.op])
        dt = da if da is not None else db
        if isinstance(const, Const) and isinstance(
                const.value, (int, np.integer)):
            return e                        # already in code space
        if not isinstance(const, Const) or not isinstance(const.value, str):
            raise TypeError(
                f"category column {col.name!r} compares against string "
                f"constants, got {const!r}")
        return _rewrite_cat_cmp(col, dt, op, const.value)
    return e


# Device-side null/dictionary helpers, lifted into expressions via fn_expr.
# Each is a closure factory, so the host constants (LUT, fill code/value)
# ride along with the plan.


def _recode_fn(lut: np.ndarray, fill: int | None = None):
    """codes -> codes through a host LUT (dictionary unification); null
    codes stay null unless ``fill`` maps them to a new code (fillna)."""
    host = torch.from_numpy(np.ascontiguousarray(lut, dtype=CODE_DTYPE))
    fillc = NULL_CODE if fill is None else int(fill)
    on_device: dict = {}

    def f(c):
        # the LUT moves to c's device once, from pinned memory without
        # blocking, so the host never waits on the card here
        t = on_device.get(c.device)
        if t is None:
            src = host.pin_memory() if c.is_cuda else host
            t = on_device[c.device] = src.to(c.device, non_blocking=True)
        return torch.where(c >= 0, t[c.clamp(min=0)], fillc)
    return f


def _fill_code_fn(code: int):
    fillc = int(code)

    def f(c):
        return torch.where(c < 0, fillc, c)
    return f


def _fill_nan_fn(v: float):
    def f(c):
        return torch.where(torch.isnan(c), v, c)
    return f


class DataFrame:
    """Lazy distributed data frame (wraps a logical plan node).

    ``rep_nodes`` holds the plan nodes the user pinned to REP with
    :meth:`replicate`; the set survives joins and aggregates, so a
    broadcast dimension table stays broadcast inside a larger plan."""

    def __init__(self, node: ir.Node, rep_nodes: frozenset = frozenset()):
        self.node = node
        self._rep_nodes = frozenset(rep_nodes)

    @property
    def _replicated(self) -> bool:
        return self.node.id in self._rep_nodes

    def _wrap(self, node: ir.Node) -> "DataFrame":
        return DataFrame(node, self._rep_nodes)

    def _rw(self, e) -> Expr:
        """Resolve string comparisons and isna against the schemas of every
        node under this frame (applied wherever an expression attaches to
        the plan), so a predicate on a joined frame finds either side's
        dictionary."""
        return _rewrite_strings(
            as_expr(e), {n.id: n.schema for n in ir.topo_order(self.node)})

    # -- schema ---------------------------------------------------------------
    @property
    def schema(self) -> dict[str, np.dtype]:
        return self.node.schema

    @property
    def columns(self) -> list[str]:
        return list(self.node.schema)

    @property
    def dtypes(self) -> dict[str, Any]:
        return dict(self.node.schema)

    # -- expression building ---------------------------------------------------
    def __getitem__(self, key):
        if isinstance(key, str):
            return ColRef(self.node.id, key)
        if isinstance(key, Expr):                       # df[pred] -> filter
            return self._wrap(ir.Filter(self.node, self._rw(key)))
        if isinstance(key, (list, tuple)):              # df[["a","b"]] -> project
            cols = {k: ColRef(self.node.id, k) for k in key}
            return self._wrap(ir.Project(self.node, cols))
        raise TypeError(key)

    def __getattr__(self, name: str):
        """Column access as attributes: ``df.x`` is ``df["x"]``."""
        try:
            node = object.__getattribute__(self, "node")
        except AttributeError:
            raise AttributeError(name) from None
        if not name.startswith("_") and name in node.schema:
            return ColRef(node.id, name)
        raise AttributeError(
            f"DataFrame has no attribute or column {name!r} "
            f"(columns: {list(node.schema)})")

    def __setitem__(self, name: str, value):
        """In-place column assignment, ``df["c"] = expr``.  Rebinds this
        wrapper to a Project over the old node; expressions built before
        stay valid (columns resolve by name at evaluation)."""
        if not isinstance(name, str):
            raise TypeError(f"column name must be a str, got {name!r}")
        cols = {k: ColRef(self.node.id, k) for k in self.node.schema}
        cols[name] = self._rw(value)
        new = ir.Project(self.node, cols)
        if self.node.id in self._rep_nodes:
            self._rep_nodes = self._rep_nodes | {new.id}
        self.node = new

    def with_column(self, name: str, e) -> "DataFrame":
        """Attach a derived column (the non-mutating ``df[name] = e``)."""
        return self.assign(**{name: e})

    def assign(self, **exprs) -> "DataFrame":
        """pandas-style ``df.assign(z=df.x * 2, w=lambda d: d.x + d.y)``: a
        new frame with the columns added or replaced.  Values may be
        expressions, scalars, or callables taking the frame."""
        cols = {k: ColRef(self.node.id, k) for k in self.node.schema}
        for name, e in exprs.items():
            if callable(e) and not isinstance(e, Expr):
                e = e(self)
            cols[name] = self._rw(e)
        return self._wrap(ir.Project(self.node, cols))

    def rename(self, mapping: dict[str, str] | None = None, *,
               columns: dict[str, str] | None = None) -> "DataFrame":
        """Rename columns; the mapping positionally or as ``columns=``."""
        mapping = mapping if mapping is not None else (columns or {})
        cols = {mapping.get(k, k): ColRef(self.node.id, k)
                for k in self.node.schema}
        return self._wrap(ir.Project(self.node, cols))

    def select(self, *names: str) -> "DataFrame":
        return self[list(names)]

    def drop(self, columns, *more: str) -> "DataFrame":
        """Drop columns: ``df.drop("a")``, ``df.drop(["a", "b"])`` or
        ``df.drop(columns=[...])``."""
        dropped = set(ir.as_keys(columns)) | set(more)
        missing = dropped - set(self.node.schema)
        if missing:
            raise KeyError(f"drop: {sorted(missing)} not in columns "
                           f"{list(self.node.schema)}")
        return self[[c for c in self.node.schema if c not in dropped]]

    # -- null / dtype verbs ------------------------------------------------------
    def astype(self, dtype) -> "DataFrame":
        """Cast columns: ``df.astype(np.float64)`` (every column) or
        ``df.astype({"x": np.int32})``.  The schema records the dtype asked
        for; the data narrows 64-bit types to 32 bits as ingest does.
        Category columns cast only to category (decode with
        ``to_numpy()``), and a nullable column casts only to a float type
        unless ``fillna`` came first."""
        sch = self.node.schema
        mapping = dict(dtype) if isinstance(dtype, dict) \
            else {c: dtype for c in sch}
        exprs: dict[str, Expr] = {c: ColRef(self.node.id, c) for c in sch}
        dts = dict(sch)
        for c, t in mapping.items():
            if c not in sch:
                raise KeyError(f"astype: no column {c!r}")
            dt = sch[c]
            if (isinstance(t, str) and t == "category") or is_category(t):
                if is_category(dt):
                    continue
                raise TypeError(
                    f"astype: column {c!r} -> category needs host-side "
                    "dictionary encoding; rebuild the input with hf.table() "
                    "or hf.from_pandas()")
            if is_category(dt):
                raise TypeError(
                    f"astype: column {c!r} is category[str]; decode with "
                    "to_numpy() instead of casting on device")
            target = np.dtype(t)
            if dt == target and not is_nullable(dt):
                continue
            if is_nullable(dt) and not np.issubdtype(target, np.floating):
                raise TypeError(
                    f"astype: column {c!r} is nullable ({dt!r}) and "
                    f"{target} has no null representation; fillna() first")
            exprs[c] = Cast(ColRef(self.node.id, c), target)
            dts[c] = DType(target, nullable=True) if is_nullable(dt) \
                else target
        return self._wrap(ir.Project(self.node, exprs, dts))

    def fillna(self, value, subset=None) -> "DataFrame":
        """Replace nulls: a scalar (for every nullable column, or those of
        ``subset``) or a dict column -> fill value.  A category column
        filled with a string outside its dictionary extends the
        dictionary.  Filled columns come back non-nullable."""
        sch = self.node.schema
        if isinstance(value, dict):
            targets = dict(value)
        else:
            cols = ir.as_keys(subset) if subset is not None else tuple(sch)
            targets = {c: value for c in cols}
        exprs: dict[str, Expr] = {c: ColRef(self.node.id, c) for c in sch}
        dts = dict(sch)
        changed = False
        for c, v in targets.items():
            if c not in sch:
                raise KeyError(f"fillna: no column {c!r}")
            dt = sch[c]
            if not is_nullable(dt):
                continue
            col = ColRef(self.node.id, c)
            if is_category(dt):
                if not isinstance(v, str):
                    raise TypeError(
                        f"fillna: column {c!r} is category[str]; the fill "
                        f"value must be a string, got {v!r}")
                cats = categories_of(dt)
                if v in cats:
                    exprs[c] = fn_expr(_fill_code_fn(cats.index(v)), col)
                    dts[c] = DType(CODE_DTYPE, cats)
                else:
                    newcats = union_categories(cats, (v,))
                    exprs[c] = fn_expr(_recode_fn(recode_map(cats, newcats),
                                                  fill=newcats.index(v)), col)
                    dts[c] = DType(CODE_DTYPE, newcats)
            else:
                exprs[c] = fn_expr(_fill_nan_fn(float(v)), col)
                dts[c] = physical_dtype(dt)
            changed = True
        if not changed:
            return self
        return self._wrap(ir.Project(self.node, exprs, dts))

    def dropna(self, subset=None) -> "DataFrame":
        """Drop rows holding a null in any column (or any of ``subset``):
        a Filter on the in-band null tests, with no exchange."""
        sch = self.node.schema
        cols = ir.as_keys(subset) if subset is not None else tuple(sch)
        missing = set(cols) - set(sch)
        if missing:
            raise KeyError(f"dropna: {sorted(missing)} not in columns "
                           f"{list(sch)}")
        preds = []
        for c in cols:
            dt = sch[c]
            if not is_nullable(dt):
                continue
            col = ColRef(self.node.id, c)
            if is_category(dt):
                preds.append(BinOp("ge", col, _code_const(0)))
            elif np.issubdtype(physical_dtype(dt), np.floating):
                preds.append(UnOp("not", UnOp("isna", col)))
        if not preds:
            return self
        return self._wrap(ir.Filter(
            self.node, _ft.reduce(lambda a, b: BinOp("and", a, b), preds)))

    def isna(self) -> "DataFrame":
        """Per-cell null mask, one bool column per input column."""
        cols = {c: self._rw(UnOp("isna", ColRef(self.node.id, c)))
                for c in self.node.schema}
        return self._wrap(ir.Project(self.node, cols))

    def notna(self) -> "DataFrame":
        cols = {c: UnOp("not", self._rw(UnOp("isna", ColRef(self.node.id, c))))
                for c in self.node.schema}
        return self._wrap(ir.Project(self.node, cols))

    def _recode(self, targets: dict[str, tuple], nullable: dict[str, bool]
                ) -> "DataFrame":
        """Re-encode category columns against new (superset) dictionaries:
        the merge/concat unification step.  Identity for no targets."""
        if not targets:
            return self
        sch = self.node.schema
        exprs: dict[str, Expr] = {c: ColRef(self.node.id, c) for c in sch}
        dts = dict(sch)
        for c, newcats in targets.items():
            dt = sch[c]
            cats = categories_of(dt)
            if cats != newcats:
                exprs[c] = fn_expr(_recode_fn(recode_map(cats, newcats)),
                                   ColRef(self.node.id, c))
            dts[c] = DType(CODE_DTYPE, newcats,
                           nullable=nullable.get(c, is_nullable(dt)))
        new = ir.Project(self.node, exprs, dts)
        rep = self._rep_nodes | ({new.id} if self._replicated else set())
        return DataFrame(new, frozenset(rep))

    # -- relational verbs -------------------------------------------------------
    def merge(self, right: "DataFrame", on, how: str = "inner",
              suffix: str = "_r") -> "DataFrame":
        """Equi-join; ``on`` is a name, a (left_name, right_name) pair, or a
        list of names / pairs for composite keys.  how="left" keeps
        unmatched left rows (float columns NaN-fill, category columns
        null-code-fill, int columns zero-fill beside a ``_matched`` int
        column).  Category keys join by code: both sides recode onto the
        union dictionary first, then the join plans as an int-key join."""
        lo, ro = _parse_on(on)
        if how not in ("inner", "left"):
            raise ValueError(how)
        lsch, rsch = self.node.schema, right.node.schema
        ltgt: dict[str, tuple] = {}
        rtgt: dict[str, tuple] = {}
        for lk, rk in zip(lo, ro):
            ldt, rdt = lsch.get(lk), rsch.get(rk)
            if ldt is None or rdt is None:
                continue                    # ir.Join reports the missing key
            if is_category(ldt) != is_category(rdt):
                raise TypeError(
                    f"merge: key {lk!r}/{rk!r} is category[str] on one side "
                    "and numeric on the other; encode both sides the same "
                    "way at ingest")
            if is_category(ldt) and categories_of(ldt) != categories_of(rdt):
                ltgt[lk] = rtgt[rk] = union_categories(categories_of(ldt),
                                                       categories_of(rdt))
        left, rgt = self._recode(ltgt, {}), right._recode(rtgt, {})
        node = ir.Join(left.node, rgt.node, lo, ro, suffix, how)
        rep = left._rep_nodes | rgt._rep_nodes
        if left._replicated and rgt._replicated:
            rep = rep | {node.id}
        return DataFrame(node, rep)

    def groupby(self, by) -> "GroupBy":
        """Group-by proxy: ``df.groupby("k").agg(total=("x", "sum"))``."""
        return GroupBy(self, by)

    def over(self, partition_by, order_by=None) -> "Over":
        """Partitioned window context (SQL ``OVER (PARTITION BY ... ORDER BY
        ...)``): ``df.over("g", order_by="t").cumsum(df.x)``."""
        return Over(self, partition_by, order_by)

    def head(self, n: int = 5) -> "DataFrame":
        """First ``n`` rows in global (rank-concatenation) order: no data
        moves, each rank clamps its count; partitioning and ordering
        survive, so a later verb on the same keys stays elided."""
        return self._wrap(ir.Limit(self.node, n))

    def limit(self, n: int) -> "DataFrame":
        """SQL-style alias of :meth:`head`."""
        return self.head(n)

    def sort(self, by, ascending: bool = True) -> "DataFrame":
        """Global sort (sample sort); ``by`` is a column name or a
        tuple/list of names (lexicographic, most significant first)."""
        return self._wrap(ir.Sort(self.node, ir.as_keys(by), ascending))

    def sort_values(self, by, ascending: bool = True) -> "DataFrame":
        """pandas-style alias of :meth:`sort`."""
        return self.sort(by, ascending)

    def repartition(self, by) -> "DataFrame":
        """Hash-partition rows across ranks by key columns: same rows, new
        placement.  One hash exchange on ``by``, elided when the input is
        already partitioned that way; persisted, the layout makes later
        ``groupby``/``merge``/``over`` on those keys exchange nothing."""
        keys = ir.as_keys(by)
        missing = set(keys) - set(self.node.schema)
        if missing:
            raise KeyError(f"repartition: {sorted(missing)} not in columns "
                           f"{list(self.node.schema)}")
        return self._wrap(ir.Repartition(self.node, by=keys))

    def sort_within_partitions(self, by, ascending: bool = True) -> "DataFrame":
        """Sort rows by ``by`` within each rank, moving nothing between
        ranks; the order becomes part of the layout :meth:`persist` keeps.
        Ascending only, like the local sort."""
        if not ascending:
            raise ValueError(
                "sort_within_partitions: only ascending=True is supported")
        keys = ir.as_keys(by)
        missing = set(keys) - set(self.node.schema)
        if missing:
            raise KeyError(
                f"sort_within_partitions: {sorted(missing)} not in columns "
                f"{list(self.node.schema)}")
        return self._wrap(ir.Repartition(self.node, sort_by=keys))

    def replicate(self) -> "DataFrame":
        """Pin this frame to REP (broadcast): small dimension tables."""
        return DataFrame(self.node,
                         frozenset(n.id for n in ir.topo_order(self.node)))

    # -- execution ---------------------------------------------------------------
    def _force_rep(self) -> set[int]:
        return set(self._rep_nodes)

    def _execute(self, cfg: ExecConfig, keep: Sequence[str] | None = None,
                 gather: bool = True, collect_block: bool = False,
                 ) -> tuple[Lowered, DTable]:
        """Lower and run under the retry policy (``lower.execute``): shared
        by :meth:`collect`, :meth:`persist` and :meth:`collect_matrix`."""
        return execute(self.node, cfg, set(keep) if keep else None,
                       self._force_rep(), gather=gather,
                       collect_block=collect_block)

    def collect(self, cfg: ExecConfig | None = None,
                keep: Sequence[str] | None = None) -> DTable:
        """Execute the plan and return the materialized DTable."""
        return self._execute(cfg or ExecConfig(), keep)[1]

    def persist(self, cfg: ExecConfig | None = None, *,
                name: str = "persist") -> "DataFrame":
        """Execute once and return a frame over the result that carries the
        layout the plan produced (``ir.ScanLayout``): partitioning keys,
        per-rank order, global sortedness, every rank's count.

        Each rank keeps its own shard on its device; later plans take it
        back by identity (no host copy, no re-pad), and ``groupby``,
        ``merge``, ``over`` and ``sort`` on the persisted keys plan no
        exchange and no sort.  The claims hold at the rank count they were
        made under.  A replicated result re-enters as a host table pinned
        to REP.  A result that still overflows after the retries raises
        :class:`CapacityOverflow` naming the op, instead of keeping
        truncated shards."""
        return self._persist(cfg or ExecConfig(), name)[0]

    def _persist(self, cfg: ExecConfig, name: str
                 ) -> tuple["DataFrame", Lowered]:
        """:meth:`persist`, with the plan that ran (the serving session
        charges its collectives to registration)."""
        lowered, t = self._execute(cfg, gather=False)
        if t.overflow:
            from .errors import CapacityOverflow
            attempts = max(cfg.auto_retry, 0) + 1
            op_id, rec = max(t.overflow_ops.items(),
                             key=lambda kv: kv[1]["cap_req"])
            raise CapacityOverflow(
                op_id=op_id, op=rec["op"], observed_est=rec["cap_req"],
                cap=rec["cap"], attempts=attempts,
                message=(
                    "persist(): capacity overflow survived the auto-retries "
                    f"at op #{op_id} ({rec['op']}): observed requirement "
                    f"~{rec['cap_req']} rows > planned cap {rec['cap']}; "
                    "raise ExecConfig.auto_retry or pre-size via "
                    f"ExecConfig.cap_overrides[{op_id}] = ({rec['cap_req']}, "
                    f"{rec['bucket_req']})"))
        root_op = lowered.pplan.root_op
        layout = ir.ScanLayout(
            kind=root_op.part.kind, partitioned_by=root_op.part.keys,
            ascending=root_op.part.ascending,
            globally_sorted=root_op.part.globally_sorted,
            sorted_by=root_op.order.keys,
            order_ascending=root_op.order.ascending,
            counts=t.counts.cpu().numpy().astype(np.int32),
            capacity=int(t.capacity), nshards=int(t.nshards), dist=t.dist)
        return _persisted(name, t.columns, layout), lowered

    def cache(self, cfg: ExecConfig | None = None, *,
              name: str = "cache") -> "DataFrame":
        """Alias of :meth:`persist` (Spark spelling)."""
        return self.persist(cfg, name=name)

    def lower(self, cfg: ExecConfig | None = None,
              keep: Sequence[str] | None = None,
              collect_block: bool = False) -> Lowered:
        """The bound plan, without running it; ``collect_block``
        rebalances a 1D_VAR result to 1D_BLOCK."""
        return lower(self.node, cfg, set(keep) if keep else None,
                     self._force_rep(), collect_block)[0]

    def collect_matrix(self, cols: Sequence[str],
                       cfg: ExecConfig | None = None):
        """Matrix assembly (the paper's ``transpose(typed_hcat)``): the
        columns ``cols`` as one float32 ``(rows, len(cols))`` matrix on the
        device, rebalanced to 1D_BLOCK as array code wants it.  Returns
        ``(mat, counts, capacity)``: at P = 1 ``mat`` holds ``capacity``
        rows of which the first ``counts[0]`` are valid; at P > 1 each rank
        gets its own ``(capacity, k)`` block, the counterpart of the
        reference's row-sharded global matrix, and every rank's count."""
        t = self._execute(cfg or ExecConfig(), cols, gather=False,
                          collect_block=True)[1]
        mat = torch.stack([t.columns[c].to(torch.float32) for c in cols],
                          dim=1)
        return mat, t.counts, t.capacity

    def to_numpy(self, cfg: ExecConfig | None = None, *,
                 decode: bool = True) -> dict[str, np.ndarray]:
        """Collect to host numpy; category columns decode to strings unless
        ``decode=False``."""
        out = self.collect(cfg).to_numpy()
        if decode:
            for c, dt in self.node.schema.items():
                if is_category(dt) and c in out:
                    out[c] = dict_decode(out[c], categories_of(dt))
        return out

    def _plan(self, cfg: ExecConfig):
        """Shared planning prologue (optimize -> infer -> rebalance ->
        physical plan) for explain()/physical_plan().  It always carries a
        stats context, so explain() can annotate estimated rows and bytes
        per exchange; the context changes DECISIONS (salting, cheap side,
        auto caps) only under ``cfg.adaptive_stats``.  Only then does a
        frame over a scan persisted at P > 1 sample through one
        ``all_gather``, so that every rank calls it, as every rank calls
        ``collect``; without it planning is local to the rank."""
        from . import stats as st
        root = self.node
        if cfg.optimize_plan:
            root, _ = opt.optimize(root)
        info = D.infer(root, force_rep=self._force_rep(),
                       broadcast_join=cfg.broadcast_join)
        root = D.insert_rebalance(root, info)
        sctx = st.analyze(root, cfg)
        return root, info, pp.plan_physical(root, info.dists, cfg, stats=sctx)

    def physical_plan(self, cfg: ExecConfig | None = None):
        """The property-driven physical plan this frame would execute."""
        return self._plan(cfg or ExecConfig())[2]

    def explain(self, cfg: ExecConfig | None = None) -> str:
        """Logical plan with distribution annotations, the logical schema,
        then the physical plan with its shuffle/sort census header.
        Exchanges carry estimated rows/bytes from the sampled statistics
        pass; a ``stats:`` line compares the root's estimate with the
        REALIZED counts of a previous adaptive run of this plan, and the
        retry events of the last run of this plan follow."""
        from . import stats as st
        from ..runtime import retry as rt
        root, info, pplan = self._plan(cfg or ExecConfig())
        sch = ", ".join(f"{k}:{dt}" for k, dt in self.node.schema.items())
        txt = (ir.plan_str(root, info.dists) + "\nschema: " + sch
               + "\n\n" + pplan.render())
        est = pplan.root_op.rows_est
        tail = []
        if est is not None:
            tail.append(f"estimated output rows ~{int(est)}")
        rl = st.realized_for(root)
        if rl is not None:
            tail.append(
                f"realized (previous run): {rl['rows']} rows over "
                f"{rl['nshards']} shards, per-shard max/mean "
                f"{rl['max']}/{rl['mean']:.1f}")
        if tail:
            txt += "\nstats: " + "; ".join(tail)
        evs = rt.events_for(root)
        if evs:
            txt += "\nevents (previous run):\n" + "\n".join(
                "  " + e.render() for e in evs)
        return txt

    def __repr__(self):
        return f"DataFrame({list(self.node.schema)})\n{ir.plan_str(self.node)}"


# pandas-spelled aliases for the named-agg table
_AGG_ALIASES = {"product": "prod", "size": "count", "average": "mean"}


class GroupBy:
    """Deferred group-by: ``df.groupby(keys)`` then :meth:`agg` or a
    whole-frame sugar method.  Specs are pandas named-agg tuples
    ``("x", "sum")`` (the column may be an expression, ``(df.x > 0,
    "sum")``), AggExpr objects ``hf.sum_(df.x)``, or ``"count"``.

    Sugar, as pandas spells it: ``g["x"]`` / ``g[["x", "y"]]`` select the
    value columns; ``size()``; ``sum``, ``mean``, ``min``, ``max``,
    ``prod``, ``any``, ``all`` (each with ``skipna``), ``count`` and
    ``nunique`` over every selected non-key column (the numeric-only fns
    skip category columns); ``transform`` broadcasts group statistics back
    onto the rows (an aggregate merged back on the keys); ``head(n)`` keeps
    the first ``n`` rows of each group in arrival order.  Output rows come
    back hash-partitioned on the keys and sorted by them within each rank:
    the layout a following :meth:`DataFrame.persist` keeps."""

    def __init__(self, df: DataFrame, by,
                 select: tuple[str, ...] | None = None):
        self.df = df
        self.keys = ir.as_keys(by)
        self._select = select
        missing = set(self.keys) - set(df.node.schema)
        if missing:
            raise KeyError(f"groupby: {sorted(missing)} not in columns "
                           f"{list(df.node.schema)}")

    def __getitem__(self, cols) -> "GroupBy":
        """Column selection, ``df.groupby("k")["x"].sum()``: a name or a
        list of names; the sugar methods then aggregate only those."""
        sel = (cols,) if isinstance(cols, str) else tuple(cols)
        if not sel:
            raise ValueError("groupby[...]: empty column selection")
        bad = [c for c in sel if not isinstance(c, str)]
        if bad:
            raise TypeError(f"groupby[...]: column names must be str, "
                            f"got {bad!r}")
        missing = set(sel) - set(self.df.node.schema)
        if missing:
            raise KeyError(f"groupby[...]: {sorted(missing)} not in columns "
                           f"{list(self.df.node.schema)}")
        return GroupBy(self.df, self.keys, select=sel)

    # fns with no meaning on dictionary codes (a code sum is garbage);
    # min/max/first/count/nunique stay valid: code order is lexicographic
    _NUMERIC_ONLY = ("sum", "mean", "var", "std", "prod", "any", "all")

    def _check_cat(self, name: str, fn: str, e) -> None:
        if fn not in self._NUMERIC_ONLY or not isinstance(e, ColRef):
            return
        if is_category(self.df.node.schema.get(e.name)):
            raise TypeError(
                f"agg {name}: {fn!r} over category[str] column {e.name!r} "
                "has no meaning (dictionary codes aren't numbers); use "
                "min/max/first/count/nunique, or fillna+astype first")

    def _spec(self, name: str, a) -> AggExpr:
        if isinstance(a, AggExpr):
            self._check_cat(name, a.fn, a.expr)
            e = self.df._rw(a.expr) if a.expr is not None else None
            return AggExpr(a.fn, e, a.skipna)
        if isinstance(a, str):
            if _AGG_ALIASES.get(a, a) == "count":
                return AggExpr("count", None)
            raise TypeError(f"agg {name}={a!r}: bare strings only spell "
                            "'count'/'size'; use a (column, fn) tuple")
        if isinstance(a, tuple) and len(a) == 2:
            col, fn = a
            fn = _AGG_ALIASES.get(fn, fn)
            if not isinstance(fn, str) or fn not in AGG_FNS:
                raise TypeError(f"agg {name}: unknown fn {fn!r}; "
                                f"valid: {AGG_FNS}")
            if isinstance(col, str) and col not in self.df.node.schema:
                raise KeyError(f"agg {name}: no column {col!r}")
            if fn == "count":
                if isinstance(col, str) and \
                        is_nullable(self.df.node.schema.get(col)):
                    return AggExpr("count", ColRef(self.df.node.id, col))
                return AggExpr("count", None)
            e = col if isinstance(col, Expr) else ColRef(self.df.node.id, col)
            self._check_cat(name, fn, e)
            return AggExpr(fn, self.df._rw(e))
        raise TypeError(f"agg {name}: expected (column, fn), an AggExpr or "
                        f"'count', got {a!r}")

    def agg(self, **aggs) -> DataFrame:
        if not aggs:
            raise ValueError("agg() needs at least one name=(column, fn) spec")
        specs = {name: self._spec(name, a) for name, a in aggs.items()}
        # pandas groupby(dropna=True): null keys form no group
        base = self.df.dropna(subset=self.keys)
        node = ir.Aggregate(base.node, self.keys, specs)
        rep = base._rep_nodes | ({node.id} if base._replicated else set())
        return DataFrame(node, frozenset(rep))

    aggregate = agg

    def size(self, name: str = "size") -> DataFrame:
        """Row count per group (pandas ``.size()``)."""
        return self.agg(**{name: AggExpr("count", None)})

    def _value_columns(self) -> list[str]:
        cols = self._select if self._select is not None \
            else self.df.node.schema
        return [c for c in cols if c not in self.keys]

    def _apply_all(self, fn: str, skipna: bool = True) -> DataFrame:
        cols = self._value_columns()
        if fn in self._NUMERIC_ONLY:
            # pandas numeric_only: the sugar skips category columns (an
            # explicit agg spec on one raises instead)
            sch = self.df.node.schema
            cols = [c for c in cols if not is_category(sch[c])]
        if not cols:
            return self.size(name="count")
        return self.agg(**{c: AggExpr(fn, ColRef(self.df.node.id, c),
                                      skipna=skipna) for c in cols})

    def transform(self, fn: str | None = None, **aggs) -> DataFrame:
        """Per-group statistics broadcast back onto the rows (pandas
        ``groupby().transform``): the aggregate merged back on the keys, so
        every row and column survives with its group's statistic beside it.
        ``transform("mean")`` names each selected non-key column's output
        ``<col>_mean``; ``transform(z=("x", "sum"))`` names outputs as
        :meth:`agg` does.  Row order is the merge's, not the input's."""
        if fn is not None:
            if aggs:
                raise TypeError("transform: pass a single fn OR "
                                "name=(column, fn) specs, not both")
            f = _AGG_ALIASES.get(fn, fn)
            if f not in AGG_FNS:
                raise TypeError(f"transform: unknown fn {fn!r}; valid: "
                                f"{AGG_FNS} (+ aliases {tuple(_AGG_ALIASES)})")
            cols = self._value_columns()
            if not cols:
                raise ValueError("transform: no value columns to aggregate")
            aggs = {f"{c}_{f}": (c, f) for c in cols}
        if not aggs:
            raise ValueError(
                "transform() needs a fn or at least one name=(column, fn)")
        clash = sorted(set(aggs) & set(self.df.node.schema))
        if clash:
            raise ValueError(f"transform: output names {clash} collide "
                             f"with existing columns")
        return self.df.merge(self.agg(**aggs), on=list(self.keys))

    def head(self, n: int = 5) -> DataFrame:
        """First ``n`` rows of each group in arrival order (pandas
        ``groupby().head``): ``row_number() <= n`` over the grouped layout,
        so one hash exchange and one local sort in all (no exchange on a
        frame persisted on the keys), and the filter is collective-free."""
        if n < 0:
            raise ValueError(f"head: n must be >= 0, got {n}")
        w = row_number(self.df, list(self.keys), None, out="__rn__")
        return w[w["__rn__"] <= n].drop("__rn__")

    def sum(self, skipna: bool = True) -> DataFrame:
        return self._apply_all("sum", skipna)

    def mean(self, skipna: bool = True) -> DataFrame:
        return self._apply_all("mean", skipna)

    def min(self, skipna: bool = True) -> DataFrame:
        return self._apply_all("min", skipna)

    def max(self, skipna: bool = True) -> DataFrame:
        return self._apply_all("max", skipna)

    def prod(self, skipna: bool = True) -> DataFrame:
        return self._apply_all("prod", skipna)

    def any(self, skipna: bool = True) -> DataFrame:
        return self._apply_all("any", skipna)

    def all(self, skipna: bool = True) -> DataFrame:
        return self._apply_all("all", skipna)

    def count(self) -> DataFrame:
        return self._apply_all("count")

    def nunique(self) -> DataFrame:
        return self._apply_all("nunique")


# ---------------------------------------------------------------------------
# constructors and free-function spellings
# ---------------------------------------------------------------------------


def table(columns, name: str = "t") -> DataFrame:
    """Create a data frame from host arrays (DataSource analogue).

    ``columns`` maps names to numpy arrays, lists or CPU tensors, or is a
    :class:`DTable` (its valid rows).  Ingest coercion as in the reference:
    strings dictionary-encode, NaN-holed floats become nullable, and 64-bit
    ints and floats narrow to 32 bits as the reference's arrays do."""
    if isinstance(columns, DTable):
        columns = columns.to_numpy()
    lens = {k: len(v) for k, v in columns.items()}
    if len(set(lens.values())) > 1:
        raise ValueError(f"column length mismatch: {lens}")
    cols: dict[str, Any] = {}
    sch: dict[str, Any] = {}
    for k, v in columns.items():
        if isinstance(v, torch.Tensor):
            v = v.cpu().numpy()
        cols[k], sch[k] = coerce_column(k, v)
    return DataFrame(ir.Scan(name, cols, sch))


def from_pandas(df, name: str = "t") -> DataFrame:
    """A frame from a pandas DataFrame (duck-typed; pandas is not
    imported): the columns go through :func:`table`'s ingest coercion, so
    object/string columns dictionary-encode and ``NaN``/``None``/``pd.NA``
    holes become nulls."""
    if not hasattr(df, "columns") or not hasattr(df, "__getitem__"):
        raise TypeError(
            f"from_pandas expects a pandas DataFrame, got {type(df).__name__}")
    cols = {}
    for c in df.columns:
        s = df[c]
        cols[str(c)] = s.to_numpy() if hasattr(s, "to_numpy") else np.asarray(s)
    return table(cols, name)


def _persisted(name: str, columns: dict, layout: ir.ScanLayout) -> DataFrame:
    """A frame over materialized columns and their layout.  A REP result
    re-enters as a host table pinned to REP, keeping its order."""
    sch = {k: numpy_dtype(v.dtype) if isinstance(v, torch.Tensor)
           else np.asarray(v).dtype for k, v in columns.items()}
    if layout.dist == D.REP:
        counts = np.asarray(layout.counts)
        rows = {k: (v.cpu().numpy() if isinstance(v, torch.Tensor)
                    else np.asarray(v))[:int(counts[0])]
                for k, v in columns.items()}
        scan = ir.Scan(name, rows, sch,
                       layout=_dc.replace(layout, kind="rep", counts=None))
        return DataFrame(scan, frozenset({scan.id}))
    return DataFrame(ir.Scan(name, dict(columns), sch, layout=layout))


def from_persisted_state(columns: dict[str, Any], layout: Mapping[str, Any],
                         *, name: str = "persist",
                         device: Any = "cuda") -> DataFrame:
    """Carry a persisted frame over from numpy state: the reference
    package's persisted Scan columns, ``(nshards * capacity,)`` arrays, and
    its ``ScanLayout``'s fields as a mapping (``dataclasses.asdict``).  The
    columns move to ``device`` (64-bit ones narrow to 32 bits, as at
    ingest) and the frame plans and re-enters as one this package
    persisted; each rank takes its own shard's rows.  A layout without
    counts (a replicated result) gives a host table pinned to REP."""
    f = {k: layout[k] for k in (
        "kind", "partitioned_by", "ascending", "globally_sorted",
        "sorted_by", "order_ascending", "counts", "capacity", "nshards",
        "dist")}
    f["partitioned_by"] = tuple(f["partitioned_by"])
    f["sorted_by"] = tuple(f["sorted_by"])
    if f["counts"] is None:
        scan = ir.Scan(name, {k: np.asarray(v) for k, v in columns.items()},
                       layout=ir.ScanLayout(**f))
        return DataFrame(scan, frozenset({scan.id}))
    f["counts"] = np.asarray(f["counts"], dtype=np.int32)
    t = DTable.from_numpy_state(columns, f["counts"], f["capacity"],
                                f["nshards"], f["dist"], device=device)
    return _persisted(name, t.columns, ir.ScanLayout(**f))


def concat(*dfs: DataFrame) -> DataFrame:
    """UNION ALL.  Column names must match; category columns recode onto
    the union dictionary, and a column nullable in any part comes out
    nullable (ir.Concat reports part 0's schema, so the unified dtypes ride
    a Project when the parts disagree)."""
    schemas = [tuple(d.node.schema) for d in dfs]
    if len(set(schemas)) > 1:
        raise ValueError(f"schema mismatch in concat: {schemas}")
    targets: list[dict[str, tuple]] = [{} for _ in dfs]
    nullflags: list[dict[str, bool]] = [{} for _ in dfs]
    over: dict[str, Any] = {}
    for c in schemas[0]:
        dts = [d.node.schema[c] for d in dfs]
        flags = [is_category(dt) for dt in dts]
        if any(flags):
            if not all(flags):
                raise TypeError(
                    f"concat: column {c!r} is category[str] in some parts "
                    "and numeric in others; encode every part the same way")
            u = _ft.reduce(union_categories, (categories_of(dt) for dt in dts))
            nb = any(is_nullable(dt) for dt in dts)
            for i, dt in enumerate(dts):
                if categories_of(dt) != u or is_nullable(dt) != nb:
                    targets[i][c] = u
                    nullflags[i][c] = nb
            over[c] = DType(CODE_DTYPE, u, nullable=nb)
        elif any(is_nullable(dt) for dt in dts) and not is_nullable(dts[0]):
            over[c] = as_nullable(dts[0])
    dfs = [d._recode(t, nf) for d, t, nf in zip(dfs, targets, nullflags)]
    node = ir.Concat(tuple(d.node for d in dfs))
    rep = frozenset().union(*(d._rep_nodes for d in dfs))
    if all(d._replicated for d in dfs):
        rep = rep | {node.id}
    if over:
        sch = node.schema
        proj = ir.Project(node, {c: ColRef(node.id, c) for c in sch},
                          {c: over.get(c, sch[c]) for c in sch})
        if node.id in rep:
            rep = rep | {proj.id}
        node = proj
    return DataFrame(node, frozenset(rep))


def _parse_on(on) -> tuple[tuple[str, ...], tuple[str, ...]]:
    """Normalize the join key spec to (left_keys, right_keys) tuples:
    "k"; ("lk", "rk") — a PAIR; ["k1", ("a", "ca"), ...] — composite."""
    if isinstance(on, str):
        return (on,), (on,)
    if isinstance(on, tuple) and len(on) == 2 \
            and all(isinstance(x, str) for x in on):
        return (on[0],), (on[1],)
    lo, ro = [], []
    for item in on:
        if isinstance(item, str):
            lo.append(item)
            ro.append(item)
        else:
            l, r = item
            lo.append(l)
            ro.append(r)
    if not lo:
        raise ValueError("join requires at least one key column")
    return tuple(lo), tuple(ro)


def join(left: DataFrame, right: DataFrame, on, suffix: str = "_r",
         how: str = "inner") -> DataFrame:
    """Spelling of :meth:`DataFrame.merge`."""
    return left.merge(right, on, how=how, suffix=suffix)


def aggregate(df: DataFrame, by, **aggs) -> DataFrame:
    """Spelling of ``df.groupby(by).agg(...)``."""
    return df.groupby(by).agg(**aggs)


# ---------------------------------------------------------------------------
# window functions
# ---------------------------------------------------------------------------


def _over_keys(x) -> tuple[str, ...]:
    """Normalize an optional partition/order key spec to a tuple (an absent
    spec — None or an empty sequence — becomes ())."""
    return () if not x else ir.as_keys(x)


def cumsum(df: DataFrame, e, out: str = "cumsum", *,
           partition_by=None, order_by=None) -> DataFrame:
    """Distributed cumulative sum (MPI_Exscan analogue).

    With ``partition_by``, the sum restarts at every group boundary
    (``SUM(...) OVER (PARTITION BY ... ORDER BY ...)``) and rows come back in
    the grouped layout, not input order."""
    return DataFrame(ir.Window(df.node, "cumsum", df._rw(e), out,
                               partition_by=_over_keys(partition_by),
                               order_by=_over_keys(order_by)),
                     df._rep_nodes)


def stencil(df: DataFrame, e, weights: Sequence[float], *, scale: float = 1.0,
            center: int | None = None, out: str = "stencil",
            partition_by=None, order_by=None, exact: bool = False) -> DataFrame:
    """1-D stencil: out[i] = sum_j w[j]/scale * x[i+j-center].

    SMA == stencil(x, [1,1,1], scale=3); WMA == stencil(x, [1,2,1], scale=4).
    With ``partition_by``, taps never cross a group boundary (the zero-border
    convention applies per group).  ``exact=True`` renormalizes border
    windows by the weight mass of the taps that actually contributed (see
    :func:`rolling_mean`)."""
    w = tuple(float(x) / scale for x in weights)
    c = len(w) // 2 if center is None else center
    return DataFrame(ir.Window(df.node, "stencil", df._rw(e), out,
                               weights=w, center=c, exact=exact,
                               partition_by=_over_keys(partition_by),
                               order_by=_over_keys(order_by)),
                     df._rep_nodes)


def sma(df: DataFrame, e, window: int = 3, out: str = "sma", *,
        partition_by=None, order_by=None) -> DataFrame:
    """Centred simple moving average over ``window`` rows."""
    return stencil(df, e, [1.0] * window, scale=float(window), out=out,
                   partition_by=partition_by, order_by=order_by)


def wma(df: DataFrame, e, weights: Sequence[float], out: str = "wma", *,
        partition_by=None, order_by=None) -> DataFrame:
    """Centred weighted moving average (weights normalized to sum 1)."""
    return stencil(df, e, weights, scale=float(sum(weights)), out=out,
                   partition_by=partition_by, order_by=order_by)


def lag(df: DataFrame, e, n: int = 1, out: str = "lag", *,
        partition_by=None, order_by=None) -> DataFrame:
    """SQL lag(): out[i] = x[i-n], a one-hot stencil.  Borders -> 0; with
    ``partition_by`` the border is the group edge."""
    return stencil(df, e, [1.0] + [0.0] * n, center=n, out=out,
                   partition_by=partition_by, order_by=order_by)


def lead(df: DataFrame, e, n: int = 1, out: str = "lead", *,
         partition_by=None, order_by=None) -> DataFrame:
    """SQL lead(): out[i] = x[i+n]; borders -> 0 (group edges when
    partitioned)."""
    return stencil(df, e, [0.0] * n + [1.0], center=0, out=out,
                   partition_by=partition_by, order_by=order_by)


def rolling_sum(df: DataFrame, e, window: int, out: str = "rolling_sum", *,
                partition_by=None, order_by=None) -> DataFrame:
    """Trailing rolling sum over rows [i-window+1 .. i] (a one-sided
    stencil, so leading borders contribute zeros)."""
    return stencil(df, e, [1.0] * window, center=window - 1, out=out,
                   partition_by=partition_by, order_by=order_by)


def rolling_mean(df: DataFrame, e, window: int, out: str = "rolling_mean", *,
                 partition_by=None, order_by=None,
                 exact: bool = False) -> DataFrame:
    """Trailing rolling mean over rows [i-window+1 .. i].

    Default (``exact=False``): the first window-1 rows of the series (or of
    each group) divide a zero-padded partial sum by the FULL window.
    ``exact=True`` divides by the number of rows that actually contributed
    (pandas ``rolling(window, min_periods=1).mean()``), fused into the same
    kernel pass; the global form exchanges a second halo for the mass."""
    return stencil(df, e, [1.0] * window, scale=float(window),
                   center=window - 1, out=out, exact=exact,
                   partition_by=partition_by, order_by=order_by)


def _rank_df(df: DataFrame, kind: str, partition_by, order_by,
             out: str, ascending: bool = True) -> DataFrame:
    pk, ok = _over_keys(partition_by), _over_keys(order_by)
    node = df.node
    if not pk and ok:
        # a global window: equal order-key tuples must be adjacent across
        # the rank-concatenated stream, so sort first (the planner makes it
        # a no-op on an input already sorted that way)
        node = ir.Sort(node, ok, ascending)
    return DataFrame(ir.Window(node, kind, None, out,
                               partition_by=pk, order_by=ok),
                     df._rep_nodes)


def rank(df: DataFrame, partition_by, order_by, out: str = "rank", *,
         ascending: bool = True) -> DataFrame:
    """SQL RANK() OVER ([PARTITION BY ...] ORDER BY ...): 1-based; equal
    order-key tuples share a rank, with gaps after ties.
    ``partition_by=None`` ranks globally over ``order_by`` (``ascending``
    picks the direction): a global sort first, then an exclusive scan of
    the per-rank counts with ties across ranks reconciled."""
    return _rank_df(df, "rank", partition_by, order_by, out, ascending)


def dense_rank(df: DataFrame, partition_by, order_by,
               out: str = "dense_rank", *,
               ascending: bool = True) -> DataFrame:
    """SQL DENSE_RANK(): ties share a rank, no gaps.  ``partition_by=None``
    ranks globally (see :func:`rank`)."""
    return _rank_df(df, "dense_rank", partition_by, order_by, out, ascending)


def row_number(df: DataFrame, partition_by, order_by=None,
               out: str = "row_number", *,
               ascending: bool = True) -> DataFrame:
    """SQL ROW_NUMBER(): 1-based position within the group (ties broken by
    the stable sort).  ``partition_by=None`` numbers rows GLOBALLY: with
    ``order_by`` the stream is sorted first, without it rows number in
    rank-concatenation arrival order; either way from an exclusive scan of
    the per-rank counts."""
    return _rank_df(df, "row_number", partition_by, order_by, out, ascending)


class Over:
    """Fluent handle for partitioned windows: ``df.over(partition_by=...,
    order_by=...)`` then any window verb — the SQL ``OVER`` clause as an
    object.  Each method returns a new DataFrame with the window column
    appended, in the grouped (hash-partitioned, locally sorted) layout."""

    def __init__(self, df: DataFrame, partition_by, order_by=None):
        self.df = df
        self.partition_by = ir.as_keys(partition_by)
        self.order_by = _over_keys(order_by)

    def _kw(self):
        return dict(partition_by=self.partition_by,
                    order_by=self.order_by or None)

    def cumsum(self, e, out: str = "cumsum") -> DataFrame:
        return cumsum(self.df, e, out, **self._kw())

    def stencil(self, e, weights, *, scale: float = 1.0,
                center: int | None = None, out: str = "stencil",
                exact: bool = False) -> DataFrame:
        return stencil(self.df, e, weights, scale=scale, center=center,
                       out=out, exact=exact, **self._kw())

    def sma(self, e, window: int = 3, out: str = "sma") -> DataFrame:
        return sma(self.df, e, window, out, **self._kw())

    def wma(self, e, weights, out: str = "wma") -> DataFrame:
        return wma(self.df, e, weights, out, **self._kw())

    def lag(self, e, n: int = 1, out: str = "lag") -> DataFrame:
        return lag(self.df, e, n, out, **self._kw())

    def lead(self, e, n: int = 1, out: str = "lead") -> DataFrame:
        return lead(self.df, e, n, out, **self._kw())

    def rolling_sum(self, e, window: int, out: str = "rolling_sum") -> DataFrame:
        return rolling_sum(self.df, e, window, out, **self._kw())

    def rolling_mean(self, e, window: int, out: str = "rolling_mean", *,
                     exact: bool = False) -> DataFrame:
        return rolling_mean(self.df, e, window, out, exact=exact, **self._kw())

    def rank(self, out: str = "rank") -> DataFrame:
        return rank(self.df, self.partition_by, self.order_by, out)

    def dense_rank(self, out: str = "dense_rank") -> DataFrame:
        return dense_rank(self.df, self.partition_by, self.order_by, out)

    def row_number(self, out: str = "row_number") -> DataFrame:
        return row_number(self.df, self.partition_by, self.order_by, out)


def udf(fn, *args) -> UDF:
    """Lift an elementwise torch callable into an expression: ``fn`` takes
    the arguments' tensors (columns, expressions, constants or external
    arrays) and returns one of their rows; it runs inside the plan exactly
    where a built-in expression would."""
    return fn_expr(fn, *args)


def explain(df: DataFrame, cfg: ExecConfig | None = None) -> str:
    return df.explain(cfg)
