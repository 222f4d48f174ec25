"""HiFrames user API on PyTorch — the relational main path.

The same fluent, pandas-flavored surface as the reference package, for the
verbs of this slice:

    from repro_torch import hiframes as hf
    df = hf.table({"id": ids, "x": xs, "y": ys})        # host arrays
    out = (df[df.x < 0.5]                                # filter
             .merge(dim, on=("id", "cid"))               # equi-join
             .groupby("id")                              # group-by
             .agg(total=("x", "sum"), ym=hf.mean(df.y))
             .collect(hf.ExecConfig(device="cpu")))      # plan + run

``collect`` runs on the card unless the config says ``device="cpu"``.
Composite keys work as in the reference: ``merge(on=[("a", "ca"), "b"])``,
``groupby(("k1", "k2"))``.  Windows, sorts, persist, replicate, head,
assign, the dtype verbs and string predicates are later slices.
"""
from __future__ import annotations

import functools as _ft
from typing import Any, Sequence

import numpy as np
import torch

from . import distribution as D
from . import ir
from . import optimizer as opt
from . import physical_plan as pp
from .dtypes import coerce_column, categories_of, dict_decode, is_category, \
    is_nullable, physical_dtype
from .expr import (AGG_FNS, AggExpr, BinOp, ColRef, Const, Expr, UnOp, all_,
                   any_, as_expr, count, first, max_, mean, min_, nunique,
                   prod, std, sum_, var)
from .lower import ExecConfig, Lowered, execute, lower
from .table import DTable

__all__ = [
    "DataFrame", "GroupBy", "table", "join", "aggregate", "sum_", "mean",
    "count", "min_", "max_", "prod", "any_", "all_", "var", "std", "first",
    "nunique", "ExecConfig", "explain", "DTable",
]


def _check_no_strings(e: Expr) -> Expr:
    stack = [e]
    while stack:
        x = stack.pop()
        if isinstance(x, Const) and isinstance(x.value, str):
            raise NotImplementedError(
                f"string predicate on {x.value!r}: comparisons against "
                "category columns are not supported by this package yet")
        stack.extend(x.children)
    return e


class DataFrame:
    """Lazy distributed data frame (wraps a logical plan node)."""

    def __init__(self, node: ir.Node):
        self.node = node

    def _rw(self, e) -> Expr:
        return _check_no_strings(as_expr(e))

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
            return DataFrame(ir.Filter(self.node, self._rw(key)))
        if isinstance(key, (list, tuple)):              # df[["a","b"]] -> project
            cols = {k: ColRef(self.node.id, k) for k in key}
            return DataFrame(ir.Project(self.node, cols))
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

    # -- relational verbs -------------------------------------------------------
    def merge(self, right: "DataFrame", on, how: str = "inner",
              suffix: str = "_r") -> "DataFrame":
        """Equi-join; ``on`` is a name, a (left_name, right_name) pair, or a
        list of names / pairs for composite keys.  how="left" keeps
        unmatched left rows (float columns NaN-fill, int columns zero-fill
        beside a ``_matched`` int column)."""
        lo, ro = _parse_on(on)
        if how not in ("inner", "left"):
            raise ValueError(how)
        for lk, rk in zip(lo, ro):
            if is_category(self.node.schema.get(lk)) or \
                    is_category(right.node.schema.get(rk)):
                raise NotImplementedError(
                    f"merge on category key {lk!r}/{rk!r}: string keys are "
                    "not supported by this package yet")
        return DataFrame(ir.Join(self.node, right.node, lo, ro, suffix, how))

    def groupby(self, by) -> "GroupBy":
        """Group-by proxy: ``df.groupby("k").agg(total=("x", "sum"))``."""
        return GroupBy(self, by)

    # -- execution ---------------------------------------------------------------
    def collect(self, cfg: ExecConfig | None = None,
                keep: Sequence[str] | None = None) -> DTable:
        """Execute the plan and return the materialized DTable."""
        return execute(self.node, cfg or ExecConfig(),
                       set(keep) if keep else None)[1]

    def lower(self, cfg: ExecConfig | None = None,
              keep: Sequence[str] | None = None) -> Lowered:
        return lower(self.node, cfg, set(keep) if keep else None)[0]

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
        physical plan) for explain()/physical_plan()."""
        root = self.node
        if cfg.optimize_plan:
            root, _ = opt.optimize(root)
        info = D.infer(root, broadcast_join=cfg.broadcast_join)
        root = D.insert_rebalance(root, info)
        return root, info, pp.plan_physical(root, info.dists, cfg)

    def physical_plan(self, cfg: ExecConfig | None = None):
        """The property-driven physical plan this frame would execute."""
        return self._plan(cfg or ExecConfig())[2]

    def explain(self, cfg: ExecConfig | None = None) -> str:
        """Logical plan with distribution annotations, the logical schema,
        then the physical plan with its shuffle/sort census header."""
        root, info, pplan = self._plan(cfg or ExecConfig())
        sch = ", ".join(f"{k}:{dt}" for k, dt in self.node.schema.items())
        return (ir.plan_str(root, info.dists) + "\nschema: " + sch
                + "\n\n" + pplan.render())

    def __repr__(self):
        return f"DataFrame({list(self.node.schema)})\n{ir.plan_str(self.node)}"


# pandas-spelled aliases for the named-agg table
_AGG_ALIASES = {"product": "prod", "size": "count", "average": "mean"}


class GroupBy:
    """Deferred group-by: ``df.groupby(keys)`` then :meth:`agg`.  Specs are
    pandas named-agg tuples ``("x", "sum")`` (the column may be an
    expression), AggExpr objects ``hf.sum_(df.x)``, or ``"count"``."""

    def __init__(self, df: DataFrame, by):
        self.df = df
        self.keys = ir.as_keys(by)
        missing = set(self.keys) - set(df.node.schema)
        if missing:
            raise KeyError(f"groupby: {sorted(missing)} not in columns "
                           f"{list(df.node.schema)}")

    def _spec(self, name: str, a) -> AggExpr:
        if isinstance(a, AggExpr):
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
            return AggExpr(fn, self.df._rw(e))
        raise TypeError(f"agg {name}: expected (column, fn), an AggExpr or "
                        f"'count', got {a!r}")

    def agg(self, **aggs) -> DataFrame:
        if not aggs:
            raise ValueError("agg() needs at least one name=(column, fn) spec")
        specs = {name: self._spec(name, a) for name, a in aggs.items()}
        # pandas groupby(dropna=True): null keys form no group
        node = self.df.node
        preds = [_not_null(ColRef(node.id, k), node.schema[k])
                 for k in self.keys if is_nullable(node.schema[k])]
        if preds:
            node = ir.Filter(node, _ft.reduce(
                lambda a, b: BinOp("and", a, b), preds))
        return DataFrame(ir.Aggregate(node, self.keys, specs))


def _not_null(col: ColRef, dt) -> Expr:
    if is_category(dt):
        return BinOp("ge", col, Const(np.int32(0)))
    if np.issubdtype(physical_dtype(dt), np.floating):
        return UnOp("not", UnOp("isna", col))
    return Const(True)


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


def explain(df: DataFrame, cfg: ExecConfig | None = None) -> str:
    return df.explain(cfg)
