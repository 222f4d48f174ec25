"""Relational optimizer — the DataFrame-Pass analogue (paper §4.3).

The paper builds a query tree over *only* the relational nodes of a general
program AST and applies rule-based rewrites after validating them against the
surrounding array code via liveness.  Here the plan IS the relational DAG
(array code hangs off it through Project/Window expressions and
ExternalArray leaves), so validity reduces to: a rewrite must not change the
multiset of rows feeding any *other* consumer of a shared subplan.  We check
consumer counts (DAG fan-out) before rewriting — the liveness analogue.

Rules implemented (fixed-point, bottom-up):
  * filter fusion             Filter(Filter(x,p),q)      -> Filter(x, p&q)
  * push predicate through project (rename-aware)
  * push predicate through join (the paper's flagship, Fig. 6)
  * push predicate through concat
  * column pruning            narrow Scans/Projects to live columns
  * redundant-sort removal    Sort(Sort(x,K1),K2) -> Sort(x,K2) when K1 is a
                              prefix of K2 (stability makes them identical);
                              Aggregate(Sort(x)) -> Aggregate(x) unless an
                              order-sensitive agg ("first") consumes the order

The logical sort rules complement the PHYSICAL exchange/sort elision in
core/physical_plan.py: the optimizer removes sorts whose *result* is
unobservable, the physical planner skips sorts/exchanges whose *effect* is
already provided by upstream data placement.
"""
from __future__ import annotations

from . import ir
from .expr import BinOp, ColRef, Expr, externals


def _holds_external(n: ir.Node) -> bool:
    """Whether ``n``'s expressions read an ExternalArray: such a node is
    aligned with the rows its child gives it, so no rewrite moves it or
    slides a filter beneath it."""
    return any(externals(e) for e in ir.node_exprs(n))


def _consumers(root: ir.Node) -> dict[int, int]:
    counts: dict[int, int] = {}
    for n in ir.topo_order(root):
        for c in n.children:
            counts[c.id] = counts.get(c.id, 0) + 1
    return counts


def column_provenance(root: ir.Node) -> dict[int, dict[str, tuple[int, str]]]:
    """For every node, map each output column to the SCAN column it is a pure
    pass-through of: node id -> {col name: (scan id, scan col)}.

    Only value-preserving paths count (renames, filters, joins carrying a
    side's columns, aggregate keys); computed columns and aggregate outputs
    have no entry.  This is the liveness-style analysis the sampled
    statistics pass (core/stats.py) uses to answer "which base-table sample
    describes this node's key columns" without materializing anything.
    """
    prov: dict[int, dict[str, tuple[int, str]]] = {}
    for n in ir.topo_order(root):
        if isinstance(n, ir.Scan):
            prov[n.id] = {c: (n.id, c) for c in n.columns}
        elif isinstance(n, ir.Project):
            child = prov.get(n.child.id, {})
            prov[n.id] = {out: child[e.name]
                          for out, e in n.cols.items()
                          if isinstance(e, ColRef) and e.name in child}
        elif isinstance(n, ir.Join):
            left = prov.get(n.left.id, {})
            right = prov.get(n.right.id, {})
            m = dict(left)                      # keys unified into left names
            for c, src in right.items():
                if c in n.right_on:
                    continue
                m.setdefault(n.right_out_name(c), src)
            prov[n.id] = m
        elif isinstance(n, ir.Aggregate):
            child = prov.get(n.child.id, {})
            prov[n.id] = {k: child[k] for k in n.key if k in child}
        elif isinstance(n, ir.Window):
            child = prov.get(n.child.id, {})
            prov[n.id] = {c: s for c, s in child.items() if c != n.out}
        elif isinstance(n, ir.Concat):
            prov[n.id] = {}                     # rows from multiple scans
        elif n.children:
            # Filter / Sort / Limit / Repartition / Rebalance: row-subset or
            # row-reorder ops — every column passes through by value.
            prov[n.id] = dict(prov.get(n.children[0].id, {}))
        else:
            prov[n.id] = {}
    return prov


# ---------------------------------------------------------------------------
# predicate pushdown
# ---------------------------------------------------------------------------


def _rename_refs(e: Expr, mapping: dict[str, str]) -> Expr:
    def fix(ref: ColRef) -> Expr:
        return ColRef(ref.table_id, mapping.get(ref.name, ref.name))
    return e.map_refs(fix)


def _try_push_filter(f: ir.Filter, fanout: dict[int, int]) -> ir.Node | None:
    child = f.child
    # Never push through a node another consumer also reads (liveness check —
    # the other consumer would observe the filtered rows).
    if fanout.get(child.id, 0) > 1:
        return None
    # a predicate over an external array holds to the rows it reads now
    if _holds_external(f):
        return None
    names = {n for (_tid, n) in f.pred.columns()}

    if isinstance(child, ir.Filter):
        fused = ir.Filter(child.child, BinOp("and", child.pred, f.pred))
        return fused

    if isinstance(child, ir.Project):
        if _holds_external(child):
            return None
        # push only if every referenced output column is a pure rename
        mapping: dict[str, str] = {}
        for n in names:
            e = child.cols.get(n)
            if not isinstance(e, ColRef):
                return None
            mapping[n] = e.name
        new_pred = _rename_refs(f.pred, mapping)
        return child.with_children((ir.Filter(child.child, new_pred),))

    if isinstance(child, ir.Join):
        j = child
        lnames = set(j.left.schema)
        rnames_out = {j.right_out_name(n): n for n in j.right.schema
                      if n not in j.right_on}
        # Predicates over left columns (incl. the unified key columns) commute
        # with both inner and left joins: every output row carries its left
        # row's values unchanged, and a left join emits >= 1 row per left row.
        if names <= lnames:
            nl = ir.Filter(j.left, f.pred)
            return j.with_children((nl, j.right))
        # Right-side (or unified-key -> right) pushes are ONLY valid for
        # inner joins: below a how="left" join the filter would shrink the
        # right table, turning matched rows into zero-filled "unmatched"
        # output rows — post-join filtering drops them instead.
        if j.how == "inner" and names <= (set(rnames_out) | set(j.left_on)):
            mapping = dict(rnames_out)
            mapping.update(dict(zip(j.left_on, j.right_on)))
            np_ = _rename_refs(f.pred, mapping)
            nr = ir.Filter(j.right, np_)
            return j.with_children((j.left, nr))
        return None

    if isinstance(child, ir.Concat):
        parts = tuple(ir.Filter(p, f.pred) for p in child.parts)
        return child.with_children(parts)

    return None


def push_predicates(root: ir.Node) -> tuple[ir.Node, int]:
    """Apply pushdown rules to fixed point; returns (new_root, n_rewrites)."""
    n_rewrites = 0
    changed = True
    while changed:
        changed = False
        fanout = _consumers(root)
        memo: dict[int, ir.Node] = {}

        def rec(n: ir.Node) -> ir.Node:
            nonlocal changed, n_rewrites
            if n.id in memo:
                return memo[n.id]
            new_children = tuple(rec(c) for c in n.children)
            out = n if new_children == n.children else n.with_children(new_children)
            if isinstance(out, ir.Filter):
                pushed = _try_push_filter(out, fanout)
                if pushed is not None:
                    changed = True
                    n_rewrites += 1
                    out = pushed
            memo[n.id] = out
            return out

        root = rec(root)
    return root, n_rewrites


# ---------------------------------------------------------------------------
# column pruning (whole-plan liveness; paper: DCE removes unused columns)
# ---------------------------------------------------------------------------


def _required_columns(root: ir.Node, keep: set[str] | None) -> dict[int, set[str]]:
    """For every node, the set of its output columns actually consumed."""
    req: dict[int, set[str]] = {root.id: set(keep) if keep else set(root.schema)}
    for n in reversed(ir.topo_order(root)):
        need = req.setdefault(n.id, set(n.schema))
        if isinstance(n, ir.Filter):
            child_need = set(need) | {c for (_t, c) in n.pred.columns()}
            req.setdefault(n.child.id, set()).update(child_need)
        elif isinstance(n, ir.Project):
            child_need = set()
            for out_name, e in n.cols.items():
                if out_name in need:
                    child_need |= {c for (_t, c) in e.columns()}
            req.setdefault(n.child.id, set()).update(child_need)
        elif isinstance(n, ir.Join):
            lneed, rneed = set(n.left_on), set(n.right_on)
            lschema = n.left.schema
            for out_name in need:
                if out_name in lneed or (n.how == "left" and out_name == "_matched"):
                    continue  # _matched is synthesized by the join itself
                if out_name in lschema:
                    lneed.add(out_name)
                else:
                    base = out_name
                    if out_name.endswith(n.suffix) and out_name[: -len(n.suffix)] in lschema:
                        base = out_name[: -len(n.suffix)]
                    rneed.add(base)
            req.setdefault(n.left.id, set()).update(lneed)
            req.setdefault(n.right.id, set()).update(rneed)
        elif isinstance(n, ir.Aggregate):
            child_need = set(n.key)
            for name, agg in n.aggs.items():
                if name in need and agg.expr is not None:
                    child_need |= {c for (_t, c) in agg.expr.columns()}
            req.setdefault(n.child.id, set()).update(child_need)
        elif isinstance(n, ir.Window):
            child_need = set(need) - {n.out}
            if n.expr is not None:
                child_need |= {c for (_t, c) in n.expr.columns()}
            # partition/order keys are read by the segment kernels (and by
            # the exchange/sort the planner may insert): always live.
            child_need |= set(n.partition_by) | set(n.order_by)
            req.setdefault(n.child.id, set()).update(child_need)
        elif isinstance(n, ir.Sort):
            req.setdefault(n.child.id, set()).update(set(need) | set(n.by))
        elif isinstance(n, ir.Repartition):
            # the exchange/sort read the layout keys even when a downstream
            # consumer drops them
            req.setdefault(n.child.id, set()).update(
                set(need) | set(n.by) | set(n.sort_by))
        elif isinstance(n, ir.Concat):
            for c in n.parts:
                req.setdefault(c.id, set()).update(need)
        elif isinstance(n, (ir.Rebalance, ir.Limit)):
            req.setdefault(n.child.id, set()).update(need)
    return req


def prune_columns(root: ir.Node, keep: set[str] | None = None) -> tuple[ir.Node, int]:
    """Narrow Scan and Project nodes to live columns."""
    req = _required_columns(root, keep)
    pruned = 0
    memo: dict[int, ir.Node] = {}

    def rec(n: ir.Node) -> ir.Node:
        nonlocal pruned
        if n.id in memo:
            return memo[n.id]
        need = req.get(n.id, set(n.schema))
        if isinstance(n, ir.Scan):
            live = {k: v for k, v in n.columns.items() if k in need}
            if not live and n.columns:
                # a plan that reads only free arrays over these rows still
                # needs their count: keep one column
                k = next(iter(n.columns))
                live = {k: n.columns[k]}
            if len(live) < len(n.columns):
                pruned += len(n.columns) - len(live)
                # persisted layouts survive pruning restricted to the live
                # columns (partitioning iff every key lives; ordering keeps
                # its surviving prefix) — the device shards still re-enter.
                lay = (n.layout.restrict(set(live))
                       if n.layout is not None else None)
                out = ir.Scan(n.name, live,
                              {k: v for k, v in n._schema.items() if k in live},
                              layout=lay)
                # keep the source's identity: distribution pins (force_rep
                # from DataFrame.replicate()) are id-based, and only SOURCE
                # pins are load-bearing — interior nodes re-derive REP via
                # the lattice meet.  Without this, pruning a broadcast
                # dimension table silently un-broadcasts it.
                out.id = n.id
            else:
                out = n
        else:
            new_children = tuple(rec(c) for c in n.children)
            out = n if new_children == n.children else n.with_children(new_children)
            if isinstance(out, ir.Project):
                live_cols = {k: v for k, v in out.cols.items() if k in need}
                if len(live_cols) < len(out.cols):
                    pruned += len(out.cols) - len(live_cols)
                    dts = ({k: v for k, v in out.dtypes.items()
                            if k in live_cols} if out.dtypes else None)
                    out = ir.Project(out.child, live_cols, dts)
            elif isinstance(out, ir.Aggregate):
                live_aggs = {k: v for k, v in out.aggs.items()
                             if k in need or k in out.key}
                if len(live_aggs) < len(out.aggs):
                    pruned += len(out.aggs) - len(live_aggs)
                    out = ir.Aggregate(out.child, out.key, live_aggs)
        memo[n.id] = out
        return out

    return rec(root), pruned


# ---------------------------------------------------------------------------
# redundant sorts (order destroyed or re-established downstream)
# ---------------------------------------------------------------------------


def drop_redundant_sorts(root: ir.Node) -> tuple[ir.Node, int]:
    """Remove Sort nodes whose effect is unobservable.

    * ``Sort(Sort(x, K1, asc), K2, asc)`` == ``Sort(x, K2, asc)`` when K1 is
      a prefix of K2: the outer stable sort re-establishes exactly the order
      the inner one contributed (ties on K2 are ties on K1, and stability
      reduces them to input order either way).
    * ``Aggregate(Sort(x), key)`` == ``Aggregate(x, key)``: aggregation is
      order-insensitive — EXCEPT for ``first``, which reads the in-group
      arrival order and pins the sort.

    Bypassing is per-edge, so a Sort shared with another consumer still runs
    for that consumer.
    """
    dropped = 0
    memo: dict[int, ir.Node] = {}

    def rec(n: ir.Node) -> ir.Node:
        nonlocal dropped
        if n.id in memo:
            return memo[n.id]
        new_children = tuple(rec(c) for c in n.children)
        out = n if new_children == n.children else n.with_children(new_children)
        if isinstance(out, ir.Sort):
            c = out.child
            if (isinstance(c, ir.Sort) and c.ascending == out.ascending
                    and c.by == out.by[: len(c.by)]):
                out = out.with_children((c.child,))
                dropped += 1
        elif isinstance(out, ir.Aggregate):
            c = out.child
            if (isinstance(c, ir.Sort) and not _holds_external(out)
                    and not any(a.fn == "first" for a in out.aggs.values())):
                out = out.with_children((c.child,))
                dropped += 1
        memo[n.id] = out
        return out

    return rec(root), dropped


# ---------------------------------------------------------------------------
# entry point: all passes in order
# ---------------------------------------------------------------------------


def optimize(root: ir.Node, keep: set[str] | None = None,
             enable: tuple[str, ...] = ("pushdown", "sorts", "prune")
             ) -> tuple[ir.Node, dict]:
    stats = {"pushdown": 0, "pruned_columns": 0, "sorts_dropped": 0}
    if "pushdown" in enable:
        root, k = push_predicates(root)
        stats["pushdown"] = k
    if "sorts" in enable:
        root, s = drop_redundant_sorts(root)
        stats["sorts_dropped"] = s
    if "prune" in enable:
        root, p = prune_columns(root, keep)
        stats["pruned_columns"] = p
    return root, stats
