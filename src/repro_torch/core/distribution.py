r"""Distribution inference — the Distributed-Pass analogue (paper §4.4).

HPAT infers a distribution for every array/parfor by fixed-point iteration
over a meet-semilattice; HiFrames extends the lattice with 1D_VAR for the
data-dependent output sizes of relational operations (paper Fig. 7):

        1D_BLOCK            (top: even block rows per rank)
           |
        1D_VAR              (variable valid-prefix per rank)
        /    \
    2D_BLOCK  |             (block-cyclic for linear algebra; meet with 1D -> REP)
        \    /
         REP                (bottom: replicated / sequential)

On TPU the *carrier* of 1D_VAR changes (static capacity + per-shard count —
see DESIGN.md §2) but the lattice, the transfer functions, and the
rebalance-only-when-needed rule are implemented verbatim.

Composite (multi-column) keys do not change the lattice: Join/Aggregate/Sort
carry key TUPLES in the IR, but their transfer functions depend only on node
shape (data-dependent output length => 1D_VAR), never on key arity — the
physical layer routes on a combined hash so co-location still holds.

This pass decides WHERE rows may live; HOW they move is decided downstream
by the property-driven physical planner (core/physical_plan.py), which seeds
its partitioning properties from these lattice elements (REP scans provide
"rep" — satisfying every co-location requirement — everything else starts
"block") and inserts exchanges only where a required property is missing.
"""
from __future__ import annotations

from dataclasses import dataclass

from . import ir

# Lattice elements, ordered by "height" (higher = more structured).
ONE_D = "1D_BLOCK"
ONE_D_VAR = "1D_VAR"
TWO_D = "2D_BLOCK"
REP = "REP"

_HEIGHT = {ONE_D: 3, ONE_D_VAR: 2, TWO_D: 2, REP: 0}


def meet(a: str, b: str) -> str:
    """Greatest lower bound in the semilattice of Fig. 7."""
    if a == b:
        return a
    # 2D is incomparable with the 1D chain: meet is REP.
    if TWO_D in (a, b):
        return REP
    if REP in (a, b):
        return REP
    # remaining: {1D_BLOCK, 1D_VAR} -> 1D_VAR
    return ONE_D_VAR


def leq(a: str, b: str) -> bool:
    """Partial order: a ⊑ b iff meet(a, b) == a."""
    return meet(a, b) == a


# Nodes whose OUTPUT length is data-dependent (=> at most 1D_VAR).
# Limit rides along: its per-shard count depends on how rows were
# distributed upstream, so it can't promise 1D_BLOCK either.
_VAR_OUT = (ir.Filter, ir.Join, ir.Aggregate, ir.Limit)


def scan_seed(n: ir.Scan) -> str:
    """Lattice element a Scan provides: plain host tables are 1D_BLOCK; a
    persisted scan re-enters at the element its producing plan satisfied
    (typically 1D_VAR — per-shard counts vary)."""
    return n.layout.dist if n.layout is not None else ONE_D


def requires_block(n: ir.Node) -> bool:
    """Nodes that REQUIRE 1D_BLOCK inputs: GLOBAL stencil neighborhoods assume
    even blocks (cumsum masks validity and accepts 1D_VAR); matrix assembly
    for ML does too (handled via collect_block).  PARTITIONED windows never
    do — their groups are made shard-local by a hash exchange and taps never
    cross a group edge, so no halo is needed."""
    return (isinstance(n, ir.Window) and n.kind == "stencil"
            and not n.partition_by)


def is_partitioned_window(n: ir.Node) -> bool:
    """Partitioned windows redistribute rows (hash on the partition keys), so
    their output length per shard is data-dependent: at most 1D_VAR."""
    return isinstance(n, ir.Window) and bool(n.partition_by)


@dataclass
class DistInfo:
    dists: dict[int, str]           # node id -> lattice element
    rebalanced: set[int]            # node ids under which a Rebalance was inserted


def infer(root: ir.Node, *, force_rep: set[int] = frozenset(),
          broadcast_join: bool = True) -> DistInfo:
    """Fixed-point distribution inference + rebalance insertion.

    ``force_rep``: node ids the caller pins to REP (e.g. tiny broadcast
    tables).  ``broadcast_join``: beyond-paper rule — a Join whose right input
    is REP keeps the left distribution (no shuffle, no sequentialization);
    with it disabled the paper's plain meet applies and REP poisons the join.

    Returns the annotation map.  The caller then calls :func:`insert_rebalance`
    to materialize Rebalance nodes where a 1D_VAR producer feeds a
    1D_BLOCK-requiring consumer — the paper's "rebalance only when necessary".
    """
    order = ir.topo_order(root)
    dist: dict[int, str] = {}

    # Initialize at top (1D_BLOCK), pin forced nodes.
    for n in order:
        dist[n.id] = REP if n.id in force_rep else ONE_D

    changed = True
    while changed:
        changed = False
        for n in order:
            d = dist[n.id]
            new = d
            is_bcast_join = (broadcast_join and isinstance(n, ir.Join)
                             and dist[n.right.id] == REP
                             and dist[n.left.id] != REP)
            if isinstance(n, ir.Scan):
                new = meet(new, scan_seed(n))
            elif is_bcast_join:
                new = meet(ONE_D_VAR, dist[n.left.id])
            elif is_partitioned_window(n):
                new = meet(ONE_D_VAR, dist[n.child.id])
            elif isinstance(n, _VAR_OUT):
                # out = 1D_VAR ∧ dist[in1] ∧ dist[in2] ...   (paper §4.4)
                new = ONE_D_VAR
                for c in n.children:
                    new = meet(new, dist[c.id])
            elif requires_block(n):
                # consumes blocks; output is 1D_BLOCK unless an input is REP.
                new = ONE_D
                for c in n.children:
                    if dist[c.id] == REP:
                        new = REP
            elif isinstance(n, ir.Concat):
                new = ONE_D_VAR
                for c in n.children:
                    new = meet(new, dist[c.id])
            elif isinstance(n, ir.Rebalance):
                new = ONE_D if dist[n.child.id] != REP else REP
            elif isinstance(n, ir.Sort):
                new = ONE_D_VAR if dist[n.child.id] != REP else REP
            elif isinstance(n, ir.Repartition):
                if n.by:
                    # hash exchange: per-shard counts become data-dependent
                    new = meet(ONE_D_VAR, dist[n.child.id])
                else:
                    # sort_within_partitions: no row movement, pass-through
                    new = meet(new, dist[n.child.id])
            else:  # Project / Window-like pass-through
                for c in n.children:
                    new = meet(new, dist[c.id])
            if n.id in force_rep:
                new = REP
            if new != d:
                dist[n.id] = new
                changed = True
            # REP inputs make relational ops sequential: propagate the meet
            # back to the inputs (paper: "all input and output arrays of an
            # aggregate should be replicated if any of them is").
            if ((isinstance(n, _VAR_OUT) or is_partitioned_window(n))
                    and dist[n.id] == REP and not is_bcast_join):
                for c in n.children:
                    if dist[c.id] != REP:
                        dist[c.id] = REP
                        changed = True
    return DistInfo(dists=dist, rebalanced=set())


def insert_rebalance(root: ir.Node, info: DistInfo,
                     collect_block: bool = False) -> ir.Node:
    """Insert Rebalance nodes exactly where 1D_VAR meets a 1D_BLOCK consumer."""

    memo: dict[int, ir.Node] = {}

    def need_block_child(parent: ir.Node) -> bool:
        return requires_block(parent)

    def rec(n: ir.Node) -> ir.Node:
        if n.id in memo:
            return memo[n.id]
        new_children = tuple(rec(c) for c in n.children)
        out = n if new_children == n.children else n.with_children(new_children)
        if out is not n:
            info.dists[out.id] = info.dists[n.id]
        if need_block_child(n):
            fixed = []
            for c_old, c_new in zip(n.children, out.children):
                if info.dists[c_old.id] == ONE_D_VAR:
                    rb = ir.Rebalance(c_new)
                    info.dists[rb.id] = ONE_D
                    info.rebalanced.add(rb.id)
                    fixed.append(rb)
                else:
                    fixed.append(c_new)
            if tuple(fixed) != out.children:
                out2 = out.with_children(tuple(fixed))
                info.dists[out2.id] = info.dists[n.id]
                out = out2
        memo[n.id] = out
        return out

    new_root = rec(root)
    if collect_block and info.dists[new_root.id] == ONE_D_VAR:
        rb = ir.Rebalance(new_root)
        info.dists[rb.id] = ONE_D
        info.rebalanced.add(rb.id)
        new_root = rb
    return new_root
