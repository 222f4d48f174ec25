"""Lowering: optimized logical plan -> physical plan -> per-rank execution.

The reference package traces the whole physical op list into ONE jitted
``shard_map`` program.  Here each rank runs the same op list once, eagerly,
on its own shard: P = 1 by default, P = the world size when
``torch.distributed`` is initialised (one process per card with NCCL, gloo
ranks on the CPU).  The property-driven physical planner
(core/physical_plan.py) decides where exchanges and sorts are required, and
this module executes the resulting op list.

Counts and per-site overflow flags stay tensors on the device until the end
of the run, where ``Lowered.__call__`` reads them back once.
"""
from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from . import distribution as D
from . import ir, physical as phys
from . import physical_plan as pp
from ..kernels import registry as kreg
from .dtypes import NULL_CODE, is_category, physical_dtype
from .expr import evaluate, nulltag_for
from .table import DTable


# ---------------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------------


@dataclass
class ExecConfig:
    """Execution configuration (device, capacity planning, physical choices).

    ``device`` is where the plan runs: "cuda" (the default: the current
    card, whose tensors launch the hand-written kernels) or "cpu" (the plain
    PyTorch versions), and only when asked for.  Without a card and without
    ``device="cpu"`` construction raises: a run never moves to the CPU on
    its own.
    """

    device: str = "cuda"
    # capacity policy: "safe" bounds every buffer by the worst case;
    # otherwise capacities are input_cap * slack and overflow is flagged.
    safe_capacities: bool = True
    shuffle_slack: float = 2.0
    join_expansion: float = 1.5
    broadcast_join: bool = True       # REP side joins without shuffle
    optimize_plan: bool = True
    # property-driven exchange/sort elision (core/physical_plan.py)
    elide_exchanges: bool = True
    # ship all columns of an exchange as ONE word-packed payload: exactly 2
    # all_to_all per exchange (counts + payload)
    packed_exchange: bool = True
    # split a shuffling aggregate with decomposable fns into
    # PartialAgg -> HashExchange -> FinalAgg
    partial_agg: bool = True
    # optional user bound on distinct groups per shard (PartialAgg buffers)
    agg_group_cap: int | None = None
    # exclusive scan of per-rank values in the global windows: "allgather"
    # (one all_gather) or "ladder" (log2(P) rounds of batch_isend_irecv)
    exscan_method: str = "allgather"
    # capacity-overflow auto-retry built into collect()
    auto_retry: int = 3
    # {op_id: (cap_floor, bucket_floor)} applied by compute_capacities —
    # written by collect()'s retry, not by users.
    cap_overrides: Any = None

    def __post_init__(self):
        dev = torch.device(self.device)
        if dev.type not in kreg.DEVICES:
            raise ValueError(f"device must be one of {kreg.DEVICES}, "
                             f"got {self.device!r}")
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "ExecConfig: no CUDA device is available; pass "
                "ExecConfig(device='cpu') to run on the CPU")

    def torch_device(self) -> torch.device:
        return torch.device(self.device)

    def nshards(self) -> int:
        """Ranks the plan runs on: the world size of an initialised
        ``torch.distributed`` group, else 1."""
        if dist.is_available() and dist.is_initialized():
            return dist.get_world_size()
        return 1


# ---------------------------------------------------------------------------
# executor
# ---------------------------------------------------------------------------


class Lowered:
    """A physical plan bound to its sources: call it to run on this rank."""

    def __init__(self, root: ir.Node, cfg: ExecConfig, dists: dict[int, str],
                 pplan: pp.PhysicalPlan):
        self.root = root
        self.cfg = cfg
        self.dists = dists
        self.pplan = pplan
        self.device = cfg.torch_device()
        self.kernels = kreg.resolve(self.device.type)
        self.P = cfg.nshards()
        self.rank = dist.get_rank() if self.P > 1 else 0
        for op in pplan.ops:
            if not isinstance(op, _EXECUTED):
                raise NotImplementedError(_unsupported(op))
        # per-op failure attribution: the static capacity-site table, one
        # (flag, requirement) pair per site in this order.
        self.sites = _capacity_sites(pplan)

    def _source(self, op: pp.Source):
        """This rank's rows of a scan and their count.

        A persisted scan whose layout re-enters at this shard count (and
        is not forced to REP) hands over this rank's device shard by
        identity, with its count from the layout's (P,) counts: no host
        copy, no re-pad.  Any other scan is a host table (a persisted one
        first gathers its valid prefixes, ``ScanLayout.gather_host``) and
        this rank takes its block, padded to the op's capacity."""
        n, dev = op.node, self.device
        lay = n.layout
        if lay is not None and lay.device_valid(self.P) and op.dist != D.REP:
            cap = int(lay.capacity)
            cols = {c: _shard(v, cap, self.rank).to(dev)
                    for c, v in n.columns.items()}
            return cols, torch.tensor(int(lay.counts[self.rank]),
                                      dtype=torch.int32, device=dev)
        cols = {c: _host(v) for c, v in n.columns.items()}
        if lay is not None and lay.counts is not None:
            if any(len(v) != lay.nshards * lay.capacity for v in cols.values()):
                raise ValueError(
                    f"persisted scan {n.name!r} holds one rank's shard of "
                    f"{lay.nshards}; it re-enters only at P = {lay.nshards} "
                    f"and not replicated (here P = {self.P}, "
                    f"{'REP' if op.dist == D.REP else op.dist})")
            cols = lay.gather_host(cols)
        rows = len(next(iter(cols.values())))
        if op.dist == D.REP:
            lo, hi, cnt = 0, rows, rows
        else:
            lo = min(self.rank * op.cap, rows)
            hi = min(lo + op.cap, rows)
            cnt = hi - lo
        cap = rows if op.dist == D.REP else op.cap
        out = {}
        for c, a in cols.items():
            t = torch.zeros(cap, dtype=torch.from_numpy(a[:0]).dtype, device=dev)
            t[: hi - lo] = torch.from_numpy(np.ascontiguousarray(a[lo:hi])).to(dev)
            out[c] = t
        return out, torch.tensor(cnt, dtype=torch.int32, device=dev)

    def __call__(self, gather: bool = True) -> DTable:
        """Run the plan on this rank.  With ``gather`` (the default) the
        result's columns hold every rank's shard, as ``collect()`` returns
        them; without it they hold this rank's own ``(capacity,)`` shard
        (``DTable.shard``), as ``persist()`` keeps them.  The counts and
        the overflow report are gathered either way, and the report is
        read back to the host once."""
        pplan, kernels, P = self.pplan, self.kernels, self.P
        packed = self.cfg.packed_exchange
        env: dict[int, tuple[dict, Any]] = {}
        flags: list[torch.Tensor] = []
        reqs: list[torch.Tensor] = []

        def flag(ovf, req):
            flags.append(torch.as_tensor(ovf, device=self.device).reshape(()))
            reqs.append(torch.as_tensor(req, device=self.device)
                        .to(torch.float32).reshape(()))

        for op in pplan.ops:
            n = op.node
            if isinstance(op, pp.Source):
                res = self._source(op)

            elif isinstance(op, pp.Compact):
                cols, cnt = env[op.inputs[0]]
                cap = next(iter(cols.values())).shape[0]
                keep = evaluate(n.pred, cols) & phys.valid_mask(cnt, cap)
                keep = keep.expand(cap)
                out, cnt2, ovf = phys.compact(cols, keep, op.cap, kernels=kernels)
                flag(ovf, keep.sum())
                res = (out, cnt2)

            elif isinstance(op, pp.Map):
                cols, cnt = env[op.inputs[0]]
                cap = next(iter(cols.values())).shape[0]
                cache: dict = {}
                out = {name: _full(evaluate(e, cols, cache), cap)
                       for name, e in n.cols.items()}
                res = (out, cnt)

            elif isinstance(op, pp.WindowOp):
                res = self._window(op, *env[op.inputs[0]])

            elif isinstance(op, pp.HashExchange):
                cols, cnt = env[op.inputs[0]]
                # the routing hashes also feed the requirement estimate
                # (max destination load) without a second hash pass.
                cap_in = next(iter(cols.values())).shape[0]
                dest = (phys.hash_keys(cols, op.keys) % P).to(torch.int32)
                valid = phys.valid_mask(cnt, cap_in)
                hist = torch.zeros(P, dtype=torch.int32, device=self.device) \
                    .index_add_(0, dest.long(), valid.to(torch.int32))
                out, cnt2, ovf = phys.exchange(
                    cols, cnt, dest, P=P, bucket_cap=op.bucket,
                    cap_out=op.cap, kernels=kernels, packed=packed)
                flag(ovf, hist.max())
                res = (out, cnt2)

            elif isinstance(op, pp.LocalSort):
                cols, cnt = env[op.inputs[0]]
                out, _ = phys.local_sort(cols, cnt, op.keys)
                res = (out, cnt)

            elif isinstance(op, pp.MergeJoin):
                lcols, lcnt = env[op.inputs[0]]
                rcols, rcnt = env[op.inputs[1]]
                lon, ron = n.left_on, n.right_on
                smap = {c: n.right_out_name(c) for c in rcols if c not in ron}
                out, cnt2, ovf = phys.merge_join(
                    lcols, lcnt, rcols, rcnt, lon, ron, cap_out=op.cap,
                    r_suffix_map=smap, how=n.how, null_fill=_join_null_fill(n))
                lf = lcnt.to(torch.float32)
                flag(ovf, torch.maximum(lf * rcnt.to(torch.float32), lf))
                res = (out, cnt2)

            elif isinstance(op, pp.AggPrep):
                cols, cnt = env[op.inputs[0]]
                cache = {}
                key0 = cols[n.key[0]]
                out = {k: cols[k] for k in n.key}
                for name, agg in n.aggs.items():
                    arr = (evaluate(agg.expr, cols, cache)
                           if agg.expr is not None
                           else torch.zeros_like(key0, dtype=torch.int32))
                    out["__v_" + name] = _full(arr, key0.shape[0])
                res = (out, cnt)

            elif isinstance(op, pp.PartialAgg):
                cols, cnt = env[op.inputs[0]]
                keys = tuple(cols[k] for k in n.key)
                out, n_seg, ovf = phys.partial_aggregate(
                    keys, cnt, _agg_values(n, cols), cap_out=op.cap,
                    kernels=kernels)
                flag(ovf, _distinct_runs(keys, cnt))
                res = (_restore_key_names(out, n.key), n_seg)

            elif isinstance(op, pp.SegmentAgg):
                cols, cnt = env[op.inputs[0]]
                keys = tuple(cols[k] for k in n.key)
                if op.from_partials:
                    tags = _agg_nulltags(n)
                    fns = {name: (agg.fn, agg.skipna, tags[name])
                           if tags[name] is not None else agg.fn
                           for name, agg in n.aggs.items()}
                    out, n_seg, ovf = phys.final_aggregate(
                        keys, cnt, fns, cols, cap_out=op.cap, kernels=kernels)
                else:
                    out, n_seg, ovf = phys.segment_aggregate(
                        keys, cnt, _agg_values(n, cols), cap_out=op.cap,
                        kernels=kernels,
                        presorted=(op.nunique_ride,) if op.nunique_ride else ())
                flag(ovf, _distinct_runs(keys, cnt))
                res = (_restore_key_names(out, n.key), n_seg)

            elif isinstance(op, pp.SampleSort):
                cols, cnt = env[op.inputs[0]]
                out, cnt2, ovf = phys.sample_sort(
                    cols, cnt, n.by, P=1 if op.dist == D.REP else P,
                    bucket_cap=op.bucket, cap_out=op.cap,
                    ascending=n.ascending, pre_sorted=op.pre_sorted,
                    kernels=kernels, packed=packed)
                flag(ovf, cnt)
                res = (out, cnt2)

            elif isinstance(op, pp.LimitOp):
                cols, cnt = env[op.inputs[0]]
                res = phys.limit(cols, cnt, n.n, 1 if op.dist == D.REP else P,
                                 cap_out=op.cap,
                                 method=self.cfg.exscan_method)

            elif isinstance(op, pp.RebalanceOp):
                cols, cnt = env[op.inputs[0]]
                out, cnt2, ovf = phys.rebalance(
                    cols, cnt, P=P, bucket_cap=op.bucket, cap_out=op.cap,
                    kernels=kernels, packed=packed)
                flag(ovf, cnt)
                res = (out, cnt2)

            elif isinstance(op, pp.ConcatOp):
                parts = [env[i] for i in op.inputs]
                out, cnt2, ovf = phys.concat(parts, op.cap, kernels=kernels)
                flag(ovf, functools.reduce(
                    torch.add, [c.to(torch.float32) for _, c in parts]))
                res = (out, cnt2)

            else:
                raise NotImplementedError(_unsupported(op))
            env[op.op_id] = res

        cols, cnt = env[pplan.root_id]
        assert len(flags) == len(self.sites), (len(flags), self.sites)
        cap = pplan.root_op.cap
        cols = {k: cols[k] for k in self.root.schema}
        report = (torch.cat([torch.stack(flags).to(torch.float32),
                             torch.stack(reqs)])
                  if flags else torch.zeros(0, device=self.device))
        counts = cnt.reshape(1)
        if P > 1:
            if gather:
                cols = {k: phys.all_gather_rows(v, P) for k, v in cols.items()}
            counts = phys.all_gather_rows(counts, P)
            report = phys.all_gather_rows(report, P)
        # the one read back to the host
        report = report.cpu().numpy().reshape(P, -1)
        nsite = len(self.sites)
        fl = report[:, :nsite] != 0
        overflow_ops = self._attribute_overflow(fl, report[:, nsite:])
        return DTable(columns=cols, counts=counts, capacity=cap, nshards=P,
                      dist=self.dists[self.root.id], overflow=bool(fl.any()),
                      overflow_ops=overflow_ops,
                      shard=None if gather else self.rank)

    def _window(self, op: pp.WindowOp, cols: dict, cnt) -> tuple[dict, Any]:
        """cumsum / stencil / rank: partitioned over the grouped layout the
        planner established (segment kernels, no collectives), or global
        (an exclusive scan of per-rank values, or a halo exchange).  A REP
        input is whole on every rank, so its global window runs as P = 1."""
        n, kernels = op.node, self.kernels
        P = 1 if op.dist == D.REP else self.P
        method = self.cfg.exscan_method
        cap = next(iter(cols.values())).shape[0]
        x = _full(evaluate(n.expr, cols), cap) if n.expr is not None else None
        tag = (nulltag_for(n.expr, n.children[0].schema)
               if n.kind == "cumsum" else None)
        if n.partition_by:
            pk = tuple(cols[k] for k in n.partition_by)
            if n.kind == "cumsum":
                col = phys.segment_cumsum(x, pk, cnt, kernels=kernels,
                                          nulltag=tag)
            elif n.kind == "stencil":
                col = phys.segment_stencil1d(x, pk, cnt, n.weights, n.center,
                                             exact=n.exact, kernels=kernels)
            else:
                ok = tuple(cols[k] for k in n.order_by)
                col = phys.segment_rank(pk, ok, cnt, n.kind, kernels=kernels)
        elif n.kind in ir.RANK_KINDS:
            ok = tuple(cols[k] for k in n.order_by)
            col = phys.global_rank(ok, cnt, cap, n.kind, P=P, method=method,
                                   kernels=kernels)
        elif n.kind == "cumsum":
            nullm = phys.null_mask(x, tag)
            if nullm is not None:          # pandas: nulls stay null and the
                x = torch.where(nullm, torch.zeros((), dtype=x.dtype,
                                                   device=x.device), x)
            col = phys.dist_cumsum(x, cnt, P=P, method=method, kernels=kernels)
            if nullm is not None:          # running total skips them
                col = torch.where(nullm, torch.tensor(
                    phys.null_value(col.dtype, tag), dtype=col.dtype,
                    device=col.device), col)
        else:
            col = phys.stencil1d(x, cnt, n.weights, n.center, P=P,
                                 kernels=kernels, exact=n.exact)
        out = dict(cols)
        out[n.out] = col
        return out, cnt

    def _attribute_overflow(self, flags: np.ndarray,
                            reqs: np.ndarray) -> dict[int, dict]:
        """Reduce per-shard (flag, requirement) vectors to the per-op
        attribution record the retry escalates from."""
        overflow_ops: dict[int, dict] = {}
        for i, (op_id, kind, rule, strategy) in enumerate(self.sites):
            if not flags[:, i].any():
                continue
            vals = reqs[:, i].astype(np.float64)
            cap_req = {"max": float(vals.max()),
                       "sum": float(vals.sum()),
                       "block": float(np.ceil(vals.sum() / max(self.P, 1)))
                       }[rule]
            op = self.pplan.ops[op_id]
            overflow_ops[op_id] = {
                "kind": kind, "op": type(op).__name__, "strategy": strategy,
                "cap": int(op.cap), "bucket": int(op.bucket),
                "cap_req": int(np.ceil(cap_req)),
                "bucket_req": int(np.ceil(float(vals.max()))),
                "req_shards": vals,
            }
        return overflow_ops


# the physical ops this executor runs; the planner's others belong to later
# slices of the package
_EXECUTED = (pp.Source, pp.Compact, pp.Map, pp.WindowOp, pp.HashExchange,
             pp.LocalSort, pp.MergeJoin, pp.AggPrep, pp.PartialAgg,
             pp.SegmentAgg, pp.SampleSort, pp.LimitOp, pp.RebalanceOp,
             pp.ConcatOp)

# why a planned op is not executed yet, by op type
_LATER = {
    "SaltOp": "a salted skew join is planned only under adaptive statistics "
              "(ExecConfig.adaptive_stats), which come with ROADMAP "
              "section 1 item 8",
}


def _unsupported(op: pp.POp) -> str:
    name = type(op).__name__
    why = _LATER.get(name, "")
    return (f"{name} is not part of this package yet"
            + (f": {why}" if why else "")
            + " (the executor runs "
            + ", ".join(t.__name__ for t in _EXECUTED) + ")")


def _host(v) -> np.ndarray:
    """A scan column as a host array (persisted columns are tensors)."""
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _shard(v: torch.Tensor, cap: int, rank: int) -> torch.Tensor:
    """This rank's ``(cap,)`` shard of a persisted column: the column
    itself when it holds one rank's shard (what ``persist()`` keeps), else
    a view of rank ``rank``'s rows of a column that holds every shard (a
    carried-over state)."""
    return v if v.shape[0] == cap else v[rank * cap:(rank + 1) * cap]


def _full(v: torch.Tensor, cap: int) -> torch.Tensor:
    """A 0-d result (a constant column) broadcast to the shard's rows."""
    return v.expand(cap).clone() if v.dim() == 0 else v


def _capacity_sites(pplan: pp.PhysicalPlan) -> list[tuple[int, str, str, str]]:
    """The static capacity-site table for per-op overflow attribution: one
    entry per overflow-flagged buffer, in per-rank flag order —
    ``(op_id, kind, reduce-rule, escalation-strategy)``.

    "max" reduces per-shard buffers, "sum" exchange receive totals, "block"
    evenly re-split rows.  "abs" sites report a true upper bound, so one
    retry at that size heals; "double" sites (join expansion) escalate
    geometrically instead.
    """
    sites = []
    for op in pplan.ops:
        rep = op.dist == D.REP
        if isinstance(op, pp.Compact):
            sites.append((op.op_id, "compact", "max", "abs"))
        elif isinstance(op, pp.HashExchange):
            sites.append((op.op_id, "exchange",
                          "max" if rep else "sum", "abs"))
        elif isinstance(op, pp.MergeJoin):
            sites.append((op.op_id, "join", "max", "double"))
        elif isinstance(op, pp.PartialAgg):
            sites.append((op.op_id, "partial_agg", "max", "abs"))
        elif isinstance(op, pp.SegmentAgg):
            sites.append((op.op_id, "segment_agg", "max", "abs"))
        elif isinstance(op, pp.SampleSort):
            sites.append((op.op_id, "sort", "max" if rep else "sum", "abs"))
        elif isinstance(op, pp.RebalanceOp):
            sites.append((op.op_id, "rebalance",
                          "max" if rep else "block", "abs"))
        elif isinstance(op, pp.ConcatOp):
            sites.append((op.op_id, "concat", "max", "abs"))
    return sites


def _distinct_runs(keys: tuple, cnt) -> torch.Tensor:
    """Exact count of key runs in the valid prefix of sorted key columns —
    the true PartialAgg/SegmentAgg output requirement."""
    cap = keys[0].shape[0]
    if cap < 2:
        return (cnt > 0).to(torch.int32)
    valid = phys.valid_mask(cnt, cap)
    neq = functools.reduce(torch.logical_or, [k[1:] != k[:-1] for k in keys])
    return (torch.sum((neq & valid[1:]).to(torch.int32))
            + (cnt > 0).to(torch.int32))


def _agg_nulltags(n: ir.Aggregate) -> dict[str, str | None]:
    """Per-output null tag, from the child's LOGICAL schema."""
    sch = n.children[0].schema
    return {name: nulltag_for(agg.expr, sch) for name, agg in n.aggs.items()}


def _agg_values(n: ir.Aggregate, cols: dict) -> dict[str, tuple]:
    """segment_aggregate value specs of an Aggregate over its prep columns."""
    tags = _agg_nulltags(n)
    return {name: (agg.fn, cols["__v_" + name], agg.skipna, tags[name])
            if tags[name] is not None else (agg.fn, cols["__v_" + name])
            for name, agg in n.aggs.items()}


def _join_null_fill(n: ir.Join) -> dict[str, Any] | None:
    """Unmatched-row fill values for a left join's right columns: null code
    for categories, NaN for floats; int columns zero-fill beside
    ``_matched``."""
    if n.how != "left":
        return None
    fill: dict[str, Any] = {}
    for c, dt in n.children[1].schema.items():
        if c in n.right_on:
            continue
        if is_category(dt):
            fill[c] = NULL_CODE
        elif np.issubdtype(physical_dtype(dt), np.floating):
            fill[c] = float("nan")
    return fill or None


def _restore_key_names(out: dict, key: tuple[str, ...]) -> dict:
    """Segment-aggregation outputs name key columns ``__key<i>__``; restore
    the real names, keeping them FIRST (schema order)."""
    renamed = {k: out.pop(f"__key{i}__") for i, k in enumerate(key)}
    renamed.update(out)
    return renamed


def lower(root: ir.Node, cfg: ExecConfig | None = None,
          keep: set[str] | None = None,
          force_rep: set[int] = frozenset()) -> tuple[Lowered, dict]:
    """optimize -> infer distributions -> plan physical ops (exchange/sort
    elision) -> plan capacities -> bind the executor.  ``force_rep``: node
    ids the caller pins to REP (``DataFrame.replicate``)."""
    from . import optimizer as opt

    cfg = cfg or ExecConfig()
    stats: dict = {}
    if cfg.optimize_plan:
        root, stats = opt.optimize(root, keep)
    info = D.infer(root, force_rep=force_rep,
                   broadcast_join=cfg.broadcast_join)
    root = D.insert_rebalance(root, info)
    source_rows = {n.id: pp.scan_rows(n)
                   for n in ir.topo_order(root) if isinstance(n, ir.Scan)}
    pplan = pp.plan_physical(root, info.dists, cfg)
    pp.plan_capacities(pplan, cfg.nshards(), cfg, source_rows)
    return Lowered(root, cfg, info.dists, pplan), stats


def execute(root: ir.Node, cfg: ExecConfig, keep: set[str] | None = None,
            force_rep: set[int] = frozenset(),
            gather: bool = True) -> tuple[Lowered, DTable]:
    """Lower and run, retrying on capacity overflow at most
    ``cfg.auto_retry`` times.  Each retry grows only the overflowed sites
    (``cap_overrides``): "abs" sites to their observed requirement, "double"
    sites to twice their cap.  The table comes back overflow-flagged when
    the retries run out; ``events`` on it lists what the loop did.
    ``gather=False`` returns this rank's own shard (``Lowered.__call__``)."""
    events: list[str] = []
    attempt = 0
    while True:
        lowered, _ = lower(root, cfg, keep, force_rep)
        t = lowered(gather)
        if not t.overflow or attempt >= max(cfg.auto_retry, 0):
            if t.overflow:
                events.append(f"overflow_exhausted after {attempt} retries: "
                              f"ops {sorted(t.overflow_ops)}")
            t.events = tuple(events)
            return lowered, t
        overrides = dict(cfg.cap_overrides or {})
        for op_id, rec in sorted(t.overflow_ops.items()):
            op = lowered.pplan.ops[op_id]
            bucket = int(op.bucket or 0)
            if rec["strategy"] == "double":
                new = (max(int(op.cap), 1) * 2, bucket * 2)
            else:
                new = (max(rec["cap_req"], 1), rec["bucket_req"] if bucket else 0)
            prev = overrides.get(op_id, (0, 0))
            overrides[op_id] = (max(new[0], prev[0]), max(new[1], prev[1]))
            events.append(f"retry {attempt + 1}: {rec['kind']} #{op_id} cap "
                          f"{rec['cap']} -> {overrides[op_id][0]}")
        cfg = dataclasses.replace(cfg, cap_overrides=overrides)
        attempt += 1
