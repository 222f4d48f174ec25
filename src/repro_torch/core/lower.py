"""Lowering: optimized logical plan -> physical plan -> per-rank execution.

The reference package traces the whole physical op list into ONE jitted
``shard_map`` program.  Here each rank runs the same op list once, eagerly,
on its own shard: P = 1 by default, P = the world size when
``torch.distributed`` is initialised (one process per card with NCCL, gloo
ranks on the CPU).  The property-driven physical planner
(core/physical_plan.py) decides where exchanges and sorts are required, and
this module executes the resulting op list.

Counts, per-site overflow flags and the ``validate`` checks stay tensors on
the device until the end of the run, where ``Lowered.__call__`` reads them
back once.  ``execute`` runs a plan under ``runtime.retry.RetryPolicy``.
"""
from __future__ import annotations

import functools
import os
import threading
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from . import distribution as D
from . import errors as err
from . import ir, physical as phys
from . import physical_plan as pp
from ..kernels import registry as kreg
from .dtypes import NULL_CODE, categories_of, is_category, physical_dtype
from .expr import evaluate, ext_dtype, ext_tensor, externals, nulltag_for
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
    # -- adaptive statistics (core/stats.py) ---------------------------------
    # adaptive_stats: build a sampled StatsContext per plan and let it make
    # planner DECISIONS: salted skew joins, cheaper-side re-exchange for
    # mixed-alignment joins, and PartialAgg auto-capacity from the
    # distinct-count estimate (plus realized feedback from previous runs of
    # the same plan fingerprint).  Off by default: plans are identical to
    # the stats-blind planner's.  explain() annotates estimates either way.
    adaptive_stats: bool = False
    # salt_threshold: sampled key frequency above which a join key counts as
    # a heavy hitter and gets salted across salt_factor sub-partitions.
    # Halved automatically when realized feedback shows shard skew.
    salt_threshold: float = 0.1
    salt_factor: int = 8
    # stats_sample: rows sampled per base table (even positions, like
    # sample_sort's splitters).
    stats_sample: int = 256
    # stats_cap_slack: headroom multiplier on SAMPLED estimates when they
    # size buffers (realized feedback is exact and gets none).  Doubled by
    # the global retry alongside shuffle_slack.
    stats_cap_slack: float = 2.0
    # -- execution guardrails ------------------------------------------------
    # validate: in-flight invariant checks: row-count conservation and a
    # packed-word checksum across every exchange, sample sort and
    # rebalance, post-sort monotonicity, category-code range.  All checks
    # are per-rank values that ride in the one report the run gathers
    # anyway: no collective is added and no plan changes.  None defers to
    # $HIFRAMES_VALIDATE (default off).
    validate: Any = None
    # fault_inject: a runtime.faults.FaultPlan with deterministic injection
    # points (force-overflow an op, fail a kernel, poison a stats estimate,
    # corrupt an exchange payload).  None = no injection.
    fault_inject: Any = None
    # retry_scope: "op" escalates only the overflowed capacity site(s) via
    # cap_overrides (fewer retries and smaller buffers on skew); "global"
    # doubles the slack of all four capacity knobs.
    retry_scope: str = "op"
    # {op_id: (cap_floor, bucket_floor)} applied by compute_capacities —
    # written by runtime.retry.RetryPolicy, not by users.
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
        if self.validate is None:
            self.validate = os.environ.get(
                "HIFRAMES_VALIDATE", "0").lower() in ("1", "true", "yes", "on")
        else:
            self.validate = bool(self.validate)
        if self.retry_scope not in ("op", "global"):
            raise ValueError(
                f"retry_scope must be 'op' or 'global', got {self.retry_scope!r}")

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
    """A physical plan bound to its sources: call it to run on this rank.

    A built ``Lowered`` runs again over other tables of the same shape:
    ``__call__(scan_nodes=, externals=)`` rebinds its scans and free arrays
    (the serving session's plan-cache hit, ``runtime/session.py``) without
    planning or building anything.  ``Lowered.built`` counts the objects
    built in this process."""

    built = 0

    def __init__(self, root: ir.Node, cfg: ExecConfig, dists: dict[int, str],
                 pplan: pp.PhysicalPlan):
        with _BUILT_LOCK:
            Lowered.built += 1
        self.root = root
        self.cfg = cfg
        self.dists = dists
        self.pplan = pplan
        self.device = cfg.torch_device()
        fault = cfg.fault_inject
        self.kernels = kreg.KernelSet(self.device.type, _kernel_wrap(fault))
        self.P = cfg.nshards()
        self.rank = dist.get_rank() if self.P > 1 else 0
        self.events: list = []   # degradation events the RetryPolicy reads
        for op in pplan.ops:
            if not isinstance(op, _EXECUTED):
                raise NotImplementedError(_unsupported(op))
        # per-op failure attribution: the static capacity-site table, one
        # (flag, requirement) pair per site in this order.
        self.sites = _capacity_sites(pplan)
        # fault injection: sites whose overflow flag is forced in this
        # build (one shot spent per build) and exchanges to corrupt
        self.forced = (fault.take_overflow_sites(pplan.ops)
                       if fault is not None else frozenset())
        self.corrupt = (fault.corrupt_sites(pplan.ops, cfg.packed_exchange)
                        if fault is not None else frozenset())
        # ExecConfig.validate: the static check tables.  A flag check gives
        # one per-rank bool, a pair check (in, out) values summed over the
        # ranks on the host.
        self.val_flags_meta: list[tuple[str, int, str]] = []
        self.val_pairs_meta: list[tuple[str, int, str]] = []
        if cfg.validate:
            for op in pplan.ops:
                if isinstance(op, (pp.HashExchange, pp.SampleSort,
                                   pp.RebalanceOp)):
                    self.val_pairs_meta.append(
                        ("rowcount", op.op_id, type(op).__name__))
                    self.val_pairs_meta.append(
                        ("checksum", op.op_id, type(op).__name__))
                if isinstance(op, pp.LocalSort):
                    self.val_flags_meta.append(
                        ("monotonic", op.op_id, op.keys[0]))
                elif isinstance(op, pp.SampleSort):
                    self.val_flags_meta.append(
                        ("monotonic", op.op_id, op.node.by[0]))
            for c, dt in root.schema.items():
                if is_category(dt):
                    self.val_flags_meta.append(
                        ("code_range", pplan.root_id, c))
        # the optimized plan's scans, in topological order (a plan-cache
        # hit maps the query's scans onto them by position)
        self.scans = [n for n in ir.topo_order(root) if isinstance(n, ir.Scan)]
        # op id -> the external arrays its expressions read; a run feeds
        # each op this rank's shard of each array, made once per (tag,
        # rows, REP) in that run only, so an array that a rebind replaced
        # never hands out a shard
        self.exts = _op_externals(pplan)
        self._run_exts: dict[str, Any] = {}
        self._ext_shards: dict[tuple, torch.Tensor] = {}

    def _env(self, op: pp.POp, cols: dict) -> dict:
        """The columns an op's expressions read, with this rank's rows of
        every external array they hold under ``"ext:<tag>"``: the array
        padded with zeros to ``P * cap`` (``cap`` the rows of the op's input
        shard), rank r taking ``[r * cap, (r + 1) * cap)`` as a scan's
        shards do (a REP input takes the first ``cap``).  A host array goes
        to the device from pinned memory without blocking; a tensor on the
        device is copied there, never through the host."""
        tags = self.exts.get(op.op_id)
        if not tags:
            return cols
        cap = next(iter(cols.values())).shape[0]
        rep = op.dist == D.REP
        P, rank = (1, 0) if rep else (self.P, self.rank)
        env = dict(cols)
        for tag in tags:
            key = (tag, cap, rep)
            t = self._ext_shards.get(key)
            if t is None:
                a = ext_tensor(self._run_exts[tag])
                if a.dim() != 1 or a.shape[0] > P * cap:
                    raise ValueError(
                        f"external array {tag} of shape {tuple(a.shape)} does "
                        f"not fit the {P} x {cap} rows it aligns with")
                lo = min(rank * cap, a.shape[0])
                hi = min(lo + cap, a.shape[0])
                piece = a[lo:hi]
                if self.device.type == "cuda" and not piece.is_cuda:
                    piece = piece.pin_memory()
                t = torch.zeros(cap, dtype=a.dtype, device=self.device)
                t[: hi - lo].copy_(piece, non_blocking=True)
                self._ext_shards[key] = t
            env["ext:" + tag] = t
        return env

    def _on_device(self, op: pp.Source) -> bool:
        """Does this Source take a persisted device shard by identity (its
        layout re-enters at this shard count and it is not forced to
        REP)?  Else it reads a host table."""
        lay = op.node.layout
        return lay is not None and lay.device_valid(self.P) \
            and op.dist != D.REP

    def _source(self, op: pp.Source, sub: ir.Scan | None = None):
        """This rank's rows of a scan and their count, read from ``sub``
        (a rebound scan of the same shape, see :meth:`_substitutes`) in
        place of ``op.node`` when it is given.

        A persisted scan whose layout re-enters at this shard count (and
        is not forced to REP) hands over this rank's device shard by
        identity, with its count from the layout's (P,) counts: no host
        copy, no re-pad.  Any other scan is a host table (a persisted one
        first gathers its valid prefixes, ``ScanLayout.gather_host``) and
        this rank takes its block, padded to the op's capacity."""
        dev = self.device
        n = op.node if sub is None else sub
        lay = n.layout
        names = list(op.node.columns)
        if self._on_device(op):
            cap = int(lay.capacity)
            cols = {c: _shard(n.columns[c], cap, self.rank).to(dev)
                    for c in names}
            return cols, torch.tensor(int(lay.counts[self.rank]),
                                      dtype=torch.int32, device=dev)
        cols = {c: _host(n.columns[c]) for c in names}
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

    def _substitutes(self, scan_nodes) -> dict[int, ir.Scan]:
        """Check a rebind ``{str(scan.id): substitute}`` of this plan's
        scans and key it by scan id.  The plan's capacities were planned
        from its own sources, so a substitute must fit them: one of a
        persisted device scan is persisted at this shard count with the
        same capacity; one of a host scan has the same row count.  Either
        holds every column the plan reads, with the same dtypes."""
        if not scan_nodes:
            return {}
        ops = {op.node.id: op for op in self.pplan.ops
               if isinstance(op, pp.Source)}
        by_key = {str(s.id): s for s in self.scans}
        unknown = sorted(set(scan_nodes) - set(by_key))
        if unknown:
            raise ValueError(f"scan rebind: this plan has no scan {unknown} "
                             f"(its scans: {sorted(by_key)})")
        subs = {}
        for key, sub in scan_nodes.items():
            s = by_key[key]
            missing = [c for c in s.columns if c not in sub.columns]
            if missing:
                raise ValueError(f"scan rebind for {s.name!r}: substitute "
                                 f"lacks columns {missing}")
            bad = [c for c in s.columns if sub.schema[c] != s.schema[c]]
            if bad:
                raise ValueError(f"scan rebind for {s.name!r}: columns {bad} "
                                 "differ in dtype")
            lay, slay = s.layout, sub.layout
            if self._on_device(ops[s.id]):
                if (slay is None or not slay.device_valid(self.P)
                        or int(slay.capacity) != int(lay.capacity)):
                    got = None if slay is None else (slay.nshards,
                                                     slay.capacity)
                    raise ValueError(
                        f"scan rebind for {s.name!r}: substitute must be "
                        f"persisted at P={self.P} with capacity "
                        f"{lay.capacity} (got {got})")
            elif pp.scan_rows(sub) != pp.scan_rows(s):
                raise ValueError(
                    f"scan rebind for {s.name!r}: substitute has "
                    f"{pp.scan_rows(sub)} rows, the plan's capacities were "
                    f"planned for {pp.scan_rows(s)}")
            subs[s.id] = sub
        return subs

    def _externals(self, rebind) -> dict[str, Any]:
        """Every free array of the plan by tag, with ``rebind``'s arrays
        (``{tag: array}``) in place of the ones the plan was built with.
        A substitute has the same shape and dtype as the array it
        replaces."""
        arrays = {tag: a for tags in self.exts.values()
                  for tag, a in tags.items()}
        for tag, a in (rebind or {}).items():
            if tag not in arrays:
                raise ValueError(f"external rebind: this plan has no free "
                                 f"array {tag} (it has {sorted(arrays)})")
            old = arrays[tag]
            if (tuple(a.shape) != tuple(old.shape)
                    or ext_dtype(a) != ext_dtype(old)):
                raise ValueError(
                    f"external rebind of {tag}: {tuple(a.shape)} "
                    f"{ext_dtype(a)} does not fit the plan's "
                    f"{tuple(old.shape)} {ext_dtype(old)}")
            arrays[tag] = a
        return arrays

    def __call__(self, gather: bool = True, *, scan_nodes=None,
                 externals=None) -> DTable:
        """Run the plan on this rank.  With ``gather`` (the default) the
        result's columns hold every rank's shard, as ``collect()`` returns
        them; without it they hold this rank's own ``(capacity,)`` shard
        (``DTable.shard``), as ``persist()`` keeps them.  The counts and
        the overflow report are gathered either way, and the report is
        read back to the host once.

        ``scan_nodes`` (``{str(scan.id): ir.Scan}``) runs the plan over
        other tables of the same shape in place of its scans, and
        ``externals`` (``{tag: array}``) over other free arrays in place of
        its own; both are checked first (``ValueError``)."""
        subs = self._substitutes(scan_nodes)
        self._run_exts = self._externals(externals)
        self._ext_shards = {}
        pplan, kernels, P = self.pplan, self.kernels, self.P
        packed = self.cfg.packed_exchange
        validate = self.cfg.validate
        env: dict[int, tuple[dict, Any]] = {}
        flags: list[torch.Tensor] = []
        reqs: list[torch.Tensor] = []
        vflags: list[torch.Tensor] = []
        vpairs: list[torch.Tensor] = []

        def flag(op, ovf, req):
            """One capacity site: its overflow flag (forced when a fault
            is injected there) and this rank's requirement (rows)."""
            ovf = torch.as_tensor(ovf, device=self.device).reshape(())
            if op.op_id in self.forced:
                ovf = torch.ones_like(ovf)
            flags.append(ovf)
            reqs.append(torch.as_tensor(req, device=self.device)
                        .to(torch.float32).reshape(()))

        def pre_exchange(cols, cnt):
            return (cnt, _checksum_u32(cols, cnt)) if validate else None

        def post_exchange(op, pre, out, cnt2):
            if op.op_id in self.corrupt:
                # deterministic payload corruption: bump row 0 of the first
                # non-bool column on every rank with rows
                name = next((k for k in sorted(out)
                             if out[k].dtype != torch.bool), None)
                if name is not None:
                    v = out[name].clone()
                    v[0] += (cnt2 > 0).to(v.dtype)
                    out = dict(out)
                    out[name] = v
            if validate:
                vpairs.extend((pre[0], cnt2, pre[1], _checksum_u32(out, cnt2)))
            return out

        for op in pplan.ops:
            n = op.node
            if isinstance(op, pp.Source):
                res = self._source(op, subs.get(n.id))

            elif isinstance(op, pp.Compact):
                cols, cnt = env[op.inputs[0]]
                cap = next(iter(cols.values())).shape[0]
                keep = evaluate(n.pred, self._env(op, cols)) \
                    & phys.valid_mask(cnt, cap)
                keep = keep.expand(cap)
                out, cnt2, ovf = phys.compact(cols, keep, op.cap, kernels=kernels)
                flag(op, ovf, keep.sum())
                res = (out, cnt2)

            elif isinstance(op, pp.Map):
                cols, cnt = env[op.inputs[0]]
                cap = next(iter(cols.values())).shape[0]
                cache: dict = {}
                env_e = self._env(op, cols)
                out = {name: _full(evaluate(e, env_e, cache), cap)
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
                pre = pre_exchange(cols, cnt)
                out, cnt2, ovf = phys.exchange(
                    cols, cnt, dest, P=P, bucket_cap=op.bucket,
                    cap_out=op.cap, kernels=kernels, packed=packed)
                flag(op, ovf, hist.max())
                res = (post_exchange(op, pre, out, cnt2), cnt2)

            elif isinstance(op, pp.LocalSort):
                cols, cnt = env[op.inputs[0]]
                out, _ = phys.local_sort(cols, cnt, op.keys)
                if validate:
                    vflags.append(_mono_violation(out[op.keys[0]], cnt))
                res = (out, cnt)

            elif isinstance(op, pp.MergeJoin):
                lcols, lcnt = env[op.inputs[0]]
                rcols, rcnt = env[op.inputs[1]]
                lon, ron = n.left_on, n.right_on
                if op.salted:
                    # join on keys + salt: each (probe, build) key match
                    # agrees on exactly one salt (see pp.SaltOp)
                    lon, ron = lon + (phys.SALT_COL,), ron + (phys.SALT_COL,)
                smap = {c: n.right_out_name(c) for c in rcols if c not in ron}
                out, cnt2, ovf = phys.merge_join(
                    lcols, lcnt, rcols, rcnt, lon, ron, cap_out=op.cap,
                    r_suffix_map=smap, how=n.how, null_fill=_join_null_fill(n))
                lf = lcnt.to(torch.float32)
                flag(op, ovf, torch.maximum(lf * rcnt.to(torch.float32), lf))
                out.pop(phys.SALT_COL, None)     # strip the probe's salt
                res = (out, cnt2)

            elif isinstance(op, pp.SaltOp):
                cols, cnt = env[op.inputs[0]]
                if op.build:
                    out, cnt2, ovf = phys.salt_build(
                        cols, cnt, op.keys, op.hot, op.R, cap_out=op.cap,
                        kernels=kernels)
                    flag(op, ovf, float(op.R) * cnt.to(torch.float32))
                    res = (out, cnt2)
                else:
                    res = phys.salt_probe(cols, cnt, op.keys, op.hot, op.R)

            elif isinstance(op, pp.AggPrep):
                cols, cnt = env[op.inputs[0]]
                cache = {}
                env_e = self._env(op, cols)
                key0 = cols[n.key[0]]
                out = {k: cols[k] for k in n.key}
                for name, agg in n.aggs.items():
                    arr = (evaluate(agg.expr, env_e, cache)
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
                flag(op, ovf, _distinct_runs(keys, cnt))
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
                flag(op, ovf, _distinct_runs(keys, cnt))
                res = (_restore_key_names(out, n.key), n_seg)

            elif isinstance(op, pp.SampleSort):
                cols, cnt = env[op.inputs[0]]
                pre = pre_exchange(cols, cnt)
                out, cnt2, ovf = phys.sample_sort(
                    cols, cnt, n.by, P=1 if op.dist == D.REP else P,
                    bucket_cap=op.bucket, cap_out=op.cap,
                    ascending=n.ascending, pre_sorted=op.pre_sorted,
                    kernels=kernels, packed=packed)
                flag(op, ovf, cnt)
                out = post_exchange(op, pre, out, cnt2)
                if validate:
                    vflags.append(_mono_violation(out[n.by[0]], cnt2,
                                                  ascending=n.ascending))
                res = (out, cnt2)

            elif isinstance(op, pp.LimitOp):
                cols, cnt = env[op.inputs[0]]
                res = phys.limit(cols, cnt, n.n, 1 if op.dist == D.REP else P,
                                 cap_out=op.cap,
                                 method=self.cfg.exscan_method)

            elif isinstance(op, pp.RebalanceOp):
                cols, cnt = env[op.inputs[0]]
                pre = pre_exchange(cols, cnt)
                out, cnt2, ovf = phys.rebalance(
                    cols, cnt, P=P, bucket_cap=op.bucket, cap_out=op.cap,
                    kernels=kernels, packed=packed)
                flag(op, ovf, cnt)
                res = (post_exchange(op, pre, out, cnt2), cnt2)

            elif isinstance(op, pp.ConcatOp):
                parts = [env[i] for i in op.inputs]
                out, cnt2, ovf = phys.concat(parts, op.cap, kernels=kernels)
                flag(op, ovf, functools.reduce(
                    torch.add, [c.to(torch.float32) for _, c in parts]))
                res = (out, cnt2)

            else:
                raise NotImplementedError(_unsupported(op))
            env[op.op_id] = res

        cols, cnt = env[pplan.root_id]
        for kind, _op_id, name in self.val_flags_meta:
            if kind == "code_range":
                c = cols[name]
                n_codes = len(categories_of(self.root.schema[name]))
                vflags.append(torch.any(phys.valid_mask(cnt, c.shape[0])
                                        & ((c < NULL_CODE) | (c >= n_codes))))
        assert len(flags) == len(self.sites), (len(flags), self.sites)
        assert len(vflags) == len(self.val_flags_meta)
        assert len(vpairs) == 2 * len(self.val_pairs_meta)
        cap = pplan.root_op.cap
        cols = {k: cols[k] for k in self.root.schema}
        # one float64 vector per rank: site flags, site requirements, check
        # flags and check pairs (counts and checksums below 2^32 are exact)
        report = torch.stack([
            torch.as_tensor(v, device=self.device).reshape(())
            .to(torch.float64) for v in flags + reqs + vflags + vpairs]) \
            if flags or vflags or vpairs \
            else torch.zeros(0, dtype=torch.float64, device=self.device)
        counts = cnt.reshape(1)
        if P > 1:
            if gather:
                cols = {k: phys.all_gather_rows(v, P) for k, v in cols.items()}
            counts = phys.all_gather_rows(counts, P)
            report = phys.all_gather_rows(report, P)
        # the one read back to the host
        report = report.cpu().numpy().reshape(P, -1)
        nsite, nflag = len(self.sites), len(self.val_flags_meta)
        fl = report[:, :nsite] != 0
        overflow_ops = self._attribute_overflow(
            fl, report[:, nsite:2 * nsite].astype(np.float32))
        checks = report[:, 2 * nsite:]
        failures = self._check_invariants(
            checks[:, :nflag] != 0,
            checks[:, nflag:].reshape(P, -1, 2).astype(np.uint64),
            overflow_ops)
        return DTable(columns=cols, counts=counts, capacity=cap, nshards=P,
                      dist=self.dists[self.root.id], overflow=bool(fl.any()),
                      overflow_ops=overflow_ops, invariant_failures=failures,
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
        x = (_full(evaluate(n.expr, self._env(op, cols)), cap)
             if n.expr is not None else None)
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

    def _check_invariants(self, vflags: np.ndarray, vpairs: np.ndarray,
                          overflow_ops: dict) -> tuple:
        """Reduce the ExecConfig.validate checks of every rank: a flag
        fails on any rank, a pair when its sums over the ranks differ
        (checksums mod 2^32).  Pairs at an overflowed op are skipped: rows
        clamped there break conservation legitimately."""
        fails: list[err.InvariantFailure] = []
        for i, (kind, op_id, detail) in enumerate(self.val_flags_meta):
            if vflags[:, i].any():
                fails.append(err.InvariantFailure(kind, op_id, detail))
        for i, (kind, op_id, detail) in enumerate(self.val_pairs_meta):
            if op_id in overflow_ops:
                continue
            a, b = int(vpairs[:, i, 0].sum()), int(vpairs[:, i, 1].sum())
            if kind == "checksum":
                a &= phys.M32
                b &= phys.M32
            if a != b:
                fails.append(err.InvariantFailure(
                    kind, op_id, f"{detail}: in={a} out={b}"))
        return tuple(fails)


_BUILT_LOCK = threading.Lock()

# the physical ops this executor runs: every op the planner emits
_EXECUTED = (pp.Source, pp.Compact, pp.Map, pp.WindowOp, pp.HashExchange,
             pp.LocalSort, pp.MergeJoin, pp.SaltOp, pp.AggPrep, pp.PartialAgg,
             pp.SegmentAgg, pp.SampleSort, pp.LimitOp, pp.RebalanceOp,
             pp.ConcatOp)


def _unsupported(op: pp.POp) -> str:
    return (f"{type(op).__name__} is not a physical op this executor runs "
            "(it runs " + ", ".join(t.__name__ for t in _EXECUTED) + ")")


def _kernel_wrap(fault):
    """KernelSet ``wrap`` hook: an injected ``FaultPlan.fail_kernel`` on a
    matching mode raises KernelBackendError; a CUDA kernel that fails (to
    build or to launch) is re-raised as one.  Nothing catches it to run the
    plain version instead: a kernel has no lower rung."""
    def wrap(name, mode, fn):
        injected = fault is not None and fault.kernel_fails(name, mode)
        if mode == "plain" and not injected:
            return fn

        def call(*a, **k):
            if injected:
                raise err.KernelBackendError(
                    name, mode, "injected fault (FaultPlan.fail_kernel)")
            try:
                return fn(*a, **k)
            except err.HiFramesError:
                raise
            except Exception as e:
                raise err.KernelBackendError(name, mode, e) from e
        return call
    return wrap


def _checksum_u32(cols: dict, cnt) -> torch.Tensor:
    """Order-invariant 32-bit payload checksum of the valid prefix: the
    packed-layout words of every column (a bitcast, so float payload bits
    count exactly), masked to valid rows, summed mod 2^32, the reference's
    uint32 sum.  torch has no uint32 reductions on the card, so the int32
    words sum into int64 (each congruent to its uint32 word mod 2^32) and
    the total is masked; one column's words at a time, never the packed
    matrix.  Exchanges permute rows across ranks, so the sum over the ranks
    is conserved."""
    cap = next(iter(cols.values())).shape[0]
    valid = phys.valid_mask(cnt, cap)[:, None]
    total = torch.zeros((), dtype=torch.int64, device=valid.device)
    for k in sorted(cols):
        total += torch.where(valid, phys.column_words(cols[k]), 0) \
            .sum(dtype=torch.int64)
    return total & phys.M32


def _mono_violation(col, cnt, ascending: bool = True) -> torch.Tensor:
    """True iff an adjacent pair inside the valid prefix is out of order.
    NaN-lenient: comparisons with NaN are False, so null floats never
    flag."""
    cap = col.shape[0]
    if cap < 2:
        return torch.zeros((), dtype=torch.bool, device=col.device)
    pair_valid = phys.valid_mask(cnt, cap)[1:]   # pair (i-1, i) needs i < cnt
    a, b = col[:-1], col[1:]
    bad = (b < a) if ascending else (b > a)
    return torch.any(bad & pair_valid)


def _op_externals(pplan: pp.PhysicalPlan) -> dict[int, dict[str, Any]]:
    """op id -> {tag: array} of the external arrays under the expressions
    of each op that evaluates some (filter, project, window, aggregate
    input).  An array aligns with the rows of its node's child as they
    stand, so an op whose input the planner moved first (the exchange and
    sort under a partitioned window) cannot hold one."""
    out: dict[int, dict[str, Any]] = {}
    for op in pplan.ops:
        n = op.node
        if not isinstance(op, (pp.Compact, pp.Map, pp.WindowOp, pp.AggPrep)):
            continue
        found = {x.tag: x.array for e in ir.node_exprs(n)
                 for x in externals(e)}
        if not found:
            continue
        if pplan.ops[op.inputs[0]] is not pplan.final_op(n.children[0]):
            raise NotImplementedError(
                f"{type(n).__name__} holds external arrays "
                f"{sorted(found)} but reads rows the plan moved first "
                f"({type(pplan.ops[op.inputs[0]]).__name__}); add the array "
                "as a column before the verb")
        out[op.op_id] = found
    return out


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
    retry at that size heals; "double" sites (join and salt expansion)
    escalate geometrically instead.
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
        elif isinstance(op, pp.SaltOp):
            if op.build:
                sites.append((op.op_id, "salt", "max", "double"))
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
          force_rep: set[int] = frozenset(),
          collect_block: bool = False) -> tuple[Lowered, dict]:
    """optimize -> infer distributions -> plan physical ops (exchange/sort
    elision) -> plan capacities -> bind the executor.  ``force_rep``: node
    ids the caller pins to REP (``DataFrame.replicate``); ``collect_block``
    rebalances a 1D_VAR result to 1D_BLOCK (``collect_matrix``).  Under
    ``cfg.adaptive_stats`` the sampled statistics pass feeds the planner;
    when it fails, planning degrades to the static rules and the returned
    executor's ``events`` say so."""
    from . import optimizer as opt

    cfg = cfg or ExecConfig()
    stats: dict = {}
    if cfg.optimize_plan:
        root, stats = opt.optimize(root, keep)
    info = D.infer(root, force_rep=force_rep,
                   broadcast_join=cfg.broadcast_join)
    root = D.insert_rebalance(root, info, collect_block=collect_block)
    source_rows = {n.id: pp.scan_rows(n)
                   for n in ir.topo_order(root) if isinstance(n, ir.Scan)}
    sctx = None
    events: list = []
    if cfg.adaptive_stats:
        from . import stats as st
        try:
            sctx = st.analyze(root, cfg)
        except st.ShardSampleError:
            raise                  # the other ranks wait in its all_gather
        except Exception as e:     # degradation: adaptive -> static
            events.append({"kind": "degrade_stats",
                           "detail": f"adaptive -> static planning: {e}"})
    pplan = pp.plan_physical(root, info.dists, cfg, stats=sctx)
    pp.plan_capacities(pplan, cfg.nshards(), cfg, source_rows)
    lowered = Lowered(root, cfg, info.dists, pplan)
    lowered.events.extend(events)
    return lowered, stats


def execute(root: ir.Node, cfg: ExecConfig, keep: set[str] | None = None,
            force_rep: set[int] = frozenset(), gather: bool = True,
            collect_block: bool = False) -> tuple[Lowered, DTable]:
    """Lower and run under the retry policy (runtime/retry.py): per-op
    capacity escalation from the overflow attribution
    (``cfg.retry_scope="global"`` doubles the slack instead), the
    packed-exchange and stats degradations, and the structured event log
    on the returned table (``.events``) and in the per-fingerprint store
    ``explain()`` renders.  The table comes back overflow-flagged when the
    ``cfg.auto_retry`` retries run out.  Under ``adaptive_stats`` the run's
    per-rank counts (or an exhausted aggregate's requirement) feed the
    realized-stats store.  ``gather=False`` returns this rank's own shard
    (``Lowered.__call__``); ``collect_block`` is :func:`lower`'s."""
    from ..runtime import retry as rt

    policy = rt.RetryPolicy(max_retries=max(cfg.auto_retry, 0),
                            scope=cfg.retry_scope)

    def run_once(c):
        lowered, _ = lower(root, c, keep, force_rep, collect_block)
        return lowered, lowered(gather)

    lowered, t, events, cfg = policy.execute(run_once, cfg)
    if events:
        rt.record_events(lowered.root, events)
    if cfg.adaptive_stats:
        from . import stats as st
        if not t.overflow:
            # a repeated run of this plan sizes PartialAgg from the true
            # group count and salts more eagerly if skew materialized
            st.record_realized(lowered.root, t.counts.cpu().numpy())
        else:
            # the failure's observed requirement sizes the next run
            for op_id, rec in t.overflow_ops.items():
                if rec["kind"] in ("partial_agg", "segment_agg"):
                    st.record_failure(lowered.pplan.ops[op_id].node,
                                      rec["req_shards"])
    return lowered, t
