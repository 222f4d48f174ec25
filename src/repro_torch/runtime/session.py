"""Multi-query serving: a long-lived Session on one rank of one card.

A one-shot ``collect()`` plans, lowers and runs one query.  A serving
deployment amortizes planning and table ingest across a query mix instead.
A :class:`Session` provides:

  * **Shared-table registry** — ``session.register("item", df)`` persists
    the frame once (device shards + layout claims) and hands every later
    query the SAME layout-carrying scan via ``session.table("item")``.
    Frames persisted at another shard count re-enter through
    :func:`~repro_torch.runtime.reshard.reshard`: an on-device split or
    merge, never a host gather.
  * **Plan cache** — built :class:`~repro_torch.core.lower.Lowered` plans
    keyed by the *shape* plan fingerprint (``stats.plan_fingerprint(node,
    scans="shape")``: structure + dictionary-aware schemas + layout
    geometry, NO table identity), the ExecConfig signature, the REP pins
    and the identity of the functions (UDFs) and constant arrays the
    expressions hold.  A hit reruns the cached plan and **rebinds** the
    query's scans and free arrays (``Lowered(scan_nodes=, externals=)``),
    so the same query shape over another registered table plans nothing
    and builds nothing: 0 re-plans and 0 re-lowers.  LRU eviction at
    ``cache_capacity``; hit/miss/eviction counters via :meth:`stats`.
  * **Concurrent admission** — ``submit()`` is thread-safe and returns a
    future; a small worker pool runs the queries, device execution
    serializes on one lock, ``admission`` bounds the queries queued or in
    flight, and each finished table carries a :class:`QueryRecord`
    (timings, cache outcome, retry events, the plan's collective count).
  * **Stats persistence** — the session scopes its own
    :class:`~repro_torch.core.stats.StatsStore` (realized row counts +
    retry events) and persists it as ``<session_dir>/stats.json``, so a
    restarted server plans with yesterday's feedback.  A corrupt sidecar
    raises :class:`~repro_torch.core.errors.StatsError` unless
    ``recover_stats=True`` quarantines it and starts cold.

Where the reference (one process over a device mesh) and this package (one
process a rank, ``torch.distributed``) differ, the session departs:

  * **An explicit card per thread.**  The CUDA current device belongs to
    each host thread, so the session resolves ``"cuda"`` to
    ``"cuda:<torch.cuda.current_device()>"`` at construction (and in every
    query's ExecConfig), and its worker pool sets that device in every
    worker (``initializer=``).  Otherwise, on a host with more than one
    card, rank r's queries would run on card 0.
  * **One order on every rank.**  ``P`` is ``cfg.nshards()``, the world
    size; at P > 1 every rank runs its own Session, and the queries are
    submitted in the same order on every rank, but the worker pool may
    start them in any order.  So every step that can reach a collective
    runs in submission order, under a ticket each rank takes when a query
    is submitted (or a table registered, or a plan explained): the cache
    lookup, the planning of a miss (``adaptive_stats`` samples a persisted
    shard with an ``all_gather``), the execution and the cache insertion,
    ``register``'s reshard and persist.  Every rank then hits or misses
    alike and issues the same collectives in the same order.  Only the
    fingerprinting, collective-free host planning, runs ahead.  At P = 1
    there is no ticket: lookups and planning overlap and only execution
    serializes, as in the reference.
  * **The sidecar.**  ``StatsStore.save`` writes ``<path>.tmp`` and renames
    it, so at P > 1 only rank 0 writes ``stats.json``; every rank loads it
    (a barrier after the load, before rank 0 may quarantine a corrupt one,
    and one after the last save in :meth:`close`).  The stores stay equal
    on every rank: each records the same gathered counts.  Recording into
    the store and saving it hold one lock: concurrent misses at P = 1
    would otherwise rename each other's ``.tmp`` away.
  * **``explain`` keys the cache as queries do** (positional REP pins).

Failure behaviour: a cache hit whose rebind is refused (``ValueError``),
that raises ``KernelBackendError`` or ``PlanInvariantError``, or that comes
back with ``overflow`` or ``invariant_failures`` (the cached capacities
were sized for a smaller table) falls back to the miss path
(``hit_fallback``): a full replan under the retry policy, and the
refreshed entry replaces the stale one.  On the miss path a
``KernelBackendError`` raises: a kernel has no lower rung.
"""
from __future__ import annotations

import contextlib
import dataclasses as _dc
import os
import threading
import time
from collections import OrderedDict
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist

from ..core import errors as err
from ..core import ir
from ..core import stats as _st
from ..core.api import DataFrame
from ..core.expr import UDF, Const, ExternalArray
from ..core.lower import ExecConfig, Lowered, lower
from . import retry as _rt
from .reshard import reshard as _reshard

_MONO = time.monotonic


def cfg_signature(cfg: ExecConfig, P: int) -> tuple:
    """Hashable signature of every ExecConfig field (the device included)
    and the shard count ``P``.  Dict levers (cap_overrides) canonicalize to
    sorted tuples; other objects (a FaultPlan) to their repr."""
    parts: list = [("P", P)]
    for f in _dc.fields(cfg):
        v = getattr(cfg, f.name)
        if isinstance(v, dict):
            v = tuple(sorted(v.items()))
        elif isinstance(v, (list, set)):
            v = tuple(sorted(v))
        elif not isinstance(v, (str, int, float, bool, tuple, type(None))):
            v = repr(v)
        parts.append((f.name, v))
    return tuple(parts)


@dataclass
class QueryRecord:
    """Per-query serving record (on the table :meth:`Session.collect`
    returns, ``DTable.query_record``, and listed by :meth:`Session.stats`)."""

    qid: int
    fingerprint: str
    cache: str = "miss"             # "hit" | "miss" | "hit_fallback"
    plan_s: float = 0.0             # host-side planning + lowering
    exec_s: float = 0.0             # execution, holding the lock (no wait)
    collectives: int = 0            # plan's all_to_all count per execution
    compiles: int = 0               # Lowered plans this query built (0: hit)
    events: tuple = ()


@dataclass
class _CacheEntry:
    lowered: Lowered
    scan_ids: tuple                 # pre-optimization scan ids, topo order
    rebindable: bool                # post-opt scans map 1:1 onto pre-opt
    ext_tags: tuple = ()            # pre-optimization free arrays, in order


class PlanCache:
    """LRU map: (shape fingerprint, ExecConfig signature, ...) -> plan."""

    def __init__(self, capacity: int = 64):
        self.capacity = int(capacity)
        self._d: OrderedDict = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self._lock = threading.Lock()

    def get(self, key) -> Optional[_CacheEntry]:
        with self._lock:
            e = self._d.get(key)
            if e is None:
                self.misses += 1
                return None
            self._d.move_to_end(key)
            self.hits += 1
            return e

    def put(self, key, entry: _CacheEntry) -> None:
        with self._lock:
            self._d[key] = entry
            self._d.move_to_end(key)
            while len(self._d) > self.capacity:
                self._d.popitem(last=False)
                self.evictions += 1

    def __contains__(self, key) -> bool:
        with self._lock:
            return key in self._d

    def __len__(self) -> int:
        return len(self._d)


def _topo_scans(node: ir.Node) -> list[ir.Scan]:
    return [n for n in ir.topo_order(node) if isinstance(n, ir.Scan)]


def _leaves(node: ir.Node):
    """Every expression leaf under the plan's nodes, in a fixed order."""
    for n in ir.topo_order(node):
        for e in ir.node_exprs(n):
            stack = [e]
            while stack:
                x = stack.pop()
                yield x
                stack.extend(x.children)


def _topo_externals(node: ir.Node) -> list[ExternalArray]:
    return [x for x in _leaves(node) if isinstance(x, ExternalArray)]


def _opaque_key(node: ir.Node) -> tuple:
    """The identities of what the shape fingerprint sees only by its type:
    the functions of UDFs and the arrays of array constants.  A cached plan
    holds them, so a query holding others must not hit it."""
    out = []
    for x in _leaves(node):
        if isinstance(x, UDF):
            out.append(("udf", id(x.fn)))
        elif isinstance(x, Const) and getattr(x.value, "ndim", 0) > 0:
            out.append(("arr", id(x.value)))
    return tuple(out)


class Session:
    """A long-lived serving session on this rank (docs/serving.md).

    >>> sess = Session(cfg)
    >>> sess.register("item", item_df)          # persist once
    >>> t = sess.collect(q26(sess.table("store_sales"), sess.table("item")))
    >>> sess.stats()["plan_cache"]["hits"]
    """

    def __init__(self, cfg: ExecConfig | None = None,
                 session_dir: str | None = None, *,
                 cache_capacity: int = 64, admission: int = 8,
                 workers: int = 4, recover_stats: bool = False):
        cfg = cfg or ExecConfig()
        dev = torch.device(cfg.device)
        self._card = None if dev.type != "cuda" else (
            torch.cuda.current_device() if dev.index is None else dev.index)
        self.cfg = self._resolve(cfg)
        self.P = self.cfg.nshards()
        self.rank = dist.get_rank() if self.P > 1 else 0
        self.session_dir = session_dir
        self._sidecar = None
        if session_dir:
            os.makedirs(session_dir, exist_ok=True)
            self._sidecar = os.path.join(session_dir, "stats.json")
        self.store = self._load_store(recover_stats)
        # the session's store becomes the process-current store for its
        # lifetime (module-level record_realized/record_events land in it
        # from any worker thread); close() restores the previous one.
        self._prev_store = _st.use_store(self.store)
        self.plan_cache = PlanCache(cache_capacity)
        self._tables: dict[str, DataFrame] = {}
        self._tables_lock = threading.Lock()
        self._exec_lock = threading.Lock()
        # the store's writers: concurrent misses record into it and save
        # it through one ``<path>.tmp``
        self._store_lock = threading.RLock()
        self._admit = threading.BoundedSemaphore(max(admission, 1))
        card = self.cfg.torch_device()
        self._pool = ThreadPoolExecutor(
            max_workers=max(workers, 1), thread_name_prefix="hf-serve",
            **({"initializer": torch.cuda.set_device, "initargs": (card,)}
               if card.type == "cuda" else {}))
        self._records: list[QueryRecord] = []
        self._records_lock = threading.Lock()
        self._qid = 0
        self._turns = threading.Condition()
        self._tickets = 0               # taken, in submission order
        self._serving = 0               # the ticket whose turn it is
        self._register_collectives = 0
        self._closed = False

    def _resolve(self, cfg: ExecConfig | None) -> ExecConfig:
        """``cfg`` (default: the session's) with ``"cuda"`` pinned to the
        session's card."""
        cfg = cfg or self.cfg
        dev = torch.device(cfg.device)
        if dev.type == "cuda" and dev.index is None:
            cfg = _dc.replace(cfg, device=f"cuda:{self._card}")
        return cfg

    # -- one order on every rank ---------------------------------------------

    def _take_ticket(self) -> int:
        with self._turns:
            self._tickets += 1
            return self._tickets - 1

    @contextlib.contextmanager
    def _turn(self, ticket: int):
        """Run the block when every earlier ticket has run (at P > 1; at
        P = 1 at once).  The turn passes on however the block ends."""
        if self.P == 1:
            yield
            return
        with self._turns:
            self._turns.wait_for(lambda: self._serving == ticket)
        try:
            yield
        finally:
            with self._turns:
                self._serving += 1
                self._turns.notify_all()

    def _barrier(self) -> None:
        if self.P > 1:
            dist.barrier()

    # -- lifecycle -----------------------------------------------------------

    def _load_store(self, recover: bool) -> _st.StatsStore:
        store, bad = _st.StatsStore(), None
        if self._sidecar and os.path.exists(self._sidecar):
            try:
                store = _st.StatsStore.load(self._sidecar)
            except err.StatsError as e:
                bad = e
        self._barrier()          # every rank has read it before it moves
        if bad is not None:
            if not recover:
                raise bad
            # quarantine the corrupt sidecar (keep it for inspection) and
            # start cold — recover_stats is the operator's explicit opt-in.
            if self.rank == 0:
                os.replace(self._sidecar, self._sidecar + ".corrupt")
        return store

    def save_stats(self) -> None:
        if self._sidecar and self.rank == 0:
            with self._store_lock:
                self.store.save(self._sidecar)

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._pool.shutdown(wait=True)
        self.save_stats()
        self._barrier()          # the sidecar is whole before any rank goes on
        _st.use_store(self._prev_store)

    def __enter__(self) -> "Session":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- shared-table registry ----------------------------------------------

    def register(self, name: str, df: DataFrame, *,
                 partition_by=None, sort_by=None) -> DataFrame:
        """Persist ``df`` once under ``name`` and share its layout-carrying
        scan with every later query.

        ``partition_by``/``sort_by`` request a layout (one on-device
        exchange / local sort) before persisting.  An already-persisted
        frame at another shard count is resharded on device (split or
        merge, never a host gather)."""
        with self._turn(self._take_ticket()):
            node = df.node
            q = df
            if isinstance(node, ir.Scan) and node.layout is not None \
                    and node.layout.counts is not None:
                if node.layout.nshards != self.P:
                    with self._exec_lock:
                        q = _reshard(df, self.P, self.cfg, name=name)
                if partition_by or sort_by:
                    q = self._relayout(q, partition_by, sort_by, name)
            else:
                q = self._relayout(q, partition_by, sort_by, name)
        with self._tables_lock:
            self._tables[name] = q
        return q

    def _relayout(self, df, partition_by, sort_by, name):
        q = df
        if partition_by:
            q = q.repartition(partition_by)
        if sort_by:
            q = q.sort_within_partitions(sort_by)
        with self._exec_lock:
            out, lowered = q._persist(self.cfg, name)
        # registration's collectives are charged to the session, not to
        # the query mix (the serve smoke's pass-1 total)
        self._register_collectives += lowered.pplan.collective_count()
        return out

    def table(self, name: str) -> DataFrame:
        with self._tables_lock:
            if name not in self._tables:
                raise KeyError(
                    f"no table {name!r} registered (have "
                    f"{sorted(self._tables)})")
            return self._tables[name]

    def tables(self) -> dict[str, DataFrame]:
        with self._tables_lock:
            return dict(self._tables)

    # -- query execution -----------------------------------------------------

    def submit(self, df: DataFrame, cfg: ExecConfig | None = None) -> Future:
        """Thread-safe asynchronous admission: returns a Future resolving to
        the DTable.  At most ``admission`` queries are queued or in flight;
        further submits block."""
        if self._closed:
            raise RuntimeError("session is closed")
        cfg = self._resolve(cfg)
        self._admit.acquire()
        qid, ticket = self._next_qid(), self._take_ticket()

        def run():
            try:
                return self._run_query(df, cfg, qid, ticket)
            finally:
                self._admit.release()

        return self._pool.submit(run)

    def collect(self, df: DataFrame, cfg: ExecConfig | None = None):
        """Synchronous execute-through-the-session (admission + cache)."""
        return self.submit(df, cfg).result()

    def _next_qid(self) -> int:
        with self._records_lock:
            self._qid += 1
            return self._qid

    @staticmethod
    def _rep_key(df: DataFrame) -> tuple:
        """Positional REP pins per scan (``df.replicate()`` changes the plan
        without changing the IR structure, so it must key the cache)."""
        rep = df._force_rep()
        return tuple(n.id in rep for n in _topo_scans(df.node))

    def _key(self, df: DataFrame, cfg: ExecConfig) -> tuple:
        """The plan-cache key of ``df`` under ``cfg``: queries and
        :meth:`explain` both read it here."""
        return (_st.plan_fingerprint(df.node, scans="shape"),
                cfg_signature(cfg, self.P), self._rep_key(df),
                _opaque_key(df.node))

    def _run_query(self, df: DataFrame, cfg: ExecConfig, qid: int,
                   ticket: int):
        t0 = _MONO()
        try:
            key = self._key(df, cfg)
        except BaseException:
            with self._turn(ticket):     # pass the turn on in order
                pass
            raise
        key_s = _MONO() - t0
        with self._turn(ticket):
            t0 = _MONO() - key_s         # planning time, not the wait
            rec = QueryRecord(qid=qid, fingerprint=key[0])
            entry = self.plan_cache.get(key)
            t = None
            if entry is not None and entry.rebindable:
                t = self._try_hit(df, entry, rec, t0)
                if t is None:
                    rec.cache = "hit_fallback"
            if t is None:
                t = self._run_miss(df, cfg, key, rec)
            self._finish(rec, t)
            return t

    def _try_hit(self, df: DataFrame, entry: _CacheEntry, rec: QueryRecord,
                 t0: float):
        """Rerun the cached plan over this query's scans and free arrays.
        Returns None when the entry cannot serve this query (the caller
        falls back to the miss path, which replaces the entry)."""
        lowered = entry.lowered
        new_scans = _topo_scans(df.node)
        if len(new_scans) != len(lowered.scans):
            return None
        scan_nodes = {str(s.id): new_scans[i]
                      for i, s in enumerate(lowered.scans)}
        rec.plan_s = _MONO() - t0
        try:
            arrays = self._ext_map(entry, df)
            with self._exec_lock:
                t1 = _MONO()
                t = lowered(scan_nodes=scan_nodes, externals=arrays)
                exec_s = _MONO() - t1
        except (ValueError, err.KernelBackendError, err.PlanInvariantError):
            return None
        if t.overflow or t.invariant_failures:
            # cached capacities were sized for a different table: replan
            return None
        rec.cache = "hit"
        rec.exec_s = exec_s
        rec.collectives = lowered.pplan.collective_count()
        return t

    @staticmethod
    def _ext_map(entry: _CacheEntry, df: DataFrame) -> dict:
        """The cached plan's free-array tags -> this query's arrays, by
        position (the shape fingerprint saw only their shapes)."""
        new = _topo_externals(df.node)
        if len(new) != len(entry.ext_tags):
            raise ValueError("free arrays do not line up with the plan's")
        known = {tag for tags in entry.lowered.exts.values() for tag in tags}
        out: dict = {}
        for tag, x in zip(entry.ext_tags, new):
            if tag in out and out[tag] is not x.array:
                raise ValueError(f"free array {tag} binds two arrays")
            out[tag] = x.array
        return {tag: a for tag, a in out.items() if tag in known}

    def _run_miss(self, df: DataFrame, cfg: ExecConfig, key,
                  rec: QueryRecord):
        """Full plan + retry-ladder execution; caches the survivor."""
        policy = _rt.RetryPolicy(max_retries=max(cfg.auto_retry, 0),
                                 scope=cfg.retry_scope)
        timings = {"plan": 0.0, "exec": 0.0, "built": 0}

        def run_once(c):
            ta = _MONO()
            lowered, _ = lower(df.node, c, force_rep=df._force_rep())
            timings["plan"] += _MONO() - ta
            timings["built"] += 1
            with self._exec_lock:
                tb = _MONO()
                t = lowered()
                timings["exec"] += _MONO() - tb
            return lowered, t

        lowered, t, events, cfg2 = policy.execute(run_once, cfg)
        with self._store_lock:
            if events:
                _rt.record_events(lowered.root, events)
            if cfg2.adaptive_stats and not t.overflow:
                _st.record_realized(lowered.root, t.counts.cpu().numpy())
            self.save_stats()
        rec.plan_s = timings["plan"]
        rec.exec_s = timings["exec"]
        rec.collectives = lowered.pplan.collective_count()
        rec.compiles = timings["built"]
        rec.events = tuple(events)
        if not t.overflow:
            self.plan_cache.put(key, self._make_entry(df, lowered))
        return t

    def _make_entry(self, df: DataFrame, lowered: Lowered) -> _CacheEntry:
        # ``lowered.scans`` is the optimized plan's scans in topo order; the
        # optimizer rewrites scan NODES (column pruning mints new ids) but
        # preserves count and relative order, so a later query with the same
        # shape fingerprint maps its scans onto the cached ones positionally.
        # A plan whose optimization dropped or duplicated scans is cached
        # but not rebindable (hits would mis-wire tables: treat as miss).
        pre_ids = tuple(s.id for s in _topo_scans(df.node))
        post_ids = [s.id for s in lowered.scans]
        rebindable = len(post_ids) == len(pre_ids) == len(set(post_ids))
        return _CacheEntry(lowered, pre_ids, rebindable,
                           tuple(x.tag for x in _topo_externals(df.node)))

    def _finish(self, rec: QueryRecord, t) -> None:
        rec.events = rec.events or tuple(getattr(t, "events", ()) or ())
        t.query_record = rec
        with self._records_lock:
            self._records.append(rec)

    # -- introspection -------------------------------------------------------

    def stats(self) -> dict:
        with self._records_lock:
            recs = list(self._records)
        pc = self.plan_cache
        return {
            "P": self.P,
            "queries": len(recs),
            "plan_cache": {"hits": pc.hits, "misses": pc.misses,
                           "evictions": pc.evictions, "size": len(pc),
                           "capacity": pc.capacity},
            "compiles": sum(r.compiles for r in recs),
            "collectives": sum(r.collectives for r in recs),
            "register_collectives": self._register_collectives,
            "tables": sorted(self._tables),
            "records": recs,
        }

    def explain(self, df: DataFrame, cfg: ExecConfig | None = None) -> str:
        """Cache-aware EXPLAIN: the plan plus this session's cache outcome
        for the query's key and the last recorded retry events.  At P > 1
        it takes its turn like a query (under ``adaptive_stats`` planning
        samples a persisted shard on every rank)."""
        cfg = self._resolve(cfg)
        key = self._key(df, cfg)
        with self._turn(self._take_ticket()):
            cached = key in self.plan_cache
            body = df.explain(cfg)
        evs = self.store.events.get(_st.plan_fingerprint(df.node), ())
        lines = [f"session: P={self.P} plan_cache="
                 f"{'HIT' if cached else 'MISS'} fingerprint={key[0][:12]}",
                 body]
        if evs:
            lines.append("last run events:")
            lines.extend(f"  {e.render()}" for e in evs)
        return "\n".join(lines)
