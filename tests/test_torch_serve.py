"""The serving layer of the port, held against the reference on the CPU.

tests/test_serve.py's shapes go through ``repro.runtime.session`` and
``repro_torch.runtime.session`` at P = 1 on the same seeded numpy inputs:
the shape fingerprints, the cache keys and their levers, LRU eviction, hits
that build no ``Lowered``, rebinds to other tables, the cache-outcome
sequences, collective counts and rows of the serve mix, a real
``hit_fallback``, the stats sidecar, ``_index_map`` and on-device
resharding, and the serve entry point.  Three reference faults are pinned
beside the port's answers: a hit that serves a stale free array or UDF,
and ``explain`` reporting MISS for a cached REP-first plan.  The P = 2
session runs inside tests/test_torch_e2e.py's two-rank spawn.
"""
import dataclasses
import os
import sys
import threading

import numpy as np
import pytest

pytest.importorskip("torch")

import torch  # noqa: E402

from repro import hiframes as rhf  # noqa: E402
from repro.core import stats as rst  # noqa: E402
from repro.core.api import ExecConfig as RCfg  # noqa: E402
from repro.launch import serve as rserve  # noqa: E402
from repro.runtime import reshard as rrs  # noqa: E402
from repro.runtime.session import Session as RSession  # noqa: E402
from repro_torch import hiframes as thf  # noqa: E402
from repro_torch.core import ir as tir  # noqa: E402
from repro_torch.core import physical as tphys  # noqa: E402
from repro_torch.core import stats as tst  # noqa: E402
from repro_torch.core.errors import StatsError  # noqa: E402
from repro_torch.core.lower import Lowered  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.runtime import reshard as trs  # noqa: E402
from repro_torch.runtime.retry import RetryEvent  # noqa: E402
from repro_torch.runtime.session import (PlanCache, Session,  # noqa: E402
                                         _CacheEntry, cfg_signature)

CPU = thf.ExecConfig(device="cpu")
PKG = {"ref": (rhf, RSession, RCfg, {}),
       "port": (thf, Session, thf.ExecConfig, {"device": "cpu"})}


@pytest.fixture(autouse=True)
def _fresh_stores():
    """Both packages keep process-global stores keyed by plan fingerprint."""
    for st in (rst, tst):
        st.clear_realized()
        st.current_store().events.clear()
    yield
    for st in (rst, tst):
        st.clear_realized()
        st.current_store().events.clear()


def _frame(n=160, seed=5, keys=11):
    rng = np.random.default_rng(seed)
    return {"k": rng.integers(0, keys, n).astype(np.int32),
            "v": rng.normal(size=n).astype(np.float32)}


def _rows(t, by) -> dict:
    d = t.to_numpy() if hasattr(t, "to_numpy") else t
    order = np.lexsort([np.asarray(d[k]) for k in reversed(by)])
    return {k: np.asarray(v)[order] for k, v in d.items()}


def _assert_rows(got: dict, want: dict, rtol=1e-4, atol=1e-4):
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.shape == w.shape, k
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g, w, rtol=rtol, atol=atol, err_msg=k)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)


def _groupby_sum(f) -> dict:
    k = f["k"]
    u = np.unique(k)
    return {"k": u, "s": np.array([f["v"][k == x].astype(np.float64).sum()
                                   for x in u], np.float32)}


# -- the plan-cache key -------------------------------------------------------

def _fp_queries(hf, cfg):
    """Queries whose shape fingerprints the two packages must agree on."""
    f, g = _frame(seed=1), _frame(seed=2)
    s = {"c": np.array(["a", "b", "a", "c"], object)}
    dim = {"dk": np.arange(11, dtype=np.int32),
           "w": np.linspace(0, 1, 11).astype(np.float32)}
    t = hf.table(f, "a")
    return {
        "groupby_sum": lambda: t.groupby("k").agg(s=("v", "sum")),
        "filter_3": lambda: t[t["k"] > 3],
        "filter_5": lambda: t[t["k"] > 5],
        "category": lambda: hf.table(s, "s1"),
        "join_agg": lambda: hf.table(g, "b").merge(
            hf.table(dim, "d"), on=("k", "dk")).groupby("k").agg(
                n=("w", "count")),
        "replicated_join": lambda: hf.table(dim, "d").replicate().merge(
            t, on=("dk", "k")).groupby("dk").agg(n=("v", "count")),
        "global_rank": lambda: hf.rank(t.groupby("k").agg(
            s=("v", "sum")), [], ["s"], out="r", ascending=False),
        "persisted": lambda: t.repartition("k").persist(cfg, name="p")
            .groupby("k").agg(s=("v", "sum")),
    }


FP_NAMES = sorted(_fp_queries(thf, CPU))


@pytest.mark.parametrize("name", FP_NAMES)
def test_shape_fingerprint_matches_reference(name):
    ref = _fp_queries(rhf, RCfg())[name]().node
    port = _fp_queries(thf, CPU)[name]().node
    assert tst.plan_fingerprint(port, scans="shape") == \
        rst.plan_fingerprint(ref, scans="shape")
    assert tst.plan_fingerprint(port) == rst.plan_fingerprint(ref)


def test_shape_fingerprint_ignores_table_identity():
    qa = thf.table(_frame(seed=1), "a").groupby("k").agg(s=("v", "sum"))
    qb = thf.table(_frame(seed=2), "b").groupby("k").agg(s=("v", "sum"))
    assert tst.plan_fingerprint(qa.node, scans="shape") == \
        tst.plan_fingerprint(qb.node, scans="shape")
    assert tst.plan_fingerprint(qa.node) != tst.plan_fingerprint(qb.node)


def test_shape_fingerprint_literal_and_dictionary_miss():
    q = _fp_queries(thf, CPU)
    fp = {n: tst.plan_fingerprint(q[n]().node, scans="shape") for n in q}
    assert fp["filter_3"] != fp["filter_5"]
    s2 = thf.table({"c": np.array(["x", "y", "x", "z"], object)}, "s2")
    assert fp["category"] != tst.plan_fingerprint(s2.node, scans="shape")


LEVERS = {"packed_exchange": dict(packed_exchange=False),
          "cap_overrides": dict(cap_overrides={3: (64, 8)}),
          "adaptive_stats": dict(adaptive_stats=True),
          "retry_scope": dict(retry_scope="global"),
          "validate": dict(validate=True)}


@pytest.mark.parametrize("lever", sorted(LEVERS) + ["P"])
def test_cfg_signature_levers(lever):
    base = cfg_signature(CPU, 1)
    assert base == cfg_signature(thf.ExecConfig(device="cpu"), 1)
    other = (cfg_signature(CPU, 2) if lever == "P" else
             cfg_signature(thf.ExecConfig(device="cpu", **LEVERS[lever]), 1))
    assert base != other
    # every field keys the cache, the device included
    assert {f.name for f in dataclasses.fields(CPU)} | {"P"} \
        == {k for k, _ in base} and ("device", "cpu") in base


def test_plan_cache_lru_eviction():
    pc = PlanCache(capacity=2)
    e = _CacheEntry(lowered=None, scan_ids=(), rebindable=False)
    pc.put("a", e), pc.put("b", e)
    assert pc.get("a") is not None       # refresh a
    pc.put("c", e)                       # evicts b (LRU)
    assert pc.get("b") is None
    assert pc.get("a") is not None and pc.get("c") is not None
    assert pc.evictions == 1 and "a" in pc and "b" not in pc


def test_session_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default config targets it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Session()


# -- hits, rebinds and misses ----------------------------------------------------

def test_session_hit_builds_no_lowered_and_stats():
    with Session(CPU) as sess:
        sess.register("t", thf.table(_frame(), "t").repartition("k"))
        q = lambda: sess.table("t").groupby("k").agg(s=("v", "sum"))
        t1 = sess.collect(q())
        built = Lowered.built
        t2 = sess.collect(q())
        assert Lowered.built == built
        assert (t1.query_record.cache, t2.query_record.cache) == ("miss", "hit")
        assert (t1.query_record.compiles, t2.query_record.compiles) == (1, 0)
        st = sess.stats()
        assert st["plan_cache"]["hits"] == 1 and st["plan_cache"]["misses"] == 1
        assert st["queries"] == 2 and st["compiles"] == 1
        assert "HIT" in sess.explain(q()).splitlines()[0]
        _assert_rows(_rows(t2, ("k",)), _rows(t1, ("k",)), 0, 0)


def test_session_rebind_different_table_returns_its_data():
    f1, f2 = _frame(seed=11), _frame(seed=22)
    with Session(CPU) as sess:
        sess.register("A", thf.table(f1, "A").repartition("k"))
        sess.register("B", thf.table(f2, "B").repartition("k"))
        assert sess.table("A").node.layout.capacity \
            == sess.table("B").node.layout.capacity
        q = lambda t: t.groupby("k").agg(s=("v", "sum"))
        sess.collect(q(sess.table("A")))
        built = Lowered.built
        t = sess.collect(q(sess.table("B")))
        assert t.query_record.cache == "hit" and Lowered.built == built
        _assert_rows(_rows(t, ("k",)), _groupby_sum(f2))


def test_session_cfg_lever_and_literal_miss():
    with Session(CPU) as sess:
        sess.register("t", thf.table(_frame(), "t"))
        q = lambda: sess.table("t").groupby("k").agg(s=("v", "sum"))
        sess.collect(q())
        t = sess.collect(q(), thf.ExecConfig(device="cpu",
                                             packed_exchange=False))
        assert t.query_record.cache == "miss"
        f = lambda th: sess.table("t")[sess.table("t")["k"] > th] \
            .groupby("k").agg(s=("v", "sum"))
        sess.collect(f(3))
        assert sess.collect(f(5)).query_record.cache == "miss"
        assert sess.collect(f(3)).query_record.cache == "hit"


def test_concurrent_submit_parity_one_rank():
    """tests/test_serve.py::test_concurrent_submit_parity at one device."""
    rng = np.random.default_rng(2)
    f = {"k": rng.integers(0, 13, 300).astype(np.int32),
         "v": rng.normal(size=300).astype(np.float32)}
    with Session(CPU, admission=4, workers=4) as sess:
        sess.register("t", thf.table(f, "t").repartition("k"))
        q = lambda: sess.table("t").groupby("k").agg(s=("v", "sum"),
                                                     c=("v", "count"))
        futs = [sess.submit(q()) for _ in range(6)]
        want = _groupby_sum(f)
        want["c"] = np.bincount(f["k"])[want["k"]].astype(np.int32)
        for fu in futs:
            _assert_rows(_rows(fu.result(), ("k",)), want)
        st = sess.stats()
        assert st["queries"] == 6 and st["plan_cache"]["hits"] >= 1


def test_turns_run_in_ticket_order():
    """At P > 1 the collective steps run in submission order whatever
    order the workers start them in (the ticket); a turn passes on when
    its block raises."""
    sess = Session(CPU)
    sess.P = 2                       # the turns only; nothing runs
    order, tickets = [], [sess._take_ticket() for _ in range(5)]

    def step(tk):
        try:
            with sess._turn(tk):
                order.append(tk)
                if tk == 2:
                    raise KeyError(tk)
        except KeyError:
            pass
    threads = [threading.Thread(target=step, args=(tk,))
               for tk in reversed(tickets)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=30)
    sess.P = 1
    sess.close()
    assert not any(th.is_alive() for th in threads)
    assert order == tickets


def test_concurrent_session_stress(tmp_path):
    """More workers than cores, a short switch interval: every query's rows
    right, every lookup counted once, every record kept with its own qid,
    the sidecar whole (concurrent misses save it through one .tmp)."""
    tables = {f"t{i}": _frame(n=120, seed=i, keys=7) for i in range(3)}
    n_workers = 2 * (os.cpu_count() or 4)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with Session(thf.ExecConfig(device="cpu", adaptive_stats=True),
                     session_dir=str(tmp_path), workers=n_workers,
                     admission=n_workers) as sess:
            for name, f in tables.items():
                sess.register(name, thf.table(f, name))
            # a large store makes each save outlast a query's execution
            sess.store.realized.update(
                (f"fp{i}", {"rows": i, "max": i, "mean": 1.0, "nshards": 1})
                for i in range(20000))
            # a literal per cut: each cut's first query misses and saves
            q = lambda t, cut: t[t["v"] > cut].groupby("k").agg(
                s=("v", "sum"), n=("v", "count"))
            cuts = np.linspace(-1, 1, 8, dtype=np.float32)
            jobs = [(name, cut) for _ in range(2) for cut in cuts
                    for name in tables]
            futs = [sess.submit(q(sess.table(name), cut))
                    for name, cut in jobs]
            outs = [fu.result(timeout=120) for fu in futs]
            st = sess.stats()
    finally:
        sys.setswitchinterval(old)
    for (name, cut), t in zip(jobs, outs):
        f = {c: v[tables[name]["v"] > cut] for c, v in tables[name].items()}
        want = _groupby_sum(f)
        want["n"] = np.bincount(f["k"])[want["k"]].astype(np.int32)
        _assert_rows(_rows(t, ("k",)), want)
    pc = st["plan_cache"]
    assert st["queries"] == len(jobs) == pc["hits"] + pc["misses"]
    assert sorted(r.qid for r in st["records"]) == list(
        range(1, len(jobs) + 1))
    assert tst.StatsStore.load(str(tmp_path / "stats.json")).realized


# -- against the reference's Session ------------------------------------------

def _signature(stats, node) -> list[str]:
    """The shape fingerprint's node signatures, a scan's columns in name
    order: the reference's persisted scans list them so (its collected
    dict is a jax pytree, alphabetical), the port's in schema order."""
    out = []
    for n in stats.ir.topo_order(node):
        sig = stats._node_sig(n, "shape")
        if sig.startswith("Scan["):
            cols, rest = sig[5:].split("|", 1)
            sig = "Scan[" + ",".join(sorted(cols.split(","))) + "|" + rest
        out.append(sig)
    return out


def _serve_run(pkg, scale=0.01):
    """The serve mix, registered as the entry point does, each query run
    twice one at a time: cache outcomes, collectives, rows and each
    query's shape fingerprint."""
    hf, S, Cfg, kw = PKG[pkg]
    serve = rserve if pkg == "ref" else tserve
    with S(Cfg(**kw)) as sess:
        serve.register_tables(sess, scale)
        mix = serve.build_mix(sess)
        ts = [sess.collect(q()) for _ in range(2) for q in mix]
        st = sess.stats()
        stats = rst if pkg == "ref" else tst
        return {"cache": [t.query_record.cache for t in ts],
                "collectives": [t.query_record.collectives for t in ts],
                "signatures": [_signature(stats, q().node) for q in mix],
                "register_collectives": st["register_collectives"],
                "rows": [t.to_numpy() for t in ts]}


def test_serve_mix_matches_reference_session():
    ref, port = _serve_run("ref"), _serve_run("port")
    assert port["cache"] == ref["cache"] == ["miss"] * 3 + ["hit"] * 3
    assert port["collectives"] == ref["collectives"]
    assert port["register_collectives"] == ref["register_collectives"]
    assert port["signatures"] == ref["signatures"]
    by = [("ss_customer_sk",), ("ss_item_sk",), ("ss_customer_sk",)] * 2
    for i, (g, w) in enumerate(zip(port["rows"], ref["rows"])):
        _assert_rows(_rows(g, by[i]), _rows(w, by[i]))
    for a, b in zip(port["rows"][:3], port["rows"][3:]):
        _assert_rows(a, b, 0, 0)         # a hit gives the miss's bits


def _fallback_tables():
    rng = np.random.default_rng(3)
    a = {"k": (rng.integers(0, 200, 200) + 10).astype(np.int32),
         "v": rng.normal(size=200).astype(np.float32)}
    b = {"k": rng.integers(0, 10, 200).astype(np.int32),
         "v": rng.normal(size=200).astype(np.float32)}
    d = {"dk": np.repeat(np.arange(10, dtype=np.int32), 10),
         "w": rng.normal(size=100).astype(np.float32)}
    return a, b, d


def _fallback_run(pkg):
    """Two tables of one capacity: A matches no dimension row, B matches
    ten each, so B's join overflows the capacities cached for A."""
    hf, S, Cfg, kw = PKG[pkg]
    a, b, d = _fallback_tables()
    with S(Cfg(**kw)) as sess:
        for name, f in (("A", a), ("B", b), ("D", d)):
            sess.register(name, hf.table(f, name))
        q = lambda t: t.merge(sess.table("D"), on=("k", "dk")) \
            .groupby("k").agg(n=("w", "count"))
        ts, entries = [], []
        for name in "ABBA":
            ts.append(sess.collect(q(sess.table(name))))
            entries.append(next(iter(sess.plan_cache._d.values())).lowered)
        return ts, entries, sess.stats()["plan_cache"]


def test_hit_fallback_on_overflow_matches_reference():
    ref, _, rpc = _fallback_run("ref")
    port, entries, pc = _fallback_run("port")
    outcomes = ["miss", "hit_fallback", "hit", "hit"]
    assert [t.query_record.cache for t in ref] == outcomes
    assert [t.query_record.cache for t in port] == outcomes
    assert pc == rpc and pc["size"] == 1
    # the fallback replanned (retry events) and replaced the entry
    assert [e.kind for e in port[1].query_record.events] == ["retry"] * 3
    assert entries[1] is not entries[0] and entries[3] is entries[1]
    _, b, d = _fallback_tables()
    want_n = sum(int((d["dk"] == k).sum()) for k in b["k"])
    for t, r in zip(port, ref):
        assert not t.overflow
        _assert_rows(_rows(t, ("k",)), _rows(r, ("k",)))
    assert int(port[1].to_numpy()["n"].sum()) == want_n
    assert int(port[0].to_numpy()["n"].sum()) == 0


# -- the stats sidecar --------------------------------------------------------

def test_sidecar_roundtrip(tmp_path):
    d = str(tmp_path)
    cfg = thf.ExecConfig(device="cpu", adaptive_stats=True)
    with Session(cfg, session_dir=d) as sess:
        sess.register("t", thf.table(_frame(), "t"))
        sess.collect(sess.table("t").groupby("k").agg(s=("v", "sum")))
        realized = dict(sess.store.realized)
    assert os.path.exists(os.path.join(d, "stats.json")) and realized
    with Session(cfg, session_dir=d) as s2:
        assert s2.store.realized == realized


def test_sidecar_corrupt_raises_and_recovers(tmp_path):
    d = str(tmp_path)
    p = os.path.join(d, "stats.json")
    with open(p, "w") as f:
        f.write('{"version": 1, "realized": {"x": ')   # truncated JSON
    with pytest.raises(StatsError):
        Session(CPU, session_dir=d)
    with Session(CPU, session_dir=d, recover_stats=True) as sess:
        assert len(sess.store.realized) == 0
    assert os.path.exists(p + ".corrupt")
    with open(p, "w") as f:
        f.write('{"version": 99}')
    with pytest.raises(StatsError):
        tst.StatsStore.load(p)


def test_sidecar_persists_retry_events(tmp_path):
    """A session's retry events reach the sidecar and a restarted session
    renders them in explain()."""
    d = str(tmp_path)
    a, b, dim = _fallback_tables()
    with Session(CPU, session_dir=d) as sess:
        sess.register("B", thf.table(b, "B"))
        sess.register("D", thf.table(dim, "D"))
        q = lambda: sess.table("B").merge(sess.table("D"), on=("k", "dk")) \
            .groupby("k").agg(n=("w", "count"))
        evs = sess.collect(q()).query_record.events
        assert [e.kind for e in evs] == ["retry"] * 3
    back = tst.StatsStore.load(os.path.join(d, "stats.json"))
    assert list(back.events.values()) == [evs]
    store = tst.StatsStore()
    store.events["fp1"] = (RetryEvent("retry", 1, 3, "cap 8 -> 16"),)
    store.realized["fp1"] = {"rows": 10, "max": 4, "mean": 2.5, "nshards": 4}
    store.save(os.path.join(d, "s2.json"))
    again = tst.StatsStore.load(os.path.join(d, "s2.json"))
    assert again.realized == store.realized and again.events == store.events


# -- resharding ---------------------------------------------------------------

INDEX_COUNTS = [[5, 0, 7, 3], [0, 0, 0, 0], [1], [10, 10], [4, 9, 0],
                [0, 13, 2, 2, 8]]


@pytest.mark.parametrize("P_new", [1, 2, 3, 4, 7])
@pytest.mark.parametrize("counts", INDEX_COUNTS,
                         ids=["-".join(map(str, c)) for c in INDEX_COUNTS])
def test_index_map_matches_reference(counts, P_new):
    cap = max(max(counts), 1) + 2
    got = trs._index_map(np.asarray(counts), cap, P_new)
    want = rrs._index_map(np.asarray(counts), cap, P_new)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype
    assert got[2] == want[2]


def _state(f, P=4, kind="hash", sort=True, block_counts=None):
    """A persisted state of ``f`` at ``P`` shards holding every shard, as
    ``hf.from_persisted_state`` reads it: hash-routed by the package's own
    row hash (or cut into ``block_counts`` contiguous blocks), each shard
    sorted by k when ``sort``."""
    n = len(f["k"])
    if block_counts is None:
        dest = (tphys.hash_keys({"k": torch.from_numpy(f["k"])}, ("k",))
                % P).numpy()
    else:
        dest = np.repeat(np.arange(P), block_counts)
    parts = []
    for r in range(P):
        idx = np.flatnonzero(dest == r)
        if sort:
            idx = idx[np.argsort(f["k"][idx], kind="stable")]
        parts.append(idx)
    counts = np.array([len(p) for p in parts], np.int32)
    cap = int(counts.max())
    cols = {c: np.zeros(P * cap, v.dtype) for c, v in f.items()}
    for r, idx in enumerate(parts):
        for c, v in f.items():
            cols[c][r * cap:r * cap + len(idx)] = v[idx]
    layout = dict(kind=kind, partitioned_by=("k",) if kind == "hash" else (),
                  ascending=True, globally_sorted=False,
                  sorted_by=("k",) if sort else (), order_ascending=True,
                  counts=counts, capacity=cap, nshards=P, dist="1D_VAR")
    assert int(counts.sum()) == n
    return cols, layout


def _valid(df) -> dict:
    lay = df.node.layout
    keep = np.concatenate([np.arange(r * lay.capacity, r * lay.capacity + c)
                           for r, c in enumerate(np.asarray(lay.counts))])
    return {c: np.asarray(v)[keep] for c, v in df.node.columns.items()}


@pytest.fixture
def no_gather_host(monkeypatch):
    calls = []
    orig = tir.ScanLayout.gather_host

    def guard(self, src):
        calls.append(self)
        return orig(self, src)
    monkeypatch.setattr(tir.ScanLayout, "gather_host", guard)
    yield calls
    assert calls == [], f"host gather x{len(calls)} during resharding"


def test_reshard_roundtrip_all_shards(no_gather_host):
    """4 -> 2 -> 4 with every shard on this device: the rows in order, the
    hash claim dropped without a cfg, shard-local order dropped by the
    merge and kept by the split, a global order kept both ways."""
    f = _frame(n=173, seed=6, keys=10)
    cols, lay = _state(f)
    p4 = thf.from_persisted_state(cols, lay, name="t4", device="cpu")
    a = _valid(p4)
    r2 = trs.reshard(p4, 2)
    l2 = r2.node.layout
    assert (l2.nshards, l2.kind, l2.partitioned_by, l2.sorted_by) \
        == (2, "block", (), ())
    assert l2.counts.tolist() == [87, 86] and l2.capacity == 87
    _assert_rows(_valid(r2), a, 0, 0)
    r4 = trs.reshard(r2, 4)
    assert r4.node.layout.counts.tolist() == [44, 43, 43, 43]
    _assert_rows(_valid(r4), a, 0, 0)
    # a split keeps a shard-local order (each new shard from one old one)
    one, lay1 = _state(f, P=1)
    s2 = trs.reshard(thf.from_persisted_state(one, lay1, device="cpu"), 2)
    assert s2.node.layout.sorted_by == ("k",)
    assert all((np.diff(_valid(s2)["k"][lo:hi]) >= 0).all()
               for lo, hi in ((0, 87), (87, 173)))
    # a global order survives any re-block
    order = np.argsort(f["k"], kind="stable")
    g = {c: v[order] for c, v in f.items()}
    gc, gl = _state(g, kind="block", sort=False,
                    block_counts=[50, 0, 80, 43])
    gl.update(sorted_by=("k",), globally_sorted=True)
    rs = trs.reshard(thf.from_persisted_state(gc, gl, device="cpu"), 3)
    assert rs.node.layout.sorted_by == ("k",) and rs.node.layout.globally_sorted
    assert (np.diff(_valid(rs)["k"]) >= 0).all()


def test_reshard_matches_reference_index_gather():
    """The port's re-blocked columns equal a take of the reference's
    index map over the same state's arrays."""
    f = _frame(n=99, seed=9)
    cols, lay = _state(f, P=3)
    out = trs.reshard(thf.from_persisted_state(cols, lay, device="cpu"), 5)
    idx, counts, cap = rrs._index_map(lay["counts"], lay["capacity"], 5)
    for c, v in cols.items():
        np.testing.assert_array_equal(out.node.columns[c].numpy(), v[idx])
    assert out.node.layout.counts.tolist() == counts.tolist()


def test_reshard_with_cfg_reestablishes_hash_claim(no_gather_host):
    """4 -> 1 at this rank's world size: one index_select, then one
    exchange re-establishes the hash claim; a group-by on it then plans no
    exchange and gives numpy's sums."""
    f = _frame(n=140, seed=3, keys=8)
    cols, lay = _state(f)
    p4 = thf.from_persisted_state(cols, lay, name="t4", device="cpu")
    r1 = trs.reshard(p4, 1, CPU)
    l1 = r1.node.layout
    assert l1.device_valid(1) and (l1.kind, l1.partitioned_by) == ("hash", ("k",))
    q = r1.groupby("k").agg(s=("v", "sum"))
    assert q.lower(CPU).pplan.counts()["hash_exchanges"] == 0
    _assert_rows(_rows(q.collect(CPU), ("k",)), _groupby_sum(f))
    r1b = trs.reshard(p4, 1, CPU, reestablish=False)
    assert r1b.node.layout.kind == "block"
    _assert_rows(_valid(r1b), _valid(trs.reshard(p4, 1)), 0, 0)


@pytest.mark.parametrize("case", ["host", "rep", "rank_local", "world",
                                  "bad_count"])
def test_reshard_refuses(case):
    f = _frame()
    if case == "host":
        df, match = thf.table(f, "t"), "persisted"
    elif case == "rep":
        df, match = thf.table(f, "t").replicate().persist(CPU), "host/REP"
    elif case == "rank_local":
        cols, lay = _state(f, P=2)
        cap = lay["capacity"]
        lay = tir.ScanLayout(**{**lay, "counts": np.asarray(lay["counts"])})
        scan = tir.Scan("shard", {c: torch.from_numpy(v[:cap])
                                  for c, v in cols.items()}, layout=lay)
        df, match = thf.DataFrame(scan), "one rank's shard"
    else:
        cols, lay = _state(f, P=2)
        df = thf.from_persisted_state(cols, lay, device="cpu")
        match = "target is 3" if case == "world" else "invalid"
    with pytest.raises(ValueError, match=match):
        trs.reshard(df, 0 if case == "bad_count" else 3,
                    CPU if case == "world" else None)


def test_register_reshards_four_shard_state(no_gather_host):
    """A 4-shard state registered into a P = 1 session: resharded on
    device, the hash claim re-established, then served (miss, hit)."""
    f = _frame(n=140, seed=3, keys=8)
    cols, lay = _state(f)
    with Session(CPU) as sess:
        sess.register("t", thf.from_persisted_state(cols, lay, name="t4",
                                                    device="cpu"))
        reg = sess.table("t").node.layout
        assert reg.device_valid(1) and reg.kind == "hash"
        assert sess.stats()["register_collectives"] == 0   # reshard's own
        q = lambda: sess.table("t").groupby("k").agg(s=("v", "sum"))
        ts = [sess.collect(q()) for _ in range(2)]
        assert [t.query_record.cache for t in ts] == ["miss", "hit"]
        for t in ts:
            _assert_rows(_rows(t, ("k",)), _groupby_sum(f))


# -- Lowered's rebind checks --------------------------------------------------

def test_lowered_rebind_checks():
    f = _frame()
    p = thf.table(f, "t").repartition("k").persist(CPU, name="p")
    low = p.groupby("k").agg(s=("v", "sum")).lower(CPU)
    sid = str(low.scans[0].id)
    small = thf.table(_frame(n=80), "s").repartition("k").persist(CPU)
    with pytest.raises(ValueError, match="capacity"):
        low(scan_nodes={sid: small.node})
    with pytest.raises(ValueError, match="lacks columns"):
        low(scan_nodes={sid: p[["k"]].persist(CPU).node})
    with pytest.raises(ValueError, match="no scan"):
        low(scan_nodes={"-1": p.node})
    host = thf.table(f, "h").groupby("k").agg(s=("v", "sum")).lower(CPU)
    with pytest.raises(ValueError, match="rows"):
        host(scan_nodes={str(host.scans[0].id):
                         thf.table(_frame(n=80), "h2").node})
    g = _frame(seed=9)
    t = host(scan_nodes={str(host.scans[0].id): thf.table(g, "h3").node})
    _assert_rows(_rows(t, ("k",)), _groupby_sum(g))


def test_lowered_external_rebind_never_serves_a_replaced_shard():
    f = _frame(n=50)
    t = thf.table(f, "t")
    ext = np.zeros(50, np.float32)
    low = t[t["v"] > ext].groupby("k").agg(c=("v", "count")).lower(CPU)
    (tag,) = {tag for tags in low.exts.values() for tag in tags}
    n0 = int(low().to_numpy()["c"].sum())
    assert n0 == int((f["v"] > 0).sum())
    high = np.full(50, 1e9, np.float32)
    assert low(externals={tag: high}).to_numpy()["c"].size == 0
    assert int(low().to_numpy()["c"].sum()) == n0
    with pytest.raises(ValueError, match="does not fit"):
        low(externals={tag: np.zeros(49, np.float32)})
    with pytest.raises(ValueError, match="does not fit"):
        low(externals={tag: np.zeros(50, np.int32)})


# -- reference faults the port does not keep ----------------------------------

def _ext_query(sess, hf, ext):
    t = sess.table("t")
    return t[t["v"] > ext].groupby("k").agg(c=("v", "count"))


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_free_array_hit_rebinds_the_new_array(pkg):
    """The reference's hit feeds the cached plan's array (its fingerprint
    sees only the shape): counts where the answer is empty.  The port
    rebinds the query's own array."""
    hf, S, Cfg, kw = PKG[pkg]
    f = _frame(n=50, seed=0, keys=5)
    with S(Cfg(**kw)) as sess:
        sess.register("t", hf.table(f, "t"))
        a = sess.collect(_ext_query(sess, hf, np.zeros(50, np.float32)))
        b = sess.collect(_ext_query(sess, hf, np.full(50, 1e9, np.float32)))
        assert (a.query_record.cache, b.query_record.cache) == ("miss", "hit")
        n = b.to_numpy()["c"]
        if pkg == "ref":                     # the stale answer, pinned
            np.testing.assert_array_equal(n, a.to_numpy()["c"])
            assert n.sum() == int((f["v"] > 0).sum())
        else:
            assert n.size == 0
        c = sess.collect(_ext_query(sess, hf, np.zeros(50, np.float32)))
        assert c.to_numpy()["c"].sum() == int((f["v"] > 0).sum())


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_udf_is_part_of_the_cache_key(pkg):
    """Two UDFs over the same columns have one shape fingerprint: the
    reference's hit runs the first UDF for the second query; the port keys
    the function's identity and misses."""
    hf, S, Cfg, kw = PKG[pkg]
    f = _frame(n=50, seed=3, keys=5)
    with S(Cfg(**kw)) as sess:
        sess.register("t", hf.table(f, "t"))

        def q(fn):
            t = sess.table("t")
            return t[hf.udf(fn, t["v"]) > 0].groupby("k").agg(n=("v", "count"))
        ident = lambda x: x          # noqa: E731
        a = sess.collect(q(ident))
        b = sess.collect(q(lambda x: x * 0 - 1))
        c = sess.collect(q(ident))
        outcomes = [t.query_record.cache for t in (a, b, c)]
        if pkg == "ref":
            assert outcomes == ["miss", "hit", "hit"]
            np.testing.assert_array_equal(b.to_numpy()["n"],
                                          a.to_numpy()["n"])
        else:
            assert outcomes == ["miss", "miss", "hit"]
            assert b.to_numpy()["n"].size == 0
        assert a.to_numpy()["n"].sum() == int((f["v"] > 0).sum())


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_explain_keys_rep_pins_as_queries_do(pkg):
    """``item.replicate().merge(ss)``: positional pins (True, False).  The
    reference's explain sorts them and says MISS after a hit; the port's
    uses the queries' key."""
    hf, S, Cfg, kw = PKG[pkg]
    f = _frame(n=120, seed=4, keys=6)
    it = {"i": np.arange(6, dtype=np.int32),
          "w": np.linspace(0, 1, 6).astype(np.float32)}
    with S(Cfg(**kw)) as sess:
        sess.register("ss", hf.table(f, "ss"))
        sess.register("item", hf.table(it, "item").replicate())
        q = lambda: sess.table("item").replicate().merge(
            sess.table("ss"), on=("i", "k")).groupby("i").agg(
                n=("v", "count"))
        assert "MISS" in sess.explain(q()).splitlines()[0]
        ts = [sess.collect(q()) for _ in range(2)]
        assert [t.query_record.cache for t in ts] == ["miss", "hit"]
        head = sess.explain(q()).splitlines()[0]
        assert ("MISS" if pkg == "ref" else "HIT") in head, head


# -- the entry point ----------------------------------------------------------

def test_serve_smoke_in_process(capsys):
    assert tserve.main(["--smoke", "--device", "cpu", "--scale", "0.01",
                        "--repeats", "1"]) == 0
    out = capsys.readouterr().out
    assert "serve smoke: PASS" in out and "0 Lowered built" in out


def test_serve_smoke_failures_name_each_broken_clause():
    p1 = {"collectives": 6}
    ok = {"queries": 3, "hits": 3, "compiles": 0, "built": 0,
          "collectives": 6}
    assert tserve.smoke_failures(p1, ok, 8) == []
    bad = dict(ok, hits=2, built=1, collectives=8)
    fails = tserve.smoke_failures(p1, bad, 8)
    assert len(fails) == 3 and "hit rate" in fails[0]
