"""End-to-end parity of the relational main path.

At P=1 every query runs three ways on the same numpy inputs: the port on
the CPU, the reference with its Pallas kernels in interpret mode, and the
python-loop oracles of tests/oracle.py.  Port and reference must agree row
for row and column by column (exact for ints and bools, floats within
rtol=1e-4, atol=1e-3); the oracle is compared as a row set.  The carry-over
tests move a reference DTable's state into the port and query it.  One test
spawns two gloo ranks and runs the same queries at P=2, together with the
window queries of tests/test_torch_window.py (the global ones with both
exclusive-scan methods), the sort, limit, rebalance, concat and persist
queries of tests/test_torch_sort.py, the frame path's queries of
tests/torch_frame_queries.py (string predicates, the null and column verbs,
recoding concat and category-key merge), the segmentation queries of
tests/torch_segmentation_queries.py (transform, head, the group-by sugar
and free arrays in a filter, an assign and an aggregate), matrix assembly
in 1D_BLOCK blocks, the guardrail queries of ``GUARD_SRC`` (a salted skew
join, a forced overflow and a packed-exchange corruption, each healed),
and direct checks of the halo exchange, the global
rank, the sample sort (an empty rank, composite keys, descending), the
rebalance and the limit across the two ranks, and the serving session
(concurrent submits in ticket order, a 1 -> 2 reshard on registration, the
sidecar written by rank 0 alone).
"""
import json
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

pytest.importorskip("torch")

import oracle  # noqa: E402
from repro import hiframes as rhf  # noqa: E402
from repro_torch import hiframes as thf  # noqa: E402
from repro_torch.core import dtypes as tdt  # noqa: E402
from test_torch_sort import (S, SDATA, SORT_SRC,  # noqa: E402
                             assert_sort_result)
from torch_frame_queries import FRAME_SRC  # noqa: E402
from torch_segmentation_queries import SEG_SRC  # noqa: E402
from test_torch_window import (W, WDATA, WINDOW_SRC,  # noqa: E402
                               assert_same_row_set, window_oracle)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TCFG = dict(device="cpu")

# -- the queries, written once against either package's ``hf`` ---------------

QUERY_SRC = '''
import numpy as np


def data():
    rng = np.random.default_rng(42)
    d = {}
    d["t"] = {"id": rng.integers(0, 40, 900).astype(np.int32),
              "x": rng.normal(size=900).astype(np.float32),
              "y": rng.normal(size=900).astype(np.float32)}
    d["left"] = {"id": rng.integers(0, 60, 700).astype(np.int32),
                 "x": rng.normal(size=700).astype(np.float32)}
    d["right"] = {"cid": np.arange(50, dtype=np.int32),
                  "w": rng.normal(size=50).astype(np.float32)}
    d["ss"] = {"ss_item_sk": rng.integers(0, 40, 800).astype(np.int32),
               "ss_customer_sk": rng.integers(0, 70, 800).astype(np.int32),
               "ss_net_paid": rng.gamma(2.0, 30.0, 800).astype(np.float32),
               "ss_region": rng.integers(0, 4, 800).astype(np.int32)}
    d["it"] = {"i_item_sk": np.arange(40, dtype=np.int32),
               "i_class_id": rng.integers(1, 17, 40).astype(np.int32)}
    d["dim"] = {"i_item_sk": np.tile(d["it"]["i_item_sk"], 4),
                "i_region": np.repeat(np.arange(4, dtype=np.int32), 40),
                "i_class_id": np.tile(d["it"]["i_class_id"], 4)}
    return d


def fig8a_filter(hf, d):
    df = hf.table(d["t"])
    return df[df.x < 0.5]


def fig8a_join(hf, d):
    return hf.join(hf.table(d["left"], "l"), hf.table(d["right"], "r"),
                   on=("id", "cid"))


def fig8a_aggregate(hf, d):
    df = hf.table(d["t"])
    return hf.aggregate(df, "id", s=hf.sum_(df["x"]), m=hf.mean(df["y"]))


def q26(hf, d, min_count=4):
    si = hf.join(hf.table(d["ss"], "ss"), hf.table(d["it"], "it"),
                 on=("ss_item_sk", "i_item_sk"))
    c = hf.aggregate(si, "ss_customer_sk", c_i_count=hf.count(),
                     id1=hf.sum_(si["i_class_id"] == 1),
                     id2=hf.sum_(si["i_class_id"] == 2),
                     id3=hf.sum_(si["i_class_id"] == 3))
    return c[c["c_i_count"] > min_count]


def q26_multikey(hf, d, min_count=4):
    si = hf.join(hf.table(d["ss"], "ss"), hf.table(d["dim"], "dim"),
                 on=[("ss_item_sk", "i_item_sk"), ("ss_region", "i_region")])
    k = hf.aggregate(si, by=("ss_item_sk", "ss_region"), n=hf.count(),
                     paid=hf.sum_(si["ss_net_paid"]),
                     id1=hf.sum_(si["i_class_id"] == 1),
                     id2=hf.sum_(si["i_class_id"] == 2))
    return k[k["n"] > min_count]


QUERIES = {"fig8a_filter": fig8a_filter, "fig8a_join": fig8a_join,
           "fig8a_aggregate": fig8a_aggregate, "q26": q26,
           "q26_multikey": q26_multikey}
'''

Q: dict = {}
exec(QUERY_SRC, Q)
DATA = Q["data"]()
NAMES = list(Q["QUERIES"])
FQ: dict = {}
exec(FRAME_SRC, FQ)
FDATA = FQ["frame_data"]()
Z: dict = {}
exec(SEG_SRC, Z)
ZDATA = Z["seg_data"]()

# The guardrail queries of the two-rank spawn: tests/test_skew.py's salted
# join (and the same join unsalted), and tests/test_faults.py's forced
# overflow and packed-exchange corruption, each healed by the retry policy.
GUARD_SRC = '''
import numpy as np


def guard_data():
    rng = np.random.default_rng(7)
    n, m = 4000, 90
    k = rng.integers(0, m, n).astype(np.int32)
    k[: int(0.35 * n)] = 3
    rng.shuffle(k)
    d = {"probe": {"k": k, "v": rng.normal(size=n).astype(np.float32)},
         "dim": {"k": np.arange(m, dtype=np.int32),
                 "w": rng.normal(size=m).astype(np.float32)}}
    rng = np.random.default_rng(11)
    d["agg"] = {"k": rng.integers(0, 23, 600).astype(np.int32),
                "v": rng.normal(size=600).astype(np.float32)}
    rng = np.random.default_rng(3)
    d["agg2"] = {"k": rng.integers(0, 17, 500).astype(np.int32),
                 "v": rng.normal(size=500).astype(np.float32)}
    return d


def skew_join(hf, d):
    return hf.table(d["probe"], "probe").merge(hf.table(d["dim"], "dim"),
                                               on="k")


def agg_sum_count(hf, d):
    return hf.table(d["agg"], "t").groupby("k").agg(s=("v", "sum"),
                                                    n=("v", "count"))


def agg_sum(hf, d):
    return hf.table(d["agg2"], "t").groupby("k").agg(s=("v", "sum"))


# name -> (frame, ExecConfig fields, FaultPlan fields or None)
GUARD_RUNS = {
    "salted_join": (skew_join, {"adaptive_stats": True}, None),
    "unsalted_join": (skew_join, {}, None),
    "forced_overflow": (agg_sum_count, {"validate": True, "auto_retry": 3},
                        {"force_overflow": ("HashExchange",)}),
    "corrupt_heal": (agg_sum, {"validate": True},
                     {"corrupt_exchange": ("HashExchange",),
                      "corrupt_packed_only": True}),
}
'''
G: dict = {}
exec(GUARD_SRC, G)
GDATA = G["guard_data"]()


def _oracle(name, d):
    if name == "fig8a_filter":
        return oracle.o_filter(d["t"], d["t"]["x"] < np.float32(0.5))
    if name == "fig8a_join":
        return oracle.o_join(d["left"], d["right"], "id", "cid")
    if name == "fig8a_aggregate":
        t = d["t"]
        return oracle.o_aggregate(t, "id", {"s": ("sum", t["x"]),
                                            "m": ("mean", t["y"])})
    if name == "q26":
        j = oracle.o_join(d["ss"], d["it"], "ss_item_sk", "i_item_sk")
        aggs = {"c_i_count": ("count", None)}
        aggs.update({f"id{c}": ("sum", (j["i_class_id"] == c).astype(np.int32))
                     for c in (1, 2, 3)})
        a = oracle.o_aggregate(j, "ss_customer_sk", aggs)
        return oracle.o_filter(a, a["c_i_count"] > 4)
    j = oracle.o_join(d["ss"], d["dim"], ("ss_item_sk", "ss_region"),
                      ("i_item_sk", "i_region"))
    aggs = {"n": ("count", None), "paid": ("sum", j["ss_net_paid"])}
    aggs.update({f"id{c}": ("sum", (j["i_class_id"] == c).astype(np.int32))
                 for c in (1, 2)})
    a = oracle.o_aggregate(j, ("ss_item_sk", "ss_region"), aggs)
    return oracle.o_filter(a, a["n"] > 4)


def _assert_same_rows(got: dict, want: dict):
    """Same columns (by name), same rows in the same order."""
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.shape == w.shape, (k, g.shape, w.shape)
        assert g.dtype == w.dtype, (k, g.dtype, w.dtype)
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-3, err_msg=k)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)


def _as_row_set(d: dict) -> dict:
    """Rows sorted lexicographically by every column (names sorted)."""
    names = sorted(d)
    order = np.lexsort([np.asarray(d[k]) for k in reversed(names)])
    return {k: np.asarray(d[k])[order] for k in names}


def _assert_same_row_set(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    g, w = _as_row_set(got), _as_row_set(want)
    for k in w:
        if np.issubdtype(w[k].dtype, np.floating):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4, atol=1e-3,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(g[k], w[k].astype(g[k].dtype),
                                          err_msg=k)


@pytest.mark.parametrize("name", NAMES)
def test_query_matches_reference_and_oracle(name):
    build = Q["QUERIES"][name]
    got = build(thf, DATA).collect(thf.ExecConfig(**TCFG))
    assert not got.overflow
    got = got.to_numpy()
    want = build(rhf, DATA).collect(
        rhf.ExecConfig(use_pallas="interpret")).to_numpy()
    _assert_same_rows(got, want)
    _assert_same_row_set(got, _oracle(name, DATA))


def test_carry_over_reference_state():
    """A reference DTable's numpy state becomes a port DTable, which then
    feeds a port query and gives the reference's answer."""
    rt = Q["fig8a_filter"](rhf, DATA).collect(rhf.ExecConfig())
    tt = thf.DTable.from_numpy_state(
        {c: np.asarray(v) for c, v in rt.columns.items()},
        np.asarray(rt.counts), rt.capacity, rt.nshards, rt.dist, device="cpu")
    _assert_same_rows(tt.to_numpy(), rt.to_numpy())
    tdf, rdf = thf.table(tt), rhf.table(rt.to_numpy())
    got = thf.aggregate(tdf, "id", s=thf.sum_(tdf["x"]), n=thf.count()) \
        .collect(thf.ExecConfig(**TCFG)).to_numpy()
    want = rhf.aggregate(rdf, "id", s=rhf.sum_(rdf["x"]), n=rhf.count()) \
        .collect(rhf.ExecConfig()).to_numpy()
    _assert_same_rows(got, want)


def test_carry_over_reference_window_state():
    """A reference partitioned window's output, in its grouped layout
    (hash-partitioned on g, sorted by g and t), carried into the port; a
    second partitioned window over the same keys runs on it and gives the
    reference's rows."""
    rt = W["p_cumsum"](rhf, WDATA).collect(rhf.ExecConfig())
    tt = thf.DTable.from_numpy_state(
        {c: np.asarray(v) for c, v in rt.columns.items()},
        np.asarray(rt.counts), rt.capacity, rt.nshards, rt.dist, device="cpu")
    assert tt.dist == rt.dist
    _assert_same_rows(tt.to_numpy(), rt.to_numpy())
    tdf, rdf = thf.table(tt), rhf.table(rt.to_numpy())
    got = tdf.over("g", order_by="t").rolling_mean(tdf["wc"], 3, out="m",
                                                   exact=True) \
        .collect(thf.ExecConfig(**TCFG)).to_numpy()
    want = rdf.over("g", order_by="t").rolling_mean(rdf["wc"], 3, out="m",
                                                    exact=True) \
        .collect(rhf.ExecConfig()).to_numpy()
    _assert_same_rows(got, want)


def test_overflow_retry_heals():
    """Unsafe capacities overflow the join's exchanges; collect() grows the
    overflowed sites and returns the full answer."""
    kw = dict(safe_capacities=False, shuffle_slack=0.05, **TCFG)
    t = Q["fig8a_join"](thf, DATA).collect(thf.ExecConfig(auto_retry=3, **kw))
    assert not t.overflow and t.events, t.events
    _assert_same_row_set(t.to_numpy(), _oracle("fig8a_join", DATA))
    t = Q["fig8a_join"](thf, DATA).collect(thf.ExecConfig(auto_retry=0, **kw))
    assert t.overflow and {r["kind"] for r in t.overflow_ops.values()} \
        == {"exchange"}


# A skewed many-to-many join that both packages truncate (a reference fault,
# logged in ROADMAP.md section 3): every row on key 0, so the join's
# capacity doubles 82 -> 164 -> 328 -> 656 over auto_retry = 3 and stops
# short of the rows the join needs (18 x 37 = 666; 40 x 40 = 1600).  Pinned
# so that the port keeps the reference's answer, flag, attribution and
# retries until both may be fixed together.
@pytest.mark.parametrize("n_left,n_right", [(18, 37), (40, 40)])
def test_skewed_join_truncation_matches_reference(n_left, n_right):
    rng = np.random.default_rng(n_left * n_right)
    left = {"id": np.zeros(n_left, np.int32),
            "x": rng.normal(size=n_left).astype(np.float32)}
    right = {"cid": np.zeros(n_right, np.int32),
             "w": rng.normal(size=n_right).astype(np.float32)}
    tabs = []
    for hf, cfg in ((rhf, rhf.ExecConfig()), (thf, thf.ExecConfig(**TCFG))):
        tabs.append(hf.join(hf.table(left), hf.table(right, "r"),
                            on=("id", "cid")).collect(cfg))
    rt, tt = tabs
    rows = len(tt.to_numpy()["id"])
    assert rows == len(rt.to_numpy()["id"]) < n_left * n_right
    assert tt.overflow and rt.overflow

    def attribution(t):
        return {op: (r["kind"], r["strategy"], r["cap"], r["cap_req"])
                for op, r in t.overflow_ops.items()}
    assert attribution(tt) == attribution(rt)
    assert [r[3] for r in attribution(tt).values()] == [n_left * n_right]
    # the retries (kind, attempt, op, "kind cap a -> b"), then the give-up:
    # the same RetryEvents
    assert [(e.kind, e.attempt, e.op_id, e.detail) for e in tt.events] \
        == [(e.kind, e.attempt, e.op_id, e.detail) for e in rt.events]
    assert [e.kind for e in rt.events][-1] == "overflow_exhausted"
    assert [e.kind for e in tt.events][:-1] == ["retry"] * (len(tt.events) - 1)


def test_cuda_default_refuses_to_run_without_a_card():
    import torch
    if torch.cuda.is_available():
        assert thf.ExecConfig().device == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            thf.ExecConfig()


RANK_SCRIPT = '''
import json, os, sys
import numpy as np
import torch
import torch.distributed as dist


def main(rank, world, port, out):
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    from repro_torch import hiframes as hf
    calls = [0]
    a2a = dist.all_to_all_single

    def counted(*a, **k):
        calls[0] += 1
        return a2a(*a, **k)
    dist.all_to_all_single = counted
    d, wd, sd = Q["data"](), W["window_data"](), S["sort_data"]()
    fd, zd = F["frame_data"](), Z["seg_data"]()
    cfg = hf.ExecConfig(device="cpu")
    ladder = hf.ExecConfig(device="cpu", exscan_method="ladder")
    runs = [(name, build, d, cfg) for name, build in Q["QUERIES"].items()]
    runs += [(name, build, wd, cfg)
             for name, build in W["WINDOW_QUERIES"].items()]
    runs += [(name + "@ladder", W["WINDOW_QUERIES"][name], wd, ladder)
             for name in W["GLOBAL_WINDOWS"]]
    runs += [(name, build, sd, cfg)
             for name, build in S["SORT_QUERIES"].items()]
    runs += [(name, build, fd, cfg)
             for name, build in F["FRAME_QUERIES"].items()]
    runs += [(name, build, zd, cfg)
             for name, build in Z["SEG_QUERIES"].items()]
    res = {}
    for name, build, data, c in runs:
        frame = build(hf, data)
        calls[0] = 0
        t = frame.collect(c)
        res[name] = {"cols": {k: v.tolist() for k, v in t.to_numpy().items()},
                     "dtypes": {k: str(v.dtype) for k, v in t.to_numpy().items()},
                     "all_to_all": calls[0], "overflow": bool(t.overflow),
                     "nshards": t.nshards,
                     "census": frame.physical_plan(c).shuffle_census(P=world)["all_to_all"]}
    res["__guard__"] = guard_runs(hf, calls, world)
    res["__direct__"] = direct_checks(rank, world)
    res["__seg_matrix__"] = seg_matrix(hf, zd, cfg)
    res["__serve__"] = serve_runs(hf, calls, os.path.join(
        os.path.dirname(out), "serve"))
    if rank == 0:
        with open(out, "w") as f:
            json.dump(res, f)
    dist.destroy_process_group()


def guard_runs(hf, calls, world):
    """The guardrail queries at P = world: rows, per-rank counts, the
    retry events and invariant failures, and the all_to_all calls."""
    from repro_torch.runtime import FaultPlan
    gd = G["guard_data"]()
    out = {}
    for name, (build, kw, fault) in G["GUARD_RUNS"].items():
        cfg = hf.ExecConfig(device="cpu", **kw, **(
            {"fault_inject": FaultPlan(**fault)} if fault else {}))
        frame = build(hf, gd)
        calls[0] = 0
        t = frame.collect(cfg)
        out[name] = {
            "cols": {k: v.tolist() for k, v in t.to_numpy().items()},
            "counts": t.counts.tolist(), "overflow": bool(t.overflow),
            "events": [[e.kind, e.attempt, e.op_id] for e in t.events],
            "failures": [list(f) for f in t.invariant_failures],
            "all_to_all": calls[0],
            "census": [build(hf, gd).physical_plan(hf.ExecConfig(
                device="cpu", packed_exchange=packed, **kw))
                .shuffle_census(P=world)["all_to_all"]
                for packed in (True, False)]}
    out["persisted_salted_join"] = persisted_salted_join(hf, gd, world)
    return out


def persisted_salted_join(hf, gd, world):
    """A persisted probe (hash-partitioned on v, so the join still moves
    it): each rank samples its own device shard and one all_gather hands
    every rank every rank's sampled rows, so the ranks plan the same salted
    join.  The sample equals the one taken from the shards' global arrays
    (the reference's layout)."""
    from repro_torch.core import ir, stats
    cpu = hf.ExecConfig(device="cpu")
    p = hf.table(gd["probe"], "probe").repartition(by="v").persist(
        cpu, name="pp")
    j = p.merge(hf.table(gd["dim"], "dim"), on="k")
    acfg = hf.ExecConfig(device="cpu", adaptive_stats=True)
    smp = stats.sample_scan(p.node, ("k", "v"), 256)
    full = {}
    for c in ("k", "v"):
        parts = [None] * world
        dist.all_gather_object(parts, p.node.columns[c].tolist())
        full[c] = torch.tensor(sum(parts, []), dtype=p.node.columns[c].dtype)
    glob = stats.sample_scan(ir.Scan("pp_global", full, layout=p.node.layout),
                             ("k", "v"), 256)
    plan = j.physical_plan(acfg).render()
    t = j.collect(acfg)
    views = [None] * world
    dist.all_gather_object(views, (plan, {k: v.tolist()
                                          for k, v in smp.items()}))
    return {"cols": {k: v.tolist() for k, v in t.to_numpy().items()},
            "overflow": bool(t.overflow), "plan": plan,
            "same_on_every_rank": all(v == views[0] for v in views),
            "sample_is_global": all(np.array_equal(smp[c], glob[c])
                                    for c in smp),
            "sample_rows": len(smp["k"])}


def serve_runs(hf, calls, sdir):
    """The serving session at P = world (adaptive statistics on, so
    planning samples each rank's persisted shard with an all_gather): six
    concurrent submits, admission 4 and workers 4, then a 1-shard state
    registered into the 2-rank session (a split 1 -> 2, its hash claim
    re-established by one exchange) and grouped on its key.  Every rank's
    record: the rows, the cache outcomes in completion order, the qids,
    the all_to_all calls, the sidecar writes."""
    from repro_torch.core import stats as st
    from repro_torch.runtime.session import Session
    os.makedirs(sdir, exist_ok=True)
    saves, save = [0], st.StatsStore.save

    def counted_save(self, path):
        saves[0] += 1
        return save(self, path)
    st.StatsStore.save = counted_save
    rng = np.random.default_rng(2)
    f = {"k": rng.integers(0, 13, 300).astype(np.int32),
         "v": rng.normal(size=300).astype(np.float32)}
    order = np.argsort(f["k"], kind="stable")
    state = {c: v[order] for c, v in f.items()}
    layout = dict(kind="hash", partitioned_by=("k",), ascending=True,
                  globally_sorted=False, sorted_by=("k",),
                  order_ascending=True, counts=[300], capacity=300,
                  nshards=1, dist="1D_VAR")
    cfg = hf.ExecConfig(device="cpu", adaptive_stats=True)
    out = {}
    with Session(cfg, session_dir=sdir, admission=4, workers=4) as sess:
        sess.register("t", hf.table(f, "t").repartition("k"))
        q = lambda: sess.table("t").groupby("k").agg(s=("v", "sum"),
                                                     c=("v", "count"))
        tabs = [fu.result() for fu in [sess.submit(q()) for _ in range(6)]]
        out["parity"] = [{k: v.tolist() for k, v in t.to_numpy().items()}
                         for t in tabs]
        out["cache"] = [t.query_record.cache for t in tabs]
        calls[0] = 0
        sess.register("one", hf.from_persisted_state(
            state, layout, name="one", device="cpu"))
        out["split_all_to_all"] = calls[0]
        lay = sess.table("one").node.layout
        out["split_layout"] = [lay.kind, list(lay.partitioned_by),
                               lay.nshards, lay.counts.tolist()]
        g = sess.table("one").groupby("k").agg(s=("v", "sum"))
        out["split_exchanges"] = g.lower(sess.cfg).pplan.counts()[
            "hash_exchanges"]
        calls[0] = 0
        t = sess.collect(g)
        out["split_query_all_to_all"] = calls[0]
        out["split_rows"] = {k: v.tolist() for k, v in t.to_numpy().items()}
        recs = sess.stats()["records"]
        out["records"] = [[r.qid, r.cache] for r in recs]
        realized = dict(sess.store.realized)
    st.StatsStore.save = save
    out["saves"] = saves[0]
    out["sidecar_is_store"] = st.StatsStore.load(
        os.path.join(sdir, "stats.json")).realized == realized
    out["realized"] = len(realized)
    views = [None] * dist.get_world_size()
    dist.all_gather_object(views, out)
    return views


def seg_matrix(hf, zd, cfg):
    """collect_matrix at P = world: each rank's (capacity, k) block, every
    rank's count, and the valid rows of every block."""
    mat, counts, cap = Z["q26_features"](hf, zd).collect_matrix(
        list(Z["FEATURES"]), cfg)
    rows = [None] * dist.get_world_size()
    dist.all_gather_object(rows, mat[:int(counts[dist.get_rank()])].tolist())
    return {"counts": counts.tolist(), "cap": cap, "shape": list(mat.shape),
            "rows": rows}


def gather_list(t):
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, t.contiguous())
    return [p.tolist() for p in parts]


def direct_checks(rank, world):
    """The halo exchange with uneven counts, and the global rank kinds with
    tie runs straddling the rank boundary, called on each rank directly."""
    from repro_torch.core import physical as phys
    out = {}
    counts = [5, 7]
    x = torch.arange(8, dtype=torch.float32) + 100 * rank
    left, right = phys.halo_exchange(x, torch.tensor(counts[rank], dtype=torch.int32),
                                     2, 3, world)
    out["halo"] = [gather_list(left), gather_list(right)]
    # sample sort: rank 1 empty (it sends sentinel samples), composite
    # keys descending, both full; the rows' inputs and outputs gathered
    rng = np.random.default_rng(5 + rank)
    cap = 12
    for tag, counts, keys, asc in (("one_key", [9, 0], ("a",), True),
                                   ("two_desc", [3, 12], ("a", "b"), False),
                                   ("two_full", [12, 12], ("b", "a"), True)):
        cols = {"a": torch.tensor(rng.integers(0, 4, cap), dtype=torch.int32),
                "b": torch.tensor(rng.integers(-2, 2, cap), dtype=torch.float32),
                "v": torch.arange(cap, dtype=torch.int32) + 100 * rank}
        cnt = torch.tensor(counts[rank], dtype=torch.int32)
        got, cnt2, ovf = phys.sample_sort(cols, cnt, keys, P=world,
                                          bucket_cap=cap, cap_out=2 * cap,
                                          ascending=asc)
        out["sort_" + tag] = {
            "in": {k: gather_list(v) for k, v in cols.items()},
            "in_counts": counts,
            "out": {k: gather_list(v) for k, v in got.items()},
            "out_counts": gather_list(cnt2.reshape(1)),
            "overflow": bool(ovf)}
    x = torch.arange(12, dtype=torch.int32) + 100 * rank
    got, cnt2, ovf = phys.rebalance(
        {"x": x}, torch.tensor([2, 11][rank], dtype=torch.int32), P=world,
        bucket_cap=12, cap_out=12)
    out["rebalance"] = [gather_list(got["x"]), gather_list(cnt2.reshape(1)),
                        bool(ovf)]
    got, cnt2 = phys.limit({"x": x}, torch.tensor([5, 7][rank], dtype=torch.int32),
                           8, world, cap_out=8)
    out["limit"] = [gather_list(got["x"]), gather_list(cnt2.reshape(1))]
    keys = [[0, 1, 1, 2, 2, 2, 9, 9], [2, 2, 3, 3, 4, 9, 9, 9]][rank]
    cnt = torch.tensor([6, 5][rank], dtype=torch.int32)
    k = torch.tensor(keys, dtype=torch.int32)
    for kind in ("row_number", "rank", "dense_rank"):
        for method in ("allgather", "ladder"):
            r = phys.global_rank((k,), cnt, 8, kind, P=world, method=method)
            out[kind + "@" + method] = gather_list(r)
    return out


if __name__ == "__main__":
    import torch.multiprocessing as mp
    port, out = int(sys.argv[1]), sys.argv[2]
    mp.spawn(main, args=(2, port, out), nprocs=2, join=True)
'''


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_gloo_ranks(tmp_path):
    """P=2 on two gloo ranks: every query's rows equal the oracle's as a
    row set, and each run issues exactly the all_to_all count the plan's
    shuffle census states (two per exchange)."""
    script = tmp_path / "ranks.py"
    script.write_text("Q = {}\nexec(" + repr(QUERY_SRC) + ", Q)\n"
                      + "W = {}\nexec(" + repr(WINDOW_SRC) + ", W)\n"
                      + "S = {}\nexec(" + repr(SORT_SRC) + ", S)\n"
                      + "F = {}\nexec(" + repr(FRAME_SRC) + ", F)\n"
                      + "Z = {}\nexec(" + repr(SEG_SRC) + ", Z)\n"
                      + "G = {}\nexec(" + repr(GUARD_SRC) + ", G)\n"
                      + textwrap.dedent(RANK_SCRIPT))
    out = tmp_path / "res.json"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, str(script), str(_free_port()),
                           str(out)], env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    res = json.loads(out.read_text())
    runs = [(name, Q["QUERIES"][name], DATA) for name in NAMES]
    runs += [(name, W["WINDOW_QUERIES"][name.split("@")[0]], WDATA)
             for name in res if name in W["WINDOW_QUERIES"]
             or name.endswith("@ladder")]
    runs += [(name, S["SORT_QUERIES"][name], SDATA)
             for name in S["SORT_QUERIES"]]
    runs += [(name, FQ["FRAME_QUERIES"][name], FDATA)
             for name in FQ["FRAME_QUERIES"]]
    runs += [(name, Z["SEG_QUERIES"][name], ZDATA)
             for name in Z["SEG_QUERIES"]]
    assert len(runs) == len(NAMES) + len(W["WINDOW_QUERIES"]) \
        + len(W["GLOBAL_WINDOWS"]) + len(S["SORT_QUERIES"]) \
        + len(FQ["FRAME_QUERIES"]) + len(Z["SEG_QUERIES"])
    for name, build, data in runs:
        r = res[name]
        assert r["nshards"] == 2 and not r["overflow"], name
        got = {k: np.asarray(v, dtype=r["dtypes"][k])
               for k, v in r["cols"].items()}
        base = name.split("@")[0]
        if data is DATA:
            _assert_same_row_set(got, _oracle(name, DATA))
        elif data is SDATA:
            assert_sort_result(name, got, SDATA)
        elif data is FDATA:
            # each rank encoded the same host table: the dictionaries of
            # the P=1 frame decode the ranks' codes
            for c, dt in build(thf, FDATA).schema.items():
                if tdt.is_category(dt):
                    got[c] = tdt.dict_decode(got[c], tdt.categories_of(dt))
            FQ["assert_frame_result"](name, got, FDATA)
        elif data is ZDATA:
            Z["assert_seg_result"](name, got, ZDATA)
        else:
            assert_same_row_set(got, window_oracle(base, WDATA))
        census = build(rhf, data).physical_plan() \
            .shuffle_census(P=2)["all_to_all"]
        assert r["all_to_all"] == r["census"] == census, (name, r, census)
    # the persisted dimension's Q26 leg issues fewer all_to_all than the
    # cold leg
    assert res["q26_persisted"]["all_to_all"] < res["q26_cold"]["all_to_all"]
    # collect_matrix: 1D_BLOCK blocks of ceil(n / 2) and the rest, whose
    # rows together are the features' rows
    m = res["__seg_matrix__"]
    want = Z["q26_want"](ZDATA["ss"], ZDATA["it"])
    n = len(want["ss_customer_sk"])
    assert m["counts"] == [-(-n // 2), n - -(-n // 2)], m["counts"]
    assert m["shape"] == [m["cap"], len(Z["FEATURES"])]
    got = np.asarray(m["rows"][0] + m["rows"][1], dtype=np.float32)
    feats = np.stack([want[c] for c in Z["FEATURES"]], 1).astype(np.float32)
    np.testing.assert_array_equal(got[np.lexsort(got.T[::-1])],
                                  feats[np.lexsort(feats.T[::-1])])
    serve = res["__serve__"]
    rng = np.random.default_rng(2)           # serve_runs' table
    f = {"k": rng.integers(0, 13, 300).astype(np.int32),
         "v": rng.normal(size=300).astype(np.float32)}
    keys = np.unique(f["k"])
    sums = np.array([f["v"][f["k"] == k].astype(np.float64).sum()
                     for k in keys])
    want = {"k": keys, "s": sums,
            "c": np.array([(f["k"] == k).sum() for k in keys])}
    for r in serve:
        for rows in r["parity"] + [r["split_rows"]]:
            _assert_same_row_set(
                {k: np.asarray(v) for k, v in rows.items()},
                {k: want[k] for k in rows})
        # ticket order: six queries, then the split's group-by
        assert [q for q, _ in r["records"]] == list(range(1, 8)), r
        assert r["cache"][0] == "miss" and r["cache"].count("hit") >= 1
        assert r["split_all_to_all"] == 2, r      # the one re-exchange
        assert r["split_layout"][:3] == ["hash", ["k"], 2]
        assert sum(r["split_layout"][3]) == 300
        assert r["split_exchanges"] == 0 and r["split_query_all_to_all"] == 0
        assert r["sidecar_is_store"] and r["realized"] > 0
    assert serve[0]["records"] == serve[1]["records"]
    assert serve[0]["saves"] >= 1 and serve[1]["saves"] == 0
    guard = res["__guard__"]
    ps = guard["persisted_salted_join"]
    assert ps["same_on_every_rank"] and ps["sample_is_global"], ps["plan"]
    assert ps["sample_rows"] >= 256 and "Salt[build]" in ps["plan"], ps
    assert not ps["overflow"]
    want = G["skew_join"](rhf, GDATA).collect(rhf.ExecConfig()).to_numpy()
    _assert_same_row_set({k: np.asarray(v, dtype=np.asarray(want[k]).dtype)
                          for k, v in ps["cols"].items()}, want)
    for name, (build, kw, fault) in G["GUARD_RUNS"].items():
        r = guard[name]
        assert not r["overflow"] and r["failures"] == [], (name, r)
        assert sum(r["counts"]) == len(r["cols"]["k"]), name
        # every run of the retry loop: a healed retry reruns the plan, a
        # healed corruption reruns it unpacked
        packed, unpacked = r["census"]
        assert r["all_to_all"] == {"forced_overflow": 2 * packed,
                                   "corrupt_heal": packed + unpacked
                                   }.get(name, packed), (name, r)
        # the reference's rows at P = 1 (the FaultPlan changes nothing
        # there once healed)
        want = build(rhf, GDATA).collect(rhf.ExecConfig(**kw)).to_numpy()
        _assert_same_row_set({k: np.asarray(v, dtype=np.asarray(want[k]).dtype)
                              for k, v in r["cols"].items()}, want)
    assert [e[0] for e in guard["forced_overflow"]["events"]] == ["retry"]
    assert [e[0] for e in guard["corrupt_heal"]["events"]] == ["degrade_packed"]
    assert guard["salted_join"]["events"] == []
    # salting adds no collective: as many all_to_all as the unsalted join
    assert guard["salted_join"]["all_to_all"] \
        == guard["unsalted_join"]["all_to_all"]
    direct = res["__direct__"]
    # rank 0 holds 0..4 valid of 8 rows, rank 1 holds 100..106: the left
    # halo of rank 1 is rank 0's valid tail, the right halo of rank 0 is
    # rank 1's head; zeros at the global borders
    assert direct["halo"] == [[[0.0, 0.0], [3.0, 4.0]],
                              [[100.0, 101.0, 102.0], [0.0, 0.0, 0.0]]]
    keys = np.array([0, 1, 1, 2, 2, 2, 2, 2, 3, 3, 4])      # the valid rows
    want = {"row_number": np.arange(1, 12),
            "rank": np.searchsorted(keys, keys, side="left") + 1,
            "dense_rank": np.unique(keys, return_inverse=True)[1] + 1}
    for kind, w in want.items():
        for method in ("allgather", "ladder"):
            r = direct[kind + "@" + method]
            assert r[0][:6] + r[1][:5] == w.tolist(), (kind, method, r)
            assert r[0][6:] == [0, 0] and r[1][5:] == [0, 0, 0]
    # the sample sort: the ranks' valid outputs, concatenated, are the
    # valid inputs stably sorted (reversed when descending), rows whole
    for tag, keys, asc in (("one_key", ("a",), True),
                           ("two_desc", ("a", "b"), False),
                           ("two_full", ("b", "a"), True)):
        r = direct["sort_" + tag]
        assert not r["overflow"]
        inp = {k: np.concatenate([np.asarray(v[q][:r["in_counts"][q]])
                                  for q in range(2)])
               for k, v in r["in"].items()}
        order = np.lexsort([inp[k] for k in reversed(keys)])
        if not asc:
            order = order[::-1]
        oc = [c[0] for c in r["out_counts"]]
        for k, v in r["out"].items():
            got = np.concatenate([np.asarray(v[q][:oc[q]]) for q in range(2)])
            np.testing.assert_array_equal(got, inp[k][order], err_msg=tag + k)
        if tag == "two_full":     # the splitters split: no rank takes all
            assert min(oc) > 0, oc
    xs, cnts, ovf = direct["rebalance"]
    assert not ovf and [c[0] for c in cnts] == [7, 6]
    assert xs[0][:7] + xs[1][:6] == [0, 1] + list(range(100, 111))
    xs, cnts = direct["limit"]
    assert [c[0] for c in cnts] == [5, 3]
    assert xs[0][:5] + xs[1][:3] == [0, 1, 2, 3, 4, 100, 101, 102]
