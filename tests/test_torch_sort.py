"""Global sort, limit, rebalance, concat, layouts and persist: the port
against the reference.

The queries are written once against either package's ``hf`` (SORT_SRC).
At P=1 each runs on the port (CPU) and on the reference (Pallas kernels in
interpret mode) and the two must agree row for row and column by column:
exact for ints, bools and the sorted keys, floats within rtol=1e-4,
atol=1e-3.  Each is also held against a numpy oracle (``sort_oracle``): in
order where the query fixes the order, as a row set where it depends on
P.  The same queries run at P=2 on two gloo ranks inside the one spawn of
tests/test_torch_e2e.py, against the same oracles.  Persisting refuses an
overflowed result, and a reference ``persist()``ed frame carried over into
the port plans and answers as the reference's does.
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

from repro import hiframes as rhf  # noqa: E402
from repro.core import errors as rerr  # noqa: E402
from repro_torch import hiframes as thf  # noqa: E402
from repro_torch.core import errors as terr  # noqa: E402
from test_torch_window import _assert_same_rows  # noqa: E402

TCFG = dict(device="cpu")

SORT_SRC = '''
import numpy as np


def sort_data():
    rng = np.random.default_rng(2017)
    d = {}
    n = 700
    d["t"] = {"id": rng.integers(0, 40, n).astype(np.int32),
              "x": rng.normal(size=n).astype(np.float32),
              "y": rng.integers(-5, 5, n).astype(np.float32)}
    nk = 48      # bench_validate.py:20-32: keys in [0, n / 16)
    d["fact"] = {"k": rng.integers(0, nk, 800).astype(np.int32),
                 "v": rng.normal(size=800).astype(np.float32)}
    d["kdim"] = {"k": np.arange(nk, dtype=np.int32),
                 "w": rng.normal(size=nk).astype(np.float32)}
    d["ser"] = {"t": np.arange(600, dtype=np.int32),
                "x": rng.normal(size=600).astype(np.float32),
                "k": rng.integers(0, 25, 600).astype(np.int32)}
    d["ss"] = {"ss_item_sk": rng.integers(0, 40, 800).astype(np.int32),
               "ss_customer_sk": rng.integers(0, 70, 800).astype(np.int32)}
    d["it"] = {"i_item_sk": np.arange(40, dtype=np.int32),
               "i_class_id": rng.integers(1, 4, 40).astype(np.int32)}
    return d


def cfg_of(hf):
    """The config of a plan persisted inside a query: the port's on the
    CPU (tests) and the reference's default."""
    fields = hf.ExecConfig.__dataclass_fields__
    return hf.ExecConfig(**({"device": "cpu"} if "device" in fields else {}))


def sort_x(hf, d):
    return hf.table(d["t"]).sort_values("x")


def sort_desc_head(hf, d):
    return hf.table(d["t"]).sort_values("x", ascending=False).head(50)


def sort_two_keys_desc(hf, d):
    return hf.table(d["t"]).sort_values(("y", "id"), ascending=False)


def fig14_pipeline(hf, d):
    """bench_validate.py:20-32: group-by sum/count -> join -> sort."""
    fact, dim = hf.table(d["fact"], "fact"), hf.table(d["kdim"], "dim")
    agg = hf.aggregate(fact, "k", v_sum=("v", "sum"), v_cnt=("v", "count"))
    return hf.join(agg, dim, on="k").sort_values("v_sum")


def global_rank(hf, d):
    df = hf.table(d["ser"], "ser")
    r = hf.rank(df, None, "k", out="r")
    r = hf.dense_rank(r, None, "k", out="dr")
    return hf.row_number(r, None, "k", out="rn")


def sma_after_filter(hf, d):
    df = hf.table(d["ser"], "ser")
    f = df[df["x"] > 0.0]
    return hf.sma(f, f["x"], 3, out="s")


def concat_aggregate(hf, d):
    t, h = d["t"], len(d["t"]["id"]) // 2
    a = hf.table({k: v[:h] for k, v in t.items()}, "a")
    b = hf.table({k: v[h:] for k, v in t.items()}, "b")
    both = hf.concat(a, b)
    return hf.aggregate(both, "id", s=hf.sum_(both["x"]), n=hf.count())


def layout_verbs(hf, d):
    return hf.table(d["t"]).repartition("id").sort_within_partitions(("id", "x"))


def replicated_join(hf, d):
    return hf.join(hf.table(d["fact"], "fact"),
                   hf.table(d["kdim"], "dim").replicate(), on="k")


def q26_fluent(ss, item, min_count=4):
    """bench_tpcx.py:65-74, over any item-dimension frame."""
    si = ss.merge(item, on=("ss_item_sk", "i_item_sk"))
    c = si.groupby("ss_customer_sk").agg(
        c_i_count="count", id1=(si["i_class_id"] == 1, "sum"),
        id2=(si["i_class_id"] == 2, "sum"), id3=(si["i_class_id"] == 3, "sum"))
    return c[c["c_i_count"] > min_count]


def q26_cold(hf, d):
    return q26_fluent(hf.table(d["ss"], "ss"), hf.table(d["it"], "it"))


def q26_persisted(hf, d):
    """bench_tpcx.py:169-190: Q26 against a persisted item dimension."""
    pdim = (hf.table(d["it"], "it").groupby("i_item_sk")
            .agg(i_class_id=("i_class_id", "first")).persist(cfg_of(hf)))
    return q26_fluent(hf.table(d["ss"], "ss"), pdim)


def persisted_rank(hf, d):
    """A leaderboard: sorted once and persisted, then ranked by the same
    key with no second sort."""
    p = hf.table(d["ser"], "ser").sort_values("k").persist(cfg_of(hf))
    return hf.rank(p, None, "k", out="r")


SORT_QUERIES = {"sort_x": sort_x, "sort_desc_head": sort_desc_head,
                "sort_two_keys_desc": sort_two_keys_desc,
                "fig14_pipeline": fig14_pipeline, "global_rank": global_rank,
                "sma_after_filter": sma_after_filter,
                "concat_aggregate": concat_aggregate,
                "layout_verbs": layout_verbs,
                "replicated_join": replicated_join, "q26_cold": q26_cold,
                "q26_persisted": q26_persisted,
                "persisted_rank": persisted_rank}
'''

S: dict = {}
exec(SORT_SRC, S)
SDATA = S["sort_data"]()
SORT_NAMES = list(S["SORT_QUERIES"])

# queries whose row order the query fixes (at any P); the others are held
# as row sets
ORDERED = ("sort_x", "sort_desc_head", "sort_two_keys_desc", "global_rank",
           "sma_after_filter")


def _rows(cols: dict, idx) -> dict:
    return {k: np.asarray(v)[idx] for k, v in cols.items()}


def _ranks(k: np.ndarray) -> dict:
    """SQL rank, dense_rank and row_number of the sorted keys ``k``."""
    return {"r": (np.searchsorted(k, k, side="left") + 1).astype(np.int32),
            "dr": np.unique(k, return_inverse=True)[1].astype(np.int32) + 1,
            "rn": np.arange(1, len(k) + 1, dtype=np.int32)}


def sort_oracle(name: str, d: dict) -> dict:
    """numpy's answer to SORT_QUERIES[name].  A descending sort is the
    ascending stable order reversed, as both packages define it."""
    t = d["t"]
    if name == "sort_x":
        return _rows(t, np.argsort(t["x"], kind="stable"))
    if name == "sort_desc_head":
        return _rows(t, np.argsort(t["x"], kind="stable")[::-1][:50])
    if name == "sort_two_keys_desc":
        return _rows(t, np.lexsort([t["id"], t["y"]])[::-1])
    if name == "fig14_pipeline":
        f, dim = d["fact"], d["kdim"]
        nk = len(dim["k"])
        cnt = np.bincount(f["k"], minlength=nk)
        keys = np.flatnonzero(cnt)
        s = np.bincount(f["k"], weights=f["v"].astype(np.float64),
                        minlength=nk)
        out = {"k": keys.astype(np.int32), "v_sum": s[keys].astype(np.float32),
               "v_cnt": cnt[keys].astype(np.int32), "w": dim["w"][keys]}
        return _rows(out, np.argsort(s[keys], kind="stable"))
    if name == "global_rank":
        ser = d["ser"]
        out = _rows(ser, np.argsort(ser["k"], kind="stable"))
        out.update(_ranks(out["k"]))
        return out
    if name == "persisted_rank":
        ser = d["ser"]
        out = _rows(ser, np.argsort(ser["k"], kind="stable"))
        out["r"] = _ranks(out["k"])["r"]
        return out
    if name == "sma_after_filter":
        ser = d["ser"]
        f = _rows(ser, ser["x"] > np.float32(0))
        v = f["x"].astype(np.float64)
        ext = np.concatenate([[0.0], v, [0.0]])
        f["s"] = ((ext[:-2] + ext[1:-1] + ext[2:]) / 3).astype(np.float32)
        return f
    if name == "concat_aggregate":
        cnt = np.bincount(t["id"], minlength=40)
        keys = np.flatnonzero(cnt)
        s = np.bincount(t["id"], weights=t["x"].astype(np.float64),
                        minlength=40)
        return {"id": keys.astype(np.int32), "s": s[keys].astype(np.float32),
                "n": cnt[keys].astype(np.int32)}
    if name == "layout_verbs":
        return dict(t)
    if name == "replicated_join":
        f, dim = d["fact"], d["kdim"]
        return {"k": f["k"], "v": f["v"], "w": dim["w"][f["k"]]}
    # q26_cold / q26_persisted: the items are unique, so "first" is the class
    ss, it = d["ss"], d["it"]
    cls = it["i_class_id"][ss["ss_item_sk"]]
    cust = ss["ss_customer_sk"]
    n_c = np.bincount(cust, minlength=70)
    keys = np.flatnonzero(n_c > 4)
    out = {"ss_customer_sk": keys.astype(np.int32),
           "c_i_count": n_c[keys].astype(np.int32)}
    for c in (1, 2, 3):
        out[f"id{c}"] = np.bincount(cust, weights=(cls == c),
                                    minlength=70)[keys].astype(np.int32)
    return out


def _close(k, g, w):
    if np.issubdtype(w.dtype, np.floating):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-3, err_msg=k)
    else:
        np.testing.assert_array_equal(g, w.astype(g.dtype), err_msg=k)


def assert_sort_result(name: str, got: dict, d: dict):
    """``got`` holds the oracle's rows: in order for ORDERED queries (the
    sorted keys exact), else as a row set; fig14_pipeline's rows come out
    in non-decreasing v_sum (its float sums may tie differently)."""
    want = sort_oracle(name, d)
    assert sorted(got) == sorted(want), (name, sorted(got), sorted(want))
    got = {k: np.asarray(v) for k, v in got.items()}
    if name == "fig14_pipeline":
        assert np.all(np.diff(got["v_sum"]) >= 0), name
    if name not in ORDERED:
        names = sorted(want)
        go = np.lexsort([got[k] for k in reversed(names)])
        wo = np.lexsort([want[k] for k in reversed(names)])
        if name == "fig14_pipeline":       # keys are unique: order by them
            go, wo = np.argsort(got["k"]), np.argsort(want["k"])
        got, want = _rows(got, go), _rows(want, wo)
    for k in want:
        assert got[k].shape == want[k].shape, (name, k)
        _close(f"{name}.{k}", got[k], want[k])


@pytest.mark.parametrize("name", SORT_NAMES)
def test_sort_query_matches_reference_and_oracle(name):
    build = S["SORT_QUERIES"][name]
    tcfg = thf.ExecConfig(**TCFG)
    tdf = build(thf, SDATA)
    got = tdf.collect(tcfg)
    assert not got.overflow
    got = got.to_numpy()
    rdf = build(rhf, SDATA)
    want = rdf.collect(rhf.ExecConfig(use_pallas="interpret")).to_numpy()
    _assert_same_rows(got, want)
    assert_sort_result(name, got, SDATA)
    assert tdf.physical_plan(tcfg).counts() == rdf.physical_plan().counts()


def test_persisted_dimension_plans_fewer_exchanges():
    """Fig. 12's A/B: Q26 against the persisted dimension exchanges only
    the fact side, so it plans fewer shuffles than against the cold one;
    a sorted, persisted frame ranks with no sort at all."""
    cfg = thf.ExecConfig(**TCFG)
    plans = {n: S["SORT_QUERIES"][n](thf, SDATA).physical_plan(cfg)
             for n in ("q26_cold", "q26_persisted", "persisted_rank")}
    assert plans["q26_persisted"].shuffle_count() \
        < plans["q26_cold"].shuffle_count()
    assert plans["q26_persisted"].shuffle_census(P=8)["all_to_all"] \
        < plans["q26_cold"].shuffle_census(P=8)["all_to_all"]
    c = plans["persisted_rank"].counts()
    assert c["sample_sorts"] == c["local_sorts"] == c["hash_exchanges"] == 0


def test_persisted_shard_reenters_by_identity():
    """The persisted frame's columns are this rank's device shard, and the
    next plan's Source hands the same tensors over: nothing is copied."""
    cfg = thf.ExecConfig(**TCFG)
    df = thf.table(SDATA["t"])
    p = df.groupby("id").agg(s=("x", "sum")).persist(cfg)
    lay = p.node.layout
    assert lay.device_valid(1) and lay.nshards == 1
    assert all(v.shape == (lay.capacity,) for v in p.node.columns.values())
    low = p.lower(cfg)
    cols, cnt = low._source(low.pplan.ops[0])
    assert int(cnt) == int(lay.counts[0])
    for c, v in cols.items():
        assert v.data_ptr() == p.node.columns[c].data_ptr()
    want = p.node.columns["s"].clone()
    p.groupby("id").agg(s2=("s", "sum")).collect(cfg)
    assert p.node.columns["s"].equal(want)     # never written in place


@pytest.mark.parametrize("pkg", ["port", "reference"])
def test_persist_refuses_an_overflowed_result(pkg):
    hf, errors, kw = ((thf, terr, TCFG) if pkg == "port"
                      else (rhf, rerr, {}))
    d = SDATA["fact"]
    dim = {"k": np.zeros(30, np.int32), "w": np.ones(30, np.float32)}
    frame = hf.join(hf.table(d, "fact"), hf.table(dim, "dim"), on="k")
    cfg = hf.ExecConfig(safe_capacities=False, shuffle_slack=0.05,
                        auto_retry=0, **kw)
    with pytest.raises(errors.CapacityOverflow, match="persist.*op #"):
        frame.persist(cfg)


def test_carry_over_reference_persisted_state():
    """A reference persist()ed frame's columns and ScanLayout, as numpy,
    become a port persisted frame; the same downstream group-by plans the
    same ops and returns the same rows on both."""
    t = SDATA["t"]
    rp = rhf.table(t).groupby("id").agg(s=("x", "sum"), n=("x", "count")) \
        .persist(rhf.ExecConfig())
    state = {c: np.asarray(v) for c, v in rp.node.columns.items()}
    tp = thf.from_persisted_state(state, dataclasses.asdict(rp.node.layout),
                                  device="cpu")
    assert dataclasses.asdict(tp.node.layout).keys() \
        == dataclasses.asdict(rp.node.layout).keys()
    frames = [hf.aggregate(p, "id", m=hf.max_(p["s"]), c=hf.sum_(p["n"]))
              for hf, p in ((thf, tp), (rhf, rp))]
    tcfg, rcfg = thf.ExecConfig(**TCFG), rhf.ExecConfig()
    tplan, rplan = frames[0].lower(tcfg).pplan, frames[1].lower(rcfg).pplan
    assert [(type(o).__name__, o.cap, o.bucket) for o in tplan.ops] \
        == [(type(o).__name__, o.cap, o.bucket) for o in rplan.ops]
    assert tplan.counts() == rplan.counts()
    assert tplan.counts()["hash_exchanges"] == 0
    _assert_same_rows(frames[0].collect(tcfg).to_numpy(),
                      frames[1].collect(rcfg).to_numpy())


def test_replicated_persist_reenters_as_rep_host_table():
    cfg = thf.ExecConfig(**TCFG)
    p = thf.table(SDATA["kdim"], "dim").replicate().persist(cfg)
    assert p._replicated and p.node.layout.counts is None
    got = thf.join(thf.table(SDATA["fact"], "fact"), p, on="k") \
        .collect(cfg).to_numpy()
    assert_sort_result("replicated_join", got, SDATA)


def test_salt_op_is_refused_naming_item_8():
    """ROADMAP section 1 item 8 brought the salted join: the executor now
    runs a planned SaltOp, and nothing refuses it by naming the item."""
    from repro_torch.core import lower as tlower
    from repro_torch.core import physical_plan as tpp
    assert tpp.SaltOp in tlower._EXECUTED
    assert not hasattr(tlower, "_LATER")
    msg = tlower._unsupported(tpp.SaltOp.__new__(tpp.SaltOp))
    assert "item 8" not in msg and "SaltOp" in msg


def test_chip_smoke_fig12_plans_are_the_references():
    """chip_smoke.py holds the card's Fig. 12 legs to the reference's plan
    counts (shuffles, all_to_all) without importing the reference; both
    packages plan those numbers for the same frames."""
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    for hf, cfg in ((rhf, rhf.ExecConfig()), (thf, thf.ExecConfig(**TCFG))):
        ss, it = hf.table(SDATA["ss"], "ss"), SDATA["it"]
        legs = {"cold": hf.table(it, "it"),
                "persisted": cs.persisted_dim(hf, it, cfg)}
        for leg, item in legs.items():
            plan = cs.q26_fluent(ss, item).physical_plan(cfg)
            assert (plan.shuffle_count(), plan.collective_count()) \
                == cs.Q26_LEGS[leg], (hf.__name__, leg)
