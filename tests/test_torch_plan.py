"""Planner parity: on the main-path pipelines of tests/test_plan_census.py
(join -> aggregate on the join keys, the elision/partial-agg baselines, the
wide table, partial aggregation with and without a group cap, packed and
per-column exchanges), on the Fig. 8a / Q26 queries and on window pipelines
(a partitioned window after a join, with and without elision; chained
grouped windows; a window after an aggregate on its keys; global cumsums,
row numbers and stencils), the port plans the
same physical op list, the same capacities, the same ``counts()`` and the
same ``shuffle_census(P=8)`` as the reference.
"""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro import hiframes as rhf  # noqa: E402
from repro_torch import hiframes as thf  # noqa: E402


def _frames(n=400, m=60, seed=3):
    rng = np.random.default_rng(seed)
    left = {"k1": rng.integers(0, 7, n).astype(np.int32),
            "k2": rng.integers(0, 9, n).astype(np.int32),
            "t": rng.permutation(n).astype(np.int32),
            "x": rng.normal(size=n).astype(np.float32)}
    right = {"ca": rng.integers(0, 7, m).astype(np.int32),
             "cb": rng.integers(0, 9, m).astype(np.int32),
             "w": rng.normal(size=m).astype(np.float32)}
    return left, right


def join_agg(hf):
    left, right = _frames()
    j = hf.join(hf.table(left), hf.table(right, "d"),
                on=[("k1", "ca"), ("k2", "cb")])
    return hf.aggregate(j, by=("k1", "k2"), s=hf.sum_(j["w"]), c=hf.count())


def join_count(hf):
    left, right = _frames()
    j = hf.join(hf.table(left), hf.table(right, "d"),
                on=[("k1", "ca"), ("k2", "cb")])
    return hf.aggregate(j, by=("k1", "k2"), c=hf.count())


def wide(hf):
    rng = np.random.default_rng(8)
    t = {f"c{i}": rng.normal(size=300).astype(np.float32) for i in range(8)}
    t["k"] = rng.integers(0, 5, 300).astype(np.int32)
    df = hf.table(t)
    return hf.aggregate(df, "k", **{f"s{i}": hf.sum_(df[f"c{i}"])
                                    for i in range(8)})


def partial(hf):
    left, _ = _frames()
    df = hf.table(left)
    return hf.aggregate(df, "k1", s=hf.sum_(df["x"]), c=hf.count())


def fig8a_filter(hf):
    rng = np.random.default_rng(0)
    df = hf.table({"id": rng.integers(0, 50, 500).astype(np.int32),
                   "x": rng.normal(size=500).astype(np.float32),
                   "y": rng.normal(size=500).astype(np.float32)})
    return df[df.x < 0.5]


def fig8a_join(hf):
    rng = np.random.default_rng(1)
    left = {"id": rng.integers(0, 40, 300).astype(np.int32),
            "x": rng.normal(size=300).astype(np.float32)}
    right = {"cid": np.arange(40, dtype=np.int32),
             "w": rng.normal(size=40).astype(np.float32)}
    return hf.join(hf.table(left, "l"), hf.table(right, "r"), on=("id", "cid"))


def q26(hf):
    rng = np.random.default_rng(2)
    ss = {"ss_item_sk": rng.integers(0, 30, 400).astype(np.int32),
          "ss_customer_sk": rng.integers(0, 50, 400).astype(np.int32)}
    it = {"i_item_sk": np.arange(30, dtype=np.int32),
          "i_class_id": rng.integers(1, 17, 30).astype(np.int32)}
    si = hf.join(hf.table(ss, "ss"), hf.table(it, "it"),
                 on=("ss_item_sk", "i_item_sk"))
    c = hf.aggregate(si, "ss_customer_sk", c_i_count=hf.count(),
                     id1=hf.sum_(si["i_class_id"] == 1),
                     id2=hf.sum_(si["i_class_id"] == 2))
    return c[c["c_i_count"] > 4]


def join_window(hf):
    left, right = _frames()
    j = hf.join(hf.table(left), hf.table(right, "d"), on=("k1", "ca"))
    return hf.wma(j, j["x"] * j["w"], [1, 2, 1], out="v", partition_by="k1",
                  order_by="t")


def grouped_windows(hf):
    left, _ = _frames()
    df = hf.table(left)
    a = df.over("k1", order_by="t").cumsum(df["x"], out="c")
    b = a.over("k1", order_by="t").rolling_mean(a["c"], 7, out="m", exact=True)
    return b.over(("k1", "k2"), order_by="t").rank(out="r")


def agg_then_window(hf):
    left, _ = _frames()
    df = hf.table(left)
    a = hf.aggregate(df, "k1", s=hf.sum_(df["x"]))
    return a.over("k1").row_number(out="r")


def global_windows(hf):
    left, _ = _frames()
    df = hf.table(left)
    c = hf.cumsum(df, df["x"], out="c")
    f = c[c["x"] < 0.5]
    return hf.row_number(hf.cumsum(f, f["c"], out="cc"), None, out="r")


def global_stencil(hf):
    left, _ = _frames()
    df = hf.table(left)
    w = hf.wma(df, df["x"], [1, 2, 1], out="w")
    return hf.rolling_mean(w, w["w"], 5, out="m", exact=True)


CASES = [
    ("join_agg_same_keys", join_agg, {}),
    ("join_agg_baseline", join_count,
     {"elide_exchanges": False, "partial_agg": False}),
    ("join_agg_no_elision", join_count, {"elide_exchanges": False}),
    ("join_agg_per_column", join_agg, {"packed_exchange": False}),
    ("wide_table", wide, {"partial_agg": False}),
    ("wide_table_per_column", wide,
     {"partial_agg": False, "packed_exchange": False}),
    ("partial_agg", partial, {}),
    ("partial_agg_capped", partial, {"agg_group_cap": 8}),
    ("fig8a_filter", fig8a_filter, {}),
    ("fig8a_join", fig8a_join, {}),
    ("q26", q26, {}),
    ("q26_unsafe_caps", q26, {"safe_capacities": False}),
    ("join_window", join_window, {}),
    ("join_window_no_elision", join_window, {"elide_exchanges": False}),
    ("grouped_windows", grouped_windows, {}),
    ("agg_then_window", agg_then_window, {}),
    ("global_windows", global_windows, {}),
    ("global_stencil", global_stencil, {}),
]


def _ops(plan):
    return [(type(op).__name__, op.short(), op.inputs, op.part.short(),
             op.order.short(), op.dist, dict(op.schema), op.cap, op.bucket)
            for op in plan.ops]


@pytest.mark.parametrize("name,build,kw", CASES, ids=[c[0] for c in CASES])
def test_plan_matches_reference(name, build, kw):
    rcfg = rhf.ExecConfig(**kw)
    tcfg = thf.ExecConfig(device="cpu", **kw)
    rdf, tdf = build(rhf), build(thf)
    # planned ops, properties, schemas and capacities (capacities are
    # written when the plan is lowered)
    rplan, tplan = rdf.lower(rcfg).pplan, tdf.lower(tcfg).pplan
    assert _ops(tplan) == _ops(rplan)
    assert tplan.counts() == rplan.counts()
    assert tplan.collective_count() == rplan.collective_count()
    assert tplan.shuffle_row_bytes() == rplan.shuffle_row_bytes()
    assert tplan.shuffle_census(P=8) == rplan.shuffle_census(P=8)
    # introspection path (no capacities) and the explain() census header
    assert _ops(tdf.physical_plan(tcfg)) == _ops(rdf.physical_plan(rcfg))
    theader = tdf.explain(tcfg).split("\n\n")[1].splitlines()[0]
    rheader = rdf.explain(rcfg).split("\n\n")[1].splitlines()[0]
    assert theader == rheader
