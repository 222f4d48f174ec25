"""Planner parity: on the main-path pipelines of tests/test_plan_census.py
(join -> aggregate on the join keys, the elision/partial-agg baselines, the
wide table, partial aggregation with and without a group cap, packed and
per-column exchanges), on the Fig. 8a / Q26 queries and on window pipelines
(a partitioned window after a join, with and without elision; chained
grouped windows; a window after an aggregate on its keys; global cumsums,
row numbers and stencils), the port plans the
same physical op list, the same capacities, the same ``counts()`` and the
same ``shuffle_census(P=8)`` as the reference.  So it does on sorts
(ascending and descending, one key and two, head after a sort), concat,
a global rank with ``order_by``, a global stencil after a filter (a
Rebalance under it), ``repartition`` + ``sort_within_partitions``, a
replicated dimension table, and persisted frames (hash-partitioned,
grouped, globally sorted, replicated) feeding a group-by, merge, window or
sort on their keys; and on the frame path's queries (FRAME_SRC): Q05 with
string and with int categories, Q09's channel rollup, the frame verbs, the
null-row filter, the concat that recodes its parts' dictionaries and the
merge on category keys.
"""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro import hiframes as rhf  # noqa: E402
from repro_torch import hiframes as thf  # noqa: E402
from torch_frame_queries import FRAME_SRC  # noqa: E402

F: dict = {}
exec(FRAME_SRC, F)
FDATA = F["frame_data"]()


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


def _cfg(hf):
    """Each package's config for the plans persisted inside a case: the
    port's on the CPU."""
    fields = hf.ExecConfig.__dataclass_fields__
    return hf.ExecConfig(**({"device": "cpu"} if "device" in fields else {}))


def sort_one(hf):
    left, _ = _frames()
    return hf.table(left).sort_values("x")


def sort_two_desc_head(hf):
    left, _ = _frames()
    return hf.table(left).sort_values(("k1", "t"), ascending=False).head(17)


def concat_parts(hf):
    left, _ = _frames()
    df = hf.table(left)
    both = hf.concat(df[df["x"] < 0.0], df[df["x"] > 0.5])
    return hf.aggregate(both, "k1", s=hf.sum_(both["x"]))


def global_rank(hf):
    left, _ = _frames()
    df = hf.table(left)
    return hf.dense_rank(hf.rank(df, None, "k1", out="r"), None, "k1",
                         out="d", ascending=False)


def stencil_after_filter(hf):
    left, _ = _frames()
    df = hf.table(left)
    f = df[df["x"] > 0.0]
    return hf.sma(f, f["x"], 3, out="s")


def layout_verbs(hf):
    left, _ = _frames()
    return hf.table(left).repartition("k1").sort_within_partitions(("k1", "t"))


def replicated_dim(hf):
    left, right = _frames()
    return hf.join(hf.table(left), hf.table(right, "d").replicate(),
                   on=("k1", "ca"))


def persisted_groupby(hf):
    left, _ = _frames()
    p = hf.table(left).repartition("k1").persist(_cfg(hf))
    return hf.aggregate(p, "k1", s=hf.sum_(p["x"]))


def persisted_merge(hf):
    left, right = _frames()
    df = hf.table(left)
    p = hf.aggregate(df, "k1", s=hf.sum_(df["x"])).persist(_cfg(hf))
    return hf.join(hf.table(right, "d"), p, on=("ca", "k1"))


def persisted_over(hf):
    left, _ = _frames()
    p = hf.table(left).repartition("k1").sort_within_partitions(
        ("k1", "t")).persist(_cfg(hf))
    return p.over("k1", order_by="t").cumsum(p["x"], out="c")


def persisted_sort(hf):
    left, _ = _frames()
    p = hf.table(left).sort_values("t").persist(_cfg(hf))
    return hf.row_number(p.sort_values("t"), None, "t", out="r")


def persisted_replicated(hf):
    left, right = _frames()
    p = hf.table(right, "d").replicate().persist(_cfg(hf))
    return hf.join(hf.table(left), p, on=("k1", "ca"))


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
    ("sort_one_key", sort_one, {}),
    ("sort_one_key_unsafe_caps", sort_one, {"safe_capacities": False}),
    ("sort_two_keys_desc_head", sort_two_desc_head, {}),
    ("concat", concat_parts, {}),
    ("global_rank_order_by", global_rank, {}),
    ("stencil_after_filter", stencil_after_filter, {}),
    ("repartition_sort_within", layout_verbs, {}),
    ("replicated_dim", replicated_dim, {}),
    ("persisted_groupby", persisted_groupby, {}),
    ("persisted_merge", persisted_merge, {}),
    ("persisted_over", persisted_over, {}),
    ("persisted_sort", persisted_sort, {}),
    ("persisted_replicated", persisted_replicated, {}),
] + [(case, (lambda hf, q=F["FRAME_QUERIES"][name]: q(hf, FDATA)), kw)
     for case, name, kw in (
         ("q05_string", "q05_string", {}), ("q05_int", "q05_int", {}),
         ("q05_string_no_elision", "q05_string", {"elide_exchanges": False}),
         ("q09_channel", "q09_channel", {}),
         ("frame_verbs", "frame_verbs", {}), ("null_rows", "null_rows", {}),
         ("concat_recoding", "concat_channels", {}),
         ("merge_category_keys", "merge_category_keys", {}),
         ("merge_category_keys_per_column", "merge_category_keys",
          {"packed_exchange": False}))]


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
