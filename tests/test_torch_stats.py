"""Adaptive statistics in the port, held against the reference on the CPU.

The same seeded numpy inputs go through ``repro`` and ``repro_torch``: the
sampled StatsContext (row estimates, distinct counts, heavy hitters, hot
fractions), the structural plan fingerprint, the adaptive plans of
tests/test_skew.py's shapes (salted skew join, Zipf aggregate auto caps,
cheap-side re-exchange, the uniform on/off identity) with their render()
and P=8 shuffle census, realized feedback on a second run, the stats store's
JSON sidecar, and explain()'s whole text for Fig. 8a's aggregate and Q26.
"""
import dataclasses
import json
import re

import numpy as np
import pytest

pytest.importorskip("torch")

from repro import hiframes as rhf  # noqa: E402
from repro.core import ir as rir  # noqa: E402
from repro.core import physical_plan as rpp  # noqa: E402
from repro.core import stats as rst  # noqa: E402
from repro.runtime import retry as rrt  # noqa: E402
from repro_torch import hiframes as thf  # noqa: E402
from repro_torch.core import ir as tir  # noqa: E402
from repro_torch.core import physical_plan as tpp  # noqa: E402
from repro_torch.core import stats as tst  # noqa: E402
from repro_torch.runtime import retry as trt  # noqa: E402
from test_torch_e2e import DATA, Q  # noqa: E402

TCFG = dict(device="cpu")
PKG = {"ref": (rhf, rir, rpp, rst, {}), "port": (thf, tir, tpp, tst, TCFG)}


@pytest.fixture(autouse=True)
def _fresh_stores():
    """Both packages keep process-global stores keyed by plan fingerprint."""
    for st, rt in ((rst, rrt), (tst, trt)):
        st.clear_realized()
        rt.clear_events()
    yield
    for st, rt in ((rst, rrt), (tst, trt)):
        st.clear_realized()
        rt.clear_events()


def _skewed(n=4000, m=90, hot_frac=0.35, seed=7):
    """tests/test_skew.py::_skewed: one hot key over a covering dimension."""
    rng = np.random.default_rng(seed)
    k = rng.integers(0, m, n).astype(np.int32)
    k[: int(hot_frac * n)] = 3
    rng.shuffle(k)
    probe = {"k": k, "v": rng.normal(size=n).astype(np.float32)}
    dim = {"k": np.arange(m, dtype=np.int32),
           "w": rng.normal(size=m).astype(np.float32)}
    return probe, dim


def _zipf(n=16000, seed=4):
    rng = np.random.default_rng(seed)
    return {"k": rng.zipf(1.5, n).astype(np.int32),
            "v": rng.normal(size=n).astype(np.float32)}


def skew_join(hf, how="inner"):
    probe, dim = _skewed()
    return hf.table(probe, "probe").merge(hf.table(dim, "dim"), on="k",
                                          how=how)


def skew_join_filtered(hf):
    probe, dim = _skewed()
    p = hf.table(probe, "probe")
    return p[p["v"] > -0.5].merge(hf.table(dim, "dim"), on="k")


def zipf_agg(hf):
    return hf.table(_zipf(), "z").groupby("k").agg(s=("v", "sum"),
                                                   c=("v", "count"))


def uniform_join(hf):
    rng = np.random.default_rng(11)
    n, m = 4000, 90
    probe = {"k": rng.integers(0, m, n).astype(np.int32),
             "v": rng.normal(size=n).astype(np.float32)}
    dim = {"k": np.arange(m, dtype=np.int32),
           "w": rng.normal(size=m).astype(np.float32)}
    return hf.table(probe, "probe").merge(hf.table(dim, "dim"), on="k")


def uniform_agg(hf):
    rng = np.random.default_rng(11)
    u = {"k": rng.integers(0, 1 << 30, 4000).astype(np.int32),
         "v": rng.normal(size=4000).astype(np.float32)}
    return hf.table(u, "u").groupby("k").agg(s=("v", "sum"))


def q26_frame(hf):
    return Q["QUERIES"]["q26"](hf, DATA)


def agg8a_frame(hf):
    return Q["QUERIES"]["fig8a_aggregate"](hf, DATA)


def _mixed(hf, cfg, big_left: bool):
    """tests/test_skew.py::_mixed_alignment_join: two persisted sides
    aligned on different join-key positions."""
    rng = np.random.default_rng(9)
    nl, nr = (6000, 300) if big_left else (300, 6000)
    left = hf.table({"k1": rng.integers(0, 7, nl).astype(np.int32),
                     "k2": rng.integers(0, 9, nl).astype(np.int32),
                     "x": rng.normal(size=nl).astype(np.float32)},
                    "L").repartition(by="k1").persist(cfg, name="Lp")
    right = hf.table({"ca": rng.integers(0, 7, nr).astype(np.int32),
                      "cb": rng.integers(0, 9, nr).astype(np.int32),
                      "w": rng.normal(size=nr).astype(np.float32)},
                     "R").repartition(by="cb").persist(cfg, name="Rp")
    return left.merge(right, on=[("k1", "ca"), ("k2", "cb")])


FRAMES = {"skew_join": skew_join, "skew_join_left": lambda hf: skew_join(hf, "left"),
          "skew_join_filtered": skew_join_filtered, "zipf_agg": zipf_agg,
          "uniform_join": uniform_join, "uniform_agg": uniform_agg,
          "q26": q26_frame, "fig8a_aggregate": agg8a_frame}


def _cfg(which, **kw):
    hf, *_rest, base = PKG[which]
    return hf.ExecConfig(**base, **kw)


def _ctx(which, frame, adaptive=True):
    """The planner's StatsContext over the optimized, rebalanced root."""
    hf, ir, pp, st, base = PKG[which]
    df = FRAMES[frame](hf)
    cfg = _cfg(which, adaptive_stats=adaptive)
    root, _info, _plan = df._plan(cfg)
    return root, st.analyze(root, cfg), ir


def _plan_view(plan):
    return [(type(op).__name__, op.short(), op.inputs, op.part.short(),
             op.order.short(), op.dist, dict(op.schema), op.cap, op.bucket,
             op.rows_est, getattr(op, "ndv_est", None),
             getattr(op, "ndv_src", None)) for op in plan.ops]


# -- the sampled statistics -------------------------------------------------


@pytest.mark.parametrize("frame", sorted(FRAMES))
def test_stats_context_matches_reference(frame):
    got = {}
    for which in ("ref", "port"):
        root, ctx, ir = _ctx(which, frame)
        nodes = ir.topo_order(root)
        rec = {"rows": [ctx.rows_est.get(n.id) for n in nodes]}
        for i, n in enumerate(nodes):
            keys = (n.left_on if isinstance(n, ir.Join) else
                    n.key if isinstance(n, ir.Aggregate) else None)
            if keys is None:
                continue
            child = n.children[0]
            rec[i] = (ctx.ndv(child, keys), ctx.ndv_cap(child, keys),
                      ctx.hot_keys(child, keys, 0.1),
                      ctx.hot_fraction(child, keys,
                                       ctx.hot_keys(child, keys, 0.1)),
                      dataclasses.astuple(ctx.key_stats(child, keys)))
        got[which] = rec
    assert got["port"] == got["ref"]


def test_skew_join_hot_key_is_found():
    root, ctx, ir = _ctx("port", "skew_join")
    j = next(n for n in ir.topo_order(root) if isinstance(n, ir.Join))
    hot = ctx.hot_keys(j.left, j.left_on, 0.1)
    assert [k for k, _f in hot] == [(3,)]
    assert 0.3 < hot[0][1] < 0.45


@pytest.mark.parametrize("frame", sorted(FRAMES))
def test_plan_fingerprint_matches_reference(frame):
    fps = []
    for which in ("ref", "port"):
        root, _ctx_, _ir = _ctx(which, frame)
        st = PKG[which][3]
        fps.append((st.plan_fingerprint(root),
                    st.plan_fingerprint(root, scans="shape")))
    assert fps[0] == fps[1]


def test_estimate_keys_and_even_positions_match_reference():
    rng = np.random.default_rng(3)
    cols = [rng.zipf(1.3, 300).astype(np.int32),
            rng.integers(0, 5, 300).astype(np.int32)]
    for total in (300, 10_000, 1 << 24):
        assert dataclasses.astuple(tst.estimate_keys(cols, total)) \
            == dataclasses.astuple(rst.estimate_keys(cols, total))
    assert dataclasses.astuple(tst.estimate_keys([], 50)) \
        == dataclasses.astuple(rst.estimate_keys([], 50))
    for n, k in ((0, 5), (7, 3), (100, 256), (1 << 20, 256)):
        np.testing.assert_array_equal(tst._even_positions(n, k),
                                      rst._even_positions(n, k))


def test_persisted_scan_sample_matches_reference():
    """A persisted frame: the port samples its own device shard at the
    positions the reference reads from its global arrays."""
    probe, _dim = _skewed()
    samples = []
    for which in ("ref", "port"):
        hf, ir, _pp, st, base = PKG[which]
        p = hf.table(probe, "probe").repartition(by="k").persist(
            hf.ExecConfig(**base), name="pp")
        samples.append(st.sample_scan(p.node, ("k", "v"), 64))
    for c in ("k", "v"):
        np.testing.assert_array_equal(samples[1][c], samples[0][c])


# -- the adaptive plans -----------------------------------------------------


@pytest.mark.parametrize("frame", ["skew_join", "skew_join_left",
                                   "skew_join_filtered", "zipf_agg",
                                   "uniform_join", "uniform_agg", "q26"])
@pytest.mark.parametrize("adaptive", [True, False], ids=["on", "off"])
def test_adaptive_plan_matches_reference(frame, adaptive):
    plans = {}
    for which in ("ref", "port"):
        hf = PKG[which][0]
        df = FRAMES[frame](hf)
        cfg = _cfg(which, adaptive_stats=adaptive, safe_capacities=False,
                   auto_retry=0)
        plans[which] = (df.physical_plan(cfg), df.lower(cfg).pplan)
    (tp, tl), (rp, rl) = plans["port"], plans["ref"]
    assert tp.render() == rp.render()
    assert tp.shuffle_census(P=8) == rp.shuffle_census(P=8)
    assert _plan_view(tl) == _plan_view(rl)
    assert tl.shuffle_census(P=8) == rl.shuffle_census(P=8)


def test_salted_plan_shape():
    plan = skew_join(thf).physical_plan(_cfg("port", adaptive_stats=True))
    assert plan.counts()["salt_ops"] == 2, plan.render()
    mj = [op for op in plan.ops if isinstance(op, tpp.MergeJoin)]
    assert len(mj) == 1 and mj[0].salted and "__salt__" not in mj[0].schema
    off = skew_join(thf).physical_plan(_cfg("port"))
    assert off.counts()["salt_ops"] == 0
    assert plan.collective_count() == off.collective_count()


def test_zipf_auto_cap_matches_reference():
    caps = []
    for which in ("ref", "port"):
        hf, _ir, pp, _st, _b = PKG[which]
        plan = zipf_agg(hf).lower(_cfg(which, adaptive_stats=True,
                                       safe_capacities=False,
                                       auto_retry=0)).pplan
        pa = [op for op in plan.ops if isinstance(op, pp.PartialAgg)]
        assert len(pa) == 1
        caps.append((pa[0].ndv_est, pa[0].ndv_src, pa[0].cap, pa[0].bucket,
                     plan.ops[pa[0].inputs[0]].cap))
    assert caps[0] == caps[1]
    ndv, src, cap, _bucket, src_cap = caps[1]
    assert src == "sample" and ndv is not None and 0 < cap < src_cap


@pytest.mark.parametrize("big_left", [True, False])
def test_cheap_side_reexchange_matches_reference(big_left):
    out = {}
    for which in ("ref", "port"):
        hf, _ir, pp, _st, base = PKG[which]
        j = _mixed(hf, hf.ExecConfig(**base), big_left)
        plans = [j.physical_plan(_cfg(which, adaptive_stats=a))
                 for a in (False, True)]
        out[which] = ([[op.keys for op in p.ops
                        if isinstance(op, pp.HashExchange)] for p in plans],
                      [p.render() for p in plans],
                      j.collect(_cfg(which, adaptive_stats=True)).to_numpy())
    assert out["port"][0] == out["ref"][0]
    assert out["port"][0][1] == ([("ca",)] if big_left else [("k2",)])
    assert out["port"][1] == out["ref"][1]
    got, want = out["port"][2], out["ref"][2]
    oi = np.lexsort([got[c] for c in sorted(got)])
    ri = np.lexsort([np.asarray(want[c]) for c in sorted(want)])
    for c in want:
        np.testing.assert_allclose(got[c][oi], np.asarray(want[c])[ri],
                                   atol=1e-5)


# -- runs: rows, realized feedback, the store -------------------------------


@pytest.mark.parametrize("how", ["inner", "left"])
def test_salted_join_rows_match_reference(how):
    rows = []
    for which in ("ref", "port"):
        t = skew_join(PKG[which][0], how).collect(
            _cfg(which, adaptive_stats=True))
        assert not t.overflow
        rows.append({k: np.asarray(v) for k, v in t.to_numpy().items()})
    want, got = rows
    assert set(got) == set(want)
    oi = np.lexsort([got[c] for c in sorted(got)])
    ri = np.lexsort([want[c] for c in sorted(want)])
    for c in want:
        np.testing.assert_array_equal(got[c][oi], want[c][ri], err_msg=c)


def test_realized_feedback_on_second_run_matches_reference():
    res = {}
    for which in ("ref", "port"):
        hf, _ir, pp, st, _b = PKG[which]
        ag = zipf_agg(hf)
        cfg = _cfg(which, adaptive_stats=True, safe_capacities=False,
                   auto_retry=0)
        t = ag.collect(cfg)
        assert not t.overflow
        plan2 = ag.lower(cfg).pplan
        pa = [op for op in plan2.ops if isinstance(op, pp.PartialAgg)][0]
        t2 = ag.collect(cfg)
        res[which] = (pa.ndv_src, pa.ndv_est, pa.cap,
                      int(np.sum(np.asarray(t2.counts))),
                      canon_ids(ag.explain(cfg)))
    assert res["port"] == res["ref"]
    true_groups = len(np.unique(_zipf()["k"]))
    assert res["port"][:4] == ("realized", true_groups,
                               max(64, true_groups), true_groups)
    assert "realized (previous run)" in res["port"][4]


def test_stats_store_save_load_round_trip(tmp_path):
    docs = {}
    for which in ("ref", "port"):
        hf, _ir, _pp, st, _b = PKG[which]
        rt = rrt if which == "ref" else trt
        zipf_agg(hf).collect(_cfg(which, adaptive_stats=True))
        rt.record_events(zipf_agg(hf).node,
                         (rt.RetryEvent("retry", 1, 4, "exchange cap 8 -> 9"),))
        path = tmp_path / f"{which}.json"
        st.current_store().save(str(path))
        docs[which] = json.loads(path.read_text())
        back = st.StatsStore.load(str(path))
        assert back.realized == st.current_store().realized
        assert back.events == st.current_store().events
    assert docs["port"] == docs["ref"]
    bad = tmp_path / "bad.json"
    bad.write_text('{"version": 1, "realized": {"x": {"rows": "?"}}}')
    from repro_torch.core.errors import StatsError
    with pytest.raises(StatsError, match="corrupt stats sidecar"):
        tst.StatsStore.load(str(bad))


def canon_ids(txt: str) -> str:
    """explain() text with the logical plan's node ids (process-local
    counters, also in its column references) renumbered in order of
    appearance; the physical op ids after the blank line are plan
    positions and stay."""
    head, sep, tail = txt.partition("\n\n")
    ids: dict = {}
    head = re.sub(r"(#|col\()(\d+)",
                  lambda m: "%sn%d" % (m.group(1),
                                       ids.setdefault(m.group(2), len(ids))),
                  head)
    return head + sep + tail


@pytest.mark.parametrize("frame", ["fig8a_aggregate", "q26"])
@pytest.mark.parametrize("adaptive", [False, True], ids=["static", "adaptive"])
def test_explain_text_matches_reference(frame, adaptive):
    """The whole explain() text: logical plan, schema, physical plan with
    its est~ annotations, the stats: tail, and after a run the realized
    counts (logical node ids renumbered, ``canon_ids``)."""
    texts = {}
    for which in ("ref", "port"):
        df = FRAMES[frame](PKG[which][0])
        cfg = _cfg(which, adaptive_stats=adaptive)
        before = df.explain(cfg)
        df.collect(cfg)
        texts[which] = (canon_ids(before), canon_ids(df.explain(cfg)))
    assert texts["port"] == texts["ref"]
    assert "est~" in texts["port"][0] and "stats: " in texts["port"][0]
    assert ("realized (previous run)" in texts["port"][1]) == adaptive
