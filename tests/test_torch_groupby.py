"""GroupBy sugar on the port against the reference: column selection,
``size``, the whole-frame reductions, ``transform`` and ``head``.

Each case builds the same frame with either package's ``hf`` on the same
numpy inputs and runs it on the port (CPU) and on the reference (Pallas
kernels in interpret mode).  Results are compared as rows ordered by the
group keys (and by every column where rows are kept whole), with the same
dtypes, ints and strings exact, floats within rtol=1e-4.  The cases are
those of tests/test_api_v2.py (the sugar, ``size``, min/max of a bool
column, ``__getitem__`` and its errors) and tests/test_skew.py (transform
in both spellings with its name clash, head's rows and plan), plus the
numeric-only sweep over a category column.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import hiframes as rhf  # noqa: E402
from repro_torch import hiframes as thf  # noqa: E402

TCFG = thf.ExecConfig(device="cpu")
RCFG = rhf.ExecConfig(use_pallas="interpret")
SUGAR = ("sum", "mean", "min", "max", "prod", "any", "all", "count",
         "nunique")


def _frame(n=600, seed=7):
    """tests/test_api_v2.py's frame."""
    rng = np.random.default_rng(seed)
    return {"k1": rng.integers(0, 8, n).astype(np.int32),
            "k2": rng.integers(0, 5, n).astype(np.int32),
            "t": rng.permutation(n).astype(np.int32),
            "x": rng.normal(size=n).astype(np.float32),
            "y": rng.normal(size=n).astype(np.float32),
            "b": rng.integers(0, 2, n) > 0}


def _cfg(hf, cfg=None):
    return cfg if cfg is not None else (TCFG if hf is thf else RCFG)


def _rows(d: dict, keys) -> dict:
    order = np.lexsort([np.asarray(d[k]) for k in reversed(list(keys))])
    return {k: np.asarray(v)[order] for k, v in d.items()}


def _same(got: dict, want: dict, keys, rtol=1e-4, atol=1e-5):
    assert sorted(got) == sorted(want), (sorted(got), sorted(want))
    g, w = _rows(got, keys), _rows(want, keys)
    for c in w:
        assert g[c].dtype == w[c].dtype, (c, g[c].dtype, w[c].dtype)
        assert g[c].shape == w[c].shape, (c, g[c].shape, w[c].shape)
        if np.issubdtype(w[c].dtype, np.floating):
            np.testing.assert_allclose(g[c], w[c], rtol=rtol, atol=atol,
                                       err_msg=c)
        else:
            assert g[c].tolist() == w[c].tolist(), c


def _both(build, keys, tcfg=None, rcfg=None, **tol):
    got = build(thf).to_numpy(_cfg(thf, tcfg))
    want = build(rhf).to_numpy(_cfg(rhf, rcfg))
    _same(got, want, keys, **tol)
    return got


def test_groupby_sugar_methods_parity():
    t = _frame()
    got = _both(lambda hf: hf.table(t).drop(["b"]).groupby("k1").sum(),
                ("k1",), rtol=1e-3)
    assert sorted(got) == ["k1", "k2", "t", "x", "y"]
    np.testing.assert_array_equal(
        got["t"][np.argsort(got["k1"])],
        np.bincount(t["k1"], weights=t["t"]).astype(np.int32))
    got = _both(lambda hf: hf.table(t).groupby(("k1", "k2")).size(),
                ("k1", "k2"))
    want = np.bincount(t["k1"] * 5 + t["k2"], minlength=40)
    assert sorted(got["size"].tolist()) == sorted(want[want > 0].tolist())


@pytest.mark.parametrize("fn", SUGAR)
def test_groupby_sugar_sweep_matches_reference(fn):
    """Each whole-frame reduction over every non-key column, bool included,
    and with a selection."""
    t = _frame()
    got = _both(lambda hf: getattr(hf.table(t).groupby("k1"), fn)(), ("k1",),
                rtol=1e-3, atol=1e-4)
    assert sorted(got) == sorted(["k1", "k2", "t", "x", "y", "b"])
    _both(lambda hf: getattr(hf.table(t).groupby("k1")[["x", "b"]], fn)(),
          ("k1",), rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("fn", ("sum", "mean", "min", "max", "prod", "any",
                                "all"))
def test_groupby_sugar_skipna_matches_reference(fn):
    t = _frame()
    t["x"] = np.where(t["t"] % 7 == 0, np.nan, t["x"]).astype(np.float32)
    for skipna in (True, False):
        _both(lambda hf: getattr(hf.table(t).groupby("k1")[["x", "y"]], fn)(
            skipna=skipna), ("k1",), rtol=1e-3, atol=1e-4)


def test_groupby_count_of_nullable_column_matches_reference():
    t = _frame()
    t["x"] = np.where(t["t"] % 5 == 0, np.nan, t["x"]).astype(np.float32)
    got = _both(lambda hf: hf.table(t).groupby("k1")[["x", "y"]].count(),
                ("k1",))
    ok = ~np.isnan(t["x"])
    np.testing.assert_array_equal(got["x"][np.argsort(got["k1"])],
                                  np.bincount(t["k1"], weights=ok))


def test_groupby_min_max_of_bool_column():
    """min/max of a bool column compare as 0/1 int32 on both aggregation
    paths, and the whole-frame sugar sweeps bool columns."""
    t = _frame()
    for tc, rc in ((TCFG, RCFG),
                   (thf.ExecConfig(device="cpu", partial_agg=False),
                    rhf.ExecConfig(use_pallas="interpret", partial_agg=False))):
        got = _both(lambda hf: hf.table(t).groupby("k1").agg(
            lo=("b", "min"), hi=("b", "max")), ("k1",), tc, rc)
        o = np.argsort(got["k1"])
        lo = [t["b"][t["k1"] == k].min() for k in range(8)]
        hi = [t["b"][t["k1"] == k].max() for k in range(8)]
        assert got["lo"][o].tolist() == [int(v) for v in lo]
        assert got["hi"][o].tolist() == [int(v) for v in hi]
    _both(lambda hf: hf.table(t).groupby("k1").min(), ("k1",))


def test_groupby_sugar_skips_category_for_numeric_fns():
    """pandas numeric_only: sum/mean skip a category column, min and
    nunique keep it (code order is string order); with nothing else left
    the sugar counts rows."""
    t = _frame()
    names = np.array(["ant", "bee", "cat", "dog", "eel"], dtype=object)
    t["s"] = names[t["k2"]]
    cols = {fn: sorted(_both(lambda hf: getattr(
        hf.table(t).groupby("k1")[["s", "x"]], fn)(), ("k1",))) for fn in
        ("sum", "mean", "min", "nunique")}
    assert cols["sum"] == cols["mean"] == ["k1", "x"]
    assert cols["min"] == cols["nunique"] == ["k1", "s", "x"]
    got = thf.table(t).groupby("k1")[["s", "x"]].min().to_numpy(TCFG)
    o = np.argsort(got["k1"])
    assert got["s"][o].tolist() == [min(t["s"][t["k1"] == k]) for k in range(8)]
    got = _both(lambda hf: hf.table(t).groupby("k1")["s"].sum(), ("k1",))
    assert sorted(got) == ["count", "k1"]
    np.testing.assert_array_equal(got["count"][np.argsort(got["k1"])],
                                  np.bincount(t["k1"]))


def test_groupby_getitem_single_column():
    t = _frame()
    got = _both(lambda hf: hf.table(t).groupby("k1")["x"].sum(), ("k1",))
    assert set(got) == {"k1", "x"}
    np.testing.assert_allclose(
        got["x"][np.argsort(got["k1"])],
        np.bincount(t["k1"], weights=t["x"].astype(np.float64)), atol=1e-3)


def test_groupby_getitem_list_mean():
    t = _frame()
    got = _both(lambda hf: hf.table(t).groupby("k1")[["x", "y"]].mean(),
                ("k1",))
    assert set(got) == {"k1", "x", "y"}
    n = np.bincount(t["k1"])
    o = np.argsort(got["k1"])
    for c in ("x", "y"):
        np.testing.assert_allclose(
            got[c][o], np.bincount(t["k1"], weights=t[c]) / n, atol=1e-4)


def test_groupby_getitem_validates():
    for hf in (thf, rhf):
        df = hf.table(_frame())
        with pytest.raises(KeyError, match="groupby"):
            df.groupby("k1")["nope"]
        with pytest.raises(ValueError, match="empty"):
            df.groupby("k1")[[]]
        with pytest.raises(TypeError):
            df.groupby("k1")[[3]]
    # agg() is unaffected by selection; explicit specs name any column
    got = _both(lambda hf: hf.table(_frame()).groupby("k1")["x"].agg(
        ym=("y", "mean")), ("k1",))
    assert set(got) == {"k1", "ym"}
    got = _both(lambda hf: hf.table(_frame()).groupby("k1").aggregate(
        n="count"), ("k1",))
    assert sorted(got["n"].tolist()) == sorted(np.bincount(_frame()["k1"]))


# -- transform / head (tests/test_skew.py) ------------------------------------


def test_groupby_transform_matches_reference_and_oracle():
    rng = np.random.default_rng(13)
    n = 1200
    g = rng.integers(0, 11, n).astype(np.int32)
    x = rng.normal(size=n).astype(np.float32)
    y = rng.normal(size=n).astype(np.float32)
    t = {"g": g, "x": x, "y": y}
    got = _both(lambda hf: hf.table(t).groupby("g").transform("mean"),
                ("g", "x", "y"))
    assert set(got) == {"g", "x", "y", "x_mean", "y_mean"}
    r = _rows(got, ("g", "x", "y"))
    e = _rows(t, ("g", "x", "y"))
    cnt = np.bincount(g)
    np.testing.assert_array_equal(r["g"], e["g"])
    np.testing.assert_array_equal(r["x"], e["x"])
    for c in ("x", "y"):
        m = np.bincount(g, weights=t[c].astype(np.float64)) / cnt
        np.testing.assert_allclose(r[c + "_mean"], m[e["g"]], atol=1e-4)
    # the named spelling, and the name clash
    got = _both(lambda hf: hf.table(t).groupby("g").transform(
        total=("x", "sum")), ("g", "x", "y"))
    assert set(got) == {"g", "x", "y", "total"}
    for hf in (thf, rhf):
        with pytest.raises(ValueError, match="collide"):
            hf.table(t).groupby("g").transform(x=("x", "sum"))


def test_groupby_transform_and_head_validate():
    for hf in (thf, rhf):
        g = hf.table({"g": np.zeros(4, np.int32)}).groupby("g")
        with pytest.raises(ValueError, match="no value columns"):
            g.transform("sum")
        gx = hf.table({"g": np.zeros(4, np.int32),
                       "x": np.ones(4, np.float32)}).groupby("g")
        with pytest.raises(TypeError, match="not both"):
            gx.transform("sum", s=("x", "sum"))
        with pytest.raises(TypeError, match="unknown fn"):
            gx.transform("median")
        with pytest.raises(ValueError, match="needs a fn"):
            gx.transform()
        with pytest.raises(ValueError, match="n must be"):
            gx.head(-1)


@pytest.mark.parametrize("k", (0, 1, 3))
def test_groupby_head_matches_reference_rows(k):
    """head(n): the first n rows of each group in their original order."""
    rng = np.random.default_rng(14)
    n = 900
    g = rng.integers(0, 7, n).astype(np.int32)
    x = np.arange(n, dtype=np.float32)          # row identity
    got = _both(lambda hf: hf.table({"g": g, "x": x}).groupby("g").head(k),
                ("g", "x"))
    seen: dict = {}
    exp = []
    for gi, xi in zip(g.tolist(), x.tolist()):
        if seen.get(gi, 0) < k:
            exp.append((gi, xi))
        seen[gi] = seen.get(gi, 0) + 1
    assert sorted(zip(got["g"].tolist(), got["x"].tolist())) == sorted(exp)
    assert set(got) == {"g", "x"}               # helper column dropped


def test_groupby_head_plans_single_exchange():
    """head(n) rides the grouped layout: one hash exchange and one local
    sort, as the reference plans it; none on a frame persisted on the
    keys."""
    rng = np.random.default_rng(15)
    t = {"g": rng.integers(0, 7, 800).astype(np.int32),
         "x": rng.normal(size=800).astype(np.float32)}
    c = thf.table(t).groupby("g").head(3).physical_plan(TCFG).counts()
    assert c == rhf.table(t).groupby("g").head(3).physical_plan().counts()
    assert c["hash_exchanges"] == 1 and c["local_sorts"] == 1
    assert c["sample_sorts"] == 0 and c["rebalances"] == 0
    p = thf.table(t).repartition(by="g").persist(TCFG, name="pg")
    cp = p.groupby("g").head(3).physical_plan(TCFG).counts()
    assert cp["hash_exchanges"] == 0, cp
    got = p.groupby("g").head(3).to_numpy(TCFG)
    want = rhf.table(t).groupby("g").head(3).to_numpy(RCFG)
    _same(got, want, ("g", "x"))
