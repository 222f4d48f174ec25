"""Frame and dtype verbs, string predicates in code space and category
recoding: the port against the reference.

Every case builds the same frame with either package's ``hf`` on the same
numpy inputs and runs it on the port (CPU) and on the reference (Pallas
kernels in interpret mode).  Category columns are compared decoded to
strings, ints and bools exactly, floats within rtol=1e-4, atol=1e-3, and
the collected dtypes must be the reference's.  The cases are those of
tests/test_dtypes.py (ingest, code-space rewriting, the null verbs, skipna
aggregation, string-keyed merge, sort and concat), the frame verbs of
tests/test_api_v2.py, ``test_projection``/``test_with_column``/
``test_concat`` of tests/test_relational.py, and two repairs: ``isna`` of a
category column, and numeric aggregates over one, which raise.  The frame
path's queries (FRAME_SRC, tests/torch_frame_queries.py) run here at P=1
against their numpy oracles, at P=2 in the spawn of tests/test_torch_e2e.py
and on the card in tests/test_torch_cuda.py.
"""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import hiframes as rhf  # noqa: E402
from repro_torch import hiframes as thf  # noqa: E402
from repro_torch.core import api as tapi  # noqa: E402
from repro_torch.core import dtypes as tdt  # noqa: E402
from repro_torch.core import expr as texpr  # noqa: E402
from torch_frame_queries import FRAME_SRC  # noqa: E402

TCFG = thf.ExecConfig(device="cpu")

F: dict = {}
exec(FRAME_SRC, F)
FDATA = F["frame_data"]()
FRAME_NAMES = list(F["FRAME_QUERIES"])


def _cfg(hf):
    return TCFG if hf is thf else rhf.ExecConfig(use_pallas="interpret")


def _run(build, rcfg=None):
    """``build(hf)`` on both packages, decoded: (port, reference)."""
    return (build(thf).to_numpy(TCFG),
            build(rhf).to_numpy(rcfg or _cfg(rhf)))


def _same(got: dict, want: dict, tag: str = ""):
    """Same columns, dtypes and rows in the same order."""
    assert sorted(got) == sorted(want), (tag, sorted(got), sorted(want))
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.shape == w.shape and g.dtype == w.dtype, \
            (tag, k, g.shape, w.shape, g.dtype, w.dtype)
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-3,
                                       err_msg=f"{tag}.{k}")
        else:
            assert g.tolist() == w.tolist(), f"{tag}.{k}"


def _both_same(build, tag="", rcfg=None):
    got, want = _run(build, rcfg)
    _same(got, want, tag)
    return got


def _ids_out(txt: str) -> str:
    """Plan or expression text without its node ids."""
    return re.sub(r"(#|col\()\d+", r"\1", txt)


def _plans_equal(tdf, rdf):
    tplan, rplan = tdf.physical_plan(TCFG), rdf.physical_plan()
    assert tplan.counts() == rplan.counts()
    assert tplan.shuffle_census(P=8) == rplan.shuffle_census(P=8)
    assert tdf.explain(TCFG).split("\n\n")[1].splitlines()[0] \
        == rdf.explain().split("\n\n")[1].splitlines()[0]


# ---------------------------------------------------------------------------
# the frame path's queries
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", FRAME_NAMES)
def test_frame_query_matches_reference_and_oracle(name):
    build = F["FRAME_QUERIES"][name]
    tdf, rdf = build(thf, FDATA), build(rhf, FDATA)
    t = tdf.collect(TCFG)
    assert not t.overflow
    got = tdf.to_numpy(TCFG)
    _same(got, rdf.to_numpy(_cfg(rhf)), name)
    F["assert_frame_result"](name, got, FDATA)
    _plans_equal(tdf, rdf)


def test_q05_string_plans_like_the_int_category_q05():
    """The string predicates rewrite into code space at plan construction:
    the plan, its census and its packed bytes are the int-keyed shape's."""
    s = F["q05_string"](thf, FDATA).physical_plan(TCFG)
    i = F["q05_int"](thf, FDATA).physical_plan(TCFG)
    assert s.counts() == i.counts()
    assert s.shuffle_census(P=8) == i.shuffle_census(P=8)
    assert s.shuffle_row_bytes() == i.shuffle_row_bytes()
    assert [type(o).__name__ for o in s.ops] == [type(o).__name__ for o in i.ops]


def test_string_keyed_join_plans_like_int_keyed():
    """tests/test_plan_census.py's gate on the port: a string-key join ->
    aggregate plans the int-key census, and the reference's."""
    rng = np.random.default_rng(12)
    n, m = 400, 26
    codes = rng.integers(0, m, n)
    x = rng.normal(size=n).astype(np.float32)
    w = rng.normal(size=m).astype(np.float32)
    strs = np.array([chr(ord("a") + c) for c in codes], dtype=object)
    sdim = np.array([chr(ord("a") + i) for i in range(m)], dtype=object)

    def pipeline(hf, keys, dimkeys):
        fact = hf.table({"k": keys, "x": x})
        dim = hf.table({"k": dimkeys, "w": w}, "d")
        return fact.merge(dim, on="k").groupby("k").agg(
            s=("x", "sum"), mw=("w", "mean"), c="count")

    qi = pipeline(thf, codes.astype(np.int32), np.arange(m, dtype=np.int32))
    qs = pipeline(thf, strs, sdim)
    pi, ps = qi.physical_plan(TCFG), qs.physical_plan(TCFG)
    assert pi.counts() == ps.counts()
    assert pi.shuffle_census(P=8) == ps.shuffle_census(P=8)
    _plans_equal(qs, pipeline(rhf, strs, sdim))
    _same(qs.to_numpy(TCFG), pipeline(rhf, strs, sdim).to_numpy(), "string")


# ---------------------------------------------------------------------------
# the two repairs
# ---------------------------------------------------------------------------


def _catdf(hf):
    return hf.table({"cat": np.array(["b", None, "a"], dtype=object),
                     "n": np.arange(3, dtype=np.int32)})


@pytest.mark.parametrize("verb", ["isna", "notna"])
def test_category_isna_filter_matches_reference(verb):
    """The null code -1 is a null, not a value: ``isna`` selects row 1,
    ``notna`` rows 0 and 2."""
    def build(hf):
        d = _catdf(hf)
        return d[getattr(d["cat"], verb)()]
    got = _both_same(build, verb)
    assert got["n"].tolist() == ([1] if verb == "isna" else [0, 2])


def test_category_isna_as_a_column_matches_reference():
    def build(hf):
        d = _catdf(hf)
        return d.assign(na=d["cat"].isna(), ok=d["cat"].notna())
    got = _both_same(build)
    assert got["na"].tolist() == [False, True, False]
    assert got["ok"].tolist() == [True, False, True]


AGG_SPELLING = {"sum": "sum_", "any": "any_", "all": "all_"}


@pytest.mark.parametrize("fn", ["sum", "mean", "var", "std", "prod", "any",
                                "all"])
@pytest.mark.parametrize("spelling", ["tuple", "aggexpr"])
def test_numeric_agg_over_category_raises(fn, spelling):
    """A sum of dictionary codes has no meaning: both packages raise."""
    for hf in (thf, rhf):
        df = hf.table({"k": np.array(["a", "b"], dtype=object),
                       "s": np.array(["x", "y"], dtype=object)})
        spec = (("s", fn) if spelling == "tuple"
                else getattr(hf, AGG_SPELLING.get(fn, fn))(df["s"]))
        with pytest.raises(TypeError, match="category"):
            df.groupby("k").agg(bad=spec)


@pytest.mark.parametrize("fn", ["min", "max", "first", "count", "nunique"])
def test_order_aggs_over_category_match_reference(fn):
    """min/max/first/count/nunique stay allowed: code order is
    lexicographic order."""
    def build(hf):
        df = hf.table({"k": np.array(["a", "b", "a", "b", "a"], dtype=object),
                       "s": np.array(["y", None, "x", "z", "w"],
                                     dtype=object)})
        return df.groupby("k").agg(r=("s", fn)).sort_values("k")
    _both_same(build, fn)


# ---------------------------------------------------------------------------
# ingest and code-space rewriting (tests/test_dtypes.py)
# ---------------------------------------------------------------------------


def test_ingest_dtypes_match_reference():
    cols = {"s": np.array(["x", "y", None], dtype=object),
            "f": np.array([1.0, np.nan, 3.0], np.float32),
            "i": np.arange(3, dtype=np.int32),
            "o": np.array([1, None, 3], dtype=object)}
    t, r = thf.table(cols).dtypes, rhf.table(cols).dtypes
    assert {k: repr(v) for k, v in t.items()} == \
        {k: repr(v) for k, v in r.items()}
    assert tdt.is_category(t["s"]) and tdt.is_nullable(t["s"])
    assert tdt.is_nullable(t["o"]) and np.dtype(t["o"]) == np.float32


def test_from_pandas_matches_reference():
    pd = pytest.importorskip("pandas")
    pdf = pd.DataFrame({"s": ["b", None, "a"], "v": [1.0, np.nan, 3.0],
                        "i": np.arange(3, dtype=np.int64)})
    got = _both_same(lambda hf: hf.from_pandas(pdf))
    assert got["s"].tolist() == ["b", None, "a"]
    assert tdt.is_category(thf.from_pandas(pdf).dtypes["s"])
    for hf in (thf, rhf):
        with pytest.raises(TypeError, match="DataFrame"):
            hf.from_pandas({"s": [1, 2]})


def test_public_names():
    assert {"from_pandas", "DType"} <= set(thf.__all__)
    assert thf.DType is tdt.DType


STR = {"cat": np.array(["b", "a", None, "c", "a", "b"], dtype=object),
       "x": np.array([1.0, 2.0, 3.0, np.nan, 5.0, 6.0], np.float32),
       "n": np.arange(6, dtype=np.int32)}

PREDICATES = {
    "eq": (lambda c: c == "a", [1, 4]),
    "ne": (lambda c: c != "a", [0, 2, 3, 5]),
    "isin": (lambda c: c.isin(["a", "c"]), [1, 3, 4]),
    "eq_absent": (lambda c: c == "zzz", []),
    "ne_absent": (lambda c: c != "zzz", [0, 1, 2, 3, 4, 5]),
    "isin_partly_absent": (lambda c: c.isin(["zzz", "c"]), [3]),
    "isin_absent": (lambda c: c.isin(["zzz"]), []),
    "gt": (lambda c: c > "a", [0, 3, 5]),
    "ge": (lambda c: c >= "b", [0, 3, 5]),
    "lt": (lambda c: c < "b", [1, 4]),
    "le": (lambda c: c <= "a", [1, 4]),
    "lt_first": (lambda c: c < "a", []),
    "ge_past_last": (lambda c: c >= "zzz", []),
    "swapped": (lambda c: "b" > c, [1, 4]),
    "and_float": (lambda c: (c == "b") & (c != "zzz"), [0, 5]),
}


@pytest.mark.parametrize("name", list(PREDICATES))
def test_string_predicate_matches_reference(name):
    """Equality, membership and ranges against the sorted dictionary; a
    value outside it gives a bare constant predicate (a 0-d tensor the
    filter broadcasts).  Nulls compare False except under ``!=``."""
    pred, rows = PREDICATES[name]

    def build(hf):
        d = hf.table(STR)
        return d[pred(d["cat"])]
    got = _both_same(build, name)
    assert sorted(got["n"].tolist()) == rows


@pytest.mark.parametrize("value", ["books", "zzz"])
def test_string_predicate_after_a_join_finds_either_dictionary(value):
    """A predicate on a joined frame resolves against the dictionary of
    the side that holds the column; an absent value pushes down as a
    constant."""
    def build(hf):
        j = hf.table(FDATA["wcs"], "wcs").merge(
            hf.table(FDATA["itx"], "it"), on=("wcs_item_sk", "i_item_sk"))
        return j[(j["i_category_name"] == value) | (j["wcs_user_sk"] < 3)]
    got = _both_same(build, value)
    names = FDATA["itx"]["i_category_name"][FDATA["wcs"]["wcs_item_sk"]]
    want = (names == value) | (FDATA["wcs"]["wcs_user_sk"] < 3)
    assert len(got["wcs_user_sk"]) == int(want.sum())


@pytest.mark.parametrize("pkg", ["port", "reference"])
def test_string_vs_plain_column_raises(pkg):
    hf = thf if pkg == "port" else rhf
    d = hf.table(STR)
    with pytest.raises(TypeError, match="non-category"):
        d[d["n"] == "a"]


@pytest.mark.parametrize("pkg", ["port", "reference"])
def test_different_dictionaries_comparison_raises(pkg):
    hf = thf if pkg == "port" else rhf
    a = hf.table({"u": np.array(["a", "b"], dtype=object),
                  "v": np.array(["b", "c"], dtype=object)})
    with pytest.raises(TypeError, match="different"):
        a[a["u"] == a["v"]]


# ---------------------------------------------------------------------------
# the null and dtype verbs
# ---------------------------------------------------------------------------


def test_isna_notna_frames_match_reference():
    """One bool column per input column.  The reference returns its
    constant False column (``n``: int32, never null) as int32 0s: its
    evaluation cache keys ``Const(False)`` and the code constant
    ``np.int32(0)`` alike (both hash and compare equal), so the mask's
    values are compared, and the port's dtype is bool."""
    got, want = _run(lambda hf: hf.table(STR).isna())
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == np.bool_
        assert got[k].tolist() == want[k].astype(bool).tolist(), k
    assert got["cat"].tolist() == [False, False, True, False, False, False]
    assert got["x"].tolist() == [False, False, False, True, False, False]
    assert not got["n"].any()
    got, want = _run(lambda hf: hf.table(STR).notna())
    for k in want:
        assert got[k].tolist() == want[k].astype(bool).tolist(), k


@pytest.mark.parametrize("subset", [None, "cat", "x", ("cat", "x"), "n"])
def test_dropna_matches_reference(subset):
    got = _both_same(lambda hf: hf.table(STR).dropna(subset=subset),
                     str(subset))
    want = {None: [0, 1, 4, 5], "cat": [0, 1, 3, 4, 5], "x": [0, 1, 2, 4, 5],
            ("cat", "x"): [0, 1, 4, 5], "n": list(range(6))}[subset]
    assert got["n"].tolist() == want


@pytest.mark.parametrize("fill", [{"cat": "zz", "x": -1.0}, {"cat": "a"},
                                  {"x": 0.5}, 7.0, {"n": 3}])
def test_fillna_matches_reference(fill):
    """A string outside the dictionary extends it; one inside does not; a
    scalar fills every nullable float column; a column holding no nulls
    is left alone.  Filled columns come back non-nullable."""
    def build(hf):
        return hf.table(STR).fillna(fill) if not isinstance(fill, float) \
            else hf.table({k: v for k, v in STR.items() if k != "cat"}) \
            .fillna(fill)
    _both_same(build, str(fill))
    t, r = build(thf), build(rhf)
    assert {k: repr(v) for k, v in t.dtypes.items()} == \
        {k: repr(v) for k, v in r.dtypes.items()}
    if fill == {"cat": "zz", "x": -1.0}:
        out = t.to_numpy(TCFG)
        assert out["cat"].tolist() == ["b", "a", "zz", "c", "a", "b"]
        assert out["x"][3] == -1.0
        assert not tdt.is_nullable(t.dtypes["cat"])
        assert tdt.categories_of(t.dtypes["cat"]) == ("a", "b", "c", "zz")
    if fill == {"cat": "a"}:
        assert tdt.categories_of(t.dtypes["cat"]) == ("a", "b", "c")


def test_fillna_explain_matches_reference():
    """The helpers' inner functions are named ``f``, as the reference's:
    the plans and the expressions print the same, node ids aside."""
    t = thf.table(STR).fillna({"cat": "zz", "x": 0.0})
    r = rhf.table(STR).fillna({"cat": "zz", "x": 0.0})
    assert _ids_out(t.explain(TCFG).split("\n\n")[0]) \
        == _ids_out(r.explain().split("\n\n")[0])
    for c in ("cat", "x"):
        assert _ids_out(repr(t.node.cols[c])) == _ids_out(repr(r.node.cols[c]))
    assert repr(t.node.cols["cat"]).startswith("udf:f(")


@pytest.mark.parametrize("target", [np.float64, np.float32, np.int32,
                                    np.int64, np.bool_])
def test_astype_matches_reference(target):
    """The schema records the dtype asked for; the data narrows 64-bit
    types to 32 bits, as the reference's arrays do with x64 off."""
    cols = {"x": np.array([1.5, -2.5, 0.0], np.float32),
            "i": np.array([1, 0, 3], np.int32)}

    def build(hf):
        return hf.table(cols).astype({"x": target, "i": target})
    got = _both_same(build, str(target))
    assert build(thf).dtypes == build(rhf).dtypes
    assert build(thf).dtypes["x"] == np.dtype(target)
    assert got["x"].dtype == tdt.canonical_dtype(target)


def test_astype_refusals_match_reference():
    from repro.core import dtypes as rdt
    for hf, dt in ((thf, tdt), (rhf, rdt)):
        d = hf.table(STR)
        with pytest.raises(TypeError, match="decode"):
            d.astype({"cat": np.int32})
        with pytest.raises(TypeError, match="fillna"):
            d.astype({"x": np.int32})
        with pytest.raises(TypeError, match="encoding"):
            d.astype({"n": "category"})
        with pytest.raises(KeyError):
            d.astype({"nope": np.int32})
        assert dt.is_nullable(d.astype({"x": np.float64}).dtypes["x"])
        assert d.astype({"cat": "category"}).dtypes["cat"] == d.dtypes["cat"]
    got = _both_same(lambda hf: hf.table(STR).astype(
        {"x": np.float64, "n": np.float32}))
    assert np.isnan(got["x"][3])


def test_all_null_and_empty_dictionary_matches_reference():
    cols = {"s": np.array([None, None, None], dtype=object),
            "x": np.ones(3, np.float32)}
    assert tdt.categories_of(thf.table(cols).dtypes["s"]) == ()
    got = _both_same(lambda hf: hf.table(cols))
    assert got["s"].tolist() == [None, None, None]
    g = _both_same(lambda hf: hf.table(cols).groupby("s").agg(
        t=("x", "sum")))
    assert len(g["s"]) == 0


# ---------------------------------------------------------------------------
# skipna aggregation, string-keyed merge, sort and concat (pandas parity)
# ---------------------------------------------------------------------------


def _pdframe(seed=21, n=300):
    rng = np.random.default_rng(seed)
    cats = np.array(["aa", "bb", "cc", "dd", "ee"], dtype=object)
    k = cats[rng.integers(0, 5, n)].astype(object)
    k[rng.random(n) < 0.1] = None
    x = rng.normal(size=n).astype(np.float32)
    x[rng.random(n) < 0.15] = np.nan
    return {"k": k, "x": x}


def test_groupby_skipna_matches_reference_and_pandas():
    pd = pytest.importorskip("pandas")
    cols = _pdframe()
    got = _both_same(lambda hf: hf.table(cols).groupby("k").agg(
        s=("x", "sum"), m=("x", "mean"), mn=("x", "min"), mx=("x", "max"),
        c=("x", "count"), n="count").sort_values("k"))
    pdf = pd.DataFrame({"k": cols["k"], "x": cols["x"].astype(np.float64)})
    ref = pdf.groupby("k").agg(
        s=("x", "sum"), m=("x", "mean"), mn=("x", "min"), mx=("x", "max"),
        c=("x", "count"), n=("x", "size")).sort_index()
    assert list(got["k"]) == list(ref.index)
    for c in ("s", "m", "mn", "mx"):
        np.testing.assert_allclose(got[c], ref[c], rtol=1e-4, atol=1e-4)
    assert got["c"].tolist() == ref["c"].tolist()
    assert got["n"].tolist() == ref["n"].tolist()


def test_groupby_all_null_group_matches_reference():
    cols = {"k": np.array(["a", "a", "b", "b"], dtype=object),
            "x": np.array([1.0, 2.0, np.nan, np.nan], np.float32)}
    got = _both_same(lambda hf: hf.table(cols).groupby("k").agg(
        s=("x", "sum"), m=("x", "mean"), c=("x", "count")).sort_values("k"))
    # pandas: an all-NaN sum is 0.0, its mean NaN, its count 0
    assert got["s"].tolist() == [3.0, 0.0]
    assert got["m"][0] == pytest.approx(1.5) and np.isnan(got["m"][1])
    assert got["c"].tolist() == [2, 0]


@pytest.mark.parametrize("skipna", [True, False])
def test_groupby_skipna_false_poisons_like_reference(skipna):
    """pandas: a NaN poisons its own group only.  The reference is held on
    its jnp route: its Pallas value scan carries the NaN into every later
    group's sum."""
    cols = {"k": np.array(["a", "a", "b"], dtype=object),
            "x": np.array([1.0, np.nan, 3.0], np.float32)}

    def build(hf):
        df = hf.table(cols)
        return df.groupby("k").agg(
            x=hf.sum_(df["x"], skipna=skipna)).sort_values("k")
    got = _both_same(build, str(skipna), rcfg=rhf.ExecConfig())
    assert got["x"][1] == 3.0
    assert np.isnan(got["x"][0]) if not skipna else got["x"][0] == 1.0


@pytest.mark.parametrize("how", ["inner", "left"])
def test_merge_string_keys_matches_reference_and_pandas(how):
    """Both sides recode onto the union dictionary; a left join fills the
    right's category columns with the null code."""
    pd = pytest.importorskip("pandas")
    cols = _pdframe(seed=5)
    dim = {"k": np.array(["aa", "cc", "ee", "zz"], dtype=object),
           "w": np.array([10.0, 20.0, 30.0, 40.0], np.float32),
           "tag": np.array(["p", "q", None, "p"], dtype=object)}
    got = _both_same(lambda hf: hf.table(cols).merge(
        hf.table(dim, "d"), on="k", how=how), how)
    assert tdt.categories_of(thf.table(cols).merge(
        thf.table(dim, "d"), on="k").dtypes["k"]) \
        == ("aa", "bb", "cc", "dd", "ee", "zz")
    ref = pd.DataFrame(cols).merge(pd.DataFrame(dim), on="k", how=how)
    assert len(got["k"]) == len(ref)
    np.testing.assert_allclose(np.sort(got["w"]), np.sort(ref["w"]))


def test_merge_category_with_numeric_key_raises():
    for hf in (thf, rhf):
        a = hf.table({"k": np.array(["a", "b"], dtype=object)})
        b = hf.table({"k": np.array([1, 2], np.int32)}, "b")
        with pytest.raises(TypeError, match="category"):
            a.merge(b, on="k")


def test_sort_string_column_nulls_first_like_reference():
    """The null code -1 sorts first (pandas puts NaN last); the rest in
    lexicographic order."""
    k = np.array(["b", None, "a", "c"], dtype=object)
    got = _both_same(lambda hf: hf.table({"k": k}).sort("k"))
    assert got["k"].tolist() == [None, "a", "b", "c"]


@pytest.mark.parametrize("parts", ["differ", "nullability", "same"])
def test_concat_unifies_dictionaries_like_reference(parts):
    a = {"k": np.array(["b", "a"], dtype=object),
         "x": np.array([1.0, 2.0], np.float32)}
    b = {"differ": {"k": np.array(["c", None], dtype=object),
                    "x": np.array([np.nan, 4.0], np.float32)},
         "nullability": {"k": np.array(["a", None], dtype=object),
                         "x": np.array([3.0, 4.0], np.float32)},
         "same": {"k": np.array(["a", "b"], dtype=object),
                  "x": np.array([3.0, 4.0], np.float32)}}[parts]

    def build(hf):
        return hf.concat(hf.table(a, "a"), hf.table(b, "b"))
    got = _both_same(build, parts)
    assert got["k"].tolist() == list(a["k"]) + list(b["k"])
    assert {k: repr(v) for k, v in build(thf).dtypes.items()} == \
        {k: repr(v) for k, v in build(rhf).dtypes.items()}
    if parts == "differ":
        cc = build(thf)
        assert tdt.categories_of(cc.dtypes["k"]) == ("a", "b", "c")
        assert tdt.is_nullable(cc.dtypes["k"])
        assert tdt.is_nullable(cc.dtypes["x"])


def test_concat_category_with_numeric_raises():
    for hf in (thf, rhf):
        a = hf.table({"k": np.array(["a", "b"], dtype=object)})
        b = hf.table({"k": np.array([1, 2], np.int32)}, "b")
        with pytest.raises(TypeError, match="category"):
            hf.concat(a, b)


def test_explain_shows_logical_dtypes_like_reference():
    t, r = thf.table(STR).explain(TCFG), rhf.table(STR).explain()
    logical = t.split("\n\n")[0]
    assert "category[str]?" in logical and "float32?" in logical
    assert _ids_out(logical) == _ids_out(r.split("\n\n")[0])


# ---------------------------------------------------------------------------
# frame verbs (tests/test_api_v2.py, tests/test_relational.py)
# ---------------------------------------------------------------------------


def _frame(n=600, seed=7):
    rng = np.random.default_rng(seed)
    return {"k1": rng.integers(0, 8, n).astype(np.int32),
            "k2": rng.integers(0, 5, n).astype(np.int32),
            "t": rng.permutation(n).astype(np.int32),
            "x": rng.normal(size=n).astype(np.float32),
            "y": rng.normal(size=n).astype(np.float32),
            "b": rng.integers(0, 2, n) > 0}


def test_setitem_assign_drop_matches_reference():
    def build(hf):
        df = hf.table(_frame())
        df["z"] = df.x * 2.0 + df.y
        return df.assign(w=lambda d: d.z - d.x, c=1.5).drop(["b", "t"])
    got = _both_same(build)
    src = _frame()
    z = src["x"] * np.float32(2.0) + src["y"]
    np.testing.assert_allclose(got["w"], z - src["x"], rtol=1e-6, atol=1e-6)
    assert got["c"].tolist() == [1.5] * 600
    assert sorted(got) == ["c", "k1", "k2", "w", "x", "y", "z"]


def test_setitem_keeps_prebuilt_expressions_valid():
    def build(hf):
        df = hf.table(_frame())
        pred = df.x > 0.0          # built before the mutation
        df["x2"] = df.x * df.x
        return df[pred]
    got = _both_same(build)
    assert len(got["x"]) == int((_frame()["x"] > 0).sum())
    np.testing.assert_allclose(got["x2"], got["x"] * got["x"], rtol=1e-6)


def test_setitem_on_a_replicated_frame_stays_replicated():
    df = thf.table(_frame()).replicate()
    df["z"] = df.x + 1.0
    assert df._replicated


@pytest.mark.parametrize("form", ["columns", "positional"])
def test_rename_matches_reference(form):
    def build(hf):
        df = hf.table(_frame())
        return df.rename(columns={"k1": "g"}) if form == "columns" \
            else df.rename({"k1": "g", "x": "v"})
    got = _both_same(build, form)
    assert "g" in got and "k1" not in got


def test_select_drop_and_their_errors_match_reference():
    got = _both_same(lambda hf: hf.table(_frame()).select("x", "k1"))
    assert sorted(got) == ["k1", "x"]
    got = _both_same(lambda hf: hf.table(_frame()).drop("b", "t"))
    assert sorted(got) == ["k1", "k2", "x", "y"]
    got = _both_same(lambda hf: hf.table(_frame()).drop(columns=["b"]))
    assert "b" not in got
    for hf in (thf, rhf):
        with pytest.raises(KeyError, match="nope"):
            hf.table(_frame()).drop("nope")
        with pytest.raises(TypeError):
            hf.table(_frame())[3] = 1.0


def test_projection():
    data = _frame()
    got = _both_same(lambda hf: hf.table(data)[["x"]])
    assert list(got) == ["x"]
    np.testing.assert_allclose(got["x"], data["x"])


def test_with_column():
    data = _frame()
    got = _both_same(lambda hf: (lambda df: df.with_column(
        "z", df["x"] * 2.0 + df["y"]))(hf.table(data)))
    np.testing.assert_allclose(got["z"], data["x"] * 2 + data["y"], rtol=1e-5)


def test_concat():
    data = _frame()
    got = _both_same(lambda hf: (lambda df: hf.concat(df, df))(
        hf.table(data)))
    assert len(got["x"]) == 2 * len(data["x"])


# ---------------------------------------------------------------------------
# the expression layer: UDF nodes and the device helpers
# ---------------------------------------------------------------------------


def test_udf_infer_dtype_and_nullability_match_reference():
    """The port types a UDF by calling it on 4-row CPU tensors of the
    children's dtypes (float32 when that fails), the reference by tracing
    it: the same schema entries for the helpers the verbs build."""
    from repro.core import dtypes as rdt
    from repro.core import expr as rexpr
    sch, rsch = ({"c": dt.DType(dt.CODE_DTYPE, ("a", "b"), nullable=True),
                  "x": dt.DType(np.float32, nullable=True),
                  "i": np.dtype(np.int32)} for dt in (tdt, rdt))
    lut = np.array([1, 2], np.int32)
    cases = [(tapi._recode_fn(lut), "c"), (tapi._fill_code_fn(1), "c"),
             (tapi._fill_nan_fn(0.5), "x"), (lambda v: v > 0, "i"),
             (lambda v: v.nope(), "i")]
    for fn, col in cases:
        te = texpr.fn_expr(fn, texpr.ColRef(0, col))
        re_ = rexpr.fn_expr(lambda *a: None, rexpr.ColRef(0, col))
        assert texpr.expr_nullable(te, sch) == rexpr.expr_nullable(re_, rsch)
        want = {"c": np.int32, "x": np.float32}.get(col, None)
        got = texpr.infer_dtype(te, sch)
        if want is not None:
            assert got == np.dtype(want)
    assert texpr.infer_dtype(texpr.fn_expr(lambda v: v > 0, texpr.ColRef(
        0, "i")), sch) == np.bool_
    assert texpr.infer_dtype(texpr.fn_expr(lambda v: v.nope(), texpr.ColRef(
        0, "i")), sch) == np.float32


def test_recode_helper_on_a_strided_view():
    """The LUT gathers through a non-contiguous code view; null codes stay
    null unless a fill code is given."""
    lut = np.array([2, 0, 3], np.int32)
    c = torch.tensor([0, 9, -1, 9, 2, 9, 1, 9], dtype=torch.int32)[::2]
    assert not c.is_contiguous()
    assert tapi._recode_fn(lut)(c).tolist() == [2, -1, 3, 0]
    assert tapi._recode_fn(lut, fill=1)(c).tolist() == [2, 1, 3, 0]
    assert tapi._fill_code_fn(4)(c).tolist() == [0, 4, 2, 1]
    assert tapi._recode_fn(lut)(c).dtype == torch.int32


def test_const_keys_tell_types_apart():
    """False, 0 and np.int32(0) hash alike; one evaluation cache must keep
    a bool constant column bool beside a code constant."""
    env = {"c": torch.tensor([0, -1], dtype=torch.int32)}
    cache: dict = {}
    ge = texpr.BinOp("ge", texpr.ColRef(0, "c"), texpr.Const(np.int32(0)))
    texpr.evaluate(texpr.Const(np.int32(0)), env, cache)
    texpr.evaluate(ge, env, cache)
    assert texpr.evaluate(texpr.Const(False), env, cache).dtype == torch.bool
