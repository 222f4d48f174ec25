"""UDFs, free arrays in expressions, matrix assembly and the K-means step of
the paper's customer-segmentation program: the port against the reference.

Every query is built with either package's ``hf`` on the same numpy inputs
(SEG_SRC, tests/torch_segmentation_queries.py) and runs on the port (CPU)
and on the reference (Pallas kernels in interpret mode): the same rows
(ordered by SEG_KEYS before the comparison, since transform's merge orders
rows by the join), the same dtypes, ints exact and floats within rtol=1e-4,
atol=1e-4, and the numpy oracle's rows.  The same queries run at P=2 in the
spawn of tests/test_torch_e2e.py and on the card in tests/test_torch_cuda.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import hiframes as rhf  # noqa: E402
from repro.core import expr as rexpr  # noqa: E402
from repro_torch import hiframes as thf  # noqa: E402
from repro_torch.core import expr as texpr  # noqa: E402
from repro_torch.data import synth  # noqa: E402
from torch_segmentation_queries import SEG_SRC  # noqa: E402

TCFG = thf.ExecConfig(device="cpu")
RCFG = rhf.ExecConfig(use_pallas="interpret")

Z: dict = {}
exec(SEG_SRC, Z)
ZDATA = Z["seg_data"]()


def _plans_equal(tdf, rdf):
    tplan, rplan = tdf.physical_plan(TCFG), rdf.physical_plan()
    assert tplan.counts() == rplan.counts()
    assert tplan.shuffle_census(P=8) == rplan.shuffle_census(P=8)


@pytest.mark.parametrize("name", list(Z["SEG_QUERIES"]))
def test_seg_query_matches_reference_and_oracle(name):
    build = Z["SEG_QUERIES"][name]
    tdf, rdf = build(thf, ZDATA), build(rhf, ZDATA)
    got, want = tdf.to_numpy(TCFG), rdf.to_numpy(RCFG)
    assert {k: v.dtype for k, v in got.items()} \
        == {k: v.dtype for k, v in want.items()}
    Z["assert_seg_result"](name, got, ZDATA, want=want)
    Z["assert_seg_result"](name, got, ZDATA)
    _plans_equal(tdf, rdf)


# ---------------------------------------------------------------------------
# UDFs (paper Fig. 10)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def data():
    """tests/test_relational.py's frame."""
    rng = np.random.default_rng(7)
    n = 2000
    return {"id": rng.integers(0, 41, n).astype(np.int32),
            "x": rng.normal(size=n).astype(np.float32),
            "y": rng.normal(size=n).astype(np.float32)}


def test_udf_zero_cost_semantics(data):
    """A UDF filters exactly like the built-in predicate, with the same
    physical plan, on the port and on the reference."""
    for hf, cfg in ((thf, TCFG), (rhf, RCFG)):
        df = hf.table(data)
        built = df[(df["x"] * 2.0 + 1.0) > 0.0]
        via = df[hf.udf(lambda x: x * 2.0 + 1.0 > 0.0, df["x"])]
        np.testing.assert_array_equal(built.to_numpy(cfg)["id"],
                                      via.to_numpy(cfg)["id"])
        pb, pu = built.physical_plan(cfg), via.physical_plan(cfg)
        assert pb.counts() == pu.counts()
        assert [type(o).__name__ for o in pb.ops] \
            == [type(o).__name__ for o in pu.ops]
    m = data["x"] * np.float32(2.0) + np.float32(1.0) > 0
    np.testing.assert_array_equal(
        thf.table(data)[thf.udf(lambda x: x * 2.0 + 1.0 > 0.0,
                                thf.table(data)["x"])].to_numpy(TCFG)["id"],
        data["id"][m])


def test_fig10_builtin_and_udf_agree():
    """benchmarks/bench_udf.py's pair: the same rows and the same plan,
    census and packed bytes, on either package."""
    t = synth.relational_tables(5000, 100, seed=4)
    rows = {}
    for hf, cfg in ((thf, TCFG), (rhf, RCFG)):
        df = hf.table(t)
        b, u = Z["fig10_builtin"](hf, df), Z["fig10_udf"](hf, df)
        pb, pu = b.physical_plan(cfg), u.physical_plan(cfg)
        assert pb.counts() == pu.counts()
        assert pb.shuffle_census(P=8) == pu.shuffle_census(P=8)
        ob, ou = b.to_numpy(cfg), u.to_numpy(cfg)
        for k in ob:
            np.testing.assert_array_equal(ob[k], ou[k])
        rows[hf] = ob
    m = t["x"] * np.float32(2.0) + t["y"] > np.float32(0.5)
    for k in t:
        np.testing.assert_array_equal(rows[thf][k], t[k][m])
        np.testing.assert_array_equal(rows[rhf][k], t[k][m])


def test_udf_is_fn_expr_and_types_like_the_reference():
    df_t, df_r = thf.table({"k": np.arange(5, dtype=np.int32)}), \
        rhf.table({"k": np.arange(5, dtype=np.int32)})
    for fn in (lambda k: k * 2, lambda k: k * 0.5, lambda k: k > 2,
               lambda k: k.astype(np.int16) if hasattr(k, "astype")
               else k.to(torch.int16)):
        et, er = thf.udf(fn, df_t.k), rhf.udf(fn, df_r.k)
        assert isinstance(et, texpr.UDF)
        sch = {"k": np.dtype(np.int32)}
        assert texpr.infer_dtype(et, sch) == rexpr.infer_dtype(er, sch)
    assert "udf" in thf.__all__


# ---------------------------------------------------------------------------
# ExternalArray
# ---------------------------------------------------------------------------

EXT_DTYPES = (np.float32, np.float64, np.int32, np.int64, np.int16, np.uint8,
              np.bool_)


@pytest.mark.parametrize("dtype", EXT_DTYPES, ids=lambda d: np.dtype(d).name)
def test_as_expr_wraps_arrays_like_the_reference(dtype):
    a = np.arange(6).astype(dtype)
    et, er = texpr.as_expr(a), rexpr.as_expr(a)
    assert isinstance(et, texpr.ExternalArray)
    assert isinstance(er, rexpr.ExternalArray)
    assert et.key() == er.key() and repr(et) == repr(er)
    assert texpr.infer_dtype(et, {}) == rexpr.infer_dtype(er, {})
    assert texpr.expr_nullable(et, {}) is rexpr.expr_nullable(er, {}) is False
    # a torch tensor types as the numpy array of its values
    tt = texpr.as_expr(torch.from_numpy(a))
    assert isinstance(tt, texpr.ExternalArray)
    assert texpr.infer_dtype(tt, {}) == rexpr.infer_dtype(er, {})
    # 0-d arrays and scalars stay constants
    assert isinstance(texpr.as_expr(a[0]), texpr.Const)
    assert isinstance(texpr.as_expr(np.asarray(a[0])), texpr.Const)


def test_external_array_rows_match_the_reference():
    """Arrays shorter than the rows pad with zeros on both packages; an
    int64 tensor narrows to int32; a longer array raises."""
    t = ZDATA["grp"]
    n = len(t["g"])
    short = ZDATA["ext"][: n // 2]

    def build(hf):
        df = hf.table(t, "grp")
        return df[df.x > short].assign(
            w=df.g * np.arange(n, dtype=np.int64))

    got, want = build(thf).to_numpy(TCFG), build(rhf).to_numpy(RCFG)
    assert {k: v.dtype for k, v in got.items()} \
        == {k: v.dtype for k, v in want.items()}
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    # the assign reads the filter's output rows, as the reference does
    m = t["x"] > np.concatenate([short, np.zeros(n - len(short), np.float32)])
    np.testing.assert_array_equal(got["x"], t["x"][m])
    assert got["w"].dtype == np.int32
    df = thf.table(t, "grp")
    tens = df.assign(w=torch.arange(n, dtype=torch.int64)).to_numpy(TCFG)
    assert tens["w"].dtype == np.int32
    np.testing.assert_array_equal(tens["w"], np.arange(n, dtype=np.int32))
    with pytest.raises(ValueError, match="does not fit"):
        df[df.x > np.zeros(n + 1, np.float32)].collect(TCFG)
    rdf = rhf.table(t, "grp")
    with pytest.raises(ValueError):
        rdf[rdf.x > np.zeros(n + 1, np.float32)].collect(RCFG)


def test_external_array_holds_its_node_in_place():
    """A filter over a free array aligned with a join's output stays above
    the join, and one above another filter is not fused into it: the
    array keeps the rows it was made for."""
    rng = np.random.default_rng(3)
    left = {"id": rng.integers(0, 20, 300).astype(np.int32),
            "x": rng.normal(size=300).astype(np.float32)}
    right = {"cid": np.arange(20, dtype=np.int32),
             "w": rng.normal(size=20).astype(np.float32)}
    j = thf.table(left, "l").merge(thf.table(right, "r"), on=("id", "cid"))
    ext = rng.normal(size=300).astype(np.float32)
    f = j[j.x > ext]
    assert "Filter" in f.explain(TCFG).splitlines()[0]
    got = f.to_numpy(TCFG)
    jn = j.to_numpy(TCFG)                   # the join's rows, in order
    m = jn["x"] > ext[: len(jn["x"])]
    for k in jn:
        np.testing.assert_array_equal(got[k], jn[k][m])
    df = thf.table(left, "l")
    pos = df[df.x > 0]
    ext2 = rng.normal(size=300).astype(np.float32)
    got = pos[pos.x > ext2].to_numpy(TCFG)
    xp = left["x"][left["x"] > 0]
    np.testing.assert_array_equal(got["x"], xp[xp > ext2[: len(xp)]])


def test_external_array_in_partitioned_window_raises():
    t = ZDATA["grp"]
    df = thf.table(t, "grp")
    w = df.over("g").cumsum(df.x * ZDATA["ext"])
    with pytest.raises(NotImplementedError, match="external arrays"):
        w.collect(TCFG)


# ---------------------------------------------------------------------------
# collect_matrix and the K-means stage (tests/test_system.py's pipeline)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def matrices():
    feats = list(Z["FEATURES"])
    tdf, rdf = Z["q26_features"](thf, ZDATA), Z["q26_features"](rhf, ZDATA)
    return (tdf.collect_matrix(feats, TCFG), rdf.collect_matrix(feats, RCFG),
            tdf, rdf)


def test_collect_matrix_matches_reference(matrices):
    (tm, tc, tcap), (rm, rc, rcap), tdf, rdf = matrices
    rm, rc = np.asarray(rm), np.asarray(rc)
    assert tm.dtype == torch.float32 and tm.shape == rm.shape
    assert tcap == rcap and tc.tolist() == rc.tolist()
    n = int(tc[0])
    assert np.array_equal(tm.numpy()[:n].view(np.int32), rm[:n].view(np.int32))
    want = Z["q26_want"](ZDATA["ss"], ZDATA["it"])
    assert n == len(want["ss_customer_sk"])
    got = tm.numpy()[:n]
    order = np.argsort(tdf.to_numpy(TCFG)["ss_customer_sk"], kind="stable")
    for i, c in enumerate(Z["FEATURES"]):
        np.testing.assert_array_equal(got[order, i], want[c].astype(np.float32))
    feats = set(Z["FEATURES"])
    tp = tdf.lower(TCFG, feats, collect_block=True).pplan
    rp = rdf.lower(RCFG, feats, collect_block=True).pplan
    assert tp.counts() == rp.counts()
    assert tp.counts()["rebalances"] == 1
    assert tdf.lower(TCFG, feats).pplan.counts()["rebalances"] == 0


def test_kmeans_steps_match_reference(matrices):
    """Each K-means step of the port's torch code from the same centroids
    as the reference's jnp step (examples/customer_segmentation.py):
    centroids within rtol 1e-5, the same assignment."""
    import jax
    import jax.numpy as jnp

    (tm, tc, _), _, _, _ = matrices
    x = tm[: int(tc[0])]
    xj = jnp.asarray(x.numpy())

    def jstep(cent):
        d2 = jnp.sum((xj[:, None] - cent[None]) ** 2, axis=-1)
        a = jnp.argmin(d2, axis=1)
        one = jax.nn.one_hot(a, cent.shape[0], dtype=xj.dtype)
        return (one.T @ xj) / jnp.maximum(one.sum(0)[:, None], 1.0), a

    cent = x[:4].clone()
    for _ in range(10):
        new, a = Z["kmeans_step"](x, cent)
        jnew, ja = jstep(jnp.asarray(cent.numpy()))
        np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
        np.testing.assert_allclose(new.numpy(), np.asarray(jnew), rtol=1e-5,
                                   atol=1e-6)
        cent = new
    assert bool(torch.isfinite(cent).all())


def test_free_array_as_the_only_live_column():
    """A plan that reads only a free array over a scan's rows keeps one of
    the scan's columns for the row count (the reference prunes them all
    and fails planning: ROADMAP section 3)."""
    t = {"a": np.arange(10, dtype=np.int32)}
    c = (np.arange(10) % 3).astype(np.int32)
    got = thf.table(t).assign(c=c).groupby("c").size().to_numpy(TCFG)
    assert got["c"].tolist() == [0, 1, 2] and got["size"].tolist() == [4, 3, 3]
    with pytest.raises(StopIteration):
        rhf.table(t).assign(c=c).groupby("c").size().collect(RCFG)
