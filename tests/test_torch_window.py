"""Window functions of the port against the reference.

Per-rank operators (segment_cumsum, segment_stencil1d, segment_rank,
run_starts, stencil1d, dist_cumsum, exscan_scalar, global_rank,
halo_exchange) are compared with the reference's on the same numpy inputs.
Whole window queries — the shapes of tests/test_partitioned_window.py and
tests/test_window_join_ext.py, global and partitioned — run at P=1 on the
port (CPU) and on the reference (Pallas kernels in interpret mode) and must
agree row for row; both are held against the python oracles of
tests/oracle.py as row sets.  Integers are exact; floats within rtol=1e-4,
atol=1e-3 (the e2e tolerance), the window operators within rtol=1e-5,
atol=1e-5 (cumsums: 1e-5 of the running sum of |x|).  The same queries run
at P=2 on two gloo ranks inside the one spawn of tests/test_torch_e2e.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

import oracle  # noqa: E402
from repro import hiframes as rhf  # noqa: E402
from repro.core import physical as rphys  # noqa: E402
from repro_torch import hiframes as thf  # noqa: E402
from repro_torch.core import physical as tphys  # noqa: E402

TCFG = dict(device="cpu")

# -- the window queries, written once against either package's ``hf`` --------

WINDOW_SRC = '''
import numpy as np


def window_data():
    rng = np.random.default_rng(77)
    d = {}
    n = 600      # groups interleaved over the input, 2 of 3 group ids empty
    d["grp"] = {"g": (3 * rng.integers(0, 9, n)).astype(np.int32),
                "t": rng.permutation(n).astype(np.int32),
                "x": rng.normal(size=n).astype(np.float32),
                "k": rng.integers(-20, 20, n).astype(np.int32)}
    ties = dict(d["grp"])
    ties["t"] = (ties["t"] // 7).astype(np.int32)     # duplicate order keys
    d["ties"] = ties
    d["ser"] = {"t": np.arange(777, dtype=np.int32),
                "x": rng.normal(size=777).astype(np.float32),
                "k": rng.integers(-9, 9, 777).astype(np.int32)}
    nf = 500     # the partitioned-WMA-after-join shape of bench_analytics.py
    d["fact"] = {"g": rng.integers(0, 22, nf).astype(np.int32),
                 "t": rng.permutation(nf).astype(np.int32),
                 "x": rng.normal(size=nf).astype(np.float32)}
    d["dim"] = {"g": np.arange(22, dtype=np.int32),
                "w0": rng.normal(size=22).astype(np.float32)}
    return d


def _over(hf, d, table="grp"):
    df = hf.table(d[table], table)
    return df, df.over("g", order_by="t")


def p_cumsum(hf, d):
    df, w = _over(hf, d)
    return w.cumsum(df["x"], out="wc")


def p_cumsum_int(hf, d):
    df, w = _over(hf, d)
    return w.cumsum(df["k"], out="wc")


def p_wma(hf, d):
    df, w = _over(hf, d)
    return w.wma(df["x"], [1, 2, 1], out="ww")


def p_stencil_k4(hf, d):
    df = hf.table(d["grp"], "grp")
    return hf.stencil(df, df["x"], [1, 0, 0, 2], center=3, out="ws",
                      partition_by="g", order_by="t")


def p_lag2(hf, d):
    df, w = _over(hf, d)
    return w.lag(df["x"], n=2, out="wl")


def p_lead1(hf, d):
    df, w = _over(hf, d)
    return w.lead(df["x"], n=1, out="wl")


def p_rolling_sum(hf, d):
    df, w = _over(hf, d)
    return w.rolling_sum(df["x"], 4, out="wr")


def p_rolling_mean_exact(hf, d):
    df, w = _over(hf, d)
    return w.rolling_mean(df["x"], 7, out="wr", exact=True)


def p_rank(hf, d):
    df, w = _over(hf, d, "ties")
    return w.rank(out="wr")


def p_dense_rank(hf, d):
    df, w = _over(hf, d, "ties")
    return w.dense_rank(out="wr")


def p_row_number(hf, d):
    df, w = _over(hf, d, "ties")
    return w.row_number(out="wr")


def join_wma(hf, d):
    j = hf.join(hf.table(d["fact"], "fact"), hf.table(d["dim"], "dim"),
                on="g")
    return hf.wma(j, j["x"] * j["w0"], [1, 2, 1], out="ww",
                  partition_by="g", order_by="t")


def g_cumsum(hf, d):
    df = hf.table(d["ser"], "ser")
    return hf.cumsum(df, df["x"], out="wc")


def g_cumsum_int(hf, d):
    df = hf.table(d["ser"], "ser")
    return hf.cumsum(df, df["k"], out="wc")


def g_cumsum_filtered(hf, d):
    df = hf.table(d["ser"], "ser")
    f = df[df["x"] < 0.5]
    return hf.cumsum(f, f["x"], out="wc")


def g_sma(hf, d):
    df = hf.table(d["ser"], "ser")
    return hf.sma(df, df["x"], 3, out="ws")


def g_wma(hf, d):
    df = hf.table(d["ser"], "ser")
    return hf.wma(df, df["x"], [1, 2, 1], out="ws")


def g_lag3(hf, d):
    df = hf.table(d["ser"], "ser")
    return hf.lag(df, df["x"] * 2.0, n=3, out="wl")


def g_lead2(hf, d):
    df = hf.table(d["ser"], "ser")
    return hf.lead(df, df["x"], n=2, out="wl")


def g_rolling_mean_exact(hf, d):
    df = hf.table(d["ser"], "ser")
    return hf.rolling_mean(df, df["x"], 20, out="wr", exact=True)


def g_row_number(hf, d):
    df = hf.table(d["ser"], "ser")
    return hf.row_number(df, None, out="wr")


WINDOW_QUERIES = {f.__name__: f for f in (
    p_cumsum, p_cumsum_int, p_wma, p_stencil_k4, p_lag2, p_lead1,
    p_rolling_sum, p_rolling_mean_exact, p_rank, p_dense_rank, p_row_number,
    join_wma, g_cumsum, g_cumsum_int, g_cumsum_filtered, g_sma, g_wma, g_lag3,
    g_lead2, g_rolling_mean_exact, g_row_number)}
# the global windows that run an exclusive scan or a halo exchange
GLOBAL_WINDOWS = tuple(n for n in WINDOW_QUERIES if n.startswith("g_"))
'''

W: dict = {}
exec(WINDOW_SRC, W)
WDATA = W["window_data"]()
WNAMES = list(W["WINDOW_QUERIES"])


def _roll(s, window):
    out = np.zeros(len(s), np.float32)
    for i in range(len(s)):
        out[i] = s[max(0, i - window + 1): i + 1].sum()
    return out


def _roll_mean_exact(s, window):
    out = np.zeros(len(s), np.float32)
    for i in range(len(s)):
        out[i] = s[max(0, i - window + 1): i + 1].mean()
    return out


def _shift(s, n):
    """lag (n > 0) / lead (n < 0) with zero borders."""
    out = np.zeros(len(s), np.float32)
    if n > 0:
        out[n:] = s[:-n] if n < len(s) else []
    elif n < 0:
        out[:n] = s[-n:] if -n < len(s) else []
    else:
        out[:] = s
    return out


_GROUP_FN = {
    "p_cumsum": lambda s: np.cumsum(s),
    "p_wma": lambda s: oracle.o_stencil(s, [0.25, 0.5, 0.25], 1),
    "p_stencil_k4": lambda s: oracle.o_stencil(s, [1, 0, 0, 2], 3),
    "p_lag2": lambda s: _shift(s, 2),
    "p_lead1": lambda s: _shift(s, -1),
    "p_rolling_sum": lambda s: _roll(s, 4),
    "p_rolling_mean_exact": lambda s: _roll_mean_exact(s, 7),
}
_OUT = {"p_cumsum": "wc", "p_cumsum_int": "wc", "p_wma": "ww",
        "p_stencil_k4": "ws", "p_lag2": "wl", "p_lead1": "wl",
        "p_rolling_sum": "wr", "p_rolling_mean_exact": "wr", "p_rank": "wr",
        "p_dense_rank": "wr", "p_row_number": "wr", "join_wma": "ww",
        "g_cumsum": "wc", "g_cumsum_int": "wc", "g_cumsum_filtered": "wc",
        "g_sma": "ws", "g_wma": "ws", "g_lag3": "wl", "g_lead2": "wl",
        "g_rolling_mean_exact": "wr", "g_row_number": "wr"}


def window_oracle(name, d):
    """The python-loop answer of a window query, as a dict of columns."""
    out = _OUT[name]
    if name == "p_cumsum_int":
        c = d["grp"]
        r = oracle.o_group_apply(c, "g", "t", c["k"], np.cumsum, dtype=np.int32)
        r[out] = r.pop("_o")
        return r
    if name in _GROUP_FN:
        c = d["grp"]
        r = oracle.o_group_apply(c, "g", "t", c["x"], _GROUP_FN[name])
        r[out] = r.pop("_o")
        return r
    if name in ("p_rank", "p_dense_rank", "p_row_number"):
        r = oracle.o_group_rank(d["ties"], "g", "t", name[2:])
        r[out] = r.pop("_o").astype(np.int32)
        return r
    if name == "join_wma":
        j = oracle.o_join(d["fact"], d["dim"], "g", "g")
        r = oracle.o_group_apply(
            j, "g", "t", j["x"] * j["w0"],
            lambda s: oracle.o_stencil(s, [0.25, 0.5, 0.25], 1))
        r[out] = r.pop("_o")
        return r
    s = dict(d["ser"])
    if name == "g_cumsum_filtered":
        s = oracle.o_filter(s, s["x"] < np.float32(0.5))
    x = s["x"]
    res = {"g_cumsum": lambda: np.cumsum(x.astype(np.float64)).astype(np.float32),
           "g_cumsum_filtered": lambda: np.cumsum(x.astype(np.float64))
           .astype(np.float32),
           "g_cumsum_int": lambda: np.cumsum(s["k"]).astype(np.int32),
           "g_sma": lambda: oracle.o_stencil(x, [1 / 3] * 3, 1),
           "g_wma": lambda: oracle.o_stencil(x, [0.25, 0.5, 0.25], 1),
           "g_lag3": lambda: _shift(x * np.float32(2.0), 3),
           "g_lead2": lambda: _shift(x, -2),
           "g_rolling_mean_exact": lambda: _roll_mean_exact(x, 20),
           "g_row_number": lambda: np.arange(1, len(x) + 1, dtype=np.int32),
           }[name]()
    s[out] = res
    return s


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


def assert_same_row_set(got: dict, want: dict):
    """Rows sorted lexicographically by every column (names sorted; each
    query keeps an exact integer key first), then compared."""
    assert sorted(got) == sorted(want)
    names = sorted(want)
    go = np.lexsort([np.asarray(got[k]) for k in reversed(names)])
    wo = np.lexsort([np.asarray(want[k]) for k in reversed(names)])
    for k in names:
        g, w = np.asarray(got[k])[go], np.asarray(want[k])[wo]
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-3, err_msg=k)
        else:
            np.testing.assert_array_equal(g, w.astype(g.dtype), err_msg=k)


@pytest.mark.parametrize("name", WNAMES)
def test_window_query_matches_reference_and_oracle(name):
    build = W["WINDOW_QUERIES"][name]
    got = build(thf, WDATA).collect(thf.ExecConfig(**TCFG))
    assert not got.overflow
    got = got.to_numpy()
    want = build(rhf, WDATA).collect(
        rhf.ExecConfig(use_pallas="interpret")).to_numpy()
    _assert_same_rows(got, want)
    assert_same_row_set(got, window_oracle(name, WDATA))


def test_over_fluent_equals_kwargs_form():
    df = thf.table(WDATA["grp"])
    a = df.over("g", order_by="t").cumsum(df["x"], out="c")
    b = thf.cumsum(df, df["x"], out="c", partition_by="g", order_by="t")
    assert a.node.short() == b.node.short()
    cfg = thf.ExecConfig(**TCFG)
    na, nb = a.collect(cfg).to_numpy(), b.collect(cfg).to_numpy()
    for k in na:
        np.testing.assert_array_equal(na[k], nb[k])


def test_elided_vs_baseline_join_window_equal():
    """elide_exchanges on and off give the same rows for join -> window."""
    win = W["join_wma"](thf, WDATA)
    on = win.collect(thf.ExecConfig(elide_exchanges=True, **TCFG)).to_numpy()
    off = win.collect(thf.ExecConfig(elide_exchanges=False, **TCFG)).to_numpy()
    assert_same_row_set(on, off)


def test_window_column_pruning_keeps_keys():
    """Selecting only the window output must not prune the partition and
    order keys (they feed the exchange, the sort and the segment kernels)."""
    c = WDATA["grp"]
    df = thf.table(c)
    win = df.over("g", order_by="t").cumsum(df["x"], out="c")
    got = win[["c"]].collect(thf.ExecConfig(**TCFG)).to_numpy()
    ref = oracle.o_group_apply(c, "g", "t", c["x"], np.cumsum)
    np.testing.assert_allclose(np.sort(got["c"]), np.sort(ref["_o"]),
                               atol=1e-3)


# -- global windows that need a sort or a rebalance first ----------------------


def test_global_rank_with_order_by_is_not_ported():
    """A global rank, dense_rank or row_number with order_by sorts first
    (a SampleSort under the window); each, ascending and descending, gives
    the reference's rows, and the ranks of the sorted keys.  The name is
    kept from when the port refused these queries."""
    cfg, rcfg = thf.ExecConfig(**TCFG), rhf.ExecConfig(use_pallas="interpret")
    for verb in ("rank", "dense_rank", "row_number"):
        for ascending in (True, False):
            frames = [getattr(hf, verb)(hf.table(WDATA["ser"]), None, "k",
                                        out="r", ascending=ascending)
                      for hf in (thf, rhf)]
            assert "SampleSort" in frames[0].explain(cfg)
            got = frames[0].collect(cfg).to_numpy()
            _assert_same_rows(got, frames[1].collect(rcfg).to_numpy())
            k = got["k"] if ascending else -got["k"]
            assert np.all(np.diff(k) >= 0), (verb, ascending)
            want = {"rank": np.searchsorted(k, k, side="left") + 1,
                    "dense_rank": np.unique(k, return_inverse=True)[1] + 1,
                    "row_number": np.arange(1, len(k) + 1)}[verb]
            np.testing.assert_array_equal(got["r"], want)


def test_global_stencil_over_1d_var_is_not_ported():
    """A filter makes the input 1D_VAR; the planner puts a Rebalance under
    the global stencil, and the result is the reference's and the stencil
    of the filtered series.  The name is kept from when the port refused
    this query."""
    frames = []
    for hf in (thf, rhf):
        df = hf.table(WDATA["ser"])
        f = df[df["x"] < 0.5]
        frames.append(hf.wma(f, f["x"], [1, 2, 1]))
    cfg = thf.ExecConfig(**TCFG)
    assert "Rebalance" in frames[0].explain(cfg)
    got = frames[0].collect(cfg).to_numpy()
    _assert_same_rows(got, frames[1].collect(
        rhf.ExecConfig(use_pallas="interpret")).to_numpy())
    s = oracle.o_filter(dict(WDATA["ser"]), WDATA["ser"]["x"] < np.float32(0.5))
    np.testing.assert_allclose(got["wma"], oracle.o_stencil(
        s["x"], [0.25, 0.5, 0.25], 1), rtol=1e-5, atol=1e-5)


def test_rank_requires_order_keys():
    df = thf.table(WDATA["grp"])
    with pytest.raises(ValueError):
        thf.rank(df, "g", ())


# -- per-rank operators against the reference's ------------------------------


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def J(a):
    return jnp.asarray(a)


def _grouped(seed, n=300, count=260, dup=False):
    """Group-sorted keys (g, t) over the valid prefix, as the planner
    delivers them; ``dup`` gives ties in t."""
    rng = np.random.default_rng(seed)
    g = np.sort(rng.integers(0, 12, n)).astype(np.int32)
    t = rng.integers(0, 40 if dup else 10**6, n).astype(np.int32)
    order = np.lexsort((t, g))
    return g[order], t[order], count


def _close(got, want, rtol=1e-5, atol=1e-5):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, \
        (got.shape, want.shape, got.dtype, want.dtype)
    if np.issubdtype(want.dtype, np.floating):
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)
    else:
        np.testing.assert_array_equal(got, want)


def _scan_close(got, want, x):
    """Cumsums: within 1e-5 of the running sum of |x| (+1e-5)."""
    got, want = got.numpy(), np.asarray(want)
    assert got.dtype == want.dtype
    tol = 1e-5 * np.cumsum(np.abs(np.nan_to_num(x).astype(np.float64))) + 1e-5
    both_nan = np.isnan(got) & np.isnan(want)
    assert np.all(both_nan | (np.abs(got - want) <= tol))


@pytest.mark.parametrize("kind", ["float", "int", "bool", "nullable"])
def test_segment_cumsum_matches_reference(kind):
    g, _t, count = _grouped(1)
    rng = np.random.default_rng(2)
    n = len(g)
    x, tag = {"float": (rng.normal(size=n).astype(np.float32), None),
              "int": (rng.integers(-9, 9, n).astype(np.int32), None),
              "bool": (rng.random(n) < 0.5, None),
              "nullable": (np.where(rng.random(n) < 0.2, np.nan,
                                    rng.normal(size=n)).astype(np.float32),
                           "nan")}[kind]
    got = tphys.segment_cumsum(T(x), (T(g),), torch.tensor(count, dtype=torch.int32),
                               nulltag=tag)
    want = rphys.segment_cumsum(J(x), (J(g),), jnp.int32(count), nulltag=tag)
    if kind in ("float", "nullable"):
        _scan_close(got, want, x)
    else:
        _close(got, want)


@pytest.mark.parametrize("weights,center,exact", [
    ((1, 2, 1), 1, False), ((1, 1, 1, 1), 3, True), ((1, 0, 0, 2), 3, False),
    ((0.5,), 0, True), ((1,) * 7, 0, True), ((1, -1), 1, False)])
def test_segment_stencil1d_matches_reference(weights, center, exact):
    g, _t, count = _grouped(3)
    x = np.random.default_rng(4).normal(size=len(g)).astype(np.float32)
    got = tphys.segment_stencil1d(T(x), (T(g),),
                                  torch.tensor(count, dtype=torch.int32),
                                  weights, center, exact=exact)
    want = rphys.segment_stencil1d(J(x), (J(g),), jnp.int32(count), weights,
                                   center, exact=exact)
    _close(got, want)


@pytest.mark.parametrize("kind", ["row_number", "rank", "dense_rank"])
def test_segment_rank_matches_reference(kind):
    g, t, count = _grouped(5, dup=True)
    got = tphys.segment_rank((T(g),), (T(t),), torch.tensor(count, dtype=torch.int32),
                             kind)
    want = rphys.segment_rank((J(g),), (J(t),), jnp.int32(count), kind)
    _close(got, want)


def test_run_starts_matches_reference():
    g, t, count = _grouped(6, dup=True)
    valid = np.arange(len(g)) < count
    got = tphys.run_starts((T(g), T(t)), T(valid))
    want = rphys.run_starts((J(g), J(t)), J(valid))
    _close(got, want)


@pytest.mark.parametrize("weights,center,exact", [
    ((1, 2, 1), 1, False), ((1, 1, 1), 1, True), ((1, 0, 0, 0), 3, False),
    ((0, 0, 1), 0, False), ((1,) * 20, 19, True)])
def test_stencil1d_single_rank_matches_reference(weights, center, exact):
    rng = np.random.default_rng(7)
    x = rng.normal(size=250).astype(np.float32)
    got = tphys.stencil1d(T(x), torch.tensor(230, dtype=torch.int32), weights,
                          center, P=1, exact=exact)
    want = rphys.stencil1d(J(x), jnp.int32(230), weights, center, (),
                           exact=exact)
    _close(got, want)


@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_dist_cumsum_single_rank_matches_reference(dtype):
    rng = np.random.default_rng(8)
    x = (rng.integers(-9, 9, 300) if dtype == np.int32
         else rng.normal(size=300)).astype(dtype)
    got = tphys.dist_cumsum(T(x), torch.tensor(270, dtype=torch.int32), P=1)
    want = rphys.dist_cumsum(J(x), jnp.int32(270), ())
    if dtype == np.int32:
        _close(got, want)
    else:
        _scan_close(got, want, x)


@pytest.mark.parametrize("kind", ["row_number", "rank", "dense_rank"])
def test_global_rank_single_rank_matches_reference(kind):
    rng = np.random.default_rng(9)
    k1 = np.sort(rng.integers(0, 30, 200)).astype(np.int32)
    k2 = rng.integers(0, 3, 200).astype(np.int32)
    order = np.lexsort((k2, k1))
    k1, k2 = k1[order], k2[order]
    got = tphys.global_rank((T(k1), T(k2)), torch.tensor(180, dtype=torch.int32),
                            200, kind, P=1)
    want = rphys.global_rank((J(k1), J(k2)), jnp.int32(180), 200, kind, ())
    _close(got, want)


def test_single_rank_exscan_and_halo_are_zero():
    v = torch.tensor(7, dtype=torch.int32)
    assert int(tphys.exscan_scalar(v, 1)) == 0
    assert int(tphys.exscan_scalar(v, 1, method="ladder")) == 0
    x = np.arange(10, dtype=np.float32)
    for kl, kr in ((2, 1), (0, 3), (1, 0)):
        gl, gr = tphys.halo_exchange(T(x), torch.tensor(8, dtype=torch.int32),
                                     kl, kr, P=1)
        wl, wr = rphys.halo_exchange(J(x), jnp.int32(8), kl, kr, ())
        _close(gl, wl)
        _close(gr, wr)
