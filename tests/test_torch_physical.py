"""Per-rank operators of the port against the reference's, on the same
numpy inputs: hashing and routing bit for bit, packing bit for bit,
compaction, the multi-key local sort (NaN keys included), the rank merge
join, every AGG_DECOMP fn through segment_aggregate and the partial/final
algebra with skipna on and off, and the JAX-with-x64-off dtype inference.
Integers, bools and hashes are exact; floats use rtol=1e-4, atol=1e-3.
"""
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core import expr as rexpr  # noqa: E402
from repro.core import physical as rphys  # noqa: E402
from repro_torch.core import expr as texpr  # noqa: E402
from repro_torch.core import physical as tphys  # noqa: E402


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def J(a):
    return jnp.asarray(a)


def i32(v):
    return torch.tensor(v, dtype=torch.int32), jnp.int32(v)


def assert_same(got, want, exact_floats=False):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    if np.issubdtype(want.dtype, np.floating) and not exact_floats:
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)
    else:
        np.testing.assert_array_equal(got, want)


def assert_cols(got: dict, want: dict, **kw):
    assert list(got) == list(want)
    for k in want:
        assert_same(got[k], want[k], **kw)


def _hash_inputs():
    rng = np.random.default_rng(0)
    ints = np.concatenate([
        rng.integers(-2**31, 2**31 - 1, 500),
        [0, -1, 1, -2**31, 2**31 - 1]]).astype(np.int32)
    big = np.concatenate([rng.integers(2**31, 2**32, 300),
                          [2**31, 2**32 - 1, 0]]).astype(np.uint32)
    fl = np.concatenate([rng.normal(size=300) * 1e6,
                         [np.nan, -np.nan, 0.0, -0.0, np.inf, -np.inf]]
                        ).astype(np.float32)
    fl = np.concatenate([fl, np.array([0x7FC00001, 0xFFC12345],
                                      np.uint32).view(np.float32)])
    return {"int32": ints, "uint32": big, "float32": fl,
            "bool": rng.random(50) < 0.5}


@pytest.mark.parametrize("kind", ["int32", "uint32", "float32", "bool"])
def test_hash_u32_bit_exact(kind):
    x = _hash_inputs()[kind]
    got = tphys.hash_u32(T(x)).numpy()
    want = np.asarray(rphys.hash_u32(J(x))).astype(np.int64)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("P", [2, 3, 8])
def test_hash_keys_and_destinations_bit_exact(P):
    rng = np.random.default_rng(P)
    n = 400
    cols = {"a": rng.integers(-2**31, 2**31 - 1, n).astype(np.int32),
            "b": rng.normal(size=n).astype(np.float32),
            "c": rng.integers(-5, 5, n).astype(np.int32)}
    cols["b"][::17] = np.nan
    cols["b"][::23] = -0.0
    for keys in (("a",), ("b",), ("a", "b"), ("c", "b", "a")):
        got = tphys.hash_keys({k: T(v) for k, v in cols.items()}, keys)
        want = rphys.hash_keys({k: J(v) for k, v in cols.items()}, keys)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int64))
        # shuffle_by_key's routing: hash % P
        np.testing.assert_array_equal(
            (got % P).to(torch.int32).numpy(),
            np.asarray((want % np.uint32(P)).astype(jnp.int32)))


def _pack_cols():
    rng = np.random.default_rng(1)
    n = 64
    f = rng.normal(size=n).astype(np.float32)
    f[:4] = np.array([0x7FC00001, 0xFFC12345, 0x7F800001, 0x80000000],
                     np.uint32).view(np.float32)      # NaN payloads, -0.0
    return {"f": f, "i": rng.integers(-2**31, 2**31 - 1, n).astype(np.int32),
            "b": rng.random(n) < 0.5,
            "h": rng.integers(-2**15, 2**15, n).astype(np.int16),
            "u": rng.integers(0, 256, n).astype(np.uint8),
            "e": rng.normal(size=n).astype(np.float16)}


def test_pack_columns_bit_exact_with_reference():
    cols = _pack_cols()
    got, glay = tphys.pack_columns({k: T(v) for k, v in cols.items()})
    want, wlay = rphys.pack_columns({k: J(v) for k, v in cols.items()})
    np.testing.assert_array_equal(got.numpy().view(np.uint32), np.asarray(want))
    assert [(n, o, w) for n, _d, o, w in glay] == [(n, o, w) for n, _d, o, w in wlay]


def test_pack_unpack_round_trip_bit_exact():
    cols = _pack_cols()
    cols["d"] = np.array([np.nan, -0.0, 1e300, -7.5] * 16, np.float64)
    cols["l"] = np.arange(-32, 32, dtype=np.int64) * (2**40 + 3)
    words, layout = tphys.pack_columns({k: T(v) for k, v in cols.items()})
    assert words.dtype == torch.int32
    assert words.shape[1] == 10          # 6 one-word columns, 2 two-word
    back = tphys.unpack_columns(words, layout)
    for k, v in cols.items():
        got = back[k].numpy()
        assert got.dtype == v.dtype
        if v.dtype == np.bool_:
            np.testing.assert_array_equal(got, v)
        else:
            np.testing.assert_array_equal(got.view(f"u{v.itemsize}"),
                                          v.view(f"u{v.itemsize}"))


@pytest.mark.parametrize("cap_out", [0, 5, 130, 400])
def test_compact_matches_reference(cap_out):
    rng = np.random.default_rng(cap_out)
    n = 300
    cols = {"k": rng.integers(0, 9, n).astype(np.int32),
            "x": rng.normal(size=n).astype(np.float32)}
    keep = rng.random(n) < 0.4
    got, gc, go = tphys.compact({k: T(v) for k, v in cols.items()}, T(keep), cap_out)
    want, wc, wo = rphys.compact({k: J(v) for k, v in cols.items()}, J(keep), cap_out)
    assert_cols(got, want, exact_floats=True)
    assert int(gc) == int(wc) and bool(go) == bool(wo)


def test_compact_empty_shard():
    got, gc, go = tphys.compact({"x": torch.zeros(0)}, torch.zeros(0, dtype=torch.bool), 4)
    assert got["x"].shape == (4,) and int(gc) == 0 and not bool(go)


@pytest.mark.parametrize("keys", [("f",), ("k1", "f"), ("f", "k2"), ("k1", "k2")])
def test_local_sort_matches_reference(keys):
    rng = np.random.default_rng(len(keys))
    n, count = 200, 170
    cols = {"k1": rng.integers(0, 5, n).astype(np.int32),
            "k2": rng.integers(-3, 3, n).astype(np.int32),
            "f": rng.integers(-3, 3, n).astype(np.float32),
            "v": rng.normal(size=n).astype(np.float32)}
    cols["f"][::13] = np.nan
    cols["f"][::11] = -0.0
    gc, tc = i32(count)
    got, gk = tphys.local_sort({k: T(v) for k, v in cols.items()}, gc, keys)
    want, wk = rphys.local_sort({k: J(v) for k, v in cols.items()}, tc, keys)
    assert_cols(got, want, exact_floats=True)
    for a, b in zip(gk, wk):
        assert_same(a, b, exact_floats=True)


def test_lex_ranks_matches_reference():
    rng = np.random.default_rng(3)
    n = 150
    a = rng.integers(0, 4, n).astype(np.int32)
    b = rng.integers(0, 3, n).astype(np.float32)
    b[::9] = np.nan
    valid = np.arange(n) < 120
    got = tphys.lex_ranks([T(a), T(b)], T(valid))
    want = rphys.lex_ranks([J(a), J(b)], J(valid))
    for g, w in zip(got, want):
        assert_same(g, w)


def _join_frames(seed):
    rng = np.random.default_rng(seed)
    n, m = 120, 40
    left = {"a": rng.integers(0, 6, n).astype(np.int32),
            "b": rng.integers(0, 3, n).astype(np.int32),
            "x": rng.normal(size=n).astype(np.float32)}
    right = {"ca": rng.integers(0, 6, m).astype(np.int32),
             "cb": rng.integers(0, 3, m).astype(np.int32),
             "w": rng.normal(size=m).astype(np.float32),
             "j": rng.integers(0, 100, m).astype(np.int32)}
    return left, right


@pytest.mark.parametrize("how", ["inner", "left"])
@pytest.mark.parametrize("keys", [(("a",), ("ca",)), (("a", "b"), ("ca", "cb"))])
def test_merge_join_matches_reference(how, keys):
    left, right = _join_frames(7)
    lk, rk = keys
    fill = {"w": np.nan} if how == "left" else None
    kw = dict(cap_out=600, r_suffix_map={"j": "j_r"}, how=how)
    lc, ljc = i32(100)
    rc, rjc = i32(35)
    got = tphys.merge_join({k: T(v) for k, v in left.items()}, lc,
                           {k: T(v) for k, v in right.items()}, rc, lk, rk,
                           null_fill=fill, **kw)
    want = rphys.merge_join({k: J(v) for k, v in left.items()}, ljc,
                            {k: J(v) for k, v in right.items()}, rjc, lk, rk,
                            null_fill=fill, **kw)
    assert_cols(got[0], want[0], exact_floats=True)
    assert int(got[1]) == int(want[1]) and bool(got[2]) == bool(want[2])


def test_merge_join_overflow_flag_matches_reference():
    left, right = _join_frames(8)
    kw = dict(cap_out=50, r_suffix_map={}, how="inner")
    lc, ljc = i32(120)
    rc, rjc = i32(40)
    got = tphys.merge_join({k: T(v) for k, v in left.items()}, lc,
                           {k: T(v) for k, v in right.items()}, rc, "a", "ca", **kw)
    want = rphys.merge_join({k: J(v) for k, v in left.items()}, ljc,
                            {k: J(v) for k, v in right.items()}, rjc, "a", "ca", **kw)
    assert bool(got[2]) and bool(want[2])
    assert int(got[1]) == int(want[1]) == 50
    assert_cols(got[0], want[0], exact_floats=True)


AGG_FNS = ("sum", "mean", "count", "min", "max", "prod", "any", "all", "var",
           "std", "first", "nunique")


def _agg_input(seed, nulls):
    rng = np.random.default_rng(seed)
    n, count = 240, 220
    keys = np.sort(rng.integers(0, 12, n)).astype(np.int32)
    k2 = rng.integers(0, 2, n).astype(np.int32)
    order = np.lexsort((k2, keys))
    keys, k2 = keys[order], k2[order]
    x = rng.integers(-4, 5, n).astype(np.float32)
    if nulls:
        x[rng.random(n) < 0.2] = np.nan
        x[keys == 3] = np.nan            # an all-null group
    xi = rng.integers(1, 4, n).astype(np.int32)
    return keys, k2, x, xi, count


@pytest.mark.parametrize("skipna", [True, False])
@pytest.mark.parametrize("fn", AGG_FNS)
def test_segment_aggregate_matches_reference(fn, skipna):
    keys, k2, x, xi, count = _agg_input(11, nulls=True)
    gc, jc = i32(count)
    for vals, tag in ((x, "nan"), (xi, None)):
        specs_t = {"o": (fn, T(vals), skipna, tag)}
        specs_j = {"o": (fn, J(vals), skipna, tag)}
        got = tphys.segment_aggregate((T(keys), T(k2)), gc, specs_t, cap_out=64)
        want = rphys.segment_aggregate((J(keys), J(k2)), jc, specs_j, cap_out=64)
        assert_cols(got[0], want[0])
        assert int(got[1]) == int(want[1])


def test_segment_aggregate_presorted_nunique():
    keys, _k2, _x, xi, count = _agg_input(12, nulls=False)
    order = np.lexsort((xi, keys))
    keys, xi = keys[order], xi[order]
    gc, jc = i32(count)
    got = tphys.segment_aggregate(T(keys), gc, {"u": ("nunique", T(xi))},
                                  cap_out=32, presorted=("u",))
    want = rphys.segment_aggregate(J(keys), jc, {"u": ("nunique", J(xi))},
                                   cap_out=32, presorted=("u",))
    assert_cols(got[0], want[0])


def test_segment_aggregate_overflow_matches_reference():
    keys, _k2, x, _xi, count = _agg_input(13, nulls=False)
    gc, jc = i32(count)
    got = tphys.segment_aggregate(T(keys), gc, {"s": ("sum", T(x))}, cap_out=5)
    want = rphys.segment_aggregate(J(keys), jc, {"s": ("sum", J(x))}, cap_out=5)
    assert bool(got[2]) and bool(want[2])
    assert_cols(got[0], want[0])


@pytest.mark.parametrize("nulls", [False, True])
@pytest.mark.parametrize("fn", sorted(tphys.AGG_DECOMP))
def test_partial_then_final_matches_reference(fn, nulls):
    keys, _k2, x, _xi, count = _agg_input(14, nulls=nulls)
    tag = "nan" if nulls else None
    gc, jc = i32(count)
    spec_t = {"o": (fn, T(x), True, tag)}
    spec_j = {"o": (fn, J(x), True, tag)}
    gp = tphys.partial_aggregate(T(keys), gc, spec_t, cap_out=40)
    wp = rphys.partial_aggregate(J(keys), jc, spec_j, cap_out=40)
    assert_cols(gp[0], wp[0])
    fns = {"o": (fn, True, tag) if tag else fn}
    pt = {k: v for k, v in gp[0].items() if k.startswith("__p_")}
    pj = {k: v for k, v in wp[0].items() if k.startswith("__p_")}
    gf = tphys.final_aggregate(gp[0]["__key0__"], gp[1], fns, pt, cap_out=40)
    wf = rphys.final_aggregate(wp[0]["__key0__"], wp[1], fns, pj, cap_out=40)
    assert_cols(gf[0], wf[0])


_DTYPES = (np.bool_, np.int32, np.float32)
_BIN = ("add", "sub", "mul", "div", "mod", "lt", "le", "gt", "ge", "eq", "ne",
        "and", "or")
_UN = ("not", "neg", "abs", "log", "exp", "sqrt", "isnan", "floor", "ceil",
       "isna")
_CONSTS = (1, 2.5, True, np.int32(3), np.float32(0.5))


def _both(build):
    return build(texpr), build(rexpr)


@pytest.mark.parametrize("op", _BIN)
def test_infer_dtype_binops_match_reference(op):
    for da, db in itertools.product(_DTYPES, _DTYPES):
        sch = {"a": np.dtype(da), "b": np.dtype(db)}
        t, r = _both(lambda m: m.BinOp(op, m.ColRef(0, "a"), m.ColRef(0, "b")))
        assert texpr.infer_dtype(t, sch) == rexpr.infer_dtype(r, sch), (op, da, db)
        for c in _CONSTS:
            t, r = _both(lambda m: m.BinOp(op, m.ColRef(0, "a"), m.Const(c)))
            assert texpr.infer_dtype(t, sch) == rexpr.infer_dtype(r, sch), (op, da, c)


@pytest.mark.parametrize("op", _UN)
def test_infer_dtype_unops_match_reference(op):
    for da in _DTYPES:
        sch = {"a": np.dtype(da)}
        t, r = _both(lambda m: m.UnOp(op, m.ColRef(0, "a")))
        assert texpr.infer_dtype(t, sch) == rexpr.infer_dtype(r, sch), (op, da)
    for c in _CONSTS:
        t, r = _both(lambda m: m.Const(c))
        assert texpr.infer_dtype(t, {}) == rexpr.infer_dtype(r, {}), c


_EVAL_BIN = ("add", "mul", "div", "mod", "lt", "le", "gt", "ge", "eq", "ne",
             "and", "or")


@pytest.mark.parametrize("op", _EVAL_BIN)
def test_evaluate_matches_reference(op):
    """Column-column and column-constant results agree in value and dtype
    (a Python constant stays weakly typed, as in JAX)."""
    rng = np.random.default_rng(2)
    cols = {"b": rng.random(32) < 0.5,
            "i": rng.integers(1, 9, 32).astype(np.int32),
            "f": (rng.normal(size=32) + 5).astype(np.float32)}
    tenv = {k: T(v) for k, v in cols.items()}
    jenv = {k: J(v) for k, v in cols.items()}
    for a, b in itertools.product(cols, list(cols) + [3, 2.5]):
        if op == "mod" and "b" in (a, b):
            continue              # integer mod by a zero divisor
        t, r = _both(lambda m: m.BinOp(
            op, m.ColRef(0, a), m.ColRef(0, b) if isinstance(b, str) else m.Const(b)))
        assert_same(texpr.evaluate(t, tenv), rexpr.evaluate(r, jenv))


@pytest.mark.parametrize("packed", [True, False])
def test_shuffle_by_key_single_rank_matches_reference(packed):
    """At P=1 an exchange is a compaction of the valid rows (no
    collective); rows, count and flag agree with the reference's."""
    rng = np.random.default_rng(9)
    n = 90
    cols = {"k": rng.integers(0, 5, n).astype(np.int32),
            "x": rng.normal(size=n).astype(np.float32)}
    gc, jc = i32(70)
    got = tphys.shuffle_by_key({k: T(v) for k, v in cols.items()}, gc, "k",
                               P=1, bucket_cap=n, cap_out=80, packed=packed)
    want = rphys.shuffle_by_key({k: J(v) for k, v in cols.items()}, jc, "k",
                                axes=(), bucket_cap=n, cap_out=80, packed=packed)
    assert_cols(got[0], want[0], exact_floats=True)
    assert int(got[1]) == int(want[1]) and bool(got[2]) == bool(want[2])


# -- limit, rebalance, sample sort and concat at P = 1 -------------------------


def _sort_cols(seed, n=160, nan=False):
    rng = np.random.default_rng(seed)
    cols = {"k1": rng.integers(0, 6, n).astype(np.int32),
            "k2": rng.integers(-4, 4, n).astype(np.float32),
            "v": rng.normal(size=n).astype(np.float32)}
    if nan:
        cols["k2"][::7] = np.nan
    cols["k2"][::11] = -0.0
    return cols


@pytest.mark.parametrize("n_keep,count", [(0, 120), (7, 120), (120, 120),
                                          (500, 120), (9, 0)])
def test_limit_matches_reference(n_keep, count):
    cols = _sort_cols(n_keep)
    cap_out = max(1, min(160, n_keep))
    gc, jc = i32(count)
    got = tphys.limit({k: T(v) for k, v in cols.items()}, gc, n_keep, 1,
                      cap_out=cap_out)
    want = rphys.limit({k: J(v) for k, v in cols.items()}, jc, n_keep, (),
                       cap_out=cap_out)
    assert_cols(got[0], want[0], exact_floats=True)
    assert_same(got[1], want[1])


@pytest.mark.parametrize("count,cap_out", [(0, 160), (100, 160), (160, 160),
                                           (100, 60)])
def test_rebalance_single_rank_matches_reference(count, cap_out):
    cols = _sort_cols(count)
    gc, jc = i32(count)
    got = tphys.rebalance({k: T(v) for k, v in cols.items()}, gc, P=1,
                          bucket_cap=160, cap_out=cap_out)
    want = rphys.rebalance({k: J(v) for k, v in cols.items()}, jc, axes=(),
                           bucket_cap=160, cap_out=cap_out)
    assert_cols(got[0], want[0], exact_floats=True)
    assert int(got[1]) == int(want[1]) and bool(got[2]) == bool(want[2])


@pytest.mark.parametrize("pre_sorted", [False, True])
@pytest.mark.parametrize("ascending", [True, False])
@pytest.mark.parametrize("keys", [("k2",), ("k1",), ("k1", "k2"), ("k2", "k1")])
def test_sample_sort_single_rank_matches_reference(keys, ascending, pre_sorted):
    cols = _sort_cols(len(keys) + 2 * ascending)
    gc, jc = i32(130)
    tcols = {k: T(v) for k, v in cols.items()}
    jcols = {k: J(v) for k, v in cols.items()}
    if pre_sorted:
        tcols = tphys.local_sort(tcols, gc, keys)[0]
        jcols = rphys.local_sort(jcols, jc, keys)[0]
    got = tphys.sample_sort(tcols, gc, keys, P=1, bucket_cap=160,
                            cap_out=150, ascending=ascending,
                            pre_sorted=pre_sorted)
    want = rphys.sample_sort(jcols, jc, keys, axes=(), bucket_cap=160,
                             cap_out=150, ascending=ascending,
                             pre_sorted=pre_sorted)
    assert_cols(got[0], want[0], exact_floats=True)
    assert int(got[1]) == int(want[1]) and bool(got[2]) == bool(want[2])


@pytest.mark.parametrize("ascending", [True, False])
def test_sample_sort_nan_keys_keep_reference_fault(ascending):
    """NaN keys with padding (ROADMAP section 3): NaN sorts after the
    float-max sentinel of the padding rows in both packages, so padding
    rows enter the valid prefix in place of the NaN rows.  Pinned so that
    the port keeps the reference's answer until both are fixed together."""
    cols = _sort_cols(5, nan=True)
    gc, jc = i32(130)
    got = tphys.sample_sort({k: T(v) for k, v in cols.items()}, gc, ("k2",),
                            P=1, bucket_cap=160, cap_out=160,
                            ascending=ascending)
    want = rphys.sample_sort({k: J(v) for k, v in cols.items()}, jc, ("k2",),
                             axes=(), bucket_cap=160, cap_out=160,
                             ascending=ascending)
    assert_cols(got[0], want[0], exact_floats=True)
    assert int(got[1]) == int(want[1])
    k = got[0]["k2"].numpy()[:int(got[1])]
    nan_rows = int(np.isnan(cols["k2"][:130]).sum())
    assert nan_rows and int(np.isnan(k).sum()) < nan_rows


@pytest.mark.parametrize("cap_out", [3, 90, 400])
def test_concat_matches_reference(cap_out):
    parts_t, parts_j = [], []
    for seed, (n, c) in enumerate(((160, 100), (40, 0), (70, 70))):
        cols = _sort_cols(seed, n)
        parts_t.append(({k: T(v) for k, v in cols.items()},
                        torch.tensor(c, dtype=torch.int32)))
        parts_j.append(({k: J(v) for k, v in cols.items()}, jnp.int32(c)))
    got = tphys.concat(parts_t, cap_out)
    want = rphys.concat(parts_j, cap_out)
    assert_cols(got[0], want[0], exact_floats=True)
    assert int(got[1]) == int(want[1]) and bool(got[2]) == bool(want[2])
