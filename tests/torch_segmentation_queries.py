"""The segmentation path's queries, written once against either package's
``hf`` (SEG_SRC), with their numpy oracles and the K-means step of the
paper's customer-segmentation program (examples/customer_segmentation.py).

chip_smoke.py's ``segmentation`` path runs the same queries at Q26's scale
64 on the card and its two-rank exchange runs the group-by sugar at 2^24
rows.  This module imports neither JAX nor the reference package, so the
card's tests (tests/test_torch_cuda.py) and chip_smoke.py read it as well
as the CPU parity tests (tests/test_torch_segmentation.py) and the two-rank
spawn (tests/test_torch_e2e.py), which execs SEG_SRC in its ranks.
"""

SEG_SRC = '''
import numpy as np

from repro_torch.data import synth

# the matrix the K-means stage reads (examples/customer_segmentation.py)
FEATURES = ("c_i_count", "id1", "id2", "id3")


def seg_data(n_sales=20_000, n_items=500, n_cust=800, n_rows=3000):
    """Q26's tables as tests/test_system.py makes them, and the group
    frame of :func:`group_table` with a free float32 array of its rows."""
    d = {"ss": synth.store_sales(n_sales, n_items, n_cust, seed=5),
         "it": synth.item(n_items, seed=6)}
    d["grp"], d["ext"] = group_table(n_rows)
    return d


def group_table(n_rows, n_groups=9, seed=16):
    """tests/test_skew.py's transform shape: ``n_rows`` rows in
    ``n_groups`` groups, a third of them in group 4, two float columns;
    and a float32 array of as many rows."""
    rng = np.random.default_rng(seed)
    g = rng.integers(0, n_groups, n_rows).astype(np.int32)
    g[: n_rows // 3] = 4
    rng.shuffle(g)
    t = {"g": g, "x": rng.normal(size=n_rows).astype(np.float32),
         "y": rng.normal(size=n_rows).astype(np.float32)}
    return t, rng.normal(size=n_rows).astype(np.float32)


def q26_features(hf, d, min_count=4):
    """The relational stage of examples/customer_segmentation.py: the
    fluent Q26 chain, its count filter through a UDF."""
    store_sales = hf.table(d["ss"], "store_sales")
    item = hf.table(d["it"], "item")
    si = store_sales.merge(item, on=("ss_item_sk", "i_item_sk"))
    c = si.groupby("ss_customer_sk").agg(
        c_i_count="count",
        id1=(si.i_class_id == 1, "sum"),
        id2=(si.i_class_id == 2, "sum"),
        id3=(si.i_class_id == 3, "sum"))
    return c[hf.udf(lambda n: n > min_count, c["c_i_count"])]


def fig10_builtin(hf, df):
    """benchmarks/bench_udf.py's built-in predicate."""
    return df[(df["x"] * 2.0 + df["y"]) > 0.5]


def fig10_udf(hf, df):
    """The same predicate as a UDF."""
    return df[hf.udf(lambda x, y: x * 2.0 + y > 0.5, df["x"], df["y"])]


def _grp(hf, d):
    return hf.table(d["grp"], "grp")


def transform_mean(hf, d):
    return _grp(hf, d).groupby("g").transform("mean")


def transform_sum(hf, d):
    return _grp(hf, d).groupby("g").transform("sum")


def transform_named(hf, d):
    return _grp(hf, d).groupby("g").transform(total=("x", "sum"),
                                              ym=("y", "mean"))


def head2(hf, d):
    return _grp(hf, d).groupby("g").head(2)


def sugar_mean(hf, d):
    return _grp(hf, d).groupby("g")[["x", "y"]].mean()


def sugar_size(hf, d):
    return _grp(hf, d).groupby("g").size()


def ext_filter(hf, d):
    """A free array in a filter."""
    df = _grp(hf, d)
    return df[df.x > d["ext"]]


def ext_assign_agg(hf, d):
    """A free array assigned as a column, then aggregated."""
    return _grp(hf, d).assign(e=d["ext"]).groupby("g").agg(
        s=("e", "sum"), n="count")


def ext_agg(hf, d):
    """A free array inside an aggregate's expression."""
    df = _grp(hf, d)
    return df.groupby("g").agg(s=(df.x * d["ext"], "sum"))


SEG_QUERIES = {"q26_features": q26_features, "transform_mean": transform_mean,
               "transform_sum": transform_sum,
               "transform_named": transform_named, "head2": head2,
               "sugar_mean": sugar_mean, "sugar_size": sugar_size,
               "ext_filter": ext_filter, "ext_assign_agg": ext_assign_agg,
               "ext_agg": ext_agg}

# the columns each result is ordered by before it is compared: every
# column of the input rows where rows are kept whole
SEG_KEYS = {"q26_features": ("ss_customer_sk",),
            "transform_mean": ("g", "x", "y"), "transform_sum": ("g", "x", "y"),
            "transform_named": ("g", "x", "y"), "head2": ("g", "x", "y"),
            "sugar_mean": ("g",), "sugar_size": ("g",),
            "ext_filter": ("g", "x", "y"), "ext_assign_agg": ("g",),
            "ext_agg": ("g",)}


def q26_want(ss, it, min_count=4):
    """Q26's rows from numpy bincounts, in customer order."""
    cls = it["i_class_id"][ss["ss_item_sk"]]
    cust = ss["ss_customer_sk"]
    n_c = np.bincount(cust)
    k = np.flatnonzero(n_c > min_count)
    want = {"ss_customer_sk": k.astype(np.int32),
            "c_i_count": n_c[k].astype(np.int32)}
    for c in (1, 2, 3):
        want[f"id{c}"] = np.bincount(cust, weights=(cls == c),
                                     minlength=len(n_c))[k].astype(np.int32)
    return want


def first_rows(g, n):
    """Mask of the first ``n`` rows of each group of ``g`` in row order."""
    order = np.argsort(g, kind="stable")
    gs = g[order]
    pos = np.arange(len(g)) - np.searchsorted(gs, gs, side="left")
    keep = np.zeros(len(g), bool)
    keep[order[pos < n]] = True
    return keep


def group_stats(g, v):
    """Per-group float64 sums, row counts and means of ``v``, by group id."""
    n = np.bincount(g)
    s = np.bincount(g, weights=np.asarray(v, np.float64), minlength=len(n))
    return s, n, s / np.maximum(n, 1)


def seg_oracle(name, d):
    """The rows ``name`` must give on ``d``, as numpy columns."""
    if name == "q26_features":
        return q26_want(d["ss"], d["it"])
    t, ext = d["grp"], d["ext"]
    g = t["g"]
    keys = np.flatnonzero(np.bincount(g)).astype(np.int32)
    sx, n, mx = group_stats(g, t["x"])
    sy, _, my = group_stats(g, t["y"])
    f32 = np.float32
    if name == "transform_mean":
        return {**t, "x_mean": mx[g].astype(f32), "y_mean": my[g].astype(f32)}
    if name == "transform_sum":
        return {**t, "x_sum": sx[g].astype(f32), "y_sum": sy[g].astype(f32)}
    if name == "transform_named":
        return {**t, "total": sx[g].astype(f32), "ym": my[g].astype(f32)}
    if name == "head2":
        m = first_rows(g, 2)
        return {k: v[m] for k, v in t.items()}
    if name == "sugar_mean":
        return {"g": keys, "x": mx[keys].astype(f32), "y": my[keys].astype(f32)}
    if name == "sugar_size":
        return {"g": keys, "size": n[keys].astype(np.int32)}
    if name == "ext_filter":
        m = t["x"] > ext
        return {k: v[m] for k, v in t.items()}
    if name == "ext_assign_agg":
        s = group_stats(g, ext)[0]
        return {"g": keys, "s": s[keys].astype(f32),
                "n": n[keys].astype(np.int32)}
    if name == "ext_agg":
        s = group_stats(g, t["x"].astype(np.float64) * ext)[0]
        return {"g": keys, "s": s[keys].astype(f32)}
    raise KeyError(name)


def _bits(v):
    """A column of at most 32 bits as uint64 of its bit patterns."""
    a = np.ascontiguousarray(v)
    assert a.itemsize <= 4, a.dtype
    return a.view(f"u{a.itemsize}").astype(np.uint64)


def sort_rows(cols, keys):
    """The rows of ``cols`` in one canonical order of the key columns' bit
    patterns (the first most significant), so two row sets compare row by
    row (rows equal on every key may come in either order): one rank of
    the leading keys' packed bits a further key, then one argsort, a third
    of ``np.lexsort``'s time on 2^24 rows."""
    key = _bits(cols[keys[0]])
    for k in keys[1:]:
        if key.max(initial=0) >> np.uint64(32):
            key = np.unique(key, return_inverse=True)[1].astype(np.uint64)
        key = key << np.uint64(32) | _bits(cols[k])
    order = np.argsort(key)
    return {k: np.asarray(v)[order] for k, v in cols.items()}


def assert_seg_result(name, got, d, rtol=1e-4, atol=1e-4, want=None):
    """``got`` holds the oracle's rows (``want`` if given): both put in
    SEG_KEYS[name]'s order by :func:`sort_rows`, ints exact, floats within
    rtol/atol.  Returns the largest float difference."""
    want = seg_oracle(name, d) if want is None else want
    assert sorted(got) == sorted(want), (name, sorted(got), sorted(want))
    g, w = sort_rows(got, SEG_KEYS[name]), sort_rows(want, SEG_KEYS[name])
    worst = 0.0
    for c in w:
        assert g[c].shape == w[c].shape, (name, c, g[c].shape, w[c].shape)
        if np.issubdtype(w[c].dtype, np.floating):
            np.testing.assert_allclose(g[c], w[c], rtol=rtol, atol=atol,
                                       err_msg=f"{name}.{c}")
            if g[c].size:
                worst = max(worst, float(np.max(np.abs(
                    g[c].astype(np.float64) - w[c]))))
        else:
            assert np.array_equal(g[c], w[c]), f"{name}.{c} differs"
    return worst


def kmeans_step(x, cent):
    """One step of the program's K-means in torch, as the example writes
    it in jnp: squared distances, argmin, one-hot @ x, counts clamped at
    1.  Returns the new centroids and the assignment."""
    import torch
    d2 = ((x[:, None] - cent[None]) ** 2).sum(-1)
    a = d2.argmin(1)
    one = torch.nn.functional.one_hot(a, cent.shape[0]).to(x.dtype)
    tot = one.T @ x
    cnt = one.sum(0)[:, None]
    return tot / cnt.clamp(min=1.0), a
'''
