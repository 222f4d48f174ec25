"""The frame path's queries, written once against either package's ``hf``
(FRAME_SRC), at small sizes, with their numpy oracles.

chip_smoke.py's ``frame`` path runs the same shapes at Q26's scale 64 on the
card.  This module imports neither JAX nor the reference package, so the
card's tests (tests/test_torch_cuda.py) read it as well as the CPU parity
tests (tests/test_torch_frame.py) and the two-rank spawn
(tests/test_torch_e2e.py), which execs FRAME_SRC in its ranks.
"""

FRAME_SRC = '''
import numpy as np

from repro_torch.data import synth

# four names shared with synth.CATEGORY_NAMES, two new
DIM_NAMES = ("bikes", "books", "garden", "music", "toys", "wine")


def frame_data(n_clicks=4000, n_items=200, n_users=150, n_sales=3000,
               n_cust=100):
    """Web clicks (Zipf-skewed items), the item table with its string
    category name, and store sales with a string channel and a discount,
    both holding 2 % null holes; a 6-row dimension keyed by category name
    whose dictionary only overlaps the item table's."""
    d = {"wcs": synth.web_clickstream(n_clicks, n_items, n_users, seed=2,
                                      skew=1.1),
         "itx": synth.item_ext(n_items, seed=1),
         "ssx": synth.store_sales_ext(n_sales, n_items, n_cust, seed=10)}
    rng = np.random.default_rng(21)
    d["cdim"] = {"i_category_name": np.asarray(DIM_NAMES, dtype=object),
                 "w": rng.normal(size=len(DIM_NAMES)).astype(np.float32)}
    return d


def item_int(itx):
    """The item table with its category names as int32 codes into the
    sorted synth.CATEGORY_NAMES: the int-category shape of Q05."""
    it = dict(itx)
    lut = {v: i for i, v in enumerate(synth.CATEGORY_NAMES)}
    it["i_category_name"] = np.fromiter((lut[v] for v in itx["i_category_name"]),
                                        np.int32, len(itx["i_category_name"]))
    return it


def q05_shape(wcs_df, item_df, books, media):
    """TPCx-BB Q05 (bench_tpcx.py:100): clicks per user on one category
    and on two others, and all clicks."""
    j = wcs_df.merge(item_df, on=("wcs_item_sk", "i_item_sk"))
    return j.groupby("wcs_user_sk").agg(
        clicks_books=(j["i_category_name"] == books, "sum"),
        clicks_media=(j["i_category_name"].isin(media), "sum"),
        total="count")


def q05_string(hf, d):
    return q05_shape(hf.table(d["wcs"], "wcs"), hf.table(d["itx"], "it"),
                     "books", ["electronics", "music"])


def q05_int(hf, d):
    """q05_string on int category codes: the same plan."""
    names = list(synth.CATEGORY_NAMES)
    return q05_shape(hf.table(d["wcs"], "wcs"),
                     hf.table(item_int(d["itx"]), "it"), names.index("books"),
                     [names.index("electronics"), names.index("music")])


def q09_channel(hf, d):
    """bench_tpcx.py:113: a string isin filter, a nullable category group
    key, skipna sum/mean/count over the nullable discount."""
    ss = hf.table(d["ssx"], "ss")
    f = ss[ss["ss_channel"].isin(["web", "catalog"])]
    return f.groupby("ss_channel").agg(
        revenue=("ss_net_paid", "sum"), avg_disc=("ss_discount", "mean"),
        n_disc=("ss_discount", "count"), n="count")


def frame_verbs(hf, d):
    ss = hf.table(d["ssx"], "ss")
    v = (ss.dropna(subset="ss_channel").fillna({"ss_discount": 0.0})
         .assign(net=lambda q: q.ss_net_paid - q.ss_discount)
         .astype({"ss_customer_sk": np.float32})
         .rename(columns={"ss_channel": "channel"})
         .drop("ss_ticket_number"))
    v["is_web"] = v["channel"] == "web"
    return v.groupby("channel").agg(
        net=("net", "sum"), cust=("ss_customer_sk", "mean"),
        web=("is_web", "sum"), n="count")


def null_rows(hf, d):
    ss = hf.table(d["ssx"], "ss")
    return ss[ss.ss_channel.isna() | ss.ss_discount.isna()][["ss_ticket_number"]]


def concat_halves(ssx):
    """Two halves of the sales; the first keeps only its catalog and store
    rows, so the two parts' dictionaries differ."""
    h = len(ssx["ss_channel"]) // 2
    ch = ssx["ss_channel"][:h]
    keep = np.flatnonzero((ch == "catalog") | (ch == "store"))
    return ({k: v[:h][keep] for k, v in ssx.items()},
            {k: v[h:] for k, v in ssx.items()})


def concat_channels(hf, d):
    a, b = concat_halves(d["ssx"])
    both = hf.concat(hf.table(a, "a"), hf.table(b, "b"))
    return both.groupby("ss_channel").agg(
        n="count", revenue=("ss_net_paid", "sum"))


def merge_category_keys(hf, d):
    j = hf.table(d["itx"], "it").merge(hf.table(d["cdim"], "cdim"),
                                       on="i_category_name")
    return j.groupby("i_category_name").agg(
        n="count", w=("w", "max"), cls=("i_class_id", "sum"))


FRAME_QUERIES = {"q05_string": q05_string, "q05_int": q05_int,
                 "q09_channel": q09_channel, "frame_verbs": frame_verbs,
                 "null_rows": null_rows, "concat_channels": concat_channels,
                 "merge_category_keys": merge_category_keys}

# the column each result is ordered by before it is compared
FRAME_KEYS = {"q05_string": "wcs_user_sk", "q05_int": "wcs_user_sk",
              "q09_channel": "ss_channel", "frame_verbs": "channel",
              "null_rows": "ss_ticket_number",
              "concat_channels": "ss_channel",
              "merge_category_keys": "i_category_name"}


def _per_key(keys, cols):
    """Group the rows of ``cols`` by the non-null ``keys``: the sorted
    distinct keys and, per column, its float64 sum per key."""
    ok = np.asarray([k is not None for k in keys])
    ks = np.asarray(keys[ok], dtype=str)
    uniq, inv = np.unique(ks, return_inverse=True)
    out = {c: np.bincount(inv, weights=np.asarray(v)[ok].astype(np.float64),
                          minlength=len(uniq)) for c, v in cols.items()}
    return uniq.astype(object), out


def frame_oracle(name, d):
    """numpy's answer to FRAME_QUERIES[name], category columns as strings,
    ordered by FRAME_KEYS[name]."""
    ssx = d["ssx"]
    if name in ("q05_string", "q05_int"):
        wcs, names = d["wcs"], d["itx"]["i_category_name"]
        cat = names[wcs["wcs_item_sk"]]
        user = wcs["wcs_user_sk"]
        n_u = np.bincount(user)
        keys = np.flatnonzero(n_u)
        media = (cat == "electronics") | (cat == "music")
        return {"wcs_user_sk": keys.astype(np.int32),
                "clicks_books": np.bincount(user, weights=cat == "books",
                                            minlength=len(n_u))[keys].astype(np.int32),
                "clicks_media": np.bincount(user, weights=media,
                                            minlength=len(n_u))[keys].astype(np.int32),
                "total": n_u[keys].astype(np.int32)}
    if name == "q09_channel":
        ch = ssx["ss_channel"]
        m = (ch == "web") | (ch == "catalog")
        disc = ssx["ss_discount"][m]
        ok = ~np.isnan(disc)
        k, s = _per_key(ch[m], {"revenue": ssx["ss_net_paid"][m],
                                "disc": np.where(ok, disc, 0), "n_disc": ok,
                                "n": np.ones(int(m.sum()))})
        return {"ss_channel": k, "revenue": s["revenue"].astype(np.float32),
                "avg_disc": (s["disc"] / s["n_disc"]).astype(np.float32),
                "n_disc": s["n_disc"].astype(np.int32),
                "n": s["n"].astype(np.int32)}
    if name == "frame_verbs":
        ch = ssx["ss_channel"]
        disc = np.where(np.isnan(ssx["ss_discount"]), np.float32(0),
                        ssx["ss_discount"])
        net = ssx["ss_net_paid"] - disc               # float32, as on device
        k, s = _per_key(ch, {"net": net, "n": np.ones(len(ch)),
                             "cust": ssx["ss_customer_sk"].astype(np.float32),
                             "web": ch == "web"})
        return {"channel": k, "net": s["net"].astype(np.float32),
                "cust": (s["cust"] / s["n"]).astype(np.float32),
                "web": s["web"].astype(np.int32), "n": s["n"].astype(np.int32)}
    if name == "null_rows":
        m = np.asarray([c is None for c in ssx["ss_channel"]]) \\
            | np.isnan(ssx["ss_discount"])
        return {"ss_ticket_number": np.sort(ssx["ss_ticket_number"][m])}
    if name == "concat_channels":
        a, b = concat_halves(ssx)
        ch = np.concatenate([a["ss_channel"], b["ss_channel"]])
        paid = np.concatenate([a["ss_net_paid"], b["ss_net_paid"]])
        k, s = _per_key(ch, {"n": np.ones(len(ch)), "revenue": paid})
        return {"ss_channel": k, "n": s["n"].astype(np.int32),
                "revenue": s["revenue"].astype(np.float32)}
    assert name == "merge_category_keys", name
    itx, dim = d["itx"], d["cdim"]
    w = dict(zip(dim["i_category_name"], dim["w"]))
    names = itx["i_category_name"]
    m = np.asarray([v in w for v in names])
    k, s = _per_key(names[m], {"n": np.ones(int(m.sum())),
                               "cls": itx["i_class_id"][m]})
    return {"i_category_name": k, "n": s["n"].astype(np.int32),
            "w": np.asarray([w[v] for v in k], np.float32),
            "cls": s["cls"].astype(np.int32)}


def assert_frame_result(name, got, d, rtol=1e-4, atol=1e-3):
    """``got`` (decoded to strings) holds the oracle's rows: ordered by
    FRAME_KEYS[name], ints and strings exact, floats within rtol/atol."""
    want = frame_oracle(name, d)
    assert sorted(got) == sorted(want), (name, sorted(got), sorted(want))
    key = FRAME_KEYS[name]
    order = np.argsort(np.asarray(got[key]), kind="stable")
    for c, w in want.items():
        g = np.asarray(got[c])[order]
        assert g.shape == w.shape, (name, c, g.shape, w.shape)
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g, w, rtol=rtol, atol=atol,
                                       err_msg=f"{name}.{c}")
        else:
            assert g.tolist() == w.tolist(), f"{name}.{c} differs"
'''
