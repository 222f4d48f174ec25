"""End-to-end parity of the relational main path.

At P=1 every query runs three ways on the same numpy inputs: the port on
the CPU, the reference with its Pallas kernels in interpret mode, and the
python-loop oracles of tests/oracle.py.  Port and reference must agree row
for row and column by column (exact for ints and bools, floats within
rtol=1e-4, atol=1e-3); the oracle is compared as a row set.  The carry-over
tests move a reference DTable's state into the port and query it.  One test
spawns two gloo ranks and runs the same queries at P=2, together with the
window queries of tests/test_torch_window.py (the global ones with both
exclusive-scan methods), the sort, limit, rebalance, concat and persist
queries of tests/test_torch_sort.py, the frame path's queries of
tests/torch_frame_queries.py (string predicates, the null and column verbs,
recoding concat and category-key merge), and direct checks of the halo
exchange, the global rank, the sample sort (an empty rank, composite keys,
descending), the rebalance and the limit across the two ranks.
"""
import json
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

pytest.importorskip("torch")

import oracle  # noqa: E402
from repro import hiframes as rhf  # noqa: E402
from repro_torch import hiframes as thf  # noqa: E402
from repro_torch.core import dtypes as tdt  # noqa: E402
from test_torch_sort import (S, SDATA, SORT_SRC,  # noqa: E402
                             assert_sort_result)
from torch_frame_queries import FRAME_SRC  # noqa: E402
from test_torch_window import (W, WDATA, WINDOW_SRC,  # noqa: E402
                               assert_same_row_set, window_oracle)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TCFG = dict(device="cpu")

# -- the queries, written once against either package's ``hf`` ---------------

QUERY_SRC = '''
import numpy as np


def data():
    rng = np.random.default_rng(42)
    d = {}
    d["t"] = {"id": rng.integers(0, 40, 900).astype(np.int32),
              "x": rng.normal(size=900).astype(np.float32),
              "y": rng.normal(size=900).astype(np.float32)}
    d["left"] = {"id": rng.integers(0, 60, 700).astype(np.int32),
                 "x": rng.normal(size=700).astype(np.float32)}
    d["right"] = {"cid": np.arange(50, dtype=np.int32),
                  "w": rng.normal(size=50).astype(np.float32)}
    d["ss"] = {"ss_item_sk": rng.integers(0, 40, 800).astype(np.int32),
               "ss_customer_sk": rng.integers(0, 70, 800).astype(np.int32),
               "ss_net_paid": rng.gamma(2.0, 30.0, 800).astype(np.float32),
               "ss_region": rng.integers(0, 4, 800).astype(np.int32)}
    d["it"] = {"i_item_sk": np.arange(40, dtype=np.int32),
               "i_class_id": rng.integers(1, 17, 40).astype(np.int32)}
    d["dim"] = {"i_item_sk": np.tile(d["it"]["i_item_sk"], 4),
                "i_region": np.repeat(np.arange(4, dtype=np.int32), 40),
                "i_class_id": np.tile(d["it"]["i_class_id"], 4)}
    return d


def fig8a_filter(hf, d):
    df = hf.table(d["t"])
    return df[df.x < 0.5]


def fig8a_join(hf, d):
    return hf.join(hf.table(d["left"], "l"), hf.table(d["right"], "r"),
                   on=("id", "cid"))


def fig8a_aggregate(hf, d):
    df = hf.table(d["t"])
    return hf.aggregate(df, "id", s=hf.sum_(df["x"]), m=hf.mean(df["y"]))


def q26(hf, d, min_count=4):
    si = hf.join(hf.table(d["ss"], "ss"), hf.table(d["it"], "it"),
                 on=("ss_item_sk", "i_item_sk"))
    c = hf.aggregate(si, "ss_customer_sk", c_i_count=hf.count(),
                     id1=hf.sum_(si["i_class_id"] == 1),
                     id2=hf.sum_(si["i_class_id"] == 2),
                     id3=hf.sum_(si["i_class_id"] == 3))
    return c[c["c_i_count"] > min_count]


def q26_multikey(hf, d, min_count=4):
    si = hf.join(hf.table(d["ss"], "ss"), hf.table(d["dim"], "dim"),
                 on=[("ss_item_sk", "i_item_sk"), ("ss_region", "i_region")])
    k = hf.aggregate(si, by=("ss_item_sk", "ss_region"), n=hf.count(),
                     paid=hf.sum_(si["ss_net_paid"]),
                     id1=hf.sum_(si["i_class_id"] == 1),
                     id2=hf.sum_(si["i_class_id"] == 2))
    return k[k["n"] > min_count]


QUERIES = {"fig8a_filter": fig8a_filter, "fig8a_join": fig8a_join,
           "fig8a_aggregate": fig8a_aggregate, "q26": q26,
           "q26_multikey": q26_multikey}
'''

Q: dict = {}
exec(QUERY_SRC, Q)
DATA = Q["data"]()
NAMES = list(Q["QUERIES"])
FQ: dict = {}
exec(FRAME_SRC, FQ)
FDATA = FQ["frame_data"]()


def _oracle(name, d):
    if name == "fig8a_filter":
        return oracle.o_filter(d["t"], d["t"]["x"] < np.float32(0.5))
    if name == "fig8a_join":
        return oracle.o_join(d["left"], d["right"], "id", "cid")
    if name == "fig8a_aggregate":
        t = d["t"]
        return oracle.o_aggregate(t, "id", {"s": ("sum", t["x"]),
                                            "m": ("mean", t["y"])})
    if name == "q26":
        j = oracle.o_join(d["ss"], d["it"], "ss_item_sk", "i_item_sk")
        aggs = {"c_i_count": ("count", None)}
        aggs.update({f"id{c}": ("sum", (j["i_class_id"] == c).astype(np.int32))
                     for c in (1, 2, 3)})
        a = oracle.o_aggregate(j, "ss_customer_sk", aggs)
        return oracle.o_filter(a, a["c_i_count"] > 4)
    j = oracle.o_join(d["ss"], d["dim"], ("ss_item_sk", "ss_region"),
                      ("i_item_sk", "i_region"))
    aggs = {"n": ("count", None), "paid": ("sum", j["ss_net_paid"])}
    aggs.update({f"id{c}": ("sum", (j["i_class_id"] == c).astype(np.int32))
                 for c in (1, 2)})
    a = oracle.o_aggregate(j, ("ss_item_sk", "ss_region"), aggs)
    return oracle.o_filter(a, a["n"] > 4)


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


def _as_row_set(d: dict) -> dict:
    """Rows sorted lexicographically by every column (names sorted)."""
    names = sorted(d)
    order = np.lexsort([np.asarray(d[k]) for k in reversed(names)])
    return {k: np.asarray(d[k])[order] for k in names}


def _assert_same_row_set(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    g, w = _as_row_set(got), _as_row_set(want)
    for k in w:
        if np.issubdtype(w[k].dtype, np.floating):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4, atol=1e-3,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(g[k], w[k].astype(g[k].dtype),
                                          err_msg=k)


@pytest.mark.parametrize("name", NAMES)
def test_query_matches_reference_and_oracle(name):
    build = Q["QUERIES"][name]
    got = build(thf, DATA).collect(thf.ExecConfig(**TCFG))
    assert not got.overflow
    got = got.to_numpy()
    want = build(rhf, DATA).collect(
        rhf.ExecConfig(use_pallas="interpret")).to_numpy()
    _assert_same_rows(got, want)
    _assert_same_row_set(got, _oracle(name, DATA))


def test_carry_over_reference_state():
    """A reference DTable's numpy state becomes a port DTable, which then
    feeds a port query and gives the reference's answer."""
    rt = Q["fig8a_filter"](rhf, DATA).collect(rhf.ExecConfig())
    tt = thf.DTable.from_numpy_state(
        {c: np.asarray(v) for c, v in rt.columns.items()},
        np.asarray(rt.counts), rt.capacity, rt.nshards, rt.dist, device="cpu")
    _assert_same_rows(tt.to_numpy(), rt.to_numpy())
    tdf, rdf = thf.table(tt), rhf.table(rt.to_numpy())
    got = thf.aggregate(tdf, "id", s=thf.sum_(tdf["x"]), n=thf.count()) \
        .collect(thf.ExecConfig(**TCFG)).to_numpy()
    want = rhf.aggregate(rdf, "id", s=rhf.sum_(rdf["x"]), n=rhf.count()) \
        .collect(rhf.ExecConfig()).to_numpy()
    _assert_same_rows(got, want)


def test_carry_over_reference_window_state():
    """A reference partitioned window's output, in its grouped layout
    (hash-partitioned on g, sorted by g and t), carried into the port; a
    second partitioned window over the same keys runs on it and gives the
    reference's rows."""
    rt = W["p_cumsum"](rhf, WDATA).collect(rhf.ExecConfig())
    tt = thf.DTable.from_numpy_state(
        {c: np.asarray(v) for c, v in rt.columns.items()},
        np.asarray(rt.counts), rt.capacity, rt.nshards, rt.dist, device="cpu")
    assert tt.dist == rt.dist
    _assert_same_rows(tt.to_numpy(), rt.to_numpy())
    tdf, rdf = thf.table(tt), rhf.table(rt.to_numpy())
    got = tdf.over("g", order_by="t").rolling_mean(tdf["wc"], 3, out="m",
                                                   exact=True) \
        .collect(thf.ExecConfig(**TCFG)).to_numpy()
    want = rdf.over("g", order_by="t").rolling_mean(rdf["wc"], 3, out="m",
                                                    exact=True) \
        .collect(rhf.ExecConfig()).to_numpy()
    _assert_same_rows(got, want)


def test_overflow_retry_heals():
    """Unsafe capacities overflow the join's exchanges; collect() grows the
    overflowed sites and returns the full answer."""
    kw = dict(safe_capacities=False, shuffle_slack=0.05, **TCFG)
    t = Q["fig8a_join"](thf, DATA).collect(thf.ExecConfig(auto_retry=3, **kw))
    assert not t.overflow and t.events, t.events
    _assert_same_row_set(t.to_numpy(), _oracle("fig8a_join", DATA))
    t = Q["fig8a_join"](thf, DATA).collect(thf.ExecConfig(auto_retry=0, **kw))
    assert t.overflow and {r["kind"] for r in t.overflow_ops.values()} \
        == {"exchange"}


# A skewed many-to-many join that both packages truncate (a reference fault,
# logged in ROADMAP.md section 3): every row on key 0, so the join's
# capacity doubles 82 -> 164 -> 328 -> 656 over auto_retry = 3 and stops
# short of the rows the join needs (18 x 37 = 666; 40 x 40 = 1600).  Pinned
# so that the port keeps the reference's answer, flag, attribution and
# retries until both may be fixed together.
@pytest.mark.parametrize("n_left,n_right", [(18, 37), (40, 40)])
def test_skewed_join_truncation_matches_reference(n_left, n_right):
    rng = np.random.default_rng(n_left * n_right)
    left = {"id": np.zeros(n_left, np.int32),
            "x": rng.normal(size=n_left).astype(np.float32)}
    right = {"cid": np.zeros(n_right, np.int32),
             "w": rng.normal(size=n_right).astype(np.float32)}
    tabs = []
    for hf, cfg in ((rhf, rhf.ExecConfig()), (thf, thf.ExecConfig(**TCFG))):
        tabs.append(hf.join(hf.table(left), hf.table(right, "r"),
                            on=("id", "cid")).collect(cfg))
    rt, tt = tabs
    rows = len(tt.to_numpy()["id"])
    assert rows == len(rt.to_numpy()["id"]) < n_left * n_right
    assert tt.overflow and rt.overflow

    def attribution(t):
        return {op: (r["kind"], r["strategy"], r["cap"], r["cap_req"])
                for op, r in t.overflow_ops.items()}
    assert attribution(tt) == attribution(rt)
    assert [r[3] for r in attribution(tt).values()] == [n_left * n_right]
    # the retries: (attempt, op, "kind cap a -> b"), then the give-up
    ref_events = [(e.attempt, e.op_id, e.detail) for e in rt.events
                  if e.kind == "retry"]
    port_events = []
    for e in tt.events[:-1]:
        head, detail = e.split(": ", 1)
        kind, op, rest = detail.split(" ", 2)
        port_events.append((int(head.split()[1]), int(op.lstrip("#")),
                            f"{kind} {rest}"))
    assert port_events == ref_events
    assert [e.kind for e in rt.events][-1] == "overflow_exhausted"
    assert tt.events[-1].startswith(
        f"overflow_exhausted after {rt.events[-1].attempt} retries")


def test_cuda_default_refuses_to_run_without_a_card():
    import torch
    if torch.cuda.is_available():
        assert thf.ExecConfig().device == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            thf.ExecConfig()


RANK_SCRIPT = '''
import json, os, sys
import numpy as np
import torch
import torch.distributed as dist


def main(rank, world, port, out):
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    from repro_torch import hiframes as hf
    calls = [0]
    a2a = dist.all_to_all_single

    def counted(*a, **k):
        calls[0] += 1
        return a2a(*a, **k)
    dist.all_to_all_single = counted
    d, wd, sd = Q["data"](), W["window_data"](), S["sort_data"]()
    fd = F["frame_data"]()
    cfg = hf.ExecConfig(device="cpu")
    ladder = hf.ExecConfig(device="cpu", exscan_method="ladder")
    runs = [(name, build, d, cfg) for name, build in Q["QUERIES"].items()]
    runs += [(name, build, wd, cfg)
             for name, build in W["WINDOW_QUERIES"].items()]
    runs += [(name + "@ladder", W["WINDOW_QUERIES"][name], wd, ladder)
             for name in W["GLOBAL_WINDOWS"]]
    runs += [(name, build, sd, cfg)
             for name, build in S["SORT_QUERIES"].items()]
    runs += [(name, build, fd, cfg)
             for name, build in F["FRAME_QUERIES"].items()]
    res = {}
    for name, build, data, c in runs:
        frame = build(hf, data)
        calls[0] = 0
        t = frame.collect(c)
        res[name] = {"cols": {k: v.tolist() for k, v in t.to_numpy().items()},
                     "dtypes": {k: str(v.dtype) for k, v in t.to_numpy().items()},
                     "all_to_all": calls[0], "overflow": bool(t.overflow),
                     "nshards": t.nshards,
                     "census": frame.physical_plan(c).shuffle_census(P=world)["all_to_all"]}
    res["__direct__"] = direct_checks(rank, world)
    if rank == 0:
        with open(out, "w") as f:
            json.dump(res, f)
    dist.destroy_process_group()


def gather_list(t):
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, t.contiguous())
    return [p.tolist() for p in parts]


def direct_checks(rank, world):
    """The halo exchange with uneven counts, and the global rank kinds with
    tie runs straddling the rank boundary, called on each rank directly."""
    from repro_torch.core import physical as phys
    out = {}
    counts = [5, 7]
    x = torch.arange(8, dtype=torch.float32) + 100 * rank
    left, right = phys.halo_exchange(x, torch.tensor(counts[rank], dtype=torch.int32),
                                     2, 3, world)
    out["halo"] = [gather_list(left), gather_list(right)]
    # sample sort: rank 1 empty (it sends sentinel samples), composite
    # keys descending, both full; the rows' inputs and outputs gathered
    rng = np.random.default_rng(5 + rank)
    cap = 12
    for tag, counts, keys, asc in (("one_key", [9, 0], ("a",), True),
                                   ("two_desc", [3, 12], ("a", "b"), False),
                                   ("two_full", [12, 12], ("b", "a"), True)):
        cols = {"a": torch.tensor(rng.integers(0, 4, cap), dtype=torch.int32),
                "b": torch.tensor(rng.integers(-2, 2, cap), dtype=torch.float32),
                "v": torch.arange(cap, dtype=torch.int32) + 100 * rank}
        cnt = torch.tensor(counts[rank], dtype=torch.int32)
        got, cnt2, ovf = phys.sample_sort(cols, cnt, keys, P=world,
                                          bucket_cap=cap, cap_out=2 * cap,
                                          ascending=asc)
        out["sort_" + tag] = {
            "in": {k: gather_list(v) for k, v in cols.items()},
            "in_counts": counts,
            "out": {k: gather_list(v) for k, v in got.items()},
            "out_counts": gather_list(cnt2.reshape(1)),
            "overflow": bool(ovf)}
    x = torch.arange(12, dtype=torch.int32) + 100 * rank
    got, cnt2, ovf = phys.rebalance(
        {"x": x}, torch.tensor([2, 11][rank], dtype=torch.int32), P=world,
        bucket_cap=12, cap_out=12)
    out["rebalance"] = [gather_list(got["x"]), gather_list(cnt2.reshape(1)),
                        bool(ovf)]
    got, cnt2 = phys.limit({"x": x}, torch.tensor([5, 7][rank], dtype=torch.int32),
                           8, world, cap_out=8)
    out["limit"] = [gather_list(got["x"]), gather_list(cnt2.reshape(1))]
    keys = [[0, 1, 1, 2, 2, 2, 9, 9], [2, 2, 3, 3, 4, 9, 9, 9]][rank]
    cnt = torch.tensor([6, 5][rank], dtype=torch.int32)
    k = torch.tensor(keys, dtype=torch.int32)
    for kind in ("row_number", "rank", "dense_rank"):
        for method in ("allgather", "ladder"):
            r = phys.global_rank((k,), cnt, 8, kind, P=world, method=method)
            out[kind + "@" + method] = gather_list(r)
    return out


if __name__ == "__main__":
    import torch.multiprocessing as mp
    port, out = int(sys.argv[1]), sys.argv[2]
    mp.spawn(main, args=(2, port, out), nprocs=2, join=True)
'''


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_gloo_ranks(tmp_path):
    """P=2 on two gloo ranks: every query's rows equal the oracle's as a
    row set, and each run issues exactly the all_to_all count the plan's
    shuffle census states (two per exchange)."""
    script = tmp_path / "ranks.py"
    script.write_text("Q = {}\nexec(" + repr(QUERY_SRC) + ", Q)\n"
                      + "W = {}\nexec(" + repr(WINDOW_SRC) + ", W)\n"
                      + "S = {}\nexec(" + repr(SORT_SRC) + ", S)\n"
                      + "F = {}\nexec(" + repr(FRAME_SRC) + ", F)\n"
                      + textwrap.dedent(RANK_SCRIPT))
    out = tmp_path / "res.json"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, str(script), str(_free_port()),
                           str(out)], env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    res = json.loads(out.read_text())
    runs = [(name, Q["QUERIES"][name], DATA) for name in NAMES]
    runs += [(name, W["WINDOW_QUERIES"][name.split("@")[0]], WDATA)
             for name in res if name in W["WINDOW_QUERIES"]
             or name.endswith("@ladder")]
    runs += [(name, S["SORT_QUERIES"][name], SDATA)
             for name in S["SORT_QUERIES"]]
    runs += [(name, FQ["FRAME_QUERIES"][name], FDATA)
             for name in FQ["FRAME_QUERIES"]]
    assert len(runs) == len(NAMES) + len(W["WINDOW_QUERIES"]) \
        + len(W["GLOBAL_WINDOWS"]) + len(S["SORT_QUERIES"]) \
        + len(FQ["FRAME_QUERIES"])
    for name, build, data in runs:
        r = res[name]
        assert r["nshards"] == 2 and not r["overflow"], name
        got = {k: np.asarray(v, dtype=r["dtypes"][k])
               for k, v in r["cols"].items()}
        base = name.split("@")[0]
        if data is DATA:
            _assert_same_row_set(got, _oracle(name, DATA))
        elif data is SDATA:
            assert_sort_result(name, got, SDATA)
        elif data is FDATA:
            # each rank encoded the same host table: the dictionaries of
            # the P=1 frame decode the ranks' codes
            for c, dt in build(thf, FDATA).schema.items():
                if tdt.is_category(dt):
                    got[c] = tdt.dict_decode(got[c], tdt.categories_of(dt))
            FQ["assert_frame_result"](name, got, FDATA)
        else:
            assert_same_row_set(got, window_oracle(base, WDATA))
        census = build(rhf, data).physical_plan() \
            .shuffle_census(P=2)["all_to_all"]
        assert r["all_to_all"] == r["census"] == census, (name, r, census)
    # the persisted dimension's Q26 leg issues fewer all_to_all than the
    # cold leg
    assert res["q26_persisted"]["all_to_all"] < res["q26_cold"]["all_to_all"]
    direct = res["__direct__"]
    # rank 0 holds 0..4 valid of 8 rows, rank 1 holds 100..106: the left
    # halo of rank 1 is rank 0's valid tail, the right halo of rank 0 is
    # rank 1's head; zeros at the global borders
    assert direct["halo"] == [[[0.0, 0.0], [3.0, 4.0]],
                              [[100.0, 101.0, 102.0], [0.0, 0.0, 0.0]]]
    keys = np.array([0, 1, 1, 2, 2, 2, 2, 2, 3, 3, 4])      # the valid rows
    want = {"row_number": np.arange(1, 12),
            "rank": np.searchsorted(keys, keys, side="left") + 1,
            "dense_rank": np.unique(keys, return_inverse=True)[1] + 1}
    for kind, w in want.items():
        for method in ("allgather", "ladder"):
            r = direct[kind + "@" + method]
            assert r[0][:6] + r[1][:5] == w.tolist(), (kind, method, r)
            assert r[0][6:] == [0, 0] and r[1][5:] == [0, 0, 0]
    # the sample sort: the ranks' valid outputs, concatenated, are the
    # valid inputs stably sorted (reversed when descending), rows whole
    for tag, keys, asc in (("one_key", ("a",), True),
                           ("two_desc", ("a", "b"), False),
                           ("two_full", ("b", "a"), True)):
        r = direct["sort_" + tag]
        assert not r["overflow"]
        inp = {k: np.concatenate([np.asarray(v[q][:r["in_counts"][q]])
                                  for q in range(2)])
               for k, v in r["in"].items()}
        order = np.lexsort([inp[k] for k in reversed(keys)])
        if not asc:
            order = order[::-1]
        oc = [c[0] for c in r["out_counts"]]
        for k, v in r["out"].items():
            got = np.concatenate([np.asarray(v[q][:oc[q]]) for q in range(2)])
            np.testing.assert_array_equal(got, inp[k][order], err_msg=tag + k)
        if tag == "two_full":     # the splitters split: no rank takes all
            assert min(oc) > 0, oc
    xs, cnts, ovf = direct["rebalance"]
    assert not ovf and [c[0] for c in cnts] == [7, 6]
    assert xs[0][:7] + xs[1][:6] == [0, 1] + list(range(100, 111))
    xs, cnts = direct["limit"]
    assert [c[0] for c in cnts] == [5, 3]
    assert xs[0][:5] + xs[1][:3] == [0, 1, 2, 3, 4, 100, 101, 102]
