"""End-to-end parity of the relational main path.

At P=1 every query runs three ways on the same numpy inputs: the port on
the CPU, the reference with its Pallas kernels in interpret mode, and the
python-loop oracles of tests/oracle.py.  Port and reference must agree row
for row and column by column (exact for ints and bools, floats within
rtol=1e-4, atol=1e-3); the oracle is compared as a row set.  The carry-over
test moves a reference DTable's state into the port and queries it.  One
test spawns two gloo ranks and runs the same queries at P=2.
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
    d = Q["data"]()
    cfg = hf.ExecConfig(device="cpu")
    res = {}
    for name, build in Q["QUERIES"].items():
        frame = build(hf, d)
        calls[0] = 0
        t = frame.collect(cfg)
        res[name] = {"cols": {k: v.tolist() for k, v in t.to_numpy().items()},
                     "dtypes": {k: str(v.dtype) for k, v in t.to_numpy().items()},
                     "all_to_all": calls[0], "overflow": bool(t.overflow),
                     "nshards": t.nshards,
                     "census": frame.physical_plan(cfg).shuffle_census(P=world)["all_to_all"]}
    if rank == 0:
        with open(out, "w") as f:
            json.dump(res, f)
    dist.destroy_process_group()


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
                      + textwrap.dedent(RANK_SCRIPT))
    out = tmp_path / "res.json"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, str(script), str(_free_port()),
                           str(out)], env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    res = json.loads(out.read_text())
    for name in NAMES:
        r = res[name]
        assert r["nshards"] == 2 and not r["overflow"], name
        got = {k: np.asarray(v, dtype=r["dtypes"][k])
               for k, v in r["cols"].items()}
        _assert_same_row_set(got, _oracle(name, DATA))
        census = Q["QUERIES"][name](rhf, DATA).physical_plan() \
            .shuffle_census(P=2)["all_to_all"]
        assert r["all_to_all"] == r["census"] == census, (name, r, census)
