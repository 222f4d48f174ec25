"""Serving entry point: a long-lived data-frame session on one card.

Boots a :class:`~repro_torch.runtime.session.Session`, registers the
synthetic TPCx-BB tables with serving layouts (store_sales hash-partitioned
on the join key, item replicated), and replays a Q26-shaped query mix
through the session's plan cache.  Two modes:

  * default — one pass over the mix, then print session stats (plan-cache
    hit rate, Lowered plans built, collectives, per-query timings);
  * ``--smoke`` — the serving contract (docs/serving.md): replay the mix
    TWICE and assert that every second-pass query HITS the plan cache,
    that the second pass builds no ``Lowered`` plan (0 re-plans, 0
    re-lowers), and that it issues strictly fewer collectives than the
    first pass with registration.  Prints ``serve smoke: PASS`` or exits
    nonzero.

On the card (the default) or on the CPU:

    PYTHONPATH=src python -m repro_torch.launch.serve --smoke
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu
"""
from __future__ import annotations

import argparse
import sys
import tempfile

from repro_torch import hiframes as hf
from repro_torch.core.api import DataFrame, ExecConfig
from repro_torch.core.lower import Lowered
from repro_torch.data import synth
from repro_torch.runtime.session import Session


def build_mix(sess: Session, sales: str = "store_sales") -> list:
    """The replayed query mix over the registered ``sales`` table and
    item: Q26 (join + aggregate + filter), a grouped top-up aggregate, and
    a global leaderboard rank — three distinct plan shapes exercising join,
    aggregation, and the global-window path."""
    ss, it = sess.table(sales), sess.table("item")

    def q26() -> DataFrame:
        j = ss.merge(it, on=("ss_item_sk", "i_item_sk"))
        c_i = (j.groupby("ss_customer_sk")
               .agg(c_i_count="count",
                    id1=hf.sum_(j["i_class_id"] == 1),
                    id2=hf.sum_(j["i_class_id"] == 2)))
        return c_i[c_i["c_i_count"] > 4]

    def per_item() -> DataFrame:
        return ss.groupby("ss_item_sk").agg(paid=("ss_net_paid", "sum"),
                                            n=("ss_net_paid", "count"))

    def leaderboard() -> DataFrame:
        per = ss.groupby("ss_customer_sk").agg(spend=("ss_net_paid", "sum"))
        return hf.rank(per, [], ["spend"], out="r", ascending=False)

    return [q26, per_item, leaderboard]


def sizes(scale: float) -> tuple[int, int, int]:
    """(store_sales rows, items, customers) at ``scale``."""
    return (max(int(200_000 * scale), 2_000), max(int(2_000 * scale), 64),
            max(int(10_000 * scale), 128))


def make_tables(scale: float, seed: int = 0) -> tuple[dict, dict]:
    """The synthetic store_sales (from ``seed``) and item tables."""
    n_sales, n_items, n_cust = sizes(scale)
    return (synth.store_sales(n_sales, n_items, n_cust, seed=seed),
            synth.item(n_items, seed=seed + 1))


def register_tables(sess: Session, scale: float, seed: int = 0, *,
                    name: str = "store_sales", tables=None) -> tuple:
    """Register ``name`` (store_sales, hash-partitioned on ss_item_sk) and
    the replicated item table, made by :func:`make_tables` or given as
    ``tables`` (an item of None registers store_sales alone).  Returns the
    numpy tables."""
    ss, it = tables or make_tables(scale, seed)
    sess.register(name, hf.table(ss, name), partition_by="ss_item_sk")
    if it is not None:
        sess.register("item", hf.table(it, "item").replicate())
    return ss, it


def run_pass(sess: Session, mix, repeats: int = 2) -> dict:
    """Submit the whole mix (each query ``repeats`` times) through the
    session's concurrent admission and collect per-pass totals."""
    built = Lowered.built
    futures = [sess.submit(q()) for _ in range(repeats) for q in mix]
    tables = [f.result() for f in futures]
    recs = [t.query_record for t in tables]
    return {"queries": len(recs),
            "hits": sum(r.cache == "hit" for r in recs),
            "compiles": sum(r.compiles for r in recs),
            "built": Lowered.built - built,
            "collectives": sum(r.collectives for r in recs),
            "plan_s": sum(r.plan_s for r in recs),
            "exec_s": sum(r.exec_s for r in recs),
            "records": recs, "tables": tables}


def smoke_failures(p1: dict, p2: dict, p1_total_coll: int) -> list[str]:
    """The serving contract's violations (empty when it holds)."""
    out = []
    if p2["hits"] != p2["queries"]:
        out.append(f"pass-2 hit rate {p2['hits']}/{p2['queries']} != 100%")
    if p2["compiles"] != 0 or p2["built"] != 0:
        out.append(f"pass-2 built {p2['built']} Lowered plans "
                   f"({p2['compiles']} by its queries; expected 0)")
    if not p2["collectives"] < p1_total_coll:
        out.append(f"pass-2 collectives {p2['collectives']} not strictly "
                   f"fewer than pass-1 total {p1_total_coll}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=float, default=0.05,
                    help="synthetic data scale factor")
    ap.add_argument("--repeats", type=int, default=2,
                    help="times each mix query runs per pass")
    ap.add_argument("--session-dir", default=None,
                    help="stats sidecar directory (default: temp dir)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the plans run (default: the card)")
    ap.add_argument("--smoke", action="store_true",
                    help="two passes; assert pass-2 hit rate 100%%, no "
                         "Lowered built, strictly fewer collectives")
    args = ap.parse_args(argv)

    cfg = ExecConfig(device=args.device)
    with tempfile.TemporaryDirectory(prefix="hf-serve-") as tmp, \
            Session(cfg, session_dir=args.session_dir or tmp) as sess:
        register_tables(sess, args.scale)
        mix = build_mix(sess)
        p1 = run_pass(sess, mix, args.repeats)
        p1_total_coll = p1["collectives"] + sess.stats()[
            "register_collectives"]
        print(f"pass 1: {p1['queries']} queries, {p1['hits']} cache hits, "
              f"{p1['built']} Lowered built, "
              f"{p1_total_coll} collectives (incl. registration), "
              f"plan {p1['plan_s']*1e3:.0f} ms exec {p1['exec_s']*1e3:.0f} ms")
        if not args.smoke:
            pc = sess.stats()["plan_cache"]
            print(f"plan cache: {pc['hits']} hits / {pc['misses']} misses, "
                  f"{pc['size']}/{pc['capacity']} entries")
            return 0
        p2 = run_pass(sess, mix, args.repeats)
        print(f"pass 2: {p2['queries']} queries, {p2['hits']} cache hits, "
              f"{p2['built']} Lowered built, {p2['collectives']} "
              f"collectives, plan {p2['plan_s']*1e3:.0f} ms "
              f"exec {p2['exec_s']*1e3:.0f} ms")
        fails = smoke_failures(p1, p2, p1_total_coll)
        for f in fails:
            print("SMOKE FAIL:", f)
        print("serve smoke:", "FAIL" if fails else "PASS")
        return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
