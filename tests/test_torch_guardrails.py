"""The execution guardrails in the port, held against the reference on the
CPU: tests/test_faults.py's cases run through both packages on the same
seeded inputs and must give the same typed errors, retry events,
``overflow_ops`` and rows.

The one departure is the kernel fault: the reference steps a failing Pallas
kernel down one rung (compiled -> interpret -> the lax version); the port
has no rung below a kernel, so an injected ``fail_kernel`` raises the typed
KernelBackendError on the CPU's plain versions here and on the card's
kernels (tests/test_torch_cuda.py), and nothing runs the plain version in a
kernel's place.
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")
import torch  # noqa: E402

from oracle import o_aggregate  # noqa: E402
from repro import hiframes as rhf  # noqa: E402
from repro.core import errors as rerr  # noqa: E402
from repro.core import lower as rlower  # noqa: E402
from repro.core import physical as rphys  # noqa: E402
from repro.core import stats as rst  # noqa: E402
from repro.runtime import retry as rrt  # noqa: E402
from repro.runtime.faults import FaultPlan as RFaultPlan  # noqa: E402
from repro_torch import hiframes as thf  # noqa: E402
from repro_torch.core import errors as terr  # noqa: E402
from repro_torch.core import lower as tlower  # noqa: E402
from repro_torch.core import physical as tphys  # noqa: E402
from repro_torch.core import stats as tst  # noqa: E402
from repro_torch.runtime import FaultPlan, RetryEvent  # noqa: E402
from repro_torch.runtime import retry as trt  # noqa: E402

TCFG = dict(device="cpu")


@pytest.fixture(autouse=True)
def _fresh_stores():
    for st, rt in ((rst, rrt), (tst, trt)):
        st.clear_realized()
        rt.clear_events()
    yield
    for st, rt in ((rst, rrt), (tst, trt)):
        st.clear_realized()
        rt.clear_events()


def _frame(n=600, keys=23, seed=11):
    rng = np.random.default_rng(seed)
    return {"k": rng.integers(0, keys, n).astype(np.int32),
            "v": rng.normal(size=n).astype(np.float32)}


def _agg(df):
    return df.groupby("k").agg(s=("v", "sum"), n=("v", "count"))


def _check_agg(out, cols):
    ref = o_aggregate(cols, "k", {"s": ("sum", cols["v"]),
                                  "n": ("count", None)})
    o = np.argsort(out["k"])
    np.testing.assert_array_equal(np.sort(out["k"]), ref["k"])
    np.testing.assert_allclose(out["s"][o], ref["s"], rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(out["n"][o], ref["n"])


def _both(build, fault: dict | None = None, **kw):
    """Collect ``build(hf)`` through both packages under the same config
    (and the same FaultPlan fields); returns (ref table, port table)."""
    out = []
    for hf, FP, base in ((rhf, RFaultPlan, {}), (thf, FaultPlan, TCFG)):
        cfg = hf.ExecConfig(**base, **kw,
                            **({"fault_inject": FP(**fault)} if fault else {}))
        out.append(build(hf).collect(cfg))
    return out


def _events(t):
    return [dataclasses.astuple(e) for e in t.events]


def _overflow_ops(t):
    return {op: {k: (v.tolist() if isinstance(v, np.ndarray) else v)
                 for k, v in r.items()} for op, r in t.overflow_ops.items()}


def _same_rows(rt, tt):
    a, b = rt.to_numpy(), tt.to_numpy()
    assert set(a) == set(b)
    oa = np.lexsort([np.asarray(a[c]) for c in sorted(a)])
    ob = np.lexsort([b[c] for c in sorted(b)])
    for c in a:
        np.testing.assert_allclose(b[c][ob], np.asarray(a[c])[oa],
                                   rtol=1e-5, atol=1e-5, err_msg=c)


# -- taxonomy and config ----------------------------------------------------


def test_error_taxonomy_types_and_fields():
    e = terr.CapacityOverflow(op_id=7, op="HashExchange",
                              observed_est=1400, cap=250, attempts=2)
    assert isinstance(e, RuntimeError) and isinstance(e, terr.HiFramesError)
    assert e.op_id == 7 and e.observed_est == 1400 and e.cap == 250
    assert str(e) == str(rerr.CapacityOverflow(
        op_id=7, op="HashExchange", observed_est=1400, cap=250, attempts=2))
    f = terr.InvariantFailure("checksum", 3, "HashExchange")
    assert f.render() == rerr.InvariantFailure(
        "checksum", 3, "HashExchange").render()
    pe = terr.PlanInvariantError((f,))
    assert isinstance(pe, RuntimeError) and pe.failures == (f,)
    assert "checksum@op#3" in str(pe)
    ke = terr.KernelBackendError("prefix_sum", "cuda", "boom")
    assert isinstance(ke, RuntimeError)
    assert ke.kernel == "prefix_sum" and ke.backend == "cuda"
    assert RetryEvent("retry", 1, 4, "x").render() \
        == rrt.RetryEvent("retry", 1, 4, "x").render()


def test_exec_config_guardrail_fields(monkeypatch):
    cfg = thf.ExecConfig(**TCFG)
    ref = rhf.ExecConfig()
    for f in ("adaptive_stats", "salt_threshold", "salt_factor",
              "stats_sample", "stats_cap_slack", "validate", "fault_inject",
              "retry_scope"):
        assert getattr(cfg, f) == getattr(ref, f), f
    assert not hasattr(cfg, "use_pallas") and not hasattr(cfg,
                                                          "kernel_fallbacks")
    with pytest.raises(ValueError, match="retry_scope"):
        thf.ExecConfig(retry_scope="rank", **TCFG)
    monkeypatch.setenv("HIFRAMES_VALIDATE", "on")
    assert thf.ExecConfig(**TCFG).validate is True
    assert thf.ExecConfig(validate=0, **TCFG).validate is False
    monkeypatch.delenv("HIFRAMES_VALIDATE")
    assert thf.ExecConfig(**TCFG).validate is False
    assert FaultPlan().fail_modes == ("cuda",)


# -- census gate: guardrail levers change zero plans ------------------------


def test_validate_and_fault_inject_change_zero_plans():
    cols = _frame()
    dim = {"k": np.arange(23, dtype=np.int32),
           "w": np.random.default_rng(1).normal(size=23).astype(np.float32)}
    q = _agg(thf.join(thf.table(cols, "t"), thf.table(dim, "d"),
                      on=("k", "k"))).sort_values("s")
    base = q.physical_plan(thf.ExecConfig(**TCFG))
    for kw in (dict(validate=True), dict(fault_inject=FaultPlan()),
               dict(validate=True, fault_inject=FaultPlan())):
        plan = q.physical_plan(thf.ExecConfig(**TCFG, **kw))
        assert plan.counts() == base.counts()
        assert plan.collective_count() == base.collective_count()
        assert plan.shuffle_census(P=8) == base.shuffle_census(P=8)
        assert plan.render() == base.render()


def test_validate_clean_run_no_failures():
    cols = _frame()
    dim = {"k": np.arange(23, dtype=np.int32),
           "w": np.random.default_rng(1).normal(size=23).astype(np.float32)}

    def q(hf):
        return _agg(hf.join(hf.table(cols, "t"), hf.table(dim, "d"),
                            on=("k", "k"))).sort_values("s")
    rt, tt = _both(q, validate=True)
    assert tt.invariant_failures == rt.invariant_failures == ()
    assert not tt.overflow and tt.overflow_ops == {}
    _same_rows(rt, tt)
    plain = q(thf).collect(thf.ExecConfig(**TCFG)).to_numpy()
    got = tt.to_numpy()
    for c in plain:
        np.testing.assert_array_equal(got[c], plain[c])


def test_validate_checks_category_codes_and_sorts():
    """A category root column gets a code-range check and each sort a
    monotonic one: the port's tables are the reference's, and all hold."""
    rng = np.random.default_rng(2)
    cats = np.array(["a", "b", "c", None], dtype=object)

    def q(hf):
        df = hf.table({"c": cats[rng.integers(0, 4, 300)],
                       "x": rng.normal(size=300).astype(np.float32)}, "t")
        return df.sort_values("x")
    metas = []
    for hf, base in ((rhf, {}), (thf, TCFG)):
        rng = np.random.default_rng(2)
        low = q(hf).lower(hf.ExecConfig(validate=True, **base))
        metas.append((low.val_flags_meta, low.val_pairs_meta))
        rng = np.random.default_rng(2)
        t = q(hf).collect(hf.ExecConfig(validate=True, **base))
        assert t.invariant_failures == ()
    assert metas[0] == metas[1]
    assert {m[0] for m in metas[1][0]} == {"monotonic", "code_range"}


# -- forced overflow --------------------------------------------------------


def test_forced_overflow_heals_within_budget():
    cols = _frame()
    rt, tt = _both(lambda hf: _agg(hf.table(cols, "t")),
                   dict(force_overflow=("HashExchange",)),
                   validate=True, auto_retry=3)
    assert not tt.overflow and tt.invariant_failures == ()
    assert _events(tt) == _events(rt)
    assert [e.kind for e in tt.events] == ["retry"]
    _check_agg(tt.to_numpy(), cols)


def test_forced_overflow_attribution_matches_reference():
    cols = _frame()
    rt, tt = _both(lambda hf: _agg(hf.table(cols, "t")),
                   dict(force_overflow=("HashExchange",)), auto_retry=0)
    assert tt.overflow and rt.overflow
    assert _overflow_ops(tt) == _overflow_ops(rt)
    (op_id, rec), = tt.overflow_ops.items()
    assert rec["op"] == "HashExchange" and rec["kind"] == "exchange"
    assert rec["cap_req"] >= 1 and rec["cap"] >= rec["cap_req"]
    assert _events(tt) == _events(rt)
    assert tt.events[-1].kind == "overflow_exhausted"


def test_persist_overflow_raises_typed_capacity_overflow():
    cols = _frame()
    msgs = []
    for hf, FP, base, E in ((rhf, RFaultPlan, {}, rerr.CapacityOverflow),
                            (thf, FaultPlan, TCFG, terr.CapacityOverflow)):
        q = _agg(hf.table(cols, "t"))
        cfg = hf.ExecConfig(auto_retry=1, **base, fault_inject=FP(
            force_overflow=("HashExchange",), overflow_shots=-1))
        with pytest.raises(E, match="persist") as ei:
            q.persist(cfg)
        assert ei.value.op_id >= 0 and ei.value.observed_est >= 1
        assert "HashExchange" in str(ei.value)
        msgs.append((ei.value.op_id, ei.value.op, ei.value.observed_est,
                     ei.value.cap, ei.value.attempts))
    assert msgs[0] == msgs[1]


def test_retry_events_rendered_in_explain():
    cols = _frame()
    texts = []
    for hf, FP, base in ((rhf, RFaultPlan, {}), (thf, FaultPlan, TCFG)):
        q = _agg(hf.table(cols, "t"))
        t = q.collect(hf.ExecConfig(auto_retry=2, **base, fault_inject=FP(
            force_overflow=("HashExchange",))))
        assert not t.overflow and any(e.kind == "retry" for e in t.events)
        txt = q.explain(hf.ExecConfig(**base))
        texts.append(txt[txt.index("\nstats: "):])
    assert "events (previous run):" in texts[1] and "retry" in texts[1]
    assert texts[0] == texts[1]


# -- the kernel fault: a typed raise, never a fallback ----------------------


def test_kernel_fault_raises_typed_error_on_plain():
    cols = _frame()
    df = thf.table(cols, "t")
    q = _agg(df[df["v"] > -0.3])
    cfg = thf.ExecConfig(**TCFG, fault_inject=FaultPlan(
        fail_kernel="prefix_sum", fail_modes=("plain",)))
    with pytest.raises(terr.KernelBackendError, match="prefix_sum") as ei:
        q.collect(cfg)
    assert ei.value.kernel == "prefix_sum" and ei.value.backend == "plain"
    # the default fail_modes name the card's kernels: the CPU run answers
    t = q.collect(thf.ExecConfig(**TCFG, fault_inject=FaultPlan(
        fail_kernel="prefix_sum")))
    keep = cols["v"] > -0.3
    _check_agg(t.to_numpy(), {k: v[keep] for k, v in cols.items()})
    assert t.events == ()


def test_kernel_wrap_types_failures_and_leaves_plain_alone():
    def boom(x):
        raise ValueError("launch refused")
    wrap = tlower._kernel_wrap(None)
    assert wrap("prefix_sum", "plain", boom) is boom
    with pytest.raises(terr.KernelBackendError) as ei:
        wrap("prefix_sum", "cuda", boom)(torch.zeros(3))
    assert ei.value.backend == "cuda" and isinstance(ei.value.cause,
                                                     ValueError)
    ok = wrap("prefix_sum", "cuda", lambda x: x + 1)
    assert int(ok(torch.ones(1))[0]) == 2
    # the policy has no rung below a kernel: the typed error reaches the
    # caller on the first attempt, and nothing runs again
    runs = []

    def run_once(cfg):
        runs.append(cfg)
        raise ei.value
    with pytest.raises(terr.KernelBackendError) as again:
        trt.RetryPolicy(max_retries=3).execute(run_once, "cfg")
    assert again.value is ei.value and runs == ["cfg"]


# -- packed-exchange corruption ---------------------------------------------


def _corrupt_cols():
    rng = np.random.default_rng(3)
    return {"k": rng.integers(0, 17, 500).astype(np.int32),
            "v": rng.normal(size=500).astype(np.float32)}


def test_corrupt_packed_exchange_degrades_to_unpacked():
    cols = _corrupt_cols()

    def q(hf):
        return hf.table(cols, "t").groupby("k").agg(s=("v", "sum"))
    rt, tt = _both(q, dict(corrupt_exchange=("HashExchange",),
                           corrupt_packed_only=True), validate=True)
    assert [e.kind for e in tt.events] == ["degrade_packed"]
    assert _events(tt) == _events(rt)
    assert tt.invariant_failures == ()
    _same_rows(rt, tt)


def test_unhealable_corruption_raises_plan_invariant_error():
    cols = _frame()
    fails = []
    for hf, FP, base, E in ((rhf, RFaultPlan, {}, rerr.PlanInvariantError),
                            (thf, FaultPlan, TCFG, terr.PlanInvariantError)):
        cfg = hf.ExecConfig(validate=True, packed_exchange=False, **base,
                            fault_inject=FP(corrupt_exchange=("HashExchange",),
                                            corrupt_packed_only=False))
        with pytest.raises(E, match="checksum") as ei:
            _agg(hf.table(cols, "t")).collect(cfg)
        fails.append([tuple(f) for f in ei.value.failures])
    assert fails[0] == fails[1]


def test_corruption_without_validate_goes_undetected():
    cols = _frame()
    rt, tt = _both(lambda hf: _agg(hf.table(cols, "t")),
                   dict(corrupt_exchange=("HashExchange",),
                        corrupt_packed_only=False),
                   validate=False, packed_exchange=False)
    assert tt.invariant_failures == () and tt.events == ()
    _same_rows(rt, tt)            # the same wrong answer


# -- stats poisoning --------------------------------------------------------


def test_poison_stats_raise_degrades_to_static_planning():
    cols = _frame()
    rt, tt = _both(lambda hf: _agg(hf.table(cols, "t")),
                   dict(poison_stats="raise"), adaptive_stats=True)
    assert not tt.overflow
    assert [e.kind for e in tt.events] == ["degrade_stats"]
    assert "static" in tt.events[0].detail
    assert _events(tt) == _events(rt)
    _check_agg(tt.to_numpy(), cols)


def test_poison_stats_ndv_healed_by_per_op_retry():
    cols = _frame(n=2000, keys=500)
    rt, tt = _both(lambda hf: _agg(hf.table(cols, "t")),
                   dict(poison_stats="ndv"), adaptive_stats=True,
                   safe_capacities=False, auto_retry=2)
    assert not tt.overflow
    assert any(e.kind == "retry" for e in tt.events), tt.events
    assert _events(tt) == _events(rt)
    _check_agg(tt.to_numpy(), cols)


def test_overflow_failure_feeds_realized_store():
    cols = _frame(n=2000, keys=500)
    res = []
    for hf, FP, base, st in ((rhf, RFaultPlan, {}, rst),
                             (thf, FaultPlan, TCFG, tst)):
        q = _agg(hf.table(cols, "t"))
        t1 = q.collect(hf.ExecConfig(
            adaptive_stats=True, safe_capacities=False, auto_retry=0, **base,
            fault_inject=FP(poison_stats="ndv")))
        assert t1.overflow and any(
            rec["kind"] == "partial_agg" for rec in t1.overflow_ops.values())
        t2 = q.collect(hf.ExecConfig(adaptive_stats=True, **base,
                                     safe_capacities=False, auto_retry=0))
        assert not t2.overflow
        res.append((_overflow_ops(t1), sorted(st.current_store()
                                              .realized.values(),
                                              key=repr)))
    assert res[0] == res[1]


# -- the helpers, bit for bit -----------------------------------------------


def _salt_inputs(seed=5, cap=64):
    rng = np.random.default_rng(seed)
    return {"a": rng.integers(0, 6, cap).astype(np.int32),
            "b": rng.integers(0, 3, cap).astype(np.int32),
            "x": rng.normal(size=cap).astype(np.float32)}


@pytest.mark.parametrize("count", [0, 37, 64])
@pytest.mark.parametrize("hot", [(), ((2, 1),), ((2, 1), (4, 0), (5, 2))])
def test_salting_helpers_match_reference(count, hot):
    import jax.numpy as jnp
    cols = _salt_inputs()
    keys, R, cap_out = ("a", "b"), 4, 128
    jc = {k: jnp.asarray(v) for k, v in cols.items()}
    tc = {k: torch.from_numpy(v) for k, v in cols.items()}
    jn, tn = jnp.int32(count), torch.tensor(count, dtype=torch.int32)
    np.testing.assert_array_equal(
        tphys.hot_mask(tc, keys, hot).numpy(),
        np.asarray(rphys.hot_mask(jc, keys, hot)))
    (ro, _), (to, _) = (rphys.salt_probe(jc, jn, keys, hot, R),
                        tphys.salt_probe(tc, tn, keys, hot, R))
    for c in ro:
        np.testing.assert_array_equal(to[c].numpy(), np.asarray(ro[c]))
    ro, rcnt, rovf = rphys.salt_build(jc, jn, keys, hot, R, cap_out)
    to, tcnt, tovf = tphys.salt_build(tc, tn, keys, hot, R, cap_out)
    assert int(tcnt) == int(rcnt) and bool(tovf) == bool(rovf)
    for c in ro:
        np.testing.assert_array_equal(to[c].numpy()[:int(tcnt)],
                                      np.asarray(ro[c])[:int(rcnt)])
    # a short buffer overflows alike
    ro, rcnt, rovf = rphys.salt_build(jc, jn, keys, hot, R, 16)
    to, tcnt, tovf = tphys.salt_build(tc, tn, keys, hot, R, 16)
    assert (int(tcnt), bool(tovf)) == (int(rcnt), bool(rovf))


@pytest.mark.parametrize("count", [0, 5, 300])
def test_checksum_u32_matches_reference_past_2_32(count):
    """Words near 2^32 - 1 make the sum wrap several times."""
    import jax.numpy as jnp
    rng = np.random.default_rng(count)
    cols = {"big": np.full(300, -3, np.int32),          # 0xFFFFFFFD
            "x": rng.normal(size=300).astype(np.float32),
            "flag": rng.random(300) < 0.5,
            "h": rng.normal(size=300).astype(np.float16)}
    want = int(np.asarray(rlower._checksum_u32(
        {k: jnp.asarray(v) for k, v in cols.items()}, jnp.int32(count))))
    got = int(tlower._checksum_u32({k: torch.from_numpy(v)
                                    for k, v in cols.items()},
                                   torch.tensor(count, dtype=torch.int32)))
    assert got == want
    if count == 300:
        assert 300 * 0xFFFFFFFD > 2**32 * 200          # it wrapped


@pytest.mark.parametrize("ascending", [True, False])
@pytest.mark.parametrize("count", [0, 1, 6, 9])
def test_mono_violation_matches_reference(ascending, count):
    import jax.numpy as jnp
    for vals in ([1, 2, 2, 5, 7, 9, 0, 0, 0], [3, 2, 1, 1, 0, -1, 5, 6, 7],
                 [1.0, np.nan, 3.0, 2.0, 4.0, 5.0, 6.0, 7.0, 8.0]):
        a = np.asarray(vals, np.float32 if isinstance(vals[1], float)
                       else np.int32)
        want = bool(rlower._mono_violation(jnp.asarray(a), jnp.int32(count),
                                           ascending=ascending))
        got = bool(tlower._mono_violation(
            torch.from_numpy(a), torch.tensor(count, dtype=torch.int32),
            ascending=ascending))
        assert got == want, (vals, count, ascending)


# -- eight ranks: the skew figures against the reference's eight shards -----

# Written once against either package's ``hf``: tests/test_skew.py's
# salted-occupancy join and tests/test_faults.py's _SKEW_BEATS_GLOBAL
# (per-op against global retries on a skewed join).
EIGHT_SRC = '''
import numpy as np


def _counts(t):
    return [int(c) for c in t.counts]


def _rows(t):
    return {k: np.asarray(v).tolist() for k, v in t.to_numpy().items()}


def eight(hf, base):
    out = {}
    rng = np.random.default_rng(7)
    n, m = 4000, 90
    k = rng.integers(0, m, n).astype(np.int32)
    k[: int(0.35 * n)] = 3
    rng.shuffle(k)
    probe = {"k": k, "v": rng.normal(size=n).astype(np.float32)}
    dim = {"k": np.arange(m, dtype=np.int32),
           "w": rng.normal(size=m).astype(np.float32)}
    j = hf.table(probe, "probe").merge(hf.table(dim, "dim"), on="k")
    salted = j.collect(hf.ExecConfig(adaptive_stats=True, **base))
    plain = j.collect(hf.ExecConfig(**base))
    out["salted"] = {"counts": _counts(salted), "rows": _rows(salted),
                     "overflow": bool(salted.overflow)}
    out["base"] = {"counts": _counts(plain), "overflow": bool(plain.overflow)}

    # _SKEW_BEATS_GLOBAL's keys as int32: the port narrows an int64 host
    # column at ingest, where the reference keeps int64 in its schema (and
    # so in buffer_bytes) though its arrays hold int32 (ROADMAP section 3)
    rng = np.random.default_rng(7)
    n = 4000
    k = np.where(rng.random(n) < 0.35, 0,
                 rng.integers(1, 400, n)).astype(np.int32)
    probe = {"k": k, "v": rng.normal(size=n).astype(np.float32)}
    dim = {"k": np.arange(400).astype(np.int32),
           "w": rng.normal(size=400).astype(np.float32)}
    q = hf.join(hf.table(probe, "t"), hf.table(dim, "d"), on=("k", "k"))
    for scope in ("op", "global"):
        cfg = hf.ExecConfig(safe_capacities=False, shuffle_slack=1.0,
                            join_expansion=1.0, auto_retry=6,
                            retry_scope=scope, broadcast_join=False, **base)
        lowered, t = q._execute(cfg)
        out[scope] = {
            "overflow": bool(t.overflow),
            "retries": len({e.attempt for e in t.events
                            if e.kind in ("retry", "retry_global")}),
            "bytes": int(lowered.pplan.buffer_bytes()),
            "events": [[e.kind, e.attempt, e.op_id, e.detail]
                       for e in t.events],
            "rows": len(t.to_numpy()["k"]), "counts": _counts(t)}
    return out
'''

EIGHT_RANKS = '''
import json, sys
import torch.distributed as dist


def main(rank, world, port, path):
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    from repro_torch import hiframes as hf
    out = E["eight"](hf, {"device": "cpu"})
    if rank == 0:
        with open(path, "w") as f:
            json.dump(out, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    import torch.multiprocessing as mp
    mp.spawn(main, args=(8, int(sys.argv[1]), sys.argv[2]), nprocs=8,
             join=True)
'''


def test_eight_gloo_ranks_match_reference_shards(tmp_path):
    """P = 8 on eight gloo ranks against the reference's eight shards on the
    same data: the salted and unsalted join's per-rank counts equal the
    reference's per-shard counts and the salted rows its rows, salting
    drops the occupancy as tests/test_skew.py requires, and the per-op and
    global retries give the reference's events, retry counts and buffer
    bytes (per-op strictly fewer of both, tests/test_faults.py)."""
    import json
    import os
    import socket
    import subprocess
    import sys

    from test_physical_plan import run_sharded

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = tmp_path / "eight.py"
    script.write_text("E = {}\nexec(" + repr(EIGHT_SRC) + ", E)\n"
                      + EIGHT_RANKS)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    res = tmp_path / "eight.json"
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"),
               OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, str(script), str(port), str(res)],
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    got = json.loads(res.read_text())
    out = run_sharded(EIGHT_SRC + "\nimport json\nprint('EIGHT '"
                      " + json.dumps(eight(hf, {})))\n", 8)
    want = json.loads(out.split("EIGHT ", 1)[1].splitlines()[0])

    for tag in ("salted", "base"):
        assert not got[tag]["overflow"]
        assert got[tag]["counts"] == want[tag]["counts"], tag
    cs = np.asarray(got["salted"]["counts"], dtype=np.float64)
    cb = np.asarray(got["base"]["counts"], dtype=np.float64)
    assert cs.sum() == cb.sum() == 4000
    r_salted, r_base = cs.max() / cs.mean(), cb.max() / cb.mean()
    assert r_base > 2.0, (r_base, cb)
    assert r_salted < 0.6 * r_base, (r_salted, r_base)
    assert cs.max() < 0.75 * cb.max(), (cs, cb)
    g, w = got["salted"]["rows"], want["salted"]["rows"]
    assert set(g) == set(w)
    og = np.lexsort([np.asarray(g[c]) for c in sorted(g)])
    ow = np.lexsort([np.asarray(w[c]) for c in sorted(w)])
    for c in w:
        np.testing.assert_array_equal(np.asarray(g[c])[og],
                                      np.asarray(w[c], np.asarray(g[c]).dtype)
                                      [ow], err_msg=c)

    for scope in ("op", "global"):
        assert not got[scope]["overflow"] and got[scope]["rows"] == 4000
        assert got[scope] == want[scope], scope
    assert 1 <= got["op"]["retries"] < got["global"]["retries"]
    assert got["op"]["bytes"] < got["global"]["bytes"]


ONE_RANK_EXPLAIN = '''
import json, sys
from datetime import timedelta

import numpy as np
import torch.distributed as dist


def main(rank, world, port, path):
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank,
                            timeout=timedelta(seconds=60))
    from repro_torch import hiframes as hf
    rng = np.random.default_rng(5)
    n = 2000
    k = np.where(rng.random(n) < 0.35, 3,
                 rng.integers(0, 50, n)).astype(np.int32)
    data = {"k": k, "v": rng.normal(size=n).astype(np.float32)}
    cfg = hf.ExecConfig(device="cpu")
    p = hf.table(data, "t").repartition(by="v").persist(cfg)
    q = p.groupby("k").agg(s=("v", "sum"), n=("v", "count"))
    out = {}
    if rank == 0:                   # one rank alone: a local planning pass
        out["explain"] = q.explain(cfg)
        out["plan"] = q.physical_plan(cfg).render()
    t = q.collect(cfg).to_numpy()
    out["rows"] = {c: np.asarray(v).tolist() for c, v in t.items()}
    # adaptive planning on a rank-local shard samples through one
    # all_gather, so every rank calls it and every rank plans the same
    out["adaptive"] = q.explain(hf.ExecConfig(device="cpu",
                                              adaptive_stats=True))
    with open(f"{path}.{rank}", "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    import torch.multiprocessing as mp
    mp.spawn(main, args=(2, int(sys.argv[1]), sys.argv[2]), nprocs=2,
             join=True)
'''


def test_explain_on_one_rank_of_a_persisted_frame(tmp_path):
    """Without adaptive_stats, explain() and physical_plan() on a frame
    persisted at P = 2 are local to the rank: rank 0 calls them alone and
    the next collect() on both ranks still answers exactly.  Under
    adaptive_stats every rank samples the shards through one all_gather
    and renders the same plan."""
    import json
    import os
    import socket
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = tmp_path / "one_rank.py"
    script.write_text(ONE_RANK_EXPLAIN)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    res = tmp_path / "one_rank.json"
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"),
               OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, str(script), str(port), str(res)],
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    got = [json.loads((tmp_path / f"one_rank.json.{r}").read_text())
           for r in range(2)]
    assert "HashExchange" in got[0]["explain"]
    assert got[0]["plan"] in got[0]["explain"]
    assert "explain" not in got[1]
    assert got[0]["adaptive"] == got[1]["adaptive"]

    rng = np.random.default_rng(5)
    n = 2000
    k = np.where(rng.random(n) < 0.35, 3,
                 rng.integers(0, 50, n)).astype(np.int32)
    v = rng.normal(size=n).astype(np.float32)
    for g in got:
        rows = g["rows"]
        o = np.argsort(rows["k"])
        keys, cnt = np.unique(k, return_counts=True)
        np.testing.assert_array_equal(np.asarray(rows["k"])[o], keys)
        np.testing.assert_array_equal(np.asarray(rows["n"])[o], cnt)
        np.testing.assert_allclose(
            np.asarray(rows["s"])[o],
            [v[k == key].astype(np.float64).sum() for key in keys],
            rtol=1e-4, atol=1e-4)
