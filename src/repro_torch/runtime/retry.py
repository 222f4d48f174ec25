"""Capacity-overflow retry and graceful-degradation policy.

One :class:`RetryPolicy` drives every re-execution decision of
``DataFrame.collect()`` / ``persist()`` / ``collect_matrix()``, and its
slack-doubling loop (``run_slack``) that of ``ft.run_with_overflow_retry``:

  * **Per-op escalation** (scope="op", the default): a failed run's
    ``DTable.overflow_ops`` attribution (core/lower.py capacity sites) maps
    each overflowed physical-plan op to its observed requirement.  Sites
    with an "abs" strategy report a true upper bound, so one retry at that
    size heals; "double" sites (join and salt expansion) escalate
    geometrically.  The escalation lands as ``ExecConfig.cap_overrides``
    floors: only the overflowed op grows, which is fewer retries and
    smaller buffers than global slack-doubling on skewed data.
  * **Global escalation** (scope="global"): double the four capacity knobs
    (join_expansion, shuffle_slack, stats_cap_slack, agg_group_cap) and
    replan.
  * **Degradation**: a packed-exchange checksum/rowcount invariant failure
    falls back to the unpacked per-column exchange; a stats failure already
    degraded adaptive -> static inside ``lower()`` and surfaces here as an
    event.  A kernel has no lower rung: a :class:`KernelBackendError` (a
    CUDA kernel that failed to build or launch, or an injected fault)
    reaches the caller, and nothing runs the plain version in its place.
  * **Structured event log**: every retry and degradation step is a
    :class:`RetryEvent`, returned on the DTable (``.events``) and recorded
    per plan fingerprint so ``explain()`` can render what the last
    execution of the same plan did.

Invariant failures no step can heal (monotonicity, category code range, or
a checksum mismatch already on the unpacked path) raise a typed
:class:`~repro_torch.core.errors.PlanInvariantError`: corruption is never
silent.
"""
from __future__ import annotations

import dataclasses as _dc
from dataclasses import dataclass

from ..core import errors as err


@dataclass(frozen=True)
class RetryEvent:
    """One structured entry in the retry/degradation log.

    kind: "retry" (per-op escalation) | "retry_global" (slack doubling) |
    "degrade_packed" | "degrade_stats" | "overflow_exhausted".
    """

    kind: str
    attempt: int = 0
    op_id: int = -1
    detail: str = ""

    def render(self) -> str:
        op = f" op#{self.op_id}" if self.op_id >= 0 else ""
        return f"[attempt {self.attempt}] {self.kind}{op}: {self.detail}"


# -- per-fingerprint event store (explain() renders the last run's events) ----
# The dict lives on core.stats.StatsStore beside the realized counts, so
# one sidecar persists both.


def _strip_rebalance(root):
    from ..core import ir
    while isinstance(root, ir.Rebalance):
        root = root.child
    return root


def record_events(root, events) -> None:
    """Remember a run's retry/degradation events under the plan fingerprint
    (the realized-stats store's keying: structural, id-free)."""
    if not events:
        return
    from ..core.stats import current_store, plan_fingerprint
    current_store().events[
        plan_fingerprint(_strip_rebalance(root))] = tuple(events)


def events_for(root) -> tuple:
    from ..core.stats import current_store, plan_fingerprint
    return current_store().events.get(
        plan_fingerprint(_strip_rebalance(root)), ())


def clear_events() -> None:
    from ..core.stats import current_store
    current_store().events.clear()


# -- the policy ---------------------------------------------------------------

_PAIR_KINDS = frozenset({"checksum", "rowcount"})


@dataclass
class RetryPolicy:
    """Bounded re-execution: at most ``max_retries`` capacity retries, plus
    degradation steps (each taken at most once, so the loop terminates)."""

    max_retries: int = 3
    scope: str = "op"               # "op" | "global"

    # -- full engine loop (collect/persist) ---------------------------------

    def execute(self, run_once, cfg):
        """Run ``run_once(cfg) -> (lowered, table)`` under the policy.

        Returns ``(lowered, table, events, cfg)``; the table may still be
        overflow-flagged after exhaustion (collect() hands it back for
        inspection; persist() raises CapacityOverflow from it).  Raises
        PlanInvariantError / KernelBackendError when no step heals.
        """
        events: list[RetryEvent] = []
        attempt = 0
        while True:
            lowered, t = run_once(cfg)
            for ev in getattr(lowered, "events", ()):
                e = RetryEvent(kind=ev.get("kind", "event"), attempt=attempt,
                               detail=ev.get("detail", ""))
                if e not in events:     # lower() re-emits per build
                    events.append(e)
            fails = tuple(getattr(t, "invariant_failures", ()) or ())
            if fails:
                cfg2 = self._degrade_packed(cfg, fails, events, attempt)
                if cfg2 is None:
                    raise err.PlanInvariantError(fails)
                cfg = cfg2
                continue
            if not getattr(t, "overflow", False):
                t.events = tuple(events)
                return lowered, t, tuple(events), cfg
            if attempt >= self.max_retries:
                events.append(RetryEvent(
                    "overflow_exhausted", attempt,
                    detail=f"{len(t.overflow_ops or {})} op(s) still over "
                           f"capacity after {attempt} retries"))
                t.events = tuple(events)
                return lowered, t, tuple(events), cfg
            cfg = self._escalate(cfg, lowered, t, events, attempt)
            attempt += 1

    # -- ft.run_with_overflow_retry's loop ----------------------------------

    def run_slack(self, build_and_run, base_slack: float = 2.0):
        """The slack-doubling loop: ``build_and_run(slack)`` returns a
        DTable; an overflow doubles the slack.  Returns (table, attempts);
        raises :class:`CapacityOverflow` once ``max_retries`` retries still
        overflow."""
        slack = base_slack
        last = base_slack
        for attempt in range(self.max_retries + 1):
            table = build_and_run(slack)
            if not getattr(table, "overflow", False):
                return table, attempt
            last = slack
            slack *= 2.0
        raise err.CapacityOverflow(
            attempts=self.max_retries + 1,
            message=(f"shuffle capacity overflow persisted after "
                     f"{self.max_retries} retries (last slack attempted "
                     f"{last}) — data skew exceeds plan bounds (cf. paper "
                     "Q05 skew discussion)"))

    # -- escalation ----------------------------------------------------------

    def _escalate(self, cfg, lowered, t, events, attempt):
        ops = dict(getattr(t, "overflow_ops", None) or {})
        if self.scope == "op" and ops:
            overrides = dict(getattr(cfg, "cap_overrides", None) or {})
            for op_id, rec in sorted(ops.items()):
                op = lowered.pplan.ops[op_id]
                bucket = int(op.bucket or 0)
                if rec["strategy"] == "double":
                    new_cap = max(int(op.cap), 1) * 2
                    new_bucket = bucket * 2
                else:                   # "abs": observed requirement heals
                    new_cap = max(int(rec["cap_req"]), 1)
                    new_bucket = int(rec["bucket_req"]) if bucket else 0
                prev = overrides.get(op_id, (0, 0))
                overrides[op_id] = (max(new_cap, prev[0]),
                                    max(new_bucket, prev[1]))
                events.append(RetryEvent(
                    "retry", attempt + 1, op_id,
                    f"{rec['kind']} cap {rec['cap']} -> "
                    f"{overrides[op_id][0]}"
                    + (f", bucket {rec['bucket']} -> {overrides[op_id][1]}"
                       if bucket else "")))
            return _dc.replace(cfg, cap_overrides=overrides)
        events.append(RetryEvent(
            "retry_global", attempt + 1,
            detail=f"slack x2: join_expansion -> "
                   f"{max(cfg.join_expansion, 1.0) * 2}, shuffle_slack -> "
                   f"{cfg.shuffle_slack * 2}"))
        return _dc.replace(
            cfg,
            join_expansion=max(cfg.join_expansion, 1.0) * 2,
            shuffle_slack=cfg.shuffle_slack * 2,
            stats_cap_slack=cfg.stats_cap_slack * 2,
            agg_group_cap=(max(1, cfg.agg_group_cap) * 2
                           if cfg.agg_group_cap is not None else None))

    # -- degradation ---------------------------------------------------------

    def _degrade_packed(self, cfg, fails, events, attempt):
        """Packed-exchange payload fault -> unpacked per-column exchange.
        Only pair-check failures are healable this way, and only once."""
        if not getattr(cfg, "packed_exchange", True):
            return None
        if not all(f.kind in _PAIR_KINDS for f in fails):
            return None
        events.append(RetryEvent(
            "degrade_packed", attempt, fails[0].op_id,
            "packed -> unpacked exchange after "
            + "; ".join(f.render() for f in fails)))
        return _dc.replace(cfg, packed_exchange=False)
