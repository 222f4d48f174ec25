"""Deterministic fault injection for the execution guardrails.

A :class:`FaultPlan` on ``ExecConfig.fault_inject`` arms injection points in
well-defined places, so tests can prove the failure handling works instead
of waiting for real skew or kernel faults:

  * ``force_overflow``: force the overflow flag of matching capacity sites
    (by physical-plan op id or op class name, e.g. ``"HashExchange"``).
    ``overflow_shots`` bounds how many plan builds are affected, so the
    retry loop heals once the shots are spent: the data is never touched,
    only the flag, which drives the attribution and escalation a real
    overflow takes.
  * ``fail_kernel``: raise :class:`~repro_torch.core.errors.KernelBackendError`
    when the named kernel runs on one of ``fail_modes`` (``"cuda"``: the
    hand-written kernel on the card; ``"plain"``: the PyTorch version on
    the CPU).  A kernel has no lower rung here, so the typed error reaches
    the caller: a run never falls back from a kernel to its plain version.
  * ``corrupt_exchange``: bump a value in the first output column of
    matching exchanges (row 0, ranks with rows only): the model of a
    packed-payload fault.  ``ExecConfig.validate`` checksums catch it; by
    default the corruption only fires while ``packed_exchange`` is on, so
    the packed -> unpacked degradation heals the query.  Set
    ``corrupt_packed_only=False`` to model a fault the fallback does not
    fix: the run then ends in a typed :class:`PlanInvariantError`.
  * ``poison_stats``: sabotage the adaptive statistics pass: ``"ndv"``
    clamps the distinct-count buffer bound to 1 (an undersized PartialAgg,
    healed by the per-op overflow retry); ``"raise"`` makes the pass raise
    :class:`~repro_torch.core.errors.StatsError` (lowering degrades to
    static planning and logs a degradation event).

Injection is config-scoped and deterministic (no randomness, no globals),
so every case replays identically.  A plan built with ``fault_inject=None``
is identical to one built without the feature.
"""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class FaultPlan:
    """Injection points, all disarmed by default."""

    # capacity sites whose overflow flag is forced: physical-plan op ids
    # (int) and/or op class names (str, e.g. "HashExchange", "PartialAgg").
    force_overflow: tuple = ()
    # plan builds affected by force_overflow before it disarms (a retry then
    # heals); negative = every build (the give-up / typed-error path).
    overflow_shots: int = 1
    # kernel registry: raise KernelBackendError when this kernel runs on one
    # of fail_modes ("cuda" for the card's kernel, "plain" for the CPU's
    # PyTorch version).
    fail_kernel: str = ""
    fail_modes: tuple = ("cuda",)
    # exchanges whose first output column gets one value bumped (op ids
    # and/or class names, like force_overflow).
    corrupt_exchange: tuple = ()
    # corruption only fires under packed_exchange=True (the packed->unpacked
    # degradation then heals); False keeps corrupting after the fallback.
    corrupt_packed_only: bool = True
    # adaptive statistics sabotage: "" (off) | "ndv" | "raise".
    poison_stats: str = ""

    _overflow_spent: int = field(default=0, repr=False, compare=False)

    # -- site matching -------------------------------------------------------

    @staticmethod
    def _matches(spec: tuple, op) -> bool:
        return any((isinstance(s, int) and s == op.op_id)
                   or (isinstance(s, str) and type(op).__name__ == s)
                   for s in spec)

    def take_overflow_sites(self, ops) -> frozenset:
        """Op ids to force-overflow in the NEXT plan build; consumes one
        shot.  Called once per ``Lowered`` build."""
        if not self.force_overflow:
            return frozenset()
        if self.overflow_shots >= 0:
            if self._overflow_spent >= self.overflow_shots:
                return frozenset()
            self._overflow_spent += 1
        return frozenset(op.op_id for op in ops
                         if self._matches(self.force_overflow, op))

    def corrupt_sites(self, ops, packed: bool) -> frozenset:
        """Op ids whose exchange output gets corrupted in this build."""
        if not self.corrupt_exchange:
            return frozenset()
        if self.corrupt_packed_only and not packed:
            return frozenset()
        return frozenset(op.op_id for op in ops
                         if self._matches(self.corrupt_exchange, op))

    def kernel_fails(self, name: str, mode: str) -> bool:
        return bool(self.fail_kernel) and name == self.fail_kernel \
            and mode in self.fail_modes
