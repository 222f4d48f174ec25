"""Structured error taxonomy for the execution guardrails (docs/robustness.md).

Every failure mode the engine can detect maps to ONE typed error here, so
callers (and the unified retry policy in runtime/retry.py) dispatch on type
instead of parsing messages:

  * :class:`CapacityOverflow`  — a 1D_VAR capacity site overflowed and the
    retry budget is exhausted.  Carries the physical-plan op id, the observed
    requirement and the planned cap, so the caller knows exactly which buffer
    to grow.
  * :class:`PlanInvariantError` — an ``ExecConfig.validate`` runtime check
    failed (row-count conservation, packed-payload checksum, post-sort
    monotonicity, category-code range): the result would be CORRUPT, never
    return it silently.
  * :class:`KernelBackendError` — a kernel backend (Pallas compiled or
    interpret) failed to build/trace; the degradation ladder steps the ONE
    offending kernel down (compiled -> interpret -> ref) before giving up.
  * :class:`StatsError`         — the adaptive statistics pass failed;
    lowering degrades to static planning and records a degradation event.

All of them subclass :class:`HiFramesError` (itself a ``RuntimeError``), so
pre-taxonomy callers catching ``RuntimeError`` keep working.
"""
from __future__ import annotations

from typing import Any, NamedTuple


class HiFramesError(RuntimeError):
    """Base of every typed engine error."""


class InvariantFailure(NamedTuple):
    """One failed runtime validation check (ExecConfig.validate).

    ``kind`` is the check family: "rowcount" (rows in != rows out across an
    exchange), "checksum" (packed-payload word checksum mismatch),
    "monotonic" (post-sort key order violated), "code_range" (category code
    outside [-1, n_categories)).  ``op_id`` anchors it to the physical plan.
    """

    kind: str
    op_id: int
    detail: str = ""

    def render(self) -> str:
        tail = f": {self.detail}" if self.detail else ""
        return f"{self.kind}@op#{self.op_id}{tail}"


class CapacityOverflow(HiFramesError):
    """A capacity site overflowed and retries are exhausted.

    ``observed_est`` is the host-reduced requirement estimate for the site
    (exact for compact/partial-agg/concat sites, a tight upper bound for
    exchanges, the worst-case product for joins); ``cap`` is the capacity the
    failing run planned.  The message names the op so "which buffer was too
    small" needs no plan spelunking.
    """

    def __init__(self, op_id: int = -1, op: str = "", observed_est: int = 0,
                 cap: int = 0, attempts: int = 0, message: str = ""):
        self.op_id = int(op_id)
        self.op = op
        self.observed_est = int(observed_est)
        self.cap = int(cap)
        self.attempts = int(attempts)
        if not message:
            where = f"op #{op_id} ({op})" if op else f"op #{op_id}"
            message = (
                f"capacity overflow at {where}: observed requirement "
                f"~{self.observed_est} rows > planned cap {self.cap} "
                f"after {self.attempts} attempt(s) — data skew exceeds plan "
                "bounds (cf. paper Q05 skew discussion)")
        super().__init__(message)


class PlanInvariantError(HiFramesError):
    """Runtime validation (ExecConfig.validate) detected corruption."""

    def __init__(self, failures: tuple[InvariantFailure, ...],
                 message: str = ""):
        self.failures = tuple(failures)
        if not message:
            body = "; ".join(f.render() for f in self.failures) or "unknown"
            message = (f"plan invariant violated ({len(self.failures)} "
                       f"check(s) failed): {body}")
        super().__init__(message)


class KernelBackendError(HiFramesError):
    """A kernel backend failed; carries what failed and on which backend so
    the retry policy can step exactly that kernel down the ladder."""

    def __init__(self, kernel: str, backend: str, cause: Any = None,
                 message: str = ""):
        self.kernel = kernel
        self.backend = backend
        self.cause = cause
        if not message:
            message = (f"kernel backend failure: {kernel!r} on backend "
                       f"{backend!r}" + (f" ({cause})" if cause else ""))
        super().__init__(message)


class StatsError(HiFramesError):
    """The adaptive statistics pass failed (lowering degrades to static)."""
