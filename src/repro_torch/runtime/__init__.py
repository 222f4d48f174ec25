"""Runtime guardrails of the port: deterministic fault injection and the
capacity-retry / degradation policy."""
from .faults import FaultPlan
from .retry import RetryEvent, RetryPolicy, clear_events, events_for
