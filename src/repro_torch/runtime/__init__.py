"""Runtime of the port: deterministic fault injection, the capacity-retry /
degradation policy, on-device resharding (``reshard.reshard``) and the
serving session."""
from . import reshard, session
from .faults import FaultPlan
from .retry import RetryEvent, RetryPolicy, clear_events, events_for
from .session import PlanCache, QueryRecord, Session, cfg_signature
