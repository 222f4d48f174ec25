"""Runtime of the port: deterministic fault injection, the capacity-retry /
degradation policy, on-device resharding (``reshard.reshard``), the
serving session and the fault-tolerant training driver (``ft``)."""
from . import ft, reshard, session
from .faults import FaultPlan
from .ft import FTConfig, TrainDriver, run_with_overflow_retry
from .retry import RetryEvent, RetryPolicy, clear_events, events_for
from .session import PlanCache, QueryRecord, Session, cfg_signature
