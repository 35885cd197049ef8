"""Freshness-SLO health governor: the port of ``repro.health``.

Enable by setting ``RedundancyPolicy(health=HealthPolicy(...))`` (or
``health=True`` for defaults); the store constructs the governor in
``attach`` and surfaces per-tick state on ``TickReport.health``.
"""
from .backoff import backoff_delay, backoff_schedule
from .governor import (
    BREAKER_STATES, CRITICAL, DEGRADED, HEALTHY,
    BackpressureError, FreshnessViolation, FreshnessViolationError,
    HealthAction, HealthGovernor, HealthPolicy, HealthReport,
)

__all__ = [
    "backoff_delay", "backoff_schedule",
    "BREAKER_STATES", "HEALTHY", "DEGRADED", "CRITICAL",
    "HealthPolicy", "HealthAction", "HealthReport", "HealthGovernor",
    "BackpressureError", "FreshnessViolation", "FreshnessViolationError",
]
