"""Shared retry-backoff schedule: exponential, capped, jittered, budgeted.

The port of ``repro.health.backoff`` (plain Python; the jitter draws are
the reference's, call for call: ``random.Random`` seeded the same way).
One policy for every retry loop in the library — the health governor's
wedged-dispatch retries draw their delays from here, as the reference's
``read_verified`` degraded-read retries do (ROADMAP.md, Queue 1 item
11.5, in the port), so "how long do we wait before trying
again" is a single auditable knob set rather than N ad-hoc sleeps.

Semantics (all seconds):

* delay for 1-based attempt ``a`` is ``base * 2**(a-1)``,
* ``cap > 0`` is a hard per-delay ceiling (post-exponentiation),
* ``jitter_frac`` shrinks each delay by a seeded uniform fraction in
  ``[0, jitter_frac)`` — jitter only ever *reduces* the delay, so ``cap``
  and ``total`` remain hard bounds and tests can assert ceilings,
* ``total > 0`` is a cumulative budget: the schedule's sum never exceeds
  it; delays past the budget degenerate to 0 (retry immediately — the
  caller's attempt count still bounds the loop).

``base <= 0`` yields an all-zero schedule (retry immediately), which is
the backwards-compatible default for ``read_retry_backoff_s=0``.
"""
from __future__ import annotations

import random
from typing import List, Optional


def backoff_delay(attempt: int, base: float, *, cap: float = 0.0,
                  jitter_frac: float = 0.0,
                  rng: Optional[random.Random] = None) -> float:
    """Delay in seconds before retry ``attempt`` (1-based)."""
    if base <= 0.0 or attempt <= 0:
        return 0.0
    d = float(base) * (2.0 ** (attempt - 1))
    if cap > 0.0:
        d = min(d, float(cap))
    if jitter_frac > 0.0:
        r = rng.random() if rng is not None else random.random()
        d *= 1.0 - min(float(jitter_frac), 1.0) * r
    return d


def backoff_schedule(attempts: int, base: float, *, cap: float = 0.0,
                     total: float = 0.0, jitter_frac: float = 0.0,
                     seed: int = 0) -> List[float]:
    """Full deterministic delay schedule for ``attempts`` retries."""
    rng = random.Random(seed)
    out: List[float] = []
    spent = 0.0
    for a in range(1, max(0, int(attempts)) + 1):
        d = backoff_delay(a, base, cap=cap, jitter_frac=jitter_frac, rng=rng)
        if total > 0.0:
            d = min(d, max(0.0, float(total) - spent))
        out.append(d)
        spent += d
    return out
