"""Reliability model — paper §4.8, plus the measured-detection extension.

The port's own copy of ``repro.core.mttdl`` (pure Python): every function
returns the same floats.

Closed form (the paper's):

MTTDL_NoRed  = MTTF_page / P                (P = total pages/blocks)
MTTDL_Vilamb = MTTF_page / (V * N)          (V = vulnerable stripes,
                                             N = blocks per stripe)
uplift       = P / (V * N)

V is measured empirically from dirty traces of real workloads (the engine's
``dirty_stats``), exactly as the paper does.

Measured form (:func:`mttdl_measured`): the closed form treats detection as
instantaneous — a corruption in a *clean* stripe is assumed repaired the
moment it lands.  In reality it sits latent until the next scheduled scrub
flags it; during that latency a **second** fault in the same stripe defeats
the single-failure XOR parity.  The fault-injection oracle
(the reference's ``repro.faults.oracle``) measures that latency against real scrub
schedules, and the measured MTTDL combines both loss modes:

    rate_window = V * N / MTTF_block          (fault lands inside the window)
    rate_double = S * (N / MTTF_block)^2 * L  (second fault within latency L,
                                               S = total stripes)
    MTTDL_measured = 1 / (rate_window + rate_double)

With L -> 0 this reduces exactly to the paper's closed form.
"""
from __future__ import annotations

from typing import Dict, Iterable, Mapping, Optional, Sequence


def mttdl_no_red(mttf_block: float, total_blocks: int) -> float:
    return mttf_block / max(total_blocks, 1)


def mttdl_vilamb(mttf_block: float, vulnerable_stripes: float, stripe_blocks: int) -> float:
    denom = max(vulnerable_stripes * stripe_blocks, 1e-12)
    return mttf_block / denom


def mttdl_uplift(total_blocks: int, vulnerable_stripes: float, stripe_blocks: int) -> float:
    """P / (V*N); infinite (capped) when no stripe is ever vulnerable."""
    denom = vulnerable_stripes * stripe_blocks
    if denom <= 0:
        return float("inf")
    return total_blocks / denom


def aggregate_uplift(stats: Mapping[str, Mapping[str, float]], stripe_blocks: int) -> float:
    """Uplift across all leaves of a state dict (time-averaged V per leaf)."""
    total = sum(int(s["total_blocks"]) for s in stats.values())
    vuln = sum(float(s["vulnerable_stripes"]) for s in stats.values())
    return mttdl_uplift(total, vuln, stripe_blocks)


def mttdl_measured(mttf_block: float, vulnerable_stripes: float,
                   stripe_blocks: int, total_stripes: int,
                   detect_latency_seconds: float) -> float:
    """MTTDL from *measured* quantities (module docstring for the model).

    ``vulnerable_stripes`` is the time-averaged V from a dirty trace;
    ``detect_latency_seconds`` the measured mean scrub detection latency
    (0 reduces to :func:`mttdl_vilamb` exactly, up to the closed form's
    1e-12 clamp).
    """
    lam = 1.0 / float(mttf_block)
    rate_window = float(vulnerable_stripes) * stripe_blocks * lam
    rate_double = (total_stripes * (stripe_blocks * lam) ** 2
                   * max(float(detect_latency_seconds), 0.0))
    denom = rate_window + rate_double
    if denom <= 0:
        return float("inf")
    return 1.0 / denom


def mttdl_measured_live(mttf_block: float, vulnerable_stripes: float,
                        stripe_blocks: int, total_stripes: int,
                        assumed_latency_seconds: float,
                        measured: Optional[Mapping[str, float]] = None
                        ) -> float:
    """:func:`mttdl_measured` with the latency substituted from a live
    measurement when one exists.

    ``measured`` is a :func:`detection_latency_stats` dict (e.g. the scrub
    patroller's ``latency_stats()``); when it records at least one
    detection (``n > 0``) its mean latency replaces
    ``assumed_latency_seconds`` (the scheduled-scrub fallback).  This is
    how the patroller's measured detection latency feeds the reliability
    model: same closed form, tighter L.
    """
    lat = float(assumed_latency_seconds)
    if measured and int(measured.get("n", 0)) > 0:
        lat = float(measured["mean_s"])
    return mttdl_measured(mttf_block, vulnerable_stripes, stripe_blocks,
                          total_stripes, lat)


def detection_latency_stats(latency_steps: Sequence[float],
                            step_seconds: float = 1.0) -> Dict[str, float]:
    """Summarize measured scrub detection latencies (steps -> seconds).

    Returns mean/max/n in seconds given the measured per-step wall time;
    empty input yields zeros (no detectable injections ran).
    """
    xs = [float(x) for x in latency_steps if x is not None]
    if not xs:
        return {"n": 0, "mean_s": 0.0, "max_s": 0.0}
    return {
        "n": len(xs),
        "mean_s": sum(xs) / len(xs) * step_seconds,
        "max_s": max(xs) * step_seconds,
    }


def average_stats(trace: Iterable[Mapping[str, Mapping[str, float]]]) -> Dict[str, Dict[str, float]]:
    """Average vulnerable-stripe counts over a trace of dirty_stats snapshots."""
    acc: Dict[str, Dict[str, float]] = {}
    n = 0
    for snap in trace:
        n += 1
        for name, s in snap.items():
            a = acc.setdefault(name, {"vulnerable_stripes": 0.0,
                                      "dirty_blocks": 0.0,
                                      "total_blocks": int(s["total_blocks"]),
                                      "total_stripes": int(s["total_stripes"])})
            a["vulnerable_stripes"] += float(s["vulnerable_stripes"])
            a["dirty_blocks"] += float(s["dirty_blocks"])
    for a in acc.values():
        a["vulnerable_stripes"] /= max(n, 1)
        a["dirty_blocks"] /= max(n, 1)
    return acc
