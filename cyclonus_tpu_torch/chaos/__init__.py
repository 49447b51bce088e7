"""Chaos layer: deterministic fault injection for the cold-start and
crash-survival contract (a copy of the reference's cyclonus_tpu.chaos).

Two halves:

  - injection hooks (this module): named points compiled into the
    production code paths — `fire(point)` raises ChaosError and
    `stall(point)` sleeps — armed ONLY via CYCLONUS_CHAOS, so the
    hooks are two dict reads when disarmed.  Points:

        backend_init       the retry envelope of the harness's
                           backend_init_flake scenario (the port has no
                           backend attach of its own)
        delta_apply        VerdictService.apply_pending, AFTER the
                           authoritative dicts mutated (exercises the
                           rollback + rebuild-to-snapshot path)
        worker_wire        worker/client.py batch issue (raise)
        worker_wire_stall  worker/client.py batch issue (sleep ARG
                           seconds; trips the per-batch timeout)
        verdict_corrupt    audit/sampler.py offer(): flips a SAMPLED
                           verdict's allow bits at the audit intake —
                           the end-to-end proof the shadow-oracle
                           sampler detects a corruption within a
                           bounded number of checks

  - the harness (chaos/harness.py): seeded, bounded scenarios — kill
    and restart `cyclonus-tpu-torch serve` mid-churn with a bounded
    time-to-first-verdict, poison the slab autotune's persisted
    winners, fail backend init N times, stall the worker wire, drop a
    delta batch mid-apply — each asserting the system degrades exactly
    as designed (fresh search / retry / rollback; incremental ==
    rebuild == oracle parity after every injected fault).  The
    `chaos` command runs them.

Spec grammar (CYCLONUS_CHAOS): comma-separated `point[:count[:arg]]` —
`count` faults fire at that point then the hook disarms (default 1);
`arg` is the point-specific float (stall seconds).  Example:

    CYCLONUS_CHAOS="backend_init:2,worker_wire_stall:1:0.5"

Every fired fault counts into cyclonus_tpu_chaos_injections_total by
point, so a chaos run's artifact shows exactly what was injected.
Nothing here imports torch: the in-pod worker loads this module.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, Optional

__all__ = [
    "ChaosError",
    "armed",
    "disarm",
    "fire",
    "injected",
    "reset",
    "stall",
]


class ChaosError(RuntimeError):
    """An injected fault (never raised unless CYCLONUS_CHAOS armed it)."""

    def __init__(self, point: str):
        super().__init__(f"chaos: injected fault at {point!r}")
        self.point = point


_LOCK = threading.Lock()
# {"env": spec string the budgets were parsed from, "budgets":
#  {point: [remaining, arg]}, "fired": {point: count}, "gen":
#  arm-generation counter (see disarm)}
_STATE: Dict = {"env": None, "budgets": {}, "fired": {}, "gen": 0}  # guarded-by: _LOCK


def _parse(spec: str) -> Dict[str, list]:
    budgets: Dict[str, list] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        bits = part.split(":")
        point = bits[0]
        try:
            count = int(bits[1]) if len(bits) > 1 else 1
        except ValueError:
            count = 1
        try:
            arg = float(bits[2]) if len(bits) > 2 else None
        except ValueError:
            arg = None
        budgets[point] = [max(0, count), arg]
    return budgets


def reset(spec: Optional[str] = None) -> int:
    """Re-arm from `spec` (tests/harness), or from the CURRENT env when
    None.  Clears fired counts.  An explicit spec is written back to
    CYCLONUS_CHAOS — the hooks re-sync from the env, so the two must
    agree or the next hook would silently re-parse the stale env.
    Returns an arm-generation token for `disarm` — a scenario thread
    abandoned past its bound must not clear the budget a LATER
    scenario armed."""
    if spec is None:
        spec = os.environ.get("CYCLONUS_CHAOS", "")
    else:
        os.environ["CYCLONUS_CHAOS"] = spec
    with _LOCK:
        _STATE["env"] = spec
        _STATE["budgets"] = _parse(spec)
        _STATE["fired"] = {}
        _STATE["gen"] += 1
        return _STATE["gen"]


def disarm(token: Optional[int] = None) -> None:
    """Clear the armed spec — but ONLY if `token` is still the current
    arm generation (None forces).  The token-checked form is what
    scenario `finally` blocks use: if the scenario was abandoned by
    run_bounded and a later scenario has re-armed, the stale thread's
    cleanup becomes a no-op instead of disarming mid-scenario."""
    with _LOCK:
        if token is not None and token != _STATE["gen"]:
            return
        os.environ["CYCLONUS_CHAOS"] = ""
        _STATE["env"] = ""
        _STATE["budgets"] = {}
        _STATE["fired"] = {}
        _STATE["gen"] += 1


def _budget(point: str):
    """The live [remaining, arg] for `point`, re-parsing when the env
    changed since the last look (subprocess harnesses set the env
    before import, long-lived tests flip it between scenarios)."""
    env = os.environ.get("CYCLONUS_CHAOS", "")
    with _LOCK:
        if env != _STATE["env"]:
            _STATE["env"] = env
            _STATE["budgets"] = _parse(env)
            _STATE["fired"] = {}
        return _STATE["budgets"].get(point)


def armed(point: str) -> bool:
    b = _budget(point)
    return bool(b and b[0] > 0)


def _consume(point: str):
    """Decrement the budget under the lock; returns the arg when a
    fault should fire, else None-sentinel False."""
    env = os.environ.get("CYCLONUS_CHAOS", "")
    with _LOCK:
        if env != _STATE["env"]:
            _STATE["env"] = env
            _STATE["budgets"] = _parse(env)
            _STATE["fired"] = {}
        b = _STATE["budgets"].get(point)
        if not b or b[0] <= 0:
            return False
        b[0] -= 1
        _STATE["fired"][point] = _STATE["fired"].get(point, 0) + 1
        arg = b[1]
    _count(point)
    return (arg,)


def fire(point: str) -> None:
    """Raise ChaosError at `point` while its budget lasts; no-op
    otherwise.  The production call sites sit on paths that already
    survive real faults of the same class — the raise must flow
    through the SAME retry/rollback machinery a real failure would."""
    if _consume(point) is not False:
        raise ChaosError(point)


def stall(point: str, default_s: float = 1.0) -> float:
    """Sleep the point's arg (or `default_s`) while its budget lasts;
    returns the seconds slept (0.0 when disarmed).  The sleep happens
    OUTSIDE the state lock."""
    hit = _consume(point)
    if hit is False:
        return 0.0
    seconds = hit[0] if hit[0] is not None else default_s
    time.sleep(max(0.0, float(seconds)))
    return float(seconds)


def injected() -> Dict[str, int]:
    """Faults fired so far, by point (this process)."""
    with _LOCK:
        return dict(_STATE["fired"])


def _count(point: str) -> None:
    try:
        from ..telemetry import instruments as ti

        ti.CHAOS_INJECTIONS.inc(point=point)
    except Exception:
        pass  # chaos must degrade to a no-op if telemetry is absent
