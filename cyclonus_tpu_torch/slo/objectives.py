"""The declared service-level objectives: a small code-declared
registry (declarations are live code the controller consumes, not
documentation) over signals the
telemetry stack already emits.

Four objectives ship, one per signal family:

  * ``query_p99`` — per-flow query latency, from the
    cyclonus_tpu_serve_query_latency_seconds histogram.  An event is
    one answered flow; bad means slower than the target.
  * ``freshness`` — delta-apply freshness, from the pending-queue wait
    age (cyclonus_tpu_serve_staleness_seconds's source value).  An
    event is one accounting tick; bad means the oldest pending delta
    has waited longer than the target.
  * ``ttfv`` — time-to-first-verdict after a (re)start, observed once
    per process.  Bad means the first verdict took longer than the
    target — the restart contract the chaos harness kills replicas to
    check.
  * ``verdict_integrity`` — shadow-oracle audit divergences, from the
    cumulative cyclonus_tpu_audit_checked/diverged counters
    (cyclonus_tpu_torch/audit).  An event is one audited verdict; bad means
    the served allow bits disagreed with the scalar oracle.  Breach-
    dump posture like ttfv: a divergence is forensic evidence, never a
    reason to block queries.

Every numeric knob is env-tunable through utils/envflags.py (the
``CYCLONUS_SLO_QUERY_P99_S``-style slo flag family) so a drill can
shrink targets/windows to force
enforcement without code changes; the DECLARATIONS (which objectives
exist, what signal each reads, what enforcement it governs) are code.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

from ..utils import envflags

#: objective signal kinds
HISTOGRAM = "histogram"  # cumulative latency histogram snapshots
GAUGE = "gauge"          # one threshold sample per accounting tick
ONCE = "once"            # a single per-process observation
COUNTER = "counter"      # cumulative (total, bad) counter pair


@dataclass(frozen=True)
class Objective:
    """One declared SLO: the signal it reads, the target that splits
    good from bad events, the burn windows, and the error budget."""

    name: str
    kind: str  # HISTOGRAM | GAUGE | ONCE | COUNTER
    signal: str  # the telemetry signal the objective is computed from
    target_s: float  # seconds: the good/bad event threshold
    budget: float  # error budget: tolerated bad-event fraction
    fast_s: float  # fast burn window (seconds)
    slow_s: float  # slow burn window (seconds)
    enforces: str  # the enforcement lever this objective governs
    description: str


def declared_objectives() -> Tuple[Objective, ...]:
    """The registry, with targets/windows resolved from the environment
    (never-raise envflags accessors, so a malformed value degrades to
    the declared default instead of killing the service)."""
    budget = envflags.get_float("CYCLONUS_SLO_BUDGET")
    fast_s = envflags.get_float("CYCLONUS_SLO_FAST_S")
    slow_s = envflags.get_float("CYCLONUS_SLO_SLOW_S")
    return (
        Objective(
            name="query_p99",
            kind=HISTOGRAM,
            signal="cyclonus_tpu_serve_query_latency_seconds",
            target_s=envflags.get_float("CYCLONUS_SLO_QUERY_P99_S"),
            budget=budget,
            fast_s=fast_s,
            slow_s=slow_s,
            enforces="shed/degrade",
            description=(
                "per-flow query latency: burning routes queries onto "
                "the scalar-oracle degraded path, exhaustion sheds "
                "with a typed refusal"
            ),
        ),
        Objective(
            name="freshness",
            kind=GAUGE,
            signal="cyclonus_tpu_serve_staleness_seconds",
            target_s=envflags.get_float("CYCLONUS_SLO_FRESHNESS_S"),
            budget=budget,
            fast_s=fast_s,
            slow_s=slow_s,
            enforces="admission",
            description=(
                "delta-apply freshness (oldest pending delta's wait "
                "age): burning caps the pending queue, exhaustion "
                "rejects delta intake until the backlog drains"
            ),
        ),
        Objective(
            name="ttfv",
            kind=ONCE,
            signal="first verdict wall-clock after process start",
            target_s=envflags.get_float("CYCLONUS_SLO_TTFV_S"),
            budget=budget,
            fast_s=fast_s,
            slow_s=slow_s,
            enforces="breach-dump",
            description=(
                "time-to-first-verdict after restart: exceeding the "
                "target is an immediate breach (black-box dump); the "
                "chaos harness kills a replica mid-churn to check it"
            ),
        ),
        Objective(
            name="verdict_integrity",
            kind=COUNTER,
            signal="cyclonus_tpu_audit_diverged_total",
            # target_s is unused for a counter objective (good/bad is
            # decided at the signal: a diverged check IS a bad event);
            # declared 0.0 so the snapshot schema stays uniform.
            target_s=0.0,
            budget=budget,
            fast_s=fast_s,
            slow_s=slow_s,
            enforces="breach-dump",
            description=(
                "shadow-oracle verdict integrity: any audited verdict "
                "disagreeing with the scalar oracle burns budget and "
                "exhaustion dumps the black box (audit-divergence "
                "bundles carry the repro) — never query-blocking"
            ),
        ),
    )
