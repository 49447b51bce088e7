"""Telemetry: structured spans, typed metrics, and a flight recorder for
the CUDA verdict engine (a copy of the reference package's telemetry/,
with the same metric names, types and labels, so a dashboard reads
either package).

The reference has no tracing at all (SURVEY.md §5); rounds 1-5 showed
the interesting truths — dispatch RTT vs device time, slab autotune
outcomes, cache behavior, HBM watermarks — are invisible without a
first-class layer.  This package is that layer:

  spans.py        hierarchical, thread-safe spans with attributes
                  (utils/tracing.phase now delegates here; the old flat
                  stats view is preserved)
  metrics.py      counters / gauges / log-bucketed histograms +
                  Prometheus text exposition + JSON snapshot
  instruments.py  the named `cyclonus_tpu_*` metrics and the per-eval
                  `eval_flight` wrapper the engine hot paths use
  recorder.py     bounded ring of the last N evaluations, dumped to
                  JSON on unhandled crash and on demand
  events.py       trace-event recorder: span enter/exit as timestamped
                  events in a bounded ring, with (trace_id, parent path)
                  context propagated driver->worker over the wire
  trace_export.py Chrome trace-event JSON export of the merged timeline
                  (Perfetto / chrome://tracing; `--trace-out`, the
                  `trace` CLI command)
  server.py       optional stdlib http.server thread (`--metrics-port`),
                  plus on-demand torch.profiler captures
                  (/profile?seconds=N)

Disable everything with CYCLONUS_TELEMETRY=0 (or `set_enabled(False)`);
the instrumented paths then cost one attribute read.  Hot-path overhead
with telemetry ON is asserted <2% by tests/test_telemetry.py.
"""

from __future__ import annotations

from typing import Any, Dict

from . import events, instruments, metrics, recorder, spans, state, trace_export
from .metrics import REGISTRY as METRICS
from .spans import REGISTRY as SPANS, span
from .state import enabled, set_enabled

__all__ = [
    "METRICS",
    "SPANS",
    "enabled",
    "events",
    "instruments",
    "metrics",
    "recorder",
    "render_prometheus",
    "render_text",
    "reset",
    "set_enabled",
    "snapshot",
    "span",
    "spans",
    "state",
    "trace_export",
]


def render_prometheus() -> str:
    return METRICS.render_prometheus()


def snapshot() -> Dict[str, Any]:
    """One JSON-able view of everything: metrics, span aggregates (flat
    + tree), and the flight-recorder window.  The BENCH `telemetry`
    block and the /telemetry.json endpoint are this."""
    return {
        "metrics": METRICS.snapshot(),
        "phases": {
            k: {x: round(v[x], 6) if isinstance(v[x], float) else v[x]
                for x in ("count", "total_s", "max_s")}
            for k, v in sorted(SPANS.stats().items())
        },
        "spans": SPANS.tree(),
        "flight_recorder": recorder.entries(),
    }


def render_text() -> str:
    """Human view for the `telemetry` CLI command."""
    out = ["# spans", SPANS.render_tree(), "", "# metrics"]
    snap = METRICS.snapshot()
    for name, fam in snap.items():
        for sample in fam["samples"]:
            labels = ",".join(f"{k}={v}" for k, v in sorted(sample["labels"].items()))
            suffix = f"{{{labels}}}" if labels else ""
            if fam["type"] == "histogram":
                out.append(
                    f"{name}{suffix} count={sample['count']} "
                    f"sum={round(sample['sum'], 6)}"
                )
            else:
                out.append(f"{name}{suffix} {sample['value']}")
    ents = recorder.entries()
    out += ["", f"# flight recorder ({len(ents)} entries)"]
    for e in ents:
        out.append(
            f"  #{e.get('seq')} {e.get('path')} n_pods={e.get('n_pods')} "
            f"q={e.get('q')} {e.get('seconds')}s {e.get('outcome')}"
        )
    return "\n".join(out)


def reset() -> None:
    """Zero spans, metric series, the flight ring, and the trace-event
    window (registrations and the active-trace state survive).  Bench
    and tests isolate runs with this."""
    SPANS.reset()
    METRICS.reset()
    recorder.reset()
    events.reset()
