"""Chrome trace-event JSON export of the recorded event timeline.

`to_chrome_trace` renders the event ring (telemetry/events.py) in the
Trace Event Format that Perfetto (https://ui.perfetto.dev) and
chrome://tracing load directly: duration events ("ph": "B"/"E") on
pid/tid rows, with process-name metadata rows naming the driver and each
worker process.  Timestamps are microseconds relative to the earliest
event (Chrome's viewers expect small `ts`); the absolute epoch origin is
preserved under otherData so timelines can be correlated with logs.

A merged driver+worker run exports as ONE file: the worker's events were
recorded in its own process (own pid row) under the driver's trace_id
and ingested back over the wire, so the timeline shows the driver's
probe-step span with the in-pod worker's batch/probe spans running
beside it in wall-clock time — exactly the dispatch/execute interleaving
view the aggregate registry cannot give.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional

from . import events

# every exported event carries these (the golden-shape test pins them)
CHROME_EVENT_KEYS = ("ph", "ts", "pid", "tid", "name")


def to_chrome_trace(
    evts: Optional[List[Dict[str, Any]]] = None,
    trace_id: Optional[str] = None,
) -> Dict[str, Any]:
    """Render events (default: the process ring) as a Chrome trace dict.
    With `trace_id`, foreign-trace events are filtered out."""
    if evts is None:
        evts = events.entries()
    if trace_id is not None:
        evts = [e for e in evts if e.get("trace_id") in (None, trace_id)]
    # stable sort by wall-clock: within one process+thread the recording
    # order is already correct (B before E, children inside parents) and
    # survives ties; across processes wall-clock is the merge key
    evts = sorted(evts, key=lambda e: e["ts"])
    origin = evts[0]["ts"] if evts else 0.0

    trace_events: List[Dict[str, Any]] = []
    seen_pids: Dict[int, str] = {}
    ids = set()
    for e in evts:
        pid = e.get("pid", 0)
        if pid not in seen_pids:
            seen_pids[pid] = str(e.get("role") or "process")
        if e.get("trace_id"):
            ids.add(e["trace_id"])
        out: Dict[str, Any] = {
            "ph": e["ph"],
            # Chrome ts is microseconds; relative to the first event so
            # viewers do not choke on epoch-scale values
            "ts": round((e["ts"] - origin) * 1e6, 3),
            "pid": pid,
            "tid": e.get("tid", 0),
            "name": e["name"],
            "cat": "span",
            "args": {
                **(e.get("args") or {}),
                "path": e.get("path", ""),
            },
        }
        trace_events.append(out)

    # process-name metadata rows: driver vs worker pids label themselves
    meta = [
        {
            "ph": "M",
            "ts": 0,
            "pid": pid,
            "tid": 0,
            "name": "process_name",
            "args": {"name": f"cyclonus {role} (pid {pid})"},
        }
        for pid, role in sorted(seen_pids.items())
    ]
    return {
        "traceEvents": meta + trace_events,
        "displayTimeUnit": "ms",
        "otherData": {
            "generator": "cyclonus-tpu",
            "trace_id": trace_id or (sorted(ids)[0] if len(ids) == 1 else None),
            "trace_ids": sorted(ids),
            "epoch_origin_s": round(origin, 6),
        },
    }


def write_chrome_trace(
    path: str,
    evts: Optional[List[Dict[str, Any]]] = None,
    trace_id: Optional[str] = None,
) -> str:
    """Write the Chrome trace JSON; returns the path written."""
    import os

    data = to_chrome_trace(evts, trace_id)
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(data, f, default=str)
        f.write("\n")
    return path


def summarize(trace: Dict[str, Any]) -> str:
    """Human summary of a written trace (the `trace --input`
    view): processes, wall span, top spans by total duration."""
    evts = [e for e in trace.get("traceEvents", []) if e.get("ph") != "M"]
    meta = {
        e["pid"]: e.get("args", {}).get("name", "")
        for e in trace.get("traceEvents", [])
        if e.get("ph") == "M" and e.get("name") == "process_name"
    }
    if not evts:
        return "(empty trace: no events)"
    ts = [e["ts"] for e in evts]
    wall_ms = (max(ts) - min(ts)) / 1000.0

    # pair B/E per (pid, tid) to charge durations per span name
    stacks: Dict[Any, List[Dict[str, Any]]] = {}
    totals: Dict[str, List[float]] = {}
    per_pid: Dict[int, int] = {}
    for e in evts:
        per_pid[e["pid"]] = per_pid.get(e["pid"], 0) + 1
        key = (e["pid"], e["tid"])
        if e["ph"] == "B":
            stacks.setdefault(key, []).append(e)
        elif e["ph"] == "E":
            stack = stacks.get(key)
            if stack:
                b = stack.pop()
                rec = totals.setdefault(b["name"], [0.0, 0.0])
                rec[0] += (e["ts"] - b["ts"]) / 1000.0
                rec[1] += 1
    tid_count = len({(e["pid"], e["tid"]) for e in evts})
    other = trace.get("otherData", {})
    out = [
        f"trace: {len(evts)} events, {len(per_pid)} process(es), "
        f"{tid_count} thread(s), {wall_ms:.1f} ms wall, "
        f"trace_id={other.get('trace_id')}"
    ]
    for pid in sorted(per_pid):
        label = meta.get(pid) or f"pid {pid}"
        out.append(f"  {label}: {per_pid[pid]} events")
    out.append(f"  {'span':<36}{'count':>8}{'total_ms':>12}")
    for name, (total, count) in sorted(
        totals.items(), key=lambda kv: -kv[1][0]
    )[:15]:
        out.append(f"  {name:<36}{int(count):>8}{total:>12.2f}")
    return "\n".join(out)
