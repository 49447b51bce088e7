"""Trace-event recorder: the timeline half of the telemetry layer.

The span registry (spans.py) aggregates — count/total/max per path —
which answers "how expensive", never "when".  This module, when a trace
is active, additionally captures every span enter/exit as a timestamped
EVENT into a bounded ring (utils/bounded.BoundedRing), so a run can be
rendered as a wall-clock timeline (trace_export.py writes Chrome
trace-event JSON loadable in Perfetto / chrome://tracing).

Event shape (one dict per enter/exit):

    {"ph": "B"|"E", "name": ..., "path": "a/b/c", "ts": <epoch seconds>,
     "pid": ..., "tid": ..., "role": "driver"|"worker", "trace_id": ...,
     "args": {span attrs}}

Timestamps are epoch seconds (time.time), NOT perf_counter: a trace is
merged across PROCESSES (the driver and its in-pod workers), and the
epoch clock is the only one they share.  pid/tid keep the processes and
threads on separate timeline rows.

Trace context — (trace_id, parent span path) — crosses the driver→worker
wire as optional fields on the worker Batch (worker/model.py): the
worker adopts the driver's path as its span parent (spans.adopt), records
its own events under the same trace_id, and ships them back attached to
its Results.  `ingest` merges them into the driver's ring; events from
this process's own pid are skipped, because an in-process worker (tests,
--mock) already recorded into the same ring.

Recording is OFF by default — aggregates are always cheap, events are
per-occurrence — and costs one module-attribute read per span when off.
Enable with `enable()` (the --trace-out flags do this) or
CYCLONUS_TRACE_EVENTS=1 at process start; the ring holds the newest
CYCLONUS_TRACE_EVENTS_N events (default 8192), so an unbounded run keeps
a bounded, newest-wins window.
"""

from __future__ import annotations

import os
import threading
import time
import uuid
from typing import Any, Dict, List, Optional

from ..utils.bounded import BoundedRing
from . import state


def _default_capacity() -> int:
    try:
        return max(1, int(os.environ.get("CYCLONUS_TRACE_EVENTS_N", "8192")))
    except ValueError:
        return 8192


RING = BoundedRing(_default_capacity())

# os.getpid() is a real syscall on every call (CPython does not cache
# it) and costs ~15 us under gVisor-style sandboxes — per EVENT that
# would dwarf the span itself.  Workers are fresh interpreters (never
# os.fork without exec), so the import-time value is always right.
_PID = os.getpid()

# Module attribute, read by the span() hot path: the disabled cost is
# this one read.  Flipped only by enable()/disable().
ACTIVE: bool = False

_TRACE: Dict[str, Optional[str]] = {"id": None, "role": "driver"}


def enable(trace_id: Optional[str] = None, role: str = "driver") -> str:
    """Start (or join) a trace.  Returns the trace id — generated when
    not given (the driver's case), passed through when joining one (the
    worker adopting the driver's id off the wire)."""
    global ACTIVE
    tid = trace_id or uuid.uuid4().hex[:16]
    _TRACE["id"] = tid
    _TRACE["role"] = role
    ACTIVE = True
    return tid


def disable() -> None:
    global ACTIVE
    ACTIVE = False


def enabled() -> bool:
    return ACTIVE and state.ENABLED


def trace_id() -> Optional[str]:
    return _TRACE["id"]


def record(
    ph: str, name: str, path: str, attrs: Optional[Dict[str, Any]] = None
) -> None:
    """Append one B/E event (called by spans.span on enter/exit)."""
    if not (ACTIVE and state.ENABLED):
        return
    event: Dict[str, Any] = {
        "ph": ph,
        "name": name,
        "path": path,
        "ts": time.time(),
        "pid": _PID,
        "tid": threading.get_ident(),
        "role": _TRACE["role"],
        "trace_id": _TRACE["id"],
    }
    if attrs:
        event["args"] = dict(attrs)
    RING.append(event)


def ingest(foreign: List[Dict[str, Any]]) -> int:
    """Merge events recorded by ANOTHER process (a worker's, shipped back
    on its Results) into this ring; returns how many were taken.  Events
    stamped with this process's own pid are skipped — an in-process
    worker (tests, --mock) already recorded them here, and ingesting
    again would double every span on the timeline."""
    taken = 0
    for e in foreign:
        if not isinstance(e, dict) or e.get("pid") == _PID:
            continue
        if not all(k in e for k in ("ph", "name", "path", "ts")):
            continue
        RING.append(dict(e))
        taken += 1
    return taken


def entries() -> List[Dict[str, Any]]:
    """Oldest-to-newest copy of the current event window."""
    return RING.snapshot()


def mark() -> int:
    """Position token for `since`: the lifetime append count."""
    return RING.appended


def since(marker: int) -> List[Dict[str, Any]]:
    """Events appended after `mark()` that are still in the window (the
    worker uses this to slice out exactly its batch's events).  The
    window and the append count come from ONE lock hold
    (snapshot_with_count): with the old separate snapshot()/.appended
    reads, appends landing between them inflated the count and the
    slice returned PRE-marker events — another thread's spans leaked
    into the worker's batch."""
    snap, appended = RING.snapshot_with_count()
    new = appended - marker
    if new <= 0:
        return []
    return snap[-min(new, len(snap)):]


def reset() -> None:
    """Clear the window (the active/trace-id state survives — a reset
    mid-trace starts an empty timeline, not an untraced one)."""
    RING.clear()


if os.environ.get("CYCLONUS_TRACE_EVENTS", "") == "1":
    enable(os.environ.get("CYCLONUS_TRACE_ID") or None)
