"""Flight recorder: a bounded ring of the last N engine evaluations.

Each entry records what a post-mortem needs — shapes, kernel path, phase
timings, outcome, wall-clock — and the ring (utils/bounded.py
BoundedRing, CYCLONUS_FLIGHT_RECORDER_N entries, default 64) is dumped
to JSON:

  * automatically on an unhandled crash, via a chained `sys.excepthook`
    installed lazily at the first recorded evaluation (so importing
    telemetry never changes interpreter behavior);
  * on demand via `dump()` / the `telemetry` CLI command.

The dump path is CYCLONUS_FLIGHT_RECORDER_PATH, defaulting to
`artifacts/cyclonus-flight-recorder-<pid>.json` (the directory is
created on dump, and the artifacts/ tree is gitignored so dumps never
land in the working tree).  The crash hook never masks the crash: any
dump failure is swallowed and the previous excepthook always runs.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from typing import Any, Dict, List, Optional

from ..utils.bounded import BoundedRing
from . import state


def _default_capacity() -> int:
    try:
        return max(1, int(os.environ.get("CYCLONUS_FLIGHT_RECORDER_N", "64")))
    except ValueError:
        return 64


RING = BoundedRing(_default_capacity())

_lock = threading.Lock()
_seq = {"n": 0}  # guarded-by: _lock
_hook = {"installed": False, "previous": None}  # guarded-by: _lock


def record(**entry: Any) -> None:
    """Append one evaluation record (timestamped + sequence-numbered)."""
    if not state.ENABLED:
        return
    _install_crash_hook()
    with _lock:
        _seq["n"] += 1
        entry["seq"] = _seq["n"]
    entry["at"] = round(time.time(), 3)
    RING.append(entry)


def entries() -> List[Dict[str, Any]]:
    return RING.snapshot()


def reset() -> None:
    RING.clear()
    with _lock:
        _seq["n"] = 0


def dump_path() -> str:
    return os.environ.get(
        "CYCLONUS_FLIGHT_RECORDER_PATH",
        os.path.join(
            "artifacts", f"cyclonus-flight-recorder-{os.getpid()}.json"
        ),
    )


def dump(path: Optional[str] = None, reason: str = "on-demand") -> str:
    """Write the ring to JSON; returns the path written."""
    path = path or dump_path()
    payload = {
        "reason": reason,
        "pid": os.getpid(),
        "at": time.strftime("%Y-%m-%dT%H:%M:%S"),
        "recorded_total": RING.appended,
        "entries": entries(),
    }
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(payload, f, indent=2, default=str)
        f.write("\n")
    return path


# benign terminations that must not litter the cwd with dump files:
# Ctrl-C, sys.exit, and a consumer closing our stdout (`... | head`)
_NO_DUMP = (KeyboardInterrupt, SystemExit, BrokenPipeError)


def _crash_hook(exc_type, exc, tb) -> None:
    try:
        if len(RING) and not issubclass(exc_type, _NO_DUMP):
            dump(reason=f"crash: {exc_type.__name__}: {exc}")
    except Exception:
        pass  # the dump must never mask the crash itself
    # lock-FREE read, deliberately: the excepthook may run while some
    # wedged thread holds _lock (the very state worth crash-reporting),
    # and blocking here would hang the process silently instead of
    # printing the traceback.  'previous' is written once, under the
    # lock, before this hook can ever fire — the race is benign.
    prev = _hook["previous"] or sys.__excepthook__  # locklint: ignore[LK001] lock-free on purpose, see above
    prev(exc_type, exc, tb)


def _install_crash_hook() -> None:
    # double-checked fast path: a stale False only costs the lock below,
    # and the locked re-check makes the install itself race-free
    if _hook["installed"]:  # locklint: ignore[LK001] double-checked fast path
        return
    with _lock:
        if _hook["installed"]:
            return
        _hook["previous"] = sys.excepthook
        sys.excepthook = _crash_hook
        _hook["installed"] = True
