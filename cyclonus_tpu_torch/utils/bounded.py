"""Bounded execution (a copy of the reference package's utils/bounded.py).

The worker client (worker/client.py) issues each in-pod batch through
run_bounded, so a worker pod that dies mid-exec costs a timeout instead
of a wedged driver thread.  BoundedRing is the fixed-capacity history
ring the reference's telemetry recorder stores into.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Any, Callable, List, Tuple

from . import guards


@guards.checked
class BoundedRing:
    """Thread-safe fixed-capacity append-only ring: the newest `maxlen`
    items win — bounded by construction so a process that evaluates
    forever holds a constant-size history."""

    # runtime twins of the guarded-by contract (tools/locklint.py LK001;
    # active only under CYCLONUS_GUARD_CHECK=1, plain attrs otherwise)
    _items = guards.Guarded("_lock")
    _appended = guards.Guarded("_lock")

    def __init__(self, maxlen: int):
        if maxlen <= 0:
            raise ValueError(f"BoundedRing maxlen must be positive, got {maxlen}")
        self.maxlen = maxlen
        self._lock = guards.lock()
        self._items: deque = deque(maxlen=maxlen)  # guarded-by: self._lock
        self._appended = 0  # guarded-by: self._lock (lifetime total)

    def append(self, item: Any) -> None:
        with self._lock:
            self._items.append(item)
            self._appended += 1

    def snapshot(self) -> List[Any]:
        """Oldest-to-newest copy of the current window."""
        with self._lock:
            return list(self._items)

    def snapshot_with_count(self) -> Tuple[List[Any], int]:
        """(oldest-to-newest copy, lifetime append count) from ONE lock
        hold.  Callers doing what's-new-since-marker math
        (telemetry/events.since) need both from the same instant: a
        snapshot() call followed by a separate .appended read admits
        appends in between, and the inflated count makes pre-marker
        items look new."""
        with self._lock:
            return list(self._items), self._appended

    def clear(self) -> None:
        with self._lock:
            self._items.clear()
            self._appended = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._items)

    @property
    def appended(self) -> int:
        with self._lock:
            return self._appended


def run_bounded(fn: Callable[[], Any], timeout_s: float) -> Tuple[str, Any]:
    """Run fn() on a daemon thread, waiting at most timeout_s.

    Returns ("ok", result), ("error", exception), or ("timeout", None).
    On timeout the thread is abandoned (daemon — it cannot be killed and
    may still complete later, harmlessly); callers must not retry the
    same blocking call on the main thread, which would just block on the
    same global init lock.
    """
    out: dict = {}

    def body():
        try:
            out["result"] = fn()
        except BaseException as e:  # surfaced to the caller, not swallowed
            out["error"] = e

    t = threading.Thread(target=body, daemon=True)
    t.start()
    t.join(timeout_s)
    if t.is_alive():
        return "timeout", None
    if "error" in out:
        return "error", out["error"]
    return "ok", out.get("result")
