"""Hierarchical structured spans.

Upgrades the flat phase timers of `utils/tracing.py` (which now delegates
here) into parent/child-nested spans with attributes, while keeping the
old flat view intact for existing consumers:

    with span("engine.encode", pods=n) as s:
        ...
        s.set(targets=t)

Nesting is tracked per thread (a thread-local path stack), so concurrent
evaluations never see each other's parents.  The registry aggregates two
views under one lock:

  * flat, by span NAME — exactly the shape `utils.tracing.stats()` has
    always returned ({"count", "total_s", "max_s"} per name);
  * hierarchical, by span PATH ("a/b/c"), each node additionally carrying
    the most recent attributes — rendered as a tree by `render_tree`.

Span names are static strings (phase names, kernel paths), so the
registry is bounded by the instrumentation sites, not by traffic.  The
hot-path cost when telemetry is disabled is one module-attribute read;
when enabled, two perf_counter calls plus one locked dict update.
"""

from __future__ import annotations

import contextlib
import logging
import threading
import time
from typing import Any, Dict, Iterator, Optional

from ..utils import guards
from . import events, state

logger = logging.getLogger("cyclonus.trace")

_EMPTY: Dict[str, Any] = {}


class Span:
    """The in-flight handle yielded by `span()`: attribute sink only —
    timing and registration happen in the context manager."""

    __slots__ = ("name", "path", "attrs")

    def __init__(self, name: str, path: str, attrs: Optional[Dict[str, Any]]):
        self.name = name
        self.path = path
        self.attrs = dict(attrs) if attrs else {}

    def set(self, **attrs: Any) -> "Span":
        self.attrs.update(attrs)
        return self


class _NullSpan:
    """Shared no-op handle for the disabled path (no allocation)."""

    __slots__ = ()
    name = ""
    path = ""
    attrs = _EMPTY

    def set(self, **attrs: Any) -> "_NullSpan":
        return self


_NULL_SPAN = _NullSpan()


@guards.checked
class SpanRegistry:
    """Thread-safe per-process aggregation of completed spans."""

    # runtime twins of the guarded-by contract (tools/locklint.py LK001)
    _flat = guards.Guarded("_lock")
    _tree = guards.Guarded("_lock")

    def __init__(self) -> None:
        self._lock = guards.lock()
        self._flat: Dict[str, Dict[str, float]] = {}  # guarded-by: self._lock
        self._tree: Dict[str, Dict[str, Any]] = {}  # guarded-by: self._lock

    def record(
        self, path: str, name: str, dt: float, attrs: Dict[str, Any]
    ) -> None:
        with self._lock:
            rec = self._flat.get(name)
            if rec is None:
                rec = self._flat[name] = {
                    "count": 0, "total_s": 0.0, "max_s": 0.0
                }
            rec["count"] += 1
            rec["total_s"] += dt
            if dt > rec["max_s"]:
                rec["max_s"] = dt
            node = self._tree.get(path)
            if node is None:
                node = self._tree[path] = {
                    "count": 0, "total_s": 0.0, "max_s": 0.0, "attrs": {}
                }
            node["count"] += 1
            node["total_s"] += dt
            if dt > node["max_s"]:
                node["max_s"] = dt
            if attrs:
                node["attrs"].update(attrs)

    def stats(self) -> Dict[str, Dict[str, float]]:
        """Flat per-name aggregates (the historical tracing.stats shape)."""
        with self._lock:
            return {k: dict(v) for k, v in self._flat.items()}

    def tree(self) -> Dict[str, Dict[str, Any]]:
        """Per-path aggregates with attributes; keys are 'a/b/c' paths."""
        with self._lock:
            return {
                k: {**{x: v[x] for x in ("count", "total_s", "max_s")},
                    "attrs": dict(v["attrs"])}
                for k, v in self._tree.items()
            }

    def reset(self) -> None:
        with self._lock:
            self._flat.clear()
            self._tree.clear()

    def render_tree(self) -> str:
        """Indented tree view, children under parents, sorted by path."""
        rows = sorted(self.tree().items())
        if not rows:
            return "(no spans recorded)"
        out = [f"{'span':<44}{'count':>8}{'total_s':>12}{'max_s':>10}"]
        for path, rec in rows:
            depth = path.count("/")
            label = ("  " * depth) + path.rsplit("/", 1)[-1]
            attrs = (
                " " + ",".join(f"{k}={v}" for k, v in sorted(rec["attrs"].items()))
                if rec["attrs"]
                else ""
            )
            out.append(
                f"{label:<44}{int(rec['count']):>8}{rec['total_s']:>12.4f}"
                f"{rec['max_s']:>10.4f}{attrs}"
            )
        return "\n".join(out)


REGISTRY = SpanRegistry()

_tls = threading.local()


def current_path() -> str:
    """The active span path on this thread ('' at top level)."""
    return getattr(_tls, "path", "")


@contextlib.contextmanager
def adopt(path: str) -> Iterator[None]:
    """Adopt a foreign span path as this thread's parent, so subsequent
    spans nest under it.  Two users: worker threads inheriting the
    issuing thread's path (pool.map drops thread-locals), and the remote
    worker adopting the DRIVER's path off the wire (worker/model.py
    Batch.parent_span) so a merged trace renders as one tree."""
    prev = getattr(_tls, "path", "")
    _tls.path = path or ""
    try:
        yield
    finally:
        _tls.path = prev


@contextlib.contextmanager
def span(name: str, **attrs: Any) -> Iterator[Span]:
    """Time a block as a child of the current thread's active span."""
    if not state.ENABLED:
        yield _NULL_SPAN  # type: ignore[misc]
        return
    parent = getattr(_tls, "path", "")
    path = f"{parent}/{name}" if parent else name
    _tls.path = path
    handle = Span(name, path, attrs)
    if events.ACTIVE:
        events.record("B", name, path, attrs)
    t0 = time.perf_counter()
    try:
        yield handle
    finally:
        dt = time.perf_counter() - t0
        _tls.path = parent
        REGISTRY.record(path, name, dt, handle.attrs)
        if events.ACTIVE:
            # exit carries the FINAL attrs (s.set() calls inside the block)
            events.record("E", name, path, handle.attrs)
        logger.debug("phase %s: %.4fs", path, dt)
