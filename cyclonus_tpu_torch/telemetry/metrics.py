"""Typed metrics: counters, gauges, and log-bucketed histograms with a
Prometheus text-exposition writer and a JSON snapshot API.

Pure stdlib and thread-safe.  Metric naming scheme (docs/DESIGN.md):
every metric is `cyclonus_tpu_<subsystem>_<what>[_total|_seconds|_bytes]`.
Unlabeled counters and gauges emit a 0-valued sample from creation, so
the exposition endpoint always carries the full schema (scrapers and the
acceptance tests can assert on names before the first event); labeled
series appear on first use.

The hot-path contract: every mutator checks `state.ENABLED` first and is
otherwise one lock + one dict update — no allocation beyond the label
tuple, never any device interaction: nothing in this package imports torch
(tests/test_torch_telemetry.py pins it).
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..utils import guards
from . import state

# ~2.5x log-spaced seconds buckets, 100 us .. 2 min: wide enough for a
# native-probe RTT and a cold multi-second engine eval in one scheme
DEFAULT_TIME_BUCKETS: Tuple[float, ...] = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0,
)


def _fmt_value(v: float) -> str:
    if v != v or v in (float("inf"), float("-inf")):  # NaN / +-Inf
        return {float("inf"): "+Inf", float("-inf"): "-Inf"}.get(v, "NaN")
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _escape_label(v: Any) -> str:
    return (
        str(v)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def _label_str(items: Sequence[Tuple[str, Any]]) -> str:
    if not items:
        return ""
    inner = ",".join(f'{k}="{_escape_label(v)}"' for k, v in items)
    return "{" + inner + "}"


@guards.checked
class Metric:
    """Base: a named family with fixed label names and per-label-value
    series created on first touch."""

    kind = "untyped"

    # runtime twin of the guarded-by contract (tools/locklint.py LK001)
    _series = guards.Guarded("_lock")

    def __init__(self, name: str, help: str, labelnames: Sequence[str] = ()):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = guards.lock()
        # unlabeled families carry a 0-valued sample from birth; one
        # assignment so construction stays a single (pre-publication)
        # write of the guarded attribute
        self._series: Dict[Tuple[Any, ...], Any] = (  # guarded-by: self._lock
            {(): self._zero()} if not self.labelnames else {}
        )

    def _zero(self) -> Any:
        return 0.0

    def _key(self, labels: Dict[str, Any]) -> Tuple[Any, ...]:
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: labels {sorted(labels)} != declared "
                f"{sorted(self.labelnames)}"
            )
        return tuple(labels[k] for k in self.labelnames)

    def samples(self) -> List[Tuple[Tuple[Tuple[str, Any], ...], Any]]:
        """[(sorted label items, value-state)] — stable iteration order."""
        with self._lock:
            items = [
                (tuple(zip(self.labelnames, key)), self._copy_state(val))
                for key, val in self._series.items()
            ]
        return sorted(items, key=lambda kv: kv[0])

    def _copy_state(self, val: Any) -> Any:
        return val

    # exposition / snapshot -------------------------------------------------

    def render(self) -> List[str]:
        lines = [
            f"# HELP {self.name} {self.help}",
            f"# TYPE {self.name} {self.kind}",
        ]
        for labels, value in self.samples():
            lines.append(f"{self.name}{_label_str(labels)} {_fmt_value(value)}")
        return lines

    def snapshot(self) -> Dict[str, Any]:
        return {
            "type": self.kind,
            "help": self.help,
            "samples": [
                {"labels": dict(labels), "value": value}
                for labels, value in self.samples()
            ],
        }


class Counter(Metric):
    kind = "counter"

    def inc(self, amount: float = 1.0, **labels: Any) -> None:
        if not state.ENABLED:
            return
        if amount < 0:
            raise ValueError(f"{self.name}: counters only go up")
        key = self._key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + amount

    def value(self, **labels: Any) -> float:
        with self._lock:
            return float(self._series.get(self._key(labels), 0.0))


class Gauge(Metric):
    kind = "gauge"

    def set(self, value: float, **labels: Any) -> None:
        if not state.ENABLED:
            return
        key = self._key(labels)
        with self._lock:
            self._series[key] = float(value)

    def inc(self, amount: float = 1.0, **labels: Any) -> None:
        if not state.ENABLED:
            return
        key = self._key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + amount

    def value(self, **labels: Any) -> float:
        with self._lock:
            return float(self._series.get(self._key(labels), 0.0))


class _HistState:
    __slots__ = ("counts", "sum", "count")

    def __init__(self, n_buckets: int):
        self.counts = [0] * n_buckets  # per-bucket (non-cumulative)
        self.sum = 0.0
        self.count = 0


class Histogram(Metric):
    """Log-bucketed histogram (default: DEFAULT_TIME_BUCKETS seconds)."""

    kind = "histogram"

    def __init__(
        self,
        name: str,
        help: str,
        labelnames: Sequence[str] = (),
        buckets: Optional[Sequence[float]] = None,
    ):
        self.buckets = tuple(sorted(buckets or DEFAULT_TIME_BUCKETS))
        super().__init__(name, help, labelnames)

    def _zero(self) -> "_HistState":
        return _HistState(len(self.buckets))

    def observe(self, value: float, **labels: Any) -> None:
        if not state.ENABLED:
            return
        key = self._key(labels)
        with self._lock:
            st = self._series.get(key)
            if st is None:
                st = self._series[key] = _HistState(len(self.buckets))
            # first bucket whose upper bound holds the value (bisect is
            # overkill at ~19 buckets)
            for i, ub in enumerate(self.buckets):
                if value <= ub:
                    st.counts[i] += 1
                    break
            st.sum += value
            st.count += 1

    def _copy_state(self, val: "_HistState") -> Dict[str, Any]:
        return {"counts": list(val.counts), "sum": val.sum, "count": val.count}

    def render(self) -> List[str]:
        lines = [
            f"# HELP {self.name} {self.help}",
            f"# TYPE {self.name} {self.kind}",
        ]
        for labels, st in self.samples():
            cum = 0
            for ub, c in zip(self.buckets, st["counts"]):
                cum += c
                le = _label_str(tuple(labels) + (("le", _fmt_value(ub)),))
                lines.append(f"{self.name}_bucket{le} {cum}")
            le = _label_str(tuple(labels) + (("le", "+Inf"),))
            lines.append(f"{self.name}_bucket{le} {st['count']}")
            lines.append(
                f"{self.name}_sum{_label_str(labels)} {_fmt_value(st['sum'])}"
            )
            lines.append(f"{self.name}_count{_label_str(labels)} {st['count']}")
        return lines

    def snapshot(self) -> Dict[str, Any]:
        return {
            "type": self.kind,
            "help": self.help,
            "buckets": list(self.buckets),
            "samples": [
                {"labels": dict(labels), **st} for labels, st in self.samples()
            ],
        }


@guards.checked
class MetricRegistry:
    """Name -> metric family; creation is idempotent (same name + kind
    returns the existing family, so import order never matters)."""

    # runtime twin of the guarded-by contract (tools/locklint.py LK001)
    _metrics = guards.Guarded("_lock")
    _collectors = guards.Guarded("_lock")

    def __init__(self) -> None:
        self._lock = guards.lock()
        self._metrics: Dict[str, Metric] = {}  # guarded-by: self._lock
        # pull-style refreshers (weakrefs to bound methods) run before
        # every snapshot/render: gauges whose value is derived from live
        # object state (e.g. serve staleness = now - oldest_pending) stay
        # fresh at scrape time instead of freezing at their last
        # event-driven write
        self._collectors: List = []  # guarded-by: self._lock

    def _register(self, cls, name: str, help: str, labelnames, **kw) -> Metric:
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if (
                    type(existing) is not cls
                    or existing.labelnames != tuple(labelnames)
                    or (
                        "buckets" in kw
                        and kw["buckets"] is not None
                        and getattr(existing, "buckets", None)
                        != tuple(sorted(kw["buckets"]))
                    )
                ):
                    raise ValueError(
                        f"metric {name} already registered with a different "
                        f"type/labels/buckets"
                    )
                return existing
            m = cls(name, help, labelnames, **kw)
            self._metrics[name] = m
            return m

    def counter(
        self, name: str, help: str, labelnames: Sequence[str] = ()
    ) -> Counter:
        return self._register(Counter, name, help, labelnames)  # type: ignore[return-value]

    def gauge(
        self, name: str, help: str, labelnames: Sequence[str] = ()
    ) -> Gauge:
        return self._register(Gauge, name, help, labelnames)  # type: ignore[return-value]

    def histogram(
        self,
        name: str,
        help: str,
        labelnames: Sequence[str] = (),
        buckets: Optional[Sequence[float]] = None,
    ) -> Histogram:
        return self._register(  # type: ignore[return-value]
            Histogram, name, help, labelnames, buckets=buckets
        )

    def register_collector(self, method) -> None:
        """Register a pull-style refresher: `method` (a BOUND method —
        held by weakref, so a dead owner is pruned, never pinned) is
        called before every snapshot()/render_prometheus().  It should
        only set gauges and must not scrape."""
        import weakref

        with self._lock:
            self._collectors.append(weakref.WeakMethod(method))

    def _run_collectors(self) -> None:
        """Refresh pull-style gauges.  Collectors run OUTSIDE the
        registry lock (they take metric locks via Gauge.set, and may
        take their owner's lock first) so the only nested acquisition
        stays reset()'s registry->metric edge."""
        with self._lock:
            refs = list(self._collectors)
        dead = []
        for r in refs:
            fn = r()
            if fn is None:
                dead.append(r)
                continue
            try:
                fn()
            except Exception:
                pass  # a broken collector must not break the scrape
        if dead:
            with self._lock:
                self._collectors = [
                    r for r in self._collectors if r not in dead
                ]

    def render_prometheus(self) -> str:
        """Prometheus text exposition format 0.0.4, families sorted by
        name, series sorted by labels — byte-stable for golden tests."""
        self._run_collectors()
        with self._lock:
            families = sorted(self._metrics.items())
        lines: List[str] = []
        for _name, metric in families:
            lines.extend(metric.render())
        return "\n".join(lines) + ("\n" if lines else "")

    def snapshot(self) -> Dict[str, Any]:
        self._run_collectors()
        with self._lock:
            families = sorted(self._metrics.items())
        return {name: metric.snapshot() for name, metric in families}

    def reset(self) -> None:
        """Zero every series (keeps registrations; tests and bench).
        Lock order: registry before metric — the only nested
        acquisition in the package; Metric methods never take the
        registry lock, so the LK002 graph stays acyclic."""
        with self._lock:
            for m in self._metrics.values():
                with m._lock:  # locklint: lock-class Metric
                    m._series.clear()
                    if not m.labelnames:
                        m._series[()] = m._zero()


def histogram_quantile(snapshot: Dict, q: float) -> Optional[float]:
    """Quantile estimate from a Histogram snapshot, label series
    merged.  Linearly interpolates inside the winning bucket (the
    Prometheus histogram_quantile() estimator) instead of reporting the
    bucket's upper bound, so tight latency targets between bucket edges
    still produce a moving p99.  The first bucket interpolates from 0;
    a rank landing past the last finite bucket clamps to its bound."""
    samples = snapshot.get("samples") or []
    buckets = snapshot.get("buckets") or []
    if not samples or not buckets:
        return None
    counts = [0] * len(buckets)
    total = 0
    for s in samples:
        for i, c in enumerate(s.get("counts") or []):
            counts[i] += c
            total += c
    if total == 0:
        return None
    rank = q * total
    cum = 0
    for i, (ub, c) in enumerate(zip(buckets, counts)):
        prev_cum = cum
        cum += c
        if cum >= rank:
            lo = 0.0 if i == 0 else float(buckets[i - 1])
            if c <= 0:
                return float(ub)
            frac = (rank - prev_cum) / c
            return lo + (float(ub) - lo) * min(1.0, max(0.0, frac))
    return float(buckets[-1])


REGISTRY = MetricRegistry()
