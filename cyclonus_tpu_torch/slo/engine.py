"""SloController: turns the declared objectives (objectives.py) plus
the burn-rate math (accounting.py) into live enforcement decisions for
the verdict service, and into the `cyclonus_tpu_slo_*` gauge family +
the `/slo` JSON payload.

Wiring:

  * VerdictService owns one controller.  Its scrape-time collector
    (`_refresh_gauges`) calls `tick()` — so burn accounting advances on
    the SAME cadence the staleness gauges already refresh on, and a
    process nobody scrapes pays nothing.
  * `query_route()` / `admit()` are the enforcement reads on the hot
    paths: lock-cheap, never raise, and constant "live"/None while
    enforcement is disarmed (CYCLONUS_SLO_ENFORCE, default off — the
    accounting and the /slo surface are always on, the levers are
    opt-in).
  * On a transition into `exhausted`, the controller records a breach
    entry (current trace id + span path as exemplars) and dumps the
    flight recorder with reason "slo-breach:<objective>" — the black
    box a post-mortem opens first.

Lock order: controller lock -> metric locks only; the controller never
takes the service lock, so service._lock -> slo._lock is the one
cross-object edge (submit/query hold the service lock while asking for
a decision) and the graph stays acyclic.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

from ..telemetry import instruments as ti
from ..telemetry import recorder
from ..utils import guards
from . import accounting
from .accounting import BURNING, EXHAUSTED, OK, BurnAccountant, Hysteresis
from .objectives import (
    COUNTER,
    GAUGE,
    HISTOGRAM,
    ONCE,
    Objective,
    declared_objectives,
)


def events_over_target(snapshot: Dict, target_s: float) -> Dict[str, float]:
    """(total, bad) cumulative event counts from a telemetry Histogram
    snapshot: bad = events that landed in a bucket whose upper bound
    exceeds the target (label series merged).  Bucket-resolution by
    construction — the same resolution /state's quantiles already have.
    """
    buckets = snapshot.get("buckets") or []
    total = 0
    good = 0
    for s in snapshot.get("samples") or []:
        total += int(s.get("count", 0))
        for ub, c in zip(buckets, s.get("counts") or []):
            if ub <= target_s:
                good += int(c)
    return {"total": float(total), "bad": float(max(0, total - good))}


class _Tracker:
    """One objective's live state: accountant + hysteresis + the last
    computed rates (cached for lock-cheap snapshot/decision reads)."""

    def __init__(self, obj: Objective, enter: float, exit_: float, hold: float):
        self.obj = obj
        self.acct = BurnAccountant(obj.budget, obj.fast_s, obj.slow_s)
        self.hyst = Hysteresis(enter, exit_, hold)
        self.fast_burn = 0.0
        self.slow_burn = 0.0
        self.remaining = 1.0
        self.forced: Optional[str] = None

    @property
    def state(self) -> str:
        return self.forced if self.forced is not None else self.hyst.state

    def advance(self, now: float) -> bool:
        """Recompute rates and step the hysteresis; True on a transition
        INTO exhausted (the breach edge)."""
        self.fast_burn, self.slow_burn = self.acct.burn_rates(now)
        self.remaining = self.acct.budget_remaining(now)
        was = self.hyst.state
        state = self.hyst.update(
            now, self.fast_burn, self.slow_burn, self.remaining
        )
        return state == EXHAUSTED and was != EXHAUSTED


@guards.checked
class SloController:
    """See the module docstring."""

    _trackers = guards.Guarded("_lock")
    _ticks = guards.Guarded("_lock")
    _ttfv_noted = guards.Guarded("_lock")

    def __init__(
        self,
        objectives: Optional[List[Objective]] = None,
        *,
        enforce: Optional[bool] = None,
        queue_cap: Optional[int] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        from ..utils import envflags

        self._lock = guards.lock()
        self._clock = clock
        self._started = clock()
        self.enforce = (
            envflags.get_bool("CYCLONUS_SLO_ENFORCE")
            if enforce is None
            else bool(enforce)
        )
        self.queue_cap = (
            envflags.get_int("CYCLONUS_SLO_QUEUE_CAP")
            if queue_cap is None
            else int(queue_cap)
        )
        enter = envflags.get_float("CYCLONUS_SLO_ENTER_BURN")
        exit_ = envflags.get_float("CYCLONUS_SLO_EXIT_BURN")
        hold = envflags.get_float("CYCLONUS_SLO_HOLD_S")
        objs = (
            list(objectives)
            if objectives is not None
            else list(declared_objectives())
        )
        self._trackers: Dict[str, _Tracker] = {
            o.name: _Tracker(o, enter, exit_, hold) for o in objs
        }
        self._ticks = 0
        self._ttfv_noted = False

    # --- signal intake ----------------------------------------------------

    def tick(
        self,
        *,
        staleness_s: Optional[float] = None,
        latency_snapshot: Optional[Dict] = None,
        now: Optional[float] = None,
    ) -> None:
        """One accounting step (the _refresh_gauges cadence): fold the
        latency histogram and the staleness sample into the accountants,
        advance every hysteresis, export the slo gauges, and dump the
        black box on a budget-exhaustion edge.  Never raises — a broken
        signal must not break the scrape that drives it."""
        try:
            self._tick(staleness_s, latency_snapshot, now)
        except Exception:
            pass  # never break the scrape path

    def _tick(
        self,
        staleness_s: Optional[float],
        latency_snapshot: Optional[Dict],
        now: Optional[float],
    ) -> None:
        if latency_snapshot is None:
            latency_snapshot = ti.SERVE_QUERY_LATENCY.snapshot()
        t = self._clock() if now is None else now
        breached: List[_Tracker] = []
        with self._lock:
            self._ticks += 1
            for tr in self._trackers.values():
                obj = tr.obj
                if obj.kind == HISTOGRAM:
                    ev = events_over_target(latency_snapshot, obj.target_s)
                    tr.acct.observe(t, ev["total"], ev["bad"])
                elif obj.kind == GAUGE:
                    if staleness_s is None:
                        continue  # contended refresh: no sample this tick
                    last = tr.acct._samples[-1] if tr.acct._samples else None
                    total = (last.total if last else 0.0) + 1.0
                    bad = (last.bad if last else 0.0) + (
                        1.0 if staleness_s > obj.target_s else 0.0
                    )
                    tr.acct.observe(t, total, bad)
                elif obj.kind == COUNTER:
                    # cumulative (total, bad) straight off the audit
                    # counters — the same shape the histogram fold
                    # produces, so the accountant diffs it identically
                    tr.acct.observe(
                        t,
                        float(ti.AUDIT_CHECKED.value()),
                        float(ti.AUDIT_DIVERGED.value()),
                    )
                # ONCE objectives advance only via observe_ttfv
                if tr.advance(t):
                    breached.append(tr)
            trackers = list(self._trackers.values())
        for tr in trackers:
            self._export(tr)
        for tr in breached:
            self._breach(tr)

    def observe_ttfv(self, seconds: float, now: Optional[float] = None) -> None:
        """Feed the once-per-process time-to-first-verdict observation:
        a single event, bad iff over target — so an over-budget restart
        is an immediate exhaustion (and breach dump)."""
        t = self._clock() if now is None else now
        with self._lock:
            tr = self._trackers.get("ttfv")
            if tr is None:
                return
            tr.acct.observe(t, 1.0, 1.0 if seconds > tr.obj.target_s else 0.0)
            breach = tr.advance(t)
        self._export(tr)
        if breach:
            self._breach(tr, extra={"ttfv_s": round(float(seconds), 3)})

    def note_first_verdict(self) -> None:
        """Idempotent hook the service's query paths call after every
        answered batch: the first call stamps time-to-first-verdict as
        now - controller creation (the service constructs its controller
        at boot, so this spans rebuild + prewarm)."""
        with self._lock:
            if self._ttfv_noted:
                return
            self._ttfv_noted = True
        self.observe_ttfv(self._clock() - self._started)

    # --- enforcement decisions (hot-path reads) ---------------------------

    def state_of(self, objective: str) -> str:
        with self._lock:
            tr = self._trackers.get(objective)
            return tr.state if tr is not None else OK

    def query_route(self) -> str:
        """The query path's routing decision: "shed" (typed refusal)
        when the latency budget is exhausted, "degraded" (scalar-oracle
        path — no service-lock wait behind a rebuild) while it burns,
        "live" otherwise or whenever enforcement is disarmed."""
        if not self.enforce:
            return "live"
        state = self.state_of("query_p99")
        if state == EXHAUSTED:
            return "shed"
        if state == BURNING:
            return "degraded"
        return "live"

    def admit(self, pending_depth: int, incoming: int) -> Optional[str]:
        """Admission control for submit(): None admits; a string is the
        rejection reason (freshness budget exhausted, or burning with
        the pending queue at cap)."""
        if not self.enforce:
            return None
        state = self.state_of("freshness")
        if state == EXHAUSTED:
            return (
                "freshness error budget exhausted: delta intake "
                "suspended until the backlog drains"
            )
        if state == BURNING and pending_depth + incoming > self.queue_cap:
            return (
                f"freshness budget burning: pending queue capped at "
                f"{self.queue_cap} (depth {pending_depth}, "
                f"incoming {incoming})"
            )
        return None

    def force_state(self, objective: str, state: Optional[str]) -> None:
        """Pin an objective's state (tests, drills, the route harness);
        None releases the pin.  Forced state feeds the same decision
        and gauge paths as computed state."""
        if state is not None and state not in (OK, BURNING, EXHAUSTED):
            raise ValueError(f"unknown slo state {state!r}")
        with self._lock:
            tr = self._trackers[objective]
            tr.forced = state
        self._export(tr)

    # --- export -----------------------------------------------------------

    def _export(self, tr: _Tracker) -> None:
        obj = tr.obj
        ti.SLO_BURN_RATE.set(
            tr.fast_burn, objective=obj.name, window="fast"
        )
        ti.SLO_BURN_RATE.set(
            tr.slow_burn, objective=obj.name, window="slow"
        )
        ti.SLO_BUDGET_REMAINING.set(tr.remaining, objective=obj.name)
        ti.SLO_STATE.set(
            accounting.state_severity(tr.state), objective=obj.name
        )

    def _breach(self, tr: _Tracker, extra: Optional[Dict] = None) -> None:
        """The budget-exhaustion edge: black-box capture.  The breach
        entry carries the live trace/span ids as exemplars so the dump
        correlates with any active timeline, then the whole flight ring
        goes to disk with the triggering objective in the reason."""
        from ..telemetry import events, spans

        obj = tr.obj
        ti.SLO_BREACHES.inc(objective=obj.name)
        entry = {
            "path": "slo.breach",
            "objective": obj.name,
            "signal": obj.signal,
            "target_s": obj.target_s,
            "burn_fast": round(tr.fast_burn, 4),
            "burn_slow": round(tr.slow_burn, 4),
            "budget_remaining": round(tr.remaining, 4),
            "trace_id": events.trace_id(),
            "span_path": spans.current_path(),
        }
        if extra:
            entry.update(extra)
        try:
            recorder.record(**entry)
            recorder.dump(reason=f"slo-breach:{obj.name}")
        except Exception:
            pass  # the dump is forensics; failing to write it must not
            # take the enforcement path down with it

    def snapshot(self) -> Dict:
        """The /slo payload: per-objective budget remaining, burn
        rates, and enforcement state (key set pinned by test)."""
        with self._lock:
            trackers = list(self._trackers.values())
            ticks = self._ticks
        objectives = {}
        for tr in trackers:
            obj = tr.obj
            objectives[obj.name] = {
                "signal": obj.signal,
                "target_s": obj.target_s,
                "budget": obj.budget,
                "windows": {"fast_s": obj.fast_s, "slow_s": obj.slow_s},
                "burn": {
                    "fast": round(tr.fast_burn, 4),
                    "slow": round(tr.slow_burn, 4),
                },
                "budget_remaining": round(tr.remaining, 4),
                "state": tr.state,
                "enforces": obj.enforces,
                "breaches": int(
                    ti.SLO_BREACHES.value(objective=obj.name)
                ),
            }
        return {
            "enforce": self.enforce,
            "queue_cap": self.queue_cap,
            "ticks": ticks,
            "shed_queries": int(ti.SLO_SHED.value()),
            "admission_rejects": int(ti.SLO_ADMISSION_REJECTS.value()),
            "objectives": objectives,
        }
