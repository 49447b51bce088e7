"""Multi-window burn-rate accounting: the SLO engine's math, with no
telemetry or service dependencies so tests can drive it against
synthetic event streams with an injected clock.

The model is the Google-SRE multi-window burn-rate alert, applied
in-process:

  * Every objective consumes a cumulative (total, bad) event stream —
    for the query-latency objective an event is one answered flow and
    "bad" means slower than the target; for the freshness objective an
    event is one accounting tick and "bad" means the oldest pending
    delta is older than the target.
  * The burn rate over a trailing window is
    ``bad_fraction(window) / error_budget`` — 1.0 means the budget is
    being spent exactly as fast as it accrues, N means N times faster.
  * Enforcement looks at a FAST and a SLOW window together: the fast
    window makes entry responsive, the slow window keeps a transient
    spike from flapping the state.  Budget remaining is
    ``1 - burn(slow)``, clamped to [0, 1] — 0 means the slow window's
    budget is fully spent (the breach transition).

The hysteresis state machine (``ok -> burning -> exhausted``) enters
eagerly and exits lazily: BURNING engages the moment the FAST window
burns past the enter threshold (the slow window cannot gate entry —
any slow burn past 1.0 already means the budget is spent, i.e.
EXHAUSTED, so a slow-window entry bar above 1.0 would be unreachable),
EXHAUSTED fires when the slow window's budget hits zero, and the
machine disengages only after BOTH windows have stayed below the exit
threshold for a continuous hold period — so a load spike that
oscillates around the threshold cannot flap shed/admission decisions
on and off.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

#: enforcement states, in severity order
OK = "ok"
BURNING = "burning"
EXHAUSTED = "exhausted"

_SEVERITY = {OK: 0, BURNING: 1, EXHAUSTED: 2}


def state_severity(state: str) -> int:
    """Numeric severity for gauges (0 ok / 1 burning / 2 exhausted)."""
    return _SEVERITY.get(state, 0)


@dataclass(frozen=True)
class BurnSample:
    """One cumulative observation: by time `at`, `total` events had
    happened, `bad` of them out of objective."""

    at: float
    total: float
    bad: float


class BurnAccountant:
    """Burn-rate evaluation over a cumulative (total, bad) stream.

    Observations are CUMULATIVE totals (monotone non-decreasing), so
    feeding histogram snapshot counts needs no per-interval diffing by
    the caller — the accountant diffs against the sample just outside
    each trailing window.  Not thread-safe by itself; the controller
    serializes access.
    """

    def __init__(self, budget: float, fast_s: float, slow_s: float):
        if fast_s > slow_s:
            fast_s, slow_s = slow_s, fast_s
        self.budget = max(float(budget), 1e-9)
        self.fast_s = float(fast_s)
        self.slow_s = float(slow_s)
        self._samples: List[BurnSample] = []

    def observe(self, now: float, total: float, bad: float) -> None:
        """Record cumulative totals as of `now`.  A stream that moves
        backwards (registry reset between ticks) restarts the window."""
        if self._samples and (
            total < self._samples[-1].total or bad < self._samples[-1].bad
        ):
            self._samples = []
        self._samples.append(BurnSample(now, float(total), float(bad)))
        # keep exactly one sample older than the slow window so the
        # window delta always has a baseline to diff against
        horizon = now - self.slow_s
        while len(self._samples) >= 2 and self._samples[1].at <= horizon:
            self._samples.pop(0)

    def _window_delta(self, now: float, window_s: float) -> Tuple[float, float]:
        """(events, bad events) inside the trailing window."""
        if not self._samples:
            return 0.0, 0.0
        latest = self._samples[-1]
        cutoff = now - window_s
        base: Optional[BurnSample] = None
        for s in self._samples:
            if s.at <= cutoff:
                base = s
            else:
                break
        if base is None:
            # stream younger than the window: everything seen counts
            return latest.total, latest.bad
        return latest.total - base.total, latest.bad - base.bad

    def bad_fraction(self, now: float, window_s: float) -> float:
        total, bad = self._window_delta(now, window_s)
        if total <= 0:
            return 0.0
        return min(1.0, max(0.0, bad / total))

    def burn_rate(self, now: float, window_s: float) -> float:
        return self.bad_fraction(now, window_s) / self.budget

    def burn_rates(self, now: float) -> Tuple[float, float]:
        """(fast, slow) burn rates."""
        return (
            self.burn_rate(now, self.fast_s),
            self.burn_rate(now, self.slow_s),
        )

    def budget_remaining(self, now: float) -> float:
        """Fraction of the slow window's error budget left, in [0, 1]."""
        return min(1.0, max(0.0, 1.0 - self.burn_rate(now, self.slow_s)))


class Hysteresis:
    """The ok -> burning -> exhausted state machine: eager entry, held
    exit (see module docstring).  Pure function of the fed rate stream
    and the injected clock, so tests can pin exact entry/exit instants.
    """

    def __init__(
        self,
        enter_burn: float = 2.0,
        exit_burn: float = 1.0,
        hold_s: float = 60.0,
    ):
        self.enter_burn = float(enter_burn)
        self.exit_burn = float(exit_burn)
        self.hold_s = float(hold_s)
        self.state = OK
        self.since: Optional[float] = None  # when `state` was entered
        self._clear_since: Optional[float] = None
        self.transitions = 0

    def _move(self, now: float, state: str) -> None:
        if state != self.state:
            self.state = state
            self.since = now
            self.transitions += 1

    def update(
        self, now: float, fast_burn: float, slow_burn: float, remaining: float
    ) -> str:
        """Advance the machine; returns the (possibly new) state."""
        if remaining <= 0.0:
            self._clear_since = None
            self._move(now, EXHAUSTED)
            return self.state
        if fast_burn >= self.enter_burn:
            self._clear_since = None
            if _SEVERITY[self.state] < _SEVERITY[BURNING]:
                self._move(now, BURNING)
            return self.state
        # below the enter threshold: exit only after a continuous hold
        # below the EXIT threshold (the gap between the two thresholds
        # plus the hold is the anti-flap margin)
        if fast_burn < self.exit_burn and slow_burn < self.exit_burn:
            if self._clear_since is None:
                self._clear_since = now
            if now - self._clear_since >= self.hold_s:
                self._move(now, OK)
        else:
            self._clear_since = None
        return self.state
