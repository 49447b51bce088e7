"""Reduction of a torch.profiler trace of the measured window to what the
per-layer readers need: the device's operations as intervals, the
harness's own host ranges (portbench.window, .apply, .recount, .wait),
the union of device-busy time, and the breakdown of the result line.

Device and host events come from one profiler, on one time base (the
profiler's start), so a device operation is attributed to the host range
it ran in.  The harness synchronises the device at the end of each apply
and each recount, so nothing of one range runs in the next.
"""

from __future__ import annotations

import bisect
import re
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

#: annotation ranges the harness opens; they also appear on the device
#: timeline as user annotations, which are not device work
PREFIX = "portbench."
#: gaps shorter than this are lumped together in the breakdown
SHORT_GAP_S = 20e-6


def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _clip(intervals, lo, hi):
    return [(max(a, lo), min(b, hi)) for a, b in intervals if b > lo and a < hi]


class DeviceTrace:
    """ops: [(name, start_s, end_s)] of device operations (kernels,
    copies, sets), sorted by start; ranges: name -> [(start_s, end_s)] of
    the harness's host ranges; host: [(name, start_s, end_s)] of the
    other host operations (for labelling idle gaps); window: (start_s,
    end_s) of portbench.window."""

    def __init__(self, ops, ranges, host):
        self.ops = sorted(ops, key=lambda o: o[1])
        self.ranges = ranges
        self.host = sorted(host, key=lambda h: h[1])
        self._host_starts = [h[1] for h in self.host]
        self._phases = sorted((a, b, name[len(PREFIX):]) for name, spans in ranges.items()
                              if name != PREFIX + "window" for a, b in spans)
        self._phase_starts = [p[0] for p in self._phases]
        win = ranges.get(PREFIX + "window") or [(0.0, 0.0)]
        self.window = win[0]
        lo, hi = self.window
        self.busy = _merge(_clip([(a, b) for _n, a, b in self.ops], lo, hi))

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy)

    def op_time(self, pattern: str) -> Tuple[float, int]:
        """(seconds, count) of the device operations that start in the
        window and whose name matches the regular expression."""
        rx = re.compile(pattern)
        lo, hi = self.window
        total, n = 0.0, 0
        for name, a, b in self.ops:
            if a >= lo and a < hi and rx.search(name):
                total += b - a
                n += 1
        return total, n

    def in_ranges(self, range_name: str, exclude: Optional[str] = None) -> Tuple[float, int]:
        """(device seconds, ranges) of the device operations that start
        inside the host ranges of that name, without those matching
        `exclude`."""
        rx = re.compile(exclude) if exclude else None
        spans = self.ranges.get(PREFIX + range_name, [])
        starts = [o[1] for o in self.ops]
        total = 0.0
        for lo, hi in spans:
            i = bisect.bisect_left(starts, lo)
            while i < len(self.ops) and self.ops[i][1] < hi:
                name, a, b = self.ops[i]
                if rx is None or not rx.search(name):
                    total += b - a
                i += 1
        return total, len(spans)

    def _host_label(self, t: float) -> str:
        """The innermost host operation running at time t, under the
        harness range that holds it."""
        phase = "loop"
        k = bisect.bisect_right(self._phase_starts, t) - 1
        if k >= 0 and t < self._phases[k][1]:
            phase = self._phases[k][2]
        i = bisect.bisect_right(self._host_starts, t) - 1
        op = None
        for j in range(i, max(i - 256, -1), -1):
            name, a, b = self.host[j]
            if b > t:
                op = name
                break
        return phase if op is None else f"{phase}/{op}"

    def breakdown(self, top: int = 10) -> Dict:
        """{device_ops: [[name, seconds]], idle_gaps: [[host label,
        seconds]]}: the device operations that took most time in the
        window, and the idle time by what the host was doing."""
        by_op: Dict[str, float] = defaultdict(float)
        lo, hi = self.window
        for name, a, b in self.ops:
            if a >= lo and a < hi:
                by_op[name] += b - a
        gaps: Dict[str, float] = defaultdict(float)
        edges = [lo] + [x for iv in self.busy for x in iv] + [hi]
        for k in range(0, len(edges), 2):
            a, b = edges[k], edges[k + 1]
            if b <= a:
                continue
            if b - a < SHORT_GAP_S:
                gaps[f"gaps under {SHORT_GAP_S * 1e6:.0f} us"] += b - a
            else:
                gaps[self._host_label((a + b) / 2)] += b - a

        def best(d):
            return [[k[:120], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]

        return {"device_ops": best(by_op), "idle_gaps": best(gaps)}


def _is_device(evt) -> bool:
    import torch

    return evt.device_type == torch.autograd.DeviceType.CUDA


def reduce(prof) -> DeviceTrace:
    """A DeviceTrace of a finished torch.profiler.profile."""
    ops, host = [], []
    ranges: Dict[str, List[Tuple[float, float]]] = defaultdict(list)
    for e in prof.events():
        a, b = e.time_range.start / 1e6, e.time_range.end / 1e6
        if e.name.startswith(PREFIX):
            if not _is_device(e):
                ranges[e.name].append((a, b))
        elif _is_device(e):
            ops.append((e.name, a, b))
        elif not e.name.startswith(("cuda", "cu")):
            host.append((e.name, a, b))
    for v in ranges.values():
        v.sort()
    return DeviceTrace(ops, dict(ranges), host)
