"""Simulated-vs-kube comparison tables (reference:
connectivity/comparisontable.go)."""

from __future__ import annotations

from typing import Dict, List

from ..probe.table import Item as ProbeItem, Table
from ..probe.truthtable import TruthTable

Comparison = str
COMPARISON_SAME: Comparison = "same"
COMPARISON_DIFFERENT: Comparison = "different"
COMPARISON_IGNORED: Comparison = "ignored"


def comparison_short_string(c: Comparison) -> str:
    return {COMPARISON_SAME: ".", COMPARISON_DIFFERENT: "X", COMPARISON_IGNORED: "?"}[c]


class ComparisonItem:
    """comparisontable.go:9-36."""

    def __init__(self, kube: ProbeItem, simulated: ProbeItem):
        self.kube = kube
        self.simulated = simulated

    def results_by_protocol(self) -> Dict[bool, Dict[str, int]]:
        counts: Dict[bool, Dict[str, int]] = {True: {}, False: {}}
        for key, kr in self.kube.job_results.items():
            same = kr.combined == self.simulated.job_results[key].combined
            proto = kr.job.protocol
            counts[same][proto] = counts[same].get(proto, 0) + 1
        return counts

    def is_success(self) -> bool:
        left, right = self.kube.job_results, self.simulated.job_results
        if len(left) != len(right):
            return False
        for k, lv in left.items():
            if k not in right or right[k].combined != lv.combined:
                return False
        return True


class ComparisonTable:
    def __init__(self, items: List[str]):
        self.wrapped = TruthTable.from_items(items, None)

    @staticmethod
    def from_probes(kube_probe: Table, simulated_probe: Table) -> "ComparisonTable":
        """Strict dimension/key equality (comparisontable.go:46-67)."""
        kf, sf = kube_probe.wrapped.froms, simulated_probe.wrapped.froms
        kt, st = kube_probe.wrapped.tos, simulated_probe.wrapped.tos
        if len(kf) != len(sf) or len(kt) != len(st):
            raise ValueError("cannot compare tables of different dimensions")
        for i, fr in enumerate(kf):
            if sf[i] != fr:
                raise ValueError(
                    f"cannot compare: from keys at index {i} do not match "
                    f"({sf[i]} vs {fr})"
                )
        for i, to in enumerate(kt):
            if st[i] != to:
                raise ValueError(
                    f"cannot compare: to keys at index {i} do not match "
                    f"({st[i]} vs {to})"
                )
        table = ComparisonTable(kf)
        for fr, to in kube_probe.wrapped.keys():
            table.wrapped.set(
                fr,
                to,
                ComparisonItem(
                    kube=kube_probe.get(fr, to), simulated=simulated_probe.get(fr, to)
                ),
            )
        return table

    def get(self, from_: str, to: str) -> ComparisonItem:
        return self.wrapped.get(from_, to)  # type: ignore

    def results_by_protocol(self) -> Dict[bool, Dict[str, int]]:
        counts: Dict[bool, Dict[str, int]] = {True: {}, False: {}}
        for fr, to in self.wrapped.keys():
            for same, proto_counts in self.get(fr, to).results_by_protocol().items():
                for proto, count in proto_counts.items():
                    counts[same][proto] = counts[same].get(proto, 0) + count
        return counts

    def value_counts_by_protocol(
        self, ignore_loopback: bool
    ) -> Dict[str, Dict[Comparison, int]]:
        counts: Dict[str, Dict[Comparison, int]] = {
            "TCP": {},
            "SCTP": {},
            "UDP": {},
        }
        for fr, to in self.wrapped.keys():
            for same, proto_counts in self.get(fr, to).results_by_protocol().items():
                if ignore_loopback and fr == to:
                    c = COMPARISON_IGNORED
                elif same:
                    c = COMPARISON_SAME
                else:
                    c = COMPARISON_DIFFERENT
                for proto, count in proto_counts.items():
                    counts.setdefault(proto, {})
                    counts[proto][c] = counts[proto].get(c, 0) + count
        return counts

    def value_counts(self, ignore_loopback: bool) -> Dict[Comparison, int]:
        counts: Dict[Comparison, int] = {
            COMPARISON_SAME: 0,
            COMPARISON_DIFFERENT: 0,
            COMPARISON_IGNORED: 0,
        }
        for fr, to in self.wrapped.keys():
            if ignore_loopback and fr == to:
                counts[COMPARISON_IGNORED] += 1
            elif self.get(fr, to).is_success():
                counts[COMPARISON_SAME] += 1
            else:
                counts[COMPARISON_DIFFERENT] += 1
        return counts

    def render_success_table(self) -> str:
        return self.wrapped.render(
            "",
            False,
            lambda fr, to, item: "." if item.is_success() else "X",
        )
