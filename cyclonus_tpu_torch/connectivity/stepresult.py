"""Per-step results with lazy comparison caching (reference:
connectivity/stepresult.go)."""

from __future__ import annotations

from typing import List, Optional

from ..kube.netpol import NetworkPolicy
from ..matcher.core import Policy
from ..probe.table import Table
from .comparison import ComparisonTable


class StepResult:
    def __init__(
        self,
        simulated_probe: Table,
        policy: Policy,
        kube_policies: List[NetworkPolicy],
    ):
        self.simulated_probe = simulated_probe
        self.policy = policy
        self.kube_policies = kube_policies
        self.kube_probes: List[Table] = []
        self._comparisons: List[Optional[ComparisonTable]] = []

    def add_kube_probe(self, kube_probe: Table) -> None:
        self.kube_probes.append(kube_probe)
        self._comparisons.append(None)

    def comparison(self, i: int) -> ComparisonTable:
        if self._comparisons[i] is None:
            self._comparisons[i] = ComparisonTable.from_probes(
                self.kube_probes[i], self.simulated_probe
            )
        return self._comparisons[i]

    def last_comparison(self) -> ComparisonTable:
        return self.comparison(len(self.kube_probes) - 1)

    def last_kube_probe(self) -> Table:
        return self.kube_probes[-1]
