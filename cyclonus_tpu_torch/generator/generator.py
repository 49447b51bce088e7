"""TestCaseGenerator (reference: generator/testcasegenerator.go)."""

from __future__ import annotations

from typing import List

from . import cases
from .testcase import TestCase


class TestCaseGenerator:
    """testcasegenerator.go:38-84: tag include/exclude filter over all 8
    case families."""

    __test__ = False  # not a pytest class

    def __init__(
        self,
        allow_dns: bool,
        pod_ip: str,
        namespaces: List[str],
        tags: List[str] = (),
        excluded_tags: List[str] = (),
    ):
        self.allow_dns = allow_dns
        self.pod_ip = pod_ip
        self.namespaces = list(namespaces)
        self.tags = list(tags)
        self.excluded_tags = list(excluded_tags)

    def target_test_cases(self) -> List[TestCase]:
        return cases.target_cases(self.namespaces)

    def rules_test_cases(self) -> List[TestCase]:
        return cases.rules_cases()

    def peers_test_cases(self) -> List[TestCase]:
        return cases.peers_cases(self.pod_ip)

    def port_protocol_test_cases(self) -> List[TestCase]:
        return cases.port_protocol_cases()

    def example_test_cases(self) -> List[TestCase]:
        return cases.example_cases()

    def action_test_cases(self) -> List[TestCase]:
        return cases.action_cases()

    def conflict_test_cases(self) -> List[TestCase]:
        return cases.conflict_cases(self.allow_dns)

    def upstream_e2e_test_cases(self) -> List[TestCase]:
        return cases.upstream_e2e_cases()

    def tier_test_cases(self):
        """The ANP/BANP precedence-tier conformance family
        (generator/anp_cases.py TierCase objects).  Differential, not
        kubectl-driven — gated engine-vs-oracle by tiers.fuzz.
        run_conformance (`fuzz --conformance`) — so it rides alongside,
        not inside, the 216 probe-driven cases."""
        from .anp_cases import tier_cases

        return tier_cases()

    def generate_all_test_cases(self) -> List[TestCase]:
        return (
            self.target_test_cases()
            + self.rules_test_cases()
            + self.peers_test_cases()
            + self.port_protocol_test_cases()
            + self.example_test_cases()
            + self.action_test_cases()
            + self.conflict_test_cases()
            + self.upstream_e2e_test_cases()
        )

    def generate_test_cases(self) -> List[TestCase]:
        out = []
        for tc in self.generate_all_test_cases():
            if (
                not self.tags or tc.tags.contains_any(self.tags)
            ) and not tc.tags.contains_any(self.excluded_tags):
                out.append(tc)
        return out
