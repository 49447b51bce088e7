"""Result aggregation: pass/fail per test, step/try, protocol, tag, and
feature (reference: connectivity/result.go)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..generator.testcase import TestCase
from ..probe.resources import Resources
from .comparison import (
    COMPARISON_DIFFERENT,
    COMPARISON_IGNORED,
    COMPARISON_SAME,
)
from .stepresult import StepResult


@dataclass
class Result:
    initial_resources: Optional[Resources]
    test_case: TestCase
    steps: List[StepResult] = field(default_factory=list)
    err: Optional[Exception] = None

    def features(self) -> Dict[str, List[str]]:
        return self.test_case.get_features()

    def passed(self, ignore_loopback: bool) -> bool:
        if self.err is not None:
            return False
        for step in self.steps:
            if (
                step.last_comparison().value_counts(ignore_loopback)[
                    COMPARISON_DIFFERENT
                ]
                > 0
            ):
                return False
        return True


@dataclass
class Summary:
    tests: List[List[str]] = field(default_factory=list)
    passed: int = 0
    failed: int = 0
    protocol_counts: Dict[str, Dict[str, int]] = field(default_factory=dict)
    tag_counts: Dict[str, Dict[str, Dict[bool, int]]] = field(default_factory=dict)
    tag_primary_counts: Dict[str, Dict[bool, int]] = field(default_factory=dict)
    feature_counts: Dict[str, Dict[str, Dict[bool, int]]] = field(default_factory=dict)
    feature_primary_counts: Dict[str, Dict[bool, int]] = field(default_factory=dict)


def _increment(dict_: Dict[str, Dict[bool, int]], keys: List[str], b: bool) -> None:
    for k in keys:
        dict_.setdefault(k, {True: 0, False: 0})
        dict_[k][b] += 1


@dataclass
class CombinedResults:
    results: List[Result] = field(default_factory=list)

    def summary(self, ignore_loopback: bool) -> Summary:
        """result.go:49-136."""
        summary = Summary(
            protocol_counts={
                "TCP": {COMPARISON_SAME: 0, COMPARISON_DIFFERENT: 0},
                "SCTP": {COMPARISON_SAME: 0, COMPARISON_DIFFERENT: 0},
                "UDP": {COMPARISON_SAME: 0, COMPARISON_DIFFERENT: 0},
            }
        )
        for test_number, result in enumerate(self.results):
            passed = result.passed(ignore_loopback)

            for primary, subs in result.features().items():
                summary.feature_counts.setdefault(primary, {})
                _increment(summary.feature_counts[primary], subs, passed)
                _increment(summary.feature_primary_counts, [primary], passed)

            for primary, subs in result.test_case.tags.group_tags().items():
                summary.tag_counts.setdefault(primary, {})
                _increment(summary.tag_counts[primary], subs, passed)
                _increment(summary.tag_primary_counts, [primary], passed)

            if passed:
                summary.passed += 1
            else:
                summary.failed += 1

            summary.tests.append(
                [
                    f"{test_number + 1}: {result.test_case.description}",
                    "passed" if passed else "failed",
                    "", "", "", "", "", "", "",
                ]
            )
            for step_number, step in enumerate(result.steps):
                for try_number in range(len(step.kube_probes)):
                    counts = step.comparison(try_number).value_counts(ignore_loopback)
                    by_proto = step.comparison(try_number).value_counts_by_protocol(
                        ignore_loopback
                    )
                    row = [
                        "",
                        "",
                        f"Step {step_number + 1}, try {try_number + 1}",
                        str(counts[COMPARISON_DIFFERENT]),
                        str(counts[COMPARISON_SAME]),
                        str(counts[COMPARISON_IGNORED]),
                    ]
                    for proto in ("TCP", "SCTP", "UDP"):
                        pc = by_proto.get(proto, {})
                        same = pc.get(COMPARISON_SAME, 0)
                        diff = pc.get(COMPARISON_DIFFERENT, 0)
                        row.append(_protocol_result(same, diff))
                        summary.protocol_counts[proto][COMPARISON_SAME] += same
                        summary.protocol_counts[proto][COMPARISON_DIFFERENT] += diff
                    summary.tests.append(row)
        return summary


def percentage(i: int, total: int) -> float:
    if i + total == 0:
        return 0.0
    import math

    return math.floor(100 * i / total)


def _protocol_result(passed: int, failed: int) -> str:
    total = passed + failed
    if total == 0:
        return "-"
    return f"{passed} / {total} ({percentage(passed, total):.0f}%)"
