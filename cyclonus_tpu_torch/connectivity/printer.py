"""Human output: per-test-case tables + final summary with markdown
pass/fail tables by tag and feature (reference: connectivity/printer.go)."""

from __future__ import annotations

import sys
from typing import Dict, List, Optional, TextIO

from ..generator.testcase import TestStep
from ..kube.yaml_io import policies_to_yaml
from ..matcher.explain import explain_table
from ..utils.table import render_table
from .comparison import (
    COMPARISON_DIFFERENT,
    COMPARISON_IGNORED,
    COMPARISON_SAME,
)
from .result import CombinedResults, Result, Summary, percentage
from .stepresult import StepResult

PASS_SYMBOL = "✅"
FAIL_SYMBOL = "❌"


class Printer:
    def __init__(
        self,
        noisy: bool = False,
        ignore_loopback: bool = False,
        out: Optional[TextIO] = None,
    ):
        self.noisy = noisy
        self.ignore_loopback = ignore_loopback
        self.results: List[Result] = []
        self.out = out or sys.stdout

    def _print(self, text: str = "") -> None:
        print(text, file=self.out)

    # --- per-test-case (printer.go:194-265) ---

    def print_test_case_result(self, result: Result) -> None:
        self.results.append(result)
        if result.err is not None:
            self._print(
                f"test case failed to execute for {result.test_case.description}: "
                f"{result.err}"
            )
            return
        self._print(f"evaluating test case: {result.test_case.description}")
        if len(result.test_case.steps) != len(result.steps):
            raise ValueError(
                f"found {len(result.test_case.steps)} test steps, but "
                f"{len(result.steps)} result steps"
            )
        for i, (step, step_result) in enumerate(
            zip(result.test_case.steps, result.steps)
        ):
            self.print_step(i + 1, step, step_result)
        self._print("\n")

    def print_step(self, i: int, step: TestStep, step_result: StepResult) -> None:
        if step.probe.port_protocol is not None:
            pp = step.probe.port_protocol
            self._print(
                f"step {i} on port {pp.port.value}, protocol {pp.protocol}:"
            )
        else:
            self._print(f"step {i} on all available ports/protocols:")
        self._print(f"Policy explanation:\n{explain_table(step_result.policy)}")
        self._print("\nResults for network policies:")
        if step_result.kube_policies:
            self._print(policies_to_yaml(step_result.kube_policies))
        else:
            self._print("no network policies")

        if not step_result.kube_probes:
            raise ValueError("found 0 KubeResults for step, expected 1 or more")

        comparison = step_result.last_comparison()
        counts = comparison.value_counts(self.ignore_loopback)
        if counts[COMPARISON_DIFFERENT] > 0:
            self._print("Discrepancy found:")
        self._print(
            f"{counts[COMPARISON_DIFFERENT]} wrong, "
            f"{counts[COMPARISON_IGNORED]} ignored, "
            f"{counts[COMPARISON_SAME]} correct"
        )
        if counts[COMPARISON_DIFFERENT] > 0 or self.noisy:
            self._print(
                f"Expected ingress:\n{step_result.simulated_probe.render_ingress()}"
            )
            self._print(
                f"Expected egress:\n{step_result.simulated_probe.render_egress()}"
            )
            self._print(
                f"Expected combined:\n{step_result.simulated_probe.render_table()}"
            )
            for try_i, kube_result in enumerate(step_result.kube_probes):
                self._print(
                    f"kube results, try {try_i}:\n{kube_result.render_table()}"
                )
            self._print(
                f"\nActual vs expected (last round):\n"
                f"{comparison.render_success_table()}"
            )
        else:
            self._print(step_result.last_kube_probe().render_table())

    # --- summary (printer.go:24-100) ---

    def print_summary(self) -> None:
        summary = CombinedResults(results=self.results).summary(self.ignore_loopback)
        self._print("Summary:")
        self._print(
            render_table(
                [
                    "Test",
                    "Result",
                    "Step/Try",
                    "Wrong",
                    "Right",
                    "Ignored",
                    "TCP",
                    "SCTP",
                    "UDP",
                ],
                summary.tests,
                row_line=True,
            )
        )
        for primary, counts in sorted(summary.tag_counts.items()):
            self._print(_pass_fail_table(primary, counts))
        self._print(_protocol_pass_fail_table(summary.protocol_counts))
        self._print(
            "Feature results:\n"
            + markdown_feature_table(
                summary.feature_primary_counts, summary.feature_counts
            )
            + "\n"
        )
        self._print(
            "Tag results:\n"
            + markdown_feature_table(summary.tag_primary_counts, summary.tag_counts)
        )


def markdown_feature_table(
    primary_counts: Dict[str, Dict[bool, int]],
    sub_counts: Dict[str, Dict[str, Dict[bool, int]]],
) -> str:
    """printer.go:68-100: markdown rows with pass-rate + check/cross."""
    lines = ["| Tag | Result |", "| --- | --- |"]
    for primary in sorted(sub_counts):
        pc = primary_counts.get(primary, {})
        lines.append(f"| {primary} | {_md_result(pc.get(True, 0), pc.get(False, 0))} |")
        for sub in sorted(sub_counts[primary]):
            counts = sub_counts[primary][sub]
            lines.append(
                f"| - {sub} | {_md_result(counts.get(True, 0), counts.get(False, 0))} |"
            )
    return "\n".join(lines)


def _md_result(passed: int, failed: int) -> str:
    total = passed + failed
    symbol = PASS_SYMBOL if failed == 0 else FAIL_SYMBOL
    return f"{passed} / {total} = {percentage(passed, total):.0f}% {symbol}"


def _pass_fail_table(caption: str, counts: Dict[str, Dict[bool, int]]) -> str:
    rows = []
    for feature in counts:
        passed = counts[feature].get(True, 0)
        failed = counts[feature].get(False, 0)
        rows.append((feature, passed, failed, percentage(passed, passed + failed)))
    rows.sort(key=lambda r: r[3])
    return f"{caption} counts:\n" + render_table(
        ["Feature", "Passed", "Failed", "Passed %"],
        [[f, str(p), str(fl), f"{pct:.0f}"] for f, p, fl, pct in rows],
    )


def _protocol_pass_fail_table(protocol_counts: Dict[str, Dict[str, int]]) -> str:
    rows = []
    for protocol, counts in protocol_counts.items():
        passed = counts.get(COMPARISON_SAME, 0)
        failed = counts.get(COMPARISON_DIFFERENT, 0)
        rows.append(
            [
                f"probe on {protocol}",
                str(passed),
                str(failed),
                f"{percentage(passed, passed + failed):.0f}",
            ]
        )
    return "Pass/Fail for probes on protocols:\n" + render_table(
        ["Protocol", "Passed", "Failed", "Passed %"], rows
    )
