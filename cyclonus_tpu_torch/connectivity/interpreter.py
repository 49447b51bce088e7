"""The Interpreter: execute a TestCase — optional reset/verify, then per
step: apply actions (dual-write), wait, probe simulated + kube with retries
until comparison is clean (reference: connectivity/interpreter.go)."""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import Optional

from ..generator.testcase import TestCase
from ..kube.ikubernetes import IKubernetes
from ..matcher.builder import build_network_policies
from ..probe.probeconfig import ProbeConfig
from ..probe.resources import Resources
from ..probe.runner import (
    DEFAULT_ENGINE,
    new_kube_batch_runner,
    new_kube_runner,
    new_simulated_runner,
)
from ..telemetry.spans import span
from .comparison import COMPARISON_DIFFERENT
from .result import Result
from .state import TestCaseState
from .stepresult import StepResult

logger = logging.getLogger(__name__)

DEFAULT_WORKERS = 15
DEFAULT_BATCH_WORKERS = 9  # 3 namespaces x 3 pods


@dataclass
class InterpreterConfig:
    """interpreter.go:22-29."""

    reset_cluster_before_test_case: bool = False
    kube_probe_retries: int = 1
    perturbation_wait_seconds: int = 5
    verify_cluster_state_before_test_case: bool = False
    batch_jobs: bool = False
    ignore_loopback: bool = False
    # new vs reference: which simulated engine to use, and the torch
    # device of the "cuda" engine (None = the current CUDA device, which
    # raises without one; "cpu" runs it on the CPU)
    simulated_engine: str = DEFAULT_ENGINE
    pod_wait_timeout_seconds: int = 60
    device: Optional[str] = None


class Interpreter:
    def __init__(
        self,
        kubernetes: IKubernetes,
        resources: Resources,
        config: Optional[InterpreterConfig] = None,
    ):
        config = config or InterpreterConfig()
        self.kubernetes = kubernetes
        self.resources = resources
        self.config = config
        if config.batch_jobs:
            self.kube_runner = new_kube_batch_runner(kubernetes, DEFAULT_BATCH_WORKERS)
        else:
            self.kube_runner = new_kube_runner(kubernetes, DEFAULT_WORKERS)

    def execute_test_case(self, test_case: TestCase) -> Result:
        """interpreter.go:64-135."""
        result = Result(initial_resources=self.resources, test_case=test_case)
        state = TestCaseState(
            kubernetes=self.kubernetes,
            resources=self.resources,
            policies=[],
            pod_wait_timeout_seconds=self.config.pod_wait_timeout_seconds,
        )

        try:
            if self.config.reset_cluster_before_test_case:
                state.reset_cluster_state()
            if self.config.verify_cluster_state_before_test_case:
                state.verify_cluster_state()
        except Exception as e:
            result.err = e
            return result

        with span(
            "interpreter.case",
            description=test_case.description,
            steps=len(test_case.steps),
        ):
            for step_index, step in enumerate(test_case.steps):
                # per-step annotation: on a trace timeline the case span
                # divides into its steps (actions + settle wait + probe),
                # so a 216-case conformance run stays navigable
                with span(
                    "interpreter.step",
                    step=step_index,
                    actions=len(step.actions),
                ):
                    for action_index, action in enumerate(step.actions):
                        try:
                            self._apply_action(state, action)
                        except Exception as e:
                            logger.error(
                                "action failed at step %d, action %d: %s",
                                step_index,
                                action_index,
                                e,
                            )
                            result.err = e
                            return result
                    if self.config.perturbation_wait_seconds > 0:
                        time.sleep(self.config.perturbation_wait_seconds)
                    result.steps.append(self._run_probe(state, step.probe))
        return result

    def _apply_action(self, state: TestCaseState, action) -> None:
        if action.create_policy is not None:
            state.create_policy(action.create_policy.policy)
        elif action.update_policy is not None:
            state.update_policy(action.update_policy.policy)
        elif action.delete_policy is not None:
            state.delete_policy(
                action.delete_policy.namespace, action.delete_policy.name
            )
        elif action.create_namespace is not None:
            state.create_namespace(
                action.create_namespace.namespace, action.create_namespace.labels
            )
        elif action.set_namespace_labels is not None:
            state.set_namespace_labels(
                action.set_namespace_labels.namespace,
                action.set_namespace_labels.labels,
            )
        elif action.delete_namespace is not None:
            state.delete_namespace(action.delete_namespace.namespace)
        elif action.read_network_policies is not None:
            state.read_policies(action.read_network_policies.namespaces)
        elif action.create_pod is not None:
            state.create_pod(
                action.create_pod.namespace,
                action.create_pod.pod,
                action.create_pod.labels,
            )
        elif action.set_pod_labels is not None:
            state.set_pod_labels(
                action.set_pod_labels.namespace,
                action.set_pod_labels.pod,
                action.set_pod_labels.labels,
            )
        elif action.delete_pod is not None:
            state.delete_pod(action.delete_pod.namespace, action.delete_pod.pod)
        else:
            raise ValueError("invalid Action")

    def _run_probe(self, state: TestCaseState, probe_config: ProbeConfig) -> StepResult:
        """interpreter.go:137-160."""
        parsed_policy = build_network_policies(True, state.policies)
        sim_runner = new_simulated_runner(
            parsed_policy, engine=self.config.simulated_engine, device=self.config.device
        )
        with span(
            "interpreter.probe",
            engine=self.config.simulated_engine,
            policies=len(state.policies),
            pods=len(state.resources.pods),
        ) as s:
            step_result = StepResult(
                simulated_probe=sim_runner.run_probe_for_config(
                    probe_config, state.resources
                ),
                policy=parsed_policy,
                kube_policies=list(state.policies),
            )
            for _try in range(self.config.kube_probe_retries + 1):
                step_result.add_kube_probe(
                    self.kube_runner.run_probe_for_config(probe_config, state.resources)
                )
                counts = step_result.last_comparison().value_counts(
                    self.config.ignore_loopback
                )
                if counts[COMPARISON_DIFFERENT] == 0:
                    break
            s.set(kube_tries=len(step_result.kube_probes))
        return step_result
