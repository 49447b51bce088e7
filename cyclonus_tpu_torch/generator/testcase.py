"""TestCase / TestStep DSL + per-case feature extraction
(reference: generator/testcase.go)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

from ..kube.netpol import NetworkPolicy
from ..probe.probeconfig import ProbeConfig
from .actions import Action
from .features import (
    ACTION_FEATURE_CREATE_NAMESPACE,
    ACTION_FEATURE_CREATE_POD,
    ACTION_FEATURE_CREATE_POLICY,
    ACTION_FEATURE_DELETE_NAMESPACE,
    ACTION_FEATURE_DELETE_POD,
    ACTION_FEATURE_DELETE_POLICY,
    ACTION_FEATURE_READ_POLICIES,
    ACTION_FEATURE_SET_NAMESPACE_LABELS,
    ACTION_FEATURE_SET_POD_LABELS,
    ACTION_FEATURE_UPDATE_POLICY,
    EGRESS_TRAVERSER,
    GENERAL_TRAVERSER,
    INGRESS_TRAVERSER,
)
from .tags import StringSet


@dataclass
class TestStep:
    __test__ = False  # not a pytest class
    probe: ProbeConfig
    actions: List[Action] = field(default_factory=list)


@dataclass
class TestCase:
    __test__ = False  # not a pytest class
    description: str
    tags: StringSet
    steps: List[TestStep]

    def collect_actions_and_policies(self):
        """testcase.go:39-73."""
        features: Dict[str, bool] = {}
        policies: List[NetworkPolicy] = []
        for step in self.steps:
            for action in step.actions:
                if action.create_policy is not None:
                    features[ACTION_FEATURE_CREATE_POLICY] = True
                    policies.append(action.create_policy.policy)
                elif action.update_policy is not None:
                    features[ACTION_FEATURE_UPDATE_POLICY] = True
                    policies.append(action.update_policy.policy)
                elif action.delete_policy is not None:
                    features[ACTION_FEATURE_DELETE_POLICY] = True
                elif action.create_namespace is not None:
                    features[ACTION_FEATURE_CREATE_NAMESPACE] = True
                elif action.set_namespace_labels is not None:
                    features[ACTION_FEATURE_SET_NAMESPACE_LABELS] = True
                elif action.delete_namespace is not None:
                    features[ACTION_FEATURE_DELETE_NAMESPACE] = True
                elif action.read_network_policies is not None:
                    features[ACTION_FEATURE_READ_POLICIES] = True
                elif action.create_pod is not None:
                    features[ACTION_FEATURE_CREATE_POD] = True
                elif action.set_pod_labels is not None:
                    features[ACTION_FEATURE_SET_POD_LABELS] = True
                elif action.delete_pod is not None:
                    features[ACTION_FEATURE_DELETE_POD] = True
                else:
                    raise ValueError("invalid Action")
        return features, policies

    def get_features(self) -> Dict[str, List[str]]:
        """testcase.go:75-90."""
        from .netpol_builder import Netpol

        action_set, policies = self.collect_actions_and_policies()
        general, ingress, egress = {}, {}, {}
        for policy in policies:
            parsed = Netpol.from_network_policy(policy)
            general.update(GENERAL_TRAVERSER.traverse(parsed))
            ingress.update(INGRESS_TRAVERSER.traverse(parsed))
            egress.update(EGRESS_TRAVERSER.traverse(parsed))
        return {
            "general": sorted(general),
            "ingress": sorted(ingress),
            "egress": sorted(egress),
            "action": sorted(action_set),
        }


def new_single_step_test_case(
    description: str, tags: StringSet, probe: ProbeConfig, *actions: Action
) -> TestCase:
    """testcase.go:18-29: empty description falls back to sorted tags."""
    if not description:
        description = ",".join(tags.keys_sorted())
    return TestCase(
        description=description,
        tags=tags,
        steps=[TestStep(probe=probe, actions=list(actions))],
    )


def new_test_case(description: str, tags: StringSet, *steps: TestStep) -> TestCase:
    return TestCase(description=description, tags=tags, steps=list(steps))
