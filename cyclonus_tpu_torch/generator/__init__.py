"""Conformance test-case generation (reference: pkg/generator): the
TestCase/TestStep/Action DSL, the Netpol builder, the two-level tag
taxonomy, the feature traverser, and the 8 case families (golden counts:
target 6, rules 4, peers 112, port/protocol 58, example 1, action 6,
conflict 16, upstream-e2e 13 = 216)."""

from .actions import (
    Action,
    create_policy,
    update_policy,
    delete_policy,
    create_namespace,
    set_namespace_labels,
    delete_namespace,
    read_network_policies,
    create_pod,
    set_pod_labels,
    delete_pod,
)
from .testcase import TestCase, TestStep, new_single_step_test_case
from .netpol_builder import (
    Netpol,
    NetpolTarget,
    NetpolPeers,
    Rule,
    build_policy,
    base_test_policy,
    set_namespace,
    set_pod_selector,
    set_rules,
    set_ports,
    set_peers,
)
from .tags import (
    ALL_TAGS,
    TAG_SET,
    StringSet,
    count_test_cases_by_tag,
    validate_tags,
)
from .generator import TestCaseGenerator

__all__ = [
    "Action",
    "create_policy",
    "update_policy",
    "delete_policy",
    "create_namespace",
    "set_namespace_labels",
    "delete_namespace",
    "read_network_policies",
    "create_pod",
    "set_pod_labels",
    "delete_pod",
    "TestCase",
    "TestStep",
    "new_single_step_test_case",
    "Netpol",
    "NetpolTarget",
    "NetpolPeers",
    "Rule",
    "build_policy",
    "base_test_policy",
    "set_namespace",
    "set_pod_selector",
    "set_rules",
    "set_ports",
    "set_peers",
    "ALL_TAGS",
    "TAG_SET",
    "StringSet",
    "count_test_cases_by_tag",
    "validate_tags",
    "TestCaseGenerator",
]
