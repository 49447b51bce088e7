"""Pathological and shared-selector fixtures (reference:
pkg/kube/netpol/pathological.go, basic.go, complicated.go); a copy of
the reference package's kube/pathological.py, fixture for fixture.

These are the edge-case policy shapes the matcher layer must compile
correctly: empty-vs-absent rule lists, every pod/namespace-selector peer
combination, IPBlocks with excepts, and the kitchen-sink "complicated"
policy.  Shipped in the library (not buried in tests) so users porting
reference-based test suites find the same named fixtures.
"""

from __future__ import annotations

from typing import Dict, List

from .netpol import (
    IPBlock,
    IntOrString,
    LabelSelector,
    NetworkPolicy,
    NetworkPolicyEgressRule,
    NetworkPolicyIngressRule,
    NetworkPolicyPeer,
    NetworkPolicyPort,
    NetworkPolicySpec,
)

# --- shared labels / selectors (pathological.go:8-29) ---

LABELS_AB: Dict[str, str] = {"a": "b"}
LABELS_CD: Dict[str, str] = {"b": "d"}  # wart preserved: key is "b", not "c"
LABELS_EF: Dict[str, str] = {"e": "f"}
LABELS_GH: Dict[str, str] = {"g": "g"}  # wart preserved: value is "g", not "h"

SELECTOR_AB = LabelSelector.make(match_labels=LABELS_AB)
SELECTOR_CD = LabelSelector.make(match_labels=LABELS_CD)
SELECTOR_EF = LabelSelector.make(match_labels=LABELS_EF)
SELECTOR_GH = LabelSelector.make(match_labels=LABELS_GH)
SELECTOR_EMPTY = LabelSelector.make()

NAMESPACE = "pathological-namespace"

# --- ipblock fixtures (pathological.go:31-38) ---

IPBLOCK_10_0_0_1_24 = IPBlock.make("10.0.0.1/24", ["10.0.0.2/30"])
IPBLOCK_192_168_242_213_24 = IPBlock.make("192.168.242.213/24")


def _policy(name: str, types: List[str], ingress=None, egress=None) -> NetworkPolicy:
    return NetworkPolicy(
        name=name,
        namespace=NAMESPACE,
        spec=NetworkPolicySpec(
            pod_selector=SELECTOR_EMPTY,
            policy_types=types,
            ingress=ingress or [],
            egress=egress or [],
        ),
    )


# --- allow nothing (deny all; pathological.go:40-113).  The *_EMPTY_RULES
# variants mirror the reference's nil-vs-empty-list pairs; this model does
# not distinguish the two (both compile to deny), so they are equal
# fixtures with the reference's names preserved. ---

ALLOW_NO_INGRESS = _policy("allow-no-ingress", ["Ingress"])
ALLOW_NO_INGRESS_EMPTY_INGRESS = _policy(
    "allow-no-ingress-empty-ingress", ["Ingress"]
)
ALLOW_NO_EGRESS = _policy("allow-no-egress", ["Egress"])
ALLOW_NO_EGRESS_EMPTY_EGRESS = _policy("allow-no-egress-empty-egress", ["Egress"])
ALLOW_NO_INGRESS_ALLOW_NO_EGRESS = _policy(
    "allow-no-ingress-allow-no-egress", ["Egress", "Ingress"]
)
ALLOW_NO_INGRESS_ALLOW_NO_EGRESS_EMPTY = _policy(
    "allow-no-ingress-allow-no-egress-empty-egress-empty-ingress",
    ["Egress", "Ingress"],
)

# --- allow all (pathological.go:115-162) ---

ALLOW_ALL_INGRESS = _policy(
    "allow-all-ingress", ["Ingress"], ingress=[NetworkPolicyIngressRule()]
)
ALLOW_ALL_EGRESS = _policy(
    "allow-all-egress", ["Egress"], egress=[NetworkPolicyEgressRule()]
)
ALLOW_ALL_INGRESS_ALLOW_ALL_EGRESS = _policy(
    "allow-all-ingress-allow-all-egress",
    ["Egress", "Ingress"],
    ingress=[NetworkPolicyIngressRule()],
    egress=[NetworkPolicyEgressRule()],
)

ALL_PATHOLOGICAL_POLICIES: List[NetworkPolicy] = [
    ALLOW_NO_INGRESS,
    ALLOW_NO_INGRESS_EMPTY_INGRESS,
    ALLOW_NO_EGRESS,
    ALLOW_NO_EGRESS_EMPTY_EGRESS,
    ALLOW_NO_INGRESS_ALLOW_NO_EGRESS,
    ALLOW_NO_INGRESS_ALLOW_NO_EGRESS_EMPTY,
    ALLOW_ALL_INGRESS,
    ALLOW_ALL_EGRESS,
    ALLOW_ALL_INGRESS_ALLOW_ALL_EGRESS,
]

# --- peer combination fixtures (pathological.go:164-213): every
# pod-selector x namespace-selector shape, used by builder tests ---

ALLOW_ALL_PODS_IN_POLICY_NAMESPACE_PEER = NetworkPolicyPeer()
ALLOW_ALL_PODS_IN_ALL_NAMESPACES_PEER = NetworkPolicyPeer(
    namespace_selector=SELECTOR_EMPTY
)
ALLOW_ALL_PODS_IN_MATCHING_NAMESPACES_PEER = NetworkPolicyPeer(
    namespace_selector=SELECTOR_AB
)
ALLOW_ALL_PODS_IN_POLICY_NAMESPACE_PEER_EMPTY_POD_SELECTOR = NetworkPolicyPeer(
    pod_selector=SELECTOR_EMPTY
)
ALLOW_ALL_PODS_IN_ALL_NAMESPACES_PEER_EMPTY_POD_SELECTOR = NetworkPolicyPeer(
    pod_selector=SELECTOR_EMPTY, namespace_selector=SELECTOR_EMPTY
)
ALLOW_ALL_PODS_IN_MATCHING_NAMESPACES_PEER_EMPTY_POD_SELECTOR = NetworkPolicyPeer(
    pod_selector=SELECTOR_EMPTY, namespace_selector=SELECTOR_AB
)
ALLOW_MATCHING_PODS_IN_POLICY_NAMESPACE_PEER = NetworkPolicyPeer(
    pod_selector=SELECTOR_CD
)
ALLOW_MATCHING_PODS_IN_ALL_NAMESPACES_PEER = NetworkPolicyPeer(
    pod_selector=SELECTOR_EF, namespace_selector=SELECTOR_EMPTY
)
ALLOW_MATCHING_PODS_IN_MATCHING_NAMESPACES_PEER = NetworkPolicyPeer(
    pod_selector=SELECTOR_GH, namespace_selector=SELECTOR_AB
)
ALLOW_IPBLOCK_PEER = NetworkPolicyPeer(ip_block=IPBLOCK_10_0_0_1_24)

# --- port fixtures (pathological.go:215-225) ---

ALLOW_ALL_PORTS_ON_PROTOCOL = NetworkPolicyPort(protocol="SCTP")
ALLOW_NUMBERED_PORT_ON_PROTOCOL = NetworkPolicyPort(
    protocol="TCP", port=IntOrString(9001)
)
ALLOW_NAMED_PORT_ON_PROTOCOL = NetworkPolicyPort(
    protocol="UDP", port=IntOrString("hello")
)


# --- basic builders (basic.go) ---

def allow_nothing_from(namespace: str, selector: LabelSelector) -> NetworkPolicy:
    return NetworkPolicy(
        name=f"allow-nothing-from-{namespace}",
        namespace=namespace,
        spec=NetworkPolicySpec(pod_selector=selector, policy_types=["Egress"]),
    )


def allow_from_to_ns_labels(
    namespace: str, selector: LabelSelector, ns_labels: Dict[str, str]
) -> NetworkPolicy:
    from .examples import label_string

    return NetworkPolicy(
        name=f"allow-from-{namespace}-to-{label_string(ns_labels)}",
        namespace=namespace,
        spec=NetworkPolicySpec(
            pod_selector=selector,
            policy_types=["Egress"],
            egress=[
                NetworkPolicyEgressRule(
                    to=[
                        NetworkPolicyPeer(
                            namespace_selector=LabelSelector.make(
                                match_labels=ns_labels
                            )
                        )
                    ]
                )
            ],
        ),
    )


def allow_all_ingress_policy(namespace: str) -> NetworkPolicy:
    return NetworkPolicy(
        name=f"allow-all-to-{namespace}",
        namespace=namespace,
        spec=NetworkPolicySpec(
            pod_selector=SELECTOR_EMPTY,
            policy_types=["Ingress"],
            ingress=[NetworkPolicyIngressRule()],
        ),
    )


def allow_all_egress_policy(namespace: str) -> NetworkPolicy:
    return NetworkPolicy(
        name="allow-all",
        namespace=namespace,
        spec=NetworkPolicySpec(
            pod_selector=SELECTOR_EMPTY,
            policy_types=["Egress"],
            egress=[NetworkPolicyEgressRule()],
        ),
    )


# --- the kitchen-sink example (complicated.go) ---

def example_complicated_network_policy() -> NetworkPolicy:
    return NetworkPolicy(
        name="complicated",
        namespace="example-namespace",
        spec=NetworkPolicySpec(
            pod_selector=SELECTOR_EMPTY,
            policy_types=["Ingress"],
            ingress=[
                NetworkPolicyIngressRule(
                    ports=[
                        NetworkPolicyPort(protocol="TCP", port=IntOrString(p))
                        for p in (3333, 4444, 5555)
                    ],
                    from_=[
                        NetworkPolicyPeer(pod_selector=SELECTOR_EMPTY),
                        NetworkPolicyPeer(namespace_selector=SELECTOR_EMPTY),
                        NetworkPolicyPeer(
                            ip_block=IPBlock.make(
                                "10.0.0.0/16",
                                ["10.0.0.0/28", "10.0.0.64/28"],
                            )
                        ),
                    ],
                )
            ],
        ),
    )
