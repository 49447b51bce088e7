"""Canned example policies (reference: pkg/kube/netpol/policies.go +
kubedocs.go): parameterized builders for ahmetb's public
kubernetes-network-policy-recipes plus the kube-docs accidental-and/or
examples.  Used by `analyze --use-example-policies` and tests."""

from __future__ import annotations

from typing import Dict, List

from .netpol import (
    IntOrString,
    LabelSelector,
    NetworkPolicy,
    NetworkPolicyEgressRule,
    NetworkPolicyIngressRule,
    NetworkPolicyPeer,
    NetworkPolicyPort,
    NetworkPolicySpec,
)


def label_string(labels: Dict[str, str]) -> str:
    """Deterministic key-val1-key2-val2 name chunk (policies.go:17-33)."""
    chunks: List[str] = []
    for key in sorted(labels):
        chunks.extend([key, labels[key]])
    return "-".join(chunks)


def _sel(labels: Dict[str, str]) -> LabelSelector:
    return LabelSelector.make(match_labels=labels)


def _policy(name, ns, pod_selector, types, ingress=None, egress=None):
    return NetworkPolicy(
        name=name,
        namespace=ns,
        spec=NetworkPolicySpec(
            pod_selector=pod_selector,
            policy_types=types,
            ingress=ingress or [],
            egress=egress or [],
        ),
    )


# recipe 01: deny all traffic to an application
def allow_nothing_to(ns: str, to_labels: Dict[str, str]) -> NetworkPolicy:
    return _policy(
        f"allow-nothing-to-{label_string(to_labels)}", ns, _sel(to_labels), ["Ingress"]
    )


def allow_nothing_to_empty_ingress(ns: str, to_labels: Dict[str, str]) -> NetworkPolicy:
    return _policy(
        f"allow-nothing-to-v2-{label_string(to_labels)}", ns, _sel(to_labels), ["Ingress"]
    )


# recipe 02: limit traffic to an application
def allow_from_to(
    ns: str, from_labels: Dict[str, str], to_labels: Dict[str, str]
) -> NetworkPolicy:
    return _policy(
        f"allow-from-{label_string(from_labels)}-to-{label_string(to_labels)}",
        ns,
        _sel(to_labels),
        ["Ingress"],
        ingress=[
            NetworkPolicyIngressRule(
                from_=[NetworkPolicyPeer(pod_selector=_sel(from_labels))]
            )
        ],
    )


# recipe 02a: allow all traffic to an application
def allow_all_to(ns: str, to_labels: Dict[str, str]) -> NetworkPolicy:
    return _policy(
        f"allow-all-to-{label_string(to_labels)}",
        ns,
        _sel(to_labels),
        ["Ingress"],
        ingress=[NetworkPolicyIngressRule()],
    )


# recipe 03: default deny all in namespace
def allow_nothing_to_anything(ns: str) -> NetworkPolicy:
    return _policy("allow-nothing-to-anything", ns, LabelSelector.make(), ["Ingress"])


# recipe 04: deny traffic from other namespaces
def allow_all_within_namespace(ns: str) -> NetworkPolicy:
    return _policy(
        "allow-all-within-namespace",
        ns,
        LabelSelector.make(),
        ["Ingress"],
        ingress=[
            NetworkPolicyIngressRule(
                from_=[NetworkPolicyPeer(pod_selector=LabelSelector.make())]
            )
        ],
    )


# recipe 05 variants: allow from all namespaces
def allow_all_to_version2(ns: str, to_labels: Dict[str, str]) -> NetworkPolicy:
    return _policy(
        f"allow-all-to-version2-{label_string(to_labels)}",
        ns,
        _sel(to_labels),
        ["Ingress"],
        ingress=[
            NetworkPolicyIngressRule(
                from_=[NetworkPolicyPeer(namespace_selector=LabelSelector.make())]
            )
        ],
    )


def allow_all_to_version3(ns: str, to_labels: Dict[str, str]) -> NetworkPolicy:
    return _policy(
        f"allow-all-to-version3-{label_string(to_labels)}",
        ns,
        _sel(to_labels),
        ["Ingress"],
        ingress=[NetworkPolicyIngressRule()],
    )


def allow_all_to_version4(ns: str, to_labels: Dict[str, str]) -> NetworkPolicy:
    return _policy(
        f"allow-all-to-version4-{label_string(to_labels)}",
        ns,
        _sel(to_labels),
        ["Ingress"],
        ingress=[
            NetworkPolicyIngressRule(
                from_=[
                    NetworkPolicyPeer(
                        pod_selector=LabelSelector.make(),
                        namespace_selector=LabelSelector.make(),
                    )
                ]
            )
        ],
    )


# recipe 06: allow traffic from a namespace
def allow_from_namespace_to(
    ns: str, namespace_labels: Dict[str, str], to_labels: Dict[str, str]
) -> NetworkPolicy:
    return _policy(
        f"allow-from-namespace-to-{label_string(to_labels)}",
        ns,
        _sel(to_labels),
        ["Ingress"],
        ingress=[
            NetworkPolicyIngressRule(
                from_=[NetworkPolicyPeer(namespace_selector=_sel(namespace_labels))]
            )
        ],
    )


# recipe 07: allow traffic from some pods in another namespace
def allow_from_different_namespace_with_labels_to(
    ns: str,
    from_labels: Dict[str, str],
    namespace_labels: Dict[str, str],
    to_labels: Dict[str, str],
) -> NetworkPolicy:
    return _policy(
        f"allow-from-namespace-with-labels-{label_string(from_labels)}-to-"
        f"{label_string(to_labels)}",
        ns,
        _sel(to_labels),
        ["Ingress"],
        ingress=[
            NetworkPolicyIngressRule(
                from_=[
                    NetworkPolicyPeer(
                        pod_selector=_sel(from_labels),
                        namespace_selector=_sel(namespace_labels),
                    )
                ]
            )
        ],
    )


# recipe 08: allow external traffic
def allow_from_anywhere(ns: str, to_labels: Dict[str, str]) -> NetworkPolicy:
    return _policy(
        f"allow-from-anywhere-to-{label_string(to_labels)}",
        ns,
        _sel(to_labels),
        ["Ingress"],
        ingress=[NetworkPolicyIngressRule(from_=[])],
    )


# recipe 09: allow traffic only to a port
def allow_specific_port_to(
    ns: str, from_labels: Dict[str, str], to_labels: Dict[str, str], port: int
) -> NetworkPolicy:
    return _policy(
        f"allow-specific-port-from-{label_string(from_labels)}-to-"
        f"{label_string(to_labels)}",
        ns,
        _sel(to_labels),
        ["Ingress"],
        ingress=[
            NetworkPolicyIngressRule(
                ports=[NetworkPolicyPort(port=IntOrString(port))],
                from_=[NetworkPolicyPeer(pod_selector=_sel(from_labels))],
            )
        ],
    )


# recipe 10: allow traffic from multiple sources
def allow_from_multiple_to(
    ns: str, from_labels: List[Dict[str, str]], to_labels: Dict[str, str]
) -> NetworkPolicy:
    return _policy(
        f"allow-from-multiple-to-{label_string(to_labels)}",
        ns,
        _sel(to_labels),
        ["Ingress"],
        ingress=[
            NetworkPolicyIngressRule(
                from_=[
                    NetworkPolicyPeer(pod_selector=_sel(labels))
                    for labels in from_labels
                ]
            )
        ],
    )


# recipe 11: deny egress from an application
def allow_no_egress_from_labels(ns: str, to_labels: Dict[str, str]) -> NetworkPolicy:
    return _policy(
        f"allow-no-egress-from-labels-{label_string(to_labels)}",
        ns,
        _sel(to_labels),
        ["Egress"],
    )


# recipe 11a: allow dns egress
def allow_egress_on_port(ns: str, to_labels: Dict[str, str], port: int) -> NetworkPolicy:
    return _policy(
        f"allow-egress-on-port-{label_string(to_labels)}",
        ns,
        _sel(to_labels),
        ["Egress"],
        egress=[
            NetworkPolicyEgressRule(
                ports=[
                    NetworkPolicyPort(protocol="TCP", port=IntOrString(port)),
                    NetworkPolicyPort(protocol="UDP", port=IntOrString(port)),
                ]
            )
        ],
    )


# recipe 12: deny all egress from a namespace
def allow_no_egress_from_namespace(ns: str) -> NetworkPolicy:
    return _policy(
        "allow-no-egress-from-namespace", ns, LabelSelector.make(), ["Egress"]
    )


# recipe 14: deny external egress
def allow_egress_to_all_namespaces_on_port(
    ns: str, to_labels: Dict[str, str], port: int
) -> NetworkPolicy:
    return _policy(
        f"allow-egress-to-all-namespace-from-{label_string(to_labels)}-on-port-{port}",
        ns,
        _sel(to_labels),
        ["Egress"],
        egress=[
            NetworkPolicyEgressRule(
                ports=[
                    NetworkPolicyPort(protocol="TCP", port=IntOrString(port)),
                    NetworkPolicyPort(protocol="UDP", port=IntOrString(port)),
                ],
                to=[NetworkPolicyPeer(namespace_selector=LabelSelector.make())],
            )
        ],
    )


def allow_no_ingress_nor_egress(ns: str, to_labels: Dict[str, str]) -> NetworkPolicy:
    return _policy("allow-nothing", ns, _sel(to_labels), ["Ingress", "Egress"])


# kube-docs accidental and/or (kubedocs.go)
def accidental_and(
    ns: str,
    target_labels: Dict[str, str],
    ingress_ns_labels: Dict[str, str],
    ingress_pod_labels: Dict[str, str],
) -> NetworkPolicy:
    """ONE peer with both selectors: namespace AND pod must match."""
    return _policy(
        "accidental-and",
        ns,
        _sel(target_labels),
        ["Ingress"],
        ingress=[
            NetworkPolicyIngressRule(
                from_=[
                    NetworkPolicyPeer(
                        namespace_selector=_sel(ingress_ns_labels),
                        pod_selector=_sel(ingress_pod_labels),
                    )
                ]
            )
        ],
    )


def accidental_or(
    ns: str,
    target_labels: Dict[str, str],
    ingress_ns_labels: Dict[str, str],
    ingress_pod_labels: Dict[str, str],
) -> NetworkPolicy:
    """TWO peers: namespace-selector peer OR pod-selector peer."""
    return _policy(
        "accidental-or",
        ns,
        _sel(target_labels),
        ["Ingress"],
        ingress=[
            NetworkPolicyIngressRule(
                from_=[
                    NetworkPolicyPeer(namespace_selector=_sel(ingress_ns_labels)),
                    NetworkPolicyPeer(pod_selector=_sel(ingress_pod_labels)),
                ]
            )
        ],
    )


def all_examples() -> List[NetworkPolicy]:
    """policies.go:699-728."""
    return [
        allow_nothing_to("default", {"app": "web"}),
        allow_nothing_to_empty_ingress("default", {"all": "web"}),
        allow_from_to(
            "default", {"app": "bookstore"}, {"app": "bookstore", "role": "api"}
        ),
        allow_all_to("default", {"app": "web"}),
        allow_nothing_to_anything("default"),
        allow_all_within_namespace("default"),
        accidental_and("default", {"a": "b"}, {"user": "alice"}, {"role": "client"}),
        accidental_or("default", {"a": "b"}, {"user": "alice"}, {"role": "client"}),
        allow_all_to_version2("default", {"app": "web"}),
        allow_all_to_version3("default", {"app": "web"}),
        allow_all_to_version4("default", {"app": "web"}),
        allow_from_namespace_to("default", {"purpose": "production"}, {"app": "web"}),
        allow_from_different_namespace_with_labels_to(
            "default", {"type": "monitoring"}, {"team": "operations"}, {"app": "web"}
        ),
        allow_from_anywhere("default", {"app": "web"}),
        allow_specific_port_to(
            "default", {"role": "monitoring"}, {"app": "apiserver"}, 5000
        ),
        allow_from_multiple_to(
            "default",
            [
                {"app": "bookstore", "role": "search"},
                {"app": "bookstore", "role": "api"},
                {"app": "inventory", "role": "web"},
            ],
            {"app": "bookstore", "role": "db"},
        ),
        allow_no_egress_from_labels("default", {"app": "foo"}),
        allow_egress_on_port("default", {"app": "foo"}, 53),
        allow_no_egress_from_namespace("default"),
        allow_egress_to_all_namespaces_on_port("default", {"app": "foo"}, 53),
        allow_no_ingress_nor_egress("default", {"app": "foo"}),
    ]


def example_cluster():
    """(pods, namespaces): a small cluster that the policies of
    all_examples() select into — pods in "default" carrying the labels
    those policies name, plus production and monitoring namespaces for
    the namespace-selector examples and one unrelated namespace."""
    namespaces = {
        "default": {"ns": "default"},
        "prod": {"ns": "prod", "purpose": "production"},
        "mon": {"ns": "mon", "type": "monitoring"},
        "x": {"ns": "x"},
    }
    labels = [
        ("default", "web", {"app": "web"}),
        ("default", "api", {"app": "bookstore", "role": "api"}),
        ("default", "search", {"app": "bookstore", "role": "search"}),
        ("default", "db", {"app": "bookstore", "role": "db"}),
        ("default", "inventory", {"app": "inventory", "role": "web"}),
        ("default", "apiserver", {"app": "apiserver"}),
        ("default", "foo", {"app": "foo"}),
        ("default", "client", {"role": "client", "user": "alice"}),
        ("default", "ab", {"a": "b", "all": "web"}),
        ("default", "monitor", {"role": "monitoring"}),
        ("prod", "web", {"app": "web"}),
        ("mon", "ops", {"team": "operations"}),
        ("mon", "monitor", {"role": "monitoring"}),
        ("x", "a", {"pod": "a"}),
    ]
    pods = [
        (ns, name, lab, f"10.0.0.{i + 1}") for i, (ns, name, lab) in enumerate(labels)
    ]
    return pods, namespaces
