"""The Netpol builder DSL (reference: generator/netpol.go): a symmetric
Target/Ingress/Egress view of NetworkPolicy plus functional setters over a
base test policy."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from ..kube.netpol import (
    LabelSelector,
    LabelSelectorRequirement,
    NetworkPolicy,
    NetworkPolicyEgressRule,
    NetworkPolicyIngressRule,
    NetworkPolicyPeer,
    NetworkPolicyPort,
    NetworkPolicySpec,
    OP_IN,
    POLICY_TYPE_EGRESS,
    POLICY_TYPE_INGRESS,
)
from .constants import (
    allow_dns_rule,
    NS_XY_MATCH_EXPRESSIONS_SELECTOR,
    NS_YZ_MATCH_EXPRESSIONS_SELECTOR,
    POD_AB_MATCH_EXPRESSIONS_SELECTOR,
    POD_BC_MATCH_EXPRESSIONS_SELECTOR,
    PORT80,
    TCP,
)


@dataclass
class Rule:
    """netpol.go:105-108: ports x peers, direction-agnostic."""

    ports: List[NetworkPolicyPort] = field(default_factory=list)
    peers: List[NetworkPolicyPeer] = field(default_factory=list)

    def ingress(self) -> NetworkPolicyIngressRule:
        return NetworkPolicyIngressRule(ports=list(self.ports), from_=list(self.peers))

    def egress(self) -> NetworkPolicyEgressRule:
        return NetworkPolicyEgressRule(ports=list(self.ports), to=list(self.peers))


@dataclass
class NetpolTarget:
    namespace: str
    pod_selector: LabelSelector

    @staticmethod
    def make(
        namespace: str,
        match_labels: Optional[Dict[str, str]] = None,
        match_expressions: Optional[List[LabelSelectorRequirement]] = None,
    ) -> "NetpolTarget":
        return NetpolTarget(
            namespace=namespace,
            pod_selector=LabelSelector.make(match_labels, match_expressions),
        )


@dataclass
class NetpolPeers:
    rules: List[Rule] = field(default_factory=list)


@dataclass
class Netpol:
    """netpol.go:11-17.  ingress/egress None means that PolicyType is
    absent; an empty rules list means deny-all in that direction."""

    name: str
    target: NetpolTarget
    ingress: Optional[NetpolPeers] = None
    egress: Optional[NetpolPeers] = None
    description: str = ""

    @staticmethod
    def from_network_policy(policy: NetworkPolicy) -> "Netpol":
        """netpol.go:19-43 (both directions always present in this view)."""
        return Netpol(
            name=policy.namespace,
            description="generated from NetworkPolicy",
            target=NetpolTarget(
                namespace=policy.namespace, pod_selector=policy.spec.pod_selector
            ),
            ingress=NetpolPeers(
                rules=[Rule(ports=r.ports, peers=r.from_) for r in policy.spec.ingress]
            ),
            egress=NetpolPeers(
                rules=[Rule(ports=r.ports, peers=r.to) for r in policy.spec.egress]
            ),
        )

    def network_policy(self) -> NetworkPolicy:
        """netpol.go:45-84; raises on 0 policy types."""
        types: List[str] = []
        ingress: List[NetworkPolicyIngressRule] = []
        egress: List[NetworkPolicyEgressRule] = []
        if self.ingress is not None:
            types.append(POLICY_TYPE_INGRESS)
            ingress = [r.ingress() for r in self.ingress.rules]
        if self.egress is not None:
            types.append(POLICY_TYPE_EGRESS)
            egress = [r.egress() for r in self.egress.rules]
        if not types:
            raise ValueError("cannot have 0 policy types")
        return NetworkPolicy(
            name=self.name,
            namespace=self.target.namespace,
            spec=NetworkPolicySpec(
                pod_selector=self.target.pod_selector,
                policy_types=types,
                ingress=ingress,
                egress=egress,
            ),
        )


Setter = Callable[[Netpol], None]


def set_description(description: str) -> Setter:
    def s(policy: Netpol) -> None:
        policy.description = description

    return s


def set_namespace(ns: str) -> Setter:
    def s(policy: Netpol) -> None:
        policy.target.namespace = ns

    return s


def set_pod_selector(selector: LabelSelector) -> Setter:
    def s(policy: Netpol) -> None:
        policy.target.pod_selector = selector

    return s


def set_rules(is_ingress: bool, rules: List[Rule]) -> Setter:
    def s(policy: Netpol) -> None:
        if is_ingress:
            policy.ingress.rules = rules
        else:
            policy.egress.rules = rules

    return s


def set_ports(is_ingress: bool, ports: List[NetworkPolicyPort]) -> Setter:
    def s(policy: Netpol) -> None:
        if is_ingress:
            policy.ingress.rules[0].ports = ports
        else:
            policy.egress.rules[0].ports = ports

    return s


def set_peers(is_ingress: bool, peers: List[NetworkPolicyPeer]) -> Setter:
    def s(policy: Netpol) -> None:
        if is_ingress:
            policy.ingress.rules[0].peers = peers
        else:
            policy.egress.rules[0].peers = peers

    return s


def base_test_policy() -> Netpol:
    """netpol.go:195-226: target x/pod:a; ingress TCP:80 from pods b,c in
    ns x,y; egress TCP:80 to pods a,b in ns y,z + AllowDNS."""
    return Netpol(
        name="base",
        target=NetpolTarget(
            namespace="x",
            pod_selector=LabelSelector.make(match_labels={"pod": "a"}),
        ),
        ingress=NetpolPeers(
            rules=[
                Rule(
                    ports=[NetworkPolicyPort(protocol=TCP, port=PORT80)],
                    peers=[
                        NetworkPolicyPeer(
                            pod_selector=POD_BC_MATCH_EXPRESSIONS_SELECTOR,
                            namespace_selector=NS_XY_MATCH_EXPRESSIONS_SELECTOR,
                        )
                    ],
                )
            ]
        ),
        egress=NetpolPeers(
            rules=[
                Rule(
                    ports=[NetworkPolicyPort(protocol=TCP, port=PORT80)],
                    peers=[
                        NetworkPolicyPeer(
                            pod_selector=POD_AB_MATCH_EXPRESSIONS_SELECTOR,
                            namespace_selector=NS_YZ_MATCH_EXPRESSIONS_SELECTOR,
                        )
                    ],
                ),
                allow_dns_rule(),
            ]
        ),
    )


def build_policy(*setters: Setter) -> Netpol:
    """netpol.go:187-193."""
    policy = base_test_policy()
    for setter in setters:
        setter(policy)
    return policy
