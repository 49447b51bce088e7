"""NetworkPolicy -> matcher IR compilation (reference: pkg/matcher/builder.go)."""

from __future__ import annotations

from typing import List, Optional, Tuple

from ..kube.labels import is_label_selector_empty
from ..kube.netpol import (
    NetworkPolicy,
    NetworkPolicyPeer,
    NetworkPolicyPort,
    POLICY_TYPE_EGRESS,
    POLICY_TYPE_INGRESS,
    PROTOCOL_TCP,
)
from .core import (
    ALL_PEERS_PORTS,
    AllNamespaceMatcher,
    AllPodMatcher,
    AllPortMatcher,
    ExactNamespaceMatcher,
    IPPeerMatcher,
    LabelSelectorNamespaceMatcher,
    LabelSelectorPodMatcher,
    NamespaceMatcher,
    PeerMatcher,
    PodMatcher,
    PodPeerMatcher,
    Policy,
    PortMatcher,
    PortProtocolMatcher,
    PortRangeMatcher,
    PortsForAllPeersMatcher,
    SpecificPortMatcher,
    Target,
)


def build_network_policies(
    simplify: bool, netpols: List[NetworkPolicy]
) -> Policy:
    """builder.go:11-26."""
    policy = Policy()
    for netpol in netpols:
        ingress, egress = build_target(netpol)
        if ingress is not None:
            policy.add_target(True, ingress)
        if egress is not None:
            policy.add_target(False, egress)
    if simplify:
        policy.simplify()
    return policy


def build_target(netpol: NetworkPolicy) -> Tuple[Optional[Target], Optional[Target]]:
    """Split a policy by PolicyTypes (builder.go:35-61).  At least one policy
    type is required (builder.go:38-40 panics)."""
    if len(netpol.spec.policy_types) == 0:
        raise ValueError("invalid network policy: need at least 1 type")
    policy_namespace = netpol.effective_namespace()
    ingress: Optional[Target] = None
    egress: Optional[Target] = None
    for ptype in netpol.spec.policy_types:
        if ptype == POLICY_TYPE_INGRESS:
            ingress = Target(
                namespace=policy_namespace,
                pod_selector=netpol.spec.pod_selector,
                source_rules=[netpol],
                peers=_build_rules_matchers(
                    policy_namespace,
                    [(r.ports, r.from_) for r in netpol.spec.ingress],
                ),
            )
        elif ptype == POLICY_TYPE_EGRESS:
            egress = Target(
                namespace=policy_namespace,
                pod_selector=netpol.spec.pod_selector,
                source_rules=[netpol],
                peers=_build_rules_matchers(
                    policy_namespace,
                    [(r.ports, r.to) for r in netpol.spec.egress],
                ),
            )
    return ingress, egress


def _build_rules_matchers(policy_namespace, rules) -> List[PeerMatcher]:
    matchers: List[PeerMatcher] = []
    for ports, peers in rules:
        matchers.extend(build_peer_matchers(policy_namespace, ports, peers))
    return matchers


def build_peer_matchers(
    policy_namespace: str,
    np_ports: List[NetworkPolicyPort],
    peers: List[NetworkPolicyPeer],
) -> List[PeerMatcher]:
    """builder.go:79-113: empty ports+peers => AllPeersPorts; empty peers =>
    PortsForAllPeersMatcher; else one matcher per peer."""
    if len(np_ports) == 0 and len(peers) == 0:
        return [ALL_PEERS_PORTS]
    port = build_port_matcher(np_ports)
    if len(peers) == 0:
        return [PortsForAllPeersMatcher(port=port)]

    matchers: List[PeerMatcher] = []
    for peer in peers:
        ip, ns, pod = build_ip_block_namespace_pod_matcher(policy_namespace, peer)
        # invalid netpol guards (builder.go:93-99)
        if ip is None and ns is None and pod is None:
            raise ValueError(
                "invalid NetworkPolicyPeer: all of IPBlock, NamespaceSelector, "
                "and PodSelector are nil"
            )
        if ip is not None and (ns is not None or pod is not None):
            raise ValueError(
                "invalid NetworkPolicyPeer: if NamespaceSelector or PodSelector "
                "is non-nil, IPBlock must be nil"
            )
        if ip is not None:
            ip.port = port
            matchers.append(ip)
        else:
            matchers.append(PodPeerMatcher(namespace=ns, pod=pod, port=port))
    return matchers


def build_ip_block_namespace_pod_matcher(
    policy_namespace: str, peer: NetworkPolicyPeer
) -> Tuple[Optional[IPPeerMatcher], Optional[NamespaceMatcher], Optional[PodMatcher]]:
    """builder.go:115-142: nil podSel => AllPod; nil nsSel => ExactNamespace
    (the policy's); empty nsSel => AllNamespace."""
    if peer.ip_block is not None:
        return (
            IPPeerMatcher(ip_block=peer.ip_block, port=AllPortMatcher()),
            None,
            None,
        )

    pod_sel = peer.pod_selector
    if pod_sel is None or is_label_selector_empty(pod_sel):
        pod_matcher: PodMatcher = AllPodMatcher()
    else:
        pod_matcher = LabelSelectorPodMatcher(selector=pod_sel)

    ns_sel = peer.namespace_selector
    if ns_sel is None:
        ns_matcher: NamespaceMatcher = ExactNamespaceMatcher(namespace=policy_namespace)
    elif is_label_selector_empty(ns_sel):
        ns_matcher = AllNamespaceMatcher()
    else:
        ns_matcher = LabelSelectorNamespaceMatcher(selector=ns_sel)

    return None, ns_matcher, pod_matcher


def build_port_matcher(np_ports: List[NetworkPolicyPort]) -> PortMatcher:
    """builder.go:144-159."""
    if len(np_ports) == 0:
        return AllPortMatcher()
    matcher = SpecificPortMatcher()
    for p in np_ports:
        single, range_ = build_single_port_matcher(p)
        if single is not None:
            matcher.ports.append(single)
        else:
            matcher.port_ranges.append(range_)
    return matcher


def build_single_port_matcher(
    np_port: NetworkPolicyPort,
) -> Tuple[Optional[PortProtocolMatcher], Optional[PortRangeMatcher]]:
    """builder.go:161-187: protocol defaults to TCP; endPort requires a
    numeric start port and end >= start."""
    protocol = np_port.protocol if np_port.protocol is not None else PROTOCOL_TCP
    if np_port.end_port is None:
        return PortProtocolMatcher(port=np_port.port, protocol=protocol), None
    if np_port.port is None:
        raise ValueError("invalid port range: start port is nil")
    if np_port.port.is_string:
        raise ValueError("invalid port range: start port is string")
    if np_port.end_port < np_port.port.int_value:
        raise ValueError("invalid port range: end port < start port")
    return None, PortRangeMatcher(
        from_port=np_port.port.int_value,
        to_port=np_port.end_port,
        protocol=protocol,
    )
