"""Render a compiled Policy as a human-readable table
(reference: pkg/matcher/explain.go)."""

from __future__ import annotations

from typing import List

from ..kube.labels import label_selector_table_lines
from ..utils.table import render_table
from .core import (
    AllNamespaceMatcher,
    AllPeersMatcher,
    AllPodMatcher,
    AllPortMatcher,
    ExactNamespaceMatcher,
    IPPeerMatcher,
    LabelSelectorNamespaceMatcher,
    LabelSelectorPodMatcher,
    PodPeerMatcher,
    Policy,
    PortMatcher,
    PortsForAllPeersMatcher,
    SpecificPortMatcher,
    Target,
)


def port_matcher_table_lines(pm: PortMatcher) -> List[str]:
    """explain.go:108-128."""
    if isinstance(pm, AllPortMatcher):
        return ["all ports, all protocols"]
    if isinstance(pm, SpecificPortMatcher):
        lines = []
        for pp in pm.ports:
            if pp.port is None:
                lines.append(f"all ports on protocol {pp.protocol}")
            else:
                lines.append(f"port {pp.port.value} on protocol {pp.protocol}")
        for pr in pm.port_ranges:
            lines.append(
                f"ports [{pr.from_port}, {pr.to_port}] on protocol {pr.protocol}"
            )
        return lines
    raise TypeError(f"invalid PortMatcher type {type(pm)}")


def _peer_lines(peer) -> List[str]:
    """One [Peer, Port/Protocol] row per matcher (explain.go:56-106)."""
    if isinstance(peer, AllPeersMatcher):
        return ["all pods, all ips", "all ports, all protocols"]
    if isinstance(peer, PortsForAllPeersMatcher):
        return ["all pods, all ips", "\n".join(port_matcher_table_lines(peer.port))]
    if isinstance(peer, IPPeerMatcher):
        peer_str = (
            peer.ip_block.cidr + "\n" + f"except {list(peer.ip_block.except_)}"
        )
        return [peer_str, "\n".join(port_matcher_table_lines(peer.port))]
    if isinstance(peer, PodPeerMatcher):
        ns = peer.namespace
        if isinstance(ns, AllNamespaceMatcher):
            namespaces = "all"
        elif isinstance(ns, LabelSelectorNamespaceMatcher):
            namespaces = label_selector_table_lines(ns.selector)
        elif isinstance(ns, ExactNamespaceMatcher):
            namespaces = ns.namespace
        else:
            raise TypeError(f"invalid NamespaceMatcher type {type(ns)}")
        pod = peer.pod
        if isinstance(pod, AllPodMatcher):
            pods = "all"
        elif isinstance(pod, LabelSelectorPodMatcher):
            pods = label_selector_table_lines(pod.selector)
        else:
            raise TypeError(f"invalid PodMatcher type {type(pod)}")
        return [
            f"namespace: {namespaces}\npods: {pods}",
            "\n".join(port_matcher_table_lines(peer.port)),
        ]
    raise TypeError(f"invalid PeerMatcher type {type(peer)}")


def _targets_table_rows(targets: List[Target], is_ingress: bool) -> List[List[str]]:
    """explain.go:40-76."""
    rule_type = "Ingress" if is_ingress else "Egress"
    rows: List[List[str]] = []
    for target in targets:
        target_str = (
            f"namespace: {target.namespace}\n"
            + label_selector_table_lines(target.pod_selector)
        )
        rules = "\n".join(target.source_rule_names())
        prefix = [rule_type, target_str, rules]
        if not target.peers:
            rows.append(prefix + ["no pods, no ips", "no ports, no protocols"])
        else:
            for peer in target.peers:
                rows.append(prefix + _peer_lines(peer))
    return rows


def explain_table(policy: Policy) -> str:
    """explain.go:20-38."""
    ingresses, egresses = policy.sorted_targets()
    rows = _targets_table_rows(ingresses, True)
    rows.append(["", "", "", "", ""])
    rows.extend(_targets_table_rows(egresses, False))
    return render_table(
        ["Type", "Target", "Source rules", "Peer", "Port/Protocol"],
        rows,
        row_line=True,
    )
