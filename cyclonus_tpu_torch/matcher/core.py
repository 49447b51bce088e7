"""Matcher IR and scalar evaluation — the parity oracle.

Faithful to the reference semantics:
  * Policy.is_traffic_allowed (policy.go:131-174): per direction —
      1. external target => allow (we can't stop external hosts)
      2. no matching target => allow
      3. otherwise allowed iff >= 1 matching target allows
  * Target.allows = OR over peer matchers (target.go:29-36)
  * PodPeerMatcher: external peer => false (podpeermatcher.go:21-28)
  * IPPeerMatcher: matches only by IP, internal or external
    (ippeermatcher.go:43-50)
  * Port matching incl. named ports and ranges (portmatcher.go)

Known reference warts preserved on purpose (they are behavior to match):
  * SpecificPortMatcher.subtract ignores port ranges (portmatcher.go:132-134)
  * named-port protocol interactions follow portmatcher.go:34-39 exactly
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..kube.labels import (
    is_labels_match_label_selector,
    serialize_label_selector,
)
from ..kube.ipaddr import is_ip_address_match_for_ip_block
from ..kube.netpol import IPBlock, IntOrString, LabelSelector, NetworkPolicy


# ---------------------------------------------------------------------------
# Traffic (reference: traffic.go)
# ---------------------------------------------------------------------------


@dataclass
class InternalPeer:
    """traffic.go:74-81."""

    pod_labels: Dict[str, str] = field(default_factory=dict)
    namespace_labels: Dict[str, str] = field(default_factory=dict)
    namespace: str = ""


@dataclass
class TrafficPeer:
    """traffic.go:58-72.  internal None => external to the cluster."""

    internal: Optional[InternalPeer] = None
    ip: str = ""

    @property
    def is_external(self) -> bool:
        return self.internal is None

    def namespace(self) -> str:
        return "" if self.internal is None else self.internal.namespace


@dataclass
class Traffic:
    """traffic.go:10-17."""

    source: TrafficPeer
    destination: TrafficPeer
    resolved_port: int = 0
    resolved_port_name: str = ""
    protocol: str = "TCP"

    @staticmethod
    def from_dict(d: dict) -> "Traffic":
        def peer(pd: dict) -> TrafficPeer:
            # NB: a present-but-empty internal dict is still an internal peer;
            # only an absent/null key means external.
            internal = pd.get("internal", pd.get("Internal"))
            ip = pd.get("ip") or pd.get("IP") or ""
            if internal is None:
                return TrafficPeer(internal=None, ip=ip)
            return TrafficPeer(
                internal=InternalPeer(
                    pod_labels=internal.get("podLabels")
                    or internal.get("PodLabels")
                    or {},
                    namespace_labels=internal.get("namespaceLabels")
                    or internal.get("NamespaceLabels")
                    or {},
                    namespace=internal.get("namespace")
                    or internal.get("Namespace")
                    or "",
                ),
                ip=ip,
            )

        return Traffic(
            source=peer(d.get("source") or d.get("Source") or {}),
            destination=peer(d.get("destination") or d.get("Destination") or {}),
            resolved_port=d.get("resolvedPort", d.get("ResolvedPort", 0)),
            resolved_port_name=d.get("resolvedPortName", d.get("ResolvedPortName", "")),
            protocol=d.get("protocol", d.get("Protocol", "TCP")),
        )


# ---------------------------------------------------------------------------
# Port matchers (reference: portmatcher.go)
# ---------------------------------------------------------------------------


class PortMatcher:
    def allows(self, port_int: int, port_name: str, protocol: str) -> bool:
        raise NotImplementedError

    def to_dict(self) -> dict:
        raise NotImplementedError


class AllPortMatcher(PortMatcher):
    def allows(self, port_int: int, port_name: str, protocol: str) -> bool:
        return True

    def to_dict(self) -> dict:
        return {"Type": "all ports"}


@dataclass
class PortProtocolMatcher:
    """portmatcher.go:26-39: port None => all ports on the protocol; port may
    be numeric or named."""

    port: Optional[IntOrString]
    protocol: str

    def allows_port_protocol(self, port_int: int, port_name: str, protocol: str) -> bool:
        if self.port is not None:
            return (
                _is_port_match(self.port, port_int, port_name)
                and self.protocol == protocol
            )
        return self.protocol == protocol

    def equals(self, other: "PortProtocolMatcher") -> bool:
        if self.protocol != other.protocol:
            return False
        if self.port is None and other.port is None:
            return True
        if (self.port is None) != (other.port is None):
            return False
        return self.port == other.port

    def to_dict(self) -> dict:
        return {
            "Port": None if self.port is None else self.port.value,
            "Protocol": self.protocol,
        }


@dataclass
class PortRangeMatcher:
    """portmatcher.go:54-63: inclusive [from, to] numeric range."""

    from_port: int
    to_port: int
    protocol: str

    def allows_port_protocol(self, port_int: int, protocol: str) -> bool:
        return (
            self.from_port <= port_int <= self.to_port and self.protocol == protocol
        )

    def to_dict(self) -> dict:
        return {
            "Type": "port range",
            "From": self.from_port,
            "To": self.to_port,
            "Protocol": self.protocol,
        }


class SpecificPortMatcher(PortMatcher):
    """portmatcher.go:74-92: OR over explicit ports and ranges."""

    def __init__(
        self,
        ports: Optional[List[PortProtocolMatcher]] = None,
        port_ranges: Optional[List[PortRangeMatcher]] = None,
    ):
        self.ports: List[PortProtocolMatcher] = ports or []
        self.port_ranges: List[PortRangeMatcher] = port_ranges or []

    def allows(self, port_int: int, port_name: str, protocol: str) -> bool:
        for m in self.ports:
            if m.allows_port_protocol(port_int, port_name, protocol):
                return True
        for r in self.port_ranges:
            if r.allows_port_protocol(port_int, protocol):
                return True
        return False

    def combine(self, other: "SpecificPortMatcher") -> "SpecificPortMatcher":
        """Union + deterministic sort (portmatcher.go:102-130).  Ranges are
        concatenated without compaction (reference TODO :125).

        The reference's dedup loop is buggy and the bug is replicated here on
        purpose (oracle parity): per portmatcher.go:104-111, for each of
        other's ports Go iterates the snapshot of pps, appending the new port
        at EVERY non-equal element until an equal one breaks the loop — so
        when self.ports is empty, other's ports are dropped entirely, and
        otherwise duplicates accumulate."""
        pps = list(self.ports)
        for other_pp in other.ports:
            snapshot = len(pps)
            for i in range(snapshot):
                if pps[i].equals(other_pp):
                    break
                pps.append(other_pp)
        pps.sort(key=_port_protocol_sort_key)
        ranges = self.port_ranges + other.port_ranges
        return SpecificPortMatcher(ports=pps, port_ranges=ranges)

    def subtract(
        self, other: "SpecificPortMatcher"
    ) -> Tuple[bool, Optional["SpecificPortMatcher"]]:
        """Ports in self but not other; ranges are NOT subtracted — reference
        wart preserved (portmatcher.go:132-134).  Returns (is_empty, rest)."""
        remaining_ranges = list(self.port_ranges)
        remaining = [
            p for p in self.ports if not any(p.equals(o) for o in other.ports)
        ]
        if not remaining_ranges and not remaining:
            return True, None
        return False, SpecificPortMatcher(ports=remaining, port_ranges=remaining_ranges)

    def to_dict(self) -> dict:
        return {
            "Type": "specific ports",
            "Ports": [p.to_dict() for p in self.ports],
            "PortRanges": [r.to_dict() for r in self.port_ranges],
        }


def _is_port_match(a: IntOrString, port_int: int, port_name: str) -> bool:
    """portmatcher.go:190-199."""
    if a.is_int:
        return a.int_value == port_int
    return a.str_value == port_name


def _port_protocol_sort_key(p: PortProtocolMatcher):
    """Order: nil < string < int, then by value, then protocol
    (portmatcher.go:112-123, 155-188)."""
    if p.port is None:
        return (0, "", 0, p.protocol)
    if p.port.is_string:
        return (1, p.port.str_value, 0, p.protocol)
    return (2, "", p.port.int_value, p.protocol)


# ---------------------------------------------------------------------------
# Pod / namespace matchers (reference: podpeermatcher.go)
# ---------------------------------------------------------------------------


class PodMatcher:
    def allows(self, pod_labels: Dict[str, str]) -> bool:
        raise NotImplementedError

    def primary_key(self) -> str:
        raise NotImplementedError


class AllPodMatcher(PodMatcher):
    def allows(self, pod_labels: Dict[str, str]) -> bool:
        return True

    def primary_key(self) -> str:
        return '{"type": "all-pods"}'

    def to_dict(self) -> dict:
        return {"Type": "all pods"}


@dataclass
class LabelSelectorPodMatcher(PodMatcher):
    selector: LabelSelector

    def allows(self, pod_labels: Dict[str, str]) -> bool:
        return is_labels_match_label_selector(pod_labels, self.selector)

    def primary_key(self) -> str:
        return json.dumps(
            {"type": "label-selector", "selector": serialize_label_selector(self.selector)}
        )

    def to_dict(self) -> dict:
        return {"Type": "matching pods by label", "Selector": self.selector.to_dict()}


class NamespaceMatcher:
    def allows(self, namespace: str, namespace_labels: Dict[str, str]) -> bool:
        raise NotImplementedError

    def primary_key(self) -> str:
        raise NotImplementedError


@dataclass
class ExactNamespaceMatcher(NamespaceMatcher):
    namespace: str

    def allows(self, namespace: str, namespace_labels: Dict[str, str]) -> bool:
        return self.namespace == namespace

    def primary_key(self) -> str:
        return json.dumps({"type": "exact-namespace", "namespace": self.namespace})

    def to_dict(self) -> dict:
        return {"Type": "specific namespace", "Namespace": self.namespace}


@dataclass
class LabelSelectorNamespaceMatcher(NamespaceMatcher):
    selector: LabelSelector

    def allows(self, namespace: str, namespace_labels: Dict[str, str]) -> bool:
        return is_labels_match_label_selector(namespace_labels, self.selector)

    def primary_key(self) -> str:
        return json.dumps(
            {"type": "label-selector", "selector": serialize_label_selector(self.selector)}
        )

    def to_dict(self) -> dict:
        return {
            "Type": "matching namespace by label",
            "Selector": self.selector.to_dict(),
        }


class AllNamespaceMatcher(NamespaceMatcher):
    def allows(self, namespace: str, namespace_labels: Dict[str, str]) -> bool:
        return True

    def primary_key(self) -> str:
        return '{"type": "all-namespaces"}'

    def to_dict(self) -> dict:
        return {"Type": "all namespaces"}


# ---------------------------------------------------------------------------
# Peer matchers (reference: peermatcher.go, ippeermatcher.go,
# podpeermatcher.go)
# ---------------------------------------------------------------------------


class PeerMatcher:
    def allows(
        self, peer: TrafficPeer, port_int: int, port_name: str, protocol: str
    ) -> bool:
        raise NotImplementedError


class AllPeersMatcher(PeerMatcher):
    """peermatcher.go:16-20: matches everything."""

    def allows(
        self, peer: TrafficPeer, port_int: int, port_name: str, protocol: str
    ) -> bool:
        return True

    def to_dict(self) -> dict:
        return {"Type": "all peers"}


ALL_PEERS_PORTS = AllPeersMatcher()


@dataclass
class PortsForAllPeersMatcher(PeerMatcher):
    """peermatcher.go:28-34: any peer, specific ports."""

    port: PortMatcher

    def allows(
        self, peer: TrafficPeer, port_int: int, port_name: str, protocol: str
    ) -> bool:
        return self.port.allows(port_int, port_name, protocol)

    def to_dict(self) -> dict:
        return {"Type": "all peers for port", "Port": self.port.to_dict()}


@dataclass
class IPPeerMatcher(PeerMatcher):
    """ippeermatcher.go: matches only on IP (CIDR minus excepts) — internal
    and external peers alike."""

    ip_block: IPBlock
    port: PortMatcher

    def primary_key(self) -> str:
        excepts = sorted(self.ip_block.except_)
        return f"{self.ip_block.cidr}: [{', '.join(excepts)}]"

    def allows(
        self, peer: TrafficPeer, port_int: int, port_name: str, protocol: str
    ) -> bool:
        is_ip_match = is_ip_address_match_for_ip_block(peer.ip, self.ip_block)
        return is_ip_match and self.port.allows(port_int, port_name, protocol)

    def to_dict(self) -> dict:
        return {
            "Type": "IPBlock",
            "CIDR": self.ip_block.cidr,
            "Except": list(self.ip_block.except_),
            "Port": self.port.to_dict(),
        }


@dataclass
class PodPeerMatcher(PeerMatcher):
    """podpeermatcher.go:11-28: namespace AND pod AND port; external peers
    never match."""

    namespace: NamespaceMatcher
    pod: PodMatcher
    port: PortMatcher

    def primary_key(self) -> str:
        return self.namespace.primary_key() + "---" + self.pod.primary_key()

    def allows(
        self, peer: TrafficPeer, port_int: int, port_name: str, protocol: str
    ) -> bool:
        if peer.is_external:
            return False
        return (
            self.namespace.allows(peer.internal.namespace, peer.internal.namespace_labels)
            and self.pod.allows(peer.internal.pod_labels)
            and self.port.allows(port_int, port_name, protocol)
        )

    def to_dict(self) -> dict:
        return {
            "Type": "pod peer",
            "Namespace": self.namespace.to_dict(),
            "Pod": self.pod.to_dict(),
            "Port": self.port.to_dict(),
        }


# ---------------------------------------------------------------------------
# Target (reference: target.go)
# ---------------------------------------------------------------------------


class Target:
    """One (namespace, podSelector) with peers + source-rule provenance."""

    def __init__(
        self,
        namespace: str,
        pod_selector: LabelSelector,
        peers: Optional[List[PeerMatcher]] = None,
        source_rules: Optional[List[NetworkPolicy]] = None,
    ):
        self.namespace = namespace
        self.pod_selector = pod_selector
        self.peers: List[PeerMatcher] = peers or []
        self.source_rules: List[NetworkPolicy] = source_rules or []
        self._primary_key: Optional[str] = None

    def is_match(self, namespace: str, pod_labels: Dict[str, str]) -> bool:
        """target.go:25-27."""
        return self.namespace == namespace and is_labels_match_label_selector(
            pod_labels, self.pod_selector
        )

    def allows(
        self, peer: TrafficPeer, port_int: int, port_name: str, protocol: str
    ) -> bool:
        """OR over peers (target.go:29-36)."""
        for peer_matcher in self.peers:
            if peer_matcher.allows(peer, port_int, port_name, protocol):
                return True
        return False

    def combine(self, other: "Target") -> "Target":
        """target.go:41-54; primary keys must match."""
        if self.get_primary_key() != other.get_primary_key():
            raise ValueError(
                f"cannot combine targets: primary keys differ -- "
                f"'{self.get_primary_key()}' vs '{other.get_primary_key()}'"
            )
        return Target(
            namespace=self.namespace,
            pod_selector=self.pod_selector,
            peers=self.peers + other.peers,
            source_rules=self.source_rules + other.source_rules,
        )

    def get_primary_key(self) -> str:
        """Deterministic (namespace, podSelector) key (target.go:57-62)."""
        if self._primary_key is None:
            self._primary_key = json.dumps(
                {
                    "Namespace": self.namespace,
                    "PodSelector": serialize_label_selector(self.pod_selector),
                }
            )
        return self._primary_key

    def simplify(self) -> None:
        from .simplify import simplify as simplify_peers

        self.peers = simplify_peers(self.peers)

    def source_rule_names(self) -> List[str]:
        return [
            f"{p.effective_namespace()}/{p.name}" for p in self.source_rules
        ]

    def __repr__(self) -> str:
        return f"Target({self.get_primary_key()})"


def combine_targets_ignoring_primary_key(
    namespace: str, pod_selector: LabelSelector, targets: List[Target]
) -> Optional[Target]:
    """target.go:66-81: merge all peers/rules under a new (ns, selector)."""
    if not targets:
        return None
    peers: List[PeerMatcher] = []
    rules: List[NetworkPolicy] = []
    for t in targets:
        peers = peers + t.peers
        rules = rules + t.source_rules
    return Target(
        namespace=namespace, pod_selector=pod_selector, peers=peers, source_rules=rules
    )


# ---------------------------------------------------------------------------
# Policy (reference: policy.go)
# ---------------------------------------------------------------------------


@dataclass
class DirectionResult:
    """policy.go:84-91."""

    allowing_targets: List[Target] = field(default_factory=list)
    denying_targets: List[Target] = field(default_factory=list)

    @property
    def is_allowed(self) -> bool:
        return len(self.allowing_targets) > 0 or len(self.denying_targets) == 0


@dataclass
class AllowedResult:
    """policy.go:93-125."""

    ingress: DirectionResult
    egress: DirectionResult

    @property
    def is_allowed(self) -> bool:
        return self.ingress.is_allowed and self.egress.is_allowed

    def table(self) -> str:
        from ..utils.table import render_table
        from ..kube.labels import label_selector_table_lines

        rows = []
        for direction, result in (("Ingress", self.ingress), ("Egress", self.egress)):
            for action, targets in (
                ("Allow", result.allowing_targets),
                ("Deny", result.denying_targets),
            ):
                for t in targets:
                    rows.append(
                        [
                            direction,
                            action,
                            f"namespace: {t.namespace}\n"
                            + label_selector_table_lines(t.pod_selector),
                        ]
                    )
            if direction == "Ingress":
                rows.append(["", "", ""])
        return render_table(
            ["Type", "Action", "Target"],
            rows,
            footer=["Is allowed?", str(self.is_allowed).lower(), ""],
            row_line=True,
        )


class Policy:
    """Root compiled form: {ingress, egress: map primary-key -> Target}
    (policy.go:12-15).  Targets with the same primary key are combined."""

    def __init__(self):
        self.ingress: Dict[str, Target] = {}
        self.egress: Dict[str, Target] = {}

    @staticmethod
    def from_targets(
        ingress: List[Target], egress: List[Target]
    ) -> "Policy":
        p = Policy()
        p.add_targets(True, ingress)
        p.add_targets(False, egress)
        return p

    def sorted_targets(self) -> Tuple[List[Target], List[Target]]:
        """policy.go:28-43: sorted by primary key."""
        ingress = sorted(self.ingress.values(), key=lambda t: t.get_primary_key())
        egress = sorted(self.egress.values(), key=lambda t: t.get_primary_key())
        return ingress, egress

    def add_targets(self, is_ingress: bool, targets: List[Target]) -> None:
        for t in targets:
            self.add_target(is_ingress, t)

    def add_target(self, is_ingress: bool, target: Target) -> Target:
        """Dedup targets by primary key, combining peers (policy.go:51-66)."""
        pk = target.get_primary_key()
        d = self.ingress if is_ingress else self.egress
        if pk in d:
            d[pk] = d[pk].combine(target)
        else:
            d[pk] = target
        return d[pk]

    def targets_applying_to_pod(
        self, is_ingress: bool, namespace: str, pod_labels: Dict[str, str]
    ) -> List[Target]:
        """policy.go:68-82."""
        d = self.ingress if is_ingress else self.egress
        return [t for t in d.values() if t.is_match(namespace, pod_labels)]

    def is_traffic_allowed(self, traffic: Traffic) -> AllowedResult:
        """policy.go:131-136."""
        return AllowedResult(
            ingress=self.is_ingress_or_egress_allowed(traffic, True),
            egress=self.is_ingress_or_egress_allowed(traffic, False),
        )

    def is_ingress_or_egress_allowed(
        self, traffic: Traffic, is_ingress: bool
    ) -> DirectionResult:
        """The 3-step allow rule (policy.go:138-174)."""
        if is_ingress:
            target_peer, peer = traffic.destination, traffic.source
        else:
            target_peer, peer = traffic.source, traffic.destination

        # 1. target external to cluster => allow (policy.go:149-153)
        if target_peer.internal is None:
            return DirectionResult()

        matching = self.targets_applying_to_pod(
            is_ingress, target_peer.internal.namespace, target_peer.internal.pod_labels
        )

        # 2. no matching targets => automatic allow (policy.go:157-160)
        if not matching:
            return DirectionResult()

        # 3. allowed iff >= 1 matching target allows (policy.go:162-173)
        allowers: List[Target] = []
        deniers: List[Target] = []
        for t in matching:
            if t.allows(
                peer, traffic.resolved_port, traffic.resolved_port_name, traffic.protocol
            ):
                allowers.append(t)
            else:
                deniers.append(t)
        return DirectionResult(allowing_targets=allowers, denying_targets=deniers)

    def simplify(self) -> None:
        for t in self.ingress.values():
            t.simplify()
        for t in self.egress.values():
            t.simplify()
