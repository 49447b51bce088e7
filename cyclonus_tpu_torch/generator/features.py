"""Feature extraction over Netpol structure (reference: generator/feature.go):
~40 feature strings powering the per-feature pass/fail report."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

ACTION_FEATURE_CREATE_POLICY = "action: create policy"
ACTION_FEATURE_UPDATE_POLICY = "action: update policy"
ACTION_FEATURE_DELETE_POLICY = "action: delete policy"
ACTION_FEATURE_CREATE_NAMESPACE = "action: create namespace"
ACTION_FEATURE_SET_NAMESPACE_LABELS = "action: set namespace labels"
ACTION_FEATURE_DELETE_NAMESPACE = "action: delete namespace"
ACTION_FEATURE_READ_POLICIES = "action: read policies"
ACTION_FEATURE_CREATE_POD = "action: create pod"
ACTION_FEATURE_SET_POD_LABELS = "action: set pod labels"
ACTION_FEATURE_DELETE_POD = "action: delete pod"

POLICY_FEATURE_INGRESS = "policy with ingress"
POLICY_FEATURE_EGRESS = "policy with egress"
POLICY_FEATURE_INGRESS_AND_EGRESS = "policy with both ingress and egress"

TARGET_FEATURE_SPECIFIC_NAMESPACE = "target: specific namespace"
TARGET_FEATURE_NAMESPACE_EMPTY = "target: empty namespace"
TARGET_FEATURE_POD_SELECTOR_EMPTY = "target: empty pod selector"
TARGET_FEATURE_POD_SELECTOR_MATCH_LABELS = "target: pod selector match labels"
TARGET_FEATURE_POD_SELECTOR_MATCH_EXPRESSIONS = "target: pod selector match expression"

RULE_FEATURE_ALL_PEERS_ALL_PORTS = "all peers on all ports/protocols"
RULE_FEATURE_SLICE_EMPTY = "0 rules"
RULE_FEATURE_SLICE_SIZE_1 = "1 rule"
RULE_FEATURE_SLICE_SIZE_2_PLUS = "2+ rules"

PEER_FEATURE_PORT_SLICE_EMPTY = "0 port/protocols"
PEER_FEATURE_PORT_SLICE_SIZE_1 = "1 port/protocol"
PEER_FEATURE_PORT_SLICE_SIZE_2_PLUS = "2+ port/protocols"
PEER_FEATURE_NUMBERED_PORT = "numbered port"
PEER_FEATURE_NAMED_PORT = "named port"
PEER_FEATURE_NIL_PORT = "nil port"
PEER_FEATURE_NIL_PROTOCOL = "nil protocol"
PEER_FEATURE_TCP_PROTOCOL = "policy on TCP"
PEER_FEATURE_UDP_PROTOCOL = "policy on UDP"
PEER_FEATURE_SCTP_PROTOCOL = "policy on SCTP"

PEER_FEATURE_PEER_SLICE_EMPTY = "0 peers"
PEER_FEATURE_PEER_SLICE_SIZE_1 = "1 peer"
PEER_FEATURE_PEER_SLICE_SIZE_2_PLUS = "2+ peers"
PEER_FEATURE_IPBLOCK_EMPTY_EXCEPT = "IPBlock (no except)"
PEER_FEATURE_IPBLOCK_NONEMPTY_EXCEPT = "IPBlock with except"
PEER_FEATURE_POD_SELECTOR_NIL = "peer pod selector nil"
PEER_FEATURE_POD_SELECTOR_EMPTY = "peer pod selector empty"
PEER_FEATURE_POD_SELECTOR_MATCH_LABELS = "peer pod selector match labels"
PEER_FEATURE_POD_SELECTOR_MATCH_EXPRESSIONS = "peer pod selector match expression"
PEER_FEATURE_NAMESPACE_SELECTOR_NIL = "peer namespace selector nil"
PEER_FEATURE_NAMESPACE_SELECTOR_EMPTY = "peer namespace selector empty"
PEER_FEATURE_NAMESPACE_SELECTOR_MATCH_LABELS = "peer namespace selector match labels"
PEER_FEATURE_NAMESPACE_SELECTOR_MATCH_EXPRESSIONS = (
    "peer namespace selector match expression"
)


def _policy_features(policy, features: Dict[str, bool]) -> None:
    """feature.go:168-182."""
    has_ingress = policy.ingress is not None and len(policy.ingress.rules) > 0
    has_egress = policy.egress is not None and len(policy.egress.rules) > 0
    if has_ingress:
        features[POLICY_FEATURE_INGRESS] = True
    if has_egress:
        features[POLICY_FEATURE_EGRESS] = True
    if has_ingress and has_egress:
        features[POLICY_FEATURE_INGRESS_AND_EGRESS] = True


def _target_features(target, features: Dict[str, bool]) -> None:
    """feature.go:184-201."""
    if target.namespace == "":
        features[TARGET_FEATURE_NAMESPACE_EMPTY] = True
    else:
        features[TARGET_FEATURE_SPECIFIC_NAMESPACE] = True
    selector = target.pod_selector
    if not selector.match_labels_items and not selector.match_expressions:
        features[TARGET_FEATURE_POD_SELECTOR_EMPTY] = True
    if selector.match_labels_items:
        features[TARGET_FEATURE_POD_SELECTOR_MATCH_LABELS] = True
    if selector.match_expressions:
        features[TARGET_FEATURE_POD_SELECTOR_MATCH_EXPRESSIONS] = True


def _rules_features(peers, features: Dict[str, bool]) -> None:
    """feature.go:203-214."""
    n = len(peers.rules)
    if n == 0:
        features[RULE_FEATURE_SLICE_EMPTY] = True
    elif n == 1:
        features[RULE_FEATURE_SLICE_SIZE_1] = True
    else:
        features[RULE_FEATURE_SLICE_SIZE_2_PLUS] = True


def _rule_feature(rule, features: Dict[str, bool]) -> None:
    if len(rule.ports) == 0 and len(rule.peers) == 0:
        features[RULE_FEATURE_ALL_PEERS_ALL_PORTS] = True


def _peers_features(peers_list, features: Dict[str, bool]) -> None:
    n = len(peers_list)
    if n == 0:
        features[PEER_FEATURE_PEER_SLICE_EMPTY] = True
    elif n == 1:
        features[PEER_FEATURE_PEER_SLICE_SIZE_1] = True
    else:
        features[PEER_FEATURE_PEER_SLICE_SIZE_2_PLUS] = True


def _single_peer_feature(peer, features: Dict[str, bool]) -> None:
    """feature.go:233-270."""
    if peer.ip_block is not None:
        if not peer.ip_block.except_:
            features[PEER_FEATURE_IPBLOCK_EMPTY_EXCEPT] = True
        else:
            features[PEER_FEATURE_IPBLOCK_NONEMPTY_EXCEPT] = True
        return
    if peer.pod_selector is not None:
        sel = peer.pod_selector
        if not sel.match_labels_items and not sel.match_expressions:
            features[PEER_FEATURE_POD_SELECTOR_EMPTY] = True
        if sel.match_labels_items:
            features[PEER_FEATURE_POD_SELECTOR_MATCH_LABELS] = True
        if sel.match_expressions:
            features[PEER_FEATURE_POD_SELECTOR_MATCH_EXPRESSIONS] = True
    else:
        features[PEER_FEATURE_POD_SELECTOR_NIL] = True
    if peer.namespace_selector is not None:
        sel = peer.namespace_selector
        if not sel.match_labels_items and not sel.match_expressions:
            features[PEER_FEATURE_NAMESPACE_SELECTOR_EMPTY] = True
        if sel.match_labels_items:
            features[PEER_FEATURE_NAMESPACE_SELECTOR_MATCH_LABELS] = True
        if sel.match_expressions:
            features[PEER_FEATURE_NAMESPACE_SELECTOR_MATCH_EXPRESSIONS] = True
    else:
        features[PEER_FEATURE_NAMESPACE_SELECTOR_NIL] = True


def _ports_features(ports, features: Dict[str, bool]) -> None:
    n = len(ports)
    if n == 0:
        features[PEER_FEATURE_PORT_SLICE_EMPTY] = True
    elif n == 1:
        features[PEER_FEATURE_PORT_SLICE_SIZE_1] = True
    else:
        features[PEER_FEATURE_PORT_SLICE_SIZE_2_PLUS] = True


def _single_port_feature(port, features: Dict[str, bool]) -> None:
    """feature.go:283-308."""
    if port.port is None:
        features[PEER_FEATURE_NIL_PORT] = True
    elif port.port.is_int:
        features[PEER_FEATURE_NUMBERED_PORT] = True
    else:
        features[PEER_FEATURE_NAMED_PORT] = True
    if port.protocol is None:
        features[PEER_FEATURE_NIL_PROTOCOL] = True
    elif port.protocol == "TCP":
        features[PEER_FEATURE_TCP_PROTOCOL] = True
    elif port.protocol == "UDP":
        features[PEER_FEATURE_UDP_PROTOCOL] = True
    elif port.protocol == "SCTP":
        features[PEER_FEATURE_SCTP_PROTOCOL] = True


@dataclass
class NetpolTraverser:
    """feature.go:72-166: a visitor parameterized by hooks; traverse
    returns the feature set."""

    policy: Optional[Callable] = None
    target: Optional[Callable] = None
    direction: Optional[Callable] = None
    rule: Optional[Callable] = None
    peers: Optional[Callable] = None
    peer: Optional[Callable] = None
    ports: Optional[Callable] = None
    port: Optional[Callable] = None
    which: str = "both"  # "ingress" | "egress" | "both"

    def traverse(self, netpol) -> Dict[str, bool]:
        features: Dict[str, bool] = {}
        if self.policy is not None:
            self.policy(netpol, features)
        if self.target is not None:
            self.target(netpol.target, features)
        for is_ingress, peers in ((True, netpol.ingress), (False, netpol.egress)):
            if peers is None:
                continue
            if self.which == "ingress" and not is_ingress:
                continue
            if self.which == "egress" and is_ingress:
                continue
            if self.direction is not None:
                self.direction(peers, features)
            for rule in peers.rules:
                if self.rule is not None:
                    self.rule(rule, features)
                if self.peers is not None:
                    self.peers(rule.peers, features)
                if self.peer is not None:
                    for p in rule.peers:
                        self.peer(p, features)
                if self.ports is not None:
                    self.ports(rule.ports, features)
                if self.port is not None:
                    for p in rule.ports:
                        self.port(p, features)
        return features


GENERAL_TRAVERSER = NetpolTraverser(policy=_policy_features, target=_target_features)

INGRESS_TRAVERSER = NetpolTraverser(
    direction=_rules_features,
    rule=_rule_feature,
    peers=_peers_features,
    peer=_single_peer_feature,
    ports=_ports_features,
    port=_single_port_feature,
    which="ingress",
)

EGRESS_TRAVERSER = NetpolTraverser(
    direction=_rules_features,
    rule=_rule_feature,
    peers=_peers_features,
    peer=_single_peer_feature,
    ports=_ports_features,
    port=_single_port_feature,
    which="egress",
)
