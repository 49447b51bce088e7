"""Policy engine: compile NetworkPolicies into a resolved matcher IR and
evaluate traffic against it (reference: pkg/matcher).

This scalar implementation is THE ORACLE: it reproduces the reference's
decision procedure exactly (policy.go:138-174), warts included, and every engine
result is checked against it for 100% truth-table parity.
"""

from .core import (
    Policy,
    Target,
    Traffic,
    TrafficPeer,
    InternalPeer,
    AllowedResult,
    DirectionResult,
    PeerMatcher,
    AllPeersMatcher,
    PortsForAllPeersMatcher,
    IPPeerMatcher,
    PodPeerMatcher,
    PodMatcher,
    AllPodMatcher,
    LabelSelectorPodMatcher,
    NamespaceMatcher,
    ExactNamespaceMatcher,
    LabelSelectorNamespaceMatcher,
    AllNamespaceMatcher,
    PortMatcher,
    AllPortMatcher,
    SpecificPortMatcher,
    PortProtocolMatcher,
    PortRangeMatcher,
    ALL_PEERS_PORTS,
    combine_targets_ignoring_primary_key,
)
from .builder import (
    build_network_policies,
    build_target,
    build_peer_matchers,
    build_ip_block_namespace_pod_matcher,
    build_port_matcher,
    build_single_port_matcher,
)
from .simplify import (
    simplify,
    combine_port_matchers,
    subtract_port_matchers,
    combine_pod_peer_matchers,
    combine_ip_peer_matchers,
)
from .explain import explain_table

__all__ = [
    "Policy",
    "Target",
    "Traffic",
    "TrafficPeer",
    "InternalPeer",
    "AllowedResult",
    "DirectionResult",
    "PeerMatcher",
    "AllPeersMatcher",
    "PortsForAllPeersMatcher",
    "IPPeerMatcher",
    "PodPeerMatcher",
    "PodMatcher",
    "AllPodMatcher",
    "LabelSelectorPodMatcher",
    "NamespaceMatcher",
    "ExactNamespaceMatcher",
    "LabelSelectorNamespaceMatcher",
    "AllNamespaceMatcher",
    "PortMatcher",
    "AllPortMatcher",
    "SpecificPortMatcher",
    "PortProtocolMatcher",
    "PortRangeMatcher",
    "ALL_PEERS_PORTS",
    "combine_targets_ignoring_primary_key",
    "build_network_policies",
    "build_target",
    "build_peer_matchers",
    "build_ip_block_namespace_pod_matcher",
    "build_port_matcher",
    "build_single_port_matcher",
    "simplify",
    "combine_port_matchers",
    "subtract_port_matchers",
    "combine_pod_peer_matchers",
    "combine_ip_peer_matchers",
    "explain_table",
]
