"""Shared fixtures for the case families (reference: generator/constants.go)."""

from __future__ import annotations

from ..kube.netpol import (
    IntOrString,
    LabelSelector,
    LabelSelectorRequirement,
    NetworkPolicyPort,
    OP_IN,
)
from ..probe.probeconfig import (
    PROBE_MODE_SERVICE_NAME,
    ProbeConfig,
)

TCP = "TCP"
UDP = "UDP"
SCTP = "SCTP"

PORT53 = IntOrString(53)
PORT79 = IntOrString(79)
PORT80 = IntOrString(80)
PORT81 = IntOrString(81)
PORT82 = IntOrString(82)
PORT7981 = IntOrString(7981)

PORT_SERVE_79_TCP = IntOrString("serve-79-tcp")
PORT_SERVE_80_TCP = IntOrString("serve-80-tcp")
PORT_SERVE_81_TCP = IntOrString("serve-81-tcp")
PORT_SERVE_80_UDP = IntOrString("serve-80-udp")
PORT_SERVE_81_UDP = IntOrString("serve-81-udp")
PORT_SERVE_7981_UDP = IntOrString("serve-7981-udp")
PORT_SERVE_80_SCTP = IntOrString("serve-80-sctp")
PORT_SERVE_81_SCTP = IntOrString("serve-81-sctp")


def probe_all_available() -> ProbeConfig:
    return ProbeConfig.all_available_config(PROBE_MODE_SERVICE_NAME)


def probe_port(port: IntOrString, protocol: str) -> ProbeConfig:
    return ProbeConfig.port_protocol_config(port, protocol, PROBE_MODE_SERVICE_NAME)


EMPTY_SELECTOR = LabelSelector.make()
POD_A_MATCH_LABELS_SELECTOR = LabelSelector.make(match_labels={"pod": "a"})
POD_C_MATCH_LABELS_SELECTOR = LabelSelector.make(match_labels={"pod": "c"})
POD_AB_MATCH_EXPRESSIONS_SELECTOR = LabelSelector.make(
    match_expressions=[LabelSelectorRequirement("pod", OP_IN, ("a", "b"))]
)
POD_BC_MATCH_EXPRESSIONS_SELECTOR = LabelSelector.make(
    match_expressions=[LabelSelectorRequirement("pod", OP_IN, ("b", "c"))]
)
NS_X_MATCH_LABELS_SELECTOR = LabelSelector.make(match_labels={"ns": "x"})
NS_XY_MATCH_EXPRESSIONS_SELECTOR = LabelSelector.make(
    match_expressions=[LabelSelectorRequirement("ns", OP_IN, ("x", "y"))]
)
NS_YZ_MATCH_EXPRESSIONS_SELECTOR = LabelSelector.make(
    match_expressions=[LabelSelectorRequirement("ns", OP_IN, ("y", "z"))]
)


def _allow_dns_rule():
    # import here to avoid a module cycle with netpol_builder
    from .netpol_builder import Rule

    return Rule(ports=[NetworkPolicyPort(protocol=UDP, port=PORT53)], peers=[])


def allow_dns_rule():
    """A fresh AllowDNS rule (UDP:53 to all peers, constants.go:53-60)."""
    return _allow_dns_rule()


def allow_dns_policy(source):
    """constants.go:67-73."""
    from .netpol_builder import Netpol, NetpolPeers

    return Netpol(
        name="allow-dns",
        target=source,
        egress=NetpolPeers(rules=[allow_dns_rule()]),
    )


def deny_all_rules():
    return []


def allow_all_rules():
    from .netpol_builder import Rule

    return [Rule()]
