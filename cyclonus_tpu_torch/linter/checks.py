"""The 12 lint checks (reference: linter/checks.go): source-level checks on
raw policies + resolved-level checks on the compiled matcher form."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Set

from ..kube.netpol import (
    NetworkPolicy,
    POLICY_TYPE_EGRESS,
    POLICY_TYPE_INGRESS,
)
from ..matcher.builder import build_network_policies
from ..matcher.core import PortsForAllPeersMatcher, Target, TrafficPeer
from ..utils.table import render_table
from ..utils.text import yaml_string

Check = str

# source-level (checks.go:23-34)
CHECK_SOURCE_MISSING_NAMESPACE: Check = "CheckSourceMissingNamespace"
CHECK_SOURCE_PORT_MISSING_PROTOCOL: Check = "CheckSourcePortMissingProtocol"
CHECK_SOURCE_MISSING_POLICY_TYPES: Check = "CheckSourceMissingPolicyTypes"
CHECK_SOURCE_MISSING_POLICY_TYPE_INGRESS: Check = "CheckSourceMissingPolicyTypeIngress"
CHECK_SOURCE_MISSING_POLICY_TYPE_EGRESS: Check = "CheckSourceMissingPolicyTypeEgress"
CHECK_SOURCE_DUPLICATE_POLICY_NAME: Check = "CheckSourceDuplicatePolicyName"

# resolved-level (checks.go:36-41)
CHECK_DNS_BLOCKED_ON_TCP: Check = "CheckDNSBlockedOnTCP"
CHECK_DNS_BLOCKED_ON_UDP: Check = "CheckDNSBlockedOnUDP"
CHECK_TARGET_ALL_INGRESS_BLOCKED: Check = "CheckTargetAllIngressBlocked"
CHECK_TARGET_ALL_EGRESS_BLOCKED: Check = "CheckTargetAllEgressBlocked"
CHECK_TARGET_ALL_INGRESS_ALLOWED: Check = "CheckTargetAllIngressAllowed"
CHECK_TARGET_ALL_EGRESS_ALLOWED: Check = "CheckTargetAllEgressAllowed"


@dataclass
class Warning:
    check: Check
    target: Optional[Target] = None
    source_policy: Optional[NetworkPolicy] = None


def lint(
    kube_policies: List[NetworkPolicy], skip: Optional[Set[Check]] = None
) -> List[Warning]:
    """checks.go:79-92 (NB resolved checks run on the UNsimplified form).

    Divergence from the reference on purpose: the reference builds the
    matcher form FIRST, so a policy with 0 policyTypes panics before the
    CheckSourceMissingPolicyTypes warning can ever be reported
    (builder.go:38-40).  We run source checks first and only compile the
    well-formed policies."""
    skip = skip or set()
    warnings = lint_source_policies(kube_policies)
    well_formed = [p for p in kube_policies if p.spec.policy_types]
    policies = build_network_policies(False, well_formed)
    warnings += lint_resolved_policies(policies)
    return [w for w in warnings if w.check not in skip]


def lint_source_policies(kube_policies: List[NetworkPolicy]) -> List[Warning]:
    """checks.go:94-149."""
    ws: List[Warning] = []
    names: Dict[str, Set[str]] = {}
    for policy in kube_policies:
        ns, name = policy.namespace, policy.name
        names.setdefault(ns, set())
        if name in names[ns]:
            ws.append(
                Warning(check=CHECK_SOURCE_DUPLICATE_POLICY_NAME, source_policy=policy)
            )
        names[ns].add(name)

        if ns == "":
            ws.append(
                Warning(check=CHECK_SOURCE_MISSING_NAMESPACE, source_policy=policy)
            )
        if len(policy.spec.policy_types) == 0:
            ws.append(
                Warning(check=CHECK_SOURCE_MISSING_POLICY_TYPES, source_policy=policy)
            )
        has_ingress = POLICY_TYPE_INGRESS in policy.spec.policy_types
        has_egress = POLICY_TYPE_EGRESS in policy.spec.policy_types
        if policy.spec.ingress and not has_ingress:
            ws.append(
                Warning(
                    check=CHECK_SOURCE_MISSING_POLICY_TYPE_INGRESS,
                    source_policy=policy,
                )
            )
        if policy.spec.egress and not has_egress:
            ws.append(
                Warning(
                    check=CHECK_SOURCE_MISSING_POLICY_TYPE_EGRESS, source_policy=policy
                )
            )
        for rule in policy.spec.ingress:
            ws.extend(_lint_ports(policy, rule.ports))
        for rule in policy.spec.egress:
            ws.extend(_lint_ports(policy, rule.ports))
    return ws


def _lint_ports(policy: NetworkPolicy, ports) -> List[Warning]:
    return [
        Warning(check=CHECK_SOURCE_PORT_MISSING_PROTOCOL, source_policy=policy)
        for port in ports
        if port.protocol is None
    ]


def lint_resolved_policies(policies) -> List[Warning]:
    """checks.go:151-184: DNS probes to 8.8.8.8:53 + all-blocked/allowed
    targets."""
    ws: List[Warning] = []
    external_dns = TrafficPeer(internal=None, ip="8.8.8.8")
    for egress in policies.egress.values():
        if not egress.allows(external_dns, 53, "", "TCP"):
            ws.append(Warning(check=CHECK_DNS_BLOCKED_ON_TCP, target=egress))
        if not egress.allows(external_dns, 53, "", "UDP"):
            ws.append(Warning(check=CHECK_DNS_BLOCKED_ON_UDP, target=egress))
        if len(egress.peers) == 0:
            ws.append(Warning(check=CHECK_TARGET_ALL_EGRESS_BLOCKED, target=egress))
        for peer in egress.peers:
            if isinstance(peer, PortsForAllPeersMatcher):
                ws.append(
                    Warning(check=CHECK_TARGET_ALL_EGRESS_ALLOWED, target=egress)
                )
    for ingress in policies.ingress.values():
        if len(ingress.peers) == 0:
            ws.append(Warning(check=CHECK_TARGET_ALL_INGRESS_BLOCKED, target=ingress))
        for peer in ingress.peers:
            if isinstance(peer, PortsForAllPeersMatcher):
                ws.append(
                    Warning(check=CHECK_TARGET_ALL_INGRESS_ALLOWED, target=ingress)
                )
    return ws


def warnings_table(warnings: List[Warning]) -> str:
    """checks.go:52-77."""
    rows = []
    for w in warnings:
        if w.source_policy is not None:
            p = w.source_policy
            rows.append(["Source", w.check, "", f"{p.namespace}/{p.name}"])
        else:
            t = w.target
            source = "\n".join(t.source_rule_names())
            target = (
                f"namespace: {t.namespace}\n\npod selector:\n"
                f"{yaml_string(t.pod_selector.to_dict())}"
            )
            rows.append(["Resolved", w.check, target, source])
    return render_table(
        ["Source/Resolved", "Type", "Target", "Source Policies"], rows, row_line=True
    )
