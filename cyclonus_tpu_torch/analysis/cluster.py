"""Self-contained analysis inputs: derive port cases from a compiled
policy set, and synthesize a small representative cluster when the
caller has no pod model (a copy of the reference package's
analysis/cluster.py).

The audit and diff verdicts are defined RELATIVE to a cluster and a
port-case set (like the verdict grid itself); these helpers make the
CLI usable with nothing but policy YAML by generating inputs that
exercise every selector, namespace, IP block, and port the policies
mention — one pod per distinct label shape, one case per distinct port.
"""

from __future__ import annotations

import ipaddress
from typing import Dict, List, Tuple

from ..engine.api import PortCase
from ..kube.ipaddr import cidr_to_base_and_prefix
from ..kube.netpol import (
    OP_EXISTS,
    OP_IN,
    LabelSelector,
)
from ..matcher.core import (
    AllPortMatcher,
    ExactNamespaceMatcher,
    IPPeerMatcher,
    LabelSelectorNamespaceMatcher,
    LabelSelectorPodMatcher,
    PodPeerMatcher,
    Policy,
    SpecificPortMatcher,
)

PodTuple = Tuple[str, str, Dict[str, str], str]

# deliberately-unmatched sentinel: a port no real policy names, so the
# derived case set always probes the "no rule fires" regime too
SENTINEL_PORT = 65432
MAX_DERIVED_CASES = 32


def _case_sort_key(c: PortCase):
    return (c.protocol, c.port_name, c.port)


def derive_port_cases(*policies: Policy) -> List[PortCase]:
    """Distinct port cases covering every port the policy sets mention:
    each numeric port, each named port, each range endpoint plus a
    midpoint — per protocol — plus a TCP baseline (80) and the sentinel
    port.  Deterministically sorted and capped at MAX_DERIVED_CASES
    (baseline and sentinel always survive the cap)."""
    cases = set()
    for policy in policies:
        for targets in (policy.ingress, policy.egress):
            for target in targets.values():
                for peer in target.peers:
                    pm = getattr(peer, "port", None)
                    if pm is None or isinstance(pm, AllPortMatcher):
                        continue
                    if not isinstance(pm, SpecificPortMatcher):
                        continue
                    for pp in pm.ports:
                        if pp.port is None:
                            cases.add(PortCase(80, "", pp.protocol))
                        elif pp.port.is_int:
                            cases.add(PortCase(pp.port.int_value, "", pp.protocol))
                        else:
                            cases.add(PortCase(0, pp.port.str_value, pp.protocol))
                    for r in pm.port_ranges:
                        cases.add(PortCase(r.from_port, "", r.protocol))
                        cases.add(PortCase(r.to_port, "", r.protocol))
                        mid = (r.from_port + r.to_port) // 2
                        cases.add(PortCase(mid, "", r.protocol))
    out = sorted(cases, key=_case_sort_key)[: MAX_DERIVED_CASES - 2]
    for required in (PortCase(80, "", "TCP"), PortCase(SENTINEL_PORT, "", "TCP")):
        if required not in out:
            out.append(required)
    return out


def _selector_label_map(sel: LabelSelector) -> Dict[str, str]:
    """A label map SATISFYING the selector's positive constraints (a pod
    wearing it makes the selector fire; negative operators may still
    veto, which is fine — the synthesized cluster only needs coverage,
    not a satisfiability proof)."""
    labels = dict(sel.match_labels_items)
    for e in sel.match_expressions:
        if e.operator == OP_IN and e.values:
            labels.setdefault(e.key, e.values[0])
        elif e.operator == OP_EXISTS:
            labels.setdefault(e.key, "present")
    return labels


def _ip_in_cidr(cidr: str) -> str:
    """A concrete IPv4 host address inside the CIDR."""
    bp = cidr_to_base_and_prefix(cidr)
    base, prefix = bp
    host = base + 1 if prefix < 32 else base
    return str(ipaddress.IPv4Address(host))


def synthesize_cluster(
    *policies: Policy, max_pods: int = 48
) -> Tuple[List[PodTuple], Dict[str, Dict[str, str]]]:
    """(pods, namespaces) exercising every policy-referenced shape: one
    namespace per target/exact-peer namespace plus one per distinct
    namespace-selector label map, and per namespace one pod per distinct
    pod-selector label map (plus an unlabeled pod); IPv4 IPBlock peers
    get pods at an in-CIDR address and inside the first except block.
    Deterministic and capped at max_pods."""
    ns_names: List[str] = []
    ns_label_maps: List[Dict[str, str]] = []
    pod_label_maps: List[Dict[str, str]] = [{}]
    ip_addrs: List[str] = []

    def _add(lst, item):
        if item not in lst:
            lst.append(item)

    for policy in policies:
        for is_ingress in (True, False):
            targets = policy.ingress if is_ingress else policy.egress
            for target in sorted(targets.values(), key=lambda t: t.get_primary_key()):
                _add(ns_names, target.namespace)
                _add(pod_label_maps, _selector_label_map(target.pod_selector))
                for peer in target.peers:
                    if isinstance(peer, PodPeerMatcher):
                        if isinstance(peer.namespace, ExactNamespaceMatcher):
                            _add(ns_names, peer.namespace.namespace)
                        elif isinstance(
                            peer.namespace, LabelSelectorNamespaceMatcher
                        ):
                            _add(
                                ns_label_maps,
                                _selector_label_map(peer.namespace.selector),
                            )
                        if isinstance(peer.pod, LabelSelectorPodMatcher):
                            _add(
                                pod_label_maps,
                                _selector_label_map(peer.pod.selector),
                            )
                    elif isinstance(peer, IPPeerMatcher):
                        if cidr_to_base_and_prefix(peer.ip_block.cidr) is None:
                            continue  # IPv6: host-path only, skip synthesis
                        _add(ip_addrs, _ip_in_cidr(peer.ip_block.cidr))
                        for ex in peer.ip_block.except_:
                            if cidr_to_base_and_prefix(ex) is not None:
                                _add(ip_addrs, _ip_in_cidr(ex))
                                break

    if not ns_names:
        ns_names.append("default")
    namespaces: Dict[str, Dict[str, str]] = {
        ns: {"kubernetes.io/metadata.name": ns} for ns in ns_names
    }
    for i, labels in enumerate(ns_label_maps):
        name = f"synth-ns-{i}"
        namespaces[name] = dict(
            labels, **{"kubernetes.io/metadata.name": name}
        )

    pods: List[PodTuple] = []
    counter = [0]

    def _next_ip() -> str:
        counter[0] += 1
        c = counter[0]
        return f"10.{(c >> 16) & 255}.{(c >> 8) & 255}.{c & 255}"

    for ns in namespaces:
        for j, labels in enumerate(pod_label_maps):
            if len(pods) >= max_pods:
                break
            pods.append((ns, f"pod-{j}", dict(labels), _next_ip()))
    # IPBlock coverage pods live in the first namespace; IP peers match
    # by address alone, so their namespace/labels are irrelevant
    first_ns = next(iter(namespaces))
    for k, ip in enumerate(ip_addrs):
        if len(pods) >= max_pods:
            break
        pods.append((first_ns, f"ip-pod-{k}", {}, ip))
    return pods, namespaces
