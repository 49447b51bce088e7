"""Matcher canonicalization algebra (reference: pkg/matcher/simplifier.go).

Buckets matchers by variant, merges duplicates by primary key (port-union),
and subtracts all-peers ports out of ip/pod matchers.  Known reference gap
preserved: subtract_port_matchers doesn't handle "all but" cases
(simplifier.go:151-153)."""

from __future__ import annotations

from typing import List, Optional, Tuple

from .core import (
    ALL_PEERS_PORTS,
    AllPeersMatcher,
    AllPortMatcher,
    IPPeerMatcher,
    PeerMatcher,
    PodPeerMatcher,
    PortMatcher,
    PortsForAllPeersMatcher,
    SpecificPortMatcher,
)


def simplify(matchers: List[PeerMatcher]) -> List[PeerMatcher]:
    """simplifier.go:8-34."""
    matches_all = False
    ports_for_all: List[PortsForAllPeersMatcher] = []
    ips: List[IPPeerMatcher] = []
    pods: List[PodPeerMatcher] = []
    for m in matchers:
        if isinstance(m, AllPeersMatcher):
            matches_all = True
        elif isinstance(m, PortsForAllPeersMatcher):
            ports_for_all.append(m)
        elif isinstance(m, IPPeerMatcher):
            ips.append(m)
        elif isinstance(m, PodPeerMatcher):
            pods.append(m)
        else:
            raise TypeError(f"invalid matcher type {type(m)}")
    all_matcher = _simplify_ports_for_all_peers(ports_for_all)
    ips = _simplify_ip_matchers(ips)
    pods = _simplify_pod_matchers(pods)
    if all_matcher is not None:
        ips, pods = _simplify_ips_and_pods_into_alls(all_matcher, ips, pods)
    return _generate_simplified_matchers(matches_all, all_matcher, ips, pods)


def _simplify_ports_for_all_peers(
    matchers: List[PortsForAllPeersMatcher],
) -> Optional[PortsForAllPeersMatcher]:
    """simplifier.go:36-45: merge by port union."""
    if not matchers:
        return None
    port = matchers[0].port
    for m in matchers[1:]:
        port = combine_port_matchers(port, m.port)
    return PortsForAllPeersMatcher(port=port)


def _simplify_pod_matchers(pms: List[PodPeerMatcher]) -> List[PodPeerMatcher]:
    """simplifier.go:47-65: group by primary key, union ports, sort."""
    grouped = {}
    for pm in pms:
        key = pm.primary_key()
        if key not in grouped:
            grouped[key] = pm
        else:
            grouped[key] = combine_pod_peer_matchers(grouped[key], pm)
    return sorted(grouped.values(), key=lambda p: p.primary_key())


def _simplify_ip_matchers(ims: List[IPPeerMatcher]) -> List[IPPeerMatcher]:
    """simplifier.go:67-85."""
    grouped = {}
    for im in ims:
        key = im.primary_key()
        if key not in grouped:
            grouped[key] = im
        else:
            grouped[key] = combine_ip_peer_matchers(grouped[key], im)
    return sorted(grouped.values(), key=lambda p: p.primary_key())


def _simplify_ips_and_pods_into_alls(
    all_matcher: PortsForAllPeersMatcher,
    ips: List[IPPeerMatcher],
    pods: List[PodPeerMatcher],
) -> Tuple[List[IPPeerMatcher], List[PodPeerMatcher]]:
    """simplifier.go:87-114: drop ip/pod ports already covered by the
    all-peers matcher."""
    new_ips: List[IPPeerMatcher] = []
    for ip in ips:
        is_empty, remaining = subtract_port_matchers(ip.port, all_matcher.port)
        if not is_empty:
            new_ips.append(IPPeerMatcher(ip_block=ip.ip_block, port=remaining))
    new_pods: List[PodPeerMatcher] = []
    for pod in pods:
        is_empty, remaining = subtract_port_matchers(pod.port, all_matcher.port)
        if not is_empty:
            new_pods.append(
                PodPeerMatcher(namespace=pod.namespace, pod=pod.pod, port=remaining)
            )
    return new_ips, new_pods


def _generate_simplified_matchers(
    matches_all: bool,
    ports_for_all: Optional[PortsForAllPeersMatcher],
    ips: List[IPPeerMatcher],
    pods: List[PodPeerMatcher],
) -> List[PeerMatcher]:
    """simplifier.go:116-131: AllPeers collapses everything to one matcher."""
    if matches_all:
        return [ALL_PEERS_PORTS]
    matchers: List[PeerMatcher] = []
    if ports_for_all is not None:
        matchers.append(ports_for_all)
    matchers.extend(ips)
    matchers.extend(pods)
    return matchers


def combine_port_matchers(a: PortMatcher, b: PortMatcher) -> PortMatcher:
    """simplifier.go:133-149: All wins; Specific+Specific unions."""
    if isinstance(a, AllPortMatcher):
        return a
    if isinstance(a, SpecificPortMatcher):
        if isinstance(b, AllPortMatcher):
            return b
        if isinstance(b, SpecificPortMatcher):
            return a.combine(b)
        raise TypeError(f"invalid Port type {type(b)}")
    raise TypeError(f"invalid Port type {type(a)}")


def subtract_port_matchers(
    a: PortMatcher, b: PortMatcher
) -> Tuple[bool, Optional[PortMatcher]]:
    """Ports in a but not b (simplifier.go:151-177).  Returns (is_empty,
    rest).  Reference wart: doesn't handle "all but" cases."""
    if isinstance(a, AllPortMatcher):
        if isinstance(b, AllPortMatcher):
            return True, None
        if isinstance(b, SpecificPortMatcher):
            return False, a
        raise TypeError(f"invalid Port type {type(b)}")
    if isinstance(a, SpecificPortMatcher):
        if isinstance(b, AllPortMatcher):
            return True, None
        if isinstance(b, SpecificPortMatcher):
            return a.subtract(b)
        raise TypeError(f"invalid Port type {type(b)}")
    raise TypeError(f"invalid Port type {type(a)}")


def combine_pod_peer_matchers(a: PodPeerMatcher, b: PodPeerMatcher) -> PodPeerMatcher:
    """simplifier.go:179-188."""
    if a.primary_key() != b.primary_key():
        raise ValueError(
            f"cannot combine PodPeerMatchers of different pks: "
            f"{a.primary_key()} vs. {b.primary_key()}"
        )
    return PodPeerMatcher(
        namespace=a.namespace,
        pod=a.pod,
        port=combine_port_matchers(a.port, b.port),
    )


def combine_ip_peer_matchers(a: IPPeerMatcher, b: IPPeerMatcher) -> IPPeerMatcher:
    """simplifier.go:190-198."""
    if a.primary_key() != b.primary_key():
        raise ValueError(
            f"unable to combine IPPeerMatcher values with different primary "
            f"keys: {a.primary_key()} vs {b.primary_key()}"
        )
    return IPPeerMatcher(
        ip_block=a.ip_block,
        port=combine_port_matchers(a.port, b.port),
    )
