"""The scalar oracle over a whole grid: Policy.is_traffic_allowed (or the
tiered lattice's TieredPolicy.is_traffic_allowed) for every (port case,
src pod, dst pod), in the engine's GridVerdict layout.  The engine's
truth tables are held against it cell by cell."""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np

from .matcher.core import InternalPeer, Policy, Traffic, TrafficPeer
from .matcher.tiered import TieredPolicy

# (namespace, name, labels, ip) — the engine's pod tuple format
PodTuple = Tuple[str, str, Dict[str, str], str]


def traffic_for_cell(
    pods: Sequence[PodTuple],
    namespaces: Dict[str, Dict[str, str]],
    case,
    src_idx: int,
    dst_idx: int,
) -> Traffic:
    """The oracle Traffic for grid cell (case, src pod, dst pod)."""

    def peer(i: int) -> TrafficPeer:
        ns, _name, labels, ip = pods[i]
        return TrafficPeer(
            internal=InternalPeer(
                pod_labels=labels,
                namespace_labels=namespaces.get(ns, {}),
                namespace=ns,
            ),
            ip=ip,
        )

    return Traffic(
        source=peer(src_idx),
        destination=peer(dst_idx),
        resolved_port=case.port,
        resolved_port_name=case.port_name,
        protocol=case.protocol,
    )


def oracle_grid(
    policy: Policy,
    pods: Sequence[PodTuple],
    namespaces: Dict[str, Dict[str, str]],
    cases: Sequence,
    tiers=None,
) -> Dict[str, np.ndarray]:
    """{ingress [Q, N_dst, N_src], egress [Q, N_src, N_dst], combined
    [Q, N_src, N_dst]} bool from the scalar oracle — the GridVerdict
    layout.  With `tiers` (a TierSet) the oracle is the precedence-tier
    lattice (matcher/tiered.TieredPolicy) over `policy`."""
    if tiers:
        tiered = TieredPolicy(policy, tiers)
        verdicts = tiered.is_traffic_allowed
    else:

        def verdicts(traffic):
            r = policy.is_traffic_allowed(traffic)
            return r.ingress.is_allowed, r.egress.is_allowed, r.is_allowed

    n, q = len(pods), len(cases)
    ingress = np.zeros((q, n, n), dtype=bool)
    egress = np.zeros((q, n, n), dtype=bool)
    combined = np.zeros((q, n, n), dtype=bool)
    for qi, case in enumerate(cases):
        for s in range(n):
            for d in range(n):
                i, e, c = verdicts(traffic_for_cell(pods, namespaces, case, s, d))
                ingress[qi, d, s] = i
                egress[qi, s, d] = e
                combined[qi, s, d] = c
    return {"ingress": ingress, "egress": egress, "combined": combined}
