"""Scalar-oracle cross-checks for the analysis layer (a copy of the
reference package's analysis/oracle.py).

Every audit/diff claim the tensor path produces is re-derived here with
the matcher's line-by-line evaluation (matcher/core.py — the same oracle
the engine parity tests hold the engine to) on a sampled subset of grid
cells.  A mismatch is an internal-consistency failure (an engine or
analysis bug), never a report row: callers raise on it.
"""

from __future__ import annotations

import random
from typing import Dict, List, Sequence, Tuple

from ..engine.api import PortCase
from ..matcher.core import Policy, Target, Traffic
from ..oracle import PodTuple, traffic_for_cell

# (case index, src pod index, dst pod index)
Cell = Tuple[int, int, int]

__all__ = [
    "Cell",
    "PodTuple",
    "check_rule_removal",
    "oracle_verdicts",
    "policy_without_rule",
    "sample_cells",
    "traffic_for_cell",
]


def oracle_verdicts(policy: Policy, traffic: Traffic) -> Tuple[bool, bool, bool]:
    """(ingress, egress, combined) allowed per the scalar matcher."""
    r = policy.is_traffic_allowed(traffic)
    return (r.ingress.is_allowed, r.egress.is_allowed, r.is_allowed)


def policy_without_rule(
    policy: Policy, direction: str, target_idx: int, peer_idx: int
) -> Policy:
    """A copy of the policy set with ONE resolved rule removed: peer
    `peer_idx` of target `target_idx` in the sorted_targets() order of
    `direction`.  The target itself stays (a peer-less target still
    denies), exactly matching the audit's removal semantics."""
    ingress, egress = policy.sorted_targets()
    lists = {"ingress": list(ingress), "egress": list(egress)}
    targets = lists[direction]
    t = targets[target_idx]
    peers = [pm for j, pm in enumerate(t.peers) if j != peer_idx]
    targets[target_idx] = Target(
        namespace=t.namespace,
        pod_selector=t.pod_selector,
        peers=peers,
        source_rules=t.source_rules,
    )
    return Policy.from_targets(lists["ingress"], lists["egress"])


def check_rule_removal(
    policy: Policy,
    modified: Policy,
    direction: str,
    pods: Sequence[PodTuple],
    namespaces: Dict[str, Dict[str, str]],
    cases: Sequence[PortCase],
    cells: Sequence[Cell],
) -> List[Tuple[Cell, bool, bool]]:
    """Oracle-evaluate `cells` under the original and the rule-stripped
    policy set; returns the cells whose DIRECTION verdict changed (empty
    = the dead-rule claim holds on this sample)."""
    is_ingress = direction == "ingress"
    bad = []
    for cell in cells:
        qi, si, di = cell
        t = traffic_for_cell(pods, namespaces, cases[qi], si, di)
        before = policy.is_ingress_or_egress_allowed(t, is_ingress).is_allowed
        after = modified.is_ingress_or_egress_allowed(t, is_ingress).is_allowed
        if before != after:
            bad.append((cell, before, after))
    return bad


def sample_cells(
    n_pods: int, n_cases: int, k: int, rng: random.Random
) -> List[Cell]:
    """k uniformly random grid cells."""
    if n_pods == 0 or n_cases == 0:
        return []
    return [
        (
            rng.randrange(n_cases),
            rng.randrange(n_pods),
            rng.randrange(n_pods),
        )
        for _ in range(k)
    ]
