"""Oracle-backed audit of the equivalence-class grid compression (a copy
of the reference package's analysis/classes.py).

The compressed evaluators (engine/api.py) rest on one claim: pods
sharing a class signature (engine/encoding.py compute_pod_classes) are
indistinguishable to every rule, so any two co-classed pods must
receive IDENTICAL scalar-oracle verdicts against every peer — as source
and as destination, for every port case.  This module re-derives that claim with the line-by-line
matcher (the same oracle the parity suites pin against) on a sampled
subset of (class, peer, case) cells, following the package convention:
a violation is an internal-consistency failure (an engine bug), never a
report row — callers raise on it.
"""

from __future__ import annotations

import random
from typing import Dict, Optional, Sequence

import numpy as np

from ..engine.api import PortCase
from ..engine.encoding import PodClasses
from ..matcher.core import Policy
from .oracle import PodTuple, oracle_verdicts, traffic_for_cell


def audit_class_reduction(
    policy: Policy,
    pods: Sequence[PodTuple],
    namespaces: Dict[str, Dict[str, str]],
    cases: Sequence[PortCase],
    classes: PodClasses,
    *,
    max_classes: int = 16,
    peers_per_class: int = 8,
    rng: Optional[random.Random] = None,
    tiers=None,
) -> Dict:
    """Sampled oracle check that the class reduction is sound.

    For up to `max_classes` classes with >= 2 members: pick the
    representative and one other member, and for `peers_per_class`
    sampled peers and every port case, assert the two members' oracle
    verdicts agree in BOTH orientations (member -> peer and
    peer -> member).  Exhaustive when the sample bounds exceed the
    cluster (small-cluster tests).

    Returns {"checked_classes", "checked_cells", "violations", "ok"};
    each violation records (class id, pod a, pod b, peer, case index,
    orientation, verdict a, verdict b).

    `tiers` (an optional tiers.model.TierSet) switches the reference to
    the tiered lattice oracle (matcher/tiered.py): when the audited
    engine carries AdminNetworkPolicy/BANP tiers, co-classed pods must
    be indistinguishable to the FULL lattice, not just the NP tier —
    tier subject/peer selectors live in the same shared selector table
    the class signature packs, so the claim holds by construction, and
    this audit is the oracle-side proof (the pre-tier plain-oracle
    check would silently under-assert on a tiered engine: a latent
    verdict==bool-OR assumption the lattice exposed).
    """
    if tiers:
        from ..matcher.tiered import TieredPolicy

        # compiled ONCE: the lattice oracle re-validates the TierSet and
        # recompiles every rule's port matchers at construction, and
        # this audit calls it per sampled cell
        _tiered = TieredPolicy(policy, tiers)

        def verdicts(pol, t):
            return _tiered.is_traffic_allowed(t)
    else:
        verdicts = oracle_verdicts
    rng = rng or random.Random(0)
    n = len(pods)
    if n != classes.n_pods:
        raise ValueError(
            f"classes cover {classes.n_pods} pods but cluster holds {n}"
        )
    multi = [
        c
        for c in range(classes.n_classes)
        if int(classes.class_size[c]) >= 2
    ]
    if len(multi) > max_classes:
        multi = rng.sample(multi, max_classes)
    violations = []
    checked_cells = 0
    for c in sorted(multi):
        members = np.flatnonzero(classes.class_of_pod == c)
        a = int(members[0])
        b = int(members[1] if len(members) == 2 else rng.choice(members[1:]))
        if n <= peers_per_class:
            peers = list(range(n))
        else:
            peers = sorted(rng.sample(range(n), peers_per_class))
        for qi, case in enumerate(cases):
            for p in peers:
                # as source: a -> p must equal b -> p
                va = verdicts(
                    policy, traffic_for_cell(pods, namespaces, case, a, p)
                )
                vb = verdicts(
                    policy, traffic_for_cell(pods, namespaces, case, b, p)
                )
                checked_cells += 2
                if va != vb:
                    violations.append(
                        {
                            "class": c, "a": a, "b": b, "peer": p,
                            "case": qi, "orientation": "src",
                            "verdict_a": va, "verdict_b": vb,
                        }
                    )
                # as destination: p -> a must equal p -> b
                va = verdicts(
                    policy, traffic_for_cell(pods, namespaces, case, p, a)
                )
                vb = verdicts(
                    policy, traffic_for_cell(pods, namespaces, case, p, b)
                )
                checked_cells += 2
                if va != vb:
                    violations.append(
                        {
                            "class": c, "a": a, "b": b, "peer": p,
                            "case": qi, "orientation": "dst",
                            "verdict_a": va, "verdict_b": vb,
                        }
                    )
    return {
        "checked_classes": len(multi),
        "checked_cells": checked_cells,
        "violations": violations,
        "ok": not violations,
    }
