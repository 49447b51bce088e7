"""Canonical epoch state digests: the string equality that makes two
replicas (or a restarted process) comparable (a copy of the reference's
audit/digest.py).

Two layers, both order-independent and route-independent:

  * state digest — SHA-256 over a CANONICAL JSON rendering of the
    authoritative cluster dicts (pods, namespace labels, NetworkPolicies,
    ANPs, BANP).  Canonicalization rules: every mapping is emitted with
    sorted keys, every policy collection is sorted by its dict key, pods
    flatten to [ns, name, sorted label pairs, ip], and policies render
    through their stable to_dict() forms.  Nothing engine-derived (pack
    plan, class compression, TSS partitions, the device) enters the
    hash — so dense/packed/compressed/TSS routes, a CUDA and a CPU
    replica, and the reference package's service all digest identically
    by construction.
  * row digest — SHA-256 over K sampled truth-table rows evaluated with
    the scalar TieredPolicy oracle on that same state.  The row RNG is
    seeded from the STATE digest (xor the operator seed), never from the
    epoch counter or wall clock, so any two processes holding equal
    state sample — and hash — identical rows.  This is the cheap
    end-to-end semantic check: equal state digests with unequal row
    digests would mean the oracle itself disagrees between builds.

The combined epoch digest is SHA-256 over {state, rows, n_rows}; the
epoch number is carried alongside for display but is NOT hashed (a
restarted replica adopting the same state at a reset epoch counter must
still compare equal).
"""

from __future__ import annotations

import hashlib
import json
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

#: port-case palette the row sampler draws from — fixed, code-declared,
#: covering numbered/named ports across the three protocols the matcher
#: distinguishes.  Changing this palette changes every row digest, so
#: treat it like a schema version.
CASE_PALETTE: Tuple[Tuple[int, str, str], ...] = (
    (80, "", "TCP"),
    (443, "", "TCP"),
    (53, "", "UDP"),
    (8080, "serve", "TCP"),
    (9090, "", "SCTP"),
)


def _canon_labels(labels: Optional[Dict[str, str]]) -> List[List[str]]:
    return [[str(k), str(v)] for k, v in sorted((labels or {}).items())]


def canonical_state(
    pods: Dict[str, Tuple[str, str, Dict[str, str], str]],
    namespaces: Dict[str, Dict[str, str]],
    netpols: Dict[str, Any],
    anps: Dict[str, Any],
    banp: Optional[Any],
) -> Dict[str, Any]:
    """The authoritative dicts as a plain, deterministically ordered
    JSON-able structure (see module docstring for the rules).

    The literal keys below are a coverage contract: statelint ST003
    pins them to the `digest_keys` of every registered StateField in
    serve/stateregistry.py, so a state field added to the service
    cannot silently drop out of replica digest equality."""
    return {
        "pods": [
            [p[0], p[1], _canon_labels(p[2]), p[3]]
            for _, p in sorted(pods.items())
        ],
        "namespaces": [
            [ns, _canon_labels(labels)]
            for ns, labels in sorted(namespaces.items())
        ],
        "netpols": [
            {
                "key": key,
                "name": np.name,
                "namespace": np.effective_namespace(),
                "spec": np.spec.to_dict(),
            }
            for key, np in sorted(netpols.items())
        ],
        "anps": [a.to_dict() for _, a in sorted(anps.items())],
        "banp": banp.to_dict() if banp is not None else None,
    }


def _sha(obj: Any) -> str:
    blob = json.dumps(obj, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode("utf-8")).hexdigest()


def state_digest(canon: Dict[str, Any]) -> str:
    return _sha(canon)


def sampled_rows(
    pods_list: Sequence[Tuple[str, str, Dict[str, str], str]],
    namespaces: Dict[str, Dict[str, str]],
    policy: Any,
    tiers: Optional[Any],
    state_hex: str,
    seed: int,
    n_rows: int,
) -> List[List[Any]]:
    """K truth-table rows, scalar-oracle evaluated: [port, port_name,
    protocol, src "ns/name", dst "ns/name", ingress, egress, combined].
    Pods are addressed through a SORTED key order (never dict insertion
    order) and the RNG seed derives from the state digest, so equal
    state yields equal rows in any process."""
    import random

    from ..oracle import traffic_for_cell
    from ..engine.api import PortCase
    from ..matcher.tiered import TieredPolicy

    if not pods_list or n_rows <= 0:
        return []
    order = sorted(
        range(len(pods_list)),
        key=lambda i: f"{pods_list[i][0]}/{pods_list[i][1]}",
    )
    rng = random.Random(int(state_hex[:16], 16) ^ int(seed))
    oracle = TieredPolicy(policy, tiers) if tiers else None
    rows: List[List[Any]] = []
    for _ in range(int(n_rows)):
        port, name, proto = CASE_PALETTE[rng.randrange(len(CASE_PALETTE))]
        si = order[rng.randrange(len(order))]
        di = order[rng.randrange(len(order))]
        t = traffic_for_cell(
            pods_list, namespaces, PortCase(port, name, proto), si, di
        )
        if oracle is not None:
            want = oracle.is_traffic_allowed(t)
        else:
            r = policy.is_traffic_allowed(t)
            want = (r.ingress.is_allowed, r.egress.is_allowed, r.is_allowed)
        rows.append([
            port, name, proto,
            f"{pods_list[si][0]}/{pods_list[si][1]}",
            f"{pods_list[di][0]}/{pods_list[di][1]}",
            bool(want[0]), bool(want[1]), bool(want[2]),
        ])
    return rows


def epoch_digest(
    epoch: int,
    pods: Dict[str, Tuple[str, str, Dict[str, str], str]],
    namespaces: Dict[str, Dict[str, str]],
    netpols: Dict[str, Any],
    anps: Dict[str, Any],
    banp: Optional[Any],
    policy: Any,
    tiers: Optional[Any],
    *,
    seed: int = 0,
    n_rows: int = 8,
) -> Dict[str, Any]:
    """The full per-epoch digest record exported on /audit and state().
    `digest` is the comparison primitive; `epoch` and `seconds` ride
    along for display and perfobs but are not hashed."""
    t0 = time.perf_counter()
    canon = canonical_state(pods, namespaces, netpols, anps, banp)
    state_hex = state_digest(canon)
    rows = sampled_rows(
        list(pods.values()), namespaces, policy, tiers,
        state_hex, seed, n_rows,
    )
    rows_hex = _sha(rows)
    combined = _sha(
        {"state": state_hex, "rows": rows_hex, "n_rows": len(rows)}
    )
    return {
        "epoch": int(epoch),
        "state": state_hex,
        "rows": rows_hex,
        "n_rows": len(rows),
        "digest": combined,
        "seconds": round(time.perf_counter() - t0, 6),
    }
