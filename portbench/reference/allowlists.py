"""The benchmark's egress allowlists, frozen, as plain Kubernetes objects.

One NetworkPolicy (networking.k8s.io/v1) per (namespace, `tier` label
value) of a synthetic cluster (reference/synthetic.py): it selects the
pods of that tier in its namespace, has policyTypes [Egress], and one
egress rule whose `to` holds `per_policy` ipBlocks and no ports.  The
blocks of all the policies are distinct (cidr, excepts) pairs, drawn by a
draw-for-draw copy of the reference project's ipBlock-heavy generator
(bench.cidr_case, the port's synthetic.cidr_cluster) with its address
pool set to the cluster's own pod addresses.  Its families, by draw odds:

  30%  a /32 on one of the pool's /24s (an address near a pod's);
  25%  a /32 anywhere in 10.0.0.0/10;
  25%  a /24 in 10.0.0.0/10;
  12%  a /16 in 10.0.0.0/10 with one /24 except inside it;
   8%  a /12, /14 or /15 written on a 10.x.0.0 address.

A candidate already drawn is drawn again, so a family with few distinct
strings (the last has 192) leaves its share to the others.

Kept here, under the benchmark, so that a change to the program cannot
move the benchmark's inputs.  Nothing in this package imports the
program.
"""

from __future__ import annotations

import random
from typing import Dict, List, Sequence, Tuple

#: (cidr, excepts)
Block = Tuple[str, Tuple[str, ...]]


def draw_blocks(distinct: int, ip_pool: Sequence[str], rng: random.Random) -> List[Block]:
    """`distinct` distinct (cidr, excepts) blocks, in draw order (fewer
    only if 64 x `distinct` draws do not find them)."""
    blocks: List[Block] = []
    seen = set()
    attempts = 0
    while len(blocks) < distinct and attempts < 64 * distinct:
        attempts += 1
        roll = rng.random()
        if roll < 0.30:
            ip = rng.choice(ip_pool)
            a, b, c, _d = ip.split(".")
            cand = (f"{a}.{b}.{c}.{rng.randrange(256)}/32", ())
        elif roll < 0.55:
            cand = (f"10.{rng.randrange(64)}.{rng.randrange(256)}.{rng.randrange(256)}/32", ())
        elif roll < 0.80:
            cand = (f"10.{rng.randrange(64)}.{rng.randrange(256)}.0/24", ())
        elif roll < 0.92:
            b2 = rng.randrange(64)
            cand = (f"10.{b2}.0.0/16", (f"10.{b2}.{rng.randrange(256)}.0/24",))
        else:
            cand = (f"10.{rng.randrange(64)}.0.0/{rng.choice((12, 14, 15))}", ())
        if cand not in seen:
            seen.add(cand)
            blocks.append(cand)
    return blocks


def _peer(block: Block) -> dict:
    cidr, excepts = block
    ip_block = {"cidr": cidr}
    if excepts:
        ip_block["except"] = list(excepts)
    return {"ipBlock": ip_block}


def allowlists(
    pods: Sequence[tuple],
    namespaces: Dict[str, Dict[str, str]],
    rng: random.Random,
    per_policy: int = 50,
    tier_values: int = 5,
) -> List[dict]:
    """The allowlist policies of a cluster: namespaces in their order,
    tiers tier0 .. tier<tier_values - 1> within each, per_policy blocks
    each, in draw order.  `pods` are (namespace, name, labels, ip)."""
    pool = sorted({p[3] for p in pods})
    keys = [(ns, f"tier{j}") for ns in namespaces for j in range(tier_values)]
    blocks = draw_blocks(len(keys) * per_policy, pool, rng)
    policies = []
    for i, (ns, tier) in enumerate(keys):
        chunk = blocks[i * per_policy:(i + 1) * per_policy]
        policies.append({
            "apiVersion": "networking.k8s.io/v1",
            "kind": "NetworkPolicy",
            "metadata": {"name": f"egress-allow-{tier}", "namespace": ns},
            "spec": {
                "podSelector": {"matchLabels": {"tier": tier}},
                "policyTypes": ["Egress"],
                "egress": [{"to": [_peer(b) for b in chunk]}],
            },
        })
    return policies
