"""Seeded precedence-tier scenario generator: the fixtures of the
tiered differential checks (tests/test_torch_tiers.py, chip_smoke.py).

Every seed deterministically generates an adversarial scenario —
overlapping ANP priorities, Pass-chains, overlapping CIDRs with
excepts, empty selectors, endPort ranges, SCTP, sentinel-adjacent port
values (0 / 1 / 65535, the encoder's 0-default and -1 pads live next
door), IPv6 pods against the pod_ip_valid mask.  Seeds also generate
tier-free scenarios (~1 in 4).  The generator is a copy of the
reference package's (cyclonus_tpu/tiers/fuzz.py build_fuzz_case), draw
for draw, so one seed gives the same scenario in both packages; the
differential gate itself lives with the callers.
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from ..engine.api import PortCase
from ..kube.netpol import (
    IPBlock,
    IntOrString,
    LabelSelector,
    LabelSelectorRequirement,
    NetworkPolicy,
    NetworkPolicyEgressRule,
    NetworkPolicyIngressRule,
    NetworkPolicyPeer,
    NetworkPolicyPort,
    NetworkPolicySpec,
    OP_DOES_NOT_EXIST,
    OP_EXISTS,
    OP_IN,
    OP_NOT_IN,
)
from .model import (
    AdminNetworkPolicy,
    BaselineAdminNetworkPolicy,
    TierPort,
    TierRule,
    TierScope,
    TierSet,
)

PodTuple = Tuple[str, str, Dict[str, str], str]


@dataclass
class FuzzCase:
    seed: int
    pods: List[PodTuple]
    namespaces: Dict[str, Dict[str, str]]
    netpols: List[NetworkPolicy]
    tiers: Optional[TierSet]
    cases: List[PortCase]
    simplify: bool = True


# --- scenario generation ---------------------------------------------------

_NS_NAMES = ("x", "y", "z", "w")
_POD_NAMES = ("a", "b", "c", "d")
#: sentinel-adjacent and ordinary port values the generator draws from:
#: 0 and 1 sit next to the encoder's 0-default item_port fill, 65535 at
#: the int16 edge, 80/81/8080 are ordinary
_PORT_POOL = (0, 1, 79, 80, 81, 8080, 65535)
_NAMED_PORTS = ("serve-80-tcp", "serve-81-udp", "serve-82-sctp", "http")
_PROTOCOLS = ("TCP", "UDP", "SCTP")
#: overlapping CIDR shapes over the 10.0.0.0/8 pod range
_CIDRS = (
    ("10.0.0.0/8", ()),
    ("10.0.1.0/24", ()),
    ("10.0.0.0/16", ("10.0.1.0/24",)),
    ("10.0.1.0/24", ("10.0.1.128/25",)),
    ("10.0.0.0/30", ()),
)


def _rand_selector(rng: random.Random, empty_ok: bool = True) -> LabelSelector:
    roll = rng.random()
    if empty_ok and roll < 0.2:
        return LabelSelector.make()  # empty: matches everything
    if roll < 0.75:
        key = rng.choice(("pod", "app", "tier"))
        val = rng.choice(_POD_NAMES + ("web", "db"))
        return LabelSelector.make({key: val})
    op = rng.choice((OP_IN, OP_NOT_IN, OP_EXISTS, OP_DOES_NOT_EXIST))
    key = rng.choice(("pod", "app"))
    values = (
        tuple(rng.sample(_POD_NAMES, rng.randint(1, 2)))
        if op in (OP_IN, OP_NOT_IN)
        else ()
    )
    return LabelSelector.make(
        match_expressions=[
            LabelSelectorRequirement(key=key, operator=op, values=values)
        ]
    )


def _rand_ns_selector(rng: random.Random) -> LabelSelector:
    roll = rng.random()
    if roll < 0.25:
        return LabelSelector.make()
    return LabelSelector.make({"ns": rng.choice(_NS_NAMES)})


def _rand_scope(rng: random.Random) -> TierScope:
    if rng.random() < 0.5:
        return TierScope(namespace_selector=_rand_ns_selector(rng))
    return TierScope(
        namespace_selector=_rand_ns_selector(rng),
        pod_selector=_rand_selector(rng),
    )


def _rand_tier_ports(rng: random.Random) -> Optional[List[TierPort]]:
    roll = rng.random()
    if roll < 0.4:
        return None  # all ports
    ports: List[TierPort] = []
    for _ in range(rng.randint(1, 2)):
        kind = rng.random()
        proto = rng.choice(_PROTOCOLS)
        if kind < 0.4:
            ports.append(
                TierPort(protocol=proto, port=IntOrString(rng.choice(_PORT_POOL)))
            )
        elif kind < 0.7:
            lo = rng.choice((0, 1, 79, 80, 65530))
            hi = min(lo + rng.choice((0, 1, 5, 1000)), 65535)
            ports.append(
                TierPort(protocol=proto, port=IntOrString(lo), end_port=hi)
            )
        else:
            ports.append(
                TierPort(
                    protocol="TCP",
                    port=IntOrString(rng.choice(_NAMED_PORTS)),
                )
            )
    return ports


def _rand_np_ports(rng: random.Random) -> List[NetworkPolicyPort]:
    n = rng.randint(0, 2)
    out = []
    for _ in range(n):
        kind = rng.random()
        proto = rng.choice(_PROTOCOLS + (None,))
        if kind < 0.3:
            out.append(NetworkPolicyPort(protocol=proto, port=None))
        elif kind < 0.6:
            out.append(
                NetworkPolicyPort(
                    protocol=proto, port=IntOrString(rng.choice(_PORT_POOL))
                )
            )
        elif kind < 0.8:
            lo = rng.choice((1, 80, 8080))
            out.append(
                NetworkPolicyPort(
                    protocol=proto,
                    port=IntOrString(lo),
                    end_port=lo + rng.choice((0, 1, 100)),
                )
            )
        else:
            out.append(
                NetworkPolicyPort(
                    protocol=proto,
                    port=IntOrString(rng.choice(_NAMED_PORTS)),
                )
            )
    return out


def _rand_np_peers(rng: random.Random) -> List[NetworkPolicyPeer]:
    n = rng.randint(0, 2)
    out = []
    for _ in range(n):
        if rng.random() < 0.3:
            cidr, excepts = rng.choice(_CIDRS)
            out.append(
                NetworkPolicyPeer(ip_block=IPBlock.make(cidr, list(excepts)))
            )
        else:
            out.append(
                NetworkPolicyPeer(
                    pod_selector=_rand_selector(rng)
                    if rng.random() < 0.7
                    else None,
                    namespace_selector=_rand_ns_selector(rng)
                    if rng.random() < 0.7
                    else None,
                )
            )
    return [
        p
        for p in out
        if p.ip_block is not None
        or p.pod_selector is not None
        or p.namespace_selector is not None
    ]


def build_fuzz_case(seed: int) -> FuzzCase:
    """Deterministic adversarial scenario for `seed` (module docstring
    lists the corner-case families)."""
    rng = random.Random(seed)
    n_ns = rng.randint(2, 4)
    ns_names = list(_NS_NAMES[:n_ns])
    namespaces = {}
    for ns in ns_names:
        labels = {"ns": ns}
        if rng.random() < 0.3:
            labels["team"] = rng.choice(("red", "blue"))
        if rng.random() < 0.1:
            labels = {}  # label-less namespace
        namespaces[ns] = labels
    pods: List[PodTuple] = []
    for ns in ns_names:
        for name in _POD_NAMES[: rng.randint(2, 3)]:
            labels = {"pod": name}
            if rng.random() < 0.3:
                labels["app"] = rng.choice(("web", "db"))
            if rng.random() < 0.05:
                labels = {}
            if rng.random() < 0.06:
                ip = f"fd00::{len(pods) + 1:x}"  # IPv6: pod_ip_valid mask
            else:
                # inside/outside the overlapping CIDR pool on purpose
                ip = f"10.0.{rng.choice((0, 1, 2))}.{rng.randint(1, 250)}"
            pods.append((ns, name, labels, ip))

    netpols: List[NetworkPolicy] = []
    for i in range(rng.randint(0, 3)):
        ptypes = rng.choice((["Ingress"], ["Egress"], ["Ingress", "Egress"]))
        spec = NetworkPolicySpec(
            pod_selector=_rand_selector(rng),
            policy_types=list(ptypes),
        )
        if "Ingress" in ptypes:
            spec.ingress = [
                NetworkPolicyIngressRule(
                    ports=_rand_np_ports(rng), from_=_rand_np_peers(rng)
                )
                for _ in range(rng.randint(0, 2))
            ]
        if "Egress" in ptypes:
            spec.egress = [
                NetworkPolicyEgressRule(
                    ports=_rand_np_ports(rng), to=_rand_np_peers(rng)
                )
                for _ in range(rng.randint(0, 2))
            ]
        netpols.append(
            NetworkPolicy(
                name=f"np-{i}", namespace=rng.choice(ns_names), spec=spec
            )
        )

    tiers: Optional[TierSet] = None
    if rng.random() < 0.75:
        anps = []
        # overlapping priorities on purpose: the (priority, name) total
        # order must resolve identically kernel- and oracle-side
        prio_pool = (0, 1, 1, 5, 5, 50, 1000)
        for i in range(rng.randint(0, 3)):
            rules_in = [
                TierRule(
                    action=rng.choice(("Allow", "Deny", "Pass", "Pass")),
                    peers=[_rand_scope(rng) for _ in range(rng.randint(1, 2))],
                    ports=_rand_tier_ports(rng),
                )
                for _ in range(rng.randint(0, 2))
            ]
            rules_eg = [
                TierRule(
                    action=rng.choice(("Allow", "Deny", "Pass")),
                    peers=[_rand_scope(rng) for _ in range(rng.randint(1, 2))],
                    ports=_rand_tier_ports(rng),
                )
                for _ in range(rng.randint(0, 2))
            ]
            anps.append(
                AdminNetworkPolicy(
                    name=f"anp-{i}",
                    priority=rng.choice(prio_pool),
                    subject=_rand_scope(rng),
                    ingress=rules_in,
                    egress=rules_eg,
                )
            )
        banp = None
        if rng.random() < 0.5:
            banp = BaselineAdminNetworkPolicy(
                subject=_rand_scope(rng),
                ingress=[
                    TierRule(
                        action=rng.choice(("Allow", "Deny")),
                        peers=[_rand_scope(rng)],
                        ports=_rand_tier_ports(rng),
                    )
                    for _ in range(rng.randint(0, 2))
                ],
                egress=[
                    TierRule(
                        action=rng.choice(("Allow", "Deny")),
                        peers=[_rand_scope(rng)],
                        ports=_rand_tier_ports(rng),
                    )
                    for _ in range(rng.randint(0, 1))
                ],
            )
        ts = TierSet(anps=anps, banp=banp)
        tiers = ts if ts else None

    cases = [
        PortCase(80, "serve-80-tcp", "TCP"),
        PortCase(81, "serve-81-udp", "UDP"),
        PortCase(rng.choice(_PORT_POOL), "", rng.choice(_PROTOCOLS)),
    ]
    if rng.random() < 0.5:
        cases.append(PortCase(82, "serve-82-sctp", "SCTP"))
    if rng.random() < 0.3:
        cases.append(PortCase(65535, "", "TCP"))

    return FuzzCase(
        seed=seed,
        pods=pods,
        namespaces=namespaces,
        netpols=netpols,
        tiers=tiers,
        cases=cases,
        simplify=rng.random() < 0.5,
    )
