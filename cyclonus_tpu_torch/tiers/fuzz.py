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
tier differential gate itself lives with the callers.

The CIDR family (build_cidr_fuzz_case, run_cidr_seed) is the ipBlock-
heavy corpus of the TSS/LPM class signature, seed for seed as the
reference's, with its differential gate.
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

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


# --- adversarial CIDR family (TSS/LPM pre-classification gate) ------------
#
# The corner-case corpus the TSS stage (engine/cidrspace.py) must survive:
# overlapping prefixes of every depth, /31-/32 splinters landing exactly
# on pod addresses, the /0 full cover, except == cidr annihilation,
# excepts nested three deep, and v4/v6 mixes (v6 CIDRs and v4 blocks
# with v6 excepts must route to the HOST columns, never the trie).
# Every seed is pinned dense == class-compressed(bit signature) ==
# class-compressed(TSS signature) == scalar oracle — grid and counts —
# plus the mechanical signature bridge: per-spec membership recovered
# from the partition signature (cidrspace.spec_membership_words) equals
# the membership the dense mask-compare computes.


class FuzzMismatch(AssertionError):
    """The differential gate failed; the message carries the seed and
    the first divergent cell for one-command reproduction."""


def _cidr_fuzz_blocks(rng: random.Random) -> List[IPBlock]:
    """3-8 adversarial IPBlocks drawn across the corpus families."""
    blocks: List[IPBlock] = []
    n = rng.randint(3, 8)
    for _ in range(n):
        fam = rng.random()
        if fam < 0.22:
            # overlapping prefix ladder over one base
            p = rng.choice((8, 9, 10, 12, 16, 20, 24))
            blocks.append(IPBlock.make(f"10.0.0.0/{p}", []))
        elif fam < 0.42:
            # /31-/32 splinters on/next to pod addresses
            o3, o4 = rng.choice((0, 1, 2)), rng.randint(0, 254)
            p = rng.choice((31, 32, 32))
            blocks.append(IPBlock.make(f"10.0.{o3}.{o4}/{p}", []))
        elif fam < 0.52:
            # the /0 full cover (mask_for_prefix(0) == 0 boundary)
            blocks.append(IPBlock.make("0.0.0.0/0", []))
        elif fam < 0.62:
            # except == cidr annihilation: matches nothing, exactly
            cidr = rng.choice(("10.0.1.0/24", "10.0.2.0/25"))
            blocks.append(IPBlock.make(cidr, [cidr]))
        elif fam < 0.80:
            # excepts nested three deep inside one block
            blocks.append(
                IPBlock.make(
                    "10.0.0.0/8",
                    ["10.0.0.0/10", "10.0.0.0/12", "10.0.0.0/14"][
                        : rng.randint(1, 3)
                    ],
                )
            )
        elif fam < 0.90:
            # v6 CIDR: encoding routes it to the host-evaluated path
            blocks.append(
                IPBlock.make(rng.choice(("fd00::/8", "fd00::/64")), [])
            )
        else:
            # v4 primary with a v6 except: the MIXED-family case — the
            # whole row must fall back to host evaluation for exactness
            blocks.append(IPBlock.make("10.0.0.0/16", ["fd00::/64"]))
    return blocks


def build_cidr_fuzz_case(seed: int) -> FuzzCase:
    """Deterministic ipBlock-heavy scenario for `seed` (the family
    corpus above), tier-free: the CIDR gate isolates the TSS stage."""
    rng = random.Random(seed ^ 0xC1D2)
    namespaces = {"x": {"ns": "x"}, "y": {"ns": "y"}}
    pods: List[PodTuple] = []
    #: boundary addresses on purpose: 0.0.0.0 and 255.255.255.255 are
    #: REAL addresses next to the encoder's 0-sentinel and the
    #: partition builder's 0xFFFFFFFF pad value
    ip_pool = ["0.0.0.0", "255.255.255.255", "10.0.1.0", "10.0.1.255"]
    ip_pool += [
        f"10.0.{rng.choice((0, 1, 2))}.{rng.randint(0, 255)}"
        for _ in range(8)
    ]
    for ns in ("x", "y"):
        for name in _POD_NAMES[: rng.randint(3, 4)]:
            labels = {"pod": name}
            if rng.random() < 0.12:
                ip = f"fd00::{len(pods) + 1:x}"  # v6 pod: pod_ip_valid off
            else:
                ip = rng.choice(ip_pool)  # duplicates on purpose: classes
            pods.append((ns, name, labels, ip))
    netpols: List[NetworkPolicy] = []
    for i in range(rng.randint(2, 3)):
        ptypes = rng.choice((["Ingress"], ["Egress"], ["Ingress", "Egress"]))
        spec = NetworkPolicySpec(
            pod_selector=_rand_selector(rng),
            policy_types=list(ptypes),
        )
        peers = [
            NetworkPolicyPeer(ip_block=b) for b in _cidr_fuzz_blocks(rng)
        ]
        if rng.random() < 0.4:
            peers.append(NetworkPolicyPeer(pod_selector=_rand_selector(rng)))
        if "Ingress" in ptypes:
            spec.ingress = [
                NetworkPolicyIngressRule(
                    ports=_rand_np_ports(rng), from_=list(peers)
                )
            ]
        if "Egress" in ptypes:
            spec.egress = [
                NetworkPolicyEgressRule(
                    ports=_rand_np_ports(rng), to=list(peers)
                )
            ]
        netpols.append(
            NetworkPolicy(
                name=f"cidr-np-{i}",
                namespace=rng.choice(("x", "y")),
                spec=spec,
            )
        )
    cases = [
        PortCase(80, "serve-80-tcp", "TCP"),
        PortCase(rng.choice(_PORT_POOL), "", rng.choice(_PROTOCOLS)),
    ]
    return FuzzCase(
        seed=seed,
        pods=pods,
        namespaces=namespaces,
        netpols=netpols,
        tiers=None,
        cases=cases,
        simplify=rng.random() < 0.5,
    )


def _table(grid: Dict[str, np.ndarray]) -> np.ndarray:
    """[Q, src, dst, 3] bool (ingress, egress, combined) of a grid in
    the GridVerdict layout (ingress [Q, dst, src])."""
    return np.stack(
        [np.swapaxes(grid["ingress"], 1, 2), grid["egress"], grid["combined"]],
        axis=-1,
    )


def _assert_cidr_table(got, want, seed, label, fc) -> None:
    if not np.array_equal(got, want):
        bad = np.argwhere(got != want)
        qi, si, di, ki = (int(x) for x in bad[0])
        raise FuzzMismatch(
            f"cidr seed {seed} ({label}): engine diverges from the "
            f"oracle at case={fc.cases[qi]} src={fc.pods[si][:2]} "
            f"dst={fc.pods[di][:2]} "
            f"component={('ingress', 'egress', 'combined')[ki]}: "
            f"engine={bool(got[qi, si, di, ki])} "
            f"oracle={bool(want[qi, si, di, ki])} "
            f"({bad.shape[0]} divergent cells)"
        )


def run_cidr_seed(seed: int, *, check_counts: bool = True, device=None) -> Dict:
    """The per-seed CIDR differential gate: dense, class-compressed with
    the per-spec bit signature, and class-compressed with the FORCED TSS
    partition signature all bit-identical to the scalar oracle — grid
    and counts — plus the TSS->bits membership bridge when the stage
    engaged.  The engines run on `device` (None: the current CUDA
    device).  The reference's mesh leg has no counterpart here (the
    port has no mesh path)."""
    from ..engine.api import TorchPolicyEngine
    from ..engine.cidrspace import dense_spec_membership, spec_membership_words
    from ..engine.encoding import pack_bool_words
    from ..matcher.builder import build_network_policies
    from ..oracle import oracle_grid

    fc = build_cidr_fuzz_case(seed)
    policy = build_network_policies(fc.simplify, fc.netpols)
    want = _table(oracle_grid(policy, fc.pods, fc.namespaces, fc.cases))
    n = len(fc.pods)
    cells = 0
    variants = (
        ("dense", {"class_compress": "0"}),
        ("classes-bit", {"class_compress": "1", "cidr_tss": "0"}),
        ("classes-tss", {"class_compress": "1", "cidr_tss": "1"}),
    )
    tss_active = False
    for label, kw in variants:
        engine = TorchPolicyEngine(policy, fc.pods, fc.namespaces, device=device, **kw)
        g = engine.evaluate_grid(fc.cases)
        got = _table({"ingress": g.ingress, "egress": g.egress, "combined": g.combined})
        _assert_cidr_table(got, want, seed, label, fc)
        cells += int(want.size // 3)
        if check_counts:
            sums = {
                "ingress": int(want[..., 0].sum()),
                "egress": int(want[..., 1].sum()),
                "combined": int(want[..., 2].sum()),
            }
            counts = engine.evaluate_grid_counts(fc.cases)
            got_counts = {k: counts[k] for k in sums}
            if got_counts != sums:
                raise FuzzMismatch(
                    f"cidr seed {seed} ({label}): counts engine "
                    f"{got_counts} != oracle sums {sums}"
                )
        if label == "classes-tss":
            st = engine._class_state
            space = st.get("cidr") if st is not None else None
            if space is not None:
                tss_active = True
                # the mechanical signature bridge: per-spec membership
                # recovered from the partition signature must equal the
                # dense mask-compare membership, packed word for word
                t = engine._tensors
                sig = space.signature_host(t["pod_ip"], t["pod_ip_valid"])
                bits = dense_spec_membership(
                    space, t["pod_ip"], t["pod_ip_valid"]
                )
                if not np.array_equal(
                    spec_membership_words(space, sig),
                    pack_bool_words(bits, axis=0),
                ):
                    raise FuzzMismatch(
                        f"cidr seed {seed}: TSS partition signature does "
                        f"not reproduce the dense per-spec membership "
                        f"bits (LPM stage unsound for this spec set)"
                    )
    return {"seed": seed, "pods": n, "cells": cells, "tss_active": tss_active}
