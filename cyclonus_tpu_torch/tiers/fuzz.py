"""Seeded policy-set fuzzer: the precedence-tier subsystem's
correctness gate (`python -m cyclonus_tpu_torch fuzz`), a copy of the
reference package's tiers/fuzz.py on the port's engine.

Every seed deterministically generates an adversarial scenario —
overlapping ANP priorities, Pass-chains, overlapping CIDRs with
excepts, empty selectors, endPort ranges, SCTP, sentinel-adjacent port
values (0 / 1 / 65535, the encoder's 0-default and -1 pads live next
door), IPv6 pods against the pod_ip_valid mask — and differentially
checks the engine against the scalar lattice oracle
(matcher/tiered.py):

  * grid truth tables BIT-IDENTICAL, dense AND class-compressed
    (class_compress both off and forced), and again through the ring
    schedule of the pod-axis mesh (the mesh leg, engine/sharded.py);
  * the counts engine equal to the oracle-checked grid sums;
  * evaluate_pairs spot checks on sampled cells;
  * the class reduction sound under the tiered oracle, and the linter
    running over every generated NetworkPolicy set.

Seeds also generate tier-free scenarios (~1 in 4).  The generator is
draw for draw the reference's (build_fuzz_case), so one seed gives the
same scenario in both packages.  A mismatch raises FuzzMismatch carrying
the seed and the first divergent cell, so any failure reproduces with
`fuzz --seed N --seeds 1`.

The CIDR family (build_cidr_fuzz_case, run_cidr_seed) is the ipBlock-
heavy corpus of the TSS/LPM class signature, seed for seed as the
reference's, with its differential gate and its mesh leg; the ANP/BANP
conformance family (generator/anp_cases.py) runs through run_conformance.
Every engine runs on `device` (None: the current CUDA device) and the
mesh leg on `mesh` (None: sharded.default_mesh of that device).
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..engine.api import PortCase, TorchPolicyEngine
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
from ..matcher.builder import build_network_policies
from ..matcher.core import Policy
from ..matcher.tiered import TieredPolicy
from ..oracle import traffic_for_cell
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


@dataclass
class FuzzReport:
    seeds: List[int] = field(default_factory=list)
    cells_checked: int = 0
    mesh_cells_checked: int = 0  # cells re-checked through the mesh's ring
    pair_checks: int = 0
    tiered_seeds: int = 0
    #: the linter leg (linter/checks.py): every seed's generated
    #: NetworkPolicy set runs linter.lint without crashing; the warning
    #: totals ride the report
    lint_warnings: int = 0
    lint_warnings_by_check: Dict[str, int] = field(default_factory=dict)
    #: the adversarial CIDR family: every seed pinned dense == compressed
    #: == TSS == oracle, mesh leg included
    cidr_seeds: List[int] = field(default_factory=list)
    cidr_cells_checked: int = 0

    def to_dict(self) -> Dict:
        return {
            "seeds": list(self.seeds),
            "cells_checked": self.cells_checked,
            "mesh_cells_checked": self.mesh_cells_checked,
            "pair_checks": self.pair_checks,
            "tiered_seeds": self.tiered_seeds,
            "lint_warnings": self.lint_warnings,
            "lint_warnings_by_check": dict(self.lint_warnings_by_check),
            "cidr_seeds": list(self.cidr_seeds),
            "cidr_cells_checked": self.cidr_cells_checked,
        }


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


class FuzzMismatch(AssertionError):
    """The differential gate failed; the message carries the seed and
    the first divergent cell for one-command reproduction."""


# --- the differential gate -------------------------------------------------


def _oracle_table(
    policy: Policy,
    tiers: Optional[TierSet],
    pods: List[PodTuple],
    namespaces: Dict[str, Dict[str, str]],
    cases: List[PortCase],
) -> np.ndarray:
    """[Q, N, N, 3] bool oracle truth table (ingress, egress, combined),
    indexed [q, src, dst]."""
    oracle = TieredPolicy(policy, tiers)
    n = len(pods)
    out = np.zeros((len(cases), n, n, 3), dtype=bool)
    for qi, case in enumerate(cases):
        for si in range(n):
            for di in range(n):
                out[qi, si, di] = oracle.is_traffic_allowed(
                    traffic_for_cell(pods, namespaces, case, si, di)
                )
    return out


def _table_from_grid(grid) -> np.ndarray:
    """[Q, src, dst, 3] bool of a GridVerdict (ingress [Q, dst, src])."""
    return np.stack(
        [np.swapaxes(grid.ingress, 1, 2), grid.egress, grid.combined], axis=-1
    )


def _engine_table(engine: TorchPolicyEngine, cases: List[PortCase]) -> np.ndarray:
    return _table_from_grid(engine.evaluate_grid(cases))


def _first_divergence(got: np.ndarray, want: np.ndarray, cases, pods):
    """(where, divergent cell count, (q, src, dst, component)) of the
    first cell where two tables differ."""
    bad = np.argwhere(got != want)
    cell = tuple(int(x) for x in bad[0])
    qi, si, di, ki = cell
    return (
        f"case={cases[qi]} src={pods[si][:2]} dst={pods[di][:2]} "
        f"component={('ingress', 'egress', 'combined')[ki]}"
    ), bad.shape[0], cell


def run_seed(
    seed: int,
    *,
    modes: Tuple[str, ...] = ("0", "1"),
    check_counts: bool = True,
    check_mesh: bool = True,
    pair_samples: int = 16,
    device=None,
    mesh=None,
) -> Dict:
    """The per-seed differential gate (module docstring).  Returns check
    stats; raises FuzzMismatch on any divergence.  check_mesh routes
    every engine (tiered and tier-free, dense AND class-compressed)
    through the ring schedule of the pod-axis mesh too
    (evaluate_grid_sharded over `mesh`) and pins it bit-identical to the
    same oracle table."""
    from ..analysis.classes import audit_class_reduction
    from ..linter.checks import lint as policy_lint

    fc = build_fuzz_case(seed)
    # the linter must process every generated NetworkPolicy set without
    # crashing, adversarial shapes included; the census rides the report
    lint_warnings = policy_lint(fc.netpols)
    policy = build_network_policies(fc.simplify, fc.netpols)
    want = _oracle_table(policy, fc.tiers, fc.pods, fc.namespaces, fc.cases)
    n = len(fc.pods)
    rng = random.Random(seed ^ 0x5EED)
    pair_checks = 0
    mesh_cells = 0
    for mode in modes:
        engine = TorchPolicyEngine(
            policy, fc.pods, fc.namespaces, tiers=fc.tiers, class_compress=mode, device=device,
        )
        got = _engine_table(engine, fc.cases)
        if not np.array_equal(got, want):
            where, n_bad, (qi, si, di, ki) = _first_divergence(got, want, fc.cases, fc.pods)
            raise FuzzMismatch(
                f"seed {seed} (class_compress={mode}): engine diverges "
                f"from the tiered oracle at {where}: "
                f"engine={bool(got[qi, si, di, ki])} "
                f"oracle={bool(want[qi, si, di, ki])} "
                f"({n_bad} divergent cells)"
            )
        if check_mesh and n:
            got_mesh = _table_from_grid(
                engine.evaluate_grid_sharded(fc.cases, mesh=mesh, schedule="ring")
            )
            if not np.array_equal(got_mesh, want):
                where, n_bad, _ = _first_divergence(got_mesh, want, fc.cases, fc.pods)
                raise FuzzMismatch(
                    f"seed {seed} (class_compress={mode}): the mesh's ring "
                    f"diverges from the tiered oracle at {where} "
                    f"({n_bad} divergent cells)"
                )
            mesh_cells += int(want.size // 3)
        if check_counts:
            sums = {
                "ingress": int(want[..., 0].sum()),
                "egress": int(want[..., 1].sum()),
                "combined": int(want[..., 2].sum()),
            }
            counts = engine.evaluate_grid_counts(fc.cases, block=8)
            got_counts = {k: counts[k] for k in sums}
            if got_counts != sums:
                raise FuzzMismatch(
                    f"seed {seed} (class_compress={mode}): counts engine "
                    f"{got_counts} != oracle sums {sums}"
                )
        if mode == "1":
            # class-reduction soundness under the lattice: co-classed pods
            # must be indistinguishable to the TIERED oracle
            pc = engine.pod_classes()
            if pc is not None:
                res = audit_class_reduction(
                    policy, fc.pods, fc.namespaces, fc.cases, pc,
                    rng=random.Random(seed ^ 0xC1A5), tiers=fc.tiers,
                )
                if not res["ok"]:
                    raise FuzzMismatch(
                        f"seed {seed}: class-reduction audit found "
                        f"{len(res['violations'])} violations under the "
                        f"tiered oracle; first {res['violations'][0]}"
                    )
        if n and pair_samples:
            pairs = [(rng.randrange(n), rng.randrange(n)) for _ in range(pair_samples)]
            res = engine.evaluate_pairs(fc.cases, pairs)
            for k, (si, di) in enumerate(pairs):
                for qi in range(len(fc.cases)):
                    got_p = tuple(bool(x) for x in res[k, qi])
                    want_p = tuple(bool(x) for x in want[qi, si, di])
                    if got_p != want_p:
                        raise FuzzMismatch(
                            f"seed {seed} (class_compress={mode}): "
                            f"evaluate_pairs diverges at "
                            f"case={fc.cases[qi]} src={fc.pods[si][:2]} "
                            f"dst={fc.pods[di][:2]}: {got_p} != {want_p}"
                        )
                    pair_checks += 1
    lint_by_check: Dict[str, int] = {}
    for w in lint_warnings:
        lint_by_check[w.check] = lint_by_check.get(w.check, 0) + 1
    return {
        "seed": seed,
        "pods": n,
        "tiered": fc.tiers is not None,
        "cells": int(want.size // 3 * len(modes)),
        "mesh_cells": mesh_cells,
        "pair_checks": pair_checks,
        "anp_count": 0 if fc.tiers is None else len(fc.tiers.anps),
        "lint_warnings": len(lint_warnings),
        "lint_warnings_by_check": lint_by_check,
    }


# --- adversarial CIDR family (TSS/LPM pre-classification gate) ------------
#
# The corner-case corpus the TSS stage (engine/cidrspace.py) must survive:
# overlapping prefixes of every depth, /31-/32 splinters landing exactly
# on pod addresses, the /0 full cover, except == cidr annihilation,
# excepts nested three deep, and v4/v6 mixes (v6 CIDRs and v4 blocks
# with v6 excepts must route to the HOST columns, never the trie).
# Every seed is pinned dense == class-compressed(bit signature) ==
# class-compressed(TSS signature) == scalar oracle — grid, counts and the
# mesh's ring — plus the mechanical signature bridge: per-spec
# membership recovered from the partition signature
# (cidrspace.spec_membership_words) equals the membership the dense
# mask-compare computes.


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


def _assert_cidr_table(got, want, seed, label, fc) -> None:
    if not np.array_equal(got, want):
        where, n_bad, (qi, si, di, ki) = _first_divergence(got, want, fc.cases, fc.pods)
        raise FuzzMismatch(
            f"cidr seed {seed} ({label}): engine diverges from the "
            f"oracle at {where}: "
            f"engine={bool(got[qi, si, di, ki])} "
            f"oracle={bool(want[qi, si, di, ki])} "
            f"({n_bad} divergent cells)"
        )


def run_cidr_seed(
    seed: int, *, check_mesh: bool = True, check_counts: bool = True, device=None, mesh=None
) -> Dict:
    """The per-seed CIDR differential gate: dense, class-compressed with
    the per-spec bit signature, and class-compressed with the FORCED TSS
    partition signature all bit-identical to the scalar oracle — grid,
    counts, and (check_mesh) the ring schedule of the pod-axis mesh —
    plus the TSS->bits membership bridge when the stage engaged."""
    from ..engine.cidrspace import dense_spec_membership, spec_membership_words
    from ..engine.encoding import pack_bool_words

    fc = build_cidr_fuzz_case(seed)
    policy = build_network_policies(fc.simplify, fc.netpols)
    want = _oracle_table(policy, None, fc.pods, fc.namespaces, fc.cases)
    n = len(fc.pods)
    cells = 0
    mesh_cells = 0
    variants = (
        ("dense", {"class_compress": "0"}),
        ("classes-bit", {"class_compress": "1", "cidr_tss": "0"}),
        ("classes-tss", {"class_compress": "1", "cidr_tss": "1"}),
    )
    tss_active = False
    for label, kw in variants:
        engine = TorchPolicyEngine(policy, fc.pods, fc.namespaces, device=device, **kw)
        got = _engine_table(engine, fc.cases)
        _assert_cidr_table(got, want, seed, label, fc)
        cells += int(want.size // 3)
        if check_mesh and n:
            got_mesh = _table_from_grid(
                engine.evaluate_grid_sharded(fc.cases, mesh=mesh, schedule="ring")
            )
            _assert_cidr_table(got_mesh, want, seed, f"{label}/mesh", fc)
            mesh_cells += int(want.size // 3)
        if check_counts:
            sums = {
                "ingress": int(want[..., 0].sum()),
                "egress": int(want[..., 1].sum()),
                "combined": int(want[..., 2].sum()),
            }
            counts = engine.evaluate_grid_counts(fc.cases, block=8)
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
    return {
        "seed": seed,
        "pods": n,
        "cells": cells,
        "mesh_cells": mesh_cells,
        "tss_active": tss_active,
    }


def run(
    seeds: int = 8,
    base_seed: int = 0,
    *,
    modes: Tuple[str, ...] = ("0", "1"),
    check_counts: bool = True,
    check_mesh: bool = True,
    pair_samples: int = 16,
    cidr_seeds: int = 0,
    log=None,
    device=None,
    mesh=None,
) -> FuzzReport:
    """Run `seeds` consecutive seeds from `base_seed` (plus `cidr_seeds`
    seeds of the adversarial CIDR family); raises FuzzMismatch on the
    first divergence."""
    report = FuzzReport()
    for s in range(base_seed, base_seed + seeds):
        r = run_seed(
            s,
            modes=modes,
            check_counts=check_counts,
            check_mesh=check_mesh,
            pair_samples=pair_samples,
            device=device,
            mesh=mesh,
        )
        report.seeds.append(s)
        report.cells_checked += r["cells"]
        report.mesh_cells_checked += r["mesh_cells"]
        report.pair_checks += r["pair_checks"]
        report.tiered_seeds += int(r["tiered"])
        report.lint_warnings += r["lint_warnings"]
        for check, n_w in r["lint_warnings_by_check"].items():
            report.lint_warnings_by_check[check] = (
                report.lint_warnings_by_check.get(check, 0) + n_w
            )
        if log is not None:
            log(
                f"seed {s}: pods={r['pods']} anps={r['anp_count']} "
                f"tiered={r['tiered']} cells={r['cells']} "
                f"mesh={r['mesh_cells']} lint={r['lint_warnings']} OK"
            )
    for s in range(base_seed, base_seed + max(0, cidr_seeds)):
        r = run_cidr_seed(
            s, check_mesh=check_mesh, check_counts=check_counts, device=device, mesh=mesh
        )
        report.cidr_seeds.append(s)
        report.cidr_cells_checked += r["cells"] + r["mesh_cells"]
        if log is not None:
            log(
                f"cidr seed {s}: pods={r['pods']} cells={r['cells']} "
                f"mesh={r['mesh_cells']} tss={r['tss_active']} OK"
            )
    return report


def run_conformance(log=None, device=None) -> int:
    """Run the generator's ANP/BANP conformance family through the same
    differential gate; returns the case count."""
    from ..generator.anp_cases import tier_cases

    n_cases = 0
    for tc in tier_cases():
        pods, namespaces = tc.cluster()
        policy = build_network_policies(True, tc.netpols)
        want = _oracle_table(policy, tc.tiers, pods, namespaces, tc.cases)
        for mode in ("0", "1"):
            engine = TorchPolicyEngine(
                policy, pods, namespaces, tiers=tc.tiers, class_compress=mode, device=device
            )
            got = _engine_table(engine, tc.cases)
            if not np.array_equal(got, want):
                where, _n_bad, _ = _first_divergence(got, want, tc.cases, pods)
                raise FuzzMismatch(
                    f"conformance case {tc.description!r} "
                    f"(class_compress={mode}) diverges at {where}"
                )
        n_cases += 1
        if log is not None:
            log(f"conformance: {tc.description} OK")
    return n_cases
