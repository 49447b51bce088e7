"""The precedence-tier conformance family: AdminNetworkPolicy / BANP
cases alongside the existing ~216 networkingv1 cases (a copy of the
reference package's generator/anp_cases.py, case for case).

These cases are DIFFERENTIAL, not kubectl-driven: no upstream cluster
this repo drives can apply AdminNetworkPolicies (the loopback cluster
speaks networkingv1 only), so a TierCase carries the full scenario —
cluster, NetworkPolicies, TierSet, port cases — and its gate is the
fuzzer's: the tiered kernel truth table must be bit-identical to the
scalar lattice oracle (matcher/tiered.py), dense and class-compressed
alike.  tiers.fuzz.run_conformance runs every case through that gate,
and `python -m cyclonus_tpu_torch fuzz --conformance` runs them from the
CLI.

The family doubles as executable documentation of the lattice's corner
semantics: Pass-fallthrough, deny-overrides-by-priority, equal-priority
total order, BANP-behind-NetworkPolicy shadowing, per-namespace
default-deny interplay, endPort ranges, and SCTP."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..engine.api import PortCase
from ..kube.netpol import (
    IntOrString,
    LabelSelector,
    NetworkPolicy,
    NetworkPolicyEgressRule,
    NetworkPolicyIngressRule,
    NetworkPolicyPeer,
    NetworkPolicyPort,
    NetworkPolicySpec,
)
from ..tiers.model import (
    AdminNetworkPolicy,
    BaselineAdminNetworkPolicy,
    TierPort,
    TierRule,
    TierScope,
    TierSet,
)
from .tags import (
    StringSet,
    TAG_ANP,
    TAG_BANP,
    TAG_DEFAULT_DENY_NS,
    TAG_SCTP,
    TAG_TIER_PASS,
)

PodTuple = Tuple[str, str, Dict[str, str], str]


@dataclass
class TierCase:
    """One differential conformance scenario for the verdict lattice."""

    __test__ = False  # not a pytest class

    description: str
    tags: StringSet
    tiers: TierSet
    netpols: List[NetworkPolicy] = field(default_factory=list)
    cases: List[PortCase] = field(default_factory=list)
    pods: Optional[List[PodTuple]] = None  # None: the default cluster
    namespaces: Optional[Dict[str, Dict[str, str]]] = None

    def cluster(self) -> Tuple[List[PodTuple], Dict[str, Dict[str, str]]]:
        if self.pods is not None:
            return self.pods, dict(self.namespaces or {})
        return default_tier_cluster()


def default_tier_cluster() -> Tuple[List[PodTuple], Dict[str, Dict[str, str]]]:
    """The x/y/z three-namespace, a/b/c pod grid every networkingv1
    conformance case probes, reused so tier verdicts are directly
    comparable with the base family's."""
    namespaces = {ns: {"ns": ns} for ns in ("x", "y", "z")}
    pods: List[PodTuple] = []
    ip = 1
    for ns in ("x", "y", "z"):
        for name in ("a", "b", "c"):
            pods.append((ns, name, {"pod": name}, f"192.168.2.{ip}"))
            ip += 1
    return pods, namespaces


DEFAULT_TIER_CASES = [
    PortCase(80, "serve-80-tcp", "TCP"),
    PortCase(81, "serve-81-udp", "UDP"),
    PortCase(82, "serve-82-sctp", "SCTP"),
]


def _ns_sel(ns: str) -> LabelSelector:
    return LabelSelector.make({"ns": ns})


def _pod_sel(pod: str) -> LabelSelector:
    return LabelSelector.make({"pod": pod})


def default_deny_netpol(ns: str) -> NetworkPolicy:
    """The per-namespace default-deny policy (empty podSelector, both
    directions, no rules): the generator feature the BANP-interplay and
    default-deny cases build on — and a reusable building block for any
    case family wanting an isolated-namespace baseline."""
    return NetworkPolicy(
        name=f"default-deny-{ns}",
        namespace=ns,
        spec=NetworkPolicySpec(
            pod_selector=LabelSelector.make(),
            policy_types=["Ingress", "Egress"],
        ),
    )


def per_namespace_default_deny(namespaces: List[str]) -> List[NetworkPolicy]:
    """One default-deny policy per namespace."""
    return [default_deny_netpol(ns) for ns in namespaces]


def tier_cases() -> List[TierCase]:
    """The ANP/BANP conformance family (see module docstring)."""
    out: List[TierCase] = []

    # 1. ANP Allow overrides a NetworkPolicy deny
    out.append(
        TierCase(
            description="ANP Allow at priority 10 admits traffic a "
            "namespace default-deny NetworkPolicy would drop",
            tags=StringSet.of(TAG_ANP),
            netpols=[default_deny_netpol("x")],
            tiers=TierSet(
                anps=[
                    AdminNetworkPolicy(
                        name="allow-y-into-x",
                        priority=10,
                        subject=TierScope(namespace_selector=_ns_sel("x")),
                        ingress=[
                            TierRule(
                                action="Allow",
                                peers=[TierScope(namespace_selector=_ns_sel("y"))],
                            )
                        ],
                    )
                ]
            ),
            cases=list(DEFAULT_TIER_CASES),
        )
    )

    # 2. ANP Deny overrides a NetworkPolicy allow
    out.append(
        TierCase(
            description="ANP Deny at priority 0 drops traffic a "
            "NetworkPolicy explicitly allows",
            tags=StringSet.of(TAG_ANP),
            netpols=[
                NetworkPolicy(
                    name="allow-z-into-x",
                    namespace="x",
                    spec=NetworkPolicySpec(
                        pod_selector=LabelSelector.make(),
                        policy_types=["Ingress"],
                        ingress=[
                            NetworkPolicyIngressRule(
                                from_=[
                                    NetworkPolicyPeer(
                                        namespace_selector=_ns_sel("z")
                                    )
                                ]
                            )
                        ],
                    ),
                )
            ],
            tiers=TierSet(
                anps=[
                    AdminNetworkPolicy(
                        name="deny-z",
                        priority=0,
                        subject=TierScope(),
                        ingress=[
                            TierRule(
                                action="Deny",
                                peers=[TierScope(namespace_selector=_ns_sel("z"))],
                            )
                        ],
                    )
                ]
            ),
            cases=list(DEFAULT_TIER_CASES),
        )
    )

    # 3. Pass falls through to the NetworkPolicy tier, then BANP
    out.append(
        TierCase(
            description="Pass-chain: high-priority Pass defers to a "
            "NetworkPolicy for selected pods and to BANP default-deny "
            "for the rest",
            tags=StringSet.of(TAG_ANP, TAG_BANP, TAG_TIER_PASS),
            netpols=[
                NetworkPolicy(
                    name="allow-y-into-xa",
                    namespace="x",
                    spec=NetworkPolicySpec(
                        pod_selector=_pod_sel("a"),
                        policy_types=["Ingress"],
                        ingress=[
                            NetworkPolicyIngressRule(
                                from_=[
                                    NetworkPolicyPeer(
                                        namespace_selector=_ns_sel("y")
                                    )
                                ]
                            )
                        ],
                    ),
                )
            ],
            tiers=TierSet(
                anps=[
                    AdminNetworkPolicy(
                        name="pass-everything",
                        priority=1,
                        subject=TierScope(),
                        ingress=[TierRule(action="Pass", peers=[TierScope()])],
                    ),
                    AdminNetworkPolicy(
                        name="shadowed-deny",
                        priority=50,
                        subject=TierScope(),
                        ingress=[TierRule(action="Deny", peers=[TierScope()])],
                    ),
                ],
                banp=BaselineAdminNetworkPolicy(
                    subject=TierScope(namespace_selector=_ns_sel("x")),
                    ingress=[TierRule(action="Deny", peers=[TierScope()])],
                ),
            ),
            cases=list(DEFAULT_TIER_CASES),
        )
    )

    # 4. equal priorities: the (priority, name) total order decides
    out.append(
        TierCase(
            description="overlapping ANP priorities: two priority-5 "
            "policies with conflicting verdicts resolve by name order",
            tags=StringSet.of(TAG_ANP),
            tiers=TierSet(
                anps=[
                    AdminNetworkPolicy(
                        name="a-allow",
                        priority=5,
                        subject=TierScope(namespace_selector=_ns_sel("y")),
                        ingress=[TierRule(action="Allow", peers=[TierScope()])],
                    ),
                    AdminNetworkPolicy(
                        name="b-deny",
                        priority=5,
                        subject=TierScope(namespace_selector=_ns_sel("y")),
                        ingress=[TierRule(action="Deny", peers=[TierScope()])],
                    ),
                ]
            ),
            cases=list(DEFAULT_TIER_CASES),
        )
    )

    # 5. BANP shadowed by NetworkPolicy selection
    out.append(
        TierCase(
            description="BANP default-deny never fires for pods a "
            "NetworkPolicy selects (NP tier is final), and fires for "
            "everything else",
            tags=StringSet.of(TAG_BANP),
            netpols=[
                NetworkPolicy(
                    name="select-xa",
                    namespace="x",
                    spec=NetworkPolicySpec(
                        pod_selector=_pod_sel("a"),
                        policy_types=["Ingress"],
                        ingress=[NetworkPolicyIngressRule()],  # deny-all
                    ),
                )
            ],
            tiers=TierSet(
                banp=BaselineAdminNetworkPolicy(
                    subject=TierScope(),
                    ingress=[
                        TierRule(
                            action="Deny",
                            peers=[TierScope(namespace_selector=_ns_sel("z"))],
                        ),
                        TierRule(action="Allow", peers=[TierScope()]),
                    ],
                )
            ),
            cases=list(DEFAULT_TIER_CASES),
        )
    )

    # 6. endPort ranges through the tier port slabs
    out.append(
        TierCase(
            description="ANP portRange (endPort analog) admits only the "
            "[80, 81] window; 82 stays at the lower tiers",
            tags=StringSet.of(TAG_ANP),
            netpols=[default_deny_netpol("y")],
            tiers=TierSet(
                anps=[
                    AdminNetworkPolicy(
                        name="range-allow",
                        priority=3,
                        subject=TierScope(namespace_selector=_ns_sel("y")),
                        ingress=[
                            TierRule(
                                action="Allow",
                                peers=[TierScope()],
                                ports=[
                                    TierPort(
                                        protocol="TCP",
                                        port=IntOrString(80),
                                        end_port=81,
                                    )
                                ],
                            )
                        ],
                    )
                ]
            ),
            cases=[
                PortCase(80, "serve-80-tcp", "TCP"),
                PortCase(81, "serve-81-tcp", "TCP"),
                PortCase(82, "serve-82-tcp", "TCP"),
            ],
        )
    )

    # 7. SCTP through the full lattice
    out.append(
        TierCase(
            description="SCTP-only ANP Deny: TCP/UDP fall through to "
            "default-allow, SCTP from z is dropped",
            tags=StringSet.of(TAG_ANP, TAG_SCTP),
            tiers=TierSet(
                anps=[
                    AdminNetworkPolicy(
                        name="sctp-deny",
                        priority=9,
                        subject=TierScope(),
                        ingress=[
                            TierRule(
                                action="Deny",
                                peers=[TierScope(namespace_selector=_ns_sel("z"))],
                                ports=[
                                    TierPort(
                                        protocol="SCTP", port=IntOrString(82)
                                    )
                                ],
                            )
                        ],
                    )
                ]
            ),
            cases=list(DEFAULT_TIER_CASES),
        )
    )

    # 8. per-namespace default-deny under a Pass-everything ANP
    out.append(
        TierCase(
            description="per-namespace default-deny in every namespace "
            "under an ANP Pass: the NP tier decides everywhere, BANP "
            "allow never fires",
            tags=StringSet.of(TAG_ANP, TAG_TIER_PASS, TAG_DEFAULT_DENY_NS),
            netpols=per_namespace_default_deny(["x", "y", "z"]),
            tiers=TierSet(
                anps=[
                    AdminNetworkPolicy(
                        name="pass-all",
                        priority=0,
                        subject=TierScope(),
                        ingress=[TierRule(action="Pass", peers=[TierScope()])],
                        egress=[TierRule(action="Pass", peers=[TierScope()])],
                    )
                ],
                banp=BaselineAdminNetworkPolicy(
                    subject=TierScope(),
                    ingress=[TierRule(action="Allow", peers=[TierScope()])],
                ),
            ),
            cases=list(DEFAULT_TIER_CASES),
        )
    )

    # 9. egress lattice: ANP egress Deny + BANP egress Allow
    out.append(
        TierCase(
            description="egress direction: ANP denies x->z egress, BANP "
            "allows the rest of x's egress explicitly",
            tags=StringSet.of(TAG_ANP, TAG_BANP),
            netpols=[
                NetworkPolicy(
                    name="x-egress-to-y",
                    namespace="x",
                    spec=NetworkPolicySpec(
                        pod_selector=_pod_sel("b"),
                        policy_types=["Egress"],
                        egress=[
                            NetworkPolicyEgressRule(
                                to=[
                                    NetworkPolicyPeer(
                                        namespace_selector=_ns_sel("y")
                                    )
                                ],
                                ports=[
                                    NetworkPolicyPort(
                                        protocol="UDP", port=IntOrString(81)
                                    )
                                ],
                            )
                        ],
                    ),
                )
            ],
            tiers=TierSet(
                anps=[
                    AdminNetworkPolicy(
                        name="deny-x-to-z",
                        priority=4,
                        subject=TierScope(namespace_selector=_ns_sel("x")),
                        egress=[
                            TierRule(
                                action="Deny",
                                peers=[TierScope(namespace_selector=_ns_sel("z"))],
                            )
                        ],
                    )
                ],
                banp=BaselineAdminNetworkPolicy(
                    subject=TierScope(namespace_selector=_ns_sel("x")),
                    egress=[TierRule(action="Allow", peers=[TierScope()])],
                ),
            ),
            cases=list(DEFAULT_TIER_CASES),
        )
    )

    # 10. empty-selector subject + pods-variant peer + named port
    out.append(
        TierCase(
            description="pods-variant scopes: subject {all-ns, pod=c} "
            "denied from peer {ns=y, pod=a} on the named port only",
            tags=StringSet.of(TAG_ANP),
            tiers=TierSet(
                anps=[
                    AdminNetworkPolicy(
                        name="named-port-deny",
                        priority=2,
                        subject=TierScope(
                            namespace_selector=LabelSelector.make(),
                            pod_selector=_pod_sel("c"),
                        ),
                        ingress=[
                            TierRule(
                                action="Deny",
                                peers=[
                                    TierScope(
                                        namespace_selector=_ns_sel("y"),
                                        pod_selector=_pod_sel("a"),
                                    )
                                ],
                                ports=[
                                    TierPort(
                                        protocol="TCP",
                                        port=IntOrString("serve-80-tcp"),
                                    )
                                ],
                            )
                        ],
                    )
                ]
            ),
            cases=list(DEFAULT_TIER_CASES),
        )
    )

    return out
