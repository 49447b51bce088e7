"""The benchmark's synthetic cluster and policy set, on this package's own
policy model: a copy of bench.build_synthetic.  From the same
random.Random it yields the same pods, namespaces and policies.

Shape: n_pods pods over max(2, n_pods // 250) namespaces, each pod with
three labels (pod, app, tier) and a distinct 10.x.y.z address; each
policy selects one app in one namespace and allows TCP 80 (plus the
named UDP port serve-81-udp for 30% of them) from one peer: an IPBlock
with one except (20%) or a tier pod selector, half of them also scoped
to a team namespace selector.  40% of the policies also cover egress.

bench_tiers is the benchmark's admin-tier lattice over the same label
scheme (a copy of the TierSet in bench.tiers_case), and cidr_cluster the
ipBlock-heavy cluster of the benchmark's CIDR leg (bench.cidr_case).
"""

from __future__ import annotations

import random

from .kube.netpol import (
    IntOrString,
    IPBlock,
    LabelSelector,
    NetworkPolicy,
    NetworkPolicyEgressRule,
    NetworkPolicyIngressRule,
    NetworkPolicyPeer,
    NetworkPolicyPort,
    NetworkPolicySpec,
)
from .tiers.model import (
    AdminNetworkPolicy,
    BaselineAdminNetworkPolicy,
    TierPort,
    TierRule,
    TierScope,
    TierSet,
)


def build_synthetic(n_pods: int, n_policies: int, rng: random.Random, n_ns: int = None):
    """(pods, namespaces, policies) of the synthetic benchmark cluster."""
    n_ns = n_ns or max(2, n_pods // 250)
    namespaces = {
        f"ns{i}": {"ns": f"ns{i}", "team": f"team{i % 7}"} for i in range(n_ns)
    }
    pods = []
    for i in range(n_pods):
        ns = f"ns{i % n_ns}"
        labels = {
            "pod": f"p{i % 100}",
            "app": f"app{i % 20}",
            "tier": f"tier{i % 5}",
        }
        ip = f"10.{(i >> 16) & 255}.{(i >> 8) & 255}.{i & 255}"
        pods.append((ns, f"pod-{i}", labels, ip))

    policies = []
    for i in range(n_policies):
        ns = f"ns{rng.randrange(n_ns)}"
        target = LabelSelector.make(match_labels={"app": f"app{rng.randrange(20)}"})
        peers = []
        r = rng.random()
        if r < 0.2:
            peers.append(
                NetworkPolicyPeer(
                    ip_block=IPBlock.make(
                        f"10.{rng.randrange(4)}.0.0/16",
                        [f"10.{rng.randrange(4)}.{rng.randrange(8)}.0/24"],
                    )
                )
            )
        else:
            peers.append(
                NetworkPolicyPeer(
                    pod_selector=LabelSelector.make(
                        match_labels={"tier": f"tier{rng.randrange(5)}"}
                    ),
                    namespace_selector=LabelSelector.make(
                        match_labels={"team": f"team{rng.randrange(7)}"}
                    )
                    if rng.random() < 0.5
                    else None,
                )
            )
        ports = [NetworkPolicyPort(protocol="TCP", port=IntOrString(80))]
        if rng.random() < 0.3:
            ports.append(
                NetworkPolicyPort(
                    protocol="UDP", port=IntOrString("serve-81-udp")
                )
            )
        rule_i = NetworkPolicyIngressRule(ports=ports, from_=peers)
        rule_e = NetworkPolicyEgressRule(ports=ports, to=peers)
        types = ["Ingress"] if rng.random() < 0.6 else ["Ingress", "Egress"]
        policies.append(
            NetworkPolicy(
                name=f"bench-{i}",
                namespace=ns,
                spec=NetworkPolicySpec(
                    pod_selector=target,
                    policy_types=types,
                    ingress=[rule_i],
                    egress=[rule_e] if "Egress" in types else [],
                ),
            )
        )
    return pods, namespaces, policies


def bench_tiers() -> TierSet:
    """The benchmark's deterministic ANP/BANP set over build_synthetic's
    labels: overlapping priorities (two at 5), a Deny from app1 to tier0
    on the TCP 80-81 endPort range, a Pass-chain for tier1 into the
    NetworkPolicy tier, an SCTP 82 Allow from team0 namespaces, and a
    BANP default-deny of ingress to app2.  Every rule is an ingress rule."""
    return TierSet(
        anps=[
            AdminNetworkPolicy(
                name="bench-deny-tier0", priority=5,
                subject=TierScope(pod_selector=LabelSelector.make({"tier": "tier0"})),
                ingress=[TierRule(
                    action="Deny",
                    peers=[TierScope(pod_selector=LabelSelector.make({"app": "app1"}))],
                    ports=[TierPort(protocol="TCP", port=IntOrString(80), end_port=81)],
                )],
            ),
            AdminNetworkPolicy(
                name="bench-pass-tier1", priority=5,
                subject=TierScope(pod_selector=LabelSelector.make({"tier": "tier1"})),
                ingress=[TierRule(action="Pass", peers=[TierScope()])],
            ),
            AdminNetworkPolicy(
                name="bench-allow-sctp", priority=9,
                subject=TierScope(),
                ingress=[TierRule(
                    action="Allow",
                    peers=[TierScope(namespace_selector=LabelSelector.make({"team": "team0"}))],
                    ports=[TierPort(protocol="SCTP", port=IntOrString(82))],
                )],
            ),
        ],
        banp=BaselineAdminNetworkPolicy(
            subject=TierScope(pod_selector=LabelSelector.make({"app": "app2"})),
            ingress=[TierRule(action="Deny", peers=[TierScope()])],
        ),
    )


def cidr_cluster(n_pods: int, distinct: int, pool: int, rng: random.Random):
    """The benchmark's ipBlock-heavy cluster (a copy of bench.cidr_case's
    generator, draw for draw): `n_pods` pods in one namespace with two
    label shapes, their IPs drawn from a sorted pool of about `pool`
    addresses, and `distinct` distinct (cidr, excepts) blocks — /32
    splinters on the pool's /24s, /32s over 10.0.0.0/10, /24s, /16s with
    one /24 except, /12-/15s — 64 to a policy, each policy selecting
    every pod and allowing those blocks on ingress and egress, all
    ports.  Returns (pods, namespaces, policies)."""
    namespaces = {"cidr": {"ns": "cidr"}}
    ip_pool = sorted(
        {
            f"10.{rng.randrange(64)}.{rng.randrange(256)}"
            f".{rng.randrange(1, 255)}"
            for _ in range(pool)
        }
    )
    # two label shapes on purpose: the signature entropy comes from the
    # CIDR structure, which is what the TSS stage compresses
    pods = [
        ("cidr", f"p{i}", {"app": f"app{i % 2}"}, ip_pool[i % len(ip_pool)])
        for i in range(n_pods)
    ]
    cidrs: list = []
    seen = set()
    attempts = 0
    while len(cidrs) < distinct and attempts < 64 * distinct:
        attempts += 1
        roll = rng.random()
        if roll < 0.30:
            ip = rng.choice(ip_pool)
            a, b, c, _d = ip.split(".")
            cand = (f"{a}.{b}.{c}.{rng.randrange(256)}/32", ())
        elif roll < 0.55:
            cand = (
                f"10.{rng.randrange(64)}.{rng.randrange(256)}"
                f".{rng.randrange(256)}/32",
                (),
            )
        elif roll < 0.80:
            cand = (
                f"10.{rng.randrange(64)}.{rng.randrange(256)}.0/24",
                (),
            )
        elif roll < 0.92:
            b2 = rng.randrange(64)
            cand = (f"10.{b2}.0.0/16", (f"10.{b2}.{rng.randrange(256)}.0/24",))
        else:
            cand = (f"10.{rng.randrange(64)}.0.0/{rng.choice((12, 14, 15))}", ())
        if cand not in seen:
            seen.add(cand)
            cidrs.append(cand)
    per_rule = 64
    policies = []
    for i in range(0, len(cidrs), per_rule):
        chunk = cidrs[i : i + per_rule]
        peers = [
            NetworkPolicyPeer(ip_block=IPBlock.make(c, list(ex)))
            for c, ex in chunk
        ]
        policies.append(
            NetworkPolicy(
                name=f"cidr-{i // per_rule}",
                namespace="cidr",
                spec=NetworkPolicySpec(
                    pod_selector=LabelSelector.make(),
                    policy_types=["Ingress", "Egress"],
                    ingress=[NetworkPolicyIngressRule(ports=[], from_=peers)],
                    egress=[NetworkPolicyEgressRule(ports=[], to=peers)],
                ),
            )
        )
    return pods, namespaces, policies
