"""The benchmark's cluster generators, frozen, as plain Kubernetes objects.

`build_synthetic` is a draw-for-draw copy of the reference project's
headline cluster generator (bench.build_synthetic, and its copy in the
port's synthetic.py): from the same `random.Random` it yields the same
pods, namespaces and policies, the policies as NetworkPolicy API dicts
(networking.k8s.io/v1) instead of objects of the program.  `bench_tiers`
is the matching AdminNetworkPolicy / BaselineAdminNetworkPolicy set
(policy.networking.k8s.io/v1alpha1) as API dicts.

Kept here, under the benchmark, so that a change to the program cannot
move the benchmark's inputs.  Nothing in this package imports the
program.

Shape: n_pods pods over max(2, n_pods // 250) namespaces, each pod with
three labels (pod, app, tier) and a distinct 10.x.y.z address; each
policy selects one app in one namespace and allows TCP 80 (plus the
named UDP port serve-81-udp for 30% of them) from one peer: an ipBlock
with one except (20%) or a tier pod selector, half of them also scoped
to a team namespace selector.  40% of the policies also cover egress.
"""

from __future__ import annotations

import random
from typing import Dict, List, Tuple

#: (namespace, name, labels, ip)
Pod = Tuple[str, str, Dict[str, str], str]


def build_synthetic(
    n_pods: int, n_policies: int, rng: random.Random, n_ns: int = None
) -> Tuple[List[Pod], Dict[str, Dict[str, str]], List[dict]]:
    """(pods, namespaces, policies) of the synthetic benchmark cluster."""
    n_ns = n_ns or max(2, n_pods // 250)
    namespaces = {f"ns{i}": {"ns": f"ns{i}", "team": f"team{i % 7}"} for i in range(n_ns)}
    pods = []
    for i in range(n_pods):
        labels = {"pod": f"p{i % 100}", "app": f"app{i % 20}", "tier": f"tier{i % 5}"}
        ip = f"10.{(i >> 16) & 255}.{(i >> 8) & 255}.{i & 255}"
        pods.append((f"ns{i % n_ns}", f"pod-{i}", labels, ip))

    policies = []
    for i in range(n_policies):
        ns = f"ns{rng.randrange(n_ns)}"
        target = {"matchLabels": {"app": f"app{rng.randrange(20)}"}}
        if rng.random() < 0.2:
            cidr = f"10.{rng.randrange(4)}.0.0/16"
            exc = f"10.{rng.randrange(4)}.{rng.randrange(8)}.0/24"
            peer = {"ipBlock": {"cidr": cidr, "except": [exc]}}
        else:
            peer = {"podSelector": {"matchLabels": {"tier": f"tier{rng.randrange(5)}"}}}
            if rng.random() < 0.5:
                peer["namespaceSelector"] = {"matchLabels": {"team": f"team{rng.randrange(7)}"}}
        ports = [{"protocol": "TCP", "port": 80}]
        if rng.random() < 0.3:
            ports.append({"protocol": "UDP", "port": "serve-81-udp"})
        types = ["Ingress"] if rng.random() < 0.6 else ["Ingress", "Egress"]
        spec = {
            "podSelector": target,
            "policyTypes": types,
            "ingress": [{"ports": ports, "from": [peer]}],
        }
        if "Egress" in types:
            spec["egress"] = [{"ports": ports, "to": [peer]}]
        policies.append({
            "apiVersion": "networking.k8s.io/v1",
            "kind": "NetworkPolicy",
            "metadata": {"name": f"bench-{i}", "namespace": ns},
            "spec": spec,
        })
    return pods, namespaces, policies


def _pods_scope(pod_labels: Dict[str, str]) -> dict:
    return {"pods": {"namespaceSelector": {}, "podSelector": {"matchLabels": pod_labels}}}


def bench_tiers() -> Tuple[List[dict], dict]:
    """(ANPs, BANP) of the benchmark's admin tiers over build_synthetic's
    labels: overlapping priorities (two at 5), a Deny from app1 to tier0
    on the TCP 80-81 port range, a Pass for tier1 into the NetworkPolicy
    tier, an SCTP 82 Allow from team0 namespaces, and a BANP default-deny
    of ingress to app2.  Every rule is an ingress rule."""
    api = "policy.networking.k8s.io/v1alpha1"

    def anp(name, priority, subject, rule):
        return {
            "apiVersion": api, "kind": "AdminNetworkPolicy", "metadata": {"name": name},
            "spec": {"priority": priority, "subject": subject, "ingress": [rule], "egress": []},
        }

    anps = [
        anp("bench-deny-tier0", 5, _pods_scope({"tier": "tier0"}), {
            "action": "Deny",
            "from": [_pods_scope({"app": "app1"})],
            "ports": [{"portRange": {"protocol": "TCP", "start": 80, "end": 81}}],
        }),
        anp("bench-pass-tier1", 5, _pods_scope({"tier": "tier1"}), {
            "action": "Pass", "from": [{"namespaces": {}}],
        }),
        anp("bench-allow-sctp", 9, {"namespaces": {}}, {
            "action": "Allow",
            "from": [{"namespaces": {"matchLabels": {"team": "team0"}}}],
            "ports": [{"portNumber": {"protocol": "SCTP", "port": 82}}],
        }),
    ]
    banp = {
        "apiVersion": api, "kind": "BaselineAdminNetworkPolicy", "metadata": {"name": "default"},
        "spec": {
            "subject": _pods_scope({"app": "app2"}),
            "ingress": [{"action": "Deny", "from": [{"namespaces": {}}]}],
            "egress": [],
        },
    }
    return anps, banp
