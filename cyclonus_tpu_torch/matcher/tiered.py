"""Scalar evaluation of the full precedence-tier verdict lattice — the
100%-parity reference for the tiered kernels.

Extends the networkingv1 oracle (matcher/core.py Policy, kept untouched)
with the AdminNetworkPolicy / BaselineAdminNetworkPolicy tiers
(tiers/model.py).  Per direction:

  1. external target pod  -> allow (mirrors policy.go:149-153; the admin
     tiers are cluster-internal and cannot select an external endpoint);
  2. ANP tier: scan TierSet.ordered_rules(direction, "anp") in order;
     the first rule whose subject matches the TARGET pod, peer matches
     the OTHER pod, and port term matches the traffic decides —
     Allow -> True, Deny -> False, Pass -> fall through;
  3. NP tier: networkingv1 semantics verbatim — if any compiled target
     selects the pod, allowed iff >= 1 matching target allows (FINAL,
     BANP never sees a NetworkPolicy-selected pod);
  4. BANP tier: first matching rule in declaration order, Allow/Deny;
  5. default allow.

External PEERS never match an ANP/BANP scope (selectors are
cluster-internal), so admin rules simply never fire for them and the
verdict falls through to the NP tier — identical to upstream semantics
where admin policies constrain cluster workloads only.

Port matching reuses the matcher's own PortMatcher classes: each tier
rule's port terms compile once into AllPortMatcher / SpecificPortMatcher
(TierPort maps 1:1 onto PortProtocolMatcher / PortRangeMatcher), so the
lattice inherits the port semantics every parity suite already pins.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ..tiers.model import (
    ACTION_ALLOW,
    ACTION_DENY,
    ACTION_PASS,
    OrderedRule,
    TierRule,
    TierSet,
    scope_matches,
)
from .core import (
    AllPortMatcher,
    Policy,
    PortMatcher,
    PortProtocolMatcher,
    PortRangeMatcher,
    SpecificPortMatcher,
    Traffic,
    TrafficPeer,
)


def compile_tier_port_matcher(rule: TierRule) -> PortMatcher:
    """The rule's port terms as a matcher-core PortMatcher (None/empty
    ports = all traffic)."""
    if not rule.ports:
        return AllPortMatcher()
    m = SpecificPortMatcher()
    for tp in rule.ports:
        if tp.end_port is not None:
            m.port_ranges.append(
                PortRangeMatcher(
                    from_port=tp.port.int_value,
                    to_port=tp.end_port,
                    protocol=tp.protocol,
                )
            )
        else:
            m.ports.append(
                PortProtocolMatcher(port=tp.port, protocol=tp.protocol)
            )
    return m


class _CompiledRule:
    __slots__ = ("ordered", "port_matcher")

    def __init__(self, ordered: OrderedRule):
        self.ordered = ordered
        self.port_matcher = compile_tier_port_matcher(ordered.rule)


class TieredPolicy:
    """The composed lattice: a TierSet over a compiled networkingv1
    Policy.  `policy` may be shared/mutated externally exactly like the
    plain oracle; the tier rules compile once at construction."""

    def __init__(self, policy: Policy, tiers: Optional[TierSet] = None):
        self.policy = policy
        self.tiers = tiers or TierSet()
        self.tiers.validate()
        self._compiled: Dict[Tuple[bool, str], List[_CompiledRule]] = {}
        for is_ingress in (True, False):
            for tier in ("anp", "banp"):
                self._compiled[(is_ingress, tier)] = [
                    _CompiledRule(o)
                    for o in self.tiers.ordered_rules(is_ingress, tier)
                ]

    # --- scalar lattice ---------------------------------------------------

    def _first_match(
        self, tier: str, is_ingress: bool, traffic: Traffic
    ) -> Optional[_CompiledRule]:
        if is_ingress:
            target_peer, other = traffic.destination, traffic.source
        else:
            target_peer, other = traffic.source, traffic.destination
        if target_peer.internal is None or other.internal is None:
            # admin scopes are cluster-internal: external endpoints
            # never match, so the tier yields nothing
            return None
        t_int, o_int = target_peer.internal, other.internal
        for cr in self._compiled[(is_ingress, tier)]:
            if not scope_matches(
                cr.ordered.policy.subject, t_int.namespace_labels,
                t_int.pod_labels,
            ):
                continue
            if not any(
                scope_matches(p, o_int.namespace_labels, o_int.pod_labels)
                for p in cr.ordered.rule.peers
            ):
                continue
            if not cr.port_matcher.allows(
                traffic.resolved_port,
                traffic.resolved_port_name,
                traffic.protocol,
            ):
                continue
            return cr
        return None

    def direction_allowed(
        self, traffic: Traffic, is_ingress: bool
    ) -> Tuple[bool, str]:
        """(allowed, deciding tier) for one direction; tier is one of
        "external" | "anp" | "np" | "banp" | "default"."""
        target_peer: TrafficPeer = (
            traffic.destination if is_ingress else traffic.source
        )
        if target_peer.internal is None:
            return True, "external"
        hit = self._first_match("anp", is_ingress, traffic)
        if hit is not None and hit.ordered.rule.action != ACTION_PASS:
            return hit.ordered.rule.action == ACTION_ALLOW, "anp"
        # NP tier (networkingv1, unchanged): decided iff any target
        # selects the pod
        matching = self.policy.targets_applying_to_pod(
            is_ingress, target_peer.internal.namespace,
            target_peer.internal.pod_labels,
        )
        if matching:
            peer = traffic.source if is_ingress else traffic.destination
            allowed = any(
                t.allows(
                    peer,
                    traffic.resolved_port,
                    traffic.resolved_port_name,
                    traffic.protocol,
                )
                for t in matching
            )
            return allowed, "np"
        hit = self._first_match("banp", is_ingress, traffic)
        if hit is not None:
            # validate() pins BANP actions to Allow/Deny
            assert hit.ordered.rule.action in (ACTION_ALLOW, ACTION_DENY)
            return hit.ordered.rule.action == ACTION_ALLOW, "banp"
        return True, "default"

    def is_traffic_allowed(self, traffic: Traffic) -> Tuple[bool, bool, bool]:
        """(ingress, egress, combined) allow bits — the truth-table shape
        every differential gate compares."""
        ingress, _ = self.direction_allowed(traffic, True)
        egress, _ = self.direction_allowed(traffic, False)
        return ingress, egress, ingress and egress

    def explain(self, traffic: Traffic) -> Dict[str, str]:
        """{direction: deciding tier} for reports and tests."""
        return {
            "ingress": self.direction_allowed(traffic, True)[1],
            "egress": self.direction_allowed(traffic, False)[1],
        }


def tiered_oracle_verdicts(
    policy: Policy, tiers: Optional[TierSet], traffic: Traffic
) -> Tuple[bool, bool, bool]:
    """One-shot tiered verdicts of one Traffic: with no
    tiers it defers to the plain oracle (bit-identical by construction —
    the acceptance criterion the zero-ANP suites rest on)."""
    if not tiers:
        r = policy.is_traffic_allowed(traffic)
        return (r.ingress.is_allowed, r.egress.is_allowed, r.is_allowed)
    return TieredPolicy(policy, tiers).is_traffic_allowed(traffic)


__all__ = [
    "TieredPolicy",
    "compile_tier_port_matcher",
    "tiered_oracle_verdicts",
]
