"""Two-level tag taxonomy (reference: generator/tags.go): 10 primary tags,
34 subordinate tags; adding a subordinate auto-adds its primary."""

from __future__ import annotations

from typing import Dict, List

TAG_ACTION = "action"
TAG_TARGET = "target"
TAG_DIRECTION = "direction"
TAG_POLICY_STACK = "policy-stack"
TAG_RULE = "rule"
TAG_PROTOCOL = "protocol"
TAG_PORT = "port"
TAG_PEER_IPBLOCK = "peer-ipblock"
TAG_PEER_PODS = "peer-pods"
TAG_MISCELLANEOUS = "miscellaneous"

TAG_CREATE_POLICY = "create-policy"
TAG_DELETE_POLICY = "delete-policy"
TAG_UPDATE_POLICY = "update-policy"
TAG_CREATE_POD = "create-pod"
TAG_DELETE_POD = "delete-pod"
TAG_SET_POD_LABELS = "set-pod-labels"
TAG_CREATE_NAMESPACE = "create-namespace"
TAG_DELETE_NAMESPACE = "delete-namespace"
TAG_SET_NAMESPACE_LABELS = "set-namespace-labels"

TAG_TARGET_NAMESPACE = "target-namespace"
TAG_TARGET_POD_SELECTOR = "target-pod-selector"

TAG_INGRESS = "ingress"
TAG_EGRESS = "egress"

TAG_DENY_ALL = "deny-all"
TAG_ALLOW_ALL = "allow-all"
TAG_ANY_PEER = "any-peer"
TAG_ANY_PORT_PROTOCOL = "any-port-protocol"
TAG_MULTI_PEER = "multi-peer"
TAG_MULTI_PORT_PROTOCOL = "multi-port/protocol"

TAG_ALL_PODS = "all-pods"
TAG_PODS_BY_LABEL = "pods-by-label"
TAG_ALL_NAMESPACES = "all-namespaces"
TAG_NAMESPACES_BY_LABEL = "namespaces-by-label"
TAG_POLICY_NAMESPACE = "policy-namespace"

TAG_IP_BLOCK_NO_EXCEPT = "ip-block-no-except"
TAG_IP_BLOCK_WITH_EXCEPT = "ip-block-with-except"

TAG_ANY_PORT = "any-port"
TAG_NUMBERED_PORT = "numbered-port"
TAG_NAMED_PORT = "named-port"

TAG_TCP = "tcp"
TAG_UDP = "udp"
TAG_SCTP = "sctp"

TAG_PATHOLOGICAL = "pathological"
TAG_CONFLICT = "conflict"
TAG_EXAMPLE = "example"
TAG_UPSTREAM_E2E = "upstream-e2e"

# precedence-tier subordinates (the ANP/BANP conformance family,
# generator/anp_cases.py) — filed under the previously-empty
# policy-stack primary: tier cases are exactly about how stacked
# policy layers compose
TAG_ANP = "admin-network-policy"
TAG_BANP = "baseline-admin-network-policy"
TAG_TIER_PASS = "tier-pass"
TAG_DEFAULT_DENY_NS = "per-namespace-default-deny"

ALL_TAGS: Dict[str, List[str]] = {
    TAG_ACTION: [
        TAG_CREATE_POLICY,
        TAG_DELETE_POLICY,
        TAG_UPDATE_POLICY,
        TAG_CREATE_POD,
        TAG_DELETE_POD,
        TAG_SET_POD_LABELS,
        TAG_CREATE_NAMESPACE,
        TAG_DELETE_NAMESPACE,
        TAG_SET_NAMESPACE_LABELS,
    ],
    TAG_TARGET: [TAG_TARGET_NAMESPACE, TAG_TARGET_POD_SELECTOR],
    TAG_DIRECTION: [TAG_INGRESS, TAG_EGRESS],
    TAG_POLICY_STACK: [
        TAG_ANP,
        TAG_BANP,
        TAG_TIER_PASS,
        TAG_DEFAULT_DENY_NS,
    ],
    TAG_RULE: [
        TAG_DENY_ALL,
        TAG_ALLOW_ALL,
        TAG_ANY_PEER,
        TAG_ANY_PORT_PROTOCOL,
        TAG_MULTI_PEER,
        TAG_MULTI_PORT_PROTOCOL,
    ],
    TAG_PEER_PODS: [
        TAG_ALL_PODS,
        TAG_PODS_BY_LABEL,
        TAG_ALL_NAMESPACES,
        TAG_NAMESPACES_BY_LABEL,
        TAG_POLICY_NAMESPACE,
    ],
    TAG_PEER_IPBLOCK: [TAG_IP_BLOCK_NO_EXCEPT, TAG_IP_BLOCK_WITH_EXCEPT],
    TAG_PORT: [TAG_ANY_PORT, TAG_NUMBERED_PORT, TAG_NAMED_PORT],
    TAG_PROTOCOL: [TAG_TCP, TAG_UDP, TAG_SCTP],
    TAG_MISCELLANEOUS: [
        TAG_PATHOLOGICAL,
        TAG_CONFLICT,
        TAG_EXAMPLE,
        TAG_UPSTREAM_E2E,
    ],
}

TAG_SET: Dict[str, bool] = {}
TAG_SLICE: List[str] = []
TAG_SUB_TO_PRIMARY: Dict[str, str] = {}

for _primary, _subs in ALL_TAGS.items():
    TAG_SET[_primary] = True
    TAG_SLICE.append(_primary)
    for _sub in _subs:
        TAG_SET[_sub] = True
        TAG_SLICE.append(_sub)
        if _sub in TAG_SUB_TO_PRIMARY:
            raise ValueError(f"subordinate tag {_sub} has multiple owners")
        TAG_SUB_TO_PRIMARY[_sub] = _primary
TAG_SLICE.sort()


def must_get_primary_tag(sub: str) -> str:
    if sub not in TAG_SUB_TO_PRIMARY:
        raise KeyError(f"no primary tag found for {sub}")
    return TAG_SUB_TO_PRIMARY[sub]


class StringSet(dict):
    """tags.go:197-248: a set that auto-adds each subordinate's primary."""

    @staticmethod
    def of(*elems: str) -> "StringSet":
        s = StringSet()
        for e in elems:
            s.add(e)
        return s

    def add(self, key: str) -> None:
        self[key] = True
        if key in TAG_SUB_TO_PRIMARY:
            self[TAG_SUB_TO_PRIMARY[key]] = True
        elif key not in ALL_TAGS:
            raise KeyError(f"tag {key} is neither primary nor subordinate")

    def keys_sorted(self) -> List[str]:
        return sorted(self.keys())

    def contains_any(self, elems: List[str]) -> bool:
        return any(e in self for e in elems)

    def group_tags(self) -> Dict[str, List[str]]:
        grouped: Dict[str, List[str]] = {}
        for tag in self:
            if tag in ALL_TAGS:
                grouped.setdefault(tag, [])
            else:
                primary = must_get_primary_tag(tag)
                grouped.setdefault(primary, []).append(tag)
        return grouped


def count_test_cases_by_tag(test_cases) -> Dict[str, int]:
    counts = {tag: 0 for tag in TAG_SET}
    for tc in test_cases:
        for key in tc.tags:
            counts[key] += 1
    return counts


def validate_tags(tags: List[str]) -> None:
    invalid = [t for t in tags if t not in TAG_SET]
    if invalid:
        raise ValueError(f"invalid tags: {', '.join(invalid)}")
