"""AdminNetworkPolicy / BaselineAdminNetworkPolicy object model.

Mirrors the subset of sig-network-policy-api types the precedence-tier
subsystem consumes (AdminNetworkPolicy v1alpha1 and its baseline
sibling), as plain dataclasses with dict round-trips — no kubernetes
client dependency, same style as kube/netpol.py.

The verdict lattice these types feed:

    ANP tier   — all AdminNetworkPolicy rules of a direction, ordered by
                 (priority asc, policy name, rule index); the FIRST rule
                 whose subject matches the target pod, peer matches the
                 other pod, and port spec matches the case decides:
                 Allow / Deny are final, Pass falls through.
    NP tier    — networkingv1 semantics unchanged (matcher/core.py): if
                 any NetworkPolicy target selects the pod, the verdict
                 is final (allow iff >= 1 matching target allows);
                 otherwise fall through.
    BANP tier  — the single BaselineAdminNetworkPolicy's rules in
                 declaration order, first match Allow/Deny; no Pass.
    default    — allow.

Nil-vs-empty carries weight exactly like networkingv1: an ABSENT
selector in a subject/peer "pods" variant means match-all, and an empty
selector also matches everything (LabelSelector semantics) — both are
preserved through dict round-trips.

Priority ties: the upstream API leaves equal-priority ordering
undefined.  This implementation totalizes it as (priority, policy name,
rule index) so the kernel and the scalar oracle sort identically — the
fuzzer generates overlapping priorities on purpose to pin that the two
sides can never disagree about the resolution order.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from ..kube.netpol import IntOrString, LabelSelector, PROTOCOL_TCP

ACTION_ALLOW = "Allow"
ACTION_DENY = "Deny"
ACTION_PASS = "Pass"

ANP_ACTIONS = (ACTION_ALLOW, ACTION_DENY, ACTION_PASS)
BANP_ACTIONS = (ACTION_ALLOW, ACTION_DENY)

#: upstream priority bounds (AdminNetworkPolicy spec.priority)
PRIORITY_MIN = 0
PRIORITY_MAX = 1000

#: the sole BaselineAdminNetworkPolicy must be named "default" upstream;
#: parsing tolerates any name, serialization defaults to this
BANP_NAME = "default"


@dataclass
class TierScope:
    """A subject or peer scope: the "namespaces" variant (ns selector
    only — every pod of the matching namespaces) or the "pods" variant
    (ns selector AND pod selector).  `namespace_selector` is never None
    (absent encodes as the empty = match-all selector); `pod_selector`
    None means the namespaces variant."""

    namespace_selector: LabelSelector = field(
        default_factory=LabelSelector.make
    )
    pod_selector: Optional[LabelSelector] = None

    def to_dict(self) -> dict:
        if self.pod_selector is None:
            return {"namespaces": self.namespace_selector.to_dict()}
        return {
            "pods": {
                "namespaceSelector": self.namespace_selector.to_dict(),
                "podSelector": self.pod_selector.to_dict(),
            }
        }

    @staticmethod
    def from_dict(d: Optional[dict]) -> "TierScope":
        d = d or {}
        if "pods" in d:
            pods = d.get("pods") or {}
            return TierScope(
                namespace_selector=LabelSelector.from_dict(
                    pods.get("namespaceSelector")
                )
                or LabelSelector.make(),
                pod_selector=LabelSelector.from_dict(pods.get("podSelector"))
                or LabelSelector.make(),
            )
        return TierScope(
            namespace_selector=LabelSelector.from_dict(d.get("namespaces"))
            or LabelSelector.make(),
            pod_selector=None,
        )


@dataclass
class TierPort:
    """One ANP/BANP port term: portNumber {protocol, port}, portRange
    {protocol, start, end}, or namedPort.  Maps 1:1 onto the matcher
    port vocabulary (PortProtocolMatcher / PortRangeMatcher), so the
    encoding reuses the existing port-spec slabs (items + lo/hi int32
    range pairs with the same sentinel conventions)."""

    protocol: str = PROTOCOL_TCP
    port: Optional[IntOrString] = None  # int or named; None only for ranges
    end_port: Optional[int] = None  # set => numeric range [port, end_port]

    def validate(self) -> None:
        if self.end_port is not None:
            if self.port is None or self.port.is_string:
                raise ValueError(
                    "invalid tier port range: start must be numeric"
                )
            if self.end_port < self.port.int_value:
                raise ValueError(
                    f"invalid tier port range: end {self.end_port} < "
                    f"start {self.port.int_value}"
                )
        elif self.port is None:
            raise ValueError("invalid tier port: need port or portRange")

    def to_dict(self) -> dict:
        if self.end_port is not None:
            return {
                "portRange": {
                    "protocol": self.protocol,
                    "start": self.port.int_value,
                    "end": self.end_port,
                }
            }
        if self.port.is_string:
            return {"namedPort": self.port.str_value}
        return {
            "portNumber": {
                "protocol": self.protocol,
                "port": self.port.int_value,
            }
        }

    @staticmethod
    def from_dict(d: dict) -> "TierPort":
        if "portRange" in d:
            r = d["portRange"] or {}
            return TierPort(
                protocol=r.get("protocol") or PROTOCOL_TCP,
                port=IntOrString(int(r["start"])),
                end_port=int(r["end"]),
            )
        if "namedPort" in d:
            # upstream named ports carry no protocol; the resolved port
            # name match is protocol-checked at probe time, so default
            # TCP mirrors networkingv1's nil-protocol default
            return TierPort(
                protocol=PROTOCOL_TCP, port=IntOrString(str(d["namedPort"]))
            )
        p = d.get("portNumber") or {}
        return TierPort(
            protocol=p.get("protocol") or PROTOCOL_TCP,
            port=IntOrString(int(p["port"])),
        )


@dataclass
class TierRule:
    """One ANP/BANP ingress or egress rule: action + peer scopes +
    optional port terms (None/empty = all ports, mirroring the upstream
    "no ports field = all traffic" semantics)."""

    action: str
    peers: List[TierScope] = field(default_factory=list)
    ports: Optional[List[TierPort]] = None
    name: str = ""

    def to_dict(self, is_ingress: bool) -> dict:
        d: Dict[str, Any] = {"action": self.action}
        if self.name:
            d["name"] = self.name
        d["from" if is_ingress else "to"] = [p.to_dict() for p in self.peers]
        if self.ports is not None:
            d["ports"] = [p.to_dict() for p in self.ports]
        return d

    @staticmethod
    def from_dict(d: dict, is_ingress: bool) -> "TierRule":
        ports = d.get("ports")
        return TierRule(
            action=d.get("action", ""),
            name=d.get("name", "") or "",
            peers=[
                TierScope.from_dict(p)
                for p in (d.get("from" if is_ingress else "to") or [])
            ],
            ports=None
            if ports is None
            else [TierPort.from_dict(p) for p in ports],
        )


@dataclass
class AdminNetworkPolicy:
    """AdminNetworkPolicy: cluster-scoped, priority-ordered, with
    Allow/Deny/Pass verdicts that short-circuit by priority."""

    name: str
    priority: int
    subject: TierScope = field(default_factory=TierScope)
    ingress: List[TierRule] = field(default_factory=list)
    egress: List[TierRule] = field(default_factory=list)

    def validate(self) -> None:
        if not self.name:
            raise ValueError("AdminNetworkPolicy needs a name")
        if not (PRIORITY_MIN <= self.priority <= PRIORITY_MAX):
            raise ValueError(
                f"AdminNetworkPolicy {self.name!r}: priority "
                f"{self.priority} outside [{PRIORITY_MIN}, {PRIORITY_MAX}]"
            )
        for direction, rules in (("ingress", self.ingress), ("egress", self.egress)):
            for i, r in enumerate(rules):
                if r.action not in ANP_ACTIONS:
                    raise ValueError(
                        f"AdminNetworkPolicy {self.name!r} {direction}[{i}]: "
                        f"invalid action {r.action!r} (want one of "
                        f"{ANP_ACTIONS})"
                    )
                for p in r.ports or ():
                    p.validate()

    def to_dict(self) -> dict:
        return {
            "apiVersion": "policy.networking.k8s.io/v1alpha1",
            "kind": "AdminNetworkPolicy",
            "metadata": {"name": self.name},
            "spec": {
                "priority": self.priority,
                "subject": self.subject.to_dict(),
                "ingress": [r.to_dict(True) for r in self.ingress],
                "egress": [r.to_dict(False) for r in self.egress],
            },
        }

    @staticmethod
    def from_dict(d: dict) -> "AdminNetworkPolicy":
        spec = d.get("spec") or {}
        name = (d.get("metadata") or {}).get("name", "") or d.get("name", "")
        if "priority" not in spec:
            # upstream makes spec.priority REQUIRED; defaulting a missing
            # field to 0 would silently make a malformed payload the
            # cluster's highest-priority ANP — reject it at parse instead
            # (the serve layer's pre-mutation validation relies on this)
            raise ValueError(
                f"AdminNetworkPolicy {name!r}: spec.priority is required"
            )
        anp = AdminNetworkPolicy(
            name=name,
            priority=int(spec["priority"]),
            subject=TierScope.from_dict(spec.get("subject")),
            ingress=[
                TierRule.from_dict(r, True) for r in (spec.get("ingress") or [])
            ],
            egress=[
                TierRule.from_dict(r, False) for r in (spec.get("egress") or [])
            ],
        )
        anp.validate()
        return anp

    def copy(self) -> "AdminNetworkPolicy":
        return AdminNetworkPolicy.from_dict(self.to_dict())


@dataclass
class BaselineAdminNetworkPolicy:
    """BaselineAdminNetworkPolicy: the cluster's single default tier —
    evaluated only for pods no NetworkPolicy selects, rules in
    declaration order, Allow/Deny only (no Pass, nothing below to pass
    to except default-allow)."""

    subject: TierScope = field(default_factory=TierScope)
    ingress: List[TierRule] = field(default_factory=list)
    egress: List[TierRule] = field(default_factory=list)
    name: str = BANP_NAME

    def validate(self) -> None:
        for direction, rules in (("ingress", self.ingress), ("egress", self.egress)):
            for i, r in enumerate(rules):
                if r.action not in BANP_ACTIONS:
                    raise ValueError(
                        f"BaselineAdminNetworkPolicy {direction}[{i}]: "
                        f"invalid action {r.action!r} (want one of "
                        f"{BANP_ACTIONS})"
                    )
                for p in r.ports or ():
                    p.validate()

    def to_dict(self) -> dict:
        return {
            "apiVersion": "policy.networking.k8s.io/v1alpha1",
            "kind": "BaselineAdminNetworkPolicy",
            "metadata": {"name": self.name or BANP_NAME},
            "spec": {
                "subject": self.subject.to_dict(),
                "ingress": [r.to_dict(True) for r in self.ingress],
                "egress": [r.to_dict(False) for r in self.egress],
            },
        }

    @staticmethod
    def from_dict(d: dict) -> "BaselineAdminNetworkPolicy":
        spec = d.get("spec") or {}
        banp = BaselineAdminNetworkPolicy(
            name=(d.get("metadata") or {}).get("name", "") or BANP_NAME,
            subject=TierScope.from_dict(spec.get("subject")),
            ingress=[
                TierRule.from_dict(r, True) for r in (spec.get("ingress") or [])
            ],
            egress=[
                TierRule.from_dict(r, False) for r in (spec.get("egress") or [])
            ],
        )
        banp.validate()
        return banp

    def copy(self) -> "BaselineAdminNetworkPolicy":
        return BaselineAdminNetworkPolicy.from_dict(self.to_dict())


@dataclass(frozen=True)
class OrderedRule:
    """One rule in resolution order: `rank` is the rule's position in
    the total evaluation order of its tier+direction (the int32 priority
    slab the kernel min-reduces over), `policy` the owning ANP/BANP."""

    rank: int
    policy: Any  # AdminNetworkPolicy | BaselineAdminNetworkPolicy
    rule: TierRule


@dataclass
class TierSet:
    """The admin tiers of one cluster: every AdminNetworkPolicy plus at
    most one BaselineAdminNetworkPolicy.  `ordered_rules` defines THE
    resolution order both the scalar oracle (matcher/tiered.py) and the
    kernel slabs (engine/encoding.py encode_tiers) consume — a single
    definition so they cannot diverge."""

    anps: List[AdminNetworkPolicy] = field(default_factory=list)
    banp: Optional[BaselineAdminNetworkPolicy] = None

    def __bool__(self) -> bool:
        return bool(self.anps) or self.banp is not None

    def validate(self) -> None:
        seen = set()
        for a in self.anps:
            a.validate()
            if a.name in seen:
                raise ValueError(
                    f"duplicate AdminNetworkPolicy name {a.name!r}"
                )
            seen.add(a.name)
        if self.banp is not None:
            self.banp.validate()

    def sorted_anps(self) -> List[AdminNetworkPolicy]:
        """(priority asc, name) — the deterministic totalization of the
        upstream's undefined equal-priority order."""
        return sorted(self.anps, key=lambda a: (a.priority, a.name))

    def ordered_rules(self, is_ingress: bool, tier: str) -> List[OrderedRule]:
        """Rules of `tier` ("anp" | "banp") for one direction, in
        resolution order with their global ranks assigned."""
        out: List[OrderedRule] = []
        if tier == "anp":
            for a in self.sorted_anps():
                for r in a.ingress if is_ingress else a.egress:
                    out.append(OrderedRule(rank=len(out), policy=a, rule=r))
        elif tier == "banp":
            if self.banp is not None:
                for r in self.banp.ingress if is_ingress else self.banp.egress:
                    out.append(
                        OrderedRule(rank=len(out), policy=self.banp, rule=r)
                    )
        else:
            raise ValueError(f"unknown tier {tier!r}")
        return out

    def rule_count(self) -> Dict[str, int]:
        return {
            "anp": sum(len(a.ingress) + len(a.egress) for a in self.anps),
            "banp": 0
            if self.banp is None
            else len(self.banp.ingress) + len(self.banp.egress),
        }

    def copy(self) -> "TierSet":
        return TierSet(
            anps=[a.copy() for a in self.anps],
            banp=None if self.banp is None else self.banp.copy(),
        )


def parse_tier_object(d: dict):
    """Parse one ANP or BANP dict by its `kind` (the YAML/wire entry
    point the serve layer and the CLI share)."""
    kind = d.get("kind", "")
    if kind == "AdminNetworkPolicy":
        return AdminNetworkPolicy.from_dict(d)
    if kind == "BaselineAdminNetworkPolicy":
        return BaselineAdminNetworkPolicy.from_dict(d)
    raise ValueError(
        f"unknown tier object kind {kind!r} (want AdminNetworkPolicy or "
        f"BaselineAdminNetworkPolicy)"
    )


def load_tier_set_from_yaml(text: str) -> TierSet:
    """YAML docs of AdminNetworkPolicy / BaselineAdminNetworkPolicy
    objects (other kinds rejected) -> a validated TierSet."""
    import yaml

    anps: List[AdminNetworkPolicy] = []
    banp: Optional[BaselineAdminNetworkPolicy] = None
    for doc in yaml.safe_load_all(text):
        if doc is None:
            continue
        items = doc if isinstance(doc, list) else [doc]
        for item in items:
            obj = parse_tier_object(item)
            if isinstance(obj, AdminNetworkPolicy):
                anps.append(obj)
            else:
                if banp is not None:
                    raise ValueError(
                        "more than one BaselineAdminNetworkPolicy (the "
                        "baseline tier is a cluster singleton)"
                    )
                banp = obj
    ts = TierSet(anps=anps, banp=banp)
    ts.validate()
    return ts


def load_tier_set_from_path(path: str) -> TierSet:
    """File => parse it; directory => recursive walk of .yml/.yaml files
    (the kube/yaml_io.load_policies_from_path convention)."""
    import os

    if not os.path.isdir(path):
        with open(path) as f:
            return load_tier_set_from_yaml(f.read())
    anps: List[AdminNetworkPolicy] = []
    banp: Optional[BaselineAdminNetworkPolicy] = None
    for root, _dirs, files in sorted(os.walk(path)):
        for name in sorted(files):
            if not name.endswith((".yml", ".yaml")):
                continue
            with open(os.path.join(root, name)) as f:
                ts = load_tier_set_from_yaml(f.read())
            anps.extend(ts.anps)
            if ts.banp is not None:
                if banp is not None:
                    raise ValueError(
                        "more than one BaselineAdminNetworkPolicy across "
                        f"{path!r} (the baseline tier is a cluster "
                        "singleton)"
                    )
                banp = ts.banp
    ts = TierSet(anps=anps, banp=banp)
    ts.validate()
    return ts


def scope_matches(
    scope: TierScope,
    namespace_labels: Dict[str, str],
    pod_labels: Dict[str, str],
) -> bool:
    """Scalar scope matching (the oracle's primitive): the namespaces
    variant checks namespace labels only; the pods variant checks both.
    Shared with nothing tensor-side on purpose — the kernel derives the
    same semantics from the selector slabs, and the fuzzer's
    differential gate pins the two."""
    from ..kube.labels import is_labels_match_label_selector

    if not is_labels_match_label_selector(
        namespace_labels, scope.namespace_selector
    ):
        return False
    if scope.pod_selector is None:
        return True
    return is_labels_match_label_selector(pod_labels, scope.pod_selector)


__all__ = [
    "ACTION_ALLOW",
    "ACTION_DENY",
    "ACTION_PASS",
    "ANP_ACTIONS",
    "BANP_ACTIONS",
    "AdminNetworkPolicy",
    "BaselineAdminNetworkPolicy",
    "OrderedRule",
    "TierPort",
    "TierRule",
    "TierScope",
    "TierSet",
    "load_tier_set_from_path",
    "load_tier_set_from_yaml",
    "parse_tier_object",
    "scope_matches",
]
