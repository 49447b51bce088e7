"""Kubernetes NetworkPolicy object model as plain dataclasses.

Mirrors the subset of k8s.io/api types the reference consumes
(networkingv1.NetworkPolicy and friends; see reference pkg/matcher/builder.go),
without any kubernetes client dependency.  The nil-vs-empty distinctions that
carry semantic weight in the k8s API are preserved:

  * ``NetworkPolicyPeer.pod_selector`` / ``namespace_selector``: ``None`` vs
    empty selector mean different things (builder.go:115-142).
  * ``NetworkPolicyPort.port``: ``None`` means "all ports on this protocol"
    (portmatcher.go:26-39).
  * rule-level ``ports`` / ``peers`` empty means "all" (builder.go:79-88).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Union

PROTOCOL_TCP = "TCP"
PROTOCOL_UDP = "UDP"
PROTOCOL_SCTP = "SCTP"

POLICY_TYPE_INGRESS = "Ingress"
POLICY_TYPE_EGRESS = "Egress"

NAMESPACE_DEFAULT = "default"


class IntOrString:
    """k8s intstr.IntOrString: a value that is either an int port or a named port."""

    __slots__ = ("value",)

    def __init__(self, value: Union[int, str]):
        if isinstance(value, bool) or not isinstance(value, (int, str)):
            raise TypeError(f"IntOrString requires int or str, got {type(value)}")
        self.value = value

    @property
    def is_int(self) -> bool:
        return isinstance(self.value, int)

    @property
    def is_string(self) -> bool:
        return isinstance(self.value, str)

    @property
    def int_value(self) -> int:
        if not self.is_int:
            raise ValueError(f"not an int port: {self.value!r}")
        return self.value

    @property
    def str_value(self) -> str:
        if not self.is_string:
            raise ValueError(f"not a named port: {self.value!r}")
        return self.value

    def __eq__(self, other) -> bool:
        return isinstance(other, IntOrString) and self.value == other.value

    def __hash__(self) -> int:
        return hash((type(self.value) is int, self.value))

    def __repr__(self) -> str:
        return f"IntOrString({self.value!r})"


def port(value: Union[int, str]) -> IntOrString:
    """Convenience constructor for ports in tests and the generator DSL."""
    return IntOrString(value)


# Label selector operators (metav1.LabelSelectorOperator).
OP_IN = "In"
OP_NOT_IN = "NotIn"
OP_EXISTS = "Exists"
OP_DOES_NOT_EXIST = "DoesNotExist"


@dataclass(frozen=True)
class LabelSelectorRequirement:
    key: str
    operator: str
    values: tuple = ()

    def to_dict(self) -> dict:
        d = {"key": self.key, "operator": self.operator}
        if self.values:
            d["values"] = list(self.values)
        return d

    @staticmethod
    def from_dict(d: dict) -> "LabelSelectorRequirement":
        return LabelSelectorRequirement(
            key=d["key"], operator=d["operator"], values=tuple(d.get("values") or ())
        )


@dataclass(frozen=True)
class LabelSelector:
    """metav1.LabelSelector: matchLabels AND matchExpressions.

    Frozen/hashable so selectors can key dicts; match_labels is stored as a
    sorted tuple of (key, value) pairs internally but constructed from a dict.
    """

    match_labels_items: tuple = ()
    match_expressions: tuple = ()

    @staticmethod
    def make(
        match_labels: Optional[Dict[str, str]] = None,
        match_expressions: Optional[List[LabelSelectorRequirement]] = None,
    ) -> "LabelSelector":
        return LabelSelector(
            match_labels_items=tuple(sorted((match_labels or {}).items())),
            match_expressions=tuple(match_expressions or ()),
        )

    @property
    def match_labels(self) -> Dict[str, str]:
        return dict(self.match_labels_items)

    def to_dict(self) -> dict:
        d: dict = {}
        if self.match_labels_items:
            d["matchLabels"] = dict(self.match_labels_items)
        if self.match_expressions:
            d["matchExpressions"] = [e.to_dict() for e in self.match_expressions]
        return d

    @staticmethod
    def from_dict(d: Optional[dict]) -> Optional["LabelSelector"]:
        if d is None:
            return None
        return LabelSelector.make(
            match_labels=d.get("matchLabels") or {},
            match_expressions=[
                LabelSelectorRequirement.from_dict(e)
                for e in (d.get("matchExpressions") or [])
            ],
        )


# An empty selector ("match everything").
EMPTY_SELECTOR = LabelSelector.make()


@dataclass(frozen=True)
class IPBlock:
    cidr: str
    except_: tuple = ()  # tuple of CIDR strings

    @staticmethod
    def make(cidr: str, except_: Optional[List[str]] = None) -> "IPBlock":
        return IPBlock(cidr=cidr, except_=tuple(except_ or ()))

    def to_dict(self) -> dict:
        d: dict = {"cidr": self.cidr}
        if self.except_:
            d["except"] = list(self.except_)
        return d

    @staticmethod
    def from_dict(d: Optional[dict]) -> Optional["IPBlock"]:
        if d is None:
            return None
        return IPBlock.make(cidr=d["cidr"], except_=list(d.get("except") or []))


@dataclass
class NetworkPolicyPort:
    """networkingv1.NetworkPolicyPort. protocol None defaults to TCP at build
    time (builder.go:161-165); port None means all ports on the protocol."""

    protocol: Optional[str] = None
    port: Optional[IntOrString] = None
    end_port: Optional[int] = None

    def to_dict(self) -> dict:
        d: dict = {}
        if self.protocol is not None:
            d["protocol"] = self.protocol
        if self.port is not None:
            d["port"] = self.port.value
        if self.end_port is not None:
            d["endPort"] = self.end_port
        return d

    @staticmethod
    def from_dict(d: dict) -> "NetworkPolicyPort":
        p = d.get("port")
        return NetworkPolicyPort(
            protocol=d.get("protocol"),
            port=IntOrString(p) if p is not None else None,
            end_port=d.get("endPort"),
        )


@dataclass
class NetworkPolicyPeer:
    """networkingv1.NetworkPolicyPeer: exactly one of ip_block or
    (pod_selector and/or namespace_selector) may be set."""

    pod_selector: Optional[LabelSelector] = None
    namespace_selector: Optional[LabelSelector] = None
    ip_block: Optional[IPBlock] = None

    def to_dict(self) -> dict:
        d: dict = {}
        if self.pod_selector is not None:
            d["podSelector"] = self.pod_selector.to_dict()
        if self.namespace_selector is not None:
            d["namespaceSelector"] = self.namespace_selector.to_dict()
        if self.ip_block is not None:
            d["ipBlock"] = self.ip_block.to_dict()
        return d

    @staticmethod
    def from_dict(d: dict) -> "NetworkPolicyPeer":
        return NetworkPolicyPeer(
            pod_selector=LabelSelector.from_dict(d.get("podSelector")),
            namespace_selector=LabelSelector.from_dict(d.get("namespaceSelector")),
            ip_block=IPBlock.from_dict(d.get("ipBlock")),
        )


@dataclass
class NetworkPolicyIngressRule:
    ports: List[NetworkPolicyPort] = field(default_factory=list)
    from_: List[NetworkPolicyPeer] = field(default_factory=list)

    def to_dict(self) -> dict:
        d: dict = {}
        if self.ports:
            d["ports"] = [p.to_dict() for p in self.ports]
        if self.from_:
            d["from"] = [p.to_dict() for p in self.from_]
        return d

    @staticmethod
    def from_dict(d: dict) -> "NetworkPolicyIngressRule":
        return NetworkPolicyIngressRule(
            ports=[NetworkPolicyPort.from_dict(p) for p in (d.get("ports") or [])],
            from_=[NetworkPolicyPeer.from_dict(p) for p in (d.get("from") or [])],
        )


@dataclass
class NetworkPolicyEgressRule:
    ports: List[NetworkPolicyPort] = field(default_factory=list)
    to: List[NetworkPolicyPeer] = field(default_factory=list)

    def to_dict(self) -> dict:
        d: dict = {}
        if self.ports:
            d["ports"] = [p.to_dict() for p in self.ports]
        if self.to:
            d["to"] = [p.to_dict() for p in self.to]
        return d

    @staticmethod
    def from_dict(d: dict) -> "NetworkPolicyEgressRule":
        return NetworkPolicyEgressRule(
            ports=[NetworkPolicyPort.from_dict(p) for p in (d.get("ports") or [])],
            to=[NetworkPolicyPeer.from_dict(p) for p in (d.get("to") or [])],
        )


@dataclass
class NetworkPolicySpec:
    pod_selector: LabelSelector = EMPTY_SELECTOR
    policy_types: List[str] = field(default_factory=list)
    ingress: List[NetworkPolicyIngressRule] = field(default_factory=list)
    egress: List[NetworkPolicyEgressRule] = field(default_factory=list)

    def to_dict(self) -> dict:
        d: dict = {"podSelector": self.pod_selector.to_dict()}
        if self.policy_types:
            d["policyTypes"] = list(self.policy_types)
        if self.ingress:
            d["ingress"] = [r.to_dict() for r in self.ingress]
        if self.egress:
            d["egress"] = [r.to_dict() for r in self.egress]
        return d

    @staticmethod
    def from_dict(d: dict) -> "NetworkPolicySpec":
        return NetworkPolicySpec(
            pod_selector=LabelSelector.from_dict(d.get("podSelector")) or EMPTY_SELECTOR,
            policy_types=list(d.get("policyTypes") or []),
            ingress=[
                NetworkPolicyIngressRule.from_dict(r) for r in (d.get("ingress") or [])
            ],
            egress=[
                NetworkPolicyEgressRule.from_dict(r) for r in (d.get("egress") or [])
            ],
        )


@dataclass
class NetworkPolicy:
    name: str
    namespace: str = ""
    spec: NetworkPolicySpec = field(default_factory=NetworkPolicySpec)

    def effective_namespace(self) -> str:
        """Empty namespace defaults to 'default' (builder.go:28-33)."""
        return self.namespace if self.namespace else NAMESPACE_DEFAULT

    def copy(self) -> "NetworkPolicy":
        return dataclasses.replace(
            self,
            spec=NetworkPolicySpec.from_dict(self.spec.to_dict()),
        )
