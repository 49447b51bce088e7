"""Batch/Request/Result wire model (reference: worker/model.go), a copy
of the reference package's worker/model.py: the verdict service's
Delta, FlowQuery, Verdict and Batch envelope.

Wire-protocol compatibility rules (the full versioned declaration —
key types, optionality, version rows, emit guards — lives in
worker/wireregistry.py):

  * The reference shape (Namespace/Pod/Container/Requests; Request/
    Output/Error) is frozen: those keys are always emitted, so an old
    (even Go) consumer keeps parsing.
  * Every extension is an OPTIONAL field: serialization omits it when
    unset (`to_dict`/`to_json` emit no key), and parsing treats a
    missing key as the unset default (`.get`).  Old workers simply never
    emit it; old drivers never look for it.
  * Unknown keys are TOLERATED on parse: `from_dict`/`from_json` read
    the keys they know and ignore the rest, so a NEWER peer's extra
    fields never break an older one.
  * Evolution is additive-optional ONLY: which version introduced each
    key is pinned by the frozen golden worker/wire_schema.json (equal to
    the reference package's, since the port's client speaks to workers
    of either); changing the protocol = adding a registry row and
    regenerating the golden, never editing a shipped key.

Each class's ``WIRE`` table is DERIVED from the registry
(`wireregistry.wire_table`), so a key declared there is covered by
emit-check and reader-check automatically.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, ClassVar, Dict, List, Optional

from ..utils import contracts
from . import wireregistry


@dataclass
class Request:
    """model.go:26-48."""

    # Wire dtype contract, derived from the one declaration in
    # wireregistry.MESSAGES (tools/wirelint.py checks emit/read sites
    # statically; contracts.check_wire validates real payloads under
    # CYCLONUS_SHAPE_CHECK=1).
    WIRE: ClassVar[Dict[str, contracts.WireField]] = (
        wireregistry.wire_table("Request")
    )

    key: str
    protocol: str
    host: str
    port: int

    def command(self) -> List[str]:
        """The agnhost connect invocation (model.go:50-61)."""
        proto = self.protocol.lower()
        if proto not in ("tcp", "udp", "sctp"):
            raise ValueError(f"invalid protocol {self.protocol}")
        return [
            "/agnhost",
            "connect",
            f"{self.host}:{self.port}",
            "--timeout=1s",
            f"--protocol={proto}",
        ]

    def to_dict(self) -> dict:
        d = {
            "Key": self.key,
            "Protocol": self.protocol,
            "Host": self.host,
            "Port": self.port,
        }
        if contracts.CHECK:
            contracts.check_wire("Request", d, self.WIRE)
        return d

    @staticmethod
    def from_dict(d: dict) -> "Request":
        if contracts.CHECK:
            contracts.check_wire("Request", d, Request.WIRE)
        return Request(
            key=d["Key"], protocol=d["Protocol"], host=d["Host"], port=d["Port"]
        )


@dataclass
class Delta:
    """One cluster-state mutation for the verdict service
    (serve/): pod add/remove, pod or namespace label change,
    policy create/update/delete.  `kind` selects which optional payload
    keys are meaningful; unused ones stay unset (omitted on the wire).

    KINDS is one half of a lifecycle contract: every member must carry
    a KindSpec row in serve/stateregistry.py (validate -> apply ->
    rollback -> named gate) and vice versa — statelint ST005 and
    test_worker's registry cross-check both fail on drift."""

    KINDS: ClassVar[tuple] = (
        "pod_add",       # Namespace/Name + Labels + Ip
        "pod_remove",    # Namespace/Name
        "pod_labels",    # Namespace/Name + Labels (full replacement)
        "ns_labels",     # Namespace + Labels (full replacement)
        "policy_upsert", # Namespace/Name + Policy (NetworkPolicy dict)
        "policy_delete", # Namespace/Name
        # precedence-tier objects (tiers/): cluster-scoped,
        # so Namespace stays empty; the k8s-shaped ANP/BANP dict rides
        # the SAME optional Policy key — new kinds are data values, not
        # new wire keys, so the envelope is unchanged and an old peer
        # rejects them at validation, never at parse
        "anp_upsert",    # Name + Policy (AdminNetworkPolicy dict)
        "anp_delete",    # Name
        "banp_upsert",   # Policy (BaselineAdminNetworkPolicy dict)
        "banp_delete",   #
    )

    WIRE: ClassVar[Dict[str, contracts.WireField]] = (
        wireregistry.wire_table("Delta")
    )

    kind: str
    namespace: str = ""  # empty for the cluster-scoped tier kinds
    name: str = ""
    labels: Optional[Dict[str, str]] = None
    ip: Optional[str] = None
    policy: Optional[Dict[str, Any]] = None

    def to_dict(self) -> dict:
        d: Dict[str, Any] = {"Kind": self.kind, "Namespace": self.namespace}
        if self.name:
            d["Name"] = self.name
        if self.labels is not None:
            d["Labels"] = dict(self.labels)
        if self.ip is not None:
            d["Ip"] = self.ip
        if self.policy is not None:
            d["Policy"] = dict(self.policy)
        if contracts.CHECK:
            contracts.check_wire("Delta", d, self.WIRE)
        return d

    @staticmethod
    def from_dict(d: dict) -> "Delta":
        if contracts.CHECK:
            contracts.check_wire_read("Delta", d, Delta.WIRE)
        labels = d.get("Labels")
        policy = d.get("Policy")
        return Delta(
            kind=d.get("Kind", ""),
            namespace=d.get("Namespace", ""),
            name=d.get("Name", "") or "",
            labels=dict(labels) if labels is not None else None,
            ip=d.get("Ip"),
            policy=dict(policy) if policy is not None else None,
        )


@dataclass
class FlowQuery:
    """One "is this flow allowed" question for the verdict service:
    src/dst are pod keys ("namespace/name") known to the serving engine;
    the (port, port_name, protocol) triple resolves exactly like an
    engine PortCase."""

    WIRE: ClassVar[Dict[str, contracts.WireField]] = (
        wireregistry.wire_table("FlowQuery")
    )

    src: str
    dst: str
    port: int
    protocol: str
    port_name: str = ""

    def to_dict(self) -> dict:
        d: Dict[str, Any] = {
            "Src": self.src,
            "Dst": self.dst,
            "Port": self.port,
            "Protocol": self.protocol,
        }
        if self.port_name:
            d["PortName"] = self.port_name
        if contracts.CHECK:
            contracts.check_wire("FlowQuery", d, self.WIRE)
        return d

    @staticmethod
    def from_dict(d: dict) -> "FlowQuery":
        if contracts.CHECK:
            contracts.check_wire_read("FlowQuery", d, FlowQuery.WIRE)
        return FlowQuery(
            src=d.get("Src", ""),
            dst=d.get("Dst", ""),
            port=int(d.get("Port", 0)),
            protocol=d.get("Protocol", ""),
            port_name=d.get("PortName", "") or "",
        )


@dataclass
class Verdict:
    """The verdict service's answer to one FlowQuery: the query echoed
    back (responses may be reordered relative to a batch), the three
    allow bits, and the engine epoch the answer was computed at (the
    staleness anchor).  A query the engine cannot answer (unknown pod
    key, bad protocol) carries Error and all-False bits.

    Shed is the SLO engine's typed refusal (optional, omitted when
    False — pre-SLO peers never see it): the service declined to
    answer because the query-latency error budget was exhausted.  A
    shed verdict also carries Error, so a caller that predates the
    field still treats it as a non-answer rather than reading the
    all-False bits as a deny."""

    WIRE: ClassVar[Dict[str, contracts.WireField]] = (
        wireregistry.wire_table("Verdict")
    )

    query: FlowQuery
    ingress: bool = False
    egress: bool = False
    combined: bool = False
    epoch: Optional[int] = None
    error: str = ""
    latency_ms: Optional[float] = None
    shed: bool = False

    def to_dict(self) -> dict:
        d: Dict[str, Any] = {
            "Query": self.query.to_dict(),
            "Ingress": self.ingress,
            "Egress": self.egress,
            "Combined": self.combined,
        }
        if self.epoch is not None:
            d["Epoch"] = self.epoch
        if self.error:
            d["Error"] = self.error
        if self.latency_ms is not None:
            d["LatencyMs"] = self.latency_ms
        if self.shed:
            d["Shed"] = True
        if contracts.CHECK:
            contracts.check_wire("Verdict", d, self.WIRE)
        return d

    @staticmethod
    def from_dict(d: dict) -> "Verdict":
        if contracts.CHECK:
            contracts.check_wire_read("Verdict", d, Verdict.WIRE)
        latency = d.get("LatencyMs")
        return Verdict(
            query=FlowQuery.from_dict(d.get("Query") or {}),
            ingress=bool(d.get("Ingress", False)),
            egress=bool(d.get("Egress", False)),
            combined=bool(d.get("Combined", False)),
            epoch=d.get("Epoch"),
            error=d.get("Error", "") or "",
            latency_ms=float(latency) if latency is not None else None,
            shed=bool(d.get("Shed", False)),
        )


@dataclass
class Batch:
    """model.go:9-24.

    trace_id / parent_span are OPTIONAL trace context (see the module
    docstring's compatibility rules): when the driver is recording a
    timeline, it stamps its trace id and current span path here so the
    worker's spans join the same trace, nested under the issuing step.

    deltas / queries are the OPTIONAL verdict-service payloads: a serve
    batch rides the same envelope as a probe batch (Namespace/Pod/
    Container may be empty there — the service is not pod-scoped), so
    one stream can carry probes to workers and deltas/queries to the
    service without a second protocol."""

    WIRE: ClassVar[Dict[str, contracts.WireField]] = (
        wireregistry.wire_table("Batch")
    )

    namespace: str
    pod: str
    container: str
    requests: List[Request] = field(default_factory=list)
    trace_id: str = ""
    parent_span: str = ""
    deltas: List[Delta] = field(default_factory=list)
    queries: List[FlowQuery] = field(default_factory=list)

    def key(self) -> str:
        return f"{self.namespace}/{self.pod}/{self.container}"

    def to_json(self) -> str:
        d: Dict[str, Any] = {
            "Namespace": self.namespace,
            "Pod": self.pod,
            "Container": self.container,
            "Requests": [r.to_dict() for r in self.requests],
        }
        if self.trace_id:
            d["TraceId"] = self.trace_id
            if self.parent_span:
                d["ParentSpan"] = self.parent_span
        if self.deltas:
            d["Deltas"] = [x.to_dict() for x in self.deltas]
        if self.queries:
            d["Queries"] = [x.to_dict() for x in self.queries]
        if contracts.CHECK:
            contracts.check_wire("Batch", d, self.WIRE)
        return json.dumps(d)

    @staticmethod
    def from_json(text: str) -> "Batch":
        d = json.loads(text)
        # tolerant parse on purpose (module docstring): missing required
        # keys default rather than raise — but a payload that isn't an
        # object, or a present key with a drifted type, is a peer wire
        # break and gets rejected with the offending key named
        if contracts.CHECK:
            contracts.check_wire_read("Batch", d, Batch.WIRE)
        return Batch(
            namespace=d.get("Namespace", ""),
            pod=d.get("Pod", ""),
            container=d.get("Container", ""),
            requests=[Request.from_dict(r) for r in d.get("Requests") or []],
            trace_id=d.get("TraceId", "") or "",
            parent_span=d.get("ParentSpan", "") or "",
            deltas=[Delta.from_dict(x) for x in d.get("Deltas") or []],
            queries=[FlowQuery.from_dict(x) for x in d.get("Queries") or []],
        )


@dataclass
class Result:
    """model.go:50-61.

    latency_ms and trace_events are optional extensions (module
    docstring): per-probe wall-clock measured by the worker
    (worker.py _issue_one) feeding the driver's real-probe latency
    histogram, and the worker's recorded trace events riding back for
    the merged driver+worker timeline."""

    WIRE: ClassVar[Dict[str, contracts.WireField]] = (
        wireregistry.wire_table("Result")
    )

    request: Request
    output: str = ""
    error: str = ""
    latency_ms: Optional[float] = None
    trace_events: Optional[List[Dict[str, Any]]] = None

    def is_success(self) -> bool:
        return self.error == ""

    def to_dict(self) -> dict:
        d: Dict[str, Any] = {
            "Request": self.request.to_dict(),
            "Output": self.output,
            "Error": self.error,
        }
        if self.latency_ms is not None:
            d["LatencyMs"] = self.latency_ms
        if self.trace_events:
            d["TraceEvents"] = self.trace_events
        if contracts.CHECK:
            contracts.check_wire("Result", d, self.WIRE)
        return d

    @staticmethod
    def from_dict(d: dict) -> "Result":
        # parse side is tolerant of ABSENT keys (old peers), but a
        # present key with a drifted type is a wire break worth catching
        if contracts.CHECK:
            contracts.check_wire_read("Result", d, Result.WIRE)
        latency = d.get("LatencyMs")
        events = d.get("TraceEvents")
        return Result(
            request=Request.from_dict(d["Request"]),
            output=d.get("Output", ""),
            error=d.get("Error", ""),
            latency_ms=float(latency) if latency is not None else None,
            trace_events=list(events) if events else None,
        )


#: The real (parse, emit) pair for each registered message this module
#: models — what wireregistry.skew_sweep drives every synthesized skew
#: view through, so the compat proof exercises THESE codecs, not a
#: test-only re-implementation.  (The Reply envelope has no class; the
#: sweep falls back to the registry-generic codec for it.)
CODECS: Dict[str, Any] = {
    "Request": (Request.from_dict, lambda r: r.to_dict()),
    "Batch": (
        lambda d: Batch.from_json(json.dumps(d)),
        lambda b: json.loads(b.to_json()),
    ),
    "Result": (Result.from_dict, lambda r: r.to_dict()),
    "Delta": (Delta.from_dict, lambda x: x.to_dict()),
    "FlowQuery": (FlowQuery.from_dict, lambda q: q.to_dict()),
    "Verdict": (Verdict.from_dict, lambda v: v.to_dict()),
}
