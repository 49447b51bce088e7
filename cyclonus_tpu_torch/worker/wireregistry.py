"""The wire protocol as a declarative, versioned registry (a copy of the
reference's worker/wireregistry.py, cut to the registry and its lookups;
the skew-harness views, the frozen golden and its writer stay there).

Every message crossing the serve wire (Batch, Request, Result, Delta,
FlowQuery, Verdict, and the serve loop's Reply envelope) is DECLARED
here and the model classes derive from the declarations:

  * ``Key`` — one wire key: its JSON type, optionality, the protocol
    version that introduced it (``since``), its emit guard
    ("set" = only when set/truthy, "with=K" = only nested inside K's
    emit, "implies=K" = any payload carrying it also carries K), its
    float canonicalization (``canon``), whether its VALUE is
    comparable across peers (``portable`` — non-portable fields like
    latencies and trace events are stripped before replica/parity
    comparison), the nested registered message its items carry
    (``ref``), and a literal ``sample`` exemplar.
  * ``Message`` — one wire message: its introducing version and its
    epoch rule ("stamp" = every constructed instance carries an epoch;
    "from-verdicts" = the reply stamps exactly one epoch taken from
    its verdicts' own batch).
  * ``wire_table`` — derives the contracts.WireField dict the model
    classes validate against, so model.py's ``WIRE`` tables ARE the
    registry.

Protocol history:

  v1  frozen reference shape (Go-compatible): Batch base, Request,
      Result base.
  v2  Result.LatencyMs (per-probe wall-clock).
  v3  trace context: Batch.TraceId/ParentSpan, Result.TraceEvents.
  v4  the verdict service: Delta, FlowQuery, Verdict, Batch.Deltas/
      Queries, and the serve Reply envelope.
  v5  the SLO engine: Verdict.Shed, Reply.Admission.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

from ..utils import contracts

#: the CURRENT protocol version — bump it (with a VERSIONS row) when a
#: key lands, then regenerate the golden
PROTOCOL_VERSION = 5

#: every version's row: wirelint WR003 rejects a key whose ``since``
#: has no row here ("a new key without a version row")
VERSIONS: Dict[int, str] = {
    1: "frozen reference shape (Batch/Request/Result base keys)",
    2: "Result.LatencyMs (per-probe wall-clock)",
    3: "trace context (Batch.TraceId/ParentSpan, Result.TraceEvents)",
    4: "verdict service (Delta/FlowQuery/Verdict, Batch.Deltas/Queries, Reply)",
    5: "SLO engine (Verdict.Shed, Reply.Admission)",
}


@dataclass(frozen=True)
class Key:
    name: str  # the wire key (Go-cased, matching the reference JSON)
    type: str  # JSON-level python type: str|int|float|bool|dict|list
    optional: bool = False  # absent-tolerated on parse, guarded on emit
    since: int = 1  # protocol version that introduced the key
    guard: str = ""  # "" derives: "always" (required) / "set" (optional)
    canon: str = ""  # declared float canonicalization (WR005)
    portable: bool = True  # value comparable across peers (WR005)
    ref: str = ""  # nested registered message carried by dict/list items
    sample: object = None  # literal exemplar for skew-view synthesis
    note: str = ""


@dataclass(frozen=True)
class Message:
    name: str
    since: int = 1  # protocol version that introduced the message
    epoch: str = ""  # "" | "stamp" | "from-verdicts" (wirelint WR004)
    keys: Tuple[Key, ...] = ()
    note: str = ""


_TYPES: Dict[str, type] = {
    "str": str, "int": int, "float": float,
    "bool": bool, "dict": dict, "list": list,
}

# --------------------------------------------------------------------------
# The message census.  Every row is a PURE LITERAL: tools/wirelint.py
# extracts this tuple off the AST without importing the package, and
# tests/test_wirelint.py pins that extraction byte-identical to
# manifest().
# --------------------------------------------------------------------------

MESSAGES: Tuple[Message, ...] = (
    Message(
        "Request", since=1,
        note="one probe ('can I connect') — model.go:26-48",
        keys=(
            Key("Key", "str", sample="probe-1"),
            Key("Protocol", "str", sample="TCP"),
            Key("Host", "str", sample="10.0.0.2"),
            Key("Port", "int", sample=80),
        ),
    ),
    Message(
        "Batch", since=1,
        note="the one envelope: probes to workers, deltas/queries to serve",
        keys=(
            Key("Namespace", "str", sample="x"),
            Key("Pod", "str", sample="a"),
            Key("Container", "str", sample="c"),
            Key("Requests", "list", ref="Request",
                sample=[{"Key": "probe-1", "Protocol": "TCP",
                         "Host": "10.0.0.2", "Port": 80}]),
            Key("TraceId", "str", optional=True, since=3, portable=False,
                sample="t-1",
                note="driver trace context; random per run, never compared"),
            Key("ParentSpan", "str", optional=True, since=3,
                guard="set,with=TraceId", portable=False, sample="0.1",
                note="rides only alongside TraceId (emit nesting, WR001)"),
            Key("Deltas", "list", optional=True, since=4, ref="Delta",
                sample=[{"Kind": "pod_add", "Namespace": "x", "Name": "a",
                         "Labels": {"app": "web"}, "Ip": "10.0.0.9"}]),
            Key("Queries", "list", optional=True, since=4, ref="FlowQuery",
                sample=[{"Src": "x/a", "Dst": "y/b", "Port": 80,
                         "Protocol": "TCP", "PortName": "http"}]),
        ),
    ),
    Message(
        "Result", since=1,
        note="one probe's answer — model.go:50-61",
        keys=(
            Key("Request", "dict", ref="Request",
                sample={"Key": "probe-1", "Protocol": "TCP",
                        "Host": "10.0.0.2", "Port": 80}),
            Key("Output", "str", sample="connected"),
            Key("Error", "str", sample=""),
            Key("LatencyMs", "float", optional=True, since=2,
                canon="round-ms", portable=False, sample=1.5,
                note="producer-rounded milliseconds (worker.py round(.,3))"),
            Key("TraceEvents", "list", optional=True, since=3,
                portable=False,
                sample=[{"name": "worker.probe", "pid": 7, "ts": 0.0}],
                note="carries pids/timestamps by design — never compared"),
        ),
    ),
    Message(
        "Delta", since=4,
        note="one cluster-state mutation; Kind selects the payload keys",
        keys=(
            Key("Kind", "str", since=4, sample="pod_add"),
            Key("Namespace", "str", since=4, sample="x"),
            Key("Name", "str", optional=True, since=4, sample="a"),
            Key("Labels", "dict", optional=True, since=4,
                sample={"app": "web"}),
            Key("Ip", "str", optional=True, since=4, sample="10.0.0.9"),
            Key("Policy", "dict", optional=True, since=4,
                sample={"metadata": {"name": "p", "namespace": "x"}},
                note="new kinds ride this SAME key — data, not new keys"),
        ),
    ),
    Message(
        "FlowQuery", since=4,
        note="one 'is this flow allowed' question",
        keys=(
            Key("Src", "str", since=4, sample="x/a"),
            Key("Dst", "str", since=4, sample="y/b"),
            Key("Port", "int", since=4, sample=80),
            Key("Protocol", "str", since=4, sample="TCP"),
            Key("PortName", "str", optional=True, since=4, sample="http"),
        ),
    ),
    Message(
        "Verdict", since=4, epoch="stamp",
        note="the service's answer; every instance stamps its epoch",
        keys=(
            Key("Query", "dict", since=4, ref="FlowQuery",
                sample={"Src": "x/a", "Dst": "y/b", "Port": 80,
                        "Protocol": "TCP", "PortName": "http"}),
            Key("Ingress", "bool", since=4, sample=True),
            Key("Egress", "bool", since=4, sample=True),
            Key("Combined", "bool", since=4, sample=True),
            Key("Epoch", "int", optional=True, since=4, sample=4,
                note="the staleness anchor for epoch-consistent reads"),
            Key("Error", "str", optional=True, since=4, sample="boom"),
            Key("LatencyMs", "float", optional=True, since=4,
                canon="round-ms", portable=False, sample=1.5),
            Key("Shed", "bool", optional=True, since=5,
                guard="set,implies=Error", sample=True,
                note="SLO refusal: only when True, always alongside Error"),
        ),
    ),
    Message(
        "Reply", since=4, epoch="from-verdicts",
        note="the serve loop's per-line answer envelope (serve/loop.py)",
        keys=(
            Key("Applied", "int", optional=True, since=4, sample=1),
            Key("Mode", "str", optional=True, since=4,
                sample="incremental"),
            Key("Epoch", "int", optional=True, since=4, sample=4,
                note="stamped on every non-error reply; exactly one, "
                     "taken from the verdicts' own batch (WR004)"),
            Key("Rejected", "list", optional=True, since=4,
                sample=[{"index": 0, "error": "bad kind"}]),
            Key("Verdicts", "list", optional=True, since=4, ref="Verdict",
                sample=[{"Query": {"Src": "x/a", "Dst": "y/b", "Port": 80,
                                   "Protocol": "TCP", "PortName": "http"},
                         "Ingress": True, "Egress": True, "Combined": True,
                         "Epoch": 4, "Error": "boom", "LatencyMs": 1.5,
                         "Shed": True}]),
            Key("Admission", "str", optional=True, since=5,
                sample="admission: freshness budget exhausted",
                note="SLO back-pressure: the batch was refused, retry"),
            Key("Error", "str", optional=True, since=4,
                sample="ValueError: malformed line",
                note="the malformed-line envelope (run_stdio)"),
        ),
    ),
)


# --------------------------------------------------------------------------
# Lookups and derived tables.
# --------------------------------------------------------------------------

def message(name: str) -> Message:
    for m in MESSAGES:
        if m.name == name:
            return m
    raise KeyError(f"unregistered wire message {name!r}")


def message_names() -> Tuple[str, ...]:
    return tuple(m.name for m in MESSAGES)


def effective_guard(k: Key) -> str:
    return k.guard or ("set" if k.optional else "always")


def wire_table(name: str) -> Dict[str, contracts.WireField]:
    """The contracts.WireField dict for one message — worker/model.py's
    ``WIRE`` ClassVars are these, so a key declared HERE is covered by
    check_wire / check_wire_read automatically."""
    return {
        k.name: contracts.wire(_TYPES[k.type], optional=k.optional)
        for k in message(name).keys
    }


def key_count() -> int:
    return sum(len(m.keys) for m in MESSAGES)
