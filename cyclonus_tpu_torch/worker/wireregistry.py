"""The wire protocol as a declarative, versioned registry (a copy of the
reference package's worker/wireregistry.py): the static twin
tools/wirelint.py lints against and the peer version-skew harness
torch_tools/skewharness.py replays against.

Every message crossing the worker/serve wire (Batch, Request, Result,
Delta, FlowQuery, Verdict, and the serve loop's Reply envelope) must
hold a five-way agreement: its emit sites write only declared keys
under their declared guards, its readers tolerate old peers (absent
optional keys) and new peers (unknown keys), its evolution stays
additive-optional against the frozen golden ``wire_schema.json``, its
replies stamp exactly one epoch, and its comparable fields stay
portable across peers.  The agreement is DECLARED here and everything
derives from the declarations:

  * ``Key`` — one wire key: its JSON type, optionality, the protocol
    version that introduced it (``since``), its emit guard
    ("set" = only when set/truthy, "with=K" = only nested inside K's
    emit, "implies=K" = any payload carrying it also carries K), its
    float canonicalization (``canon``), whether its VALUE is
    comparable across peers (``portable`` — non-portable fields like
    latencies and trace events are stripped before replica/parity
    comparison), the nested registered message its items carry
    (``ref``), and a literal ``sample`` exemplar the skew harness
    synthesizes payloads from.
  * ``Message`` — one wire message: its introducing version and its
    epoch rule ("stamp" = every constructed instance carries an epoch;
    "from-verdicts" = the reply stamps exactly one epoch taken from
    its verdicts' own batch — wirelint WR004).
  * ``wire_table`` — derives the contracts.WireField dict the model
    classes validate against, so model.py's ``WIRE`` tables ARE the
    registry.
  * ``legacy_view`` / ``inject_unknown`` — synthesize what an older /
    newer peer would see, recursively through ``ref`` links; the skew
    harness uses these instead of hand-built per-key dicts.
  * ``build_golden`` — the frozen-schema projection committed as
    ``worker/wire_schema.json``; wirelint WR003 fails on any
    non-additive diff, and regenerating the golden
    (``python -m cyclonus_tpu_torch.worker.wireregistry --write-golden``)
    is the explicit, diffable act of changing the protocol.  The port's
    client speaks to workers built from either package, so its golden
    equals the reference package's as JSON (tests/test_torch_wire.py).

Protocol history (the version rows WR003 pins every key to):

  v1  frozen reference shape (Go-compatible): Batch base, Request,
      Result base.
  v2  Result.LatencyMs (per-probe wall-clock).
  v3  trace context: Batch.TraceId/ParentSpan, Result.TraceEvents.
  v4  the verdict service: Delta, FlowQuery, Verdict, Batch.Deltas/
      Queries, and the serve Reply envelope.
  v5  the SLO engine: Verdict.Shed, Reply.Admission.

Strip contract (same as serve/stateregistry.py): ``ACTIVE`` is read
ONCE at import.  When off — every production run — the skew-view call
recorder is a constant-false branch away from a no-op; armed
(CYCLONUS_SKEWHARNESS=1) it records which registry helpers synthesized
the views, so the harness can assert its skew coverage really is
registry-driven rather than a drifted hand-rolled copy.
"""

from __future__ import annotations

import copy
import json
import os
import threading
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

from ..utils import contracts

ACTIVE = os.environ.get("CYCLONUS_SKEWHARNESS", "") == "1"

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
# tests/test_torch_wire.py pins that extraction equal to
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


def _dependents(msg: Message, key_name: str) -> List[str]:
    """Keys whose guard ties them to `key_name` (ParentSpan with=TraceId):
    a view dropping the anchor must drop the dependents too, or the
    synthesized payload would violate its own declared guards."""
    out = []
    for k in msg.keys:
        for tok in (k.guard or "").split(","):
            if tok.strip() == f"with={key_name}":
                out.append(k.name)
                out.extend(_dependents(msg, k.name))
    return out


def _view(
    name: str,
    payload: dict,
    version: Optional[int],
    drop_unknown: bool,
    drop_keys: Tuple[str, ...] = (),
) -> dict:
    """The registry-driven skew projection: drop keys newer than
    `version` (None = current), optionally drop unknown keys (the
    old-reader simulation), always drop `drop_keys` plus their guard
    dependents — recursing through ``ref`` links so nested messages
    skew consistently (a v4 Reply view drops Shed from its Verdicts)."""
    msg = message(name)
    declared = {k.name: k for k in msg.keys}
    dropped = set(drop_keys)
    for d in drop_keys:
        dropped.update(_dependents(msg, d))
    out: dict = {}
    for key, value in payload.items():
        k = declared.get(key)
        if k is None:
            if drop_unknown:
                continue
            out[key] = copy.deepcopy(value)
            continue
        if key in dropped:
            continue
        if version is not None and k.since > version:
            continue
        if k.ref:
            if k.type == "list" and isinstance(value, list):
                value = [
                    _view(k.ref, v, version, drop_unknown)
                    if isinstance(v, dict) else copy.deepcopy(v)
                    for v in value
                ]
            elif k.type == "dict" and isinstance(value, dict):
                value = _view(k.ref, value, version, drop_unknown)
            else:
                value = copy.deepcopy(value)
        else:
            value = copy.deepcopy(value)
        out[key] = value
    return out


def legacy_view(name: str, payload: dict, version: int) -> dict:
    """What a version-`version` peer's payload looks like: every key
    introduced after `version` dropped, recursively.  This is the
    older-emitter->newer-reader synthesis (and equally, the key set an
    older READER would consider after ignoring unknowns)."""
    _record("legacy_view")
    return _view(name, payload, version, drop_unknown=False)


def drop_view(name: str, payload: dict, key: str) -> dict:
    """The per-key absence view: `key` (plus its guard dependents)
    removed — the 'this old peer never set it' case the per-key compat
    tests used to hand-build."""
    _record("drop")
    return _view(
        name, payload, None, drop_unknown=False, drop_keys=(key,)
    )


def inject_unknown(name: str, payload: dict) -> dict:
    """The newer-emitter view: an undeclared key injected at every
    level (top and inside each ``ref``), which every reader must
    ignore — the frozen tolerate-unknown-keys rule."""
    _record("inject")
    out = _view(name, payload, None, drop_unknown=False)
    out["XWireSkewProbe"] = {"from": "the-future"}
    msg = message(name)
    for k in msg.keys:
        if not k.ref or k.name not in out:
            continue
        v = out[k.name]
        if k.type == "list" and isinstance(v, list):
            out[k.name] = [
                dict(item, XWireSkewProbe=1)
                if isinstance(item, dict) else item
                for item in v
            ]
        elif k.type == "dict" and isinstance(v, dict):
            out[k.name] = dict(v, XWireSkewProbe=1)
    return out


def strip_nonportable(name: str, payload: dict) -> dict:
    """Drop every ``portable=False`` key, recursively — the
    registry-driven projection under which two peers' payloads for the
    same state must compare EQUAL (latencies, trace ids, and trace
    events are measurements, not state)."""
    msg = message(name)
    out: dict = {}
    for key, value in payload.items():
        k = next((x for x in msg.keys if x.name == key), None)
        if k is not None and not k.portable:
            continue
        if k is not None and k.ref:
            if k.type == "list" and isinstance(value, list):
                value = [
                    strip_nonportable(k.ref, v)
                    if isinstance(v, dict) else v
                    for v in value
                ]
            elif k.type == "dict" and isinstance(value, dict):
                value = strip_nonportable(k.ref, value)
        out[key] = value
    return out


def sample_payload(name: str) -> dict:
    """The fully-populated exemplar synthesized from the registry's
    literal ``sample`` column — every optional key present, so skew
    views exercise every declared key."""
    return {
        k.name: copy.deepcopy(k.sample)
        for k in message(name).keys
        if k.sample is not None
    }


def check_read(name: str, payload: object) -> None:
    """Reader-side validation against the registry table (the serve
    loop and the driver client call this under CYCLONUS_SHAPE_CHECK=1
    via contracts.check_wire_read)."""
    contracts.check_wire_read(name, payload, wire_table(name))


def guard_violations(name: str, payload: dict) -> List[str]:
    """Declared-guard conformance of one EMITTED payload: an
    ``implies=K`` key present without K, or a ``with=K`` key present
    without its anchor.  The skew harness asserts every live emit is
    clean; a violation names the key and the rule."""
    msg = message(name)
    out = []
    for k in msg.keys:
        if k.name not in payload:
            continue
        for tok in (k.guard or "").split(","):
            tok = tok.strip()
            for rule in ("implies=", "with="):
                if tok.startswith(rule) and tok[len(rule):] not in payload:
                    out.append(
                        f"{name}.{k.name}: declared '{tok}' but "
                        f"{tok.split('=', 1)[1]!r} absent from the payload"
                    )
    return out


# --------------------------------------------------------------------------
# The skew sweep: both peer directions for every registered message,
# synthesized from the registry.  torch_tools/skewharness.py drives
# this (armed) plus the real serve wire loop.
# --------------------------------------------------------------------------

def _generic_codec(name: str):
    """The registry-derived codec for messages with no model class (the
    Reply envelope): parse = validate + deep-restrict to declared keys
    (exactly what an old reader's ignore-unknowns parse yields), emit =
    identity."""

    def parse(d: dict) -> dict:
        check_read(name, d)
        return _view(name, d, None, drop_unknown=True)

    return parse, lambda obj: obj


def skew_sweep(
    codecs: Optional[Dict[str, Tuple[Callable, Callable]]] = None,
) -> Dict[str, object]:
    """For every registered message: the full-sample round-trip, every
    (older-emitter -> newer-reader) version view, every (newer-emitter
    -> older-reader) unknown-key injection, and every per-optional-key
    absence view — each driven through the real codec (worker/model.py
    CODECS) or the registry-generic one.  Returns the counters the
    census stamps, with any divergence in
    ``problems``."""
    codecs = codecs or {}
    pairs = 0
    problems: List[str] = []
    dropped_census: Dict[str, set] = {}
    present_census: Dict[str, set] = {}

    def note(msg_name: str, payload: dict, *, absent: Optional[set] = None):
        keys = {k.name for k in message(msg_name).keys if k.optional}
        present_census.setdefault(msg_name, set()).update(
            keys & set(payload)
        )
        if absent is not None:
            dropped_census.setdefault(msg_name, set()).update(
                absent & keys
            )

    for msg in MESSAGES:
        parse, emit = codecs.get(msg.name) or _generic_codec(msg.name)
        full = sample_payload(msg.name)

        def run_pair(view: dict, scenario: str) -> Optional[dict]:
            nonlocal pairs
            pairs += 1
            try:
                emitted = emit(parse(view))
            except Exception as e:  # noqa: BLE001 - reported, not raised
                problems.append(
                    f"{msg.name} {scenario}: parse/emit raised "
                    f"{type(e).__name__}: {e}"
                )
                return None
            if emitted != view:
                problems.append(
                    f"{msg.name} {scenario}: round-trip drifted "
                    f"(keys {sorted(view)} -> {sorted(emitted)})"
                )
            return emitted

        # full-sample round-trip + declared-guard conformance
        emitted = run_pair(full, "full")
        note(msg.name, full)
        if emitted is not None:
            problems.extend(guard_violations(msg.name, emitted))
        # older emitter -> newer reader, at every prior version
        for v in range(msg.since, PROTOCOL_VERSION):
            view = legacy_view(msg.name, full, v)
            run_pair(view, f"older-emitter(v{v})")
            note(msg.name, view, absent=set(full) - set(view))
            problems.extend(guard_violations(msg.name, view))
            # newer emitter -> older reader: unknown keys injected on
            # top of the same view must parse identically
            pairs += 1
            try:
                a = emit(parse(inject_unknown(msg.name, view)))
                b = emit(parse(view))
            except Exception as e:  # noqa: BLE001
                problems.append(
                    f"{msg.name} newer-emitter(v{v}): unknown key broke "
                    f"the parse: {type(e).__name__}: {e}"
                )
            else:
                if a != b:
                    problems.append(
                        f"{msg.name} newer-emitter(v{v}): unknown keys "
                        f"leaked into the parse ({sorted(b)} -> "
                        f"{sorted(a)})"
                    )
        # per-optional-key absence (the old peer never set it)
        for k in msg.keys:
            if not k.optional:
                continue
            view = drop_view(msg.name, full, k.name)
            run_pair(view, f"absent({k.name})")
            note(msg.name, view, absent=set(full) - set(view))
    return {
        "schema_version": PROTOCOL_VERSION,
        "messages": len(MESSAGES),
        "keys": key_count(),
        "skew_pairs_checked": pairs,
        "problems": problems,
        "census": {
            "dropped": {m: sorted(s) for m, s in dropped_census.items()},
            "present": {m: sorted(s) for m, s in present_census.items()},
        },
    }


def census_gaps(sweep: Dict[str, object]) -> List[str]:
    """Registered optional keys the sweep never exercised under skew —
    both directions required: present in a parsed view AND absent from
    one.  The coverage census the skew harness fails on."""
    census = sweep.get("census") or {}
    dropped = census.get("dropped") or {}
    present = census.get("present") or {}
    gaps = []
    for m in MESSAGES:
        for k in m.keys:
            if not k.optional:
                continue
            if k.name not in (present.get(m.name) or ()):
                gaps.append(f"{m.name}.{k.name}: never present under skew")
            if k.name not in (dropped.get(m.name) or ()):
                gaps.append(f"{m.name}.{k.name}: never absent under skew")
    return gaps


# --------------------------------------------------------------------------
# The frozen golden (worker/wire_schema.json) and the manifest.
# --------------------------------------------------------------------------

def build_golden() -> Dict[str, object]:
    """The evolution-relevant projection of the registry: type,
    optionality, and version row per key.  Committed as
    wire_schema.json; wirelint WR003 diffs the live registry against
    it, so ANY protocol change is a golden regeneration — a reviewable
    diff — and additive-optional is the only change that passes."""
    return {
        "schema_version": PROTOCOL_VERSION,
        "versions": {str(v): note for v, note in sorted(VERSIONS.items())},
        "messages": {
            m.name: {
                "since": m.since,
                "epoch": m.epoch,
                "keys": {
                    k.name: {
                        "type": k.type,
                        "optional": k.optional,
                        "since": k.since,
                    }
                    for k in m.keys
                },
            }
            for m in MESSAGES
        },
    }


def golden_path() -> str:
    return os.path.join(os.path.dirname(__file__), "wire_schema.json")


def manifest() -> Dict[str, object]:
    """The full registry as plain JSON-able data.
    tools/wirelint.py's AST extraction reads the same declarations, so
    the static twin lints the REAL registry."""
    return {
        "version": 1,
        "protocol_version": PROTOCOL_VERSION,
        "versions": {str(v): note for v, note in sorted(VERSIONS.items())},
        "messages": [
            {
                "name": m.name,
                "since": m.since,
                "epoch": m.epoch,
                "note": m.note,
                "keys": [
                    {
                        "name": k.name,
                        "type": k.type,
                        "optional": k.optional,
                        "since": k.since,
                        "guard": effective_guard(k),
                        "canon": k.canon,
                        "portable": k.portable,
                        "ref": k.ref,
                        "sample": k.sample,
                        "note": k.note,
                    }
                    for k in m.keys
                ],
            }
            for m in MESSAGES
        ],
    }


# --------------------------------------------------------------------------
# The harness-mode call recorder (strip contract: ACTIVE read once at
# import; disarmed, _record is a constant-false branch away from free).
# --------------------------------------------------------------------------

_CALLS_LOCK = threading.Lock()
_CALLS: List[str] = []  # guarded-by: _CALLS_LOCK


def _record(op: str) -> None:  # never-raises
    if not ACTIVE:
        return
    with _CALLS_LOCK:
        _CALLS.append(op)


def drain() -> List[str]:
    """The skew-view helper calls recorded since the last drain (armed
    mode only; disarmed, always empty)."""
    if not ACTIVE:
        return []
    with _CALLS_LOCK:
        out = list(_CALLS)
        _CALLS.clear()
        return out


def _main(argv: Optional[List[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="wire registry tools (see module docstring)"
    )
    ap.add_argument(
        "--write-golden", action="store_true",
        help="regenerate worker/wire_schema.json from the registry — "
             "the explicit act of changing the wire protocol",
    )
    args = ap.parse_args(argv)
    if args.write_golden:
        path = golden_path()
        with open(path, "w") as f:
            json.dump(build_golden(), f, indent=2, sort_keys=True)
            f.write("\n")
        print(f"wrote {path}")
        return 0
    print(json.dumps(manifest(), indent=2, sort_keys=True))
    return 0


if __name__ == "__main__":
    raise SystemExit(_main())
