"""The authoritative-state surface as a declarative registry — the
static twin tools/statelint.py lints against and the state-surface
harness tests/stateharness.py replays against.

Every piece of authoritative VerdictService state (pods, namespace
labels, NetworkPolicies, ANPs, the BANP singleton — soon per-tenant
slabs and mesh-tier objects) must hold a six-way agreement: mutated
only on the guarded commit path, snapshotted by the apply_pending
rollback, canonicalized into the epoch digest (audit/digest.py),
handed to the audit ring's ``note_epoch``, exposed in ``state()``, and
round-tripped by a wire Delta kind.  Before this module that agreement
was maintained by hand across ~6 surfaces; now it is DECLARED here and
the service reads the declarations:

  * ``StateField`` — one authoritative field: its service attribute,
    container shape, the delta kinds that mutate it, and its
    digest / state() participation keys.  ``snapshot`` / ``restore`` /
    ``audit_state`` / ``state_counts`` below iterate FIELDS, so adding
    a field HERE is the whole rollback/audit/state() change — the
    planspec discipline ("editing the registry IS the dispatch
    change") applied to state.
  * ``KindSpec`` — one delta Kind's lifecycle row: its owning field
    and the named gate (a tests/ file or make target) that proves the
    validate -> apply -> rollback -> wire round-trip chain.
    tools/statelint.py ST005 cross-checks each row against
    worker/model.py's Delta.KINDS, the validator, and the applier.
  * ``COMMIT`` — the guarded commit-path contract: the service class,
    its commit/validator/applier functions, the epoch attribute, and
    the lock.  tools/statelint.py anchors ST001/ST002/ST004 on these
    names instead of hardcoding them.

Strip contract (same as engine/planspec.py): ``ACTIVE`` is read ONCE
at import.  When off — every production run — the call recorder is a
constant-false branch away from a no-op; armed
(CYCLONUS_STATEHARNESS=1) it records which registry helpers the live
service routed through, so the harness can assert the commit path
really is registry-driven rather than a drifted hand-rolled copy.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

ACTIVE = os.environ.get("CYCLONUS_STATEHARNESS", "") == "1"


@dataclass(frozen=True)
class StateField:
    name: str  # registry name == note_epoch kwarg (audit/sampler.py)
    attr: str  # the VerdictService attribute holding the field
    container: str  # "dict" (journaled or shallow-copied) | "optional" (replaced wholesale)
    kinds: Tuple[str, ...]  # delta kinds that mutate this field
    digest_key: str  # audit/digest.py canonical_state key
    state_key: str  # state() payload key ("" = not exposed)
    rollback: bool = True  # participates in the apply_pending snapshot
    note: str = ""


@dataclass(frozen=True)
class KindSpec:
    kind: str  # the wire Delta Kind value (worker/model.py Delta.KINDS)
    field: str  # owning StateField name
    gate: str  # lifecycle gate: a tests/ file or a make target
    payload: str = ""  # optional wire key carrying the object ("Policy")
    note: str = ""


# --------------------------------------------------------------------------
# The field census.  Shallow copies are stable snapshots because every
# apply REPLACES values wholesale (fresh tuples/dicts, never in-place)
# — the rollback-snapshot discipline service.py documents.
# --------------------------------------------------------------------------

FIELDS: Tuple[StateField, ...] = (
    StateField(
        "pods", attr="pods", container="dict",
        kinds=("pod_add", "pod_labels", "pod_remove"),
        digest_key="pods", state_key="pods",
        note="key 'ns/name' -> PodTuple (ns, name, labels, ip)",
    ),
    StateField(
        "namespaces", attr="namespaces", container="dict",
        kinds=("ns_labels",),
        digest_key="namespaces", state_key="namespaces",
        note="namespace -> label dict",
    ),
    StateField(
        "netpols", attr="netpols", container="dict",
        kinds=("policy_upsert", "policy_delete"),
        digest_key="netpols", state_key="policies",
        note="key 'ns/name' -> NetworkPolicy",
    ),
    StateField(
        "anps", attr="anps", container="dict",
        kinds=("anp_upsert", "anp_delete"),
        digest_key="anps", state_key="anps",
        note="cluster-scoped name -> AdminNetworkPolicy",
    ),
    StateField(
        "banp", attr="banp", container="optional",
        kinds=("banp_upsert", "banp_delete"),
        digest_key="banp", state_key="banp",
        note="the BaselineAdminNetworkPolicy singleton, or None",
    ),
)

# --------------------------------------------------------------------------
# The kind lifecycle matrix.  One row per wire Delta Kind; statelint
# ST005 pins each row to Delta.KINDS, _validate_delta, _apply_to_state,
# the rollback set, and an existing gate — and fails on a wire kind
# with no row here (a new state surface without a declared lifecycle).
# --------------------------------------------------------------------------

KINDS: Tuple[KindSpec, ...] = (
    KindSpec("pod_add", field="pods", gate="tests/stateharness.py"),
    KindSpec("pod_labels", field="pods", gate="tests/stateharness.py"),
    KindSpec("pod_remove", field="pods", gate="tests/stateharness.py"),
    KindSpec("ns_labels", field="namespaces", gate="tests/stateharness.py"),
    KindSpec("policy_upsert", field="netpols", gate="tests/stateharness.py",
             payload="Policy"),
    KindSpec("policy_delete", field="netpols", gate="tests/stateharness.py"),
    KindSpec("anp_upsert", field="anps", gate="tests/stateharness.py",
             payload="Policy"),
    KindSpec("anp_delete", field="anps", gate="tests/stateharness.py"),
    KindSpec("banp_upsert", field="banp", gate="tests/stateharness.py",
             payload="Policy"),
    KindSpec("banp_delete", field="banp", gate="tests/stateharness.py"),
)

#: the guarded commit-path contract statelint anchors ST001/ST002/ST004
#: on: who commits, who validates, who applies, which attribute is the
#: epoch, and which lock guards it all.
COMMIT: Dict[str, str] = {
    "class": "VerdictService",
    "commit": "apply_pending",
    "validator": "_validate_delta",
    "applier": "_apply_to_state",
    "epoch_attr": "_epoch",
    "lock": "self._lock",
    "audit_note": "note_epoch",
}


def field_names() -> Tuple[str, ...]:
    return tuple(f.name for f in FIELDS)


def field_by_name(name: str) -> Optional[StateField]:
    for f in FIELDS:
        if f.name == name:
            return f
    return None


def delta_kinds() -> Tuple[str, ...]:
    """Every declared delta kind, in KINDS declaration order."""
    return tuple(k.kind for k in KINDS)


# --------------------------------------------------------------------------
# The live helpers VerdictService's commit path reads.  All of them
# iterate FIELDS, so a registry edit IS the state-surface change; the
# caller holds the service lock (service.py's commit discipline).
# --------------------------------------------------------------------------

def _copy(f: StateField, value: object) -> object:
    return dict(value) if f.container == "dict" else value


_ABSENT = object()


class JournalDict(dict):
    """A dict field that keeps an undo journal: while one is open
    (open_journal), the first write or delete of a key records the
    value the key held before it (or its absence).  So a rollback point
    costs what its batch writes, not a copy of the field."""

    _undo: Optional[Dict] = None  # the open journal

    def __reduce__(self):
        # a copy or an unpickled one starts with no journal
        return type(self), (dict(self),)

    def _note(self, key) -> None:
        undo = self._undo
        if undo is not None and key not in undo:
            undo[key] = dict.get(self, key, _ABSENT)

    def __setitem__(self, key, value) -> None:
        self._note(key)
        dict.__setitem__(self, key, value)

    def __delitem__(self, key) -> None:
        if key in self:
            self._note(key)
        dict.__delitem__(self, key)

    def pop(self, key, *default):
        if key in self:
            self._note(key)
        return dict.pop(self, key, *default)

    def popitem(self):
        if self:
            self._note(next(reversed(self)))
        return dict.popitem(self)

    def setdefault(self, key, default=None):
        if key not in self:
            self._note(key)
        return dict.setdefault(self, key, default)

    def update(self, *args, **kwargs) -> None:
        for key, value in dict(*args, **kwargs).items():
            self[key] = value

    def __ior__(self, other):
        self.update(other)
        return self

    def clear(self) -> None:
        for key in self:
            self._note(key)
        dict.clear(self)

    def open_journal(self) -> Dict:
        """Start a new journal (the last one stops recording)."""
        self._undo = {}
        return self._undo

    def undo(self, journal: Dict) -> None:
        """Put back every key `journal` recorded.  A key deleted since
        returns at the end of the iteration order; the contents are
        exact."""
        if journal is not self._undo:
            raise RuntimeError("a later snapshot superseded this rollback point")
        for key, old in journal.items():
            if old is _ABSENT:
                dict.pop(self, key, None)
            else:
                dict.__setitem__(self, key, old)


class _Journaled:
    """A JournalDict field's rollback point: the dict and its journal."""

    __slots__ = ("data", "journal")

    def __init__(self, data: JournalDict):
        self.data = data
        self.journal = data.open_journal()


def _mark(f: StateField, value: object) -> object:
    if f.container == "dict" and isinstance(value, JournalDict):
        return _Journaled(value)
    return _copy(f, value)


def snapshot(svc: object) -> Dict[str, object]:
    """The apply_pending rollback point of every rollback-participating
    field, keyed by registry name: a JournalDict field's journal, opened
    here, else a shallow copy."""
    _record("snapshot")
    return {
        f.name: _mark(f, getattr(svc, f.attr)) for f in FIELDS if f.rollback
    }


def restore(svc: object, snap: Dict[str, object]) -> None:
    """Roll every rollback-participating field back to its snapshot.
    STRICT on purpose: a snapshot missing a registered field raises
    KeyError, before any field is touched, instead of silently
    committing poison — the runtime twin of statelint ST002
    (tests/stateharness.py proves it fires)."""
    _record("restore")
    marks = [(f, snap[f.name]) for f in FIELDS if f.rollback]
    for f, mark in marks:
        if isinstance(mark, _Journaled):
            mark.data.undo(mark.journal)
            mark = mark.data
        setattr(svc, f.attr, mark)


def audit_state(svc: object) -> Dict[str, object]:
    """Fresh shallow copies of every field, keyed by registry name —
    the exact kwarg set AuditController.note_epoch requires, so a field
    added here without a note_epoch parameter fails loudly (TypeError)
    instead of silently losing digest coverage."""
    _record("audit_state")
    return {f.name: _copy(f, getattr(svc, f.attr)) for f in FIELDS}


def state_counts(svc: object) -> Dict[str, object]:
    """Every field's state() exposure: dict fields count, the optional
    singleton reports presence."""
    _record("state_counts")
    out: Dict[str, object] = {}
    for f in FIELDS:
        if not f.state_key:
            continue
        value = getattr(svc, f.attr)
        out[f.state_key] = (
            len(value) if f.container == "dict" else value is not None
        )
    return out


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
    """The registry-helper calls recorded since the last drain (armed
    mode only; disarmed, always empty)."""
    if not ACTIVE:
        return []
    with _CALLS_LOCK:
        out = list(_CALLS)
        _CALLS.clear()
        return out


def manifest() -> Dict[str, object]:
    """The registry as plain JSON-able data.  tests/test_statelint.py
    pins tools/statelint.py's AST extraction byte-identical to this —
    the proof the static twin lints the REAL declarations."""
    return {
        "version": 1,
        "fields": [
            {
                "name": f.name,
                "attr": f.attr,
                "container": f.container,
                "kinds": list(f.kinds),
                "digest_key": f.digest_key,
                "state_key": f.state_key,
                "rollback": f.rollback,
                "note": f.note,
            }
            for f in FIELDS
        ],
        "kinds": [
            {
                "kind": k.kind,
                "field": k.field,
                "gate": k.gate,
                "payload": k.payload,
                "note": k.note,
            }
            for k in KINDS
        ],
        "commit": dict(COMMIT),
    }
