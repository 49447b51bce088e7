"""Wire contracts: the dtype half for the worker JSON model (a copy of
the reference package's utils/contracts.py, cut to its wire contracts;
the tensor-shape contracts stay there).  Required keys must be present
with the declared Python type, optional keys may be absent (worker/
model.py docstring compat rules).

Under `CYCLONUS_SHAPE_CHECK=1` (read once at import, same pattern as
guards.CHECK) the model classes validate every payload they emit and
read; with the variable unset the call sites skip the check on one
module-attribute read.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict

# Read once at import (same contract as guards.CHECK).
CHECK: bool = os.environ.get("CYCLONUS_SHAPE_CHECK", "") == "1"

#: wire-contract validations performed (only ever moves under
#: CYCLONUS_SHAPE_CHECK=1)
CHECKS = 0


class ContractViolation(AssertionError):
    """A wire field disagreed with its declared contract."""


_COUNTER = None


def _count(n: int) -> None:
    """Contract-check telemetry.  The counter is created ON FIRST CHECK,
    as in the reference, so with CYCLONUS_SHAPE_CHECK unset it never
    enters the metric registry."""
    global CHECKS, _COUNTER
    CHECKS += n
    if _COUNTER is None:
        from ..telemetry.metrics import REGISTRY

        _COUNTER = REGISTRY.counter(
            "cyclonus_tpu_contract_checks_total",
            "Tensor-contract validations performed (only exists under "
            "CYCLONUS_SHAPE_CHECK=1).",
        )
    _COUNTER.inc(n)


# --- wire contracts (worker/model.py JSON payloads) ----------------------


@dataclasses.dataclass(frozen=True)
class WireField:
    """Dtype contract for one wire key: the Python type a peer may rely
    on, and whether the key may be absent (worker/model.py compat rules:
    every extension is optional, the reference shape is frozen)."""

    type: type
    optional: bool = False


def wire(py_type: type, optional: bool = False) -> WireField:
    return WireField(py_type, optional)


def check_wire(
    name: str,
    d: Dict[str, Any],
    contract: Dict[str, WireField],
    partial: bool = False,
) -> None:
    """Validate a parsed/emitted wire dict against its contract.  Call
    sites gate on `contracts.CHECK` themselves (guards.assert_held
    pattern) so the disabled cost stays one module-attribute read.
    `partial=True` type-checks only the keys that are PRESENT — the
    parse-side mode, where the compat rules require tolerating absent
    keys from old peers."""
    for key, wf in contract.items():
        if key not in d:
            if wf.optional or partial:
                continue
            raise ContractViolation(f"{name}.{key}: required wire key absent")
        v = d[key]
        ok = isinstance(v, wf.type) or (
            wf.type is float and isinstance(v, int) and not isinstance(v, bool)
        )
        if not ok:
            raise ContractViolation(
                f"{name}.{key}: declared {wf.type.__name__} but observed "
                f"{type(v).__name__} ({v!r})"
            )
    _count(1)


def check_wire_read(
    name: str,
    d: Any,
    contract: Dict[str, WireField],
) -> None:
    """The reader-side twin of check_wire: validate a payload that came
    OFF the wire from a peer.  Shape first (a malformed line must be
    rejected with the payload named, not surface as a downstream
    KeyError/TypeError), then present-key dtype drift — absent optional
    keys and unknown keys are both legal (old peer / new peer), so this
    is exactly check_wire's partial mode on top of the object check.
    Call sites gate on `contracts.CHECK` (CYCLONUS_SHAPE_CHECK=1)."""
    if not isinstance(d, dict):
        raise ContractViolation(
            f"{name}: wire payload must be an object, got "
            f"{type(d).__name__} ({d!r})"
        )
    check_wire(name, d, contract, partial=True)
