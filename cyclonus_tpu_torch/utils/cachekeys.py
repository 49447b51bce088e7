"""Runtime cache-key registry: the dynamic twin of tools/cachelint.py
over the port (a copy of the reference package's utils/cachekeys.py).

The static pass proves, from the AST, that every cache of the engine
declares what it derives from.  This module adds the dynamic half — the
registry torch_tools/keyharness.py drives: every cache registers itself
with the NAMES of its key components, and the harness perturbs each
component one at a time, asserting a miss, then reverts and asserts a
hit.  A component that can be mutated without a miss is an incomplete
key — the stale-verdict-after-restart failure mode, caught
mechanically.

The port's families: ``autotune`` (persisted slab-autotune winners,
engine/autotune.py), ``kernels.library`` (the persisted kernel
libraries, engine/build.py), ``engine.pre_cache`` and
``engine.slab_ops`` (the steady state's pinned operands, engine/api.py).

Strip contract (the utils/guards.py / utils/contracts.py discipline):
`CYCLONUS_KEYHARNESS=1` is read ONCE at import.  With it unset —
production and the normal test suite — `register()` returns before
touching any state, the registry stays empty, and the
`cyclonus_tpu_cachekey_*` instruments are NEVER created, so their
absence from the metric registry is the proof the strip is real
(tests/test_torch_cachekeys.py asserts it).
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

#: read once at import (the guards.CHECK pattern): flipping it later
#: cannot resurrect registrations that never happened
ACTIVE: bool = os.environ.get("CYCLONUS_KEYHARNESS", "") == "1"

_LOCK = threading.Lock()
_REG: Dict[str, "RegisteredCache"] = {}  # guarded-by: _LOCK
_GAUGE = None  # lazily created instrument; None forever when inactive
_REGISTRATIONS = None


@dataclass(frozen=True)
class RegisteredCache:
    """One cache family and the key components the harness must prove
    complete.  `kind`: persisted (survives the process — kernel
    libraries / autotune winner files), program (in-process compiled-
    program dict), device (value-derived device state dropped by
    invalidate_after_patch)."""

    name: str
    kind: str
    components: Tuple[str, ...]
    fingerprint: Optional[str] = None


def register(
    name: str,
    *,
    kind: str,
    components: Tuple[str, ...],
    fingerprint: Optional[str] = None,
) -> Optional[RegisteredCache]:  # never-raises
    """Record one cache family (idempotent per name; the latest
    fingerprint wins).  A no-op returning None unless the harness env
    armed the registry at import."""
    if not ACTIVE:
        return None
    try:
        entry = RegisteredCache(name, kind, tuple(components), fingerprint)
        with _LOCK:
            _REG[name] = entry
            n = len(_REG)
        _instruments(n)
        return entry
    except Exception:  # the registry must never break a cache fill
        return None


def program(*components: str) -> Tuple[str, ...]:
    """Declaration descriptor for a cache site: names the key components
    both sides read — tools/cachelint.py CC001 statically treats the
    string constants as covered, and the caller passes the tuple on to
    register().  Returns the components unchanged."""
    return tuple(components)


def registered() -> Dict[str, RegisteredCache]:
    """Snapshot of the registry ({} when the harness env is unset)."""
    with _LOCK:
        return dict(_REG)


def registered_count() -> int:  # never-raises
    """How many cache families have registered (0 when inactive)."""
    try:
        with _LOCK:
            return len(_REG)
    except Exception:
        return 0


def clear() -> None:
    """Harness-only: reset between scenarios."""
    with _LOCK:
        _REG.clear()


def _instruments(n: int) -> None:
    """Create/update the cyclonus_tpu_cachekey_* instruments — ONLY
    reachable under the harness env, so with it unset they never enter
    the metric registry (the strip proof)."""
    global _GAUGE, _REGISTRATIONS
    if _GAUGE is None:
        from ..telemetry.metrics import REGISTRY

        _GAUGE = REGISTRY.gauge(
            "cyclonus_tpu_cachekey_registered",
            "Cache families registered with their key components "
            "(only exists under CYCLONUS_KEYHARNESS=1).",
        )
        _REGISTRATIONS = REGISTRY.counter(
            "cyclonus_tpu_cachekey_registrations_total",
            "Cache-registry registration events (only exists under "
            "CYCLONUS_KEYHARNESS=1).",
        )
    _GAUGE.set(n)
    _REGISTRATIONS.inc()
