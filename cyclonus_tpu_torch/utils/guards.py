"""Runtime lock-discipline guards: the dynamic twin of tools/locklint.py.

The static lint proves, from the AST, that attributes declared
`# guarded-by: <lock>` are only touched under `with <lock>:`.  This
module adds the sanitizer half — the checks Go gets from `go test -race`
and C++ from Clang's Thread Safety Analysis runtime — for the schedules
the AST cannot see (callbacks, monkeypatched paths, test harnesses):

    @guards.checked
    class BoundedRing:
        _items = guards.Guarded("_lock")      # declared contract

Under `CYCLONUS_GUARD_CHECK=1` (read once at import, same pattern as
`telemetry.events.ACTIVE`) every `Guarded` declaration becomes a data
descriptor that raises `GuardViolation` when the attribute is read or
written without its lock held.  With the variable unset, `checked`
REMOVES the declarations from the class, so the attributes are plain
instance slots — the production cost of a guard is exactly zero: one
ordinary attribute access, no descriptor call, no branch
(tests/test_locklint.py pins this with the same min-of-5 differential
method as the telemetry overhead tests).

The first write to a guarded attribute (normally in `__init__`, before
the object is visible to any other thread) is exempt, mirroring the
static lint's constructor exemption — construction happens-before
publication.

`holds("self._lock")` declares a function's calling contract (the lock
must already be held); locklint treats its body as lock-held, and under
CYCLONUS_GUARD_CHECK=1 the contract is asserted on entry.
"""

from __future__ import annotations

import functools
import os
import threading
from typing import Any, Callable, Optional

# Read once at import: flipping it later cannot resurrect descriptors
# that `checked` already stripped, so there is deliberately no setter.
CHECK: bool = os.environ.get("CYCLONUS_GUARD_CHECK", "") == "1"


class GuardViolation(AssertionError):
    """A guarded attribute was accessed without its declared lock held."""


def lock():
    """The lock constructor for guard-checked classes: a plain
    threading.Lock in production, an OWNERSHIP-checkable RLock under
    CYCLONUS_GUARD_CHECK=1.  A plain Lock only knows that *someone*
    holds it, so under contention an unguarded access slips past the
    assertion exactly when another thread is inside its critical
    section — the schedules the race harness generates.  RLock's
    `_is_owned` pins the check to THIS thread.  (tools/locklint.py
    recognizes `guards.lock()` as a lock constructor.)"""
    return threading.RLock() if CHECK else threading.Lock()


def lock_held(lock: Any) -> bool:
    """Best-effort 'is this lock held' probe.

    RLocks know their owner (`_is_owned`); plain Locks only know they
    are locked — good enough for an assertion that catches unguarded
    access (an access racing the true holder is exactly the schedule the
    race harness fuzzes for, and it still trips when the holder is
    between critical sections).
    """
    owned = getattr(lock, "_is_owned", None)
    if owned is not None:
        return bool(owned())
    locked = getattr(lock, "locked", None)
    if locked is not None:
        return bool(locked())
    return True  # unknown lock type: never false-positive


def assert_held(lock: Any, what: str = "shared state") -> None:
    """Module-level-state variant of the descriptor check (descriptors
    need a class); call sites gate on `guards.CHECK` themselves so the
    disabled cost stays one module-attribute read."""
    if CHECK and not lock_held(lock):
        raise GuardViolation(
            f"{what} accessed without its declared lock held"
        )


class Guarded:
    """Class-body declaration `attr = Guarded("<lock attr name>")`.

    Only meaningful on a class passed through `@checked`: with checking
    on it becomes the asserting data descriptor below; with checking off
    it is deleted and the attribute reverts to a plain instance slot.
    """

    def __init__(self, lock_attr: str):
        self.lock_attr = lock_attr
        self.name: Optional[str] = None
        self.slot: Optional[str] = None

    def __set_name__(self, owner: type, name: str) -> None:
        self.name = name
        self.slot = f"_guarded__{name}"

    def __get__(self, obj: Any, objtype: Optional[type] = None) -> Any:
        if obj is None:
            return self
        try:
            value = obj.__dict__[self.slot]
        except KeyError:
            raise AttributeError(self.name) from None
        self._check(obj, "read")
        return value

    def __set__(self, obj: Any, value: Any) -> None:
        # first write = construction (happens-before publication): exempt
        if self.slot in obj.__dict__:
            self._check(obj, "write")
        obj.__dict__[self.slot] = value

    def _check(self, obj: Any, verb: str) -> None:
        lock = getattr(obj, self.lock_attr, None)
        if lock is not None and not lock_held(lock):
            raise GuardViolation(
                f"{type(obj).__name__}.{self.name} {verb} without "
                f"self.{self.lock_attr} held (declared guarded-by)"
            )


def checked(cls: type) -> type:
    """Activate (CYCLONUS_GUARD_CHECK=1) or strip (default) every
    `Guarded` declaration in the class body."""
    if not CHECK:
        for name, val in list(vars(cls).items()):
            if isinstance(val, Guarded):
                delattr(cls, name)
    return cls


def _resolve(obj: Any, expr: str) -> Optional[Any]:
    """'self._lock' / 'self.a.b' -> the lock object on `obj` (None when
    the expression is not self-rooted or any hop is missing)."""
    parts = expr.split(".")
    if parts[0] != "self":
        return None
    cur = obj
    for p in parts[1:]:
        cur = getattr(cur, p, None)
        if cur is None:
            return None
    return cur


def holds(*lock_exprs: str) -> Callable:
    """Declare that the decorated method requires the named locks held
    by its caller (locklint treats the body as lock-held; the grammar is
    the same 'self.<attr>' expression the guarded-by comments use).
    Under CYCLONUS_GUARD_CHECK=1 the contract is asserted on entry."""

    def deco(fn: Callable) -> Callable:
        if not CHECK:
            fn.__locklint_holds__ = lock_exprs
            return fn

        @functools.wraps(fn)
        def wrapper(self, *args, **kwargs):
            for expr in lock_exprs:
                lock = _resolve(self, expr)
                if lock is not None and not lock_held(lock):
                    raise GuardViolation(
                        f"{fn.__qualname__} requires {expr} held"
                    )
            return fn(self, *args, **kwargs)

        wrapper.__locklint_holds__ = lock_exprs
        return wrapper

    return deco
