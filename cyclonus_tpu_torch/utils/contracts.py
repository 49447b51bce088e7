"""Tensor and wire contracts: the runtime twin of tools/shapelint.py (a
copy of the reference package's utils/contracts.py, with dtypes read off
numpy arrays and torch tensors alike).

The static lint proves, from the AST, that tensors are BUILT consistently
with their declarations — `contracts.tensor(...)` descriptors on the
encoding dataclass fields, `contracts.args(...)` and `# shape: (N, L)
int32` trailing comments on kernel parameters.  This module adds the
sanitizer half for the shapes the AST cannot see (runtime-sized axes,
caller-supplied arrays, wire payloads), mirroring utils/guards.py:

    @contracts.checked
    @dataclass
    class ClusterEncoding:
        pod_kv: np.ndarray = contracts.tensor(
            "(N, L) int32", sentinel="-1=pad"
        )

Under `CYCLONUS_SHAPE_CHECK=1` (read once at import, same pattern as
guards.CHECK) every construction of a `checked` dataclass validates each
declared field against its spec — dtype exact, rank exact, literal dims
exact, and SYMBOLIC dims consistent across the instance (every field's
`N` must be the same N) — raising `ContractViolation` with the field
path and the observed shape/dtype.  With the variable unset, `checked`
returns the class untouched and `args` returns the function itself, so
the production cost of a contract is zero: no wrapper frame, no branch.

Only shapes and dtypes are read, never values: a value read on a CUDA
tensor would force a device sync, and the reference checks no values
either (sentinels and masks are declarations for the static lint).

Shape-spec grammar (shared with the static lint):

    "(N, L) int32"          dims: symbols or int literals; dtype optional
    sentinel="-1=pad"       fill values with reserved meaning
    mask="pod_ip_valid"     companion validity array: the field's values
                            are only meaningful where the mask is True

Wire contracts (`wire` / `check_wire`) are the dtype half for the worker
JSON model: required keys must be present with the declared Python type,
optional keys may be absent (worker/model.py docstring compat rules).
"""

from __future__ import annotations

import dataclasses
import functools
import inspect
import os
import re
from typing import Any, Callable, Dict, Optional, Tuple

# Read once at import: flipping it later cannot re-wrap classes that
# `checked` already returned untouched, so there is deliberately no
# setter (same contract as guards.CHECK).
CHECK: bool = os.environ.get("CYCLONUS_SHAPE_CHECK", "") == "1"

#: contract validations performed, tensor and wire (only ever moves under
#: CYCLONUS_SHAPE_CHECK=1)
CHECKS = 0


class ContractViolation(AssertionError):
    """A tensor (or wire field) disagreed with its declared contract."""


_SPEC_RE = re.compile(
    r"^\s*[(\[]\s*(?P<dims>[^)\]]*)[)\]]\s*(?P<dtype>[A-Za-z_][A-Za-z0-9_]*)?\s*$"
)
_DTYPES = {
    "bool",
    "int8",
    "int16",
    "int32",
    "int64",
    "uint8",
    "uint16",
    "uint32",
    "uint64",
    "float32",
    "float64",
    "bfloat16",
}


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """Parsed shape/dtype/sentinel declaration for one tensor."""

    dims: Tuple[object, ...]  # int literals or str symbols
    dtype: Optional[str]
    sentinel: Tuple[Tuple[int, str], ...] = ()
    mask: Optional[str] = None

    def render(self) -> str:
        dims = ", ".join(str(d) for d in self.dims)
        out = f"({dims}{',' if len(self.dims) == 1 else ''})"
        if self.dtype:
            out += f" {self.dtype}"
        return out


def parse_spec(
    text: str,
    sentinel: Optional[str] = None,
    mask: Optional[str] = None,
) -> TensorSpec:
    """'(N, L) int32' -> TensorSpec.  Dims are int literals or symbol
    names; the dtype token, when present, must be a canonical numpy
    name.  Raises ValueError at declaration time (import time for the
    dataclass descriptors) so a typo can never ship silently."""
    m = _SPEC_RE.match(text)
    if not m:
        raise ValueError(f"unparseable tensor spec {text!r}")
    dims: list = []
    raw = m.group("dims").strip()
    if raw:
        for tok in raw.split(","):
            tok = tok.strip()
            if not tok:
                continue
            if tok.lstrip("-").isdigit():
                dims.append(int(tok))
            elif re.fullmatch(r"[A-Za-z_][A-Za-z0-9_]*", tok):
                dims.append(tok)
            else:
                # "(N L)" (comma typo) must not become a rank-1 symbol
                # "N L": the declared rank would be wrong and every
                # correct array would violate it
                raise ValueError(
                    f"bad dim token {tok!r} in tensor spec {text!r}"
                )
    dtype = m.group("dtype")
    if dtype is not None and dtype not in _DTYPES:
        raise ValueError(f"unknown dtype {dtype!r} in tensor spec {text!r}")
    sent: list = []
    if sentinel:
        for part in sentinel.split(","):
            val, _, meaning = part.strip().partition("=")
            sent.append((int(val), meaning or "sentinel"))
    return TensorSpec(tuple(dims), dtype, tuple(sent), mask)


def tensor(
    spec: str, *, sentinel: Optional[str] = None, mask: Optional[str] = None
) -> Any:
    """Dataclass-field contract declaration:

        pod_ip: np.ndarray = contracts.tensor(
            "(N,) uint32", sentinel="0=invalid", mask="pod_ip_valid"
        )

    The spec parses eagerly (typos fail at import), and rides the field
    metadata: with checking off a contracts-annotated field is an
    ordinary required dataclass field, indistinguishable at runtime."""
    return dataclasses.field(
        metadata={"tensor": parse_spec(spec, sentinel=sentinel, mask=mask)}
    )


def _canon_dtype(dt: Any) -> str:
    """One name for a numpy dtype and a torch dtype of the same type:
    numpy's `.name` ("int32", "bool"), torch's str() less its "torch."
    prefix (torch dtypes have no `.name`)."""
    name = getattr(dt, "name", None) or str(dt)
    if name.startswith("torch."):
        name = name[len("torch."):]
    return {"bool_": "bool"}.get(name, name)


def _validate(
    name: str, value: Any, spec: TensorSpec, symbols: Dict[str, int]
) -> None:
    shape = getattr(value, "shape", None)
    dtype = getattr(value, "dtype", None)
    if shape is None or dtype is None:
        raise ContractViolation(
            f"{name}: declared {spec.render()} but observed a non-array "
            f"{type(value).__name__}"
        )
    shape = tuple(int(d) for d in shape)  # torch.Size and numpy alike
    if spec.dtype is not None and _canon_dtype(dtype) != spec.dtype:
        raise ContractViolation(
            f"{name}: declared dtype {spec.dtype} but observed "
            f"{_canon_dtype(dtype)} (shape {shape})"
        )
    if len(shape) != len(spec.dims):
        raise ContractViolation(
            f"{name}: declared {spec.render()} (rank {len(spec.dims)}) but "
            f"observed shape {shape}"
        )
    for dim, got in zip(spec.dims, shape):
        if isinstance(dim, int):
            if got != dim:
                raise ContractViolation(
                    f"{name}: declared {spec.render()} but observed shape "
                    f"{shape} (dim {dim} != {got})"
                )
        else:
            bound = symbols.setdefault(dim, got)
            if bound != got:
                raise ContractViolation(
                    f"{name}: symbol {dim} = {got} here but {bound} "
                    f"elsewhere in the same instance (observed shape "
                    f"{shape}, declared {spec.render()})"
                )


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


def validate_dataclass(obj: Any) -> None:
    """Check every contracts.tensor field of a dataclass instance; one
    shared symbol table, so cross-field dims (every field's N) must
    agree.  Called automatically by `checked` under CHECK."""
    symbols: Dict[str, int] = {}
    checked_n = 0
    cls = type(obj).__name__
    for f in dataclasses.fields(obj):
        spec = f.metadata.get("tensor")
        if spec is None:
            continue
        _validate(f"{cls}.{f.name}", getattr(obj, f.name), spec, symbols)
        checked_n += 1
    if checked_n:
        _count(checked_n)


def checked(cls: type) -> type:
    """Activate (CYCLONUS_SHAPE_CHECK=1) or skip (default) validation of
    every `contracts.tensor` field at construction time.  Apply OUTSIDE
    @dataclass.  With checking off the class is returned untouched:
    zero wrapper, zero branch."""
    if not CHECK:
        return cls
    orig_init = cls.__init__

    @functools.wraps(orig_init)
    def __init__(self, *a: Any, **kw: Any) -> None:
        orig_init(self, *a, **kw)
        validate_dataclass(self)

    cls.__init__ = __init__
    return cls


def args(**specs: str) -> Callable:
    """Function-parameter contracts (kernel entry points):

        @contracts.args(pod_ip="(N,) int64", pod_ip_valid="(N,) bool")
        def direction_precompute(...):

    The specs parse at def time and ride `__tensor_contracts__` for the
    static lint; with checking off the original function is returned
    (zero call overhead).  Under CHECK each call validates the named
    arguments that are arrays or tensors: shape/dtype reads only, so a
    CUDA tensor validates with no device sync."""
    parsed = {k: parse_spec(v) for k, v in specs.items()}

    def deco(fn: Callable) -> Callable:
        if not CHECK:
            fn.__tensor_contracts__ = parsed
            return fn
        sig = inspect.signature(fn)

        @functools.wraps(fn)
        def wrapper(*a: Any, **kw: Any):
            bound = sig.bind(*a, **kw)
            symbols: Dict[str, int] = {}
            n = 0
            for name, spec in parsed.items():
                v = bound.arguments.get(name)
                if v is not None and hasattr(v, "shape"):
                    _validate(f"{fn.__qualname__}({name})", v, spec, symbols)
                    n += 1
            if n:
                _count(n)
            return fn(*a, **kw)

        wrapper.__tensor_contracts__ = parsed
        return wrapper

    return deco


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
