"""The CYCLONUS_* environment vocabulary of the port as one declarative
registry: every flag's name, type, parsed default, owning subsystem and
one-line meaning, plus never-raise accessors that parse through the
registry (a copy of the reference's utils/envflags.py).

Accessors here never raise on a malformed value: they degrade to the
registered default.  Flags whose resolvers validate and raise on purpose
(CYCLONUS_PACK and CYCLONUS_MESH_SCHEDULE reject unknown modes where an
entry point resolves them) keep their validating parse at the resolver;
the registry still declares them so the vocabulary is complete.
tests/test_torch_envflags.py walks cyclonus_tpu_torch/ and fails on any
CYCLONUS_* token that is neither registered nor listed in DROPPED.

Bool semantics are encoded by the default: default False means the flag
is opt-in (`== "1"`), default True means opt-out (`!= "0"`).

The port registers one flag of its own, CYCLONUS_TORCH_BUILD_DIR (where
engine/build.py puts the compiled kernels).  It drops the reference's
flags that it never reads (DROPPED):

  * CYCLONUS_JAX_CACHE, CYCLONUS_AOT_CACHE, CYCLONUS_FULL_LOCATIONS: the
    jax compilation cache, the AOT executable cache and jaxpr source
    locations; eager torch compiles nothing per shape.
  * CYCLONUS_PALLAS_DTYPE: the TPU kernels' operand dtype; the port's
    dense kernels take int8 only.
  * CYCLONUS_BACKEND_TIMEOUT_S: the bound on attaching the remote TPU
    backend; the port has no backend attach.
  * CYCLONUS_AUTOTUNE_TIMEOUT_S, CYCLONUS_AUTOTUNE_DRAIN_S: the bound on
    the reference's candidate threads; the port's slab autotune times
    two kernels on the calling thread.
  * CYCLONUS_SERVE_PREWARM_PAIRS: the reference's pair-bucket prewarm;
    the port's query path pads nothing, so one call warms it.

Every harness recorder of the reference is registered: the cache-key
registry (utils/cachekeys.py, CYCLONUS_KEYHARNESS), the route recorder
(engine/planspec.py, CYCLONUS_PLANHARNESS), the state registry's call
recorder (CYCLONUS_STATEHARNESS) and the wire skew-view recorder
(worker/wireregistry.py, CYCLONUS_SKEWHARNESS).

Nothing here imports torch: the in-pod worker loads this module through
the chaos points of worker/client.py.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple


@dataclass(frozen=True)
class Flag:
    name: str
    kind: str  # "bool" | "int" | "float" | "enum" | "str" | "path"
    default: object
    owner: str  # "engine" | "serve" | "worker" | "chaos" | "telemetry" | "harness" | "slo" | "audit"
    description: str
    choices: Tuple[str, ...] = field(default=())


_FLAGS = [
    # --- engine: evaluation plans and budgets -------------------------
    Flag("CYCLONUS_SLAB_MAX_BYTES", "int", 6 * 2**30, "engine",
         "Device byte budget shared by counts slabs, CIDR staging, and "
         "serve's staged patches (default 6 GiB)."),
    Flag("CYCLONUS_PACK", "enum", "auto", "engine",
         "Packed dtype plan kill switch; resolved eagerly at entry "
         "points (encoding.resolve_pack).", choices=("auto", "0", "1")),
    Flag("CYCLONUS_COMPACT", "enum", "", "engine",
         "Rule-compaction opt-out: '0' disables, '1' forces past the "
         "host-work budget, '' (default) auto.", choices=("", "0", "1")),
    Flag("CYCLONUS_PRE_CACHE", "bool", True, "engine",
         "Steady-state cache of a case set's precompute and kernel "
         "operands."),
    Flag("CYCLONUS_CLASS_COMPRESS", "enum", "auto", "engine",
         "Pod-class compression: 'auto' (size floor), '1' (force), "
         "'0' (off).", choices=("auto", "0", "1")),
    Flag("CYCLONUS_CLASS_MIN_PODS", "int", 4096, "engine",
         "Pod-count floor below which auto class compression stays "
         "off."),
    Flag("CYCLONUS_TORCH_BUILD_DIR", "path", "", "engine",
         "Directory of the compiled CUDA kernels ('' picks build/"
         "torch_kernels/ in the checkout)."),
    # --- engine: kernels and autotune ---------------------------------
    Flag("CYCLONUS_PALLAS_SLAB", "enum", "auto", "engine",
         "Slab kernel (K6) plan: 'auto' (CUDA with the pre-cache on), "
         "'1', '0'.", choices=("auto", "0", "1")),
    Flag("CYCLONUS_MESH_SCHEDULE", "enum", "ring", "engine",
         "Sharded counts schedule (sharded.mesh_schedule).",
         choices=("ring", "allgather", "ring2d", "ring-pipelined")),
    Flag("CYCLONUS_AUTOTUNE", "enum", "auto", "engine",
         "Steady-state slab autotune: 'auto' (CUDA only), '1' (force, "
         "plain versions ok), '0' (off).", choices=("auto", "0", "1")),
    Flag("CYCLONUS_AUTOTUNE_REPS", "int", 4, "engine",
         "Timed reps per autotune round."),
    Flag("CYCLONUS_AUTOTUNE_ROUNDS", "int", 3, "engine",
         "Autotune rounds per candidate."),
    Flag("CYCLONUS_AUTOTUNE_CACHE", "path", "", "engine",
         "Autotune winners file; '0' disables, unset picks the default "
         "path."),
    # --- engine: CIDR pre-classification ------------------------------
    Flag("CYCLONUS_CIDR_TSS", "enum", "auto", "engine",
         "TSS/LPM CIDR pre-classification: 'auto' (spec floor), '1', "
         "'0'.", choices=("auto", "0", "1")),
    Flag("CYCLONUS_CIDR_TSS_MIN", "int", 256, "engine",
         "CIDR spec-count floor for auto TSS."),
    Flag("CYCLONUS_CIDR_TSS_DEVICE", "enum", "auto", "engine",
         "Device-side TSS classify: 'auto' (cell floor), '1', '0'.",
         choices=("auto", "0", "1")),
    Flag("CYCLONUS_CIDR_DEVICE_MIN", "int", 1 << 24, "engine",
         "Cell-count floor for auto device-side TSS classify."),
    # --- serve ---------------------------------------------------------
    Flag("CYCLONUS_SERVE_HEADROOM", "int", 1, "serve",
         "Spare rule-slab bucket steps reserved past the live "
         "snapshot's need."),
    Flag("CYCLONUS_SERVE_PREWARM", "bool", True, "serve",
         "Prewarm the query path at serve start."),
    Flag("CYCLONUS_SERVE_CHURN_ROWS", "int", 64, "serve",
         "Row-growth slack per incremental patch flush."),
    Flag("CYCLONUS_SERVE_CHURN_FRAC", "float", 0.25, "serve",
         "Fraction of snapshot rows tolerated as staged churn before "
         "rebuild."),
    # --- worker / fleet -------------------------------------------------
    Flag("CYCLONUS_WORKER_TIMEOUT_S", "float", 120.0, "worker",
         "Per-request worker RPC timeout."),
    Flag("CYCLONUS_WORKER_RETRIES", "int", 2, "worker",
         "Worker RPC retry attempts."),
    Flag("CYCLONUS_WORKER_BACKOFF_S", "float", 0.5, "worker",
         "Base backoff between worker RPC retries."),
    Flag("CYCLONUS_WORKER_IMAGE", "str", "cyclonus-tpu-worker:latest",
         "worker", "Worker container image."),
    Flag("CYCLONUS_AGNHOST_IMAGE", "str", "", "worker",
         "Agnhost probe image override."),
    Flag("CYCLONUS_CONNECT_NATIVE", "bool", False, "worker",
         "Probe with native sockets instead of agnhost exec."),
    Flag("CYCLONUS_SOURCE_IP", "str", "", "worker",
         "Source IP override for native probes."),
    # --- chaos ----------------------------------------------------------
    Flag("CYCLONUS_CHAOS", "str", "", "chaos",
         "Fault-injection spec armed for the chaos harness."),
    Flag("CYCLONUS_CHAOS_TTFV_S", "float", 150.0, "chaos",
         "Time-to-first-verdict bound asserted by the chaos harness."),
    # --- telemetry ------------------------------------------------------
    Flag("CYCLONUS_TELEMETRY", "bool", True, "telemetry",
         "Telemetry counters/gauges master switch."),
    Flag("CYCLONUS_TRACE_EVENTS", "bool", False, "telemetry",
         "Structured event trace emission."),
    Flag("CYCLONUS_TRACE_EVENTS_N", "int", 8192, "telemetry",
         "Event trace ring capacity."),
    Flag("CYCLONUS_TRACE_ID", "str", "", "telemetry",
         "Trace correlation id attached to emitted events."),
    Flag("CYCLONUS_TRACE_VERDICTS", "bool", False, "telemetry",
         "Per-verdict trace logging in the probe runner."),
    Flag("CYCLONUS_FLIGHT_RECORDER_PATH", "path", "", "telemetry",
         "Flight-recorder dump path ('' picks the default)."),
    Flag("CYCLONUS_FLIGHT_RECORDER_N", "int", 64, "telemetry",
         "Flight-recorder ring capacity."),
    # --- slo: objectives, windows, and enforcement ----------------------
    Flag("CYCLONUS_SLO_QUERY_P99_S", "float", 0.25, "slo",
         "query_p99 objective target: per-flow query latency bound."),
    Flag("CYCLONUS_SLO_FRESHNESS_S", "float", 5.0, "slo",
         "freshness objective target: oldest pending delta's tolerated "
         "wait age."),
    Flag("CYCLONUS_SLO_TTFV_S", "float", 150.0, "slo",
         "ttfv objective target: time-to-first-verdict after restart."),
    Flag("CYCLONUS_SLO_BUDGET", "float", 0.01, "slo",
         "Error budget shared by the declared objectives (tolerated "
         "bad-event fraction)."),
    Flag("CYCLONUS_SLO_FAST_S", "float", 300.0, "slo",
         "Fast burn-rate window (seconds)."),
    Flag("CYCLONUS_SLO_SLOW_S", "float", 3600.0, "slo",
         "Slow burn-rate window (seconds)."),
    Flag("CYCLONUS_SLO_ENFORCE", "bool", False, "slo",
         "Arm SLO enforcement (admission control, shed, degraded-path "
         "governance); accounting and /slo run regardless."),
    Flag("CYCLONUS_SLO_QUEUE_CAP", "int", 1024, "slo",
         "Pending-delta queue cap applied while the freshness budget "
         "is burning."),
    Flag("CYCLONUS_SLO_ENTER_BURN", "float", 2.0, "slo",
         "Fast-window burn rate at which an objective enters "
         "'burning'."),
    Flag("CYCLONUS_SLO_EXIT_BURN", "float", 1.0, "slo",
         "Burn rate both windows must stay below to start the exit "
         "hold."),
    Flag("CYCLONUS_SLO_HOLD_S", "float", 60.0, "slo",
         "Continuous below-exit-threshold time required to leave an "
         "enforcement state."),
    # --- audit: shadow-oracle sampling + epoch digests ------------------
    Flag("CYCLONUS_AUDIT", "bool", False, "audit",
         "Arm the verdict audit plane (shadow-oracle sampler, epoch "
         "digests, /audit route); off strips the query path to one "
         "attribute check."),
    Flag("CYCLONUS_AUDIT_RATE", "float", 0.05, "audit",
         "Fraction of answered flow queries the shadow-oracle sampler "
         "re-checks (seeded Bernoulli per verdict)."),
    Flag("CYCLONUS_AUDIT_QUEUE", "int", 1024, "audit",
         "Audit check-queue cap; overflow drops are counted, never "
         "block the query path."),
    Flag("CYCLONUS_AUDIT_SEED", "int", 0, "audit",
         "Sampler RNG seed (deterministic sampling decisions for a "
         "fixed query order)."),
    Flag("CYCLONUS_AUDIT_DIGEST_ROWS", "int", 8, "audit",
         "Truth-table rows sampled into each epoch digest (seeded off "
         "the state digest, so replicas sample identical rows)."),
    Flag("CYCLONUS_AUDIT_EPOCHS", "int", 8, "audit",
         "Epoch snapshot ring depth: checks older than this many "
         "committed epochs are dropped as epoch_evicted."),
    # --- harnesses (strip contracts: read ONCE at import) ---------------
    Flag("CYCLONUS_SHAPE_CHECK", "bool", False, "harness",
         "Arm runtime shape-contract checks (utils/contracts.py)."),
    Flag("CYCLONUS_GUARD_CHECK", "bool", False, "harness",
         "Arm runtime lock-guard checks (utils/guards.py)."),
    Flag("CYCLONUS_KEYHARNESS", "bool", False, "harness",
         "Arm the cache-key mutation recorder (utils/cachekeys.py)."),
    Flag("CYCLONUS_PLANHARNESS", "bool", False, "harness",
         "Arm the dispatch-route recorder (engine/planspec.py)."),
    Flag("CYCLONUS_STATEHARNESS", "bool", False, "harness",
         "Arm the state-surface registry call recorder "
         "(serve/stateregistry.py)."),
    Flag("CYCLONUS_SKEWHARNESS", "bool", False, "harness",
         "Arm the wire skew-view recorder (worker/wireregistry.py)."),
]

REGISTRY: Dict[str, Flag] = {f.name: f for f in _FLAGS}

#: the reference's flags the port never reads (see the module docstring)
DROPPED: Tuple[str, ...] = (
    "CYCLONUS_JAX_CACHE",
    "CYCLONUS_AOT_CACHE",
    "CYCLONUS_FULL_LOCATIONS",
    "CYCLONUS_PALLAS_DTYPE",
    "CYCLONUS_BACKEND_TIMEOUT_S",
    "CYCLONUS_AUTOTUNE_TIMEOUT_S",
    "CYCLONUS_AUTOTUNE_DRAIN_S",
    "CYCLONUS_SERVE_PREWARM_PAIRS",
)


def get_raw(name: str) -> Optional[str]:
    """The unparsed environment value, or None when unset.  `name` must
    be registered: an unregistered read is a programming error and raises
    KeyError."""
    flag = REGISTRY[name]
    return os.environ.get(flag.name)


def get_int(name: str) -> int:  # never-raises (registered names)
    flag = REGISTRY[name]
    raw = os.environ.get(name)
    if raw is None:
        return int(flag.default)
    try:
        return int(raw)
    except (ValueError, TypeError):
        return int(flag.default)


def get_float(name: str) -> float:  # never-raises (registered names)
    flag = REGISTRY[name]
    raw = os.environ.get(name)
    if raw is None:
        return float(flag.default)
    try:
        return float(raw)
    except (ValueError, TypeError):
        return float(flag.default)


def get_bool(name: str) -> bool:  # never-raises (registered names)
    """Default-False flags are opt-in (== '1'); default-True flags are
    opt-out (!= '0'), selected by the registered default."""
    flag = REGISTRY[name]
    raw = os.environ.get(name)
    if raw is None:
        return bool(flag.default)
    return raw != "0" if flag.default else raw == "1"


def get_enum(name: str) -> str:  # never-raises (registered names)
    """Lower-cased value, degrading to the registered default when the
    value is not a registered choice."""
    flag = REGISTRY[name]
    raw = os.environ.get(name)
    if raw is None:
        return str(flag.default)
    val = raw.lower()
    return val if val in flag.choices else str(flag.default)


def get_str(name: str) -> str:  # never-raises (registered names)
    flag = REGISTRY[name]
    raw = os.environ.get(name)
    return str(flag.default) if raw is None else raw


def _render_default(flag: Flag) -> str:
    if flag.kind == "bool":
        return "on" if flag.default else "off"
    if flag.name == "CYCLONUS_SLAB_MAX_BYTES":
        return "6 GiB"
    if flag.default == "":
        return "(unset)"
    return str(flag.default)


def markdown_table(owner: Optional[str] = None) -> str:
    """The env-var table of the registry as Markdown, one row a flag (all
    of them, or those of one `owner`), as the reference renders its
    README table."""
    rows = [f for f in _FLAGS if owner is None or f.owner == owner]
    out = ["| Variable | Type | Default | Subsystem | Meaning |",
           "| --- | --- | --- | --- | --- |"]
    for f in rows:
        out.append(
            f"| `{f.name}` | {f.kind} | {_render_default(f)} | "
            f"{f.owner} | {f.description} |"
        )
    return "\n".join(out)
