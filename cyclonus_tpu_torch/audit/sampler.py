"""AuditController: the shadow-oracle sampler behind the audit plane.

The serving hot path pays exactly one attribute check when auditing is
disabled (`service._audit is None`) and one `offer()` when enabled:
a seeded Bernoulli draw, an optional chaos corruption, and a bounded
deque append — never an oracle evaluation, never a digest, never I/O.
Everything expensive runs on one daemon worker thread:

  * sampled checks pop off the queue and re-evaluate against the scalar
    TieredPolicy oracle ON THE SNAPSHOT OF THE QUERY'S EPOCH — the
    per-epoch snapshot ring (note_epoch) holds the authoritative dicts
    plus the built policy/tiers exactly as they were when the verdict
    was computed, exploiting apply's replace-wholesale discipline
    (shallow dict copies are stable).  A check whose epoch aged out of
    the ring is dropped and counted (reason=epoch_evicted), never
    evaluated against the wrong state.
  * each committed epoch gets a canonical state digest (digest.py),
    exported on /audit and state().

Divergence posture: a mismatch is forensic evidence, never an exception
on the serving path.  The worker records a full repro bundle (query,
both verdicts, the serve route, epoch, pack/class/tier config, the
canonical state when small), dumps the flight recorder with reason
``audit-divergence``, and bumps cyclonus_tpu_audit_diverged_total —
which the SLO engine's ``verdict_integrity`` objective reads as its bad
count (breach-dump, never query-blocking).

Chaos: ``verdict_corrupt`` fires at the sampling intake and flips the
SAMPLED entry's served allow bits — so an armed corruption is detected
within a bounded number of checks by construction, not by sampling
luck.

Lock order: service._lock -> audit._lock (note_epoch runs under the
service lock; offer runs after it is released) and audit._lock ->
metric locks.  The worker never takes the service lock, so the
acquisition graph stays acyclic.

The worker reads only the host snapshots note_epoch was handed (plain
dicts and the compiled scalar policy); it never touches a device tensor.
"""

from __future__ import annotations

import random
import threading
import time
from collections import deque
from typing import Any, Dict, Optional, Tuple

from .. import chaos
from ..telemetry import instruments as ti
from ..telemetry import recorder
from ..utils import envflags, guards
from . import digest as dg

#: pods at or below this count embed the full canonical state in a
#: divergence bundle; above it the bundle carries the digest + counts
#: (a 10k-pod snapshot would drown the flight-recorder ring)
BUNDLE_STATE_MAX_PODS = 256


@guards.checked
class AuditController:
    """See the module docstring."""

    _queue = guards.Guarded("_lock")
    _snapshots = guards.Guarded("_lock")
    _epochs = guards.Guarded("_lock")
    _pending = guards.Guarded("_lock")
    _digests = guards.Guarded("_lock")
    _rng = guards.Guarded("_lock")
    _inflight = guards.Guarded("_lock")
    _sampled = guards.Guarded("_lock")
    _last_divergence = guards.Guarded("_lock")

    def __init__(
        self,
        *,
        rate: Optional[float] = None,
        queue_cap: Optional[int] = None,
        seed: Optional[int] = None,
        digest_rows: Optional[int] = None,
        epoch_ring: Optional[int] = None,
        start_worker: bool = True,
    ):
        self._lock = guards.lock()
        self.rate = (
            envflags.get_float("CYCLONUS_AUDIT_RATE")
            if rate is None else float(rate)
        )
        self.queue_cap = max(1, (
            envflags.get_int("CYCLONUS_AUDIT_QUEUE")
            if queue_cap is None else int(queue_cap)
        ))
        self.seed = (
            envflags.get_int("CYCLONUS_AUDIT_SEED")
            if seed is None else int(seed)
        )
        self.digest_rows = (
            envflags.get_int("CYCLONUS_AUDIT_DIGEST_ROWS")
            if digest_rows is None else int(digest_rows)
        )
        self.epoch_ring = max(1, (
            envflags.get_int("CYCLONUS_AUDIT_EPOCHS")
            if epoch_ring is None else int(epoch_ring)
        ))
        self._queue: deque = deque()
        self._snapshots: Dict[int, Dict[str, Any]] = {}
        self._epochs: deque = deque()  # snapshot insertion order
        self._pending: deque = deque()  # epochs awaiting a digest
        self._digests: Dict[int, Dict[str, Any]] = {}
        self._rng = random.Random(self.seed)
        self._inflight = 0
        self._sampled = 0
        self._last_divergence: Optional[Dict[str, Any]] = None
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._worker: Optional[threading.Thread] = None
        if start_worker:
            self._worker = threading.Thread(
                target=self._run, name="audit-worker", daemon=True
            )
            self._worker.start()

    # --- intake (serving-path side) ---------------------------------------

    def note_epoch(
        self,
        epoch: int,
        *,
        pods: Dict[str, Tuple[str, str, Dict[str, str], str]],
        namespaces: Dict[str, Dict[str, str]],
        netpols: Dict[str, Any],
        anps: Dict[str, Any],
        banp: Optional[Any],
        policy: Any,
        tiers: Optional[Any],
        config: Optional[Dict[str, Any]] = None,
    ) -> None:
        """Register a committed epoch's state snapshot (the caller holds
        the service lock and passes fresh shallow dict copies).  Evicts
        the oldest snapshot past the ring depth — dropping any queued
        checks stranded on it — and schedules the digest."""
        dropped = 0
        with self._lock:
            self._snapshots[int(epoch)] = {
                "pods": pods,
                "namespaces": namespaces,
                "netpols": netpols,
                "anps": anps,
                "banp": banp,
                "policy": policy,
                "tiers": tiers,
                "config": dict(config or {}),
            }
            self._epochs.append(int(epoch))
            self._pending.append(int(epoch))
            while len(self._epochs) > self.epoch_ring:
                old = self._epochs.popleft()
                self._snapshots.pop(old, None)
                keep = deque()
                for item in self._queue:
                    if item["epoch"] == old:
                        dropped += 1
                    else:
                        keep.append(item)
                self._queue = keep
            while len(self._digests) > self.epoch_ring:
                oldest = min(self._digests)
                del self._digests[oldest]
            depth = len(self._queue)
        if dropped:
            ti.AUDIT_DROPPED.inc(dropped, reason="epoch_evicted")
            ti.AUDIT_QUEUE_DEPTH.set(depth)
        self._wake.set()

    def sample(self) -> bool:
        """The seeded Bernoulli draw alone — the ONLY per-verdict cost
        the serving path pays for an unsampled flow.  Callers draw
        first and build the offer entry only on True, so the common
        (rejected) case allocates nothing."""
        with self._lock:
            if self._rng.random() >= self.rate:
                return False
            self._sampled += 1
            return True

    def offer(
        self,
        query: Dict[str, Any],
        served: Tuple[bool, bool, bool],
        route: str,
        epoch: int,
        *,
        presampled: bool = False,
    ) -> bool:
        """Maybe-sample one answered flow (called with the service lock
        RELEASED): seeded Bernoulli draw (skipped when the caller
        already won a `sample()` draw — presampled=True), chaos
        corruption point, and a bounded enqueue.  Returns True when the
        flow was enqueued."""
        if not presampled and not self.sample():
            return False
        # the corruption point sits AFTER the sampling draw on purpose:
        # an armed verdict_corrupt flips a verdict the auditor is
        # guaranteed to check, so detection is bounded by the check
        # budget instead of sampling luck
        try:
            chaos.fire("verdict_corrupt")
        except chaos.ChaosError:
            served = (not served[0], not served[1], not served[2])
        entry = {
            "query": dict(query),
            "served": (bool(served[0]), bool(served[1]), bool(served[2])),
            "route": str(route),
            "epoch": int(epoch),
        }
        with self._lock:
            if len(self._queue) >= self.queue_cap:
                depth = len(self._queue)
                overflow = True
            else:
                self._queue.append(entry)
                depth = len(self._queue)
                overflow = False
        if overflow:
            ti.AUDIT_DROPPED.inc(reason="overflow")
        ti.AUDIT_QUEUE_DEPTH.set(depth)
        self._wake.set()
        return not overflow

    # --- worker -----------------------------------------------------------

    def _run(self) -> None:
        while not self._stop.is_set():
            self._wake.wait(timeout=0.05)
            self._wake.clear()
            try:
                self.drain()
            except Exception:
                pass  # the audit plane never takes the service down

    def drain(self) -> int:
        """Process every queued check and pending digest on the CALLING
        thread (the worker's loop body; also the synchronous path tests
        and the drills use).  Returns the number
        of checks evaluated."""
        done = 0
        while True:
            with self._lock:
                epoch = self._pending.popleft() if self._pending else None
                snap = (
                    self._snapshots.get(epoch)
                    if epoch is not None else None
                )
            if epoch is None:
                break
            if snap is None:
                continue  # evicted before its digest was computed
            d = dg.epoch_digest(
                epoch,
                snap["pods"], snap["namespaces"], snap["netpols"],
                snap["anps"], snap["banp"], snap["policy"], snap["tiers"],
                seed=self.seed, n_rows=self.digest_rows,
            )
            with self._lock:
                self._digests[epoch] = d
                while len(self._digests) > self.epoch_ring:
                    del self._digests[min(self._digests)]
            ti.AUDIT_DIGEST_SECONDS.set(d["seconds"])
            ti.AUDIT_DIGEST_EPOCH.set(epoch)
        while True:
            with self._lock:
                if not self._queue:
                    break
                entry = self._queue.popleft()
                snap = self._snapshots.get(entry["epoch"])
                self._inflight += 1
                depth = len(self._queue)
            ti.AUDIT_QUEUE_DEPTH.set(depth)
            try:
                if snap is None:
                    ti.AUDIT_DROPPED.inc(reason="epoch_evicted")
                else:
                    self._check(entry, snap)
                    done += 1
            finally:
                with self._lock:
                    self._inflight -= 1
        return done

    def _check(self, entry: Dict[str, Any], snap: Dict[str, Any]) -> None:
        """One shadow-oracle re-evaluation: the divergence edge of the
        whole audit plane."""
        from ..oracle import traffic_for_cell
        from ..engine import planspec
        from ..engine.api import PortCase
        from ..matcher.tiered import tiered_oracle_verdicts

        planspec.record("serve.audit.check")
        t0 = time.perf_counter()
        q = entry["query"]
        pods_list = list(snap["pods"].values())
        idx = {f"{p[0]}/{p[1]}": i for i, p in enumerate(pods_list)}
        si, di = idx.get(q["src"]), idx.get(q["dst"])
        if si is None or di is None:
            # the verdict answered at this epoch, so a missing pod means
            # the snapshot contract broke — that IS a divergence
            want: Tuple[bool, bool, bool] = (False, False, False)
            missing = q["src"] if si is None else q["dst"]
            diverged = True
            detail = f"pod {missing!r} absent from epoch snapshot"
        else:
            t = traffic_for_cell(
                pods_list, snap["namespaces"],
                PortCase(q["port"], q["port_name"], q["protocol"]),
                si, di,
            )
            want = tiered_oracle_verdicts(
                snap["policy"], snap["tiers"], t
            )
            diverged = tuple(entry["served"]) != (
                bool(want[0]), bool(want[1]), bool(want[2])
            )
            detail = ""
        ti.AUDIT_CHECKED.inc()
        ti.AUDIT_CHECK_LATENCY.observe(time.perf_counter() - t0)
        if diverged:
            self._divergence(entry, snap, want, detail)

    def _divergence(
        self,
        entry: Dict[str, Any],
        snap: Dict[str, Any],
        want: Tuple[bool, bool, bool],
        detail: str,
    ) -> None:
        """Capture the repro bundle and dump the black box."""
        ti.AUDIT_DIVERGED.inc()
        n_pods = len(snap["pods"])
        if n_pods <= BUNDLE_STATE_MAX_PODS:
            state: Dict[str, Any] = dg.canonical_state(
                snap["pods"], snap["namespaces"], snap["netpols"],
                snap["anps"], snap["banp"],
            )
        else:
            state = {
                "digest_only": True,
                "pods": n_pods,
                "namespaces": len(snap["namespaces"]),
                "netpols": len(snap["netpols"]),
            }
        summary = {
            "path": "audit.divergence",
            "epoch": entry["epoch"],
            "query": dict(entry["query"]),
            "served": list(entry["served"]),
            "oracle": [bool(want[0]), bool(want[1]), bool(want[2])],
            "route": entry["route"],
            "config": dict(snap["config"]),
            "detail": detail,
        }
        with self._lock:
            digest = self._digests.get(entry["epoch"])
            self._last_divergence = dict(summary)
        recorder.record(
            **summary,
            digest=digest,
            state=state,
        )
        recorder.dump(reason="audit-divergence")

    # --- reads ------------------------------------------------------------

    def flush(self, timeout: float = 5.0) -> bool:
        """Block until every queued check and pending digest is done (or
        the timeout passes) — the deterministic barrier tests and the
        drills use.  With a worker running this just waits; without one
        it drains on the calling thread."""
        if self._worker is None:
            self.drain()
            return True
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                idle = (
                    not self._queue
                    and not self._pending
                    and self._inflight == 0
                )
            if idle:
                return True
            self._wake.set()
            time.sleep(0.005)
        return False

    def digests(self) -> Dict[int, Dict[str, Any]]:
        with self._lock:
            return {e: dict(d) for e, d in sorted(self._digests.items())}

    def snapshot(self) -> Dict[str, Any]:
        """The /audit (and state().audit) payload."""
        with self._lock:
            depth = len(self._queue)
            pending = len(self._pending)
            sampled = self._sampled
            last = (
                dict(self._last_divergence)
                if self._last_divergence else None
            )
            digests = {
                str(e): d["digest"]
                for e, d in sorted(self._digests.items())
            }
            latest = (
                max(self._digests) if self._digests else None
            )
            latest_d = (
                dict(self._digests[latest]) if latest is not None else None
            )
        dropped = {
            r: ti.AUDIT_DROPPED.value(reason=r)
            for r in ("overflow", "epoch_evicted")
        }
        return {
            "enabled": True,
            "rate": self.rate,
            "queue_cap": self.queue_cap,
            "seed": self.seed,
            "sampled": sampled,
            "checked": ti.AUDIT_CHECKED.value(),
            "diverged": ti.AUDIT_DIVERGED.value(),
            "dropped": dropped,
            "queue_depth": depth,
            "pending_digests": pending,
            "digests": digests,
            "latest": latest_d,
            "last_divergence": last,
        }

    def close(self) -> None:
        self._stop.set()
        self._wake.set()
        if self._worker is not None:
            self._worker.join(timeout=2.0)
            self._worker = None
