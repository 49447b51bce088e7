"""VerdictService: the long-running verdict engine behind
`cyclonus-tpu-torch serve` (the reference's serve/service.py on the
port's engine).

Holds the AUTHORITATIVE cluster state (pods / namespace labels /
NetworkPolicies / ANPs / the BANP as plain dicts), a delta queue, and an
IncrementalEngine derived from that state.  Deltas stream in
(worker/model.py Delta), queries answer from the live engine (FlowQuery
-> Verdict), and every apply either PATCHES the live engine's host
tensors and device views row/slab-wise (incremental.py) or — when churn
crosses the threshold, the patch bytes would pass the
CYCLONUS_SLAB_MAX_BYTES budget, or a delta is structurally ineligible —
REBUILDS the engine from the authoritative dicts.  Because the dicts are
the source of truth, the fallback is always available and always exact;
the differential gate (verify_parity) pins the incremental path to it.

The engine runs on the CUDA device unless `device` says otherwise; with
no card and no `device="cpu"` the constructor raises.

Threading model: one lock serializes every state access — submit()
enqueues, apply_pending() drains + patches the engine, query()
evaluates — so the engine is never patched under a reader.

Epoch/staleness semantics: `epoch` counts applied delta batches that
changed the engine; `staleness_s` is how long the OLDEST pending
(submitted, unapplied) delta has been waiting — 0 when the queue is
empty.  Every Verdict carries the epoch it was computed at.

The HTTP surface (register_http: /state, /query, /slo and /audit on the
process metrics server, /readyz through readiness()) and the
cyclonus_tpu_serve_* instruments are the reference's; state()'s
query-latency quantiles and degraded count read the process-wide
histogram and counter, as the reference's do.

The SLO controller (slo/), the audit plane (audit/) and the chaos point
`delta_apply` sit where the reference has them.  SLO enforcement
(CYCLONUS_SLO_ENFORCE) and auditing (CYCLONUS_AUDIT) are off by default:
the controller then admits every batch and routes every ready query
live, and the query path pays one `is None` check for the audit plane.
Lock order: service -> slo and service -> audit, never the reverse.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import TYPE_CHECKING, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import chaos
from ..carry import resolve_device
from ..engine.api import PortCase, TorchPolicyEngine
from ..engine.host import _parseable_ip, _slab_max_bytes
from ..kube.netpol import NAMESPACE_DEFAULT, NetworkPolicy
from ..kube.yaml_io import parse_policy_dict
from ..matcher.builder import build_network_policies
from ..oracle import traffic_for_cell
from ..matcher.tiered import TieredPolicy, tiered_oracle_verdicts
from ..slo.engine import SloController
from ..telemetry import instruments as ti
from ..telemetry.metrics import histogram_quantile
from ..tiers.model import AdminNetworkPolicy, BaselineAdminNetworkPolicy, TierSet
from ..utils import envflags, guards
from ..utils.tracing import phase
from ..worker.model import Delta, FlowQuery, Verdict
from . import stateregistry
from .incremental import IncrementalEngine, Ineligible, PodTuple

if TYPE_CHECKING:
    from ..audit import AuditController

logger = logging.getLogger("cyclonus.serve")

#: default delta-stream port cases for parity verification
VERIFY_CASES = (
    PortCase(80, "serve-80-tcp", "TCP"),
    PortCase(81, "serve-81-udp", "UDP"),
)


def _churn_row_limit() -> int:
    return envflags.get_int("CYCLONUS_SERVE_CHURN_ROWS")


def _churn_frac_limit() -> float:
    return envflags.get_float("CYCLONUS_SERVE_CHURN_FRAC")


class AdmissionRejected(Exception):
    """submit() refusal under freshness-budget admission control
    (CYCLONUS_SLO_ENFORCE): the delta batch was NOT enqueued; str(e) is
    the reason the SLO controller gave.  The wire loop reports it in the
    reply envelope."""


def register_http(service: "VerdictService") -> None:
    """Expose the service on the process metrics server
    (telemetry/server.py extension routes):

        /state                        epoch, pending-delta depth,
                                      staleness seconds, apply counters
        /query?src=x/a&dst=y/b&port=80&protocol=TCP[&portName=...]
                                      one curl-able flow verdict
                                      (429 when the query was shed)
        /slo                          per-objective budget remaining,
                                      burn rates, enforcement state
        /audit                        audit-plane snapshot: shadow-
                                      oracle check counts, queue
                                      accounting, epoch state digests

    /readyz reads service.readiness() once the caller registers it
    (cli/serve_cmd.py does)."""
    from ..telemetry import server as tserver

    def state_route(_query):
        return service.state(), 200

    def query_route(query):
        def one(key, default=""):
            vals = query.get(key) or [default]
            return vals[0]

        try:
            port = int(one("port", "0"))
        except ValueError:
            return {"error": "port must be an integer"}, 400
        src, dst = one("src"), one("dst")
        if not src or not dst:
            return {"error": "src and dst query params are required"}, 400
        fq = FlowQuery(
            src=src,
            dst=dst,
            port=port,
            protocol=one("protocol", "TCP"),
            port_name=one("portName"),
        )
        verdict = service.query([fq])[0]
        if verdict.shed:
            return verdict.to_dict(), 429  # typed refusal, not an answer
        return verdict.to_dict(), (400 if verdict.error else 200)

    tserver.register_route("/state", state_route)
    tserver.register_route("/query", query_route)
    tserver.register_slo(service.slo_snapshot)
    tserver.register_audit(service.audit_snapshot)


@guards.checked
class VerdictService:
    """See the module docstring.  All mutable state below is guarded by
    `_lock`; the guards.Guarded descriptors make the contract checkable
    (CYCLONUS_GUARD_CHECK=1 asserts at runtime)."""

    _queue = guards.Guarded("_lock")
    _epoch = guards.Guarded("_lock")
    _pending_since = guards.Guarded("_lock")
    _inc = guards.Guarded("_lock")
    _pod_idx = guards.Guarded("_lock")

    def __init__(
        self,
        pods: Sequence[PodTuple],
        namespaces: Dict[str, Dict[str, str]],
        policies: Sequence[NetworkPolicy],
        *,
        simplify: bool = True,
        class_compress: Optional[str] = None,
        tiers: Optional[TierSet] = None,
        defer_ready: bool = False,
        device=None,
        slo: Optional[SloController] = None,
        audit: Optional[AuditController] = None,
    ):
        self._lock = guards.lock()
        self._device = resolve_device(device)
        # created at construction so its clock anchors time-to-first-
        # verdict at boot; accounting rides the scrape-time collector
        self._slo = slo or SloController()
        # readiness: warming is not ready.  defer_ready=True starts the
        # service WARMING: queries answer from the scalar oracle over the
        # authoritative state until prewarm() or mark_ready() flips it
        self._ready = threading.Event()
        if not defer_ready:
            self._ready.set()
        self._simplify = simplify
        self._class_compress = class_compress
        # the dict fields journal their writes, so apply_pending's
        # rollback point costs what a batch writes (stateregistry)
        self.pods: Dict[str, PodTuple] = stateregistry.JournalDict(
            (f"{p[0]}/{p[1]}", (p[0], p[1], dict(p[2]), p[3])) for p in pods
        )
        self.namespaces: Dict[str, Dict[str, str]] = stateregistry.JournalDict(
            (k, dict(v)) for k, v in namespaces.items()
        )
        self.netpols: Dict[str, NetworkPolicy] = stateregistry.JournalDict(
            (f"{p.effective_namespace()}/{p.name}", p) for p in policies
        )
        # precedence-tier authoritative state: ANPs keyed by
        # cluster-scoped name, at most one BANP
        tiers = tiers or TierSet()
        tiers.validate()
        self.anps: Dict[str, AdminNetworkPolicy] = stateregistry.JournalDict(
            (a.name, a) for a in tiers.anps
        )
        self.banp: Optional[BaselineAdminNetworkPolicy] = tiers.banp
        self._queue: List[Delta] = []
        self._epoch = 0
        self._pending_since: Optional[float] = None
        self._counts = {"incremental": 0, "full": 0, "noop": 0, "class_rebuild": 0}
        self._last_full_rebuild_s: Optional[float] = None
        self._last_apply_s: Optional[float] = None
        self._patch_bytes = 0
        self._headroom_saves = 0
        self._policy = None
        self._inc: Optional[IncrementalEngine] = None
        self._pod_idx: Dict[str, int] = {}
        with self._lock:
            self._rebuild()
        # pull-style gauge refresh at scrape time: staleness/pending age
        # continuously between delta events.  WeakMethod-registered — a
        # garbage-collected service drops out of the scrape path on its own
        ti.REGISTRY.register_collector(self._refresh_gauges)
        # audit plane: disabled leaves _audit None and every query path
        # at one attribute check
        if audit is None and envflags.get_bool("CYCLONUS_AUDIT"):
            from ..audit import AuditController

            audit = AuditController()
        self._audit = audit
        if self._audit is not None:
            with self._lock:
                self._note_epoch_locked()

    # --- engine lifecycle -------------------------------------------------

    def _compiled_policy(self):
        return build_network_policies(self._simplify, list(self.netpols.values()))

    @guards.holds("self._lock")
    def _note_epoch_locked(self) -> None:
        """Hand the just-committed epoch's host state to the audit plane:
        the state registry's field snapshot (stateregistry.audit_state),
        the compiled policy and the tiers.  Shallow copies are stable
        snapshots because every apply replaces values wholesale.  Digest
        and shadow checks run on the audit worker, never here.

        holds-lock: self._lock"""
        self._audit.note_epoch(
            self._epoch,
            policy=self._policy,
            tiers=self._tier_set(),
            config={
                "simplify": self._simplify,
                "class_compress": self._class_compress,
                "anps": len(self.anps),
                "banp": self.banp is not None,
            },
            **stateregistry.audit_state(self),
        )

    def _tier_set(self) -> Optional[TierSet]:
        """The authoritative tier dicts as the TierSet the engine
        consumes — None when empty, so a tier-free service keeps the
        tier-free tensor set."""
        if not self.anps and self.banp is None:
            return None
        return TierSet(anps=list(self.anps.values()), banp=self.banp)

    @guards.holds("self._lock")
    def _rebuild(self) -> float:
        """Full rebuild from the authoritative dicts (the fallback every
        ineligible delta batch takes; also the initial build).

        holds-lock: self._lock"""
        t0 = time.perf_counter()
        self._policy = self._compiled_policy()
        self._inc = IncrementalEngine(
            self._policy,
            list(self.pods.values()),
            dict(self.namespaces),
            device=self._device,
            class_compress=self._class_compress,
            tiers=self._tier_set(),
        )
        self._pod_idx = self._inc.engine.pod_index()
        dt = time.perf_counter() - t0
        self._last_full_rebuild_s = dt
        return dt

    @property
    def engine(self) -> TorchPolicyEngine:
        """The live engine (test/bench convenience; take the service's
        word for when it changes)."""
        with self._lock:
            return self._inc.engine

    @property
    def epoch(self) -> int:
        """The applied-batch generation, cheaply (the wire loop stamps
        query-only replies with it)."""
        with self._lock:
            return self._epoch

    # --- delta intake -----------------------------------------------------

    def submit(self, deltas: Sequence[Delta]) -> int:
        """Enqueue deltas; returns the pending depth.  Cheap by design —
        the wire loop can acknowledge intake before paying the apply.

        Admission control (CYCLONUS_SLO_ENFORCE): while the freshness
        error budget is burning the pending queue is capped, and with the
        budget exhausted intake is rejected outright — AdmissionRejected,
        with nothing enqueued."""
        depth = 0
        with self._lock:
            reason = self._slo.admit(len(self._queue), len(deltas))
            if reason is None:
                if deltas and self._pending_since is None:
                    self._pending_since = time.monotonic()
                self._queue.extend(deltas)
                depth = len(self._queue)
        if reason is not None:
            ti.SLO_ADMISSION_REJECTS.inc()
            raise AdmissionRejected(reason)
        ti.SERVE_PENDING.set(depth)
        ti.SERVE_DELTAS.inc(len(deltas))
        return depth

    def apply(self, deltas: Sequence[Delta]) -> Dict:
        self.submit(deltas)
        return self.apply_pending()

    def _apply_to_state(self, d: Delta, pol=None) -> Optional[Tuple[str, str]]:
        """Fold one delta into the authoritative dicts; returns the
        engine-visible op it implies, or None for a no-op (unknown key,
        value already current).  `pol` is _validate_delta's parse of a
        policy_upsert / anp_upsert / banp_upsert payload, reused here."""
        key = f"{d.namespace}/{d.name}"
        if d.kind == "pod_add":
            pod = (d.namespace, d.name, dict(d.labels or {}), d.ip or "")
            if self.pods.get(key) == pod:
                return None
            existed = key in self.pods
            self.pods[key] = pod
            return ("pod_set" if existed else "pod_new", key)
        if d.kind == "pod_labels":
            cur = self.pods.get(key)
            if cur is None:
                return None
            pod = (cur[0], cur[1], dict(d.labels or {}), cur[3])
            if pod == cur:
                return None
            self.pods[key] = pod
            return ("pod_set", key)
        if d.kind == "pod_remove":
            if key not in self.pods:
                return None
            del self.pods[key]
            return ("pod_del", key)
        if d.kind == "ns_labels":
            labels = dict(d.labels or {})
            if self.namespaces.get(d.namespace) == labels:
                return None
            self.namespaces[d.namespace] = labels
            return ("ns", d.namespace)
        if d.kind == "policy_upsert":
            if pol is None:
                pol = parse_policy_dict(d.policy or {})
            if not pol.name:
                pol.name = d.name
            if not pol.namespace:
                pol.namespace = d.namespace
            pkey = f"{pol.effective_namespace()}/{pol.name}"
            if self.netpols.get(pkey) == pol:
                return None
            self.netpols[pkey] = pol
            return ("policy", pkey)
        if d.kind == "policy_delete":
            # the same key rule policy_upsert stores under: an empty
            # namespace means 'default'
            pkey = f"{d.namespace or NAMESPACE_DEFAULT}/{d.name}"
            if pkey not in self.netpols:
                return None
            del self.netpols[pkey]
            return ("policy", pkey)
        # precedence-tier objects (cluster-scoped: d.namespace unused)
        if d.kind == "anp_upsert":
            if pol is None:
                pol = AdminNetworkPolicy.from_dict(d.policy or {})
            if self.anps.get(pol.name) == pol:
                return None
            self.anps[pol.name] = pol
            return ("tier", pol.name)
        if d.kind == "anp_delete":
            if d.name not in self.anps:
                return None
            del self.anps[d.name]
            return ("tier", d.name)
        if d.kind == "banp_upsert":
            if pol is None:
                pol = BaselineAdminNetworkPolicy.from_dict(d.policy or {})
            if self.banp == pol:
                return None
            self.banp = pol
            return ("tier", "banp")
        if d.kind == "banp_delete":
            if self.banp is None:
                return None
            self.banp = None
            return ("tier", "banp")
        raise ValueError(f"unknown delta kind {d.kind!r}")

    def _validate_delta(self, d: Delta) -> Tuple[Optional[str], object]:
        """Reject a malformed delta BEFORE any state mutates.  Returns
        (rejection reason or None, the parsed policy for policy/anp/banp
        upserts), so each policy event parses once.  The solo compile
        runs under the live simplify setting; a policy that fails only in
        combination with the existing set is caught by apply_pending's
        rollback."""
        if d.kind not in Delta.KINDS:
            return f"unknown delta kind {d.kind!r}", None
        if d.kind == "policy_upsert":
            try:
                pol = parse_policy_dict(d.policy or {})
                # prove compilability, not just parseability
                build_network_policies(self._simplify, [pol])
            except Exception as e:
                return f"invalid Policy payload: {type(e).__name__}: {e}", None
            if not (pol.name or d.name):
                return "policy_upsert needs a name (payload or Name key)", None
            return None, pol
        if d.kind in ("anp_upsert", "banp_upsert"):
            cls = AdminNetworkPolicy if d.kind == "anp_upsert" else BaselineAdminNetworkPolicy
            payload = dict(d.policy or {})
            # from_dict ignores `kind`: a mis-routed object must be
            # rejected here, not installed as the other tier
            if payload.get("kind") != cls.__name__:
                return (
                    f"{d.kind} payload kind {payload.get('kind')!r} != {cls.__name__!r}",
                    None,
                )
            if d.kind == "anp_upsert" and d.name:
                # name-from-Delta, injected before the parse because
                # validate() requires a name
                md = dict(payload.get("metadata") or {})
                md.setdefault("name", d.name)
                payload["metadata"] = md
            try:
                pol = cls.from_dict(payload)
            except Exception as e:
                return f"invalid {cls.__name__} payload: {type(e).__name__}: {e}", None
            return None, pol
        if d.kind == "banp_delete":
            return None, None  # the singleton needs no Name
        if d.kind != "ns_labels" and not d.name:
            return f"{d.kind} needs a Name", None
        if d.kind == "pod_add" and not _parseable_ip(d.ip or ""):
            # an unparseable pod ip would make every later query raise
            # (malformed IPs raise by design): reject the one delta
            return f"pod_add needs a parseable Ip (got {d.ip!r})", None
        return None, None

    def apply_pending(self) -> Dict:
        """Drain the queue and bring the engine up to date.  Returns a
        report: {applied, mode, rejected, epoch, seconds}."""
        t0 = time.perf_counter()
        with self._lock:
            deltas, self._queue = self._queue, []
            self._pending_since = None
            ti.SERVE_PENDING.set(0)
            if not deltas:
                return {"applied": 0, "mode": None, "epoch": self._epoch, "seconds": 0.0}
            # validate the WHOLE batch before touching any state
            rejected = []
            valid = []
            with phase("serve.validate"):
                for d in deltas:
                    reason, pol = self._validate_delta(d)
                    if reason is None:
                        valid.append((d, pol))
                    else:
                        rejected.append(f"{d.kind}/{d.namespace}/{d.name}: {reason}")
            if rejected:
                ti.SERVE_REJECTED.inc(len(rejected))
            # rollback point: every _apply_to_state mutation REPLACES
            # values wholesale, so the old values the dict fields'
            # journals keep (or shallow copies) make the batch atomic
            with phase("serve.snapshot"):
                snap = stateregistry.snapshot(self)
            ops = []
            try:
                with phase("serve.state"):
                    for d, pol in valid:
                        op = self._apply_to_state(d, pol)
                        if op is not None:
                            ops.append(op)
                # chaos point `delta_apply`: after the authoritative dicts
                # mutated, before the engine saw anything — it rides the
                # rollback below like a real mid-apply failure
                chaos.fire("delta_apply")
                if not ops:
                    self._counts["noop"] += 1
                    ti.SERVE_APPLIES.inc(mode="noop")
                    return {
                        "applied": len(valid), "mode": "noop",
                        "rejected": rejected, "epoch": self._epoch,
                        "seconds": round(time.perf_counter() - t0, 6),
                    }
                # the delta-application span: the nested engine spans
                # (the full rebuild's encode) land under it
                with phase("serve.apply"):
                    mode = self._apply_ops(ops)
            except Exception:
                # an unexpected raise must not leave the engine diverged
                # from the dicts or poison them: roll the batch back,
                # rebuild the engine to match, then surface the error
                stateregistry.restore(self, snap)
                try:
                    self._rebuild()
                except Exception:
                    logger.exception(
                        "rebuild after rolled-back apply failed; engine may "
                        "be stale until the next apply"
                    )
                ti.SERVE_FALLBACKS.inc(reason="apply_error")
                raise
            self._epoch += 1
            self._counts[mode] += 1
            ti.SERVE_APPLIES.inc(mode=mode)
            ti.SERVE_EPOCH.set(self._epoch)
            if self._audit is not None:
                self._note_epoch_locked()
            dt = time.perf_counter() - t0
            self._last_apply_s = dt
            ti.SERVE_APPLY_SECONDS.observe(dt, mode=mode)
            return {
                "applied": len(valid), "mode": mode,
                "rejected": rejected, "epoch": self._epoch,
                "seconds": round(dt, 6),
            }

    @guards.holds("self._lock")
    def _apply_ops(self, ops: List[Tuple[str, str]]) -> str:
        """Apply engine-visible ops incrementally, falling back to a full
        rebuild on any ineligibility.  The state dicts are already
        updated (so the fallback sees the new world).  Returns the mode
        taken.

        holds-lock: self._lock"""
        try:
            return self._apply_ops_incremental(ops)
        except Ineligible as e:
            ti.SERVE_FALLBACKS.inc(reason="ineligible")
            logger.info("incremental apply ineligible (%s): full rebuild", e)
            self._rebuild()
            return "full"

    @guards.holds("self._lock")
    def _apply_ops_incremental(self, ops: List[Tuple[str, str]]) -> str:
        """holds-lock: self._lock"""
        inc = self._inc
        eng = inc.engine
        inc.check_patchable()
        pod_ops = [o for o in ops if o[0] in ("pod_set", "pod_new", "pod_del")]
        ns_ops = [o for o in ops if o[0] == "ns"]
        policy_changed = any(o[0] == "policy" for o in ops)
        tier_changed = any(o[0] == "tier" for o in ops)
        n = eng.n_pods
        touched = len(pod_ops) + len(ns_ops)
        limit = max(_churn_row_limit(), int(_churn_frac_limit() * max(n, 1)))
        if touched > limit:
            raise Ineligible(f"churn threshold: {touched} touched rows > limit {limit}")
        with phase("serve.encode"):
            patch = inc.main_patchset()
            class_patch = inc.class_patchset()
            structure_change = False
            touched_rows: List[int] = []
            for kind, key in pod_ops:
                if kind == "pod_del":
                    idx = self._pod_idx.pop(key, None)
                    if idx is None:
                        continue  # added AND deleted within this batch
                    inc.remove_pod(idx, patch)
                    structure_change = True
                    # swap-remove moved the old last row into the hole
                    keys = eng.encoding.cluster.pod_keys
                    if idx < len(keys):
                        self._pod_idx[keys[idx]] = idx
                else:
                    pod = self.pods.get(key)
                    if pod is None:
                        continue  # deleted later within this batch
                    idx = self._pod_idx.get(key)
                    if idx is None:
                        idx = inc.add_pod(pod, patch)
                        self._pod_idx[key] = idx
                        structure_change = True
                    else:
                        inc.update_pod(idx, pod, patch)
                        touched_rows.append(idx)
            for _kind, ns in ns_ops:
                inc.set_namespace_labels(ns, dict(self.namespaces.get(ns, {})), patch, class_patch)
            if patch.staged_bytes > _slab_max_bytes():
                raise Ineligible(
                    f"patch bytes {patch.staged_bytes} exceed the CYCLONUS_SLAB_MAX_BYTES budget"
                )
        bytes0, saves0 = inc.patch_bytes, inc.headroom_saves
        with phase("serve.patch"):
            inc.flush(patch)
            inc.flush(class_patch)
        mode = "incremental"
        if policy_changed or tier_changed:
            # tier slabs patch like rule slabs: patch_policy re-encodes
            # the NetworkPolicy directions, the shared selector table and
            # the tier slabs together, and raises Ineligible when any
            # slab outgrows its allocation (tier slabs appearing on a
            # tier-less engine or vanishing included)
            with phase("serve.policy"):
                if policy_changed:
                    self._policy = self._compiled_policy()
                inc.patch_policy(self._policy, tiers=self._tier_set())
            if eng._class_state is not None:
                mode = "class_rebuild"
        elif eng._class_state is not None:
            with phase("serve.classes"):
                if structure_change:
                    inc.resize_signatures()
                    mode = "class_rebuild"
                else:
                    for i in touched_rows:
                        if inc.update_pod_signature(i) == "rebuild":
                            mode = "class_rebuild"
                            break
        with phase("serve.finish"):
            inc.finish()
        self._patch_bytes += inc.patch_bytes - bytes0
        self._headroom_saves += inc.headroom_saves - saves0
        return mode

    # --- readiness / prewarm ----------------------------------------------

    @property
    def ready(self) -> bool:
        """False while the service is still warming (queries then answer
        from the scalar oracle)."""
        return self._ready.is_set()

    def mark_ready(self) -> None:
        self._ready.set()

    def readiness(self) -> Tuple[bool, str]:
        """The (ready, detail) pair telemetry/server.py's /readyz route
        consumes."""
        if self._ready.is_set():
            return True, f"serving at epoch {self.epoch}"
        return False, "prewarming the query path (queries degrade to the scalar oracle)"

    def prewarm(self, case: PortCase = VERIFY_CASES[0]) -> Dict:
        """Warm the query path BEFORE the service marks itself ready: one
        evaluate_pairs call, which uploads the device views (eager torch
        compiles nothing per shape, so no batch size needs warming).
        Marks the service ready when done, also when the call raises (the
        error then propagates).  Runs the evaluation outside the lock:
        the delta stream starts only after prewarm returns."""
        t0 = time.perf_counter()
        with self._lock:
            eng = self._inc.engine
        n = eng.n_pods
        calls = 0
        try:
            if n > 0:
                eng.evaluate_pairs([case], [(0, 0)])
                calls = 1
        finally:
            self.mark_ready()
        return {"seconds": round(time.perf_counter() - t0, 3), "calls": calls, "pods": n}

    # --- queries ----------------------------------------------------------

    def query(self, queries: Sequence[FlowQuery]) -> List[Verdict]:
        """Answer a batch of flow queries from the live engine: one
        evaluate_pairs call per distinct port case.  While the service is
        still WARMING (defer_ready and prewarm in flight), queries answer
        from the scalar oracle over the authoritative state instead —
        exact verdicts at host speed, counted as degraded.

        SLO enforcement (CYCLONUS_SLO_ENFORCE) routes ahead of the
        warming check: query_p99 budget EXHAUSTED sheds the batch with
        typed refusals (shed=True plus an error, never a wrong verdict);
        BURNING routes onto the degraded path.  Each route is recorded
        (engine/planspec.py) where the reference records it."""
        from ..engine import planspec

        route = self._slo.query_route()
        if route == "shed":
            planspec.record("serve.query.shed")
            return self._query_shed(queries)
        if not self._ready.is_set() or route == "degraded":
            planspec.record("serve.query.degraded")
            out = self._query_degraded(queries)
            self._slo.note_first_verdict()
            if self._audit is not None:
                self._offer_audit(out, "serve.query.degraded")
            return out
        planspec.record("serve.query.live")
        t0 = time.perf_counter()
        with self._lock:
            # host-side span only (serve.query): no device sync inside
            with phase("serve.query"):
                out = self._query_locked(queries)
        per = (time.perf_counter() - t0) / max(len(queries), 1)
        for v in out:
            if v is not None and not v.error:
                v.latency_ms = round(per * 1000.0, 4)
        self._observe(per, len(queries))
        self._slo.note_first_verdict()
        if self._audit is not None:
            self._offer_audit(out, "serve.query.live")
        return [v for v in out if v is not None]

    def _offer_audit(self, verdicts: Sequence[Optional[Verdict]], route: str) -> None:
        """Feed answered (non-error, non-shed) verdicts to the audit
        sampler, with the service lock RELEASED.  The per-verdict cost is
        one seeded Bernoulli draw; the offer entry is built only for the
        sampled minority, and everything else happens on the audit
        worker."""
        aud = self._audit
        for v in verdicts:
            if v is None or v.error or v.shed:
                continue
            if not aud.sample():
                continue
            q = v.query
            aud.offer(
                {"src": q.src, "dst": q.dst, "port": q.port, "port_name": q.port_name,
                 "protocol": q.protocol},
                (v.ingress, v.egress, v.combined),
                route,
                v.epoch,
                presampled=True,
            )

    @staticmethod
    def _observe(per_query_s: float, n: int) -> None:
        """Batch-amortized per-query latency, observed once per query:
        what a caller of this batch size experienced per flow."""
        for _ in range(n):
            ti.SERVE_QUERY_LATENCY.observe(per_query_s)
        ti.SERVE_QUERIES.inc(n)

    @guards.holds("self._lock")
    def _query_locked(self, queries: Sequence[FlowQuery]) -> List[Optional[Verdict]]:
        """holds-lock: self._lock"""
        eng = self._inc.engine
        epoch = self._epoch
        out: List[Optional[Verdict]] = [None] * len(queries)
        groups: Dict[Tuple[int, str, str], List[Tuple[int, int, int]]] = {}
        for pos, q in enumerate(queries):
            si = self._pod_idx.get(q.src)
            di = self._pod_idx.get(q.dst)
            if si is None or di is None:
                missing = q.src if si is None else q.dst
                out[pos] = Verdict(query=q, epoch=epoch, error=f"unknown pod key {missing!r}")
                continue
            groups.setdefault((q.port, q.port_name, q.protocol), []).append((pos, si, di))
        for (port, name, proto), items in groups.items():
            case = PortCase(port, name, proto)
            res = eng.evaluate_pairs([case], [(si, di) for _pos, si, di in items])  # [K, 1, 3]
            for (pos, _si, _di), row in zip(items, res[:, 0]):
                out[pos] = Verdict(
                    query=queries[pos],
                    ingress=bool(row[0]),
                    egress=bool(row[1]),
                    combined=bool(row[2]),
                    epoch=epoch,
                )
        return out

    def _query_degraded(self, queries: Sequence[FlowQuery]) -> List[Verdict]:
        """Warmup-window query path: every verdict from the scalar oracle
        straight from the authoritative dicts (the state the engine
        itself is built from, so answers are exact)."""
        t0 = time.perf_counter()
        with self._lock:
            pods_list = list(self.pods.values())
            namespaces = dict(self.namespaces)
            policy = self._policy
            tiers = self._tier_set()
            epoch = self._epoch
        idx = {f"{p[0]}/{p[1]}": i for i, p in enumerate(pods_list)}
        oracle = TieredPolicy(policy, tiers) if tiers else None
        out: List[Verdict] = []
        for q in queries:
            si, di = idx.get(q.src), idx.get(q.dst)
            if si is None or di is None:
                missing = q.src if si is None else q.dst
                out.append(Verdict(query=q, epoch=epoch, error=f"unknown pod key {missing!r}"))
                continue
            t = traffic_for_cell(
                pods_list, namespaces, PortCase(q.port, q.port_name, q.protocol), si, di
            )
            want = (
                oracle.is_traffic_allowed(t)
                if oracle is not None
                else tiered_oracle_verdicts(policy, None, t)
            )
            out.append(Verdict(
                query=q, ingress=bool(want[0]), egress=bool(want[1]),
                combined=bool(want[2]), epoch=epoch,
            ))
        per = (time.perf_counter() - t0) / max(len(queries), 1)
        for v in out:
            if not v.error:
                v.latency_ms = round(per * 1000.0, 4)
        self._observe(per, len(queries))
        ti.SERVE_DEGRADED.inc(len(queries))
        return out

    def _query_shed(self, queries: Sequence[FlowQuery]) -> List[Verdict]:
        """Load-shed refusal: every query of the batch gets a typed Shed
        verdict — shed=True AND an error, so a caller that ignores the
        field still sees a non-answer.  No engine work, no latency
        observation."""
        epoch = self.epoch
        out = [
            Verdict(
                query=q,
                epoch=epoch,
                shed=True,
                error=(
                    "shed: query_p99 error budget exhausted; retry "
                    "after the budget recovers (/slo)"
                ),
            )
            for q in queries
        ]
        ti.SLO_SHED.inc(len(queries))
        return out

    # --- observability ----------------------------------------------------

    def _refresh_gauges(self) -> None:
        """Scrape-time collector (MetricRegistry.register_collector):
        recompute the event-independent gauges so a scrape between delta
        events sees the oldest pending delta's CURRENT age.  Try-locks
        with a short timeout: an apply can hold the lock for a full
        rebuild, and a scrape landing then must keep /metrics responsive
        — it skips the refresh (counted in
        cyclonus_tpu_serve_gauge_refresh_skipped_total).

        Doubles as the SLO accounting cadence: every scrape advances the
        burn-rate accountants (slo.tick after the service lock is
        released).  A contended skip still ticks latency accounting; only
        the freshness sample is missing that tick."""
        if not self._lock.acquire(timeout=0.2):
            ti.SERVE_GAUGE_REFRESH_SKIPPED.inc()
            self._slo.tick()
            return
        try:
            pending = len(self._queue)
            staleness = (
                time.monotonic() - self._pending_since
                if self._pending_since is not None
                else 0.0
            )
            epoch = self._epoch
        finally:
            self._lock.release()
        ti.SERVE_PENDING.set(pending)
        ti.SERVE_STALENESS.set(staleness)
        ti.SERVE_EPOCH.set(epoch)
        self._slo.tick(staleness_s=staleness)

    def state(self) -> Dict:
        """The /state payload: epoch, pending-delta depth, staleness
        seconds, the state registry's counts, apply counters, engine
        shape, the query-latency quantiles of
        cyclonus_tpu_serve_query_latency_seconds, and the slo and audit
        blocks (the reference's payload)."""
        with self._lock:
            eng = self._inc.engine
            pending = len(self._queue)
            staleness = (
                time.monotonic() - self._pending_since
                if self._pending_since is not None
                else 0.0
            )
            ti.SERVE_STALENESS.set(staleness)
            hist = ti.SERVE_QUERY_LATENCY.snapshot()
            cc = eng.class_compression_stats()
            return {
                "epoch": self._epoch,
                "ready": self._ready.is_set(),
                "degraded_queries": int(ti.SERVE_DEGRADED.value()),
                "pending_deltas": pending,
                "staleness_s": round(staleness, 3),
                **stateregistry.state_counts(self),
                "applies": dict(self._counts),
                "last_apply_s": self._last_apply_s,
                "last_full_rebuild_s": self._last_full_rebuild_s,
                "class_compression": {
                    "active": cc["active"],
                    "classes": cc["classes"],
                    "ratio": cc["ratio"],
                },
                "tiers": eng.tier_stats(),
                "query_latency": {
                    "count": sum(s.get("count", 0) for s in hist.get("samples") or []),
                    "p50_s": histogram_quantile(hist, 0.50),
                    "p99_s": histogram_quantile(hist, 0.99),
                },
                "slo": {
                    "enforce": self._slo.enforce,
                    "objectives": {
                        name: {"state": o["state"], "budget_remaining": o["budget_remaining"]}
                        for name, o in self._slo.snapshot()["objectives"].items()
                    },
                },
                "audit": self.audit_snapshot(),
            }

    @property
    def slo(self) -> SloController:
        """The service's SLO controller (tests, drills, harnesses)."""
        return self._slo

    def slo_snapshot(self) -> Dict:
        """The /slo payload (telemetry/server.py register_slo)."""
        return self._slo.snapshot()

    @property
    def audit(self):
        """The service's AuditController, or None when auditing is off."""
        return self._audit

    def audit_snapshot(self) -> Dict:
        """The /audit payload (telemetry/server.py register_audit)."""
        aud = self._audit
        if aud is None:
            return {"enabled": False}
        return aud.snapshot()

    def patch_stats(self) -> Dict[str, int]:
        """Bytes of row values the incremental applies wrote to the
        device views, and the policy patches the slab headroom kept off
        the full rebuild, over the service's life."""
        with self._lock:
            return {"patch_bytes": self._patch_bytes, "headroom_saves": self._headroom_saves}

    # --- the differential correctness gate --------------------------------

    def verify_parity(
        self,
        cases: Sequence[PortCase] = VERIFY_CASES,
        rng=None,
        oracle_samples: int = 32,
    ) -> Dict:
        """After any delta sequence, the incrementally-updated engine
        must produce truth tables IDENTICAL to an engine freshly built
        from the post-delta cluster state (rows aligned by pod key —
        incremental row order drifts under swap-removes), with the scalar
        oracle spot-checking both.  Raises AssertionError on any
        mismatch; returns check stats."""
        import random as _random

        rng = rng or _random.Random(0)
        with self._lock:
            eng = self._inc.engine
            pods_list = list(self.pods.values())
            namespaces = dict(self.namespaces)
            policy = self._policy
            tiers = self._tier_set()
            _tiered = TieredPolicy(policy, tiers) if tiers else None
            fresh = TorchPolicyEngine(
                policy,
                pods_list,
                namespaces,
                device=self._device,
                compact=False,
                class_compress=self._class_compress,
                tiers=tiers,
            )
            n = len(pods_list)
            if n == 0:
                return {"pods": 0, "cells": 0, "oracle_checked": 0}
            perm = np.array([self._pod_idx[k] for k in fresh.pod_keys], dtype=np.int64)
            g_inc = eng.evaluate_grid(list(cases))
            g_fresh = fresh.evaluate_grid(list(cases))
            for name in ("ingress", "egress", "combined"):
                a = np.asarray(getattr(g_inc, name))
                b = np.asarray(getattr(g_fresh, name))
                a_aligned = a[:, perm][:, :, perm]
                if not np.array_equal(a_aligned, b):
                    bad = np.argwhere(a_aligned != b)
                    qi, ai, bi = (int(x) for x in bad[0])
                    # ingress grids are [Q, dst, src]; egress/combined
                    # are [Q, src, dst]
                    si, di = (bi, ai) if name == "ingress" else (ai, bi)
                    raise AssertionError(
                        f"DIFFERENTIAL GATE: {name} grid diverges at "
                        f"case={cases[qi]} src={fresh.pod_keys[si]} "
                        f"dst={fresh.pod_keys[di]}: incremental="
                        f"{bool(a_aligned[qi, ai, bi])} fresh="
                        f"{bool(b[qi, ai, bi])} ({bad.shape[0]} cells)"
                    )
            checked = 0
            for _ in range(oracle_samples):
                qi = rng.randrange(len(cases))
                si = rng.randrange(n)
                di = rng.randrange(n)
                t = traffic_for_cell(pods_list, namespaces, cases[qi], si, di)
                want = (
                    _tiered.is_traffic_allowed(t)
                    if _tiered is not None
                    else tiered_oracle_verdicts(policy, None, t)
                )
                got = g_fresh.job_verdict(qi, si, di)
                if got != want:
                    raise AssertionError(
                        f"DIFFERENTIAL GATE: oracle mismatch at "
                        f"case={cases[qi]} src={fresh.pod_keys[si]} "
                        f"dst={fresh.pod_keys[di]}: oracle={want} "
                        f"engine={got}"
                    )
                checked += 1
            return {"pods": n, "cells": len(cases) * n * n, "oracle_checked": checked}
