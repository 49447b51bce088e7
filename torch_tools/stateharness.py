"""State-surface harness of the port: the dynamic proof behind
tools/statelint.py over cyclonus_tpu_torch/serve and /audit (a copy of
the reference package's tests/stateharness.py, its scenarios run on the
port's verdict service with its engine on --device).

The static pass proves the declared state registry
(cyclonus_tpu_torch/serve/stateregistry.py) agrees with the code: every
registered field is mutated only on the guarded commit path, rides the
rollback snapshot, the digest canonicalization, the ``note_epoch``
audit snapshot, the ``state()`` payload, and a wire Delta kind.  This
harness proves the declarations PREDICT live behavior: it arms the
registry call recorder (CYCLONUS_STATEHARNESS=1, read once at import —
the strip contract), drives every registered field's delta kinds
through a real VerdictService, and asserts

  * the epoch state digest CHANGES for every committed kind,
  * a forced mid-apply failure (chaos point ``delta_apply``) rolls the
    digest back to the pre-batch value through the registry-driven
    snapshot/restore pair,
  * the epoch advances exactly once per committed batch and not at all
    for rejected or dropped batches,
  * every declared kind round-trips the wire Delta envelope,

plus the planted "forgotten field" leg: a snapshot stripped of a
registered field makes ``restore`` raise KeyError, an ``audit_state``
dict stripped of one makes ``note_epoch`` raise TypeError, and a
canonicalization stripped of one digests a BANP change EQUAL.

    python torch_tools/stateharness.py [--device cpu] [--full] [--verbose]

The quick slice runs in tier-1 (tests/test_torch_lint.py, --device
cpu); --full adds the scaled parity sweep.  The last line of the output
is one JSON object (torch_tools/_harness.py).
"""

from __future__ import annotations

import sys
from typing import Callable, Dict, List, Optional, Tuple

import _harness

# the recorder is armed at stateregistry IMPORT (strip contract): set
# the flag before any cyclonus_tpu_torch import
_harness.arm(CYCLONUS_STATEHARNESS="1")


class HarnessFailure(AssertionError):
    """A live state surface diverged from the registry's declaration;
    the message names the scenario and the divergence."""


def _check(cond: bool, scenario: str, detail: str) -> None:
    if not cond:
        raise HarnessFailure(f"{scenario}: {detail}")


# --- delta payload factories ------------------------------------------------


def _np_dict(name: str, ns: str, app: str) -> Dict:
    """A minimal compilable NetworkPolicy payload."""
    return {
        "apiVersion": "networking.k8s.io/v1",
        "kind": "NetworkPolicy",
        "metadata": {"name": name, "namespace": ns},
        "spec": {
            "podSelector": {},
            "policyTypes": ["Ingress"],
            "ingress": [
                {"from": [{"podSelector": {"matchLabels": {"app": app}}}]}
            ],
        },
    }


def _anp_dict(name: str, priority: int) -> Dict:
    from cyclonus_tpu_torch.tiers.model import (
        AdminNetworkPolicy,
        TierRule,
        TierScope,
    )

    return AdminNetworkPolicy(
        name=name, priority=priority, subject=TierScope(),
        ingress=[TierRule(action="Allow", peers=[TierScope()])],
    ).to_dict()


def _banp_dict() -> Dict:
    from cyclonus_tpu_torch.tiers.model import (
        BaselineAdminNetworkPolicy,
        TierRule,
        TierScope,
    )

    return BaselineAdminNetworkPolicy(
        subject=TierScope(),
        ingress=[TierRule(action="Deny", peers=[TierScope()])],
    ).to_dict()


def _kind_delta(kind: str):
    """A representative, state-CHANGING Delta for each registered kind
    against the Ctx fixture (pods pod-0..N-1 in ns0/ns1; deltas are
    ordered so upserts precede their deletes)."""
    from cyclonus_tpu_torch.worker.model import Delta

    table = {
        "pod_add": Delta(
            kind="pod_add", namespace="ns0", name="harness-pod",
            labels={"app": "app1", "pod": "p99", "tier": "tier1"},
            ip="10.99.0.1",
        ),
        "pod_labels": Delta(
            kind="pod_labels", namespace="ns0", name="harness-pod",
            labels={"app": "app2", "pod": "p99", "tier": "tier2"},
        ),
        "pod_remove": Delta(
            kind="pod_remove", namespace="ns0", name="harness-pod",
        ),
        "ns_labels": Delta(
            kind="ns_labels", namespace="ns0",
            labels={"ns": "ns0", "team": "team9"},
        ),
        "policy_upsert": Delta(
            kind="policy_upsert", namespace="ns0", name="harness-np",
            policy=_np_dict("harness-np", "ns0", "app1"),
        ),
        "policy_delete": Delta(
            kind="policy_delete", namespace="ns0", name="harness-np",
        ),
        "anp_upsert": Delta(
            kind="anp_upsert", name="harness-anp",
            policy=_anp_dict("harness-anp", 10),
        ),
        "anp_delete": Delta(kind="anp_delete", name="harness-anp"),
        "banp_upsert": Delta(kind="banp_upsert", policy=_banp_dict()),
        "banp_delete": Delta(kind="banp_delete"),
    }
    return table[kind]


class Ctx:
    """Shared scenario context: a small live service (8 pods across 2
    namespaces — every registered field populated or populatable inside
    the tier-1 budget), its audit controller (synchronous drain — no
    worker thread), and the covered field/kind census."""

    def __init__(self, seed: int, device):
        self.seed = seed
        self.device = device
        self._svc = None
        self._aud = None
        self.covered_fields: set = set()
        self.covered_kinds: set = set()

    def service(self):
        if self._svc is None:
            from cyclonus_tpu_torch.audit import AuditController
            from cyclonus_tpu_torch.cli.serve_cmd import synthetic_cluster
            from cyclonus_tpu_torch.serve import VerdictService

            pods, namespaces = synthetic_cluster(8, 2, self.seed)
            self._aud = AuditController(
                rate=0.0, seed=7, digest_rows=4, start_worker=False
            )
            self._svc = VerdictService(
                pods, namespaces, [], audit=self._aud, device=self.device
            )
        return self._svc

    @property
    def audit(self):
        self.service()
        return self._aud

    def digest(self) -> str:
        """The state digest computed HERE, directly from the service's
        authoritative dicts — independent of the audit plane, so the
        rollback leg does not trust the surface under test."""
        from cyclonus_tpu_torch.audit import digest as dg

        svc = self.service()
        return dg.state_digest(dg.canonical_state(
            svc.pods, svc.namespaces, svc.netpols, svc.anps, svc.banp
        ))

    def drain_calls(self) -> List[str]:
        from cyclonus_tpu_torch.serve import stateregistry

        return stateregistry.drain()


# --- scenarios --------------------------------------------------------------


def scenario_field_kind_digests(ctx: Ctx) -> Dict:
    """Every registered field's every delta kind, committed through the
    live service: the state digest must CHANGE, the epoch must advance
    exactly once, the state() payload must reflect the field, and the
    commit must route through the registry's snapshot + audit_state
    helpers (the recorder proves the path is registry-driven, not a
    drifted hand-rolled copy)."""
    from cyclonus_tpu_torch.serve import stateregistry

    svc = ctx.service()
    batches = 0
    for f in stateregistry.FIELDS:
        for kind in f.kinds:
            pre_digest = ctx.digest()
            pre_epoch = svc.epoch
            ctx.drain_calls()
            report = svc.apply([_kind_delta(kind)])
            calls = ctx.drain_calls()
            _check(
                report["applied"] == 1 and not report["rejected"],
                f"digest.{kind}", f"delta rejected: {report}",
            )
            _check(
                ctx.digest() != pre_digest, f"digest.{kind}",
                f"state digest unchanged across a committed {kind} "
                f"(field {f.name!r} lost digest coverage)",
            )
            _check(
                svc.epoch == pre_epoch + 1, f"digest.{kind}",
                f"epoch {pre_epoch} -> {svc.epoch} (want exactly +1)",
            )
            _check(
                "snapshot" in calls and "audit_state" in calls,
                f"digest.{kind}",
                f"commit did not route through the registry helpers "
                f"(recorded {calls})",
            )
            st = svc.state()
            _check(
                f.state_key in st, f"digest.{kind}",
                f"state() payload lost registered key {f.state_key!r}",
            )
            ctx.covered_fields.add(f.name)
            ctx.covered_kinds.add(kind)
            batches += 1
    # the state() exposure is registry-driven end to end: counts match
    # the live dicts for every field
    st = svc.state()
    counts = stateregistry.state_counts(svc)
    for key, want in counts.items():
        _check(
            st[key] == want, "digest.state_counts",
            f"state()[{key!r}] = {st[key]!r} != registry count {want!r}",
        )
    return {"batches": batches}


def scenario_rollback_restores_digest(ctx: Ctx) -> Dict:
    """A fault injected mid-apply — after the authoritative dicts
    mutated, before the engine saw anything — must roll the DIGEST back
    to the pre-batch value via the registry snapshot/restore pair, leave
    the epoch untouched, and let the next clean batch commit."""
    from cyclonus_tpu_torch import chaos
    from cyclonus_tpu_torch.worker.model import Delta

    svc = ctx.service()
    delta = Delta(
        kind="ns_labels", namespace="ns1",
        labels={"ns": "ns1", "team": "chaos"},
    )
    pre_digest = ctx.digest()
    pre_epoch = svc.epoch
    ctx.drain_calls()
    tok = chaos.reset("delta_apply:1")
    try:
        raised = False
        try:
            svc.apply([delta])
        except chaos.ChaosError:
            raised = True
        _check(raised, "rollback", "injected delta_apply fault never fired")
        calls = ctx.drain_calls()
        _check(
            "snapshot" in calls and "restore" in calls, "rollback",
            f"dropped batch did not route through registry "
            f"snapshot/restore (recorded {calls})",
        )
        _check(
            ctx.digest() == pre_digest, "rollback",
            "state digest NOT rolled back to the pre-batch value",
        )
        _check(
            svc.epoch == pre_epoch, "rollback",
            f"epoch advanced through a dropped batch "
            f"({pre_epoch} -> {svc.epoch})",
        )
    finally:
        chaos.disarm(tok)
    report = svc.apply([delta])
    _check(
        report["epoch"] == pre_epoch + 1 and ctx.digest() != pre_digest,
        "rollback", f"post-fault apply did not commit cleanly: {report}",
    )
    return {"faults": 1}


def scenario_epoch_once_per_batch(ctx: Ctx) -> Dict:
    """One committed batch spanning several fields advances the epoch
    exactly once; an all-rejected batch advances it not at all."""
    svc = ctx.service()
    from cyclonus_tpu_torch.worker.model import Delta

    pre = svc.epoch
    report = svc.apply([
        _kind_delta("pod_add"),
        _kind_delta("ns_labels"),
        _kind_delta("policy_upsert"),
    ])
    _check(
        not report["rejected"] and svc.epoch == pre + 1, "epoch.batch",
        f"3-delta batch moved epoch {pre} -> {svc.epoch} "
        f"(rejected={report.get('rejected')}, want exactly +1)",
    )
    pre = svc.epoch
    report = svc.apply([Delta(kind="no_such_kind", namespace="ns0")])
    _check(
        len(report["rejected"]) == 1 and svc.epoch == pre, "epoch.rejected",
        f"rejected batch moved epoch {pre} -> {svc.epoch}: {report}",
    )
    # cleanup so later scenarios see the fixture baseline
    svc.apply([_kind_delta("policy_delete"), _kind_delta("pod_remove")])
    return {"batches": 3}


def scenario_wire_roundtrip(ctx: Ctx) -> Dict:
    """Every registry-declared kind is a wire Delta kind and survives
    to_dict -> from_dict intact, carrying its declared payload key —
    and the registry's kind set IS Delta.KINDS, both ways."""
    from cyclonus_tpu_torch.serve import stateregistry
    from cyclonus_tpu_torch.worker.model import Delta

    _check(
        set(stateregistry.delta_kinds()) == set(Delta.KINDS),
        "wire.census",
        f"registry kinds {sorted(stateregistry.delta_kinds())} != "
        f"wire Delta.KINDS {sorted(Delta.KINDS)}",
    )
    for spec in stateregistry.KINDS:
        d = _kind_delta(spec.kind)
        wire = d.to_dict()
        back = Delta.from_dict(wire)
        _check(
            back == d, f"wire.{spec.kind}",
            f"Delta round-trip mutated the payload: {d} -> {back}",
        )
        if spec.payload:
            _check(
                spec.payload in wire, f"wire.{spec.kind}",
                f"declared payload key {spec.payload!r} absent from the "
                f"wire dict {sorted(wire)}",
            )
        ctx.covered_kinds.add(spec.kind)
    return {"kinds": len(stateregistry.KINDS)}


def scenario_audit_digest_coverage(ctx: Ctx) -> Dict:
    """The audit ring's per-epoch digest must separate states differing
    ONLY in tier objects: an anp_upsert (and a banp_upsert) produces a
    digest unequal to the previous epoch's — the replica-comparison
    coverage the registry's digest_key column declares."""
    svc = ctx.service()
    aud = ctx.audit
    for kind, cleanup in (
        ("anp_upsert", "anp_delete"),
        ("banp_upsert", "banp_delete"),
    ):
        svc.apply([_kind_delta(kind)])
        aud.drain()
        digests = aud.digests()
        epoch = svc.epoch
        _check(
            epoch in digests and (epoch - 1) in digests,
            f"audit.{kind}", f"digest ring missing epochs "
            f"{epoch - 1}/{epoch}: have {sorted(digests)}",
        )
        _check(
            digests[epoch]["digest"] != digests[epoch - 1]["digest"],
            f"audit.{kind}",
            f"epoch digest EQUAL across a committed {kind}: two "
            f"replicas differing only in a tier object would compare "
            f"clean",
        )
        svc.apply([_kind_delta(cleanup)])
    return {"kinds": 2}


def scenario_forgotten_field(ctx: Ctx) -> Dict:
    """The planted forgotten-field fixture, live: each of statelint's
    ST002/ST003 failure modes is demonstrably REAL (the guarded
    surfaces fail loudly where the unguarded ones would silently lose
    coverage) and ST005's (an undeclared kind is rejected, never
    half-applied)."""
    from cyclonus_tpu_torch.audit import digest as dg
    from cyclonus_tpu_torch.serve import stateregistry
    from cyclonus_tpu_torch.worker.model import Delta

    svc = ctx.service()
    # ST002's runtime twin: a snapshot missing a registered field makes
    # restore raise KeyError instead of committing poison.  (Restoring
    # from a just-taken snapshot, so the partial writes are no-ops.)
    snap = stateregistry.snapshot(svc)
    forgotten = dict(snap)
    forgotten.pop("banp")
    raised = False
    try:
        stateregistry.restore(svc, forgotten)
    except KeyError:
        raised = True
    _check(
        raised, "forgotten.restore",
        "restore accepted a snapshot missing a registered field",
    )
    stateregistry.restore(svc, snap)
    # ST003's runtime twin #1: an audit_state dict missing a field makes
    # note_epoch raise TypeError (required keyword-only parameter).
    state = stateregistry.audit_state(svc)
    state.pop("banp")
    raised = False
    try:
        ctx.audit.note_epoch(
            svc.epoch, policy=None, tiers=None, **state
        )
    except TypeError:
        raised = True
    _check(
        raised, "forgotten.note_epoch",
        "note_epoch accepted a snapshot missing a registered field",
    )
    # ST003's runtime twin #2: a canonicalization that DROPS a field
    # digests a BANP change equal — the silent coverage loss itself.
    pre_full = ctx.digest()
    pre_canon = dg.canonical_state(
        svc.pods, svc.namespaces, svc.netpols, svc.anps, svc.banp
    )
    pre_canon.pop("banp")
    pre_partial = dg.state_digest(pre_canon)
    svc.apply([_kind_delta("banp_upsert")])
    post_canon = dg.canonical_state(
        svc.pods, svc.namespaces, svc.netpols, svc.anps, svc.banp
    )
    post_canon.pop("banp")
    _check(
        dg.state_digest(post_canon) == pre_partial, "forgotten.digest",
        "the partial-canonicalization control failed (states differ "
        "beyond the BANP)",
    )
    _check(
        ctx.digest() != pre_full, "forgotten.digest",
        "the full digest missed a BANP change",
    )
    svc.apply([_kind_delta("banp_delete")])
    # ST005's runtime twin: a kind with no declared lifecycle is
    # rejected by the validator's Delta.KINDS membership vet.
    report = svc.apply([Delta(kind="tenant_upsert", namespace="ns0")])
    _check(
        len(report["rejected"]) == 1, "forgotten.kind",
        f"undeclared kind was not rejected: {report}",
    )
    return {"legs": 4}


def scenario_scaled_parity(ctx: Ctx) -> Dict:
    """The slow leg (--full): a 48-pod service, every
    registered kind committed in sequence, incremental-vs-rebuild
    parity verified after each batch — the registry-driven commit path
    under realistic churn."""
    from cyclonus_tpu_torch.cli.serve_cmd import synthetic_cluster
    from cyclonus_tpu_torch.serve import VerdictService, stateregistry

    pods, namespaces = synthetic_cluster(48, 4, ctx.seed + 1)
    svc = VerdictService(pods, namespaces, [], device=ctx.device)
    for spec in stateregistry.KINDS:
        pre = svc.epoch
        report = svc.apply([_kind_delta(spec.kind)])
        _check(
            not report["rejected"] and svc.epoch == pre + 1,
            f"scaled.{spec.kind}", f"batch did not commit: {report}",
        )
        # raises AssertionError on any incremental-vs-rebuild mismatch
        parity = svc.verify_parity(oracle_samples=4)
        _check(
            parity["cells"] > 0, f"scaled.{spec.kind}",
            f"parity sweep checked nothing: {parity}",
        )
    return {"batches": len(stateregistry.KINDS)}


#: (name, fn, in_quick_slice)
SCENARIOS: List[Tuple[str, Callable[[Ctx], Dict], bool]] = [
    ("field_kind_digests", scenario_field_kind_digests, True),
    ("rollback_restores_digest", scenario_rollback_restores_digest, True),
    ("epoch_once_per_batch", scenario_epoch_once_per_batch, True),
    ("wire_roundtrip", scenario_wire_roundtrip, True),
    ("audit_digest_coverage", scenario_audit_digest_coverage, True),
    ("forgotten_field", scenario_forgotten_field, True),
    ("scaled_parity", scenario_scaled_parity, False),
]


def coverage_census(ctx: Ctx) -> Dict:
    """Every registered field and declared kind must have been driven
    through the live service."""
    from cyclonus_tpu_torch.serve import stateregistry

    missing_fields = sorted(
        f.name for f in stateregistry.FIELDS
        if f.name not in ctx.covered_fields
    )
    missing_kinds = sorted(
        k.kind for k in stateregistry.KINDS
        if k.kind not in ctx.covered_kinds
    )
    _check(
        not missing_fields and not missing_kinds, "coverage",
        f"registered surface never exercised: fields={missing_fields} "
        f"kinds={missing_kinds}",
    )
    return {
        "fields": len(ctx.covered_fields),
        "kinds": len(ctx.covered_kinds),
    }


def run(
    *,
    quick: bool = True,
    only: Optional[List[str]] = None,
    seed: int = 0,
    device="cpu",
    log: Optional[Callable[[str], None]] = None,
) -> Dict[str, Dict]:
    """Run the scenario set on services whose engines live on `device`;
    raises HarnessFailure on the first divergence.  Returns per-scenario
    stats."""
    ctx = Ctx(seed, device)
    results: Dict[str, Dict] = {}
    for name, fn, in_quick in SCENARIOS:
        if only is not None:
            if name not in only:
                continue
        elif quick and not in_quick:
            continue
        stats = fn(ctx)
        results[name] = stats
        if log is not None:
            log(f"stateharness {name}: OK {stats}")
    if only is None:
        results["coverage_census"] = coverage_census(ctx)
        if log is not None:
            log(
                f"stateharness coverage_census: OK "
                f"{results['coverage_census']}"
            )
    return results


def main(argv: Optional[List[str]] = None) -> int:
    ap = _harness.parser(__doc__)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument(
        "--scenarios", nargs="*", default=None,
        help=f"subset (choices: {[n for n, _f, _q in SCENARIOS]})",
    )
    args = ap.parse_args(argv)
    device = _harness.resolve_device(args.device)
    results = run(
        quick=not args.full,
        only=args.scenarios,
        seed=args.seed,
        device=device,
        log=print if args.verbose else None,
    )
    print(
        f"stateharness: {len(results)} scenario(s) passed "
        f"({', '.join(sorted(results))}) on {device}",
        file=sys.stderr,
    )
    _harness.report("state", device, results)
    return 0


if __name__ == "__main__":
    sys.exit(main())
