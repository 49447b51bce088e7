"""Shadowing / redundancy audit of a COMPILED policy set on the dense
tensor encoding (a copy of the reference package's analysis/audit.py on
the port's engine: the firing masks come from the device, the per-cell
counts stay exact int32 numpy matmuls on the host).

Every resolved rule (one peer matcher of one target, per direction) has
a FIRING MASK over the pod x pod x port-case grid — the cells where the
rule itself matches both endpoints and the port:

    fire[p, n, m, q] = rule_tmatch[p, n] & peer_match[p, m] & pport[p, q]

(engine.kernel.rule_firing_kernel computes the three rank-1 factors on
the engine's device, so the [P, N, N, Q] tensor never materializes).  On top of the masks:

  * a rule that fires NOWHERE on the grid is dead ("never-fires");
  * a rule whose every firing cell is also fired by some other rule is
    SHADOWED: removing it leaves the verdict tensor bit-identical,
    because a direction verdict is `~has_target | OR_p fire[p]` and a
    rule's firing cells always lie inside its own target's has_target
    rows.  Equivalently: the rule is shadowed iff no cell exists where
    it is the UNIQUE firing rule — which reduces to boolean matmuls over
    the per-cell firing-rule COUNT, no per-rule grid subtraction needed.

Both claims are relative to the given cluster and port cases (exactly
like the verdict grid itself), and every finding is cross-checked
against the scalar matcher oracle on a sampled subset (analysis.oracle)
before it is reported — a refuted claim raises instead of printing.

Tier composition note: firing masks
are a NetworkPolicy-TIER concept — a "rule" here is one peer matcher of
one networkingv1 target, and the bool-OR identity above is the NP
tier's internal semantics, NOT the cross-tier verdict (which is
first-match-by-priority, engine/kernel.py resolve_tier_lattice).  The
audit stays sound unchanged when AdminNetworkPolicy/BANP tiers are
layered on top, because the lattice reads the NP tier ONLY through
`has_target` and the per-cell any-allow OR: removing a never-firing or
shadowed NP rule changes neither (a peer-row removal cannot flip
has_target, and a shadowed rule's firing cells are covered in the OR),
so the full lattice verdict is bit-identical too.  Consequently the
oracle cross-check below runs the PLAIN networkingv1 oracle on purpose:
it verifies the NP-tier claim directly, which is the stronger, tier-
independent statement.  ANP/BANP rules themselves are NOT audited here
— their semantics are first-match, where "shadowed" means something
different (a lower-priority rule behind a total higher-priority match),
a separate analysis.  engine.firing_components likewise excludes the
tier slabs from its shared tensors (engine/api.py).
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..engine.api import PortCase, TorchPolicyEngine
from ..matcher.core import Policy, Target
from ..utils.table import render_table
from .cluster import derive_port_cases
from .oracle import (
    Cell,
    PodTuple,
    check_rule_removal,
    policy_without_rule,
    sample_cells,
)

# count[N, N*Q] int32 is the audit's big intermediate; past this many
# grid cells the audit refuses instead of thrashing host memory (audit
# targets representative clusters, not the 100k-pod bench)
MAX_AUDIT_CELLS = 1 << 26


@dataclass(frozen=True)
class RuleRef:
    """One resolved rule: peer `peer_idx` of target `target_idx` in the
    sorted_targets() order of `direction`."""

    direction: str
    target_idx: int
    peer_idx: int
    target_namespace: str
    policies: Tuple[str, ...]  # source policy names ("ns/name")
    peer: str  # brief peer description

    @property
    def label(self) -> str:
        src = ",".join(self.policies) or "<no source policy>"
        return (
            f"{self.direction} target {self.target_idx} "
            f"(ns={self.target_namespace}) rule {self.peer_idx}: "
            f"{self.peer} [{src}]"
        )


@dataclass
class AuditFinding:
    kind: str  # "shadowed" | "never-fires"
    rule: RuleRef
    covered_by: List[RuleRef] = field(default_factory=list)
    fire_cells: int = 0  # grid cells the rule fires on
    oracle: Optional[str] = None  # "confirmed" once cross-checked


@dataclass
class AuditReport:
    findings: List[AuditFinding]
    n_rules: Dict[str, int]  # per direction
    n_pods: int
    cases: List[PortCase]
    oracle_checked: int = 0
    #: host-clock seconds of the audit's stages: "firing" (the firing
    #: components on the engine's device, read back), "matmul" (the
    #: host's int32 count products and the findings' source
    #: attribution), "oracle" (the scalar cross-checks)
    seconds: Dict[str, float] = field(default_factory=dict)

    @property
    def cells(self) -> int:
        return len(self.cases) * self.n_pods * self.n_pods

    def table(self) -> str:
        rows = []
        for f in self.findings:
            rows.append(
                [
                    f.rule.direction,
                    f"t{f.rule.target_idx}.r{f.rule.peer_idx} "
                    f"ns={f.rule.target_namespace}\n{f.rule.peer}",
                    "\n".join(f.rule.policies) or "-",
                    f.kind,
                    str(f.fire_cells),
                    "\n".join(
                        f"t{c.target_idx}.r{c.peer_idx} {c.peer}"
                        for c in f.covered_by[:4]
                    )
                    + ("\n..." if len(f.covered_by) > 4 else ""),
                    f.oracle or "-",
                ]
            )
        return render_table(
            [
                "Direction",
                "Rule",
                "Source Policies",
                "Finding",
                "Fire Cells",
                "Covered By",
                "Oracle",
            ],
            rows,
            row_line=True,
        )


def _peer_brief(peer) -> str:
    """One-line peer description for reports."""
    d = peer.to_dict()
    t = d.get("Type", type(peer).__name__)
    if t == "IPBlock":
        ex = f" except {list(d.get('Except') or [])}" if d.get("Except") else ""
        return f"ip {d['CIDR']}{ex}"
    if t == "pod peer":
        return (
            f"pods ns={_matcher_brief(d['Namespace'])} "
            f"pod={_matcher_brief(d['Pod'])} port={_matcher_brief(d['Port'])}"
        )
    if t == "all peers for port":
        return f"all peers, port={_matcher_brief(d['Port'])}"
    return t


def _matcher_brief(d: dict) -> str:
    t = d.get("Type", "?")
    if "Selector" in d:
        sel = d["Selector"]
        return str(sel.get("matchLabels", sel)) if sel else "{}"
    if "Namespace" in d:
        return d["Namespace"]
    if t == "specific ports":
        parts = [
            f"{p.get('Port')}/{p.get('Protocol')}" for p in d.get("Ports", [])
        ] + [
            f"[{r['From']}-{r['To']}]/{r['Protocol']}"
            for r in d.get("PortRanges", [])
        ]
        return ",".join(parts) or "none"
    return t


def _peer_sources(direction: str, target: Target, peer) -> Tuple[str, ...]:
    """The source POLICIES responsible for this specific peer rule.

    Targets with the same primary key are combined at build time (peers
    and source_rules both concatenate), so the Target alone only knows
    the union of sources.  Re-building each source policy individually
    and matching the peer by its serialized form recovers the exact
    contributor(s); when nothing matches (e.g. the audited set was
    built simplified, rewriting the peers), fall back to the target's
    full source list rather than mis-attributing."""
    import json

    from ..matcher.builder import build_network_policies

    key = json.dumps(peer.to_dict(), sort_keys=True, default=str)
    srcs: List[str] = []
    for pol in target.source_rules:
        try:
            sub = build_network_policies(False, [pol])
        except Exception:
            continue
        d = sub.ingress if direction == "ingress" else sub.egress
        for t in d.values():
            if t.get_primary_key() != target.get_primary_key():
                continue
            if any(
                json.dumps(p.to_dict(), sort_keys=True, default=str) == key
                for p in t.peers
            ):
                srcs.append(f"{pol.effective_namespace()}/{pol.name}")
                break
    return tuple(dict.fromkeys(srcs)) or tuple(target.source_rule_names())


def _rule_refs(
    direction: str, targets: List[Target], enc
) -> List[RuleRef]:
    """RuleRef per flat peer row, via the encoding's provenance arrays
    (peer_target / peer_rule_idx map row -> (target, peer) exactly).
    Source-policy attribution is left EMPTY here — _peer_sources
    rebuilds policies per peer, so it runs only for rules that actually
    appear in findings (audit_policy_set attributes them lazily)."""
    refs = []
    for t_idx, p_idx in zip(enc.peer_target, enc.peer_rule_idx):
        target = targets[int(t_idx)]
        peer = target.peers[int(p_idx)]
        refs.append(
            RuleRef(
                direction=direction,
                target_idx=int(t_idx),
                peer_idx=int(p_idx),
                target_namespace=target.namespace,
                policies=(),
                peer=_peer_brief(peer),
            )
        )
    return refs


def _fire_cell_samples(
    direction: str,
    a_p: np.ndarray,  # [N] target-side pods the rule's target matches
    b_p: np.ndarray,  # [N] peer-side pods the rule matches
    c_p: np.ndarray,  # [Q] cases the rule's port spec allows
    k: int,
    rng: random.Random,
) -> List[Cell]:
    """Up to k (case, src, dst) cells where the rule fires.  For ingress
    the target side is the DESTINATION; for egress the SOURCE."""
    ns = np.flatnonzero(a_p)
    ms = np.flatnonzero(b_p)
    qs = np.flatnonzero(c_p)
    if not (ns.size and ms.size and qs.size):
        return []
    cells = []
    for _ in range(k):
        n = int(ns[rng.randrange(ns.size)])
        m = int(ms[rng.randrange(ms.size)])
        q = int(qs[rng.randrange(qs.size)])
        cells.append((q, m, n) if direction == "ingress" else (q, n, m))
    return cells


def audit_policy_set(
    policy: Policy,
    pods: Sequence[PodTuple],
    namespaces: Dict[str, Dict[str, str]],
    cases: Optional[Sequence[PortCase]] = None,
    *,
    oracle_samples: int = 8,
    seed: int = 0,
    engine: Optional[TorchPolicyEngine] = None,
    device=None,
) -> AuditReport:
    """Audit every resolved rule of the policy set against the cluster:
    report never-firing and shadowed rules, each cross-checked against
    the scalar oracle on `oracle_samples` firing cells plus as many
    random cells.  Raises RuntimeError if the oracle refutes a claim
    (an engine/analysis bug, not a user condition).  Without `engine`
    one is built on `device` (None: the current CUDA device)."""
    if cases is None:
        cases = derive_port_cases(policy)
    cases = list(cases)
    n = len(pods)
    if len(cases) * n * n > MAX_AUDIT_CELLS:
        raise ValueError(
            f"audit grid {len(cases)} x {n} x {n} exceeds "
            f"{MAX_AUDIT_CELLS} cells; audit a representative sample "
            f"cluster instead"
        )
    engine = engine or TorchPolicyEngine(policy, pods, namespaces, device=device)
    seconds: Dict[str, float] = {}
    t0 = time.perf_counter()
    comp = engine.firing_components(cases)
    seconds["firing"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ingress_targets, egress_targets = policy.sorted_targets()
    rng = random.Random(seed)

    findings: List[AuditFinding] = []
    n_rules: Dict[str, int] = {}
    fire_samples: Dict[int, List[Cell]] = {}
    for direction, targets, enc in (
        ("ingress", ingress_targets, engine.encoding.ingress),
        ("egress", egress_targets, engine.encoding.egress),
    ):
        c = comp[direction]
        a = c["rule_tmatch"]  # [P, N] bool
        b = c["peer_match"]  # [P, N] bool
        cq = c["pport"]  # [P, Q] bool
        p, n_pods_axis = a.shape
        q = cq.shape[1]
        n_rules[direction] = int(p)
        if p == 0:
            continue
        refs = _rule_refs(direction, targets, enc)
        # bc[p, m*q]: the rule's peer-side x case footprint
        bc = (b[:, :, None] & cq[:, None, :]).reshape(p, n_pods_axis * q)  # shape: (P, NQ) bool
        # explicit int32 BEFORE the matmuls: bool @ bool would upcast
        # per numpy promotion
        a32 = a.astype(np.int32)  # shape: (P, N) int32
        bc32 = bc.astype(np.int32)  # shape: (P, NQ) int32
        # per-cell firing-rule count over the whole direction
        count = a32.T @ bc32  # [N, N*Q]
        uniq = count == 1
        fires = a.any(axis=1) & bc.any(axis=1)
        # unique_any[p]: does any cell exist where p is the ONLY rule firing
        d = a32 @ uniq.astype(np.int32)  # [P, N*Q] (# target rows hitting uniq)
        unique_any = ((d > 0) & bc).any(axis=1)
        shadowed = fires & ~unique_any
        overlap = None
        if shadowed.any():
            # rule pairs with a shared firing cell: both factors overlap
            overlap = ((a32 @ a32.T) > 0) & ((bc32 @ bc32.T) > 0)
        for pi in range(p):
            if not fires[pi]:
                findings.append(
                    AuditFinding(kind="never-fires", rule=refs[pi])
                )
            elif shadowed[pi]:
                covers = [
                    refs[pj]
                    for pj in np.flatnonzero(overlap[pi] & fires)
                    if pj != pi
                ]
                findings.append(
                    AuditFinding(
                        kind="shadowed",
                        rule=refs[pi],
                        covered_by=covers,
                        fire_cells=int(a[pi].sum()) * int(bc[pi].sum()),
                    )
                )
                fire_samples[id(findings[-1])] = _fire_cell_samples(
                    direction, a[pi], b[pi], cq[pi], oracle_samples, rng
                )

    # attribute source policies only for rules that made it into a
    # finding (rule or coverer): _peer_sources rebuilds policies per
    # peer, far too much host work to run for every clean rule
    targets_by_dir = {"ingress": ingress_targets, "egress": egress_targets}
    attr_memo: Dict[Tuple[str, int, int], RuleRef] = {}

    def _attributed(ref: RuleRef) -> RuleRef:
        key = (ref.direction, ref.target_idx, ref.peer_idx)
        if key not in attr_memo:
            import dataclasses

            target = targets_by_dir[ref.direction][ref.target_idx]
            attr_memo[key] = dataclasses.replace(
                ref,
                policies=_peer_sources(
                    ref.direction, target, target.peers[ref.peer_idx]
                ),
            )
        return attr_memo[key]

    for f in findings:
        f.rule = _attributed(f.rule)
        f.covered_by = [_attributed(c) for c in f.covered_by]
    seconds["matmul"] = time.perf_counter() - t0

    # oracle cross-check: every claim, on firing + random cells
    t0 = time.perf_counter()
    checked = 0
    for f in findings:
        cells = fire_samples.get(id(f), []) + sample_cells(
            n, len(cases), oracle_samples, rng
        )
        if not cells:
            f.oracle = "skipped (empty grid)"
            continue
        modified = policy_without_rule(
            policy, f.rule.direction, f.rule.target_idx, f.rule.peer_idx
        )
        bad = check_rule_removal(
            policy, modified, f.rule.direction, pods, namespaces, cases, cells
        )
        if bad:
            raise RuntimeError(
                f"oracle REFUTED audit claim {f.kind} for {f.rule.label}: "
                f"removal changed {len(bad)} sampled verdicts, first "
                f"{bad[0]}"
            )
        f.oracle = "confirmed"
        checked += 1
    seconds["oracle"] = time.perf_counter() - t0
    return AuditReport(
        findings=findings,
        n_rules=n_rules,
        n_pods=n,
        cases=cases,
        oracle_checked=checked,
        seconds=seconds,
    )
