"""The plain reference against the program's CPU engine at tiny sizes,
with and without admin tiers, after a churn schedule applied through the
verdict service; and the yardstick's work counts against a brute force."""

import random
from collections import Counter

import pytest
import torch

from portbench.reference import bound, churn, netpol, synthetic

CASES_2 = [(80, "serve-80-tcp", "TCP"), (81, "serve-81-udp", "UDP")]
CASES_6 = [(80, "serve-80-tcp", "TCP"), (81, "serve-81-tcp", "TCP"),
           (80, "serve-80-udp", "UDP"), (81, "serve-81-udp", "UDP"),
           (80, "serve-80-sctp", "SCTP"), (81, "serve-81-sctp", "SCTP")]
MIX = {
    "rate_per_s": 20,
    "events": {"pod_labels": 0.8, "pod_remove_add": 0.2},
    "labels": {"pod": ["p", 100], "app": ["app", 20], "tier": ["tier", 5]},
}


def _service(pods, namespaces, policies, anps, banp):
    from cyclonus_tpu_torch.kube.yaml_io import parse_policy_dict
    from cyclonus_tpu_torch.serve import VerdictService
    from cyclonus_tpu_torch.tiers.model import (
        AdminNetworkPolicy, BaselineAdminNetworkPolicy, TierSet,
    )

    tiers = None
    if anps or banp:
        tiers = TierSet(anps=[AdminNetworkPolicy.from_dict(a) for a in anps],
                        banp=BaselineAdminNetworkPolicy.from_dict(banp))
    return VerdictService(pods, namespaces, [parse_policy_dict(p) for p in policies],
                          device="cpu", tiers=tiers)


@pytest.mark.parametrize("tiered", [False, True])
@pytest.mark.parametrize("seed", [3, 11, 2024, 2**32 + 1])
def test_reference_equals_the_program_after_churn(seed, tiered):
    from cyclonus_tpu_torch.engine import PortCase
    from cyclonus_tpu_torch.worker.model import Delta

    pods, namespaces, policies = synthetic.build_synthetic(900, 120, random.Random(seed))
    anps, banp = synthetic.bench_tiers() if tiered else ([], None)
    svc = _service(pods, namespaces, policies, anps, banp)
    state = {f"{p[0]}/{p[1]}": p for p in pods}
    ps = netpol.PolicySet(policies, anps, banp)
    sched = churn.schedule(MIX, 2.0, state, seed)
    for i in range(0, len(sched), 8):
        deltas = [d for ev in sched[i:i + 8] for d in ev["deltas"]]
        svc.apply([Delta(**d) for d in deltas])
        churn.apply_deltas(state, deltas)
        for cases in (CASES_2, CASES_6):
            got = svc.engine.evaluate_grid_counts([PortCase(*c) for c in cases])
            want = netpol.grid_counts(state.values(), namespaces, policies, cases,
                                      policy_set=ps)
            assert got == want, (i, cases)


def _brute_counts(pods, namespaces, policies, cases, anps, banp):
    """The same semantics cell by cell, for a handful of pods."""
    ps = netpol.PolicySet(policies, anps, banp)
    c = netpol._Compiled(pods, namespaces, ps, "cpu")
    out = {"ingress": 0, "egress": 0, "combined": 0, "cells": len(pods) ** 2 * len(cases)}
    for case in cases:
        a_in = c.allowed("ingress", case)[c.pod_u]  # [dst, src]
        a_eg = c.allowed("egress", case)[c.pod_u]  # [src, dst]
        out["ingress"] += int(a_in.sum())
        out["egress"] += int(a_eg.sum())
        out["combined"] += int((a_in.T & a_eg).sum())
    return out


@pytest.mark.parametrize("blocks", [(4096, 4096), (7, 33)])
@pytest.mark.parametrize("seed", [0, 5])
def test_grouped_sums_equal_cell_by_cell(seed, blocks, monkeypatch):
    pods, namespaces, policies = synthetic.build_synthetic(300, 60, random.Random(seed))
    # churned labels make many keys, so that small blocks split them
    rng = random.Random(seed)
    pods = [(ns, name, {"pod": f"p{rng.randrange(9)}", "app": f"app{rng.randrange(20)}",
                        "tier": f"tier{rng.randrange(5)}"}, ip) for ns, name, _l, ip in pods]
    anps, banp = synthetic.bench_tiers()
    want = _brute_counts(pods, namespaces, policies, CASES_6, anps, banp)
    monkeypatch.setattr(netpol, "KEY_BLOCK", blocks[0])
    monkeypatch.setattr(netpol, "POD_BLOCK", blocks[1])
    assert netpol.grid_counts(pods, namespaces, policies, CASES_6, anps, banp) == want


def test_key_work_counts_live_targets_and_tier_cells():
    pods, namespaces, policies = synthetic.build_synthetic(600, 90, random.Random(8))
    anps, banp = synthetic.bench_tiers()
    ps = netpol.PolicySet(policies, anps, banp)
    keys = Counter((p[0], tuple(sorted(p[2].items()))) for p in pods)
    work = bound.key_work(keys, namespaces, ps, CASES_2)
    c = netpol._Compiled(pods, namespaces, ps, "cpu")
    sel = c.sel_keys[:, c.pod_u]  # [S, N]
    for d in ("ingress", "egress"):
        t = sel[sorted(ps.np_targets[d])]
        assert work["live_rows"][d] == int(t.any(dim=1).sum()) + int((~t.any(dim=0)).any())
    # tier cells by brute force over (subject pod, peer pod, case)
    rows = ps.anp_rules["ingress"] + ps.banp_rules["ingress"]
    row_cells, union = 0, torch.zeros(len(CASES_2), len(pods), len(pods), dtype=torch.bool)
    for q, case in enumerate(CASES_2):
        for subj, peers, ports, _action in rows:
            if not netpol.admin_port_matches(ports, case):
                continue
            m = c._rule_mask(subj, peers, 0, c.u)[c.pod_u]
            row_cells += int(m.sum())
            union[q] |= m
    assert work["tier_rules"] == len(rows)
    assert work["tier_row_cells"] == row_cells
    assert work["tier_cells"] == int(union.sum())


def test_least_time_is_operations_bound_at_the_headline_shape():
    work = {"pods": 100_000, "cases": 2, "live_rows": {"ingress": 272, "egress": 146},
            "tier_rules": 0, "tier_row_cells": 0, "tier_cells": 0}
    seconds, by, ops, nbytes = bound.packed_counts_least_s(work)
    assert by == "operations"
    # 2 ops a (cell, live row) on the single-bit tensor cores
    assert ops == 2 * 2 * 100_000**2 * (272 + 146)
    assert seconds == pytest.approx(ops / bound.PEAK_B1_OPS)
