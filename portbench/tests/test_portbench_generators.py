"""The benchmark's frozen generators against the program's at this commit,
draw for draw, and the churn schedule's fixed amount of work."""

import math
import random
from collections import Counter

import pytest

from portbench.reference import churn, synthetic

MIX = {
    "rate_per_s": 20,
    "events": {"pod_labels": 0.8, "pod_remove_add": 0.2},
    "labels": {"pod": ["p", 100], "app": ["app", 20], "tier": ["tier", 5]},
    "cases": [[80, "serve-80-tcp", "TCP"]],
}


@pytest.mark.parametrize("seed", [0, 1, 7, 20260729, 2**31 + 11])
def test_build_synthetic_matches_the_program(seed):
    from cyclonus_tpu_torch.kube.yaml_io import parse_policy_dict
    from cyclonus_tpu_torch.synthetic import build_synthetic

    pods_a, ns_a, pol_a = build_synthetic(2600, 400, random.Random(seed))
    pods_b, ns_b, pol_b = synthetic.build_synthetic(2600, 400, random.Random(seed))
    assert pods_a == pods_b
    assert ns_a == ns_b
    assert [parse_policy_dict(p) for p in pol_b] == pol_a


def test_bench_tiers_match_the_program():
    from cyclonus_tpu_torch.synthetic import bench_tiers
    from cyclonus_tpu_torch.tiers.model import AdminNetworkPolicy, BaselineAdminNetworkPolicy

    want = bench_tiers()
    anps, banp = synthetic.bench_tiers()
    assert [AdminNetworkPolicy.from_dict(a) for a in anps] == want.anps
    assert BaselineAdminNetworkPolicy.from_dict(banp) == want.banp


def _pods(n=500):
    pods, _ns, _pol = synthetic.build_synthetic(n, 1, random.Random(0))
    return {f"{p[0]}/{p[1]}": p for p in pods}


@pytest.mark.parametrize("seconds", [3.0, 30.0])
def test_schedule_same_work_for_every_seed(seconds):
    pods = _pods()
    shapes = set()
    for seed in (1, 2, 99, 2**33 + 5):
        sched = churn.schedule(MIX, seconds, pods, seed)
        assert len(sched) == round(MIX["rate_per_s"] * seconds)
        dues = [e["due"] for e in sched]
        assert dues == sorted(dues) and 0 < dues[0] and dues[-1] < seconds
        gaps = sorted(round(b - a, 9) for a, b in zip([0.0] + dues, dues))
        kinds = Counter(len(e["deltas"]) for e in sched)
        shapes.add((tuple(gaps), tuple(sorted(kinds.items()))))
    # one multiset of gaps and of kinds; only their order differs
    assert len(shapes) == 1
    n = round(MIX["rate_per_s"] * seconds)
    assert kinds[2] == round(0.2 * n) and kinds[1] == n - round(0.2 * n)


def test_schedule_is_a_function_of_the_seed():
    pods = _pods()
    assert churn.schedule(MIX, 5.0, pods, 42) == churn.schedule(MIX, 5.0, pods, 42)
    assert churn.schedule(MIX, 5.0, pods, 42) != churn.schedule(MIX, 5.0, pods, 43)


def test_gaps_are_exponential_quantiles():
    g = churn.gaps(20.0, 1000)
    assert math.isclose(sum(g) / len(g), 1 / 20.0, rel_tol=0.01)
    assert math.isclose(sorted(g)[500], math.log(2) / 20.0, rel_tol=0.01)


def test_remove_add_restores_the_pod():
    pods = _pods()
    sched = churn.schedule(MIX, 10.0, pods, 5)
    state = dict(pods)
    for ev in sched:
        before = dict(state)
        churn.apply_deltas(state, ev["deltas"])
        if len(ev["deltas"]) == 2:
            assert state == before
        else:
            d = ev["deltas"][0]
            assert d["kind"] == "pod_labels" and set(d["labels"]) == {"pod", "app", "tier"}
    assert set(state) == set(pods)
