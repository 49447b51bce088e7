"""Precedence tiers (AdminNetworkPolicy / BaselineAdminNetworkPolicy) in
the PyTorch port against the reference package and the tiered scalar
oracle, on the CPU: the seeded scenario generator, host tensors leaf by
leaf, truth-table grids and full-grid counts on both class modes, the
oracle itself, the tier-free byte identity, and a tier set past the
reference's fused-epilogue ceiling of 1,024 bucketed rows.  Every
comparison is exact.

Tier objects reach the port through the reference's to_dict and the
port's parse_tier_object, policies through policy_to_dict and
parse_policy_dict, so each package compiles its own objects from
identical input."""

import functools

import numpy as np
import pytest

from cyclonus_tpu.engine import PortCase as RefPortCase
from cyclonus_tpu.engine import TpuPolicyEngine
from cyclonus_tpu.kube.netpol import LabelSelector
from cyclonus_tpu.kube.yaml_io import policy_to_dict
from cyclonus_tpu.matcher import build_network_policies as ref_build
from cyclonus_tpu.tiers import fuzz as ref_fuzz
from cyclonus_tpu.tiers.model import (
    AdminNetworkPolicy,
    TierRule,
    TierScope,
)
from cyclonus_tpu.tiers.model import TierSet as RefTierSet
from cyclonus_tpu_torch import oracle
from cyclonus_tpu_torch.engine import PortCase, TorchPolicyEngine
from cyclonus_tpu_torch.kube.yaml_io import parse_policy_dict
from cyclonus_tpu_torch.matcher import build_network_policies
from cyclonus_tpu_torch.matcher.tiered import TieredPolicy
from cyclonus_tpu_torch.tiers import fuzz as port_fuzz
from cyclonus_tpu_torch.tiers.model import TierSet, parse_tier_object

from test_torch_engine import assert_tree_equal, grids

#: the seeds tests/test_tiers.py::test_fuzz_seed runs
SEEDS = range(8)
MODES = ["0", "1"]


def port_tiers(tiers):
    """A reference TierSet as the port's, through the dict round trip."""
    if tiers is None:
        return None
    return TierSet(
        anps=[parse_tier_object(a.to_dict()) for a in tiers.anps],
        banp=None if tiers.banp is None else parse_tier_object(tiers.banp.to_dict()),
    )


def tier_dicts(tiers):
    if tiers is None:
        return None
    return (
        [a.to_dict() for a in tiers.anps],
        None if tiers.banp is None else tiers.banp.to_dict(),
    )


def port_policy(simplify, netpols):
    return build_network_policies(
        simplify, [parse_policy_dict(policy_to_dict(p)) for p in netpols]
    )


@functools.lru_cache(maxsize=None)
def fuzz_engines(seed, mode):
    """(reference case, reference engine, port policy, port tiers, port
    engine) of fuzz seed `seed` at class_compress=`mode`."""
    fc = ref_fuzz.build_fuzz_case(seed)
    ref = TpuPolicyEngine(
        ref_build(fc.simplify, fc.netpols), fc.pods, fc.namespaces,
        tiers=fc.tiers, class_compress=mode,
    )
    policy = port_policy(fc.simplify, fc.netpols)
    tiers = port_tiers(fc.tiers)
    port = TorchPolicyEngine(
        policy, fc.pods, fc.namespaces, tiers=tiers, class_compress=mode, device="cpu"
    )
    return fc, ref, policy, tiers, port


def cases_of(fc):
    return (
        [RefPortCase(c.port, c.port_name, c.protocol) for c in fc.cases],
        [PortCase(c.port, c.port_name, c.protocol) for c in fc.cases],
    )


@pytest.mark.parametrize("seed", range(16))
def test_fuzz_case_matches_reference(seed):
    want = ref_fuzz.build_fuzz_case(seed)
    got = port_fuzz.build_fuzz_case(seed)
    assert got.seed == want.seed and got.simplify == want.simplify
    assert got.pods == want.pods and got.namespaces == want.namespaces
    assert [policy_to_dict(p) for p in got.netpols] == [policy_to_dict(p) for p in want.netpols]
    assert tier_dicts(got.tiers) == tier_dicts(want.tiers)
    assert [(c.port, c.port_name, c.protocol) for c in got.cases] == [
        (c.port, c.port_name, c.protocol) for c in want.cases
    ]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("seed", SEEDS)
def test_tensors_leaf_equal(seed, mode):
    fc, ref, _policy, _tiers, port = fuzz_engines(seed, mode)
    assert ("tiers" in port._tensors) == (fc.tiers is not None)
    assert_tree_equal(ref._tensors, port._tensors)
    rs, ps = ref._class_state, port._class_state
    assert (rs is None) == (ps is None)
    if rs is not None:
        assert_tree_equal(rs["ctensors"], ps["ctensors"])
        assert np.array_equal(rs["classes"].class_of_pod, ps["classes"].class_of_pod)
    want, got = ref.tier_stats(), port.tier_stats()
    for k in ("active", "anp_count", "rule_rows", "banp"):
        assert got[k] == want[k], k


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("seed", SEEDS)
def test_grid_and_counts(seed, mode):
    fc, ref, policy, tiers, port = fuzz_engines(seed, mode)
    ref_cases, cases = cases_of(fc)
    got = grids(port.evaluate_grid(cases))
    assert_tree_equal(grids(ref.evaluate_grid(ref_cases)), got)
    assert_tree_equal(oracle.oracle_grid(policy, fc.pods, fc.namespaces, cases, tiers=tiers), got)
    counts = port.evaluate_grid_counts(cases)
    assert counts == ref.evaluate_grid_counts(ref_cases)
    assert {k: counts[k] for k in ("ingress", "egress", "combined")} == {
        k: int(v.sum()) for k, v in got.items()
    }


@pytest.mark.parametrize("seed", SEEDS)
def test_tiered_oracle_matches_reference(seed):
    fc, _ref, policy, tiers, _port = fuzz_engines(seed, "0")
    want = ref_fuzz._oracle_table(
        ref_build(fc.simplify, fc.netpols), fc.tiers, fc.pods, fc.namespaces, fc.cases
    )  # [Q, src, dst, 3]
    oracle_ = TieredPolicy(policy, tiers)
    _ref_cases, cases = cases_of(fc)
    got = np.zeros_like(want)
    for qi, case in enumerate(cases):
        for s in range(len(fc.pods)):
            for d in range(len(fc.pods)):
                got[qi, s, d] = oracle_.is_traffic_allowed(
                    oracle.traffic_for_cell(fc.pods, fc.namespaces, case, s, d)
                )
    assert np.array_equal(got, want)


def test_empty_tierset_byte_identical():
    fc = port_fuzz.build_fuzz_case(3)
    policy = build_network_policies(fc.simplify, fc.netpols)
    plain = TorchPolicyEngine(policy, fc.pods, fc.namespaces, device="cpu")
    empty = TorchPolicyEngine(policy, fc.pods, fc.namespaces, tiers=TierSet(), device="cpu")
    assert empty.tiers is None and empty.encoding.tiers is None
    assert "tiers" not in plain._tensors and "tiers" not in empty._tensors
    assert_tree_equal(plain._tensors, empty._tensors)
    assert not empty.tier_stats()["active"]


@pytest.mark.parametrize("mode", MODES)
def test_from_tensors_tiered(mode):
    """A tiered reference tensor dict carried across (int8 action/tier,
    int32 selectors/rank, the nested port spec) gives the reference's
    counts and grids."""
    fc, ref, _policy, _tiers, port = fuzz_engines(3, mode)
    st = ref._class_state
    vocab = ref.encoding.cluster.vocab
    carried = TorchPolicyEngine.from_tensors(
        ref._tensors,
        pod_keys=ref.pod_keys,
        port_names=vocab.port_name,
        protocols=vocab.proto,
        classes=st["classes"] if st else None,
        ctensors=st["ctensors"] if st else None,
        device="cpu",
    )
    dev = carried._dev()["tiers"]["ingress"]
    assert str(dev["action"].dtype) == "torch.int8" and str(dev["rank"].dtype) == "torch.int32"
    assert str(dev["subj_ns_sel"].dtype) == "torch.int32"
    assert set(dev["port_spec"]) == set(ref._tensors["tiers"]["ingress"]["port_spec"])
    assert carried.tier_stats()["active"]
    ref_cases, cases = cases_of(fc)
    assert carried.evaluate_grid_counts(cases) == ref.evaluate_grid_counts(ref_cases)
    assert_tree_equal(grids(port.evaluate_grid(cases)), grids(carried.evaluate_grid(cases)))


def _ceiling_problem():
    """40 ANPs, each with one rule per direction over 15 peer scopes:
    600 rows per direction, 1,280 bucketed rows in all, past the
    reference's PACKED_TIER_MAX_ROWS (1,024)."""
    nss = ["x", "y", "z", "w"]
    namespaces = {ns: {"ns": ns} for ns in nss}
    pods = [
        (ns, f"p{i}", {"pod": f"p{i % 6}", "app": ("web", "db")[i % 2]}, f"10.0.{j}.{i + 1}")
        for j, ns in enumerate(nss)
        for i in range(16)
    ]
    actions = ("Allow", "Deny", "Pass")

    def peers(k):
        return [
            TierScope(
                namespace_selector=LabelSelector.make({"ns": nss[(k + p) % 4]}),
                pod_selector=LabelSelector.make({"pod": f"p{(k + p) % 7}"}),
            )
            for p in range(15)
        ]

    anps = [
        AdminNetworkPolicy(
            name=f"anp-{k:02d}",
            priority=k % 11,
            subject=TierScope(
                namespace_selector=LabelSelector.make({"ns": nss[k % 4]}),
                pod_selector=LabelSelector.make({"app": ("web", "db")[k % 2]}),
            ),
            ingress=[TierRule(action=actions[k % 3], peers=peers(k))],
            egress=[TierRule(action=actions[(k + 1) % 3], peers=peers(k + 2))],
        )
        for k in range(40)
    ]
    return pods, namespaces, RefTierSet(anps=anps)


def test_past_the_reference_ceiling():
    from cyclonus_tpu.engine.pallas_kernel import PACKED_TIER_MAX_ROWS

    pods, namespaces, ref_tiers = _ceiling_problem()
    policy_ref = ref_build(True, [])
    ref = TpuPolicyEngine(policy_ref, pods, namespaces, tiers=ref_tiers, class_compress="0")
    rows = sum(int(ref._tensors["tiers"][d]["action"].shape[0]) for d in ("ingress", "egress"))
    assert rows > PACKED_TIER_MAX_ROWS
    ref_cases = [RefPortCase(80, "serve-80-tcp", "TCP")]
    want = ref.evaluate_grid_counts(ref_cases, backend="xla")
    policy = build_network_policies(True, [])
    tiers = port_tiers(ref_tiers)
    cases = [PortCase(80, "serve-80-tcp", "TCP")]
    want_grid = oracle.oracle_grid(policy, pods, namespaces, cases, tiers=tiers)
    sums = {k: int(v.sum()) for k, v in want_grid.items()}
    assert {k: want[k] for k in sums} == sums
    for mode in MODES:
        port = TorchPolicyEngine(
            policy, pods, namespaces, tiers=tiers, class_compress=mode, device="cpu"
        )
        assert port._tensors["tiers"]["ingress"]["action"].shape[0] == 640
        assert port.evaluate_grid_counts(cases) == want, mode



def test_bench_tiers_match_reference(monkeypatch):
    """synthetic.bench_tiers equals the TierSet bench.tiers_case layers
    over its cluster (captured where the benchmark builds its engine)."""
    import bench
    import cyclonus_tpu.engine as ref_engine
    from cyclonus_tpu_torch.synthetic import bench_tiers

    class Captured(Exception):
        pass

    def capture(policy, pods, namespaces, tiers=None, **kw):
        raise Captured(tiers)

    monkeypatch.setattr(ref_engine, "TpuPolicyEngine", capture)
    with pytest.raises(Captured) as info:
        bench.tiers_case([RefPortCase(80, "serve-80-tcp", "TCP")], 8, 8)
    assert tier_dicts(bench_tiers()) == tier_dicts(info.value.args[0])
