"""The port's analysis layer (cyclonus_tpu_torch/analysis and
TorchPolicyEngine.firing_components) against the reference's
(cyclonus_tpu/analysis, TpuPolicyEngine.firing_components), on the CPU:
the same policies, cluster and port cases through both packages —
firing components leaf by leaf, audit and diff reports field by field
and table by table on every all_examples() policy, with a hand-built
shadowed rule and a one-rule perturbation as in tests/test_analysis.py,
the class-reduction audit, and the derived inputs.  Every value is
boolean or integer: the tolerance is zero."""

import numpy as np
import pytest
import torch

from cyclonus_tpu import analysis as ref_analysis
from cyclonus_tpu.engine import PortCase as RefPortCase
from cyclonus_tpu.engine import TpuPolicyEngine
from cyclonus_tpu.kube.examples import all_examples
from cyclonus_tpu.kube.netpol import (
    IntOrString,
    LabelSelector,
    NetworkPolicyPeer,
    NetworkPolicyPort,
)
from cyclonus_tpu.kube.pathological import (
    ALLOW_ALL_INGRESS,
    ALLOW_MATCHING_PODS_IN_POLICY_NAMESPACE_PEER,
    NAMESPACE,
    SELECTOR_GH,
)
from cyclonus_tpu.kube.yaml_io import policy_to_dict
from cyclonus_tpu.matcher import build_network_policies as ref_build
from cyclonus_tpu_torch import analysis
from cyclonus_tpu_torch.engine import PortCase, TorchPolicyEngine
from cyclonus_tpu_torch.kube.yaml_io import parse_policy_dict
from cyclonus_tpu_torch.matcher import build_network_policies

from test_analysis import _ingress_policy, _pathological_cluster

EXAMPLES = all_examples()


def both(netpols, simplify=False):
    """(reference Policy, port Policy) of the same raw policies."""
    port = build_network_policies(
        simplify, [parse_policy_dict(policy_to_dict(p)) for p in netpols]
    )
    return ref_build(simplify, netpols), port


def port_cases(cases):
    return [PortCase(c.port, c.port_name, c.protocol) for c in cases]


def case_tuples(cases):
    return [(c.port, c.port_name, c.protocol) for c in cases]


def rule_fields(r):
    return (r.direction, r.target_idx, r.peer_idx, r.target_namespace, r.policies, r.peer)


def assert_audit_equal(ref, port):
    assert port.n_rules == ref.n_rules
    assert port.n_pods == ref.n_pods
    assert case_tuples(port.cases) == case_tuples(ref.cases)
    assert port.oracle_checked == ref.oracle_checked
    assert len(port.findings) == len(ref.findings)
    for a, b in zip(ref.findings, port.findings):
        assert (b.kind, b.fire_cells, b.oracle) == (a.kind, a.fire_cells, a.oracle)
        assert rule_fields(b.rule) == rule_fields(a.rule)
        assert [rule_fields(c) for c in b.covered_by] == [rule_fields(c) for c in a.covered_by]
    assert port.cells == ref.cells
    assert port.table() == ref.table()


def assert_diff_equal(ref, port):
    assert case_tuples(port.cases) == case_tuples(ref.cases)
    assert port.pod_keys == ref.pod_keys
    assert port.n_diff == ref.n_diff
    assert port.truncated == ref.truncated
    assert port.oracle_checked == ref.oracle_checked
    assert [(c.src, c.dst, c.a, c.b, case_tuples([c.case])) for c in port.cells] == [
        (c.src, c.dst, c.a, c.b, case_tuples([c.case])) for c in ref.cells
    ]
    assert port.equivalent == ref.equivalent and port.total_cells == ref.total_cells
    assert port.table() == ref.table()


def example_inputs(netpols, simplify=False):
    """(ref policy, port policy, pods, namespaces, ref cases, port cases)
    with the cluster and the cases derived from the policies."""
    ref, port = both(netpols, simplify)
    pods, namespaces = ref_analysis.synthesize_cluster(ref)
    cases = ref_analysis.derive_port_cases(ref)
    return ref, port, pods, namespaces, cases, port_cases(cases)


class TestFiringComponents:
    @pytest.mark.parametrize("i", range(len(EXAMPLES)))
    def test_leaf_equal_per_example(self, i):
        ref, port, pods, namespaces, rcases, pcases = example_inputs([EXAMPLES[i]])
        want = TpuPolicyEngine(ref, pods, namespaces).firing_components(rcases)
        got = TorchPolicyEngine(port, pods, namespaces, device="cpu").firing_components(pcases)
        assert set(got) == set(want) == {"ingress", "egress"}
        for d in want:
            assert set(got[d]) == set(want[d])
            for k in want[d]:
                assert got[d][k].dtype == np.bool_, (d, k)
                assert got[d][k].shape == want[d][k].shape, (d, k)
                assert np.array_equal(got[d][k], np.asarray(want[d][k])), (d, k)

    def test_all_examples_raw_rows_map_to_rules(self):
        """The components read the raw encoding: peer row p is resolved
        rule (peer_target[p], peer_rule_idx[p]), and the rank-1 factors
        rebuild the engine's own verdict grid."""
        ref, port, pods, namespaces, rcases, pcases = example_inputs(EXAMPLES)
        eng = TorchPolicyEngine(port, pods, namespaces, device="cpu", class_compress="1")
        comp = eng.firing_components(pcases[:3])
        want = TpuPolicyEngine(ref, pods, namespaces).firing_components(rcases[:3])
        for d in want:
            for k in want[d]:
                assert np.array_equal(comp[d][k], np.asarray(want[d][k])), (d, k)
            assert comp[d]["rule_tmatch"].shape[0] == len(getattr(eng.encoding, d).peer_target)
        grid = eng.evaluate_grid(pcases[:3])
        for direction, got in (
            ("ingress", np.swapaxes(np.asarray(grid.ingress), 1, 2)),
            ("egress", np.asarray(grid.egress)),
        ):
            c = comp[direction]
            fire_any = np.einsum("pn,pm,pq->nmq", c["rule_tmatch"], c["peer_match"],
                                 c["pport"]) > 0
            allowed = (~c["has_target"][:, None, None]) | fire_any
            want_grid = np.moveaxis(allowed, -1, 0)
            if direction == "ingress":
                want_grid = want_grid.swapaxes(1, 2)
            assert np.array_equal(want_grid, got), direction

    def test_pad_rules_and_no_card_fallback(self, monkeypatch):
        """An engine built from a tensor dict has no raw encoding, and
        the components never fall back from a missing card."""
        ref, port, pods, namespaces, _rc, pcases = example_inputs(EXAMPLES[:2])
        eng = TorchPolicyEngine(port, pods, namespaces, device="cpu")
        bare = TorchPolicyEngine.from_tensors(
            eng._tensors, pod_keys=eng.pod_keys, port_names=eng._port_names,
            protocols=eng._protocols, device="cpu",
        )
        with pytest.raises(ValueError, match="built from a policy"):
            bare.firing_components(pcases)
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            analysis.audit_policy_set(port, pods, namespaces, pcases)


class TestAudit:
    @pytest.mark.parametrize("i", range(len(EXAMPLES)))
    def test_report_equal_per_example(self, i):
        ref, port, pods, namespaces, rcases, pcases = example_inputs([EXAMPLES[i]])
        want = ref_analysis.audit_policy_set(ref, pods, namespaces, rcases, oracle_samples=4)
        got = analysis.audit_policy_set(port, pods, namespaces, pcases, oracle_samples=4,
                                        device="cpu")
        assert_audit_equal(want, got)
        assert set(got.seconds) == {"firing", "matmul", "oracle"}

    def test_all_examples_report_equal(self):
        ref, port, pods, namespaces, rcases, pcases = example_inputs(EXAMPLES)
        want = ref_analysis.audit_policy_set(ref, pods, namespaces, rcases, oracle_samples=4)
        got = analysis.audit_policy_set(port, pods, namespaces, pcases, oracle_samples=4,
                                        device="cpu")
        assert_audit_equal(want, got)
        assert sum(got.n_rules.values()) > 10

    def test_pathological_shadowed_rule(self):
        narrow = _ingress_policy("narrow", [ALLOW_MATCHING_PODS_IN_POLICY_NAMESPACE_PEER])
        ref, port = both([ALLOW_ALL_INGRESS, narrow])
        pods, namespaces = _pathological_cluster()
        cases = [RefPortCase(80, "", "TCP"), RefPortCase(53, "", "UDP")]
        want = ref_analysis.audit_policy_set(ref, pods, namespaces, cases)
        got = analysis.audit_policy_set(port, pods, namespaces, port_cases(cases), device="cpu")
        assert_audit_equal(want, got)
        shadowed = [f for f in got.findings if f.kind == "shadowed"]
        assert len(shadowed) == 1 and shadowed[0].rule.policies == (f"{NAMESPACE}/narrow",)
        assert shadowed[0].oracle == "confirmed"

    @pytest.mark.parametrize("which", ["never-fires", "port-shadowing", "live"])
    def test_hand_built_sets(self, which):
        if which == "never-fires":
            pols = [_ingress_policy("dead", [NetworkPolicyPeer(pod_selector=SELECTOR_GH)])]
        elif which == "port-shadowing":
            pols = [
                _ingress_policy("wide", [NetworkPolicyPeer()]),
                _ingress_policy("narrow-port", [NetworkPolicyPeer()],
                                ports=[NetworkPolicyPort(protocol="TCP", port=IntOrString(80))]),
            ]
        else:
            pols = [_ingress_policy("only", [ALLOW_MATCHING_PODS_IN_POLICY_NAMESPACE_PEER])]
        ref, port = both(pols)
        pods, namespaces = _pathological_cluster()
        cases = [RefPortCase(80, "", "TCP"), RefPortCase(53, "", "UDP")]
        want = ref_analysis.audit_policy_set(ref, pods, namespaces, cases)
        got = analysis.audit_policy_set(port, pods, namespaces, port_cases(cases), device="cpu")
        assert_audit_equal(want, got)

    def test_audit_grid_cap(self):
        _ref, port = both([ALLOW_ALL_INGRESS])
        pods = [(NAMESPACE, f"p{i}", {}, f"10.0.0.{i}") for i in range(4)]
        with pytest.raises(ValueError, match="exceeds"):
            analysis.audit_policy_set(port, pods * 3000, {NAMESPACE: {}},
                                      [PortCase(80, "", "TCP"), PortCase(53, "", "UDP")],
                                      device="cpu")


class TestDiff:
    @pytest.mark.parametrize("i", range(len(EXAMPLES)))
    def test_one_rule_removed_per_example(self, i):
        """Each example against itself with its first resolved rule
        removed (or against an empty set when it has none)."""
        ref, port, pods, namespaces, rcases, pcases = example_inputs([EXAMPLES[i]])
        ri, re_ = ref.sorted_targets()
        direction = "ingress" if any(t.peers for t in ri) else "egress"
        targets = ri if direction == "ingress" else re_
        t_idx = next((j for j, t in enumerate(targets) if t.peers), None)
        if t_idx is None:
            ref_b, port_b = both([])
        else:
            ref_b = ref_analysis.policy_without_rule(ref, direction, t_idx, 0)
            port_b = analysis.policy_without_rule(port, direction, t_idx, 0)
        want = ref_analysis.diff_policy_sets(ref, ref_b, pods, namespaces, rcases)
        got = analysis.diff_policy_sets(port, port_b, pods, namespaces, pcases, device="cpu")
        assert_diff_equal(want, got)

    def test_self_diff_empty(self):
        ref, port, pods, namespaces, rcases, pcases = example_inputs(EXAMPLES)
        want = ref_analysis.diff_policy_sets(ref, ref, pods, namespaces, rcases)
        got = analysis.diff_policy_sets(port, port, pods, namespaces, pcases, device="cpu")
        assert_diff_equal(want, got)
        assert got.equivalent and got.cells == [] and got.oracle_checked > 0

    def test_one_rule_perturbation_localizes(self):
        web = LabelSelector.make(match_labels={"app": "web"})
        client = NetworkPolicyPeer(pod_selector=LabelSelector.make(match_labels={"app": "client"}))
        pol = _ingress_policy("web-in", [client], namespace="default", pod_selector=web)
        ref_a, port_a = both([pol])
        ref_b = ref_analysis.policy_without_rule(ref_a, "ingress", 0, 0)
        port_b = analysis.policy_without_rule(port_a, "ingress", 0, 0)
        pods = [
            ("default", "web", {"app": "web"}, "10.0.0.1"),
            ("default", "client", {"app": "client"}, "10.0.0.2"),
            ("default", "other", {}, "10.0.0.3"),
        ]
        cases = [RefPortCase(80, "", "TCP"), RefPortCase(53, "", "UDP")]
        want = ref_analysis.diff_policy_sets(ref_a, ref_b, pods, {"default": {}}, cases)
        got = analysis.diff_policy_sets(port_a, port_b, pods, {"default": {}},
                                         port_cases(cases), device="cpu")
        assert_diff_equal(want, got)
        assert got.n_diff["egress"] == 0 and got.n_diff["ingress"] == len(got.cells) > 0
        for cell in got.cells:
            assert (cell.src, cell.dst) == ("default/client", "default/web")
            assert cell.a[0] and not cell.b[0]

    @pytest.mark.parametrize("max_cells", [0, 3, 64])
    def test_truncation(self, max_cells):
        ref_a, port_a = both(EXAMPLES[:6])
        ref_b, port_b = both(EXAMPLES[3:9])
        pods, namespaces = ref_analysis.synthesize_cluster(ref_a, ref_b)
        cases = ref_analysis.derive_port_cases(ref_a, ref_b)
        want = ref_analysis.diff_policy_sets(ref_a, ref_b, pods, namespaces, cases,
                                             max_cells=max_cells)
        got = analysis.diff_policy_sets(port_a, port_b, pods, namespaces, port_cases(cases),
                                        max_cells=max_cells, device="cpu")
        assert_diff_equal(want, got)


class TestClassReduction:
    @pytest.mark.parametrize("tiered", [False, True])
    def test_report_equal(self, tiered):
        from cyclonus_tpu.tiers import fuzz as ref_fuzz
        from test_torch_tiers import port_tiers

        seed = 3 if tiered else 9
        fc = ref_fuzz.build_fuzz_case(seed)
        tiers = fc.tiers if tiered else None
        ref, port = both(fc.netpols, fc.simplify)
        reng = TpuPolicyEngine(ref, fc.pods, fc.namespaces, class_compress="1", tiers=tiers)
        peng = TorchPolicyEngine(port, fc.pods, fc.namespaces, device="cpu",
                                 class_compress="1", tiers=port_tiers(tiers))
        import random

        want = ref_analysis.audit_class_reduction(
            ref, fc.pods, fc.namespaces, fc.cases, reng.pod_classes(),
            rng=random.Random(1), tiers=tiers,
        )
        got = analysis.audit_class_reduction(
            port, fc.pods, fc.namespaces, port_cases(fc.cases), peng.pod_classes(),
            rng=random.Random(1), tiers=port_tiers(tiers),
        )
        assert got == want and got["ok"]


class TestInputs:
    @pytest.mark.parametrize("k", [1, 6, len(EXAMPLES)])
    def test_derived_cases_and_cluster_equal(self, k):
        ref, port = both(EXAMPLES[:k])
        assert case_tuples(analysis.derive_port_cases(port)) == case_tuples(
            ref_analysis.derive_port_cases(ref)
        )
        assert analysis.synthesize_cluster(port) == ref_analysis.synthesize_cluster(ref)
        assert analysis.synthesize_cluster(port, max_pods=5) == ref_analysis.synthesize_cluster(
            ref, max_pods=5
        )

    def test_policy_without_rule_equal(self):
        from cyclonus_tpu.matcher.explain import explain_table as ref_explain
        from cyclonus_tpu_torch.matcher.explain import explain_table as port_explain

        ref, port = both(EXAMPLES)
        for direction in ("ingress", "egress"):
            ri = ref.sorted_targets()[0 if direction == "ingress" else 1]
            for t_idx, t in enumerate(ri):
                for p_idx in range(len(t.peers)):
                    a = ref_analysis.policy_without_rule(ref, direction, t_idx, p_idx)
                    b = analysis.policy_without_rule(port, direction, t_idx, p_idx)
                    assert port_explain(b) == ref_explain(a), (direction, t_idx, p_idx)
