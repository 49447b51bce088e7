"""The port's conformance generator and interpreter
(cyclonus_tpu_torch.generator / .connectivity) against the reference's,
on the CPU.

The generator must give the reference's 216 cases: descriptions, tags,
probe configs, step actions and serialised policies, and the counts by
tag.  The first and the last case of each generator family run through
the port's Interpreter (engine "cuda" on device="cpu") and the
reference's (engine "tpu", JAX on the CPU), both against a mock cluster
with the perfect CNI: every step's simulated Table must be the same cell
for cell, the printed report the same text, and every case must pass."""

import dataclasses
import io

import pytest

from cyclonus_tpu.connectivity import Interpreter as RefInterpreter
from cyclonus_tpu.connectivity import InterpreterConfig as RefInterpreterConfig
from cyclonus_tpu.connectivity import Printer as RefPrinter
from cyclonus_tpu.generator import TestCaseGenerator as RefTestCaseGenerator
from cyclonus_tpu.generator import count_test_cases_by_tag as ref_count_by_tag
from cyclonus_tpu.kube import MockKubernetes as RefMockKubernetes
from cyclonus_tpu.kube.mockcni import PolicyAwareMockExec as RefPolicyAwareMockExec
from cyclonus_tpu.kube.yaml_io import policy_to_dict as ref_policy_to_dict
from cyclonus_tpu.probe import Resources as RefResources
from cyclonus_tpu_torch.connectivity import Interpreter, InterpreterConfig, Printer
from cyclonus_tpu_torch.generator import TestCaseGenerator, count_test_cases_by_tag
from cyclonus_tpu_torch.kube import MockKubernetes
from cyclonus_tpu_torch.kube.mockcni import PolicyAwareMockExec
from cyclonus_tpu_torch.kube.yaml_io import policy_to_dict
from cyclonus_tpu_torch.probe import Resources

from test_torch_probe import assert_tables_equal

NAMESPACES = ["x", "y", "z"]
PODS = ["a", "b", "c"]
PORTS = [80, 81]
PROTOCOLS = ["TCP", "UDP", "SCTP"]

FAMILIES = [
    "target",
    "rules",
    "peers",
    "port_protocol",
    "example",
    "action",
    "conflict",
    "upstream_e2e",
]


def probe_form(probe):
    pp = probe.port_protocol
    return (
        probe.all_available,
        str(probe.mode),
        None if pp is None else (pp.protocol, pp.port.value),
    )


def action_form(action, to_dict):
    """(variant, payload) of an Action: the policy as its YAML dict, any
    other variant as its fields."""
    for f in dataclasses.fields(action):
        v = getattr(action, f.name)
        if v is None:
            continue
        if f.name in ("create_policy", "update_policy"):
            return f.name, to_dict(v.policy)
        return f.name, dataclasses.asdict(v)
    raise AssertionError("empty Action")


def case_form(tc, to_dict):
    return (
        tc.description,
        tc.tags.keys_sorted(),
        [
            (probe_form(step.probe), [action_form(a, to_dict) for a in step.actions])
            for step in tc.steps
        ],
        tc.get_features(),
    )


class TestGenerator:
    @pytest.fixture(scope="class")
    def cases(self):
        ref = RefTestCaseGenerator(True, "192.168.0.9", NAMESPACES, [], []).generate_test_cases()
        port = TestCaseGenerator(True, "192.168.0.9", NAMESPACES, [], []).generate_test_cases()
        return ref, port

    def test_cases_equal_reference(self, cases):
        ref, port = cases
        assert len(ref) == len(port) == 216
        for a, b in zip(ref, port):
            assert case_form(a, ref_policy_to_dict) == case_form(b, policy_to_dict)

    def test_counts_by_tag_equal_reference(self, cases):
        ref, port = cases
        assert ref_count_by_tag(ref) == count_test_cases_by_tag(port)

    @pytest.mark.parametrize("family", FAMILIES)
    def test_family_equal_reference(self, family):
        ref = getattr(RefTestCaseGenerator(True, "192.168.0.9", NAMESPACES), f"{family}_test_cases")()
        port = getattr(TestCaseGenerator(True, "192.168.0.9", NAMESPACES), f"{family}_test_cases")()
        assert [case_form(tc, ref_policy_to_dict) for tc in ref] == [
            case_form(tc, policy_to_dict) for tc in port
        ]


def port_harness():
    kube = MockKubernetes(1.0)
    resources = Resources.new_default(
        kube, NAMESPACES, PODS, PORTS, PROTOCOLS, pod_creation_timeout_seconds=1
    )
    kube.exec_verdict_fn = PolicyAwareMockExec(kube)
    config = InterpreterConfig(
        reset_cluster_before_test_case=True,
        verify_cluster_state_before_test_case=True,
        kube_probe_retries=0,
        perturbation_wait_seconds=0,
        simulated_engine="cuda",
        pod_wait_timeout_seconds=1,
        device="cpu",
    )
    return resources, Interpreter(kube, resources, config)


def ref_harness():
    kube = RefMockKubernetes(1.0)
    resources = RefResources.new_default(
        kube, NAMESPACES, PODS, PORTS, PROTOCOLS, pod_creation_timeout_seconds=1
    )
    kube.exec_verdict_fn = RefPolicyAwareMockExec(kube)
    config = RefInterpreterConfig(
        reset_cluster_before_test_case=True,
        verify_cluster_state_before_test_case=True,
        kube_probe_retries=0,
        perturbation_wait_seconds=0,
        simulated_engine="tpu",
        pod_wait_timeout_seconds=1,
    )
    return resources, RefInterpreter(kube, resources, config)


class TestInterpreter:
    @pytest.mark.parametrize("index", [0, -1], ids=["first", "last"])
    @pytest.mark.parametrize("family", FAMILIES)
    def test_family_case_equals_reference(self, family, index):
        """The family's first and last case through both interpreters:
        each step's simulated table equal, the printed report equal, and
        a pass."""
        ref_res, ref_interp = ref_harness()
        port_res, port_interp = port_harness()
        zc = ref_res.get_pod("z", "c").ip
        assert port_res.get_pod("z", "c").ip == zc
        ref_case = getattr(RefTestCaseGenerator(True, zc, NAMESPACES), f"{family}_test_cases")()[index]
        port_case = getattr(TestCaseGenerator(True, zc, NAMESPACES), f"{family}_test_cases")()[index]

        ref_result = ref_interp.execute_test_case(ref_case)
        port_result = port_interp.execute_test_case(port_case)
        assert port_result.err is None and ref_result.err is None
        assert len(port_result.steps) == len(ref_result.steps) == len(port_case.steps)
        for ref_step, port_step in zip(ref_result.steps, port_result.steps):
            assert_tables_equal(ref_step.simulated_probe, port_step.simulated_probe)
            assert_tables_equal(ref_step.last_kube_probe(), port_step.last_kube_probe())
        assert port_result.passed(False) and ref_result.passed(False)

        ref_out, port_out = io.StringIO(), io.StringIO()
        RefPrinter(noisy=True, out=ref_out).print_test_case_result(ref_result)
        Printer(noisy=True, out=port_out).print_test_case_result(port_result)
        assert ref_out.getvalue() == port_out.getvalue()
