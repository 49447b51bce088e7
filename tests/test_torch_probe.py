"""The port's probe layer (cyclonus_tpu_torch.probe) against the
reference's (cyclonus_tpu.probe), on the CPU: the job fan-out of the
mock cluster, and the simulated probe tables of the port's "cuda" runner
(TorchPolicyEngine on device="cpu") held against the reference's "tpu"
engine (JAX on the CPU) and its scalar "oracle", cell for cell and as
rendered text.  Every comparison is exact.

Policies reach the port through its own YAML-dict parser (reference
policy_to_dict -> port parse_policy_dict), so each package compiles its
own matcher objects from identical input."""

import dataclasses
import os

import pytest
import torch

from cyclonus_tpu.kube import MockKubernetes as RefMockKubernetes
from cyclonus_tpu.kube.netpol import IntOrString as RefIntOrString
from cyclonus_tpu.kube.yaml_io import load_policies_from_path, policy_to_dict
from cyclonus_tpu.matcher import build_network_policies as ref_build
from cyclonus_tpu.probe import Pod as RefPod
from cyclonus_tpu.probe import ProbeConfig as RefProbeConfig
from cyclonus_tpu.probe import Resources as RefResources
from cyclonus_tpu.probe import new_simulated_runner as ref_new_simulated_runner
from cyclonus_tpu_torch.engine import TorchPolicyEngine
from cyclonus_tpu_torch.generator import TestCase, TestStep, read_network_policies
from cyclonus_tpu_torch.generator.tags import StringSet
from cyclonus_tpu_torch.connectivity import Interpreter, InterpreterConfig
from cyclonus_tpu_torch.kube import MockKubernetes
from cyclonus_tpu_torch.kube.netpol import IntOrString
from cyclonus_tpu_torch.kube.yaml_io import parse_policy_dict
from cyclonus_tpu_torch.matcher import build_network_policies
from cyclonus_tpu_torch.probe import (
    ProbeConfig,
    Resources,
    SimulatedJobRunner,
    new_simulated_runner,
)
from cyclonus_tpu_torch.probe import Pod as PortPod
from cyclonus_tpu_torch.probe import runner as port_runner
from cyclonus_tpu_torch.probe.probeconfig import PROBE_MODE_SERVICE_NAME

from test_torch_engine import fuzz_policies

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIMPLE_EXAMPLE = os.path.join(REPO, "examples", "networkpolicies", "simple-example")

CLUSTER_3X3 = (["x", "y", "z"], ["a", "b", "c"])
CLUSTER_5X8 = (["x", "y", "z", "v", "w"], ["a", "b", "c", "d", "e", "f", "g", "h"])
PORTS = [80, 81]
PROTOCOLS = ["TCP", "UDP", "SCTP"]


def resources_pair(cluster):
    """The reference's and the port's Resources over one mock cluster
    shape: namespaces x pod names, ports 80/81, TCP/UDP/SCTP."""
    namespaces, pods = cluster
    ref = RefResources.new_default(
        RefMockKubernetes(1.0), namespaces, pods, PORTS, PROTOCOLS,
        pod_creation_timeout_seconds=1,
    )
    port = Resources.new_default(
        MockKubernetes(1.0), namespaces, pods, PORTS, PROTOCOLS,
        pod_creation_timeout_seconds=1,
    )
    return ref, port


def probe_configs(kind):
    """(reference, port) ProbeConfig of one kind of probe."""
    if kind == "all-available":
        return RefProbeConfig.all_available_config(), ProbeConfig.all_available_config()
    port_value, protocol = {
        "numbered": (80, "TCP"),
        "numbered-udp": (81, "UDP"),
        "unserved-numbered": (7777, "TCP"),
        "named": ("serve-81-udp", "UDP"),
        "bad-named": ("no-such-port", "TCP"),
    }[kind]
    return (
        RefProbeConfig.port_protocol_config(RefIntOrString(port_value), protocol),
        ProbeConfig.port_protocol_config(IntOrString(port_value), protocol),
    )


def policies_pair(policies):
    """Reference NetworkPolicy objects -> (reference Policy, port Policy)."""
    port = [parse_policy_dict(policy_to_dict(p)) for p in policies]
    return ref_build(True, policies), build_network_policies(True, port)


def scenario_policies(name):
    if name == "none":
        return []
    if name == "simple-example":
        return load_policies_from_path(SIMPLE_EXAMPLE)
    return fuzz_policies(int(name.split("-")[1]))[0]


def table_cells(table):
    """{(from, to): {job key: (ingress, egress, combined)}} of a Table."""
    return {
        (fr, to): {
            k: (r.ingress, r.egress, r.combined)
            for k, r in table.get(fr, to).job_results.items()
        }
        for fr, to in table.wrapped.keys()
    }


def table_text(table):
    return (table.render_ingress(), table.render_egress(), table.render_table())


def assert_tables_equal(ref, port):
    assert table_cells(ref) == table_cells(port)
    assert table_text(ref) == table_text(port)


def job_form(job):
    return dataclasses.asdict(job)


class TestJobFanOut:
    @pytest.mark.parametrize(
        "kind",
        ["all-available", "numbered", "unserved-numbered", "named", "bad-named"],
    )
    def test_jobs_equal_reference(self, kind):
        ref_res, port_res = resources_pair(CLUSTER_3X3)
        ref_cfg, port_cfg = probe_configs(kind)
        ref_jobs = ref_res.get_jobs_for_probe_config(ref_cfg)
        port_jobs = port_res.get_jobs_for_probe_config(port_cfg)
        for bucket in ("valid", "bad_named_port", "bad_port_protocol"):
            a = [job_form(j) for j in getattr(ref_jobs, bucket)]
            b = [job_form(j) for j in getattr(port_jobs, bucket)]
            assert a == b, bucket
        n = len(port_res.pods) ** 2
        expected = {
            "all-available": (n * 6, 0, 0),
            "numbered": (n, 0, 0),
            "unserved-numbered": (0, 0, n),
            "named": (n, 0, 0),
            "bad-named": (0, n, 0),
        }[kind]
        got = (len(port_jobs.valid), len(port_jobs.bad_named_port), len(port_jobs.bad_port_protocol))
        assert got == expected

    def test_resources_equal_reference(self):
        ref_res, port_res = resources_pair(CLUSTER_5X8)
        assert ref_res.namespaces == port_res.namespaces

        def pod_form(p):
            containers = [
                (c.name, c.port, c.protocol, c.port_name, c.batch_jobs, c.image())
                for c in p.containers
            ]
            return (p.namespace, p.name, p.labels, p.ip, p.service_ip, containers)

        assert [pod_form(p) for p in ref_res.pods] == [pod_form(p) for p in port_res.pods]
        # the in-pod batch worker's pods ask for the worker image
        ref_pod = RefPod.default("x", "a", [80], ["TCP"], batch_jobs=True)
        port_pod = PortPod.default("x", "a", [80], ["TCP"], batch_jobs=True)
        assert pod_form(port_pod) == pod_form(ref_pod)
        assert port_pod.containers[0].image() == "cyclonus-tpu-worker:latest"
        assert ref_res.render_table() == port_res.render_table()


SCENARIOS = [
    ("none", CLUSTER_3X3),
    ("simple-example", CLUSTER_3X3),
    ("simple-example", CLUSTER_5X8),
    ("seed-0", CLUSTER_3X3),
    ("seed-1", CLUSTER_3X3),
    ("seed-2", CLUSTER_3X3),
    ("seed-3", CLUSTER_5X8),
    ("seed-4", CLUSTER_5X8),
    ("seed-5", CLUSTER_5X8),
]


class TestTables:
    @pytest.mark.parametrize("kind", ["all-available", "numbered-udp", "named", "unserved-numbered"])
    @pytest.mark.parametrize(
        "scenario,cluster", SCENARIOS, ids=[f"{s}-{len(c[0])}x{len(c[1])}" for s, c in SCENARIOS]
    )
    def test_cuda_runner_equals_reference(self, scenario, cluster, kind):
        """The port's cuda runner (on the CPU) against the reference's tpu
        engine and its oracle: every cell of ingress, egress and combined,
        and the rendered tables."""
        ref_policy, port_policy = policies_pair(scenario_policies(scenario))
        ref_res, port_res = resources_pair(cluster)
        ref_cfg, port_cfg = probe_configs(kind)
        port_table = new_simulated_runner(port_policy, device="cpu").run_probe_for_config(
            port_cfg, port_res
        )
        for engine in ("tpu", "oracle"):
            ref_table = ref_new_simulated_runner(ref_policy, engine=engine).run_probe_for_config(
                ref_cfg, ref_res
            )
            assert_tables_equal(ref_table, port_table)

    @pytest.mark.parametrize("scenario", ["simple-example", "seed-3"])
    def test_port_oracle_equals_cuda_runner(self, scenario):
        _, port_policy = policies_pair(scenario_policies(scenario))
        _, port_res = resources_pair(CLUSTER_5X8)
        cfg = ProbeConfig.all_available_config()
        cuda = new_simulated_runner(port_policy, device="cpu")
        table = cuda.run_probe_for_config(cfg, port_res)
        oracle = new_simulated_runner(port_policy, engine="oracle").run_probe_for_config(cfg, port_res)
        assert_tables_equal(oracle, table)
        assert set(cuda.seconds) == {"jobs", "run", "table"}
        assert set(cuda.job_runner.seconds) == {"build", "grid", "scatter"}

    def test_job_order_and_verdicts(self):
        """run_jobs_with_resources keeps the jobs' order, and each verdict
        equals the scalar oracle's for that job."""
        ref_policy, port_policy = policies_pair(scenario_policies("seed-4"))
        _, port_res = resources_pair(CLUSTER_3X3)
        jobs = port_res.get_jobs_for_probe_config(ProbeConfig.all_available_config()).valid
        runner = SimulatedJobRunner(port_policy, device="cpu")
        results = runner.run_jobs_with_resources(jobs, port_res)
        assert [r.job for r in results] == jobs
        expected = [runner.run_job(j) for j in jobs]
        assert [(r.ingress, r.egress, r.combined) for r in results] == [
            (r.ingress, r.egress, r.combined) for r in expected
        ]


class TestNoFallback:
    def test_engine_vocabulary(self):
        assert port_runner.ENGINE_CHOICES == ["oracle", "cuda", "cuda-sharded"]
        assert port_runner.DEFAULT_ENGINE == "cuda"
        for engine in ("tpu", "tpu-sharded", "native"):
            with pytest.raises(ValueError):
                SimulatedJobRunner(build_network_policies(True, []), engine=engine)

    def test_no_card_raises(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        policy = build_network_policies(True, [])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            SimulatedJobRunner(policy)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            new_simulated_runner(policy, engine="cuda", device=None)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            SimulatedJobRunner(policy, engine="cuda-sharded")
        with pytest.raises(RuntimeError):
            SimulatedJobRunner(policy, device="cuda")
        # the interpreter's default config asks for the card too
        kube = MockKubernetes(1.0)
        res = Resources.new_default(kube, ["x"], ["a"], [80], ["TCP"], pod_creation_timeout_seconds=1)
        interpreter = Interpreter(kube, res, InterpreterConfig(perturbation_wait_seconds=0))
        case = TestCase(
            description="probe",
            tags=StringSet(),
            steps=[TestStep(probe=ProbeConfig.all_available_config(), actions=[read_network_policies(["x"])])],
        )
        with pytest.raises(RuntimeError, match="no CUDA device"):
            interpreter.execute_test_case(case)
        # the oracle engine needs no device
        SimulatedJobRunner(policy, engine="oracle")

    def test_failing_engine_raises(self, monkeypatch):
        def boom(self, cases):
            raise RuntimeError("engine failed")

        monkeypatch.setattr(TorchPolicyEngine, "evaluate_grid", boom)
        _, port_res = resources_pair(CLUSTER_3X3)
        runner = new_simulated_runner(build_network_policies(True, []), device="cpu")
        with pytest.raises(RuntimeError, match="engine failed"):
            runner.run_probe_for_config(ProbeConfig.all_available_config(), port_res)

    def test_oracle_builds_no_engine(self, monkeypatch):
        def no_engine(*args, **kwargs):
            raise AssertionError("the oracle engine built a TorchPolicyEngine")

        monkeypatch.setattr(TorchPolicyEngine, "__init__", no_engine)
        _, port_res = resources_pair(CLUSTER_3X3)
        table = new_simulated_runner(
            build_network_policies(True, []), engine="oracle"
        ).run_probe_for_config(ProbeConfig.all_available_config(PROBE_MODE_SERVICE_NAME), port_res)
        assert len(table.wrapped.keys()) == 81


@pytest.mark.cuda
class TestCudaRunner:
    @pytest.mark.parametrize(
        "scenario,cluster", [("simple-example", CLUSTER_3X3), ("seed-3", CLUSTER_5X8)]
    )
    def test_card_equals_cpu(self, scenario, cluster):
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA device")
        _, port_policy = policies_pair(scenario_policies(scenario))
        _, port_res = resources_pair(cluster)
        cfg = ProbeConfig.all_available_config()
        card = new_simulated_runner(port_policy).run_probe_for_config(cfg, port_res)
        cpu = new_simulated_runner(port_policy, device="cpu").run_probe_for_config(cfg, port_res)
        assert_tables_equal(cpu, card)
