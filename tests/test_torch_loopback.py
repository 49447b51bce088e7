"""The port's loopback cluster (cyclonus_tpu_torch/kube/loopback.py) over
real sockets, against the reference's (cyclonus_tpu/kube/loopback.py), on
the CPU: pods as real processes on 127/8, probes as real TCP connects and
UDP datagrams, the in-pod batch prober as the port's real worker
subprocess, and the simulated side on the port's engine (engine "cuda",
device "cpu").

Every port test that spawns loopback pods lives in this one file.  Two
clusters of one process take their base octet from the pid and a
per-package instance counter, so a reference cluster and a port cluster
opened with equal counters share their addresses: they are opened one
after the other, each closed before the next opens.  Where the two must
give byte-equal output, `same_addresses()` aligns the two counters first,
so the next cluster of each package gets the same pod IPs."""

import json
import os

import pytest

import cyclonus_tpu.kube.loopback as ref_loopback
import cyclonus_tpu_torch.kube.loopback as port_loopback
from cyclonus_tpu.cli import main as ref_main
from cyclonus_tpu.connectivity import Interpreter as RefInterpreter
from cyclonus_tpu.connectivity import InterpreterConfig as RefInterpreterConfig
from cyclonus_tpu.generator import create_policy as ref_create_policy
from cyclonus_tpu.generator import read_network_policies as ref_read_network_policies
from cyclonus_tpu.generator.tags import StringSet as RefStringSet
from cyclonus_tpu.generator.testcase import TestCase as RefTestCase
from cyclonus_tpu.generator.testcase import TestStep as RefTestStep
from cyclonus_tpu.kube import netpol as ref_netpol
from cyclonus_tpu.kube.objects import KubeContainer as RefKubeContainer
from cyclonus_tpu.kube.objects import KubeContainerPort as RefKubeContainerPort
from cyclonus_tpu.kube.objects import KubeNamespace as RefKubeNamespace
from cyclonus_tpu.kube.objects import KubePod as RefKubePod
from cyclonus_tpu.probe.probeconfig import PROBE_MODE_SERVICE_NAME as REF_SERVICE_NAME
from cyclonus_tpu.probe.probeconfig import ProbeConfig as RefProbeConfig
from cyclonus_tpu.probe.resources import Resources as RefResources
from cyclonus_tpu_torch.cli import main
from cyclonus_tpu_torch.connectivity import Interpreter, InterpreterConfig
from cyclonus_tpu_torch.connectivity.journal import Journal
from cyclonus_tpu_torch.generator import TestCaseGenerator, create_policy, read_network_policies
from cyclonus_tpu_torch.generator.tags import StringSet
from cyclonus_tpu_torch.generator.testcase import TestCase, TestStep
from cyclonus_tpu_torch.kube import netpol
from cyclonus_tpu_torch.kube.loopback import LoopbackKubernetes, native_probe
from cyclonus_tpu_torch.kube.objects import KubeContainer, KubeContainerPort, KubeNamespace, KubePod
from cyclonus_tpu_torch.probe.probeconfig import PROBE_MODE_SERVICE_NAME, ProbeConfig
from cyclonus_tpu_torch.probe.resources import Resources

from test_torch_engine import REPO

JOURNAL = os.path.join(REPO, "artifacts", "loopback-conformance-journal.jsonl")
GETTING_STARTED = os.path.join(REPO, "examples", "networkpolicies", "getting-started")


class Pkg:
    """One package's names for what these tests drive."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


REF = Pkg(
    loopback=ref_loopback, np=ref_netpol, Resources=RefResources, Interpreter=RefInterpreter,
    InterpreterConfig=RefInterpreterConfig, TestCase=RefTestCase, TestStep=RefTestStep,
    StringSet=RefStringSet, ProbeConfig=RefProbeConfig, service_name=REF_SERVICE_NAME,
    read=ref_read_network_policies, create=ref_create_policy, KubePod=RefKubePod,
    KubeContainer=RefKubeContainer, KubeContainerPort=RefKubeContainerPort,
    KubeNamespace=RefKubeNamespace, engine={"simulated_engine": "oracle"},
)
PORT = Pkg(
    loopback=port_loopback, np=netpol, Resources=Resources, Interpreter=Interpreter,
    InterpreterConfig=InterpreterConfig, TestCase=TestCase, TestStep=TestStep,
    StringSet=StringSet, ProbeConfig=ProbeConfig, service_name=PROBE_MODE_SERVICE_NAME,
    read=read_network_policies, create=create_policy, KubePod=KubePod,
    KubeContainer=KubeContainer, KubeContainerPort=KubeContainerPort,
    KubeNamespace=KubeNamespace, engine={"simulated_engine": "cuda", "device": "cpu"},
)


def same_addresses():
    """Align the two packages' instance counters: the next reference
    cluster and the next port cluster of this process get the same base
    octet, so the same pod IPs (they must not be open at once)."""
    n = max(ref_loopback._INSTANCES[0], port_loopback._INSTANCES[0])
    ref_loopback._INSTANCES[0] = port_loopback._INSTANCES[0] = n


def grid(m, lb, namespaces=("x", "y", "z"), pods=("a", "b", "c")):
    return m.Resources.new_default(
        lb, list(namespaces), list(pods), [80, 81], ["TCP", "UDP"],
        pod_creation_timeout_seconds=15,
    )


def deny_ingress(m, ns="y", from_pod=None):
    """Deny all ingress in `ns`, or allow it only from pods labelled
    pod=<from_pod> in any namespace."""
    ingress = []
    if from_pod:
        ingress = [m.np.NetworkPolicyIngressRule(
            ports=[],
            from_=[m.np.NetworkPolicyPeer(
                pod_selector=m.np.LabelSelector.make(match_labels={"pod": from_pod}),
                namespace_selector=m.np.LabelSelector.make(),
            )],
        )]
    return m.np.NetworkPolicy(
        name="deny",
        namespace=ns,
        spec=m.np.NetworkPolicySpec(
            pod_selector=m.np.LabelSelector.make(), policy_types=["Ingress"], ingress=ingress,
        ),
    )


class TestSockets:
    """Allow, deny, unserved port, source attribution and pod deletion,
    each observed through a real socket, with the port's native_probe and
    the reference's giving the same answer on the same sockets."""

    @pytest.fixture(scope="class")
    def lb(self):
        with LoopbackKubernetes() as lb:
            grid(PORT, lb, namespaces=("x", "y"), pods=("a", "b"))
            yield lb

    @staticmethod
    def probe(host, port, protocol, source_ip=None):
        got = native_probe(host, port, protocol, source_ip=source_ip)
        assert ref_loopback.native_probe(host, port, protocol, source_ip=source_ip) == got
        return got

    def test_enforcement_over_real_sockets(self, lb):
        pa, pb, xb = lb.get_pod("x", "a"), lb.get_pod("y", "b"), lb.get_pod("x", "b")
        assert pa.pod_ip.startswith("127.") and pb.pod_ip.startswith("127.")
        assert self.probe(pb.pod_ip, 80, "TCP", pa.pod_ip) is None
        assert self.probe(pb.pod_ip, 81, "UDP", pa.pod_ip) is None
        assert "refused" in self.probe(pb.pod_ip, 99, "TCP", pa.pod_ip).lower()
        assert self.probe(pb.pod_ip, 80, "SCTP", pa.pod_ip) == "protocol SCTP unsupported on loopback"
        # a non-pod source (127.0.0.1) is in no verdict
        assert self.probe(pb.pod_ip, 80, "TCP") == "closed without ack"

        lb.create_network_policy(deny_ingress(PORT))
        assert self.probe(pb.pod_ip, 80, "TCP", pa.pod_ip) == "closed without ack"
        assert self.probe(pb.pod_ip, 80, "UDP", pa.pod_ip) == "timeout"
        assert self.probe(pa.pod_ip, 80, "TCP", pb.pod_ip) is None

        lb.update_network_policy(deny_ingress(PORT, from_pod="a"))
        assert self.probe(pb.pod_ip, 80, "TCP", pa.pod_ip) is None
        assert self.probe(pb.pod_ip, 80, "TCP", xb.pod_ip) == "closed without ack"
        lb.delete_network_policy("y", "deny")
        assert self.probe(pb.pod_ip, 80, "TCP", xb.pod_ip) is None

    def test_worker_subprocess_batch(self, lb):
        """The port's worker as a real subprocess, the service name of
        one request resolved to its pod, mixed verdicts in one batch."""
        pa, pb = lb.get_pod("x", "a"), lb.get_pod("y", "b")
        lb.create_network_policy(deny_ingress(PORT))
        batch = json.dumps({
            "Namespace": "x", "Pod": "a", "Container": "cont-80-tcp",
            "Requests": [
                {"Key": "blocked", "Protocol": "tcp", "Host": pb.pod_ip, "Port": 80},
                {"Key": "open", "Protocol": "tcp", "Host": pa.pod_ip, "Port": 80},
                {"Key": "service", "Protocol": "udp", "Host": "s-x-b.x.svc.cluster.local", "Port": 81},
            ],
        })
        out, _stderr, err = lb.execute_remote_command(
            "x", "a", "cont-80-tcp", ["/worker", "--jobs", batch]
        )
        lb.delete_network_policy("y", "deny")
        assert err is None
        results = {r["Request"]["Key"]: r for r in json.loads(out)}
        assert results["blocked"]["Error"] == "closed without ack"
        assert results["open"]["Error"] == "" and results["open"]["Output"] == "connected"
        assert results["service"]["Error"] == "" and results["service"]["Request"]["Host"].startswith("127.")
        assert all(r["LatencyMs"] >= 0 for r in results.values())

    def test_exec_errors(self, lb):
        with pytest.raises(port_loopback.KubeError, match="pod x/zz not found"):
            lb.execute_remote_command("x", "zz", "c", ["/worker", "--jobs", "{}"])
        with pytest.raises(port_loopback.KubeError, match="container x/a/nope not found"):
            lb.execute_remote_command("x", "a", "nope", ["/worker", "--jobs", "{}"])

    def test_pod_deletion_frees_address(self, lb):
        pa, pb = lb.get_pod("x", "a"), lb.get_pod("x", "b")
        assert self.probe(pb.pod_ip, 80, "TCP", pa.pod_ip) is None
        lb.delete_pod("x", "b")
        err = self.probe(pb.pod_ip, 80, "TCP", pa.pod_ip)
        assert err and ("refused" in err.lower() or "timeout" in err)


def verdict_maps(m):
    """The cluster's verdict map after each kind of mutation, in order."""
    maps = []
    with m.loopback.LoopbackKubernetes() as lb:

        def snap(what):
            with open(lb.verdict_path) as f:
                maps.append((what, json.load(f)["allow"]))

        grid(m, lb, namespaces=("x", "y"), pods=("a", "b"))
        snap("pods and services")
        lb.create_network_policy(deny_ingress(m))
        snap("policy create")
        lb.update_network_policy(deny_ingress(m, from_pod="a"))
        snap("policy update")
        lb.set_pod_labels("x", "b", {"pod": "a", "extra": "1"})
        snap("pod labels")
        lb.create_network_policy(m.np.NetworkPolicy(
            name="from-team", namespace="x",
            spec=m.np.NetworkPolicySpec(
                pod_selector=m.np.LabelSelector.make(), policy_types=["Ingress"],
                ingress=[m.np.NetworkPolicyIngressRule(ports=[], from_=[m.np.NetworkPolicyPeer(
                    namespace_selector=m.np.LabelSelector.make(match_labels={"team": "t"}),
                )])],
            ),
        ))
        snap("namespace-selector policy")
        lb.set_namespace_labels("y", {"ns": "y", "team": "t"})
        snap("namespace labels")
        lb.create_namespace(m.KubeNamespace(name="w", labels={"ns": "w", "team": "t"}))
        lb.create_pod(m.KubePod(
            namespace="w", name="p", labels={"pod": "p"},
            containers=[m.KubeContainer(name="c", ports=[
                m.KubeContainerPort(container_port=81, name="serve-81-udp", protocol="UDP"),
                m.KubeContainerPort(container_port=82, name="serve-82-sctp", protocol="SCTP"),
            ])],
        ))
        snap("namespace and pod create")
        lb.delete_pod("x", "a")
        snap("pod delete")
        lb.delete_network_policy("y", "deny")
        snap("policy delete")
        lb.delete_all_network_policies_in_namespace("x")
        snap("all policies deleted")
        lb.delete_namespace("y")
        snap("namespace delete")
    return maps


def test_verdict_map_equals_reference():
    """verdicts.json, written from the port's scalar matcher, equals the
    reference's after every kind of mutation (same pod IPs)."""
    same_addresses()
    ref = verdict_maps(REF)
    port = verdict_maps(PORT)
    assert port == ref
    sizes = [len(allow) for _, allow in port]
    assert len(set(map(str, (a for _, a in port)))) >= 8, sizes
    assert min(sizes) > 0


def one_off(m, lb, resources, batch_jobs):
    """test_loopback's one-off case through the package's interpreter:
    deny all ingress in y, then allow it back from x's pod a; TCP 80 by
    service name (the conflict cases probe every port and protocol)."""
    policies = [
        deny_ingress(m),
        m.np.NetworkPolicy(
            name="allow-a-to-y", namespace="y",
            spec=m.np.NetworkPolicySpec(
                pod_selector=m.np.LabelSelector.make(), policy_types=["Ingress"],
                ingress=[m.np.NetworkPolicyIngressRule(ports=[], from_=[m.np.NetworkPolicyPeer(
                    pod_selector=m.np.LabelSelector.make(match_labels={"pod": "a"}),
                    namespace_selector=m.np.LabelSelector.make(match_labels={"ns": "x"}),
                )])],
            ),
        ),
    ]
    case = m.TestCase(
        description="loopback one-off",
        tags=m.StringSet(),
        steps=[m.TestStep(
            probe=m.ProbeConfig.port_protocol_config(m.np.IntOrString(80), "TCP", m.service_name),
            actions=[m.read(["x", "y", "z"])] + [m.create(p) for p in policies],
        )],
    )
    config = m.InterpreterConfig(
        reset_cluster_before_test_case=True, verify_cluster_state_before_test_case=True,
        kube_probe_retries=0, perturbation_wait_seconds=0, batch_jobs=batch_jobs,
        pod_wait_timeout_seconds=15, **m.engine,
    )
    return m.Interpreter(lb, resources, config).execute_test_case(case)


def kube_cells(result):
    """{(from, to): {job key: combined}} of the step's real-socket table."""
    table = result.steps[-1].last_kube_probe()
    return {
        (fr, to): {k: r.combined for k, r in table.get(fr, to).job_results.items()}
        for fr, to in table.wrapped.keys()
    }


class TestInterpreter:
    """The conformance loop over the port's loopback cluster: the one-off
    probe in both exec modes against the reference's, then the 16
    conflict cases in both exec modes against the committed journal."""

    @pytest.fixture(scope="class")
    def ref_tables(self):
        same_addresses()
        with ref_loopback.LoopbackKubernetes() as lb:
            resources = grid(REF, lb)
            return {mode: one_off(REF, lb, resources, mode) for mode in (False, True)}

    @pytest.fixture(scope="class")
    def cluster(self, ref_tables):
        with LoopbackKubernetes() as lb:
            yield lb, grid(PORT, lb)

    @pytest.mark.parametrize("batch_jobs", [False, True], ids=["exec", "batch"])
    def test_one_off_probe(self, batch_jobs, ref_tables, cluster):
        result = one_off(PORT, *cluster, batch_jobs)
        ref = ref_tables[batch_jobs]
        assert result.err is None and ref.err is None, (result.err, ref.err)
        assert result.passed(ignore_loopback=False), "real table != simulated table"
        cells = kube_cells(result)
        assert cells == kube_cells(ref)
        combined = [c for row in cells.values() for c in row.values()]
        assert len(combined) == 81
        assert 0 < combined.count("allowed") < len(combined)

    @pytest.mark.parametrize("batch_jobs", [False, True], ids=["exec", "batch"])
    def test_conflict_cases(self, batch_jobs, cluster, tmp_path):
        lb, resources = cluster
        cases = TestCaseGenerator(
            allow_dns=True, pod_ip=resources.get_pod("z", "c").ip, namespaces=["x", "y", "z"],
            tags=["conflict"], excluded_tags=["multi-peer", "upstream-e2e", "example"],
        ).generate_test_cases()
        config = InterpreterConfig(
            reset_cluster_before_test_case=True, verify_cluster_state_before_test_case=True,
            kube_probe_retries=0, perturbation_wait_seconds=0, pod_wait_timeout_seconds=15,
            batch_jobs=batch_jobs, simulated_engine="cuda", device="cpu",
        )
        interpreter = Interpreter(lb, resources, config)
        journal = Journal(str(tmp_path / "journal.jsonl"))
        for i, tc in enumerate(cases):
            result = interpreter.execute_test_case(tc)
            journal.record(
                tc.description, passed=result.passed(ignore_loopback=False),
                step_count=len(result.steps), tags=tc.tags.keys_sorted(),
                error=str(result.err) if result.err else "", key=f"{i}:{tc.description}",
            )

        def rows(path):
            with open(path) as f:
                return [{k: v for k, v in json.loads(line).items() if k != "ts"} for line in f]

        got = rows(tmp_path / "journal.jsonl")
        assert len(got) == 16 and all(r["passed"] for r in got)
        assert got == rows(JOURNAL)


class TestCli:
    """`probe --loopback` and `generate --loopback --batch-jobs` of the
    port's CLI print what the reference's prints (the reference on its
    oracle engine, the port on its cuda engine on the CPU)."""

    def run_both(self, argv, capsys):
        outs = []
        same_addresses()
        for fn, extra in ((ref_main, ["--engine", "oracle"]), (main, ["--device", "cpu"])):
            rc = fn(argv + extra)
            outs.append((rc, capsys.readouterr().out))
        return outs

    def test_probe_equals_reference(self, capsys):
        argv = ["probe", "--loopback", "--probe-port", "80", "--probe-protocol", "tcp",
                "--policy-path", GETTING_STARTED, "--noisy"]
        (ref_rc, ref_out), (rc, out) = self.run_both(argv, capsys)
        assert rc == ref_rc == 0
        assert out == ref_out
        assert "loopback cluster: dropping unsupported protocol SCTP" in out
        assert "0 wrong, 0 ignored, 81 correct" in out

    def test_generate_batch_jobs_equals_reference(self, capsys):
        argv = ["generate", "--loopback", "--batch-jobs", "--include", "conflict",
                "--retries", "0", "--max-cases", "2"]
        (ref_rc, ref_out), (rc, out) = self.run_both(argv, capsys)
        assert rc == ref_rc == 0
        assert out == ref_out
        assert out.count("0 wrong") == 2 and "total: 2 test cases" in out

    def test_generate_trace_out_merges_worker_processes(self, tmp_path, capsys):
        """`generate --loopback --batch-jobs --trace-out F --metrics-port 0
        --phase-stats`: F holds the driver's events and those of at least
        one worker subprocess under one trace id, `trace --input F`
        summarises it, and a scrape of /metrics shows the probe latency
        histogram."""
        import urllib.request

        from cyclonus_tpu_torch.telemetry import events
        from cyclonus_tpu_torch.telemetry import server as tserver

        out = str(tmp_path / "trace.json")
        same_addresses()
        try:
            rc = main(["generate", "--loopback", "--batch-jobs", "--include", "conflict",
                       "--retries", "0", "--max-cases", "1", "--device", "cpu",
                       "--metrics-port", "0", "--trace-out", out, "--phase-stats"])
            text = capsys.readouterr().out
            assert rc == 0 and "0 wrong" in text
            assert "phase timers:" in text and "engine.encode" in text
            srv = tserver.active_server()
            with urllib.request.urlopen(srv.url + "/metrics", timeout=30) as resp:
                body = resp.read().decode()
            assert 'cyclonus_tpu_probe_latency_seconds_count{source="batch",outcome=' in body
        finally:
            events.disable()
            events.reset()
            tserver.register_readiness(None)
            tserver.stop_metrics_server()
        trace = json.load(open(out))
        evts = [e for e in trace["traceEvents"] if e["ph"] != "M"]
        assert len(trace["otherData"]["trace_ids"]) == 1
        roles = {e["pid"]: e["args"]["name"] for e in trace["traceEvents"] if e["ph"] == "M"}
        assert len({e["pid"] for e in evts}) >= 2
        assert any("worker" in r for r in roles.values())
        assert any("driver" in r for r in roles.values())
        assert {"generate.run", "probe.kube_batch", "worker.batch", "worker.probe"} <= {
            e["name"] for e in evts}
        assert main(["trace", "--input", out]) == 0
        summary = capsys.readouterr().out
        assert "process(es)" in summary and "worker.probe" in summary
