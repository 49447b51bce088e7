"""The port's CLI paths that read a live cluster or synthesize one, against
the reference's, on the CPU: `analyze -n/-A` through the recording fake
kubectl of fakekubectl.py on PATH (the six cases of
tests/test_cli_analyze_kube.py: the same kubectl calls, stdout, stderr
and exit), and `serve --synthesize-pods`, whose replies to a fixed stdin
stream equal the reference's.  The loopback CLI paths are tested in
test_torch_loopback.py, the one file that spawns loopback pods."""

import io
import json
import os
import sys
import types

import pytest

from cyclonus_tpu.cli import main as ref_main
from cyclonus_tpu.serve import service as ref_service_mod
from cyclonus_tpu_torch.cli import main
from cyclonus_tpu_torch.serve import service as service_mod

from fakekubectl import FakeKubectl, pod_json
from test_torch_engine import REPO

SIMPLE_EXAMPLE = os.path.join(REPO, "examples", "networkpolicies", "simple-example")

DENY_ALL_X = {
    "apiVersion": "networking.k8s.io/v1",
    "kind": "NetworkPolicy",
    "metadata": {"name": "deny-all", "namespace": "x"},
    "spec": {"podSelector": {}, "policyTypes": ["Ingress"]},
}


def _portless():
    pod = pod_json(ns="x", name="c", ip="10.0.0.3")
    pod["spec"]["containers"][0]["ports"] = []
    return pod


def _podless_container():
    pod = pod_json(ns="x", name="d", ip="10.0.0.4")
    pod["spec"]["containers"] = []
    return pod


# name: (canned kubectl responses in call order, analyze argv, pod file)
CASES = {
    "query_target_sources_pods_from_cluster": (
        [{"items": [DENY_ALL_X]}, {"items": [pod_json(ns="x", name="a", labels={"pod": "a"})]}],
        ["-n", "x", "--mode", "query-target"],
        None,
    ),
    "query_target_merges_cluster_and_file": (
        [{"items": [DENY_ALL_X]}, {"items": [pod_json(ns="x", name="a", labels={"pod": "a"})]}],
        ["-n", "x", "--mode", "query-target"],
        [{"Namespace": "other", "Labels": {"pod": "z"}}],
    ),
    "probe_builds_resources_from_cluster": (
        [
            {"items": [DENY_ALL_X]},
            {"items": [pod_json(ns="x", name="a", labels={"pod": "a"}, ip="10.0.0.1"),
                       pod_json(ns="x", name="b", labels={"pod": "b"}, ip="10.0.0.2"),
                       _portless(), _podless_container()]},
            {"metadata": {"name": "x", "labels": {"ns": "x"}}},
        ],
        ["-n", "x", "--mode", "probe", "--engine", "oracle"],
        None,
    ),
    "probe_without_model_or_cluster_fails": ([], ["--mode", "probe"], None),
    "all_namespaces_sources_everything": (
        [
            {"items": [DENY_ALL_X]},
            {"items": [pod_json(ns="x", name="a"), pod_json(ns="y", name="b", ip="10.0.0.8")]},
            {"items": [{"metadata": {"name": "x", "labels": {"ns": "x"}}},
                       {"metadata": {"name": "y", "labels": None}}]},
        ],
        ["-A", "--mode", "probe", "--engine", "oracle"],
        None,
    ),
    "lint_mode_fetches_no_pods": (
        [{"items": [DENY_ALL_X]}],
        ["-n", "x", "--mode", "lint"],
        None,
    ),
    "every_cheap_mode_from_two_namespaces": (
        [{"items": [DENY_ALL_X]}, {"items": []}],
        ["-n", "x", "-n", "y", "--mode", "parse", "--mode", "explain", "--mode", "lint"],
        None,
    ),
    "kubectl_error_surfaces": (
        [dict(rc=1, stderr='namespaces "x" not found')],
        ["-n", "x", "--mode", "explain"],
        None,
    ),
    "namespace_and_all_namespaces_exclusive": ([], ["-n", "x", "-A"], None),
}


def run_analyze(fn, argv, root, monkeypatch, capsys, responses):
    """(kubectl argvs, outcome, stdout, stderr) of one in-process run."""
    root.mkdir()
    monkeypatch.setenv("PATH", f"{root}{os.pathsep}{os.environ.get('PATH', '')}")
    fake = FakeKubectl(root)
    for r in responses:
        if isinstance(r, dict) and set(r) <= {"stdout", "rc", "stderr"}:
            fake.enqueue(**r)
        else:
            fake.enqueue(r)
    try:
        outcome = ("rc", fn(["analyze"] + argv))
    except SystemExit as e:
        outcome = ("exit", str(e.code))
    except Exception as e:
        outcome = (type(e).__name__, str(e))
    captured = capsys.readouterr()
    return [c["argv"] for c in fake.calls()], outcome, captured.out, captured.err


@pytest.mark.parametrize("name", sorted(CASES))
def test_analyze_equals_reference(name, tmp_path, monkeypatch, capsys):
    responses, argv, pod_file = CASES[name]
    if pod_file is not None:
        path = tmp_path / "pods.json"
        path.write_text(json.dumps(pod_file))
        argv = argv + ["--target-pod-path", str(path)]
    ref = run_analyze(ref_main, argv, tmp_path / "ref", monkeypatch, capsys, responses)
    port_argv = [("cuda" if a == "oracle" else a) for a in argv] + ["--device", "cpu"]
    port = run_analyze(main, port_argv, tmp_path / "port", monkeypatch, capsys, responses)
    assert port == ref
    if "--engine" in argv:
        # the port's oracle engine prints what its cuda engine prints
        oracle = run_analyze(main, argv + ["--device", "cpu"], tmp_path / "oracle",
                             monkeypatch, capsys, responses)
        assert oracle == port


def test_analyze_probe_reads_cluster(tmp_path, monkeypatch, capsys):
    """What the six reference cases pin about the cluster-sourced probe,
    on the port: deny-all in x blocks the 2 x 2 table, the port-less and
    container-less pods are skipped with the reference's warnings, and
    -A reads policies, pods and namespaces in that order."""
    responses, argv, _ = CASES["probe_builds_resources_from_cluster"]
    calls, outcome, out, err = run_analyze(
        main, argv + ["--device", "cpu"], tmp_path / "n", monkeypatch, capsys, responses)
    assert outcome == ("rc", 0)
    combined = out.split("Combined:")[1]
    assert "| X   | X   |" in combined and "x/c" not in out
    assert "skipping container x/c/cont-80-tcp, no ports available" in err
    assert "skipping pod x/d, no containers available" in err
    responses, argv, _ = CASES["all_namespaces_sources_everything"]
    calls, outcome, out, err = run_analyze(
        main, argv + ["--device", "cpu"], tmp_path / "a", monkeypatch, capsys, responses)
    assert outcome == ("rc", 0)
    assert calls == [
        ["get", "networkpolicy", "--all-namespaces", "-o", "json"],
        ["get", "pods", "--all-namespaces", "-o", "json"],
        ["get", "namespaces", "-o", "json"],
    ]


class TestServeSynthesizePods:
    ARGV = ["serve", "--synthesize-pods", "--policies", SIMPLE_EXAMPLE, "--no-prewarm"]

    def stream(self):
        """Queries among the synthesized pods (both port cases, a pod
        pair each way and a self pair), a label delta, then the queries
        again."""
        from cyclonus_tpu_torch.analysis import synthesize_cluster
        from cyclonus_tpu_torch.kube.yaml_io import load_policies_from_path
        from cyclonus_tpu_torch.matcher import build_network_policies

        pods, _ = synthesize_cluster(build_network_policies(True, load_policies_from_path(SIMPLE_EXAMPLE)))
        keys = [f"{ns}/{name}" for ns, name, _, _ in pods]
        assert len(keys) >= 4
        queries = [
            {"Src": s, "Dst": d, "Port": port, "Protocol": proto, **({"PortName": name} if name else {})}
            for s, d in [(keys[0], keys[1]), (keys[1], keys[0]), (keys[2], keys[-1]),
                         (keys[-1], keys[2]), (keys[3], keys[3])]
            for port, proto, name in [(80, "TCP", ""), (81, "UDP", "serve-81-udp")]
        ]
        ns, name = pods[1][0], pods[1][1]
        lines = [
            {"Namespace": "", "Pod": "", "Container": "", "Queries": queries},
            {"Namespace": "", "Pod": "", "Container": "",
             "Deltas": [{"Kind": "pod_labels", "Namespace": ns, "Name": name,
                         "Labels": {"relabelled": "yes"}}],
             "Queries": queries},
        ]
        return "\n".join(json.dumps(line) for line in lines) + "\n", len(queries)

    def test_replies_equal_reference(self, monkeypatch, capsys):
        still = types.SimpleNamespace(perf_counter=lambda: 0.0, monotonic=lambda: 0.0)
        monkeypatch.setattr(ref_service_mod, "time", still)
        monkeypatch.setattr(service_mod, "time", still)
        stdin, n = self.stream()
        outs = []
        for fn, argv in ((ref_main, self.ARGV), (main, self.ARGV + ["--device", "cpu"])):
            monkeypatch.setattr(sys, "stdin", io.StringIO(stdin))
            assert fn(argv) == 0
            outs.append(capsys.readouterr().out)
        assert outs[1] == outs[0]
        replies = [json.loads(line) for line in outs[1].splitlines()]
        assert len(replies) == 2 and replies[1]["Mode"] == "incremental"
        verdicts = [v["Combined"] for r in replies for v in r["Verdicts"]]
        assert len(verdicts) == 2 * n and True in verdicts and False in verdicts
