"""The port's kubectl cluster (cyclonus_tpu_torch/kube/kubectl.py) against
the reference's, through the recording fake kubectl of fakekubectl.py on
PATH: every call that tests/test_kubectl.py covers runs first on the
reference's KubectlKubernetes and then on the port's, each with the same
canned responses.  The recorded argv and stdin of every kubectl
invocation must be equal, and so must the returned objects (as dataclass
dicts) or the KubeError text."""

import dataclasses
import json
import os
from types import SimpleNamespace

import pytest

import cyclonus_tpu.kube.ikubernetes as ref_ik
import cyclonus_tpu.kube.kubectl as ref_kubectl
import cyclonus_tpu.kube.netpol as ref_netpol
import cyclonus_tpu.kube.objects as ref_objects
import cyclonus_tpu.kube.yaml_io as ref_yaml_io
import cyclonus_tpu_torch.kube.ikubernetes as port_ik
import cyclonus_tpu_torch.kube.kubectl as port_kubectl
import cyclonus_tpu_torch.kube.netpol as port_netpol
import cyclonus_tpu_torch.kube.objects as port_objects
import cyclonus_tpu_torch.kube.yaml_io as port_yaml_io

from fakekubectl import FakeKubectl, pod_json

REF = SimpleNamespace(k=ref_kubectl, ik=ref_ik, np=ref_netpol, o=ref_objects, y=ref_yaml_io)
PORT = SimpleNamespace(k=port_kubectl, ik=port_ik, np=port_netpol, o=port_objects, y=port_yaml_io)


def netpol(m, ns="x", name="np1"):
    return m.np.NetworkPolicy(
        name=name,
        namespace=ns,
        spec=m.np.NetworkPolicySpec(
            pod_selector=m.np.LabelSelector.make(match_labels={"pod": "a"}),
            policy_types=["Ingress"],
        ),
    )


def kube_pod(m, protocol="TCP", port=80, image=""):
    ports = [] if port is None else [
        m.o.KubeContainerPort(
            container_port=port, name=f"serve-{port}-{protocol.lower()}", protocol=protocol
        )
    ]
    return m.o.KubePod(
        namespace="x",
        name="a",
        labels={"pod": "a"},
        containers=[m.o.KubeContainer(name=f"cont-{port}", image=image, ports=ports)],
    )


# Each scenario: (canned responses, call).  The call gets the package's
# modules and a KubectlKubernetes on the fake, and returns what the
# backend returned; responses are enqueued in call order.
SCENARIOS = {
    "context_flag_prefixes_every_command": (
        [{"metadata": {"name": "x", "labels": {"ns": "x"}}}],
        lambda m, k: m.k.KubectlKubernetes(context="kind-calico").get_namespace("x"),
    ),
    "error_maps_to_kube_error": (
        [dict(rc=1, stderr='namespaces "zzz" not found')],
        lambda m, k: k.get_namespace("zzz"),
    ),
    "create_namespace": (
        ["namespace/x created"],
        lambda m, k: k.create_namespace(m.o.KubeNamespace(name="x", labels={"ns": "x"})),
    ),
    "get_namespace": (
        [{"metadata": {"name": "y", "labels": {"ns": "y", "team": "a"}}}],
        lambda m, k: k.get_namespace("y"),
    ),
    "get_namespace_null_labels": (
        [{"metadata": {"name": "y", "labels": None}}],
        lambda m, k: k.get_namespace("y"),
    ),
    "set_namespace_labels_clears_old_keys": (
        [{"metadata": {"name": "y", "labels": {"old": "1", "ns": "y"}}}, "namespace/y patched"],
        lambda m, k: k.set_namespace_labels("y", {"ns": "y", "new": "2"}),
    ),
    "delete_namespace": (["namespace/x deleted"], lambda m, k: k.delete_namespace("x")),
    "create_network_policy": (
        ["networkpolicy/np1 created"],
        lambda m, k: k.create_network_policy(netpol(m)),
    ),
    "get_network_policies_in_namespace": (
        [{"items": [ref_yaml_io.policy_to_dict(netpol(REF)),
                    ref_yaml_io.policy_to_dict(netpol(REF, name="np2"))]}],
        lambda m, k: k.get_network_policies_in_namespace("x"),
    ),
    "get_network_policies_all_namespaces": (
        [{"items": [ref_yaml_io.policy_to_dict(netpol(REF, ns="y"))]}],
        lambda m, k: k.get_network_policies_all_namespaces(),
    ),
    "update_network_policy": (
        ["networkpolicy/np1 configured"],
        lambda m, k: k.update_network_policy(netpol(m)),
    ),
    "delete_network_policy": (["deleted"], lambda m, k: k.delete_network_policy("x", "np1")),
    "delete_all_network_policies_in_namespace": (
        ["deleted"],
        lambda m, k: k.delete_all_network_policies_in_namespace("x"),
    ),
    "create_service": (
        ["service/s created"],
        lambda m, k: k.create_service(
            m.o.KubeService(
                namespace="x",
                name="s-x-a",
                selector={"pod": "a"},
                ports=[m.o.KubeServicePort(port=80, name="service-port-tcp-80", protocol="TCP")],
            )
        ),
    ),
    "get_service": (
        [{"spec": {"selector": {"pod": "a"},
                   "ports": [{"port": 80, "name": "p", "protocol": "UDP"}],
                   "clusterIP": "10.96.0.12"}}],
        lambda m, k: k.get_service("x", "s-x-a"),
    ),
    "get_services_in_namespace_fetches_each": (
        [{"items": [{"metadata": {"name": "s1"}}]},
         {"spec": {"selector": {}, "ports": [], "clusterIP": "ip"}}],
        lambda m, k: k.get_services_in_namespace("x"),
    ),
    "delete_service": (["deleted"], lambda m, k: k.delete_service("x", "s")),
    "create_pod_tcp_container_manifest": (
        ["pod/a created"],
        lambda m, k: k.create_pod(kube_pod(m)),
    ),
    "create_pod_udp_container_manifest": (
        ["pod/a created"],
        lambda m, k: k.create_pod(kube_pod(m, "UDP", 81)),
    ),
    "create_pod_sctp_uses_porter": (
        ["pod/a created"],
        lambda m, k: k.create_pod(kube_pod(m, "SCTP", 82)),
    ),
    "create_pod_portless_worker_image": (
        ["pod/a created"],
        lambda m, k: k.create_pod(kube_pod(m, port=None, image="cyclonus-tpu-worker:latest")),
    ),
    "get_pod_parses_status": ([pod_json()], lambda m, k: k.get_pod("x", "a")),
    "delete_pod_does_not_wait": (["deleted"], lambda m, k: k.delete_pod("x", "a")),
    "set_pod_labels_clears_old_keys": (
        [pod_json(labels={"pod": "a", "stale": "1"}), "pod/a patched"],
        lambda m, k: k.set_pod_labels("x", "a", {"pod": "a"}),
    ),
    "get_pods_in_namespace": (
        [{"items": [pod_json(), pod_json(name="b", ip="10.0.0.10")]}],
        lambda m, k: k.get_pods_in_namespace("x"),
    ),
    "get_all_namespaces": (
        [{"items": [{"metadata": {"name": "x", "labels": {"ns": "x"}}},
                    {"metadata": {"name": "y", "labels": None}}]}],
        lambda m, k: k.get_all_namespaces(),
    ),
    "get_pods_all_namespaces": (
        [{"items": [pod_json(ns="x"), pod_json(ns="y", name="b")]}],
        lambda m, k: k.get_pods_all_namespaces(),
    ),
    "execute_remote_command_success": (
        [dict(stdout="hi\n", stderr="")],
        lambda m, k: k.execute_remote_command(
            "x", "a", "cont-80-tcp", ["/agnhost", "connect", "s-x-b.x.svc:80"]
        ),
    ),
    "execute_remote_command_failure_returns_not_raises": (
        [dict(stdout="", stderr="TIMEOUT", rc=1)],
        lambda m, k: k.execute_remote_command("x", "a", "c", ["cmd"]),
    ),
    "execute_remote_command_failure_empty_stderr": (
        [dict(rc=7)],
        lambda m, k: k.execute_remote_command("x", "a", "c", ["cmd"]),
    ),
    "worker_batch_exec": (
        [dict(stdout="[]\n")],
        lambda m, k: k.execute_remote_command(
            "x", "a", "cont-80-tcp",
            ["/worker", "--jobs", '{"Namespace":"x","Pod":"a","Container":"c","Requests":[]}'],
        ),
    ),
}


def as_data(value):
    """A backend's return value as plain data: dataclasses as dicts,
    lists and tuples element-wise."""
    if dataclasses.is_dataclass(value):
        return dataclasses.asdict(value)
    if isinstance(value, (list, tuple)):
        return type(value)(as_data(v) for v in value)
    return value


def drive(m, root, monkeypatch, responses, call):
    """(recorded kubectl calls, returned data or the KubeError text) of
    one scenario on one package."""
    root.mkdir()
    monkeypatch.setenv("PATH", f"{root}{os.pathsep}{os.environ.get('PATH', '')}")
    fake = FakeKubectl(root)
    for r in responses:
        if isinstance(r, dict) and set(r) <= {"stdout", "rc", "stderr"}:
            fake.enqueue(**r)
        else:
            fake.enqueue(r)
    try:
        out = as_data(call(m, m.k.KubectlKubernetes()))
    except m.ik.KubeError as e:
        out = ("KubeError", str(e))
    calls = fake.calls()
    for c in calls:
        # manifests and patches compare as data, not as JSON text
        if c["stdin"]:
            c["stdin"] = json.loads(c["stdin"])
    return calls, out


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_call_equals_reference(name, tmp_path, monkeypatch):
    responses, call = SCENARIOS[name]
    ref = drive(REF, tmp_path / "ref", monkeypatch, responses, call)
    port = drive(PORT, tmp_path / "port", monkeypatch, responses, call)
    assert port == ref
    assert ref[0], "the scenario ran no kubectl command"


def test_missing_kubectl_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))  # nothing on PATH
    errors = []
    for m in (REF, PORT):
        with pytest.raises(m.ik.KubeError) as e:
            m.k.KubectlKubernetes()
        errors.append(str(e.value))
    assert errors[0] == errors[1] == "kubectl not found on PATH"


def test_worker_image_on_the_manifest(tmp_path, monkeypatch):
    """A batch-jobs pod (probe.pod.Container with batch_jobs) asks the
    cluster for the worker image, on both packages."""
    from cyclonus_tpu.probe.pod import Pod as RefPod
    from cyclonus_tpu_torch.probe.pod import Pod

    out = []
    for m, pod_cls in ((REF, RefPod), (PORT, Pod)):
        pod = pod_cls.default("x", "a", [80], ["TCP"], batch_jobs=True).kube_pod()
        out.append(drive(m, tmp_path / m.k.__name__, monkeypatch, ["pod/a created"],
                         lambda m, k, pod=pod: k.create_pod(pod)))
    assert out[0] == out[1]
    assert out[1][0][0]["stdin"]["spec"]["containers"][0]["image"] == "cyclonus-tpu-worker:latest"
