"""Real-cluster IKubernetes backend over the kubectl CLI (the reference's
process/cluster boundary is client-go + SPDY exec, kubernetes.go:182-218;
ours shells out to kubectl, which is equivalent for every operation the
framework performs and keeps the core dependency-free).

Requires kubectl on PATH and a reachable cluster; construction raises
KubeError otherwise.  Untested in CI (no cluster); the MockKubernetes path
covers all callers."""

from __future__ import annotations

import json
import shutil
import subprocess
from typing import Dict, List, Optional, Tuple

from ..images import AGNHOST_IMAGE
from .ikubernetes import IKubernetes, KubeError
from .netpol import NetworkPolicy
from .objects import (
    KubeContainer,
    KubeContainerPort,
    KubeNamespace,
    KubePod,
    KubeService,
    KubeServicePort,
)
from .yaml_io import parse_policy_dict, policy_to_dict


class KubectlKubernetes(IKubernetes):
    def __init__(self, context: str = ""):
        if shutil.which("kubectl") is None:
            raise KubeError("kubectl not found on PATH")
        self.context = context

    def _base(self) -> List[str]:
        cmd = ["kubectl"]
        if self.context:
            cmd += ["--context", self.context]
        return cmd

    def _run(self, args: List[str], input_text: Optional[str] = None) -> str:
        proc = subprocess.run(
            self._base() + args,
            # always give kubectl a CLOSED stdin ("" = empty pipe): with
            # an inherited never-closing fd 0 (CI runners, nohup), any
            # kubectl invocation that reads stdin would hang to timeout
            input=input_text if input_text is not None else "",
            capture_output=True,
            text=True,
            timeout=120,
        )
        if proc.returncode != 0:
            raise KubeError(
                f"kubectl {' '.join(args)} failed: {proc.stderr.strip()}"
            )
        return proc.stdout

    def _get_json(self, args: List[str]) -> dict:
        return json.loads(self._run(args + ["-o", "json"]))

    def _apply(self, manifest: dict) -> None:
        self._run(["apply", "-f", "-"], input_text=json.dumps(manifest))

    # namespaces

    def create_namespace(self, ns: KubeNamespace) -> KubeNamespace:
        self._apply(
            {
                "apiVersion": "v1",
                "kind": "Namespace",
                "metadata": {"name": ns.name, "labels": ns.labels},
            }
        )
        return ns

    def get_namespace(self, namespace: str) -> KubeNamespace:
        d = self._get_json(["get", "namespace", namespace])
        return KubeNamespace(
            name=d["metadata"]["name"], labels=d["metadata"].get("labels") or {}
        )

    def set_namespace_labels(self, namespace: str, labels: Dict[str, str]) -> KubeNamespace:
        current = self.get_namespace(namespace)
        patch = {"metadata": {"labels": {k: None for k in current.labels}}}
        patch["metadata"]["labels"].update(labels)
        self._run(
            ["patch", "namespace", namespace, "--type=merge", "-p", json.dumps(patch)]
        )
        return KubeNamespace(name=namespace, labels=dict(labels))

    def delete_namespace(self, namespace: str) -> None:
        self._run(["delete", "namespace", namespace, "--wait=true"])

    # network policies

    def create_network_policy(self, policy: NetworkPolicy) -> NetworkPolicy:
        self._apply(policy_to_dict(policy))
        return policy

    def get_network_policies_in_namespace(self, namespace: str) -> List[NetworkPolicy]:
        d = self._get_json(["get", "networkpolicy", "-n", namespace])
        return [parse_policy_dict(item) for item in d.get("items", [])]

    def get_network_policies_all_namespaces(self) -> List[NetworkPolicy]:
        """analyze --all-namespaces (reference analyze.go AllNamespaces /
        kubectl -A)."""
        d = self._get_json(["get", "networkpolicy", "--all-namespaces"])
        return [parse_policy_dict(item) for item in d.get("items", [])]

    def update_network_policy(self, policy: NetworkPolicy) -> NetworkPolicy:
        self._apply(policy_to_dict(policy))
        return policy

    def delete_network_policy(self, namespace: str, name: str) -> None:
        self._run(["delete", "networkpolicy", name, "-n", namespace])

    def delete_all_network_policies_in_namespace(self, namespace: str) -> None:
        self._run(["delete", "networkpolicy", "--all", "-n", namespace])

    # services

    def create_service(self, service: KubeService) -> KubeService:
        self._apply(
            {
                "apiVersion": "v1",
                "kind": "Service",
                "metadata": {"name": service.name, "namespace": service.namespace},
                "spec": {
                    "selector": service.selector,
                    "ports": [
                        {"name": p.name, "port": p.port, "protocol": p.protocol}
                        for p in service.ports
                    ],
                },
            }
        )
        return service

    def get_service(self, namespace: str, name: str) -> KubeService:
        d = self._get_json(["get", "service", name, "-n", namespace])
        spec = d.get("spec", {})
        return KubeService(
            namespace=namespace,
            name=name,
            selector=spec.get("selector") or {},
            ports=[
                KubeServicePort(
                    port=p["port"],
                    name=p.get("name", ""),
                    protocol=p.get("protocol", "TCP"),
                )
                for p in spec.get("ports", [])
            ],
            cluster_ip=spec.get("clusterIP", ""),
        )

    def delete_service(self, namespace: str, name: str) -> None:
        self._run(["delete", "service", name, "-n", namespace])

    def get_services_in_namespace(self, namespace: str) -> List[KubeService]:
        d = self._get_json(["get", "service", "-n", namespace])
        return [
            self.get_service(namespace, item["metadata"]["name"])
            for item in d.get("items", [])
        ]

    # pods

    def create_pod(self, pod: KubePod) -> KubePod:
        self._apply(
            {
                "apiVersion": "v1",
                "kind": "Pod",
                "metadata": {
                    "name": pod.name,
                    "namespace": pod.namespace,
                    "labels": pod.labels,
                },
                "spec": {
                    "terminationGracePeriodSeconds": 0,
                    "containers": [
                        _container_manifest(c) for c in pod.containers
                    ],
                },
            }
        )
        return pod

    def get_pod(self, namespace: str, pod: str) -> KubePod:
        d = self._get_json(["get", "pod", pod, "-n", namespace])
        return _pod_from_json(d)

    def delete_pod(self, namespace: str, pod: str) -> None:
        self._run(["delete", "pod", pod, "-n", namespace, "--wait=false"])

    def set_pod_labels(self, namespace: str, pod: str, labels: Dict[str, str]) -> KubePod:
        current = self.get_pod(namespace, pod)
        patch = {"metadata": {"labels": {k: None for k in current.labels}}}
        patch["metadata"]["labels"].update(labels)
        self._run(
            ["patch", "pod", pod, "-n", namespace, "--type=merge", "-p", json.dumps(patch)]
        )
        current.labels = dict(labels)
        return current

    def get_pods_in_namespace(self, namespace: str) -> List[KubePod]:
        d = self._get_json(["get", "pods", "-n", namespace])
        return [_pod_from_json(item) for item in d.get("items", [])]

    # cluster-wide reads (concrete-backend methods like the reference's
    # kube.Kubernetes.GetAllNamespaces, kubernetes.go)

    def get_all_namespaces(self) -> List[KubeNamespace]:
        d = self._get_json(["get", "namespaces"])
        return [
            KubeNamespace(
                name=item["metadata"]["name"],
                labels=item["metadata"].get("labels") or {},
            )
            for item in d.get("items", [])
        ]

    def get_pods_all_namespaces(self) -> List[KubePod]:
        d = self._get_json(["get", "pods", "--all-namespaces"])
        return [_pod_from_json(item) for item in d.get("items", [])]

    # exec

    def execute_remote_command(
        self, namespace: str, pod: str, container: str, command: List[str]
    ) -> Tuple[str, str, Optional[str]]:
        proc = subprocess.run(
            self._base()
            + ["exec", pod, "-c", container, "-n", namespace, "--"]
            + command,
            input="",  # closed stdin; see _run
            capture_output=True,
            text=True,
            timeout=60,
        )
        if proc.returncode != 0:
            return proc.stdout, proc.stderr, proc.stderr.strip() or "command failed"
        return proc.stdout, proc.stderr, None


def _container_manifest(c: KubeContainer) -> dict:
    port = c.ports[0] if c.ports else None
    manifest: dict = {
        "name": c.name,
        "imagePullPolicy": "IfNotPresent",
        "image": c.image or AGNHOST_IMAGE,
        "securityContext": {},
    }
    if port is not None:
        proto = port.protocol
        if proto == "TCP":
            manifest["command"] = [
                "/agnhost", "serve-hostname", "--tcp", "--http=false",
                "--port", str(port.container_port),
            ]
        elif proto == "UDP":
            manifest["command"] = [
                "/agnhost", "serve-hostname", "--udp", "--http=false",
                "--port", str(port.container_port),
            ]
        elif proto == "SCTP":
            manifest["env"] = [
                {"name": f"SERVE_SCTP_PORT_{port.container_port}", "value": "foo"}
            ]
            manifest["command"] = ["/agnhost", "porter"]
        manifest["ports"] = [
            {
                "containerPort": port.container_port,
                "name": port.name,
                "protocol": port.protocol,
            }
        ]
    return manifest


def _pod_from_json(d: dict) -> KubePod:
    containers = []
    for c in d.get("spec", {}).get("containers", []):
        containers.append(
            KubeContainer(
                name=c["name"],
                image=c.get("image", ""),
                ports=[
                    KubeContainerPort(
                        container_port=p["containerPort"],
                        name=p.get("name", ""),
                        protocol=p.get("protocol", "TCP"),
                    )
                    for p in c.get("ports", [])
                ],
            )
        )
    status = d.get("status", {})
    return KubePod(
        namespace=d["metadata"]["namespace"],
        name=d["metadata"]["name"],
        labels=d["metadata"].get("labels") or {},
        containers=containers,
        phase=status.get("phase", ""),
        pod_ip=status.get("podIP", ""),
    )
