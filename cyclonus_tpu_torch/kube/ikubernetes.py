"""The cluster interface and the in-memory fake cluster
(reference: pkg/kube/ikubernetes.go).

``IKubernetes`` is the process/cluster boundary: everything above it (probe
fan-out, interpreter, generator) is cluster-agnostic.  ``MockKubernetes`` is
the key integration fixture — it implements the full interface in memory with
deterministic pod IPs and a pass-rate-random exec stub, so the entire
conformance pipeline runs clusterless (`generate --mock`).

Differences from the reference, on purpose:
  * pod IPs are allocated over 192.168.0.0/16 instead of a single /24, so the
    mock scales to ~65k pods instead of 254 (ikubernetes.go:292-297 panics at
    255) — needed for TPU-scale synthetic benchmarks.
  * errors are raised as ``KubeError`` instead of returned.
"""

from __future__ import annotations

import dataclasses
import random
from typing import Callable, Dict, List, Optional, Tuple

from .netpol import NetworkPolicy
from .objects import KubeNamespace, KubePod, KubeService


class KubeError(Exception):
    """Cluster-interaction failure (the reference's returned error)."""


class IKubernetes:
    """18-method cluster interface (ikubernetes.go:11-35)."""

    # namespaces
    def create_namespace(self, ns: KubeNamespace) -> KubeNamespace:
        raise NotImplementedError

    def get_namespace(self, namespace: str) -> KubeNamespace:
        raise NotImplementedError

    def set_namespace_labels(self, namespace: str, labels: Dict[str, str]) -> KubeNamespace:
        raise NotImplementedError

    def delete_namespace(self, namespace: str) -> None:
        raise NotImplementedError

    # network policies
    def create_network_policy(self, policy: NetworkPolicy) -> NetworkPolicy:
        raise NotImplementedError

    def get_network_policies_in_namespace(self, namespace: str) -> List[NetworkPolicy]:
        raise NotImplementedError

    def update_network_policy(self, policy: NetworkPolicy) -> NetworkPolicy:
        raise NotImplementedError

    def delete_network_policy(self, namespace: str, name: str) -> None:
        raise NotImplementedError

    def delete_all_network_policies_in_namespace(self, namespace: str) -> None:
        raise NotImplementedError

    # services
    def create_service(self, service: KubeService) -> KubeService:
        raise NotImplementedError

    def get_service(self, namespace: str, name: str) -> KubeService:
        raise NotImplementedError

    def delete_service(self, namespace: str, name: str) -> None:
        raise NotImplementedError

    def get_services_in_namespace(self, namespace: str) -> List[KubeService]:
        raise NotImplementedError

    # pods
    def create_pod(self, pod: KubePod) -> KubePod:
        raise NotImplementedError

    def get_pod(self, namespace: str, pod: str) -> KubePod:
        raise NotImplementedError

    def delete_pod(self, namespace: str, pod: str) -> None:
        raise NotImplementedError

    def set_pod_labels(self, namespace: str, pod: str, labels: Dict[str, str]) -> KubePod:
        raise NotImplementedError

    def get_pods_in_namespace(self, namespace: str) -> List[KubePod]:
        raise NotImplementedError

    # exec
    def execute_remote_command(
        self, namespace: str, pod: str, container: str, command: List[str]
    ) -> Tuple[str, str, Optional[str]]:
        """Returns (stdout, stderr, command_error).  command_error is None on
        success; a setup failure raises KubeError (mirroring the reference's
        two distinct error returns, ikubernetes.go:34)."""
        raise NotImplementedError


# module-level helpers (ikubernetes.go:37-81)

def get_network_policies_in_namespaces(
    kubernetes: IKubernetes, namespaces: List[str]
) -> List[NetworkPolicy]:
    out: List[NetworkPolicy] = []
    for ns in namespaces:
        out.extend(kubernetes.get_network_policies_in_namespace(ns))
    return out


def delete_all_network_policies_in_namespaces(
    kubernetes: IKubernetes, namespaces: List[str]
) -> None:
    for ns in namespaces:
        kubernetes.delete_all_network_policies_in_namespace(ns)


def get_pods_in_namespaces(
    kubernetes: IKubernetes, namespaces: List[str]
) -> List[KubePod]:
    out: List[KubePod] = []
    for ns in namespaces:
        out.extend(kubernetes.get_pods_in_namespace(ns))
    return out


def get_services_in_namespaces(
    kubernetes: IKubernetes, namespaces: List[str]
) -> List[KubeService]:
    out: List[KubeService] = []
    for ns in namespaces:
        out.extend(kubernetes.get_services_in_namespace(ns))
    return out


class MockNamespace:
    def __init__(self, obj: KubeNamespace):
        self.namespace_object = obj
        self.netpols: Dict[str, NetworkPolicy] = {}
        self.pods: Dict[str, KubePod] = {}
        self.services: Dict[str, KubeService] = {}


class MockKubernetes(IKubernetes):
    """In-memory fake cluster (ikubernetes.go:83-340)."""

    MAX_PODS = 65534  # 192.168.0.0/16 minus network/broadcast

    def __init__(self, pass_rate: float = 1.0, seed: Optional[int] = None):
        self.namespaces: Dict[str, MockNamespace] = {}
        self.pass_rate = pass_rate
        self._pod_id = 1
        self._service_id = 0
        self._rng = random.Random(seed)
        # bumped on every netpol mutation; lets policy-aware exec hooks
        # cache their compiled policy (see kube.mockcni)
        self.policy_rev = 0
        # Optional policy-aware exec hook with signature
        # (namespace, pod, container, command) -> bool (True = connect
        # succeeded) OR a full (stdout, stderr, command_error) tuple; when
        # set, exec verdicts come from it instead of pass_rate.
        self.exec_verdict_fn: Optional[Callable[[str, str, str, List[str]], object]] = None

    def _ns(self, namespace: str) -> MockNamespace:
        if namespace in self.namespaces:
            return self.namespaces[namespace]
        raise KubeError(f"namespace {namespace} not found")

    # namespaces

    def create_namespace(self, ns: KubeNamespace) -> KubeNamespace:
        if ns.name in self.namespaces:
            raise KubeError(f"namespace {ns.name} already present")
        self.namespaces[ns.name] = MockNamespace(ns)
        return ns

    def get_namespace(self, namespace: str) -> KubeNamespace:
        return self._ns(namespace).namespace_object

    def set_namespace_labels(self, namespace: str, labels: Dict[str, str]) -> KubeNamespace:
        obj = self.get_namespace(namespace)
        obj.labels = dict(labels)
        return obj

    def delete_namespace(self, namespace: str) -> None:
        ns = self._ns(namespace)
        # dropping a namespace drops its policies: policy-aware exec
        # hooks cache their compiled policy keyed on this rev (mockcni,
        # loopback) and would otherwise keep enforcing ghost policies
        if ns.netpols:
            self.policy_rev += 1
        del self.namespaces[namespace]

    # network policies

    def create_network_policy(self, policy: NetworkPolicy) -> NetworkPolicy:
        ns = self._ns(policy.namespace)
        if policy.name in ns.netpols:
            raise KubeError(
                f"network policy {policy.namespace}/{policy.name} already present"
            )
        ns.netpols[policy.name] = policy
        self.policy_rev += 1
        return policy

    def get_network_policies_in_namespace(self, namespace: str) -> List[NetworkPolicy]:
        return list(self._ns(namespace).netpols.values())

    def update_network_policy(self, policy: NetworkPolicy) -> NetworkPolicy:
        ns = self._ns(policy.namespace)
        if policy.name not in ns.netpols:
            raise KubeError(
                f"network policy {policy.namespace}/{policy.name} not found"
            )
        ns.netpols[policy.name] = policy
        self.policy_rev += 1
        return policy

    def delete_network_policy(self, namespace: str, name: str) -> None:
        ns = self._ns(namespace)
        if name not in ns.netpols:
            raise KubeError(f"network policy {namespace}/{name} not found")
        del ns.netpols[name]
        self.policy_rev += 1

    def delete_all_network_policies_in_namespace(self, namespace: str) -> None:
        self._ns(namespace).netpols = {}
        self.policy_rev += 1

    # services

    def create_service(self, service: KubeService) -> KubeService:
        ns = self._ns(service.namespace)
        if service.name in ns.services:
            raise KubeError(
                f"service {service.namespace}/{service.name} already present"
            )
        if not service.cluster_ip:
            # a real apiserver allocates a ClusterIP on a COPY — the
            # caller's object must not mutate (a re-submit of the same
            # object would otherwise carry the stale IP)
            self._service_id += 1
            service = dataclasses.replace(
                service,
                cluster_ip=(
                    f"10.96.{self._service_id // 256}.{self._service_id % 256}"
                ),
            )
        ns.services[service.name] = service
        return service

    def get_service(self, namespace: str, name: str) -> KubeService:
        ns = self._ns(namespace)
        if name in ns.services:
            return ns.services[name]
        raise KubeError(f"service {namespace}/{name} not found")

    def delete_service(self, namespace: str, name: str) -> None:
        ns = self._ns(namespace)
        if name not in ns.services:
            raise KubeError(f"service {namespace}/{name} not found")
        del ns.services[name]

    def get_services_in_namespace(self, namespace: str) -> List[KubeService]:
        return list(self._ns(namespace).services.values())

    # pods

    def create_pod(self, pod: KubePod) -> KubePod:
        ns = self._ns(pod.namespace)
        if pod.name in ns.pods:
            raise KubeError(f"pod {pod.namespace}/{pod.name} already exists")
        if self._pod_id > self.MAX_PODS:
            raise KubeError(f"unable to handle more than {self.MAX_PODS} pods in mock")
        pod.phase = "Running"
        pod.pod_ip = f"192.168.{self._pod_id // 256}.{self._pod_id % 256}"
        self._pod_id += 1
        ns.pods[pod.name] = pod
        return pod

    def get_pod(self, namespace: str, pod: str) -> KubePod:
        ns = self._ns(namespace)
        if pod in ns.pods:
            return ns.pods[pod]
        raise KubeError(f"pod {namespace}/{pod} not found")

    def delete_pod(self, namespace: str, pod: str) -> None:
        ns = self._ns(namespace)
        if pod not in ns.pods:
            raise KubeError(f"pod {namespace}/{pod} not found")
        del ns.pods[pod]

    def set_pod_labels(self, namespace: str, pod: str, labels: Dict[str, str]) -> KubePod:
        obj = self.get_pod(namespace, pod)
        obj.labels = dict(labels)
        return obj

    def get_pods_in_namespace(self, namespace: str) -> List[KubePod]:
        return list(self._ns(namespace).pods.values())

    # cluster-wide reads (on the concrete backends, not IKubernetes,
    # mirroring the reference where GetAllNamespaces lives on
    # kube.Kubernetes rather than the interface — kubernetes.go)

    def get_all_namespaces(self) -> List[KubeNamespace]:
        return [m.namespace_object for m in self.namespaces.values()]

    def get_pods_all_namespaces(self) -> List[KubePod]:
        return [p for m in self.namespaces.values() for p in m.pods.values()]

    # exec

    def execute_remote_command(
        self, namespace: str, pod: str, container: str, command: List[str]
    ) -> Tuple[str, str, Optional[str]]:
        ns = self._ns(namespace)
        if pod not in ns.pods:
            raise KubeError(f"pod {namespace}/{pod} not found")
        pod_obj = ns.pods[pod]
        if not any(c.name == container for c in pod_obj.containers):
            raise KubeError(f"container {namespace}/{pod}/{container} not found")
        if self.exec_verdict_fn is not None:
            verdict = self.exec_verdict_fn(namespace, pod, container, command)
            if isinstance(verdict, tuple):
                # hook speaks the full (stdout, stderr, command_error)
                # protocol (e.g. the /worker batch prober)
                return verdict
            return ("", "", None if verdict else "mock verdict: blocked")
        if self._rng.random() > self.pass_rate:
            return ("", "", "mock call randomly failed")
        return ("", "", None)
