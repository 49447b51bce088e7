"""TestCaseState: the mirror of the cluster during a test — every action is
dual-written to the in-memory model AND the cluster
(reference: connectivity/testcasestate.go)."""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List

from ..kube.ikubernetes import (
    IKubernetes,
    KubeError,
    delete_all_network_policies_in_namespaces,
    get_network_policies_in_namespaces,
    get_pods_in_namespaces,
)
from ..kube.netpol import NetworkPolicy
from ..kube.objects import KubeNamespace
from ..probe.resources import Resources


@dataclass
class LabelsDiff:
    """testcasestate.go:251-289."""

    same: List[str] = field(default_factory=list)
    different: List[str] = field(default_factory=list)
    extra: List[str] = field(default_factory=list)
    missing: List[str] = field(default_factory=list)

    @staticmethod
    def compare(actual: Dict[str, str], expected: Dict[str, str]) -> "LabelsDiff":
        ld = LabelsDiff()
        for k, actual_value in actual.items():
            if k not in expected:
                ld.extra.append(k)
            elif actual_value != expected[k]:
                ld.different.append(k)
            else:
                ld.same.append(k)
        for k in expected:
            if k not in actual:
                ld.missing.append(k)
        return ld

    def are_labels_equal(self) -> bool:
        return not self.different and not self.extra and not self.missing

    def are_all_expected_labels_present(self) -> bool:
        return not self.different and not self.missing


class TestCaseState:
    __test__ = False  # not a pytest class

    def __init__(
        self,
        kubernetes: IKubernetes,
        resources: Resources,
        policies: List[NetworkPolicy] = None,
        pod_wait_timeout_seconds: int = 60,
        pod_wait_sleep_seconds: int = 5,
    ):
        self.kubernetes = kubernetes
        self.resources = resources
        self.policies: List[NetworkPolicy] = list(policies or [])
        self.pod_wait_timeout_seconds = pod_wait_timeout_seconds
        self.pod_wait_sleep_seconds = pod_wait_sleep_seconds

    # --- policies ---

    def create_policy(self, policy: NetworkPolicy) -> None:
        for kube_pol in self.policies:
            if (
                kube_pol.namespace == policy.namespace
                and kube_pol.name == policy.name
            ):
                raise KubeError(
                    f"cannot create policy {policy.namespace}/{policy.name}: "
                    f"already exists"
                )
        self.policies.append(policy)
        self.kubernetes.create_network_policy(policy)

    def update_policy(self, policy: NetworkPolicy) -> None:
        for i, kube_pol in enumerate(self.policies):
            if (
                kube_pol.namespace == policy.namespace
                and kube_pol.name == policy.name
            ):
                self.policies[i] = policy
                self.kubernetes.update_network_policy(policy)
                return
        raise KubeError(
            f"cannot update policy {policy.namespace}/{policy.name}: not found"
        )

    def delete_policy(self, ns: str, name: str) -> None:
        index = -1
        for i, kube_pol in enumerate(self.policies):
            if kube_pol.namespace == ns and kube_pol.name == name:
                index = i
        if index == -1:
            raise KubeError(f"cannot delete policy {ns}/{name}: not found")
        self.policies = [p for i, p in enumerate(self.policies) if i != index]
        self.kubernetes.delete_network_policy(ns, name)

    def read_policies(self, namespaces: List[str]) -> None:
        self.policies.extend(
            get_network_policies_in_namespaces(self.kubernetes, namespaces)
        )

    # --- namespaces ---

    def create_namespace(self, ns: str, labels: Dict[str, str]) -> None:
        self.resources = self.resources.create_namespace(ns, labels)
        self.kubernetes.create_namespace(KubeNamespace(name=ns, labels=dict(labels)))

    def set_namespace_labels(self, ns: str, labels: Dict[str, str]) -> None:
        self.resources = self.resources.update_namespace_labels(ns, labels)
        self.kubernetes.set_namespace_labels(ns, labels)

    def delete_namespace(self, ns: str) -> None:
        self.resources = self.resources.delete_namespace(ns)
        self.kubernetes.delete_namespace(ns)

    # --- pods ---

    def create_pod(self, ns: str, pod: str, labels: Dict[str, str]) -> None:
        """Dual-create then wait-for-IP loop (testcasestate.go:81-112)."""
        self.resources = self.resources.create_pod(ns, pod, labels)
        new_pod = self.resources.get_pod(ns, pod)
        self.kubernetes.create_pod(new_pod.kube_pod())
        self.kubernetes.create_service(new_pod.kube_service())
        deadline = max(1, self.pod_wait_timeout_seconds // self.pod_wait_sleep_seconds)
        for _attempt in range(deadline):
            kube_pod = self.kubernetes.get_pod(ns, pod)
            if kube_pod.phase == "Running" and kube_pod.pod_ip != "":
                new_pod.ip = kube_pod.pod_ip
                return
            time.sleep(self.pod_wait_sleep_seconds)
        raise KubeError(
            f"unable to wait for running or get pod ip for {ns}/{pod} after creation"
        )

    def set_pod_labels(self, ns: str, pod: str, labels: Dict[str, str]) -> None:
        self.resources = self.resources.set_pod_labels(ns, pod, labels)
        self.kubernetes.set_pod_labels(ns, pod, labels)

    def delete_pod(self, ns: str, pod: str) -> None:
        deleted_pod = self.resources.get_pod(ns, pod)
        self.resources = self.resources.delete_pod(ns, pod)
        self.kubernetes.delete_service(ns, deleted_pod.kube_service().name)
        self.kubernetes.delete_pod(ns, pod)

    # --- reset / verify (testcasestate.go:291-331) ---

    def reset_cluster_state(self) -> None:
        delete_all_network_policies_in_namespaces(
            self.kubernetes, self.resources.namespaces_slice()
        )
        for ns, labels in self.resources.namespaces.items():
            self.kubernetes.set_namespace_labels(ns, labels)
        for pod in self.resources.pods:
            self.kubernetes.set_pod_labels(pod.namespace, pod.name, pod.labels)

    def verify_cluster_state(self) -> None:
        self._verify_cluster_state_helper()
        policies = get_network_policies_in_namespaces(
            self.kubernetes, self.resources.namespaces_slice()
        )
        if policies:
            raise KubeError(
                f"expected 0 policies in namespaces "
                f"{self.resources.namespaces_slice()}, found {len(policies)}"
            )

    def _verify_cluster_state_helper(self) -> None:
        """Deep-compare pods/services/namespaces (testcasestate.go:183-249)."""
        kube_pods = get_pods_in_namespaces(
            self.kubernetes, self.resources.namespaces_slice()
        )
        actual_pods = {f"{p.namespace}/{p.name}": p for p in kube_pods}

        for expected_pod in self.resources.pods:
            key = str(expected_pod.pod_string())
            if key not in actual_pods:
                raise KubeError(f"missing expected pod {key}")
            actual = actual_pods[key]
            if not LabelsDiff.compare(actual.labels, expected_pod.labels).are_labels_equal():
                raise KubeError(
                    f"for pod {key}, expected labels {expected_pod.labels} "
                    f"(found {actual.labels})"
                )
            if actual.pod_ip != expected_pod.ip:
                raise KubeError(
                    f"for pod {key}, expected ip {expected_pod.ip} "
                    f"(found {actual.pod_ip})"
                )
            if not expected_pod.is_equal_to_kube_pod(actual):
                raise KubeError(
                    f"for pod {key}, expected containers "
                    f"{expected_pod.containers} (found {actual.containers})"
                )

        for expected_pod in self.resources.pods:
            expected_svc = expected_pod.kube_service()
            svc = self.kubernetes.get_service(expected_svc.namespace, expected_svc.name)
            if not LabelsDiff.compare(svc.selector, expected_pod.labels).are_labels_equal():
                raise KubeError(
                    f"for service {expected_pod.namespace}/{expected_pod.name}, "
                    f"expected labels {expected_pod.labels} (found {svc.selector})"
                )
            if len(expected_svc.ports) != len(svc.ports):
                raise KubeError(
                    f"for service {expected_svc.namespace}/{expected_svc.name}, "
                    f"expected {len(expected_svc.ports)} ports (found {len(svc.ports)})"
                )
            for expected_port, kube_port in zip(expected_svc.ports, svc.ports):
                if (
                    kube_port.protocol != expected_port.protocol
                    or kube_port.port != expected_port.port
                ):
                    raise KubeError(
                        f"for service {expected_svc.namespace}/{expected_svc.name}, "
                        f"expected port {expected_port} (found {kube_port})"
                    )

        for ns, expected_labels in self.resources.namespaces.items():
            namespace = self.kubernetes.get_namespace(ns)
            diff = LabelsDiff.compare(namespace.labels, expected_labels)
            if not diff.are_all_expected_labels_present():
                raise KubeError(
                    f"for namespace {ns}, expected labels {expected_labels} "
                    f"(found {namespace.labels})"
                )
