"""Cluster model for probes with immutable perturbation updates and the
pod x pod x port job fan-out (reference: probe/resources.go)."""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List

from ..kube.ikubernetes import IKubernetes, KubeError, get_pods_in_namespaces
from ..kube.netpol import IntOrString
from ..kube.objects import KubeNamespace
from ..utils.table import render_table
from .job import Job, Jobs
from .pod import Pod
from .probeconfig import ProbeConfig, ProbeMode


@dataclass
class Resources:
    """resources.go:15-19."""

    namespaces: Dict[str, Dict[str, str]] = field(default_factory=dict)
    pods: List[Pod] = field(default_factory=list)

    # ------------------------------------------------------------------
    # construction against a cluster
    # ------------------------------------------------------------------

    @staticmethod
    def new_default(
        kubernetes: IKubernetes,
        namespaces: List[str],
        pod_names: List[str],
        ports: List[int],
        protocols: List[str],
        pod_creation_timeout_seconds: int = 60,
        batch_jobs: bool = False,
    ) -> "Resources":
        """Create the ns x pod grid in the cluster, wait ready, harvest IPs
        (resources.go:21-46)."""
        r = Resources(
            namespaces={ns: {"ns": ns} for ns in namespaces},
            pods=[
                Pod.default(ns, name, ports, protocols, batch_jobs)
                for ns in namespaces
                for name in pod_names
            ],
        )
        r.create_resources_in_kube(kubernetes)
        r.wait_for_pods_ready(kubernetes, pod_creation_timeout_seconds)
        r.get_pod_ips_from_kube(kubernetes)
        return r

    def create_resources_in_kube(self, kubernetes: IKubernetes) -> None:
        """Idempotent creation (resources.go:240-268)."""
        for ns, labels in self.namespaces.items():
            try:
                kubernetes.get_namespace(ns)
            except KubeError:
                kubernetes.create_namespace(KubeNamespace(name=ns, labels=dict(labels)))
        for pod in self.pods:
            try:
                kubernetes.get_pod(pod.namespace, pod.name)
            except KubeError:
                kubernetes.create_pod(pod.kube_pod())
            service = pod.kube_service()
            try:
                kubernetes.get_service(service.namespace, service.name)
            except KubeError:
                kubernetes.create_service(service)

    def wait_for_pods_ready(
        self, kubernetes: IKubernetes, timeout_seconds: int, sleep_seconds: int = 5
    ) -> None:
        """resources.go:48-70."""
        elapsed = 0
        while True:
            pod_list = get_pods_in_namespaces(kubernetes, self.namespaces_slice())
            ready = sum(
                1 for p in pod_list if p.phase == "Running" and p.pod_ip != ""
            )
            if ready == len(self.pods):
                return
            if elapsed >= timeout_seconds:
                raise KubeError("pods not ready")
            time.sleep(sleep_seconds)
            elapsed += sleep_seconds

    def get_pod_ips_from_kube(self, kubernetes: IKubernetes) -> None:
        """resources.go:72-98."""
        pod_list = get_pods_in_namespaces(kubernetes, self.namespaces_slice())
        for kube_pod in pod_list:
            if kube_pod.pod_ip == "":
                raise KubeError(
                    f"no ip found for pod {kube_pod.namespace}/{kube_pod.name}"
                )
            pod = self.get_pod(kube_pod.namespace, kube_pod.name)
            pod.ip = kube_pod.pod_ip
            service = kubernetes.get_service(pod.namespace, pod.service_name())
            pod.service_ip = service.cluster_ip

    def get_pod(self, ns: str, name: str) -> Pod:
        for pod in self.pods:
            if pod.namespace == ns and pod.name == name:
                return pod
        raise KubeError(f"unable to find pod {ns}/{name}")

    # ------------------------------------------------------------------
    # immutable perturbation updates (resources.go:110-221)
    # ------------------------------------------------------------------

    def create_namespace(self, ns: str, labels: Dict[str, str]) -> "Resources":
        if ns in self.namespaces:
            raise KubeError(f"namespace {ns} already found")
        new_namespaces = dict(self.namespaces)
        new_namespaces[ns] = labels
        return Resources(namespaces=new_namespaces, pods=self.pods)

    def update_namespace_labels(self, ns: str, labels: Dict[str, str]) -> "Resources":
        if ns not in self.namespaces:
            raise KubeError(f"namespace {ns} not found")
        new_namespaces = dict(self.namespaces)
        new_namespaces[ns] = labels
        return Resources(namespaces=new_namespaces, pods=self.pods)

    def delete_namespace(self, ns: str) -> "Resources":
        if ns not in self.namespaces:
            raise KubeError(f"namespace {ns} not found")
        new_namespaces = {k: v for k, v in self.namespaces.items() if k != ns}
        return Resources(
            namespaces=new_namespaces,
            pods=[p for p in self.pods if p.namespace != ns],
        )

    def create_pod(self, ns: str, name: str, labels: Dict[str, str]) -> "Resources":
        """New pods copy the first pod's containers (resources.go:166-178
        TODO preserved)."""
        if ns not in self.namespaces:
            raise KubeError(f"can't find namespace {ns}")
        new_pod = Pod(
            namespace=ns,
            name=name,
            labels=dict(labels),
            ip="TODO",
            containers=self.pods[0].containers,
        )
        return Resources(namespaces=self.namespaces, pods=self.pods + [new_pod])

    def set_pod_labels(self, ns: str, name: str, labels: Dict[str, str]) -> "Resources":
        found = False
        pods = []
        for pod in self.pods:
            if pod.namespace == ns and pod.name == name:
                found = True
                pods.append(pod.set_labels(labels))
            else:
                pods.append(pod)
        if not found:
            raise KubeError(f"no pod named {ns}/{name} found")
        return Resources(namespaces=self.namespaces, pods=pods)

    def delete_pod(self, ns: str, name: str) -> "Resources":
        found = False
        pods = []
        for pod in self.pods:
            if pod.namespace == ns and pod.name == name:
                found = True
            else:
                pods.append(pod)
        if not found:
            raise KubeError(f"pod {ns}/{name} not found")
        return Resources(namespaces=self.namespaces, pods=pods)

    # ------------------------------------------------------------------
    # views
    # ------------------------------------------------------------------

    def sorted_pod_names(self) -> List[str]:
        return sorted(str(pod.pod_string()) for pod in self.pods)

    def namespaces_slice(self) -> List[str]:
        return list(self.namespaces)

    def render_table(self) -> str:
        """resource-printer.go:11-69."""
        rows = []
        for ns in sorted(self.namespaces):
            ns_labels = self.namespaces[ns]
            for pod in sorted(
                (p for p in self.pods if p.namespace == ns), key=lambda p: p.name
            ):
                for cont in pod.containers:
                    rows.append(
                        [
                            ns,
                            " ".join(f"{k}: {v}" for k, v in sorted(ns_labels.items())),
                            pod.name,
                            " ".join(f"{k}: {v}" for k, v in sorted(pod.labels.items())),
                            pod.ip,
                            cont.name,
                            f"{cont.port}/{cont.protocol}",
                        ]
                    )
        return render_table(
            ["Namespace", "NS Labels", "Pod", "Pod Labels", "IP", "Container", "Port/Protocol"],
            rows,
        )

    # ------------------------------------------------------------------
    # job fan-out (resources.go:274-364)
    # ------------------------------------------------------------------

    def get_jobs_for_probe_config(self, config: ProbeConfig) -> Jobs:
        if config.all_available:
            return self.get_jobs_all_available_servers(config.mode)
        if config.port_protocol is not None:
            return self.get_jobs_for_named_port_protocol(
                config.port_protocol.port, config.port_protocol.protocol, config.mode
            )
        raise ValueError(f"invalid ProbeConfig {config!r}")

    def _base_job(self, pod_from: Pod, pod_to: Pod, mode: ProbeMode) -> Job:
        return Job(
            from_key=str(pod_from.pod_string()),
            from_namespace=pod_from.namespace,
            from_namespace_labels=self.namespaces.get(pod_from.namespace, {}),
            from_pod=pod_from.name,
            from_pod_labels=pod_from.labels,
            from_container=pod_from.containers[0].name,
            from_ip=pod_from.ip,
            to_key=str(pod_to.pod_string()),
            to_host=pod_to.host(mode),
            to_namespace=pod_to.namespace,
            to_namespace_labels=self.namespaces.get(pod_to.namespace, {}),
            to_pod_labels=pod_to.labels,
            to_ip=pod_to.ip,
        )

    def get_jobs_for_named_port_protocol(
        self, port: IntOrString, protocol: str, mode: ProbeMode
    ) -> Jobs:
        """Named/numbered port resolution per destination pod; unresolvable
        combos sort into the Bad* buckets.  The named-port protocol TODOs at
        resources.go:311/319 are intentional behavior to preserve."""
        jobs = Jobs()
        for pod_from in self.pods:
            for pod_to in self.pods:
                job = self._base_job(pod_from, pod_to, mode)
                job.resolved_port = -1
                job.resolved_port_name = ""
                job.protocol = protocol

                if port.is_string:
                    job.resolved_port_name = port.str_value
                    try:
                        job.resolved_port = pod_to.resolve_named_port(port.str_value)
                    except ValueError:
                        jobs.bad_named_port.append(job)
                        continue
                else:
                    job.resolved_port = port.int_value
                    try:
                        job.resolved_port_name = pod_to.resolve_numbered_port(
                            port.int_value
                        )
                    except ValueError:
                        jobs.bad_port_protocol.append(job)
                        continue
                jobs.valid.append(job)
        return jobs

    def get_jobs_all_available_servers(self, mode: ProbeMode) -> Jobs:
        """One job per (from pod, to pod, to serving container)
        (resources.go:336-364)."""
        jobs = []
        for pod_from in self.pods:
            for pod_to in self.pods:
                for cont_to in pod_to.containers:
                    job = self._base_job(pod_from, pod_to, mode)
                    job.to_container = cont_to.name
                    job.resolved_port = cont_to.port
                    job.resolved_port_name = cont_to.port_name
                    job.protocol = cont_to.protocol
                    jobs.append(job)
        return Jobs(valid=jobs)
