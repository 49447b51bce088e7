"""Pod/Container model for probes (reference: probe/pod.go)."""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Dict, List

from ..kube.objects import (
    KubeContainer,
    KubeContainerPort,
    KubePod,
    KubeService,
    KubeServicePort,
)
from ..kube.protocol import qualified_service_address
from .podstring import PodString
from .probeconfig import (
    PROBE_MODE_POD_IP,
    PROBE_MODE_SERVICE_IP,
    PROBE_MODE_SERVICE_NAME,
    ProbeMode,
)

from ..images import AGNHOST_IMAGE, WORKER_IMAGE  # noqa: F401  (re-export)


@dataclass
class Container:
    """One serving container: a single (port, protocol) with a derived name
    (pod.go:173-189)."""

    name: str
    port: int
    protocol: str
    port_name: str
    batch_jobs: bool = False

    @staticmethod
    def default(port: int, protocol: str, batch_jobs: bool = False) -> "Container":
        proto = protocol.lower()
        return Container(
            name=f"cont-{port}-{proto}",
            port=port,
            protocol=protocol,
            port_name=f"serve-{port}-{proto}",
            batch_jobs=batch_jobs,
        )

    def image(self) -> str:
        return WORKER_IMAGE if self.batch_jobs else AGNHOST_IMAGE

    def kube_container(self) -> KubeContainer:
        return KubeContainer(
            name=self.name,
            image=self.image(),
            ports=[
                KubeContainerPort(
                    container_port=self.port,
                    name=self.port_name,
                    protocol=self.protocol,
                )
            ],
        )

    def kube_service_port(self) -> KubeServicePort:
        return KubeServicePort(
            port=self.port,
            name=f"service-port-{self.protocol.lower()}-{self.port}",
            protocol=self.protocol,
        )


@dataclass
class Pod:
    """probe/pod.go:44-51."""

    namespace: str
    name: str
    labels: Dict[str, str] = field(default_factory=dict)
    service_ip: str = ""
    ip: str = ""
    containers: List[Container] = field(default_factory=list)

    @staticmethod
    def default(
        ns: str,
        name: str,
        ports: List[int],
        protocols: List[str],
        batch_jobs: bool = False,
    ) -> "Pod":
        """One container per port x protocol; labels {pod: name}
        (pod.go:28-42)."""
        containers = [
            Container.default(port, protocol, batch_jobs)
            for port in ports
            for protocol in protocols
        ]
        return Pod(
            namespace=ns,
            name=name,
            labels={"pod": name},
            ip="TODO",
            containers=containers,
        )

    def host(self, probe_mode: ProbeMode) -> str:
        """pod.go:53-64."""
        if probe_mode == PROBE_MODE_SERVICE_NAME:
            return qualified_service_address(self.service_name(), self.namespace)
        if probe_mode == PROBE_MODE_POD_IP:
            return self.ip
        if probe_mode == PROBE_MODE_SERVICE_IP:
            return self.service_ip
        raise ValueError(f"invalid mode {probe_mode}")

    def service_name(self) -> str:
        return f"s-{self.namespace}-{self.name}"

    def kube_pod(self) -> KubePod:
        return KubePod(
            namespace=self.namespace,
            name=self.name,
            labels=dict(self.labels),
            containers=[c.kube_container() for c in self.containers],
        )

    def kube_service(self) -> KubeService:
        return KubeService(
            namespace=self.namespace,
            name=self.service_name(),
            selector=dict(self.labels),
            ports=[c.kube_service_port() for c in self.containers],
        )

    def is_equal_to_kube_pod(self, kube_pod: KubePod) -> bool:
        """Container port/protocol equality (pod.go:66-85)."""
        if len(kube_pod.containers) != len(self.containers):
            return False
        for kube_cont, cont in zip(kube_pod.containers, self.containers):
            if len(kube_cont.ports) != 1:
                return False
            if kube_cont.ports[0].container_port != cont.port:
                return False
            if kube_cont.ports[0].protocol != cont.protocol:
                return False
        return True

    def resolve_named_port(self, port: str) -> int:
        """pod.go:132-139; raises if unresolvable."""
        for c in self.containers:
            if c.port_name == port:
                return c.port
        raise ValueError(
            f"unable to resolve named port {port} on pod {self.namespace}/{self.name}"
        )

    def resolve_numbered_port(self, port: int) -> str:
        """pod.go:141-148."""
        for c in self.containers:
            if c.port == port:
                return c.port_name
        raise ValueError(
            f"unable to resolve numbered port {port} on pod "
            f"{self.namespace}/{self.name}"
        )

    def is_serving_port_protocol(self, port: int, protocol: str) -> bool:
        return any(c.port == port and c.protocol == protocol for c in self.containers)

    def set_labels(self, labels: Dict[str, str]) -> "Pod":
        """Immutable update (pod.go:159-167)."""
        return replace(self, labels=dict(labels))

    def pod_string(self) -> PodString:
        return PodString.make(self.namespace, self.name)
