"""Probe work items (reference: probe/job.go).  Job.traffic() is the bridge
from the probe layer (L3) to the matcher (L2)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..matcher.core import InternalPeer, Traffic, TrafficPeer
from .connectivity import Connectivity


@dataclass
class Job:
    """job.go:27-47."""

    from_key: str = ""
    from_namespace: str = ""
    from_namespace_labels: Dict[str, str] = field(default_factory=dict)
    from_pod: str = ""
    from_pod_labels: Dict[str, str] = field(default_factory=dict)
    from_container: str = ""
    from_ip: str = ""

    to_key: str = ""
    to_host: str = ""
    to_namespace: str = ""
    to_namespace_labels: Dict[str, str] = field(default_factory=dict)
    to_pod_labels: Dict[str, str] = field(default_factory=dict)
    to_container: str = ""
    to_ip: str = ""

    resolved_port: int = -1
    resolved_port_name: str = ""
    protocol: str = "TCP"

    def key(self) -> str:
        """job.go:49-51."""
        return (
            f"{self.from_key}/{self.from_container}/{self.to_key}/"
            f"{self.to_container}/{self.protocol}/{self.resolved_port}"
        )

    def to_address(self) -> str:
        return f"{self.to_host}:{self.resolved_port}"

    def client_command(self) -> List[str]:
        """The agnhost connect invocation (job.go:57-68)."""
        proto = self.protocol.lower()
        if proto not in ("tcp", "udp", "sctp"):
            raise ValueError(f"protocol {self.protocol} not supported")
        return [
            "/agnhost",
            "connect",
            self.to_address(),
            "--timeout=1s",
            f"--protocol={proto}",
        ]

    def kube_exec_command(self) -> List[str]:
        return [
            "kubectl",
            "exec",
            self.from_pod,
            "-c",
            self.from_container,
            "-n",
            self.from_namespace,
            "--",
        ] + self.client_command()

    def traffic(self) -> Traffic:
        """job.go:81-103."""
        return Traffic(
            source=TrafficPeer(
                internal=InternalPeer(
                    pod_labels=self.from_pod_labels,
                    namespace_labels=self.from_namespace_labels,
                    namespace=self.from_namespace,
                ),
                ip=self.from_ip,
            ),
            destination=TrafficPeer(
                internal=InternalPeer(
                    pod_labels=self.to_pod_labels,
                    namespace_labels=self.to_namespace_labels,
                    namespace=self.to_namespace,
                ),
                ip=self.to_ip,
            ),
            resolved_port=self.resolved_port,
            resolved_port_name=self.resolved_port_name,
            protocol=self.protocol,
        )


@dataclass
class Jobs:
    """job.go:10-14: valid jobs plus the two invalid buckets."""

    valid: List[Job] = field(default_factory=list)
    bad_named_port: List[Job] = field(default_factory=list)
    bad_port_protocol: List[Job] = field(default_factory=list)


@dataclass
class JobResult:
    """job.go:16-25.  ingress/egress are None when unknown (kube probes only
    observe the combined verdict)."""

    job: Job
    combined: Connectivity
    ingress: Optional[Connectivity] = None
    egress: Optional[Connectivity] = None

    def key(self) -> str:
        return f"{self.job.protocol}/{self.job.resolved_port}"
