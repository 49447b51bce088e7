"""Lightweight stand-ins for the k8s core/v1 objects the framework touches
(Namespace, Pod, Container, Service).  Only the fields the reference reads or
writes are modeled (see pkg/connectivity/probe/pod.go KubePod/KubeService)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class KubeContainerPort:
    container_port: int
    name: str = ""
    protocol: str = "TCP"


@dataclass
class KubeContainer:
    name: str
    ports: List[KubeContainerPort] = field(default_factory=list)
    image: str = ""


@dataclass
class KubePod:
    namespace: str
    name: str
    labels: Dict[str, str] = field(default_factory=dict)
    containers: List[KubeContainer] = field(default_factory=list)
    phase: str = ""  # "Running" once scheduled
    pod_ip: str = ""


@dataclass
class KubeServicePort:
    port: int
    name: str = ""
    protocol: str = "TCP"


@dataclass
class KubeService:
    namespace: str
    name: str
    selector: Dict[str, str] = field(default_factory=dict)
    ports: List[KubeServicePort] = field(default_factory=list)
    cluster_ip: str = ""


@dataclass
class KubeNamespace:
    name: str
    labels: Dict[str, str] = field(default_factory=dict)
