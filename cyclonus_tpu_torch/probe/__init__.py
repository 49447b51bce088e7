"""Probe engine (reference: pkg/connectivity/probe): cluster model for
probes, pod x pod x port job fan-out, truth-table results, and job runners
(simulated via the oracle or the port's engine on the card; kube runners
exec into a real or mock cluster).

Layering fix vs the reference: ProbeConfig/ProbeMode live HERE, not in the
generator (the reference has an upward import probe -> generator,
resources.go:274, pod.go:53 — SURVEY.md section 1)."""

from .connectivity import (
    Connectivity,
    CONNECTIVITY_ALLOWED,
    CONNECTIVITY_BLOCKED,
    CONNECTIVITY_CHECK_FAILED,
    CONNECTIVITY_INVALID_NAMED_PORT,
    CONNECTIVITY_INVALID_PORT_PROTOCOL,
    CONNECTIVITY_UNKNOWN,
)
from .podstring import PodString, Peer
from .probeconfig import ProbeConfig, ProbeMode, PortProtocol
from .pod import Pod, Container
from .job import Job, Jobs, JobResult
from .resources import Resources
from .table import Table
from .truthtable import TruthTable
from .runner import (
    Runner,
    SimulatedJobRunner,
    KubeJobRunner,
    KubeBatchJobRunner,
    new_simulated_runner,
    new_kube_runner,
    new_kube_batch_runner,
)

__all__ = [
    "Connectivity",
    "CONNECTIVITY_ALLOWED",
    "CONNECTIVITY_BLOCKED",
    "CONNECTIVITY_CHECK_FAILED",
    "CONNECTIVITY_INVALID_NAMED_PORT",
    "CONNECTIVITY_INVALID_PORT_PROTOCOL",
    "CONNECTIVITY_UNKNOWN",
    "PodString",
    "Peer",
    "ProbeConfig",
    "ProbeMode",
    "PortProtocol",
    "Pod",
    "Container",
    "Job",
    "Jobs",
    "JobResult",
    "Resources",
    "Table",
    "TruthTable",
    "Runner",
    "SimulatedJobRunner",
    "KubeJobRunner",
    "KubeBatchJobRunner",
    "new_simulated_runner",
    "new_kube_runner",
    "new_kube_batch_runner",
]
