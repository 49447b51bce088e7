"""Shared cluster selection for the generate/probe commands: one place
for the --mock / --loopback / kubectl wiring so the two commands cannot
drift (SCTP handling, settle-wait semantics, teardown)."""

from __future__ import annotations

from typing import List, Tuple

from ..kube.ikubernetes import IKubernetes, MockKubernetes


def make_cluster(args, protocols: List[str]) -> Tuple[IKubernetes, List[str]]:
    """Build the cluster backend from CLI flags; returns it with the
    protocol list (loopback drops SCTP, which python sockets cannot
    serve — docs/LOOPBACK.md)."""
    if args.mock and args.loopback:
        raise SystemExit("--mock and --loopback are mutually exclusive")
    if args.mock:
        return MockKubernetes(1.0), protocols
    if args.loopback:
        from ..kube.loopback import LoopbackKubernetes

        kubernetes = LoopbackKubernetes(
            ready_timeout_s=args.pod_creation_timeout_seconds
        )
        if "SCTP" in protocols:
            print("loopback cluster: dropping unsupported protocol SCTP")
            protocols = [p for p in protocols if p != "SCTP"]
        return kubernetes, protocols
    from ..kube.kubectl import KubectlKubernetes

    return KubectlKubernetes(args.context), protocols


def perturbation_wait_seconds(args) -> int:
    """mock answers from memory and loopback's verdict map is written
    synchronously before the mutating call returns: no settle wait."""
    return 0 if args.mock or args.loopback else args.perturbation_wait_seconds


def close_cluster(kubernetes: IKubernetes) -> None:
    if hasattr(kubernetes, "close"):
        kubernetes.close()  # loopback: kill pod server processes
