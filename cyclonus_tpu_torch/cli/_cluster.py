"""Cluster selection for the generate/probe commands: the in-memory mock
cluster is the one the port has."""

from __future__ import annotations

from ..kube.ikubernetes import IKubernetes, MockKubernetes


def make_cluster(args) -> IKubernetes:
    """The cluster backend the CLI flags name; exits with one line when
    they name a cluster that is not ported."""
    if not args.mock:
        raise SystemExit(
            "error: only --mock is supported: the kubectl and loopback "
            "clusters are not ported to cyclonus_tpu_torch yet"
        )
    return MockKubernetes(1.0)
