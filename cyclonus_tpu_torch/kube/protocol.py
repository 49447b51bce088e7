"""Protocol and service helpers (reference: pkg/kube/protocol.go, service.go)."""

from __future__ import annotations

from .netpol import PROTOCOL_SCTP, PROTOCOL_TCP, PROTOCOL_UDP


def parse_protocol(s: str) -> str:
    """protocol.go:8-18 (case-sensitive, raises on anything else)."""
    if s in (PROTOCOL_TCP, PROTOCOL_UDP, PROTOCOL_SCTP):
        return s
    raise ValueError(f"invalid protocol {s!r}")


def qualified_service_address(service_name: str, namespace: str) -> str:
    """service.go:9-11."""
    return f"{service_name}.{namespace}.svc.cluster.local"
