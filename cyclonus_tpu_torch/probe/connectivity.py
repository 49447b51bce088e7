"""Connectivity verdict enum (reference: probe/connectivity.go)."""

from __future__ import annotations

Connectivity = str

CONNECTIVITY_UNKNOWN: Connectivity = "unknown"
CONNECTIVITY_CHECK_FAILED: Connectivity = "checkfailed"
CONNECTIVITY_INVALID_NAMED_PORT: Connectivity = "invalidnamedport"
CONNECTIVITY_INVALID_PORT_PROTOCOL: Connectivity = "invalidportprotocol"
CONNECTIVITY_BLOCKED: Connectivity = "blocked"
CONNECTIVITY_ALLOWED: Connectivity = "allowed"

ALL_CONNECTIVITY = [
    CONNECTIVITY_UNKNOWN,
    CONNECTIVITY_CHECK_FAILED,
    CONNECTIVITY_INVALID_NAMED_PORT,
    CONNECTIVITY_INVALID_PORT_PROTOCOL,
    CONNECTIVITY_BLOCKED,
    CONNECTIVITY_ALLOWED,
]

_SHORT = {
    CONNECTIVITY_UNKNOWN: "?",
    CONNECTIVITY_CHECK_FAILED: "!",
    CONNECTIVITY_BLOCKED: "X",
    CONNECTIVITY_ALLOWED: ".",
    CONNECTIVITY_INVALID_NAMED_PORT: "P",
    CONNECTIVITY_INVALID_PORT_PROTOCOL: "N",
}


def short_string(c: Connectivity) -> str:
    """connectivity.go:25-42."""
    try:
        return _SHORT[c]
    except KeyError:
        raise ValueError(f"invalid Connectivity value: {c!r}")
