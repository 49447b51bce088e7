"""Probe configuration (reference: generator/testcase.go:111-156 — moved
into the probe layer where it belongs)."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

from ..kube.netpol import IntOrString


class ProbeMode(str):
    pass


PROBE_MODE_SERVICE_NAME = ProbeMode("service-name")
PROBE_MODE_SERVICE_IP = ProbeMode("service-ip")
PROBE_MODE_POD_IP = ProbeMode("pod-ip")

ALL_PROBE_MODES = [
    PROBE_MODE_SERVICE_NAME,
    PROBE_MODE_SERVICE_IP,
    PROBE_MODE_POD_IP,
]


@dataclass
class PortProtocol:
    protocol: str
    port: IntOrString


@dataclass
class ProbeConfig:
    """Sum type: either all-available (one job per serving container) or a
    single port/protocol across the grid (testcase.go:137-156)."""

    all_available: bool = False
    port_protocol: Optional[PortProtocol] = None
    mode: ProbeMode = PROBE_MODE_SERVICE_NAME

    def with_mode(self, mode: ProbeMode) -> "ProbeConfig":
        """Copy with the probe mode replaced (generate --destination-type)."""
        return dataclasses.replace(self, mode=mode)

    @staticmethod
    def all_available_config(mode: ProbeMode = PROBE_MODE_SERVICE_NAME) -> "ProbeConfig":
        return ProbeConfig(all_available=True, mode=mode)

    @staticmethod
    def port_protocol_config(
        port: IntOrString, protocol: str, mode: ProbeMode = PROBE_MODE_SERVICE_NAME
    ) -> "ProbeConfig":
        return ProbeConfig(
            port_protocol=PortProtocol(protocol=protocol, port=port), mode=mode
        )
