"""SLO engine: declarative objectives over signals the telemetry
stack already emits, multi-window burn-rate accounting, and in-service
enforcement (admission control, load shedding, degraded-path governance)
with breach black-box capture (a copy of the reference's cyclonus_tpu.slo).
"""

from .accounting import (
    BURNING,
    EXHAUSTED,
    OK,
    BurnAccountant,
    BurnSample,
    Hysteresis,
    state_severity,
)
from .engine import SloController, events_over_target
from .objectives import GAUGE, HISTOGRAM, ONCE, Objective, declared_objectives

__all__ = [
    "OK",
    "BURNING",
    "EXHAUSTED",
    "BurnAccountant",
    "BurnSample",
    "Hysteresis",
    "state_severity",
    "SloController",
    "events_over_target",
    "HISTOGRAM",
    "GAUGE",
    "ONCE",
    "Objective",
    "declared_objectives",
]
