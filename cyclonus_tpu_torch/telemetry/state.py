"""Process-wide telemetry enable switch.

Every span, metric, and flight-recorder call checks `ENABLED` first and
returns immediately when off, so the instrumented hot paths pay one
attribute read when telemetry is disabled (the <2% overhead budget is
asserted by tests/test_telemetry.py even with it ON).  CYCLONUS_TELEMETRY=0
disables at process start; `set_enabled` flips it at runtime (tests, and
callers that want a quiet burst)."""

from __future__ import annotations

import os

ENABLED: bool = os.environ.get("CYCLONUS_TELEMETRY", "1") != "0"


def set_enabled(on: bool) -> None:
    global ENABLED
    ENABLED = bool(on)


def enabled() -> bool:
    return ENABLED
