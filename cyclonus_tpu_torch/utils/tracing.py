"""Phase timers + the torch profiler hook — a thin facade over
`cyclonus_tpu_torch.telemetry.spans` (a copy of the reference package's
utils/tracing.py, with jax_profile replaced by torch_profile).

`phase` is a structured span (hierarchical, thread-safe, attribute-
carrying); this module keeps the flat API the CLI's --phase-stats and
the tests read:

    with phase("engine.encode"):
        ...
    stats()        -> {"engine.encode": {"count": 3, "total_s": ..., "max_s": ...}}
    reset()

    with torch_profile("/tmp/trace"):   # no-op when dir is falsy
        engine.evaluate_grid_counts(cases)

Nothing here imports torch at module level: the in-pod worker loads this
module through the telemetry package and must start without torch.
"""

from __future__ import annotations

import contextlib
import logging
import os
from typing import Dict, Iterator, Optional

from ..telemetry.spans import REGISTRY, span as phase  # noqa: F401 (re-export)

logger = logging.getLogger("cyclonus.trace")

#: the Chrome trace file torch_profile writes into its directory
PROFILE_TRACE_FILE = "torch-profile.trace.json"


def stats() -> Dict[str, Dict[str, float]]:
    """Flat per-name aggregates."""
    return REGISTRY.stats()


def reset() -> None:
    REGISTRY.reset()


def render_stats() -> str:
    rows = sorted(stats().items())
    if not rows:
        from ..telemetry import state

        if not state.ENABLED:
            return "(no phases recorded: telemetry disabled, CYCLONUS_TELEMETRY=0)"
        return "(no phases recorded)"
    out = [f"{'phase':<24}{'count':>8}{'total_s':>12}{'max_s':>10}"]
    for name, rec in rows:
        out.append(
            f"{name:<24}{int(rec['count']):>8}{rec['total_s']:>12.4f}"
            f"{rec['max_s']:>10.4f}"
        )
    return "\n".join(out)


def _all_threads_config():
    """The profiler config that records the CPU operations of every
    thread, not only the one that opened the capture (/profile opens it on
    a server thread while the engine runs on others); None on a torch
    without the option.  CUDA activity is process-wide either way."""
    from torch._C._profiler import _ExperimentalConfig

    try:
        return _ExperimentalConfig(profile_all_threads=True)
    except TypeError:
        return None


@contextlib.contextmanager
def torch_profile(trace_dir: Optional[str]) -> Iterator[None]:
    """Wrap a block in torch.profiler.profile and write its Chrome trace
    (export_chrome_trace) to <trace_dir>/torch-profile.trace.json; no-op
    when the dir is falsy.  Profiles CPU activity, plus CUDA (CUPTI)
    whenever a card is present: on a machine with a card the capture
    never drops to the CPU alone."""
    if not trace_dir:
        yield
        return
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with torch.profiler.profile(
        activities=activities, experimental_config=_all_threads_config()
    ) as prof:
        yield
    path = os.path.join(trace_dir, PROFILE_TRACE_FILE)
    prof.export_chrome_trace(path)
    logger.info("torch profiler trace written to %s", path)
