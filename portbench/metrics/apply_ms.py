"""apply_ms (ms, program span): the mean of VerdictService.apply's own
report `seconds` over the window's batches (serve/service.py,
serve/incremental.py)."""


def read(run):
    xs = [s["apply_s"] for s in run.steps if s["apply_s"] is not None and s["deltas"]]
    return 1e3 * sum(xs) / len(xs) if xs else None
