"""recount_ms (ms, host clock): the mean host time of one counts call,
svc.engine.evaluate_grid_counts, ended by a device synchronise
(engine/api.py evaluate_grid_counts, _counts_dense)."""


def read(run):
    xs = [s["recount_s"] for s in run.recounts()]
    return 1e3 * sum(xs) / len(xs) if xs else None
