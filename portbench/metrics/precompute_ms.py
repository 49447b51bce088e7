"""precompute_ms (ms, device trace): device time per recount of every
device operation other than the hand-written counts kernels, started
inside the recount's host range — the plain-torch precompute
(engine/tiled.py, engine/kernel.py) and its copies."""

#: the hand-written counts kernels (csrc/packed_counts.cu, csrc/dense_counts.cu)
HANDWRITTEN = r"packed_counts_kernel|dense_counts_kernel"


def read(run):
    if run.trace is None:
        return None
    seconds, n = run.trace.in_ranges("recount", exclude=HANDWRITTEN)
    if n == 0 or seconds <= 0:
        return None
    return 1e3 * seconds / n
