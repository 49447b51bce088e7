"""k3_roofline (%, device trace): the least time of the tiered packed
counts kernel (K3, packed_counts_kernel<false, true> in
csrc/packed_counts.cu) over the window's recounts, reckoned by the
benchmark from each recount's cluster state (reference/bound.py), over
the kernel's device time in the trace."""

from portbench.reference import bound

#: the kernel's name as the profiler gives it, demangled or not
KERNEL = r"packed_counts_kernel<\s*false\s*,\s*true\s*>|packed_counts_kernelILb0ELb1E"


def read(run):
    if run.trace is None:
        return None
    seconds, n = run.trace.op_time(KERNEL)
    if n == 0 or seconds <= 0:
        return None
    work = run.work()
    if work is None:
        return None
    least = sum(bound.packed_counts_least_s(w)[0]
                for s, w in zip(run.steps, work) if s["counts"] is not None)
    return 100.0 * least / seconds
