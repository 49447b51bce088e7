"""setup_s (s, host clock): process start to the window's first step —
imports, the kernel libraries (built on a checkout's first run, loaded
after), the cluster, the service and the warm-up of the cell's shapes."""


def read(run):
    return run.setup_s
