"""Run one benchmark cell once, on the CUDA card, and print its result.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  The last line of standard output is the
result (correct, attempted, failed, metrics, device; with --trace 1 also
breakdown), the last lines of standard error the numbers compared, each
beside its limit.  Exits 2, with no result, when no card is present or
the card count is below the cell's, and 1 on any other failure.

The program's caches stay in the checkout, at fixed paths under build/:
its kernel libraries in build/torch_kernels (the program's default) and
its autotune record in build/portbench.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def cache_env(root: str) -> None:
    build = os.path.join(root, "build")
    os.environ["CYCLONUS_TORCH_BUILD_DIR"] = os.path.join(build, "torch_kernels")
    os.environ["CYCLONUS_AUTOTUNE_CACHE"] = os.path.join(build, "portbench", "autotune.json")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build, "torch_extensions")


def main(argv=None) -> int:
    args = parse(argv)
    cache_env(ROOT)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import torch

    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    chips = next((c["chips"] for c in bench["workloads"] if c["name"] == args.workload), None)
    if chips is None:
        print(f"no cell {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 1
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    from portbench.harness import run_cell

    try:
        run_cell(args.workload, args.seed, args.seconds, bool(args.trace), t_start=T_START)
    except Exception:
        traceback.print_exc()
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
