"""Readings for the limits of `correct`: the program's own runs and the
control's, at a cell's own size, several seeds in one process.

    python3 portbench/control.py --workload <cell> --seeds 11,12,13 --seconds 10 \
        [--mode sound|control|both]

The control is the cell's traffic kind's (portbench/generators/<kind>.py;
for `churn` each step recounts before it applies its batch, which breaks
the guarantee that every delta applied before a recount is visible in
that recount).  For every seed and mode it prints one line {"seed",
"mode", "correct", "checked", "checks", "metrics"}; the benchmark's own
runs never run the control.  Needs the card, as run.py does.
"""

import argparse
import io
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--mode", choices=("sound", "control", "both"), default="both")
    args = ap.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from portbench.run import cache_env

    cache_env(ROOT)
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from portbench.harness import run_cell

    modes = ["sound", "control"] if args.mode == "both" else [args.mode]
    for seed in (int(s) for s in args.seeds.split(",")):
        for mode in modes:
            res = run_cell(args.workload, seed, args.seconds, False,
                           control=mode == "control",
                           out=io.StringIO(), err=io.StringIO())
            print(json.dumps({"seed": seed, "mode": mode, "correct": res["correct"],
                              "checked": res["checked"], "checks": res["checks"],
                              "metrics": res["metrics"]}), flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
