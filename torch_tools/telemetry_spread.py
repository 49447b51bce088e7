"""The spread of chip_smoke's telemetry on/off check on one counts route.

    python3 torch_tools/telemetry_spread.py [--route class] [--repeats 12]
                                            [--rounds 5,15] [--out FILE]

Run from the root of a checkout, on a CUDA card (exits 2 without one).
It builds the headline cluster (100,000 pods x 10,000 policies, seed
20260729) and one engine on the route (`class`: class_compress auto, K2;
`packed`: class_compress="0", K1), takes 8 warm counts calls, and then
repeats chip_smoke's telemetry leg (b) measurement `--repeats` times for
each round count: rounds of one call with telemetry off and one with it
on, in alternating order, and the ratio of the two minima.  Beside each
it runs the same protocol with telemetry off on both sides (an A/A
control), whose ratios show what the host's noise alone gives.  Prints
the card's name and power limit, then one JSON line (every call's
seconds, each repeat's ratios), and writes the line to --out.
"""

from __future__ import annotations

import argparse
import json
import random
import subprocess
import sys
import time
from pathlib import Path

N_PODS, N_POLICIES, SEED = 100_000, 10_000, 20260729


def measure(eng, cases, rounds, sides):
    """Ratio of minima of `rounds` alternating calls with telemetry set to
    sides[1] and sides[0], and every call's seconds."""
    from cyclonus_tpu_torch import telemetry

    times = {0: [], 1: []}
    for r in range(rounds):
        for side in ((0, 1) if r % 2 == 0 else (1, 0)):
            telemetry.set_enabled(sides[side])
            try:
                t = time.perf_counter()
                eng.evaluate_grid_counts(cases)
                times[side].append(time.perf_counter() - t)
            finally:
                telemetry.set_enabled(True)
    return min(times[1]) / min(times[0]), times


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--route", choices=("class", "packed"), default="class")
    ap.add_argument("--repeats", type=int, default=12)
    ap.add_argument("--rounds", default="5,15")
    ap.add_argument("--out", default="")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("telemetry_spread: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path.cwd()))
    from cyclonus_tpu_torch.engine import PortCase, TorchPolicyEngine
    from cyclonus_tpu_torch.matcher import build_network_policies
    from cyclonus_tpu_torch.synthetic import build_synthetic

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    pods, namespaces, policies = build_synthetic(N_PODS, N_POLICIES, random.Random(SEED))
    kw = {} if args.route == "class" else {"class_compress": "0"}
    eng = TorchPolicyEngine(build_network_policies(True, policies), pods, namespaces,
                            device="cuda", **kw)
    if (args.route == "class") != eng._class_counts_eligible(2):
        raise AssertionError(f"the engine did not take the {args.route} route")
    cases = [PortCase(80, "serve-80-tcp", "TCP"), PortCase(81, "serve-81-udp", "UDP")]
    for _ in range(8):
        eng.evaluate_grid_counts(cases)
    out = {"card": card, "route": args.route, "repeats": args.repeats, "legs": []}
    for rounds in (int(x) for x in args.rounds.split(",")):
        for name, sides in (("off/on", (False, True)), ("off/off", (False, False))):
            ratios, calls = [], []
            for _ in range(args.repeats):
                ratio, times = measure(eng, cases, rounds, sides)
                ratios.append(ratio)
                calls.append(times)
            leg = {"rounds": rounds, "sides": name, "ratios": ratios,
                   "max_ratio": max(ratios), "over_1_05": sum(r > 1.05 for r in ratios),
                   "calls_s": calls}
            out["legs"].append(leg)
            print(f"{args.route} {name} rounds {rounds}: ratios "
                  f"{' '.join(f'{r:.4f}' for r in ratios)}; {leg['over_1_05']} of "
                  f"{args.repeats} over 1.05", flush=True)
    line = json.dumps(out)
    print(line)
    if args.out:
        Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
