"""`fuzz`: the precedence-tier differential fuzz gate (tiers/fuzz.py) as
a CLI — seeded and bounded (the reference's cli/fuzz_cmd.py).

Every engine runs on --device (default: the current CUDA device, and an
error without one), and the mesh leg on that device's default mesh
(engine/sharded.default_mesh: every visible card, or 8 logical shards on
the one device).  The reference's XLA_FLAGS device-count setup has no
counterpart: a logical mesh needs none."""

from __future__ import annotations

import json
import time


def setup_fuzz(sub) -> None:
    p = sub.add_parser(
        "fuzz",
        help="seeded ANP/BANP policy-set fuzzer: differential "
        "engine-vs-oracle gate over adversarial corner cases",
    )
    p.add_argument(
        "--seeds",
        type=int,
        default=8,
        metavar="N",
        help="number of consecutive seeds to run (default 8)",
    )
    p.add_argument(
        "--seed",
        type=int,
        default=0,
        metavar="S",
        help="base seed (default 0); a failure message names the exact "
        "seed, so --seed S --seeds 1 reproduces it",
    )
    p.add_argument(
        "--dense-only",
        action="store_true",
        help="skip the class-compressed twin of each check (half the "
        "work; the compressed path is the default because compression "
        "must be verdict-invariant under tiers)",
    )
    p.add_argument(
        "--no-counts",
        action="store_true",
        help="skip the counts cross-check",
    )
    p.add_argument(
        "--no-mesh",
        action="store_true",
        help="skip the mesh leg (each engine's truth table re-evaluated "
        "through the ring schedule of the pod-axis mesh and pinned "
        "bit-identical)",
    )
    p.add_argument(
        "--pair-samples",
        type=int,
        default=16,
        metavar="K",
        help="evaluate_pairs spot checks per seed (default 16)",
    )
    p.add_argument(
        "--cidr-seeds",
        type=int,
        default=6,
        metavar="N",
        help="seeds of the adversarial CIDR family (overlapping "
        "prefixes, /31-/32 splinters, /0 full cover, except==cidr "
        "annihilation, three-deep excepts, v4/v6 mixes) pinned "
        "dense==compressed==TSS==oracle incl. the mesh leg "
        "(default 6; 0 skips)",
    )
    p.add_argument(
        "--conformance",
        action="store_true",
        help="also run the generator's ANP/BANP conformance family "
        "through the same differential gate",
    )
    p.add_argument(
        "--json",
        action="store_true",
        dest="as_json",
        help="emit the report as one JSON object",
    )
    p.add_argument(
        "--device",
        default=None,
        help="torch device of the engines (default: the current CUDA "
        "device, and an error without one; 'cpu' runs them on the CPU)",
    )
    p.set_defaults(func=_run_fuzz)


def _run_fuzz(args) -> int:
    from ..tiers import fuzz

    t0 = time.perf_counter()
    log = None if args.as_json else print
    try:
        report = fuzz.run(
            seeds=args.seeds,
            base_seed=args.seed,
            modes=("0",) if args.dense_only else ("0", "1"),
            check_counts=not args.no_counts,
            check_mesh=not args.no_mesh,
            pair_samples=args.pair_samples,
            cidr_seeds=args.cidr_seeds,
            log=log,
            device=args.device,
        )
        conformance = (
            fuzz.run_conformance(log=log, device=args.device) if args.conformance else None
        )
    except fuzz.FuzzMismatch as e:
        if args.as_json:
            print(json.dumps({"ok": False, "error": str(e)}))
        else:
            print(f"FUZZ GATE FAILED: {e}")
        return 1
    out = report.to_dict()
    out["ok"] = True
    out["seconds"] = round(time.perf_counter() - t0, 2)
    if conformance is not None:
        out["conformance_cases"] = conformance
    if args.as_json:
        print(json.dumps(out))
    else:
        print(
            f"fuzz gate green: {len(out['seeds'])} seeds "
            f"({out['tiered_seeds']} tiered), {out['cells_checked']} "
            f"truth-table cells ({out['mesh_cells_checked']} re-checked "
            f"via the overlapped mesh), {out['pair_checks']} pair checks"
            + (
                f", {len(out['cidr_seeds'])} CIDR seeds "
                f"({out['cidr_cells_checked']} cells)"
                if out.get("cidr_seeds")
                else ""
            )
            + (
                f", {conformance} conformance cases"
                if conformance is not None
                else ""
            )
            + f" in {out['seconds']}s"
        )
    return 0
