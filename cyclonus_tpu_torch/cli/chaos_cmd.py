"""`chaos`: the seeded fault-injection suite (cyclonus_tpu_torch/chaos;
the reference's cli/chaos_cmd.py with --device).

Runs the bounded scenario set — serve kill/restart with a bounded
time-to-first-verdict, the audit plane's corruption detection, the SLO
ttfv budget and breach dump, a poisoned autotune winners file, backend-
init flakes, worker-wire death, dropped delta batches — and exits
nonzero if any designed degradation fails to hold."""

from __future__ import annotations

import json
import sys


def setup_chaos(sub) -> None:
    cmd = sub.add_parser(
        "chaos",
        help="run the seeded fault-injection suite: kill/restart serve "
        "(bounded time-to-first-verdict), poison the autotune "
        "winners, flake backend init, kill the worker wire, drop a "
        "delta mid-apply — asserting retry/rollback/fresh-search "
        "degradation plus oracle parity after every fault",
    )
    cmd.add_argument(
        "--seed", type=int, default=0, help="scenario seed (default 0)"
    )
    cmd.add_argument(
        "--scenario",
        action="append",
        default=None,
        metavar="NAME",
        help="run only this scenario (repeatable); default: all of "
        "serve_kill_restart, audit_divergence, slo_ttfv, poisoned_caches, "
        "backend_init_flake, worker_wire, delta_drop",
    )
    cmd.add_argument(
        "--bound",
        type=float,
        default=420.0,
        metavar="S",
        help="per-scenario wall-clock bound in seconds (default 420)",
    )
    cmd.add_argument(
        "--json",
        action="store_true",
        help="print the full suite report as JSON",
    )
    cmd.add_argument(
        "--device",
        default=None,
        help="torch device of the engines and the serve replicas "
        "(default: the current CUDA device, and an error without one; "
        "'cpu' runs them on the CPU)",
    )
    cmd.set_defaults(func=run_chaos)


def run_chaos(args) -> int:
    from ..chaos import harness

    unknown = [
        s for s in (args.scenario or []) if s not in harness.SCENARIOS
    ]
    if unknown:
        print(
            f"error: unknown scenario(s) {unknown}; have "
            f"{sorted(harness.SCENARIOS)}",
            file=sys.stderr,
        )
        return 2
    report = harness.run_all(
        seed=args.seed, only=args.scenario, bound_s=args.bound,
        device=args.device,
    )
    if args.json:
        # JSON mode prints ONLY the report (machine consumers parse
        # stdout wholesale)
        print(json.dumps(report, indent=2, default=str))
        return 0 if report["ok"] else 1
    else:
        for name, r in report["scenarios"].items():
            status = "OK " if r.get("ok") else "FAIL"
            extra = ""
            if "ttfv_s" in r:
                extra = f" ttfv={r['ttfv_s']}s/{r['ttfv_bound_s']:g}s"
            if "retries" in r:
                extra = f" retries={r['retries']}"
            if "rejected" in r:
                extra = f" rejected_entries={r['rejected']}"
            if not r.get("ok"):
                extra = f" error={r.get('error')}"
            print(f"chaos {status} {name} ({r.get('seconds')}s){extra}")
    print(
        "chaos: "
        + ("all scenarios held" if report["ok"] else "FAILURES above")
    )
    return 0 if report["ok"] else 1
