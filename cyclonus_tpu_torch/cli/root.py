"""Argument parsing and command dispatch (reference: pkg/cli/root.go)."""

from __future__ import annotations

import argparse
import logging
import sys
from typing import List, Optional

from .. import __version__


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="cyclonus-tpu-torch",
        description="kubernetes network policy prober and conformance-test "
        "generator on PyTorch and CUDA",
    )
    parser.add_argument(
        "-v",
        "--verbosity",
        default="info",
        choices=["debug", "info", "warn", "error"],
        help="log level",
    )
    sub = parser.add_subparsers(dest="command", required=True)

    from .analyze import setup_analyze
    from .chaos_cmd import setup_chaos
    from .fuzz_cmd import setup_fuzz
    from .generate import setup_generate
    from .probe_cmd import setup_probe
    from .recipes_cmd import setup_recipes
    from .serve_cmd import setup_serve

    setup_analyze(sub)
    setup_chaos(sub)
    setup_fuzz(sub)
    setup_generate(sub)
    setup_probe(sub)
    setup_recipes(sub)
    setup_serve(sub)

    telemetry_cmd = sub.add_parser(
        "telemetry",
        help="dump process telemetry (spans, metrics, flight recorder) "
        "or render a flight-recorder crash dump",
    )
    telemetry_cmd.add_argument(
        "--format",
        default="text",
        choices=["text", "json", "prometheus"],
        help="text = human tree + metric lines; json = the full snapshot "
        "(the /telemetry.json shape); prometheus = text "
        "exposition, exactly what --metrics-port serves",
    )
    telemetry_cmd.add_argument(
        "--flight-file",
        default="",
        metavar="PATH",
        help="render a flight-recorder JSON dump written by a crashed "
        "run (or by `dump()`), instead of this process's telemetry",
    )
    telemetry_cmd.set_defaults(func=_run_telemetry)

    trace_cmd = sub.add_parser(
        "trace",
        help="export this process's trace-event timeline as Chrome "
        "trace JSON, or summarize one written by --trace-out",
    )
    trace_cmd.add_argument(
        "--input",
        default="",
        metavar="PATH",
        help="summarize a Chrome trace JSON written by --trace-out "
        "(events per process, wall span, top spans by duration) "
        "instead of exporting this process's ring",
    )
    trace_cmd.add_argument(
        "--out",
        default="",
        metavar="PATH",
        help="write the export to PATH instead of stdout",
    )
    trace_cmd.set_defaults(func=_run_trace)

    version_cmd = sub.add_parser("version", help="print version information")
    version_cmd.set_defaults(func=_run_version)

    args = parser.parse_args(argv)
    logging.basicConfig(
        level={"debug": logging.DEBUG, "info": logging.INFO, "warn": logging.WARNING,
               "error": logging.ERROR}[args.verbosity],
        format="%(levelname)s %(name)s: %(message)s",
    )
    return args.func(args) or 0


def _run_telemetry(args) -> int:
    """The on-demand side of the flight recorder: crash dumps are written
    automatically by the except hook; this command reads one back
    (--flight-file) or snapshots the CURRENT process — which is mostly
    useful to tooling that embeds the CLI in-process, and as the one-stop
    schema reference (every cyclonus_tpu_* metric is registered at
    import, so even a fresh process prints the full catalog)."""
    import json

    from .. import telemetry

    if args.flight_file:
        with open(args.flight_file) as f:
            dump = json.load(f)
        if args.format == "json":
            print(json.dumps(dump, indent=2, default=str))
            return 0
        print(
            f"flight recorder dump: reason={dump.get('reason')!r} "
            f"pid={dump.get('pid')} at={dump.get('at')} "
            f"({dump.get('recorded_total')} recorded total)"
        )
        for e in dump.get("entries", []):
            print(
                f"  #{e.get('seq')} {e.get('path')} "
                f"n_pods={e.get('n_pods')} q={e.get('q')} "
                f"{e.get('seconds')}s {e.get('outcome')}"
            )
        return 0
    if args.format == "prometheus":
        print(telemetry.render_prometheus(), end="")
    elif args.format == "json":
        print(json.dumps(telemetry.snapshot(), indent=2, default=str))
    else:
        print(telemetry.render_text())
    return 0


def _run_trace(args) -> int:
    """The timeline sibling of `telemetry`: where that command renders
    AGGREGATES (span tree, metric families), this one deals in the
    trace-event TIMELINE — export the
    current process's event ring as Chrome trace JSON (mostly useful to
    tooling embedding the CLI in-process), or summarize a trace file a
    `probe`/`generate` run wrote via --trace-out."""
    import json

    from ..telemetry import events, trace_export

    if args.input:
        with open(args.input) as f:
            trace = json.load(f)
        print(trace_export.summarize(trace))
        return 0
    if not events.entries():
        print(
            "(no trace events recorded in this process: run with "
            "--trace-out, or CYCLONUS_TRACE_EVENTS=1)",
            file=sys.stderr,
        )
    if args.out:
        path = trace_export.write_chrome_trace(args.out)
        print(
            f"trace: wrote {path} "
            "(load in https://ui.perfetto.dev or chrome://tracing)"
        )
    else:
        print(json.dumps(trace_export.to_chrome_trace(), default=str))
    return 0


def _run_version(args) -> int:
    # static info only, like the reference (pkg/cli/version.go:1-34):
    # torch's version comes from package metadata, and no device is touched
    from importlib import metadata

    print(f"cyclonus-tpu-torch version {__version__}")
    try:
        torch_version = metadata.version("torch")
    except metadata.PackageNotFoundError:
        torch_version = "not installed"
    print(f"torch {torch_version}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
