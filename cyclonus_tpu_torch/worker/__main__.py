"""In-pod worker entrypoint (reference: cmd/worker/main.go + worker/cli.go):
`python -m cyclonus_tpu_torch.worker --jobs '<batch json>'` issues the
batch's probes and prints JSON results on stdout (the driver-side Client
parses them from the kubectl-exec stream)."""

from __future__ import annotations

import argparse
import sys

from .worker import run_worker


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="cyclonus-worker", description="in-pod batch connectivity prober"
    )
    parser.add_argument(
        "--jobs", required=True, help="JSON-serialized worker Batch"
    )
    parser.add_argument(
        "--metrics-port",
        type=int,
        default=None,
        metavar="PORT",
        help="serve Prometheus /metrics on 127.0.0.1:PORT (0 = ephemeral) "
        "for the batch's duration — per-probe latency histograms "
        "(cyclonus_tpu_probe_latency_seconds) scrape here",
    )
    parser.add_argument(
        "--trace-out",
        default="",
        metavar="PATH",
        help="write this worker's own span timeline as Chrome trace "
        "JSON (standalone debugging; in a driver run the events ride "
        "back on the Results instead)",
    )
    args = parser.parse_args(argv)
    if args.trace_out:
        # standalone debugging: record this worker's own timeline even
        # without driver-supplied trace context on the batch
        from ..telemetry import events

        events.enable(role="worker")
    if args.metrics_port is not None:
        from ..telemetry.server import MetricsPortBusy, start_metrics_server

        try:
            srv = start_metrics_server(args.metrics_port)
        except MetricsPortBusy as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        print(
            f"telemetry: metrics on {srv.url}/metrics (port {srv.port})",
            file=sys.stderr,
        )
        # honest readiness: the worker is ready the moment it starts
        # consuming its batch (no warmup phase of its own)
        from ..telemetry.server import register_readiness

        register_readiness(lambda: (True, "worker processing batch"))
    print(run_worker(args.jobs))
    if args.trace_out:
        from ..telemetry import trace_export

        path = trace_export.write_chrome_trace(args.trace_out)
        print(f"trace: wrote {path}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
