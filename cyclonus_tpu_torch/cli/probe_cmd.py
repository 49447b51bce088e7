"""`probe` command: a one-off probe against a (mock or real) cluster
(reference: pkg/cli/probe.go)."""

from __future__ import annotations

from ..connectivity import Interpreter, InterpreterConfig, Printer
from ..generator import read_network_policies, create_policy
from ..generator.tags import StringSet
from ..generator.testcase import TestCase, TestStep
from ..kube.netpol import IntOrString
from ..kube.yaml_io import load_policies_from_path
from ..probe.probeconfig import (
    ALL_PROBE_MODES,
    PROBE_MODE_SERVICE_NAME,
    ProbeConfig,
    ProbeMode,
)
from ..probe.resources import Resources
from ..probe.runner import DEFAULT_ENGINE, ENGINE_CHOICES


def _start_metrics(args) -> None:
    """Shared --metrics-port hookup for probe/generate: a daemon
    http.server thread serving the process-global telemetry registry.
    Prints the BOUND port (port 0 is ephemeral — the OS picks), and a
    taken port exits with one clean line instead of a traceback."""
    if getattr(args, "metrics_port", None) is None:
        return
    from ..telemetry.server import MetricsPortBusy, start_metrics_server

    try:
        srv = start_metrics_server(args.metrics_port)
    except MetricsPortBusy as e:
        raise SystemExit(f"error: {e}")
    # honest readiness from the first bind: /healthz says the process
    # is alive, /readyz says "starting" until the command's own setup
    # (cluster build, backend probe) completes and _mark_ready flips it
    from ..telemetry.server import register_readiness

    ready = {"v": False, "detail": "starting: cluster/backend setup in progress"}
    args._readiness = ready
    register_readiness(lambda: (ready["v"], ready["detail"]))
    print(f"telemetry: metrics on {srv.url}/metrics (port {srv.port})")


def _mark_ready(args, detail: str) -> None:
    """Flip the /readyz answer registered by _start_metrics (no-op when
    no metrics server was requested)."""
    r = getattr(args, "_readiness", None)
    if r is not None:
        r["v"] = True
        r["detail"] = detail


def _start_trace(args) -> None:
    """Shared --trace-out hookup for probe/generate: start recording
    span enter/exit events under a fresh trace id (the worker side joins
    it through the batch wire context)."""
    if not getattr(args, "trace_out", ""):
        return
    from ..telemetry import events, state

    if not state.ENABLED:
        print(
            "trace: telemetry is disabled (CYCLONUS_TELEMETRY=0) — "
            "--trace-out will record an empty timeline"
        )
    tid = events.enable()
    print(f"trace: recording timeline (trace_id {tid})")


def _write_trace(args) -> None:
    """Write the merged driver+worker timeline at exit (Chrome
    trace-event JSON — open in https://ui.perfetto.dev)."""
    if not getattr(args, "trace_out", ""):
        return
    from ..telemetry import trace_export

    path = trace_export.write_chrome_trace(args.trace_out)
    print(
        f"trace: wrote {path} "
        "(load in https://ui.perfetto.dev or chrome://tracing)"
    )


def setup_probe(sub) -> None:
    cmd = sub.add_parser("probe", help="run a connectivity probe against a cluster")
    cmd.add_argument("--mock", action="store_true", help="use an in-memory mock cluster")
    cmd.add_argument(
        "--loopback",
        action="store_true",
        help="use the loopback cluster: pods as real processes on 127.x "
        "addresses, real TCP/UDP probes (kube/loopback.py; SCTP dropped)",
    )
    cmd.add_argument(
        "--perfect-cni", action="store_true",
        help="with --mock: emulate a policy-correct CNI",
    )
    cmd.add_argument("--context", default="", help="kube context")
    cmd.add_argument(
        "-n",
        "--server-namespace",
        action="append",
        default=None,
        help="namespaces (default x,y,z)",
    )
    cmd.add_argument(
        "--server-pod", action="append", default=None, help="pod names (default a,b,c)"
    )
    cmd.add_argument(
        "--server-port", action="append", type=int, default=None, help="ports (default 80,81)"
    )
    cmd.add_argument(
        "--server-protocol", action="append", default=None,
        help="protocols (default TCP,UDP,SCTP)",
    )
    cmd.add_argument(
        "--policy-path", default="", help="create policies from this file/dir first"
    )
    cmd.add_argument(
        "--all-available", action="store_true",
        help="probe all available (port, protocol) server combinations",
    )
    cmd.add_argument(
        "--probe-port",
        "--port",  # reference alias (probe.go --port, repeatable)
        action="append",
        default=None,
        help="port(s) to probe, numbered or named; repeatable — one "
        "probe per (port, protocol) combination",
    )
    cmd.add_argument(
        "--probe-protocol",
        "--protocol",  # reference alias (probe.go --protocol, repeatable)
        action="append",
        default=None,
        help="protocol(s) to probe (default TCP); repeatable",
    )
    cmd.add_argument(
        "--probe-mode", default=PROBE_MODE_SERVICE_NAME, choices=[str(m) for m in ALL_PROBE_MODES]
    )
    cmd.add_argument(
        "--engine", default=DEFAULT_ENGINE, choices=ENGINE_CHOICES, help="simulated engine"
    )
    cmd.add_argument(
        "--pod-creation-timeout-seconds", type=int, default=60, help="pod creation timeout"
    )
    cmd.add_argument(
        "--perturbation-wait-seconds",
        type=int,
        default=5,
        help="wait after applying policies before probing (ignored with --mock)",
    )
    cmd.add_argument(
        "--device",
        default=None,
        help="torch device of the cuda engine (default: the current CUDA "
        "device, and an error without one; 'cpu' runs it on the CPU)",
    )
    cmd.add_argument(
        "--noisy", action="store_true", help="print all tables, not just discrepancies"
    )
    cmd.add_argument(
        "--ignore-loopback",
        action="store_true",
        help="ignore loopback cells in correctness verification",
    )
    add_telemetry_flags(cmd)
    cmd.set_defaults(func=run_probe)


def add_telemetry_flags(cmd) -> None:
    """--metrics-port, --trace-out and the --torch-profile / --trace-dir
    pair, shared by probe and generate."""
    cmd.add_argument(
        "--metrics-port",
        type=int,
        default=None,
        metavar="PORT",
        help="serve Prometheus /metrics (+ /telemetry.json, /profile) on "
        "127.0.0.1:PORT for the run (0 = ephemeral port)",
    )
    cmd.add_argument(
        "--trace-out",
        default="",
        metavar="PATH",
        help="record span enter/exit events and write the merged "
        "driver+worker timeline as Chrome trace-event JSON to PATH at "
        "exit (open in Perfetto / chrome://tracing)",
    )
    cmd.add_argument(
        "--torch-profile",
        "--trace-dir",
        dest="torch_profile",
        default="",
        metavar="DIR",
        help="write a torch.profiler Chrome trace of the run (CPU activity, "
        "plus CUDA on the card) to DIR/torch-profile.trace.json",
    )


def run_probe(args) -> int:
    _start_metrics(args)
    _start_trace(args)
    namespaces = args.server_namespace or ["x", "y", "z"]
    pods = args.server_pod or ["a", "b", "c"]
    ports = args.server_port or [80, 81]
    protocols = [p.upper() for p in (args.server_protocol or ["TCP", "UDP", "SCTP"])]

    from ..utils.tracing import torch_profile
    from ._cluster import close_cluster, make_cluster

    kubernetes, protocols = make_cluster(args, protocols)
    _mark_ready(args, "cluster up; probing")
    # pod servers (loopback subprocesses) exist from new_default onward;
    # an exception anywhere past this point must still close the cluster
    try:
        with torch_profile(args.torch_profile):
            return _run_probe_cases(args, kubernetes, namespaces, pods, ports, protocols)
    finally:
        # the trace is written FIRST: it is the artifact the user asked
        # for and is most valuable exactly when the run ended abnormally
        # — a cleanup failure must not discard it (and a failed write
        # must not skip cleanup)
        try:
            _write_trace(args)
        finally:
            close_cluster(kubernetes)


def _run_probe_cases(args, kubernetes, namespaces, pods, ports, protocols) -> int:
    from ._cluster import perturbation_wait_seconds

    resources = Resources.new_default(
        kubernetes,
        namespaces,
        pods,
        ports,
        protocols,
        pod_creation_timeout_seconds=args.pod_creation_timeout_seconds,
    )
    if args.mock and args.perfect_cni:
        from ..kube.mockcni import PolicyAwareMockExec

        kubernetes.exec_verdict_fn = PolicyAwareMockExec(kubernetes)

    read = read_network_policies(namespaces)  # idempotent, re-run per case
    creates = []
    if args.policy_path:
        for policy in load_policies_from_path(args.policy_path):
            creates.append(create_policy(policy))

    mode = ProbeMode(args.probe_mode)
    if args.all_available or (
        args.probe_port is None and args.probe_protocol is None
    ):
        probe_configs = [
            ("all available one-off probe", ProbeConfig.all_available_config(mode))
        ]
    else:
        # one probe per (port, protocol) combination, like the
        # reference's loop (probe.go:123-130); a protocol without a port
        # probes the reference's default port list (["80"])
        probe_ports = args.probe_port or ["80"]
        probe_protocols = args.probe_protocol or ["TCP"]
        probe_configs = []
        for port_str in probe_ports:
            port = (
                IntOrString(int(port_str))
                if port_str.isdigit()
                else IntOrString(port_str)
            )
            for proto in probe_protocols:
                probe_configs.append(
                    (
                        f"one-off probe {port_str}/{proto.upper()}",
                        ProbeConfig.port_protocol_config(
                            port, proto.upper(), mode
                        ),
                    )
                )

    def make_config(wait_s):
        return InterpreterConfig(
            kube_probe_retries=0,
            perturbation_wait_seconds=wait_s,
            simulated_engine=args.engine,
            pod_wait_timeout_seconds=args.pod_creation_timeout_seconds,
            ignore_loopback=args.ignore_loopback,
            device=args.device,
        )

    interpreter = Interpreter(
        kubernetes, resources, make_config(perturbation_wait_seconds(args))
    )
    # later cases only re-run the idempotent read (the creates applied in
    # case 1 and would error on re-apply), so they need no settle wait
    interpreter_settled = Interpreter(kubernetes, resources, make_config(0))
    printer = Printer(noisy=args.noisy, ignore_loopback=args.ignore_loopback)
    from ..telemetry.spans import span

    # the timeline's root: every case/step/probe span nests under it
    with span("probe.run", configs=len(probe_configs), engine=args.engine):
        for i, (description, probe_config) in enumerate(probe_configs):
            test_case = TestCase(
                description=description,
                tags=StringSet(),
                steps=[
                    TestStep(
                        probe=probe_config,
                        actions=[read] + creates if i == 0 else [read],
                    )
                ],
            )
            result = (
                interpreter if i == 0 else interpreter_settled
            ).execute_test_case(test_case)
            printer.print_test_case_result(result)
    return 0
