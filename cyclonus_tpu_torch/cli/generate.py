"""`generate` command: the flagship conformance run
(reference: pkg/cli/generate.go)."""

from __future__ import annotations

from ..connectivity import Interpreter, InterpreterConfig, Printer
from ..generator import TestCaseGenerator
from ..generator.tags import validate_tags
from ..probe.probeconfig import ALL_PROBE_MODES, ProbeMode
from ..probe.resources import Resources
from ..probe.runner import DEFAULT_ENGINE, ENGINE_CHOICES


def setup_generate(sub) -> None:
    cmd = sub.add_parser(
        "generate", help="generate and run conformance test cases against a CNI"
    )
    cmd.add_argument("--mock", action="store_true", help="use an in-memory mock cluster")
    cmd.add_argument(
        "--loopback",
        action="store_true",
        help="use the loopback cluster: pods as real processes on 127.x "
        "addresses, probes as real TCP/UDP through the in-pod worker "
        "(kube/loopback.py; SCTP unsupported and dropped)",
    )
    cmd.add_argument(
        "--perfect-cni",
        action="store_true",
        help="with --mock: emulate a policy-correct CNI (all cases should pass)",
    )
    cmd.add_argument("--dry-run", action="store_true", help="print cases without running")
    cmd.add_argument(
        "--destination-type",
        default="",
        choices=[""] + [str(m) for m in ALL_PROBE_MODES],
        help="override every test step's probe destination (generate.go"
        ":131-139); leave empty to keep per-case modes",
    )
    cmd.add_argument("--context", default="", help="kube context")
    cmd.add_argument(
        "--server-namespace",
        "--namespace",  # the reference's generate spells it --namespace
        action="append",
        default=None,
        help="namespaces (default x,y,z).  Fixture-bearing case families "
        "(conflict, upstream-e2e, example) reference namespaces x, y, z "
        "by name — a custom list must INCLUDE them or those cases error "
        "(reference parity: conflictcases.go:254-255 hardcodes them too)",
    )
    cmd.add_argument(
        "--server-pod",
        "--pod",  # reference alias (generate.go)
        action="append",
        default=None,
        help="pod names (default a,b,c)",
    )
    cmd.add_argument(
        "--server-port", action="append", type=int, default=None, help="ports (default 80,81)"
    )
    cmd.add_argument(
        "--server-protocol",
        action="append",
        default=None,
        help="protocols (default TCP,UDP,SCTP)",
    )
    cmd.add_argument("--include", action="append", default=[], help="tags to include")
    cmd.add_argument(
        "--exclude",
        action="append",
        default=None,
        help="tags to exclude (default: multi-peer, upstream-e2e, example; "
        "pass the literal value 'none' to run the full unfiltered suite)",
    )
    cmd.add_argument("--retries", type=int, default=1, help="kube probe retries")
    cmd.add_argument(
        "--perturbation-wait-seconds", type=int, default=5, help="wait after each perturbation"
    )
    cmd.add_argument(
        "--pod-creation-timeout-seconds", type=int, default=60, help="pod creation timeout"
    )
    cmd.add_argument("--batch-jobs", action="store_true", help="use the in-pod batch worker")
    cmd.add_argument("--ignore-loopback", action="store_true", help="ignore loopback calls")
    cmd.add_argument("--noisy", action="store_true", help="print tables for every step")
    cmd.add_argument(
        "--engine", default=DEFAULT_ENGINE, choices=ENGINE_CHOICES, help="simulated engine"
    )
    cmd.add_argument(
        "--device",
        default=None,
        help="torch device of the cuda engine (default: the current CUDA "
        "device, and an error without one; 'cpu' runs it on the CPU)",
    )
    cmd.add_argument(
        "--allow-dns",
        default=True,
        type=lambda s: s.lower() in ("1", "true", "yes"),
        help="inject an allow-DNS egress policy alongside egress-denying "
        "conflict cases (default true)",
    )
    cmd.add_argument(
        "--cleanup-namespaces", action="store_true", help="delete namespaces after the run"
    )
    cmd.add_argument(
        "--max-cases", type=int, default=0, help="cap the number of cases (0 = all)"
    )
    cmd.add_argument(
        "--journal",
        default="",
        help="JSONL journal of per-case results (crash-safe, appended per case)",
    )
    cmd.add_argument(
        "--resume",
        action="store_true",
        help="skip test cases already recorded in --journal",
    )
    cmd.set_defaults(func=run_generate)


DEFAULT_EXCLUDE = ["multi-peer", "upstream-e2e", "example"]


def run_generate(args) -> int:
    if args.resume and not args.journal:
        # validate before any cluster resources get created
        raise SystemExit("--resume requires --journal")
    namespaces = args.server_namespace or ["x", "y", "z"]
    pods = args.server_pod or ["a", "b", "c"]
    ports = args.server_port or [80, 81]
    protocols = [p.upper() for p in (args.server_protocol or ["TCP", "UDP", "SCTP"])]
    excluded = args.exclude if args.exclude is not None else DEFAULT_EXCLUDE
    if "none" in excluded:
        # the append action cannot express an empty list; the 'none'
        # sentinel runs the full unfiltered suite (216 cases)
        if len(excluded) > 1:
            raise SystemExit(
                "--exclude none must be the only --exclude value "
                "(it disables the default excludes entirely)"
            )
        excluded = []
    validate_tags(args.include)
    validate_tags(excluded)

    from ._cluster import close_cluster, make_cluster

    kubernetes, protocols = make_cluster(args, protocols)
    # pod servers (loopback subprocesses) exist from new_default onward;
    # an exception mid-case must still close the cluster
    try:
        return _run_generate_cases(
            args, kubernetes, namespaces, pods, ports, protocols, excluded
        )
    finally:
        close_cluster(kubernetes)


def _run_generate_cases(
    args, kubernetes, namespaces, pods, ports, protocols, excluded
) -> int:
    from ._cluster import perturbation_wait_seconds

    resources = Resources.new_default(
        kubernetes,
        namespaces,
        pods,
        ports,
        protocols,
        pod_creation_timeout_seconds=args.pod_creation_timeout_seconds,
        batch_jobs=args.batch_jobs,
    )
    print(f"resources:\n{resources.render_table()}")

    if args.mock and args.perfect_cni:
        from ..kube.mockcni import PolicyAwareMockExec

        kubernetes.exec_verdict_fn = PolicyAwareMockExec(kubernetes)

    # ipblock cases derive from pod z/c's IP (generate.go:112-115)
    zc_pod = resources.get_pod(namespaces[-1], pods[-1])
    generator = TestCaseGenerator(
        allow_dns=args.allow_dns,
        pod_ip=zc_pod.ip,
        namespaces=namespaces,
        tags=args.include,
        excluded_tags=excluded,
    )
    cases = generator.generate_test_cases()
    if args.max_cases:
        cases = cases[: args.max_cases]
    print(f"test cases to run by tag:")
    from ..generator import count_test_cases_by_tag

    for tag, count in sorted(count_test_cases_by_tag(cases).items()):
        if count:
            print(f"  {tag}: {count}")
    print(f"total: {len(cases)} test cases\n")

    if args.dry_run:
        for i, tc in enumerate(cases):
            print(f"{i + 1}: {tc.description} (tags: {', '.join(tc.tags.keys_sorted())})")
        return 0

    if args.destination_type:
        # override every step's probe mode (generate.go:131-139)
        mode = ProbeMode(args.destination_type)
        for tc in cases:
            for step in tc.steps:
                if step.probe is not None:
                    step.probe = step.probe.with_mode(mode)

    config = InterpreterConfig(
        reset_cluster_before_test_case=True,
        verify_cluster_state_before_test_case=True,
        kube_probe_retries=args.retries,
        perturbation_wait_seconds=perturbation_wait_seconds(args),
        batch_jobs=args.batch_jobs,
        ignore_loopback=args.ignore_loopback,
        simulated_engine=args.engine,
        pod_wait_timeout_seconds=args.pod_creation_timeout_seconds,
        device=args.device,
    )
    interpreter = Interpreter(kubernetes, resources, config)
    printer = Printer(noisy=args.noisy, ignore_loopback=args.ignore_loopback)

    journal = None
    if args.journal:
        from ..connectivity.journal import Journal

        journal = Journal(args.journal)
        if args.resume and journal.completed():
            print(f"resuming: {len(journal.completed())} case(s) already journaled")

    failed = 0
    for i, tc in enumerate(cases):
        # descriptions are not unique across cases; the index in the
        # deterministic generated order disambiguates (see journal.py)
        case_key = f"{i}:{tc.description}"
        if journal is not None and args.resume and journal.should_skip(case_key):
            print(f"skipping journaled test case #{i + 1} ({tc.description})")
            continue
        print(f"starting test case #{i + 1} ({tc.description})")
        result = interpreter.execute_test_case(tc)
        printer.print_test_case_result(result)
        if not result.passed(args.ignore_loopback):
            failed += 1
        if journal is not None:
            journal.record(
                tc.description,
                passed=result.passed(args.ignore_loopback),
                step_count=len(result.steps),
                tags=tc.tags.keys_sorted(),
                error=str(result.err) if result.err else "",
                key=case_key,
            )

    printer.print_summary()

    if args.cleanup_namespaces:
        for ns in namespaces:
            try:
                kubernetes.delete_namespace(ns)
            except Exception as e:
                print(f"unable to delete namespace {ns}: {e}")
    # a conformance runner that exits 0 on failing cases gives CI a
    # permanently green signal; the summary already printed the detail
    if failed:
        print(f"{failed} test case(s) FAILED")
        return 1
    return 0
