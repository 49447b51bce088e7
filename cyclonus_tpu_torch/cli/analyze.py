"""`analyze` command: parse / explain / lint / audit / diff /
query-target / query-traffic / probe modes (reference: pkg/cli/analyze.go;
a copy of the reference package's cli/analyze.py on the port's engine).

The audit, diff and probe modes run the engine on `--device` (default:
the current CUDA device, and an error without one; "cpu" runs it on the
CPU).  Policies come from files, the bundled examples and, with `-n` /
`-A`, a live cluster through kubectl (kube/kubectl.py)."""

from __future__ import annotations

import json
from typing import List

from ..kube.labels import label_selector_table_lines, serialize_label_selector
from ..kube.netpol import IntOrString, LabelSelector, NetworkPolicy
from ..kube.yaml_io import load_policies_from_path
from ..matcher.builder import build_network_policies
from ..matcher.core import Policy, Traffic, combine_targets_ignoring_primary_key
from ..matcher.explain import explain_table
from ..utils.table import render_table
from ..probe.runner import DEFAULT_ENGINE, ENGINE_CHOICES

ALL_MODES = [
    "parse",
    "explain",
    "lint",
    "audit",
    "diff",
    "query-target",
    "query-traffic",
    "probe",
]


def setup_analyze(sub) -> None:
    cmd = sub.add_parser("analyze", help="analyze network policies")
    cmd.add_argument(
        "--mode",
        action="append",
        default=None,
        choices=ALL_MODES,
        help="analysis modes to run (default: explain)",
    )
    cmd.add_argument(
        "--policy-path",
        default="",
        help="file or directory to read policies from",
    )
    cmd.add_argument(
        "--use-example-policies",
        action="store_true",
        help="if true, reads example policies",
    )
    cmd.add_argument(
        "-n",
        "--namespace",
        action="append",
        default=[],
        help="namespaces to read policies from a live cluster (via kubectl)",
    )
    cmd.add_argument(
        "-A",
        "--all-namespaces",
        action="store_true",
        help="read policies from all namespaces (kubectl's -A)",
    )
    cmd.add_argument("--context", default="", help="kube context")
    cmd.add_argument(
        "--simplify-policies",
        default=True,
        action=_bool_action(),
        help="reduce policies to simpler form while preserving semantics",
    )
    cmd.add_argument(
        "--policy-path2",
        default="",
        help="second policy file/directory for diff mode (set B)",
    )
    cmd.add_argument(
        "--max-diff-cells",
        type=int,
        default=32,
        help="max differing cells to print in diff mode",
    )
    cmd.add_argument("--target-pod-path", default="", help="json target pod file")
    cmd.add_argument("--traffic-path", default="", help="json traffic file")
    cmd.add_argument("--probe-path", default="", help="json synthetic probe model")
    cmd.add_argument(
        "--engine",
        default=DEFAULT_ENGINE,
        choices=ENGINE_CHOICES,
        help="simulated engine for probe mode",
    )
    cmd.add_argument(
        "--device",
        default=None,
        help="torch device of the engine in the audit, diff and probe "
        "modes (default: the current CUDA device, and an error without "
        "one; 'cpu' runs it on the CPU)",
    )
    cmd.set_defaults(func=run_analyze)


def _bool_action():
    import argparse

    class _B(argparse.Action):
        def __call__(self, parser, namespace, values, option_string=None):
            setattr(namespace, self.dest, str(values).lower() in ("1", "true", "yes"))

    return _B


def _read_cluster(args, want_pods: bool, want_ns_labels: bool):
    """Kube-sourced inputs (RunAnalyzeCommand step 1, analyze.go:91-109):
    policies — plus pods (query-target/probe) and namespace labels
    (probe only) when a requested mode consumes them; fetching the whole
    pod list for lint/explain would stall large clusters for nothing —
    from the live cluster whenever -n/-A is given.  One deviation,
    noted: with -n the reference leaves the namespace-label map empty
    (only -A fills it, analyze.go:100-105), which silently breaks
    namespace selectors in probe mode — here the named namespaces'
    labels are fetched too."""
    policies: List[NetworkPolicy] = []
    kube_pods = []  # List[KubePod]
    kube_namespaces = {}  # Dict[ns name, labels]
    if args.namespace and args.all_namespaces:
        # kubectl rejects this combination too
        raise SystemExit("--namespace and --all-namespaces are mutually exclusive")
    if args.namespace or args.all_namespaces:
        from ..kube.kubectl import KubectlKubernetes

        kube = KubectlKubernetes(args.context)
        if args.all_namespaces:
            policies.extend(kube.get_network_policies_all_namespaces())
            if want_pods:
                kube_pods.extend(kube.get_pods_all_namespaces())
            if want_ns_labels:
                for ns in kube.get_all_namespaces():
                    kube_namespaces[ns.name] = ns.labels
        else:
            for ns in args.namespace:
                policies.extend(kube.get_network_policies_in_namespace(ns))
                if want_pods:
                    kube_pods.extend(kube.get_pods_in_namespace(ns))
                if want_ns_labels:
                    kube_namespaces[ns] = kube.get_namespace(ns).labels
    return policies, kube_pods, kube_namespaces


def run_analyze(args) -> int:
    modes = args.mode or ["explain"]
    want_pods = bool({"query-target", "probe"} & set(modes))
    want_ns_labels = "probe" in modes  # only probe consumes ns labels
    kube_policies, kube_pods, kube_namespaces = _read_cluster(
        args, want_pods, want_ns_labels
    )
    if args.policy_path:
        kube_policies = kube_policies + load_policies_from_path(args.policy_path)
    if args.use_example_policies:
        from ..kube.examples import all_examples

        kube_policies = kube_policies + all_examples()
    policies = build_network_policies(args.simplify_policies, kube_policies)

    for mode in modes:
        if mode == "parse":
            print(_parse_table(kube_policies))
        elif mode == "explain":
            print(explain_table(policies))
        elif mode == "lint":
            from ..linter import lint, warnings_table

            print(warnings_table(lint(kube_policies)))
        elif mode == "audit":
            _run_audit(policies, args)
        elif mode == "diff":
            _run_diff(policies, args)
        elif mode == "query-target":
            _query_targets(policies, args.target_pod_path, kube_pods)
        elif mode == "query-traffic":
            _query_traffic(policies, args.traffic_path)
        elif mode == "probe":
            _synthetic_probe(
                policies,
                args.probe_path,
                args.engine,
                kube_pods,
                kube_namespaces,
                device=args.device,
            )
        else:
            raise ValueError(f"unrecognized mode {mode}")
    return 0


def _analysis_cluster(args, *policies):
    """(pods, namespaces) for the audit/diff modes: the --probe-path
    Resources model when given, else a representative cluster
    synthesized from the policies themselves (analysis.cluster)."""
    if args.probe_path:
        with open(args.probe_path) as f:
            config = json.load(f)
        resources = (config.get("Resources") or config) or {}
        pods = [
            (
                p["Namespace"],
                p["Name"],
                p.get("Labels") or {},
                p.get("IP", "") or f"10.99.{i // 256}.{i % 256}",
            )
            for i, p in enumerate(resources.get("Pods") or [])
        ]
        namespaces = dict(resources.get("Namespaces") or {})
        for ns, _, _, _ in pods:
            namespaces.setdefault(ns, {})
        if pods:
            return pods, namespaces
    from ..analysis import synthesize_cluster

    return synthesize_cluster(*policies)


def _run_audit(policies: Policy, args) -> None:
    """`analyze --mode audit`: shadowed / never-firing resolved rules on
    the dense encoding, oracle cross-checked (analysis.audit)."""
    from ..analysis import audit_policy_set, derive_port_cases

    pods, namespaces = _analysis_cluster(args, policies)
    cases = derive_port_cases(policies)
    report = audit_policy_set(policies, pods, namespaces, cases, device=args.device)
    n_rules = sum(report.n_rules.values())
    print(
        f"audited {n_rules} resolved rules over {report.n_pods} pods x "
        f"{len(report.cases)} port cases ({report.cells} grid cells), "
        f"{report.oracle_checked} findings oracle-checked"
    )
    if not report.findings:
        print("no dead rules: every rule fires uniquely somewhere")
        return
    print(report.table())


def _run_diff(policies: Policy, args) -> None:
    """`analyze --mode diff`: verdict-tensor diff of this policy set
    (A) against --policy-path2 (B) on a shared cluster
    (analysis.diff)."""
    from ..analysis import derive_port_cases, diff_policy_sets

    if not args.policy_path2:
        raise ValueError("diff mode needs --policy-path2 (the B policy set)")
    kube_b = load_policies_from_path(args.policy_path2)
    policies_b = build_network_policies(args.simplify_policies, kube_b)
    pods, namespaces = _analysis_cluster(args, policies, policies_b)
    cases = derive_port_cases(policies, policies_b)
    report = diff_policy_sets(
        policies, policies_b, pods, namespaces, cases,
        max_cells=args.max_diff_cells, device=args.device,
    )
    if report.equivalent:
        print(
            f"policy sets EQUIVALENT: 0 of {report.total_cells} verdict "
            f"cells differ ({len(report.pod_keys)} pods x "
            f"{len(report.cases)} port cases; "
            f"{report.oracle_checked} cells oracle-checked)"
        )
        return
    print(
        f"policy sets DIFFER: "
        + ", ".join(f"{k}={v}" for k, v in report.n_diff.items())
        + f" of {report.total_cells} verdict cells "
        f"({report.oracle_checked} cells oracle-checked)"
    )
    print(report.table())
    if report.truncated:
        print(f"... truncated to the first {len(report.cells)} cells")


def _print_peers(peers) -> str:
    """networkpolicy.go:51-64."""
    if not peers:
        return "all peers"
    lines = []
    for peer in peers:
        if peer.ip_block is not None:
            lines.append(
                f"{peer.ip_block.cidr} except "
                f"[{','.join(peer.ip_block.except_)}]"
            )
        else:
            ns = (
                "nil"
                if peer.namespace_selector is None
                else serialize_label_selector(peer.namespace_selector)
            )
            pod = (
                "nil"
                if peer.pod_selector is None
                else serialize_label_selector(peer.pod_selector)
            )
            lines.append(f"ns/pod selector:\n - ns: {ns}\n - pod: {pod}")
    return "\n\n".join(lines)


def _print_ports(ports) -> str:
    """networkpolicy.go:85-110."""
    if not ports:
        return "all ports, all protocols"
    lines = []
    for pp in ports:
        port = "all ports" if pp.port is None else f"port {pp.port.value}"
        protocol = pp.protocol or "TCP"
        if pp.end_port is None:
            lines.append(f"{port} on {protocol}")
        else:
            # endPort without port is invalid per k8s validation but must
            # not crash the inspection tool
            lo = pp.port.value if pp.port is not None else "nil"
            lines.append(f"[{lo}, {pp.end_port}] on {protocol}")
    return "\n".join(lines)


def _parse_table(policies: List[NetworkPolicy]) -> str:
    """Per-rule policy table (networkpolicy.go:11-49): one row per
    ingress/egress rule with its peers and ports spelled out."""
    rows = []
    for p in policies:
        name = f"{p.effective_namespace()}/{p.name}"
        target = label_selector_table_lines(p.spec.pod_selector)
        for policy_type in p.spec.policy_types:
            if policy_type == "Ingress":
                if not p.spec.ingress:
                    rows.append([name, target, "ingress", "none", "none"])
                for rule in p.spec.ingress:
                    rows.append(
                        [name, target, "ingress",
                         _print_peers(rule.from_), _print_ports(rule.ports)]
                    )
            elif policy_type == "Egress":
                if not p.spec.egress:
                    rows.append([name, target, "egress", "none", "none"])
                for rule in p.spec.egress:
                    rows.append(
                        [name, target, "egress",
                         _print_peers(rule.to), _print_ports(rule.ports)]
                    )
    return render_table(
        ["Policy", "Target", "Direction", "Peer", "Port/Protocol"],
        rows,
        row_line=True,
    )


def _query_targets(policies: Policy, pod_path: str, kube_pods=()) -> None:
    """analyze.go:170-207: kube-sourced pods first (when -n/-A gave us
    any, analyze.go:133-140), then pods from the JSON file appended
    (analyze.go:171-178) — the file is optional once a cluster supplies
    pods."""
    pods = [
        {"Namespace": p.namespace, "Labels": p.labels} for p in kube_pods
    ]
    if pod_path:
        with open(pod_path) as f:
            pods.extend(json.load(f))
    if not pods:
        raise ValueError(
            "query-target needs pods: a target pod file (--target-pod-path) "
            "or a cluster source (-n/-A)"
        )
    for pod in pods:
        namespace = pod.get("Namespace") or pod.get("namespace") or ""
        labels = pod.get("Labels") or pod.get("labels") or {}
        print(f"pod in ns {namespace} with labels {labels}:\n")
        ingress_targets = policies.targets_applying_to_pod(True, namespace, labels)
        egress_targets = policies.targets_applying_to_pod(False, namespace, labels)
        matching = Policy.from_targets(ingress_targets, egress_targets)
        combined_i = combine_targets_ignoring_primary_key(
            namespace, LabelSelector.make(match_labels=labels), ingress_targets
        )
        combined_e = combine_targets_ignoring_primary_key(
            namespace, LabelSelector.make(match_labels=labels), egress_targets
        )
        combined = Policy.from_targets(
            [combined_i] if combined_i else [], [combined_e] if combined_e else []
        )
        print(f"Matching targets:\n{explain_table(matching)}")
        print(f"Combined rules:\n{explain_table(combined)}\n\n")


def _query_traffic(policies: Policy, traffic_path: str) -> None:
    """analyze.go:209-225."""
    if not traffic_path:
        raise ValueError("path to traffic file required for query-traffic")
    with open(traffic_path) as f:
        traffics = json.load(f)
    for d in traffics:
        traffic = Traffic.from_dict(d)
        result = policies.is_traffic_allowed(traffic)
        print(f"Traffic: {json.dumps(d)}")
        print(f"Is traffic allowed?\n{result.table()}\n\n")


def _synthetic_probe(
    policies: Policy,
    probe_path: str,
    engine: str,
    kube_pods=(),
    kube_namespaces=None,
    device=None,
) -> None:
    """analyze.go:232-299: simulated probes over a JSON cluster model
    (when --probe-path is given) and/or an all-available probe over
    probe.Resources built from live-cluster pods (when -n/-A sourced
    any; ProbeSyntheticConnectivity's kube path, analyze.go:255-299 —
    port-less containers and container-less pods are skipped with a
    warning exactly like the reference).  The reference also runs the
    kube path with zero pods, printing empty tables; here that case
    raises instead, since it always signals a missing flag.  `engine`
    runs on `device`."""
    from ..probe.pod import Container, Pod
    from ..probe.probeconfig import ProbeConfig
    from ..probe.resources import Resources
    from ..probe.runner import new_simulated_runner

    if not probe_path and not kube_pods:
        raise ValueError(
            "probe mode needs a model: a JSON file (--probe-path) or a "
            "cluster source (-n/-A)"
        )
    runner = new_simulated_runner(policies, engine=engine, device=device)
    if probe_path:
        with open(probe_path) as f:
            config = json.load(f)

        resources_json = config.get("Resources") or {}
        pods = []
        for p in resources_json.get("Pods") or []:
            containers = [
                Container(
                    name=c.get("Name", ""),
                    port=c["Port"],
                    protocol=c.get("Protocol", "TCP").upper(),
                    port_name=c.get("PortName", ""),
                )
                for c in p.get("Containers") or []
            ]
            pods.append(
                Pod(
                    namespace=p["Namespace"],
                    name=p["Name"],
                    labels=p.get("Labels") or {},
                    ip=p.get("IP", ""),
                    containers=containers,
                )
            )
        resources = Resources(
            namespaces=resources_json.get("Namespaces") or {}, pods=pods
        )

        for probe_spec in config.get("Probes") or []:
            port = IntOrString(probe_spec["Port"])
            protocol = probe_spec.get("Protocol", "TCP")
            table = runner.run_probe_for_config(
                ProbeConfig.port_protocol_config(port, protocol), resources
            )
            print(f"probe on port {port.value}, protocol {protocol}")
            print(f"Ingress:\n{table.render_ingress()}")
            print(f"Egress:\n{table.render_egress()}")
            print(f"Combined:\n{table.render_table()}\n\n")

    if kube_pods:
        import sys

        pods = []
        for kp in kube_pods:
            containers = []
            for c in kp.containers:
                if not c.ports:
                    print(
                        f"skipping container {kp.namespace}/{kp.name}/"
                        f"{c.name}, no ports available",
                        file=sys.stderr,
                    )
                    continue
                port = c.ports[0]
                containers.append(
                    Container(
                        name=c.name,
                        port=port.container_port,
                        protocol=port.protocol,
                        port_name=port.name,
                    )
                )
            if not containers:
                print(
                    f"skipping pod {kp.namespace}/{kp.name}, no containers "
                    f"available",
                    file=sys.stderr,
                )
                continue
            pods.append(
                Pod(
                    namespace=kp.namespace,
                    name=kp.name,
                    labels=kp.labels,
                    ip=kp.pod_ip,
                    containers=containers,
                )
            )
        resources = Resources(namespaces=dict(kube_namespaces or {}), pods=pods)
        table = runner.run_probe_for_config(
            ProbeConfig.all_available_config(), resources
        )
        print(f"Ingress:\n{table.render_ingress()}")
        print(f"Egress:\n{table.render_egress()}")
        print(f"Combined:\n{table.render_table()}\n\n")
