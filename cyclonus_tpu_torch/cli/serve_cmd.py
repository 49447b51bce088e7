"""`serve`: the long-running verdict service (cyclonus_tpu_torch/serve;
the reference's cli/serve_cmd.py).

Boot a cluster (policies from YAML plus a synthesized or synthetic pod
set), then answer a JSON-lines stream of Batch envelopes on stdin —
Deltas patch the live engine on the device, Queries answer from it — one
reply object per line, until EOF.  The reference's --metrics-port HTTP
surface is left out."""

from __future__ import annotations

import sys


def setup_serve(sub) -> None:
    cmd = sub.add_parser(
        "serve",
        help="run the persistent verdict service: stream deltas/queries "
        "over stdin/stdout (worker wire Batch envelopes), with "
        "incremental patches of the live engine",
    )
    cmd.add_argument(
        "--policies",
        default="",
        metavar="PATH",
        help="YAML file/dir of NetworkPolicies for the initial state "
        "(default: start with no policies)",
    )
    cmd.add_argument(
        "--anps",
        default="",
        metavar="PATH",
        help="YAML file/dir of AdminNetworkPolicy / "
        "BaselineAdminNetworkPolicy objects layered over --policies",
    )
    cmd.add_argument(
        "--synthesize-pods",
        action="store_true",
        help="synthesize an initial pod set exercising every policy-"
        "referenced shape (analysis.synthesize_cluster) instead of "
        "starting pod-less",
    )
    cmd.add_argument(
        "--synthetic-pods",
        type=int,
        default=0,
        metavar="N",
        help="start with N synthetic pods across --synthetic-namespaces "
        "namespaces (seeded; for benchmarks and smoke tests)",
    )
    cmd.add_argument(
        "--synthetic-namespaces",
        type=int,
        default=4,
        metavar="M",
        help="namespace count for --synthetic-pods (default 4)",
    )
    cmd.add_argument("--seed", type=int, default=7, help="synthetic-cluster seed")
    cmd.add_argument(
        "--no-simplify",
        action="store_true",
        help="compile policies without matcher simplification",
    )
    cmd.add_argument(
        "--class-compress",
        default="",
        choices=["", "auto", "1", "0"],
        help="override CYCLONUS_CLASS_COMPRESS for the serving engine",
    )
    cmd.add_argument(
        "--max-lines",
        type=int,
        default=None,
        metavar="N",
        help="exit after N input lines (smoke tests)",
    )
    cmd.add_argument(
        "--no-prewarm",
        action="store_true",
        help="skip the startup prewarm of the query path.  "
        "CYCLONUS_SERVE_PREWARM=0 is the env twin.",
    )
    cmd.add_argument(
        "--device",
        default=None,
        help="torch device of the engine (default: the current CUDA "
        "device, and an error without one; 'cpu' runs it on the CPU)",
    )
    cmd.set_defaults(func=run_serve)


def synthetic_cluster(n_pods: int, n_ns: int, seed: int):
    """A seeded synthetic pod set with bench-shaped label diversity
    (app/tier cycling) — the serve smoke tests start here."""
    import random

    rng = random.Random(seed)
    n_ns = max(1, n_ns)
    namespaces = {
        f"ns{i}": {"ns": f"ns{i}", "team": f"team{i % 7}"}
        for i in range(n_ns)
    }
    pods = []
    for i in range(n_pods):
        ns = f"ns{rng.randrange(n_ns)}"
        labels = {
            "pod": f"p{i % 100}",
            "app": f"app{i % 20}",
            "tier": f"tier{i % 5}",
        }
        ip = f"10.{(i >> 16) & 255}.{(i >> 8) & 255}.{i & 255}"
        pods.append((ns, f"pod-{i}", labels, ip))
    return pods, namespaces


def run_serve(args) -> int:
    from ..kube.yaml_io import load_policies_from_path
    from ..serve import VerdictService, run_stdio
    from ..serve.service import prewarm_enabled

    policies = load_policies_from_path(args.policies) if args.policies else []
    tiers = None
    if args.anps:
        from ..tiers.model import load_tier_set_from_path

        tiers = load_tier_set_from_path(args.anps) or None
    pods, namespaces = [], {}
    if args.synthetic_pods:
        pods, namespaces = synthetic_cluster(
            args.synthetic_pods, args.synthetic_namespaces, args.seed
        )
    elif args.synthesize_pods and policies:
        from ..analysis import synthesize_cluster
        from ..matcher.builder import build_network_policies

        compiled = build_network_policies(not args.no_simplify, policies)
        pods, namespaces = synthesize_cluster(compiled)
    for p in policies:
        namespaces.setdefault(p.effective_namespace(), {})
    prewarm_on = not args.no_prewarm and prewarm_enabled()
    service = VerdictService(
        pods,
        namespaces,
        policies,
        simplify=not args.no_simplify,
        class_compress=args.class_compress or None,
        tiers=tiers,
        defer_ready=prewarm_on,
        device=args.device,
    )
    if prewarm_on:
        pw = service.prewarm()
        print(
            f"serve: prewarmed the query path in {pw['seconds']}s",
            file=sys.stderr,
        )
    st = service.state()
    tier_note = ""
    if st["tiers"]["active"]:
        tier_note = (
            f", {st['tiers']['anp_count']} ANPs"
            f"{' + BANP' if st['tiers']['banp'] else ''}"
        )
    print(
        f"serve: engine ready on {service.engine.device} — {st['pods']} pods, "
        f"{st['policies']} policies{tier_note} (epoch {st['epoch']}); "
        f"reading batches from stdin",
        file=sys.stderr,
    )
    run_stdio(service, sys.stdin, sys.stdout, max_lines=args.max_lines)
    return 0
