"""Dispatch-route harness of the port: the dynamic proof behind
tools/planlint.py over cyclonus_tpu_torch (a copy of the reference
package's tests/planharness.py, its scenarios run on the port's engine
and verdict service on --device).

The static pass proves every dispatch leaf records a DECLARED path and
every reachable feature interaction has a matrix cell; this harness
proves the declarations PREDICT: it arms the route recorder
(CYCLONUS_PLANHARNESS=1, read once at import — the strip contract),
sweeps the governing flag/argument matrix through the real public
entry points, and asserts the drained routes equal what
``planspec.predict`` derives from the PathSpec registry alone.  Where
the compatibility matrix says "raise", the harness asserts the live
dispatch raises the cell's EXACT declared message.

The quick slice must exercise every PathSpec whose coverage is "tier1"
(the census is asserted here); --full adds the slow ring-pipeline leg.

    python torch_tools/planharness.py [--device cpu] [--full] [--verbose]

HEADLINE and drive_headline are the route sequence of chip_smoke.py's
guards phase: tests/test_torch_planspec.py drives it through both
packages at a small size and holds their routes equal to HEADLINE, and
chip_smoke.py drives it through the port at the headline size.  This
module imports nothing of the package at its top, so importing it arms
nothing; main() arms the recorder before the scenarios import.
"""

from __future__ import annotations

import contextlib
import os
import random
import sys
from typing import Callable, Dict, List, Optional, Tuple

import _harness

#: (label, engine options, calls): the guards phase's sequence.  Options
#: are the port's constructor arguments (`tiers` True means the
#: benchmark's tier set); three calls of one case set run fused, split,
#: then steady.
HEADLINE_STEPS: Tuple[Tuple[str, Dict, int], ...] = (
    ("class", {"class_compress": "1"}, 1),
    ("packed", {"class_compress": "0"}, 3),
    ("tiered class", {"class_compress": "1", "tiers": True}, 1),
    ("tiered packed", {"class_compress": "0", "tiers": True}, 3),
    ("dense slab", {"class_compress": "0", "pack": False, "slab": "1"}, 3),
)

#: the routes HEADLINE_STEPS records, in order
HEADLINE: List[str] = (
    ["counts.classes"]
    + ["counts.pallas"] * 3 + ["counts.steady.default"]
    + ["counts.classes"]
    + ["counts.pallas"] * 3 + ["counts.steady.default"]
    + ["counts.pallas"] * 3 + ["counts.steady.slab"]
)


def drive_headline(make: Callable[..., object], cases, drain: Callable[[], List[str]],
                   call_kw: Optional[Dict] = None, clock=None):
    """Run HEADLINE_STEPS: `make(**options)` builds an engine, each call
    is `evaluate_grid_counts(cases, **call_kw)`.  Returns (routes
    drained after the sequence, {label: [counts of each call]},
    {label: [seconds of each call]}); `clock` (default perf_counter)
    times the calls, a caller on a card passing one that syncs first."""
    import time

    clock = clock or time.perf_counter
    counts, seconds = {}, {}
    drain()
    for label, options, calls in HEADLINE_STEPS:
        eng = make(**options)
        counts[label], seconds[label] = [], []
        for _ in range(calls):
            t0 = clock()
            counts[label].append(eng.evaluate_grid_counts(cases, **(call_kw or {})))
            seconds[label].append(clock() - t0)
        del eng
    return drain(), counts, seconds


class HarnessFailure(AssertionError):
    """A recorded route diverged from the registry's prediction; the
    message names the scenario and both routes."""


def _check(cond: bool, scenario: str, detail: str) -> None:
    if not cond:
        raise HarnessFailure(f"{scenario}: {detail}")


def _expect(scenario: str, actual: List[str], expected: List[str]) -> None:
    _check(
        actual == expected, scenario,
        f"recorded routes {actual} != predicted {expected}",
    )


@contextlib.contextmanager
def _env(**kv: Optional[str]):
    """Set/unset env vars, restoring exactly on exit."""
    old = {k: os.environ.get(k) for k in kv}
    try:
        for k, v in kv.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


class Ctx:
    """Shared scenario context: one lazily built engine per option set
    (24 pods, every program family), on `device`, plus the
    recorded-route union for the coverage census."""

    def __init__(self, seed: int, device):
        self.rng = random.Random(seed)
        self.device = device
        self._engines: Dict[Tuple, object] = {}
        self.covered: set = set()

    def _fixture(self, n_pods=24, n_policies=6):
        from cyclonus_tpu_torch.matcher import build_network_policies
        from cyclonus_tpu_torch.synthetic import build_synthetic

        pods, namespaces, policies = build_synthetic(n_pods, n_policies, random.Random(7))
        return build_network_policies(True, policies), pods, namespaces

    def engine(self, *, class_compress=None, tiers=False, size=(24, 6), **kw):
        key = (class_compress, tiers, size, tuple(sorted(kw.items())))
        if key not in self._engines:
            from cyclonus_tpu_torch.engine import TorchPolicyEngine

            policy, pods, namespaces = self._fixture(*size)
            if class_compress is not None:
                kw["class_compress"] = class_compress
            if tiers:
                kw["tiers"] = self._tierset()
            self._engines[key] = TorchPolicyEngine(
                policy, pods, namespaces, device=self.device, **kw
            )
        return self._engines[key]

    def _tierset(self):
        from cyclonus_tpu_torch.tiers.model import (
            AdminNetworkPolicy,
            TierRule,
            TierScope,
            TierSet,
        )

        return TierSet(anps=[
            AdminNetworkPolicy(
                name="harness-tier", priority=1, subject=TierScope(),
                ingress=[TierRule(action="Allow", peers=[TierScope()])],
            )
        ])

    def cases(self, q: int = 1):
        from cyclonus_tpu_torch.engine import PortCase

        base = [
            PortCase(80, "serve-80-tcp", "TCP"),
            PortCase(81, "serve-81-udp", "UDP"),
        ]
        return base[:q]

    def drain(self) -> List[str]:
        from cyclonus_tpu_torch.engine import planspec

        routes = planspec.drain()
        self.covered.update(routes)
        return routes


# --- scenarios -------------------------------------------------------------


def scenario_grid_routes(ctx: Ctx) -> Dict:
    """evaluate_grid routes on the dense engine and the class-compressed
    engine exactly as the `classes` feature predicts."""
    from cyclonus_tpu_torch.engine import planspec

    eng = ctx.engine()
    ctx.drain()
    eng.evaluate_grid(ctx.cases(1))
    _expect("grid.dense", ctx.drain(), [planspec.predict("grid", {})])

    ceng = ctx.engine(class_compress="1")
    _check(
        ceng.class_compression_stats()["active"],
        "grid.classes", "forced class compression did not activate",
    )
    ctx.drain()
    ceng.evaluate_grid(ctx.cases(1))
    _expect(
        "grid.classes", ctx.drain(),
        [planspec.predict("grid", {"classes": True})],
    )
    return {"routes": 2}


def scenario_sharded_grid_routes(ctx: Ctx) -> Dict:
    """evaluate_grid_sharded: explicit ring / allgather, the default
    (auto) schedule, and the class-compressed route."""
    from cyclonus_tpu_torch.engine import planspec

    eng = ctx.engine()
    cases = ctx.cases(1)
    ctx.drain()
    for schedule in ("ring", "allgather", None):
        kw = {} if schedule is None else {"schedule": schedule}
        eng.evaluate_grid_sharded(cases, **kw)
        feats = {} if schedule is None else {"schedule": schedule}
        _expect(
            f"grid.sharded[{schedule}]", ctx.drain(),
            [planspec.predict("grid_sharded", feats)],
        )
    ceng = ctx.engine(class_compress="1")
    ctx.drain()
    ceng.evaluate_grid_sharded(cases)
    _expect(
        "grid.sharded.classes", ctx.drain(),
        [planspec.predict("grid_sharded", {"classes": True})],
    )
    return {"routes": 4}


def scenario_counts_routes(ctx: Ctx) -> Dict:
    """evaluate_grid_counts backend routing: explicit xla, the default
    (the counts kernels), the compressed route — and the tiers x pallas
    matrix cell: auto-fallback silently, explicit request raises the
    cell's exact declared message (live AND predicted)."""
    from cyclonus_tpu_torch.engine import planspec

    eng = ctx.engine()
    cases = ctx.cases(1)
    ctx.drain()
    eng.evaluate_grid_counts(cases, backend="xla")
    _expect(
        "counts.xla", ctx.drain(),
        [planspec.predict("counts", {"backend": "xla"})],
    )
    eng.evaluate_grid_counts(cases)  # the default: the counts kernels
    _expect(
        "counts.auto", ctx.drain(),
        [planspec.predict("counts", {"platform": ctx.device.type})],
    )
    ceng = ctx.engine(class_compress="1")
    ctx.drain()
    ceng.evaluate_grid_counts(cases)
    _expect(
        "counts.classes", ctx.drain(),
        [planspec.predict("counts", {"classes": True, "platform": ctx.device.type})],
    )
    # tiers x backend=pallas on the dense plan, explicit: both sides
    # raise the SAME text
    teng = ctx.engine(tiers=True, pack=False)
    ctx.drain()
    live_msg = pred_msg = None
    try:
        teng.evaluate_grid_counts(cases, backend="pallas")
    except ValueError as e:
        live_msg = str(e)
    try:
        planspec.predict(
            "counts", {"backend": "pallas", "tiers": True, "pack": False}
        )
    except planspec.PlanError as e:
        pred_msg = str(e)
    _check(live_msg is not None, "counts.tiers-pallas", "live did not raise")
    _check(pred_msg is not None, "counts.tiers-pallas", "predict did not raise")
    _check(
        live_msg == pred_msg == planspec.interaction(
            "tiers", "backend=pallas"
        ).message,
        "counts.tiers-pallas",
        f"raise text diverged from the declared cell: live={live_msg!r} "
        f"predicted={pred_msg!r}",
    )
    ctx.drain()  # the raise recorded no route
    # auto on the tiered dense-plan engine falls back to the tile loop
    teng.evaluate_grid_counts(cases)
    _expect(
        "counts.tiers-auto", ctx.drain(),
        [planspec.predict("counts", {"tiers": True, "pack": False})],
    )
    # under the packed plan the tiered epilogue (K3) keeps the kernel
    pteng = ctx.engine(tiers=True, pack=True)
    ctx.drain()
    pteng.evaluate_grid_counts(cases, backend="pallas")
    _expect(
        "counts.tiers-packed", ctx.drain(),
        [planspec.predict("counts", {"backend": "pallas", "tiers": True, "pack": True})],
    )
    return {"routes": 5}


def scenario_counts_steady_routes(ctx: Ctx) -> Dict:
    """The counts kernel path and its steady-state sub-dispatch: the
    cold fused call and the split call record only counts.pallas; the
    third (pinned) call adds the counts.steady.* leaf — the default
    kernel, and the slab kernel (K6) on a dense-plan engine with the
    slab forced, on a cluster of 4,096 pods where the slab plan holds at
    the kernel's own tiles (the pack x slab matrix cell retires slab
    under the packed plan)."""
    from cyclonus_tpu_torch.engine import planspec

    cases = ctx.cases(1)
    with _env(CYCLONUS_AUTOTUNE="0"):
        eng = ctx.engine(pack=True)
        ctx.drain()
        cp = planspec.predict("counts", {"backend": "pallas", "pack": True})
        for _ in range(2):  # cold fused, then split
            eng.evaluate_grid_counts(cases, backend="pallas")
        _expect("counts.pallas.warmup", ctx.drain(), [cp, cp])
        eng.evaluate_grid_counts(cases, backend="pallas")  # steady
        _expect(
            "counts.steady.default", ctx.drain(),
            [cp, planspec.predict("counts_steady", {"pack": True})],
        )
        seng = ctx.engine(class_compress="0", pack=False, slab="1", size=(4096, 410))
        ctx.drain()
        cp0 = planspec.predict("counts", {"backend": "pallas", "pack": False})
        for _ in range(2):
            seng.evaluate_grid_counts(cases, backend="pallas")
        _expect("counts.slab.warmup", ctx.drain(), [cp0, cp0])
        _check(
            isinstance(seng._slab_plan_state, dict),
            "counts.steady.slab",
            f"slab plan did not engage: {seng._slab_plan_state!r}",
        )
        seng.evaluate_grid_counts(cases, backend="pallas")
        _expect(
            "counts.steady.slab", ctx.drain(),
            [cp0, planspec.predict("counts_steady", {"pack": False, "slab": True})],
        )
    return {"routes": 2}


def scenario_counts_sharded_routes(ctx: Ctx) -> Dict:
    """evaluate_grid_counts_sharded kernel routing: explicit xla and
    pallas, the default for the device, the compressed route, and the
    tiers x kernel=pallas cell's exact raise."""
    from cyclonus_tpu_torch.engine import planspec

    eng = ctx.engine()
    cases = ctx.cases(1)
    ctx.drain()
    for kernel in ("xla", "pallas"):
        eng.evaluate_grid_counts_sharded(cases, kernel=kernel)
        _expect(
            f"counts.sharded.{kernel}", ctx.drain(),
            [planspec.predict("counts_sharded", {"kernel": kernel})],
        )
    eng.evaluate_grid_counts_sharded(cases)
    _expect(
        "counts.sharded.auto", ctx.drain(),
        [planspec.predict("counts_sharded", {"platform": ctx.device.type})],
    )
    ceng = ctx.engine(class_compress="1")
    ctx.drain()
    ceng.evaluate_grid_counts_sharded(cases)
    _expect(
        "counts.sharded.classes", ctx.drain(),
        [planspec.predict("counts_sharded", {"classes": True})],
    )
    teng = ctx.engine(tiers=True, pack=False)
    ctx.drain()
    live_msg = pred_msg = None
    try:
        teng.evaluate_grid_counts_sharded(cases, kernel="pallas")
    except ValueError as e:
        live_msg = str(e)
    try:
        planspec.predict(
            "counts_sharded", {"kernel": "pallas", "tiers": True}
        )
    except planspec.PlanError as e:
        pred_msg = str(e)
    _check(
        live_msg is not None and live_msg == pred_msg,
        "counts.sharded.tiers-pallas",
        f"raise text diverged: live={live_msg!r} predicted={pred_msg!r}",
    )
    ctx.drain()
    # auto under tiers resolves to the tile loop (fallback cell)
    teng.evaluate_grid_counts_sharded(cases)
    _expect(
        "counts.sharded.tiers-auto", ctx.drain(),
        [planspec.predict("counts_sharded", {"tiers": True})],
    )
    return {"routes": 5}


def scenario_ring_family_routes(ctx: Ctx) -> Dict:
    """The ring-rotation counts family: single-axis ring and the
    hierarchical 2D ring (the pipelined leg is the slow scenario)."""
    from cyclonus_tpu_torch.engine import planspec

    eng = ctx.engine()
    cases = ctx.cases(1)
    ctx.drain()
    eng.evaluate_grid_counts_ring(cases)
    _expect(
        "counts.ring", ctx.drain(), [planspec.predict("counts_ring", {})]
    )
    eng.evaluate_grid_counts_ring2d(cases)
    _expect(
        "counts.ring2d", ctx.drain(), [planspec.predict("counts_ring2d", {})]
    )
    return {"routes": 2}


def scenario_analysis_routes(ctx: Ctx) -> Dict:
    """The point / streaming / analysis entries: blocked grid stream,
    the serve pair program, and the raw firing components."""
    from cyclonus_tpu_torch.engine import planspec

    eng = ctx.engine()
    cases = ctx.cases(1)
    ctx.drain()
    for _ in eng.iter_grid_blocks(cases, block=8):
        pass
    _expect(
        "grid.blocks", ctx.drain(), [planspec.predict("grid_blocks", {})]
    )
    eng.evaluate_pairs(cases, [(0, 1), (2, 3)])
    _expect("pairs.aot", ctx.drain(), [planspec.predict("pairs", {})])
    eng.firing_components(cases)
    _expect("firing.raw", ctx.drain(), [planspec.predict("firing", {})])
    return {"routes": 3}


_SERVE_NS = ("x", "y")
_SERVE_PODS = [
    ("x", "p0", {"app": "a0"}, "10.0.0.1"),
    ("y", "p1", {"app": "a1"}, "10.0.0.2"),
]


def scenario_serve_routes(ctx: Ctx) -> Dict:
    """serve's query routing: a deferred-readiness replica answers from
    the degraded scalar oracle; after mark_ready the live engine path
    (which itself dispatches the pair program) takes over — the
    warming x query matrix cell; an exhausted query_p99 budget sheds."""
    from cyclonus_tpu_torch.engine import planspec
    from cyclonus_tpu_torch.serve import VerdictService
    from cyclonus_tpu_torch.slo import EXHAUSTED, SloController
    from cyclonus_tpu_torch.worker.model import FlowQuery

    namespaces = {ns: {"ns": ns} for ns in _SERVE_NS}
    svc = VerdictService(_SERVE_PODS, namespaces, [], defer_ready=True, device=ctx.device)
    queries = [FlowQuery(src="x/p0", dst="y/p1", port=80, protocol="TCP")]
    ctx.drain()
    svc.query(queries)
    degraded = ctx.drain()
    _check(
        degraded[:1] == [planspec.predict("serve_query", {"warming": True})],
        "serve.query.degraded",
        f"warming query routed {degraded}",
    )
    svc.mark_ready()
    svc.query(queries)
    live = ctx.drain()
    _check(
        live[:1] == [planspec.predict("serve_query", {})],
        "serve.query.live",
        f"live query routed {live}",
    )
    svc2 = VerdictService(_SERVE_PODS, namespaces, [], slo=SloController(enforce=True),
                          device=ctx.device)
    svc2.slo.force_state("query_p99", EXHAUSTED)
    ctx.drain()
    out = svc2.query(queries)
    shed = ctx.drain()
    _check(
        all(v.shed for v in out)
        and shed[:1] == [planspec.predict("serve_query", {"shed": True})],
        "serve.query.shed",
        f"exhausted query routed {shed}",
    )
    return {"routes": 3}


def scenario_audit_routes(ctx: Ctx) -> Dict:
    """The audit plane's shadow-oracle check: a sampled verdict from a
    live service drains through the scalar re-evaluation route."""
    from cyclonus_tpu_torch.audit import AuditController
    from cyclonus_tpu_torch.engine import planspec
    from cyclonus_tpu_torch.serve import VerdictService
    from cyclonus_tpu_torch.worker.model import FlowQuery

    namespaces = {ns: {"ns": ns} for ns in _SERVE_NS}
    svc = VerdictService(
        _SERVE_PODS, namespaces, [],
        audit=AuditController(rate=1.0, seed=7, start_worker=False),
        device=ctx.device,
    )
    svc.query([FlowQuery(src="x/p0", dst="y/p1", port=80, protocol="TCP")])
    ctx.drain()
    checked = svc.audit.drain()
    routes = ctx.drain()
    _check(
        checked == 1
        and routes[:1] == [planspec.predict("serve_audit", {})],
        "serve.audit.check",
        f"audit check routed {routes} ({checked} checked)",
    )
    return {"routes": 1}


def scenario_ring_pipelined_route(ctx: Ctx) -> Dict:
    """The feed-forward ring pipeline (coverage: slow — the sweep is
    bench-scale, the route proof is not)."""
    from cyclonus_tpu_torch.engine import planspec

    eng = ctx.engine()
    ctx.drain()
    eng.mesh_counts_pipelined_eval_s(ctx.cases(1), reps=2)
    routes = ctx.drain()
    _check(
        routes[:1] == [planspec.predict("counts_ring_pipelined", {})],
        "counts.ring.pipelined",
        f"pipelined ring routed {routes}",
    )
    return {"routes": 1}


#: (name, fn, in_quick_slice)
SCENARIOS: List[Tuple[str, Callable[[Ctx], Dict], bool]] = [
    ("grid_routes", scenario_grid_routes, True),
    ("sharded_grid_routes", scenario_sharded_grid_routes, True),
    ("counts_routes", scenario_counts_routes, True),
    ("counts_steady_routes", scenario_counts_steady_routes, True),
    ("counts_sharded_routes", scenario_counts_sharded_routes, True),
    ("ring_family_routes", scenario_ring_family_routes, True),
    ("analysis_routes", scenario_analysis_routes, True),
    ("serve_routes", scenario_serve_routes, True),
    ("audit_routes", scenario_audit_routes, True),
    ("ring_pipelined_route", scenario_ring_pipelined_route, False),
]


def coverage_census(ctx: Ctx, *, quick: bool) -> Dict:
    """Every PathSpec whose coverage tier the run claims must have been
    recorded — the route-coverage gate."""
    from cyclonus_tpu_torch.engine import planspec

    want_tiers = {"tier1"} if quick else {"tier1", "slow"}
    missing = sorted(
        p.name for p in planspec.PATHS
        if p.coverage in want_tiers and p.name not in ctx.covered
    )
    _check(
        not missing, "coverage",
        f"declared {sorted(want_tiers)} path(s) never recorded: {missing}",
    )
    return {"covered": len(ctx.covered)}


def run(
    *,
    quick: bool = True,
    only: Optional[List[str]] = None,
    seed: int = 0,
    device="cpu",
    log: Optional[Callable[[str], None]] = None,
) -> Dict[str, Dict]:
    """Run the scenario set on `device`; raises HarnessFailure on the
    first route divergence.  Returns per-scenario stats."""
    ctx = Ctx(seed, device)
    results: Dict[str, Dict] = {}
    for name, fn, in_quick in SCENARIOS:
        if only is not None:
            if name not in only:
                continue
        elif quick and not in_quick:
            continue
        stats = fn(ctx)
        results[name] = stats
        if log is not None:
            log(f"planharness {name}: OK {stats}")
    if only is None:
        results["coverage_census"] = coverage_census(ctx, quick=quick)
        if log is not None:
            log(f"planharness coverage_census: OK {results['coverage_census']}")
    return results


def main(argv: Optional[List[str]] = None) -> int:
    # the recorder is armed at planspec IMPORT (strip contract): set the
    # flag before any cyclonus_tpu_torch import
    _harness.arm(CYCLONUS_PLANHARNESS="1")
    ap = _harness.parser(__doc__)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument(
        "--scenarios", nargs="*", default=None,
        help=f"subset (choices: {[n for n, _f, _q in SCENARIOS]})",
    )
    args = ap.parse_args(argv)
    device = _harness.resolve_device(args.device)
    results = run(
        quick=not args.full,
        only=args.scenarios,
        seed=args.seed,
        device=device,
        log=print if args.verbose else None,
    )
    print(
        f"planharness: {len(results)} scenario(s) passed "
        f"({', '.join(sorted(results))}) on {device}",
        file=sys.stderr,
    )
    _harness.report("plan", device, results)
    return 0


if __name__ == "__main__":
    sys.exit(main())
