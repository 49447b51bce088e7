"""The port's dispatch-route registry (cyclonus_tpu_torch/engine/
planspec.py) against the reference's, on the CPU: the same call sequence
records the same route list in both packages — the class and dense
counts routes on both dtype plans, tiered and untiered, the slab modes
"0", "1" and "auto", backend="xla", the logical mesh's sharded and ring
routes, the grid, point and analysis entries, and serve's live, degraded
and shed queries — and the tiers x pallas cells raise the same declared
message in both.  The registry itself matches the reference's (less the
one path the port lacks), every path's gate is an existing
tests/test_torch_*.py file, the counts backend is resolved through the
matrix, and the port's route harness (torch_tools/planharness.py) runs
its quick slice as a subprocess.

The recorders are armed in-process by setting each planspec module's
ACTIVE (the strip contract reads the env var once, at import)."""

import json
import os
import random
import subprocess
import sys

import pytest

import bench
import cyclonus_tpu.engine.pallas_kernel as ref_pk
import cyclonus_tpu.engine.planspec as ref_ps
from cyclonus_tpu.engine import PortCase as RefPortCase
from cyclonus_tpu.engine import TpuPolicyEngine
from cyclonus_tpu.matcher import build_network_policies as ref_build
from cyclonus_tpu.tiers.model import TierSet as RefTierSet
from cyclonus_tpu.tiers.model import parse_tier_object as ref_parse_tier
from cyclonus_tpu_torch import synthetic
from cyclonus_tpu_torch.engine import PortCase, TorchPolicyEngine
from cyclonus_tpu_torch.engine import dense_kernel as dk
from cyclonus_tpu_torch.engine import planspec as ps
from cyclonus_tpu_torch.matcher import build_network_policies

from test_torch_engine import REPO

sys.path.insert(0, os.path.join(REPO, "torch_tools"))
import planharness  # noqa: E402  (imports nothing of the package at its top)

CASES = [(80, "serve-80-tcp", "TCP"), (81, "serve-81-udp", "UDP")]


def _cases(q=2):
    return [RefPortCase(*c) for c in CASES[:q]], [PortCase(*c) for c in CASES[:q]]


@pytest.fixture
def armed(monkeypatch):
    """Both route recorders on for the test, drained around it."""
    monkeypatch.setattr(ref_ps, "ACTIVE", True)
    monkeypatch.setattr(ps, "ACTIVE", True)
    ref_ps.drain()
    ps.drain()
    yield
    ref_ps.drain()
    ps.drain()


@pytest.fixture
def tiny_slab(monkeypatch):
    """Both packages' slab tiles and window ceiling set to 8, so a small
    cluster has a slab plan."""
    for mod in (ref_pk, dk):
        monkeypatch.setattr(mod, "SLAB_BS", 8)
        monkeypatch.setattr(mod, "SLAB_BD", 8)
        monkeypatch.setattr(mod, "SLAB_W", 8)


def _ref_tiers(tiers):
    """The port's TierSet as the reference's, through the dict round trip."""
    return RefTierSet(
        anps=[ref_parse_tier(a.to_dict()) for a in tiers.anps],
        banp=None if tiers.banp is None else ref_parse_tier(tiers.banp.to_dict()),
    )


def _factory(monkeypatch, n_pods=48, n_policies=8):
    """make(**options) -> (reference engine, port engine) of one
    synthetic cluster; options are the port's constructor arguments, the
    reference's pack and slab go through its env flags."""
    pods, namespaces, ref_policies = bench.build_synthetic(n_pods, n_policies, random.Random(7))
    _pods, _ns, policies = synthetic.build_synthetic(n_pods, n_policies, random.Random(7))
    ref_policy, policy = ref_build(True, ref_policies), build_network_policies(True, policies)
    tiers = synthetic.bench_tiers()

    def make(*, class_compress="0", tiers_on=False, pack=True, slab="0"):
        monkeypatch.setenv("CYCLONUS_PACK", "1" if pack else "0")
        monkeypatch.setenv("CYCLONUS_PALLAS_SLAB", slab)
        ref = TpuPolicyEngine(ref_policy, pods, namespaces, class_compress=class_compress,
                              tiers=_ref_tiers(tiers) if tiers_on else None)
        port = TorchPolicyEngine(policy, pods, namespaces, device="cpu",
                                 class_compress=class_compress, pack=pack, slab=slab,
                                 tiers=tiers if tiers_on else None)
        return ref, port

    return make


def _both(ref_call, port_call):
    """Run one call in each package: (ref result or raise text, routes),
    (port result or raise text, routes)."""
    out = []
    for call, mod in ((ref_call, ref_ps), (port_call, ps)):
        try:
            res = call()
        except ValueError as e:
            res = ("raised", str(e))
        out.append((res, mod.drain()))
    return out


class TestCountsRoutes:
    @pytest.mark.parametrize("backend", ["pallas", "xla"])
    @pytest.mark.parametrize("class_compress", ["0", "1"])
    @pytest.mark.parametrize("tiers_on", [False, True], ids=["untiered", "tiered"])
    @pytest.mark.parametrize("pack", [True, False], ids=["packed", "dense"])
    def test_same_calls_same_routes(self, armed, monkeypatch, pack, tiers_on, class_compress,
                                    backend):
        """Three calls of one case set (fused, split, steady on the
        kernel route): equal counts, or the same raise, and equal route
        lists."""
        ref, port = _factory(monkeypatch)(class_compress=class_compress, tiers_on=tiers_on,
                                          pack=pack)
        ref_cases, cases = _cases()
        ref_routes, routes = [], []
        for _ in range(3):
            (a, ra), (b, rb) = _both(
                lambda: ref.evaluate_grid_counts(ref_cases, backend=backend),
                lambda: port.evaluate_grid_counts(cases, backend=backend),
            )
            assert a == b
            ref_routes += ra
            routes += rb
        assert routes == ref_routes
        if tiers_on and not pack and backend == "pallas":
            assert a[0] == "raised" and a[1] == ps.interaction("tiers", "backend=pallas").message
            assert routes == [] or class_compress == "1"

    @pytest.mark.parametrize("slab", ["0", "1", "auto"])
    def test_slab_modes(self, armed, monkeypatch, tiny_slab, slab):
        """The dense plan's slab modes on the CPU: "1" takes K6 at the
        steady call, "0" and "auto" (which plans on a card only, as the
        reference's on its TPU) the default kernel."""
        ref, port = _factory(monkeypatch)(pack=False, slab=slab)
        ref_cases, cases = _cases()
        ref_routes, routes = [], []
        for _ in range(4):
            (a, ra), (b, rb) = _both(
                lambda: ref.evaluate_grid_counts(ref_cases, backend="pallas"),
                lambda: port.evaluate_grid_counts(cases),
            )
            assert a == b
            ref_routes += ra
            routes += rb
        assert routes == ref_routes
        leaf = "counts.steady.slab" if slab == "1" else "counts.steady.default"
        assert routes == ["counts.pallas"] * 3 + [leaf, "counts.pallas", leaf]

    def test_port_default_backend_is_the_kernels(self, armed, monkeypatch):
        """backend=None: the port's default is its counts kernels on any
        device (predict's "pallas"), where the reference's CPU default is
        its tile loop."""
        _ref, port = _factory(monkeypatch)()
        port.evaluate_grid_counts(_cases()[1])
        assert ps.drain() == [ps.predict("counts", {"platform": "cpu"})] == ["counts.pallas"]

    def test_backend_is_resolved_through_the_matrix(self, monkeypatch):
        """evaluate_grid_counts calls planspec.resolve_counts_backend, and
        the class route's kernel comes off the (classes, backend) cells."""
        seen = []
        real = ps.resolve_counts_backend

        def spy(**kw):
            seen.append(kw)
            return real(**kw)

        monkeypatch.setattr(ps, "resolve_counts_backend", spy)
        _ref, port = _factory(monkeypatch)(class_compress="1")
        port.evaluate_grid_counts(_cases()[1], backend="xla")
        assert seen and seen[0]["backend"] == "xla" and seen[0]["explicit"]
        assert ps.resolve_class_counts_kernel(backend="pallas", pack=True) == "pallas"
        assert ps.resolve_class_counts_kernel(backend="pallas", pack=False) == "xla"
        assert ps.resolve_class_counts_kernel(backend="xla", pack=True) == "xla"


class TestHeadline:
    def test_sequence_records_headline_in_both(self, armed, monkeypatch, tiny_slab):
        """chip_smoke.py's guards sequence at a small size: both packages
        record planharness.HEADLINE, and every call's counts are equal."""
        make = _factory(monkeypatch)
        pairs = {}

        def make_ref(**options):
            key = tuple(sorted(options.items()))
            pairs[key] = make(class_compress=options["class_compress"],
                              tiers_on=options.get("tiers", False),
                              pack=options.get("pack", True), slab=options.get("slab", "0"))
            return pairs[key][0]

        def make_port(**options):
            return pairs[tuple(sorted(options.items()))][1]

        ref_cases, cases = _cases()
        ref_routes, ref_counts, _ = planharness.drive_headline(
            make_ref, ref_cases, ref_ps.drain, call_kw={"backend": "pallas"}
        )
        routes, counts, _ = planharness.drive_headline(make_port, cases, ps.drain)
        assert ref_routes == planharness.HEADLINE
        assert routes == planharness.HEADLINE
        assert counts == ref_counts
        assert counts["class"][0] == counts["packed"][0] == counts["dense slab"][0]


class TestOtherEntries:
    def test_grid_point_and_analysis_routes(self, armed, monkeypatch):
        make = _factory(monkeypatch)
        ref_cases, cases = _cases(1)
        ref_routes, routes = [], []
        for cc in ("0", "1"):
            ref, port = make(class_compress=cc)
            for ref_call, port_call in (
                (lambda: ref.evaluate_grid(ref_cases).combined.sum(),
                 lambda: int(port.evaluate_grid(cases).combined.sum())),
                (lambda: ref.evaluate_pairs(ref_cases, [(0, 1), (2, 3)]).tolist(),
                 lambda: port.evaluate_pairs(cases, [(0, 1), (2, 3)]).tolist()),
                (lambda: sum(int(b[3].sum()) for b in ref.iter_grid_blocks(ref_cases, block=16)),
                 lambda: sum(int(b[3].sum()) for b in port.iter_grid_blocks(cases, block=16))),
                (lambda: sorted(ref.firing_components(ref_cases)),
                 lambda: sorted(port.firing_components(cases))),
            ):
                (a, ra), (b, rb) = _both(ref_call, port_call)
                assert a == b
                ref_routes += ra
                routes += rb
        assert routes == ref_routes
        assert set(routes) == {"grid.dense", "grid.classes", "pairs.aot", "grid.blocks",
                               "firing.raw"}

    def test_mesh_routes(self, armed, monkeypatch):
        """The logical mesh (8 shards of the CPU) against the reference's
        8 virtual CPU devices: sharded grids by schedule, sharded counts
        by kernel (and the tiered raise), the ring family."""
        make = _factory(monkeypatch)
        ref_cases, cases = _cases(1)
        ref, port = make()
        cref, cport = make(class_compress="1")
        tref, tport = make(tiers_on=True, pack=False)
        calls = [
            (lambda: ref.evaluate_grid_sharded(ref_cases, schedule="ring").combined.sum(),
             lambda: int(port.evaluate_grid_sharded(cases, schedule="ring").combined.sum())),
            (lambda: ref.evaluate_grid_sharded(ref_cases, schedule="allgather").combined.sum(),
             lambda: int(port.evaluate_grid_sharded(cases, schedule="allgather").combined.sum())),
            (lambda: cref.evaluate_grid_sharded(ref_cases).combined.sum(),
             lambda: int(cport.evaluate_grid_sharded(cases).combined.sum())),
            (lambda: ref.evaluate_grid_counts_sharded(ref_cases, kernel="xla"),
             lambda: port.evaluate_grid_counts_sharded(cases, kernel="xla")),
            (lambda: ref.evaluate_grid_counts_sharded(ref_cases),
             lambda: port.evaluate_grid_counts_sharded(cases)),
            (lambda: cref.evaluate_grid_counts_sharded(ref_cases),
             lambda: cport.evaluate_grid_counts_sharded(cases)),
            (lambda: tref.evaluate_grid_counts_sharded(ref_cases, kernel="pallas"),
             lambda: tport.evaluate_grid_counts_sharded(cases, kernel="pallas")),
            (lambda: tref.evaluate_grid_counts_sharded(ref_cases),
             lambda: tport.evaluate_grid_counts_sharded(cases)),
            (lambda: ref.evaluate_grid_counts_ring(ref_cases),
             lambda: port.evaluate_grid_counts_ring(cases)),
            (lambda: ref.evaluate_grid_counts_ring2d(ref_cases),
             lambda: port.evaluate_grid_counts_ring2d(cases)),
            (lambda: ref.mesh_counts_pipelined_eval_s(ref_cases, reps=2)[1],
             lambda: port.mesh_counts_pipelined_eval_s(cases, reps=2)[1]),
        ]
        ref_routes, routes = [], []
        for ref_call, port_call in calls:
            (a, ra), (b, rb) = _both(ref_call, port_call)
            assert a == b
            ref_routes += ra
            routes += rb
        assert routes == ref_routes
        assert routes == [
            "grid.sharded.ring", "grid.sharded.allgather", "grid.sharded.classes",
            "counts.sharded.xla", "counts.sharded.xla", "counts.sharded.classes",
            "counts.sharded.xla", "counts.ring", "counts.ring2d", "counts.ring.pipelined",
        ]

    def test_serve_routes(self, armed):
        """A warming replica answers degraded, a ready one live (each
        live query then runs the pair program), an exhausted query_p99
        budget sheds: the same routes from both packages' services."""
        from cyclonus_tpu.serve import VerdictService as RefService
        from cyclonus_tpu.slo import EXHAUSTED as REF_EXHAUSTED
        from cyclonus_tpu.slo import SloController as RefSlo
        from cyclonus_tpu.worker.model import FlowQuery as RefFlowQuery
        from cyclonus_tpu_torch.serve import VerdictService
        from cyclonus_tpu_torch.slo import EXHAUSTED, SloController
        from cyclonus_tpu_torch.worker.model import FlowQuery

        namespaces = {ns: {"ns": ns} for ns in ("x", "y")}
        pods = [("x", "p0", {"app": "a0"}, "10.0.0.1"), ("y", "p1", {"app": "a1"}, "10.0.0.2")]
        q = dict(src="x/p0", dst="y/p1", port=80, protocol="TCP")
        ref = RefService(pods, namespaces, [], defer_ready=True)
        svc = VerdictService(pods, namespaces, [], defer_ready=True, device="cpu")
        ref_shed = RefService(pods, namespaces, [], slo=RefSlo(enforce=True))
        shed = VerdictService(pods, namespaces, [], slo=SloController(enforce=True), device="cpu")
        ref_shed.slo.force_state("query_p99", REF_EXHAUSTED)
        shed.slo.force_state("query_p99", EXHAUSTED)
        ref_routes, routes = [], []
        for step in ("degraded", "ready", "live", "shed"):
            if step == "ready":
                ref.mark_ready()
                svc.mark_ready()
                continue
            a_svc, b_svc = (ref_shed, shed) if step == "shed" else (ref, svc)
            (a, ra), (b, rb) = _both(
                lambda: [(v.ingress, v.egress, v.combined, v.shed)
                         for v in a_svc.query([RefFlowQuery(**q)])],
                lambda: [(v.ingress, v.egress, v.combined, v.shed)
                         for v in b_svc.query([FlowQuery(**q)])],
            )
            assert a == b
            ref_routes += ra
            routes += rb
        assert routes == ref_routes
        assert routes == ["serve.query.degraded", "serve.query.live", "pairs.aot",
                          "serve.query.shed"]


class TestRegistry:
    def test_paths_are_the_references_less_packed_tuned(self):
        ref_names = [p.name for p in ref_ps.PATHS]
        assert [p.name for p in ps.PATHS] == [
            n for n in ref_names if n != "counts.steady.packed_tuned"
        ]
        for p in ps.PATHS:
            r = ref_ps.REGISTRY[p.name]
            assert (p.entry, p.stages, p.cache_key_family) == (r.entry, r.stages,
                                                               r.cache_key_family)
            when = {k: v for k, v in r.when.items() if k != "tuned"}
            assert dict(p.when) == when, p.name

    def test_interactions_are_the_references(self):
        def cells(mod):
            return [(i.a, i.b, i.verdict, i.on_explicit, i.unless, i.resolves_to, i.message)
                    for i in mod.INTERACTIONS]

        assert cells(ps) == cells(ref_ps)

    @pytest.mark.parametrize("path", [p.name for p in ps.PATHS])
    def test_gate_is_an_existing_port_test(self, path):
        gate = ps.REGISTRY[path].gate
        assert gate.startswith("tests/test_torch_") and gate.endswith(".py")
        assert os.path.exists(os.path.join(REPO, gate))

    def test_predict_agrees_with_the_reference_where_the_defaults_agree(self):
        for entry, feats in (
            ("counts", {"backend": "xla"}), ("counts", {"classes": True}),
            ("counts", {"backend": "pallas", "tiers": True, "pack": True,
                        "packed_tier_ok": True}),
            ("counts_steady", {"pack": False, "slab": True}), ("counts_steady", {"pack": True}),
            ("counts_sharded", {"kernel": "xla"}), ("counts_sharded", {"tiers": True}),
            ("grid", {}), ("grid_sharded", {"schedule": "allgather"}),
            ("serve_query", {"warming": True}), ("serve_query", {"shed": True}),
        ):
            assert ps.predict(entry, feats) == ref_ps.predict(entry, feats), (entry, feats)

    def test_recorder_stripped_when_unarmed(self, monkeypatch):
        assert not ps.ACTIVE
        _ref, port = _factory(monkeypatch)()
        port.evaluate_grid_counts(_cases()[1])
        assert ps.drain() == []

    def test_planlint_extraction_matches_the_manifest(self):
        """tools/planlint.py reads the port's registry off the AST: the
        same paths, gates and cells as the runtime manifest."""
        sys.path.insert(0, os.path.join(REPO, "tools"))
        import planlint

        reg = planlint.load_registry(os.path.join(REPO, "cyclonus_tpu_torch", "engine",
                                                  "planspec.py"))
        static, runtime = planlint.build_manifest(reg), ps.manifest()
        keys = ("name", "entry", "stages", "flags", "gate", "coverage", "when")
        assert [{k: p[k] for k in keys} for p in static["paths"]] == [
            {k: p[k] for k in keys} for p in runtime["paths"]
        ]
        assert static["interactions"] == runtime["interactions"]


def test_planharness_quick_slice_runs():
    """torch_tools/planharness.py --device cpu: every tier1 path recorded
    and predicted, and the last line is its JSON result."""
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "torch_tools", "planharness.py"), "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, JAX_PLATFORMS="cpu"),
    )
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["harness"] == "plan" and out["ok"]
    tier1 = sum(p.coverage == "tier1" for p in ps.PATHS)
    assert out["results"]["coverage_census"]["covered"] >= tier1
