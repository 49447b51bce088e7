"""The pod-axis mesh of the PyTorch port (engine/sharded.py and the mesh
family of engine/tiled.py) against the reference's mesh, on the CPU.

The reference runs its shard_map programs on its 8 virtual CPU devices
(cpu_mesh of tests/test_engine_sharded.py); the port runs the same
shards as a loop over a logical mesh (logical_mesh("cpu", n)).  The
same seeded inputs go through both packages, and every grid and count
must equal the reference's sharded result and the port's single-device
one: all values are boolean or integer, so the tolerance is zero.

Mirrors tests/test_engine_sharded.py, with two of its tests not ported:
  * test_overlapped_beats_allgather_throughput_min_of_5 is a wall-clock
    race between the schedules, which logical shards on one device
    cannot make meaningful (every shard runs in turn);
  * TestElasticResize::test_same_bucket_resize_zero_retrace pins the
    reuse of compiled sharded programs, and the port compiles none (the
    bucket helpers it also covers are tested by test_torch_engine).
and with the mesh cases of tests/test_tiers.py (TestMeshTieredCounts)."""

import functools
import random

import numpy as np
import pytest
from jax.sharding import Mesh as JaxMesh

from bench import build_synthetic as ref_synthetic
from cyclonus_tpu.engine import PortCase as RefPortCase
from cyclonus_tpu.engine import TpuPolicyEngine
from cyclonus_tpu.engine import sharded as ref_sharded
from cyclonus_tpu.kube.netpol import (
    IPBlock,
    IntOrString,
    LabelSelector,
    NetworkPolicyIngressRule,
    NetworkPolicyPeer,
    NetworkPolicyPort,
    NetworkPolicySpec,
    NetworkPolicy,
)
from cyclonus_tpu.matcher import build_network_policies as ref_build
from cyclonus_tpu.tiers.model import (
    AdminNetworkPolicy,
    BaselineAdminNetworkPolicy,
    TierPort,
    TierRule,
    TierScope,
    TierSet,
)
from cyclonus_tpu_torch.engine import PortCase, TorchPolicyEngine
from cyclonus_tpu_torch.engine import sharded
from cyclonus_tpu_torch.synthetic import build_synthetic

from test_engine_parity import default_cluster, mkpol
from test_engine_sharded import cpu_mesh
from test_tiers import anp, mk_cluster, oracle_table, pod_sel, rule
from test_torch_engine import fuzz_policies, grids
from test_torch_engine import port_policy as port_policy_simplified
from test_torch_tiers import port_policy, port_tiers

CASE_TUPLES = [(80, "serve-80-tcp", "TCP"), (81, "serve-81-udp", "UDP")]
REF_CASES = [RefPortCase(*c) for c in CASE_TUPLES]
CASES = [PortCase(*c) for c in CASE_TUPLES]
TIER_CASES = [PortCase(*c) for c in CASE_TUPLES + [(82, "serve-82-sctp", "SCTP")]]
SHARDS = [1, 2, 4, 8]


def mesh(n):
    return sharded.logical_mesh("cpu", n)


def assert_grids_equal(a, b):
    for k in ("ingress", "egress", "combined"):
        assert np.array_equal(a[k], b[k]), k


def ref_grids(engine, n_dev, schedule="ring"):
    return grids(engine.evaluate_grid_sharded(REF_CASES, mesh=cpu_mesh(n_dev), schedule=schedule))


def pair(policies, pods, namespaces, **kw):
    """(reference engine, port engine) of one raw policy list."""
    ref = TpuPolicyEngine(ref_build(True, policies), pods, namespaces, **kw)
    port = TorchPolicyEngine(
        port_policy_simplified(policies), pods, namespaces, device="cpu", **kw
    )
    return ref, port


@functools.lru_cache(maxsize=None)
def uneven(seed):
    """The 13-pod fuzz fixture of seed `seed`: (reference engine, port
    engine); 13 pods divide over no mesh width."""
    return pair(*fuzz_policies(seed, n_extra_pods=4))


@functools.lru_cache(maxsize=None)
def uneven_ref_ring(seed, n_dev):
    return ref_grids(uneven(seed)[0], n_dev)


@functools.lru_cache(maxsize=None)
def tiered_fixture():
    policies, pods, namespaces = fuzz_policies(7, n_extra_pods=4)
    tiers = TierSet(
        anps=[
            AdminNetworkPolicy(
                name="deny-a",
                priority=5,
                subject=TierScope(pod_selector=LabelSelector.make({"pod": "a"})),
                ingress=[
                    TierRule(
                        action="Deny",
                        peers=[TierScope(pod_selector=LabelSelector.make({"pod": "b"}))],
                        ports=[TierPort(protocol="TCP", port=IntOrString(80))],
                    )
                ],
            )
        ],
        banp=BaselineAdminNetworkPolicy(
            subject=TierScope(pod_selector=LabelSelector.make({"pod": "c"})),
            ingress=[TierRule(action="Deny", peers=[TierScope()])],
        ),
    )
    ref = TpuPolicyEngine(ref_build(True, policies), pods, namespaces, tiers=tiers)
    port = TorchPolicyEngine(
        port_policy(True, policies), pods, namespaces, device="cpu", tiers=port_tiers(tiers)
    )
    return ref, port


@functools.lru_cache(maxsize=None)
def ipv6_fixture():
    pods, namespaces = default_cluster()
    pods = [
        (ns, name, labels, f"2001:db8::{i + 1}")
        for i, (ns, name, labels, _ip) in enumerate(pods)
    ]
    policies = [
        mkpol(
            "v6",
            "x",
            LabelSelector.make(),
            ["Ingress"],
            ingress=[
                NetworkPolicyIngressRule(
                    ports=[],
                    from_=[
                        NetworkPolicyPeer(
                            ip_block=IPBlock.make("2001:db8::/112", ["2001:db8::4/126"])
                        )
                    ],
                )
            ],
        )
    ]
    return pair(policies, pods, namespaces)


@functools.lru_cache(maxsize=None)
def class_fixture():
    return pair(*fuzz_policies(2, n_extra_pods=6), class_compress="1")


@functools.lru_cache(maxsize=None)
def fixture_ref_ring(name):
    """The reference's ring grid of a fixture on its 8 virtual devices."""
    fixture = {"tiered": tiered_fixture, "class": class_fixture, "ipv6": ipv6_fixture}[name]
    return ref_grids(fixture()[0], 8)


class TestRingParity:
    @pytest.mark.parametrize("schedule", ["ring", "allgather"])
    @pytest.mark.parametrize("n_dev", SHARDS)
    @pytest.mark.parametrize("seed", [0, 3])
    def test_uneven_matches_reference(self, seed, n_dev, schedule):
        """13 pods over 1, 2, 4 and 8 shards (pad rows inert in both
        directions): the port's grid equals the reference's ring grid on
        as many virtual devices and the port's single-device grid, cut
        back to exactly n x n."""
        ref, port = uneven(seed)
        got = grids(port.evaluate_grid_sharded(CASES, mesh=mesh(n_dev), schedule=schedule))
        assert_grids_equal(got, uneven_ref_ring(seed, n_dev))
        assert_grids_equal(got, grids(port.evaluate_grid(CASES)))
        n = port.n_pods
        assert n == 13 and got["combined"].shape == (len(CASES), n, n)

    @pytest.mark.parametrize("schedule", ["ring", "allgather"])
    @pytest.mark.parametrize("n_dev", SHARDS)
    def test_synthetic_matches_reference(self, n_dev, schedule):
        """bench.py's synthetic cluster at 13 pods, whose verdicts differ
        from column to column (so a block written to the wrong columns
        shows): equal to the reference's ring grid and the port's
        single-device grid."""
        ref, port = synthetic_pair(13, n_pols=20)
        got = grids(port.evaluate_grid_sharded(CASES, mesh=mesh(n_dev), schedule=schedule))
        assert_grids_equal(got, synthetic_ref_ring(n_dev))
        assert_grids_equal(got, grids(port.evaluate_grid(CASES)))
        # ingress [Q, dst, src], egress [Q, src, dst]: dst columns differ
        assert len({got["ingress"][0, d, :].tobytes() for d in range(13)}) > 1
        assert len({got["egress"][0, :, d].tobytes() for d in range(13)}) > 1

    @pytest.mark.parametrize("seed", [1, 4])
    def test_ring_bit_identical_to_allgather(self, seed):
        policies, pods, namespaces = fuzz_policies(seed, n_extra_pods=2)
        ref, port = pair(policies, pods, namespaces)
        ring = grids(port.evaluate_grid_sharded(CASES, mesh=mesh(8), schedule="ring"))
        ag = grids(port.evaluate_grid_sharded(CASES, mesh=mesh(8), schedule="allgather"))
        assert_grids_equal(ring, ag)
        assert_grids_equal(ag, ref_grids(ref, 8, "allgather"))

    @pytest.mark.parametrize("schedule", ["ring", "allgather"])
    @pytest.mark.parametrize("n_dev", SHARDS)
    def test_tiered_engine(self, n_dev, schedule):
        """The tier lattice resolves inside each ring step (the tier
        arrays on the dst pod axis ride the bundle) and against the
        gathered tier blocks."""
        ref, port = tiered_fixture()
        got = grids(port.evaluate_grid_sharded(CASES, mesh=mesh(n_dev), schedule=schedule))
        assert_grids_equal(got, fixture_ref_ring("tiered"))
        assert_grids_equal(got, grids(port.evaluate_grid(CASES)))

    @pytest.mark.parametrize("schedule", ["ring", "allgather"])
    @pytest.mark.parametrize("n_dev", SHARDS)
    def test_class_compressed_engine(self, n_dev, schedule):
        """The class route shards the class axis and gathers back to pod
        axes: equal to the dense single-device grid."""
        ref, port = class_fixture()
        assert port.pod_classes() is not None
        got = grids(port.evaluate_grid_sharded(CASES, mesh=mesh(n_dev), schedule=schedule))
        assert_grids_equal(got, fixture_ref_ring("class"))
        assert_grids_equal(got, grids(pair(*fuzz_policies(2, n_extra_pods=6),
                                           class_compress="0")[1].evaluate_grid(CASES)))

    @pytest.mark.parametrize("schedule", ["ring", "allgather"])
    @pytest.mark.parametrize("n_dev", SHARDS)
    def test_ipv6_host_rows(self, n_dev, schedule):
        """Host-evaluated (IPv6) peer rows split their pod axis with the
        pods and pad inert."""
        ref, port = ipv6_fixture()
        assert "host_ip_match" in port._tensors["ingress"]
        got = grids(port.evaluate_grid_sharded(CASES, mesh=mesh(n_dev), schedule=schedule))
        assert_grids_equal(got, fixture_ref_ring("ipv6"))
        assert_grids_equal(got, grids(port.evaluate_grid(CASES)))

    def test_empty_cases_and_schedule_env(self, monkeypatch):
        _ref, port = uneven(0)
        assert port.evaluate_grid_sharded([]).combined.shape == (0, 13, 13)
        monkeypatch.setenv("CYCLONUS_MESH_SCHEDULE", "allgather")
        assert sharded.mesh_schedule() == "allgather"
        with pytest.raises(ValueError, match="unknown mesh schedule"):
            sharded.mesh_schedule("bogus")


@functools.lru_cache(maxsize=None)
def synthetic_pair(n_pods, n_pols=6, seed=3, pack=True):
    """(reference engine, port engine on the `pack` plan) of bench.py's
    synthetic cluster, built by each package's own generator."""
    from cyclonus_tpu_torch.matcher import build_network_policies

    pods, namespaces, policies = ref_synthetic(n_pods, n_pols, random.Random(seed))
    ref = TpuPolicyEngine(ref_build(True, policies), pods, namespaces)
    pods, namespaces, policies = build_synthetic(n_pods, n_pols, random.Random(seed))
    port = TorchPolicyEngine(
        build_network_policies(True, policies), pods, namespaces, device="cpu", pack=pack
    )
    return ref, port


@functools.lru_cache(maxsize=None)
def synthetic_ref_ring(n_dev):
    return ref_grids(synthetic_pair(13, n_pols=20)[0], n_dev)


@functools.lru_cache(maxsize=None)
def ref_mesh_counts():
    """The reference's counts of the 13-pod synthetic engine on its
    8-device mesh: sync ring, pipelined ring, sharded tile loop, ring2d."""
    ref, _ = synthetic_pair(13)
    m = cpu_mesh(8)
    return {
        "ring": ref.evaluate_grid_counts_ring(REF_CASES, block=4, mesh=m),
        "pipelined": ref.mesh_counts_pipelined_eval_s(REF_CASES, reps=2, block=4, mesh=m)[1],
        "sharded": ref.evaluate_grid_counts_sharded(REF_CASES, block=4, mesh=m, kernel="xla"),
        "ring2d": ref.evaluate_grid_counts_ring2d(
            REF_CASES, block=4, mesh=JaxMesh(np.array(m.devices).reshape(2, 4), ("dcn", "ici"))
        ),
    }


class TestMeshCounts:
    @pytest.mark.parametrize("pack", [True, False])
    @pytest.mark.parametrize("n_dev", SHARDS)
    def test_ring_and_pipelined_twin(self, n_dev, pack):
        """The sync ring and its pipelined twin equal the reference's on
        its 8 devices and the port's single-device counts."""
        want = ref_mesh_counts()
        _ref, port = synthetic_pair(13, pack=pack)
        assert want["ring"] == want["pipelined"]
        assert port.evaluate_grid_counts(CASES, block=4, backend="xla") == want["ring"]
        assert port.evaluate_grid_counts_ring(CASES, block=4, mesh=mesh(n_dev)) == want["ring"]
        dt, counts = port.mesh_counts_pipelined_eval_s(CASES, reps=3, block=4, mesh=mesh(n_dev))
        assert counts == want["pipelined"] and dt > 0

    @pytest.mark.parametrize("kernel", ["xla", "pallas"])
    @pytest.mark.parametrize("pack", [True, False])
    @pytest.mark.parametrize("n_dev", SHARDS)
    def test_sharded_counts(self, n_dev, pack, kernel):
        """Source rows split over the mesh: the tile loop, and the counts
        kernels' plain versions per shard (K1 under the packed plan, K4
        under pack=False) on each shard's rectangular operand pair."""
        want = ref_mesh_counts()["sharded"]
        _ref, port = synthetic_pair(13, pack=pack)
        got = port.evaluate_grid_counts_sharded(CASES, block=4, mesh=mesh(n_dev), kernel=kernel)
        assert got == want

    def test_sharded_default_kernel_follows_the_mesh(self, monkeypatch):
        """kernel None is "xla" on a CPU mesh: no counts kernel runs."""
        from cyclonus_tpu_torch.engine import dense_kernel, tiled

        def refuse(*a, **k):
            raise AssertionError("a counts kernel ran on the CPU mesh's default")

        monkeypatch.setattr(tiled, "verdict_counts_packed", refuse)
        monkeypatch.setattr(dense_kernel, "verdict_counts_rect", refuse)
        for pack in (True, False):
            _ref, port = synthetic_pair(13, pack=pack)
            got = port.evaluate_grid_counts_sharded(CASES, block=4, mesh=mesh(4))
            assert got == ref_mesh_counts()["sharded"]
        with pytest.raises(ValueError, match="unknown sharded counts kernel"):
            port.evaluate_grid_counts_sharded(CASES, mesh=mesh(2), kernel="bogus")

    @pytest.mark.parametrize("pack", [True, False])
    @pytest.mark.parametrize("shape", [(1, 1), (1, 2), (2, 2), (2, 4), (4, 2)])
    def test_ring2d(self, shape, pack):
        """The 2-D ring ("ici" hops inside a round, one "dcn" hop a round)
        equals the reference's on its (2, 4) mesh."""
        want = ref_mesh_counts()["ring2d"]
        _ref, port = synthetic_pair(13, pack=pack)
        m = sharded.logical_mesh("cpu", shape=shape)
        assert m.axis_names == ("dcn", "ici") and m.shape == {"dcn": shape[0], "ici": shape[1]}
        assert port.evaluate_grid_counts_ring2d(CASES, block=4, mesh=m) == want
        if shape == (2, 4):
            assert port.evaluate_grid_counts_ring2d(CASES, block=4) == want
            with pytest.raises(ValueError, match="ring2d needs"):
                port.evaluate_grid_counts_ring2d(CASES, mesh=mesh(8))

    def test_pipelined_twin_tiered(self):
        """Tier slabs rotate with the bundle: the pipelined twin on a
        tiered engine equals the tiered counts, the reference's twin on 4
        devices included."""
        policies, pods, namespaces = fuzz_policies(9, n_extra_pods=4)
        tiers = TierSet(
            anps=[
                AdminNetworkPolicy(
                    name="deny-b",
                    priority=3,
                    subject=TierScope(),
                    egress=[
                        TierRule(
                            action="Deny",
                            peers=[TierScope(pod_selector=LabelSelector.make({"pod": "b"}))],
                        )
                    ],
                )
            ]
        )
        ref = TpuPolicyEngine(ref_build(True, policies), pods, namespaces, tiers=tiers)
        port = TorchPolicyEngine(
            port_policy(True, policies), pods, namespaces, device="cpu", tiers=port_tiers(tiers)
        )
        want = ref.mesh_counts_pipelined_eval_s(REF_CASES, reps=2, block=4, mesh=cpu_mesh(4))[1]
        assert port.evaluate_grid_counts(CASES, block=4) == want
        for n_dev in SHARDS:
            assert port.mesh_counts_pipelined_eval_s(
                CASES, reps=2, block=4, mesh=mesh(n_dev))[1] == want

    @pytest.mark.parametrize("n_dev", SHARDS)
    def test_sharded_class_route(self, n_dev):
        """The class route splits the class axis: its row sums feed the
        exact host finish and equal the reference's sharded class route."""
        policies, pods, namespaces = fuzz_policies(2, n_extra_pods=6)
        ref, port = pair(policies, pods, namespaces, class_compress="1")
        assert port._class_counts_eligible(len(CASES))
        want = ref.evaluate_grid_counts_sharded(REF_CASES, block=4, mesh=cpu_mesh(8))
        got = port.evaluate_grid_counts_sharded(CASES, block=4, mesh=mesh(n_dev))
        assert got == want == port.evaluate_grid_counts(CASES)

    def test_empty_problems(self):
        _ref, port = synthetic_pair(13, pack=True)
        zero = {"ingress": 0, "egress": 0, "combined": 0, "cells": 0}
        assert port.evaluate_grid_counts_sharded([], mesh=mesh(2)) == zero
        assert port.evaluate_grid_counts_ring([], mesh=mesh(2)) == zero
        assert port.evaluate_grid_counts_ring2d([]) == zero
        assert port.mesh_counts_pipelined_eval_s([], mesh=mesh(2)) is None


class TestPeerBufferBytes:
    @pytest.mark.parametrize("pack", [True, False])
    @pytest.mark.parametrize("n_dev", SHARDS)
    def test_equals_reference(self, n_dev, pack):
        """The per-shard peer-side working set equals the reference's
        integer on the same padded tensors; ring < allgather at 8."""
        ref, port = synthetic_pair(64, n_pols=10)
        t_ref = dict(ref._tensors_with_cases(REF_CASES))
        t_ref, _ = ref_sharded._pad_pod_arrays(t_ref, 64, n_dev)
        t_port = dict(port._with_host_cases(CASES))
        t_port, _ = sharded.host._pad_pod_arrays(t_port, 64, n_dev)
        for schedule in ("ring", "allgather"):
            want = ref_sharded.peer_buffer_bytes(t_ref, n_dev, schedule, pack=pack)
            assert sharded.peer_buffer_bytes(t_port, n_dev, schedule, pack=pack) == want
        if n_dev == 8:
            assert 0 < sharded.peer_buffer_bytes(t_port, 8, "ring", pack=pack) < (
                sharded.peer_buffer_bytes(t_port, 8, "allgather"))

    def test_tiered_equals_reference(self):
        ref, port = tiered_fixture()
        t_ref, _ = ref_sharded._pad_pod_arrays(dict(ref._tensors_with_cases(REF_CASES)), 13, 8)
        t_port, _ = sharded.host._pad_pod_arrays(dict(port._with_host_cases(CASES)), 13, 8)
        for schedule, pack in (("ring", True), ("ring", False), ("allgather", False)):
            assert sharded.peer_buffer_bytes(t_port, 8, schedule, pack=pack) == (
                ref_sharded.peer_buffer_bytes(t_ref, 8, schedule, pack=pack))


class TestMesh:
    def test_logical_and_default_meshes(self):
        m = mesh(8)
        assert m.size == 8 and m.axis_names == ("x",) and m.shape == {"x": 8}
        assert {str(d) for d in m.flat} == {"cpu"}
        d = sharded.default_mesh("cpu")
        assert d.size == sharded.DEFAULT_LOGICAL_SHARDS and d.flat[0].type == "cpu"
        r = sharded.ring2d_mesh(d)
        assert r.shape == {"dcn": 2, "ici": 4}
        assert sharded.ring2d_mesh(mesh(3)).shape == {"dcn": 1, "ici": 3}
        with pytest.raises(ValueError, match="one name per axis"):
            sharded.Mesh(np.array(m.devices).reshape(2, 4), ("x",))

    def test_default_mesh_needs_a_device(self, monkeypatch):
        import torch

        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            sharded.default_mesh()

    def test_shard_tensors_split_rule(self):
        """Pod arrays split on axis 0, host_ip_match on its pod axis,
        policy tensors and port cases replicated (one upload a device)."""
        _ref, port = ipv6_fixture()
        t, padded = sharded.host._pad_pod_arrays(port._with_host_cases(CASES), port.n_pods, 4)
        parts = sharded.shard_tensors(t, mesh(4).flat, padded // 4)
        for d, part in enumerate(parts):
            rows = slice(d * padded // 4, (d + 1) * padded // 4)
            assert np.array_equal(part["pod_ns_id"].numpy(), t["pod_ns_id"][rows])
            assert np.array_equal(part["ingress"]["host_ip_match"].numpy(),
                                  t["ingress"]["host_ip_match"][:, rows])
            assert part["q_port"] is parts[0]["q_port"]
            assert part["ingress"]["target_ns"] is parts[0]["ingress"]["target_ns"]


class TestMeshTieredCounts:
    """The mesh cases of tests/test_tiers.py (TestMeshTieredCounts): the
    sharded, ring and ring2d counts and the sharded grid of a tiered
    engine against the tiered oracle, and the loud refusal of an
    explicit per-shard kernel under tiers."""

    def test_sharded_and_ring_counts_match_oracle_under_tiers(self):
        pods, namespaces = mk_cluster()
        netpol = NetworkPolicy(
            name="allow-80",
            namespace="x",
            spec=NetworkPolicySpec(
                pod_selector=pod_sel(app="web"),
                policy_types=["Ingress"],
                ingress=[
                    NetworkPolicyIngressRule(
                        ports=[NetworkPolicyPort(protocol="TCP", port=IntOrString(80))],
                        from_=[],
                    )
                ],
            ),
        )
        ts = TierSet(
            anps=[
                anp("deny-db", 1, TierScope(pod_selector=pod_sel(app="db")),
                    ingress=[rule("Deny", peers=[TierScope(namespace_selector=pod_sel(team="red"))])]),
                anp("pass-web", 2, TierScope(pod_selector=pod_sel(app="web")),
                    ingress=[rule("Pass")]),
            ],
            banp=BaselineAdminNetworkPolicy(
                subject=TierScope(namespace_selector=pod_sel(ns="z")),
                ingress=[rule("Deny")],
                egress=[rule("Allow")],
            ),
        )
        want = oracle_table(ref_build(True, [netpol]), ts, pods, namespaces)
        sums = {k: int(want[..., i].sum()) for i, k in enumerate(("ingress", "egress", "combined"))}
        engine = TorchPolicyEngine(
            port_policy(True, [netpol]), pods, namespaces, device="cpu", tiers=port_tiers(ts)
        )
        for name in ("sharded", "ring", "ring2d"):
            counts = getattr(engine, f"evaluate_grid_counts_{name}")(TIER_CASES, block=4)
            assert {k: counts[k] for k in sums} == sums, name
        g = grids(engine.evaluate_grid_sharded(TIER_CASES))
        got = np.stack([np.swapaxes(g["ingress"], 1, 2), g["egress"], g["combined"]], axis=-1)
        assert np.array_equal(got, want)

    @pytest.mark.parametrize("pack", [False, True])
    def test_explicit_pallas_counts_request_fails_loudly(self, pack):
        """A tiered engine's sharded counts take the tile loop: kernel
        None resolves to it, an explicit "pallas" raises with the
        reference's message, on both dtype plans."""
        pods, namespaces = mk_cluster()
        ts = TierSet(anps=[anp("d", 1, TierScope(), ingress=[rule("Deny")])])
        engine = TorchPolicyEngine(
            port_policy(True, []), pods, namespaces, device="cpu", tiers=port_tiers(ts),
            pack=pack,
        )
        with pytest.raises(ValueError, match="precedence-tier"):
            engine.evaluate_grid_counts_sharded(TIER_CASES, kernel="pallas")
        want = oracle_table(ref_build(True, []), ts, pods, namespaces)
        counts = engine.evaluate_grid_counts_sharded(TIER_CASES, block=8)
        assert counts["combined"] == int(want[..., 2].sum())
        assert counts == engine.evaluate_grid_counts(TIER_CASES, block=8)


@pytest.mark.cuda
class TestOnCard:
    @pytest.mark.parametrize("pack", [True, False])
    def test_sharded_kernels_and_ring_on_the_card(self, pack):
        """On logical shards of the card: K1 (packed) or K4 (pack=False)
        launches once a shard, and every count and grid equals the CPU
        engine's."""
        import torch

        from cyclonus_tpu_torch.engine import dense_kernel as dk
        from cyclonus_tpu_torch.engine import packed_kernel as pk

        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA device: the kernels have no CPU mode")
        _ref, cpu = synthetic_pair(13, n_pols=20, pack=pack)
        pods, namespaces, policies = build_synthetic(13, 20, random.Random(3))
        from cyclonus_tpu_torch.matcher import build_network_policies

        card = TorchPolicyEngine(build_network_policies(True, policies), pods, namespaces,
                                 device="cuda", pack=pack)
        want = cpu.evaluate_grid_counts(CASES, block=4, backend="xla")
        m = sharded.logical_mesh("cuda", 4)
        before = {**pk.LAUNCHES, **dk.LAUNCHES}
        got = card.evaluate_grid_counts_sharded(CASES, block=4, mesh=m)
        after = {**pk.LAUNCHES, **dk.LAUNCHES}
        name = "packed_counts" if pack else "dense_counts_1chunk"
        assert got == want and after[name] == before[name] + 4
        assert card.evaluate_grid_counts_ring(CASES, block=4, mesh=m) == want
        assert card.evaluate_grid_counts_ring2d(CASES, block=4) == want
        assert_grids_equal(grids(card.evaluate_grid_sharded(CASES, mesh=m)),
                           grids(cpu.evaluate_grid(CASES)))
