"""The scale phase of chip_smoke.py (phase 14) at CPU size, against the
reference: bench.py's mega_class shape cut to 20,000 pods x 400 policies
x 16 namespaces (its seed, 20260803) and the full-grid tables mode at
3,000 pods x 300 policies (bench.py's seed), each package fed the same
synthetic cluster.  Exact: the class compression stats, the class
route's eligibility and byte estimate, the counts on both routes, the
pairs, the class-reduction audit and the grids.

Then the shape limits the scale legs run up against, the same in both
packages and both dtype plans: the int32 partial-count guard of the
counts kernels at the first padded dst axis with bs * nd_pad >= 2^31
(operands on torch's meta device and jax.eval_shape: no allocation),
the engine's check of it before the upload, the tile loop's block
shrink, and the class route's bypass at _CLASS_MAX_PODS_EXACT."""

import functools
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
import cyclonus_tpu.engine.api as ref_api
import cyclonus_tpu.engine.pallas_kernel as ref_pk
import cyclonus_tpu.engine.tiled as ref_tiled
from cyclonus_tpu.analysis import audit_class_reduction as ref_audit
from cyclonus_tpu.engine import PortCase as RefPortCase
from cyclonus_tpu.engine import TpuPolicyEngine
from cyclonus_tpu.matcher import build_network_policies as ref_build
from cyclonus_tpu_torch import synthetic
from cyclonus_tpu_torch.analysis import audit_class_reduction
from cyclonus_tpu_torch.engine import PortCase, TorchPolicyEngine, api, host, tiled
from cyclonus_tpu_torch.engine import dense_kernel as dk
from cyclonus_tpu_torch.engine import packed_kernel as pk
from cyclonus_tpu_torch.matcher import build_network_policies

CASES = [(80, "serve-80-tcp", "TCP"), (81, "serve-81-udp", "UDP")]
REF_CASES = [RefPortCase(*c) for c in CASES]
PORT_CASES = [PortCase(*c) for c in CASES]

#: chip_smoke's mega_class leg (1,000,000 x 2,000 x 512) cut to CPU size
MEGA = (20_000, 400, 16)
MEGA_SEED = 20260803
#: chip_smoke's tables leg (25,000 x 2,500) cut to CPU size
TABLES = (3_000, 300)
SEED = 20260729

#: bucketed pod counts around the int32 bounds: 2^21 (the dense plan's
#: K4/K5 at bs 1,024) and 2^22 (bs 512, both plans)
BOUNDS = (2**21 - 1024, 2**21, 2**22 - 1024, 2**22)


def cluster(n_pods, n_policies, seed, n_ns=None):
    """(pods, namespaces, reference Policy, port Policy): each package's
    synthetic generator from the same seed."""
    pods, namespaces, ref_policies = bench.build_synthetic(
        n_pods, n_policies, random.Random(seed), n_ns=n_ns)
    port_pods, port_namespaces, policies = synthetic.build_synthetic(
        n_pods, n_policies, random.Random(seed), n_ns=n_ns)
    assert (port_pods, port_namespaces) == (pods, namespaces)
    return pods, namespaces, ref_build(True, ref_policies), build_network_policies(True, policies)


def engines(c, **kw):
    pods, namespaces, ref_policy, policy = c
    return (TpuPolicyEngine(ref_policy, pods, namespaces, **kw),
            TorchPolicyEngine(policy, pods, namespaces, device="cpu", **kw))


@pytest.fixture(scope="module")
def mega():
    c = cluster(*MEGA[:2], MEGA_SEED, n_ns=MEGA[2])
    return c, engines(c)


class TestMegaClass:
    def test_class_compression_stats(self, mega):
        _, (ref, port) = mega
        want = dict(ref.class_compression_stats())
        want.pop("gather_s")  # the reference's last gather seconds
        got = port.class_compression_stats()
        assert got == want
        assert got["active"] and 1 < got["classes"] < MEGA[0]

    def test_eligible_and_byte_estimate(self, mega, monkeypatch):
        """Both packages take the class route at the default budget, and
        their estimates agree to the byte: both decline one byte under."""
        _, (ref, port) = mega
        assert port._class_counts_eligible(2) and ref._class_counts_eligible(2)
        est = port._class_counts_bytes(2)
        for budget, want in ((est, True), (est - 1, False)):
            monkeypatch.setenv("CYCLONUS_SLAB_MAX_BYTES", str(budget))
            assert port._class_counts_eligible(2) is want
            assert ref._class_counts_eligible(2) is want

    def test_counts_on_both_routes(self, mega):
        """The class route (K2's plain version) and the dense route (K1's)
        against the reference's class route and its tile loop."""
        c, (ref, port) = mega
        want = ref.evaluate_grid_counts(REF_CASES)
        assert port.evaluate_grid_counts(PORT_CASES) == want
        ref_dense, dense = engines(c, class_compress="0")
        assert dense.pod_classes() is None and ref_dense.pod_classes() is None
        assert ref_dense.evaluate_grid_counts(REF_CASES, backend="xla") == want
        assert dense.evaluate_grid_counts(PORT_CASES) == want
        assert want["cells"] == 2 * MEGA[0] ** 2

    def test_pairs(self, mega):
        _, (ref, port) = mega
        rng = random.Random(MEGA_SEED)
        pairs = [(rng.randrange(MEGA[0]), rng.randrange(MEGA[0])) for _ in range(10)]
        np.testing.assert_array_equal(port.evaluate_pairs(PORT_CASES, pairs),
                                      np.asarray(ref.evaluate_pairs(REF_CASES, pairs)))

    def test_audit_class_reduction(self, mega):
        (pods, namespaces, ref_policy, policy), (ref, port) = mega
        got = audit_class_reduction(policy, pods, namespaces, PORT_CASES, port.pod_classes(),
                                    max_classes=4, peers_per_class=4, rng=random.Random(3))
        want = ref_audit(ref_policy, pods, namespaces, REF_CASES, ref.pod_classes(),
                         max_classes=4, peers_per_class=4, rng=random.Random(3))
        assert got == want and got["ok"] and got["checked_cells"] == 128


@pytest.fixture(scope="module")
def tables():
    c = cluster(*TABLES, SEED)
    out = {}
    for route, kw in (("class", {}), ("dense", {"class_compress": "0"})):
        ref, port = engines(c, **kw)
        assert (port.pod_classes() is not None) == (route == "class")
        out[route] = (ref, port, ref.evaluate_grid(REF_CASES), port.evaluate_grid(PORT_CASES))
    return out


GRIDS = ("ingress", "egress", "combined")


class TestTables:
    @pytest.mark.parametrize("route", ["class", "dense"])
    def test_grid_equals_reference(self, tables, route):
        _, _, want, got = tables[route]
        for name in GRIDS:
            np.testing.assert_array_equal(getattr(got, name), np.asarray(getattr(want, name)))

    def test_class_grid_equals_dense_grid(self, tables):
        a, b = tables["class"][3], tables["dense"][3]
        for name in GRIDS:
            assert torch.equal(getattr(a, name + "_dev"), getattr(b, name + "_dev"))

    @pytest.mark.parametrize("route", ["class", "dense"])
    def test_sums_equal_counts(self, tables, route):
        ref, port, _, grid = tables[route]
        for qi, (case, ref_case) in enumerate(zip(PORT_CASES, REF_CASES)):
            sums = {name: int(getattr(grid, name + "_dev")[qi].sum()) for name in GRIDS}
            sums["cells"] = TABLES[0] ** 2
            assert port.evaluate_grid_counts([case]) == sums
            assert ref.evaluate_grid_counts([ref_case], backend="xla") == sums


def _meta(*shape, dtype=torch.bool):
    return torch.empty(shape, dtype=dtype, device="meta")


def _spec(*shape, dtype=jnp.bool_):
    return jax.ShapeDtypeStruct(shape, dtype)


def _raises_int32(fn, n_pad):
    """Whether fn(n_pad) raised the int32 partial-count guard: any other
    outcome, a return or another error, is False."""
    try:
        fn(n_pad)
    except ValueError as e:
        return "too large for int32 tile counts" in str(e)
    except NotImplementedError:
        pass
    return False


NS, Q, W = 1024, 2, 1


def port_packed(n_pad):
    i32 = torch.int32
    return pk._packed_operands(
        _meta(W, NS, dtype=i32), _meta(NS), _meta(W, n_pad, Q, dtype=i32),
        _meta(W, n_pad, dtype=i32), _meta(n_pad), _meta(W, NS, Q, dtype=i32),
        _meta(NS), _meta(n_pad), None, None, pk.PACKED_BS, pk.PACKED_BD)


def ref_packed(n_pad):
    i32 = jnp.int32
    fn = functools.partial(ref_pk._verdict_counts_pallas_packed, tier=None, w_dst=None,
                           bs=ref_pk.PACKED_BS, bd=ref_pk.PACKED_BD, interpret=True)
    return jax.eval_shape(fn, _spec(W, NS, dtype=i32), _spec(NS), _spec(W, n_pad, Q, dtype=i32),
                          _spec(W, n_pad, dtype=i32), _spec(n_pad), _spec(W, NS, Q, dtype=i32),
                          _spec(NS), _spec(n_pad))


def port_dense(n_pad):
    # a meta tensor passes the guard, then meets the live-depth read
    return dk.dense_operands(_meta(8, NS), _meta(NS), _meta(8, n_pad, Q), _meta(8, n_pad),
                             _meta(n_pad), _meta(8, NS, Q))


def ref_dense(n_pad):
    bf = jnp.bfloat16
    fn = functools.partial(ref_pk._verdict_counts_pallas_rect, interpret=True,
                           operand_dtype="int8")
    return jax.eval_shape(fn, _spec(8, NS), _spec(NS), _spec(8, n_pad, Q, dtype=bf),
                          _spec(8, n_pad), _spec(n_pad), _spec(8, NS, Q, dtype=bf),
                          _spec(NS), _spec(n_pad))


def port_slab(n):
    bs, bd = dk.SLAB_BS, dk.SLAB_BD
    t0_e, t0_i = np.zeros(-(-n // bs), np.int32), np.zeros(-(-n // bd), np.int32)
    return dk.slab_operands(_meta(8, n), _meta(n), _meta(8, n, Q), _meta(8, n), _meta(n),
                            _meta(8, n, Q), t0_e, t0_i, n)


def ref_slab(n):
    bs, bd = ref_pk.SLAB_BS, ref_pk.SLAB_BD
    fn = functools.partial(ref_pk._slab_operands, operand_dtype="int8", bs=bs, bd=bd,
                           w=ref_pk.SLAB_W)
    return jax.eval_shape(fn, _spec(8, n), _spec(n), _spec(8, n, Q), _spec(8, n), _spec(n),
                          _spec(8, n, Q), _spec(-(-n // bs), dtype=jnp.int32),
                          _spec(-(-n // bd), dtype=jnp.int32), n)


class TestTileCountGuards:
    @pytest.mark.parametrize("n_pad", BOUNDS)
    def test_packed_plan(self, n_pad):
        """K1-K3 at the default 512 x 512 tiles: the first dst axis with
        512 * nd_pad >= 2^31 is 4,194,304 pods in both packages, and the
        engine's shape check agrees."""
        want = pk.PACKED_BS * n_pad >= 2**31
        assert want == (n_pad >= 2**22)
        assert _raises_int32(ref_packed, n_pad) is want
        assert _raises_int32(port_packed, n_pad) is want
        assert _raises_int32(pk.check_tile_counts, n_pad) is want

    @pytest.mark.parametrize("n_pad", BOUNDS)
    def test_dense_plan(self, n_pad):
        """K4/K5: the reference's tiles keep 2 * bs * (n + 2048) under
        2^31 down to its default bs of 512; the port steps its bs of
        1,024 down to 512 alike, so both raise first at 4,194,304 pods
        (at 2,097,152 the port raised while the reference answered)."""
        want = n_pad >= 2**22
        assert _raises_int32(ref_dense, n_pad) is want
        assert _raises_int32(port_dense, n_pad) is want
        assert _raises_int32(dk.check_tile_counts, n_pad) is want
        bs = dk._int32_safe_bs(n_pad)
        assert bs == (dk.BS if dk.BS * n_pad < 2**31 else dk.MIN_BS)
        if not want:
            assert bs * n_pad < 2**31

    @pytest.mark.parametrize("n", [2**20 - dk.SLAB_BD, 2**20 - dk.SLAB_BD + 1, 2**20])
    def test_slab_plan(self, n):
        """K6 at its 2,048 x 1,024 tiles: both raise at the first dst axis
        with 2,048 * nd_pad >= 2^31."""
        assert (dk.SLAB_BS, dk.SLAB_BD) == (ref_pk.SLAB_BS, ref_pk.SLAB_BD)
        nd_pad = -(-n // dk.SLAB_BD) * dk.SLAB_BD
        want = dk.SLAB_BS * nd_pad >= 2**31
        assert _raises_int32(ref_slab, n) is want
        assert _raises_int32(port_slab, n) is want

    @pytest.mark.parametrize("n", [8, 1000, 2**20, 2**21 + 3, 2**22, 10**7])
    @pytest.mark.parametrize("q", [1, 2, 3])
    def test_tile_loop_block_shrink(self, n, q):
        for block in (1024, 4096):
            got = tiled._int32_safe_block(block, n, q)
            assert got == ref_tiled._int32_safe_block(block, n, q)
            assert got == 1 or got * n * q < 2**31


def test_engine_checks_the_bound_before_it_allocates(monkeypatch):
    """Past the int32 bound the counts call raises the kernels' error
    before it uploads or precomputes anything, on both plans (the bound
    moved down to the cluster's size, as the card meets it at 4,194,304
    pods)."""
    pods, namespaces, _, policy = cluster(300, 30, 7)
    for pack in (True, False):
        eng = TorchPolicyEngine(policy, pods, namespaces, device="cpu", class_compress="0",
                                pack=pack)
        n_pad = int(eng._tensors["pod_ns_id"].shape[0])
        monkeypatch.setattr(pk, "PACKED_BS", 2**31 // pk.PACKED_BD)
        monkeypatch.setattr(dk, "BS", 2**31 // n_pad)
        monkeypatch.setattr(dk, "MIN_BS", 2**31 // n_pad)
        before = dict(api.TRANSFERS)
        with pytest.raises(ValueError, match="too large for int32 tile counts"):
            eng.evaluate_grid_counts(PORT_CASES)
        assert dict(api.TRANSFERS) == before and eng._device_tensors is None
        assert eng.pre_cache_stats()["precomputes"] == 0
        monkeypatch.undo()
        # the same engine answers once the bound is back
        assert eng.evaluate_grid_counts(PORT_CASES)["cells"] == 2 * 300 ** 2


@pytest.mark.parametrize("mode", ["1", "auto"])
def test_class_route_bypassed_at_the_exact_limit(mode, monkeypatch):
    """At _CLASS_MAX_PODS_EXACT pods both packages bypass the class
    route (its f32 row sums are exact only below 2^24), one pod under it
    both take it; the counts agree either way."""
    c = cluster(2600, 40, 11)
    n = len(c[0])
    monkeypatch.setenv("CYCLONUS_CLASS_MIN_PODS", "2048")
    want = None
    for limit, active in ((n, False), (n + 1, True)):
        monkeypatch.setattr(ref_api, "_CLASS_MAX_PODS_EXACT", limit)
        monkeypatch.setattr(host, "_CLASS_MAX_PODS_EXACT", limit)
        ref, port = engines(c, class_compress=mode)
        assert (port.pod_classes() is not None) is active
        assert (ref.pod_classes() is not None) is active
        if active:
            np.testing.assert_array_equal(port.pod_classes().class_of_pod,
                                          ref.pod_classes().class_of_pod)
        counts = port.evaluate_grid_counts(PORT_CASES)
        assert counts == ref.evaluate_grid_counts(REF_CASES, backend="xla")
        assert want is None or counts == want
        want = counts
