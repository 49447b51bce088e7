"""The PyTorch port's plain kernels (cyclonus_tpu_torch/engine/kernel.py
and tiled.py) against their JAX twins in cyclonus_tpu, on identical
inputs: numpy arrays made from a seed, or the reference engine's own
tensor dict.  Every comparison is exact."""

import numpy as np
import pytest
import torch

from cyclonus_tpu.engine import TpuPolicyEngine
from cyclonus_tpu.engine import encoding as ref_encoding
from cyclonus_tpu.engine import kernel as ref_kernel
from cyclonus_tpu.engine import tiled as ref_tiled
from cyclonus_tpu_torch import carry
from cyclonus_tpu_torch.engine import encoding as port_encoding
from cyclonus_tpu_torch.engine import kernel as port_kernel
from cyclonus_tpu_torch.engine import tiled as port_tiled

from test_engine_tiled import CASES, fuzz_problem


def _np(x):
    return np.asarray(x.cpu().numpy() if isinstance(x, torch.Tensor) else x)


def _assert_tree_equal(ref, port, path=""):
    if isinstance(ref, dict):
        assert set(ref) == set(port), path
        for k in ref:
            _assert_tree_equal(ref[k], port[k], f"{path}/{k}")
        return
    a, b = _np(ref), _np(port)
    assert a.shape == b.shape, f"{path}: {a.shape} != {b.shape}"
    assert np.array_equal(a, b), f"{path} differs"


class TestPackWords:
    @pytest.mark.parametrize(
        "shape,axis",
        [((1,), 0), ((32,), 0), ((33, 5), 0), ((70, 9), 0), ((6, 64), 1), ((3, 95, 2), 1)],
    )
    def test_pack_bool_words_three_way(self, shape, axis):
        rng = np.random.default_rng(sum(shape) * 7 + axis)
        a = rng.random(shape) < 0.5
        # every bit 31 set on the first word, so the int32 sign is exercised
        idx = [slice(None)] * a.ndim
        if a.shape[axis] >= 32:
            idx[axis] = 31
            a[tuple(idx)] = True
        want = ref_encoding.pack_bool_words(a, axis=axis)
        assert np.array_equal(port_encoding.pack_bool_words(a, axis=axis), want)
        assert np.array_equal(_np(ref_kernel.pack_bool_words_jnp(a, axis=axis)), want)
        got = port_kernel.pack_bool_words_torch(torch.from_numpy(a), dim=axis)
        assert got.dtype == torch.int32
        assert np.array_equal(_np(got), want)
        if a.shape[axis] >= 32:
            assert (want < 0).any()

    @pytest.mark.parametrize("t,na,nb", [(1, 3, 4), (40, 7, 11), (96, 16, 5)])
    def test_packed_any(self, t, na, nb):
        rng = np.random.default_rng(t + na + nb)
        a = rng.random((t, na)) < 0.1
        b = rng.random((t, nb)) < 0.1
        a_pk = ref_encoding.pack_bool_words(a)
        b_pk = ref_encoding.pack_bool_words(b)
        want = _np(ref_kernel.packed_any(a_pk, b_pk))
        got = _np(port_kernel.packed_any(torch.from_numpy(a_pk), torch.from_numpy(b_pk)))
        assert np.array_equal(got, want)
        assert np.array_equal(want, (a.astype(int).T @ b.astype(int)) > 0)


def _problem_tensors(seed, n_extra=5):
    policy, pods, namespaces = fuzz_problem(seed, n_extra_pods=n_extra)
    engine = TpuPolicyEngine(policy, pods, namespaces, class_compress="0")
    return engine._tensors_with_cases(CASES)


class TestKernelTwins:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_selector_match(self, seed):
        t = _problem_tensors(seed)
        pt = carry.tensors_from_reference(t, "cpu")
        for kv, key in (("pod_kv", "pod_key"), ("ns_kv", "ns_key")):
            args = ("sel_req_kv", "sel_exp_op", "sel_exp_key", "sel_exp_vals", kv, key)
            want = ref_kernel.selector_match(*(t[a] for a in args))
            got = port_kernel.selector_match(*(pt[a] for a in args))
            assert np.array_equal(_np(got), _np(want))

    @pytest.mark.parametrize("seed,pack", [(0, False), (0, True), (1, False), (1, True), (3, True)])
    def test_evaluate_grid_kernel(self, seed, pack):
        t = _problem_tensors(seed)
        want = ref_kernel.evaluate_grid_kernel(t, pack=pack)
        got = port_kernel.evaluate_grid_kernel(
            carry.tensors_from_reference(t, "cpu"), pack=pack
        )
        _assert_tree_equal(want, got)

    @pytest.mark.parametrize("seed", [2, 4])
    def test_precompute_packed(self, seed):
        t = _problem_tensors(seed)
        want = ref_tiled._precompute(t, True)
        got = port_tiled._precompute(carry.tensors_from_reference(t, "cpu"), True)
        for d in ("ingress", "egress"):
            for k in ("tmatch", "has_target", "tallow_pk", "tmatch_pk"):
                assert np.array_equal(_np(got[d][k]), _np(want[d][k])), (d, k)

    def test_gather_class_grids_and_stats(self):
        rng = np.random.default_rng(5)
        grids = {k: rng.random((2, 6, 6)) < 0.5 for k in ("ingress", "egress", "combined")}
        class_of = rng.integers(0, 6, size=11).astype(np.int32)
        want = ref_kernel.gather_class_grids(grids, class_of)
        got = port_kernel.gather_class_grids(
            {k: torch.from_numpy(v) for k, v in grids.items()}, torch.from_numpy(class_of)
        )
        _assert_tree_equal(want, got)
        w = _np(ref_kernel.grid_stats_kernel(*(want[k] for k in ("ingress", "egress", "combined"))))
        g = _np(port_kernel.grid_stats_kernel(*(got[k] for k in ("ingress", "egress", "combined"))))
        assert np.array_equal(w, g)


def _tiered_tensors(seed):
    """The tensor dict (port cases included) of tiered fuzz scenario
    `seed` as the reference engine builds it."""
    from cyclonus_tpu.matcher import build_network_policies
    from cyclonus_tpu.tiers.fuzz import build_fuzz_case

    fc = build_fuzz_case(seed)
    assert fc.tiers is not None
    engine = TpuPolicyEngine(
        build_network_policies(fc.simplify, fc.netpols), fc.pods, fc.namespaces,
        tiers=fc.tiers, class_compress="0",
    )
    return engine._tensors_with_cases(fc.cases)


#: tiered fuzz scenarios (seeds 3-7 of tiers/fuzz.py carry tiers)
TIER_SEEDS = [3, 5, 6]


class TestTierTwins:
    @pytest.mark.parametrize("seed", TIER_SEEDS)
    def test_tier_direction_arrays(self, seed):
        """tier_scope_match, port_spec_allows and tier_keys through
        tier_direction_arrays, then tier_first_match_keys, each direction."""
        t = _tiered_tensors(seed)
        pt = carry.tensors_from_reference(t, "cpu")
        sel = ("sel_req_kv", "sel_exp_op", "sel_exp_key", "sel_exp_vals")
        selpod = ref_kernel.selector_match(*(t[k] for k in sel), t["pod_kv"], t["pod_key"])
        selns = ref_kernel.selector_match(*(t[k] for k in sel), t["ns_kv"], t["ns_key"])
        p_selpod, p_selns = port_kernel.selector_tables(pt)
        cases = ("q_port", "q_name", "q_proto")
        for d in ("ingress", "egress"):
            want = ref_kernel.tier_direction_arrays(
                t["tiers"][d], selpod, selns, t["pod_ns_id"], *(t[k] for k in cases)
            )
            got = port_kernel.tier_direction_arrays(
                pt["tiers"][d], p_selpod, p_selns, pt["pod_ns_id"], *(pt[k] for k in cases)
            )
            _assert_tree_equal(want, got)
            anp, banp = port_kernel.tier_keys(pt["tiers"][d])
            assert anp.dtype == torch.int32 and banp.dtype == torch.int32
            for chunk in (1, 8):
                _assert_tree_equal(
                    ref_kernel.tier_first_match_keys(
                        want["subj"], want["peerq"], want["anp_key"], want["banp_key"],
                        chunk=chunk,
                    ),
                    port_kernel.tier_first_match_keys(
                        got["subj"], got["peerq"], got["anp_key"], got["banp_key"],
                        chunk=chunk,
                    ),
                )

    def test_tier_scope_match_pad_pods(self):
        """Pad pods (ns id -1) and POD_ALL / POD_SELECTOR rows."""
        rng = np.random.default_rng(11)
        g, n, s, m = 9, 14, 5, 4
        args = (
            rng.integers(0, s, size=g).astype(np.int32),
            rng.integers(0, 2, size=g).astype(np.int32),
            rng.integers(-1, s, size=g).astype(np.int32),
            rng.random((s, n)) < 0.5,
            rng.random((s, m)) < 0.5,
            np.where(rng.random(n) < 0.2, -1, rng.integers(0, m, size=n)).astype(np.int32),
        )
        want = ref_kernel.tier_scope_match(*args)
        got = port_kernel.tier_scope_match(*(torch.from_numpy(a) for a in args))
        assert np.array_equal(_np(got), _np(want))

    def test_resolve_tier_lattice(self):
        """Every (np verdict, has_target, ANP action, BANP action)
        combination, the no-match key included."""
        none = ref_encoding.TIER_KEY_NONE
        keys = np.array([none, 4 * 3 + 1, 4 * 3 + 2, 4 * 3 + 3, 1, 2], dtype=np.int32)
        grid = np.array(np.meshgrid([0, 1], [0, 1], keys, keys, indexing="ij")).reshape(4, -1)
        np_allowed, has = grid[0].astype(bool), grid[1].astype(bool)
        anp, banp = grid[2].astype(np.int32), grid[3].astype(np.int32)
        want = ref_kernel.resolve_tier_lattice(np_allowed, has, anp, banp)
        got = port_kernel.resolve_tier_lattice(
            *(torch.from_numpy(a) for a in (np_allowed, has, anp, banp))
        )
        assert np.array_equal(_np(got), _np(want))

    @pytest.mark.parametrize("seed,pack", [(3, True), (5, False), (7, True)])
    def test_evaluate_grid_kernel_tiered(self, seed, pack):
        t = _tiered_tensors(seed)
        want = ref_kernel.evaluate_grid_kernel(t, pack=pack)
        got = port_kernel.evaluate_grid_kernel(carry.tensors_from_reference(t, "cpu"), pack=pack)
        _assert_tree_equal(want, got)

    def test_precompute_tier(self):
        t = _tiered_tensors(6)
        want = ref_tiled._precompute(t, True)
        got = port_tiled._precompute(carry.tensors_from_reference(t, "cpu"), True)
        for d in ("ingress", "egress"):
            _assert_tree_equal(want[d]["tier"], got[d]["tier"])
        assert port_tiled.packed_tier(got) == {d: got[d]["tier"] for d in ("ingress", "egress")}


class TestCarry:
    def test_tensors_from_reference_dtypes(self):
        t = {
            "pod_ip": np.array([0, 1, 0xFFFFFFFF, 0x80000000], dtype=np.uint32),
            "d": {"m": np.array([True, False]), "k": np.array([-1, 7], dtype=np.int32)},
            "s": np.array([3], dtype=np.int8),
            "n": 5,
        }
        got = carry.tensors_from_reference(t, "cpu")
        assert got["pod_ip"].dtype == torch.int64
        assert got["pod_ip"].tolist() == [0, 1, 0xFFFFFFFF, 0x80000000]
        assert got["d"]["m"].dtype == torch.bool and got["d"]["k"].dtype == torch.int32
        assert got["s"].dtype == torch.int8 and got["n"] == 5
        with pytest.raises(TypeError, match="unsupported"):
            carry.to_torch(np.zeros(2, dtype=np.float64), "cpu")
