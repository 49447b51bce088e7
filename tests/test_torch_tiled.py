"""The tile loop of the PyTorch port (cyclonus_tpu_torch/engine/tiled.py:
the per-tile verdict body, the counts loop and the class row sums)
against the reference's XLA tile loop (cyclonus_tpu/engine/tiled.py), on
the CPU: the same engine tensors through both, both dtype plans (packed
words and the dense plan's bf16 operands), untiered and with precedence
tiers (tier fuzz seeds 0-3).  Every comparison is exact.

The tile loop is plain PyTorch — the reference left it to XLA outside any
Pallas call — so it has no kernel to hold on the card."""

import functools

import numpy as np
import pytest
import torch

import cyclonus_tpu.engine.tiled as ref_tiled
from cyclonus_tpu.engine import TpuPolicyEngine
from cyclonus_tpu.engine.planspec import PlanError
from cyclonus_tpu.matcher import build_network_policies as ref_build
from cyclonus_tpu.tiers import fuzz as ref_fuzz
from cyclonus_tpu_torch import carry
from cyclonus_tpu_torch.engine import TorchPolicyEngine
from cyclonus_tpu_torch.engine import tiled

from test_torch_engine import PORT_CASES, REF_CASES, fuzz_policies, port_policy
from test_torch_tiers import cases_of, port_tiers
from test_torch_tiers import port_policy as tier_port_policy

PACKS = [True, False]
SEEDS = range(4)


@functools.lru_cache(maxsize=None)
def tier_engines(seed, mode):
    """(ref cases, port cases, reference engine, port engine) of tier fuzz
    seed `seed` at class_compress=`mode` (the tile-loop functions take the
    dtype plan as an argument, so the engines' own plans do not matter)."""
    fc = ref_fuzz.build_fuzz_case(seed)
    ref = TpuPolicyEngine(
        ref_build(fc.simplify, fc.netpols), fc.pods, fc.namespaces,
        tiers=fc.tiers, class_compress=mode,
    )
    port = TorchPolicyEngine(
        tier_port_policy(fc.simplify, fc.netpols), fc.pods, fc.namespaces,
        tiers=port_tiers(fc.tiers), class_compress=mode, device="cpu",
    )
    ref_cases, port_cases = cases_of(fc)
    return ref_cases, port_cases, ref, port


@functools.lru_cache(maxsize=None)
def plain_engines(seed, mode):
    policies, pods, namespaces = fuzz_policies(seed, 11)
    ref = TpuPolicyEngine(ref_build(True, policies), pods, namespaces, class_compress=mode)
    port = TorchPolicyEngine(port_policy(policies), pods, namespaces, device="cpu",
                             class_compress=mode)
    return REF_CASES, PORT_CASES, ref, port


def engines(kind, seed, mode):
    return (tier_engines if kind == "tiered" else plain_engines)(seed, mode)


def _ref_class_tensors(ref, cases):
    t = dict(ref._class_state["ctensors"])
    t["q_port"], t["q_name"], t["q_proto"] = ref._port_case_arrays(cases)
    return t


KINDS = [("tiered", s) for s in SEEDS] + [("plain", s) for s in (0, 5)]


class TestTileLoop:
    @pytest.mark.parametrize("pack", PACKS)
    @pytest.mark.parametrize("kind,seed", KINDS)
    def test_counts(self, kind, seed, pack):
        """tiled.evaluate_grid_counts on the engine's host tensors, several
        tiles per grid and one, equals the reference's."""
        ref_cases, port_cases, ref, port = engines(kind, seed, "0")
        n = port.n_pods
        for block in (4, 1024):
            want = ref_tiled.evaluate_grid_counts(
                ref._tensors_with_cases(ref_cases), n, block=block, pack=pack
            )
            got = tiled.evaluate_grid_counts(
                port._with_host_cases(port_cases), n, block=block, pack=pack, device="cpu"
            )
            assert got == want, (block, got, want)

    @pytest.mark.parametrize("pack", PACKS)
    @pytest.mark.parametrize("kind,seed", KINDS)
    def test_class_rowsums(self, kind, seed, pack):
        """The class tile loop's [Cb, Q, 3] row sums equal the reference's
        bit for bit, and the finished counts equal the weighted kernel's."""
        ref_cases, port_cases, ref, port = engines(kind, seed, "1")
        st = port._class_state
        pc = st["classes"]
        ref_t = _ref_class_tensors(ref, ref_cases)
        port_t = port._with_cases(port._class_dev(), port_cases)
        for block in (4, 1024):
            w, blk, n_tiles = tiled.class_rowsums_plan(port_t, pc.n_classes, pc.class_size, block)
            r_w, r_blk, r_tiles = ref_tiled.class_rowsums_plan(ref_t, pc.n_classes, pc.class_size, block)
            assert np.array_equal(w, r_w) and (blk, n_tiles) == (r_blk, r_tiles)
            want = np.asarray(ref_tiled._class_rowsums_kernel(ref_t, r_w, r_blk, r_tiles, pack))
            got = tiled._class_rowsums_kernel(port_t, torch.from_numpy(w), blk, n_tiles, pack)
            assert got.dtype == torch.float32
            assert np.array_equal(got.numpy(), want)
        counts = {
            k: tiled.evaluate_grid_counts_classes(
                port_t, pc.n_classes, pc.class_size, port.n_pods, pack=pack, kernel=k
            )
            for k in ("xla", "pallas")
        }
        assert counts["xla"] == counts["pallas"]

    @pytest.mark.parametrize("pack", PACKS)
    @pytest.mark.parametrize("seed", SEEDS)
    def test_tile_verdicts(self, seed, pack):
        """The per-tile verdict blocks of every tile equal the reference's
        (tier lattice included)."""
        ref_cases, port_cases, ref, port = tier_engines(seed, "0")
        ref_t = ref._tensors_with_cases(ref_cases)
        n_b = int(ref_t["pod_ns_id"].shape[0])
        block = 8
        ref_src, ref_dst = ref_tiled._split_pre(ref_tiled._precompute(ref_t, pack))
        pre = tiled._precompute(carry.tensors_from_reference(port._with_host_cases(port_cases), "cpu"), pack)
        src, dst = tiled._split_pre(pre)
        assert sorted(src) == sorted(ref_src) and sorted(dst) == sorted(ref_dst)
        for start in range(0, n_b, block):
            want = ref_tiled._tile_verdicts_split(ref_src, ref_dst, start, block)
            got = tiled._tile_verdicts_split(src, dst, start, block)
            for g, w in zip(got, want):
                assert np.array_equal(g.numpy(), np.asarray(w)), start

    def test_helpers(self):
        for block, n, q in ((1024, 100_000, 2), (1024, 3_000_000, 3), (7, 9, 1), (1, 10**9, 4)):
            assert tiled._int32_safe_block(block, n, q) == ref_tiled._int32_safe_block(block, n, q)
        _rc, port_cases, _ref, port = plain_engines(0, "1")
        t = port._with_cases(port._class_dev(), port_cases)
        pc = port._class_state["classes"]
        if not torch.cuda.is_available():
            # the tile loop runs on the card unless the caller asks for the CPU
            with pytest.raises(RuntimeError, match="no CUDA device"):
                tiled.evaluate_grid_counts(port._with_host_cases(port_cases), port.n_pods,
                                           pack=True)
        with pytest.raises(ValueError, match="unknown class counts kernel"):
            tiled.evaluate_grid_counts_classes(t, pc.n_classes, pc.class_size, port.n_pods,
                                               pack=True, kernel="mosaic")


class TestEngineTiered:
    @pytest.mark.parametrize("mode", ["0", "1"])
    @pytest.mark.parametrize("seed", SEEDS)
    def test_pack_off_tiered_counts(self, monkeypatch, seed, mode):
        """Tiered counts under the dense plan take the tile loop on auto and
        equal TpuPolicyEngine's under CYCLONUS_PACK=0; an explicit
        backend="pallas" raises, as the reference's plan does."""
        monkeypatch.setenv("CYCLONUS_PACK", "0")
        fc = ref_fuzz.build_fuzz_case(seed)
        ref = TpuPolicyEngine(
            ref_build(fc.simplify, fc.netpols), fc.pods, fc.namespaces,
            tiers=fc.tiers, class_compress=mode,
        )
        port = TorchPolicyEngine(
            tier_port_policy(fc.simplify, fc.netpols), fc.pods, fc.namespaces,
            tiers=port_tiers(fc.tiers), class_compress=mode, device="cpu",
        )
        assert not port._pack
        ref_cases, port_cases = cases_of(fc)
        want = ref.evaluate_grid_counts(ref_cases)
        assert port.evaluate_grid_counts(port_cases) == want
        assert port.evaluate_grid_counts(port_cases, backend="xla", block=16) == want
        if fc.tiers is None:
            assert port.evaluate_grid_counts(port_cases, backend="pallas") == want
            return
        with pytest.raises(PlanError):
            ref.evaluate_grid_counts(ref_cases, backend="pallas")
        with pytest.raises(ValueError, match="precedence-tier"):
            port.evaluate_grid_counts(port_cases, backend="pallas")
