"""Point queries of the port (TorchPolicyEngine.evaluate_pairs,
tiled.evaluate_pairs_kernel) and the streamed grid blocks
(iter_grid_blocks) against the reference's (cyclonus_tpu), on the CPU:
the same policies, pods, port cases and pairs through both packages.
Every value is boolean, so every comparison is exact.

Pairs include the padding the verdict service sends (repeats of (0, 0)),
repeated pairs, and rows of the bucketing's pad pods."""

import numpy as np
import pytest

from cyclonus_tpu.engine import TpuPolicyEngine
from cyclonus_tpu.kube.netpol import (
    IPBlock,
    LabelSelector,
    NetworkPolicyIngressRule,
    NetworkPolicyPeer,
)
from cyclonus_tpu.matcher import build_network_policies as ref_build
from cyclonus_tpu_torch.engine import TorchPolicyEngine

from test_engine_parity import default_cluster, mkpol
from test_torch_engine import (
    PORT_CASES,
    REF_CASES,
    assert_tree_equal,
    engines,
    fuzz_policies,
    grids,
)
from test_torch_tiers import cases_of, fuzz_engines


def seeded_pairs(seed: int, n_pods: int, n_bucketed: int, k: int = 48) -> np.ndarray:
    """[k', 2] int64 (src, dst) rows: random real pairs, some repeated,
    the service's (0, 0) pads, and pairs on the bucketing's pad rows."""
    rng = np.random.default_rng(seed)
    real = rng.integers(0, n_pods, size=(k, 2))
    pads = np.zeros((5, 2), dtype=np.int64)
    repeats = real[: k // 4]
    extra = []
    if n_bucketed > n_pods:
        extra = [[n_pods, 0], [0, n_bucketed - 1], [n_bucketed - 1, n_pods]]
    return np.concatenate([real, repeats, pads, np.array(extra, dtype=np.int64).reshape(-1, 2)])


def pair_equal(ref, port, ref_cases, port_cases, pairs):
    want = ref.evaluate_pairs(ref_cases, [tuple(p) for p in pairs])
    got = port.evaluate_pairs(port_cases, [tuple(p) for p in pairs])
    assert got.dtype == bool and got.shape == (len(pairs), len(port_cases), 3)
    assert np.array_equal(want, got)
    return got


def grid_cells(grid, cases, pairs):
    """The [K, Q, 3] cells of a full grid at real (src, dst) pairs."""
    g = grids(grid)
    out = np.zeros((len(pairs), len(cases), 3), dtype=bool)
    for i, (s, d) in enumerate(pairs):
        out[i, :, 0] = g["ingress"][:, d, s]
        out[i, :, 1] = g["egress"][:, s, d]
        out[i, :, 2] = g["combined"][:, s, d]
    return out


class TestPairs:
    @pytest.mark.parametrize("seed", range(7))
    @pytest.mark.parametrize("mode", ["0", "1"])
    def test_fuzz_seed(self, seed, mode):
        """NetworkPolicy fuzz seeds 0-6 on both class modes: pairs equal
        the reference's, and the real ones equal the port's own grid."""
        policies, pods, namespaces = fuzz_policies(seed, seed % 5 * 3)
        ref, port = engines(policies, pods, namespaces, class_compress=mode)
        n_b = int(port._tensors["pod_ns_id"].shape[0])
        pairs = seeded_pairs(seed, len(pods), n_b)
        got = pair_equal(ref, port, REF_CASES, PORT_CASES, pairs)
        real = [tuple(p) for p in pairs if p[0] < len(pods) and p[1] < len(pods)]
        mask = (pairs[:, 0] < len(pods)) & (pairs[:, 1] < len(pods))
        assert np.array_equal(
            got[mask], grid_cells(port.evaluate_grid(PORT_CASES), PORT_CASES, real)
        )

    @pytest.mark.parametrize("seed", range(8))
    def test_tier_fuzz_seed(self, seed):
        """Tier fuzz seeds 0-7: the pairs tier epilogue against the
        reference's, and against the port's tiered grid."""
        fc, ref, _policy, _tiers, port = fuzz_engines(seed, "0")
        ref_cases, port_cases = cases_of(fc)
        n_b = int(port._tensors["pod_ns_id"].shape[0])
        pairs = seeded_pairs(100 + seed, len(fc.pods), n_b)
        got = pair_equal(ref, port, ref_cases, port_cases, pairs)
        mask = (pairs[:, 0] < len(fc.pods)) & (pairs[:, 1] < len(fc.pods))
        real = [tuple(p) for p in pairs[mask]]
        assert np.array_equal(
            got[mask], grid_cells(port.evaluate_grid(port_cases), port_cases, real)
        )

    def test_host_ip_rows_by_original_row(self):
        """IPv6 / mixed-family IPBlocks are host-evaluated per pod; the
        pairs kernel patches them in by the pair's ORIGINAL pod row."""
        pods, namespaces = default_cluster()
        pods = [
            (ns, name, labels, f"fd00::{i + 1}" if i % 3 == 0 else ip)
            for i, (ns, name, labels, ip) in enumerate(pods)
        ]
        policies = [
            mkpol(
                "v6", "y", LabelSelector.make(), ["Ingress"],
                ingress=[
                    NetworkPolicyIngressRule(
                        from_=[
                            NetworkPolicyPeer(ip_block=IPBlock.make("fd00::/120", ["fd00::4/128"])),
                            NetworkPolicyPeer(ip_block=IPBlock.make("192.168.1.0/29")),
                        ]
                    )
                ],
            )
        ]
        ref, port = engines(policies, pods, namespaces, class_compress="0")
        assert "host_ip_match" in port._tensors["ingress"]
        n = len(pods)
        pairs = np.array([(s, d) for s in range(n) for d in range(n)], dtype=np.int64)
        got = pair_equal(ref, port, REF_CASES, PORT_CASES, pairs)
        assert np.array_equal(
            got, grid_cells(port.evaluate_grid(PORT_CASES), PORT_CASES, [tuple(p) for p in pairs])
        )

    def test_empty(self):
        _ref, port = engines(*fuzz_policies(0))
        assert port.evaluate_pairs(PORT_CASES, []).shape == (0, 3, 3)
        assert port.evaluate_pairs([], [(0, 1), (1, 0)]).shape == (2, 0, 3)

    def test_uses_resident_device_views(self):
        """A pairs call reads the engine's device views: the first call
        uploads them once, later calls upload nothing."""
        from cyclonus_tpu_torch.engine import api

        _ref, port = engines(*fuzz_policies(2, 4), class_compress="0")
        before = dict(api.TRANSFERS)
        port.evaluate_pairs(PORT_CASES, [(0, 1)])
        port.evaluate_pairs(PORT_CASES[:1], [(1, 0), (2, 2)])
        assert api.TRANSFERS["tensors"] == before["tensors"] + 1


class TestGridBlocks:
    @pytest.mark.parametrize("seed,extra,block", [(0, 0, 4), (3, 9, 8), (5, 13, 1024), (6, 2, 5)])
    @pytest.mark.parametrize("pack", [True, False])
    def test_blocks_equal_reference(self, monkeypatch, seed, extra, block, pack):
        monkeypatch.setenv("CYCLONUS_PACK", "1" if pack else "0")
        ref, port = engines(*fuzz_policies(seed, extra), class_compress="0")
        want = list(ref.iter_grid_blocks(REF_CASES, block=block))
        got = list(port.iter_grid_blocks(PORT_CASES, block=block))
        assert len(got) == len(want)
        for (s0, *a), (s1, *b) in zip(want, got):
            assert s0 == s1
            for x, y in zip(a, b):
                assert np.array_equal(np.asarray(x), y)

    @pytest.mark.parametrize("seed", range(7))
    def test_fuzz_seed_blocks_equal_reference(self, seed):
        """NetworkPolicy fuzz seeds 0-6, a block that does not divide the
        pod count."""
        ref, port = engines(*fuzz_policies(seed, seed % 5 * 3), class_compress="0")
        want = list(ref.iter_grid_blocks(REF_CASES, block=7))
        got = list(port.iter_grid_blocks(PORT_CASES, block=7))
        assert [w[0] for w in want] == [g[0] for g in got]
        for (_s0, *a), (_s1, *b) in zip(want, got):
            for x, y in zip(a, b):
                assert np.array_equal(np.asarray(x), y)

    @pytest.mark.parametrize("seed", range(8))
    def test_tiered_blocks_equal_reference(self, seed):
        fc, ref, _policy, _tiers, port = fuzz_engines(seed, "0")
        ref_cases, port_cases = cases_of(fc)
        want = list(ref.iter_grid_blocks(ref_cases, block=8))
        got = list(port.iter_grid_blocks(port_cases, block=8))
        assert [w[0] for w in want] == [g[0] for g in got]
        for (_s0, *a), (_s1, *b) in zip(want, got):
            for x, y in zip(a, b):
                assert np.array_equal(np.asarray(x), y)

    def test_blocks_tile_the_grid(self):
        """The blocks laid side by side are the port's own truth tables."""
        _ref, port = engines(*fuzz_policies(4, 6), class_compress="1")
        g = grids(port.evaluate_grid(PORT_CASES))
        rows = {"ingress": [], "egress": [], "combined": []}
        for _start, ing, eg, comb in port.iter_grid_blocks(PORT_CASES, block=4):
            rows["ingress"].append(ing)
            rows["egress"].append(eg)
            rows["combined"].append(comb)
        full = {k: np.concatenate(v) for k, v in rows.items()}  # [N_src, N_dst, Q]
        assert np.array_equal(np.moveaxis(full["egress"], -1, 0), g["egress"])
        assert np.array_equal(np.moveaxis(full["combined"], -1, 0), g["combined"])
        # ingress_rows[s, d, q] = ingress[q, d, s]
        assert np.array_equal(np.moveaxis(full["ingress"], -1, 0).transpose(0, 2, 1), g["ingress"])

    def test_empty(self):
        _ref, port = engines(*fuzz_policies(0))
        assert list(port.iter_grid_blocks([])) == []

    def test_counts_its_upload(self):
        """A block stream uploads one padded copy of the tensor set, and
        TRANSFERS counts it."""
        from cyclonus_tpu_torch.engine import api

        _ref, port = engines(*fuzz_policies(1, 3), class_compress="0")
        before = api.TRANSFERS["tensors"]
        assert len(list(port.iter_grid_blocks(PORT_CASES, block=4))) > 1
        assert api.TRANSFERS["tensors"] == before + 1


def test_tiered_pairs_class_route():
    """Pairs read the main tensor set whatever the class route: a
    class-compressed tiered engine answers as the dense one."""
    fc, ref, _policy, _tiers, port = fuzz_engines(5, "1")
    ref_cases, port_cases = cases_of(fc)
    pairs = seeded_pairs(7, len(fc.pods), int(port._tensors["pod_ns_id"].shape[0]))
    pair_equal(ref, port, ref_cases, port_cases, pairs)
    dense = fuzz_engines(5, "0")[4]
    assert np.array_equal(
        port.evaluate_pairs(port_cases, [tuple(p) for p in pairs]),
        dense.evaluate_pairs(port_cases, [tuple(p) for p in pairs]),
    )


def test_pairs_on_reference_tensors():
    """An engine over the reference's own tensor dict answers the
    reference's pairs."""
    policies, pods, namespaces = fuzz_policies(1, 7)
    ref = TpuPolicyEngine(ref_build(True, policies), pods, namespaces, class_compress="0")
    vocab = ref.encoding.cluster.vocab
    carried = TorchPolicyEngine.from_tensors(
        ref._tensors, pod_keys=ref.pod_keys, port_names=vocab.port_name,
        protocols=vocab.proto, device="cpu",
    )
    pairs = seeded_pairs(11, len(pods), int(ref._tensors["pod_ns_id"].shape[0]))
    pair_equal(ref, carried, REF_CASES, PORT_CASES, pairs)
    assert_tree_equal(
        grids(ref.evaluate_grid(REF_CASES)), grids(carried.evaluate_grid(PORT_CASES))
    )

