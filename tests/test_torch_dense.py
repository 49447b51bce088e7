"""The dense (CYCLONUS_PACK=0) counts plan of the PyTorch port against the
reference package, on the CPU: the plain versions of the single-chunk
(K4), chunked (K5) and slab (K6) kernels of
cyclonus_tpu_torch/engine/dense_kernel.py against the reference's Pallas
kernels in interpret mode on identical seeded operands, the host slab
plan against the reference engine's, and TorchPolicyEngine(pack=False)
against TpuPolicyEngine under CYCLONUS_PACK=0 on every counts route.
Every comparison is exact.

The CUDA kernels themselves are held against the plain versions on the
card by the `cuda`-marked tests at the end (skipped without a card) and
by chip_smoke.py."""

import numpy as np
import pytest
import torch

import cyclonus_tpu.engine.pallas_kernel as ref_pk
from cyclonus_tpu.engine import TpuPolicyEngine
from cyclonus_tpu.engine.encoding import pack_enabled as ref_pack_enabled
from cyclonus_tpu.kube.netpol import LabelSelector
from cyclonus_tpu.matcher import build_network_policies as ref_build
from cyclonus_tpu_torch import oracle
from cyclonus_tpu_torch.engine import TorchPolicyEngine
from cyclonus_tpu_torch.engine import dense_kernel as dk
from cyclonus_tpu_torch.engine import host, tiled
from cyclonus_tpu_torch.engine.encoding import pack_enabled
from cyclonus_tpu_torch.engine.packed_kernel import sum_partials

from test_engine_parity import default_cluster, mkpol
from test_torch_engine import (
    PORT_CASES,
    REF_CASES,
    assert_tree_equal,
    fuzz_policies,
    grids,
    port_policy,
)


def _operands(seed, q, te, ti, ns, nd, n_ns=0):
    """Seeded dense-plan operands as numpy arrays: tmatch/has/tallow per
    direction plus non-prefix validity masks.  n_ns > 0 puts pods and
    targets in the order of n_ns namespaces (block-diagonal tmatch: most
    64-pod blocks x target chunks all zero, narrow windows per tile)."""
    rng = np.random.default_rng(seed)

    def tmatch(t, n):
        if not n_ns:
            return rng.random((t, n)) < 0.05
        return (np.sort(rng.integers(0, n_ns, t))[:, None]
                == np.sort(rng.integers(0, n_ns, n))[None, :]) & (rng.random((t, n)) < 0.6)

    return {
        "tmatch_e": tmatch(te, ns),
        "has_e": rng.random(ns) < 0.7,
        "tallow_e": rng.random((te, nd, q)) < 0.1,
        "tmatch_i": tmatch(ti, nd),
        "has_i": rng.random(nd) < 0.7,
        "tallow_i": rng.random((ti, ns, q)) < 0.1,
        "valid_src": rng.random(ns) < 0.8,
        "valid_dst": rng.random(nd) < 0.8,
    }


_ARGS = ("tmatch_e", "has_e", "tallow_e", "tmatch_i", "has_i", "tallow_i")


def _ref_args(ops):
    import jax.numpy as jnp

    return [
        jnp.asarray(ops[k], dtype=jnp.bfloat16) if k.startswith("tallow") else ops[k]
        for k in _ARGS
    ]


def _port_args(ops):
    return [
        torch.from_numpy(ops[k]).to(torch.bfloat16) if k.startswith("tallow")
        else torch.from_numpy(ops[k])
        for k in _ARGS
    ]


def _per_q(partials):
    """[Q, 3] int64 totals of [Q, n_tiles, 3] partials (the two packages
    cut the src axis into different tiles)."""
    return np.asarray(partials, dtype=np.int64).sum(axis=1)


# (seed, q, te, ti, ns, nd, namespaces): ragged axes, Q in {1, 2, 3},
# target depths from 0 to past one 1,024-row chunk in either direction
SHAPES = [
    (0, 1, 0, 0, 9, 9, 0),
    (1, 2, 5, 7, 37, 50, 0),
    (2, 3, 30, 20, 130, 77, 0),
    (3, 2, 1100, 40, 60, 70, 0),
    (4, 1, 40, 1030, 50, 45, 0),
    (5, 2, 1023, 1024, 40, 40, 0),
    (6, 2, 1200, 1300, 300, 260, 40),
    # single chunk at Q = 3, chunks of 256 and 128 rows
    (8, 3, 250, 100, 200, 150, 0),
]


# (seed, q, te, ti, ns, nd, namespaces, pads): target axes that end in
# inert rows that match no pod (the engine's bucketing pads), so the
# pseudo row sits before them and the live depth is ragged: a multiple of
# neither 32 nor 128 nor the chunk, or only the pseudo row
RAGGED = [
    (30, 2, 1100, 40, 60, 70, 0, (37, 5)),
    (31, 1, 0, 1300, 50, 45, 0, (0, 20)),
    (32, 3, 30, 20, 130, 77, 0, (3, 100)),
    (33, 2, 1200, 1300, 300, 260, 40, (7, 1)),
    # single chunk (K4): live depths below the chunk, and a direction
    # whose live depth is only the pseudo row
    (36, 2, 200, 250, 70, 90, 0, (40, 60)),
    (37, 1, 0, 90, 40, 50, 0, (30, 0)),
    (38, 3, 100, 0, 60, 45, 6, (20, 27)),
]


def _with_pads(ops, pads):
    """ops with pads[0] / pads[1] target rows appended to the egress /
    ingress tmatch and tallow: they match no pod, and half their allow
    entries are set (a peer that selects every pod), so only the match
    side tells they add nothing."""
    rng = np.random.default_rng(sum(pads))
    out = dict(ops)
    for d, pad in zip("ei", pads):
        tm, tl = ops["tmatch_" + d], ops["tallow_" + d]
        out["tmatch_" + d] = np.concatenate([tm, np.zeros((pad,) + tm.shape[1:], dtype=bool)])
        out["tallow_" + d] = np.concatenate([tl, rng.random((pad,) + tl.shape[1:]) < 0.5])
    return out


def _data_rows(tmatch, valid):
    """The rows up to the last one that matches a valid pod, in numpy."""
    rows = np.flatnonzero((tmatch & valid[None, :]).any(axis=1))
    return int(rows[-1]) + 1 if rows.size else 0


class TestDensePlainVsPallas:
    @pytest.mark.parametrize("seed,q,te,ti,ns,nd,n_ns", SHAPES)
    def test_rect_masks(self, seed, q, te, ti, ns, nd, n_ns):
        """Non-prefix validity masks on both sides; K4 or K5 taken exactly
        where the reference takes its single-chunk or chunked kernel."""
        ops = _operands(seed, q, te, ti, ns, nd, n_ns)
        want = ref_pk.verdict_counts_pallas_rect(
            *_ref_args(ops), valid_src=ops["valid_src"], valid_dst=ops["valid_dst"],
            interpret=True,
        )
        vs, vd = torch.from_numpy(ops["valid_src"]), torch.from_numpy(ops["valid_dst"])
        got = dk.verdict_counts_rect(*_port_args(ops), valid_src=vs, valid_dst=vd, bs=64)
        assert got.dtype == torch.int32
        assert np.array_equal(_per_q(got), _per_q(want))
        d_ops = dk.dense_operands(*_port_args(ops), vs, vd)
        ref_single = ref_pk._kt_for(te + 1) >= te + 1 and ref_pk._kt_for(ti + 1) >= ti + 1
        assert dk.single_chunk(d_ops) == ref_single

    @pytest.mark.parametrize("seed,q,te,ti,ns,nd,n_ns", SHAPES[1:5])
    def test_square_n_pods(self, seed, q, te, ti, ns, nd, n_ns):
        ops = _operands(seed + 10, q, te, ti, ns, ns, n_ns)
        n = ns - 4
        want = ref_pk.verdict_counts_pallas(*_ref_args(ops), n_pods=n, interpret=True)
        got = dk.verdict_counts(*_port_args(ops), n_pods=n)
        assert np.array_equal(_per_q(got), _per_q(want))
        assert sum_partials(got, q, n) == ref_pk.sum_partials(want, q, n)

    @pytest.mark.parametrize("direction", ["e", "i"])
    def test_has_false_and_empty_direction(self, direction):
        """Every pod without a target on one direction (the pseudo row
        alone decides it), then that direction with no targets at all."""
        ops = _operands(20, 2, 300, 200, 90, 80)
        ops["has_" + direction] = np.zeros_like(ops["has_" + direction])
        for variant in (ops, dict(ops, **{
            "tmatch_" + direction: ops["tmatch_" + direction][:0],
            "tallow_" + direction: ops["tallow_" + direction][:0],
        })):
            want = ref_pk.verdict_counts_pallas_rect(
                *_ref_args(variant), valid_src=variant["valid_src"],
                valid_dst=variant["valid_dst"], interpret=True,
            )
            got = dk.verdict_counts_rect(
                *_port_args(variant), valid_src=torch.from_numpy(variant["valid_src"]),
                valid_dst=torch.from_numpy(variant["valid_dst"]),
            )
            assert np.array_equal(_per_q(got), _per_q(want))

    def test_block_skip(self):
        """Namespace-sorted, block-diagonal operands over several chunks:
        K5's nz maps skip some blocks and keep exactly the blocks that hold
        a nonzero (the pseudo row's included), and the counts equal the
        reference's."""
        ops = _operands(21, 2, 2100, 1500, 512, 384, n_ns=60)
        args = _port_args(ops)
        vs, vd = torch.from_numpy(ops["valid_src"]), torch.from_numpy(ops["valid_dst"])
        d_ops = dk.dense_operands(*args, vs, vd, bs=64)
        assert not dk.single_chunk(d_ops)
        nz_e, nz_i = dk._nz_maps(d_ops)
        assert nz_e.shape == (512 // 64, 3) and nz_i.shape == (384 // 64, 2)
        assert 0 < int(nz_e.sum()) < nz_e.numel() and 0 < int(nz_i.sum()) < nz_i.numel()
        # a kept flag for every block that holds a nonzero, and no other
        for a, nz, kt in ((d_ops["a_e"], nz_e, d_ops["kt_e"]), (d_ops["a_i"], nz_i, d_ops["kt_i"])):
            blocks = a.view(a.shape[0] // 64, 64, a.shape[1] // kt, kt)
            assert torch.equal(nz.bool(), blocks.ne(0).any(dim=3).any(dim=1))
        want = ref_pk.verdict_counts_pallas_rect(
            *_ref_args(ops), valid_src=ops["valid_src"], valid_dst=ops["valid_dst"],
            interpret=True,
        )
        assert np.array_equal(_per_q(dk.counts_from_ops(d_ops)), _per_q(want))

    @pytest.mark.parametrize("seed,q,te,ti,ns,nd,n_ns,pads", RAGGED)
    def test_ragged_live_depth(self, seed, q, te, ti, ns, nd, n_ns, pads):
        """The pseudo row right after the last row that matches a valid
        pod, the pads after it: the plain version equals the reference's
        Pallas kernel in interpret mode (its pseudo row after every row),
        and the live depth is those rows plus the pseudo row, rounded up
        to 32, with only zeros past it on the match side."""
        ops = _with_pads(_operands(seed, q, te, ti, ns, nd, n_ns), pads)
        want = ref_pk.verdict_counts_pallas_rect(
            *_ref_args(ops), valid_src=ops["valid_src"], valid_dst=ops["valid_dst"],
            interpret=True,
        )
        vs, vd = torch.from_numpy(ops["valid_src"]), torch.from_numpy(ops["valid_dst"])
        got = dk.verdict_counts_rect(*_port_args(ops), valid_src=vs, valid_dst=vd, bs=64)
        assert np.array_equal(_per_q(got), _per_q(want))
        d_ops = dk.dense_operands(*_port_args(ops), vs, vd)
        for d, key, a, valid in (("e", "live_e", "a_e", ops["valid_src"]),
                                 ("i", "live_i", "a_i", ops["valid_dst"])):
            n = _data_rows(ops["tmatch_" + d], valid)
            assert n <= (te if d == "e" else ti)
            assert d_ops[key] == dk.live_depth(n) == -(-(n + 1) // 32) * 32
            assert d_ops[key] % 32 == 0 and d_ops[key] <= d_ops[a].shape[1]
            assert not d_ops[a][:, n + 1:].any()

    def test_data_rows(self):
        """data_rows stops at the last row that matches a pod, and the
        wrapper counts only valid pods: a target whose pods are all
        invalid moves the pseudo row (and the live depth) before it."""
        t = torch.tensor([[0, 0, 0], [0, 1, 0], [0, 0, 0]], dtype=torch.int8)
        assert dk.data_rows(t) == 2
        assert dk.data_rows(torch.zeros(4, 3, dtype=torch.int8)) == 0
        assert dk.data_rows(torch.zeros(0, 3, dtype=torch.int8)) == 0
        ops = _operands(0, 1, 40, 70, 9, 9)
        ops["tmatch_e"][:] = False
        ops["tmatch_e"][[3, 35], 4] = True
        ops["tmatch_i"][:] = False
        ops["tmatch_i"][[2, 64], [1, 6]] = True
        vs = np.ones(9, dtype=bool)
        vd = np.ones(9, dtype=bool)
        vd[6] = False  # ingress target 64 matches only an invalid pod
        d_ops = dk.dense_operands(*_port_args(ops), torch.from_numpy(vs), torch.from_numpy(vd))
        assert (d_ops["live_e"], d_ops["live_i"]) == (64, 32)
        assert d_ops["a_e"][4, 35] == 1 and d_ops["a_e"][:9, 36].equal(
            torch.from_numpy(~ops["has_e"] & vs).to(torch.int8))
        assert not d_ops["a_i"][:, 4:].any()
        want = ref_pk.verdict_counts_pallas_rect(
            *_ref_args(ops), valid_src=vs, valid_dst=vd, interpret=True,
        )
        got = dk.counts_from_ops(d_ops)
        assert np.array_equal(_per_q(got), _per_q(want))

    def test_chunk_rule_and_helpers(self):
        for n in (0, 1, 127, 128, 129, 383, 1023, 1024, 1025, 5000):
            assert dk._kt_for(n) == ref_pk._kt_for(n)
            assert dk.lane_round_up(n) == ref_pk.lane_round_up(n)
        for w in (1, 8, 31, 32, 64, 127, 128):
            assert dk.slab_w_aug(w) == ref_pk.slab_w_aug("int8", w)
        assert dk.slab_w_aug() == ref_pk.slab_w_aug("int8")

    def test_every_kernel_names_its_instance(self):
        """Each launch counter has the CUDA instance its wrapper launches,
        in the order of the C entry's `kind`: K4 and K6 without the skip,
        K5 with it, K6 in 64-byte stages."""
        assert list(dk.INSTANCES) == list(dk.LAUNCHES)
        assert [dk._KIND[k] for k in dk.LAUNCHES] == [0, 1, 2]
        assert dk.INSTANCES["dense_counts_chunked"] == "dense_counts_kernel<true, 128>"
        assert {dk.INSTANCES[k] for k in ("dense_counts_1chunk", "dense_counts_slab")} == {
            "dense_counts_kernel<false, 128>", "dense_counts_kernel<false, 64>"}

    def test_int32_partial_guard_and_device(self):
        args = _port_args(_operands(0, 1, 1, 1, 4, 4))
        with pytest.raises(ValueError, match="too large"):
            dk.verdict_counts_rect(*args, bs=2**25)
        with pytest.raises(ValueError, match="multiple of 64"):
            dk.verdict_counts_rect(*args, bs=100)
        with pytest.raises(ValueError, match="no dense counts kernel"):
            dk.verdict_counts_rect(*[a.to("meta") for a in args])


class TestSlab:
    @pytest.mark.parametrize("seed", range(6))
    def test_slab_windows_match_reference(self, seed):
        rng = np.random.default_rng(seed)
        t, n = int(rng.integers(0, 40)), int(rng.integers(0, 90))
        tm = (np.sort(rng.integers(0, 6, t))[:, None] == np.sort(rng.integers(0, 6, n))[None, :]) & (
            rng.random((t, n)) < 0.5
        )
        for tile in (4, 8, 16):
            for w in (1, 4, 8, 32):
                got = dk.slab_windows(tm, tile, w)
                want = ref_pk.slab_windows(tm, tile, w)
                assert got[1] == want[1] and np.array_equal(got[0], want[0])

    # (seed, q, te, ti, n, bs, bd, w, namespaces)
    SLABS = [
        (0, 1, 12, 16, 40, 8, 8, 8, 10),
        (1, 2, 30, 20, 70, 16, 8, 4, 20),
        (2, 3, 25, 40, 100, 8, 16, 32, 12),
        # tiles off the CUDA kernel's 128 x 256 item, a tile pair of
        # several items, w_aug = 160 (w = 128), Q = 1 and 3
        (3, 1, 60, 80, 300, 136, 200, 16, 20),
        (4, 2, 100, 120, 1000, 256, 512, 32, 50),
        (5, 3, 150, 200, 400, 64, 32, 128, 30),
        (6, 1, 40, 50, 350, 72, 328, 128, 25),
    ]

    @pytest.mark.parametrize("seed,q,te,ti,n,bs,bd,w,n_ns", SLABS)
    def test_operands_and_counts_match_reference(self, seed, q, te, ti, n, bs, bd, w, n_ns):
        """The gathered operands equal the reference's slab_operands (in
        the port's target-innermost layout), with windows from the host
        reduction and with out-of-range starts (clipped as the reference
        clips them); the counts equal the reference's slab kernel, and
        equal K4's wherever the windows hold."""
        ops = _operands(seed, q, te, ti, n, n, n_ns)
        n_pods = n - 3
        live = np.arange(n) < n_pods
        t0 = [dk.slab_windows(ops[k] & live[None, :], tile, w) for k, tile in
              (("tmatch_e", bs), ("tmatch_i", bd))]
        n_i, n_j = -(-n // bs), -(-n // bd)
        wild = (np.arange(n_i, dtype=np.int32) * 7 - 3, np.full(n_j, 10**6, dtype=np.int32))
        for t0_e, t0_i in ((t0[0][0], t0[1][0]), wild):
            want_ops = ref_pk.slab_operands(
                *_ref_args(ops), t0_e, t0_i, n_pods, bs=bs, bd=bd, w=w
            )
            got_ops = dk.slab_operands(*_port_args(ops), t0_e, t0_i, n_pods, bs=bs, bd=bd, w=w)
            for k in ("a_e", "a_i"):
                assert np.array_equal(got_ops[k].transpose(1, 2).numpy(), np.asarray(want_ops[k]))
            for k in ("b_e", "b_i"):
                assert np.array_equal(got_ops[k].transpose(2, 3).numpy(), np.asarray(want_ops[k]))
            want = ref_pk.verdict_counts_pallas_slab_from_ops(want_ops, interpret=True)
            got = dk.verdict_counts_slab_from_ops(got_ops)
            assert np.array_equal(got.numpy(), np.asarray(want))
        # the narrowest doubling of w whose windows hold every target
        while True:
            t0 = [dk.slab_windows(ops[k] & live[None, :], tile, w) for k, tile in
                  (("tmatch_e", bs), ("tmatch_i", bd))]
            if t0[0][1] and t0[1][1]:
                break
            w *= 2
        slab = dk.verdict_counts_slab_from_ops(dk.slab_operands(
            *_port_args(ops), t0[0][0], t0[1][0], n_pods, bs=bs, bd=bd, w=w
        ))
        dense = dk.verdict_counts(*_port_args(ops), n_pods=n_pods)
        assert sum_partials(slab, q, n_pods) == sum_partials(dense, q, n_pods)

    def test_shape_checks(self):
        ops = _operands(3, 1, 5, 5, 16, 16)
        got = dk.slab_operands(*_port_args(ops), [0, 0], [0, 0], 16, bs=8, bd=8, w=4)
        bad = dict(got, b_e=got["b_e"][:, :1])
        with pytest.raises(ValueError, match="disagree"):
            dk.verdict_counts_slab_from_ops(bad)
        with pytest.raises(ValueError, match="window starts"):
            dk.slab_operands(*_port_args(ops), [0], [0, 0], 16, bs=8, bd=8, w=4)


def _tiny_slab(monkeypatch):
    """Both packages' slab tiles and window ceiling set to 8, so a fuzz
    cluster spans several tiles."""
    for mod in (ref_pk, dk):
        monkeypatch.setattr(mod, "SLAB_BS", 8)
        monkeypatch.setattr(mod, "SLAB_BD", 8)
        monkeypatch.setattr(mod, "SLAB_W", 8)


def _ref_engine(monkeypatch, policies, pods, namespaces, **kw):
    monkeypatch.setenv("CYCLONUS_PACK", "0")
    return TpuPolicyEngine(ref_build(True, policies), pods, namespaces, **kw)


class TestSlabPlan:
    @pytest.mark.parametrize("seed,extra", [(34, 10), (30, 9), (31, 30)])
    def test_plan_matches_reference(self, monkeypatch, seed, extra):
        """The port's slab plan (t0 per direction, the shared w) equals the
        reference engine's on the same ns-sorted axis, and the slab route's
        counts equal the reference's."""
        _tiny_slab(monkeypatch)
        monkeypatch.setenv("CYCLONUS_PALLAS_SLAB", "1")
        policies, pods, namespaces = fuzz_policies(seed, extra)
        ref = _ref_engine(monkeypatch, policies, pods, namespaces, class_compress="0")
        port = TorchPolicyEngine(
            port_policy(policies), pods, namespaces, device="cpu", class_compress="0"
        )
        assert not port._pack and port._slab_mode == "1"
        counts = port.evaluate_grid_counts(PORT_CASES)
        ns = ref._tensors["pod_ns_id"]
        perm = np.argsort(np.where(ns < 0, np.iinfo(np.int32).max, ns), kind="stable")
        want = ref._slab_plan(perm.astype(np.int32))
        got = port._slab_plan_state
        assert isinstance(want, dict) and isinstance(got, dict)
        assert got["w"] == want["w"]
        for d in ("egress", "ingress"):
            assert np.array_equal(np.asarray(got[d]), np.asarray(want[d]))
        assert counts == ref.evaluate_grid_counts(REF_CASES, backend="xla")

    def test_plan_gate_rejects_like_reference(self, monkeypatch):
        """Two same-namespace targets that both match pods fill two rows of
        one tile's window, so a window ceiling of 1 is never eligible: both
        plans come back None and the chunked kernels give the counts."""
        _tiny_slab(monkeypatch)
        for mod in (ref_pk, dk):
            monkeypatch.setattr(mod, "SLAB_W", 1)
        monkeypatch.setenv("CYCLONUS_PALLAS_SLAB", "1")
        pods, namespaces = default_cluster()
        policies = [
            mkpol("p1", "x", LabelSelector.make(match_labels={"pod": "a"}), ["Ingress"], ingress=[]),
            mkpol("p2", "x", LabelSelector.make(match_labels={"pod": "b"}), ["Ingress"], ingress=[]),
        ]
        ref = _ref_engine(monkeypatch, policies, pods, namespaces)
        port = TorchPolicyEngine(port_policy(policies), pods, namespaces, device="cpu")
        counts = port.evaluate_grid_counts(PORT_CASES)
        ns = ref._tensors["pod_ns_id"]
        perm = np.argsort(np.where(ns < 0, np.iinfo(np.int32).max, ns), kind="stable")
        assert ref._slab_plan(perm.astype(np.int32)) is None
        assert port._slab_plan_state is None
        assert counts == ref.evaluate_grid_counts(REF_CASES, backend="xla")

    def test_budget_and_size_gates(self, monkeypatch):
        _tiny_slab(monkeypatch)
        policies, pods, namespaces = fuzz_policies(34, 10)
        port = TorchPolicyEngine(port_policy(policies), pods, namespaces, device="cpu",
                                 class_compress="0", pack=False, slab="1")
        perm = np.arange(port._tensors["pod_ns_id"].shape[0])
        assert host._slab_plan(port._tensors, perm, port.n_pods, 0) is not None
        assert host._slab_plan(port._tensors, perm, port.n_pods, 1 << 40) is None
        monkeypatch.setattr(dk, "SLAB_BS", 1 << 20)
        assert host._slab_plan(port._tensors, perm, port.n_pods, 0) is None


class _Spy:
    """Counts the calls of the dense kernels' wrappers and the tile loop."""

    def __init__(self, monkeypatch):
        self.calls = []
        for mod, name in ((dk, "counts_from_ops"), (dk, "verdict_counts_slab_from_ops"),
                          (tiled, "evaluate_grid_counts"), (tiled, "_class_rowsums_kernel"),
                          (tiled, "class_rowsums")):
            fn = getattr(mod, name)
            monkeypatch.setattr(mod, name, self._wrap(name, fn))

    def _wrap(self, name, fn):
        def spy(*a, **kw):
            self.calls.append(name)
            return fn(*a, **kw)
        return spy


# (seed, extra pods, engine options, the route's call): every counts
# route of the dense plan
ROUTES = [
    (0, 4, {"class_compress": "0"}, "counts_from_ops"),
    (1, 7, {"class_compress": "0", "compact": False}, "counts_from_ops"),
    (2, 13, {"class_compress": "1"}, "_class_rowsums_kernel"),
    (5, 13, {"class_compress": "0", "slab": "1"}, "verdict_counts_slab_from_ops"),
]


class TestEnginePackOff:
    @pytest.mark.parametrize("seed,extra,kw,route", ROUTES)
    def test_counts_every_route(self, monkeypatch, seed, extra, kw, route):
        """pack=False counts equal TpuPolicyEngine's under CYCLONUS_PACK=0
        (its tile loop and its Pallas kernels in interpret mode) on the
        dense route (K4 or K5), the class route (tile-loop row sums) and
        the slab route (K6); backend="xla" takes the tile loop."""
        _tiny_slab(monkeypatch)
        policies, pods, namespaces = fuzz_policies(seed, extra)
        ref_kw = {k: v for k, v in kw.items() if k != "slab"}
        if "slab" in kw:
            monkeypatch.setenv("CYCLONUS_PALLAS_SLAB", "1")
        ref = _ref_engine(monkeypatch, policies, pods, namespaces, **ref_kw)
        want = ref.evaluate_grid_counts(REF_CASES, backend="xla")
        if route == "counts_from_ops":
            assert ref.evaluate_grid_counts(REF_CASES, backend="pallas") == want
        port = TorchPolicyEngine(port_policy(policies), pods, namespaces, device="cpu",
                                 pack=False, **kw)
        spy = _Spy(monkeypatch)
        assert port.evaluate_grid_counts(PORT_CASES) == want
        assert spy.calls == [route]
        spy.calls.clear()
        assert port.evaluate_grid_counts(PORT_CASES, backend="xla", block=4) == want
        assert spy.calls == ["_class_rowsums_kernel" if route.startswith("_class")
                             else "evaluate_grid_counts"]

    @pytest.mark.parametrize("seed,extra", [(1, 7), (4, 11), (6, 3)])
    def test_live_depth_is_data_rows(self, monkeypatch, seed, extra):
        """On the engine's dense route the live depth is each direction's
        rows up to the last encoded target that matches a valid pod, plus
        the pseudo row; the inert targets that bucket the axis lie past
        it, and the rows chip_smoke.live_target_rows counts (the numbers
        its K4 / K5 bounds use) lie within it."""
        import chip_smoke
        from cyclonus_tpu_torch.engine.tiled import _precompute

        policies, pods, namespaces = fuzz_policies(seed, extra)
        port = TorchPolicyEngine(port_policy(policies), pods, namespaces, device="cpu",
                                 pack=False, class_compress="0", compact=False)
        seen = []
        real = dk.dense_operands

        def spy(*a, **kw):
            seen.append(real(*a, **kw))
            return seen[-1]

        monkeypatch.setattr(dk, "dense_operands", spy)
        port.evaluate_grid_counts(PORT_CASES)
        (ops,) = seen
        pre = _precompute(port._dense_counts_tensors(PORT_CASES), False)
        valid = np.arange(pre["egress"]["tmatch"].shape[1]) < port.n_pods
        for d, key, a, kt in (("egress", "live_e", "a_e", "kt_e"),
                              ("ingress", "live_i", "a_i", "kt_i")):
            target_ns = port._tensors[d]["target_ns"]
            tmatch = pre[d]["tmatch"].numpy()
            n = _data_rows(tmatch, valid)
            encoded = np.flatnonzero(target_ns >= 0)
            assert n <= (encoded[-1] + 1 if encoded.size else 0)
            # the inert targets that bucket the axis match no pod
            assert not (tmatch[target_ns < 0] & valid[None, :]).any()
            assert ops[key] == dk.live_depth(n)
            rows = chip_smoke.live_target_rows(ops[a], ops[kt])
            assert int(rows.sum()) == int((tmatch & valid[None, :]).any(axis=1).sum()) + int(
                ops[a][:, n].any())
            assert int(rows.sum()) <= n + 1
            assert not ops[a][:, ops[key]:].any()

    @pytest.mark.parametrize("mode", ["0", "1"])
    def test_grid_pack_off(self, monkeypatch, mode):
        policies, pods, namespaces = fuzz_policies(3, 9)
        ref = _ref_engine(monkeypatch, policies, pods, namespaces, class_compress=mode)
        port = TorchPolicyEngine(port_policy(policies), pods, namespaces, device="cpu",
                                 class_compress=mode, pack=False)
        got = grids(port.evaluate_grid(PORT_CASES))
        assert_tree_equal(grids(ref.evaluate_grid(REF_CASES)), got)
        assert_tree_equal(
            oracle.oracle_grid(port_policy(policies), pods, namespaces, PORT_CASES), got
        )

    def test_env_and_arguments(self, monkeypatch):
        policies, pods, namespaces = fuzz_policies(0, 4)
        pol = port_policy(policies)
        monkeypatch.setenv("CYCLONUS_PACK", "0")
        monkeypatch.setenv("CYCLONUS_PALLAS_SLAB", "1")
        eng = TorchPolicyEngine(pol, pods, namespaces, device="cpu")
        assert not eng._pack and eng._slab_mode == "1"
        eng = TorchPolicyEngine(pol, pods, namespaces, device="cpu", pack=True, slab="0")
        assert eng._pack and eng._slab_mode == "0"
        with pytest.raises(ValueError, match="CYCLONUS_PALLAS_SLAB"):
            TorchPolicyEngine(pol, pods, namespaces, device="cpu", slab="on")
        monkeypatch.setenv("CYCLONUS_PALLAS_SLAB", "yes")
        with pytest.raises(ValueError, match="CYCLONUS_PALLAS_SLAB"):
            TorchPolicyEngine(pol, pods, namespaces, device="cpu")
        monkeypatch.setenv("CYCLONUS_PALLAS_SLAB", "AUTO")
        assert TorchPolicyEngine(pol, pods, namespaces, device="cpu")._slab_mode == "auto"
        monkeypatch.setenv("CYCLONUS_PACK", "maybe")
        with pytest.raises(ValueError, match="CYCLONUS_PACK"):
            TorchPolicyEngine(pol, pods, namespaces, device="cpu")
        with pytest.raises(ValueError, match="unknown counts backend"):
            TorchPolicyEngine(pol, pods, namespaces, device="cpu", pack=True).evaluate_grid_counts(
                PORT_CASES, backend="mosaic")

    @pytest.mark.parametrize("mode", [None, "auto", "0", "1", "AUTO"])
    def test_pack_enabled_matches_reference(self, monkeypatch, mode):
        if mode is None:
            monkeypatch.delenv("CYCLONUS_PACK", raising=False)
        assert pack_enabled(mode) == ref_pack_enabled(mode)
        for bad in ("2", "yes"):
            with pytest.raises(ValueError):
                pack_enabled(bad)
            with pytest.raises(ValueError):
                ref_pack_enabled(bad)

    def test_class_eligibility_matches_reference(self, monkeypatch):
        """The dense-plan branch of the class-route budget: both engines
        take the same decision as the budget moves past the estimate."""
        policies, pods, namespaces = fuzz_policies(2, 13)
        ref = _ref_engine(monkeypatch, policies, pods, namespaces, class_compress="1")
        port = TorchPolicyEngine(port_policy(policies), pods, namespaces, device="cpu",
                                 class_compress="1", pack=False)
        for budget in (1, 10_000, 40_000, 1 << 30):
            monkeypatch.setenv("CYCLONUS_SLAB_MAX_BYTES", str(budget))
            for q in (1, 3):
                assert port._class_counts_eligible(q) == ref._class_counts_eligible(q)


@pytest.mark.cuda
class TestCudaKernels:
    @pytest.mark.parametrize("seed,q,te,ti,ns,nd,n_ns", SHAPES + [(7, 2, 3000, 2500, 2048, 1900, 200)])
    def test_dense_kernels_match_plain(self, seed, q, te, ti, ns, nd, n_ns):
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA device: the kernel has no CPU mode")
        ops = _operands(seed, q, te, ti, ns, nd, n_ns)
        args = [a.cuda() for a in _port_args(ops)]
        vs = torch.from_numpy(ops["valid_src"]).cuda()
        vd = torch.from_numpy(ops["valid_dst"]).cuda()
        d_ops = dk.dense_operands(*args, vs, vd, bs=64)
        kind = "dense_counts_1chunk" if dk.single_chunk(d_ops) else "dense_counts_chunked"
        before = dk.LAUNCHES[kind]
        got = dk.counts_from_ops(d_ops)
        torch.cuda.synchronize()
        assert dk.LAUNCHES[kind] == before + 1
        assert torch.equal(got, dk.counts_from_ops(d_ops, plain=True))

    @pytest.mark.parametrize("seed,q,te,ti,ns,nd,n_ns,pads", RAGGED + [
        (34, 3, 2200, 1500, 1000, 700, 40, (37, 5)),
        (35, 2, 1030, 1100, 4100, 2000, 500, (7, 0))])
    def test_ragged_live_depth_matches_plain(self, seed, q, te, ti, ns, nd, n_ns, pads):
        """K5 stops at the live depth; its plain version contracts every
        row, pads included, and skips no block."""
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA device: the kernel has no CPU mode")
        ops = _with_pads(_operands(seed, q, te, ti, ns, nd, n_ns), pads)
        args = [a.cuda() for a in _port_args(ops)]
        vs = torch.from_numpy(ops["valid_src"]).cuda()
        vd = torch.from_numpy(ops["valid_dst"]).cuda()
        for bs in (64, None):
            d_ops = dk.dense_operands(*args, vs, vd, bs=bs)
            kind = "dense_counts_1chunk" if dk.single_chunk(d_ops) else "dense_counts_chunked"
            before = dk.LAUNCHES[kind]
            got = dk.counts_from_ops(d_ops)
            torch.cuda.synchronize()
            assert dk.LAUNCHES[kind] == before + 1
            assert torch.equal(got, dk.counts_from_ops(d_ops, plain=True))

    @pytest.mark.parametrize("seed,q,te,ti,n,bs,bd,w,n_ns", TestSlab.SLABS + [
        (3, 2, 200, 300, 5000, 2048, 1024, 128, 100)])
    def test_slab_kernel_matches_plain(self, seed, q, te, ti, n, bs, bd, w, n_ns):
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA device: the kernel has no CPU mode")
        ops = _operands(seed, q, te, ti, n, n, n_ns)
        live = np.arange(n) < n - 3
        t0 = [dk.slab_windows(ops[k] & live[None, :], tile, w)[0] for k, tile in
              (("tmatch_e", bs), ("tmatch_i", bd))]
        args = [a.cuda() for a in _port_args(ops)]
        s_ops = dk.slab_operands(*args, t0[0], t0[1], n - 3, bs=bs, bd=bd, w=w)
        before = dk.LAUNCHES["dense_counts_slab"]
        got = dk.verdict_counts_slab_from_ops(s_ops)
        torch.cuda.synchronize()
        assert dk.LAUNCHES["dense_counts_slab"] == before + 1
        assert torch.equal(got, dk.verdict_counts_slab_from_ops(s_ops, plain=True))
