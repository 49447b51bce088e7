"""The packed verdict-count kernel's plain PyTorch version
(cyclonus_tpu_torch/engine/packed_kernel.py) against the reference's
packed Pallas kernel (cyclonus_tpu/engine/pallas_kernel.py, interpret
mode) on identical seeded operands: both epilogues (plain counts and
dst-weighted row sums), ragged shapes, several port cases and word
depths, explicit rectangular validity masks.  Exact equality.

The CUDA kernel itself is held against the plain version on the card by
the `cuda`-marked test at the end (skipped without a card) and by
chip_smoke.py."""

import numpy as np
import pytest
import torch

from cyclonus_tpu.engine.pallas_kernel import verdict_counts_pallas_packed
from cyclonus_tpu_torch.engine import packed_kernel
from cyclonus_tpu_torch.engine.packed_kernel import (
    sum_partials,
    verdict_counts_packed,
    verdict_counts_packed_plain,
)


def _operands(seed, q, we, wi, ns, nd, density=0.05):
    """Seeded packed operands: sparse random bits (so some cells stay
    unallowed), words with bit 31 set, random has flags, random weights
    with zeros."""
    rng = np.random.default_rng(seed)

    def words(shape):
        bits = rng.random(shape + (32,)) < density
        w = (bits.astype(np.uint64) << np.arange(32, dtype=np.uint64)).sum(-1)
        return w.astype(np.uint32).view(np.int32)

    return {
        "tmatch_e_pk": words((we, ns)),
        "has_e": rng.random(ns) < 0.7,
        "tallow_e_pk": words((we, nd, q)),
        "tmatch_i_pk": words((wi, nd)),
        "has_i": rng.random(nd) < 0.7,
        "tallow_i_pk": words((wi, ns, q)),
        "w": rng.integers(0, 5, size=nd).astype(np.float32),
        "valid_src": rng.random(ns) < 0.8,
        "valid_dst": rng.random(nd) < 0.8,
    }


def _split(ops):
    args = [ops[k] for k in ("tmatch_e_pk", "has_e", "tallow_e_pk", "tmatch_i_pk", "has_i", "tallow_i_pk")]
    return args


def _torch(args):
    return [torch.from_numpy(np.asarray(a)) for a in args]


# (seed, q, we, wi, ns, nd, bs, bd): ragged axes, Q in {1, 2, 3}, word
# depths 1 .. 12, several src tiles per call
SHAPES = [
    (0, 1, 1, 1, 9, 9, None, None),
    (1, 2, 3, 2, 37, 50, None, None),
    (2, 3, 2, 4, 130, 77, 64, 128),
    (3, 2, 12, 8, 200, 260, 64, 128),
]


class TestPlainVsPallas:
    @pytest.mark.parametrize("seed,q,we,wi,ns,nd,bs,bd", SHAPES)
    def test_counts_n_pods(self, seed, q, we, wi, ns, nd, bs, bd):
        ops = _operands(seed, q, we, wi, ns, nd)
        n = min(ns, nd) - 3
        kw = {"n_pods": n, "bs": bs, "bd": bd}
        want = np.asarray(verdict_counts_pallas_packed(*_split(ops), interpret=True, **kw))
        got = verdict_counts_packed_plain(*_torch(_split(ops)), **kw)
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), want)
        # the wrapper takes the plain version for CPU tensors
        assert np.array_equal(verdict_counts_packed(*_torch(_split(ops)), **kw).numpy(), want)
        assert sum_partials(got, q, n) == sum_partials(want, q, n)

    @pytest.mark.parametrize("seed,q,we,wi,ns,nd,bs,bd", SHAPES)
    def test_counts_rect_masks(self, seed, q, we, wi, ns, nd, bs, bd):
        ops = _operands(seed + 10, q, we, wi, ns, nd)
        kw = {"bs": bs, "bd": bd}
        want = np.asarray(
            verdict_counts_pallas_packed(
                *_split(ops), valid_src=ops["valid_src"], valid_dst=ops["valid_dst"],
                interpret=True, **kw,
            )
        )
        got = verdict_counts_packed_plain(
            *_torch(_split(ops)),
            valid_src=torch.from_numpy(ops["valid_src"]),
            valid_dst=torch.from_numpy(ops["valid_dst"]),
            **kw,
        )
        assert np.array_equal(got.numpy(), want)

    @pytest.mark.parametrize("seed,q,we,wi,ns,nd,bs,bd", SHAPES)
    def test_weighted_rowsums(self, seed, q, we, wi, ns, nd, bs, bd):
        ops = _operands(seed + 20, q, we, wi, ns, nd)
        kw = {"n_pods": ns, "bs": bs, "bd": bd}
        want = np.asarray(
            verdict_counts_pallas_packed(*_split(ops), w_dst=ops["w"], interpret=True, **kw)
        )
        got = verdict_counts_packed_plain(
            *_torch(_split(ops)), w_dst=torch.from_numpy(ops["w"]), **kw
        )
        assert got.dtype == torch.float32
        assert got.shape == want.shape
        assert np.array_equal(got.numpy(), want)

    def test_int32_partial_guard(self):
        ops = _operands(0, 1, 1, 1, 4, 4)
        with pytest.raises(ValueError, match="too large"):
            verdict_counts_packed_plain(*_torch(_split(ops)), bs=2**16, bd=2**15)

    def test_unknown_device_raises(self):
        ops = _torch(_split(_operands(0, 1, 1, 1, 4, 4)))
        with pytest.raises(ValueError, match="no packed counts kernel"):
            verdict_counts_packed(*[a.to("meta") for a in ops])


@pytest.mark.cuda
class TestCudaKernel:
    @pytest.mark.parametrize(
        "seed,q,we,wi,ns,nd",
        # word depths up to several staging chunks, unequal per direction
        [(0, 1, 1, 1, 9, 9), (1, 3, 12, 8, 777, 1500), (2, 2, 33, 33, 300, 257), (3, 2, 300, 170, 200, 300)],
    )
    def test_kernel_matches_plain(self, seed, q, we, wi, ns, nd):
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA device: the kernel has no CPU mode")
        ops = _operands(seed, q, we, wi, ns, nd, density=0.02)
        args = [a.cuda() for a in _torch(_split(ops))]
        vs = torch.from_numpy(ops["valid_src"]).cuda()
        vd = torch.from_numpy(ops["valid_dst"]).cuda()
        w = torch.from_numpy(ops["w"]).cuda()
        before = dict(packed_kernel.LAUNCHES)
        for kw in ({"valid_src": vs, "valid_dst": vd}, {"n_pods": ns - 1, "w_dst": w}):
            got = verdict_counts_packed(*args, **kw)
            torch.cuda.synchronize()
            assert torch.equal(got, verdict_counts_packed_plain(*args, **kw))
        assert packed_kernel.LAUNCHES["packed_counts"] == before["packed_counts"] + 1
        assert packed_kernel.LAUNCHES["packed_rowsums"] == before["packed_rowsums"] + 1
