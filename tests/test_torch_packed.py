"""The packed verdict-count kernel's plain PyTorch version
(cyclonus_tpu_torch/engine/packed_kernel.py) against the reference's
packed Pallas kernel (cyclonus_tpu/engine/pallas_kernel.py, interpret
mode) on identical seeded operands: both epilogues (plain counts and
dst-weighted row sums), each untiered and tiered, ragged shapes, several
port cases, word depths and tier row counts, pad tier rows, explicit
rectangular validity masks.  Exact equality.

The CUDA kernel itself is held against the plain version on the card by
the `cuda`-marked test at the end (skipped without a card) and by
chip_smoke.py."""

import numpy as np
import pytest
import torch

from cyclonus_tpu.engine.encoding import TIER_KEY_NONE
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


def _tier(seed, q, ns, nd, ge, gi, density=0.3, ordered=False):
    """A seeded `tier` operand ({direction: {subj, peerq, anp_key,
    banp_key}}) as numpy arrays: random subjects and peers, ANP rows with
    Allow/Deny/Pass, BANP rows with Allow/Deny, random ranks with ties,
    and pad rows (both keys TIER_KEY_NONE).  ordered=True lays the rows
    out as the engine does: ANP rows first, then BANP rows, each by
    non-decreasing key."""
    rng = np.random.default_rng(seed)

    def keys(g):
        rank = rng.integers(0, max(g // 2, 1), size=g)
        banp = rng.random(g) < 0.3
        act = np.where(banp, rng.integers(1, 3, size=g), rng.integers(1, 4, size=g))
        key = (rank * 4 + act).astype(np.int32)
        if ordered:
            key = np.concatenate([np.sort(key[~banp]), np.sort(key[banp])])
            banp = np.sort(banp)
        pad = rng.random(g) < 0.2
        anp_key = np.where(~banp & ~pad, key, TIER_KEY_NONE).astype(np.int32)
        banp_key = np.where(banp & ~pad, key, TIER_KEY_NONE).astype(np.int32)
        return anp_key, banp_key

    ea, eb = keys(ge)
    ia, ib = keys(gi)
    return {
        "egress": {
            "subj": rng.random((ge, ns)) < density,
            "peerq": rng.random((ge, nd, q)) < density,
            "anp_key": ea,
            "banp_key": eb,
        },
        "ingress": {
            "subj": rng.random((gi, nd)) < density,
            "peerq": rng.random((gi, ns, q)) < density,
            "anp_key": ia,
            "banp_key": ib,
        },
    }


def _tier_torch(tier, device="cpu"):
    return {d: {k: torch.from_numpy(v).to(device) for k, v in t.items()} for d, t in tier.items()}


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


# (seed, q, we, wi, ns, nd): word depths around the kernel's 8-word steps,
# unequal per direction, Q 1-3, pod axes one off 128 and 256
DEPTHS = [
    (0, 1, 1, 7, 129, 257),
    (1, 2, 7, 8, 257, 129),
    (2, 3, 8, 9, 127, 255),
    (3, 1, 9, 12, 255, 127),
    (4, 2, 12, 16, 129, 129),
    (5, 3, 16, 17, 257, 257),
    (6, 1, 17, 33, 130, 250),
    (7, 2, 33, 1, 250, 130),
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

    @pytest.mark.parametrize(
        "seed,q,we,wi,ns,nd,bs,bd,ge,gi",
        # tier rows from one to past one packed word, unequal per direction
        [s + g for s, g in zip(SHAPES, [(1, 4), (8, 8), (4, 12), (40, 33)])],
    )
    def test_tiered(self, seed, q, we, wi, ns, nd, bs, bd, ge, gi):
        ops = _operands(seed + 30, q, we, wi, ns, nd, density=0.02)
        tier = _tier(seed + ge, q, ns, nd, ge, gi)
        tier_t = _tier_torch(tier)
        variants = [
            {"n_pods": min(ns, nd) - 1},
            {"valid_src": ops["valid_src"], "valid_dst": ops["valid_dst"]},
            {"n_pods": ns, "w_dst": ops["w"]},
        ]
        for kw in variants:
            kw = dict(kw, bs=bs, bd=bd)
            want = np.asarray(
                verdict_counts_pallas_packed(*_split(ops), tier=tier, interpret=True, **kw)
            )
            kw_t = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
            got = verdict_counts_packed_plain(*_torch(_split(ops)), tier=tier_t, **kw_t).numpy()
            assert got.dtype == want.dtype and got.shape == want.shape, sorted(kw)
            assert np.array_equal(got, want), sorted(kw)
            # the wrapper takes the plain version for CPU tensors
            wrapped = verdict_counts_packed(*_torch(_split(ops)), tier=tier_t, **kw_t)
            assert np.array_equal(wrapped.numpy(), want)

    @pytest.mark.parametrize("weighted", [False, True])
    @pytest.mark.parametrize("tiered", [False, True])
    @pytest.mark.parametrize("seed,q,we,wi,ns,nd", DEPTHS)
    def test_word_depths(self, seed, q, we, wi, ns, nd, tiered, weighted):
        """Word depths on both sides of the kernel's 8-word (k256) steps,
        unequal per direction, pod axes off 128 and 256: the plain version
        on the K-major, step-padded layout equals the reference exactly."""
        ops = _operands(seed + 40, q, we, wi, ns, nd, density=0.02)
        kw = {"valid_src": ops["valid_src"], "valid_dst": ops["valid_dst"], "bs": 64, "bd": 128}
        if weighted:
            kw["w_dst"] = ops["w"]
        tier = _tier(seed, q, ns, nd, 3, 40) if tiered else None
        want = np.asarray(
            verdict_counts_pallas_packed(*_split(ops), tier=tier, interpret=True, **kw)
        )
        kw_t = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
        got = verdict_counts_packed_plain(
            *_torch(_split(ops)), tier=_tier_torch(tier) if tiered else None, **kw_t
        )
        assert got.dtype == torch.float32 if weighted else got.dtype == torch.int32
        assert np.array_equal(got.numpy(), want)

    def test_int32_partial_guard(self):
        ops = _operands(0, 1, 1, 1, 4, 4)
        with pytest.raises(ValueError, match="too large"):
            verdict_counts_packed_plain(*_torch(_split(ops)), bs=2**16, bd=2**15)

    def test_unknown_device_raises(self):
        ops = _torch(_split(_operands(0, 1, 1, 1, 4, 4)))
        with pytest.raises(ValueError, match="no packed counts kernel"):
            verdict_counts_packed(*[a.to("meta") for a in ops])


def _word_rule(match, keys):
    """Plain-Python model of the tiered kernel's per-word rule: min keys
    (anp, banp) per cell from match [W, n] int32 (subject & peer words)
    and keys [2, 32 W].  Per word and key vector, the rows with a real key
    form a mask; where the vector's real keys are non-decreasing in bit
    order the word contributes the key of the first set bit of match &
    mask, otherwise the min over its set bits."""
    n_words, n = match.shape
    out = np.full((2, n), TIER_KEY_NONE, dtype=np.int64)
    for v in range(2):
        for w in range(n_words):
            kw = keys[v, 32 * w:32 * (w + 1)]
            real_bits = [b for b in range(32) if kw[b] < TIER_KEY_NONE]
            real = sum(1 << b for b in real_bits)
            ordered = all(kw[a] <= kw[b] for a, b in zip(real_bits, real_bits[1:]))
            for j in range(n):
                m = int(match[w, j]) & 0xFFFFFFFF & real
                if not m:
                    continue
                bits = [b for b in range(32) if m >> b & 1]
                best = kw[bits[0]] if ordered else min(kw[b] for b in bits)
                out[v, j] = min(out[v, j], best)
    return out


class TestWordRule:
    @pytest.mark.parametrize("seed", range(6))
    @pytest.mark.parametrize("ordered", [True, False])
    def test_word_rule_matches_min_keys(self, seed, ordered):
        """The per-word rule that the kernel's fast path takes (first set
        bit under ordered keys, the walk otherwise) equals the plain
        version's min over every matching row, on seeded words with pad
        rows, whole pad words, and keys in and out of order."""
        rng = np.random.default_rng(seed)
        n_words, n = 3, 200
        tier = _tier(seed, 1, 1, 1, 32 * n_words, 1, ordered=ordered)["egress"]
        keys = np.stack([tier["anp_key"], tier["banp_key"]])
        keys[:, 32:64] = TIER_KEY_NONE  # a word with no real row
        bits = rng.random((n_words, n, 32)) < rng.choice([0.02, 0.2, 0.6])
        match = (bits.astype(np.uint64) << np.arange(32, dtype=np.uint64)).sum(-1)
        match = match.astype(np.uint32).view(np.int32)
        kt = torch.from_numpy(keys)
        got = packed_kernel._min_keys(
            lambda w: torch.from_numpy(match[w]), kt, packed_kernel._live_rows(kt), (n,), "cpu"
        )
        want = _word_rule(match, keys)
        assert np.array_equal(np.stack([g.numpy() for g in got]), want)
        real = keys < TIER_KEY_NONE
        in_order = [bool((np.diff(keys[v, 32 * w:32 * w + 32][real[v, 32 * w:32 * w + 32]]) >= 0).all())
                    for v in range(2) for w in range(n_words)]
        assert all(in_order) if ordered else not all(in_order)


class TestKernelLayout:
    """What the CUDA kernel rests on, held on the CPU: the popc identity of
    its single-bit products, the operand layout its tensor maps read, and
    the tables and walk order its epilogue reads."""

    def test_popc_sum_identity(self):
        """sum_w popc(a & b) != 0 exactly where OR_w(a & b) != 0, and the
        sum stays below 2^31, up to 420 words with all-ones rows."""
        rng = np.random.default_rng(0)
        for depth in (1, 8, 9, 33, 420):
            a = rng.integers(0, 2**32, size=(40, depth), dtype=np.uint64).astype(np.uint32)
            b = rng.integers(0, 2**32, size=(50, depth), dtype=np.uint64).astype(np.uint32)
            a &= np.where(rng.random((40, depth)) < 0.9, 0, 0xFFFFFFFF).astype(np.uint32)
            b &= np.where(rng.random((50, depth)) < 0.9, 0, 0xFFFFFFFF).astype(np.uint32)
            a[0] = b[0] = 0xFFFFFFFF  # all ones: the largest sum
            a[1] = 0  # no bit: a zero sum
            both = a[:, None, :] & b[None, :, :]
            popc = np.bitwise_count(both).sum(axis=2, dtype=np.int64)
            ored = np.bitwise_or.reduce(both, axis=2)
            assert np.array_equal(popc != 0, ored != 0)
            assert popc.max() == 32 * depth < 2**31

    @pytest.mark.parametrize("seed,q,we,wi,ns,nd", DEPTHS[:4])
    def test_operand_layout(self, seed, q, we, wi, ns, nd):
        """K-major contraction operands padded to whole 8-word steps with
        zero words (16-byte row strides for TMA), the flags in their own
        vectors, nothing of the flags in the contraction rows."""
        ops = _operands(seed, q, we, wi, ns, nd)
        args = _torch(_split(ops))
        vs, vd = torch.from_numpy(ops["valid_src"]), torch.from_numpy(ops["valid_dst"])
        lay = packed_kernel._packed_operands(*args, vs, vd, None, None, 64, 128)
        ns_pad, nd_pad = -(-ns // 64) * 64, -(-nd // 128) * 128
        de, di = -(-we // 8) * 8, -(-wi // 8) * 8
        nb = -(-nd_pad // 256)
        shapes = {"a_e": (ns_pad, de), "b_e": (q, nd_pad, de), "b_i": (q, ns_pad, di),
                  "a_i": (nd_pad, di), "f_s": (ns_pad,), "f_d_frag": (2, nb, 4, 4)}
        for name, shape in shapes.items():
            t = lay[name]
            assert tuple(t.shape) == shape and t.dtype == torch.int32 and t.is_contiguous(), name
            if t.dim() > 1:
                assert t.stride(-2) * t.element_size() % 16 == 0, name
        for name, w in (("a_e", we), ("b_e", we), ("b_i", wi), ("a_i", wi)):
            assert not lay[name][..., w:].any(), f"{name}: pad words not zero"
        tm_e, has_e, tl_e, tm_i, has_i, tl_i = args
        assert torch.equal(lay["a_e"][:ns, :we], torch.where(vs[None], tm_e, 0).T)
        want_be = torch.where(vd[None, :, None], tl_e, 0).permute(2, 1, 0)
        want_bi = torch.where(vs[None, :, None], tl_i, 0).permute(2, 1, 0)
        assert torch.equal(lay["b_e"][:, :nd, :we], want_be)
        assert torch.equal(lay["b_i"][:, :ns, :wi], want_bi)
        assert torch.equal(lay["a_i"][:nd, :wi], torch.where(vd[None], tm_i, 0).T)
        assert torch.equal(lay["f_s"][:ns], has_e.int() + 2 * vs.int())
        valid_d, has_d = packed_kernel._unfragments(lay["f_d_frag"], nd_pad)
        assert torch.equal(valid_d[:nd], vd) and torch.equal(has_d[:nd], has_i)
        assert not lay["f_s"][ns:].any() and not (valid_d[nd:].any() or has_d[nd:].any())

    @pytest.mark.parametrize("q,ns,nd,ge,gi", [(1, 9, 9, 1, 1), (2, 130, 300, 4, 70),
                                               (3, 257, 129, 100, 33)])
    def test_tier_layout(self, q, ns, nd, ge, gi):
        """The tier walk's layout: positions padded to a multiple of PASS,
        position words and fragments 16-byte aligned per row, each
        position's bits those of its row (validity-masked), pad positions
        zero with no key."""
        ops = _operands(q, q, 3, 5, ns, nd)
        tier = _tier_torch(_tier(q, q, ns, nd, ge, gi))
        vs, vd = torch.from_numpy(ops["valid_src"]), torch.from_numpy(ops["valid_dst"])
        lay = packed_kernel._packed_operands(*_torch(_split(ops)), vs, vd, tier, None, 64, 128)
        t = lay["tier"]
        ns_pad, nd_pad = -(-ns // 64) * 64, -(-nd // 128) * 128
        nb = -(-nd_pad // 256)
        for d, side, g in (("e", tier["egress"], ge), ("i", tier["ingress"], gi)):
            lp = -(-2 * g // packed_kernel.PASS) * packed_kernel.PASS
            want = {"key": (lp,), "real": (2,),
                    "rows": (ns_pad, lp // 32) if d == "e" else (q, ns_pad, lp // 32),
                    "frag": (q, nb, lp, 4, 4) if d == "e" else (nb, lp, 4, 4)}
            for name, shape in want.items():
                a = t[f"{name}_{d}"]
                assert tuple(a.shape) == shape and a.dtype == torch.int32 and a.is_contiguous()
                if name in ("rows", "frag"):
                    assert a.stride(-2 if name == "rows" else -3) * 4 % 16 == 0
            rows, key, real = packed_kernel._walk(side["anp_key"], side["banp_key"])
            n_real = int(real.sum())
            assert torch.equal(t[f"key_{d}"][:n_real], key[:n_real])
            assert (t[f"key_{d}"][n_real:] == TIER_KEY_NONE).all()
            bits = ((t[f"rows_{d}"][..., :, None] >> torch.arange(32)) & 1).flatten(-2) != 0
            dst = packed_kernel._unfragments(t[f"frag_{d}"].transpose(-4, -3), nd_pad)
            if d == "e":
                want_src = (side["subj"] & vs)[rows].T  # [Ns, 2 G]
                want_dst = (side["peerq"] & vd[:, None]).permute(2, 0, 1)[:, rows]  # [Q, 2 G, Nd]
            else:
                want_src = (side["peerq"] & vs[:, None]).permute(2, 1, 0)[:, :, rows]
                want_dst = (side["subj"] & vd)[rows]
            assert torch.equal(bits[..., :ns, : 2 * g], want_src)
            assert not bits[..., ns:, :].any() and not bits[..., 2 * g:].any()
            assert torch.equal(dst[..., : 2 * g, :nd], want_dst)
            assert not dst[..., 2 * g:, :].any() and not dst[..., nd:].any()

    @pytest.mark.parametrize("n", [1, 128, 255, 256, 300, 1000])
    def test_fragments(self, n):
        """Bit 4 m + 2 h + e of word j for lane class l is column 64 j + 8 m
        + 2 l + e of its 256-column block, for both rows h (the wgmma
        m64n256 accumulator layout); columns past n are 0."""
        rng = np.random.default_rng(n)
        bits = rng.random((3, n)) < 0.5
        frag = packed_kernel._fragments(torch.from_numpy(bits)).numpy().view(np.uint32)
        nb = -(-n // 256)
        assert frag.shape == (3, nb, 4, 4)
        padded = np.zeros((3, nb * 256), dtype=bool)
        padded[:, :n] = bits
        for cb in range(nb):
            for lc in range(4):
                for j in range(4):
                    for b in range(32):
                        col = cb * 256 + 64 * j + 8 * (b >> 2) + 2 * lc + (b & 1)
                        got = (frag[:, cb, lc, j] >> b) & 1
                        assert np.array_equal(got.astype(bool), padded[:, col]), (cb, lc, j, b)
        back = packed_kernel._unfragments(torch.from_numpy(frag.view(np.int32)), n)
        assert np.array_equal(back.numpy(), bits)
        wide = packed_kernel._fragments(torch.from_numpy(bits), n + 300)
        assert wide.shape == (3, -(-(n + 300) // 256), 4, 4)
        assert np.array_equal(packed_kernel._unfragments(wide, n).numpy(), bits)

    @pytest.mark.parametrize("seed", range(4))
    @pytest.mark.parametrize("ordered", [True, False])
    def test_sorted_walk_matches_min_keys(self, seed, ordered):
        """The kernel's rule: walk the positions of _walk (the real ANP
        rows by key, then the real BANP rows by key) and let the first
        position that matches a cell decide it within its tier.  Its
        action equals that of the min key over every row, for keys in any
        order, with ties, pad rows and rows past one word."""
        rng = np.random.default_rng(seed)
        g, n = 70, 300
        t = _tier(seed, 1, 1, 1, g, 1, ordered=ordered)["egress"]
        keys = torch.from_numpy(np.stack([t["anp_key"], t["banp_key"]]))
        match = rng.random((g, n)) < rng.choice([0.05, 0.3])
        rows, key, real = packed_kernel._walk(keys[0], keys[1])
        real = real.tolist()
        assert rows.shape == key.shape == (2 * g,)
        assert real == (keys < TIER_KEY_NONE).sum(1).tolist()
        assert (key[sum(real):] == TIER_KEY_NONE).all()
        for v, walk in enumerate((range(real[0]), range(real[0], sum(real)))):
            walk = [(int(rows[i]), int(key[i])) for i in walk]
            assert [k for _, k in walk] == sorted(k for _, k in walk)
            assert all(keys[v, r] == k for r, k in walk)
            assert sorted(r for r, _ in walk) == (keys[v] < TIER_KEY_NONE).nonzero().flatten().tolist()
            act = np.zeros(n, dtype=np.int64)  # 0: no real row matched
            decided = np.zeros(n, dtype=bool)
            for row, k in walk:
                first = match[row] & ~decided
                act[first] = k & 3
                decided |= match[row]
            kv = keys[v].numpy().astype(np.int64)[:, None]
            want = np.where(match & (kv < TIER_KEY_NONE), kv, TIER_KEY_NONE).min(axis=0)
            assert np.array_equal(decided, want < TIER_KEY_NONE)
            assert np.array_equal(act[decided], want[decided] & 3)


@pytest.mark.cuda
class TestCudaKernel:
    @pytest.mark.parametrize(
        "seed,q,we,wi,ns,nd",
        # word depths from one k256 step (8 words) to several dozen,
        # unequal per direction, and around the step's edge (DEPTHS)
        [(0, 1, 1, 1, 9, 9), (1, 3, 12, 8, 777, 1500), (2, 2, 33, 33, 300, 257),
         (3, 2, 300, 170, 200, 300)] + DEPTHS,
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

    @pytest.mark.parametrize(
        "seed,q,we,wi,ns,nd,ge,gi",
        # tier rows past one staging chunk (512 rows) and past the
        # reference's 1,024-row ceiling
        [(0, 1, 1, 1, 9, 9, 1, 1), (1, 3, 12, 8, 777, 1500, 4, 40), (2, 2, 33, 3, 300, 257, 600, 1500)],
    )
    @pytest.mark.parametrize("ordered", [False, True])
    def test_tiered_kernel_matches_plain(self, seed, q, we, wi, ns, nd, ge, gi, ordered):
        """Keys in random order (the kernel walks each word's set bits) and
        in the engine's order (its first-bit path); tier words within one
        pass and past it."""
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA device: the kernel has no CPU mode")
        ops = _operands(seed, q, we, wi, ns, nd, density=0.02)
        args = [a.cuda() for a in _torch(_split(ops))]
        tier = _tier_torch(_tier(seed, q, ns, nd, ge, gi, density=0.05, ordered=ordered), "cuda")
        vs = torch.from_numpy(ops["valid_src"]).cuda()
        vd = torch.from_numpy(ops["valid_dst"]).cuda()
        w = torch.from_numpy(ops["w"]).cuda()
        before = dict(packed_kernel.LAUNCHES)
        for kw in ({"valid_src": vs, "valid_dst": vd}, {"n_pods": ns - 1, "w_dst": w}):
            got = verdict_counts_packed(*args, tier=tier, **kw)
            torch.cuda.synchronize()
            assert torch.equal(got, verdict_counts_packed_plain(*args, tier=tier, **kw))
        for name in ("packed_counts_tiered", "packed_rowsums_tiered"):
            assert packed_kernel.LAUNCHES[name] == before[name] + 1
