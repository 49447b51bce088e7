"""The packed verdict-count kernel: the port of the reference's packed
Pallas kernel (cyclonus_tpu/engine/pallas_kernel.py, _make_packed_kernel
under _verdict_counts_pallas_packed) in its plain and weighted epilogues,
each untiered or tiered.

The verdict contraction is pure boolean, so the target axis arrives
packed 32-per-int32-word (tiled._precompute(pack=True)): any_allow is an
OR over ceil(T/32) word AND steps.  Per port case q, src pod s and dst
pod d:

  egress  = ~has_e[s] | OR_w(tmatch_e_pk[w, s] & tallow_e_pk[w, d, q]) != 0
  ingress = ~has_i[d] | OR_w(tallow_i_pk[w, s, q] & tmatch_i_pk[w, d]) != 0
  combined = egress & ingress

With precedence tiers (K3) each direction's verdict first passes through
the ANP -> NetworkPolicy -> BANP lattice (kernel.resolve_tier_lattice)
over the min matching key rank * 4 + action of each admin tier:

  anp_e[s, d, q]  = min over rows g with subj_e[g, s] & peerq_e[g, d, q]
                    of anp_key_e[g]  (TIER_KEY_NONE when no row matches)
  egress  = lattice(egress,  has_e[s], anp_e, banp_e)
  ingress = lattice(ingress, has_i[d], anp_i, banp_i)   (subject = dst,
                                                          peer = src)

and the epilogue is either
  * plain (K1): validity-masked counts, one int32 partial per (q, src
    tile of `bs` rows) -> [Q, n_src_tiles, 3] int32, summed on the host
    in int64 (sum_partials); or
  * weighted (K2): per-src-row sums of each verdict times w_dst[d] (the
    class sizes of the class-compressed route) -> [Q, Ns', 3] float32,
    exact integers below 2^24.

verdict_counts_packed is the wrapper: packed_operands builds the operand
dict, counts_from_packed_ops launches on it, a CPU tensor going through
the plain PyTorch version (verdict_counts_packed_plain), a CUDA tensor
through the hand-written kernel in csrc/packed_counts.cu, and nothing
else.  Both share one operand layout (_packed_operands), the
contraction operands K-major (words innermost), each row zero-padded to
De = We or Di = Wi rounded up to a multiple of STEP_WORDS (8 words, 32
bytes: one step of the kernel's single-bit product; zero words change no
AND, OR or popc):

  a_e [Ns', De] int32     src rows: egress tmatch words
  b_e [Q, Nd', De] int32  dst rows: egress tallow words
  b_i [Q, Ns', Di] int32  src rows: ingress tallow words
  a_i [Nd', Di] int32     dst rows: ingress tmatch words
  f_s [Ns'] int32         src flags: bit 0 = has_target, bit 1 = valid
  f_d_frag [2, nb, 4, 4] int32  dst valid, then dst has, as _fragments
                          lays dst bits out (nb = 256-column blocks)
  w   [Nd'] float32       dst weights (weighted epilogue only)

where _fragments puts a dst-indexed bit vector in the bit order of the
kernel's accumulators, 16 words per 256 columns (_unfragments is its
inverse).  Tiered, each direction's tier rows are listed as one walk
(_walk): the rows with a real ANP key by non-decreasing key, then those
with a real BANP key the same way, then the rest; Lp positions, 2 G
padded to a multiple of PASS.  The tier bits are laid out by position:

  rows_e [Ns', Lp / 32] int32     egress subjects by src row, position words
  rows_i [Q, Ns', Lp / 32] int32  ingress peers by src row
  frag_e [Q, nb, Lp, 4, 4] int32  egress peers as dst fragments
  frag_i [nb, Lp, 4, 4] int32     ingress subjects as dst fragments
  key_e / key_i [Lp] int32        the key of each position, TIER_KEY_NONE
                                  past the real ones
  real_e / real_i [2] int32       real ANP, then BANP positions

The kernel walks the positions in order, the first that matches a cell
deciding it within its tier; the plain version takes each cell's min key
over the same positions.  Both read exactly this layout.

Invalid pod columns are masked out of every packed operand, so a pad pod
contributes nothing to either contraction.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import numpy as np
import torch

from . import build
from .dense_kernel import _check_int32_partials
from .encoding import TIER_KEY_NONE
from .kernel import pack_bool_words_torch, resolve_tier_lattice

#: default tile heights (src x dst) of the reference kernel; `bs` fixes
#: the partial-count granularity of the plain epilogue's output, `bd` the
#: dst-axis padding
PACKED_BS = 512
PACKED_BD = 512

#: the CUDA kernel's granularity: bs must be a multiple of CUDA_SRC_TILE
#: (one consumer warpgroup's rows) and bd of CUDA_DST_TILE on the card
CUDA_SRC_TILE = 64
CUDA_DST_TILE = 128
#: words per step of the kernel's single-bit product (256 bits, 32 bytes);
#: each contraction row is zero-padded to a multiple of it
STEP_WORDS = 8
#: dst columns of one work item of the kernel, and of one block of a
#: fragment table
FRAG_COLS = 256
#: tier walk positions the kernel stages at a time; each direction's walk
#: is padded to a multiple of it
PASS = 128

#: the kernel instance each wrapper launches (csrc/packed_counts.cu)
INSTANCES = {
    "packed_counts": "packed_counts_kernel<false, false>",
    "packed_rowsums": "packed_counts_kernel<true, false>",
    "packed_counts_tiered": "packed_counts_kernel<false, true>",
    "packed_rowsums_tiered": "packed_counts_kernel<true, true>",
}

#: launches of each kernel, counted by the wrapper where it launches
LAUNCHES: Dict[str, int] = {
    "packed_counts": 0,
    "packed_rowsums": 0,
    "packed_counts_tiered": 0,
    "packed_rowsums_tiered": 0,
}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _round_up(n: int, m: int) -> int:
    return -(-max(int(n), 1) // m) * m


def _pad(a, dim, size):
    widths = [0, 0] * (a.dim() - 1 - dim) + [0, size - a.shape[dim]]
    return torch.nn.functional.pad(a, widths).contiguous()


def _fragments(bits: torch.Tensor, n: Optional[int] = None) -> torch.Tensor:
    """[..., N] bits (bool or 0/1) of the dst columns -> [..., nb, 4, 4]
    int32, nb = ceil(n / FRAG_COLS) (n = N by default, at least N): per
    block of FRAG_COLS columns and
    lane class l (lane % 4), the kernel thread's four mask words j.  Bit
    4 m + 2 h + e of word j is column 64 j + 8 m + 2 l + e of the block,
    for both of the thread's rows h (the wgmma m64n256 accumulator layout);
    columns past N are 0."""
    *lead, cols = bits.shape
    nb = -(-max(cols, n or 0) // FRAG_COLS)
    b = _pad(bits.to(torch.int32), len(lead), nb * FRAG_COLS)
    b = b.reshape(*lead, nb, 4, 8, 4, 2)  # [..., nb, j, m, l, e]
    shift = (4 * torch.arange(8, device=b.device).view(8, 1, 1)
             + torch.arange(2, device=b.device).view(1, 1, 2)).to(torch.int32)
    # distinct bits, so the sum is their OR; bits 4 m + e end at bit 29
    words = (b << shift).sum(dim=(-3, -1), dtype=torch.int32)  # [..., nb, j, l]
    # both rows (bit 31 rides the int32 sign)
    return (words | (words << 2)).transpose(-1, -2).contiguous()  # [..., nb, l, j]


def _unfragments(frag: torch.Tensor, n: int) -> torch.Tensor:
    """The inverse of _fragments: [..., nb, 4, 4] int32 -> [..., n] bool,
    each column's bit read from the thread's first row h = 0."""
    *lead, nb, _, _ = frag.shape
    shift = (4 * torch.arange(8, device=frag.device).view(8, 1)
             + torch.arange(2, device=frag.device).view(1, 2)).to(torch.int32)
    b = (frag[..., None, None] >> shift) & 1  # [..., nb, l, j, m, e]
    k = len(lead)
    b = b.permute(*range(k), k, k + 2, k + 3, k + 1, k + 4)  # [..., nb, j, m, l, e]
    return (b.reshape(*lead, nb * FRAG_COLS) != 0)[..., :n]


def _walk(anp_key: torch.Tensor, banp_key: torch.Tensor):
    """(rows [2 G] int64, key [2 G] int32, real [2] int32): one direction's
    tier walk over its G rows: the rows with a real ANP key by
    non-decreasing key, then those with a real BANP key the same way,
    then the rest (key TIER_KEY_NONE), and the number of real ANP and
    BANP positions.  Within a tier the first position that matches a cell
    holds the cell's min key, whatever the order of the rows themselves."""
    keys = torch.stack([anp_key, banp_key]).to(torch.int64)  # [2, G]
    g = keys.shape[1]
    real = keys < TIER_KEY_NONE
    tier = torch.arange(2, device=keys.device).view(2, 1)
    order = torch.where(real, keys + (tier << 31), 1 << 33).flatten()
    _, idx = torch.sort(order, stable=True)
    key = torch.where(order[idx] < 1 << 33, keys.flatten()[idx], TIER_KEY_NONE)
    return idx % max(g, 1), key.to(torch.int32), real.sum(dim=1).to(torch.int32)


def _tier_operands(tier: Dict, vs, vd, ns_pad: int, nd_pad: int) -> Dict[str, torch.Tensor]:
    """The tier operand layout (module docstring): validity-masked like
    the contraction operands, so a pad pod matches no tier row.
    Egress subjects are src pods and peers dst pods; ingress the other
    way round."""
    out = {}
    for d, side in (("e", tier["egress"]), ("i", tier["ingress"])):
        rows, key, real = _walk(side["anp_key"], side["banp_key"])
        lp = _round_up(rows.numel(), PASS)
        rows = _pad(rows, 0, lp)
        pos = (torch.arange(lp, device=rows.device) < key.numel())[:, None]
        subj, peer = side["subj"][rows] & pos, side["peerq"][rows] & pos[:, :, None]
        if d == "e":
            src = pack_bool_words_torch(subj & vs).T  # [Lp / 32, Ns] -> [Ns, Lp / 32]
            dst = (peer & vd[:, :, None]).permute(2, 0, 1)  # [Q, Lp, Nd]
        else:
            src = pack_bool_words_torch(peer & vs[:, :, None]).permute(2, 1, 0)  # [Q, Ns, Lp / 32]
            dst = subj & vd  # [Lp, Nd]
        out["rows_" + d] = _pad(src, src.dim() - 2, ns_pad)
        # [..., Lp, nb, 4, 4] -> [..., nb, Lp, 4, 4]: a block's positions contiguous
        out["frag_" + d] = _fragments(dst, nd_pad).transpose(-4, -3).contiguous()
        out["key_" + d] = torch.nn.functional.pad(key, [0, lp - key.numel()], value=TIER_KEY_NONE)
        out["real_" + d] = real
    return out


def check_tile_counts(n_dst: int) -> None:
    """Raise, as _packed_operands would at the default tiles, when the
    partials over an n_dst-pod dst axis cannot stay within int32: a check
    on the shape alone, before anything is allocated."""
    _check_int32_partials(PACKED_BS, _round_up(n_dst, PACKED_BD))


def _packed_operands(
    tmatch_e_pk, has_e, tallow_e_pk, tmatch_i_pk, has_i, tallow_i_pk,
    valid_src, valid_dst, tier, w_dst, bs, bd,
) -> Dict[str, Optional[torch.Tensor]]:
    """The kernel operand layout (module docstring), padded: src axis to
    a multiple of `bs`, dst axis to a multiple of `bd`, word axes to a
    multiple of STEP_WORDS."""
    we, ns = tmatch_e_pk.shape
    wi, nd = tmatch_i_pk.shape
    ns_pad = _round_up(ns, bs)
    nd_pad = _round_up(nd, bd)
    de = _round_up(we, STEP_WORDS)
    di = _round_up(wi, STEP_WORDS)
    _check_int32_partials(bs, nd_pad)
    zero = torch.zeros((), dtype=torch.int32, device=tmatch_e_pk.device)
    vs = valid_src[None, :]
    vd = valid_dst[None, :]
    tm_e = torch.where(vs, tmatch_e_pk, zero)  # [We, Ns]
    tm_i = torch.where(vd, tmatch_i_pk, zero)  # [Wi, Nd]
    tl_e = torch.where(vd[:, :, None], tallow_e_pk, zero)  # [We, Nd, Q]
    tl_i = torch.where(vs[:, :, None], tallow_i_pk, zero)  # [Wi, Ns, Q]
    f_s = _pad(has_e.to(torch.int32) + 2 * valid_src.to(torch.int32), 0, ns_pad)
    w = None
    if w_dst is not None:
        w = torch.zeros((nd_pad,), dtype=torch.float32, device=f_s.device)
        w[: w_dst.shape[0]] = w_dst.to(torch.float32)
    t = None if tier is None else _tier_operands(tier, vs, vd, ns_pad, nd_pad)
    return {
        "a_e": _pad(_pad(tm_e.T, 1, de), 0, ns_pad),
        "b_e": _pad(_pad(tl_e.permute(2, 1, 0), 2, de), 1, nd_pad),
        "b_i": _pad(_pad(tl_i.permute(2, 1, 0), 2, di), 1, ns_pad),
        "a_i": _pad(_pad(tm_i.T, 1, di), 0, nd_pad),
        "f_s": f_s,
        "f_d_frag": _fragments(torch.stack([valid_dst, has_i]), nd_pad),
        "w": w,
        "tier": t,
    }


def _resolve(tmatch_e_pk, tmatch_i_pk, n_pods, valid_src, valid_dst, bs, bd):
    ns = tmatch_e_pk.shape[1]
    nd = tmatch_i_pk.shape[1]
    dev = tmatch_e_pk.device
    if valid_src is None:
        valid_src = torch.arange(ns, device=dev) < (ns if n_pods is None else int(n_pods))
    if valid_dst is None:
        valid_dst = torch.arange(nd, device=dev) < (nd if n_pods is None else int(n_pods))
    return (
        valid_src,
        valid_dst,
        PACKED_BS if bs is None else int(bs),
        PACKED_BD if bd is None else int(bd),
    )


def _live_rows(keys: torch.Tensor):
    """The tier rows whose anp or banp key is real: a row with both keys
    TIER_KEY_NONE (a pad) cannot move a min, so the plain version skips
    it."""
    return ((keys < TIER_KEY_NONE).any(dim=0)).nonzero().flatten().tolist()


def _min_keys(match_word, keys: torch.Tensor, live, shape, device):
    """(anp_min, banp_min) [shape] int32 over the live rows g whose bit is
    set in match_word(g // 32), the [shape] int32 word of subject AND
    peer bits."""
    none = torch.tensor(TIER_KEY_NONE, dtype=torch.int32, device=device)
    amin = torch.full(shape, TIER_KEY_NONE, dtype=torch.int32, device=device)
    bmin = amin.clone()
    words = {}
    for g in live:
        wd, bit = divmod(g, 32)
        if wd not in words:
            words[wd] = match_word(wd)
        hit = ((words[wd] >> bit) & 1) != 0
        amin = torch.minimum(amin, torch.where(hit, keys[0, g], none))
        bmin = torch.minimum(bmin, torch.where(hit, keys[1, g], none))
    return amin, bmin


def _position_keys(key: torch.Tensor, real: torch.Tensor) -> torch.Tensor:
    """[2, Lp] int32: per walk position its anp key (ANP positions) and
    its banp key (BANP positions), TIER_KEY_NONE elsewhere."""
    n_anp, n_real = int(real[0]), int(real.sum())
    i = torch.arange(key.shape[0], device=key.device)
    none = torch.full_like(key, TIER_KEY_NONE)
    return torch.stack([torch.where(i < n_anp, key, none),
                        torch.where((i >= n_anp) & (i < n_real), key, none)])


def _counts_plain(ops: Dict, bs: int) -> torch.Tensor:
    a_e, b_e, b_i, a_i, w = ops["a_e"], ops["b_e"], ops["b_i"], ops["a_i"], ops["w"]
    t = ops["tier"]
    q, nd_pad, de = b_e.shape
    ns_pad = a_e.shape[0]
    di = a_i.shape[1]
    valid_d, has_d = _unfragments(ops["f_d_frag"], nd_pad)
    if t is not None:
        # per direction: the position keys and the dst side as position
        # words [.., Lp / 32, Nd'] (egress peers per q, ingress subjects)
        keys_e = _position_keys(t["key_e"], t["real_e"])
        keys_i = _position_keys(t["key_i"], t["real_i"])
        live_e, live_i = _live_rows(keys_e), _live_rows(keys_i)
        dst_e = pack_bool_words_torch(_unfragments(t["frag_e"].transpose(1, 2), nd_pad), dim=1)
        dst_i = pack_bool_words_torch(_unfragments(t["frag_i"].transpose(0, 1), nd_pad))
    weighted = w is not None
    if weighted:
        out = torch.zeros((q, ns_pad, 3), dtype=torch.float32, device=a_e.device)
    else:
        out = torch.zeros((q, ns_pad // bs, 3), dtype=torch.int32, device=a_e.device)
    for qi in range(q):
        for i in range(ns_pad // bs):
            rows = slice(i * bs, (i + 1) * bs)
            acc_e = torch.zeros((bs, nd_pad), dtype=torch.int32, device=a_e.device)
            acc_i = torch.zeros_like(acc_e)
            for k in range(de):
                acc_e |= a_e[rows, k, None] & b_e[qi, :, k][None, :]
            for k in range(di):
                acc_i |= b_i[qi, rows, k, None] & a_i[:, k][None, :]
            flags_s = ops["f_s"][rows]
            has_s = (flags_s & 1) != 0
            egress = (~has_s)[:, None] | (acc_e != 0)
            ingress = (~has_d)[None, :] | (acc_i != 0)
            if t is not None:
                shape, dev = acc_e.shape, a_e.device
                anp, banp = _min_keys(
                    lambda k: t["rows_e"][rows, k, None] & dst_e[qi, k][None, :],
                    keys_e, live_e, shape, dev,
                )
                egress = resolve_tier_lattice(egress, has_s[:, None], anp, banp)
                anp, banp = _min_keys(
                    lambda k: t["rows_i"][qi, rows, k, None] & dst_i[k][None, :],
                    keys_i, live_i, shape, dev,
                )
                ingress = resolve_tier_lattice(ingress, has_d[None, :], anp, banp)
            combined = egress & ingress
            if weighted:
                for j, v in enumerate((ingress, egress, combined)):
                    out[qi, rows, j] = (v.to(torch.float32) * w[None, :]).sum(dim=1)
            else:
                mask = ((flags_s & 2) != 0)[:, None] & valid_d[None, :]
                for j, v in enumerate((ingress, egress, combined)):
                    out[qi, i, j] = (v & mask).sum(dtype=torch.int32)
    return out


def verdict_counts_packed_plain(
    tmatch_e_pk: torch.Tensor,  # [We, Ns] int32 — packed egress tmatch
    has_e: torch.Tensor,  # [Ns] bool
    tallow_e_pk: torch.Tensor,  # [We, Nd, Q] int32 — packed egress tallow
    tmatch_i_pk: torch.Tensor,  # [Wi, Nd] int32
    has_i: torch.Tensor,  # [Nd] bool
    tallow_i_pk: torch.Tensor,  # [Wi, Ns, Q] int32
    n_pods: Optional[int] = None,
    valid_src: Optional[torch.Tensor] = None,
    valid_dst: Optional[torch.Tensor] = None,
    tier: Optional[Dict] = None,
    w_dst: Optional[torch.Tensor] = None,
    bs: Optional[int] = None,
    bd: Optional[int] = None,
) -> torch.Tensor:
    """The plain PyTorch version of the packed counts kernel, on whatever
    device its inputs lie: a loop over port cases and src tiles of `bs`
    rows, with the word-axis AND/OR broadcast over each tile and, tiered,
    a loop over the live tier rows.  Returns the kernel's exact output
    (module docstring)."""
    ops = packed_operands(
        tmatch_e_pk, has_e, tallow_e_pk, tmatch_i_pk, has_i, tallow_i_pk,
        n_pods, valid_src, valid_dst, tier, w_dst, bs, bd,
    )
    return counts_from_packed_ops(ops, plain=True)


_lib = None


def _library():
    global _lib
    if _lib is None:
        from .build import load

        lib = load("packed_counts")
        lib.cyclonus_packed_counts.argtypes = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 9 + [
            ctypes.c_void_p
        ]
        lib.cyclonus_packed_counts.restype = ctypes.c_int
        lib.cyclonus_packed_kernel_attrs.argtypes = [ctypes.c_int] + [
            ctypes.POINTER(ctypes.c_int)
        ] * 4
        lib.cyclonus_packed_kernel_attrs.restype = ctypes.c_int
        lib.cyclonus_cuda_error_string.argtypes = [ctypes.c_int]
        lib.cyclonus_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def kernel_attrs() -> Dict[str, Dict]:
    """Per kernel instance (LAUNCHES keys): the instance, registers per
    thread, static and dynamic shared memory and local (spill) bytes per
    thread, as the loaded library reports them."""
    lib = _library()
    out = {}
    for which, name in enumerate(INSTANCES):
        vals = [ctypes.c_int() for _ in range(4)]
        err = lib.cyclonus_packed_kernel_attrs(which, *[ctypes.byref(v) for v in vals])
        if err != 0:
            msg = lib.cyclonus_cuda_error_string(err).decode()
            raise RuntimeError(f"{name} attributes failed: {msg} ({err})")
        regs, smem, dyn, local = (v.value for v in vals)
        out[name] = {"instance": INSTANCES[name], "regs": regs, "smem_static": smem,
                     "smem_dynamic": dyn, "local_bytes": local}
    return out


def _check(name: str, a, dev, shape, dtype=torch.int32) -> None:
    if (a.device != dev or a.dtype != dtype or not a.is_contiguous()
            or tuple(a.shape) != tuple(shape)):
        raise ValueError(f"{name}: want a contiguous {dtype} {tuple(shape)} tensor on {dev}")


def _counts_cuda(ops: Dict, bs: int) -> torch.Tensor:
    a_e, b_e, b_i, a_i, w = ops["a_e"], ops["b_e"], ops["b_i"], ops["a_i"], ops["w"]
    dev = a_e.device
    q, nd_pad, de = b_e.shape
    ns_pad = a_e.shape[0]
    di = a_i.shape[1]
    nb = -(-nd_pad // FRAG_COLS)
    want = {
        "a_e": (ns_pad, de), "b_e": (q, nd_pad, de), "b_i": (q, ns_pad, di),
        "a_i": (nd_pad, di), "f_s": (ns_pad,), "f_d_frag": (2, nb, 4, 4),
    }
    for name, shape in want.items():
        _check(name, ops[name], dev, shape)
    if de % STEP_WORDS or di % STEP_WORDS:
        raise ValueError(
            f"word axes must be padded to a multiple of {STEP_WORDS} (De={de}, Di={di})"
        )
    if bs % CUDA_SRC_TILE or ns_pad % bs or nd_pad % CUDA_DST_TILE:
        raise ValueError(
            f"the CUDA kernel needs bs % {CUDA_SRC_TILE} == 0 and a dst axis "
            f"padded to a multiple of {CUDA_DST_TILE} (bs={bs}, Nd'={nd_pad})"
        )
    weighted = w is not None
    if weighted:
        _check("w", w, dev, (nd_pad,), torch.float32)
        out = torch.zeros((q, ns_pad, 3), dtype=torch.float32, device=dev)
    else:
        out = torch.zeros((q, ns_pad // bs, 3), dtype=torch.int32, device=dev)
    t = ops["tier"]
    tier_ptrs = [None] * 8
    lpe = lpi = 0
    if t is not None:
        lpe, lpi = t["key_e"].shape[0], t["key_i"].shape[0]
        tier_want = {
            "rows_e": (ns_pad, lpe // 32), "rows_i": (q, ns_pad, lpi // 32),
            "frag_e": (q, nb, lpe, 4, 4), "frag_i": (nb, lpi, 4, 4),
            "key_e": (lpe,), "key_i": (lpi,), "real_e": (2,), "real_i": (2,),
        }
        for name, shape in tier_want.items():
            _check(f"tier {name}", t[name], dev, shape)
        if lpe % PASS or lpi % PASS:
            raise ValueError(f"tier walks must be padded to a multiple of {PASS} positions")
        tier_ptrs = [t[name].data_ptr() for name in tier_want]
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.cyclonus_packed_counts(
            a_e.data_ptr(), b_e.data_ptr(), b_i.data_ptr(), a_i.data_ptr(),
            ops["f_s"].data_ptr(), ops["f_d_frag"].data_ptr(),
            w.data_ptr() if weighted else None, out.data_ptr(), *tier_ptrs,
            q, ns_pad, nd_pad, de, di, lpe, lpi, bs, int(weighted),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        msg = lib.cyclonus_cuda_error_string(err).decode()
        raise RuntimeError(f"packed counts kernel launch failed: {msg} ({err})")
    name = "packed_rowsums" if weighted else "packed_counts"
    LAUNCHES[name if t is None else name + "_tiered"] += 1
    return out


def verdict_counts_packed(
    tmatch_e_pk: torch.Tensor,  # [We, Ns] int32 — packed egress tmatch
    has_e: torch.Tensor,  # [Ns] bool
    tallow_e_pk: torch.Tensor,  # [We, Nd, Q] int32 — packed egress tallow
    tmatch_i_pk: torch.Tensor,  # [Wi, Nd] int32
    has_i: torch.Tensor,  # [Nd] bool
    tallow_i_pk: torch.Tensor,  # [Wi, Ns, Q] int32
    n_pods: Optional[int] = None,
    valid_src: Optional[torch.Tensor] = None,
    valid_dst: Optional[torch.Tensor] = None,
    tier: Optional[Dict] = None,
    w_dst: Optional[torch.Tensor] = None,
    bs: Optional[int] = None,
    bd: Optional[int] = None,
) -> torch.Tensor:
    """The packed verdict kernel over pre-packed operands.

    Returns [Q, n_src_tiles, 3] int32 partial counts, or — with `w_dst`
    (the class-size weights of the class-compressed route) — [Q, Ns', 3]
    f32 dst-weighted row sums.  `tier` ({direction: {subj, peerq,
    anp_key, banp_key}}, tiled.packed_tier) adds the precedence-tier
    lattice to both directions' verdicts; it takes any number of tier
    rows.  Rectangular: per-side validity masks (default: the first
    n_pods rows of each side).  CPU tensors take the plain version; CUDA
    tensors launch the kernel, or raise."""
    return counts_from_packed_ops(packed_operands(
        tmatch_e_pk, has_e, tallow_e_pk, tmatch_i_pk, has_i, tallow_i_pk,
        n_pods, valid_src, valid_dst, tier, w_dst, bs, bd,
    ))


def packed_operands(
    tmatch_e_pk, has_e, tallow_e_pk, tmatch_i_pk, has_i, tallow_i_pk,
    n_pods=None, valid_src=None, valid_dst=None, tier=None, w_dst=None, bs=None, bd=None,
) -> Dict:
    """Everything one launch of the kernel reads: the operand layout of
    the module docstring (verdict_counts_packed's arguments, resolved
    alike) and the src tile height under "bs".  The engine pins this dict
    to repeat a counts call without its precompute."""
    valid_src, valid_dst, bs, bd = _resolve(
        tmatch_e_pk, tmatch_i_pk, n_pods, valid_src, valid_dst, bs, bd
    )
    ops = _packed_operands(
        tmatch_e_pk, has_e, tallow_e_pk, tmatch_i_pk, has_i, tallow_i_pk,
        valid_src, valid_dst, tier, w_dst, bs, bd,
    )
    ops["bs"] = bs
    return ops


def counts_from_packed_ops(ops: Dict, plain: bool = False) -> torch.Tensor:
    """The kernel's output (verdict_counts_packed) from packed_operands: a
    CPU tensor (or plain=True) takes the plain version, a CUDA tensor
    launches the kernel, or raises."""
    kind = ops["a_e"].device.type
    if plain:
        return _counts_plain(ops, ops["bs"])
    t = ops["tier"]
    build.note_trace(
        "counts_packed" + ("_tiered" if t is not None else "")
        + ("_weighted" if ops["w"] is not None else ""),
        kind,
        tuple(tuple(ops[k].shape) for k in ("a_e", "b_e", "b_i", "a_i"))
        + ((tuple(t["key_e"].shape), tuple(t["key_i"].shape)) if t is not None else ()),
    )
    if kind == "cpu":
        return _counts_plain(ops, ops["bs"])
    if kind == "cuda":
        return _counts_cuda(ops, ops["bs"])
    raise ValueError(f"no packed counts kernel for device {ops['a_e'].device}")


def sum_partials(partials, q: int, n_pods: int) -> Dict[str, int]:
    """Host-side int64 reduction of [Q, n_tiles, 3] partials into the
    counts dict — the one place that knows the lane order (ingress,
    egress, combined)."""
    if isinstance(partials, torch.Tensor):
        partials = partials.cpu().numpy()
    c = np.asarray(partials, dtype=np.int64).sum(axis=(0, 1))
    return {
        "ingress": int(c[0]),
        "egress": int(c[1]),
        "combined": int(c[2]),
        "cells": q * n_pods * n_pods,
    }
