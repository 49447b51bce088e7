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

verdict_counts_packed is the wrapper: a CPU tensor goes through the plain
PyTorch version (verdict_counts_packed_plain), a CUDA tensor through the
hand-written kernel in csrc/packed_counts.cu, and nothing else.  Both
share one operand layout (_packed_operands):

  a_e [Ns', We+1] int32  src rows: egress tmatch words, then the flags word
  b_e [Q, We, Nd'] int32 egress tallow words by dst column
  b_i [Q, Ns', Wi] int32 src rows: ingress tallow words
  a_i [Wi+1, Nd'] int32  ingress tmatch words by dst column, then flags
  w   [Nd'] float32      dst weights (weighted epilogue only)

and, tiered, the tier rows packed 32 per word the same way (Wg =
packed_words(G) per direction), each matrix laid out like the contraction
operand of the same side:

  subj_e  [Ns', Wge] int32     egress subjects by src row
  peerq_e [Q, Wge, Nd'] int32  egress peers by dst column
  subj_i  [Wgi, Nd'] int32     ingress subjects by dst column
  peerq_i [Q, Ns', Wgi] int32  ingress peers by src row
  keys_e / keys_i [2, 32 * Wg] int32  anp then banp keys, TIER_KEY_NONE
                                      past the real rows

Flags words: bit 0 = has_target, bit 1 = valid.  Invalid pod columns are
masked out of every packed operand, so a pad pod contributes nothing to
either contraction.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import numpy as np
import torch

from .encoding import TIER_KEY_NONE
from .kernel import pack_bool_words_torch, resolve_tier_lattice

#: default tile heights (src x dst) of the reference kernel; `bs` fixes
#: the partial-count granularity of the plain epilogue's output, `bd` the
#: dst-axis padding
PACKED_BS = 512
PACKED_BD = 512

#: the CUDA kernel's block tile (src rows x dst columns); bs and bd must
#: be multiples of these on the card
CUDA_SRC_TILE = 64
CUDA_DST_TILE = 128

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


def _tier_keys(t: Dict, words: int) -> torch.Tensor:
    """[2, 32 * words] int32: anp then banp keys, TIER_KEY_NONE past the
    real rows (so every bit of the packed rows has a key)."""
    keys = torch.stack([t["anp_key"], t["banp_key"]]).to(torch.int32)
    pad = 32 * words - keys.shape[1]
    return torch.nn.functional.pad(keys, [0, pad], value=TIER_KEY_NONE).contiguous()


def _tier_operands(tier: Dict, vs, vd, ns_pad: int, nd_pad: int) -> Dict[str, torch.Tensor]:
    """The tier operand layout (module docstring): validity-masked like
    the contraction operands, so a pad pod matches no tier row.
    Egress subjects are src pods and peers dst pods; ingress the other
    way round."""
    te, ti = tier["egress"], tier["ingress"]
    subj_e = pack_bool_words_torch(te["subj"] & vs)  # [Wge, Ns]
    peerq_e = pack_bool_words_torch(te["peerq"] & vd[:, :, None])  # [Wge, Nd, Q]
    subj_i = pack_bool_words_torch(ti["subj"] & vd)  # [Wgi, Nd]
    peerq_i = pack_bool_words_torch(ti["peerq"] & vs[:, :, None])  # [Wgi, Ns, Q]
    return {
        "subj_e": _pad(subj_e.T, 0, ns_pad),
        "peerq_e": _pad(peerq_e.permute(2, 0, 1), 2, nd_pad),
        "subj_i": _pad(subj_i, 1, nd_pad),
        "peerq_i": _pad(peerq_i.permute(2, 1, 0), 1, ns_pad),
        "keys_e": _tier_keys(te, subj_e.shape[0]),
        "keys_i": _tier_keys(ti, subj_i.shape[0]),
    }


def _packed_operands(
    tmatch_e_pk, has_e, tallow_e_pk, tmatch_i_pk, has_i, tallow_i_pk,
    valid_src, valid_dst, tier, w_dst, bs, bd,
) -> Dict[str, Optional[torch.Tensor]]:
    """The kernel operand layout (module docstring), padded: src axis to
    a multiple of `bs`, dst axis to a multiple of `bd`."""
    we, ns = tmatch_e_pk.shape
    wi, nd = tmatch_i_pk.shape
    ns_pad = _round_up(ns, bs)
    nd_pad = _round_up(nd, bd)
    if bs * nd_pad >= 2**31:
        raise ValueError(
            f"dst axis {nd_pad} too large for int32 tile counts at bs={bs}"
        )
    zero = torch.zeros((), dtype=torch.int32, device=tmatch_e_pk.device)
    vs = valid_src[None, :]
    vd = valid_dst[None, :]
    tm_e = torch.where(vs, tmatch_e_pk, zero)  # [We, Ns]
    tm_i = torch.where(vd, tmatch_i_pk, zero)  # [Wi, Nd]
    tl_e = torch.where(vd[:, :, None], tallow_e_pk, zero)  # [We, Nd, Q]
    tl_i = torch.where(vs[:, :, None], tallow_i_pk, zero)  # [Wi, Ns, Q]
    flags_s = has_e.to(torch.int32) + 2 * valid_src.to(torch.int32)
    flags_d = has_i.to(torch.int32) + 2 * valid_dst.to(torch.int32)

    a_e = _pad(torch.cat([tm_e.T, flags_s[:, None]], dim=1), 0, ns_pad)
    b_e = _pad(tl_e.permute(2, 0, 1), 2, nd_pad)
    b_i = _pad(tl_i.permute(2, 1, 0), 1, ns_pad)
    a_i = _pad(torch.cat([tm_i, flags_d[None, :]], dim=0), 1, nd_pad)
    w = None
    if w_dst is not None:
        w = torch.zeros((nd_pad,), dtype=torch.float32, device=a_e.device)
        w[: w_dst.shape[0]] = w_dst.to(torch.float32)
    t = None if tier is None else _tier_operands(tier, vs, vd, ns_pad, nd_pad)
    return {"a_e": a_e, "b_e": b_e, "b_i": b_i, "a_i": a_i, "w": w, "tier": t}


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


def _counts_plain(ops: Dict, bs: int) -> torch.Tensor:
    a_e, b_e, b_i, a_i, w = ops["a_e"], ops["b_e"], ops["b_i"], ops["a_i"], ops["w"]
    t = ops["tier"]
    if t is not None:
        live_e = _live_rows(t["keys_e"])
        live_i = _live_rows(t["keys_i"])
    q, we, nd_pad = b_e.shape
    ns_pad = a_e.shape[0]
    wi = b_i.shape[2]
    flags_d = a_i[wi]
    has_d = (flags_d & 1) != 0
    valid_d = (flags_d & 2) != 0
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
            for k in range(we):
                acc_e |= a_e[rows, k, None] & b_e[qi, k][None, :]
            for k in range(wi):
                acc_i |= b_i[qi, rows, k, None] & a_i[k][None, :]
            flags_s = a_e[rows, we]
            has_s = (flags_s & 1) != 0
            egress = (~has_s)[:, None] | (acc_e != 0)
            ingress = (~has_d)[None, :] | (acc_i != 0)
            if t is not None:
                shape, dev = acc_e.shape, a_e.device
                anp, banp = _min_keys(
                    lambda k: t["subj_e"][rows, k, None] & t["peerq_e"][qi, k][None, :],
                    t["keys_e"], live_e, shape, dev,
                )
                egress = resolve_tier_lattice(egress, has_s[:, None], anp, banp)
                anp, banp = _min_keys(
                    lambda k: t["peerq_i"][qi, rows, k, None] & t["subj_i"][k][None, :],
                    t["keys_i"], live_i, shape, dev,
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
    valid_src, valid_dst, bs, bd = _resolve(
        tmatch_e_pk, tmatch_i_pk, n_pods, valid_src, valid_dst, bs, bd
    )
    ops = _packed_operands(
        tmatch_e_pk, has_e, tallow_e_pk, tmatch_i_pk, has_i, tallow_i_pk,
        valid_src, valid_dst, tier, w_dst, bs, bd,
    )
    return _counts_plain(ops, bs)


_lib = None


def _library():
    global _lib
    if _lib is None:
        from .build import load

        lib = load("packed_counts")
        lib.cyclonus_packed_counts.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 9 + [
            ctypes.c_void_p
        ]
        lib.cyclonus_packed_counts.restype = ctypes.c_int
        lib.cyclonus_cuda_error_string.argtypes = [ctypes.c_int]
        lib.cyclonus_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _counts_cuda(ops: Dict, bs: int) -> torch.Tensor:
    a_e, b_e, b_i, a_i, w = ops["a_e"], ops["b_e"], ops["b_i"], ops["a_i"], ops["w"]
    dev = a_e.device
    for name, t in (("a_e", a_e), ("b_e", b_e), ("b_i", b_i), ("a_i", a_i)):
        if t.device != dev or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"{name}: want a contiguous int32 tensor on {dev}")
    q, we, nd_pad = b_e.shape
    ns_pad = a_e.shape[0]
    wi = b_i.shape[2]
    if a_e.shape[1] != we + 1 or tuple(b_i.shape) != (q, ns_pad, wi) or tuple(
        a_i.shape
    ) != (wi + 1, nd_pad):
        raise ValueError("packed operands disagree in shape")
    if bs % CUDA_SRC_TILE or ns_pad % bs or nd_pad % CUDA_DST_TILE:
        raise ValueError(
            f"the CUDA kernel needs bs % {CUDA_SRC_TILE} == 0 and a dst axis "
            f"padded to a multiple of {CUDA_DST_TILE} (bs={bs}, Nd'={nd_pad})"
        )
    weighted = w is not None
    if weighted:
        if w.device != dev or w.dtype != torch.float32 or w.shape != (nd_pad,):
            raise ValueError(f"w: want a float32 [{nd_pad}] tensor on {dev}")
        out = torch.zeros((q, ns_pad, 3), dtype=torch.float32, device=dev)
    else:
        out = torch.zeros((q, ns_pad // bs, 3), dtype=torch.int32, device=dev)
    t = ops["tier"]
    tier_ptrs = [None] * 6
    wge = wgi = 0
    if t is not None:
        wge, wgi = t["subj_e"].shape[1], t["subj_i"].shape[0]
        want = {
            "subj_e": (ns_pad, wge), "peerq_e": (q, wge, nd_pad),
            "subj_i": (wgi, nd_pad), "peerq_i": (q, ns_pad, wgi),
            "keys_e": (2, 32 * wge), "keys_i": (2, 32 * wgi),
        }
        for name, shape in want.items():
            a = t[name]
            if (a.device != dev or a.dtype != torch.int32 or not a.is_contiguous()
                    or tuple(a.shape) != shape):
                raise ValueError(f"tier {name}: want a contiguous int32 {shape} tensor on {dev}")
        tier_ptrs = [t[name].data_ptr() for name in want]
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.cyclonus_packed_counts(
            a_e.data_ptr(), b_e.data_ptr(), b_i.data_ptr(), a_i.data_ptr(),
            w.data_ptr() if weighted else None, out.data_ptr(), *tier_ptrs,
            q, ns_pad, nd_pad, we, wi, wge, wgi, bs, int(weighted),
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
    valid_src, valid_dst, bs, bd = _resolve(
        tmatch_e_pk, tmatch_i_pk, n_pods, valid_src, valid_dst, bs, bd
    )
    ops = _packed_operands(
        tmatch_e_pk, has_e, tallow_e_pk, tmatch_i_pk, has_i, tallow_i_pk,
        valid_src, valid_dst, tier, w_dst, bs, bd,
    )
    kind = tmatch_e_pk.device.type
    if kind == "cpu":
        return _counts_plain(ops, bs)
    if kind == "cuda":
        return _counts_cuda(ops, bs)
    raise ValueError(f"no packed counts kernel for device {tmatch_e_pk.device}")


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
