"""Full-grid counts for grids too large to materialise (the reference's
engine/tiled.py, cut to what the port's routes run): the per-direction
precompute (both packings, with the precedence-tier arrays), the fused
class-compressed counts route, the tile loop, the block stream
(iter_grid_blocks) and the point verdicts of (src, dst) pairs
(evaluate_pairs_kernel), which the verdict service's queries run on.

The precompute resolves every pod against every target once per
direction.  The verdict contraction over the target axis and the count
epilogue then run in a counts kernel (packed_kernel.py, dense_kernel.py),
which never materialises an N x N verdict block, or in the tile loop: a
Python loop over `block`-row source tiles that materialises one
[block, N, Q] verdict block at a time in plain PyTorch
(_tile_verdicts_split).  The tile loop is the reference's XLA route
(backend "xla"), and it is where tiered counts go under the dense dtype
plan (CYCLONUS_PACK=0), which has no tiered kernel.
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np
import torch

from .. import carry
from . import host
from .encoding import TIER_KEY_NONE
from .kernel import (
    _bool_matmul,
    apply_host_ip,
    direction_precompute,
    m_tp_onehot,
    pack_bool_words_torch,
    packed_any,
    port_spec_allows,
    resolve_tier_lattice,
    selector_match,
    selector_tables,
    tier_direction_arrays,
    tier_first_match_keys,
    tier_keys,
    tier_scope_match,
)
from .packed_kernel import verdict_counts_packed


def _precompute(tensors: Dict, pack: bool = False) -> Dict[str, Dict[str, torch.Tensor]]:
    """Per-direction, port-resolved precompute shared by every tile:

      tallow_bf [T, N, Q] bf16 — target t allows traffic with pod n on the
                                 PEER side for port case q (m_tp @ peer_allow)
      tmatch    [T, N] bool    — target t applies to pod n (target side)
      has_target[N] bool

    With pack=True the target-axis operands ship 32-per-word instead:
    tallow_pk [W, N, Q] int32 and tmatch_pk [W, N] int32 replace
    tallow_bf (W = encoding.packed_words(T)).  A tiered tensor dict adds
    `tier` (kernel.tier_direction_arrays: subj [G, N], peerq [G, N, Q],
    anp_key / banp_key [G]) to each direction."""
    selpod, selns = selector_tables(tensors)
    out = {}
    q = tensors["q_port"].shape[0]
    for direction in ("ingress", "egress"):
        enc = tensors[direction]
        pre = direction_precompute(
            enc,
            selpod,
            selns,
            tensors["pod_ns_id"],
            tensors["pod_ip"],
            tensors["pod_ip_valid"],
        )
        peer_match = apply_host_ip(enc, pre["peer_match"])
        pport = port_spec_allows(
            enc["port_spec"],
            tensors["q_port"],
            tensors["q_name"],
            tensors["q_proto"],
        )
        n_p, n = peer_match.shape
        peer_allow = (
            peer_match[:, :, None] & pport[:, None, :]
        ).reshape(n_p, n * q)  # shape: (P, NQ)
        tallow = _bool_matmul(m_tp_onehot(enc), peer_allow)  # [T, N*Q] bool
        t = tallow.shape[0]
        out[direction] = {
            "tmatch": pre["tmatch"],
            "has_target": pre["has_target"],
        }
        if pack:
            out[direction]["tallow_pk"] = pack_bool_words_torch(
                tallow.reshape(t, n, q)
            )  # shape: (W, N, Q) int32
            out[direction]["tmatch_pk"] = pack_bool_words_torch(
                pre["tmatch"]
            )  # shape: (W, N) int32
        else:
            out[direction]["tallow_bf"] = tallow.to(torch.bfloat16).reshape(t, n, q)
        if "tiers" in tensors:
            out[direction]["tier"] = tier_direction_arrays(
                tensors["tiers"][direction],
                selpod,
                selns,
                tensors["pod_ns_id"],
                tensors["q_port"],
                tensors["q_name"],
                tensors["q_proto"],
            )
    return out


def packed_tier(pre: Dict):
    """The `tier` argument of the packed counts kernel from a precompute:
    {direction: {subj, peerq, anp_key, banp_key}}, or None untiered."""
    if "tier" not in pre["egress"]:
        return None
    return {d: pre[d]["tier"] for d in ("ingress", "egress")}


def class_rowsums_plan(
    tensors: Dict, n_classes: int, class_size: np.ndarray, block: int = 1024
) -> Tuple[np.ndarray, int, int]:
    """(w, block, n_tiles) for the class row sums over `tensors` whose pod
    axis is the (bucketing-padded) class axis: w [Cb] float32 holds the
    class sizes, zero on pad classes; block and n_tiles size the tile
    loop.  Bucketed axes are powers of two or multiples of 1024, so
    min(block, 1024, Cb) divides Cb; the fallback to the whole axis covers
    hand-built tensor dicts."""
    cb = int(tensors["pod_ns_id"].shape[0])
    block = max(1, min(block, 1024, cb))
    if cb % block:
        block = cb
    w = np.zeros((cb,), dtype=np.float32)
    w[:n_classes] = np.asarray(class_size, dtype=np.float32)
    return w, block, cb // block


def class_counts_finish(
    rowsums: np.ndarray,
    class_size: np.ndarray,
    n_classes: int,
    q: int,
    n_pods: int,
) -> Dict[str, int]:
    """Exact int64 host finish of the device row sums: the src-side
    class weighting.  Row-sum entries are integers <= N held exactly in
    f32 (N < 2^24 gated by the caller); the products reach ~N^2 and live
    in int64 only."""
    rs = np.rint(np.asarray(rowsums)[:n_classes]).astype(np.int64)  # [C, Q, 3]
    w = np.asarray(class_size, dtype=np.int64)
    totals = (w[:, None, None] * rs).sum(axis=(0, 1))  # [3]
    return {
        "ingress": int(totals[0]),
        "egress": int(totals[1]),
        "combined": int(totals[2]),
        "cells": q * n_pods * n_pods,
    }


def class_rowsums(tensors: Dict, w: torch.Tensor) -> torch.Tensor:
    """[Cb, Q, 3] f32 dst-weighted verdict row sums over the class grid:
    packed precompute + the packed counts kernel's weighted epilogue
    (tiered when the tensors carry tiers)."""
    pre = _precompute(tensors, True)
    cb = int(tensors["pod_ns_id"].shape[0])
    rs = verdict_counts_packed(
        pre["egress"]["tmatch_pk"],
        pre["egress"]["has_target"],
        pre["egress"]["tallow_pk"],
        pre["ingress"]["tmatch_pk"],
        pre["ingress"]["has_target"],
        pre["ingress"]["tallow_pk"],
        n_pods=cb,  # every class row is live; pad weights are zero
        tier=packed_tier(pre),
        w_dst=w,
    )  # [Q, Cb', 3] f32
    return torch.movedim(rs[:, :cb, :], 0, 1)


def evaluate_grid_counts_classes(
    tensors: Dict,
    n_classes: int,
    class_size: np.ndarray,
    n_pods: int,
    block: int = 1024,
    *,
    pack: bool,
    kernel: str,
) -> Dict[str, int]:
    """Allow counts over the FULL N x N x Q grid, evaluated on the
    compressed C x C class grid and weighted back exactly.

    kernel="pallas" runs the packed counts kernel's weighted epilogue
    (K2, tiered K3); kernel="xla" the tile loop (_class_rowsums_kernel)
    over the `pack` precompute.  Identical row sums either way."""
    if kernel not in ("pallas", "xla"):
        raise ValueError(f"unknown class counts kernel {kernel!r} (want 'pallas' or 'xla')")
    w, block, n_tiles = class_rowsums_plan(tensors, n_classes, class_size, block)
    w_dev = torch.from_numpy(w).to(tensors["pod_ns_id"].device)
    if kernel == "pallas":
        rs = class_rowsums(tensors, w_dev)
    else:
        rs = _class_rowsums_kernel(tensors, w_dev, block, n_tiles, pack)
    return class_counts_finish(
        rs.cpu().numpy(), class_size, n_classes, int(tensors["q_port"].shape[0]), n_pods
    )


# --- the tile loop ---------------------------------------------------------


def _split_pre(pre: Dict) -> Tuple[Dict, Dict]:
    """Split the per-direction precompute into the SRC-side view (the
    tile's source rows: egress target side + ingress peer side) and the
    DST-side view (egress peer side + ingress target side).  With the
    packed precompute the same keys carry the int32 words and
    _tile_verdicts_split contracts them with packed_any.  Tier arrays
    split the same way: subjects on the direction's target side, peerq on
    its peer side; the [G] key vectors stay in the src view."""
    if "tallow_pk" in pre["egress"]:
        src = {
            "tmatch_e": pre["egress"]["tmatch_pk"],
            "has_e": pre["egress"]["has_target"],
            "tallow_i": pre["ingress"]["tallow_pk"],
        }
        dst = {
            "tallow_e": pre["egress"]["tallow_pk"],
            "tmatch_i": pre["ingress"]["tmatch_pk"],
            "has_i": pre["ingress"]["has_target"],
        }
    else:
        src = {
            "tmatch_e": pre["egress"]["tmatch"],
            "has_e": pre["egress"]["has_target"],
            "tallow_i": pre["ingress"]["tallow_bf"],
        }
        dst = {
            "tallow_e": pre["egress"]["tallow_bf"],
            "tmatch_i": pre["ingress"]["tmatch"],
            "has_i": pre["ingress"]["has_target"],
        }
    if "tier" in pre["egress"]:
        te, ti = pre["egress"]["tier"], pre["ingress"]["tier"]
        src["tier_subj_e"] = te["subj"]
        src["tier_peerq_i"] = ti["peerq"]
        src["tier_keys_e"] = torch.stack([te["anp_key"], te["banp_key"]])
        src["tier_keys_i"] = torch.stack([ti["anp_key"], ti["banp_key"]])
        dst["tier_peerq_e"] = te["peerq"]
        dst["tier_subj_i"] = ti["subj"]
    return src, dst


def _tile_verdicts_split(
    src: Dict, dst: Dict, start: int, block: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Verdict blocks for source rows [start, start+block) of the src
    view against ALL dst-view pods: (ingress_rows, egress, combined),
    each [B, Nd, Q] bool; ingress_rows[b, d, q] is the ingress verdict for
    dst d <- src start+b.  The contraction follows the view's
    representation: int32 views are packed words (packed_any), bool/bf16
    views go through _bool_matmul; both are exact on 0/1 values."""
    t_e, nd, q = dst["tallow_e"].shape
    t_i = dst["tmatch_i"].shape[0]
    packed = src["tmatch_e"].dtype == torch.int32
    rows = slice(start, start + block)

    # egress: the source block is the TARGET side; peer side = dst pods
    tme = src["tmatch_e"][:, rows]
    hte = src["has_e"][rows]  # [B]
    if packed:
        any_e = packed_any(tme, dst["tallow_e"].reshape(t_e, nd * q))
    else:
        any_e = _bool_matmul(tme.T, dst["tallow_e"].reshape(t_e, nd * q))
    egress = (~hte[:, None, None]) | any_e.reshape(block, nd, q)  # [B, Nd, Q]

    # ingress: the source block is the PEER side; target side = dst pods
    tli = src["tallow_i"][:, rows, :]  # [T, B, Q]
    if packed:
        any_i = packed_any(dst["tmatch_i"], tli.reshape(t_i, block * q))
    else:
        any_i = _bool_matmul(dst["tmatch_i"].T, tli.reshape(t_i, block * q))
    ingress_t = (~dst["has_i"][:, None, None]) | any_i.reshape(nd, block, q)  # [Nd, B, Q]

    if "tier_subj_e" in src:
        # the precedence-tier lattice, per tile: egress subjects are the
        # source block, ingress subjects the dst view
        anp_e, banp_e = tier_first_match_keys(
            src["tier_subj_e"][:, rows], dst["tier_peerq_e"],
            src["tier_keys_e"][0], src["tier_keys_e"][1],
        )  # [B, Nd, Q]
        egress = resolve_tier_lattice(egress, hte[:, None, None], anp_e, banp_e)
        anp_i, banp_i = tier_first_match_keys(
            dst["tier_subj_i"], src["tier_peerq_i"][:, rows, :],
            src["tier_keys_i"][0], src["tier_keys_i"][1],
        )  # [Nd, B, Q]
        ingress_t = resolve_tier_lattice(
            ingress_t, dst["has_i"][:, None, None], anp_i, banp_i
        )

    ingress_rows = ingress_t.transpose(0, 1)  # [B, Nd, Q]
    return ingress_rows, egress, egress & ingress_rows


def _pad_pod_axis(tensors: Dict, n_pods: int, block: int) -> Tuple[Dict, int]:
    """Pad the (numpy) pod axis to a multiple of `block` with inert rows
    (host._pad_pod_arrays: they match no target and no peer); returns the
    tensors and the tile count of the final padded length."""
    tensors, padded = host._pad_pod_arrays(tensors, n_pods, block)
    return tensors, padded // block


def _tile_counts_split(
    src: Dict, dst: Dict, src_valid: torch.Tensor, dst_valid: torch.Tensor,
    start: int, block: int,
) -> torch.Tensor:
    """[3] int32 validity-masked allow counts (ingress, egress, combined)
    for src-view rows [start, start+block) against all dst-view pods."""
    ingress_rows, egress, combined = _tile_verdicts_split(src, dst, start, block)
    mask = src_valid[start : start + block, None, None] & dst_valid[None, :, None]
    return torch.stack(
        [(v & mask).sum(dtype=torch.int32) for v in (ingress_rows, egress, combined)]
    )


def _int32_safe_block(block: int, n_pods: int, q: int) -> int:
    """Halve the tile height until per-tile counts stay below 2^31."""
    while block > 1 and block * n_pods * q >= 2**31:
        block //= 2
    return block


def _counts_kernel(
    tensors: Dict, block: int, n_tiles: int, n_pods: int, pack: bool
) -> torch.Tensor:
    """[n_tiles, 3] int32 allow counts over the full grid: the precompute,
    then one tile body per `block` source rows."""
    pre = _precompute(tensors, pack)
    src, dst = _split_pre(pre)
    n_padded = tensors["pod_ns_id"].shape[0]
    valid = torch.arange(n_padded, device=tensors["pod_ns_id"].device) < n_pods
    return torch.stack(
        [_tile_counts_split(src, dst, valid, valid, i * block, block) for i in range(n_tiles)]
    )


def evaluate_grid_counts(
    tensors: Dict, n_pods: int, block: int = 1024, *, pack: bool, device=None
) -> Dict[str, int]:
    """Allow counts over the full N x N x Q grid with the tile loop.
    `tensors` is the engine's host (numpy) tensor dict with the port-case
    arrays; its pod axis is padded to a multiple of the tile height and
    moved to `device` (carry.resolve_device: None is the CUDA device, or
    raises).  `pack` routes the tile bodies through the packed operands."""
    device = carry.resolve_device(device)
    q = int(tensors["q_port"].shape[0])
    # per-tile counts are int32: keep block * N * Q below 2^31
    block = _int32_safe_block(min(block, max(n_pods, 1)), n_pods, q)
    tensors, n_tiles = _pad_pod_axis(tensors, n_pods, block)
    out = _counts_kernel(
        carry.tensors_from_reference(tensors, device), block, n_tiles, n_pods, pack
    )
    counts = out.cpu().numpy().astype(np.int64).sum(axis=0)
    return {
        "ingress": int(counts[0]),
        "egress": int(counts[1]),
        "combined": int(counts[2]),
        "cells": q * n_pods * n_pods,
    }


def _class_tile_rowsums(
    src: Dict, dst: Dict, w_dst: torch.Tensor, start: int, block: int
) -> torch.Tensor:
    """[block, Q, 3] float32 dst-weighted verdict row sums for src-view
    rows [start, start+block): rs[b, q, k] = sum_d grid_k[b, d, q] *
    w_dst[d].  The weights are class sizes (integers), summed in int64 and
    cast to float32 — exact below 2^24, whatever the matmul precision
    settings.  Pad classes carry weight 0 on the dst side and are dropped
    by the host weighting on the src side."""
    w = w_dst.to(torch.int64)[None, :, None]

    def rs(v: torch.Tensor) -> torch.Tensor:
        return torch.where(v, w, 0).sum(dim=1).to(torch.float32)  # [B, Q]

    return torch.stack([rs(v) for v in _tile_verdicts_split(src, dst, start, block)], dim=-1)


def _class_rowsums_kernel(
    tensors: Dict, w: torch.Tensor, block: int, n_tiles: int, pack: bool
) -> torch.Tensor:
    """[n_tiles * block, Q, 3] float32 weighted row sums over the class
    grid: the precompute, then one tile body per `block` class rows."""
    pre = _precompute(tensors, pack)
    src, dst = _split_pre(pre)
    return torch.cat(
        [_class_tile_rowsums(src, dst, w, i * block, block) for i in range(n_tiles)]
    )


# --- streamed blocks and point pairs ----------------------------------------


def iter_grid_blocks(
    tensors: Dict, n_pods: int, block: int = 1024, *, pack: bool, device=None
) -> Iterator[Tuple[int, np.ndarray, np.ndarray, np.ndarray]]:
    """Stream verdict blocks to the host: yields (start, ingress_rows,
    egress, combined) with arrays [b, N, Q] bool, pad rows and columns
    stripped.  ingress_rows[b, d, q] is the ingress verdict for dst d <-
    src (start+b), i.e. full-grid ingress[q, d, start+b].  `tensors` is
    the engine's host (numpy) tensor dict with the port-case arrays; its
    pod axis is padded to a multiple of `block` and moved to `device`
    (carry.resolve_device: None is the CUDA device, or raises)."""
    device = carry.resolve_device(device)
    block = min(block, max(n_pods, 1))
    tensors, n_tiles = _pad_pod_axis(tensors, n_pods, block)
    src, dst = _split_pre(_precompute(carry.tensors_from_reference(tensors, device), pack))
    # bucketing may have padded the pod axis past the last real tile:
    # walk only the tiles with real rows
    n_tiles = min(n_tiles, -(-n_pods // block))
    for i in range(n_tiles):
        start = i * block
        ingress_rows, egress, combined = _tile_verdicts_split(src, dst, start, block)
        b = min(block, n_pods - start)
        yield (
            start,
            ingress_rows[:b, :n_pods].cpu().numpy(),
            egress[:b, :n_pods].cpu().numpy(),
            combined[:b, :n_pods].cpu().numpy(),
        )


def evaluate_pairs_kernel(
    tensors: Dict, s_idx: torch.Tensor, d_idx: torch.Tensor
) -> Dict[str, torch.Tensor]:
    """Point verdicts for K (src, dst) index pairs: {ingress, egress,
    combined}, each [K, Q] bool.  O((S + T + P) * K): no N x N grid
    anywhere.  Per direction the target-side pods are resolved against
    the targets and the peer-side pods against the peers; the peer ->
    target contraction is kernel._bool_matmul (bf16 on the card, float32
    on the CPU: 0/1 operands, exact either way) and the per-pair target
    contraction an AND-any over the target axis.  Host-evaluated ip-peer
    rows are indexed by the original pod row; with tier slabs the
    ANP -> NetworkPolicy -> BANP lattice runs per pair."""
    sel = (
        tensors["sel_req_kv"],
        tensors["sel_exp_op"],
        tensors["sel_exp_key"],
        tensors["sel_exp_vals"],
    )
    selns = selector_match(*sel, tensors["ns_kv"], tensors["ns_key"])
    q_args = (tensors["q_port"], tensors["q_name"], tensors["q_proto"])

    def sub(idx):
        rows = {k: tensors[k][idx] for k in host._POD_KEYS}
        rows["selpod"] = selector_match(*sel, rows["pod_kv"], rows["pod_key"])
        return rows

    def direction_pair(direction, t_idx, p_idx):
        """Verdict [K, Q] for target-side pods t_idx and peer-side pods
        p_idx in `direction`."""
        enc = tensors[direction]
        t_sub, p_sub = sub(t_idx), sub(p_idx)
        pre_t = direction_precompute(
            enc, t_sub["selpod"], selns, t_sub["pod_ns_id"], t_sub["pod_ip"],
            t_sub["pod_ip_valid"],
        )
        pre_p = direction_precompute(
            enc, p_sub["selpod"], selns, p_sub["pod_ns_id"], p_sub["pod_ip"],
            p_sub["pod_ip_valid"],
        )
        peer_match = pre_p["peer_match"]
        if "host_ip_match" in enc:
            peer_match = torch.where(
                enc["host_ip_mask"][:, None], enc["host_ip_match"][:, p_idx], peer_match
            )
        pport = port_spec_allows(enc["port_spec"], *q_args)  # [P, Q]
        n_p, k = peer_match.shape
        q = pport.shape[1]
        peer_allow = (peer_match[:, :, None] & pport[:, None, :]).reshape(n_p, k * q)
        # tallow[t, k, q]: some peer of target t allows peer-side pod k
        tallow = _bool_matmul(m_tp_onehot(enc), peer_allow).reshape(-1, k, q)
        any_allow = (pre_t["tmatch"][:, :, None] & tallow).any(dim=0)  # [K, Q]
        allowed = (~pre_t["has_target"][:, None]) | any_allow
        if "tiers" in tensors:
            tenc = tensors["tiers"][direction]
            subj = tier_scope_match(
                tenc["subj_ns_sel"], tenc["subj_pod_kind"], tenc["subj_pod_sel"],
                t_sub["selpod"], selns, t_sub["pod_ns_id"],
            )  # [G, K]
            peer = tier_scope_match(
                tenc["peer_ns_sel"], tenc["peer_pod_kind"], tenc["peer_pod_sel"],
                p_sub["selpod"], selns, p_sub["pod_ns_id"],
            )  # [G, K]
            pport_t = port_spec_allows(tenc["port_spec"], *q_args)  # [G, Q]
            match = (subj & peer)[:, :, None] & pport_t[:, None, :]  # [G, K, Q]
            anp_key, banp_key = tier_keys(tenc)
            none = torch.tensor(TIER_KEY_NONE, dtype=torch.int32, device=match.device)
            anp_min = torch.where(match, anp_key[:, None, None], none).amin(dim=0)
            banp_min = torch.where(match, banp_key[:, None, None], none).amin(dim=0)
            allowed = resolve_tier_lattice(
                allowed, pre_t["has_target"][:, None], anp_min, banp_min
            )
        return allowed

    egress = direction_pair("egress", s_idx, d_idx)  # src is the target side
    ingress = direction_pair("ingress", d_idx, s_idx)  # dst is the target side
    return {"ingress": ingress, "egress": egress, "combined": ingress & egress}
