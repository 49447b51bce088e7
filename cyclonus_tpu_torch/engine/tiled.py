"""Full-grid counts for grids too large to materialise (the reference's
engine/tiled.py, cut to the per-direction precompute and the fused
class-compressed counts route), with the precedence-tier precompute.

The precompute resolves every pod against every target once per
direction; the verdict contraction over the target axis and the count
epilogue then run in the packed counts kernel (packed_kernel.py), which
never materialises an N x N verdict block.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .kernel import (
    _bool_matmul,
    apply_host_ip,
    direction_precompute,
    m_tp_onehot,
    pack_bool_words_torch,
    port_spec_allows,
    selector_tables,
    tier_direction_arrays,
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


def class_rowsums_plan(tensors: Dict, n_classes: int, class_size: np.ndarray) -> np.ndarray:
    """The [Cb] float32 dst weights of the class row sums over `tensors`
    whose pod axis is the (bucketing-padded) class axis: the class sizes,
    zero on pad classes.  (The reference's plan also sizes the blocks of
    its XLA tile loop, which the port does not have.)"""
    w = np.zeros((int(tensors["pod_ns_id"].shape[0]),), dtype=np.float32)
    w[:n_classes] = np.asarray(class_size, dtype=np.float32)
    return w


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


def class_rowsums(tensors: Dict, w: torch.Tensor, counts_fn=verdict_counts_packed) -> torch.Tensor:
    """[Cb, Q, 3] f32 dst-weighted verdict row sums over the class grid:
    packed precompute + the packed counts kernel's weighted epilogue
    (tiered when the tensors carry tiers)."""
    pre = _precompute(tensors, True)
    cb = int(tensors["pod_ns_id"].shape[0])
    rs = counts_fn(
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
    counts_fn=verdict_counts_packed,
) -> Dict[str, int]:
    """Allow counts over the FULL N x N x Q grid, evaluated on the
    compressed C x C class grid and weighted back exactly."""
    w = class_rowsums_plan(tensors, n_classes, class_size)
    w_dev = torch.from_numpy(w).to(tensors["pod_ns_id"].device)
    rs = class_rowsums(tensors, w_dev, counts_fn).cpu().numpy()
    return class_counts_finish(
        rs, class_size, n_classes, int(tensors["q_port"].shape[0]), n_pods
    )
