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

The mesh family (engine/sharded.py's Mesh, one shard a loop step) splits
the pod axis over the shards: the sharded counts (each shard's source
rows against the whole target axis, through the counts kernels or the
tile loop), the class-axis split of the class route, and the ring counts
(both pod axes sharded, the dst-side bundle rotating one hop a step: the
sync ring, its pipelined twin and the 2-D ring).  Every shard's partial
counts are int32 (_int32_safe_block) and summed on the host in int64.

Each counts entry point records one telemetry flight, under the
reference's path names: counts.xla (the tile loop), counts.classes,
counts.classes.sharded, counts.sharded, counts.ring,
counts.ring.pipelined and counts.ring2d, with engine.dispatch /
engine.execute spans where the reference has them.  A flight's seconds
end at the path's own readback.
"""

from __future__ import annotations

import time
from typing import Dict, Iterator, List, Sequence, Tuple

import numpy as np
import torch

from .. import carry
from ..telemetry import instruments as ti
from ..utils.tracing import phase
from . import dense_kernel, host
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
) -> Tuple[Dict[str, int], float]:
    """Allow counts over the FULL N x N x Q grid, evaluated on the
    compressed C x C class grid and weighted back exactly.  Returns
    (counts, gather_s), gather_s the exact host weighting (the broadcast-
    back epilogue).

    kernel="pallas" runs the packed counts kernel's weighted epilogue
    (K2, tiered K3); kernel="xla" the tile loop (_class_rowsums_kernel)
    over the `pack` precompute.  Identical row sums either way."""
    if kernel not in ("pallas", "xla"):
        raise ValueError(f"unknown class counts kernel {kernel!r} (want 'pallas' or 'xla')")
    q = int(tensors["q_port"].shape[0])
    w, block, n_tiles = class_rowsums_plan(tensors, n_classes, class_size, block)
    with ti.eval_flight("counts.classes", n_pods, q, classes=n_classes, block=block) as fl:
        with phase("engine.dispatch"):
            w_dev = torch.from_numpy(w).to(tensors["pod_ns_id"].device)
            if kernel == "pallas":
                rs = class_rowsums(tensors, w_dev)
            else:
                rs = _class_rowsums_kernel(tensors, w_dev, block, n_tiles, pack)
        # the readback is the execution barrier
        with phase("engine.execute"):
            rs = rs.cpu().numpy()
        t0 = time.perf_counter()
        counts = class_counts_finish(rs, class_size, n_classes, q, n_pods)
        gather_s = time.perf_counter() - t0
        fl.set(cells=counts["cells"])
    return counts, gather_s


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


#: the dst-side bundle keys: the arrays the ring paths rotate.  Tier
#: arrays on the DST pod axis (egress peer side, ingress target side) ride
#: the bundle, or a rotated step would resolve tiers against the wrong
#: shard.
_DST_VIEW_KEYS = ("tallow_e", "tmatch_i", "has_i")
_DST_TIER_KEYS = ("tier_peerq_e", "tier_subj_i")


def _dst_bundle_keys(ring: Dict) -> Tuple[str, ...]:
    keys = _DST_VIEW_KEYS
    if "tier_peerq_e" in ring:
        keys = keys + _DST_TIER_KEYS
    return keys


def _permute(rings: List[Dict], devices: Sequence[torch.device], perm: Sequence[int]) -> List[Dict]:
    """One ppermute hop: shard d's bundle moves to shard perm[d], each
    leaf copied to that shard's device without a host sync (on the same
    device `.to` returns the tensor itself)."""
    out: List[Dict] = [{} for _ in rings]
    for d, ring in enumerate(rings):
        dev = devices[perm[d]]
        out[perm[d]] = {k: v.to(dev, non_blocking=True) for k, v in ring.items()}
    return out


def _ring_sweep(devices: Sequence[torch.device], rings: List[Dict], accs: List, body):
    """The ring loop every 1-D ring path shares (the sync ring counts, the
    pipelined twin and the sharded grid's ring) so the schedule cannot
    diverge between them.  One hop per step, issued before the step's
    compute: the copy and the compute both only read the current bundle.
    `body(step, d, ring, acc) -> acc` consumes the bundle shard d holds.
    All n hops run: the last returns every bundle to its origin, which
    the pipelined twin relies on.  Returns (accs, rings at origin)."""
    n = len(devices)
    perm = [(d + 1) % n for d in range(n)]
    for step in range(n):
        nxt = _permute(rings, devices, perm)
        accs = [body(step, d, rings[d], accs[d]) for d in range(n)]
        rings = nxt
    return accs, rings


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
    with ti.eval_flight("counts.xla", n_pods, q, block=block) as fl:
        tensors, n_tiles = _pad_pod_axis(tensors, n_pods, block)
        with phase("engine.dispatch"):
            out = _counts_kernel(
                carry.tensors_from_reference(tensors, device), block, n_tiles, n_pods, pack
            )
        # the readback is the execution barrier
        with phase("engine.execute"):
            counts = out.cpu().numpy().astype(np.int64).sum(axis=0)
        fl.set(cells=q * n_pods * n_pods)
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


# --- the pod-axis mesh ----------------------------------------------------


def _mesh_counts_setup(tensors: Dict, n_pods: int, block: int, mesh):
    """The setup every mesh counts path shares: resolve the mesh (None:
    sharded.default_mesh), bound the tile height for int32 partials, and
    pad the (numpy) pod axis so every shard gets a whole number of tiles."""
    from .sharded import default_mesh

    mesh = mesh or default_mesh()
    n_dev = mesh.size
    q = int(tensors["q_port"].shape[0])
    block = _int32_safe_block(min(block, max(n_pods // n_dev, 1)), n_pods, q)
    tensors, n_padded = host._pad_pod_arrays(tensors, n_pods, n_dev * block)
    return mesh, n_dev, q, block, tensors, n_padded


def _run_mesh_counts(parts: Sequence[torch.Tensor], q: int, n_pods: int, fl=None) -> Dict[str, int]:
    """The tail of every mesh counts path: the shards' [*, 3] int32
    partials summed on the host in int64 (the readback is the barrier),
    and the cells on the path's flight `fl` when one is given."""
    counts = np.zeros(3, dtype=np.int64)
    for p in parts:
        counts += p.cpu().numpy().astype(np.int64).reshape(-1, 3).sum(axis=0)
    if fl is not None:
        fl.set(cells=q * n_pods * n_pods)
    return {
        "ingress": int(counts[0]),
        "egress": int(counts[1]),
        "combined": int(counts[2]),
        "cells": q * n_pods * n_pods,
    }


def _shard_valid(d: int, shard: int, n_pods: int, device) -> torch.Tensor:
    """[shard] bool: the real pods among shard d's rows."""
    return (torch.arange(shard, device=device) + d * shard) < n_pods


def evaluate_grid_counts_sharded(
    tensors: Dict, n_pods: int, block: int = 1024, mesh=None, kernel: str = None, *, pack: bool
) -> Dict[str, int]:
    """Mesh-parallel counts: the SOURCE-ROW axis is split over the mesh;
    each shard evaluates its row shard against the full (replicated)
    precompute, and the shards' partials are summed on the host.

    kernel="pallas" runs the hand-written counts kernel once per shard on
    the rectangular pair (the shard's source rows against the whole
    target axis, with validity masks): the packed kernel (K1) under the
    packed plan, K4 (K5 when the operands span chunks) under pack=False;
    kernel="xla" runs the tile loop.  The default is "pallas" on a CUDA
    mesh and "xla" on a CPU mesh (where the kernels' plain versions run).
    `tensors` is the engine's host (numpy) tensor dict with the port-case
    arrays; tiered counts take kernel="xla" (the engine resolves it)."""
    mesh, n_dev, q, block, tensors, n_padded = _mesh_counts_setup(tensors, n_pods, block, mesh)
    if kernel is None:
        kernel = "pallas" if mesh.flat[0].type == "cuda" else "xla"
    if kernel not in ("pallas", "xla"):
        raise ValueError(f"unknown sharded counts kernel {kernel!r} (want 'pallas' or 'xla')")
    from . import planspec

    if kernel == "pallas":
        planspec.record("counts.sharded.pallas")
    else:
        planspec.record("counts.sharded.xla")
    shard = n_padded // n_dev
    devices = mesh.flat
    with ti.eval_flight("counts.sharded", n_pods, q, devices=n_dev) as fl:
        return _run_mesh_counts(
            _sharded_parts(tensors, devices, shard, n_padded, n_pods, block, kernel, pack),
            q, n_pods, fl,
        )


def _sharded_parts(tensors, devices, shard, n_padded, n_pods, block, kernel, pack):
    """Each shard's partials of evaluate_grid_counts_sharded."""
    from .sharded import replicate

    parts = []
    for d, t in enumerate(replicate(tensors, devices)):
        pre = _precompute(t, pack)
        row0 = d * shard
        valid = torch.arange(n_padded, device=devices[d]) < n_pods
        if kernel == "xla":
            src, dst = _split_pre(pre)
            parts.append(torch.stack([
                _tile_counts_split(src, dst, valid, valid, start, block)
                for start in range(row0, row0 + shard, block)
            ]))
            continue
        rows = slice(row0, row0 + shard)
        e, ig = pre["egress"], pre["ingress"]
        if pack:
            parts.append(verdict_counts_packed(
                e["tmatch_pk"][:, rows], e["has_target"][rows], e["tallow_pk"],
                ig["tmatch_pk"], ig["has_target"], ig["tallow_pk"][:, rows],
                valid_src=valid[rows], valid_dst=valid,
            ))
        else:
            parts.append(dense_kernel.verdict_counts_rect(
                e["tmatch"][:, rows], e["has_target"][rows], e["tallow_bf"],
                ig["tmatch"], ig["has_target"], ig["tallow_bf"][:, rows],
                valid_src=valid[rows], valid_dst=valid,
            ))
    return parts


def evaluate_grid_counts_classes_sharded(
    tensors: Dict,
    n_classes: int,
    class_size: np.ndarray,
    n_pods: int,
    block: int = 1024,
    mesh=None,
    *,
    pack: bool,
) -> Tuple[Dict[str, int], float]:
    """Mesh-parallel compressed counts: the CLASS axis splits over the
    mesh, each shard computes the f32 class-weighted row sums of its class
    shard against the replicated dst view (the tile loop's row sums), and
    the gathered [C, Q, 3] row sums go to the same exact host finish as
    the single-device route (class_counts_finish).  Returns (counts,
    gather_s) as evaluate_grid_counts_classes does."""
    from .sharded import replicate

    mesh, n_dev, q, block, tensors, n_padded = _mesh_counts_setup(
        tensors, n_classes, block, mesh
    )
    shard = n_padded // n_dev
    w = np.zeros((n_padded,), dtype=np.float32)
    w[:n_classes] = np.asarray(class_size, dtype=np.float32)
    rows = []
    with ti.eval_flight(
        "counts.classes.sharded", n_pods, q, classes=n_classes, devices=n_dev
    ) as fl:
        for d, t in enumerate(replicate(dict(tensors, class_w=w), mesh.flat)):
            src, dst = _split_pre(_precompute(t, pack))
            row0 = d * shard
            rows.append(torch.cat([
                _class_tile_rowsums(src, dst, t["class_w"], start, block)
                for start in range(row0, row0 + shard, block)
            ]))
        rs = np.concatenate([r.cpu().numpy() for r in rows])
        t0 = time.perf_counter()
        counts = class_counts_finish(rs, class_size, n_classes, q, n_pods)
        gather_s = time.perf_counter() - t0
        fl.set(cells=counts["cells"])
    return counts, gather_s


def ring_counts_pipeline(tensors: Dict, n_pods: int, block: int, devices, *, pack: bool):
    """(seed, step, meta) of the ring counts over `tensors` (already padded
    by _mesh_counts_setup) on the shards' `devices`, in shard order:

      seed(tensors) -> (srcs, rings)  each shard's tensors on its device
                                      and its precompute, split into the
                                      src view (local) and the dst bundle
                                      with its validity mask (the ring)
      step(srcs, rings) -> (partials, rings)  the full n-hop ring sweep;
                                      the last hop returns every bundle to
                                      its origin, so the returned rings
                                      feed the next step

    The sync ring runs one seed and one step; the pipelined twin one seed
    and steps back to back.  meta holds the shard height, the tiles per
    shard and count_bundle, the count body the 2-D ring shares."""
    from .sharded import shard_tensors

    devices = list(devices)
    n_dev = len(devices)
    shard = int(tensors["pod_ns_id"].shape[0]) // n_dev
    tiles_per_shard = shard // block

    def seed(tensors):
        srcs, rings = [], []
        for d, t in enumerate(shard_tensors(tensors, devices, shard)):
            src, dst0 = _split_pre(_precompute(t, pack))
            srcs.append(src)
            rings.append(dict(dst0, valid=_shard_valid(d, shard, n_pods, devices[d])))
        return srcs, rings

    def count_bundle(src, ring, valid_local, counts, slot):
        """Shard counts of src rows against the bundle `ring`, written at
        tile rows slot * tiles_per_shard onwards."""
        dst = {k: ring[k] for k in _dst_bundle_keys(ring)}
        for i in range(tiles_per_shard):
            counts[slot * tiles_per_shard + i] = _tile_counts_split(
                src, dst, valid_local, ring["valid"], i * block, block
            )
        return counts

    def step(srcs, rings):
        def body(st, d, ring, counts):
            return count_bundle(srcs[d], ring, _shard_valid(d, shard, n_pods, devices[d]), counts, st)

        init = [
            torch.zeros((n_dev * tiles_per_shard, 3), dtype=torch.int32, device=dev)
            for dev in devices
        ]
        return _ring_sweep(devices, rings, init, body)

    return seed, step, {"shard": shard, "tiles_per_shard": tiles_per_shard,
                        "count_bundle": count_bundle}


def evaluate_grid_counts_ring(
    tensors: Dict, n_pods: int, block: int = 1024, mesh=None, *, pack: bool
) -> Dict[str, int]:
    """Ring-rotation counts: BOTH pod axes stay sharded.  Each shard keeps
    only its own pod shard's precompute, and the dst-side bundle rotates
    one hop a step (_ring_sweep):

        for step in range(n_dev):
            counts += local src rows x current dst block
            dst block <- the previous shard's

    so a shard holds O(N / n_dev) of the precompute where the sharded
    counts replicate all of it.  With `pack` the bundle carries the packed
    words."""
    mesh, n_dev, q, block, tensors, n_padded = _mesh_counts_setup(tensors, n_pods, block, mesh)
    seed, step, _meta = ring_counts_pipeline(tensors, n_pods, block, mesh.flat, pack=pack)
    with ti.eval_flight("counts.ring", n_pods, q, devices=n_dev) as fl:
        parts, _rings = step(*seed(tensors))
        return _run_mesh_counts(parts, q, n_pods, fl)


def evaluate_grid_counts_ring_pipelined(
    tensors: Dict, n_pods: int, reps: int = 10, block: int = 1024, mesh=None, *, pack: bool
) -> Tuple[float, Dict[str, int]]:
    """Steady-state seconds per ring-counts evaluation: one seed (upload
    and precompute, pinned on the shards' devices), one warm step read
    back, then `reps` steps back to back, each fed the previous one's
    rings, and one readback at the end.  Returns (seconds per evaluation,
    counts)."""
    mesh, n_dev, q, block, tensors, n_padded = _mesh_counts_setup(tensors, n_pods, block, mesh)
    seed, step, _meta = ring_counts_pipeline(tensors, n_pods, block, mesh.flat, pack=pack)
    with ti.eval_flight("counts.ring.pipelined", n_pods, q, devices=n_dev, reps=reps) as fl:
        srcs, rings = seed(tensors)
        partials, rings = step(srcs, rings)
        _run_mesh_counts(partials, q, n_pods)  # warm; the readback is the barrier
        t0 = time.perf_counter()
        for _ in range(max(reps, 1)):
            partials, rings = step(srcs, rings)
        # the streams run in order: one barrier
        counts = _run_mesh_counts(partials, q, n_pods, fl)
        dt = (time.perf_counter() - t0) / max(reps, 1)
    if dt > 0:
        ti.MESH_RING_STEP_SECONDS.set(dt / max(n_dev, 1))
    return dt, counts


def evaluate_grid_counts_ring2d(
    tensors: Dict, n_pods: int, block: int = 1024, mesh=None, *, pack: bool
) -> Dict[str, int]:
    """Hierarchical ring counts over a 2-D ("dcn", "ici") mesh: the math of
    evaluate_grid_counts_ring with the rotation laid out for several
    hosts.  Each round makes n_ici - 1 hops on the "ici" axis, then one on
    "dcn", so shard (h, c) sees every shard once: at step j of round o it
    holds the bundle of (h - o, c + o - j mod n_ici).  Pod shards follow
    the flattened (dcn, ici) order.  mesh None: the default mesh factored
    by sharded.ring2d_mesh."""
    from .sharded import default_mesh, ring2d_mesh

    if mesh is None:
        mesh = ring2d_mesh(default_mesh())
    if set(mesh.axis_names) != {"dcn", "ici"}:
        raise ValueError(f"ring2d needs a ('dcn', 'ici') mesh, got {mesh.axis_names}")
    grid = mesh.devices if mesh.axis_names == ("dcn", "ici") else mesh.devices.T
    n_dcn, n_ici = grid.shape
    devices = list(grid.flat)
    mesh, n_dev, q, block, tensors, n_padded = _mesh_counts_setup(tensors, n_pods, block, mesh)
    with ti.eval_flight("counts.ring2d", n_pods, q, devices=n_dev) as fl:
        return _run_mesh_counts(
            _ring2d_parts(tensors, n_pods, block, devices, n_dcn, n_ici, pack), q, n_pods, fl
        )


def _ring2d_parts(tensors, n_pods, block, devices, n_dcn, n_ici, pack):
    """Each shard's partials of evaluate_grid_counts_ring2d."""
    n_dev = len(devices)
    seed, _step, meta = ring_counts_pipeline(tensors, n_pods, block, devices, pack=pack)
    srcs, rings = seed(tensors)
    ici = [h * n_ici + (c + 1) % n_ici for h in range(n_dcn) for c in range(n_ici)]
    dcn = [((h + 1) % n_dcn) * n_ici + c for h in range(n_dcn) for c in range(n_ici)]
    counts = [
        torch.zeros((n_dev * meta["tiles_per_shard"], 3), dtype=torch.int32, device=dev)
        for dev in devices
    ]
    for o in range(n_dcn):
        for j in range(n_ici):
            # all but one hop of a round stay on "ici"; the bundle crosses
            # "dcn" once a round (the last round's hop brings it home)
            nxt = _permute(rings, devices, ici if j < n_ici - 1 else dcn)
            for d in range(n_dev):
                valid_local = _shard_valid(d, meta["shard"], n_pods, devices[d])
                counts[d] = meta["count_bundle"](
                    srcs[d], rings[d], valid_local, counts[d], o * n_ici + j
                )
            rings = nxt
    return counts


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
