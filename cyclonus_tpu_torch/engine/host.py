"""Host-side tensor passes of the engine: the numpy work between the
encoder and the device.

Copies of the reference engine's host passes (cyclonus_tpu/engine/api.py
and the pod padding of engine/sharded.py), without the CIDR
tuple-space stage and the serve path's slab headroom:

  * _build_tensors       — encoding -> tensor dict, incl. the host-evaluated
                           IPv6 / mixed-family ip-peer rows and the
                           precedence-tier slabs
  * _compact_dead_targets — drop targets no pod of the cluster matches
  * _sort_targets_by_ns  — targets in namespace order
  * _bucket_tensors      — pad every axis to its shape bucket with the
                           inert fill of that array

Everything here is numpy; the result is what carry.tensors_from_reference
moves onto the device.
"""

from __future__ import annotations

import ipaddress
import logging
import math
import os
from typing import Dict, Optional, Tuple

import numpy as np

from ..kube.ipaddr import is_ip_address_match_for_ip_block
from .encoding import (
    EXP_EXISTS,
    EXP_IN,
    EXP_NONE,
    EXP_NOT_IN,
    PolicyEncoding,
    TierDirectionEncoding,
    _DirectionEncoding,
)

# pod-axis tensor keys
_POD_KEYS = ("pod_ns_id", "pod_kv", "pod_key", "pod_ip", "pod_ip_valid")


def _direction_tensors(enc: _DirectionEncoding) -> Dict:
    # peer->target mapping ships as a [P] index vector; kernels build the
    # dense one-hot on device (kernel.m_tp_onehot)
    peer_target = np.asarray(enc.peer_target, dtype=np.int32).reshape(-1)
    return {
        "target_ns": enc.target_ns,
        "target_sel": enc.target_sel,
        "peer_kind": enc.peer_kind,
        "peer_ns_kind": enc.peer_ns_kind,
        "peer_ns_id": enc.peer_ns_id,
        "peer_ns_sel": enc.peer_ns_sel,
        "peer_pod_kind": enc.peer_pod_kind,
        "peer_pod_sel": enc.peer_pod_sel,
        "ip_base": enc.ip_base,
        "ip_mask": enc.ip_mask,
        "ip_is_v4": enc.ip_is_v4,
        "ex_base": enc.ex_base,
        "ex_mask": enc.ex_mask,
        "ex_valid": enc.ex_valid,
        "peer_target": peer_target,
        "port_spec": dict(enc.port_spec),
    }


def _tier_tensors(tenc: TierDirectionEncoding) -> Dict:
    """Tensor-dict view of one direction's TierDirectionEncoding: the int8
    verdict + int32 rank slabs, the shared-table selector ids, and the
    per-row port spec."""
    return {
        "subj_ns_sel": tenc.subj_ns_sel,
        "subj_pod_kind": tenc.subj_pod_kind,
        "subj_pod_sel": tenc.subj_pod_sel,
        "peer_ns_sel": tenc.peer_ns_sel,
        "peer_pod_kind": tenc.peer_pod_kind,
        "peer_pod_sel": tenc.peer_pod_sel,
        "action": tenc.action,  # shape: (G,) int8; sentinel: 0=pad
        "tier": tenc.tier,
        "rank": tenc.rank,
        "port_spec": dict(tenc.port_spec),
    }


def _build_tensors(enc: PolicyEncoding) -> Dict:
    """The engine tensor dict of an encoding (TpuPolicyEngine._build_tensors):
    a "tiers" subtree appears only when the encoding carries tier slabs."""
    c = enc.cluster
    tensors = {
        "sel_req_kv": enc.sel_req_kv,
        "sel_exp_op": enc.sel_exp_op,
        "sel_exp_key": enc.sel_exp_key,
        "sel_exp_vals": enc.sel_exp_vals,
        "pod_ns_id": c.pod_ns_id,
        "pod_kv": c.pod_kv,
        "pod_key": c.pod_key,
        "pod_ip": c.pod_ip,
        "pod_ip_valid": c.pod_ip_valid,
        "ns_kv": c.ns_kv,
        "ns_key": c.ns_key,
        "ingress": _direction_tensors(enc.ingress),
        "egress": _direction_tensors(enc.egress),
    }
    if enc.tiers is not None:
        tensors["tiers"] = {
            "ingress": _tier_tensors(enc.tiers[0]),
            "egress": _tier_tensors(enc.tiers[1]),
        }
    for direction, denc in (("ingress", enc.ingress), ("egress", enc.egress)):
        if denc.host_ip_rows:
            # IPv6 / mixed-family IPBlocks: evaluate via the oracle's IP
            # matcher on host, inject as precomputed rows.
            n = c.n_pods
            mask = np.zeros((denc.n_peers,), dtype=bool)
            match = np.zeros((denc.n_peers, n), dtype=bool)
            for row, peer in denc.host_ip_rows:
                mask[row] = True
                for i, ip in enumerate(c.pod_ips):
                    match[row, i] = is_ip_address_match_for_ip_block(
                        ip, peer.ip_block
                    )
            tensors[direction]["host_ip_mask"] = mask
            tensors[direction]["host_ip_match"] = match
    return tensors


def _parseable_ip(ip: str) -> bool:
    try:
        ipaddress.ip_address(ip)
        return True
    except ValueError:
        return False


def _selector_match_np(
    sel_req_kv: np.ndarray,  # [S, R]
    sel_exp_op: np.ndarray,  # [S, E]
    sel_exp_key: np.ndarray,  # [S, E]
    sel_exp_vals: np.ndarray,  # [S, E, V]
    kv: np.ndarray,  # [N, L]
    key: np.ndarray,  # [N, L]
) -> np.ndarray:
    """[S, N] bool — numpy twin of kernel.selector_match, op for op."""
    present = np.any(
        kv[None, :, None, :] == sel_req_kv[:, None, :, None], axis=-1
    )
    req_ok = np.all((sel_req_kv[:, None, :] == -1) | present, axis=-1)  # [S, N]

    has_key = np.any(
        key[None, :, None, :] == sel_exp_key[:, None, :, None], axis=-1
    )  # [S, N, E]
    val_hit = np.any(
        (sel_exp_vals[:, None, :, :, None] != -1)
        & (kv[None, :, None, None, :] == sel_exp_vals[:, None, :, :, None]),
        axis=(-1, -2),
    )  # [S, N, E]
    op = sel_exp_op[:, None, :]  # [S, 1, E]
    exp_ok = np.where(
        op == EXP_NONE,
        True,
        np.where(
            op == EXP_IN,
            has_key & val_hit,
            np.where(
                op == EXP_NOT_IN,
                has_key & ~val_hit,
                np.where(op == EXP_EXISTS, has_key, ~has_key),
            ),
        ),
    )  # [S, N, E]
    return req_ok & np.all(exp_ok, axis=-1)


def _selector_pod_matches_host(tensors: Dict, chunk: int = 0) -> np.ndarray:
    """[S, N] bool selector-vs-pod matches, evaluated host-side in pod
    chunks.  The chunk scales inversely with the selector count and the
    trailing broadcast dims so the [S, chunk, ...] intermediates stay
    bounded in every axis."""
    n = tensors["pod_kv"].shape[0]
    s = tensors["sel_req_kv"].shape[0]
    if not chunk:
        r = tensors["sel_req_kv"].shape[1]
        e, v = tensors["sel_exp_vals"].shape[1:3]
        l = tensors["pod_kv"].shape[1]
        per_pod = max(s, 1) * max(r * l, e * v * l, 1)
        chunk = max(64, (1 << 24) // per_pod)
    outs = []
    for lo in range(0, n, chunk):
        outs.append(
            _selector_match_np(
                tensors["sel_req_kv"],
                tensors["sel_exp_op"],
                tensors["sel_exp_key"],
                tensors["sel_exp_vals"],
                tensors["pod_kv"][lo : lo + chunk],
                tensors["pod_key"][lo : lo + chunk],
            )
        )
    if not outs:
        return np.zeros((s, 0), dtype=bool)
    return np.concatenate(outs, axis=1)


# port_spec arrays are [P, ...]-shaped like the flat peer arrays
_PEER_KEYS = (
    "peer_kind",
    "peer_ns_kind",
    "peer_ns_id",
    "peer_ns_sel",
    "peer_pod_kind",
    "peer_pod_sel",
    "ip_base",
    "ip_mask",
    "ip_is_v4",
    "ex_base",
    "ex_mask",
    "ex_valid",
    "host_ip_mask",
)


def _compact_dead_targets(tensors: Dict, selpod: Optional[np.ndarray] = None) -> Dict:
    """Drop targets that match no pod of this cluster (and their peers).

    Verdicts are exactly invariant: a dead target's tmatch row is all
    False, so it contributes nothing to has_target and nothing to
    any_allow, while the target axis is the depth of every verdict
    contraction.  Deadness is decided with the real selector semantics,
    evaluated once on the host at encode time."""
    pod_ns_id = tensors["pod_ns_id"]
    if selpod is None:
        selpod = _selector_pod_matches_host(tensors)
    s = selpod.shape[0]
    # rows: any ns id referenced by pods or targets (vocab ns ids can
    # exceed the cluster's ns table when policies name pod-less namespaces)
    n_rows = int(tensors["ns_kv"].shape[0])
    for direction in ("ingress", "egress"):
        t_ns = tensors[direction]["target_ns"]
        if t_ns.size:
            n_rows = max(n_rows, int(t_ns.max()) + 1)
    if pod_ns_id.size:
        n_rows = max(n_rows, int(pod_ns_id.max()) + 1)
    # live_by_sel_ns[s, ns] = selector s matches >= 1 pod in namespace ns
    live_by_sel_ns = np.zeros((s, max(n_rows, 1)), dtype=bool)
    for si in range(s):
        ids = pod_ns_id[selpod[si]]
        if ids.size:
            live_by_sel_ns[si, ids[ids >= 0]] = True

    out = dict(tensors)
    for direction in ("ingress", "egress"):
        d = tensors[direction]
        t_ns, t_sel = d["target_ns"], d["target_sel"]
        t = t_ns.shape[0]
        if t == 0:
            continue
        live = (t_ns >= 0) & live_by_sel_ns[t_sel, np.maximum(t_ns, 0)]
        keep = np.flatnonzero(live)
        if keep.size == t:
            continue
        remap = np.full(t, -1, dtype=np.int32)
        remap[keep] = np.arange(keep.size, dtype=np.int32)
        pt = d["peer_target"]
        pkeep = (pt >= 0) & live[np.clip(pt, 0, t - 1)]
        nd = dict(d)
        nd["target_ns"] = np.ascontiguousarray(t_ns[keep])
        nd["target_sel"] = np.ascontiguousarray(t_sel[keep])
        nd["peer_target"] = np.ascontiguousarray(remap[pt[pkeep]])
        for k in _PEER_KEYS:
            if k in nd:
                nd[k] = np.ascontiguousarray(nd[k][pkeep])
        if "host_ip_match" in nd:
            nd["host_ip_match"] = np.ascontiguousarray(nd["host_ip_match"][pkeep])
        nd["port_spec"] = {
            k: np.ascontiguousarray(v[pkeep]) for k, v in d["port_spec"].items()
        }
        out[direction] = nd
    return out


def _sort_targets_by_ns(tensors: Dict) -> Dict:
    """Permute each direction's targets into namespace order (stable).

    Target order is semantically irrelevant — every kernel reduces over
    the target axis — and the sort keeps the tensor set identical to the
    reference engine's."""
    out = dict(tensors)
    for direction in ("ingress", "egress"):
        d = tensors[direction]
        t_ns = d["target_ns"]
        if t_ns.size == 0:
            continue
        tperm = np.argsort(t_ns, kind="stable")
        if np.array_equal(tperm, np.arange(tperm.size)):
            continue
        inv = np.empty_like(tperm)
        inv[tperm] = np.arange(tperm.size)
        nd = dict(d)
        nd["target_ns"] = np.ascontiguousarray(t_ns[tperm])
        nd["target_sel"] = np.ascontiguousarray(d["target_sel"][tperm])
        if d["peer_target"].size:
            nd["peer_target"] = np.ascontiguousarray(
                inv[d["peer_target"]].astype(np.int32)
            )
        out[direction] = nd
    return out


def _bucket_dim(n: int, lo: int = 4) -> int:
    """Shape bucket: next power of two up to 128, then multiples of 128."""
    n = max(n, lo)
    if n <= 128:
        return 1 << (n - 1).bit_length()
    return -(-n // 128) * 128


def _bucket_pods(n: int) -> int:
    """Pod-axis bucket: pow2 up to 1024, then multiples of 1024."""
    n = max(n, 8)
    if n <= 1024:
        return 1 << (n - 1).bit_length()
    return -(-n // 1024) * 1024


def _pad_axis(a: np.ndarray, axis: int, size: int, fill) -> np.ndarray:
    """Pad `axis` up to `size` with `fill` (no-op when already there)."""
    cur = a.shape[axis]
    if cur >= size:
        return a
    widths = [(0, 0)] * a.ndim
    widths[axis] = (0, size - cur)
    return np.pad(a, widths, constant_values=fill)


# (array key, per-axis fill values) — the inert pad conventions from
# encoding.py's padding-neutrality invariants: padded selectors are
# unreferenced, padded targets match no pod (ns -1), padded peers belong
# to target -1 (zero one-hot row), padded port items/ranges match nothing
_SEL_PADS = {
    "sel_req_kv": -1,
    "sel_exp_op": 0,
    "sel_exp_key": -1,
    "sel_exp_vals": -1,
}
_DIRECTION_PADS = {
    "target_ns": -1,
    "target_sel": 0,
    "peer_target": -1,
    "peer_kind": 0,
    "peer_ns_kind": 0,
    "peer_ns_id": -1,
    "peer_ns_sel": 0,
    "peer_pod_kind": 0,
    "peer_pod_sel": 0,
    "ip_base": 0,
    "ip_mask": 0,
    "ip_is_v4": False,
    "ex_base": 0,
    "ex_mask": 0,
    "ex_valid": False,
    "host_ip_mask": False,
    "host_ip_match": False,
}
_PORT_SPEC_PADS = {
    "item_kind": -1,
    "item_port": 0,
    "item_name": -2,
    "item_proto": -2,
    "rng_from": 0,
    "rng_to": -1,
    "rng_proto": -2,
    "spec_all": False,
}
# tier-slab pads: action 0 = TIER_ACT_NONE — a padded rule row matches
# nothing (every kernel masks on action > 0), so selector/rank fills
# are inert by construction
_TIER_PADS = {
    "subj_ns_sel": 0,
    "subj_pod_kind": 0,
    "subj_pod_sel": -1,
    "peer_ns_sel": 0,
    "peer_pod_kind": 0,
    "peer_pod_sel": -1,
    "action": 0,
    "tier": 0,
    "rank": 0,
}


def _pad_pod_arrays(tensors: Dict, n_pods: int, n_dev: int) -> Tuple[Dict, int]:
    """Pad the pod axis to a multiple of `n_dev` with inert rows (ns id
    -1, labels -1, invalid ip): they match no target and no peer.  The
    current length, not n_pods, is what gets rounded up."""
    cur = int(tensors["pod_ns_id"].shape[0])
    padded = math.ceil(max(cur, n_pods, 1) / n_dev) * n_dev
    if padded == cur:
        return tensors, cur
    pad = padded - cur
    t = dict(tensors)
    t["pod_ns_id"] = np.concatenate(
        [tensors["pod_ns_id"], np.full((pad,), -1, np.int32)]
    )
    t["pod_kv"] = np.concatenate(
        [tensors["pod_kv"], np.full((pad, tensors["pod_kv"].shape[1]), -1, np.int32)]
    )
    t["pod_key"] = np.concatenate(
        [tensors["pod_key"], np.full((pad, tensors["pod_key"].shape[1]), -1, np.int32)]
    )
    t["pod_ip"] = np.concatenate(
        [tensors["pod_ip"], np.zeros((pad,), np.uint32)]
    )  # shape: (N,) uint32; sentinel: 0=invalid; mask: pod_ip_valid
    t["pod_ip_valid"] = np.concatenate(
        [tensors["pod_ip_valid"], np.zeros((pad,), bool)]
    )  # shape: (N,) bool
    for direction in ("ingress", "egress"):
        d = t[direction]
        if "host_ip_match" in d:
            d = dict(d)
            d["host_ip_match"] = np.concatenate(
                [
                    d["host_ip_match"],
                    np.zeros((d["host_ip_match"].shape[0], pad), bool),
                ],
                axis=1,
            )
            t[direction] = d
    return t, padded


def _bucket_tensors(tensors: Dict) -> Dict:
    """Pad every tensor dimension up to its shape bucket with the inert
    fill for that array.  Semantics are unchanged by construction: each
    pad value is the same inert encoding the encoder itself uses for
    ragged padding."""
    t = dict(tensors)
    s = _bucket_dim(t["sel_req_kv"].shape[0])
    for k in ("sel_req_kv", "sel_exp_op", "sel_exp_key"):
        fill = _SEL_PADS[k]
        t[k] = _pad_axis(
            _pad_axis(t[k], 1, _bucket_dim(t[k].shape[1]), fill), 0, s, fill
        )
    ev = t["sel_exp_vals"]
    fill = _SEL_PADS["sel_exp_vals"]
    t["sel_exp_vals"] = _pad_axis(
        _pad_axis(
            _pad_axis(ev, 2, _bucket_dim(ev.shape[2]), fill),
            1, _bucket_dim(ev.shape[1]), fill,
        ),
        0, s, fill,
    )
    # namespace tables: padded rows are unreferenced (ns ids are real)
    m = _bucket_dim(t["ns_kv"].shape[0])
    for k in ("ns_kv", "ns_key"):
        t[k] = _pad_axis(
            _pad_axis(t[k], 1, _bucket_dim(t[k].shape[1]), -1), 0, m, -1
        )
    for k in ("pod_kv", "pod_key"):
        t[k] = _pad_axis(t[k], 1, _bucket_dim(t[k].shape[1]), -1)
    for direction in ("ingress", "egress"):
        d = dict(t[direction])
        # the reference's dense counts kernel appends one pseudo-target
        # row: the target axis buckets to boundary - 1, kept here so the
        # two packages hold identical tensors
        nt = _bucket_dim(d["target_ns"].shape[0] + 1) - 1
        np_ = _bucket_dim(d["peer_kind"].shape[0])
        for k, fill in _DIRECTION_PADS.items():
            if k not in d:
                continue
            size = nt if k.startswith("target_") else np_
            d[k] = _pad_axis(d[k], 0, size, fill)
            if k in ("ex_base", "ex_mask", "ex_valid"):
                d[k] = _pad_axis(d[k], 1, _bucket_dim(d[k].shape[1]), fill)
        spec = {}
        for k, fill in _PORT_SPEC_PADS.items():
            a = _pad_axis(d["port_spec"][k], 0, np_, fill)
            if a.ndim == 2:
                a = _pad_axis(a, 1, _bucket_dim(a.shape[1]), fill)
            spec[k] = a
        d["port_spec"] = spec
        t[direction] = d
    # precedence-tier slabs: the rule axis buckets like the peer axis,
    # padded with inert (action 0) rows
    if "tiers" in t:
        tiers = {}
        for direction in ("ingress", "egress"):
            d = dict(t["tiers"][direction])
            g = _bucket_dim(d["action"].shape[0])
            for k, fill in _TIER_PADS.items():
                d[k] = _pad_axis(d[k], 0, g, fill)
            spec = {}
            for k, fill in _PORT_SPEC_PADS.items():
                a = _pad_axis(d["port_spec"][k], 0, g, fill)
                if a.ndim == 2:
                    a = _pad_axis(a, 1, _bucket_dim(a.shape[1]), fill)
                spec[k] = a
            d["port_spec"] = spec
            tiers[direction] = d
        t["tiers"] = tiers
    n = t["pod_ns_id"].shape[0]
    t, _ = _pad_pod_arrays(t, n, _bucket_pods(n))
    return t


def _compaction_enabled(tensors: Dict) -> bool:
    """Compaction is on by default (CYCLONUS_COMPACT=0 opts out), guarded
    by a host-work budget on the selector pass: past 2^32 element ops
    the compaction win is dwarfed by its own cost (CYCLONUS_COMPACT=1
    forces it back on)."""
    setting = os.environ.get("CYCLONUS_COMPACT", "")
    if setting == "0":
        return False
    if setting == "1":
        return True
    s = int(tensors["sel_req_kv"].shape[0])
    n = int(tensors["pod_ns_id"].shape[0])
    r = int(tensors["sel_req_kv"].shape[1])
    e, v = (int(x) for x in tensors["sel_exp_vals"].shape[1:3])
    l = int(tensors["pod_kv"].shape[1])
    ops = s * n * max(r * l, e * v * l, 1)
    if ops > 1 << 32:
        logging.getLogger(__name__).info(
            "skipping dead-target compaction: host selector pass would "
            "cost ~%.1e element ops (budget 2^32); set CYCLONUS_COMPACT=1 "
            "to force it",
            float(ops),
        )
        return False
    return True


#: below this pod count the auto mode leaves class compression off
#: (CYCLONUS_CLASS_MIN_PODS overrides)
_CLASS_AUTO_MIN_PODS = 2048
#: the weighted-count split keeps every device-side partial an exact f32
#: integer only while row sums stay below 2^24 — larger clusters bypass
#: compression entirely
_CLASS_MAX_PODS_EXACT = 1 << 24
#: device byte budget the class counts route must fit
#: (CYCLONUS_SLAB_MAX_BYTES overrides)
_SLAB_MAX_BYTES = 6 * 2**30


def _class_compress_mode() -> str:
    """CYCLONUS_CLASS_COMPRESS: "auto" (default — engage above the pod
    floor when the class reduction is real), "1" (force, any size),
    "0" (off, incl. the rule-axis partition compression)."""
    return os.environ.get("CYCLONUS_CLASS_COMPRESS", "auto").lower()


def _class_auto_min_pods() -> int:
    try:
        return int(
            os.environ.get("CYCLONUS_CLASS_MIN_PODS", str(_CLASS_AUTO_MIN_PODS))
        )
    except ValueError:
        return _CLASS_AUTO_MIN_PODS


def _slab_max_bytes() -> int:
    try:
        return int(os.environ.get("CYCLONUS_SLAB_MAX_BYTES", str(_SLAB_MAX_BYTES)))
    except ValueError:
        return _SLAB_MAX_BYTES


def _np_leaves(tree):
    """Flat iterator over the numpy leaves of a nested tensor dict."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _np_leaves(v)
    elif isinstance(tree, np.ndarray):
        yield tree


def _slab_mode(slab: Optional[str] = None) -> str:
    """The slab-kernel mode, `slab` or else CYCLONUS_PALLAS_SLAB, for the
    dense route of the dense dtype plan: "1" forces the slab kernel (K6);
    "auto" (the default) plans it on a CUDA device with the precompute
    cache on and lets the engine's autotune time K6 against K4/K5 at the
    first steady-state call and keep the faster (never on the CPU, as the
    reference's auto plans on its TPU only); "0" turns it off; anything
    else raises.  Of the reference's autotune the port leaves out the
    bounded candidate thread and its fallback to the default kernel, a
    guard for a wedged remote TPU compile: a failing K6 raises."""
    if slab is None:
        slab = os.environ.get("CYCLONUS_PALLAS_SLAB", "auto")
    slab = str(slab).lower()
    if slab not in ("auto", "0", "1"):
        raise ValueError(f"slab mode (CYCLONUS_PALLAS_SLAB) must be auto, 0, or 1, got {slab!r}")
    return slab


def _tmatch_host(d: Dict, pod_ns: np.ndarray, selpod: np.ndarray) -> np.ndarray:
    """[T, N] bool numpy twin of the precompute's tmatch
    (kernel.direction_precompute): target t applies to pod n when they
    share the namespace and the target's pod selector matches n."""
    tm = d["target_ns"][:, None] == pod_ns[None, :]
    if selpod.size and d["target_sel"].size:
        t_sel = np.clip(d["target_sel"], 0, selpod.shape[0] - 1)
        tm &= selpod[t_sel]
    return tm


def _slab_plan(
    tensors: Dict,
    perm: np.ndarray,
    n_pods: int,
    aux_bytes: int,
    selpod: Optional[np.ndarray] = None,
) -> Optional[Dict]:
    """Per-tile target windows for the slab kernel (K6), or None when it
    does not apply.

    The same reduction the kernel's safety rests on, on the host: per
    direction, every pod tile's matching targets on the ns-sorted pod
    axis (`perm`) must fit one window (dense_kernel.slab_windows), with
    the pad pods' columns forced False as the kernel's validity mask
    forces them.  The cluster must span at least two src tiles, and the
    gathered slabs (both directions at 2 port cases, at the widest window)
    plus the class state's `aux_bytes` must fit the device budget.  The
    window width is the narrowest rung of {SLAB_W/4, SLAB_W/2, SLAB_W}
    that covers every tile of both directions (one w for both).  `selpod`
    is the compaction-time selector pass (real selectors x real pods),
    padded here to the bucketed axes.

    Returns {"egress": t0_e [n_i], "ingress": t0_i [n_j], "w",
    "bytes_per_case", "budget"}."""
    from . import dense_kernel as dk

    n_b = int(tensors["pod_ns_id"].shape[0])
    if n_b < 2 * dk.SLAB_BS:
        return None
    n_tiles = -(-n_b // dk.SLAB_BS) + -(-n_b // dk.SLAB_BD)
    bytes_per_case = n_tiles * dk.slab_w_aug() * n_b  # int8 slabs
    budget = _slab_max_bytes()
    if 2 * bytes_per_case + aux_bytes > budget:
        return None
    if selpod is None:
        selpod = _selector_pod_matches_host(tensors)
    else:
        pre = selpod
        selpod = np.zeros((tensors["sel_req_kv"].shape[0], n_b), dtype=bool)
        selpod[: pre.shape[0], : pre.shape[1]] = pre
    pod_ns = tensors["pod_ns_id"]
    ladder = sorted({max(1, dk.SLAB_W // 4), max(1, dk.SLAB_W // 2), dk.SLAB_W})
    plan = {}
    w_need = ladder[0]
    for direction, tile in (("egress", dk.SLAB_BS), ("ingress", dk.SLAB_BD)):
        tm = _tmatch_host(tensors[direction], pod_ns, selpod)[:, perm]
        tm[:, n_pods:] = False  # pads sort last
        t0 = ok = None
        for w_try in ladder:
            t0, ok = dk.slab_windows(tm, tile, w_try)
            if ok:
                w_need = max(w_need, w_try)
                break
        if not ok:
            return None
        plan[direction] = t0
    plan["w"] = w_need
    plan["bytes_per_case"] = bytes_per_case
    plan["budget"] = budget
    return plan
