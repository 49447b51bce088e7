"""Incremental (delta-oriented) engine maintenance for the verdict
service: the reference's serve/incremental.py on the port's engine.

The engine uploads its host tensor dict to the device once, as one torch
tensor per leaf (TorchPolicyEngine._dev).  A controller that sees a
stream of pod, label and policy events cannot pay that upload per event,
so this module patches the LIVE engine instead, on the host and on the
device alike:

  * pod deltas (add / remove / label change / ip change) re-encode ONLY
    the touched pod rows against the engine's existing vocabulary
    (encoding.encode_pod_rows: the vocab grows monotonically, so a fresh
    label pair gets an id no selector references — exactly the
    fresh-rebuild semantics), write them into the host arrays, and stage
    the touched rows for the device leaves;
  * namespace-label deltas patch the one namespace row (in the main and,
    when present, the class-representative tensor set);
  * policy and tier deltas re-encode the RULE SLABS (directions, tier
    slabs and the shared selector table) against the same vocabulary,
    run them through the engine's own partition compression, ns sort and
    bucketing, and patch them wholesale IF every slab fits its allocated
    bucketed shape (the engine's slab headroom absorbs a slab that grew
    past its natural bucket);
  * anything that cannot patch exactly — label rows wider than the
    encoded width, a namespace beyond the bucketed table, IPv6 or
    mixed-family host-evaluated IP blocks, rule slabs that outgrow their
    allocation — raises Ineligible, and the service falls back to a full
    rebuild from its authoritative cluster state.

A flush (_PatchSet.flush) moves the staged rows of every leaf to the
device in ONE host-to-device copy, then writes each leaf with one
index_copy_ (or one copy_ when a whole leaf was staged): untouched rows
and untouched leaves are never re-uploaded.  A staged row is widened as
carry.to_torch widens it (uint32 pod IPs and CIDR bases to int64).

Class-compression state (encoding.PodClasses) is patched too: a pod
delta recomputes that pod's observability signature and moves it
between EXISTING classes in place; a brand-new signature, a departing
class representative with survivors, or any policy/add/remove churn
rebuilds the class state alone (host classify, and the class tensor set
uploads again at its next use; the main set stays untouched).  When the
class signature's CIDR block rides the TSS partition map
(engine/cidrspace.py), every signature is taken with the engine's cached
map: a pod delta reuses it, a class rebuild re-resolves it from the
patched tensors, and a policy delta that changes the map's mask
structure raises Ineligible before anything mutates.

After any patch, TorchPolicyEngine.invalidate_after_patch() drops what
was derived from the old values (the steady state's pin, the slab
operands and plan, the ns-order permutation, the class map) and keeps
the device views the flush wrote.

Correctness is pinned by the differential gate (VerdictService.
verify_parity, tests/test_torch_serve.py): after any delta sequence the
patched engine must equal an engine freshly built from the post-delta
cluster state, with the scalar oracle spot-checking both.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import carry
from ..engine import cidrspace, host
from ..engine.api import TorchPolicyEngine
from ..engine.encoding import (
    PEER_IP,
    classes_from_signatures,
    compress_rule_axes,
    encode_directions,
    encode_ns_row,
    encode_pod_rows,
    gather_class_pod_rows,
    pod_signatures,
)
from ..matcher.core import Policy
from ..telemetry import instruments as ti
from ..utils import envflags

PodTuple = Tuple[str, str, Dict[str, str], str]

#: the five per-pod leaves every pod-row patch touches
_POD_LEAVES = host._POD_KEYS

#: rule-slab leaves outside the per-direction dicts
_SEL_LEAVES = ("sel_req_kv", "sel_exp_op", "sel_exp_key", "sel_exp_vals")


class Ineligible(Exception):
    """This delta batch cannot patch the live engine exactly; the caller
    must fall back to a full rebuild from authoritative state."""


def serve_headroom() -> int:  # never-raises
    """CYCLONUS_SERVE_HEADROOM: extra rule-slab bucket steps the serve
    path reserves at engine build (default 1; 0 restores exact-fit
    buckets).  A malformed value reads as the default."""
    return max(0, envflags.get_int("CYCLONUS_SERVE_HEADROOM"))


def _leaf(tree: Dict, path: tuple):
    for k in path:
        if not isinstance(tree, dict) or k not in tree:
            return None
        tree = tree[k]
    return tree


def _align(n: int) -> int:
    return -(-n // 8) * 8


class _PatchSet:
    """Staged row writes into one resident device tensor set (the engine's
    device views, or its class set's).

    A stage records WHICH rows of a leaf to write, from which host array;
    the values are read at flush, after every host update of the batch,
    so a row staged twice is written once with its final value."""

    def __init__(self, device_tensors: Dict):
        self._dev = device_tensors
        # path -> (host array, rows; None = the whole leaf)
        self._staged: Dict[tuple, Tuple[np.ndarray, Optional[set]]] = {}

    def stage_rows(self, path: tuple, host_arr: np.ndarray, row_lo: int, row_hi: int) -> None:
        """Stage rows [row_lo, row_hi) of the leaf at `path` (axis 0)."""
        if row_hi <= row_lo:
            return
        dev = _leaf(self._dev, path)
        if not isinstance(dev, torch.Tensor):
            raise Ineligible(f"no device leaf at {path!r}")
        want = carry._DTYPES.get(host_arr.dtype)
        if tuple(dev.shape) != tuple(host_arr.shape) or dev.dtype != want:
            raise Ineligible(
                f"leaf {path!r} drifted from its device view: "
                f"{host_arr.dtype}{host_arr.shape} vs {dev.dtype}{tuple(dev.shape)}"
            )
        prev = self._staged.get(path)
        whole = row_lo == 0 and row_hi >= host_arr.shape[0]
        rows = None if whole else set(range(row_lo, row_hi))
        if prev is not None:
            if prev[0] is not host_arr:
                raise Ineligible(f"leaf {path!r} staged from two host arrays")
            rows = None if prev[1] is None or rows is None else prev[1] | rows
        if rows is not None and len(rows) == host_arr.shape[0]:
            rows = None
        self._staged[path] = (host_arr, rows)

    def stage_leaf(self, path: tuple, host_arr: np.ndarray) -> None:
        self.stage_rows(path, host_arr, 0, int(host_arr.shape[0]))

    def _plan(self):
        """(path, rows array or None, values in the device dtype) per
        staged leaf."""
        out = []
        for path, (arr, rows) in self._staged.items():
            idx = None if rows is None else np.array(sorted(rows), dtype=np.int64)
            vals = arr if idx is None else arr[idx]
            if vals.dtype == np.uint32:
                vals = vals.astype(np.int64)
            out.append((path, idx, np.ascontiguousarray(vals)))
        return out

    @property
    def staged_bytes(self) -> int:
        """Bytes of the staged row values, in the device dtype."""
        total = 0
        for arr, rows in self._staged.values():
            n_rows = arr.shape[0] if rows is None else len(rows)
            item = 8 if arr.dtype == np.uint32 else arr.dtype.itemsize
            total += n_rows * int(np.prod(arr.shape[1:], dtype=np.int64)) * item
        return total

    def flush(self) -> int:
        """Write the staged rows into the device leaves; returns the bytes
        of row values written.  One host-to-device copy moves every
        leaf's rows and row indices (8-byte aligned segments of one byte
        buffer); then one index_copy_ per leaf, or one copy_ for a
        leaf staged whole."""
        plan = self._plan()
        if not plan:
            return 0
        segs, off = [], 0
        for path, idx, vals in plan:
            v_off = off
            off = _align(off + vals.nbytes)
            i_off = off
            if idx is not None:
                off = _align(off + idx.nbytes)
            segs.append((path, idx, vals, v_off, i_off))
        buf = np.zeros((max(off, 8),), dtype=np.uint8)
        for _path, idx, vals, v_off, i_off in segs:
            buf[v_off : v_off + vals.nbytes] = vals.reshape(-1).view(np.uint8)
            if idx is not None:
                buf[i_off : i_off + idx.nbytes] = idx.view(np.uint8)
        dev_leaf0 = _leaf(self._dev, segs[0][0])
        dbuf = torch.from_numpy(buf).to(dev_leaf0.device)
        nbytes = 0
        for path, idx, vals, v_off, i_off in segs:
            leaf = _leaf(self._dev, path)
            seg = dbuf[v_off : v_off + vals.nbytes].view(leaf.dtype).reshape(vals.shape)
            if idx is None:
                leaf.copy_(seg)
            else:
                rows = dbuf[i_off : i_off + idx.nbytes].view(torch.int64)
                leaf.index_copy_(0, rows, seg)
            nbytes += vals.nbytes
        self._staged.clear()
        return nbytes


def _pad_row(row: np.ndarray, width: int, fill) -> np.ndarray:
    if row.shape[-1] >= width:
        return row
    out = np.full(row.shape[:-1] + (width,), fill, dtype=row.dtype)
    out[..., : row.shape[-1]] = row
    return out


class IncrementalEngine:
    """A TorchPolicyEngine plus the state needed to patch it in place.

    Single-writer by contract: the owning VerdictService serializes
    every apply and query under its own lock, so nothing here locks."""

    def __init__(
        self,
        policy: Policy,
        pods: Sequence[PodTuple],
        namespaces: Dict[str, Dict[str, str]],
        *,
        device=None,
        class_compress: Optional[str] = None,
        tiers=None,
    ):
        # compact=False: dead-target compaction bakes pod state into the
        # RULE tensors, which a pod delta can invalidate — a
        # delta-oriented engine keeps every target resident
        self.engine = TorchPolicyEngine(
            policy,
            pods,
            namespaces,
            device=device,
            compact=False,
            class_compress=class_compress,
            tiers=tiers,
            slab_headroom=serve_headroom(),
        )
        # the zero-headroom engine's rule-slab buckets, the baseline
        # headroom saves count against; derived at the first policy patch
        self._natural_buckets: Optional[Dict[tuple, int]] = None
        #: policy patches that grew a slab past the zero-headroom engine's
        #: bucket and still fit the reservation: full rebuilds avoided
        self.headroom_saves = 0
        #: bytes of row values written to the device by this engine's patches
        self.patch_bytes = 0
        # class-patch support: the per-pod signature matrix and the
        # signature -> class id index (see update_pod_signature)
        self._sigs: Optional[np.ndarray] = None
        self._selpod: Optional[np.ndarray] = None
        self._class_sig_of: Dict[bytes, int] = {}
        # (staged, space) handoff from patch_policy's structure pin to
        # the rebuild it ends with — consumed (and reset) by
        # rebuild_class_state, staged only after every Ineligible
        self._resolved_cidr = (False, None)
        if self.engine._class_state is not None:
            self._init_class_support()

    # --- construction-time views ----------------------------------------

    def _raw_selector_view(self) -> Dict:
        """Raw (pre-bucket) selector + pod arrays for host selector-match
        passes (the class signature's selpod block keeps the raw selector
        count, which the bucketed tables pad)."""
        enc = self.engine.encoding
        c = enc.cluster
        return {
            "sel_req_kv": enc.sel_req_kv,
            "sel_exp_op": enc.sel_exp_op,
            "sel_exp_key": enc.sel_exp_key,
            "sel_exp_vals": enc.sel_exp_vals,
            "pod_kv": c.pod_kv,
            "pod_key": c.pod_key,
            "pod_ns_id": c.pod_ns_id,
        }

    def _sig_view(self, rows) -> Dict:
        """A row-sliced view of the engine tensors for pod_signatures:
        per-pod arrays at `rows`, direction dicts shared (the ip-peer
        spec set is row-independent)."""
        t = self.engine._tensors
        v = {
            k: np.ascontiguousarray(t[k][rows])
            for k in ("pod_ns_id", "pod_ip", "pod_ip_valid")
        }
        v["ingress"] = t["ingress"]
        v["egress"] = t["egress"]
        return v

    def _init_class_support(self) -> None:
        n = self.engine.n_pods
        self._selpod = host._selector_pod_matches_host(self._raw_selector_view())
        # the engine's resolved CidrSpace (or None = dense bits) rides
        # every signature computation: build and serve must read the
        # same partition map or row widths/values would diverge
        self._sigs = pod_signatures(
            self._sig_view(np.arange(n)),
            self._selpod,
            cidr=self.engine._class_state.get("cidr"),
        )
        pc = self.engine._class_state["classes"]
        self._class_sig_of = {
            self._sigs[rep].tobytes(): cid
            for cid, rep in enumerate(np.asarray(pc.class_rep))
        }

    # --- eligibility -----------------------------------------------------

    def check_patchable(self) -> None:
        """Engine-level preconditions every incremental path shares."""
        enc = self.engine.encoding
        if enc.ingress.host_ip_rows or enc.egress.host_ip_rows:
            raise Ineligible(
                "host-evaluated (IPv6/mixed) IPBlock rows present: their "
                "per-pod match columns are rebuilt host-side only"
            )

    def pod_capacity(self) -> int:
        """Spare bucketed pod rows available for in-place adds."""
        return int(self.engine._tensors["pod_ns_id"].shape[0] - self.engine.n_pods)

    # --- pod row patches -------------------------------------------------

    def _ensure_namespace(self, ns: str) -> int:
        """Vocab id for `ns`, claiming a padded namespace row when the
        namespace is new (Ineligible when the bucketed table is full).
        Stages NOTHING: a fresh namespace starts label-less and its
        bucketed row is already the all-pad row."""
        eng = self.engine
        vocab = eng.encoding.cluster.vocab
        nid = vocab.ns.get(ns)
        if nid is not None:
            return nid
        t = eng._tensors
        nid = len(vocab.ns)
        if nid >= int(t["ns_kv"].shape[0]):
            raise Ineligible(
                f"namespace table full ({nid} ids, "
                f"{int(t['ns_kv'].shape[0])} bucketed rows)"
            )
        vocab.ns_id(ns)
        # only the RAW table needs the append
        c = eng.encoding.cluster
        if nid >= int(c.ns_kv.shape[0]):
            pad = np.full((1, c.ns_kv.shape[1]), -1, dtype=np.int32)
            c.ns_kv = np.concatenate([c.ns_kv, pad])
            c.ns_key = np.concatenate([c.ns_key, pad.copy()])
        return nid

    def set_namespace_labels(
        self,
        ns: str,
        labels: Dict[str, str],
        patch: _PatchSet,
        class_patch: Optional[_PatchSet],
    ) -> None:
        eng = self.engine
        c = eng.encoding.cluster
        t = eng._tensors
        nid = self._ensure_namespace(ns)
        try:
            kv, key = encode_ns_row(labels, c.vocab, int(c.ns_kv.shape[1]))
        except ValueError as e:
            raise Ineligible(str(e)) from None
        c.ns_kv[nid] = kv
        c.ns_key[nid] = key
        bw = int(t["ns_kv"].shape[1])
        t["ns_kv"][nid] = _pad_row(kv, bw, -1)
        t["ns_key"][nid] = _pad_row(key, bw, -1)
        patch.stage_rows(("ns_kv",), t["ns_kv"], nid, nid + 1)
        patch.stage_rows(("ns_key",), t["ns_key"], nid, nid + 1)
        st = eng._class_state
        if st is not None:
            ct = st["ctensors"]
            # the class set shares the namespace tables; its copies may
            # or may not alias the main ones — write + stage both
            ct["ns_kv"][nid] = t["ns_kv"][nid]
            ct["ns_key"][nid] = t["ns_key"][nid]
            if class_patch is not None:
                class_patch.stage_rows(("ns_kv",), ct["ns_kv"], nid, nid + 1)
                class_patch.stage_rows(("ns_key",), ct["ns_key"], nid, nid + 1)

    def _write_pod_row(self, i: int, pod: PodTuple, patch: _PatchSet, *, append: bool) -> None:
        """Encode `pod` against the live vocab and write row i of the raw
        + bucketed pod arrays, staging the bucketed row."""
        eng = self.engine
        c = eng.encoding.cluster
        t = eng._tensors
        try:
            ns_id, kv, key, ip, ip_valid = encode_pod_rows([pod], c.vocab, int(c.pod_kv.shape[1]))
        except ValueError as e:
            raise Ineligible(str(e)) from None
        if append:
            c.pod_ns_id = np.concatenate([c.pod_ns_id, ns_id])
            c.pod_kv = np.concatenate([c.pod_kv, kv])
            c.pod_key = np.concatenate([c.pod_key, key])
            c.pod_ip = np.concatenate([c.pod_ip, ip])
            c.pod_ip_valid = np.concatenate([c.pod_ip_valid, ip_valid])
            c.pod_keys.append(f"{pod[0]}/{pod[1]}")
            c.pod_ips.append(pod[3])
        else:
            c.pod_ns_id[i] = ns_id[0]
            c.pod_kv[i] = kv[0]
            c.pod_key[i] = key[0]
            c.pod_ip[i] = ip[0]
            c.pod_ip_valid[i] = ip_valid[0]
            c.pod_keys[i] = f"{pod[0]}/{pod[1]}"
            c.pod_ips[i] = pod[3]
        bw = int(t["pod_kv"].shape[1])
        t["pod_ns_id"][i] = ns_id[0]
        t["pod_kv"][i] = _pad_row(kv[0], bw, -1)
        t["pod_key"][i] = _pad_row(key[0], bw, -1)
        t["pod_ip"][i] = ip[0]
        t["pod_ip_valid"][i] = ip_valid[0]
        self._stage_pod_row(i, patch)

    def _stage_pod_row(self, i: int, patch: _PatchSet) -> None:
        t = self.engine._tensors
        for k in _POD_LEAVES:
            patch.stage_rows((k,), t[k], i, i + 1)

    def _clear_pod_row(self, i: int, patch: _PatchSet) -> None:
        """Reset bucketed row i to the inert pad scheme (ns -1, labels
        -1, invalid ip) — the fill host._pad_pod_arrays uses."""
        t = self.engine._tensors
        t["pod_ns_id"][i] = -1
        t["pod_kv"][i] = -1
        t["pod_key"][i] = -1
        t["pod_ip"][i] = 0
        t["pod_ip_valid"][i] = False
        self._stage_pod_row(i, patch)

    def update_pod(self, i: int, pod: PodTuple, patch: _PatchSet) -> None:
        """Label/ip/namespace change of an existing pod row."""
        self._ensure_namespace(pod[0])
        self._write_pod_row(i, pod, patch, append=False)

    def add_pod(self, pod: PodTuple, patch: _PatchSet) -> int:
        """Claim the first padded row for a new pod; returns its index."""
        if self.pod_capacity() < 1:
            raise Ineligible("bucketed pod axis is full")
        self._ensure_namespace(pod[0])
        i = self.engine.n_pods
        self._write_pod_row(i, pod, patch, append=True)
        return i

    def remove_pod(self, i: int, patch: _PatchSet) -> Optional[int]:
        """Swap-remove pod row i (the last real row moves into the hole);
        returns the moved row's OLD index (None when i was last)."""
        eng = self.engine
        c = eng.encoding.cluster
        t = eng._tensors
        last = c.n_pods - 1
        moved = None
        if i != last:
            moved = last
            # copy VALUES first (reads before any write, alias-safe)
            row = tuple(np.copy(t[k][last]) for k in _POD_LEAVES)
            for k, v in zip(_POD_LEAVES, row):
                t[k][i] = v
            self._stage_pod_row(i, patch)
            c.pod_ns_id[i] = c.pod_ns_id[last]
            c.pod_kv[i] = c.pod_kv[last]
            c.pod_key[i] = c.pod_key[last]
            c.pod_ip[i] = c.pod_ip[last]
            c.pod_ip_valid[i] = c.pod_ip_valid[last]
            c.pod_keys[i] = c.pod_keys[last]
            c.pod_ips[i] = c.pod_ips[last]
        self._clear_pod_row(last, patch)
        c.pod_ns_id = c.pod_ns_id[:last].copy()
        c.pod_kv = c.pod_kv[:last].copy()
        c.pod_key = c.pod_key[:last].copy()
        c.pod_ip = c.pod_ip[:last].copy()
        c.pod_ip_valid = c.pod_ip_valid[:last].copy()
        c.pod_keys.pop()
        c.pod_ips.pop()
        return moved

    # --- class-state maintenance ----------------------------------------

    def update_pod_signature(self, i: int) -> str:
        """Recompute pod i's signature after a same-row update; move it
        between existing classes in place when possible.  Returns the
        action taken: 'none' (no class state), 'noop', 'moved', or
        'rebuild' (class state rebuilt)."""
        eng = self.engine
        if eng._class_state is None:
            return "none"
        enc = eng.encoding
        c = enc.cluster
        # refresh the selpod column from the RAW row (raw widths)
        col = host._selector_match_np(
            enc.sel_req_kv, enc.sel_exp_op, enc.sel_exp_key, enc.sel_exp_vals,
            c.pod_kv[i : i + 1], c.pod_key[i : i + 1],
        )[:, 0]
        self._selpod[:, i] = col
        sig = pod_signatures(
            self._sig_view(np.array([i])),
            self._selpod[:, i : i + 1],
            cidr=eng._class_state.get("cidr"),
        )[0]
        if sig.shape[0] != self._sigs.shape[1]:
            self.rebuild_class_state()
            return "rebuild"
        if sig.tobytes() == self._sigs[i].tobytes():
            return "noop"
        pc = eng._class_state["classes"]
        cid_old = int(pc.class_of_pod[i])
        cid_new = self._class_sig_of.get(sig.tobytes())
        self._sigs[i] = sig
        if cid_new is None or (
            int(pc.class_rep[cid_old]) == i and int(pc.class_size[cid_old]) > 1
        ):
            # a brand-new signature needs a new class row (shape change),
            # and a departing representative leaves survivors pointing at
            # values that no longer exist — both rebuild the class state
            self.rebuild_class_state()
            return "rebuild"
        pc.class_of_pod[i] = cid_new
        pc.class_size[cid_old] -= 1
        pc.class_size[cid_new] += 1
        return "moved"

    def resize_signatures(self) -> None:
        """After add/remove churn the signature matrix is row-stale; the
        class state rebuilds wholesale (class axes may change)."""
        if self.engine._class_state is not None:
            self.rebuild_class_state()

    def rebuild_class_state(self) -> None:
        """Recompute classes + the class-representative tensor set from
        the CURRENT (already patched) engine tensors; the class set
        uploads again at its next use, the main set is untouched."""
        eng = self.engine
        st = eng._class_state
        if st is None:
            return
        n = eng.n_pods
        self._selpod = host._selector_pod_matches_host(self._raw_selector_view())
        # re-resolve the TSS partition map from the CURRENT tensors: a
        # same-structure policy patch may have changed atom membership
        # within existing masks (patch_policy pins the mask structure
        # itself), and a stale map would compute stale signatures.  A
        # patch_policy call hands over the space it already resolved for
        # the structure pin, so a policy delta derives the map once.
        stashed, space = self._resolved_cidr
        self._resolved_cidr = (False, None)
        if not stashed:
            space = cidrspace.resolve(
                eng._tensors, mode=eng._opt_cidr_tss, n_pods=n, device=eng.device
            )
        st["cidr"] = space
        t0 = time.perf_counter()
        self._sigs = pod_signatures(
            self._sig_view(np.arange(n)), self._selpod, cidr=space
        )
        pc = classes_from_signatures(self._sigs)
        st["classify_s"] = time.perf_counter() - t0
        self._class_sig_of = {
            self._sigs[rep].tobytes(): cid
            for cid, rep in enumerate(np.asarray(pc.class_rep))
        }
        base = dict(eng._tensors)
        base.update({k: np.ascontiguousarray(eng._tensors[k][:n]) for k in _POD_LEAVES})
        ct = host._bucket_tensors(
            host._sort_targets_by_ns(gather_class_pod_rows(base, pc.class_rep)),
            headroom=eng._slab_headroom,
        )
        cb = int(ct["pod_ns_id"].shape[0])
        st["classes"] = pc
        st["ratio"] = n / max(pc.n_classes, 1)
        st["ctensors"] = ct
        st["aux_bytes"] = int(
            n * 4 + cb * 4 + sum(a.nbytes for a in host._np_leaves(ct))
            + (space.nbytes() if space is not None else 0)
        )
        st["device_tensors"] = None
        st["class_of"] = None
        ti.CLASS_PODS.set(n)
        ti.CLASS_COUNT.set(pc.n_classes)
        ti.CLASS_RATIO.set(st["ratio"])
        ti.CLASS_AUX_BYTES.set(st["aux_bytes"])

    # --- rule-slab patches ----------------------------------------------

    def patch_policy(self, policy: Policy, tiers=None) -> None:
        """Re-encode the rule slabs for a changed policy/tier set and
        patch them into the live engine; Ineligible when any slab outgrows
        its allocated bucketed shape.

        `tiers` must be the service's CURRENT TierSet whenever the live
        engine carries tier slabs — even for a pure NetworkPolicy delta:
        the tier rows index the SHARED selector table this re-encode
        rebuilds.  The bucketed-shape comparison below covers the tier
        slabs exactly like the NetworkPolicy slabs."""
        eng = self.engine
        enc = eng.encoding
        vocab = enc.cluster.vocab
        had_tiers = "tiers" in eng._tensors
        if had_tiers and not tiers:
            raise Ineligible(
                "live engine carries tier slabs but the patch has no "
                "TierSet (tensor structure change)"
            )
        if tiers and not had_tiers:
            raise Ineligible("tier slabs appear on a tier-less engine (tensor structure change)")
        ingress, egress, sel_arrays, n_sel, tier_enc = encode_directions(
            policy, vocab, tiers=tiers if had_tiers else None
        )
        if ingress.host_ip_rows or egress.host_ip_rows:
            raise Ineligible("changed policy set introduces host-evaluated (IPv6) IPBlock rows")
        new: Dict = {
            "sel_req_kv": sel_arrays[0],
            "sel_exp_op": sel_arrays[1],
            "sel_exp_key": sel_arrays[2],
            "sel_exp_vals": sel_arrays[3],
            "ingress": host._direction_tensors(ingress),
            "egress": host._direction_tensors(egress),
        }
        if tier_enc is not None:
            new["tiers"] = {
                "ingress": host._tier_tensors(tier_enc[0]),
                "egress": host._tier_tensors(tier_enc[1]),
            }
        # the TSS partition-map pin: when the live class state rides the
        # LPM stage, a policy delta that changes the MASK structure (a
        # prefix length appearing or disappearing, or the stage turning
        # on or off) changes the shape of every pod signature.  That is a
        # full rebuild, checked before any state mutates; atom churn
        # within existing masks stays patchable (rebuild_class_state
        # takes the new map after the slabs land)
        new_space = None
        if eng._class_state is not None:
            new_space = cidrspace.resolve(
                {"ingress": new["ingress"], "egress": new["egress"]},
                mode=eng._opt_cidr_tss,
                n_pods=eng.n_pods,
                device=eng.device,
            )
            if cidrspace.mask_structure(
                eng._class_state.get("cidr")
            ) != cidrspace.mask_structure(new_space):
                raise Ineligible(
                    "CIDR TSS partition structure changed (new mask "
                    "structure): the class signature layout must rebuild"
                )
        pstats = None
        if eng._partition_stats is not None:
            pstats = {}
            for direction in ("ingress", "egress"):
                new[direction], pstats[direction] = compress_rule_axes(new[direction])
        merged = dict(eng._tensors)
        merged.update(new)
        merged = host._bucket_tensors(host._sort_targets_by_ns(merged))
        # fit the re-encoded slabs into the engine's ALLOCATED buckets:
        # each leaf pads up to its existing shape with the inert fill —
        # into the headroom reservation when the natural bucket grew —
        # and any axis past the allocation is a bucket overflow only a
        # full rebuild can absorb.  All checked before anything mutates.
        old = eng._tensors
        headroom = eng._slab_headroom

        def _fit(label: str, arr: np.ndarray, old_arr: np.ndarray, fill):
            if arr.shape == old_arr.shape:
                return arr
            if any(a > b for a, b in zip(arr.shape, old_arr.shape)):
                raise Ineligible(
                    f"{label} outgrows its allocated bucket {old_arr.shape} -> {arr.shape}"
                )
            for ax, size in enumerate(old_arr.shape):
                arr = host._pad_axis(arr, ax, size, fill)
            return arr

        def _fit_slab_dict(label: str, od: Dict, nd: Dict, pads: Dict) -> Dict:
            if set(od) != set(nd):
                raise Ineligible(f"{label} slab key set changed")
            out = {}
            for k in od:
                if k == "port_spec":
                    if set(od[k]) != set(nd[k]):
                        raise Ineligible(f"{label} port_spec key set changed")
                    out[k] = {
                        s: _fit(f"{label}.port_spec.{s}", nd[k][s], od[k][s],
                                host._PORT_SPEC_PADS[s])
                        for s in od[k]
                    }
                else:
                    out[k] = _fit(f"{label}.{k}", nd[k], od[k], pads[k])
            return out

        # a headroom SAVE = this patch grew some rule-slab row axis past
        # the zero-headroom engine's CURRENT bucket but still fit the
        # reservation.  That baseline starts at the build-time natural
        # buckets and follows each applied patch (a zero-headroom engine
        # rebuilds on any bucket change), so later patches at an
        # already-grown size count nothing.  Target axes are tracked in
        # full-bucket units (allocated as bucket - 1).
        needed_buckets: Dict[tuple, int] = {("sel",): int(merged["sel_req_kv"].shape[0])}
        for direction in ("ingress", "egress"):
            nd = merged[direction]
            needed_buckets[(direction, "target")] = int(nd["target_ns"].shape[0]) + 1
            needed_buckets[(direction, "peer")] = int(nd["peer_kind"].shape[0])
            if had_tiers:
                needed_buckets[(direction, "tier")] = int(
                    merged["tiers"][direction]["action"].shape[0]
                )
        if self._natural_buckets is None:
            base: Dict[tuple, int] = {
                ("sel",): host._bucket_down(int(old["sel_req_kv"].shape[0]), headroom),
            }
            for direction in ("ingress", "egress"):
                od = old[direction]
                base[(direction, "target")] = host._bucket_down(
                    int(od["target_ns"].shape[0]) + 1, headroom
                )
                base[(direction, "peer")] = host._bucket_down(
                    int(od["peer_kind"].shape[0]), headroom
                )
                if had_tiers:
                    base[(direction, "tier")] = host._bucket_down(
                        int(old["tiers"][direction]["action"].shape[0]), headroom
                    )
            self._natural_buckets = base
        saved = headroom > 0 and any(
            needed > self._natural_buckets.get(key, needed)
            for key, needed in needed_buckets.items()
        )
        for k in _SEL_LEAVES:
            merged[k] = _fit(k, merged[k], old[k], host._SEL_PADS[k])
        for direction in ("ingress", "egress"):
            merged[direction] = _fit_slab_dict(
                direction, old[direction], merged[direction], host._DIRECTION_PADS
            )
            if had_tiers:
                merged["tiers"] = dict(merged.get("tiers", {}))
                merged["tiers"][direction] = _fit_slab_dict(
                    f"tiers.{direction}", old["tiers"][direction],
                    merged["tiers"][direction], host._TIER_PADS,
                )
        patch = self.main_patchset()

        def _stage_slab_dict(prefix: tuple, d: Dict) -> None:
            for k, v in d.items():
                if k == "port_spec":
                    for s, arr in v.items():
                        patch.stage_leaf(prefix + ("port_spec", s), arr)
                else:
                    patch.stage_leaf(prefix + (k,), v)

        for k in _SEL_LEAVES:
            patch.stage_leaf((k,), merged[k])
        for direction in ("ingress", "egress"):
            _stage_slab_dict((direction,), merged[direction])
            if had_tiers:
                _stage_slab_dict(("tiers", direction), merged["tiers"][direction])
        # past the CYCLONUS_SLAB_MAX_BYTES budget (default 6 GiB) the
        # full rebuild is the bounded path; checked BEFORE any host slab
        # is replaced, so Ineligible leaves the engine untouched
        if patch.staged_bytes > host._slab_max_bytes():
            raise Ineligible(
                f"rule-slab patch bytes {patch.staged_bytes} exceed the "
                "CYCLONUS_SLAB_MAX_BYTES budget"
            )
        for k in _SEL_LEAVES:
            old[k] = merged[k]
        for direction in ("ingress", "egress"):
            old[direction] = merged[direction]
        if had_tiers:
            old["tiers"] = merged["tiers"]
        self.flush(patch)
        # the zero-headroom engine has now rebuilt onto exactly this
        # patch's natural buckets
        self._natural_buckets = needed_buckets
        if saved:
            self.headroom_saves += 1
            ti.SERVE_HEADROOM_SAVES.inc()
        # the raw encoding and the derived host state follow
        enc.ingress = ingress
        enc.egress = egress
        enc.sel_req_kv, enc.sel_exp_op, enc.sel_exp_key, enc.sel_exp_vals = sel_arrays
        enc.n_selectors = n_sel
        if had_tiers:
            enc.tiers = tier_enc
            eng.tiers = tiers
        if pstats is not None:
            eng._partition_stats = pstats
        eng._has_ip_peers = bool(np.any(ingress.peer_kind == PEER_IP)) or bool(
            np.any(egress.peer_kind == PEER_IP)
        )
        if eng._class_state is not None:
            # the selector table changed: every signature's selpod block
            # is differently shaped — classes rebuild from scratch, with
            # the space resolved for the structure pin above (a function
            # of the spec set, which compression and bucketing keep);
            # staged here, past every Ineligible, so an aborted patch
            # never leaves a stale stash for a later rebuild
            self._resolved_cidr = (True, new_space)
            self.rebuild_class_state()

    # --- device application ----------------------------------------------

    def main_patchset(self) -> _PatchSet:
        """A patch set against the engine's device views (uploaded here
        if no call has made them yet, so the patch writes in place)."""
        return _PatchSet(self.engine._dev())

    def class_patchset(self) -> Optional[_PatchSet]:
        st = self.engine._class_state
        if st is None or st["device_tensors"] is None:
            return None  # the next use uploads the (updated) host set
        return _PatchSet(st["device_tensors"])

    def flush(self, patch: Optional[_PatchSet]) -> int:
        if patch is None:
            return 0
        nbytes = patch.flush()
        self.patch_bytes += nbytes
        if nbytes:
            ti.SERVE_PATCH_BYTES.inc(nbytes)
        return nbytes

    def finish(self) -> None:
        """Invalidate value-derived caches and refresh derived host
        state after a flushed patch."""
        eng = self.engine
        c = eng.encoding.cluster
        eng._unparseable_ips = [
            ip
            for ip, v4 in zip(c.pod_ips, c.pod_ip_valid)
            if not v4 and not host._parseable_ip(ip)
        ]
        eng.invalidate_after_patch()
