"""TorchPolicyEngine: the user-facing facade over the tensor compiler and
the verdict kernels, on one CUDA device.

Mirrors the reference's TpuPolicyEngine (cyclonus_tpu/engine/api.py):
the same constructor pipeline (encode -> dead-target compaction -> rule
partition compression -> pod classes -> ns-sort -> shape buckets), and
the same two entry points:

  * evaluate_grid         — the full N x N x Q truth tables;
  * evaluate_grid_counts  — allow counts over the full grid: the class-
                            compressed route when class state is on and
                            fits the device budget, else the dense route
                            over ns-sorted pods.

Two dtype plans, as in the reference (`pack`, CYCLONUS_PACK):

  * packed (the default): the counts kernels contract 32-per-word bitmaps
    — the weighted epilogue (K2) on the class route, the plain epilogue
    (K1) on the dense route;
  * dense (pack=False): int8 operands — the dense route runs the slab
    kernel (K6) when the slab plan holds (`slab`, CYCLONUS_PALLAS_SLAB=1),
    else the single-chunk (K4) or chunked (K5) kernel; the class route
    runs the tile loop's row sums.

backend="xla" runs the tile loop (tiled.evaluate_grid_counts) on either
plan.  With admin tiers (tiers=, a tiers.model.TierSet of
AdminNetworkPolicies and a BaselineAdminNetworkPolicy) both entry points
resolve the ANP -> NetworkPolicy -> BANP precedence lattice: the truth
tables in plain PyTorch, the packed counts in the tiered epilogue of the
packed counts kernel (K3), any number of tier rows; the dense plan has
no tiered kernel, so its tiered counts take the tile loop.

The reference's autotune, precompute cache, AOT cache and plan recording
are performance or compile machinery that change no result; the port
runs the default tile and a one-shot precompute, and its slab plan
engages only when forced.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import carry
from ..carry import resolve_device
from ..matcher.core import Policy
from . import dense_kernel, host, tiled
from .encoding import (
    PEER_IP,
    PolicyEncoding,
    compress_rule_axes,
    compute_pod_classes,
    encode_policy,
    gather_class_pod_rows,
    pack_enabled,
    packed_words,
)
from .kernel import evaluate_grid_kernel, gather_class_grids, grid_stats_kernel
from .packed_kernel import sum_partials, verdict_counts_packed, verdict_counts_packed_plain
from .tiled import _precompute, evaluate_grid_counts_classes, packed_tier


@dataclass(frozen=True)
class PortCase:
    """One distinct (resolved port, resolved port name, protocol) tuple."""

    port: int
    port_name: str
    protocol: str


class GridVerdict:
    """Verdict grids.  The tensors stay on the engine's device; numpy
    views materialise lazily on first access, and `gather` fetches
    individual cells with one device-side index."""

    def __init__(self, pod_keys, port_cases, ingress_dev, egress_dev, combined_dev):
        self.pod_keys: List[str] = pod_keys
        self.port_cases: List[PortCase] = port_cases
        # ingress [Q, N_dst, N_src]; egress/combined [Q, N_src, N_dst]
        self.ingress_dev = ingress_dev
        self.egress_dev = egress_dev
        self.combined_dev = combined_dev
        self._np: Dict[str, np.ndarray] = {}

    def _materialize(self, name: str) -> np.ndarray:
        if name not in self._np:
            self._np[name] = getattr(self, name + "_dev").cpu().numpy()
        return self._np[name]

    @property
    def ingress(self) -> np.ndarray:
        return self._materialize("ingress")

    @property
    def egress(self) -> np.ndarray:
        return self._materialize("egress")

    @property
    def combined(self) -> np.ndarray:
        return self._materialize("combined")

    def job_verdict(self, q_idx: int, src_idx: int, dst_idx: int):
        return (
            bool(self.ingress[q_idx, dst_idx, src_idx]),
            bool(self.egress[q_idx, src_idx, dst_idx]),
            bool(self.combined[q_idx, src_idx, dst_idx]),
        )

    def gather(self, triples: Sequence[Tuple[int, int, int]]) -> np.ndarray:
        """(ingress, egress, combined) for a batch of (q, src, dst)
        triples with one device gather and one small transfer."""
        idx = np.array(triples, dtype=np.int64).reshape(-1, 3)
        if idx.shape[0] == 0:
            return np.zeros((0, 3), dtype=bool)
        t = torch.from_numpy(idx).to(self.egress_dev.device)
        q, s, d = t[:, 0], t[:, 1], t[:, 2]
        out = torch.stack(
            [
                self.ingress_dev[q, d, s],
                self.egress_dev[q, s, d],
                self.combined_dev[q, s, d],
            ],
            dim=1,
        )
        return out.cpu().numpy()

    def allow_stats(self) -> Dict[str, float]:
        """Mean allow rate per grid, computed on the device."""
        if self.ingress_dev.shape[0] == 0:
            return {"ingress": 0.0, "egress": 0.0, "combined": 0.0}
        stats = grid_stats_kernel(
            self.ingress_dev, self.egress_dev, self.combined_dev
        ).cpu().numpy()
        return {
            "ingress": float(stats[0]),
            "egress": float(stats[1]),
            "combined": float(stats[2]),
        }


class TorchPolicyEngine:
    """Compile once per (policy set, cluster state); evaluate many port
    cases.  Pods are (namespace, name, labels, ip) tuples.

    `device` None means the current CUDA device, and raises when there is
    none; pass device="cpu" to run on the CPU.  compact/class_compress/
    pack/slab override the CYCLONUS_COMPACT / CYCLONUS_CLASS_COMPRESS /
    CYCLONUS_PACK / CYCLONUS_PALLAS_SLAB env defaults (None = env): pack
    False selects the dense dtype plan, slab "1" forces the slab kernel
    under it.  `tiers` (a
    tiers.model.TierSet) layers AdminNetworkPolicy / BaselineAdmin-
    NetworkPolicy precedence tiers over the policies; absent or empty, the
    tensor set is byte-identical to the tier-free engine's."""

    def __init__(
        self,
        policy: Policy,
        pods: Sequence[Tuple[str, str, Dict[str, str], str]],
        namespaces: Dict[str, Dict[str, str]],
        *,
        device=None,
        compact: Optional[bool] = None,
        class_compress: Optional[str] = None,
        tiers=None,
        pack: Optional[bool] = None,
        slab: Optional[str] = None,
    ):
        self.device = resolve_device(device)
        t0 = time.perf_counter()
        self.tiers = tiers if tiers else None
        if self.tiers is not None:
            self.tiers.validate()
        self.encoding: PolicyEncoding = encode_policy(
            policy, pods, namespaces, tiers=self.tiers
        )
        cluster = self.encoding.cluster
        tensors = host._build_tensors(self.encoding)
        # one O(S*N) host selector pass serves dead-target compaction and
        # the pod-class signatures
        selpod = None
        compact_on = (
            host._compaction_enabled(tensors) if compact is None else bool(compact)
        )
        if compact_on:
            selpod = host._selector_pod_matches_host(tensors)
            tensors = host._compact_dead_targets(tensors, selpod=selpod)
        mode = (
            host._class_compress_mode()
            if class_compress is None
            else str(class_compress).lower()
        )
        classes = None
        ctensors = None
        if mode != "0":
            for direction in ("ingress", "egress"):
                tensors[direction], _stats = compress_rule_axes(tensors[direction])
            classes = self._maybe_classify(tensors, selpod, mode)
            if classes is not None:
                ctensors = host._bucket_tensors(
                    host._sort_targets_by_ns(
                        gather_class_pod_rows(tensors, classes.class_rep)
                    )
                )
        tensors = host._bucket_tensors(host._sort_targets_by_ns(tensors))
        self._init_state(
            tensors,
            pod_keys=cluster.pod_keys,
            port_names=cluster.vocab.port_name,
            protocols=cluster.vocab.proto,
            classes=classes,
            ctensors=ctensors,
            pack=pack,
            slab=slab,
        )
        # the compaction-time selector pass, reused by the slab plan
        self._selpod_prebucket = selpod
        self._has_ip_peers = bool(
            np.any(self.encoding.ingress.peer_kind == PEER_IP)
            or np.any(self.encoding.egress.peer_kind == PEER_IP)
        )
        # pod_ip_valid=True already proves parseability, so only the
        # residue — IPv6 pods and garbage — pays ipaddress.ip_address
        self._unparseable_ips = [
            ip
            for ip, v4 in zip(cluster.pod_ips, cluster.pod_ip_valid)
            if not v4 and not host._parseable_ip(ip)
        ]
        self.encode_s = time.perf_counter() - t0

    @staticmethod
    def _maybe_classify(tensors: Dict, selpod, mode: str):
        """PodClasses, or None: bucket pods into label-equivalence classes
        when compression is forced (mode "1") or worth it (auto: above the
        pod floor with a real reduction).  Reuses the selector pass
        dead-target compaction paid for; when compaction's work budget
        skipped it, auto mode skips classes too."""
        n = int(tensors["pod_ns_id"].shape[0])
        if n == 0 or n >= host._CLASS_MAX_PODS_EXACT:
            return None
        if mode != "1" and n < host._class_auto_min_pods():
            return None
        if selpod is None:
            if mode != "1":
                return None
            selpod = host._selector_pod_matches_host(tensors)
        pc = compute_pod_classes(tensors, selpod)
        if mode != "1" and pc.n_classes > int(0.9 * n):
            return None  # no real reduction
        return pc

    @classmethod
    def from_tensors(
        cls,
        tensors: Dict,
        *,
        pod_keys: Sequence[str],
        port_names: Dict[str, int],
        protocols: Dict[str, int],
        classes=None,
        ctensors: Optional[Dict] = None,
        device=None,
        pack: Optional[bool] = None,
        slab: Optional[str] = None,
    ) -> "TorchPolicyEngine":
        """An engine over an already built, bucketed numpy tensor dict —
        e.g. the reference engine's `_tensors` and its class state's
        `classes` / `ctensors` — skipping the host pipeline.  port_names
        and protocols are the encoding vocabulary's name -> id maps (the
        port cases resolve through them); `classes` is any object with
        n_classes, class_of_pod and class_size."""
        self = cls.__new__(cls)
        self.device = resolve_device(device)
        self.encoding = None
        self.tiers = None  # a tiered dict carries its slabs under "tiers"
        self._init_state(
            tensors,
            pod_keys=list(pod_keys),
            port_names=dict(port_names),
            protocols=dict(protocols),
            classes=classes,
            ctensors=ctensors,
            pack=pack,
            slab=slab,
        )
        self._has_ip_peers = any(
            bool(np.any(tensors[d]["peer_kind"] == PEER_IP))
            for d in ("ingress", "egress")
        )
        self._unparseable_ips = []
        self.encode_s = 0.0
        return self

    def _init_state(
        self, tensors, *, pod_keys, port_names, protocols, classes, ctensors, pack, slab
    ):
        self._tensors = tensors
        self._pod_keys = list(pod_keys)
        self._port_names = port_names
        self._protocols = protocols
        # the dtype plan: packed words (True) or dense int8 operands
        self._pack = pack_enabled() if pack is None else bool(pack)
        self._slab_mode = host._slab_mode(slab)
        self._slab_plan_state = "unset"  # the slab windows, planned at first use
        self._selpod_prebucket = None
        self._device_tensors = None
        self._pod_perm = None  # ns-order pod permutation of the dense counts route
        self._pod_perm_host = None
        self._class_state = None
        self._tier_resolve_s = None
        if classes is not None:
            n = len(self._pod_keys)
            cb = int(ctensors["pod_ns_id"].shape[0])
            self._class_state = {
                "classes": classes,
                "ctensors": ctensors,
                "device_tensors": None,
                "class_of": None,
                # the device bytes the class route pins (class map +
                # weights + the class tensor set), charged against the
                # device budget exactly as the reference charges them
                "aux_bytes": int(
                    n * 4 + cb * 4 + sum(a.nbytes for a in host._np_leaves(ctensors))
                ),
            }

    @property
    def n_pods(self) -> int:
        return len(self._pod_keys)

    @property
    def pod_keys(self) -> List[str]:
        return self._pod_keys

    def tier_stats(self) -> Dict:
        """The precedence-tier summary: whether the lattice is active, the
        ANP object count, the flat rule-row count (real rows, both
        directions), whether a baseline policy is present, and the host
        wall-clock of the last tiered evaluate_grid (resolve_s; None until
        one ran).  An engine built from a tensor dict has no TierSet, so
        it reports no ANP objects and no baseline."""
        tiers = self._tensors.get("tiers")
        rows = 0
        if tiers is not None:
            rows = sum(int((tiers[d]["action"] > 0).sum()) for d in ("ingress", "egress"))
        return {
            "active": tiers is not None,
            "anp_count": len(self.tiers.anps) if self.tiers is not None else 0,
            "rule_rows": rows,
            "banp": self.tiers is not None and self.tiers.banp is not None,
            "resolve_s": self._tier_resolve_s,
        }

    def pod_classes(self):
        """The PodClasses of the class state, or None when compression is
        off for this engine."""
        st = self._class_state
        return st["classes"] if st is not None else None

    def _dev(self) -> Dict:
        if self._device_tensors is None:
            self._device_tensors = carry.tensors_from_reference(self._tensors, self.device)
        return self._device_tensors

    def _class_dev(self) -> Dict:
        st = self._class_state
        if st["device_tensors"] is None:
            st["device_tensors"] = carry.tensors_from_reference(st["ctensors"], self.device)
        return st["device_tensors"]

    def _port_case_arrays(self, cases: Sequence[PortCase]):
        q_port = np.array([c.port for c in cases], dtype=np.int32)  # shape: (Q,) int32
        q_name = np.array(
            [self._port_names.get(c.port_name, -1) for c in cases], dtype=np.int32
        )  # shape: (Q,) int32; sentinel: -1=unnamed
        # protocols unseen at compile time can match no spec: id -1 (pads
        # are -2, real ids >= 0)
        q_proto = np.array(
            [self._protocols.get(c.protocol, -1) for c in cases], dtype=np.int32
        )
        return q_port, q_name, q_proto

    def _with_cases(self, tensors: Dict, cases: Sequence[PortCase]) -> Dict:
        t = dict(tensors)
        for k, a in zip(("q_port", "q_name", "q_proto"), self._port_case_arrays(cases)):
            t[k] = carry.to_torch(a, self.device)
        return t

    def _check_ips(self) -> None:
        if self._has_ip_peers and self._unparseable_ips:
            # The oracle raises when an IP peer matcher meets an unparseable
            # pod IP (kube/ipaddr.py); a grid evaluation hits every pair, so
            # raise with the same class of error.
            raise ValueError(
                f"unable to parse IP(s) {self._unparseable_ips[:3]!r} "
                f"while IPBlock peers are present"
            )

    # --- truth tables ----------------------------------------------------

    def evaluate_grid(self, cases: Sequence[PortCase]) -> GridVerdict:
        """The full N x N x Q verdict grid, on the engine's device."""
        self._check_ips()
        n = self.n_pods
        if not cases:
            empty = torch.zeros((0, n, n), dtype=torch.bool, device=self.device)
            return GridVerdict(self.pod_keys, [], empty, empty.clone(), empty.clone())
        t0 = time.perf_counter()
        if self._class_state is not None:
            grid = self._evaluate_grid_classes(cases)
        else:
            out = evaluate_grid_kernel(self._with_cases(self._dev(), cases), pack=self._pack)
            # bucketing pads the pod axis; strip the pad rows
            grid = GridVerdict(
                self.pod_keys,
                list(cases),
                out["ingress"][:, :n, :n],
                out["egress"][:, :n, :n],
                out["combined"][:, :n, :n],
            )
        if "tiers" in self._tensors:
            self._tier_resolve_s = time.perf_counter() - t0
        return grid

    def _evaluate_grid_classes(self, cases: Sequence[PortCase]) -> GridVerdict:
        """Class-compressed grid: the C x C x Q class grid, broadcast back
        to pod axes with the gather epilogue."""
        st = self._class_state
        if st["class_of"] is None:
            st["class_of"] = carry.to_torch(st["classes"].class_of_pod, self.device)
        out = gather_class_grids(
            evaluate_grid_kernel(self._with_cases(self._class_dev(), cases), pack=self._pack),
            st["class_of"],
        )
        return GridVerdict(
            self.pod_keys, list(cases), out["ingress"], out["egress"], out["combined"]
        )

    # --- full-grid counts ------------------------------------------------

    def _class_counts_eligible(self, q: int) -> bool:
        """The class counts route must fit the device budget it protects:
        aux/index tensors + the class precompute + row sums, estimated on
        the host before any dispatch."""
        st = self._class_state
        if st is None:
            return False
        ct = st["ctensors"]
        cb = int(ct["pod_ns_id"].shape[0])
        t = sum(int(ct[d]["target_ns"].shape[0]) for d in ("ingress", "egress"))
        if self._pack:
            # packed plan: tallow_pk int32 [W, Cb, Q] + tmatch_pk [W, Cb]
            # + the bool tmatch
            w = sum(packed_words(int(ct[d]["target_ns"].shape[0])) for d in ("ingress", "egress"))
            est = st["aux_bytes"] + cb * (4 * w * (q + 1) + t) + cb * q * 12
        else:
            # tallow bf16 [T, Cb, Q] per direction + tmatch + f32 row sums
            est = st["aux_bytes"] + t * cb * (2 * q + 1) + cb * q * 12
        return est <= host._slab_max_bytes()

    def evaluate_grid_counts(
        self, cases: Sequence[PortCase], block: int = 1024, backend: Optional[str] = None
    ) -> Dict[str, int]:
        """Allow counts over the full N x N x Q grid (ingress, egress,
        combined and the cell count), routed as the reference routes
        them: the class-compressed route when class state is on and fits
        the device budget, else the dense route.

        backend "pallas" (the default) runs the hand-written counts
        kernels; "xla" runs the tile loop (`block` source rows per tile,
        the class route's row sums included).  The dense dtype plan has no
        tiered kernel: tiered counts there take the tile loop, and an
        explicit backend="pallas" raises."""
        explicit = backend is not None
        if backend is None:
            backend = "pallas"
        if backend not in ("xla", "pallas"):
            raise ValueError(f"unknown counts backend {backend!r} (want 'xla' or 'pallas')")
        if "tiers" in self._tensors and backend == "pallas" and not self._pack:
            if explicit:
                raise ValueError(
                    "counts backend 'pallas' cannot evaluate the precedence-tier "
                    "lattice under the dense dtype plan (pack off); use "
                    "backend='xla' or backend=None (auto)"
                )
            backend = "xla"
        self._check_ips()
        n = self.n_pods
        if not cases or n == 0:
            return {"ingress": 0, "egress": 0, "combined": 0, "cells": 0}
        if self._class_counts_eligible(len(cases)):
            return self._counts_classes(
                cases, kernel="pallas" if self._pack and backend == "pallas" else "xla",
                block=block,
            )
        if backend == "pallas":
            return self._counts_dense(cases)
        return tiled.evaluate_grid_counts(
            self._with_host_cases(cases), n, block=block, pack=self._pack, device=self.device
        )

    def _with_host_cases(self, cases: Sequence[PortCase]) -> Dict:
        """The host (numpy) tensors with the port-case arrays."""
        t = dict(self._tensors)
        t["q_port"], t["q_name"], t["q_proto"] = self._port_case_arrays(cases)
        return t

    def _counts_classes(self, cases, kernel: str, block: int = 1024) -> Dict[str, int]:
        st = self._class_state
        pc = st["classes"]
        return evaluate_grid_counts_classes(
            self._with_cases(self._class_dev(), cases),
            pc.n_classes,
            pc.class_size,
            self.n_pods,
            block=block,
            pack=self._pack,
            kernel=kernel,
        )

    def _dense_counts_tensors(self, cases: Sequence[PortCase]) -> Dict:
        """The device tensors of the dense counts route: pods in
        namespace order (bucketing pads, ns id -1, kept LAST — the
        kernel's validity mask assumes the real pods occupy the first n
        rows), host-evaluated ip columns permuted alike.  Counts are
        invariant under the permutation."""
        if self._pod_perm is None:
            ns = self._tensors["pod_ns_id"]
            key = np.where(ns < 0, np.iinfo(np.int32).max, ns)
            self._pod_perm_host = np.argsort(key, kind="stable")
            self._pod_perm = torch.from_numpy(self._pod_perm_host).to(self.device)
        perm = self._pod_perm
        t = dict(self._dev())
        for k in host._POD_KEYS:
            t[k] = t[k][perm]
        for direction in ("ingress", "egress"):
            if "host_ip_match" in t[direction]:
                d = dict(t[direction])
                d["host_ip_match"] = d["host_ip_match"][:, perm]
                t[direction] = d
        return self._with_cases(t, cases)

    def _slab_plan(self) -> Optional[Dict]:
        """The slab windows of the dense route (host._slab_plan), planned
        once per engine: None unless the slab mode is "1" and the plan
        holds."""
        if self._slab_plan_state == "unset":
            plan = None
            if self._slab_mode == "1":
                aux = self._class_state["aux_bytes"] if self._class_state else 0
                plan = host._slab_plan(
                    self._tensors, self._pod_perm_host, self.n_pods, aux,
                    selpod=self._selpod_prebucket,
                )
            self._slab_plan_state = plan
        return self._slab_plan_state

    def _counts_dense(self, cases, plain: bool = False) -> Dict[str, int]:
        """The dense route: the packed counts kernel (K1, tiered K3) under
        the packed plan; under the dense plan the slab kernel (K6) when
        the slab plan holds and its bytes fit the budget at this case
        count, else K4/K5.  plain=True runs each kernel's plain version."""
        q = len(cases)
        tensors = self._dense_counts_tensors(cases)
        if self._pack:
            pre = _precompute(tensors, True)
            e, ig = pre["egress"], pre["ingress"]
            fn = verdict_counts_packed_plain if plain else verdict_counts_packed
            partials = fn(
                e["tmatch_pk"], e["has_target"], e["tallow_pk"],
                ig["tmatch_pk"], ig["has_target"], ig["tallow_pk"],
                n_pods=self.n_pods,
                tier=packed_tier(pre),
            )
            return sum_partials(partials, q, self.n_pods)
        if "tiers" in self._tensors:
            raise ValueError("the dense dtype plan has no tiered counts kernel")
        pre = _precompute(tensors, False)
        e, ig = pre["egress"], pre["ingress"]
        args = (
            e["tmatch"], e["has_target"], e["tallow_bf"],
            ig["tmatch"], ig["has_target"], ig["tallow_bf"],
        )
        plan = self._slab_plan()
        aux = self._class_state["aux_bytes"] if self._class_state else 0
        if plan is not None and q * plan["bytes_per_case"] + aux <= plan["budget"]:
            ops = dense_kernel.slab_operands(
                *args, plan["egress"], plan["ingress"], self.n_pods, w=plan["w"]
            )
            partials = dense_kernel.verdict_counts_slab_from_ops(ops, plain=plain)
        else:
            partials = dense_kernel.verdict_counts(*args, n_pods=self.n_pods, plain=plain)
        return sum_partials(partials, q, self.n_pods)
