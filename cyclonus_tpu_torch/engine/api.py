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

and, for point queries, evaluate_pairs (the verdicts of K (src, dst) pod
pairs, no grid) and iter_grid_blocks (the grid streamed to the host in
blocks of source rows); for the analysis layer, firing_components (each
rule's firing-mask factors on the raw encoding).

On a pod-axis mesh (engine/sharded.py: `mesh` None is
sharded.default_mesh(device), every visible card, or 8 logical shards
on the engine's device): evaluate_grid_sharded (ring or all-gather
schedule), evaluate_grid_counts_sharded (the counts kernel per shard, or
the tile loop; the class route splits its class axis),
evaluate_grid_counts_ring, its pipelined twin mesh_counts_pipelined_eval_s
and evaluate_grid_counts_ring2d.  These read the host tensors and never
touch the steady state's pins or the ns-order permutation.

The class signature's CIDR dimension takes the TSS/LPM partition
signature (engine/cidrspace.py, on the engine's device above its work
floor) when the stage resolves (`cidr_tss`, CYCLONUS_CIDR_TSS: above 256
distinct CIDR specs in auto mode), else one bit per distinct spec;
cidr_stats() reports it.

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

Steady state, as the reference's (TpuPolicyEngine._counts_pallas_dispatch):
the first counts call of a case set on the kernel route runs fused
(precompute, operands, kernel); a second call of the same set runs split
and pins on the device the operands the kernel reads (and the
precompute, while the slab operands may still be gathered from it);
every later call of that set launches only the counts kernel from the
pin.  Two calls in a row of other sets evict the pin.  The reference's
byte gate decides (_pre_bytes_estimate, _PRE_CACHE_MAX_BYTES), so a set
it would not pin is not pinned here either; CYCLONUS_PRE_CACHE=0 runs
every call fused.  Under the dense plan the slab "auto" mode plans on a
CUDA device and, at the first steady-state call, times K6 against K4/K5
from the same pin and keeps the faster (_autotune_slab, persisted by
engine/autotune.py).  The reference runs its slab candidate in a bounded
thread and falls back to the default kernel when it fails or hangs, a
guard for a wedged remote TPU compile; here K6 lives in the library that
K4/K5 come from, so a candidate that fails raises like any kernel.

The verdict service (cyclonus_tpu_torch/serve) keeps an engine resident
and patches its host tensors and the device views of them in place
(`slab_headroom` reserves rule-slab rows for its policy patches);
invalidate_after_patch then drops what was derived from the old values.
A patch that wrote pod rows alone calls invalidate_after_pod_patch
instead: under the packed plan the pin stays, and the next counts call
of its case set recomputes only the patched pods' columns of the
operands and writes them into the pin before it launches from it
(_patch_pin, span engine.pre_patch), since the precompute is local to
each pod's column given that pod's own row.  TRANSFERS counts the
uploads of a whole tensor set, so a caller can show that a patch moved
no untouched leaf.

The reference's packed tile autotune and AOT cache are compile
machinery that change no result; the port has one tile shape per kernel
and nothing to compile ahead.  Its dispatch records the reference's
routes at the reference's points (engine/planspec.py, armed by
CYCLONUS_PLANHARNESS=1) and resolves the tiers x backend decision off the
same compatibility matrix.

Telemetry (cyclonus_tpu_torch/telemetry) hooks in at the reference's
steps with the reference's names: the spans engine.encode (with
engine.compact, engine.partition, engine.classify nested),
engine.device_put, engine.slab_plan, engine.autotune, engine.dispatch,
engine.execute, engine.dispatch_sharded and grid.fetch; one eval_flight
per evaluation (paths grid, grid.classes, pairs, counts.pallas, and the
tile loop's and the mesh's in tiled.py and sharded.py); the cache,
class, slab and autotune instruments.  Every hook is host-side: the
flight of a counts call ends at the call's own readback, and a grid's
flight times the enqueue only (dispatch_only).  The reference's steps
that the port does not have (the unpack program, AOT adoption, program
compiles) have no phase.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import carry
from ..carry import resolve_device
from ..matcher.core import Policy
from ..telemetry import instruments as ti
from ..utils import cachekeys, guards
from ..utils.tracing import phase
from . import autotune, cidrspace, dense_kernel, host, packed_kernel, planspec, sharded, tiled
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
from .kernel import (
    evaluate_grid_kernel,
    gather_class_grids,
    grid_stats_kernel,
    rule_firing_kernel,
)
from .packed_kernel import counts_from_packed_ops, packed_operands, sum_partials
from .tiled import (
    _class_rowsums_kernel,
    _precompute,
    class_counts_finish,
    class_rowsums,
    class_rowsums_plan,
    evaluate_grid_counts_classes,
    ip_legs,
    packed_tier,
)

#: the most bytes the steady state pins on the device for one case set
#: (the reference's _PRE_CACHE_MAX_BYTES): past it, recomputing the
#: precompute on every call beats holding it
_PRE_CACHE_MAX_BYTES = 2 << 30

#: uploads of a whole engine tensor set to the device, counted where the
#: engine makes them: "tensors" the main set (the resident views, and the
#: padded copy iter_grid_blocks streams from), "class_tensors" the class
#: representatives' set
TRANSFERS: Dict[str, int] = {"tensors": 0, "class_tensors": 0}


def _pre_cache_enabled() -> bool:
    """Repeat counts calls of one case set run from pinned operands
    (CYCLONUS_PRE_CACHE=0 opts out); read at each call."""
    return os.environ.get("CYCLONUS_PRE_CACHE", "1") != "0"


def _tensor_bytes(tree) -> int:
    """Device bytes of the tensors in a nested dict."""
    if isinstance(tree, dict):
        return sum(_tensor_bytes(v) for v in tree.values())
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return 0


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
            # the copy waits for the device: it absorbs whatever of the
            # grid's execution the dispatch left running (engine.dispatch)
            with phase("grid.fetch"):
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


@guards.checked
class TorchPolicyEngine:
    """Compile once per (policy set, cluster state); evaluate many port
    cases.  Pods are (namespace, name, labels, ip) tuples.

    `device` None means the current CUDA device, and raises when there is
    none; pass device="cpu" to run on the CPU.  compact/class_compress/
    pack/slab override the CYCLONUS_COMPACT / CYCLONUS_CLASS_COMPRESS /
    CYCLONUS_PACK / CYCLONUS_PALLAS_SLAB env defaults (None = env): pack
    False selects the dense dtype plan, slab "1" forces the slab kernel
    under it, "auto" lets the autotune pick it on a CUDA device, "0"
    turns it off.  `tiers` (a
    tiers.model.TierSet) layers AdminNetworkPolicy / BaselineAdmin-
    NetworkPolicy precedence tiers over the policies; absent or empty, the
    tensor set is byte-identical to the tier-free engine's.

    The gathered slab operands are guarded by _slab_lock, as the
    reference's are: the operand build checks the slab choice and fills
    the cache under the lock that a rejection of the slab kernel clears
    it under, so a rejected kernel keeps no operands pinned
    (torch_tools/raceharness.py, scenario engine_cache).

    `slab_headroom` steps the rule-slab row buckets that many buckets up
    (host._bucket_tensors): 0 for batch engines, CYCLONUS_SERVE_HEADROOM
    for the verdict service's."""

    # the guarded-by contract (tools/locklint.py statically; under
    # CYCLONUS_GUARD_CHECK=1 guards.Guarded asserts it at runtime)
    _slab_ops_cache = guards.Guarded("_slab_lock")

    def __init__(
        self,
        policy: Policy,
        pods: Sequence[Tuple[str, str, Dict[str, str], str]],
        namespaces: Dict[str, Dict[str, str]],
        *,
        device=None,
        compact: Optional[bool] = None,
        class_compress: Optional[str] = None,
        cidr_tss: Optional[str] = None,
        tiers=None,
        pack: Optional[bool] = None,
        slab: Optional[str] = None,
        slab_headroom: int = 0,
    ):
        self.device = resolve_device(device)
        t0 = time.perf_counter()
        # overrides CYCLONUS_CIDR_TSS for the TSS/LPM CIDR stage of the
        # class signature (engine/cidrspace.py); None = env
        self._opt_cidr_tss = cidr_tss
        self._slab_headroom = max(0, int(slab_headroom or 0))
        self.tiers = tiers if tiers else None
        if self.tiers is not None:
            self.tiers.validate()
        with phase("engine.encode"):
            # the compaction-time selector pass, reused by the slab plan
            self._selpod_prebucket = self._build(
                policy, pods, namespaces, compact, class_compress, pack, slab
            )
        cluster = self.encoding.cluster
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

    def _build(self, policy, pods, namespaces, compact, class_compress, pack, slab):
        """The constructor pipeline: encode -> dead-target compaction ->
        rule partition compression -> pod classes -> ns-sort -> shape
        buckets.  Returns the compaction's selector pass (None when
        compaction was off)."""
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
            with phase("engine.compact"):
                selpod = host._selector_pod_matches_host(tensors)
                tensors = host._compact_dead_targets(tensors, selpod=selpod)
        mode = (
            host._class_compress_mode()
            if class_compress is None
            else str(class_compress).lower()
        )
        classes = None
        ctensors = None
        space = None
        classify_s = None
        # the rule-axis partition stats; None when compression is off
        # (the service's policy patch compresses exactly when the build did)
        self._partition_stats = None
        if mode != "0":
            self._partition_stats = {}
            with phase("engine.partition"):
                for direction in ("ingress", "egress"):
                    tensors[direction], self._partition_stats[direction] = compress_rule_axes(
                        tensors[direction]
                    )
            classes, space, classify_s = self._maybe_classify(tensors, selpod, mode)
            if classes is not None:
                ctensors = host._bucket_tensors(
                    host._sort_targets_by_ns(
                        gather_class_pod_rows(tensors, classes.class_rep)
                    ),
                    headroom=self._slab_headroom,
                )
        tensors = host._bucket_tensors(
            host._sort_targets_by_ns(tensors), headroom=self._slab_headroom
        )
        self._init_state(
            tensors,
            pod_keys=cluster.pod_keys,
            port_names=cluster.vocab.port_name,
            protocols=cluster.vocab.proto,
            classes=classes,
            ctensors=ctensors,
            pack=pack,
            slab=slab,
            cidr=space,
            classify_s=classify_s,
        )
        return selpod

    def _maybe_classify(self, tensors: Dict, selpod, mode: str):
        """(PodClasses, CidrSpace or None, classify seconds), or (None,
        None, None): bucket pods into label-equivalence classes when
        compression is forced (mode "1") or worth it (auto: above the pod
        floor with a real reduction).  Reuses the selector pass dead-target compaction paid
        for; when compaction's work budget skipped it, auto mode skips
        classes too.  When the TSS/LPM CIDR stage resolves
        (CYCLONUS_CIDR_TSS gate, distinct-spec floor, device budget), the
        signature's CIDR dimension rides the [K] int32 partition
        signature on the engine's device instead of per-spec bits; None
        is the dense bit path, byte-identical to the pre-TSS signature."""
        n = int(tensors["pod_ns_id"].shape[0])
        if n == 0 or n >= host._CLASS_MAX_PODS_EXACT:
            return None, None, None
        if mode != "1" and n < host._class_auto_min_pods():
            return None, None, None
        if selpod is None:
            if mode != "1":
                return None, None, None
            selpod = host._selector_pod_matches_host(tensors)
        space = cidrspace.resolve(
            tensors, mode=self._opt_cidr_tss, n_pods=n, device=self.device
        )
        t0 = time.perf_counter()
        with phase("engine.classify"):
            pc = compute_pod_classes(tensors, selpod, cidr=space)
        classify_s = time.perf_counter() - t0
        if mode != "1" and pc.n_classes > int(0.9 * n):
            return None, None, None  # no real reduction
        return pc, space, classify_s

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
        self._slab_headroom = 0
        self._opt_cidr_tss = None
        self._partition_stats = None
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
        self, tensors, *, pod_keys, port_names, protocols, classes, ctensors, pack, slab,
        cidr=None, classify_s=None,
    ):
        self._tensors = tensors
        # the encoding's own list when built from one: the verdict
        # service's pod patches edit it in place
        self._pod_keys = pod_keys
        self._port_names = port_names
        self._protocols = protocols
        # the dtype plan: packed words (True) or dense int8 operands
        self._pack = pack_enabled() if pack is None else bool(pack)
        self._slab_mode = host._slab_mode(slab)
        # The trailing `# derived-from:` declarations below are the
        # cache-coherence contract tools/cachelint.py CC002 enforces, as
        # on the reference's engine: a VALUE token means
        # invalidate_after_patch must reset the attribute after an
        # in-place patch of the tensors; `patched` marks state the serve
        # patch path maintains itself; `shapes` marks state fixed by the
        # shapes alone.  tests/test_torch_lint.py holds every cache set
        # here to a declaration.
        # the slab windows, planned at first use
        self._slab_plan_state = "unset"  # derived-from: buffer (window proof)
        self._selpod_prebucket = None  # derived-from: buffer (selector x pod match)
        self._device_tensors = None  # derived-from: patched (the patch writes the views)
        # ns-order pod permutation of the dense counts route
        self._pod_perm = None  # derived-from: pod-rows (ns-order perm)
        self._pod_perm_host = None  # derived-from: pod-rows
        # how the dense precompute resolves each direction's peer rows
        # (tiled.ip_legs): rule rows alone, so a patch of pod rows keeps it
        self._ip_legs = None  # derived-from: rule-rows (ip-peer partitions)
        self._class_state = None  # derived-from: patched (rebuild_class_state)
        self._tier_resolve_s = None
        # the steady state of the dense counts route (module docstring):
        # the pinned case set (key, {"ops": the kernel's operands, "pre":
        # the precompute while the slab operands may be gathered from
        # it}), the gathered slab operands (key, ops), the misses since
        # the pin was last hit, the key the byte check declined, and the
        # key of the last fused call
        self._pre_cache = None  # derived-from: buffer (cases key + pinned operands)
        # the pod rows patched since the pin last launched, whose columns
        # the next call of its set recomputes (invalidate_after_pod_patch)
        self._pre_cache_dirty = set()  # derived-from: buffer (pod rows)
        self._slab_lock = guards.lock()
        with self._slab_lock:
            self._slab_ops_cache = None  # derived-from: buffer (gathered ops)
        self._pre_cache_misses = 0  # derived-from: buffer
        self._pre_cache_declined = None  # derived-from: buffer (declined key)
        self._last_counts_key = None  # derived-from: buffer
        # the slab kernel: None until the autotune (or a persisted winner,
        # or slab "1") decides, then True or False
        self._slab_choice = None  # derived-from: buffer (re-timed)
        self._autotune_stats = None
        self._steady_counts = {"hits": 0, "misses": 0, "precomputes": 0,
                               "autotune_searches": 0, "patches": 0, "patched_columns": 0}
        # the dense route's first call ran (the reference's counts programs)
        self._counts_setup = False  # derived-from: shapes
        self._last_counts_mode = None
        if classes is not None:
            n = len(self._pod_keys)
            cb = int(ctensors["pod_ns_id"].shape[0])
            self._class_state = {
                "classes": classes,
                "ctensors": ctensors,
                "device_tensors": None,
                "class_of": None,
                "ratio": n / max(classes.n_classes, 1),
                # the device bytes the class route pins (class map +
                # weights + the class tensor set + the TSS partition
                # tensors), charged against the device budget exactly as
                # the reference charges them
                "aux_bytes": int(
                    n * 4 + cb * 4 + sum(a.nbytes for a in host._np_leaves(ctensors))
                    + (cidr.nbytes() if cidr is not None else 0)
                ),
                # the TSS partition map the signatures were taken with
                # (None: the dense per-spec bits), and the host seconds of
                # the classify (signatures, LPM stage included, and unique)
                "cidr": cidr,
                "classify_s": classify_s,
            }
            ti.CLASS_PODS.set(n)
            ti.CLASS_COUNT.set(classes.n_classes)
            ti.CLASS_RATIO.set(self._class_state["ratio"])
            ti.CLASS_AUX_BYTES.set(self._class_state["aux_bytes"])

    @property
    def n_pods(self) -> int:
        return len(self._pod_keys)

    @property
    def pod_keys(self) -> List[str]:
        return self._pod_keys

    def pod_index(self) -> Dict[str, int]:
        return {k: i for i, k in enumerate(self.pod_keys)}

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

    def class_compression_stats(self) -> Dict:
        """The grid-compression summary: whether class state is on, pods,
        classes, the pods-per-class ratio, the signature and device bytes,
        and the rule-axis partition stats."""
        st = self._class_state
        if st is None:
            return {"active": False, "pods": self.n_pods, "classes": None,
                    "ratio": None, "partitions": self._partition_stats}
        pc = st["classes"]
        return {
            "active": True,
            "pods": self.n_pods,
            "classes": pc.n_classes,
            "ratio": round(st["ratio"], 4),
            "signature_bytes": pc.signature_bytes,
            "aux_bytes": st["aux_bytes"],
            "partitions": self._partition_stats,
        }

    def cidr_stats(self) -> Dict:
        """The TSS/LPM CIDR pre-classification summary: whether the stage
        is active, the distinct spec/atom/partition counts, the last LPM
        stage wall-clock and whether it ran on the device, the partition-
        tensor bytes charged to the device budget, and (the port's own
        key) the seconds of the classify that took the signatures."""
        st = self._class_state
        space = st.get("cidr") if st is not None else None
        if space is None:
            return {
                "active": False,
                "distinct_cidrs": None,
                "atoms": None,
                "partitions": None,
                "lpm_s": None,
                "device": None,
                "bytes": 0,
            }
        return {
            "active": True,
            "distinct_cidrs": space.n_specs,
            "atoms": space.n_atoms,
            "partitions": space.n_partitions,
            "max_bucket": space.max_bucket,
            "host_rows": space.n_host_rows,
            "lpm_s": space.last_lpm_s,
            "device": space.last_device,
            "bytes": space.nbytes(),
            "classify_s": st.get("classify_s"),
        }

    def _dev(self) -> Dict:
        """The device views of the host tensors: uploaded whole once,
        then patched in place by the verdict service."""
        if self._device_tensors is None:
            with phase("engine.device_put"):
                self._device_tensors = carry.tensors_from_reference(self._tensors, self.device)
            TRANSFERS["tensors"] += 1
        return self._device_tensors

    def _class_dev(self) -> Dict:
        st = self._class_state
        if st["device_tensors"] is None:
            with phase("engine.device_put"):
                st["device_tensors"] = carry.tensors_from_reference(st["ctensors"], self.device)
            TRANSFERS["class_tensors"] += 1
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
            planspec.record("grid.dense")
            # dispatch-only timing: the kernels are enqueued on the stream;
            # the device time lands in grid.fetch / allow_stats
            with ti.eval_flight("grid", n, len(cases), dispatch_only=True):
                tensors = self._with_cases(self._dev(), cases)
                with phase("engine.dispatch"):
                    out = evaluate_grid_kernel(tensors, pack=self._pack)
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
        planspec.record("grid.classes")
        st = self._class_state
        with ti.eval_flight(
            "grid.classes", self.n_pods, len(cases), classes=st["classes"].n_classes,
            dispatch_only=True,
        ):
            tensors = self._with_cases(self._class_dev(), cases)
            if st["class_of"] is None:
                with phase("engine.device_put"):
                    st["class_of"] = carry.to_torch(st["classes"].class_of_pod, self.device)
            with phase("engine.dispatch"):
                out = gather_class_grids(
                    evaluate_grid_kernel(tensors, pack=self._pack), st["class_of"]
                )
            ti.CLASS_EVALS.inc(path="grid")
        return GridVerdict(
            self.pod_keys, list(cases), out["ingress"], out["egress"], out["combined"]
        )

    # --- point queries and streamed blocks -------------------------------

    def evaluate_pairs(
        self, cases: Sequence[PortCase], pairs: Sequence[Tuple[int, int]]
    ) -> np.ndarray:
        """Point verdicts for (src_idx, dst_idx) pod pairs: [K, Q, 3] bool
        (ingress, egress, combined), with no N x N grid anywhere
        (tiled.evaluate_pairs_kernel over the device views)."""
        self._check_ips()
        if not cases or len(pairs) == 0:
            return np.zeros((len(pairs), len(cases), 3), dtype=bool)
        planspec.record("pairs.aot")
        with ti.eval_flight("pairs", self.n_pods, len(cases), k=len(pairs)):
            idx = torch.from_numpy(np.asarray(pairs, dtype=np.int64).reshape(-1, 2)).to(self.device)
            out = tiled.evaluate_pairs_kernel(
                self._with_cases(self._dev(), cases), idx[:, 0], idx[:, 1]
            )
        return torch.stack([out["ingress"], out["egress"], out["combined"]], dim=2).cpu().numpy()

    def firing_components(
        self, cases: Sequence[PortCase]
    ) -> Dict[str, Dict[str, np.ndarray]]:
        """Per-direction RULE firing-mask components on the RAW encoding
        (built anew: no dead-target compaction, no rule-axis compression,
        no shape bucketing), so flat peer row p maps 1:1 to resolved rule
        (peer_target[p], peer_rule_idx[p]) of the policy's
        sorted_targets() order — the contract the analysis layer
        (cyclonus_tpu_torch.analysis) audits on.  Computed on the
        engine's device (kernel.rule_firing_kernel).

        Returns {direction: {rule_tmatch [P, N], peer_match [P, N],
        pport [P, Q], has_target [N]}} numpy bool arrays; rule p's firing
        mask over (target-side pod n, peer-side pod m, case q) is
        rule_tmatch[p, n] & peer_match[p, m] & pport[p, q]."""
        self._check_ips()
        planspec.record("firing.raw")
        if self.encoding is None:
            raise ValueError("firing_components needs an engine built from a policy")
        raw = host._build_tensors(self.encoding)
        # "tiers" excluded on purpose: firing masks are a NetworkPolicy-
        # tier concept (rule = one peer matcher of one target); the
        # lattice reads the NP tier only through has_target and the
        # any-allow OR, which removing a shadowed NP rule leaves as they
        # are (analysis/audit.py)
        shared = {
            k: v for k, v in raw.items() if k not in ("ingress", "egress", "tiers")
        }
        for k, a in zip(("q_port", "q_name", "q_proto"), self._port_case_arrays(cases)):
            shared[k] = a
        shared = carry.tensors_from_reference(shared, self.device)
        out = {}
        for direction in ("ingress", "egress"):
            comp = rule_firing_kernel(
                shared, carry.tensors_from_reference(raw[direction], self.device)
            )
            out[direction] = {k: v.cpu().numpy() for k, v in comp.items()}
        return out

    def iter_grid_blocks(self, cases: Sequence[PortCase], block: int = 1024):
        """Stream verdict blocks of source rows to the host: yields
        (start, ingress_rows, egress, combined), arrays [b, N, Q] bool
        (tiled.iter_grid_blocks), for consumers that scan grids bigger
        than host or device memory."""
        self._check_ips()
        n = self.n_pods
        if not cases or n == 0:
            return iter(())
        planspec.record("grid.blocks")
        return self._grid_blocks(cases, n, block)

    def _grid_blocks(self, cases: Sequence[PortCase], n: int, block: int):
        # tiled.iter_grid_blocks uploads a padded copy of the whole set
        TRANSFERS["tensors"] += 1
        yield from tiled.iter_grid_blocks(
            self._with_host_cases(cases), n, block=block, pack=self._pack, device=self.device
        )

    # --- full-grid counts ------------------------------------------------

    def _class_counts_bytes(self, q: int) -> Optional[int]:
        """The host-side estimate of the class counts route's device bytes
        at q port cases: aux/index tensors + the class precompute + row
        sums; None without class state."""
        st = self._class_state
        if st is None:
            return None
        ct = st["ctensors"]
        cb = int(ct["pod_ns_id"].shape[0])
        t = sum(int(ct[d]["target_ns"].shape[0]) for d in ("ingress", "egress"))
        if self._pack:
            # packed plan: tallow_pk int32 [W, Cb, Q] + tmatch_pk [W, Cb]
            # + the bool tmatch
            w = sum(packed_words(int(ct[d]["target_ns"].shape[0])) for d in ("ingress", "egress"))
            return st["aux_bytes"] + cb * (4 * w * (q + 1) + t) + cb * q * 12
        # tallow bf16 [T, Cb, Q] per direction + tmatch + f32 row sums
        return st["aux_bytes"] + t * cb * (2 * q + 1) + cb * q * 12

    def _class_counts_eligible(self, q: int) -> bool:
        """The class counts route must fit the device budget it protects,
        estimated on the host before any dispatch (_class_counts_bytes)."""
        est = self._class_counts_bytes(q)
        return est is not None and est <= host._slab_max_bytes()

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
        # tiers x pallas: a declared cell of the compatibility matrix
        # (planspec), resolved there so the declaration and the dispatch
        # cannot drift: legal under the packed plan (K3), else fallback to
        # the tile loop on auto and a loud failure on an explicit request
        backend = planspec.resolve_counts_backend(
            backend=backend,
            explicit=explicit,
            tiers="tiers" in self._tensors,
            pack=self._pack,
            # K3 walks any number of tier rows in staged passes: unlike the
            # reference's unrolled epilogue it has no row ceiling
            packed_tier_ok=lambda: True,
        )
        self._check_ips()
        n = self.n_pods
        if not cases or n == 0:
            return {"ingress": 0, "egress": 0, "combined": 0, "cells": 0}
        if self._class_counts_eligible(len(cases)):
            return self._counts_classes(
                cases,
                kernel=planspec.resolve_class_counts_kernel(backend=backend, pack=self._pack),
                block=block,
            )
        if backend == "pallas":
            return self._counts_dense(cases)
        planspec.record("counts.xla")
        return tiled.evaluate_grid_counts(
            self._with_host_cases(cases), n, block=block, pack=self._pack, device=self.device
        )

    def _with_host_cases(self, cases: Sequence[PortCase], tensors: Optional[Dict] = None) -> Dict:
        """The host (numpy) tensors (default: the engine's) with the
        port-case arrays."""
        t = dict(self._tensors if tensors is None else tensors)
        t["q_port"], t["q_name"], t["q_proto"] = self._port_case_arrays(cases)
        return t

    def _counts_classes(self, cases, kernel: str, block: int = 1024) -> Dict[str, int]:
        planspec.record("counts.classes")
        st = self._class_state
        pc = st["classes"]
        counts, gather_s = evaluate_grid_counts_classes(
            self._with_cases(self._class_dev(), cases),
            pc.n_classes,
            pc.class_size,
            self.n_pods,
            block=block,
            pack=self._pack,
            kernel=kernel,
        )
        ti.CLASS_GATHER_SECONDS.set(gather_s)
        ti.CLASS_EVALS.inc(path="counts")
        return counts

    def _pod_order(self) -> torch.Tensor:
        """The ns-order pod permutation of the dense counts route, built
        once: bucketing pads (ns id -1) sort LAST, since the kernels'
        validity mask takes the real pods to be the first n rows."""
        if self._pod_perm is None:
            ns = self._tensors["pod_ns_id"]
            key = np.where(ns < 0, np.iinfo(np.int32).max, ns)
            self._pod_perm_host = np.argsort(key, kind="stable")
            with phase("engine.device_put"):
                self._pod_perm = torch.from_numpy(self._pod_perm_host).to(self.device)
        return self._pod_perm

    def _dense_counts_tensors(
        self, cases: Sequence[PortCase], rows: Optional[torch.Tensor] = None
    ) -> Dict:
        """The device tensors of the dense counts route: pods in
        namespace order (_pod_order), host-evaluated ip columns permuted
        alike.  Counts are invariant under the permutation.  `rows` (a
        device index vector) takes those pod rows instead, in its order:
        the columns a pin patch recomputes."""
        perm = self._pod_order() if rows is None else rows
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
        once per engine.  None under the packed plan, and unless the slab
        mode is "1", or "auto" on a CUDA device with the precompute cache
        on: the autotune that settles "auto" runs at the first
        steady-state call, which the cache being off never reaches, and
        it times kernels, which the plain versions on the CPU are not
        (the reference's auto likewise plans on its TPU only).  A plan
        under "1" chooses the slab kernel."""
        if self._slab_plan_state == "unset":
            plan = None
            mode = self._slab_mode
            auto = mode == "auto" and self.device.type == "cuda" and _pre_cache_enabled()
            if not self._pack and (mode == "1" or auto):
                self._pod_order()
                plan = host._slab_plan(
                    self._tensors, self._pod_perm_host, self.n_pods, self._class_aux_bytes(),
                    selpod=self._selpod_prebucket,
                )
                if plan is not None and mode == "1":
                    self._slab_choice = True
            self._slab_plan_state = plan
        return self._slab_plan_state

    def _class_aux_bytes(self) -> int:
        st = self._class_state
        return int(st["aux_bytes"]) if st is not None else 0

    def _pre_bytes_estimate(self, q: int) -> int:
        """The reference's host-side estimate of its precompute's bytes at
        q port cases, unchanged, so the port pins a case set exactly when
        the reference would try to: under the packed plan tallow_pk
        [W, N, Q] and tmatch_pk [W, N] int32 plus the bool tmatch [T, N];
        under the dense plan the bf16 tallow [T, N, Q] per direction plus
        tmatch."""
        n = int(self._tensors["pod_ns_id"].shape[0])
        targets = [int(self._tensors[d]["target_ns"].shape[0]) for d in ("ingress", "egress")]
        t = sum(targets)
        if self._pack:
            w = sum(packed_words(x) for x in targets)
            return n * (4 * w * (q + 1) + t)
        return t * n * (2 * q + 1)

    def _steady_state_args(self, cases: Sequence[PortCase]):
        """(key, slab_ok, slab) of a dense-route counts call: the one
        definition of the cache key, (q_port, q_name, q_proto bytes, n),
        and of the kernel a steady-state call launches, shared by
        evaluate_grid_counts and counts_pipelined_eval_s.  slab_ok: a
        slab plan exists and its gathered operands fit the budget at this
        case count (the plan budgets 2 cases); slab: the slab kernel is
        also chosen."""
        q_port, q_name, q_proto = self._port_case_arrays(cases)
        key = (q_port.tobytes(), q_name.tobytes(), q_proto.tobytes(), self.n_pods)
        if cachekeys.ACTIVE:
            cachekeys.register(
                "engine.pre_cache",
                kind="device",
                components=cachekeys.program("q_port", "q_name", "q_proto", "n_pods"),
            )
        plan = self._slab_plan()
        slab_ok = plan is not None and (
            len(cases) * plan["bytes_per_case"] + self._class_aux_bytes() <= plan["budget"]
        )
        return key, slab_ok, slab_ok and self._slab_choice is True

    def _counts_dense(self, cases, plain: bool = False) -> Dict[str, int]:
        """The dense route: the packed counts kernel (K1, tiered K3) under
        the packed plan; under the dense plan the slab kernel (K6) when it
        is chosen and its bytes fit the budget at this case count, else
        K4/K5.  Runs the steady state's three-way machine of the
        reference (api.py, _counts_pallas_dispatch):

          * steady — the case set is pinned: launch only the kernel from
            the pin (the first such call under the slab "auto" mode runs
            the autotune instead), once the pod columns patched since
            its last launch are written into it (_patch_pin);
          * split — the same set as the last call, not declined, the
            cache on and the reference's estimate under the cap: the
            precompute once, the operands pinned (declined instead when
            their actual bytes pass the cap), and the default kernel
            launched on them;
          * fused — anything else: the last key recorded, and the second
            miss in a row evicts the pin and the slab operands with it.

        One flight-recorder entry ("counts.pallas") per call, as the
        reference's telemetry shell records it; its seconds end at the
        partials' readback, the call's own barrier.  plain=True runs the
        fused call's plain versions and leaves the steady state and the
        telemetry as they are."""
        if not self._pack and "tiers" in self._tensors:
            raise ValueError("the dense dtype plan has no tiered counts kernel")
        # the kernels' int32 partials bound the pod axis: raise on the
        # shape, before the upload and the precompute allocate anything
        n_pad = int(self._tensors["pod_ns_id"].shape[0])
        (packed_kernel if self._pack else dense_kernel).check_tile_counts(n_pad)
        q = len(cases)
        if plain:
            _key, _slab_ok, slab = self._steady_state_args(cases)
            return sum_partials(self._counts_fused(cases, slab, plain=True), q, self.n_pods)
        planspec.record("counts.pallas")
        with ti.eval_flight("counts.pallas", self.n_pods, q) as fl:
            counts = self._counts_dispatch(cases, fl)
            fl.set(cells=counts["cells"])
            return counts

    def _counts_dispatch(self, cases, fl) -> Dict[str, int]:
        """The body of _counts_dense: the reference's per-engine setup
        (the ns-order permutation, the slab plan), the three-way machine,
        and the readback."""
        q = len(cases)
        self._dev()  # the upload, ahead of the dispatch (the reference's _ensure_packed)
        if not self._counts_setup:
            # the reference builds its per-engine counts programs here
            # (api._build_counts_jits): the port's counterpart is the
            # per-engine state of the route, set up once
            self._counts_setup = True
            ti.ENGINE_PROGRAMS_BUILT.inc()
        if self._slab_plan_state == "unset":
            with phase("engine.slab_plan"):
                self._slab_plan()
        key, slab_ok, slab = self._steady_state_args(cases)
        if self._pre_cache_dirty and (self._pre_cache[0] != key or not _pre_cache_enabled()):
            # a pin that waits for a patch serves only its own set, with
            # the cache on: anything else drops it, as any patch would
            self._drop_pin()
        counts = self._steady_counts
        t_dispatch = time.perf_counter()
        autotuned = False
        if self._pre_cache is not None and self._pre_cache[0] == key:
            counts["hits"] += 1
            self._pre_cache_misses = 0
            mode = "steady"
            ti.PRE_CACHE_HITS.inc()
            fl.set(mode="steady", slab=slab)
            if self._pre_cache_dirty:
                self._patch_pin(cases)
            if slab_ok and self._slab_choice is None and self._autotune_enabled():
                autotuned = True
                with phase("engine.autotune"):
                    partials = self._autotune_slab(key)
            else:
                with phase("engine.dispatch"):
                    partials = self._dispatch_steady(key, slab)
        elif (
            self._last_counts_key == key
            and key != self._pre_cache_declined
            and _pre_cache_enabled()
            and self._pre_bytes_estimate(q) <= _PRE_CACHE_MAX_BYTES
        ):
            counts["misses"] += 1
            mode = "split"
            ti.PRE_CACHE_MISSES.inc()
            ti.PRE_CACHE_BUDGET_BYTES.set(_PRE_CACHE_MAX_BYTES)
            fl.set(mode="split")
            with phase("engine.dispatch"):
                partials = self._counts_split(cases, key, slab_ok, slab)
        else:
            counts["misses"] += 1
            mode = "fused"
            self._last_counts_key = key
            ti.PRE_CACHE_MISSES.inc()
            fl.set(mode="fused")
            if self._pre_cache is not None:
                # one call of another set between two of the pinned one
                # (A, B, A, B) must not evict it; two in a row do
                self._pre_cache_misses += 1
                if self._pre_cache_misses >= 2:
                    self._drop_pin()
            with phase("engine.dispatch"):
                partials = self._counts_fused(cases, slab)
        self._last_counts_mode = mode
        if not autotuned:
            # the autotune runs timed, synchronised rounds: recording them
            # as the enqueue would poison the dispatch-vs-device split
            ti.EVAL_DISPATCH_SECONDS.set(time.perf_counter() - t_dispatch)
        # the partials' readback is the execution barrier: the device's
        # run time lands here, not in the enqueue above
        t_execute = time.perf_counter()
        with phase("engine.execute"):
            partials = partials.cpu()
        ti.EVAL_EXECUTE_SECONDS.set(time.perf_counter() - t_execute)
        return sum_partials(partials, q, self.n_pods)

    def _dense_pre(self, cases) -> Dict:
        """The precompute of the dense route at these port cases, under
        its own span: fused and split calls open it, steady ones never."""
        self._steady_counts["precomputes"] += 1
        with phase("engine.precompute"):
            return _precompute(self._dense_counts_tensors(cases), self._pack, self._ip_legs_for())

    def _ip_legs_for(self) -> Dict:
        """The ip legs of the dense precompute (tiled.ip_legs), built from
        the device views at first use and kept until a patch of rule rows."""
        if self._ip_legs is None:
            self._ip_legs = ip_legs(self._dev())
        return self._ip_legs

    @staticmethod
    def _dense_args(pre: Dict):
        e, ig = pre["egress"], pre["ingress"]
        return (e["tmatch"], e["has_target"], e["tallow_bf"],
                ig["tmatch"], ig["has_target"], ig["tallow_bf"])

    def _counts_fused(self, cases, slab: bool, plain: bool = False) -> torch.Tensor:
        """One call from scratch: the precompute, the operands and the
        kernel (K1/K3; K6 when `slab`, else K4/K5).  plain=True runs each
        kernel's plain version."""
        pre = self._dense_pre(cases)
        if slab:
            plan = self._slab_plan()
            ops = dense_kernel.slab_operands(
                *self._dense_args(pre), plan["egress"], plan["ingress"], self.n_pods, w=plan["w"]
            )
            return dense_kernel.verdict_counts_slab_from_ops(ops, plain=plain)
        return self._launch(self._kernel_operands(pre), plain)

    def _kernel_operands(self, pre: Dict, valid: Optional[torch.Tensor] = None) -> Dict:
        """Everything one launch of the default kernel reads: the packed
        operands (K1/K3), or the dense ones with K5's nz maps.  `valid`
        (packed only): the precompute's own pod columns, valid where
        True, laid out with tiles of 1, as a pin patch writes them."""
        if self._pack:
            e, ig = pre["egress"], pre["ingress"]
            shape = (
                {"n_pods": self.n_pods} if valid is None
                else {"valid_src": valid, "valid_dst": valid, "bs": 1, "bd": 1}
            )
            return packed_operands(
                e["tmatch_pk"], e["has_target"], e["tallow_pk"],
                ig["tmatch_pk"], ig["has_target"], ig["tallow_pk"],
                tier=packed_tier(pre), **shape,
            )
        args = self._dense_args(pre)
        valid = torch.arange(args[0].shape[1], device=args[0].device) < self.n_pods
        return dense_kernel.with_nz_maps(dense_kernel.dense_operands(*args, valid, valid))

    def _launch(self, ops: Dict, plain: bool = False) -> torch.Tensor:
        """The default kernel (K1/K3, or K4/K5) on its operands."""
        if self._pack:
            return counts_from_packed_ops(ops, plain)
        return dense_kernel.counts_from_ops(ops, plain)

    def _counts_split(self, cases, key, slab_ok: bool, slab: bool) -> torch.Tensor:
        """The split call: one precompute; pinned, what the steady state
        reads — the default kernel's operands, or the precompute when the
        slab kernel is chosen, and both while a slab plan fits and the
        choice is open — unless those bytes pass the cap, which declines
        the key; then the default kernel on its operands, as the
        reference's split call runs its default program.  A packed pin
        also carries, on the host, the column of each pod row in its
        operands ("cols", the inverse of the ns-order permutation they
        were laid out in), which a pin patch writes through."""
        pre = self._dense_pre(cases)
        ops = self._kernel_operands(pre)
        open_choice = slab_ok and self._slab_choice is None
        pin = {"ops": None if slab else ops, "pre": pre if slab or open_choice else None}
        nbytes = _tensor_bytes(pin)
        if nbytes <= _PRE_CACHE_MAX_BYTES:
            if self._pack:
                perm = self._pod_perm_host
                pin["cols"] = np.empty_like(perm)
                pin["cols"][perm] = np.arange(perm.size)
            self._pre_cache = (key, pin)  # evicts any other set
            self._pre_cache_dirty = set()
            with self._slab_lock:
                self._slab_ops_cache = None  # stale for the new set
            self._pre_cache_misses = 0
            ti.PRE_CACHE_BYTES.set(nbytes)
        else:
            self._pre_cache_declined = key
        return self._launch(ops)

    def _slab_ops_for(self, key) -> Dict:
        """The gathered slab operands of the pinned case set, built once
        from the pinned precompute and cached beside the pin (evicted
        with it).  Once the slab kernel is chosen, the pin's default
        operands and precompute are read no more and are dropped.

        The build runs outside _slab_lock; the fill checks the choice
        under it, so a rejection of the slab kernel between the two
        leaves no operands pinned."""
        if cachekeys.ACTIVE:
            # the pin's key (_steady_state_args): the operands are the pin's
            cachekeys.register(
                "engine.slab_ops",
                kind="device",
                components=cachekeys.program("q_port", "q_name", "q_proto", "n_pods"),
            )
        with self._slab_lock:
            cached = self._slab_ops_cache
        if cached is not None and cached[0] == key:
            ti.SLAB_OPS_CACHE_HITS.inc()
        else:
            ti.SLAB_OPS_CACHE_MISSES.inc()
            plan = self._slab_plan()
            pin = self._pre_cache  # read once: the build reads one pin
            ops = dense_kernel.slab_operands(
                *self._dense_args(pin[1]["pre"]), plan["egress"], plan["ingress"],
                self.n_pods, w=plan["w"],
            )
            # the actual pinned bytes supersede the plan's q=2 estimate
            ti.SLAB_HBM_BYTES.set(_tensor_bytes(ops))
            cached = (key, ops)
            with self._slab_lock:
                if self._slab_choice is not False:
                    self._slab_ops_cache = cached
        if self._slab_choice is True:
            self._pre_cache = (key, {"ops": None, "pre": None})
        return cached[1]

    def _dispatch_steady(self, key, slab: bool) -> torch.Tensor:
        """One steady-state launch of the chosen kernel, its route
        recorded: K6 from the cached slab operands, else the default
        kernel from the pin."""
        if slab:
            planspec.record("counts.steady.slab")
        else:
            planspec.record("counts.steady.default")
        return self._launch_steady(key, slab)

    def _launch_steady(self, key, slab: bool) -> torch.Tensor:
        """The launch of _dispatch_steady, unrecorded: the autotune's
        adoption of a persisted winner launches it too, and records no
        route (the reference's autotune runs its programs directly)."""
        if slab:
            return dense_kernel.verdict_counts_slab_from_ops(self._slab_ops_for(key))
        return self._launch(self._pre_cache[1]["ops"])

    def _patch_pin(self, cases) -> None:
        """Bring the pinned operands up to date with the pod rows patched
        since their last launch: the precompute of those pods alone,
        their own operands laid out from it, written into the pin at the
        rows' columns (packed_kernel.patch_packed_operands).  A row at or
        past the live pod count (the old last row of a swap-remove) is
        written as an invalid column, so the kernel counts exactly the
        live pods."""
        rows = np.fromiter(sorted(self._pre_cache_dirty), dtype=np.int64)
        self._pre_cache_dirty = set()
        pin = self._pre_cache[1]
        with phase("engine.pre_patch"):
            idx = torch.from_numpy(rows).to(self.device)
            pre = _precompute(self._dense_counts_tensors(cases, idx), True, self._ip_legs_for())
            sub = self._kernel_operands(pre, valid=idx < self.n_pods)
            packed_kernel.patch_packed_operands(pin["ops"], sub, pin["cols"][rows])
        self._steady_counts["patches"] += 1
        self._steady_counts["patched_columns"] += int(rows.size)
        ti.PRE_CACHE_PATCHES.inc()
        ti.PRE_CACHE_PATCHED_COLUMNS.inc(int(rows.size))

    def _drop_pin(self) -> None:
        """Evict the pin, with its pending patch and the slab operands
        gathered from it."""
        self._pre_cache = None
        self._pre_cache_dirty = set()
        with self._slab_lock:
            self._slab_ops_cache = None  # the operands go with the pin
        ti.PRE_CACHE_BYTES.set(0)

    # --- the slab autotune ------------------------------------------------

    def _autotune_enabled(self) -> bool:
        """CYCLONUS_AUTOTUNE: "auto" (the default) tunes on a CUDA device,
        where the times mean something; "1" forces it (how the CPU tests
        drive its mechanics over the plain versions); "0" turns it off."""
        mode = os.environ.get("CYCLONUS_AUTOTUNE", "auto").lower()
        if mode == "0":
            return False
        if mode == "1":
            return True
        return self.device.type == "cuda"

    def _autotune_key(self, q: int) -> str:
        """The persisted winner's key (engine/autotune.py): the shape
        bucket, the device as "cuda:<name>:<count>", the dtype plan."""
        t = self._tensors
        shape = {
            "n": int(t["pod_ns_id"].shape[0]),
            "te": int(t["egress"]["target_ns"].shape[0]),
            "ti": int(t["ingress"]["target_ns"].shape[0]),
            "q": int(q),
            "tiered": "tiers" in t,
            "classes": self._class_state is not None,
        }
        kind = self.device.type
        if kind == "cuda":
            device = f"cuda:{torch.cuda.get_device_name(self.device)}:{torch.cuda.device_count()}"
        else:
            device = f"{kind}:{kind}:1"
        return autotune.make_key(shape, device, "int8")

    @staticmethod
    def _timed_rounds(dispatch):
        """(best seconds, per-round seconds, first output) of a launch:
        one launch outside the timing, then CYCLONUS_AUTOTUNE_ROUNDS
        rounds (3) of CYCLONUS_AUTOTUNE_REPS launches (4), each round
        ended by reading back its last output (the stream runs them in
        order), the best round kept."""
        out = dispatch()
        out.cpu()  # the readback is the barrier: the stream runs launches in order
        reps = max(1, int(os.environ.get("CYCLONUS_AUTOTUNE_REPS", "4")))
        rounds = max(1, int(os.environ.get("CYCLONUS_AUTOTUNE_ROUNDS", "3")))
        times = []
        for _ in range(rounds):
            t0 = time.perf_counter()
            outs = [dispatch() for _ in range(reps)]
            outs[-1].cpu()
            times.append((time.perf_counter() - t0) / reps)
        return min(times), times, out

    @staticmethod
    def _noise_floor(baseline_rounds) -> float:
        """The margin the slab kernel must win by: 10%, widened to the
        default kernel's own spread between rounds, at most 50%."""
        lo, hi = min(baseline_rounds), max(baseline_rounds)
        return max(0.10, min(0.5, (hi - lo) / max(lo, 1e-9)))

    def _autotune_slab(self, key) -> torch.Tensor:
        """The dense plan's kernel autotune, at the first steady-state
        call of a pinned case set with a slab plan: adopt the persisted
        winner of this shape and device with no search, or time the
        default kernel (K4/K5) and K6 from the same pin (_timed_rounds;
        K6's operands are gathered once, outside its timing), keep K6
        only if it wins by more than the noise floor, and persist the
        winner.  Returns the winner's output for the call that paid for
        the search.  A candidate that fails raises."""
        akey = self._autotune_key(len(key[0]) // 4)  # key[0]: q_port int32 bytes
        persisted = autotune.load_winner(akey)
        if persisted is not None:
            chose_slab = persisted["kernel"] == "slab"
            self._settle_slab_choice(key, chose_slab)
            ti.AUTOTUNE_CACHE.inc(outcome="hit")
            self._autotune_stats = {"source": "cache", "winner": dict(persisted),
                                    "search_s": 0.0, "candidates": []}
            return self._launch_steady(key, chose_slab)
        if autotune.cache_path() is not None:
            ti.AUTOTUNE_CACHE.inc(outcome="miss")
        ti.AUTOTUNE_SEARCHES.inc()
        self._steady_counts["autotune_searches"] += 1
        t0 = time.perf_counter()
        default_ops = self._pre_cache[1]["ops"]
        t_default, rounds_default, out_default = self._timed_rounds(
            lambda: self._launch(default_ops)
        )
        slab_ops = self._slab_ops_for(key)
        t_slab, rounds_slab, out_slab = self._timed_rounds(
            lambda: dense_kernel.verdict_counts_slab_from_ops(slab_ops)
        )
        floor = self._noise_floor(rounds_default)
        chose_slab = bool(t_slab < (1.0 - floor) * t_default)
        self._settle_slab_choice(key, chose_slab)
        winner = {"kernel": "slab" if chose_slab else "default"}
        self._autotune_stats = {
            "source": "search",
            "winner": winner,
            "search_s": time.perf_counter() - t0,
            "noise_floor": floor,
            "candidates": [
                {"kernel": "default", "s": t_default, "rounds": rounds_default},
                {"kernel": "slab", "s": t_slab, "rounds": rounds_slab},
            ],
        }
        if autotune.store_winner(akey, winner, {"default_s": t_default, "slab_s": t_slab}):
            ti.AUTOTUNE_CACHE.inc(outcome="store")
        ti.AUTOTUNE_OUTCOMES.inc(outcome=winner["kernel"])
        return out_slab if chose_slab else out_default

    def _settle_slab_choice(self, key, chose_slab: bool) -> None:
        """Record the slab choice and keep pinned only what its kernel
        reads: K6's gathered operands, or the default kernel's."""
        with self._slab_lock:
            self._slab_choice = chose_slab
            if not chose_slab:
                self._slab_ops_cache = None
        if chose_slab:
            self._slab_ops_for(key)
        else:
            self._pre_cache = (key, {"ops": self._pre_cache[1]["ops"], "pre": None})

    # --- measurement and invalidation ---------------------------------------

    def counts_pipelined_eval_s(self, cases: Sequence[PortCase], reps: int = 10):
        """Steady-state seconds per counts evaluation with the launches
        pipelined: `reps` launches of exactly the program a steady-state
        call runs, back to back, reading back only the last (the stream
        runs them in order), then the same host finish.  Returns
        (seconds per evaluation, counts), or None when the engine is not
        at the steady state of this case set; a pin that waits for a
        patch is patched first, untimed.  The class route has no cache
        and always measures its whole program."""
        if self._class_counts_eligible(len(cases)):
            return self._pipelined_classes(cases, reps)
        key, _slab_ok, slab = self._steady_state_args(cases)
        if self._pre_cache is None or self._pre_cache[0] != key:
            return None
        if self._pre_cache_dirty:
            self._patch_pin(cases)
        self._dispatch_steady(key, slab).cpu()  # warm
        t0 = time.perf_counter()
        outs = [self._dispatch_steady(key, slab) for _ in range(reps)]
        partials = outs[-1].cpu()
        dt = (time.perf_counter() - t0) / reps
        return self._pipelined_gauges(dt, sum_partials(partials, len(cases), self.n_pods))

    @staticmethod
    def _pipelined_gauges(dt: float, counts: Dict[str, int]):
        """The pipelined rate as a gauge beside the sync call's: what a
        batched caller sustains.  Returns (dt, counts)."""
        if dt > 0:
            ti.EVAL_DEVICE_SECONDS.set(dt)
            ti.EVAL_PIPELINED_CELLS_PER_SEC.set(counts["cells"] / dt)
        return dt, counts

    def _pipelined_classes(self, cases: Sequence[PortCase], reps: int):
        """The class route's twin of counts_pipelined_eval_s: `reps` runs
        of its row-sum program (the weighted kernel under the packed plan,
        the tile loop under the dense one), one readback, the same exact
        host finish."""
        pc = self._class_state["classes"]
        tensors = self._with_cases(self._class_dev(), cases)
        w, block, n_tiles = class_rowsums_plan(tensors, pc.n_classes, pc.class_size)
        w = torch.from_numpy(w).to(self.device)
        if self._pack:
            run = lambda: class_rowsums(tensors, w)  # noqa: E731
        else:
            run = lambda: _class_rowsums_kernel(tensors, w, block, n_tiles, False)  # noqa: E731
        run().cpu()  # warm
        t0 = time.perf_counter()
        outs = [run() for _ in range(reps)]
        rs = outs[-1].cpu().numpy()
        dt = (time.perf_counter() - t0) / reps
        return self._pipelined_gauges(
            dt, class_counts_finish(rs, pc.class_size, pc.n_classes, len(cases), self.n_pods)
        )

    # --- the pod-axis mesh ------------------------------------------------

    def _mesh(self, mesh) -> "sharded.Mesh":
        return mesh if mesh is not None else sharded.default_mesh(self.device)

    def evaluate_grid_sharded(
        self, cases: Sequence[PortCase], mesh=None, schedule: Optional[str] = None
    ) -> GridVerdict:
        """The truth tables over the pod-axis mesh (sharded.
        evaluate_grid_sharded; `schedule` "ring", the default, or
        "allgather"), bit-identical to evaluate_grid; the grids lie on the
        mesh's first device.  Class state runs the sharded program over
        the class axis and gathers back to pod axes on the device."""
        self._check_ips()
        if not cases:
            return self.evaluate_grid(cases)
        mesh = self._mesh(mesh)
        st = self._class_state
        if st is not None:
            planspec.record("grid.sharded.classes")
            pc = st["classes"]
            tensors = self._with_host_cases(cases, st["ctensors"])
            with phase("engine.dispatch_sharded"):
                grids = sharded.evaluate_class_grid_sharded(
                    tensors, pc.n_classes, pc.class_of_pod,
                    mesh=mesh, schedule=schedule, pack=self._pack,
                )
            ti.CLASS_EVALS.inc(path="sharded")
        else:
            # recorded at the dispatch leaf, not inside the shared sharded
            # program (the class route reuses it over the class axis)
            if sharded.mesh_schedule(schedule) == "ring":
                planspec.record("grid.sharded.ring")
            else:
                planspec.record("grid.sharded.allgather")
            tensors = self._with_host_cases(cases)
            with phase("engine.dispatch_sharded"):
                grids = sharded.evaluate_grid_sharded(
                    tensors, self.n_pods, mesh=mesh, schedule=schedule, pack=self._pack,
                )
        return GridVerdict(self.pod_keys, list(cases), *(torch.movedim(g, -1, 0) for g in grids))

    def evaluate_grid_counts_sharded(
        self, cases: Sequence[PortCase], block: int = 1024, mesh=None, kernel: Optional[str] = None
    ) -> Dict[str, int]:
        """Mesh-parallel counts (tiled.evaluate_grid_counts_sharded): source
        rows split over the mesh, the counts kernel (kernel="pallas", the
        default on a CUDA mesh) or the tile loop ("xla") per shard.  The
        class route, when it is eligible, splits its class axis instead.
        Tiered counts take the tile loop: kernel None resolves to "xla",
        an explicit "pallas" raises."""
        self._check_ips()
        n = self.n_pods
        if not cases or n == 0:
            return {"ingress": 0, "egress": 0, "combined": 0, "cells": 0}
        mesh = self._mesh(mesh)
        if self._class_counts_eligible(len(cases)):
            planspec.record("counts.sharded.classes")
            pc = self._class_state["classes"]
            counts, gather_s = tiled.evaluate_grid_counts_classes_sharded(
                self._with_host_cases(cases, self._class_state["ctensors"]), pc.n_classes,
                pc.class_size, n, block=block, mesh=mesh, pack=self._pack,
            )
            ti.CLASS_GATHER_SECONDS.set(gather_s)
            ti.CLASS_EVALS.inc(path="sharded")
            return counts
        # tiers x per-shard kernel: the same matrix discipline as
        # evaluate_grid_counts (auto takes the tile loop, an explicit
        # kernel raises with the declared message)
        kernel = planspec.resolve_sharded_counts_kernel(
            kernel=kernel, tiers="tiers" in self._tensors
        )
        return tiled.evaluate_grid_counts_sharded(
            self._with_host_cases(cases), n, block=block, mesh=mesh, kernel=kernel,
            pack=self._pack,
        )

    def evaluate_grid_counts_ring(
        self, cases: Sequence[PortCase], block: int = 1024, mesh=None
    ) -> Dict[str, int]:
        """Ring-rotation counts (tiled.evaluate_grid_counts_ring): both pod
        axes sharded, the dst-side precompute rotating around the mesh."""
        self._check_ips()
        n = self.n_pods
        if not cases or n == 0:
            return {"ingress": 0, "egress": 0, "combined": 0, "cells": 0}
        planspec.record("counts.ring")
        return tiled.evaluate_grid_counts_ring(
            self._with_host_cases(cases), n, block=block, mesh=self._mesh(mesh), pack=self._pack
        )

    def mesh_counts_pipelined_eval_s(
        self, cases: Sequence[PortCase], reps: int = 10, block: int = 1024, mesh=None
    ):
        """Seconds per ring-counts evaluation with the steps pipelined
        (tiled.evaluate_grid_counts_ring_pipelined: one seed pins each
        shard's src view and ring bundle, then `reps` ring sweeps back to
        back and one readback).  Returns (seconds per evaluation, counts),
        or None for an empty problem."""
        self._check_ips()
        n = self.n_pods
        if not cases or n == 0:
            return None
        planspec.record("counts.ring.pipelined")
        return tiled.evaluate_grid_counts_ring_pipelined(
            self._with_host_cases(cases), n, reps=reps, block=block, mesh=self._mesh(mesh),
            pack=self._pack,
        )

    def evaluate_grid_counts_ring2d(
        self, cases: Sequence[PortCase], block: int = 1024, mesh=None
    ) -> Dict[str, int]:
        """Hierarchical ring counts over a ("dcn", "ici") mesh
        (tiled.evaluate_grid_counts_ring2d); mesh None factors the default
        mesh into 2 "hosts" (sharded.ring2d_mesh)."""
        self._check_ips()
        n = self.n_pods
        if not cases or n == 0:
            return {"ingress": 0, "egress": 0, "combined": 0, "cells": 0}
        planspec.record("counts.ring2d")
        if mesh is None:
            mesh = sharded.ring2d_mesh(sharded.default_mesh(self.device))
        return tiled.evaluate_grid_counts_ring2d(
            self._with_host_cases(cases), n, block=block, mesh=mesh, pack=self._pack
        )

    def pre_cache_stats(self) -> Dict:
        """The steady state's counters and residency: hits (steady-state
        calls), misses (fused and split calls), precomputes run, autotune
        searches, pin patches and the pod columns they recomputed, the
        mode of the last dense-route call (fused, split or steady; None
        before one), whether a case set is pinned, the bytes of the pin
        and of the cached slab operands, the slab choice and the
        autotune's record."""
        with self._slab_lock:
            slab = self._slab_ops_cache
        pin = self._pre_cache
        return {
            **self._steady_counts,
            "mode": self._last_counts_mode,
            "pinned": pin is not None,
            "pinned_bytes": _tensor_bytes(pin[1]) if pin is not None else 0,
            "slab_ops_bytes": _tensor_bytes(slab[1]) if slab is not None else 0,
            "slab_choice": self._slab_choice,
            "autotune": self._autotune_stats,
        }

    def invalidate_after_patch(self) -> None:
        """Reset every cache derived from tensor values after the verdict
        service patched the host tensors and their device views in place,
        shapes unchanged: the pin with its pending patch, its misses, the
        declined and last keys, the slab operands, the slab choice, the
        ns-order pod permutation, the ip legs and the class map.  The
        device views themselves stay: the patch wrote them.  The slab plan's window
        proof is stale too, so the slab kernel stays off until the engine
        is rebuilt, as on the reference.  The service calls it after a
        patch of namespace, policy or tier rows; after one of pod rows
        alone, invalidate_after_pod_patch."""
        self._pre_cache = None
        self._pre_cache_dirty = set()
        with self._slab_lock:
            self._slab_ops_cache = None
        self._pre_cache_misses = 0
        self._pre_cache_declined = None
        self._last_counts_key = None
        ti.PRE_CACHE_BYTES.set(0)
        self._slab_choice = None
        self._slab_plan_state = None
        self._selpod_prebucket = None
        self._pod_perm = None
        self._pod_perm_host = None
        self._ip_legs = None
        if self._class_state is not None:
            self._class_state["class_of"] = None

    def invalidate_after_pod_patch(self, rows) -> None:
        """invalidate_after_patch after a patch that wrote pod rows alone
        (`rows`: host row indices, of updates, swap-removes and adds), for
        which a packed pin need not go.  It drops the same, but the
        packed pin and the last key stay, rekeyed to the live pod count,
        and the rows join the pin's pending patch, which the next counts
        call of its case set writes (_patch_pin) before it launches from
        the pin.  The ip legs stay under either plan: they read rule rows
        alone.  Under the dense plan the rest is invalidate_after_patch."""
        pin, last, legs = self._pre_cache, self._last_counts_key, self._ip_legs
        dirty = self._pre_cache_dirty | set(rows)
        self.invalidate_after_patch()
        self._ip_legs = legs  # read from rule rows alone
        if not self._pack:
            return
        n = self.n_pods
        if last is not None:
            # no pin yet: the next call of that set still splits and pins
            self._last_counts_key = last[:3] + (n,)
        if pin is not None and "cols" in pin[1]:
            self._pre_cache = (pin[0][:3] + (n,), pin[1])
            self._pre_cache_dirty = dirty
            ti.PRE_CACHE_BYTES.set(_tensor_bytes(pin[1]))
