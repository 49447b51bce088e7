"""Host-side tensor compiler: matcher IR + cluster model -> dense numpy
arrays ready for the device kernels.

Encoding scheme (see SURVEY.md section 7 step 3):
  * label vocabulary: every distinct (key, value) pair appearing on any pod,
    namespace, or selector gets an int id; every distinct key gets a key id.
  * pods: (namespace id, padded kv-id list, padded key-id list, IPv4 uint32);
    namespaces: (padded kv-id list, padded key-id list).
  * selectors: deduped; matchLabels as padded required-kv ids, up to E
    matchExpressions each (op, key id, padded value-kv ids).
  * targets: (namespace id, selector id) per direction.
  * peers: flat arrays with a target id and a kind code
    (ALL / ALL_PORTS / IP / POD); pod peers carry namespace-matcher and
    pod-matcher codes; ip peers carry premasked (base, mask) plus excepts.
  * port specs: per peer, up to I single items (nil/int/named x protocol)
    and R ranges.

Padding is provably neutral: padded kv ids are -1 (never equal to a real
id), padded expressions are op NONE (always true), padded peers belong to
target -1 (one-hot row of zeros), padded except-blocks carry valid=False.

Ragged semantics warning: everything here must mirror the scalar oracle in
cyclonus_tpu_torch.matcher exactly — any divergence is caught by the parity tests
(tests/test_engine_parity.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..kube.ipaddr import cidr_to_base_and_prefix, ip_to_uint32
from ..kube.netpol import (
    OP_DOES_NOT_EXIST,
    OP_EXISTS,
    OP_IN,
    OP_NOT_IN,
    LabelSelector,
)
from ..kube.labels import serialize_label_selector
from ..matcher.core import (
    AllNamespaceMatcher,
    AllPeersMatcher,
    AllPodMatcher,
    AllPortMatcher,
    ExactNamespaceMatcher,
    IPPeerMatcher,
    LabelSelectorNamespaceMatcher,
    LabelSelectorPodMatcher,
    PodPeerMatcher,
    Policy,
    PortsForAllPeersMatcher,
    SpecificPortMatcher,
)

# selector expression opcodes
EXP_NONE = 0
EXP_IN = 1
EXP_NOT_IN = 2
EXP_EXISTS = 3
EXP_DOES_NOT_EXIST = 4

_OP_CODES = {
    OP_IN: EXP_IN,
    OP_NOT_IN: EXP_NOT_IN,
    OP_EXISTS: EXP_EXISTS,
    OP_DOES_NOT_EXIST: EXP_DOES_NOT_EXIST,
}

# peer kinds
PEER_ALL = 0  # AllPeersMatcher: everything
PEER_ALL_PORTS = 1  # PortsForAllPeersMatcher: any peer, port-matched
PEER_IP = 2  # IPPeerMatcher
PEER_POD = 3  # PodPeerMatcher

# namespace-matcher kinds (within a pod peer)
NS_EXACT = 0
NS_SELECTOR = 1
NS_ALL = 2

# pod-matcher kinds
POD_ALL = 0
POD_SELECTOR = 1

# port item kinds
PORT_NIL = 0  # protocol only
PORT_INT = 1
PORT_NAMED = 2

# precedence-tier verdict codes (int8 slab).  0 is the PAD action: a
# padded tier rule matches nothing.
TIER_ACT_NONE = 0
TIER_ACT_ALLOW = 1
TIER_ACT_DENY = 2
TIER_ACT_PASS = 3

# tier ids within the shared slab
TIER_ANP = 0
TIER_BANP = 1

#: "no matching rule" priority-key sentinel: every real key is
#: rank * 4 + action < 2^30 (ranks are slab positions, actions 1-3)
TIER_KEY_NONE = 1 << 30

# --- bit-packed match slabs (docs/DESIGN.md "Bit-packed kernel") ----------
#
# The verdict contraction is pure boolean: any_allow = OR_t (tmatch[t] AND
# tallow[t]).  Packing the target axis 32-per-int32-word turns that OR of
# T bools into an OR of ceil(T/32) word AND-OR steps — a 32x cut of the
# contraction depth every evaluator shares (the grid kernel and the
# packed counts kernel).  int32 is the one packed dtype:
# the word sum below never carries across bit lanes, so the sign bit is
# just bit 31.  The numpy packer here and the torch twin
# (kernel.pack_bool_words_torch) are pinned bit-identical by
# tests/test_torch_kernel.py.

#: bits per packed word — the 32-per-word layout every packed slab uses
PACK_BITS = 32


def packed_words(n: int) -> int:
    """Words needed for `n` packed bits (>= 1): the one ceil-div formula
    of the 32-per-word layout."""
    return -(-max(int(n), 1) // PACK_BITS)


def pack_bool_words(a: np.ndarray, axis: int = 0) -> np.ndarray:
    """Pack a bool array 32-per-word along `axis` into int32 words.

    Bit b of word w holds element w * 32 + b (little-endian within the
    word); the trailing word zero-pads.  Word values are built as a sum
    of disjoint shifted bits, which equals the bitwise OR exactly (no
    carries), including bit 31 riding the int32 sign."""
    a = np.moveaxis(np.asarray(a, dtype=bool), axis, 0)
    t = a.shape[0]
    w = packed_words(t)
    total = w * PACK_BITS
    pad = total - t
    if pad:
        a = np.concatenate(
            [a, np.zeros((pad,) + a.shape[1:], dtype=bool)], axis=0
        )
    bits = a.reshape((w, PACK_BITS) + a.shape[1:]).astype(np.uint32)
    shifts = (np.uint32(1) << np.arange(PACK_BITS, dtype=np.uint32)).reshape(
        (1, PACK_BITS) + (1,) * (a.ndim - 1)
    )
    words = (bits * shifts).sum(axis=1, dtype=np.uint32).view(np.int32)
    return np.moveaxis(words, 0, axis)


def pack_enabled(mode: Optional[str] = None) -> bool:
    """Resolve the CYCLONUS_PACK kill switch: "0" turns the packed
    (32-per-word) dtype plan off everywhere and routes the counts through
    the dense int8 kernels and the tile loop instead, with identical
    results; "1"/"auto" (the default) keep it on.  `mode` None reads the
    environment."""
    import os

    if mode is None:
        mode = os.environ.get("CYCLONUS_PACK", "auto")
    mode = str(mode).lower()
    if mode not in ("auto", "0", "1"):
        raise ValueError(
            f"CYCLONUS_PACK must be auto, 0, or 1, got {mode!r}"
        )
    return mode != "0"


# protocols: TCP/UDP/SCTP preseeded; unknown protocol strings appearing in
# policies get fresh ids at encode time so that equal strings still match
# (the oracle compares protocol strings for equality — matcher/core.py).


@dataclass
class _Vocab:
    kv: Dict[Tuple[str, str], int] = field(default_factory=dict)
    key: Dict[str, int] = field(default_factory=dict)
    ns: Dict[str, int] = field(default_factory=dict)
    port_name: Dict[str, int] = field(default_factory=dict)
    proto: Dict[str, int] = field(
        default_factory=lambda: {"TCP": 0, "UDP": 1, "SCTP": 2}
    )

    def kv_id(self, k: str, v: str) -> int:
        return self.kv.setdefault((k, v), len(self.kv))

    def key_id(self, k: str) -> int:
        return self.key.setdefault(k, len(self.key))

    def ns_id(self, ns: str) -> int:
        return self.ns.setdefault(ns, len(self.ns))

    def port_name_id(self, name: str) -> int:
        if name == "":
            return -1
        return self.port_name.setdefault(name, len(self.port_name))

    def proto_id(self, protocol: str) -> int:
        return self.proto.setdefault(protocol, len(self.proto))


@dataclass
class ClusterEncoding:
    """Tensorized cluster: one row per pod, one row per namespace.

    Shapes: N pods, M namespaces, L/Lns label pad widths."""

    vocab: _Vocab
    pod_keys: List[str]  # "ns/name" in row order
    pod_ns_id: np.ndarray  # shape: (N,) int32
    pod_kv: np.ndarray  # shape: (N, L) int32; sentinel: -1=pad
    pod_key: np.ndarray  # shape: (N, L) int32; sentinel: -1=pad
    # a parse-failure row holds uint32 0 — a REAL address (0.0.0.0) — so
    # the bool validity column, not the 0, is the ground truth: every
    # comparison against pod_ip must consult pod_ip_valid
    pod_ip: np.ndarray  # shape: (N,) uint32; sentinel: 0=invalid; mask: pod_ip_valid
    pod_ip_valid: np.ndarray  # shape: (N,) bool
    pod_ips: List[str]  # raw strings, for host-side v6 fallback
    ns_kv: np.ndarray  # shape: (M, Lns) int32; sentinel: -1=pad
    ns_key: np.ndarray  # shape: (M, Lns) int32; sentinel: -1=pad

    @property
    def n_pods(self) -> int:
        return len(self.pod_keys)


def _encode_label_rows(
    label_maps: Sequence[Dict[str, str]], vocab: _Vocab
) -> Tuple[np.ndarray, np.ndarray]:
    """Vocab-encode per-row label maps to padded id matrices.

    Vectorized for large clusters: per-row dict walks produce flat
    (row, key, value) triples, the vocab lookup runs once per DISTINCT
    pair/key (label cardinality is tiny next to pod count), and the
    padded matrices fill with one scatter.  Vocab id assignment order is
    identical to the scalar form (first appearance in row-major sorted
    order), so selector tables encoded earlier against the same vocab
    stay consistent."""
    n = len(label_maps)
    # Distinct-map dedup: clusters repeat a small set of label maps
    # across huge pod counts (replicas share a template), so encode each
    # DISTINCT map once and scatter by row index.  The cache key is the
    # map's insertion-order items — equal maps built in different orders
    # just dedup less, never wrongly merge.  Vocab id assignment order
    # is unchanged: a repeated map introduces no new pair on later
    # appearances, so first-appearance order over distinct maps equals
    # first-appearance order over all rows.
    row_of = np.empty(n, dtype=np.int32)
    distinct_index: Dict[tuple, int] = {}
    label_maps_d: List[Dict[str, str]] = []
    for i, m in enumerate(label_maps):
        cache_key = tuple(m.items())
        rid = distinct_index.get(cache_key)
        if rid is None:
            rid = distinct_index[cache_key] = len(label_maps_d)
            label_maps_d.append(m)
        row_of[i] = rid
    if len(label_maps_d) < n:
        kv_d, key_d = _encode_label_rows(label_maps_d, vocab)
        return kv_d[row_of], key_d[row_of]

    max_l = max((len(m) for m in label_maps), default=0)
    max_l = max(max_l, 1)
    kv = np.full((n, max_l), -1, dtype=np.int32)
    key = np.full((n, max_l), -1, dtype=np.int32)
    rows, cols, ks, vs = [], [], [], []
    for i, m in enumerate(label_maps):
        for j, (k, v) in enumerate(sorted(m.items())):
            rows.append(i)
            cols.append(j)
            ks.append(k)
            vs.append(v)
    if not rows:
        return kv, key
    # id-assign in first-appearance order over the flat stream, visiting
    # the dict only once per distinct pair/key
    kv_ids = np.empty(len(rows), dtype=np.int32)
    key_ids = np.empty(len(rows), dtype=np.int32)
    kv_cache: Dict[Tuple[str, str], int] = {}
    key_cache: Dict[str, int] = {}
    for idx, (k, v) in enumerate(zip(ks, vs)):
        pair = (k, v)
        kv_cached = kv_cache.get(pair)
        if kv_cached is None:
            kv_cached = kv_cache[pair] = vocab.kv_id(k, v)
        kv_ids[idx] = kv_cached
        key_cached = key_cache.get(k)
        if key_cached is None:
            key_cached = key_cache[k] = vocab.key_id(k)
        key_ids[idx] = key_cached
    kv[rows, cols] = kv_ids
    key[rows, cols] = key_ids
    return kv, key


_STRICT_IPV4_LINES = None  # compiled lazily (module import stays light)


def _encode_pod_ips(ips: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
    """(pod_ip uint32 [N], pod_ip_valid bool [N]) for all pods at once.

    Contract (ClusterEncoding.pod_ip): a parse failure fills uint32 0 —
    a REAL address (0.0.0.0) — with the bool column as ground truth, so
    every consumer comparison must be pod_ip_valid-guarded (shapelint
    SC003 enforces this wherever the mask-declared field is compared).

    Bulk fast path: ONE multiline regex pass over the joined IP strings
    (the strict octet grammar — exactly what _fast_ipv4_to_uint32
    accepts: no leading zeros, no signs/whitespace, 0-255) and one numpy
    combine.  Any line that doesn't match breaks the count, and the
    whole batch falls back to the per-item path — mixed/IPv6 clusters
    keep exact semantics, all-IPv4 clusters (the big ones) skip ~4us of
    python per pod."""
    global _STRICT_IPV4_LINES
    if not ips:
        return np.zeros((0,), np.uint32), np.zeros((0,), bool)
    if _STRICT_IPV4_LINES is None:
        import re

        octet = r"(25[0-5]|2[0-4][0-9]|1[0-9][0-9]|[1-9][0-9]|[0-9])"
        _STRICT_IPV4_LINES = re.compile(
            rf"(?m)^{octet}\.{octet}\.{octet}\.{octet}$"
        )
    if not any("\n" in ip for ip in ips):
        matches = _STRICT_IPV4_LINES.findall("\n".join(ips))
        if len(matches) == len(ips):
            octets = np.array(matches, dtype=np.uint32)  # [N, 4]
            ip_int = (
                (octets[:, 0] << 24)
                | (octets[:, 1] << 16)
                | (octets[:, 2] << 8)
                | octets[:, 3]
            )
            return ip_int.astype(np.uint32), np.ones(len(ips), dtype=bool)
    ip_ints = [_fast_ipv4_to_uint32(ip) for ip in ips]
    return (
        np.array([i or 0 for i in ip_ints], dtype=np.uint32),
        np.array([i is not None for i in ip_ints], dtype=bool),
    )


def _fast_ipv4_to_uint32(ip: str) -> Optional[int]:
    """Dotted-quad fast path for the per-pod encode loop (ipaddress.
    ip_address costs ~4us/call, dominating 100k+-pod encodes); anything
    unusual falls back to the oracle-faithful ip_to_uint32."""
    parts = ip.split(".")
    if len(parts) != 4:
        return ip_to_uint32(ip)
    out = 0
    for x in parts:
        # reject forms ipaddress rejects: empty/oversize octets, signs,
        # whitespace, non-ASCII digits (isdigit alone accepts those and
        # int() converts them), leading zeros, out-of-range values
        n = len(x)
        if (
            n == 0
            or n > 3
            or not x.isascii()
            or not x.isdigit()
            or (n > 1 and x[0] == "0")
        ):
            return ip_to_uint32(ip)
        v = int(x)
        if v > 255:
            return ip_to_uint32(ip)
        out = (out << 8) | v
    return out


def encode_cluster(
    pods: Sequence[Tuple[str, str, Dict[str, str], str]],
    namespaces: Dict[str, Dict[str, str]],
    vocab: Optional[_Vocab] = None,
) -> ClusterEncoding:
    """pods: (namespace, name, labels, ip) per pod.
    namespaces: ns -> labels.

    The namespace-label rows are indexed BY VOCAB NS ID (the vocab may
    already hold ids for policy-target namespaces, and pods may live in
    namespaces absent from the dict) — a namespace with no labels entry gets
    an all-pad row, matching the oracle's empty-label semantics for unknown
    namespaces."""
    vocab = vocab or _Vocab()
    for ns in namespaces:
        vocab.ns_id(ns)
    for p in pods:
        vocab.ns_id(p[0])
    n_ns = len(vocab.ns)
    label_rows: List[Dict[str, str]] = [{} for _ in range(n_ns)]
    for ns, labels in namespaces.items():
        label_rows[vocab.ns_id(ns)] = labels
    ns_kv, ns_key = _encode_label_rows(label_rows, vocab)

    pod_ns_id = np.array(
        [vocab.ns_id(p[0]) for p in pods], dtype=np.int32
    ) if pods else np.zeros((0,), dtype=np.int32)
    pod_kv, pod_key = _encode_label_rows([p[2] for p in pods], vocab)
    ips = [p[3] for p in pods]
    pod_ip, pod_ip_valid = _encode_pod_ips(ips)
    return ClusterEncoding(
        vocab=vocab,
        pod_keys=[f"{p[0]}/{p[1]}" for p in pods],
        pod_ns_id=pod_ns_id,
        pod_kv=pod_kv,
        pod_key=pod_key,
        pod_ip=pod_ip,
        pod_ip_valid=pod_ip_valid,
        pod_ips=list(ips),
        ns_kv=ns_kv,
        ns_key=ns_key,
    )


@dataclass
class _SelectorTable:
    """Deduped selectors encoded as fixed-width arrays."""

    index: Dict[str, int] = field(default_factory=dict)
    selectors: List[LabelSelector] = field(default_factory=list)
    # object-level memo in front of the serialize-keyed dedup: selectors
    # are frozen/hashable, and serialize_label_selector (json.dumps) is
    # the encode hot spot at 10k+ policies.  Memo and serialization read
    # the same fields (serialization preserves expression order, as does
    # dataclass equality), so the memo can never merge selectors the
    # index would keep distinct.
    _memo: Dict[LabelSelector, int] = field(default_factory=dict)

    def sel_id(self, selector: LabelSelector) -> int:
        sid = self._memo.get(selector)
        if sid is not None:
            return sid
        key = serialize_label_selector(selector)
        if key not in self.index:
            self.index[key] = len(self.selectors)
            self.selectors.append(selector)
        sid = self.index[key]
        self._memo[selector] = sid
        return sid

    def encode(self, vocab: _Vocab):
        n = len(self.selectors)
        max_r = max((len(s.match_labels_items) for s in self.selectors), default=0)
        max_e = max((len(s.match_expressions) for s in self.selectors), default=0)
        max_v = max(
            (
                len(e.values)
                for s in self.selectors
                for e in s.match_expressions
            ),
            default=0,
        )
        max_r, max_e, max_v = max(max_r, 1), max(max_e, 1), max(max_v, 1)
        req_kv = np.full((n, max_r), -1, dtype=np.int32)
        exp_op = np.full((n, max_e), EXP_NONE, dtype=np.int32)
        exp_key = np.full((n, max_e), -1, dtype=np.int32)
        exp_vals = np.full((n, max_e, max_v), -1, dtype=np.int32)
        for i, s in enumerate(self.selectors):
            for j, (k, v) in enumerate(s.match_labels_items):
                req_kv[i, j] = vocab.kv_id(k, v)
            for j, e in enumerate(s.match_expressions):
                exp_op[i, j] = _OP_CODES[e.operator]
                exp_key[i, j] = vocab.key_id(e.key)
                for vi, v in enumerate(e.values):
                    exp_vals[i, j, vi] = vocab.kv_id(e.key, v)
        return req_kv, exp_op, exp_key, exp_vals


@dataclass
class _PortSpecBuilder:
    """Per-peer port spec rows."""

    all_flag: List[bool] = field(default_factory=list)
    items: List[List[Tuple[int, int, int, int]]] = field(default_factory=list)
    # item: (kind, port_int, name_id, proto_id)
    ranges: List[List[Tuple[int, int, int]]] = field(default_factory=list)
    # range: (from, to, proto_id)

    def add(self, port_matcher, vocab: _Vocab) -> None:
        if isinstance(port_matcher, AllPortMatcher):
            self.all_flag.append(True)
            self.items.append([])
            self.ranges.append([])
            return
        if not isinstance(port_matcher, SpecificPortMatcher):
            raise TypeError(f"invalid PortMatcher type {type(port_matcher)}")
        items = []
        for pp in port_matcher.ports:
            pid = vocab.proto_id(pp.protocol)
            if pp.port is None:
                items.append((PORT_NIL, 0, -1, pid))
            elif pp.port.is_int:
                items.append((PORT_INT, pp.port.int_value, -1, pid))
            else:
                items.append(
                    (PORT_NAMED, 0, vocab.port_name_id(pp.port.str_value), pid)
                )
        ranges = [
            (r.from_port, r.to_port, vocab.proto_id(r.protocol))
            for r in port_matcher.port_ranges
        ]
        self.all_flag.append(False)
        self.items.append(items)
        self.ranges.append(ranges)

    def encode(self):
        n = len(self.all_flag)
        max_i = max((len(x) for x in self.items), default=0)
        max_r = max((len(x) for x in self.ranges), default=0)
        max_i, max_r = max(max_i, 1), max(max_r, 1)
        item_kind = np.full((n, max_i), -1, dtype=np.int32)  # -1 = pad, no match
        item_port = np.zeros((n, max_i), dtype=np.int32)
        item_name = np.full((n, max_i), -2, dtype=np.int32)  # -2 never equals -1
        item_proto = np.full((n, max_i), -2, dtype=np.int32)
        rng_from = np.zeros((n, max_r), dtype=np.int32)
        rng_to = np.full((n, max_r), -1, dtype=np.int32)  # empty range
        rng_proto = np.full((n, max_r), -2, dtype=np.int32)
        for i in range(n):
            for j, (kind, port, name, proto) in enumerate(self.items[i]):
                item_kind[i, j] = kind
                item_port[i, j] = port
                item_name[i, j] = name
                item_proto[i, j] = proto
            for j, (f, t, proto) in enumerate(self.ranges[i]):
                rng_from[i, j] = f
                rng_to[i, j] = t
                rng_proto[i, j] = proto
        return {
            "spec_all": np.array(self.all_flag, dtype=bool),
            "item_kind": item_kind,
            "item_port": item_port,
            "item_name": item_name,
            "item_proto": item_proto,
            "rng_from": rng_from,
            "rng_to": rng_to,
            "rng_proto": rng_proto,
        }


@dataclass
class _DirectionEncoding:
    """Targets + flattened peers for one direction (ingress or egress).

    Shapes: T targets, P flat peers, X except-block pad width."""

    n_targets: int
    # -1: namespace unknown to cluster
    target_ns: np.ndarray  # shape: (T,) int32; sentinel: -1=pad
    target_sel: np.ndarray  # shape: (T,) int32  # selector id
    # peers, flat (pad peers belong to target -1: zero one-hot row):
    peer_target: np.ndarray  # shape: (P,) int32; sentinel: -1=pad
    # peer's index WITHIN its target (rule provenance for the analysis
    # layer: flat row p is rule (peer_target[p], peer_rule_idx[p]) of
    # the sorted_targets() order)
    peer_rule_idx: np.ndarray  # shape: (P,) int32
    peer_kind: np.ndarray  # shape: (P,) int32
    peer_ns_kind: np.ndarray  # shape: (P,) int32  # (pod peers)
    peer_ns_id: np.ndarray  # shape: (P,) int32; sentinel: -1=pad  # (NS_EXACT)
    peer_ns_sel: np.ndarray  # shape: (P,) int32; sentinel: -1=pad  # (NS_SELECTOR)
    peer_pod_kind: np.ndarray  # shape: (P,) int32
    peer_pod_sel: np.ndarray  # shape: (P,) int32; sentinel: -1=pad
    # ip peers (IPv4 in-kernel; v6 handled via host rows).  base/mask
    # rows are only meaningful where ip_is_v4 — non-v4 rows hold 0,
    # which as uint32 data would be 0.0.0.0/0 (match everything)
    ip_base: np.ndarray  # shape: (P,) uint32; sentinel: 0=inert; mask: ip_is_v4  # (pre-masked)
    ip_mask: np.ndarray  # shape: (P,) uint32; sentinel: 0=inert; mask: ip_is_v4
    ip_is_v4: np.ndarray  # shape: (P,) bool
    ex_base: np.ndarray  # shape: (P, X) uint32; sentinel: 0=inert; mask: ex_valid
    ex_mask: np.ndarray  # shape: (P, X) uint32; sentinel: 0=inert; mask: ex_valid
    ex_valid: np.ndarray  # shape: (P, X) bool
    host_ip_rows: List[Tuple[int, IPPeerMatcher]]  # v6 fallback: peer row -> matcher
    port_spec: Dict[str, np.ndarray]  # per-peer port spec arrays

    @property
    def n_peers(self) -> int:
        return len(self.peer_target)


def _mask_for_prefix(prefix: int) -> int:
    return 0 if prefix == 0 else (0xFFFFFFFF << (32 - prefix)) & 0xFFFFFFFF


def _encode_direction(
    targets, sel_table: _SelectorTable, vocab: _Vocab
) -> _DirectionEncoding:
    t_ns, t_sel = [], []
    p_target, p_rule_idx, p_kind = [], [], []
    p_ns_kind, p_ns_id, p_ns_sel = [], [], []
    p_pod_kind, p_pod_sel = [], []
    ip_rows: List[Tuple[int, int, bool]] = []  # (base, mask, is_v4)
    ex_rows: List[List[Tuple[int, int]]] = []
    host_ip_rows: List[Tuple[int, IPPeerMatcher]] = []
    specs = _PortSpecBuilder()

    for t_idx, target in enumerate(targets):
        # target namespace must match by name; namespaces not present in the
        # cluster can't match any pod, but we register them in the vocab so
        # equality against pod ns ids is well-defined either way.
        t_ns.append(vocab.ns_id(target.namespace))
        t_sel.append(sel_table.sel_id(target.pod_selector))
        for peer_idx, peer in enumerate(target.peers):
            p_target.append(t_idx)
            p_rule_idx.append(peer_idx)
            if isinstance(peer, AllPeersMatcher):
                p_kind.append(PEER_ALL)
                specs.add(AllPortMatcher(), vocab)
                p_ns_kind.append(NS_ALL)
                p_ns_id.append(-1)
                p_ns_sel.append(-1)
                p_pod_kind.append(POD_ALL)
                p_pod_sel.append(-1)
                ip_rows.append((0, 0, False))
                ex_rows.append([])
            elif isinstance(peer, PortsForAllPeersMatcher):
                p_kind.append(PEER_ALL_PORTS)
                specs.add(peer.port, vocab)
                p_ns_kind.append(NS_ALL)
                p_ns_id.append(-1)
                p_ns_sel.append(-1)
                p_pod_kind.append(POD_ALL)
                p_pod_sel.append(-1)
                ip_rows.append((0, 0, False))
                ex_rows.append([])
            elif isinstance(peer, IPPeerMatcher):
                p_kind.append(PEER_IP)
                specs.add(peer.port, vocab)
                p_ns_kind.append(NS_ALL)
                p_ns_id.append(-1)
                p_ns_sel.append(-1)
                p_pod_kind.append(POD_ALL)
                p_pod_sel.append(-1)
                bp = cidr_to_base_and_prefix(peer.ip_block.cidr)
                if bp is None:
                    # IPv6 CIDR: evaluate host-side (rare), kernel row inert
                    ip_rows.append((0, 0, False))
                    ex_rows.append([])
                    host_ip_rows.append((len(p_target) - 1, peer))
                else:
                    base, prefix = bp
                    mask = _mask_for_prefix(prefix)
                    ip_rows.append((base & mask, mask, True))
                    exs = []
                    v6_except = False
                    for ex in peer.ip_block.except_:
                        ebp = cidr_to_base_and_prefix(ex)
                        if ebp is None:
                            v6_except = True
                            continue
                        ebase, eprefix = ebp
                        emask = _mask_for_prefix(eprefix)
                        exs.append((ebase & emask, emask))
                    if v6_except:
                        # mixed-family excepts: fall back to host eval for
                        # exactness
                        ip_rows[-1] = (0, 0, False)
                        exs = []
                        host_ip_rows.append((len(p_target) - 1, peer))
                    ex_rows.append(exs)
            elif isinstance(peer, PodPeerMatcher):
                p_kind.append(PEER_POD)
                specs.add(peer.port, vocab)
                ns = peer.namespace
                if isinstance(ns, ExactNamespaceMatcher):
                    p_ns_kind.append(NS_EXACT)
                    p_ns_id.append(vocab.ns_id(ns.namespace))
                    p_ns_sel.append(-1)
                elif isinstance(ns, LabelSelectorNamespaceMatcher):
                    p_ns_kind.append(NS_SELECTOR)
                    p_ns_id.append(-1)
                    p_ns_sel.append(sel_table.sel_id(ns.selector))
                elif isinstance(ns, AllNamespaceMatcher):
                    p_ns_kind.append(NS_ALL)
                    p_ns_id.append(-1)
                    p_ns_sel.append(-1)
                else:
                    raise TypeError(f"invalid NamespaceMatcher {type(ns)}")
                pod = peer.pod
                if isinstance(pod, AllPodMatcher):
                    p_pod_kind.append(POD_ALL)
                    p_pod_sel.append(-1)
                elif isinstance(pod, LabelSelectorPodMatcher):
                    p_pod_kind.append(POD_SELECTOR)
                    p_pod_sel.append(sel_table.sel_id(pod.selector))
                else:
                    raise TypeError(f"invalid PodMatcher {type(pod)}")
                ip_rows.append((0, 0, False))
                ex_rows.append([])
            else:
                raise TypeError(f"invalid PeerMatcher type {type(peer)}")

    n_p = len(p_target)
    max_x = max((len(x) for x in ex_rows), default=0)
    max_x = max(max_x, 1)
    ex_base = np.zeros((n_p, max_x), dtype=np.uint32)
    ex_mask = np.zeros((n_p, max_x), dtype=np.uint32)
    ex_valid = np.zeros((n_p, max_x), dtype=bool)
    for i, exs in enumerate(ex_rows):
        for j, (b, m) in enumerate(exs):
            ex_base[i, j] = b
            ex_mask[i, j] = m
            ex_valid[i, j] = True

    return _DirectionEncoding(
        n_targets=len(t_ns),
        target_ns=np.array(t_ns, dtype=np.int32).reshape(-1),
        target_sel=np.array(t_sel, dtype=np.int32).reshape(-1),
        peer_target=np.array(p_target, dtype=np.int32).reshape(-1),
        peer_rule_idx=np.array(p_rule_idx, dtype=np.int32).reshape(-1),
        peer_kind=np.array(p_kind, dtype=np.int32).reshape(-1),
        peer_ns_kind=np.array(p_ns_kind, dtype=np.int32).reshape(-1),
        peer_ns_id=np.array(p_ns_id, dtype=np.int32).reshape(-1),
        peer_ns_sel=np.array(p_ns_sel, dtype=np.int32).reshape(-1),
        peer_pod_kind=np.array(p_pod_kind, dtype=np.int32).reshape(-1),
        peer_pod_sel=np.array(p_pod_sel, dtype=np.int32).reshape(-1),
        ip_base=np.array([r[0] for r in ip_rows], dtype=np.uint32).reshape(-1),
        ip_mask=np.array([r[1] for r in ip_rows], dtype=np.uint32).reshape(-1),
        ip_is_v4=np.array([r[2] for r in ip_rows], dtype=bool).reshape(-1),
        ex_base=ex_base,
        ex_mask=ex_mask,
        ex_valid=ex_valid,
        host_ip_rows=host_ip_rows,
        port_spec=specs.encode(),
    )


@dataclass
class TierDirectionEncoding:
    """Precedence-tier rule slabs for one direction.

    One row per (rule, peer scope) pair, flattened over BOTH admin tiers
    (`tier` 0=ANP, 1=BANP) in resolution order: `rank` is the rule's
    position in TierSet.ordered_rules for its tier, shared by all of the
    rule's peer rows — the first-match reduction is a min over matching
    rows of the int32 key rank * 4 + action, so equal-rank rows
    implement the within-rule peer OR exactly.  `action` is the int8
    verdict slab (TIER_ACT_*; 0 = pad, matches nothing — the inert fill
    shape bucketing uses).  Selector ids index the SAME deduped selector
    table as the NetworkPolicy slabs: subject/peer namespace selectors
    are evaluated against namespace labels (selns), pod selectors
    against pod labels (selpod), which is also what keeps the
    equivalence-class pod signature complete under tiers.

    Shapes: G flat tier rows."""

    n_rules: int  # real (pre-flatten) rule count, both tiers
    subj_ns_sel: np.ndarray  # shape: (G,) int32
    subj_pod_kind: np.ndarray  # shape: (G,) int32  # POD_*
    subj_pod_sel: np.ndarray  # shape: (G,) int32; sentinel: -1=pad
    peer_ns_sel: np.ndarray  # shape: (G,) int32
    peer_pod_kind: np.ndarray  # shape: (G,) int32
    peer_pod_sel: np.ndarray  # shape: (G,) int32; sentinel: -1=pad
    action: np.ndarray  # shape: (G,) int8; sentinel: 0=pad
    tier: np.ndarray  # shape: (G,) int8
    rank: np.ndarray  # shape: (G,) int32
    port_spec: Dict[str, np.ndarray] = field(default_factory=dict)

    @property
    def n_rows(self) -> int:
        return int(self.action.shape[0])


def _encode_tier_direction(
    tiers, is_ingress: bool, sel_table: "_SelectorTable", vocab: _Vocab
) -> TierDirectionEncoding:
    """Flatten one direction of a TierSet into slab rows (see
    TierDirectionEncoding).  Selector ids are assigned through the
    SHARED table/vocab so tier selectors ride the same selpod/selns
    kernels as NetworkPolicy selectors."""
    from ..matcher.tiered import compile_tier_port_matcher

    subj_ns, subj_pk, subj_ps = [], [], []
    peer_ns, peer_pk, peer_ps = [], [], []
    action, tier_col, rank = [], [], []
    specs = _PortSpecBuilder()
    act_code = {
        "Allow": TIER_ACT_ALLOW,
        "Deny": TIER_ACT_DENY,
        "Pass": TIER_ACT_PASS,
    }
    n_rules = 0
    for tier_id, tier_name in ((TIER_ANP, "anp"), (TIER_BANP, "banp")):
        for o in tiers.ordered_rules(is_ingress, tier_name):
            n_rules += 1
            subject = o.policy.subject
            s_ns = sel_table.sel_id(subject.namespace_selector)
            if subject.pod_selector is None:
                s_pk, s_ps = POD_ALL, -1
            else:
                s_pk = POD_SELECTOR
                s_ps = sel_table.sel_id(subject.pod_selector)
            pm = compile_tier_port_matcher(o.rule)
            for peer in o.rule.peers:
                subj_ns.append(s_ns)
                subj_pk.append(s_pk)
                subj_ps.append(s_ps)
                peer_ns.append(sel_table.sel_id(peer.namespace_selector))
                if peer.pod_selector is None:
                    peer_pk.append(POD_ALL)
                    peer_ps.append(-1)
                else:
                    peer_pk.append(POD_SELECTOR)
                    peer_ps.append(sel_table.sel_id(peer.pod_selector))
                action.append(act_code[o.rule.action])
                tier_col.append(tier_id)
                rank.append(o.rank)
                specs.add(pm, vocab)
    return TierDirectionEncoding(
        n_rules=n_rules,
        subj_ns_sel=np.array(subj_ns, dtype=np.int32).reshape(-1),
        subj_pod_kind=np.array(subj_pk, dtype=np.int32).reshape(-1),
        subj_pod_sel=np.array(subj_ps, dtype=np.int32).reshape(-1),
        peer_ns_sel=np.array(peer_ns, dtype=np.int32).reshape(-1),
        peer_pod_kind=np.array(peer_pk, dtype=np.int32).reshape(-1),
        peer_pod_sel=np.array(peer_ps, dtype=np.int32).reshape(-1),
        action=np.array(action, dtype=np.int8).reshape(-1),
        tier=np.array(tier_col, dtype=np.int8).reshape(-1),
        rank=np.array(rank, dtype=np.int32).reshape(-1),
        port_spec=specs.encode(),
    )


def encode_tier_directions(
    tiers, sel_table: "_SelectorTable", vocab: _Vocab
) -> Tuple[TierDirectionEncoding, TierDirectionEncoding]:
    """(ingress, egress) tier slabs against the shared selector table."""
    return (
        _encode_tier_direction(tiers, True, sel_table, vocab),
        _encode_tier_direction(tiers, False, sel_table, vocab),
    )


@dataclass
class PolicyEncoding:
    """Full tensor encoding of a compiled Policy against a cluster.

    Selector-table shapes: S deduped selectors, R matchLabels pad
    width, E matchExpressions pad width, V expression-values pad
    width."""

    cluster: ClusterEncoding
    ingress: _DirectionEncoding
    egress: _DirectionEncoding
    # selector arrays (shared by both directions):
    sel_req_kv: np.ndarray  # shape: (S, R) int32; sentinel: -1=pad
    sel_exp_op: np.ndarray  # shape: (S, E) int32  # EXP_NONE pad
    sel_exp_key: np.ndarray  # shape: (S, E) int32; sentinel: -1=pad
    sel_exp_vals: np.ndarray  # shape: (S, E, V) int32; sentinel: -1=pad
    n_selectors: int
    # precedence-tier slabs (None without admin tiers: zero ANP/BANP
    # objects leave the tensor set byte-identical)
    tiers: Optional[Tuple[TierDirectionEncoding, TierDirectionEncoding]] = None


# --- equivalence-class grid compression ----------------------------------
#
# The verdict of pod n is a pure function of what the RESOLVED MATCHER SET
# can observe about n (kernel.py direction_precompute, term by term):
#   * tmatch:     target_ns == pod_ns_id[n]  AND  selpod[target_sel, n]
#   * pod peers:  ns kind (EXACT compares pod_ns_id; SELECTOR goes through
#                 selns[*, pod_ns_id[n]]) and selpod[peer_pod_sel, n]
#   * ip peers:   pod_ip_valid-masked CIDR membership per distinct
#                 (base, mask, excepts) row; host-evaluated v6 rows are a
#                 per-pod bool column of their own
# so the tuple (ns id, selector-match column, CIDR-membership bits,
# host-ip columns) is a COMPLETE signature: pods sharing it are
# indistinguishable to every rule and must receive identical verdict rows
# AND columns.  compute_pod_classes buckets pods by that signature; the
# evaluators then run the unique (src-class x dst-class x port) grid and
# broadcast back with an int32 gather (kernel.gather_class_grids) or an
# exact class-size weighting (tiled.evaluate_grid_counts_classes).
# The CIDR dimension always rides the dense per-spec bits here; the
# tuple-space partition signature is not part of this package.


@dataclass
class PodClasses:
    """Label-equivalence classes over the pod axis.

    Shapes: N pods, C classes.  class_of_pod maps pod row -> class id;
    class_rep is the first member (the row whose tensors stand in for the
    whole class); class_size the member count (the exact weight of a
    class cell when counts broadcast back to the pod grid)."""

    n_pods: int
    n_classes: int
    class_of_pod: np.ndarray  # shape: (N,) int32
    class_rep: np.ndarray  # shape: (C,) int32
    class_size: np.ndarray  # shape: (C,) int32
    # bytes per pod of the signature the classes were derived from
    signature_bytes: int = 0


def encode_pod_rows(
    pods: Sequence[Tuple[str, str, Dict[str, str], str]],
    vocab: _Vocab,
    l_width: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Encode pod tuples against an EXISTING vocab into fixed-width rows:
    (pod_ns_id [k], pod_kv [k, l_width], pod_key, pod_ip, pod_ip_valid).

    The verdict service re-encodes only the touched pod rows: the vocab
    grows monotonically (a label pair/key/namespace new to the cluster
    gets a fresh id, which by construction equals no selector-referenced
    id, so it matches nothing — exactly the fresh-rebuild semantics), and
    existing pairs resolve to their original ids, so a patched row is
    bit-compatible with the rows around it.  Raises ValueError when a pod
    carries more labels than l_width — the caller's signal to fall back to
    a full re-encode."""
    k = len(pods)
    ns_id = np.empty((k,), dtype=np.int32)
    kv = np.full((k, max(l_width, 1)), -1, dtype=np.int32)
    key = np.full((k, max(l_width, 1)), -1, dtype=np.int32)
    for i, (ns, _name, labels, _ip) in enumerate(pods):
        if len(labels) > l_width:
            raise ValueError(
                f"pod row needs {len(labels)} label slots, row width is "
                f"{l_width} (full re-encode required)"
            )
        ns_id[i] = vocab.ns_id(ns)
        # sorted(items) mirrors _encode_label_rows' within-row order
        for j, (lk, lv) in enumerate(sorted(labels.items())):
            kv[i, j] = vocab.kv_id(lk, lv)
            key[i, j] = vocab.key_id(lk)
    ip, ip_valid = _encode_pod_ips([p[3] for p in pods])
    return ns_id, kv, key, ip, ip_valid


def encode_ns_row(
    labels: Dict[str, str], vocab: _Vocab, lns_width: int
) -> Tuple[np.ndarray, np.ndarray]:
    """One namespace-label row (ns_kv, ns_key) of width lns_width against
    an existing vocab; ValueError when the labels don't fit (full
    re-encode required)."""
    if len(labels) > lns_width:
        raise ValueError(
            f"namespace row needs {len(labels)} label slots, row width is "
            f"{lns_width} (full re-encode required)"
        )
    kv = np.full((max(lns_width, 1),), -1, dtype=np.int32)
    key = np.full((max(lns_width, 1),), -1, dtype=np.int32)
    for j, (lk, lv) in enumerate(sorted(labels.items())):
        kv[j] = vocab.kv_id(lk, lv)
        key[j] = vocab.key_id(lk)
    return kv, key


def encode_directions(
    policy: Policy, vocab: _Vocab, tiers=None
) -> Tuple[
    _DirectionEncoding,
    _DirectionEncoding,
    Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray],
    int,
    Optional[Tuple[TierDirectionEncoding, TierDirectionEncoding]],
]:
    """Encode both directions + the shared selector table of a compiled
    Policy against `vocab` (grown in place), plus — when `tiers` (a
    TierSet) is present and non-empty — the precedence-tier slabs, whose
    selector ids live in the SAME table (the table must close over both,
    or tier rows would index selectors the kernel never evaluates): the
    rule-slab half of encode_policy."""
    sel_table = _SelectorTable()
    ingress_targets, egress_targets = policy.sorted_targets()
    ingress = _encode_direction(ingress_targets, sel_table, vocab)
    egress = _encode_direction(egress_targets, sel_table, vocab)
    tier_enc = None
    if tiers:
        tier_enc = encode_tier_directions(tiers, sel_table, vocab)
    sel_arrays = sel_table.encode(vocab)
    return ingress, egress, sel_arrays, len(sel_table.selectors), tier_enc


def _host_ip_cols(tensors: Dict) -> List[np.ndarray]:
    """The host-evaluated (IPv6/mixed-family) ip rows' per-pod match
    columns, both directions — part of the class signature."""
    host_cols: List[np.ndarray] = []
    for direction in ("ingress", "egress"):
        d = tensors[direction]
        if "host_ip_mask" in d:
            for r in np.flatnonzero(d["host_ip_mask"]):
                host_cols.append(np.asarray(d["host_ip_match"][r], dtype=bool))
    return host_cols


def iter_ip_specs(
    tensors: Dict,
) -> List[Tuple[int, int, Tuple[Tuple[int, int], ...]]]:
    """Distinct (base, mask, sorted excepts) in-kernel IPv4 ip-peer
    specs across both directions, in discovery (row) order — the spec
    identity _ip_signature_bits buckets on."""
    specs: Dict[Tuple[int, int, Tuple[Tuple[int, int], ...]], None] = {}
    for direction in ("ingress", "egress"):
        d = tensors[direction]
        rows = np.flatnonzero((d["peer_kind"] == PEER_IP) & d["ip_is_v4"])
        for r in rows:
            exs = tuple(
                sorted(
                    (int(d["ex_base"][r, j]), int(d["ex_mask"][r, j]))
                    for j in np.flatnonzero(d["ex_valid"][r])
                )
            )
            specs.setdefault(
                (int(d["ip_base"][r]), int(d["ip_mask"][r]), exs), None
            )
    return list(specs)


def _ip_signature_bits(tensors: Dict) -> Optional[np.ndarray]:
    """[N, ceil(B/8)] uint8 packed per-pod IP-observability bits, or None
    when no rule observes pod IPs.

    One bit per DISTINCT (base, mask, sorted excepts) IPv4 ip-peer row
    across both directions — the same membership term the kernel
    computes (in_cidr & ~in_except, both pod_ip_valid-masked) — plus one
    bit per host-evaluated (IPv6/mixed) row's match column, plus the
    validity bit itself.  Deduping rows first keeps the bit count at the
    number of distinct CIDR shapes, not the raw peer count: O(specs)
    bits and O(specs x N) work per classify."""
    pod_ip = tensors["pod_ip"]  # shape: (N,) uint32; sentinel: 0=invalid; mask: pod_ip_valid
    pod_ip_valid = tensors["pod_ip_valid"]  # shape: (N,) bool
    n = int(pod_ip.shape[0])
    specs = iter_ip_specs(tensors)
    host_cols = _host_ip_cols(tensors)
    if not specs and not host_cols:
        return None
    bits = np.zeros((len(specs) + len(host_cols) + 1, n), dtype=bool)
    for i, (base, mask, exs) in enumerate(specs):
        # mirrors kernel.direction_precompute: both the CIDR term and
        # every except term consult pod_ip_valid
        m = pod_ip_valid & ((pod_ip & np.uint32(mask)) == np.uint32(base))
        for eb, em in exs:
            m &= ~(pod_ip_valid & ((pod_ip & np.uint32(em)) == np.uint32(eb)))
        bits[i] = m
    for j, col in enumerate(host_cols):
        bits[len(specs) + j] = col
    bits[-1] = pod_ip_valid
    return np.packbits(bits, axis=0).T  # [N, ceil(B/8)]


def _ip_signature_tss(tensors: Dict, cidr) -> np.ndarray:
    """[N, 4K + ceil((H+1)/8)] uint8 TSS signature block: the [K] int32
    per-pod partition signature (cidrspace.CidrSpace.signature — the
    device LPM stage or its numpy twin) viewed as bytes, plus the packed
    host-evaluated columns and the validity bit.

    Sound for compute_pod_classes because pods with equal partition
    signatures match exactly the same atom in every partition, hence
    carry identical membership on every (base, mask, excepts) spec —
    the same bits _ip_signature_bits would emit
    (cidrspace.spec_membership_words).  The TSS block may be FINER than
    the bit block (splitting costs classes, never correctness)."""
    pod_ip = tensors["pod_ip"]  # shape: (N,) uint32; sentinel: 0=invalid; mask: pod_ip_valid
    pod_ip_valid = tensors["pod_ip_valid"]  # shape: (N,) bool
    n = int(pod_ip.shape[0])
    sig = cidr.signature(pod_ip, pod_ip_valid)  # [K, N] int32
    # explicit width (not -1): numpy cannot infer a trailing dim for a
    # zero-size array, and n=0 must keep working (empty-cluster rebuild
    # on the serve path)
    blocks = [
        np.ascontiguousarray(sig.T)
        .view(np.uint8)
        .reshape(n, 4 * int(sig.shape[0]))
    ]
    host_cols = _host_ip_cols(tensors)
    tail = np.zeros((len(host_cols) + 1, n), dtype=bool)
    for j, col in enumerate(host_cols):
        tail[j] = col
    tail[-1] = pod_ip_valid
    blocks.append(np.packbits(tail, axis=0).T)
    return np.concatenate(blocks, axis=1)


#: `cidr` default for pod_signatures/compute_pod_classes: resolve the
#: TSS stage from the env + tensors (engine/cidrspace.py).  Distinct
#: from None, which means "explicitly dense bits" — the engine passes
#: its resolved space (or None) so build and serve never disagree
CIDR_AUTO = "auto"


def pod_signatures(
    tensors: Dict, selpod: np.ndarray, cidr=CIDR_AUTO
) -> np.ndarray:
    """[N, K] uint8 packed per-pod observability signatures: ns id bytes
    + packed selector-match bits + the IP-observability block (see the
    class-compression design note above).  Pods with equal rows are
    indistinguishable to every rule.

    `cidr` selects the IP block's form: a cidrspace.CidrSpace routes the
    CIDR dimension through the TSS/LPM partition signature ([K] int32
    per pod); None keeps the dense per-spec bits; CIDR_AUTO (default)
    resolves from the env/tensors, which derives the same space an
    engine build would (its device leg on the current CUDA device).

    The delta path recomputes single rows of this matrix (a one-pod
    `tensors` view + the pod's [S, 1] selpod column); the row width
    depends only on the selector count and the ip-peer spec/partition
    structure, so it is stable across pod-only deltas."""
    n = int(tensors["pod_ns_id"].shape[0])
    blocks = [
        np.ascontiguousarray(
            tensors["pod_ns_id"].astype(np.int32, copy=False).reshape(n, 1)
        ).view(np.uint8).reshape(n, 4)
    ]
    if selpod.shape[0]:
        if selpod.shape[1] != n:
            raise ValueError(
                f"selpod covers {selpod.shape[1]} pods but tensors hold {n}"
            )
        blocks.append(np.packbits(selpod, axis=0).T)  # [N, ceil(S/8)]
    if cidr is CIDR_AUTO:
        from .cidrspace import resolve as _resolve_cidr

        cidr = _resolve_cidr(tensors)
    if cidr is not None:
        blocks.append(_ip_signature_tss(tensors, cidr))
    else:
        ip_bits = _ip_signature_bits(tensors)
        if ip_bits is not None:
            blocks.append(ip_bits)
    return np.ascontiguousarray(np.concatenate(blocks, axis=1))


def classes_from_signatures(buf: np.ndarray) -> PodClasses:
    """PodClasses from a [N, K] signature matrix: one np.unique over the
    void row view."""
    n = int(buf.shape[0])
    if n == 0:
        z = np.zeros((0,), dtype=np.int32)
        return PodClasses(
            n_pods=0, n_classes=0, class_of_pod=z,
            class_rep=z.copy(), class_size=z.copy(),
        )
    rows = buf.view(np.dtype((np.void, buf.shape[1]))).reshape(n)
    _, rep, inv, counts = np.unique(
        rows, return_index=True, return_inverse=True, return_counts=True
    )
    return PodClasses(
        n_pods=n,
        n_classes=int(rep.size),
        class_of_pod=inv.astype(np.int32).reshape(n),
        class_rep=rep.astype(np.int32).reshape(-1),
        class_size=counts.astype(np.int32).reshape(-1),
        signature_bytes=int(buf.shape[1]),
    )


def compute_pod_classes(
    tensors: Dict, selpod: np.ndarray, cidr=CIDR_AUTO
) -> PodClasses:
    """Bucket pods into label-equivalence classes.

    `tensors` is the engine tensor dict BEFORE shape bucketing (real pod
    rows only); `selpod` the [S, N] host selector-match matrix over the
    same rows (host._selector_pod_matches_host — the identical pass that
    feeds dead-target compaction); `cidr` a resolved cidrspace.CidrSpace
    / None / CIDR_AUTO exactly as pod_signatures takes it.  Numpy plus
    the optional device LPM stage: one packed signature matrix, one
    np.unique over its void view."""
    n = int(tensors["pod_ns_id"].shape[0])
    if n == 0:
        return classes_from_signatures(np.zeros((0, 1), dtype=np.uint8))
    return classes_from_signatures(pod_signatures(tensors, selpod, cidr=cidr))


def gather_class_pod_rows(tensors: Dict, class_rep: np.ndarray) -> Dict:
    """The compressed tensor dict: per-pod arrays gathered at the class
    representatives (pod axis N -> class axis C); policy tensors shared
    by reference.  host_ip_match columns gather too — a host-evaluated
    row's column is part of the class signature, so the representative's
    value is the class value."""
    t = dict(tensors)
    for k in ("pod_ns_id", "pod_kv", "pod_key", "pod_ip", "pod_ip_valid"):
        t[k] = np.ascontiguousarray(t[k][class_rep])
    for direction in ("ingress", "egress"):
        d = t[direction]
        if "host_ip_match" in d:
            d = dict(d)
            d["host_ip_match"] = np.ascontiguousarray(
                d["host_ip_match"][:, class_rep]
            )
            t[direction] = d
    return t


def _rows_as_bytes(arrays: Sequence[np.ndarray]) -> np.ndarray:
    """[R, K] uint8 matrix whose row r concatenates the bytes of row r of
    every input array (1-D or 2-D; bools and ints alike)."""
    blocks = []
    r = int(arrays[0].shape[0])
    for a in arrays:
        a = np.ascontiguousarray(a)
        blocks.append(a.view(np.uint8).reshape(r, -1))
    return np.concatenate(blocks, axis=1)


def compress_rule_axes(d: Dict) -> Tuple[Dict, Dict[str, int]]:
    """Tuple-space partition compression of one direction's rule axes.

    Two exact reductions (verdicts depend on the target/peer axes only
    through OR-reductions, so duplicates are redundant):

      1. targets with identical (namespace, selector) merge into one row
         — their tmatch rows are equal, and ORing their peer sets under
         one row preserves any_allow > 0 and has_target exactly;
      2. flat peer rules that are byte-identical across every matcher
         array, their port-spec row, and their (merged) target collapse
         to one row — the peer->target one-hot matmul only feeds a > 0
         threshold, so multiplicity never matters.

    Host-evaluated ip rows (host_ip_mask) never merge: their [N] match
    columns live outside the row signature.  Returns the compressed
    direction dict + stats, including `partitions`: the number of
    distinct rule tuples ignoring the target — the tuple-space partition
    count in the TSS sense."""
    t_ns, t_sel = d["target_ns"], d["target_sel"]
    t = int(t_ns.shape[0])
    p = int(d["peer_target"].shape[0])
    stats = {
        "targets_before": t, "targets_after": t,
        "peers_before": p, "peers_after": p, "partitions": 0,
    }
    if t == 0 or p == 0:
        return d, stats
    tkey = np.stack([t_ns, t_sel], axis=1)
    uniq_t, t_inv = np.unique(tkey, axis=0, return_inverse=True)
    t_inv = t_inv.astype(np.int32).reshape(-1)
    pt = d["peer_target"]
    new_pt = np.where(pt >= 0, t_inv[np.clip(pt, 0, t - 1)], np.int32(-1))

    peer_arrays = [new_pt.reshape(-1, 1)]
    for k in (
        "peer_kind", "peer_ns_kind", "peer_ns_id", "peer_ns_sel",
        "peer_pod_kind", "peer_pod_sel", "ip_base", "ip_mask", "ip_is_v4",
        "ex_base", "ex_mask", "ex_valid",
    ):
        peer_arrays.append(d[k])
    for k in sorted(d["port_spec"]):
        peer_arrays.append(d["port_spec"][k])
    # host rows: a unique per-row tag keeps them out of every merge group
    host_tag = np.full((p,), -1, dtype=np.int32)
    if "host_ip_mask" in d:
        hr = np.flatnonzero(d["host_ip_mask"])
        host_tag[hr] = np.arange(hr.size, dtype=np.int32)
    peer_arrays.append(host_tag.reshape(-1, 1))
    key_bytes = _rows_as_bytes(peer_arrays)
    rows = np.ascontiguousarray(key_bytes).view(
        np.dtype((np.void, key_bytes.shape[1]))
    ).reshape(p)
    _, keep = np.unique(rows, return_index=True)
    keep = np.sort(keep)
    # partition count: same signature with the target column blanked
    part_bytes = key_bytes[:, 4:]
    part_rows = np.ascontiguousarray(part_bytes).view(
        np.dtype((np.void, part_bytes.shape[1]))
    ).reshape(p)
    stats["partitions"] = int(np.unique(part_rows).size)

    nd = dict(d)
    nd["target_ns"] = np.ascontiguousarray(uniq_t[:, 0].astype(np.int32))
    nd["target_sel"] = np.ascontiguousarray(uniq_t[:, 1].astype(np.int32))
    nd["peer_target"] = np.ascontiguousarray(new_pt[keep])
    for k in (
        "peer_kind", "peer_ns_kind", "peer_ns_id", "peer_ns_sel",
        "peer_pod_kind", "peer_pod_sel", "ip_base", "ip_mask", "ip_is_v4",
        "ex_base", "ex_mask", "ex_valid",
    ):
        nd[k] = np.ascontiguousarray(d[k][keep])
    if "host_ip_mask" in d:
        nd["host_ip_mask"] = np.ascontiguousarray(d["host_ip_mask"][keep])
    if "host_ip_match" in d:
        nd["host_ip_match"] = np.ascontiguousarray(d["host_ip_match"][keep])
    nd["port_spec"] = {
        k: np.ascontiguousarray(v[keep]) for k, v in d["port_spec"].items()
    }
    stats["targets_after"] = int(uniq_t.shape[0])
    stats["peers_after"] = int(keep.size)
    return nd, stats


def encode_policy(
    policy: Policy,
    pods: Sequence[Tuple[str, str, Dict[str, str], str]],
    namespaces: Dict[str, Dict[str, str]],
    tiers=None,
) -> PolicyEncoding:
    """Compile (policy, cluster) to tensors.  The selector/label vocabulary
    is built jointly so every selector-referenced pair has an id.  `tiers`
    (an optional TierSet) adds the precedence-tier slabs; with it absent or
    empty the encoding is byte-identical to the networkingv1-only form."""
    vocab = _Vocab()
    ingress, egress, sel_arrays, n_selectors, tier_enc = encode_directions(
        policy, vocab, tiers=tiers
    )
    cluster = encode_cluster(pods, namespaces, vocab=vocab)
    sel_req_kv, sel_exp_op, sel_exp_key, sel_exp_vals = sel_arrays
    return PolicyEncoding(
        cluster=cluster,
        ingress=ingress,
        egress=egress,
        sel_req_kv=sel_req_kv,
        sel_exp_op=sel_exp_op,
        sel_exp_key=sel_exp_key,
        sel_exp_vals=sel_exp_vals,
        n_selectors=n_selectors,
        tiers=tier_enc,
    )
