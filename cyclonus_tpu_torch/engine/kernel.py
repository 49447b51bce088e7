"""Verdict kernels in plain PyTorch (the reference's engine/kernel.py,
which was plain XLA: none of these is a hand-written kernel there).

The decision procedure mirrors matcher/core.py (and thus the reference's
policy.go:138-174):

  per direction d in {ingress, egress}:
    selpod[S, N]      selector s matches pod n's labels        (int compares)
    tmatch[T, N]      target t applies to pod n                (ns eq AND sel)
    peer_match[P, N]  peer p matches pod n (ports aside)       (kind switch)
    pport[P, Q]       peer p's port spec allows port case q    (int compares)
    peer_allow[P,N,Q] = peer_match & pport
    tallow[T, N, Q]   = one_hot(peer->target) @ peer_allow     <- matmul
    any_allow[n,m,Q]  = tmatch^T @ tallow                      <- matmul or
                                                                  packed words
    allowed[n, m, q]  = NOT has_target[n] OR any_allow > 0

  combined[s, d, q] = egress_allowed[s, d, q] AND ingress_allowed[d, s, q]

With precedence tiers each direction's verdict then passes through the
ANP -> NetworkPolicy -> BANP lattice (resolve_tier_lattice).

All tensors are boolean/integer.  Torch has no boolean matmul, so the
products run in a float type and threshold at > 0: inputs are 0/1, so a
positive sum can never round to zero and the threshold is exact.
Pod IPs and CIDR bases/masks arrive widened to int64 (carry.py).
"""

from __future__ import annotations

from typing import Dict

import torch

from .encoding import (
    EXP_EXISTS,
    EXP_IN,
    EXP_NONE,
    EXP_NOT_IN,
    NS_EXACT,
    NS_SELECTOR,
    PACK_BITS,
    PEER_ALL,
    PEER_ALL_PORTS,
    PEER_IP,
    POD_SELECTOR,
    PORT_INT,
    PORT_NAMED,
    PORT_NIL,
    TIER_ACT_ALLOW,
    TIER_ACT_NONE,
    TIER_ACT_PASS,
    TIER_ANP,
    TIER_BANP,
    TIER_KEY_NONE,
    packed_words,
)
from ..utils import contracts

#: element budget of one selector_match chunk's largest broadcast
#: intermediate ([S, chunk, E, V, L] bools): eager torch materialises
#: what XLA fused, so the pod axis is walked in chunks
_SELECTOR_CHUNK_ELEMS = 1 << 27


def _selector_match_chunk(sel_req_kv, sel_exp_op, sel_exp_key, sel_exp_vals, kv, key):
    present = torch.any(
        kv[None, :, None, :] == sel_req_kv[:, None, :, None], dim=-1
    )  # [S, N, R]
    req_ok = torch.all((sel_req_kv[:, None, :] == -1) | present, dim=-1)  # [S, N]
    has_key = torch.any(
        key[None, :, None, :] == sel_exp_key[:, None, :, None], dim=-1
    )  # [S, N, E]
    val_hit = (
        (sel_exp_vals[:, None, :, :, None] != -1)
        & (kv[None, :, None, None, :] == sel_exp_vals[:, None, :, :, None])
    ).flatten(-2).any(dim=-1)  # [S, N, E]
    op = sel_exp_op[:, None, :]  # [S, 1, E]
    exp_ok = torch.where(
        op == EXP_NONE,
        True,
        torch.where(
            op == EXP_IN,
            has_key & val_hit,
            torch.where(
                op == EXP_NOT_IN,
                has_key & ~val_hit,
                torch.where(op == EXP_EXISTS, has_key, ~has_key),
            ),
        ),
    )  # [S, N, E]
    return req_ok & torch.all(exp_ok, dim=-1)


@contracts.args(
    sel_req_kv="(S, R) int32",
    sel_exp_op="(S, E) int32",
    sel_exp_key="(S, E) int32",
    sel_exp_vals="(S, E, V) int32",
    kv="(N, L) int32",
    key="(N, L) int32",
)
def selector_match(
    sel_req_kv: torch.Tensor,  # [S, R]
    sel_exp_op: torch.Tensor,  # [S, E]
    sel_exp_key: torch.Tensor,  # [S, E]
    sel_exp_vals: torch.Tensor,  # [S, E, V]
    kv: torch.Tensor,  # [N, L]
    key: torch.Tensor,  # [N, L]
) -> torch.Tensor:
    """[S, N] bool: selector s matches label-set n.
    Mirrors kube/labels.py is_labels_match_label_selector."""
    s, r = sel_req_kv.shape
    e, v = sel_exp_vals.shape[1:3]
    n, l = kv.shape
    per_row = max(s, 1) * max(r * l, e * v * l, 1)
    chunk = max(64, _SELECTOR_CHUNK_ELEMS // per_row)
    if n <= chunk:
        return _selector_match_chunk(
            sel_req_kv, sel_exp_op, sel_exp_key, sel_exp_vals, kv, key
        )
    return torch.cat(
        [
            _selector_match_chunk(
                sel_req_kv, sel_exp_op, sel_exp_key, sel_exp_vals,
                kv[lo : lo + chunk], key[lo : lo + chunk],
            )
            for lo in range(0, n, chunk)
        ],
        dim=1,
    )


@contracts.args(
    selpod="(S, N) bool",
    selns="(S, M) bool",
    pod_ns_id="(N,) int32",
    pod_ip="(N,) int64",  # the reference's uint32, widened on the device (carry.py)
    pod_ip_valid="(N,) bool",
)
def direction_precompute(
    enc: Dict[str, torch.Tensor],
    selpod: torch.Tensor,  # [S, N] selector-vs-pod-labels
    selns: torch.Tensor,  # [S, M] selector-vs-namespace-labels
    pod_ns_id: torch.Tensor,  # [N] int32
    pod_ip: torch.Tensor,  # [N] int64 (widened uint32)
    pod_ip_valid: torch.Tensor,  # [N] bool
) -> Dict[str, torch.Tensor]:
    """Per-direction pod-resolution: tmatch[T, N], has_target[N],
    peer_match[P, N]."""
    tmatch, has_target = target_match(enc, selpod, pod_ns_id)
    ip_ok = ip_rows_match(enc, pod_ip, pod_ip_valid)
    kind = enc["peer_kind"][:, None]
    peer_match = torch.where(
        kind == PEER_IP, ip_ok, selector_peer_match(enc, selpod, selns, pod_ns_id)
    )  # [P, N]
    return {"tmatch": tmatch, "has_target": has_target, "peer_match": peer_match}


def target_match(enc: Dict[str, torch.Tensor], selpod: torch.Tensor, pod_ns_id: torch.Tensor):
    """(tmatch [T, N], has_target [N]): target t applies to pod n by
    namespace name equality and its pod selector."""
    tmatch = (enc["target_ns"][:, None] == pod_ns_id[None, :]) & selpod[
        enc["target_sel"].long()
    ]  # [T, N]
    return tmatch, torch.any(tmatch, dim=0)


def selector_peer_match(
    enc: Dict[str, torch.Tensor],
    selpod: torch.Tensor,  # [S, N]
    selns: torch.Tensor,  # [S, M]
    pod_ns_id: torch.Tensor,  # [N] int32
) -> torch.Tensor:
    """[P, N] bool: the peer rows of `enc` (all of them, or the rows a
    caller gathered) against each pod, ip peers aside: every pod for the
    all-peers kinds, else the namespace term and the pod selector."""
    # pod-peer namespace matching; a pad pod's ns id -1 wraps to the last
    # namespace row exactly as the reference's take does (the pad column
    # is masked wherever it could count)
    ns_sel_match = selns[enc["peer_ns_sel"].clamp(min=0).long()]  # [P, M]
    ns_match_by_pod = ns_sel_match[:, pod_ns_id.long()]  # [P, N]
    ns_kind = enc["peer_ns_kind"][:, None]
    ns_ok = torch.where(
        ns_kind == NS_EXACT,
        enc["peer_ns_id"][:, None] == pod_ns_id[None, :],
        torch.where(ns_kind == NS_SELECTOR, ns_match_by_pod, True),
    )  # [P, N]

    # pod-peer pod matching
    pod_sel_match = selpod[enc["peer_pod_sel"].clamp(min=0).long()]  # [P, N]
    pod_ok = torch.where(
        enc["peer_pod_kind"][:, None] == POD_SELECTOR, pod_sel_match, True
    )
    kind = enc["peer_kind"][:, None]
    return torch.where((kind == PEER_ALL) | (kind == PEER_ALL_PORTS), True, ns_ok & pod_ok)


def ip_rows_match(
    enc: Dict[str, torch.Tensor],
    pod_ip: torch.Tensor,  # [N] int64 (widened uint32)
    pod_ip_valid: torch.Tensor,  # [N] bool
) -> torch.Tensor:
    """[P, N] bool: the ipBlock of each peer row of `enc` (all of them,
    or the rows a caller gathered) holds pod n's IPv4 address: inside the
    CIDR and outside every except (IPv4 kernel; v6 rows are patched
    host-side, apply_host_ip).  pod_ip's 0-sentinel is a real address
    (0.0.0.0), so both the CIDR and the except terms consult
    pod_ip_valid.  The uint32 CIDR columns travel widened to int64 like
    pod_ip (carry.py): .long() returns them as is."""
    ip_base, ip_mask = enc["ip_base"].long(), enc["ip_mask"].long()
    ex_base, ex_mask = enc["ex_base"].long(), enc["ex_mask"].long()
    in_cidr = (
        enc["ip_is_v4"][:, None]
        & pod_ip_valid[None, :]
        & ((pod_ip[None, :] & ip_mask[:, None]) == ip_base[:, None])
    )  # [P, N]
    in_except = torch.any(
        enc["ex_valid"][:, :, None]
        & pod_ip_valid[None, None, :]
        & (
            (pod_ip[None, None, :] & ex_mask[:, :, None])
            == ex_base[:, :, None]
        ),
        dim=1,
    )  # [P, N]
    return in_cidr & ~in_except


@contracts.args(
    q_port="(Q,) int32", q_name="(Q,) int32", q_proto="(Q,) int32"
)
def port_spec_allows(
    spec: Dict[str, torch.Tensor],
    q_port: torch.Tensor,  # [Q] int32
    q_name: torch.Tensor,  # [Q] int32 (-1: unnamed)
    q_proto: torch.Tensor,  # [Q] int32
) -> torch.Tensor:
    """[P, Q] bool: peer p's port matcher allows port case q.
    Mirrors matcher/core.py SpecificPortMatcher.allows / AllPortMatcher."""
    kind = spec["item_kind"][:, :, None]  # [P, I, 1]
    proto_ok = spec["item_proto"][:, :, None] == q_proto[None, None, :]
    item_ok = torch.where(
        kind == PORT_NIL,
        proto_ok,
        torch.where(
            kind == PORT_INT,
            (spec["item_port"][:, :, None] == q_port[None, None, :]) & proto_ok,
            torch.where(
                kind == PORT_NAMED,
                (spec["item_name"][:, :, None] == q_name[None, None, :]) & proto_ok,
                False,  # pad
            ),
        ),
    )  # [P, I, Q]
    rng_ok = (
        (spec["rng_from"][:, :, None] <= q_port[None, None, :])
        & (q_port[None, None, :] <= spec["rng_to"][:, :, None])
        & (spec["rng_proto"][:, :, None] == q_proto[None, None, :])
    )  # [P, R, Q]
    any_ok = torch.any(item_ok, dim=1) | torch.any(rng_ok, dim=1)
    return spec["spec_all"][:, None] | any_ok  # [P, Q]


def _bool_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a @ b) > 0 for bool operands: bf16 on the card, float32 on the
    CPU (where bf16 products are slow); exact either way for 0/1
    inputs."""
    dtype = torch.float32 if a.device.type == "cpu" else torch.bfloat16
    return torch.matmul(a.to(dtype), b.to(dtype)) > 0


# --- bit-packed contraction ------------------------------------------------

#: the int32 value of each bit of a packed word; bit 31 is the sign, so
#: its weight is -2^31 and the word sum never leaves the int32 range
_BIT_WEIGHTS = [1 << b for b in range(PACK_BITS - 1)] + [-(1 << (PACK_BITS - 1))]


def pack_bool_words_torch(a: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Torch twin of encoding.pack_bool_words: pack a bool tensor
    32-per-int32-word along `dim`.  Bit b of word w holds element
    w * 32 + b; bit values are summed as disjoint weights — exactly the
    bitwise OR, with bit 31 riding the int32 sign — so the twins are
    bit-identical by construction."""
    a = torch.movedim(a, dim, 0)
    t = a.shape[0]
    w = packed_words(t)
    pad = w * PACK_BITS - t
    if pad:
        a = torch.cat([a, a.new_zeros((pad,) + tuple(a.shape[1:]))], dim=0)
    bits = a.reshape((w, PACK_BITS) + tuple(a.shape[1:]))
    words = torch.zeros((w,) + tuple(a.shape[1:]), dtype=torch.int32, device=a.device)
    for b, weight in enumerate(_BIT_WEIGHTS):
        # one fused pass a bit: the bool slice promotes inside the add
        words.add_(bits[:, b], alpha=weight)
    return torch.movedim(words, 0, dim)


def packed_any(a_pk: torch.Tensor, b_pk: torch.Tensor) -> torch.Tensor:
    """[A, B] bool: OR_w (a_pk[w, a] AND b_pk[w, b]) != 0 — the packed
    twin of `_bool_matmul(a.T, b)` over a [T, A] x [T, B] contraction,
    with the target axis pre-packed 32-per-word (a_pk [W, A], b_pk
    [W, B] int32).  One [A, B] int32 accumulator walks the W words."""
    acc = torch.zeros(
        (a_pk.shape[1], b_pk.shape[1]), dtype=torch.int32, device=a_pk.device
    )
    for w in range(a_pk.shape[0]):
        acc |= a_pk[w][:, None] & b_pk[w][None, :]
    return acc != 0


def m_tp_onehot(enc: Dict) -> torch.Tensor:
    """[T, P] bool peer->target one-hot, built on the device from the
    [P] peer_target index vector (pad peers carry -1: a zero column)."""
    t = enc["target_ns"].shape[0]
    pt = enc["peer_target"]
    return pt[None, :] == torch.arange(t, dtype=pt.dtype, device=pt.device)[:, None]


def direction_allowed(
    tmatch_target: torch.Tensor,  # [T, Nt] target-side pods
    has_target: torch.Tensor,  # [Nt]
    m_tp: torch.Tensor,  # [T, P] peer->target one-hot
    peer_match: torch.Tensor,  # [P, Np] peer-side pods
    pport: torch.Tensor,  # [P, Q]
    pack: bool = False,
) -> torch.Tensor:
    """[Nt, Np, Q] bool: direction verdict for (target-side pod, peer-side
    pod, port case).  With pack=True the target-axis contraction runs
    over 32-per-word packed bitmaps (packed_any) instead of the float
    matmul — identical by construction."""
    n_p, n_np = peer_match.shape
    q = pport.shape[1]
    peer_allow = (peer_match[:, :, None] & pport[:, None, :]).reshape(n_p, n_np * q)
    tallow = _bool_matmul(m_tp, peer_allow)  # [T, Np*Q]
    if pack:
        any_allow = packed_any(
            pack_bool_words_torch(tmatch_target),  # [W, Nt]
            pack_bool_words_torch(tallow),  # [W, Np*Q]
        )
    else:
        any_allow = _bool_matmul(tmatch_target.T, tallow)  # [Nt, Np*Q]
    allowed = (~has_target[:, None]) | any_allow
    return allowed.reshape(-1, n_np, q)


def selector_tables(tensors: Dict):
    """(selpod [S, N], selns [S, M]): every selector against the pod and
    the namespace label rows."""
    sel = (
        tensors["sel_req_kv"],
        tensors["sel_exp_op"],
        tensors["sel_exp_key"],
        tensors["sel_exp_vals"],
    )
    selpod = selector_match(*sel, tensors["pod_kv"], tensors["pod_key"])
    selns = selector_match(*sel, tensors["ns_kv"], tensors["ns_key"])
    return selpod, selns


def apply_host_ip(enc: Dict, peer_match: torch.Tensor) -> torch.Tensor:
    """Patch the host-evaluated (IPv6 / mixed-family) ip-peer rows."""
    if "host_ip_match" in enc:
        return torch.where(
            enc["host_ip_mask"][:, None], enc["host_ip_match"], peer_match
        )
    return peer_match


@contracts.args(
    # the reference's uint32 operands, widened on the device (carry.py)
    pod_ip="(N,) int64",
    pod_ip_valid="(N,) bool",
    pmask="(K,) int64",
    pbases="(K, B) int64",
    pindex="(K, B) int32",
)
def lpm_partition_signature(
    pod_ip: torch.Tensor,  # [N] int64 (widened uint32)
    pod_ip_valid: torch.Tensor,  # [N] bool
    pmask: torch.Tensor,  # [K] int64 partition masks (LPM order)
    pbases: torch.Tensor,  # [K, B] int64 sorted bases, 0xFFFFFFFF pad
    pindex: torch.Tensor,  # [K, B] int32 global atom ids, -1 pad
) -> torch.Tensor:
    """[K, N] int32 TSS/LPM partition signature (engine/cidrspace.py):
    the global atom index pod n's IP matches within partition k, or -1
    (no base equals pod_ip & pmask[k], or the IP is invalid).  Within a
    partition at most one base can match — pod_ip & mask is one value —
    so the leftmost binary search over the sorted bases is the whole
    trie walk: one batched searchsorted over the K rows.  The uint32
    operands arrive widened to int64 (torch has no uint32 search), where
    the 0xFFFFFFFF pad base stays the largest value; pad slots are
    rejected by their -1 pindex, never by the pad base value, so a real
    255.255.255.255 base (which ties the pad and wins the leftmost
    search) still resolves.  Bit-identical to the numpy twin
    cidrspace.CidrSpace.signature_host."""
    key = pod_ip[None, :] & pmask[:, None]  # [K, N] int64
    pos = torch.searchsorted(pbases.contiguous(), key.contiguous(), side="left")
    pos = pos.clamp(max=pbases.shape[1] - 1)  # [K, N]
    hit = torch.gather(pbases, 1, pos) == key
    idx = torch.gather(pindex, 1, pos)
    return torch.where(
        hit & (idx >= 0) & pod_ip_valid[None, :], idx, torch.full_like(idx, -1)
    ).to(torch.int32)


def ip_atom_table(
    part_target: torch.Tensor,  # [R] int64 target of each partitioned ip row
    part_atom: torch.Tensor,  # [R] int64 its atom (cidrspace.ip_leg)
    part_ok: torch.Tensor,  # [R, Q] bool its ports admit case q
    anc: torch.Tensor,  # [K, A] int64 strict ancestor atoms, -1 none
    n_targets: int,
) -> torch.Tensor:
    """[A + 1, W * Q] int32: per atom a, the packed words of the targets
    (bit t of word t // 32, case q at column w * Q + q) that an ip row
    on a admits for case q, less those that an ip row on one of a's
    strict ancestors (a shorter CIDR holding a) already admits; row A is
    the zero row that a partition signature's -1 reads.

    A pod's matched atoms are one chain of nested CIDRs, and each
    (target, case) bit is kept on the outermost atom of any chain that
    holds it, so the rows that a pod's signature gathers hold disjoint
    bits: their sum is their OR (kernel.ip_partition_words).  Duplicate
    (atom, target, case) triples are kept once; the sort, the ancestor
    probe and the scatter are each one operation however many
    partitions there are."""
    q = part_ok.shape[1]
    n_atoms = anc.shape[1]
    words = packed_words(n_targets)
    dev = part_ok.device
    span = n_targets * q
    key = (part_atom[:, None] * n_targets + part_target[:, None]) * q + torch.arange(
        q, device=dev
    )[None, :]
    key, _ = torch.sort(torch.where(part_ok, key, -1).reshape(-1))  # [E]
    first = torch.ones_like(key, dtype=torch.bool)
    first[1:] = key[1:] != key[:-1]
    atom, rem = key.clamp(min=0) // span, key.clamp(min=0) % span
    t, case = rem // q, rem % q
    # the same (target, case) on a strict ancestor: searched among the keys
    up = anc[:, atom]  # [K, E]
    probe = torch.where(up >= 0, (up * n_targets + t) * q + case, -2)
    pos = torch.searchsorted(key, probe).clamp(max=key.numel() - 1)
    held = torch.any(key[pos] == probe, dim=0)
    keep = (key >= 0) & first & ~held
    weights = torch.tensor(_BIT_WEIGHTS, dtype=torch.int32, device=dev)
    value = torch.where(keep, weights[t % PACK_BITS], 0)
    index = torch.where(keep, (atom * words + t // PACK_BITS) * q + case, 0)
    table = torch.zeros((n_atoms + 1) * words * q, dtype=torch.int32, device=dev)
    # disjoint bits of a word: their sum is their OR, int32 wrap included
    table.index_add_(0, index, value)
    return table.view(n_atoms + 1, words * q)


@contracts.args(pod_ip="(N,) int64", pod_ip_valid="(N,) bool")
def ip_partition_words(
    table: torch.Tensor,  # [A + 1, W * Q] int32 (ip_atom_table)
    pod_ip: torch.Tensor,  # [N] int64 (widened uint32)
    pod_ip_valid: torch.Tensor,  # [N] bool
    pmask: torch.Tensor,  # [K] int64
    pbases: torch.Tensor,  # [K, B] int64
    pindex: torch.Tensor,  # [K, B] int32
    q: int,
) -> torch.Tensor:
    """[W, N, Q] int32: the packed ip part of tallow_pk for the pods:
    each pod's partition signature [K] (lpm_partition_signature, -1 to
    the zero row), the table rows it names gathered and summed over the
    partitions (disjoint bits, so the sum is the OR), in
    pack_bool_words_torch's layout.  Work and memory scale as K x N x W,
    never as ip rows x pods; the operations do not grow with K."""
    n_atoms = table.shape[0] - 1
    sig = lpm_partition_signature(pod_ip, pod_ip_valid, pmask, pbases, pindex)
    idx = torch.where(sig >= 0, sig.long(), n_atoms)  # [K, N]
    words = table[idx].sum(dim=0).to(torch.int32)  # [N, W * Q]
    return words.view(pod_ip.shape[0], -1, q).transpose(0, 1)


def unpack_bool_words_torch(words: torch.Tensor, t: int) -> torch.Tensor:
    """[t, ...] bool: the inverse of pack_bool_words_torch along dim 0."""
    shifts = torch.arange(PACK_BITS, dtype=torch.int32, device=words.device)
    shifts = shifts.view((1, PACK_BITS) + (1,) * (words.dim() - 1))
    bits = ((words.unsqueeze(1) >> shifts) & 1).to(torch.bool)  # [W, 32, ...]
    return bits.reshape((-1,) + tuple(words.shape[1:]))[:t]


def rule_firing_kernel(shared: Dict, enc: Dict) -> Dict[str, torch.Tensor]:
    """Per-RULE firing-mask components for one direction — the batched
    variant of the verdict path that the analysis layer
    (cyclonus_tpu_torch.analysis) audits on.

    The firing mask of flat peer rule p over (target-side pod n,
    peer-side pod m, port case q) is the rank-1 product

        fire[p, n, m, q] = rule_tmatch[p, n] & peer_match[p, m] & pport[p, q]

    so returning the three factors is the whole mask without ever
    materializing [P, N, N, Q].  rule_tmatch gathers each rule's
    target row (a rule fires only where its OWN target applies), with
    pad rules (peer_target -1) masked to all-False."""
    selpod, selns = selector_tables(shared)
    pre = direction_precompute(
        enc,
        selpod,
        selns,
        shared["pod_ns_id"],
        shared["pod_ip"].long(),  # int64 on the device (carry.py); .long() returns it as is
        shared["pod_ip_valid"],
    )
    peer_match = apply_host_ip(enc, pre["peer_match"])
    pport = port_spec_allows(
        enc["port_spec"],
        shared["q_port"],
        shared["q_name"],
        shared["q_proto"],
    )
    pt = enc["peer_target"].long()
    rule_tmatch = pre["tmatch"][pt.clamp(min=0)] & (pt >= 0)[:, None]
    return {
        "rule_tmatch": rule_tmatch,  # [P, N] bool
        "peer_match": peer_match,  # [P, N] bool
        "pport": pport,  # [P, Q] bool
        "has_target": pre["has_target"],  # [N] bool
    }


# --- precedence-tier resolution epilogue ----------------------------------
#
# The ANP/BANP lattice replaces the bool-OR assumption with
# FIRST-MATCH-BY-PRIORITY: tier rows carry an int8 action and an int32
# rank (encoding.TierDirectionEncoding), and the first matching rule of a
# tier is the min over matching rows of the combined key rank * 4 + action
# (actions are 1..3, so key % 4 recovers the winning action and
# min-of-keys == first-match because ranks are the resolution order).
# Rows of one rule share its rank, which makes the within-rule peer OR
# exact under the min.  TIER_KEY_NONE (2^30) is the no-match identity.
# All of it composes with the class-compressed grid unchanged: tier rules
# observe pods only through (ns id, shared-table selector matches), both
# part of the class signature.


def tier_scope_match(
    ns_sel: torch.Tensor,  # [G] selector ids (namespace labels)
    pod_kind: torch.Tensor,  # [G] POD_ALL | POD_SELECTOR
    pod_sel: torch.Tensor,  # [G] selector ids (pod labels; -1 when ALL)
    selpod: torch.Tensor,  # [S, N]
    selns: torch.Tensor,  # [S, M]
    pod_ns_id: torch.Tensor,  # [N]
) -> torch.Tensor:
    """[G, N] bool: tier scope g (a subject or peer) matches pod n —
    namespace labels via selns, pod labels via selpod (the shared
    selector table; mirrors tiers.model.scope_matches).  A pad pod's ns
    id -1 wraps to the last namespace row as in direction_precompute."""
    ns_by_pod = selns[ns_sel.long()][:, pod_ns_id.long()]  # [G, N]
    pod_m = selpod[pod_sel.clamp(min=0).long()]  # [G, N]
    pod_ok = torch.where(pod_kind[:, None] == POD_SELECTOR, pod_m, True)
    return ns_by_pod & pod_ok


def tier_keys(tenc: Dict[str, torch.Tensor]):
    """(anp_key [G], banp_key [G]) int32 priority keys: rank * 4 + action
    for real rows of each tier, TIER_KEY_NONE elsewhere (pad rows carry
    action 0 and are inert in both)."""
    act = tenc["action"].to(torch.int32)
    key = tenc["rank"] * 4 + act
    tier = tenc["tier"].to(torch.int32)
    valid = act > TIER_ACT_NONE
    none = torch.tensor(TIER_KEY_NONE, dtype=torch.int32, device=key.device)
    anp = torch.where(valid & (tier == TIER_ANP), key, none)
    banp = torch.where(valid & (tier == TIER_BANP), key, none)
    return anp, banp


def tier_first_match_keys(
    subj: torch.Tensor,  # [G, A] bool — subject side (target pods)
    peerq: torch.Tensor,  # [G, B, Q] bool — peer side x port cases
    anp_key: torch.Tensor,  # [G] int32
    banp_key: torch.Tensor,  # [G] int32
    chunk: int = 8,
):
    """([A, B, Q], [A, B, Q]) int32 min matching keys per tier.

    Walks the rule axis in `chunk`-row slices so the [c, A, B, Q] match
    intermediate — not [G, A, B, Q] — is the only rule-axis blowup."""
    g, a = subj.shape
    b, q = peerq.shape[1], peerq.shape[2]
    none = torch.tensor(TIER_KEY_NONE, dtype=torch.int32, device=subj.device)
    anp_min = torch.full((a, b, q), TIER_KEY_NONE, dtype=torch.int32, device=subj.device)
    banp_min = anp_min.clone()
    for lo in range(0, g, chunk):
        m = subj[lo : lo + chunk, :, None, None] & peerq[lo : lo + chunk, None, :, :]
        ka = anp_key[lo : lo + chunk, None, None, None]
        kb = banp_key[lo : lo + chunk, None, None, None]
        anp_min = torch.minimum(anp_min, torch.where(m, ka, none).amin(dim=0))
        banp_min = torch.minimum(banp_min, torch.where(m, kb, none).amin(dim=0))
    return anp_min, banp_min


def resolve_tier_lattice(
    np_allowed: torch.Tensor,  # NetworkPolicy-tier verdict (any shape)
    has_target_b: torch.Tensor,  # bool, broadcastable to np_allowed
    anp_min: torch.Tensor,  # int32 min ANP key, same shape as np_allowed
    banp_min: torch.Tensor,
) -> torch.Tensor:
    """The lattice fold: ANP first-match (Allow/Deny final, Pass falls
    through), then the NetworkPolicy tier WHERE a target selects the pod
    (final), then BANP first-match, then default-allow.  np_allowed is
    the existing direction verdict (~has_target | any_allow): where
    has_target holds it equals the NP-tier verdict, and elsewhere it is
    bypassed."""
    anp_act = torch.where(anp_min < TIER_KEY_NONE, anp_min % 4, TIER_ACT_NONE)
    banp_act = torch.where(banp_min < TIER_KEY_NONE, banp_min % 4, TIER_ACT_NONE)
    below = torch.where(
        has_target_b,
        np_allowed,
        torch.where(banp_act == TIER_ACT_NONE, True, banp_act == TIER_ACT_ALLOW),
    )
    return torch.where(
        (anp_act == TIER_ACT_NONE) | (anp_act == TIER_ACT_PASS),
        below,
        anp_act == TIER_ACT_ALLOW,
    )


def tier_direction_arrays(
    tenc: Dict[str, torch.Tensor],
    selpod: torch.Tensor,
    selns: torch.Tensor,
    pod_ns_id: torch.Tensor,
    q_port: torch.Tensor,
    q_name: torch.Tensor,
    q_proto: torch.Tensor,
) -> Dict[str, torch.Tensor]:
    """Per-direction tier precompute over ONE pod set (both sides of the
    grid): subj [G, N], peerq [G, N, Q], and the two [G] key vectors."""
    subj = tier_scope_match(
        tenc["subj_ns_sel"], tenc["subj_pod_kind"], tenc["subj_pod_sel"],
        selpod, selns, pod_ns_id,
    )
    peer = tier_scope_match(
        tenc["peer_ns_sel"], tenc["peer_pod_kind"], tenc["peer_pod_sel"],
        selpod, selns, pod_ns_id,
    )
    pport = port_spec_allows(tenc["port_spec"], q_port, q_name, q_proto)
    anp_key, banp_key = tier_keys(tenc)
    return {
        "subj": subj,
        "peerq": peer[:, :, None] & pport[:, None, :],
        "anp_key": anp_key,
        "banp_key": banp_key,
    }


def evaluate_grid_kernel(tensors: Dict, pack: bool = False) -> Dict[str, torch.Tensor]:
    """Full-grid verdict on one device.

    tensors: dict with keys sel_*: selector tables; pod_*: cluster pod
    arrays; ns_kv/ns_key; ingress/egress: per-direction encodings (dicts
    incl. peer_target); q_port/q_name/q_proto: [Q] port cases; optional
    tiers: per-direction tier slabs.  `pack` routes the target-axis
    contraction through the 32-per-word packed bitmaps.  Returns
    ingress[q, d, s], egress[q, s, d], combined[q, s, d].
    """
    selpod, selns = selector_tables(tensors)
    out = {}
    for direction in ("ingress", "egress"):
        enc = tensors[direction]
        pre = direction_precompute(
            enc,
            selpod,
            selns,
            tensors["pod_ns_id"],
            tensors["pod_ip"].long(),  # int64 on the device (carry.py); .long() returns it as is
            tensors["pod_ip_valid"],
        )
        pport = port_spec_allows(
            enc["port_spec"],
            tensors["q_port"],
            tensors["q_name"],
            tensors["q_proto"],
        )
        out[direction] = direction_allowed(
            pre["tmatch"], pre["has_target"], m_tp_onehot(enc),
            apply_host_ip(enc, pre["peer_match"]), pport, pack=pack,
        )
        if "tiers" in tensors:
            ta = tier_direction_arrays(
                tensors["tiers"][direction],
                selpod,
                selns,
                tensors["pod_ns_id"],
                tensors["q_port"],
                tensors["q_name"],
                tensors["q_proto"],
            )
            anp_min, banp_min = tier_first_match_keys(
                ta["subj"], ta["peerq"], ta["anp_key"], ta["banp_key"]
            )
            out[direction] = resolve_tier_lattice(
                out[direction], pre["has_target"][:, None, None], anp_min, banp_min
            )
    # ingress is indexed [dst, src, q]; egress [src, dst, q]
    combined = out["egress"] & out["ingress"].transpose(0, 1)
    return {
        "ingress": torch.movedim(out["ingress"], -1, 0),
        "egress": torch.movedim(out["egress"], -1, 0),
        "combined": torch.movedim(combined, -1, 0),
    }


@contracts.args(class_of="(N,) int32")
def gather_class_grids(
    out: Dict[str, torch.Tensor], class_of: torch.Tensor
) -> Dict[str, torch.Tensor]:
    """Broadcast class-grid verdicts back to the full pod x pod grid:
    cell (q, i, j) copies class cell (q, class_of[i], class_of[j]), which
    is exact by the class signature's completeness
    (encoding.compute_pod_classes).  class_of: [N] pod -> class map."""
    idx = class_of.long()
    return {k: v[:, idx][:, :, idx] for k, v in out.items()}


def grid_stats_kernel(ingress, egress, combined) -> torch.Tensor:
    """[3] f32 mean allow-rates of the three grids: the exact integer sum
    times the f32 reciprocal of the cell count, as jnp.mean rounds it."""
    return torch.stack(
        [
            g.sum(dtype=torch.int64).to(torch.float32)
            * torch.reciprocal(torch.tensor(float(g.numel()), dtype=torch.float32))
            for g in (ingress, egress, combined)
        ]
    )
