"""Tuple-space / longest-prefix-match pre-classification of CIDR-heavy
policy sets (a copy of the reference package's engine/cidrspace.py; the
device leg runs kernel.lpm_partition_signature in PyTorch).

The class-compression wall this breaks: the per-pod observability
signature (encoding.pod_signatures) spends one bit per DISTINCT
(base, mask, excepts) ip-peer spec.  An ipBlock-heavy set — 100k
distinct CIDRs, the internet-facing egress case — makes that signature
O(specs) bits per pod: a [specs, N] bool membership pass that is 10 GB
of host temporaries at the 100k x 100k shape.

The tuple-space observation: group CIDR atoms by MASK.  Within one mask
partition, `pod_ip & mask` is a single value, so a pod can match AT
MOST ONE base — the whole partition's membership pattern collapses to
one integer: the index of the matched atom, or -1.  The per-pod
signature for the entire CIDR dimension is therefore a [K] int32 vector
(K = distinct masks, <= 33 for IPv4) instead of [specs] bits, and the
lookup is a binary search over each partition's sorted bases — the
flattened form of a prefix-trie walk.

Soundness: every spec's membership bit is a boolean function of its
primary atom's hit and its except atoms' hits, all of which the
partition signature determines — so pods with equal signatures have
equal membership on every spec, equal verdict rows, and may share a
class (spec_membership_words is the mechanical bridge; the CIDR fuzz
family pins it).  The signature may be FINER than the per-spec bits
(two pods hitting different except-only atoms split), which costs
classes, never correctness.

Family routing: only in-kernel IPv4 rows (`ip_is_v4`) contribute atoms.
Host-evaluated rows — IPv6 CIDRs and v4 blocks with mixed-family
excepts — keep their per-pod match COLUMNS in the signature exactly as
before: the trie never sees a v6 row.

Gating (`CYCLONUS_CIDR_TSS`): "auto" (default) engages above
CYCLONUS_CIDR_TSS_MIN distinct specs — below it the per-spec bit path
is smaller and faster; "1" forces; "0" disables, restoring the pre-TSS
signature bytes exactly.  The stage falls back to the dense bit path
(returns None) when the partition tensors plus the staged [K, N]
signature would not fit CYCLONUS_SLAB_MAX_BYTES — the same budget the
class route charges (the engine counts the partition tensors in its
aux bytes).

The device leg (kernel.lpm_partition_signature on the engine's torch
device) runs the same searchsorted walk for large pod x atom products
(CYCLONUS_CIDR_DEVICE_MIN, CYCLONUS_CIDR_TSS_DEVICE); the numpy twin
here is the small-case path and the differential check.  A device leg
that fails raises: it never falls back to the twin.
"""

from __future__ import annotations

import logging
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from . import host
from .encoding import PEER_IP, iter_ip_specs, pack_bool_words
from ..utils import contracts

logger = logging.getLogger(__name__)

#: pad value for partition base buckets: sorts after every real base of
#: its row (reals are placed first, so a real 255.255.255.255/32 still
#: wins the leftmost-searchsorted tie); the paired pindex pad is -1,
#: which is what actually rejects a pad hit
_BASE_PAD = np.uint32(0xFFFFFFFF)

#: bucket width granule: the reference pads each partition row to a
#: multiple of the TPU lane width, so the port pads alike and the
#: partition tensors are equal leaf by leaf
_LANE = 128


def lane_round_up(n: int) -> int:
    """Smallest multiple of 128 >= n (>= 128)."""
    return -(-max(int(n), 1) // _LANE) * _LANE


def tss_mode(mode: Optional[str] = None) -> str:
    """Resolve CYCLONUS_CIDR_TSS: "auto" (default — engage above the
    distinct-spec floor), "1" (force), "0" (off: signature bytes exactly
    the pre-TSS per-spec bit path)."""
    if mode is None:
        mode = os.environ.get("CYCLONUS_CIDR_TSS", "auto")
    mode = str(mode).lower()
    if mode not in ("auto", "0", "1"):
        raise ValueError(
            f"CYCLONUS_CIDR_TSS must be auto, 0, or 1, got {mode!r}"
        )
    return mode


def tss_min_specs() -> int:  # never-raises
    """Auto-mode floor on distinct (base, mask, excepts) specs: below
    it, one bit per spec is cheaper than 4 bytes per partition and the
    dense membership pass is noise (CYCLONUS_CIDR_TSS_MIN overrides)."""
    try:
        return int(os.environ.get("CYCLONUS_CIDR_TSS_MIN", "256"))
    except Exception as e:  # malformed env degrades to the default
        logger.debug("malformed CYCLONUS_CIDR_TSS_MIN: %s", e)
        return 256


def device_min_cells() -> int:  # never-raises
    """pods x atoms floor above which the LPM stage runs on the device
    (CYCLONUS_CIDR_TSS_DEVICE=1/0 forces/forbids): below it the numpy
    twin beats a device round trip."""
    try:
        return int(os.environ.get("CYCLONUS_CIDR_DEVICE_MIN", str(1 << 24)))
    except Exception as e:  # malformed env degrades to the default
        logger.debug("malformed CYCLONUS_CIDR_DEVICE_MIN: %s", e)
        return 1 << 24


@contracts.checked
@dataclass
class CidrSpace:
    """The TSS partition map of one engine's ip-peer rows.

    Tensor contracts: A atoms (distinct (base, mask) over primary CIDRs and their excepts,
    both directions), K partitions (distinct masks, LPM order: longest
    prefix first), B the bucket width padded to 128.  `pbases` rows hold
    each partition's bases sorted ascending with _BASE_PAD fill;
    `pindex` holds the matching GLOBAL atom index with -1 fill — the -1,
    not the pad base value, is what rejects a pad hit, so a real
    0xFFFFFFFF base is safe.  `device` is the torch device the LPM
    stage's device leg runs on (None: the current CUDA device).
    Validated on construction under CYCLONUS_SHAPE_CHECK=1."""

    n_specs: int  # distinct (base, mask, excepts) rows (the bit path's width)
    n_atoms: int
    n_host_rows: int  # host-evaluated (v6/mixed) rows routed AROUND the trie
    atom_base: np.ndarray = contracts.tensor("(A,) uint32")
    atom_mask: np.ndarray = contracts.tensor("(A,) uint32")
    atom_part: np.ndarray = contracts.tensor("(A,) int32")  # atom -> partition
    pmask: np.ndarray = contracts.tensor("(K,) uint32")
    pprefix: np.ndarray = contracts.tensor("(K,) int32")
    pbases: np.ndarray = contracts.tensor("(K, B) uint32")
    pindex: np.ndarray = contracts.tensor("(K, B) int32", sentinel="-1=pad")
    #: per spec: (primary atom id, tuple of except atom ids) — the
    #: bridge from partition signatures back to per-spec membership
    #: (spec_membership_words); row order = spec discovery
    spec_atoms: List[Tuple[int, Tuple[int, ...]]] = field(default_factory=list)
    #: forensics of the last signature computation
    last_lpm_s: Optional[float] = None
    last_device: Optional[bool] = None
    device: object = field(default=None, compare=False, repr=False)

    @property
    def n_partitions(self) -> int:
        return int(self.pmask.shape[0])

    @property
    def max_bucket(self) -> int:
        return int(self.pbases.shape[1])

    def nbytes(self) -> int:
        """Device bytes of the partition tensors — charged against
        CYCLONUS_SLAB_MAX_BYTES in the engine's class aux bytes."""
        return int(
            self.atom_base.nbytes
            + self.atom_mask.nbytes
            + self.atom_part.nbytes
            + self.pmask.nbytes
            + self.pprefix.nbytes
            + self.pbases.nbytes
            + self.pindex.nbytes
        )

    def structure(self) -> Tuple:
        """The partition-map identity the serve patch path compares
        (serve/incremental.py patch_policy): a policy delta whose mask
        structure differs must go Ineligible -> full rebuild rather than
        patch over a stale map."""
        return tuple(int(m) for m in self.pmask)

    def signature(
        self,
        pod_ip: np.ndarray,
        pod_ip_valid: np.ndarray,
        device: Optional[bool] = None,
    ) -> np.ndarray:
        """[K, N] int32 per-pod partition signature: the GLOBAL index of
        the one atom of partition k that pod n's IP matches, or -1
        (no match / invalid IP).  device=None routes by work size; the
        two legs are bit-identical (tests/test_torch_cidr.py)."""
        n = int(pod_ip.shape[0])
        if device is None:
            device = _device_enabled(n * max(self.n_atoms, 1))
        t0 = time.perf_counter()
        if device and n:
            out = self.signature_device(pod_ip, pod_ip_valid)
        else:
            out = self.signature_host(pod_ip, pod_ip_valid)
            device = False
        self.last_lpm_s = time.perf_counter() - t0
        self.last_device = bool(device)
        return out

    def signature_device(
        self, pod_ip: np.ndarray, pod_ip_valid: np.ndarray
    ) -> np.ndarray:
        """The device leg: kernel.lpm_partition_signature on
        `self.device`, read back as numpy int32."""
        from .. import carry
        from .kernel import lpm_partition_signature

        dev = carry.resolve_device(self.device)
        out = lpm_partition_signature(
            carry.to_torch(np.ascontiguousarray(pod_ip), dev),
            carry.to_torch(np.ascontiguousarray(pod_ip_valid), dev),
            carry.to_torch(self.pmask, dev),
            carry.to_torch(self.pbases, dev),
            carry.to_torch(self.pindex, dev),
        )
        return out.cpu().numpy()

    def signature_host(
        self, pod_ip: np.ndarray, pod_ip_valid: np.ndarray
    ) -> np.ndarray:
        """Numpy twin of kernel.lpm_partition_signature, op for op:
        mask, leftmost binary search per partition, gather, reject pads
        via pindex -1 and invalid IPs via the validity mask."""
        k = self.n_partitions
        n = int(pod_ip.shape[0])
        key = pod_ip[None, :] & self.pmask[:, None]  # [K, N] uint32
        pos = np.empty((k, n), dtype=np.int64)
        for ki in range(k):
            pos[ki] = np.searchsorted(self.pbases[ki], key[ki], side="left")
        pos = np.minimum(pos, self.max_bucket - 1)
        hit = np.take_along_axis(self.pbases, pos, axis=1) == key
        idx = np.take_along_axis(self.pindex, pos, axis=1)
        return np.where(
            hit & (idx >= 0) & pod_ip_valid[None, :], idx, np.int32(-1)
        ).astype(np.int32)


def _collect(tensors: Dict):
    """(specs, atoms, n_host_rows) over both directions' in-kernel IPv4
    ip-peer rows: specs come from encoding.iter_ip_specs — the one spec
    identity the dense bit path also buckets on; atoms dedup on
    (base, mask) over primaries and excepts.  Host-evaluated rows
    (host_ip_mask) are counted but contribute NO atoms."""
    specs = iter_ip_specs(tensors)
    atoms: Dict[Tuple[int, int], int] = {}
    for base, mask, exs in specs:
        atoms.setdefault((base, mask), 0)
        for eb, em in exs:
            atoms.setdefault((eb, em), 0)
    n_host = 0
    for direction in ("ingress", "egress"):
        d = tensors[direction]
        if "host_ip_mask" in d:
            n_host += int(np.count_nonzero(d["host_ip_mask"]))
    return specs, atoms, n_host


def partition_atoms(base: np.ndarray, mask: np.ndarray) -> Dict[str, np.ndarray]:
    """The tuple-space partition of (base, mask) pairs, duplicates
    merged: {atom_base, atom_mask, atom_part (A,), pmask, pprefix (K,),
    pbases, pindex (K, B), inverse: the atom of each input pair}.
    Partitions are the distinct masks, longest prefix first (mask values
    are monotone in prefix length, so numeric-descending IS the LPM
    order); each partition's bases ascend; global atom ids run in
    (partition, base) order, the signature values; B is the largest
    bucket rounded up to 128.  Deterministic in the pairs' contents."""
    base = np.asarray(base, dtype=np.uint64).reshape(-1)
    mask = np.asarray(mask, dtype=np.uint64).reshape(-1)
    # mask descending, then base ascending, as one uint64 sort key
    key = ((np.uint64(0xFFFFFFFF) - mask) << np.uint64(32)) | base
    uniq, inverse = np.unique(key, return_inverse=True)
    a_base = (uniq & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    a_mask = (np.uint64(0xFFFFFFFF) - (uniq >> np.uint64(32))).astype(np.uint32)
    new = np.ones(a_mask.shape, dtype=bool)
    new[1:] = a_mask[1:] != a_mask[:-1]
    starts = np.flatnonzero(new)
    a_part = (np.cumsum(new) - 1).astype(np.int32)
    pmask = a_mask[starts]
    sizes = np.diff(np.append(starts, a_mask.size))
    b_pad = lane_round_up(int(sizes.max()) if sizes.size else 0)
    pbases = np.full((pmask.size, b_pad), _BASE_PAD, dtype=np.uint32)
    pindex = np.full((pmask.size, b_pad), -1, dtype=np.int32)
    col = np.arange(a_mask.size) - starts[a_part]
    pbases[a_part, col] = a_base
    pindex[a_part, col] = np.arange(a_mask.size, dtype=np.int32)
    pprefix = np.array([bin(int(m)).count("1") for m in pmask], dtype=np.int32)
    return {"atom_base": a_base, "atom_mask": a_mask, "atom_part": a_part,
            "pmask": pmask, "pprefix": pprefix.reshape(-1), "pbases": pbases,
            "pindex": pindex, "inverse": inverse.reshape(-1)}


def build_space(tensors: Dict) -> Optional[CidrSpace]:
    """The CidrSpace of `tensors`' ip-peer rows, or None when no
    in-kernel IPv4 row exists.  Deterministic in the tensor contents
    alone (partition_atoms), so build-time and serve-time derivations of
    the same tensors always agree."""
    specs, atoms, n_host = _collect(tensors)
    if not atoms:
        return None
    pairs = np.array(list(atoms), dtype=np.uint64).reshape(-1, 2)
    part = partition_atoms(pairs[:, 0], pairs[:, 1])
    atom_id = dict(zip(atoms, (int(i) for i in part["inverse"])))
    spec_atoms = [
        (atom_id[(base, mask)], tuple(atom_id[(eb, em)] for eb, em in exs))
        for (base, mask, exs) in specs
    ]
    return CidrSpace(
        n_specs=len(specs),
        n_atoms=int(part["atom_base"].size),
        n_host_rows=n_host,
        atom_base=part["atom_base"],
        atom_mask=part["atom_mask"],
        atom_part=part["atom_part"],
        pmask=part["pmask"],
        pprefix=part["pprefix"],
        pbases=part["pbases"],
        pindex=part["pindex"],
        spec_atoms=spec_atoms,
    )


def _numpy(a) -> np.ndarray:
    """A host array of a numpy array or a torch tensor on any device."""
    return a.cpu().numpy() if hasattr(a, "cpu") else np.asarray(a)


def ip_leg(d: Dict, n_targets: int) -> Dict:
    """How the dense precompute resolves one direction's peer rows (`d`,
    a direction of an engine's tensors, host or device): on the host,
    numpy arrays of row indices and the tuple-space partition of the
    rows it resolves by atom.  Pad rows (peer_target -1) are in no group.

      other       live rows of every kind but ip: the selector product
      block       ip rows resolved row by row, in target order: those
                  with excepts, host-evaluated (v6, mixed-family) rows
                  and non-v4 rows; block_run numbers their runs of one
                  target, run_target is each run's target
      part_rows   in-kernel IPv4 rows without excepts, resolved through
                  the partition: part_atom is each row's atom, pmask /
                  pbases / pindex the partition (partition_atoms), and
                  anc [K, A] each atom's strict ancestor in partition k
                  (the atom of a shorter prefix that holds it), or -1
    """
    kind = _numpy(d["peer_kind"])
    target = _numpy(d["peer_target"]).astype(np.int64)
    live = target >= 0
    host_rows = _numpy(d["host_ip_mask"]) if "host_ip_mask" in d else np.zeros_like(live)
    ip = live & (kind == PEER_IP)
    part = ip & _numpy(d["ip_is_v4"]) & ~_numpy(d["ex_valid"]).any(axis=1) & ~host_rows
    block = np.flatnonzero(ip & ~part)
    block = block[np.argsort(target[block], kind="stable")]
    new_run = np.ones(block.size, dtype=bool)
    new_run[1:] = target[block][1:] != target[block][:-1]
    leg = {
        "n_targets": int(n_targets),
        "other": np.flatnonzero(live & ~ip & ~host_rows),
        "block": block,
        "block_run": np.cumsum(new_run) - 1,
        "run_target": target[block][new_run],
        "part_rows": np.flatnonzero(part),
    }
    rows = leg["part_rows"]
    p = partition_atoms(
        _numpy(d["ip_base"])[rows].astype(np.uint64), _numpy(d["ip_mask"])[rows].astype(np.uint64)
    )
    leg.update(part_atom=p["inverse"].astype(np.int64), pmask=p["pmask"],
               pbases=p["pbases"], pindex=p["pindex"])
    # strict ancestors: the atom whose base is this atom's base under a
    # shorter partition's mask (lpm_partition_signature of the atom bases)
    a_base = p["atom_base"].astype(np.uint64)
    own = p["pprefix"][p["atom_part"]] if a_base.size else np.zeros(0, np.int32)
    anc = np.full((p["pmask"].size, a_base.size), -1, dtype=np.int64)
    for k in range(p["pmask"].size):
        key = (a_base & np.uint64(p["pmask"][k])).astype(np.uint32)
        pos = np.minimum(np.searchsorted(p["pbases"][k], key, side="left"), p["pbases"].shape[1] - 1)
        hit = (p["pbases"][k][pos] == key) & (p["pindex"][k][pos] >= 0) & (p["pprefix"][k] < own)
        anc[k] = np.where(hit, p["pindex"][k][pos], -1)
    leg["anc"] = anc
    return leg


def ip_leg_on(leg: Dict, device) -> Dict:
    """The leg's arrays on the torch `device`, the uint32 partition
    columns widened to int64 as pod_ip is (carry.py); the host copies of
    the counts and of block_run stay, for the block loop's bounds."""
    import torch

    out = {"n_targets": leg["n_targets"], "n_atoms": int(leg["anc"].shape[1]),
           "n_partitions": int(leg["pmask"].size), "n_block": int(leg["block"].size),
           "n_part": int(leg["part_rows"].size), "block_run_host": leg["block_run"]}
    for k in ("other", "block", "block_run", "run_target", "part_rows", "part_atom",
              "pmask", "pbases", "anc"):
        out[k] = torch.from_numpy(np.ascontiguousarray(leg[k]).astype(np.int64)).to(device)
    out["pindex"] = torch.from_numpy(np.ascontiguousarray(leg["pindex"])).to(device)
    return out


def resolve(
    tensors: Dict,
    mode: Optional[str] = None,
    n_pods: Optional[int] = None,
    device=None,
) -> Optional[CidrSpace]:
    """The gated entry point: the CidrSpace the class machinery should
    use, or None for the dense per-spec bit path — off (mode "0"), no
    IPv4 atoms, unprofitable (auto below the distinct-spec floor), or
    over the device budget (partition tensors + the staged [K, N]
    signature vs CYCLONUS_SLAB_MAX_BYTES).  `device` is the torch device
    of the space's device leg (the engine's)."""
    m = tss_mode(mode)
    if m == "0":
        return None
    space = build_space(tensors)
    if space is None:
        return None
    if m == "auto" and space.n_specs < tss_min_specs():
        return None
    if n_pods is None:
        n_pods = int(tensors["pod_ip"].shape[0]) if "pod_ip" in tensors else 0
    staged = space.nbytes() + 4 * space.n_partitions * n_pods + 4 * n_pods
    if staged > host._slab_max_bytes():
        return None
    space.device = device
    return space


def mask_structure(space: Optional[CidrSpace]) -> Optional[Tuple]:
    """The comparable partition-map identity (None = stage inactive) —
    what serve's patch_policy pins across a policy delta."""
    return None if space is None else space.structure()


def _device_enabled(cells: int) -> bool:
    """Route the LPM stage to the device?  CYCLONUS_CIDR_TSS_DEVICE
    "1"/"0" force/forbid; default: above the pods x atoms work floor."""
    forced = os.environ.get("CYCLONUS_CIDR_TSS_DEVICE", "auto").lower()
    if forced == "1":
        return True
    if forced == "0":
        return False
    return cells >= device_min_cells()


def dense_spec_membership(
    space: CidrSpace, pod_ip: np.ndarray, pod_ip_valid: np.ndarray
) -> np.ndarray:
    """[n_specs, N] bool per-spec membership by the DENSE mask-compare —
    the reference semantics (kernel.direction_precompute's
    in_cidr & ~in_except, validity-masked) that spec_membership_words is
    checked against."""
    am = pod_ip_valid[None, :] & (
        (pod_ip[None, :] & space.atom_mask[:, None])
        == space.atom_base[:, None]
    )  # [A, N] atom membership
    n = int(pod_ip.shape[0])
    bits = np.zeros((max(space.n_specs, 1), n), dtype=bool)
    for s, (primary, excepts) in enumerate(space.spec_atoms):
        m = am[primary].copy()
        for ea in excepts:
            m &= ~am[ea]
        bits[s] = m
    return bits


def spec_membership_words(space: CidrSpace, sig: np.ndarray) -> np.ndarray:
    """[W, N] int32 packed per-SPEC membership words recovered from a
    [K, N] partition signature (32 per word, pack_bool_words): spec s
    matches pod n iff its primary atom is n's match in that atom's
    partition and no except atom is — the mechanical bridge from the TSS
    signature back to the dense bit semantics."""
    n = int(sig.shape[1])
    bits = np.zeros((max(space.n_specs, 1), n), dtype=bool)
    for s, (primary, excepts) in enumerate(space.spec_atoms):
        m = sig[int(space.atom_part[primary])] == primary
        for ea in excepts:
            m &= ~(sig[int(space.atom_part[ea])] == ea)
        bits[s] = m
    return pack_bool_words(bits, axis=0)
