"""Mesh-sharded verdict evaluation over the pod axis, in one process (the
reference's engine/sharded.py).

The reference runs one shard_map program over a jax Mesh.  Here a Mesh
holds torch devices, a device may repeat (several logical shards on one
card), and each shard_map body is a plain function run once per shard
in a Python loop, every shard's tensors on its own device:

  * jax.lax.axis_index("x") is the loop index;
  * all_gather(..., tiled=True) is a torch.cat of the shards' outputs on
    the gathering device;
  * one ppermute hop is t.to(next_device, non_blocking=True) for every
    leaf of the bundle, issued before the step's compute
    (tiled._ring_sweep).  Between logical shards of one device `.to`
    returns the same tensor, so the hop costs nothing; across cards it is
    a peer copy.

Sharding layout (shard_tensors, the reference's pod_sharded_in_specs):
every per-pod array (labels, ns ids, IPs) is split over the mesh, and so
are the columns of the host-evaluated ip-peer rows (host_ip_match);
policy tensors, tier slabs and port cases are replicated.  Each shard
computes the verdict ROWS of its source-pod block.

Two schedules give bit-identical grids:

  ring (default) — each shard keeps only its own pod shard's peer-side
      precompute, and the peer blocks stream around the mesh one hop per
      step while each shard computes the verdict block it already holds.
  allgather — the peer side (egress tallow [T, N, Q], ingress tmatch
      [T, N] and has_target [N], and the tier scope blocks) is gathered
      whole once per evaluation and every shard contracts against it: the
      reference schedule the ring is held against.

The reference's compiled-program caches and AOT wrapping have no
counterpart: the port compiles no programs.
"""

from __future__ import annotations

import math
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import carry
from ..telemetry import instruments as ti
from . import host
from .encoding import packed_words
from .kernel import (
    _bool_matmul,
    apply_host_ip,
    direction_precompute,
    m_tp_onehot,
    port_spec_allows,
    resolve_tier_lattice,
    selector_tables,
    tier_direction_arrays,
    tier_first_match_keys,
)
from .tiled import _dst_bundle_keys, _precompute, _ring_sweep, _split_pre, _tile_verdicts_split

# pod-axis-sharded tensor keys
_POD_KEYS = host._POD_KEYS

#: logical shards of the default mesh on one device: the reference's
#: 8 virtual CPU devices (tests/conftest.py)
DEFAULT_LOGICAL_SHARDS = 8


class Mesh:
    """Named axes over torch devices: the counterpart of
    jax.sharding.Mesh.  `devices` is a numpy object array of
    torch.device whose shape gives the axes' sizes (row-major order is
    the shard order); a device may repeat.  `shape` maps each axis name
    to its size, `size` is the shard count."""

    def __init__(self, devices, axis_names: Sequence[str] = ("x",)):
        arr = np.asarray(devices, dtype=object)
        flat = [torch.device(d) for d in arr.flat]
        self.devices = np.empty(len(flat), dtype=object)
        self.devices[:] = flat
        self.devices = self.devices.reshape(arr.shape)
        self.axis_names = tuple(axis_names)
        if len(self.axis_names) != self.devices.ndim or not flat:
            raise ValueError(
                f"mesh of shape {self.devices.shape} needs one name per axis, "
                f"got {self.axis_names}"
            )
        self.shape = dict(zip(self.axis_names, self.devices.shape))
        self.size = len(flat)

    @property
    def flat(self) -> List[torch.device]:
        """The shards' devices in shard order."""
        return list(self.devices.flat)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={sorted({str(d) for d in self.flat})})"


def logical_mesh(device, n: int = DEFAULT_LOGICAL_SHARDS, shape=None) -> Mesh:
    """`n` logical shards on one device, on the axis "x"; with `shape`
    (n_hosts, n_chips), prod(shape) shards on the ("dcn", "ici") axes of
    the 2-D ring."""
    device = torch.device(device)
    shape = (int(n),) if shape is None else tuple(int(s) for s in shape)
    names = ("dcn", "ici") if len(shape) == 2 else ("x",)
    devs = np.empty(math.prod(shape), dtype=object)
    devs[:] = [device] * devs.size
    return Mesh(devs.reshape(shape), names)


def default_mesh(device=None) -> Mesh:
    """Every visible CUDA card when the engine's device is a CUDA device
    and more than one card is visible; otherwise DEFAULT_LOGICAL_SHARDS
    logical shards on the engine's device (carry.resolve_device: None is
    the current CUDA device, or raises).  An engine on the card never
    moves to the CPU."""
    device = carry.resolve_device(device)
    if device.type == "cuda" and torch.cuda.device_count() > 1:
        return Mesh([torch.device("cuda", i) for i in range(torch.cuda.device_count())])
    return logical_mesh(device, DEFAULT_LOGICAL_SHARDS)


def ring2d_mesh(mesh: Mesh) -> Mesh:
    """A flat mesh factored into ("dcn", "ici"): 2 "hosts" when the
    shard count is even (so the dcn axis runs on a logical mesh too),
    else 1."""
    devs = mesh.devices.reshape(-1)
    n_hosts = 2 if devs.size % 2 == 0 and devs.size > 1 else 1
    return Mesh(devs.reshape(n_hosts, -1), ("dcn", "ici"))


def mesh_schedule(schedule: Optional[str] = None) -> str:
    """Resolve the mesh exchange schedule: explicit arg, else
    CYCLONUS_MESH_SCHEDULE, else "ring" (the overlapped default;
    "allgather" keeps the replicated reference schedule)."""
    s = (schedule or os.environ.get("CYCLONUS_MESH_SCHEDULE", "ring")).lower()
    if s not in ("ring", "allgather"):
        raise ValueError(
            f"unknown mesh schedule {s!r} (want 'ring' or 'allgather')"
        )
    return s


def replicate(tensors: Dict, devices: Sequence[torch.device]) -> List[Dict]:
    """Every leaf of a numpy tensor dict on every shard's device (the
    all-replicated in_specs of the mesh-parallel counts paths), uploaded
    once per distinct device."""
    moved: Dict[torch.device, Dict] = {}
    for dev in devices:
        if dev not in moved:
            moved[dev] = carry.tensors_from_reference(tensors, dev)
    return [moved[dev] for dev in devices]


def shard_tensors(tensors: Dict, devices: Sequence[torch.device], shard: int) -> List[Dict]:
    """Per-shard torch tensor dicts of a (padded) numpy tensor dict, shard
    d on devices[d], by the rule of the reference's pod_sharded_in_specs:
    the pod arrays split on axis 0, host_ip_match on axis 1 (its pod
    axis), tiers and every policy tensor replicated."""
    shared = {k: v for k, v in tensors.items() if k not in _POD_KEYS}
    for direction in ("ingress", "egress"):
        if "host_ip_match" in tensors[direction]:
            shared[direction] = {
                k: v for k, v in tensors[direction].items() if k != "host_ip_match"
            }
    out = []
    for d, t in enumerate(replicate(shared, devices)):
        dev = devices[d]
        rows = slice(d * shard, (d + 1) * shard)
        t = dict(t)
        for k in _POD_KEYS:
            t[k] = carry.to_torch(tensors[k][rows], dev)
        for direction in ("ingress", "egress"):
            if "host_ip_match" in tensors[direction]:
                t[direction] = dict(t[direction])
                t[direction]["host_ip_match"] = carry.to_torch(
                    tensors[direction]["host_ip_match"][:, rows], dev
                )
        out.append(t)
    return out


def _gather(blocks: Sequence[torch.Tensor], dim: int, device: torch.device) -> torch.Tensor:
    """all_gather(tiled=True): the shards' blocks concatenated on `device`."""
    return torch.cat([b.to(device, non_blocking=True) for b in blocks], dim=dim)


# --- the all-gather schedule ------------------------------------------------


def _allgather_local(t: Dict) -> Dict:
    """The local half of the all-gather program on one shard: its
    precompute over the local pod block, and the peer-side blocks every
    shard gathers (egress tallow, ingress tmatch and has_target, and the
    tier blocks on the dst pod axis)."""
    selpod, selns = selector_tables(t)
    q = t["q_port"].shape[0]
    pre, local = {}, {}
    for direction in ("ingress", "egress"):
        enc = t[direction]
        p = direction_precompute(
            enc, selpod, selns, t["pod_ns_id"], t["pod_ip"], t["pod_ip_valid"]
        )
        p["peer_match"] = apply_host_ip(enc, p["peer_match"])
        pport = port_spec_allows(enc["port_spec"], t["q_port"], t["q_name"], t["q_proto"])
        n_p, n_b = p["peer_match"].shape
        peer_allow = (p["peer_match"][:, :, None] & pport[:, None, :]).reshape(n_p, n_b * q)
        p["tallow"] = _bool_matmul(m_tp_onehot(enc), peer_allow)  # [T, Nb*Q]
        if "tiers" in t:
            p["tier"] = tier_direction_arrays(
                t["tiers"][direction], selpod, selns, t["pod_ns_id"],
                t["q_port"], t["q_name"], t["q_proto"],
            )
        pre[direction] = p
    e, i = pre["egress"], pre["ingress"]
    local["tallow_e"] = e["tallow"].reshape(e["tallow"].shape[0], e["tmatch"].shape[1], q)
    local["tmatch_i"] = i["tmatch"]  # [T, Nb]
    local["has_i"] = i["has_target"]  # [Nb]
    if "tier" in e:
        local["tier_peerq_e"] = e["tier"]["peerq"]  # [G, Nb, Q]
        local["tier_subj_i"] = i["tier"]["subj"]  # [G, Nb]
    return {"pre": pre, "local": local}


#: the gathered blocks and the pod axis each is gathered on
_GATHER_AXES = {"tallow_e": 1, "tmatch_i": 1, "has_i": 0, "tier_peerq_e": 1, "tier_subj_i": 1}


def _allgather_rows(pre: Dict, g: Dict) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One shard's verdict rows against the gathered peer side g:
    (ingress_rows, egress, combined), each [Sb, N, Q]."""
    e, i = pre["egress"], pre["ingress"]
    t_e, n_total, q = g["tallow_e"].shape
    n_b = e["tmatch"].shape[1]
    # egress: the local source block is the target side
    any_e = _bool_matmul(e["tmatch"].T, g["tallow_e"].reshape(t_e, n_total * q))
    egress = (~e["has_target"][:, None, None]) | any_e.reshape(n_b, n_total, q)
    if "tier" in e:
        anp_e, banp_e = tier_first_match_keys(
            e["tier"]["subj"], g["tier_peerq_e"], e["tier"]["anp_key"], e["tier"]["banp_key"]
        )  # [Sb, N, Q]
        egress = resolve_tier_lattice(egress, e["has_target"][:, None, None], anp_e, banp_e)
    # ingress: the local source block is the peer side
    any_i = _bool_matmul(g["tmatch_i"].T, i["tallow"])  # [N, Sb*Q]
    ingress_t = (~g["has_i"][:, None, None]) | any_i.reshape(n_total, n_b, q)
    if "tier" in i:
        anp_i, banp_i = tier_first_match_keys(
            g["tier_subj_i"], i["tier"]["peerq"], i["tier"]["anp_key"], i["tier"]["banp_key"]
        )  # [N, Sb, Q]
        ingress_t = resolve_tier_lattice(ingress_t, g["has_i"][:, None, None], anp_i, banp_i)
    ingress_rows = ingress_t.transpose(0, 1)  # [Sb, N, Q]
    return ingress_rows, egress, egress & ingress_rows


def _allgather_eval(shards: List[Dict], devices: Sequence[torch.device]):
    """The all-gather schedule: every shard's local half, one gather of the
    peer side on every shard's device, then every shard's verdict rows."""
    parts = [_allgather_local(t) for t in shards]
    out = []
    for d, part in enumerate(parts):
        g = {
            k: _gather([p["local"][k] for p in parts], axis, devices[d])
            for k, axis in _GATHER_AXES.items()
            if k in part["local"]
        }
        out.append(_allgather_rows(part["pre"], g))
    return out


# --- the ring schedule --------------------------------------------------------


def _ring_grid_eval(shards: List[Dict], devices: Sequence[torch.device], shard: int, pack: bool):
    """The ring schedule: each shard's own precompute (tiled._precompute,
    packed words with `pack`), the dst-side bundle streamed around the
    mesh by tiled._ring_sweep, and the verdict blocks written column-wise
    by the same tile body every tiled path runs (the tier lattice
    included)."""
    n_dev = len(shards)
    srcs, rings = [], []
    for t in shards:
        src, dst0 = _split_pre(_precompute(t, pack))
        srcs.append(src)
        rings.append(dst0)
    n_total = n_dev * shard
    q = shards[0]["q_port"].shape[0]
    init = [
        tuple(torch.zeros((shard, n_total, q), dtype=torch.bool, device=dev) for _ in range(3))
        for dev in devices
    ]

    def body(step, d, ring, grids):
        dst = {k: ring[k] for k in _dst_bundle_keys(ring)}
        blocks = _tile_verdicts_split(srcs[d], dst, 0, shard)
        # after `step` hops shard d holds the bundle that started at shard
        # (d - step) mod n_dev: its verdicts land in those columns
        col0 = ((d - step) % n_dev) * shard
        for grid, block in zip(grids, blocks):
            grid[:, col0 : col0 + shard] = block
        return grids

    grids, _ = _ring_sweep(devices, rings, init, body)
    return grids


def peer_buffer_bytes(tensors: Dict, n_dev: int, schedule: str, pack: bool = False) -> int:
    """Host-side estimate of the PER-SHARD peer-side working set of one
    sharded grid evaluation (the reference's formula, unchanged).

    allgather: the gathered arrays every shard holds whole — egress tallow
    [T_e, N, Q] + ingress tmatch [T_i, N] + has [N] (+ the gathered tier
    scope blocks).  ring: TWO copies (resident + in flight) of the
    rotating bundle over one shard — tallow_bf is bf16 (2 bytes), the
    rest bool; with `pack` the tallow/tmatch legs are 32-per-word int32
    slabs (encoding.packed_words(T) words of 4 bytes each)."""
    n = int(tensors["pod_ns_id"].shape[0])
    q = int(tensors["q_port"].shape[0])
    t_e = int(tensors["egress"]["target_ns"].shape[0])
    t_i = int(tensors["ingress"]["target_ns"].shape[0])
    g_e = g_i = 0
    if "tiers" in tensors:
        g_e = int(tensors["tiers"]["egress"]["action"].shape[0])
        g_i = int(tensors["tiers"]["ingress"]["action"].shape[0])
    if schedule == "allgather":
        return t_e * n * q + t_i * n + n + g_e * n * q + g_i * n
    shard = n // max(n_dev, 1)
    if pack:
        bundle = (
            4 * packed_words(t_e) * shard * q  # tallow_pk: int32 words
            + 4 * packed_words(t_i) * shard  # tmatch_pk
            + shard  # has_i
            + g_e * shard * q
            + g_i * shard
        )
    else:
        bundle = (
            2 * t_e * shard * q  # tallow_bf: bf16
            + t_i * shard
            + shard  # has_i
            + g_e * shard * q
            + g_i * shard
        )
    return 2 * bundle


def evaluate_grid_sharded(
    tensors: Dict,
    n_pods: int,
    mesh: Optional[Mesh] = None,
    schedule: Optional[str] = None,
    *,
    pack: bool,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(ingress [N_dst, N_src, Q], egress [N_src, N_dst, Q], combined
    [N_src, N_dst, Q]) bool on the mesh's first device, pad rows and
    columns stripped.  `tensors` is the engine's host (numpy) tensor dict
    with the port-case arrays; its pod axis is padded to a multiple of
    the shard count.  `schedule` picks the peer exchange: "ring" (the
    default) or "allgather"; `pack` the ring's operands (the all-gather
    schedule is the dense reference twin)."""
    mesh = mesh or default_mesh()
    schedule = mesh_schedule(schedule)
    devices = mesh.flat
    tensors, padded = host._pad_pod_arrays(tensors, n_pods, len(devices))
    shard = padded // len(devices)
    ti.MESH_PEER_BYTES.set(
        peer_buffer_bytes(tensors, len(devices), schedule, pack=pack), schedule=schedule
    )
    with ti.eval_flight(
        "grid.sharded", n_pods, int(tensors["q_port"].shape[0]),
        devices=len(devices), schedule=schedule, dispatch_only=True,
    ):
        shards = shard_tensors(tensors, devices, shard)
        if schedule == "ring":
            rows = _ring_grid_eval(shards, devices, shard, pack)
        else:
            rows = _allgather_eval(shards, devices)
        home = devices[0]
        ingress_rows, egress, combined = (
            _gather([r[k] for r in rows], 0, home)[:n_pods, :n_pods] for k in range(3)
        )
    return ingress_rows.transpose(0, 1), egress, combined


def evaluate_class_grid_sharded(
    tensors: Dict,
    n_classes: int,
    class_of: np.ndarray,
    mesh: Optional[Mesh] = None,
    schedule: Optional[str] = None,
    *,
    pack: bool,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """evaluate_grid_sharded over the class axis (`tensors` carries the
    class representatives' rows; with the ring schedule a C x C ring),
    then the gather back to pod axes: one index on the device per axis."""
    grids = evaluate_grid_sharded(tensors, n_classes, mesh=mesh, schedule=schedule, pack=pack)
    idx = torch.from_numpy(np.asarray(class_of, dtype=np.int64)).to(grids[0].device)
    return tuple(g.index_select(0, idx).index_select(1, idx) for g in grids)
