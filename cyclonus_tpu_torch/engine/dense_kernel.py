"""The dense (int8) verdict-count kernels of the CYCLONUS_PACK=0 plan: the
port of the non-packed half of the reference's Pallas module
(cyclonus_tpu/engine/pallas_kernel.py) — K4 single-chunk, K5 chunked with
the all-zero block skip, and K6 per-tile target slabs.

Per port case q, src pod s and dst pod d:

  egress   = (tmatch_e'^T . tallow_e') > 0
  ingress  = (tallow_i'^T . tmatch_i') > 0
  combined = egress & ingress

over int8 0/1 operands whose target axis carries one extra PSEUDO-TARGET
row per direction (_augment): it matches the valid pods that have no
target and allows the valid pods, and invalid pod columns are zero in
both operands, so `acc > 0` is the whole verdict (the allow-if-no-target
rule and the validity mask ride the contraction) and an invalid pod
counts nothing.  The pseudo row sits right after the last target row
whose (validity-masked) match row holds a nonzero; the rows after it
(the inert targets that bucket the axis, or targets that match no valid
pod) add nothing to either contraction.  Each direction's LIVE DEPTH —
the rows up to the pseudo row, rounded up to 32 — is all K4 and K5
load.  The output is [Q, n_src_tiles, 3] int32 partial counts (ingress,
egress, combined), summed on the host in int64 (sum_partials).

Routes, decided as the reference decides them:

  * verdict_counts_rect / verdict_counts — K4 when both directions'
    augmented target axes fit one chunk of at most KT rows (_kt_for), else
    K5, which skips a (64-pod block, target chunk) pair whose match
    operand is all zero (nz maps, _nz_maps); both stop at the live depth;
  * verdict_counts_slab_from_ops — K6 over operands gathered per pod tile
    (slab_operands): each tile pair contracts over its w-row target
    windows plus the pseudo/validity row, padded to slab_w_aug rows.  The
    caller proves on the host (slab_windows, host._slab_plan) that every
    tile's targets fit its window; a violated window undercounts.

Each wrapper takes the plain PyTorch version for a tensor on the CPU and
launches the hand-written kernel (csrc/dense_counts.cu) for a CUDA
tensor, or raises.  Operand layout (target axis innermost, padded to the
chunk; src axis padded to `bs`, dst axis to CUDA_TILE):

  a_e [Ns', Te'] int8      b_e [Q, Nd', Te'] int8
  b_i [Q, Ns', Ti'] int8   a_i [Nd', Ti'] int8

and, for K6, per tile (w_aug = slab_w_aug(w) rows of window):

  a_e [n_i, bs, w_aug]     b_e [Q, n_i, Nd', w_aug]
  b_i [Q, n_j, Ns', w_aug] a_i [n_j, bd, w_aug]

The operand dtype is int8 only: the reference's CYCLONUS_PALLAS_DTYPE=bf16
is a TPU operand choice that changes no result.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from . import build

#: the largest target-axis chunk (rows); the per-direction chunk is
#: _kt_for of the augmented target count.  Read at call time.
KT = 1024
#: src rows per int32 partial count (a multiple of CUDA_TILE on the card)
BS = 1024
#: the CUDA kernel's pod block: a consumer warpgroup's src rows, the
#: granularity of K5's nz maps; the dst axis pads to it
CUDA_TILE = 64
#: the depth granularity of the int8 tensor-core instructions (bytes)
DEPTH_STEP = 32

#: K6 defaults: window rows, src tile and dst tile.  Read at call time, so
#: a test can set them small.
SLAB_W = 128
SLAB_BS = 2048
SLAB_BD = 1024

#: launches of each kernel, counted by the wrapper where it launches
LAUNCHES: Dict[str, int] = {
    "dense_counts_1chunk": 0,
    "dense_counts_chunked": 0,
    "dense_counts_slab": 0,
}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def lane_round_up(n: int) -> int:
    """Smallest multiple of 128 >= n (>= 128)."""
    return -(-max(int(n), 1) // 128) * 128


def _kt_for(n_targets: int) -> int:
    """Per-direction target-axis chunk: a multiple of 128, no larger than
    needed and at most KT."""
    return max(128, min(KT, lane_round_up(n_targets)))


def _pad_to(x: torch.Tensor, dim: int, mult: int) -> torch.Tensor:
    """Zero-pad `dim` up to a multiple of `mult` — at least one full
    chunk, so a zero-size axis (a direction with no targets) still yields
    an all-zero block."""
    n = x.shape[dim]
    pad = mult if n == 0 else (-n) % mult
    if pad == 0:
        return x
    widths = [0, 0] * (x.dim() - 1 - dim) + [0, pad]
    return torch.nn.functional.pad(x, widths)


def _check_int32_partials(bs: int, nd_pad: int) -> None:
    # raise, not assert: a runtime size guard
    if bs * nd_pad >= 2**31:
        raise ValueError(f"dst axis {nd_pad} too large for int32 tile counts at bs={bs}")


def live_depth(n_rows: int) -> int:
    """The live depth of a direction: its first n_rows target rows plus
    the pseudo row, rounded up to DEPTH_STEP bytes."""
    return -(-(int(n_rows) + 1) // DEPTH_STEP) * DEPTH_STEP


def data_rows(tmatch: torch.Tensor) -> int:
    """The target rows up to the last one that matches a pod (tmatch
    [T, N], validity-masked): every row after it is zero on the match
    side, so it adds nothing to the contraction."""
    rows = tmatch.ne(0).any(dim=1).nonzero()
    return int(rows[-1]) + 1 if rows.numel() else 0


def _augment(tmatch, has, tallow_qtn, valid_match, valid_allow):
    """Zero the invalid-pod columns of BOTH operands — peers that match
    every pod match the inert pad pods too, and an unmasked pad column
    would count as allowed; tmatch needs the mask as well, since a
    validity mask may invalidate a real pod that a real target matches —
    and insert the pseudo-target row (matches valid no-target pods on the
    MATCH side, allows valid pods on the ALLOW side) right after the
    data_rows of the masked tmatch.  Returns tmatch' [T+1, N], tallow'
    [Q, T+1, N], int8, and the pseudo row's index."""
    od = torch.int8
    va = valid_allow.to(od)
    vm = valid_match.to(od)
    pseudo_match = ((~has) & valid_match).to(od)[None, :]
    tmatch = tmatch.to(od) * vm[None, :]
    n = data_rows(tmatch)
    tmatch = torch.cat([tmatch[:n], pseudo_match, tmatch[n:]], dim=0)
    tallow_qtn = tallow_qtn * va[None, None, :]
    q = tallow_qtn.shape[0]
    valid_q = va[None, None, :].expand(q, 1, va.shape[0])
    tallow_qtn = torch.cat([tallow_qtn[:, :n], valid_q, tallow_qtn[:, n:]], dim=1)
    return tmatch, tallow_qtn, n


def dense_operands(
    tmatch_e, has_e, tallow_e, tmatch_i, has_i, tallow_i,
    valid_src=None, valid_dst=None, bs: Optional[int] = None,
) -> Dict:
    """The K4/K5 operand layout (module docstring) with its chunks and
    live depths: {a_e, b_e, b_i, a_i, kt_e, kt_i, live_e, live_i, bs}."""
    bs = BS if bs is None else int(bs)
    if bs < 1 or bs % CUDA_TILE:
        raise ValueError(f"bs={bs}: want a positive multiple of {CUDA_TILE}")
    ns = tmatch_e.shape[1]
    nd = tmatch_i.shape[1]
    _check_int32_partials(bs, -(-max(nd, 1) // CUDA_TILE) * CUDA_TILE)
    dev = tmatch_e.device
    if dev.type not in ("cpu", "cuda"):
        # the live depth is read from the operands' values
        raise ValueError(f"no dense counts kernel for device {dev}")
    if valid_src is None:
        valid_src = torch.ones(ns, dtype=torch.bool, device=dev)
    if valid_dst is None:
        valid_dst = torch.ones(nd, dtype=torch.bool, device=dev)
    tm_e, tl_e, live_e = _augment(
        tmatch_e, has_e, tallow_e.permute(2, 0, 1).to(torch.int8), valid_src, valid_dst
    )
    tm_i, tl_i, live_i = _augment(
        tmatch_i, has_i, tallow_i.permute(2, 0, 1).to(torch.int8), valid_dst, valid_src
    )
    kt_e = _kt_for(tm_e.shape[0])
    kt_i = _kt_for(tm_i.shape[0])
    # each axis pads to its own multiple; the operand pairs that share an
    # axis (a_e + b_i the src axis, b_e + a_i the dst axis) pad alike
    a_e = _pad_to(_pad_to(tm_e, 0, kt_e), 1, bs).T.contiguous()  # [Ns', Te']
    b_e = _pad_to(_pad_to(tl_e, 1, kt_e), 2, CUDA_TILE).transpose(1, 2).contiguous()  # [Q, Nd', Te']
    b_i = _pad_to(_pad_to(tl_i, 1, kt_i), 2, bs).transpose(1, 2).contiguous()  # [Q, Ns', Ti']
    a_i = _pad_to(_pad_to(tm_i, 0, kt_i), 1, CUDA_TILE).T.contiguous()  # [Nd', Ti']
    return {"a_e": a_e, "b_e": b_e, "b_i": b_i, "a_i": a_i, "kt_e": kt_e, "kt_i": kt_i,
            "live_e": live_depth(live_e), "live_i": live_depth(live_i), "bs": bs}


def single_chunk(ops: Dict) -> bool:
    """True when both directions fit one target chunk: K4; else K5."""
    return ops["a_e"].shape[1] == ops["kt_e"] and ops["a_i"].shape[1] == ops["kt_i"]


def _nz_maps(ops: Dict):
    """K5's content maps at the kernel's geometry: nz_e [Ns'/64, n_k_e]
    (egress: src block x chunk of a_e) and nz_i [Nd'/64, n_k_i] (ingress:
    dst block x chunk of a_i), int32, 1 where the block holds a nonzero.
    Built from the augmented operands, so the chunk of a pseudo row that
    matches any pod of the block is never skipped."""
    out = []
    for a, kt in ((ops["a_e"], ops["kt_e"]), (ops["a_i"], ops["kt_i"])):
        n, depth = a.shape
        blocks = a.view(n // CUDA_TILE, CUDA_TILE, depth // kt, kt)
        out.append(blocks.ne(0).any(dim=3).any(dim=1).to(torch.int32).contiguous())
    return tuple(out)


def with_nz_maps(ops: Dict) -> Dict:
    """dense_operands with K5's nz maps under "nz" when the operands take
    K5, so a pinned operand dict holds everything a launch reads."""
    return ops if single_chunk(ops) else {**ops, "nz": _nz_maps(ops)}


def _dot_dtype(device: torch.device) -> torch.dtype:
    """Float type of the plain contractions: float32 on the CPU (where
    bf16 products are slow), bf16 on the card.  Both are exact for the
    `> 0` test of 0/1 operands."""
    return torch.float32 if device.type == "cpu" else torch.bfloat16


def _counts_plain(ops: Dict) -> torch.Tensor:
    """The plain version of K4 and K5: per port case and src segment of
    `bs` rows, one matmul per direction over the whole depth.  It skips
    no block and contracts past the live depth, so it checks K5's skip and
    K4/K5's live depth rather than repeating them."""
    a_e, b_e, b_i, a_i, bs = ops["a_e"], ops["b_e"], ops["b_i"], ops["a_i"], ops["bs"]
    dt = _dot_dtype(a_e.device)
    q = b_e.shape[0]
    ns_pad = a_e.shape[0]
    out = torch.zeros((q, ns_pad // bs, 3), dtype=torch.int32, device=a_e.device)
    ai_t = a_i.to(dt).T
    for qi in range(q):
        be_t = b_e[qi].to(dt).T
        for i in range(ns_pad // bs):
            rows = slice(i * bs, (i + 1) * bs)
            egress = (a_e[rows].to(dt) @ be_t) > 0  # [bs, Nd']
            ingress = (b_i[qi, rows].to(dt) @ ai_t) > 0
            out[qi, i, 0] = ingress.sum(dtype=torch.int32)
            out[qi, i, 1] = egress.sum(dtype=torch.int32)
            out[qi, i, 2] = (egress & ingress).sum(dtype=torch.int32)
    return out


_lib = None


def _library():
    global _lib
    if _lib is None:
        from .build import load

        lib = load("dense_counts")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.cyclonus_dense_counts.argtypes = [p] * 7 + [i] * 13 + [p]
        lib.cyclonus_dense_counts.restype = i
        lib.cyclonus_dense_kernel_attrs.argtypes = [i] + [ctypes.POINTER(i)] * 4
        lib.cyclonus_dense_kernel_attrs.restype = i
        lib.cyclonus_dense_error_string.argtypes = [i]
        lib.cyclonus_dense_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(err: int, what: str) -> None:
    if err != 0:
        msg = _library().cyclonus_dense_error_string(err).decode()
        raise RuntimeError(f"{what} failed: {msg} ({err})")


#: the kernel instance each wrapper launches, dense_counts_kernel<skip,
#: stage depth> in csrc/dense_counts.cu, in the order of the C entry's
#: `kind` argument
INSTANCES = {
    "dense_counts_1chunk": "dense_counts_kernel<false, 128>",
    "dense_counts_chunked": "dense_counts_kernel<true, 128>",
    "dense_counts_slab": "dense_counts_kernel<false, 64>",
}
_KIND = {name: k for k, name in enumerate(INSTANCES)}


def kernel_attrs() -> Dict[str, Dict]:
    """Per kernel (LAUNCHES keys): the instance it launches, registers per
    thread, static and dynamic shared memory and local (spill) bytes per
    thread, as the loaded library reports them."""
    lib = _library()
    out = {}
    for name, instance in INSTANCES.items():
        vals = [ctypes.c_int() for _ in range(4)]
        _check(lib.cyclonus_dense_kernel_attrs(_KIND[name], *[ctypes.byref(v) for v in vals]),
               f"{name} attributes")
        out[name] = {"instance": instance, **dict(zip(
            ("regs", "smem_static", "smem_dynamic", "local_bytes"), (v.value for v in vals)))}
    return out


def _check_operands(dev, named) -> None:
    for name, t in named:
        want = torch.int32 if name.startswith("nz") else torch.int8
        if t.device != dev or t.dtype != want or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: want a contiguous, 16-byte aligned {want} tensor on {dev}")


def _launch(kind: str, ops: Dict, *, n_i: int, n_j: int, tile_rows: int, tile_cols: int,
            seg_rows: int, live_e: int, live_i: int, nz=None) -> torch.Tensor:
    """One launch of csrc/dense_counts.cu over n_i x n_j (src, dst) tiles:
    K4 (one tile per axis), K5 (the same with its nz maps) or K6 (the slab
    tiles).  Returns the [Q, n_i * tile_rows / seg_rows, 3] partials."""
    a_e, b_e, b_i, a_i = ops["a_e"], ops["b_e"], ops["b_i"], ops["a_i"]
    dev = a_e.device
    named = [("a_e", a_e), ("b_e", b_e), ("b_i", b_i), ("a_i", a_i)]
    if nz is not None:
        named += [("nz_e", nz[0]), ("nz_i", nz[1])]
    _check_operands(dev, named)
    q = b_e.shape[0]
    de, di = a_e.shape[-1], a_i.shape[-1]
    for name, live, depth in (("live_e", live_e, de), ("live_i", live_i, di)):
        if live % DEPTH_STEP or not DEPTH_STEP <= live <= depth:
            raise ValueError(f"{name}={live}: want a multiple of {DEPTH_STEP} in "
                             f"[{DEPTH_STEP}, {depth}]")
    out = torch.zeros((q, n_i * tile_rows // seg_rows, 3), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = _library().cyclonus_dense_counts(
            a_e.data_ptr(), b_e.data_ptr(), b_i.data_ptr(), a_i.data_ptr(),
            None if nz is None else nz[0].data_ptr(), None if nz is None else nz[1].data_ptr(),
            out.data_ptr(), _KIND[kind], q, n_i, n_j, tile_rows, tile_cols, seg_rows, de, di,
            live_e, live_i, ops.get("kt_e", 0), ops.get("kt_i", 0),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _check(err, f"{kind} kernel launch")
    LAUNCHES[kind] += 1
    return out


def _counts_cuda(ops: Dict, nz=None) -> torch.Tensor:
    """K4 (nz None: every (block, chunk) kept) or K5 (with its nz maps) on
    the operands' device, each loading up to its live depths."""
    a_e, b_e, b_i, a_i, bs = ops["a_e"], ops["b_e"], ops["b_i"], ops["a_i"], ops["bs"]
    q, nd_pad, de = b_e.shape
    ns_pad, di = b_i.shape[1], b_i.shape[2]
    if tuple(a_e.shape) != (ns_pad, de) or tuple(a_i.shape) != (nd_pad, di):
        raise ValueError("dense operands disagree in shape")
    if bs % CUDA_TILE or ns_pad % bs or nd_pad % CUDA_TILE:
        raise ValueError(
            f"the CUDA kernel needs bs % {CUDA_TILE} == 0 and a dst axis padded to a "
            f"multiple of {CUDA_TILE} (bs={bs}, Nd'={nd_pad})"
        )
    kind = "dense_counts_1chunk" if nz is None else "dense_counts_chunked"
    return _launch(kind, ops, n_i=1, n_j=1, tile_rows=ns_pad, tile_cols=nd_pad, seg_rows=bs,
                   live_e=ops["live_e"], live_i=ops["live_i"], nz=nz)


def counts_from_ops(ops: Dict, plain: bool = False) -> torch.Tensor:
    """[Q, Ns'/bs, 3] int32 partials from dense_operands: K4 when both
    directions fit one chunk, else K5 with its nz maps (those under "nz",
    with_nz_maps, or built now).  A CPU tensor (or plain=True) takes the
    plain version; a CUDA tensor the kernel."""
    kind = ops["a_e"].device.type
    if plain:
        return _counts_plain(ops)
    # the reference's rect program and its chunk kernel trace together
    shapes = tuple(tuple(ops[k].shape) for k in ("a_e", "b_e", "b_i", "a_i"))
    build.note_trace("counts_rect", kind, shapes)
    build.note_trace("counts_1chunk" if single_chunk(ops) else "counts_chunked", kind, shapes)
    if kind == "cpu":
        return _counts_plain(ops)
    if kind == "cuda":
        if single_chunk(ops):
            return _counts_cuda(ops)
        return _counts_cuda(ops, ops["nz"] if "nz" in ops else _nz_maps(ops))
    raise ValueError(f"no dense counts kernel for device {ops['a_e'].device}")


def verdict_counts_rect(
    tmatch_e: torch.Tensor,  # [T_e, Ns] bool — egress targets vs SRC pods
    has_e: torch.Tensor,  # [Ns] bool
    tallow_e: torch.Tensor,  # [T_e, Nd, Q] 0/1 (bf16 or bool) — egress allows DST
    tmatch_i: torch.Tensor,  # [T_i, Nd] bool — ingress targets vs DST pods
    has_i: torch.Tensor,  # [Nd] bool
    tallow_i: torch.Tensor,  # [T_i, Ns, Q] 0/1 — ingress allows SRC
    valid_src: Optional[torch.Tensor] = None,  # [Ns] bool, any pattern
    valid_dst: Optional[torch.Tensor] = None,  # [Nd] bool
    bs: Optional[int] = None,
    plain: bool = False,
) -> torch.Tensor:
    """[Q, Ns'/bs, 3] int32 partial allow counts (ingress, egress,
    combined) over the Ns x Nd x Q grid; rectangular, with per-side
    validity masks that need not be prefixes.  K4 or K5 (module
    docstring); plain=True forces the plain version on any device."""
    ops = dense_operands(
        tmatch_e, has_e, tallow_e, tmatch_i, has_i, tallow_i, valid_src, valid_dst, bs
    )
    return counts_from_ops(ops, plain=plain)


def verdict_counts(
    tmatch_e, has_e, tallow_e, tmatch_i, has_i, tallow_i,
    n_pods: Optional[int] = None, bs: Optional[int] = None, plain: bool = False,
) -> torch.Tensor:
    """Square form (src pods == dst pods, the first n_pods of them
    valid) of verdict_counts_rect."""
    n = tmatch_e.shape[1]
    valid = torch.arange(n, device=tmatch_e.device) < (n if n_pods is None else int(n_pods))
    return verdict_counts_rect(
        tmatch_e, has_e, tallow_e, tmatch_i, has_i, tallow_i,
        valid_src=valid, valid_dst=valid, bs=bs, plain=plain,
    )


# --- K6: per-tile target slabs ----------------------------------------------


def slab_w_aug(w: Optional[int] = None) -> int:
    """Window depth the slab kernel contracts over: the w-row window plus
    the pseudo/validity row, rounded up to the int8 tile of 32 rows."""
    if w is None:
        w = SLAB_W
    return -(-(w + 1) // 32) * 32


def slab_windows(tmatch: np.ndarray, tile: int, w: Optional[int] = None):
    """Per-tile target-window starts from a host (numpy, valid-masked)
    tmatch [T, N]: (t0 [n_tiles] int32, ok).  ok is False when some tile's
    nonzero rows span more than w rows — the slab kernel must not run
    then.  Empty tiles get t0 = 0."""
    if w is None:
        w = SLAB_W
    t, n = tmatch.shape
    n_tiles = -(-n // tile) if n else 0
    if n_tiles == 0 or t == 0:
        return np.zeros(max(n_tiles, 1), dtype=np.int32), True
    pad = n_tiles * tile - n
    if pad:
        tmatch = np.pad(tmatch, ((0, 0), (0, pad)))
    nz = tmatch.reshape(t, n_tiles, tile).any(axis=2)  # [T, n_tiles]
    any_t = nz.any(axis=0)
    first = np.where(any_t, nz.argmax(axis=0), 0).astype(np.int32)
    last = np.where(any_t, t - 1 - nz[::-1].argmax(axis=0), -1)
    ok = bool(((last - first) < w).all())
    return first, ok


def _window_start(start: int, dim: int, size: int) -> int:
    """A slice start clamped into [0, dim - size], as a dynamic slice
    clamps it."""
    return min(max(int(start), 0), dim - size)


def _starts(t0) -> Sequence[int]:
    if isinstance(t0, torch.Tensor):
        t0 = t0.cpu().numpy()
    return [int(x) for x in np.asarray(t0).reshape(-1)]


def slab_operands(
    tmatch_e, has_e, tallow_e, tmatch_i, has_i, tallow_i,
    t0_e, t0_i, n_pods: int,
    bs: Optional[int] = None, bd: Optional[int] = None, w: Optional[int] = None,
) -> Dict[str, torch.Tensor]:
    """The slab kernel's gathered operands {a_e, b_e, b_i, a_i} (module
    docstring), in plain PyTorch: per src tile i the w-row window of the
    egress targets starting at t0_e[i], per dst tile j the ingress window
    at t0_i[j], each followed by the pseudo row (match side) or the
    validity row (allow side) and zero rows up to slab_w_aug(w).  The
    first n_pods pods are valid.  bs, bd and w default to SLAB_BS,
    SLAB_BD and SLAB_W, read now."""
    bs = SLAB_BS if bs is None else int(bs)
    bd = SLAB_BD if bd is None else int(bd)
    w = SLAB_W if w is None else int(w)
    od = torch.int8
    dev = tmatch_e.device
    n = tmatch_e.shape[1]
    q = tallow_e.shape[2]
    live = torch.arange(n, device=dev) < int(n_pods)
    valid = live.to(od)
    ns_pad = -(-max(n, 1) // bs) * bs
    nd_pad = -(-max(n, 1) // bd) * bd
    n_i, n_j = ns_pad // bs, nd_pad // bd
    _check_int32_partials(bs, nd_pad)

    def prep(tmatch, tallow, n_pad_match, n_pad_allow):
        """Valid-masked, int8, pod-padded operands plus w zero rows on the
        target axis: an empty tile's window reads only zeros."""
        tm = tmatch.to(od) * valid[None, :]
        tl = tallow.permute(2, 0, 1).to(od) * valid[None, None, :]
        tm = _pad_to(_pad_to(tm, 0, 1), 1, n_pad_match)
        tl = _pad_to(tl, 2, n_pad_allow)
        tm = torch.nn.functional.pad(tm, (0, 0, 0, w))
        tl = torch.nn.functional.pad(tl, (0, 0, 0, w))
        return tm, tl

    tm_e, tl_e = prep(tmatch_e, tallow_e, bs, bd)
    tm_i, tl_i = prep(tmatch_i, tallow_i, bd, bs)
    w_aug = slab_w_aug(w)

    def clipped(t0, t_pad, count):
        starts = [min(max(s, 0), t_pad - w) for s in _starts(t0)]
        if len(starts) != count:
            raise ValueError(f"{len(starts)} window starts for {count} tiles")
        return starts

    t0_e = clipped(t0_e, tm_e.shape[0], n_i)
    t0_i = clipped(t0_i, tm_i.shape[0], n_j)

    def gather_tm(tm, starts, tile, pseudo):
        """[count, tile, w_aug]: each tile's pod columns of its w-row
        window, then the pseudo row, then zeros."""
        out = torch.zeros((len(starts), tile, w_aug), dtype=od, device=dev)
        for i, s in enumerate(starts):
            s = _window_start(s, tm.shape[0], w)
            out[i, :, :w] = tm[s : s + w, i * tile : (i + 1) * tile].T
        out[:, :, w] = pseudo.view(len(starts), tile)
        return out

    def gather_tl(tl, starts, vrow_other):
        """[Q, count, n_other, w_aug]: the window over every pod of the
        other side, then the validity row, then zeros."""
        n_other = tl.shape[2]
        out = torch.zeros((q, len(starts), n_other, w_aug), dtype=od, device=dev)
        for i, s in enumerate(starts):
            s = _window_start(s, tl.shape[1], w)
            out[:, i, :, :w] = tl[:, s : s + w, :].transpose(1, 2)
        out[:, :, :, w] = vrow_other
        return out

    def padded(v, size):
        return _pad_to(v[None, :], 1, size)[0]

    pe_s = padded(((~has_e) & live).to(od), bs)  # [ns_pad]
    pi_d = padded(((~has_i) & live).to(od), bd)  # [nd_pad]
    vs = padded(valid, bs)
    vd = padded(valid, bd)
    # egress: acc[s, d] += pe[s] * vd[d]; ingress: acc[s, d] += vs[s] * pi[d]
    return {
        "a_e": gather_tm(tm_e, t0_e, bs, pe_s),  # [n_i, bs, w_aug]
        "b_e": gather_tl(tl_e, t0_e, vd),  # [Q, n_i, nd_pad, w_aug]
        "b_i": gather_tl(tl_i, t0_i, vs),  # [Q, n_j, ns_pad, w_aug]
        "a_i": gather_tm(tm_i, t0_i, bd, pi_d),  # [n_j, bd, w_aug]
    }


def _slab_counts_plain(ops: Dict) -> torch.Tensor:
    """The plain version of K6: per port case and src tile, one matmul
    for egress and one batched matmul over the dst tiles for ingress."""
    a_e, b_e, b_i, a_i = ops["a_e"], ops["b_e"], ops["b_i"], ops["a_i"]
    n_i, bs, _ = a_e.shape
    n_j, bd, _ = a_i.shape
    q = b_e.shape[0]
    dt = _dot_dtype(a_e.device)
    out = torch.zeros((q, n_i, 3), dtype=torch.int32, device=a_e.device)
    ai_t = a_i.to(dt).transpose(1, 2)  # [n_j, w_aug, bd]
    for qi in range(q):
        for i in range(n_i):
            egress = (a_e[i].to(dt) @ b_e[qi, i].to(dt).T) > 0  # [bs, Nd']
            rows = b_i[qi, :, i * bs : (i + 1) * bs].to(dt)  # [n_j, bs, w_aug]
            ingress = ((rows @ ai_t) > 0).permute(1, 0, 2).reshape(bs, n_j * bd)
            out[qi, i, 0] = ingress.sum(dtype=torch.int32)
            out[qi, i, 1] = egress.sum(dtype=torch.int32)
            out[qi, i, 2] = (egress & ingress).sum(dtype=torch.int32)
    return out


def verdict_counts_slab_from_ops(ops: Dict, plain: bool = False) -> torch.Tensor:
    """[Q, n_i, 3] int32 partials (one per port case and src tile) from
    slab_operands.  Every layout parameter comes from the operand shapes.
    A CPU tensor (or plain=True) takes the plain version; a CUDA tensor
    launches K6, or raises."""
    a_e, b_e, b_i, a_i = ops["a_e"], ops["b_e"], ops["b_i"], ops["a_i"]
    n_i, bs, w_aug = a_e.shape
    n_j, bd, _ = a_i.shape
    q = b_e.shape[0]
    ns_pad, nd_pad = n_i * bs, n_j * bd
    if (tuple(b_e.shape) != (q, n_i, nd_pad, w_aug) or tuple(b_i.shape) != (q, n_j, ns_pad, w_aug)
            or a_i.shape[2] != w_aug):
        raise ValueError("slab operands disagree in shape")
    _check_int32_partials(bs, nd_pad)
    kind = a_e.device.type
    if plain:
        return _slab_counts_plain(ops)
    build.note_trace("counts_slab", kind, tuple(tuple(ops[k].shape) for k in ("a_e", "b_e", "b_i", "a_i")))
    if kind == "cpu":
        return _slab_counts_plain(ops)
    if kind == "cuda":
        return _launch("dense_counts_slab", ops, n_i=n_i, n_j=n_j, tile_rows=bs, tile_cols=bd,
                       seg_rows=bs, live_e=w_aug, live_i=w_aug)
    raise ValueError(f"no slab counts kernel for device {a_e.device}")

