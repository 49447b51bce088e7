"""The yardstick of the packed counts kernels: the least time an H100
could take for one counts call, from counts that the benchmark reckons
from the cell's own inputs.

The arithmetic is a frozen copy of the reference project's smoke test
(chip_smoke.bound and tier_work): the least time is the larger of the
bytes over HBM bandwidth and the operations' time, the operations' time
the least of three ways to run the same contraction (the 32-bit integer
pipe, the int8 tensor cores, the single-bit tensor cores), plus the tier
work on the integer pipe.  What it is fed is the benchmark's own: the
pods, the NetworkPolicy targets of each direction that select some pod
(the "live" target rows, one more where some pod has no target), the
port cases, and the admin tier rules' matched cells, all worked out
from the plain cluster state by the selectors' semantics
(reference/netpol.py), never read from the program's operand tensors.
So a change to the program's encoding cannot move it.

Each input byte counts once and the output once: per direction the
pods' target bits and the targets' allowed bits per peer pod and case,
bit-packed in 32-bit words of live rows, and for the tiers a bit per
(rule, pod) and per (rule, pod, case).
"""

from __future__ import annotations

import math
from collections import Counter
from typing import Dict, Sequence, Tuple

import torch

from . import netpol

#: peak 32-bit integer instructions/s of one H100 SXM at 700 W, derived
#: from the data sheet's 67e12 float32 FLOP/s: that counts an FMA as two
#: operations on 128 float32 lanes per clock and SM; the integer pipe that
#: issues LOP3 (and, or, compare, select) has 64 lanes per clock and SM,
#: so 67e12 / 2 * 64 / 128
PEAK_INT_OPS = 67e12 / 4
#: HBM bytes/s of the same card (data sheet)
PEAK_BYTES = 3.35e12
#: dense int8 tensor-core operations/s of the same card (data sheet; a
#: multiply-add counts two)
PEAK_INT8_OPS = 1.979e15
#: single-bit tensor-core operations/s (a bit multiply-add counts two).
#: NVIDIA publishes no rate; this is the rate measured for wgmma
#: m64n256k256 .b1.and.popc on an H100 80GB HBM3 at 700 W by the
#: repository's torch_tools/mma_probe.py, 7.883e15 bit multiply-adds/s
PEAK_B1_OPS = 2 * 7.883e15
PEAKS = {
    "int_ops_per_s": PEAK_INT_OPS, "hbm_bytes_per_s": PEAK_BYTES,
    "int8_ops_per_s": PEAK_INT8_OPS, "b1_ops_per_s": PEAK_B1_OPS,
    "b1_source": "measured (wgmma .b1.and.popc, H100 80GB HBM3, 700 W); no published rate",
}
#: the epilogue, per cell: the != 0 test of each direction's accumulator
EPILOGUE_CELL_OPS = 2
#: per 32 cells: fold each direction's bits into a mask (2), OR each with
#: the cells whose subject has no target (2), AND the two validity masks
#: (1), then per verdict the AND with validity, popc and add (9)
EPILOGUE_WORD_OPS = 14
#: tiered, per (tier rule, 32 cells it matches): the AND of the rule's
#: subject and peer masks, then the update of its tier's decided mask and
#: of its allow or deny mask
TIER_ROW_OPS = 3
#: tiered, per 32 cells of a direction that some rule matches: the
#: lattice as mask logic
LATTICE_WORD_OPS = 2


def packed_counts_least_s(work: Dict) -> Tuple[float, str, float, float]:
    """(seconds, bound_by, operations, bytes) of one counts call whose work
    is `work` (see key_work)."""
    q, n = work["cases"], work["pods"]
    live_e, live_i = work["live_rows"]["egress"], work["live_rows"]["ingress"]
    we, wi = math.ceil(live_e / 32), math.ceil(live_i / 32)
    cells = q * n * n
    # target bits per pod, allowed bits per (pod, case), per direction;
    # each direction's has-target flag; the counts out
    nbytes = 4 * (we + wi) * (n + n * q) + 2 * n / 8 + 4 * 4
    int_ops = cells * (we + wi + EPILOGUE_CELL_OPS) + EPILOGUE_WORD_OPS * cells / 32
    tc_ops = 2 * cells * (live_e + live_i)
    n_ops, ops_s = min((int_ops, int_ops / PEAK_INT_OPS), (tc_ops, tc_ops / PEAK_INT8_OPS),
                       (tc_ops, tc_ops / PEAK_B1_OPS), key=lambda c: c[1])
    rules = work["tier_rules"]
    if rules:
        nbytes += rules * n * (1 + q) / 8
        tier_ops = (TIER_ROW_OPS * work["tier_row_cells"] + LATTICE_WORD_OPS * work["tier_cells"]) / 32
        n_ops += tier_ops
        ops_s += tier_ops / PEAK_INT_OPS
    by = "operations" if ops_s >= nbytes / PEAK_BYTES else "bytes"
    return max(ops_s, nbytes / PEAK_BYTES), by, n_ops, nbytes


def key_work(
    keys: Counter,
    namespaces: Dict[str, Dict[str, str]],
    ps: netpol.PolicySet,
    cases: Sequence[netpol.Case],
    device="cpu",
) -> Dict:
    """The work of one counts call at a cluster state given as a Counter
    of pod keys (namespace, sorted label items) -> pods, against a
    compiled PolicySet.  Selectors see only namespaces and labels, so the
    keys are enough: no pod address enters a target or an admin scope.

    live_rows[d]: the distinct targets of direction d that select some
    pod, plus one where some pod has none.  tier_row_cells: per admin
    rule and case it matches, subject pods x peer pods, summed;
    tier_cells: the cells (subject, peer, case) that some rule matches."""
    keys = +keys
    order = list(keys)
    sel_keys = ps.match_keys(order, namespaces, device).cpu()  # [S, U]
    count = torch.tensor([float(keys[k]) for k in order], dtype=torch.float64)
    live = {}
    for d in ("ingress", "egress"):
        targets = sorted(ps.np_targets[d])
        if targets:
            sel = sel_keys[torch.tensor(targets)]
            live[d] = int(sel.any(dim=1).sum()) + int((~sel.any(dim=0)).any())
        else:
            live[d] = 1
    peer_sel = {k: ps.sels[key] for key, k in ps.peers.items() if key[0] == "sel"}
    rules = sum(len(ps.anp_rules[d]) + len(ps.banp_rules[d]) for d in ("ingress", "egress"))
    row_cells = cells = 0.0
    for d in ("ingress", "egress"):
        for case in cases:
            ms = [(r[0], r[1]) for r in ps.anp_rules[d] + ps.banp_rules[d]
                  if netpol.admin_port_matches(r[2], case)]
            if not ms:
                continue
            union = torch.zeros(len(order), len(order), dtype=torch.bool)
            for subj, peers in ms:
                sub = sel_keys[subj]
                peer = torch.zeros(len(order), dtype=torch.bool)
                for k in peers:
                    peer |= sel_keys[peer_sel[k]]
                row_cells += float(count[sub].sum() * count[peer].sum())
                union |= sub[:, None] & peer[None, :]
            cells += float((count[:, None] * count[None, :])[union].sum())
    return {"pods": int(sum(keys.values())), "cases": len(cases), "live_rows": live,
            "tier_rules": rules, "tier_row_cells": row_cells, "tier_cells": cells}
