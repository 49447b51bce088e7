#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (cyclonus_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each raising on failure:
  1. card     — name and power limit from nvidia-smi, torch and CUDA
                versions;
  2. build    — compile every CUDA kernel of the package (nvcc, sm_90a);
  3. kernels  — each kernel against its plain PyTorch version on the card,
                on seeded operands: ragged axes, Q in {1, 2, 3}, word
                depths from 1 to several hundred (many shared-memory
                staging chunks), invalid rows and columns, has=False rows,
                zero weights; the tiered variants (K3) also with 1 to
                1,500 tier rows per direction (within one staged pass of
                256 rows and past it), pad rows, whole words of pad rows
                and random ANP/BANP/Pass actions, with keys in the
                engine's order and in random order; the dense kernels (K4,
                K5) at target depths 0 to 3,000 (one to three chunks),
                with non-prefix masks, an all-has=False direction, a
                direction whose nz map is all zero, bucketing pad rows
                past the live depth (a multiple of neither 32 nor 128 nor
                the chunk, or only the pseudo row), pod axes off 128 and
                256, and block-diagonal operands for K5's skip (blocks
                kept for one of a block's two warpgroups or some of its
                four dst pieces), and the slab kernel (K6) at windows of
                1 to 128 rows and tiles from 8 wide to the default.
                Exact equality;
  4. truth tables — TorchPolicyEngine.evaluate_grid on the card against
                the scalar oracle, on both dtype plans (packed and
                pack=False), for every policy of all_examples(), and for
                seeds 0-15 of the tiered scenario generator on both class
                modes against the tiered oracle (grids and counts; K3 must
                have launched on the packed plan, K4 on every dense-plan
                example engine);
  5. main path — the benchmark's synthetic cluster (100,000 pods x 10,000
                policies, seed 20260729, port cases TCP 80 and named UDP
                81) through the default engine (class-compressed route,
                weighted kernel) and with class_compress="0" (dense route,
                plain-epilogue kernel), then the same with the benchmark's
                admin-tier lattice layered over it (the tiered kernels);
                on each path both counts must agree, both kernels must
                have launched, and the plain version must agree with the
                kernel path at a sub-size and with each kernel at the
                main-path shapes.  The tiered counts are held against the
                untiered ones: egress equal (every egress tier row is a
                pad), ingress lower (the tier0 <- app1 Deny hits TCP 80).
                Then the dense dtype plan (pack=False) on the same cluster:
                the dense route through K4, with compaction off through
                K5, with the slab forced through K6, the class route and
                the tiered routes through the tile loop; every leg's
                counts equal the packed plan's, each dense kernel
                launched and no packed one.  Times: encode, precompute,
                kernel (median of 5 CUDA-event runs), plain version, the
                kernel's bound, end-to-end cells/s; per kernel also its
                registers, shared memory and spill bytes.

Every comparison is exact.  Prints a JSON line of the main path's
end-to-end numbers, a JSON line of per-kernel numbers, then as its last
line {"ok": true, "device": {...}}.  Exits non-zero, with no result line,
when there is no CUDA device or any phase fails.  The port's CPU paths
are covered by tests/test_torch_*.py.
"""

from __future__ import annotations

import json
import random
import statistics
import subprocess
import sys
import time

#: peak 32-bit integer instructions/s of one H100 SXM at 700 W, derived
#: from the data sheet's 67e12 float32 FLOP/s: that counts an FMA as two
#: operations on 128 float32 lanes per clock and SM; the integer pipe that
#: issues LOP3 (and, or, compare, select) has 64 lanes per clock and SM,
#: so 67e12 / 2 * 64 / 128
PEAK_INT_OPS = 67e12 / 4
#: HBM bytes/s of the same card (data sheet)
PEAK_BYTES = 3.35e12
#: dense int8 tensor-core operations/s of the same card (data sheet; a
#: multiply-add counts two) — the least time for the dense kernels' int8
#: multiply-adds, whatever unit the port's kernels run them on
PEAK_INT8_OPS = 1.979e15
#: the benchmark's headline cluster (bench.py): pods, policies, seed
N_PODS = 100_000
N_POLICIES = 10_000
SEED = 20260729
#: the packed counts' epilogue, per cell: the != 0 test of each
#: direction's accumulator, one bit each of a 32-cell verdict mask; every
#: later step acts on 32 cells at once
EPILOGUE_CELL_OPS = 2
#: per 32 cells, plain counts: fold each direction's bits into a mask (2),
#: OR each with the cells whose subject has no target (2), AND the two
#: validity masks (1), then per verdict the AND with validity (the
#: combined one with both directions' masks in one LOP3), popc and add (9)
EPILOGUE_WORD_OPS = 14
#: weighted (row sums by w[dst]), per cell: one select of w[dst] per
#: verdict, its add going to the float pipe (which has twice the lanes)
WEIGHTED_CELL_OPS = 3
#: weighted, per 32 cells: the two folds, the two ORs with !has, the
#: combined AND and the validity AND
WEIGHTED_WORD_OPS = 6
#: tiered, per (live tier row, 32 cells it matches): the AND of the row's
#: subject and peer masks, then the update of its tier's decided mask and
#: of its allow or deny mask — processing a tier's rows in key order, a
#: row decides the cells it matches that no earlier row decided
TIER_ROW_OPS = 3
#: tiered, per 32 cells of a direction that some live row matches: the
#: lattice as mask logic, ANP allow | (~ANP deny & (has ? np : ~BANP deny))
LATTICE_WORD_OPS = 2
#: the dense sub-size at which the engine's kernel path is held against
#: its plain version
N_SUB = 8192


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int = 5, warm: int = 1) -> float:
    """Median milliseconds of `reps` runs of fn after `warm` runs, timed
    with CUDA events."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def card_info() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def random_operands(rng, q, we, wi, ns, nd, device):
    """Seeded packed operands with sparse bits (bit 31 included), some
    has=False rows, random rectangular validity and weights with zeros."""
    import numpy as np
    import torch

    def words(shape):
        bits = rng.random(shape + (32,)) < 0.02
        w = (bits.astype(np.uint64) << np.arange(32, dtype=np.uint64)).sum(-1)
        return torch.from_numpy(w.astype(np.uint32).view(np.int32)).to(device)

    def flags(n, p):
        return torch.from_numpy(rng.random(n) < p).to(device)

    args = [
        words((we, ns)), flags(ns, 0.7), words((we, nd, q)),
        words((wi, nd)), flags(nd, 0.7), words((wi, ns, q)),
    ]
    w = torch.from_numpy(rng.integers(0, 4, size=nd).astype(np.float32)).to(device)
    return args, flags(ns, 0.8), flags(nd, 0.8), w


def random_tier(rng, q, ns, nd, ge, gi, device, ordered=False):
    """A seeded `tier` operand of the packed counts kernel: random
    subjects and peers, ANP rows with Allow/Deny/Pass and BANP rows with
    Allow/Deny at random ranks (with ties), and pad rows whose keys are
    both TIER_KEY_NONE, among them the whole second word of rows where
    there are more than 64.  ordered=True draws the ranks the way the
    engine emits them: ANP rows first, then BANP rows, each by
    non-decreasing key (the kernel's in-order, bit-parallel path);
    otherwise the keys fall in random order (its per-cell min)."""
    import numpy as np
    import torch

    from cyclonus_tpu_torch.engine.encoding import TIER_KEY_NONE

    def keys(g):
        rank = rng.integers(0, max(g // 2, 1), size=g)
        banp = rng.random(g) < 0.3
        act = np.where(banp, rng.integers(1, 3, size=g), rng.integers(1, 4, size=g))
        key = (rank * 4 + act).astype(np.int32)
        if ordered:
            key = np.concatenate([np.sort(key[~banp]), np.sort(key[banp])])
            banp = np.sort(banp)
        pad = rng.random(g) < 0.2
        pad[32:64] = g > 64
        return (
            np.where(~banp & ~pad, key, TIER_KEY_NONE).astype(np.int32),
            np.where(banp & ~pad, key, TIER_KEY_NONE).astype(np.int32),
        )

    def bits(shape, p):
        return rng.random(shape) < p

    # sparser as the rows grow, so a cell matches a handful of rows
    p_e, p_i = min(0.3, 4 / ge) ** 0.5, min(0.3, 4 / gi) ** 0.5
    (ea, eb), (ia, ib) = keys(ge), keys(gi)
    tier = {
        "egress": {"subj": bits((ge, ns), p_e), "peerq": bits((ge, nd, q), p_e),
                   "anp_key": ea, "banp_key": eb},
        "ingress": {"subj": bits((gi, nd), p_i), "peerq": bits((gi, ns, q), p_i),
                    "anp_key": ia, "banp_key": ib},
    }
    return {d: {k: torch.from_numpy(v).to(device) for k, v in t.items()} for d, t in tier.items()}


def device_time_profile(fn, reps: int = 3):
    """(busy share, top kernels) of `reps` warm calls of fn under
    torch.profiler: the device's summed kernel time over the host wall
    time of the window, and the five kernels that took most of it.
    (None, []) when the profiler recorded no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device-side events only (kernels, copies): the host ops that
    # launched them carry the same time again
    rows = [
        (e.self_device_time_total, e.key)
        for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
    ]
    busy_us = sum(us for us, _ in rows)
    if busy_us <= 0:
        return None, []
    rows.sort(reverse=True)
    return busy_us / wall_us, [(k[:60], round(us / reps / 1e3, 3)) for us, k in rows[:5]]


def check_kernel(got, want, what: str) -> None:
    import torch

    if not torch.equal(got, want):
        bad = int((got != want).sum())
        raise AssertionError(f"kernel != plain at {what}: {bad} entries differ")


def phase_kernels(device) -> None:
    import numpy as np
    import torch

    from cyclonus_tpu_torch.engine import packed_kernel as pk

    rng = np.random.default_rng(20260729)
    shapes = [  # (q, we, wi, ns, nd)
        (1, 1, 1, 9, 9),
        (2, 12, 8, 1000, 777),
        (3, 33, 33, 523, 1500),
        (2, 1, 33, 2049, 130),
        (2, 300, 170, 200, 300),
        (1, 17, 420, 130, 260),
    ]
    n_checked = 0
    for q, we, wi, ns, nd in shapes:
        args, vs, vd, w = random_operands(rng, q, we, wi, ns, nd, device)
        variants = [
            {"n_pods": min(ns, nd) - 1},
            {"valid_src": vs, "valid_dst": vd},
            {"n_pods": ns, "w_dst": w},
            {"valid_src": vs, "valid_dst": vd, "w_dst": w, "bs": 64, "bd": 128},
        ]
        for kw in variants:
            got = pk.verdict_counts_packed(*args, **kw)
            torch.cuda.synchronize()
            want = pk.verdict_counts_packed_plain(*args, **kw)
            check_kernel(got, want, f"q={q} we={we} wi={wi} ns={ns} nd={nd} {sorted(kw)}")
            n_checked += 1
    log(f"kernels: {n_checked} untiered kernel-vs-plain checks equal")

    # the tiered variants: tier rows from one to past the reference's
    # 1,024-row ceiling; keys ordered as the engine emits them (K3's
    # in-order path) or in random order (its per-cell min); one pass of tier
    # words (256 rows a direction) and past it (restaged per src row)
    tiered = [  # (q, we, wi, ns, nd, ge, gi, ordered)
        (1, 1, 1, 9, 9, 1, 1, False),
        (2, 12, 8, 1000, 777, 4, 4, False),
        (2, 12, 8, 1000, 777, 4, 4, True),
        (3, 33, 33, 523, 1500, 40, 7, False),
        (3, 33, 33, 523, 1500, 100, 70, True),
        (1, 4, 4, 700, 650, 256, 90, True),
        (1, 4, 4, 700, 650, 257, 90, True),
        (2, 1, 33, 2049, 130, 1500, 600, False),
        (2, 1, 33, 2049, 130, 300, 200, True),
        (2, 300, 170, 200, 300, 513, 1500, False),
    ]
    n_tiered = 0
    for q, we, wi, ns, nd, ge, gi, ordered in tiered:
        args, vs, vd, w = random_operands(rng, q, we, wi, ns, nd, device)
        tier = random_tier(rng, q, ns, nd, ge, gi, device, ordered=ordered)
        variants = [
            {"n_pods": min(ns, nd) - 1},
            {"valid_src": vs, "valid_dst": vd},
            {"n_pods": ns, "w_dst": w},
            {"valid_src": vs, "valid_dst": vd, "w_dst": w, "bs": 64, "bd": 128},
        ]
        for kw in variants:
            got = pk.verdict_counts_packed(*args, tier=tier, **kw)
            torch.cuda.synchronize()
            want = pk.verdict_counts_packed_plain(*args, tier=tier, **kw)
            check_kernel(got, want, f"tiered q={q} ge={ge} gi={gi} ns={ns} nd={nd} "
                         f"ordered={ordered} {sorted(kw)}")
            n_tiered += 1
    log(f"kernels: {n_tiered} tiered kernel-vs-plain checks equal (tolerance: exact)")


def random_dense(rng, q, te, ti, ns, nd, device, n_ns=0, pads=(0, 0)):
    """Seeded dense-plan operands (tmatch bool, has bool, tallow bf16 per
    direction) with random rectangular validity.  n_ns > 0: pods and
    targets in the order of n_ns namespaces, tmatch block diagonal — most
    (pod block, target chunk) pairs all zero and narrow target windows
    per pod tile, as on the ns-sorted dense route.  pads: per direction,
    inert all-zero target rows appended after the te / ti drawn ones, as
    the engine's bucketing appends them."""
    import numpy as np
    import torch

    def tmatch(t, n, pad):
        if not n_ns:
            m = rng.random((t, n)) < 0.02
        else:
            m = (np.sort(rng.integers(0, n_ns, t))[:, None]
                 == np.sort(rng.integers(0, n_ns, n))[None, :]) & (rng.random((t, n)) < 0.5)
        return np.concatenate([m, np.zeros((pad, n), dtype=bool)])

    def tallow(t, n, pad):
        return np.concatenate([rng.random((t, n, q)) < 0.05, np.zeros((pad, n, q), dtype=bool)])

    def flags(n, p):
        return rng.random(n) < p

    arrays = [tmatch(te, ns, pads[0]), flags(ns, 0.7), tallow(te, nd, pads[0]),
              tmatch(ti, nd, pads[1]), flags(nd, 0.7), tallow(ti, ns, pads[1])]
    args = [torch.from_numpy(a).to(device) for a in arrays]
    args[2] = args[2].to(torch.bfloat16)
    args[5] = args[5].to(torch.bfloat16)
    vs = torch.from_numpy(flags(ns, 0.8)).to(device)
    vd = torch.from_numpy(flags(nd, 0.8)).to(device)
    return args, vs, vd


def _block_groups(nz, width):
    """[groups, chunks]: per chunk, how many 64-pod blocks of each run of
    `width` are kept — a K5 block's two src blocks (egress, width 2) or
    four dst blocks (ingress, width 4)."""
    import torch

    pad = (-nz.shape[0]) % width
    return torch.nn.functional.pad(nz, (0, 0, 0, pad)).view(-1, width, nz.shape[1]).sum(dim=1)


def mixed_blocks(nz_e, nz_i):
    """(warpgroup pairs, dst block groups) where the nz maps keep part of
    a K5 block: (src blocks 2b, 2b + 1; chunk) with one flag set and the
    other not (one consumer warpgroup contracts, the other skips), and
    (dst blocks 4b .. 4b + 3; chunk) with some but not all four set (K5
    loads and contracts the four whole)."""
    return tuple(int(((g > 0) & (g < w)).sum())
                 for g, w in ((_block_groups(nz_e, 2), 2), (_block_groups(nz_i, 4), 4)))


def phase_dense_kernels(device) -> None:
    """K4/K5/K6 against their plain versions on seeded operands."""
    import numpy as np
    import torch

    from cyclonus_tpu_torch.engine import dense_kernel as dk
    from cyclonus_tpu_torch.engine.packed_kernel import sum_partials

    rng = np.random.default_rng(20260730)
    shapes = [  # (q, te, ti, ns, nd, namespaces, pads): target depths 0 to ~3,000
        (1, 0, 0, 9, 9, 0, (0, 0)),
        (2, 5, 7, 130, 77, 0, (0, 0)),
        (3, 255, 383, 1000, 777, 0, (0, 0)),
        (1, 1023, 1024, 200, 200, 0, (0, 0)),
        (2, 1100, 40, 300, 513, 0, (0, 0)),
        (2, 3000, 2999, 700, 650, 0, (0, 0)),
        (2, 3000, 2400, 4096, 4096, 300, (0, 0)),
        (1, 40, 1500, 2100, 1900, 5, (0, 0)),
        # K5: the live depth a multiple of neither 32 nor 128 nor the
        # chunk, bucketing pads past it (only the plain version contracts
        # them), one direction's depth only the pseudo row, pod axes off
        # 128 and 256, Q from 1 to 3, mixed warpgroup pairs and pieces
        (3, 1500, 1301, 1000, 700, 40, (37, 5)),
        (1, 0, 2100, 650, 900, 30, (0, 20)),
        (2, 2200, 0, 1300, 333, 60, (3, 0)),
        (2, 1030, 1100, 4100, 2000, 500, (7, 0)),
    ]
    checked = {"dense_counts_1chunk": 0, "dense_counts_chunked": 0}
    mixed = [0, 0]
    for q, te, ti, ns, nd, n_ns, pads in shapes:
        args, vs, vd = random_dense(rng, q, te, ti, ns, nd, device, n_ns, pads)
        variants = [
            {"valid_src": vs, "valid_dst": vd},
            {"valid_src": vs, "valid_dst": vd, "bs": 64},
        ]
        if ns == nd:
            n = ns - 3
            variants.append({"valid_src": torch.arange(ns, device=device) < n,
                             "valid_dst": torch.arange(nd, device=device) < n})
        # has=False everywhere on one direction: the pseudo row alone; and
        # has=True everywhere with no match: that direction's nz map all zero
        alt = list(args)
        alt[1] = torch.zeros_like(args[1])
        cases = [(a, v) for a in (args, alt) for v in variants]
        if te + ti + 1 > dk.KT:
            empty = list(args)
            empty[0] = torch.zeros_like(args[0])
            empty[1] = torch.ones_like(args[1])
            cases.append((empty, variants[1]))
        for a, kw in cases:
            ops = dk.dense_operands(*a, kw["valid_src"], kw["valid_dst"], kw.get("bs"))
            kind = "dense_counts_1chunk" if dk.single_chunk(ops) else "dense_counts_chunked"
            before = dk.LAUNCHES[kind]
            got = dk.counts_from_ops(ops)
            torch.cuda.synchronize()
            if dk.LAUNCHES[kind] != before + 1:
                raise AssertionError(f"{kind} did not launch")
            want = dk.counts_from_ops(ops, plain=True)
            label = (f"{kind} q={q} te={te} ti={ti} ns={ns} nd={nd} namespaces={n_ns} "
                     f"pads={pads} live={ops['live_e']}/{ops['live_i']} {sorted(kw)}")
            check_kernel(got, want, label)
            if a is not args:
                # the same operands through the user's entry point
                got = dk.verdict_counts_rect(*a, **kw)
                check_kernel(got, want, label + " via verdict_counts_rect")
            if kind == "dense_counts_chunked":
                for i, m in enumerate(mixed_blocks(*dk._nz_maps(ops))):
                    mixed[i] += m
            checked[kind] += 1
    log(f"kernels: {json.dumps(checked)} dense kernel-vs-plain checks equal (tolerance: exact); "
        f"K5 (block, chunk) pairs kept in part: {mixed[0]} warpgroup pairs, {mixed[1]} dst "
        f"piece groups")
    if not all(mixed):
        raise AssertionError(f"K5's partly kept blocks not exercised: {mixed}")

    n_slab = 0
    slab_shapes = [  # (q, te, ti, n, bs, bd, w, namespaces): 8-wide tiles to the default
        (1, 30, 40, 100, 8, 8, 1, 30),
        (2, 60, 50, 250, 8, 16, 8, 50),
        (3, 200, 300, 1000, 64, 32, 32, 100),
        (2, 250, 300, 5000, 2048, 1024, 128, 100),
        (2, 20, 30, 5000, 2048, 1024, 32, 20),
        (2, 600, 900, 5000, 2048, 1024, 128, 40),
    ]
    for q, te, ti, n, bs, bd, w, n_ns in slab_shapes:
        args, _vs, _vd = random_dense(rng, q, te, ti, n, n, device, n_ns)
        n_pods = n - 5
        live = np.arange(n) < n_pods
        t0 = [dk.slab_windows(args[k].cpu().numpy() & live[None, :], tile, w)
              for k, tile in ((0, bs), (3, bd))]
        ops = dk.slab_operands(*args, t0[0][0], t0[1][0], n_pods, bs=bs, bd=bd, w=w)
        before = dk.LAUNCHES["dense_counts_slab"]
        got = dk.verdict_counts_slab_from_ops(ops)
        torch.cuda.synchronize()
        if dk.LAUNCHES["dense_counts_slab"] != before + 1:
            raise AssertionError("the slab kernel did not launch")
        check_kernel(got, dk.verdict_counts_slab_from_ops(ops, plain=True),
                     f"dense_counts_slab q={q} te={te} ti={ti} n={n} bs={bs} bd={bd} w={w}")
        n_slab += 1
        if t0[0][1] and t0[1][1]:
            # windows that hold every target: the slab counts equal K4/K5's
            dense = sum_partials(dk.verdict_counts(*args, n_pods=n_pods), q, n_pods)
            if sum_partials(got, q, n_pods) != dense:
                raise AssertionError(f"slab counts != dense counts at q={q} n={n} w={w}")
            n_slab += 1
    log(f"kernels: {n_slab} slab kernel checks equal (vs plain, and vs the dense kernels "
        f"where the windows hold; tolerance: exact)")


def phase_truth_tables(device) -> None:
    from cyclonus_tpu_torch.engine import PortCase, TorchPolicyEngine
    from cyclonus_tpu_torch.engine import dense_kernel as dk
    from cyclonus_tpu_torch.engine import packed_kernel as pk
    from cyclonus_tpu_torch.kube import examples
    from cyclonus_tpu_torch.matcher import build_network_policies
    from cyclonus_tpu_torch.oracle import oracle_grid
    from cyclonus_tpu_torch.tiers.fuzz import build_fuzz_case

    def check(engines, policy, pods, namespaces, cases, what, tiers=None):
        """Each engine (both dtype plans) against one oracle grid."""
        want = oracle_grid(policy, pods, namespaces, cases, tiers=tiers)
        sums = {k: int(v.sum()) for k, v in want.items()}
        for engine in engines:
            label = f"{what} pack={engine._pack}"
            grid = engine.evaluate_grid(cases)
            for k, v in want.items():
                got = getattr(grid, k)
                if got.shape != v.shape or not (got == v).all():
                    raise AssertionError(f"{label}: {k} grid differs from the oracle")
            counts = engine.evaluate_grid_counts(cases)
            if {k: counts[k] for k in sums} != sums:
                raise AssertionError(f"{label}: counts {counts} != oracle sums {sums}")
        return want["combined"].size * len(engines)

    pods, namespaces = examples.example_cluster()
    cases = [
        PortCase(80, "serve-80-tcp", "TCP"),
        PortCase(5000, "", "TCP"),
        PortCase(53, "", "UDP"),
    ]
    policy_sets = [[p] for p in examples.all_examples()] + [examples.all_examples()]
    cells = 0
    dk.reset_launches()
    for i, policies in enumerate(policy_sets):
        policy = build_network_policies(True, policies)
        engines = [TorchPolicyEngine(policy, pods, namespaces, device=device, pack=p)
                   for p in (True, False)]
        cells += check(engines, policy, pods, namespaces, cases, f"policy set {i}")
    if dk.LAUNCHES["dense_counts_1chunk"] != len(policy_sets):
        raise AssertionError(f"dense plan: {dk.LAUNCHES} for {len(policy_sets)} engines")
    log(f"truth tables: {len(policy_sets)} policy sets x both dtype plans, {cells} cells "
        f"equal to the oracle")

    cells = n_tiered = 0
    for seed in range(16):
        fc = build_fuzz_case(seed)
        policy = build_network_policies(fc.simplify, fc.netpols)
        for mode in ("0", "1"):
            pk.reset_launches()
            engines = [
                TorchPolicyEngine(policy, fc.pods, fc.namespaces, tiers=fc.tiers,
                                  class_compress=mode, device=device, pack=p)
                for p in (True, False)
            ]
            cells += check(
                engines, policy, fc.pods, fc.namespaces, fc.cases,
                f"fuzz seed {seed} class_compress={mode}", tiers=fc.tiers,
            )
            k3 = pk.LAUNCHES["packed_counts_tiered"] + pk.LAUNCHES["packed_rowsums_tiered"]
            if (fc.tiers is not None) != (k3 > 0):
                raise AssertionError(
                    f"fuzz seed {seed} class_compress={mode}: tiered counts kernel "
                    f"launches {pk.LAUNCHES} do not match tiers={fc.tiers is not None}"
                )
            n_tiered += fc.tiers is not None
    log(f"truth tables: 16 fuzz seeds x 2 class modes x both dtype plans ({n_tiered} "
        f"tiered settings), {cells} cells and all counts equal to the tiered oracle")


def bound(args, w_dst, out, ops=None, tier_work=(0, 0)):
    """(ms, bound_by, ops, bytes): the least time the card could take for one
    packed counts call on these inputs — the larger of bytes (each input
    read once, the output written once) over HBM bandwidth and 32-bit
    integer instructions over the integer pipe's peak — and the two
    counts.  Instructions: one LOP3 per packed word, cell and direction,
    EPILOGUE_CELL_OPS per cell, and the rest of the epilogue per 32 cells
    (the weighted one per cell as well); tiered, TIER_ROW_OPS per live
    row and 32 cells it matches and LATTICE_WORD_OPS per 32 matched cells
    and direction, as 32-bit mask logic (a cell that no live row matches
    needs no tier work).  `ops` is the tiered operand dict (packed tier
    words and keys) and `tier_work` this run's (matched (row, cell)
    pairs, matched cells) from `tier_work`."""
    tmatch_e_pk, _has_e, tallow_e_pk, tmatch_i_pk, _has_i, _tallow_i_pk = args
    we, ns = tmatch_e_pk.shape
    wi, nd = tmatch_i_pk.shape
    q = tallow_e_pk.shape[2]
    nbytes = sum(a.numel() * a.element_size() for a in args)
    nbytes += out.numel() * out.element_size()
    cells = q * ns * nd
    if w_dst is None:
        per_cell, per_word = EPILOGUE_CELL_OPS, EPILOGUE_WORD_OPS
    else:
        nbytes += w_dst.numel() * w_dst.element_size()
        per_cell, per_word = EPILOGUE_CELL_OPS + WEIGHTED_CELL_OPS, WEIGHTED_WORD_OPS
    n_ops = cells * (we + wi + per_cell) + per_word * cells / 32
    if ops is not None:
        t = ops["tier"]
        nbytes += sum(a.numel() * a.element_size() for a in t.values())
        row_cells, tier_cells = tier_work
        n_ops += (TIER_ROW_OPS * row_cells + LATTICE_WORD_OPS * tier_cells) / 32
    by = "operations" if n_ops / PEAK_INT_OPS >= nbytes / PEAK_BYTES else "bytes"
    return max(n_ops / PEAK_INT_OPS, nbytes / PEAK_BYTES) * 1e3, by, n_ops, nbytes


def _matched_cells(subj, peer):
    """Cells (subject pod, peer pod, port case) that at least one of the
    rows matches, subj [G, N] and peer [G, M, Q] bool, counted by grouping
    pods by the set of rows they hold."""
    import torch

    if subj.shape[0] == 0:
        return 0
    cells = 0
    us, cs = torch.unique(subj.T.to(torch.uint8), dim=0, return_counts=True)
    for qi in range(peer.shape[2]):
        up, cp = torch.unique(peer[:, :, qi].T.to(torch.uint8), dim=0, return_counts=True)
        match = (us.double() @ up.double().T) > 0
        cells += int((cs.double()[:, None] * cp.double()[None, :])[match].sum())
    return cells


def tier_work(tier, valid_src, valid_dst):
    """This run's tier work that the function needs, both directions:
    (matched (row, cell) pairs, matched cells) — per live row the cells
    its subject and peer hold, summed over the rows, and the cells that
    some live row matches — over valid pods and the rows that can change
    a verdict (a pad row, both keys TIER_KEY_NONE, changes nothing)."""
    import torch

    from cyclonus_tpu_torch.engine.encoding import TIER_KEY_NONE

    row_cells = cells = 0
    sides = ((tier["egress"], valid_src, valid_dst), (tier["ingress"], valid_dst, valid_src))
    for t, v_subj, v_peer in sides:
        live = (t["anp_key"] != TIER_KEY_NONE) | (t["banp_key"] != TIER_KEY_NONE)
        subj = (t["subj"] & v_subj[None, :])[live]  # [G, N]
        peer = (t["peerq"] & v_peer[None, :, None])[live]  # [G, M, Q]
        row_cells += int((subj.sum(dim=1, dtype=torch.float64)[:, None]
                          * peer.sum(dim=1, dtype=torch.float64)).sum())
        cells += _matched_cells(subj, peer)
    return row_cells, cells


def kernel_record(name, replaces, pre, n_pods, w_dst, launches):
    """Hold the kernel against its plain version on the main path's
    inputs (tiered when the precompute carries tiers) and time both."""
    import torch

    from cyclonus_tpu_torch.engine import packed_kernel as pk
    from cyclonus_tpu_torch.engine.tiled import packed_tier

    e, ig = pre["egress"], pre["ingress"]
    args = [
        e["tmatch_pk"], e["has_target"], e["tallow_pk"],
        ig["tmatch_pk"], ig["has_target"], ig["tallow_pk"],
    ]
    tier = packed_tier(pre)
    kw = {"n_pods": n_pods, "tier": tier, "w_dst": w_dst}
    got = pk.verdict_counts_packed(*args, **kw)
    torch.cuda.synchronize()
    want = pk.verdict_counts_packed_plain(*args, **kw)
    check_kernel(got, want, f"{name}, the main-path shapes")
    max_abs_err = float((got.double() - want.double()).abs().max())
    valid_src, valid_dst, bs, bd = pk._resolve(
        args[0], args[3], n_pods, None, None, None, None
    )
    ops = pk._packed_operands(*args, valid_src, valid_dst, tier, w_dst, bs, bd)
    ms = time_ms(lambda: pk._counts_cuda(ops, bs), reps=5, warm=1)
    plain_ms = time_ms(lambda: pk._counts_plain(ops, bs), reps=1, warm=0)
    work = (0, 0) if tier is None else tier_work(tier, valid_src, valid_dst)
    b_ms, b_by, b_ops, b_bytes = bound(args, w_dst, got, None if tier is None else ops, work)
    rec = {
        "name": name,
        "route": "cuda",
        "source": "cyclonus_tpu_torch/csrc/packed_counts.cu",
        "replaces": replaces,
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": None,
        **pk.kernel_attrs()[name],
    }
    shape = {
        "q": int(args[2].shape[2]), "we": int(args[0].shape[0]), "wi": int(args[3].shape[0]),
        "ns": int(args[0].shape[1]), "nd": int(args[3].shape[1]),
    }
    if tier is not None:
        shape.update(ge=int(tier["egress"]["subj"].shape[0]),
                     gi=int(tier["ingress"]["subj"].shape[0]), tier_row_cells=work[0],
                     tier_cells=work[1])
    log(
        f"{name}: {ms:.3f} ms (bound {b_ms:.3f} ms: {b_ops:.4e} ops, {b_bytes:.4e} bytes; "
        f"plain {plain_ms:.1f} ms) at {shape}, equal to plain (tolerance: exact)"
    )
    return rec


def drive_main_path(policy, pods, namespaces, cases, device, tiers=None):
    """The main path, once: both counts routes through the entry points a
    user calls, with the launch counts zeroed just before and read just
    after.  Returns (class engine, dense engine, counts, launches, first
    call seconds of each route)."""
    from cyclonus_tpu_torch.engine import TorchPolicyEngine
    from cyclonus_tpu_torch.engine import packed_kernel as pk

    label = "tiered main path" if tiers else "main path"
    suffix = "_tiered" if tiers else ""
    pk.reset_launches()
    eng_a = TorchPolicyEngine(policy, pods, namespaces, device=device, tiers=tiers)
    t0 = time.perf_counter()
    counts_a = eng_a.evaluate_grid_counts(cases)
    first_a = time.perf_counter() - t0
    eng_b = TorchPolicyEngine(policy, pods, namespaces, device=device, class_compress="0",
                              tiers=tiers)
    t0 = time.perf_counter()
    counts_b = eng_b.evaluate_grid_counts(cases)
    first_b = time.perf_counter() - t0
    launches = dict(pk.LAUNCHES)
    log(f"{label} launches: {launches}")

    if eng_a.pod_classes() is None or not eng_a._class_counts_eligible(len(cases)):
        raise AssertionError(f"{label}: the default engine did not take the class route")
    if eng_b.pod_classes() is not None:
        raise AssertionError(f"{label}: class_compress=0 engine holds class state")
    if counts_a != counts_b:
        raise AssertionError(f"{label}: class route {counts_a} != dense route {counts_b}")
    n = len(pods)
    if counts_a["cells"] != len(cases) * n * n or not 0 < counts_a["combined"] <= counts_a["cells"]:
        raise AssertionError(f"{label}: implausible counts {counts_a}")
    for name in ("packed_counts", "packed_rowsums"):
        if launches[name + suffix] < 1:
            raise AssertionError(f"{label}: kernel {name + suffix} never launched: {launches}")
    log(f"{label} counts (both routes): {json.dumps(counts_a)}")
    return eng_a, eng_b, counts_a, launches, first_a, first_b


def route_numbers(eng_a, eng_b, cases, first_a, first_b, label):
    """Warm end-to-end times, device busy shares and precompute times of
    both routes; returns (routes dict, class precompute inputs, dense
    precompute)."""
    import torch

    from cyclonus_tpu_torch.engine.tiled import _precompute

    e2e_a = time_ms(lambda: eng_a.evaluate_grid_counts(cases), reps=3, warm=0) / 1e3
    e2e_b = time_ms(lambda: eng_b.evaluate_grid_counts(cases), reps=3, warm=0) / 1e3
    busy = {}
    for route, eng in (("class", eng_a), ("dense", eng_b)):
        share, top = device_time_profile(lambda e=eng: e.evaluate_grid_counts(cases))
        busy[route] = share
        if share is None:
            log(f"{label}: device busy share, {route} route: not measured (no device time traced)")
        else:
            log(f"{label}: device busy share, {route} route: {share:.4f}; "
                f"top kernels ms/call: {top}")

    tens_b = eng_b._dense_counts_tensors(cases)
    pre_b = _precompute(tens_b, True)
    pre_ms_b = time_ms(lambda: _precompute(tens_b, True), reps=3, warm=0)
    tens_a = eng_a._with_cases(eng_a._class_dev(), cases)
    pre_a = _precompute(tens_a, True)
    pre_ms_a = time_ms(lambda: _precompute(tens_a, True), reps=3, warm=0)
    torch.cuda.synchronize()
    cells = len(cases) * eng_a.n_pods ** 2
    routes = {
        "class": {"encode_s": eng_a.encode_s, "first_call_s": first_a, "warm_s": e2e_a,
                  "precompute_ms": pre_ms_a, "pod_axis": int(tens_a["pod_ns_id"].shape[0])},
        "dense": {"encode_s": eng_b.encode_s, "first_call_s": first_b, "warm_s": e2e_b,
                  "precompute_ms": pre_ms_b, "pod_axis": int(tens_b["pod_ns_id"].shape[0])},
    }
    for route, r in routes.items():
        r["cells_per_s"] = cells / r["warm_s"]
        r["device_busy_share"] = busy[route]
    return routes, (tens_a, pre_a), pre_b


def sub_size_check(policy_count, cases, device, tiers=None) -> None:
    """The plain version through the engine at a sub-size, dense route."""
    from cyclonus_tpu_torch.engine import TorchPolicyEngine
    from cyclonus_tpu_torch.matcher import build_network_policies
    from cyclonus_tpu_torch.synthetic import build_synthetic

    sp, sn, spol = build_synthetic(N_SUB, policy_count, random.Random(SEED))
    eng = TorchPolicyEngine(build_network_policies(True, spol), sp, sn, device=device,
                            class_compress="0", tiers=tiers)
    got = eng.evaluate_grid_counts(cases)
    want = eng._counts_dense(cases, plain=True)
    label = "tiered " if tiers else ""
    if got != want:
        raise AssertionError(f"{label}sub-size {N_SUB}: kernel path {got} != plain {want}")
    log(f"{label}sub-size {N_SUB} pods dense route: kernel path == plain version "
        f"({json.dumps(got)})")


def dense_bound(inputs, out, macs):
    """(ms, bound_by, ops, bytes) of one dense-plan kernel call: the larger
    of its int8 multiply-adds (two operations each) over the int8
    tensor-core peak and the bytes of its inputs (each read once) and
    output over HBM bandwidth."""
    nbytes = sum(a.numel() * a.element_size() for a in inputs) + out.numel() * out.element_size()
    n_ops = 2 * macs
    by = "operations" if n_ops / PEAK_INT8_OPS >= nbytes / PEAK_BYTES else "bytes"
    return max(n_ops / PEAK_INT8_OPS, nbytes / PEAK_BYTES) * 1e3, by, n_ops, nbytes


def live_target_rows(a, kt):
    """[n_chunks] int64: per kt-row chunk of a direction's augmented match
    operand a [N', T'] (the wrapper's a_e or a_i), the target rows that
    hold data — a nonzero for some pod: the targets that match a valid
    pod, and the pseudo row where some valid pod has no target; not the
    inert targets that bucket the axis, nor the zero rows that pad it to
    a chunk."""
    return a.ne(0).any(dim=0).view(-1, kt).sum(dim=1).long().cpu()


def dense_record(name, eng, cases, launches):
    """K4 (single chunk), K5 (chunked) or K6 (slab, name dense_counts_slab)
    against its plain version on the inputs of `eng`'s dense route, timed."""
    import torch

    from cyclonus_tpu_torch.engine import dense_kernel as dk
    from cyclonus_tpu_torch.engine.tiled import _precompute

    pre = _precompute(eng._dense_counts_tensors(cases), False)
    e, ig = pre["egress"], pre["ingress"]
    args = [e["tmatch"], e["has_target"], e["tallow_bf"],
            ig["tmatch"], ig["has_target"], ig["tallow_bf"]]
    n, q = eng.n_pods, len(cases)
    ns, nd = args[0].shape[1], args[3].shape[1]
    # the bounds count multiply-adds over live rows only: the first n pods
    # of each pod axis (the rest are bucketing pads, zero in every operand)
    # and the target rows that hold data, never the zero rows that pad a
    # depth to a chunk or a window to its 32-row int8 tile
    if name == "dense_counts_slab":
        plan = eng._slab_plan()
        ops = dk.slab_operands(*args, plan["egress"], plan["ingress"], n, w=plan["w"])
        w_aug = ops["a_e"].shape[2]
        # per direction the w window rows plus the pseudo/validity row
        macs = q * n * n * 2 * (plan["w"] + 1)
        run = lambda: dk.verdict_counts_slab_from_ops(ops)  # noqa: E731
        run_plain = lambda: dk.verdict_counts_slab_from_ops(ops, plain=True)  # noqa: E731
        shape = {"q": q, "n": ns, "w": plan["w"], "w_aug": w_aug,
                 "tiles": [ops["a_e"].shape[0], ops["a_i"].shape[0]]}
        replaces = "cyclonus_tpu/engine/pallas_kernel.py:1414"
    else:
        valid = torch.arange(ns, device=args[0].device) < n
        ops = dk.dense_operands(*args, valid, valid)
        chunked = name == "dense_counts_chunked"
        if dk.single_chunk(ops) == chunked:
            raise AssertionError(f"{name}: the main-path operands take the other kernel")
        # per chunk of the augmented depth, the rows that hold data
        live_rows = [live_target_rows(ops[a], ops[kt]) for a, kt in
                     (("a_e", "kt_e"), ("a_i", "kt_i"))]
        te, ti = (int(r.sum()) for r in live_rows)
        nz = dk._nz_maps(ops) if chunked else None
        if chunked:
            # the blocks the nz maps keep: each kept (64-pod src block,
            # egress chunk) against every live dst pod, each kept (64-pod
            # dst block, ingress chunk) against every live src pod; a
            # block counts its live pods, a chunk its live rows
            def kept_macs(m, rows):
                pods = (n - dk.CUDA_TILE * torch.arange(m.shape[0])).clamp(0, dk.CUDA_TILE)
                return int((m.cpu().long() * pods[:, None] * rows[None, :]).sum())

            macs = q * n * sum(kept_macs(m, r) for m, r in zip(nz, live_rows))
            kept = [round(float(m.float().mean()), 4) for m in nz]
        else:
            macs = q * n * n * (te + ti)
            kept = None
        run = lambda: dk._counts_cuda(ops, nz)  # noqa: E731
        run_plain = lambda: dk._counts_plain(ops)  # noqa: E731
        shape = {"q": q, "ns": ns, "nd": nd, "te": te, "ti": ti,
                 "kt": [ops["kt_e"], ops["kt_i"]], "live_depth": [ops["live_e"], ops["live_i"]],
                 "nz_kept": kept}
        if chunked:
            shape["nz_partly_kept"] = mixed_blocks(*nz)
        replaces = ("cyclonus_tpu/engine/pallas_kernel.py:601" if chunked
                    else "cyclonus_tpu/engine/pallas_kernel.py:523")
    before = dict(dk.LAUNCHES)
    got = run()
    torch.cuda.synchronize()
    if dk.LAUNCHES[name] != before[name] + 1:
        raise AssertionError(f"{name}: the main-path operands did not launch it")
    want = run_plain()
    check_kernel(got, want, f"{name}, the main-path shapes")
    max_abs_err = float((got.double() - want.double()).abs().max())
    ms = time_ms(run, reps=5, warm=1)
    plain_ms = time_ms(run_plain, reps=1, warm=0)
    b_ms, b_by, b_ops, b_bytes = dense_bound(args, got, macs)
    log(f"{name}: {ms:.3f} ms (bound {b_ms:.3f} ms: {b_ops:.4e} int8 ops, {b_bytes:.4e} bytes; "
        f"plain {plain_ms:.1f} ms) at {shape}, equal to plain (tolerance: exact)")
    return {
        "name": name, "route": "cuda", "source": "cyclonus_tpu_torch/csrc/dense_counts.cu",
        "replaces": replaces, "launches": launches, "max_abs_err": max_abs_err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        **dk.kernel_attrs()[name],
    }


#: the dense dtype plan's legs (pack=False): (name, tiered, engine options,
#: the kernel the leg's first call must launch, or None for the tile loop)
DENSE_LEGS = [
    ("dense", False, {"class_compress": "0"}, "dense_counts_1chunk"),
    ("chunked", False, {"class_compress": "0", "compact": False}, "dense_counts_chunked"),
    ("slab", False, {"class_compress": "0", "slab": "1"}, "dense_counts_slab"),
    ("class", False, {}, None),
    ("dense", True, {"class_compress": "0"}, None),
    ("class", True, {}, None),
]


def phase_dense_plan(device, policy, pods, namespaces, cases, want_plain, want_tiered):
    """The dense dtype plan's main path (pack=False) on the headline
    cluster, once, with every launch count zeroed just before and read
    just after: the dense route through K4, K5 (compaction off) and K6
    (slab forced), the class route through the tile loop's row sums, and
    the tiered dense and class routes through the tile loop.  Each leg's
    counts must equal the packed plan's (want_plain / want_tiered); each
    dense kernel must have launched, and no packed kernel.  Then per leg:
    encode, first call, warm end to end, device busy share; per kernel:
    the record against its plain version."""
    import torch

    from cyclonus_tpu_torch.engine import TorchPolicyEngine
    from cyclonus_tpu_torch.engine import dense_kernel as dk
    from cyclonus_tpu_torch.engine import packed_kernel as pk
    from cyclonus_tpu_torch.synthetic import bench_tiers

    tiers = bench_tiers()
    engines = {}
    pk.reset_launches()
    dk.reset_launches()
    for name, tiered, kw, kernel in DENSE_LEGS:
        key = f"{'tiered ' if tiered else ''}{name}"
        before = dict(dk.LAUNCHES)
        eng = TorchPolicyEngine(policy, pods, namespaces, device=device, pack=False,
                                tiers=tiers if tiered else None, **kw)
        t0 = time.perf_counter()
        counts = eng.evaluate_grid_counts(cases)
        first = time.perf_counter() - t0
        want = want_tiered if tiered else want_plain
        if counts != want:
            raise AssertionError(f"dense plan, {key}: counts {counts} != packed plan {want}")
        ran = {k: dk.LAUNCHES[k] - before[k] for k in dk.LAUNCHES}
        if ran != {k: int(k == kernel) for k in dk.LAUNCHES}:
            raise AssertionError(f"dense plan, {key}: launches {ran}, want {kernel}")
        if (eng.pod_classes() is not None) != (name == "class"):
            raise AssertionError(f"dense plan, {key}: class state does not match the leg")
        engines[key] = (eng, kernel, first)
    launches = {**dict(dk.LAUNCHES), **dict(pk.LAUNCHES)}
    log(f"dense plan launches: {launches}")
    if any(pk.LAUNCHES.values()):
        raise AssertionError(f"dense plan: a packed kernel launched: {pk.LAUNCHES}")
    log(f"dense plan counts: every leg equal to the packed plan (untiered "
        f"{json.dumps(want_plain)}, tiered {json.dumps(want_tiered)})")

    cells = len(cases) * len(pods) ** 2
    legs, records = {}, []
    for key, (eng, kernel, first) in engines.items():
        reps = 1 if key == "tiered dense" else 3  # the tile loop over 98 dense tiles
        warm_s = time_ms(lambda e=eng: e.evaluate_grid_counts(cases), reps=reps, warm=0) / 1e3
        share, top = device_time_profile(lambda e=eng: e.evaluate_grid_counts(cases), reps=reps)
        legs[key] = {"kernel": kernel or "tile loop", "encode_s": eng.encode_s,
                     "first_call_s": first, "warm_s": warm_s, "cells_per_s": cells / warm_s,
                     "device_busy_share": share}
        log(f"dense plan, {key}: warm {warm_s * 1e3:.2f} ms, device busy "
            f"{'not measured' if share is None else f'{share:.4f}'}; top kernels ms/call: {top}")
        if kernel is not None:
            if kernel == "dense_counts_slab":
                legs[key]["slab_w"] = eng._slab_plan()["w"]
            records.append(dense_record(kernel, eng, cases, launches[kernel]))
        del eng
        engines[key] = None
        torch.cuda.empty_cache()
    return records, {"legs": legs, "launches": launches}


def phase_main_path(device):
    import torch

    from cyclonus_tpu_torch.engine import PortCase
    from cyclonus_tpu_torch.engine.tiled import class_rowsums_plan
    from cyclonus_tpu_torch.matcher import build_network_policies
    from cyclonus_tpu_torch.synthetic import bench_tiers, build_synthetic

    n_pods, n_policies = N_PODS, N_POLICIES
    t0 = time.perf_counter()
    pods, namespaces, policies = build_synthetic(n_pods, n_policies, random.Random(SEED))
    policy = build_network_policies(True, policies)
    log(f"main path: synthetic {n_pods} pods x {n_policies} policies built in "
        f"{time.perf_counter() - t0:.2f} s")
    cases = [PortCase(80, "serve-80-tcp", "TCP"), PortCase(81, "serve-81-udp", "UDP")]
    ref = "cyclonus_tpu/engine/pallas_kernel.py:689"
    ref_tiered = "cyclonus_tpu/engine/pallas_kernel.py:1085"
    records = []
    summary = {"pods": n_pods, "policies": n_policies, "seed": SEED}
    sub_policies = n_policies * N_SUB // n_pods
    for tiers in (None, bench_tiers()):
        key = "tiered" if tiers else "untiered"
        suffix = "_tiered" if tiers else ""
        eng_a, eng_b, counts, launches, first_a, first_b = drive_main_path(
            policy, pods, namespaces, cases, device, tiers=tiers
        )
        pc = eng_a.pod_classes()
        log(f"{key}: classes: {pc.n_classes} for {n_pods} pods, class axis "
            f"{int(eng_a._class_state['ctensors']['pod_ns_id'].shape[0])}"
            + (f"; tiers {json.dumps(eng_a.tier_stats())}" if tiers else ""))
        routes, (tens_a, pre_a), pre_b = route_numbers(
            eng_a, eng_b, cases, first_a, first_b, key
        )
        # each kernel against its plain version on the main path's own inputs
        w = torch.from_numpy(class_rowsums_plan(tens_a, pc.n_classes, pc.class_size)[0]).to(device)
        records += [
            kernel_record("packed_counts" + suffix, ref_tiered if tiers else ref, pre_b,
                          n_pods, None, launches["packed_counts" + suffix]),
            kernel_record("packed_rowsums" + suffix, ref_tiered if tiers else ref, pre_a,
                          int(tens_a["pod_ns_id"].shape[0]), w,
                          launches["packed_rowsums" + suffix]),
        ]
        del eng_a, eng_b, pre_a, pre_b, tens_a
        torch.cuda.empty_cache()
        sub_size_check(sub_policies, cases, device, tiers=tiers)
        summary[key] = {"counts": counts, "classes": pc.n_classes, "routes": routes}

    # the lattice against the tier-free verdicts of the same cluster:
    # every egress tier row is an inert pad, and on ingress the lattice
    # only adds Deny (tier0 <- app1 on TCP 80-81), Pass -> BANP Deny
    # (app2) and an SCTP Allow that no port case hits
    plain, tiered = summary["untiered"]["counts"], summary["tiered"]["counts"]
    if tiered["egress"] != plain["egress"]:
        raise AssertionError(f"tiered egress {tiered} != untiered {plain}")
    if not tiered["ingress"] < plain["ingress"] or tiered["combined"] > plain["combined"]:
        raise AssertionError(f"tiered ingress/combined {tiered} not below untiered {plain}")
    log(f"tiers vs untiered: egress equal, ingress {plain['ingress']} -> {tiered['ingress']}, "
        f"combined {plain['combined']} -> {tiered['combined']}")

    dense_records, summary["dense_plan"] = phase_dense_plan(
        device, policy, pods, namespaces, cases, plain, tiered
    )
    records += dense_records

    # the main path's end-to-end numbers in one line, next to the kernels
    # line at the end of the output
    log(json.dumps({"main_path": summary}))
    return records


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    device = torch.device("cuda")

    from cyclonus_tpu_torch.engine import build

    log(card_info())
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(device)}")
    t0 = time.perf_counter()
    secs = build.build(verbose=True)
    log(f"build: {json.dumps(secs)} (wall {time.perf_counter() - t0:.1f} s)")
    phase_kernels(device)
    phase_dense_kernels(device)
    phase_truth_tables(device)
    records = phase_main_path(device)
    log(card_info())
    log(json.dumps({"kernels": records}))
    log(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
