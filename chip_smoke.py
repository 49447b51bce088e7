#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (cyclonus_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each raising on failure:
  1. card     — name and power limit from nvidia-smi, torch and CUDA
                versions;
  2. build    — compile every CUDA kernel of the package (nvcc, sm_90a);
  3. kernels  — each kernel against its plain PyTorch version on the card,
                on seeded operands: ragged axes, Q in {1, 2, 3}, word
                depths from 1 to 420 (one to 53 single-bit k256 steps;
                among them 7, 8, 9, 16 and 17 words), pod axes off 128
                and 256, more items than the persistent grid holds (each
                block walks several bs segments), invalid rows and
                columns, has=False rows, zero weights; the tiered variants
                (K3) also with 1 to 1,500 tier rows per direction, pad
                rows, whole words of pad rows and random ANP/BANP/Pass
                actions, with keys in the engine's order and in random
                order; the dense kernels (K4,
                K5) at target depths 0 to 3,000 (one to three chunks),
                with non-prefix masks, src tiles (bs) of 64, 512 and the
                default 1,024, an all-has=False direction, a
                direction whose nz map is all zero, bucketing pad rows
                past the live depth (a multiple of neither 32 nor 128 nor
                the chunk, or only the pseudo row; K4 too), pod axes off
                128 and 256, and block-diagonal operands for K5's skip
                (blocks kept for one of a block's two warpgroups or some
                of its four dst pieces), and the slab kernel (K6) at
                windows of 1 to 128 rows (w_aug 32 to 160 bytes), tiles
                from 8 wide to the default, tiles that are not multiples
                of the kernel's 128 x 256 item or span several items, and
                more items than the persistent grid holds, so each block
                walks several src-tile segments.  Exact equality;
  4. truth tables — TorchPolicyEngine.evaluate_grid on the card against
                the scalar oracle, on both dtype plans (packed and
                pack=False), for every policy of all_examples(), and for
                seeds 0-15 of the tiered scenario generator on both class
                modes against the tiered oracle (grids and counts; K3 must
                have launched on the packed plan, K4 on every dense-plan
                example engine);
  5. probe    — the probe layer on the card, which runs no CUDA kernel of
                its own (evaluate_grid is plain torch): (a) the `probe`
                CLI (`--mock --perfect-cni`, the simple-example policies,
                x, y, z x a, b, c, ports 80 and 81, TCP, UDP, SCTP) with
                zero differing cells, its report equal to the oracle
                engine's; (b) the full conformance run (`generate --mock
                --perfect-cni --exclude none`): 216 journaled cases, all
                passed, every simulated probe on the cuda engine on the
                card; (c) an all-available probe of 10 namespaces x 30
                pods (540,000 jobs) under fixed policies, whose table
                must equal the CPU engine's cell for cell and, on a seeded
                sample of 2,000 jobs, the oracle's.  Prints a
                {"probe": ...} line: per run the seconds in total and for
                the job fan-out, engine build, grid, scatter and table,
                the cases run and passed and the cells compared;
  6. cidr and analyze — each CIDR leg reading the kernel launch counts
                just before its engines and just after its counts calls:
                (a) bench.py's cidr leg at its defaults (1,024 pods, 512
                distinct CIDRs, an IP pool of 64, random.Random(424242),
                64 blocks a policy) with the TSS stage forced, (b) the acceptance shape of the reference's
                stage, 100,000 distinct CIDRs (1,563 policies) over 4,096
                pods and a pool of 4,096 IPs, on the default engine, which
                must engage the stage with its LPM on the card.  On each:
                the device LPM equal to its numpy twin, the class route's
                counts (K2) equal to the pre-TSS bit path's and the
                class_compress="0" engine's (K1), 256 evaluate_pairs cells
                of the TSS and the dense engine against the oracle (run in
                one spawned process a CPU core), and at
                (b) K1 and K2 against their plain versions at the leg's
                operands.  Then every `analyze` mode of the port on the
                simple-example policies (diff against getting-started,
                probe with --engine cuda), stdout on the card equal to
                --device cpu byte for byte; the audit of the synthetic
                cluster at 4,096 pods x 41 policies (no claim refuted;
                firing components on the card, the int32 products and the
                oracle checks on the host, each timed) and a self-diff with
                one policy removed, whose cells must lie on that policy's
                target.  Prints one {"cidr": ...} line a leg and one
                {"analyze": ...} line;
  7. serve    — the verdict service (cyclonus_tpu_torch/serve) on the
                card, with the kernel launch counts zeroed before it and
                read after it: (a) bench.py's serve leg at its defaults
                (1,024 pods, 128 policies, random.Random(123), 32
                single-pod delta steps, every fifth a remove-then-add,
                the others label changes, 8 queries a step, half TCP 80
                and half named UDP 81), every apply incremental, no tensor
                set uploaded by a patch (engine.api.TRANSFERS), then
                verify_parity (grids against a fresh engine, 32 oracle
                cells); the same again over the benchmark's ANP/BANP
                tiers with one ANP delta more; (b) the headline cluster
                (100,000 pods x 10,000 policies, seed 20260729): three
                counts calls (fused, split, steady), the same delta
                stream plus a namespace-label delta and a policy update
                and create, a 4,096-query batch (throughput, device busy
                share), then against a fresh engine of the post-delta
                state: 4,096 pairs on both port cases, 256 of them
                against the oracle, and the dense counts, whose first call
                after the patch must run fused and launch K1 once.
                Prints one {"serve": ...} line per size;
  8. main path — the benchmark's synthetic cluster (100,000 pods x 10,000
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
                Then the live-target pass before K1/K3
                (packed_kernel.live_targets) on the dense route's
                operands at compact=False, the verdict service's encoding
                (the benchmark's np-100k: 104 / 184 words), at the main
                path's two cases and at the six all-ports cases, its
                launch count zeroed just before: the live words of
                live_or_kernel and every operand of live_gather_kernel
                equal bit for bit to the plain versions (_or_rows,
                gather_live_plain) on the same inputs, both directions
                compacted, K1 over the compacted operands equal to K1
                over the full ones; its record on the kernels line holds
                both kernels' time (median of 5 CUDA-event runs), the
                plain versions' and the bytes bound, at Q=2 and Q=6.
                Then the dense dtype plan (pack=False) on the same cluster:
                the dense route through K4, with compaction off through
                K5, with the slab forced through K6, the class route and
                the tiered routes through the tile loop; every leg's
                counts equal the packed plan's, each dense kernel
                launched and no packed one; and the slab "auto" mode,
                whose autotune must time K6 against K4 once and whose
                winner a second engine must adopt from the persisted
                cache with no search.  Each kernel leg then runs as
                bench.py runs it: after the first (fused) call, a second
                (split: the operands pinned on the card) and 5 more (the
                steady state: each launches only its kernel, runs no
                precompute and adds one hit to the engine's counters;
                the K5 leg, past the reference's 2 GiB gate, must stay
                fused), then counts_pipelined_eval_s (10 launches, one
                readback), then a fresh engine under
                CYCLONUS_PRE_CACHE=0; every count equal to the first
                call's.  Times: encode, first call, second call, steady
                state (min of 5, host clock, as bench.py), pipelined,
                PRE_CACHE=0, precompute, kernel (median of 5 CUDA-event
                runs), plain version, the kernel's bound, cells/s; per
                kernel also its registers, shared memory and spill
                bytes;
  9. mesh     — the pod-axis mesh (engine/sharded.py) on logical shards
                of the one card: (a) bench.py's mesh leg (2,048 pods x 200
                policies, random.Random(77), block 512) on 1, 2, 4 and 8
                shards: ring counts, the pipelined twin and the sharded
                counts (kernel and tile loop) equal to
                evaluate_grid_counts; at 8 shards the ring grid, the
                all-gather grid and evaluate_grid bit-identical, the class
                engine's sharded grid equal to its evaluate_grid, peer
                bytes ring < allgather; the 2-D ring on (2, 4); the tiered
                twin's ring and tile-loop counts equal; (b) the headline
                cluster through the sharded counts on 1 and 4 shards on
                both dtype plans, the launch counts zeroed just before
                and read just after: K1 and K4 once a shard on the shard's
                rows against the whole target axis, every result equal
                to evaluate_grid_counts, then one ring counts call on 4
                shards, and shard 0's K1 and K4 against their plain
                versions; (c) `fuzz --seeds 8 --conformance --cidr-seeds 4
                --json` (its mesh leg on the default mesh, 8 logical
                shards of the card) must exit 0, and `probe --engine
                cuda-sharded` must print what `--engine cuda` prints.
                Prints one {"mesh": ...} line a leg.  Logical shards share
                the card: no scaling or overlap figure comes from them;
 10. loopback — run right after `probe`, with the kernel launch counts
                zeroed before it and read after it: the loopback cluster
                (pods as processes on 127/8 answering real TCP and UDP
                probes, kube/loopback.py) through the port's CLI, every
                simulated table on the card: (a) `probe --loopback` on
                the getting-started policies, TCP 80, zero differing
                cells; (b) `generate --loopback --include conflict
                --retries 0`, per-job exec and `--batch-jobs` (one worker
                subprocess per source pod and step), 16/16 each, the
                descriptions those of the reference's committed journal
                in its order; (c) `analyze -A --mode probe` through the
                recording kubectl of tests/fakekubectl.py on PATH, its
                tables equal to the oracle engine's; (d) for (a) and four
                conflict cases, a TorchPolicyEngine on the card over the
                step's pods, namespaces and policy counts the step's port
                cases on the packed plan (K1) and under CYCLONUS_PACK=0
                (K4): each combined count equal to the allowed cells of
                the real-socket table, each kernel launched.  Only a
                refused bind of port 80 on 127/8 skips (a)-(c) (one
                {"loopback": {"skipped": ...}} line; (d) then counts the
                mock cluster's tables).  Prints one {"loopback": ...} line.
 11. telemetry — run after `mesh`, the kernel launch counts zeroed before
                it and read after it: (a) `generate --loopback
                --batch-jobs --include conflict --max-cases 2 --metrics-port
                0 --trace-out F --phase-stats` through the port's CLI on the
                card: F must hold the driver's events and at least one
                worker subprocess's under one trace id, `trace --input F`
                must summarise it, and an in-process scrape of /metrics
                must show cyclonus_tpu_probe_latency_seconds samples; (b)
                on the headline cluster, 5 steady counts calls on each
                route (packed: K1; class: K2; pack=False: K6 or K4 by the
                autotune): the route's dispatch counter moves by 5, the
                flight recorder holds 5 `ok` entries with the counts'
                cells, the kernel traces rise on the first shape and stay
                flat, the route's launches move by 5; then 15 rounds of
                a call with telemetry off and one with it on, the median
                of the rounds' on/off ratios within 1.05 (the minima
                reported beside it); (c) a VerdictService
                at the serve phase's 1,024-pod cluster behind register_http
                on a metrics server at port 0: /readyz 503 before the
                prewarm and 200 after, /state equal to state() outside the
                volatile keys, 64 /query GETs with the verdicts of
                svc.query, the query counter moved by 64; (d)
                /profile?seconds=2 while a thread makes K1 steady calls:
                200, its Chrome trace names packed_counts_kernel among the
                device events, and a second /profile during the first gets
                409.  Prints one {"telemetry": ...} line.
 12. chaos    — run after `telemetry`, the kernel launch counts zeroed
                before it and read after it: (a) `python -m
                cyclonus_tpu_torch chaos --json` on the card, all seven
                scenarios ok (serve_kill_restart's time to first verdict,
                the torch import and CUDA's start included,
                printed against its 150 s bound; audit_divergence's
                corruption found within 32 checks); (b) a VerdictService
                on the card at the serve phase's 1,024-pod cluster, untiered
                and tiered, with CYCLONUS_AUDIT=1 and rate 1.0, under
                bench.py's 32-delta stream beside a CPU twin: verdicts equal
                to the twin's, every answered query checked and none
                diverged, one digest per epoch equal to the twin's, and the
                final packed counts (K1; tiered K3) equal to the twin's; (c)
                scenario_poisoned_caches at that cluster with the autotune
                on "auto": K4 and K6 launch, every poisoned winners file is
                searched again and the counts stay equal; (d)
                CYCLONUS_SLO_ENFORCE=1 with query_p99 and freshness forced
                to exhausted: every query shed (SLO_SHED), a delta batch
                refused with Admission; forced back to ok, the verdicts are
                live and equal to the oracle; (e) `recipes --engine cuda`:
                the 15 recipes' tables equal to `--engine oracle`'s.
                Prints one {"chaos": ...} line.
 13. native   — run after `chaos`, outside the steady-state settings, the
                kernel launch counts zeroed before it and read after it:
                (a) g++ builds the C++ host evaluator (native/) into the
                package's build directory (its seconds logged), and it must
                load; (b) synthetic.build_synthetic(4096, 200,
                random.Random(0)) with TCP 80 named, UDP 81 named and SCTP
                9999: the native ingress, egress and combined grids equal
                to the card's evaluate_grid in every cell, 2,000 sampled
                cells equal to the scalar oracle (native seconds, the
                card's grid seconds and the host's CPU count logged); (c)
                the native combined grid's per-case allow counts equal to
                evaluate_grid_counts on the packed plan's dense route (K1),
                which must launch; (d) `probe --engine native` on the
                getting-started policies and `generate --mock --perfect-cni
                --engine native --retries 0 --max-cases 8`: 0 wrong cells,
                VERDICTS{engine="native"} moved and no oracle fallback; (e)
                `perf report --format json` and `perf gate` on the
                checkout's BENCH_r* / MULTICHIP_r* (runs by failure class,
                the gate's exit code, which must lie in 0-2); (f) `version
                --devices` names the card, count 1.  Prints one
                {"native": ...} line.
 14. scale    — run after `native`, the kernel launch counts zeroed
                before it and read after it (the K2 check of (c) left
                out): the reference's largest shapes, each cluster from
                synthetic.build_synthetic with TCP 80 named and UDP 81
                named, its matcher shared by the leg's engines: (a)
                1,000,000 pods x 500 policies (bench.py's seed): engine A
                (class_compress auto) and engine B (class_compress="0"):
                per engine the encode, its counts route read before the
                first call and held against the launches (class: K2 and
                no K1; dense: K1 and no K2), the first counts call and the
                min of 3 more, torch.cuda.max_memory_allocated; A's counts
                equal to B's, cells included, and 25 evaluate_pairs pairs
                at both cases on each engine equal to the scalar oracle
                (run in this process); (b) the same at 2,000,000 pods,
                where a declined class route is reported with its class
                count and byte estimate and engine A then runs K1 under
                that name; (c) bench.py's mega_class (1,000,000 pods x
                2,000 policies x 512 namespaces, random.Random(20260803)):
                class_compression_stats(), _class_counts_eligible(2) True,
                the counts as in (a), K2 against its plain version at the
                leg's class operands, 10 pairs against the oracle and
                analysis.audit_class_reduction(max_classes=4,
                peers_per_class=4) ok; (d) the full-grid tables mode at
                25,000 pods x 2,500 policies (bench.py's seed):
                evaluate_grid on the class route (the gather epilogue)
                and the dense route equal cell for cell on the card, each
                case's sums equal to evaluate_grid_counts on both engines,
                the dense grids fetched to the host (timed) and 2,000
                cells equal to the oracle.  The phase must end within
                240 s.  Prints one {"scale": ...} line;
 15. guards   — the runtime guards on the card, each leg a process of its
                own (the guard flags are read at import): (a)
                torch_tools/planharness.py's HEADLINE sequence at the
                headline cluster (100,000 pods x 10,000 policies, seed
                20260729; the class route and class_compress="0" on the
                packed plan, untiered and tiered, three calls each on the
                dense route, then pack=False with slab "1"), once with
                CYCLONUS_SHAPE_CHECK=1 CYCLONUS_GUARD_CHECK=1
                CYCLONUS_PLANHARNESS=1 and once with the three set to 0:
                every call's counts equal the main path's, armed and
                unarmed alike; the armed run's contract counter above 0
                and its drained routes equal to HEADLINE (counts.classes,
                counts.pallas then counts.steady.default, and
                counts.steady.slab for slab "1": the list
                tests/test_torch_planspec.py holds both packages to); the
                unarmed run records no route and checks no contract; (b)
                torch_tools/raceharness.py --device cuda on engine_cache
                and worker_ingest under CYCLONUS_GUARD_CHECK=1 (50 seeded
                schedules, 8 threads); (c) torch_tools/skewharness.py
                --device cuda (the serve loop on the card's engine); (d)
                torch_tools/planharness.py --device cuda; (e)
                torch_tools/keyharness.py --device cuda --full (the
                cache-key mutations of the autotune winners, the kernel
                libraries and the steady state's pins on K1, K4 and K6,
                each call's counts equal to a fresh engine's; a fresh
                process on the warm build directory compiling nothing;
                the registry census, armed against unarmed, with the
                steady K1 call timed in paired rounds, the registry on
                and off in turns).  Each call's seconds armed
                and unarmed are reported.  The phase must end within
                180 s.  Prints one {"guards": ...} line.

Every comparison is exact.  Prints a JSON line of the probe phase, the
loopback line, the cidr and analyze lines, the serve lines, the mesh lines, a JSON line of
the main path's
end-to-end numbers (per route and dense-plan leg), the telemetry line, the
chaos line, the native line, the scale line, the guards line, a line of each
phase's seconds, a JSON line of per-kernel numbers (with each kernel's launches
on the serve path, on the CIDR legs, on the mesh's sharded calls, on the
loopback phase, on the telemetry phase, on the chaos phase, on the native
phase, on the scale phase and on the guards phase), then as its last
line {"ok": true,
"device": {...}}.
A crash dumps the flight recorder into the temporary directory.
Exits non-zero, with no result line, when there is no CUDA device or any
phase fails.  The port's CPU paths are covered by tests/test_torch_*.py.
"""

from __future__ import annotations

import contextlib
import json
import os
import random
import statistics
import subprocess
import sys
import tempfile
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
#: multiply-adds
PEAK_INT8_OPS = 1.979e15
#: single-bit tensor-core operations/s of the same card (a bit
#: multiply-add counts two): the data sheet gives no rate, so this is the
#: rate that torch_tools/mma_probe.py measured for wgmma m64n256k256
#: .b1.and.popc on an H100 80GB HBM3 at 700 W, 7.883e15 bit multiply-adds/s
#: — the least time for the packed kernels' contraction, which runs on it
PEAK_B1_OPS = 2 * 7.883e15
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


def packed_items(ops) -> int:
    """Work items of one packed counts launch: (q, 128 src rows, 256 dst
    cols) over the padded pod axes."""
    q, nd_pad, _ = ops["b_e"].shape
    return q * -(-ops["a_e"].shape[0] // 128) * -(-nd_pad // 256)


def phase_kernels(device) -> None:
    import numpy as np
    import torch

    from cyclonus_tpu_torch.engine import packed_kernel as pk

    rng = np.random.default_rng(20260729)
    # word depths 1 to 420 (one k256 step is 8 words; 9 and 17 words take
    # a second and third step with mostly zero words, 300 and 420 several
    # dozen), pod axes off 128 and 256, and more items than the persistent
    # grid holds, so each block walks several bs segments
    shapes = [  # (q, we, wi, ns, nd)
        (1, 1, 1, 9, 9),
        (2, 12, 8, 1000, 777),
        (3, 33, 33, 523, 1500),
        (2, 1, 33, 2049, 130),
        (2, 300, 170, 200, 300),
        (1, 17, 420, 130, 260),
        (2, 7, 8, 300, 500),
        (1, 9, 16, 1000, 1000),
        (3, 17, 7, 129, 257),
        (1, 16, 9, 257, 129),
        (2, 8, 17, 3000, 2900),
    ]
    n_checked = max_items = 0
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
        bs, bd = pk.PACKED_BS, pk.PACKED_BD
        max_items = max(max_items, q * -(-ns // bs) * bs // 128 * (-(-nd // bd) * bd // 256))
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    log(f"kernels: {n_checked} untiered kernel-vs-plain checks equal (tolerance: exact); "
        f"up to {max_items} items on {sms} SMs")
    if max_items < 4 * sms:
        raise AssertionError(f"no packed case walks several items per block: {max_items} items")

    # the tiered variants: tier rows from one to past the reference's
    # 1,024-row ceiling; keys ordered as the engine emits them or in random
    # order (the kernel walks each key vector's rows sorted by key either
    # way); walks of one row to past several passes of 128 positions; a tier
    # word depth past one and many items on the persistent grid
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
        (2, 9, 17, 3000, 2900, 5, 33, False),
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


def slab_items(ops) -> int:
    """Work items of one K6 launch: (q, src tile, dst tile, 128 src rows,
    256 dst cols), none straddling two tiles."""
    n_i, bs, _ = ops["a_e"].shape
    n_j, bd, _ = ops["a_i"].shape
    return ops["b_e"].shape[0] * n_i * n_j * -(-bs // 128) * -(-bd // 256)


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
        # K4 at live depths below its chunk, bucketing pads past them, and
        # a direction whose live depth is only the pseudo row
        (2, 200, 300, 3000, 2000, 0, (50, 60)),
        (1, 0, 300, 500, 700, 20, (100, 0)),
        (3, 90, 0, 1300, 900, 0, (0, 37)),
    ]
    checked = {"dense_counts_1chunk": 0, "dense_counts_chunked": 0}
    mixed = [0, 0]
    for q, te, ti, ns, nd, n_ns, pads in shapes:
        args, vs, vd = random_dense(rng, q, te, ti, ns, nd, device, n_ns, pads)
        variants = [
            {"valid_src": vs, "valid_dst": vd},
            {"valid_src": vs, "valid_dst": vd, "bs": 64},
            # the src tile dense_operands steps down to past 2,097,152 pods
            {"valid_src": vs, "valid_dst": vd, "bs": dk.MIN_BS},
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
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    slab_shapes = [  # (q, te, ti, n, bs, bd, w, namespaces): 8-wide tiles to the default
        (1, 30, 40, 100, 8, 8, 1, 30),
        (2, 60, 50, 250, 8, 16, 8, 50),
        (3, 200, 300, 1000, 64, 32, 32, 100),
        (2, 250, 300, 5000, 2048, 1024, 128, 100),
        (2, 20, 30, 5000, 2048, 1024, 32, 20),
        (2, 600, 900, 5000, 2048, 1024, 128, 40),
        # tiles off the kernel's 128 x 256 item, tile pairs of several
        # items, w_aug 160 (three 64-byte stages a direction), Q 1 and 3
        (1, 150, 200, 1000, 136, 200, 16, 60),
        (3, 300, 300, 1000, 256, 512, 32, 80),
        (2, 400, 500, 3000, 264, 136, 128, 40),
        (3, 100, 120, 2000, 72, 328, 64, 90),
        # many more items than the persistent grid: each block walks
        # items of several src tiles, flushing its counts at each change
        (2, 500, 600, 12000, 512, 256, 64, 120),
    ]
    max_items = 0
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
        max_items = max(max_items, slab_items(ops))
        if t0[0][1] and t0[1][1]:
            # windows that hold every target: the slab counts equal K4/K5's
            dense = sum_partials(dk.verdict_counts(*args, n_pods=n_pods), q, n_pods)
            if sum_partials(got, q, n_pods) != dense:
                raise AssertionError(f"slab counts != dense counts at q={q} n={n} w={w}")
            n_slab += 1
    log(f"kernels: {n_slab} slab kernel checks equal (vs plain, and vs the dense kernels "
        f"where the windows hold; tolerance: exact); up to {max_items} items on {sms} SMs")
    if max_items < 8 * sms:
        raise AssertionError(f"no slab case walks several items per block: {max_items} items")


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


#: the large probe's cluster: namespaces x pods, 540,000 all-available
#: jobs over ports 80 and 81 and TCP, UDP, SCTP (6 containers a pod)
PROBE_NAMESPACES = ["x", "y", "z"] + [f"n{i}" for i in range(3, 10)]
PROBE_PODS = ["a", "b", "c"] + [f"p{i}" for i in range(3, 30)]
#: jobs of the large probe held against the scalar oracle
PROBE_ORACLE_SAMPLE = 2000
SIMPLE_EXAMPLE = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "examples", "networkpolicies", "simple-example"
)
#: the job runners that probe a cluster: per-job exec and in-pod batches
KUBE_RUNNERS = ("KubeJobRunner", "KubeBatchJobRunner")


@contextlib.contextmanager
def probe_recorder(keep=False):
    """Every probe that Runner.run_probe_for_config runs while active, as
    the runner recorded it: the job runner's kind, the seconds split, and
    for the simulated runner its engine and device.  With `keep`, also the
    table, the pods and namespaces it probed and the simulated runner's
    policy."""
    from cyclonus_tpu_torch.probe import runner as pr

    records = []
    original = pr.Runner.run_probe_for_config

    def recorded(self, probe_config, resources):
        table = original(self, probe_config, resources)
        jr = self.job_runner
        rec = {"kind": type(jr).__name__, **self.seconds}
        if isinstance(jr, pr.SimulatedJobRunner):
            rec.update(engine=jr.engine, device=str(jr.device), **jr.seconds)
        if keep:
            rec.update(
                probe_table=table,
                policy=getattr(jr, "policies", None),
                pods=[(p.namespace, p.name, dict(p.labels), p.ip) for p in resources.pods],
                namespaces={k: dict(v) for k, v in resources.namespaces.items()},
            )
        records.append(rec)
        return table

    pr.Runner.run_probe_for_config = recorded
    try:
        yield records
    finally:
        pr.Runner.run_probe_for_config = original


def probe_split(records, wall_s, engine="cuda"):
    """The seconds of a run's simulated probes by stage, summed, and a
    check that each ran on `engine` (on the card for "cuda" and
    "cuda-sharded", on the host for "oracle" and "native")."""
    sim = [r for r in records if r["kind"] == "SimulatedJobRunner"]
    kube = [r for r in records if r["kind"] in KUBE_RUNNERS]
    on_card = engine in ("cuda", "cuda-sharded")
    bad = [r for r in sim if r["engine"] != engine or on_card != r["device"].startswith("cuda")]
    if not sim or bad:
        raise AssertionError(f"probes not on the {engine} engine: {bad or 'none ran'}")

    def total(rs, key):
        return sum(r.get(key, 0.0) for r in rs)

    return {
        "seconds": wall_s,
        "simulated_probes": len(sim),
        "device": sim[0]["device"],
        "jobs_s": total(sim, "jobs"),
        "build_s": total(sim, "build"),
        "grid_s": total(sim, "grid"),
        "scatter_s": total(sim, "scatter"),
        "table_s": total(sim, "table"),
        "kube_probe_s": total(kube, "jobs") + total(kube, "run") + total(kube, "table"),
    }


def run_cli(argv, engine="cuda", keep=None):
    """(exit code, stdout, stage split) of one in-process CLI run; a list
    `keep` receives the run's probe records with their tables."""
    import io

    from cyclonus_tpu_torch.cli import main as cli_main

    out = io.StringIO()
    t0 = time.perf_counter()
    with probe_recorder(keep is not None) as records, contextlib.redirect_stdout(out):
        rc = cli_main(argv)
    split = probe_split(records, time.perf_counter() - t0, engine)
    if keep is not None:
        keep.extend(records)
    return rc, out.getvalue(), split


def comparison_counts(text):
    """(wrong, ignored, correct) summed over the report's step lines."""
    import re

    rows = re.findall(r"^(\d+) wrong, (\d+) ignored, (\d+) correct$", text, re.M)
    return tuple(sum(int(r[i]) for r in rows) for i in range(3)), len(rows)


def table_cells(table):
    """{(from, to): {job key: (ingress, egress, combined)}} of a Table."""
    return {
        (fr, to): {k: (r.ingress, r.egress, r.combined) for k, r in table.get(fr, to).job_results.items()}
        for fr, to in table.wrapped.keys()
    }


def large_probe_policies():
    """The large probe's fixed policy set: the simple-example fixture
    (namespace y) and one example policy in each of the ten namespaces,
    selecting the probe pods by their {pod: name} labels."""
    from cyclonus_tpu_torch.kube import examples as ex
    from cyclonus_tpu_torch.kube.yaml_io import load_policies_from_path

    return load_policies_from_path(SIMPLE_EXAMPLE) + [
        ex.allow_from_to("x", {"pod": "a"}, {"pod": "b"}),
        ex.allow_all_within_namespace("y"),
        ex.allow_nothing_to_anything("z"),
        ex.allow_from_namespace_to("n3", {"ns": "x"}, {"pod": "c"}),
        ex.allow_specific_port_to("n4", {"pod": "p5"}, {"pod": "a"}, 81),
        ex.allow_no_egress_from_labels("n5", {"pod": "b"}),
        ex.allow_egress_on_port("n6", {"pod": "p7"}, 80),
        ex.allow_no_egress_from_namespace("n7"),
        ex.allow_egress_to_all_namespaces_on_port("n8", {"pod": "a"}, 81),
        ex.allow_from_different_namespace_with_labels_to("n9", {"pod": "c"}, {"ns": "y"}, {"pod": "p9"}),
        ex.accidental_or("x", {"pod": "c"}, {"ns": "y"}, {"pod": "a"}),
    ]


def phase_probe(device) -> None:
    """The probe layer on the card: the probe CLI, the full conformance
    run, and the large probe against the CPU engine and the oracle."""
    from cyclonus_tpu_torch.kube import MockKubernetes
    from cyclonus_tpu_torch.matcher import build_network_policies
    from cyclonus_tpu_torch.probe import ProbeConfig, Resources, SimulatedJobRunner, new_simulated_runner
    from cyclonus_tpu_torch.probe import runner as pr

    if pr.DEFAULT_ENGINE != "cuda":
        raise AssertionError(f"default simulated engine {pr.DEFAULT_ENGINE!r}")
    out = {"card": card_info()}

    # (a) the probe CLI at its defaults, then the same on the oracle engine
    argv = ["probe", "--mock", "--perfect-cni", "--noisy", "--policy-path", SIMPLE_EXAMPLE]
    rc, text, split = run_cli(argv)
    oracle_rc, oracle_text, _ = run_cli(argv + ["--engine", "oracle"], engine="oracle")
    (wrong, ignored, correct), steps = comparison_counts(text)
    if rc != 0 or oracle_rc != 0 or wrong or not correct:
        raise AssertionError(f"probe CLI: rc {rc}/{oracle_rc}, {wrong} wrong, {correct} correct")
    if text != oracle_text:
        raise AssertionError("probe CLI: the cuda engine's report differs from the oracle's")
    out["cli_probe"] = {**split, "steps": steps, "cells_compared": wrong + ignored + correct,
                        "differing_cells": wrong}
    log(f"probe CLI: {correct} cells equal to the perfect CNI, report equal to the oracle's, "
        f"{split['seconds']:.2f} s")

    # (b) the full conformance run
    with tempfile.TemporaryDirectory(prefix="chip_smoke-journal-") as tmp:
        journal = os.path.join(tmp, "journal.jsonl")
        rc, text, split = run_cli(
            ["generate", "--mock", "--perfect-cni", "--exclude", "none", "--journal", journal]
        )
        with open(journal) as f:
            entries = [json.loads(line) for line in f if line.strip()]
    (wrong, ignored, correct), steps = comparison_counts(text)
    passed = sum(e["passed"] for e in entries)
    if rc != 0 or len(entries) != 216 or passed != 216 or wrong:
        raise AssertionError(f"conformance: rc {rc}, {passed}/{len(entries)} passed, {wrong} wrong cells")
    if split["simulated_probes"] != sum(e["step_count"] for e in entries):
        raise AssertionError(f"conformance: {split['simulated_probes']} simulated probes for "
                             f"{sum(e['step_count'] for e in entries)} steps")
    out["conformance"] = {**split, "cases_run": len(entries), "cases_passed": passed,
                          "steps": steps, "cells_compared": wrong + ignored + correct}
    log(f"conformance: {passed}/{len(entries)} cases passed on the cuda engine, "
        f"{split['seconds']:.2f} s")

    # (c) the large all-available probe: card, CPU engine, oracle sample
    policy = build_network_policies(True, large_probe_policies())
    t0 = time.perf_counter()
    resources = Resources.new_default(
        MockKubernetes(1.0), PROBE_NAMESPACES, PROBE_PODS, [80, 81], ["TCP", "UDP", "SCTP"]
    )
    setup_s = time.perf_counter() - t0
    cfg = ProbeConfig.all_available_config()
    card = new_simulated_runner(policy)
    t0 = time.perf_counter()
    with probe_recorder() as records:
        card_table = card.run_probe_for_config(cfg, resources)
    card_split = probe_split(records, time.perf_counter() - t0)
    n_jobs = (len(PROBE_NAMESPACES) * len(PROBE_PODS)) ** 2 * 6
    cpu = new_simulated_runner(policy, device="cpu")
    t0 = time.perf_counter()
    cpu_table = cpu.run_probe_for_config(cfg, resources)
    cpu_s = time.perf_counter() - t0
    card_cells = table_cells(card_table)
    n_cells = sum(len(v) for v in card_cells.values())
    if n_cells != n_jobs:
        raise AssertionError(f"large probe: {n_cells} cells for {n_jobs} jobs")
    if card_cells != table_cells(cpu_table):
        raise AssertionError("large probe: the card's table differs from the CPU engine's")
    results = [r for fr, to in card_table.wrapped.keys() for r in card_table.get(fr, to).job_results.values()]
    oracle = SimulatedJobRunner(policy, engine="oracle")
    for r in random.Random(SEED).sample(results, PROBE_ORACLE_SAMPLE):
        o = oracle.run_job(r.job)
        if (r.ingress, r.egress, r.combined) != (o.ingress, o.egress, o.combined):
            raise AssertionError(f"large probe: job {r.job.key()} differs from the oracle")
    allowed = sum(r.combined == "allowed" for r in results)
    share, top = device_time_profile(lambda: card.run_probe_for_config(cfg, resources), reps=1)
    out["large"] = {
        **card_split,
        "pods": len(resources.pods), "jobs": n_jobs, "allowed": allowed,
        "cluster_setup_s": setup_s, "cpu_engine_s": cpu_s, "cpu_engine_split": {**cpu.seconds, **cpu.job_runner.seconds},
        "cells_compared": n_cells + PROBE_ORACLE_SAMPLE,
        "device_busy_share": share, "device_top": top,
    }
    log(f"large probe: {n_jobs} jobs ({allowed} allowed) equal to the CPU engine and "
        f"{PROBE_ORACLE_SAMPLE} to the oracle; card {card_split['seconds']:.2f} s, "
        f"CPU engine {cpu_s:.2f} s, device busy {share}")
    log(json.dumps({"probe": out}))


# --- the loopback cluster -----------------------------------------------------

HERE = os.path.dirname(os.path.abspath(__file__))
GETTING_STARTED = os.path.join(HERE, "examples", "networkpolicies", "getting-started")
#: the reference's committed journal of the 16 conflict cases on its
#: loopback cluster: the descriptions, in order, that leg (b) must pass
LOOPBACK_JOURNAL = os.path.join(HERE, "artifacts", "loopback-conformance-journal.jsonl")
#: the conflict cases (indices into the 16) whose step leg (d) recounts on
#: the engine: egress and ingress, by pod and by IP
LOOPBACK_COUNT_CASES = (0, 5, 12, 15)
#: one bind that the pod servers' ports need (root or CAP_NET_BIND_SERVICE)
LOOPBACK_BIND = ("127.10.0.1", 80)


def loopback_precondition():
    """None when this process may bind port 80 on 127/8, else the errno
    text: the one reason legs (a)-(c) may be skipped."""
    import socket

    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    try:
        s.bind(LOOPBACK_BIND)
    except OSError as e:
        return f"bind {LOOPBACK_BIND[0]}:{LOOPBACK_BIND[1]}: {e.strerror or e}"
    finally:
        s.close()
    return None


@contextlib.contextmanager
def worker_batches():
    """Counts the in-pod worker batches the loopback cluster runs while
    active: each one `python -m cyclonus_tpu_torch.worker` subprocess."""
    from cyclonus_tpu_torch.kube.loopback import LoopbackKubernetes

    count = [0]
    original = LoopbackKubernetes.execute_remote_command

    def counted(self, namespace, pod, container, command):
        if command and command[0] == "/worker":
            count[0] += 1
        return original(self, namespace, pod, container, command)

    LoopbackKubernetes.execute_remote_command = counted
    try:
        yield count
    finally:
        LoopbackKubernetes.execute_remote_command = original


def step_pairs(records, what):
    """The (simulated, cluster) probe records of each step, in order: the
    interpreter probes the simulated table, then the cluster once (no
    retries)."""
    sims, kubes = records[0::2], records[1::2]
    kinds = [r["kind"] for r in records]
    if (len(sims) != len(kubes) or any(r["kind"] != "SimulatedJobRunner" for r in sims)
            or any(r["kind"] not in KUBE_RUNNERS for r in kubes)):
        raise AssertionError(f"{what}: probes not in (simulated, cluster) pairs: {kinds}")
    return list(zip(sims, kubes))


def loopback_counts(device, sim, kube, label):
    """Leg (d) for one step: the engine on `device` over the step's pods,
    namespaces and policy counts the step's port cases on the packed plan
    (K1) and under CYCLONUS_PACK=0 (K4); each combined count must equal
    the allowed cells of the cluster's table, each cell count its jobs,
    and on the card each kernel must have launched."""
    from cyclonus_tpu_torch.engine import PortCase, TorchPolicyEngine

    table = kube["probe_table"]
    results = [r for fr, to in table.wrapped.keys() for r in table.get(fr, to).job_results.values()]
    keys = list(dict.fromkeys(
        (r.job.resolved_port, r.job.resolved_port_name, r.job.protocol) for r in results
    ))
    cases = [PortCase(*k) for k in keys]
    allowed = sum(r.combined == "allowed" for r in results)
    out = {"jobs": len(results), "allowed": allowed, "cases": len(cases)}
    for plan, pack, kernel in (("packed", "1", "packed_counts"), ("dense", "0", "dense_counts_1chunk")):
        before = launch_counts()
        with env(CYCLONUS_PACK=pack):
            eng = TorchPolicyEngine(sim["policy"], sim["pods"], sim["namespaces"], device=device)
            counts = eng.evaluate_grid_counts(cases)
        moved = {k: v - before[k] for k, v in launch_counts().items() if v != before[k]}
        if counts["combined"] != allowed or counts["cells"] != len(results):
            raise AssertionError(f"{label}, {plan} plan: counts {counts} against {allowed} "
                                 f"allowed of {len(results)} cells in the cluster's table")
        if device.type == "cuda" and moved.get(kernel, 0) < 1:
            raise AssertionError(f"{label}, {plan} plan: {kernel} did not launch: {moved}")
        out[plan] = {"counts": counts, "launches": moved}
    return out


def loopback_analyze():
    """Leg (c): `analyze -A --mode probe` with its pods, namespaces and
    policies from the recording kubectl of tests/fakekubectl.py on PATH,
    the simulated probe on the card; its tables equal the oracle
    engine's."""
    from pathlib import Path

    from cyclonus_tpu_torch.kube.yaml_io import load_policies_from_path, policy_to_dict

    sys.path.insert(0, os.path.join(HERE, "tests"))
    from fakekubectl import FakeKubectl, pod_json

    namespaces, pods = ["x", "y", "z"], ["a", "b", "c"]
    policies = [policy_to_dict(p) for p in load_policies_from_path(SIMPLE_EXAMPLE)]
    texts, calls = {}, {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke-kubectl-") as tmp:
        for engine in ("cuda", "oracle"):
            root = Path(tmp) / engine
            root.mkdir()
            fake = FakeKubectl(root)
            fake.enqueue({"items": policies})
            fake.enqueue({"items": [
                pod_json(ns=ns, name=name, labels={"pod": name}, ip=f"10.7.{i}.{j + 1}")
                for i, ns in enumerate(namespaces) for j, name in enumerate(pods)
            ]})
            fake.enqueue({"items": [{"metadata": {"name": ns, "labels": {"ns": ns}}}
                                    for ns in namespaces]})
            with env(PATH=f"{root}{os.pathsep}{os.environ.get('PATH', '')}"), \
                    probe_recorder() as records:
                rc, texts[engine] = analyze_cli(["-A", "--mode", "probe", "--engine", engine])
            if rc != 0:
                raise AssertionError(f"analyze -A --engine {engine}: exit {rc}")
            calls[engine] = [c["argv"] for c in fake.calls()]
            if engine == "cuda":
                split = probe_split(records, 0.0)
    if texts["cuda"] != texts["oracle"] or "Combined:" not in texts["cuda"]:
        raise AssertionError("analyze -A: the card's tables differ from the oracle engine's")
    if calls["cuda"] != [["get", "networkpolicy", "--all-namespaces", "-o", "json"],
                         ["get", "pods", "--all-namespaces", "-o", "json"],
                         ["get", "namespaces", "-o", "json"]] or calls["oracle"] != calls["cuda"]:
        raise AssertionError(f"analyze -A: kubectl calls {calls}")
    return {"cells_compared": len(namespaces) ** 2 * len(pods) ** 2, "kubectl_calls": len(calls["cuda"]),
            "device": split["device"], "grid_s": split["grid_s"]}


def phase_loopback(device):
    """The loopback cluster (pods as processes on 127/8, real sockets)
    through the port's CLI, every simulated table on the card: (a) `probe
    --loopback`, (b) the 16 conflict cases in both exec modes, (c)
    `analyze -A` through a recording kubectl, (d) the engine's counts
    (K1, K4) against the real-socket tables.  Returns the kernel launches
    of the phase, counted from zero."""
    from cyclonus_tpu_torch.engine import dense_kernel as dk
    from cyclonus_tpu_torch.engine import packed_kernel as pk

    pk.reset_launches()
    dk.reset_launches()
    out = {"card": card_info()}
    legs_s = {}
    skipped = loopback_precondition()
    if skipped:
        # (d) still runs, on the same pods and policies in the mock cluster
        log(json.dumps({"loopback": {"skipped": skipped}}))
        cluster = ["--mock", "--perfect-cni"]
    else:
        cluster = ["--loopback"]

    # (a) the one-off probe of getting-started on TCP 80
    t0 = time.perf_counter()
    one_off = []
    rc, text, split = run_cli(["probe"] + cluster + [
        "--probe-port", "80", "--probe-protocol", "tcp", "--policy-path", GETTING_STARTED,
        "--noisy"], keep=one_off)
    (wrong, ignored, correct), steps = comparison_counts(text)
    if rc != 0 or wrong or correct != 81 or steps != 1:
        raise AssertionError(f"probe {cluster[0]}: rc {rc}, {wrong} wrong, {correct} correct")
    legs_s["a_probe"] = time.perf_counter() - t0
    out["cli_probe"] = {**split, "cells_compared": wrong + ignored + correct, "differing_cells": wrong}
    log(f"probe {cluster[0]}: {correct} cells of the real-socket table equal to the card's, "
        f"{legs_s['a_probe']:.2f} s")

    # (b) the 16 conflict cases, per-job exec and in-pod batches
    with open(LOOPBACK_JOURNAL) as f:
        want = [json.loads(line)["description"] for line in f if line.strip()]
    conflict = []
    workers = 0
    for mode in ("exec", "batch") if not skipped else ("exec",):
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(prefix="chip_smoke-loopback-") as tmp, \
                worker_batches() as batches:
            journal = os.path.join(tmp, "journal.jsonl")
            rc, text, split = run_cli(
                ["generate"] + cluster + ["--include", "conflict", "--retries", "0", "--journal", journal]
                + (["--batch-jobs"] if mode == "batch" else []),
                keep=conflict if mode == "exec" else None,
            )
            with open(journal) as f:
                entries = [json.loads(line) for line in f if line.strip()]
        (wrong, ignored, correct), steps = comparison_counts(text)
        passed = sum(e["passed"] for e in entries)
        if rc != 0 or passed != 16 or wrong or [e["description"] for e in entries] != want:
            raise AssertionError(f"conflict cases ({mode}): rc {rc}, {passed}/{len(entries)} passed, "
                                 f"{wrong} wrong cells, descriptions equal to the journal's: "
                                 f"{[e['description'] for e in entries] == want}")
        if mode == "batch" and batches[0] != 16 * 9:
            raise AssertionError(f"conflict cases (batch): {batches[0]} worker batches, not 16 x 9")
        workers += batches[0]
        legs_s[f"b_conflict_{mode}"] = time.perf_counter() - t0
        out[f"conflict_{mode}"] = {**split, "cases_run": len(entries), "cases_passed": passed,
                                   "steps": steps, "cells_compared": wrong + ignored + correct,
                                   "worker_subprocesses": batches[0]}
        log(f"conflict cases ({mode}): {passed}/{len(entries)} passed over real sockets, "
            f"{legs_s[f'b_conflict_{mode}']:.2f} s")

    # (c) analyze -A through the recording kubectl
    if not skipped:
        t0 = time.perf_counter()
        out["analyze_kube"] = loopback_analyze()
        legs_s["c_analyze"] = time.perf_counter() - t0
        log(f"analyze -A --mode probe: the card's tables equal the oracle engine's, "
            f"{legs_s['c_analyze']:.2f} s")

    # (d) the engine's counts against the real-socket tables
    t0 = time.perf_counter()
    pairs = step_pairs(one_off, "probe")
    conflict_pairs = step_pairs(conflict, "conflict cases")
    if len(conflict_pairs) != 16:
        raise AssertionError(f"conflict cases: {len(conflict_pairs)} probed steps, not 16")
    pairs += [conflict_pairs[i] for i in LOOPBACK_COUNT_CASES]
    counts = [loopback_counts(device, sim, kube, f"step {i}") for i, (sim, kube) in enumerate(pairs)]
    legs_s["d_counts"] = time.perf_counter() - t0
    launches = launch_counts()
    for kernel in ("packed_counts", "dense_counts_1chunk"):
        if device.type == "cuda" and launches[kernel] < len(pairs):
            raise AssertionError(f"loopback counts: {kernel} launched {launches[kernel]} times "
                                 f"for {len(pairs)} steps")
    out["counts"] = {"steps": counts, "cells_compared": sum(c["jobs"] for c in counts)}
    log(f"loopback counts: {len(pairs)} steps, K1 and K4 combined counts equal to the "
        f"real-socket tables' allowed cells, {legs_s['d_counts']:.2f} s")
    out.update(legs_s=legs_s, worker_subprocesses=workers, launches=launches,
               cases_run=sum(out[k]["cases_run"] for k in out if k.startswith("conflict_")),
               cases_passed=sum(out[k]["cases_passed"] for k in out if k.startswith("conflict_")))
    log(json.dumps({"loopback": out}))
    return launches


# --- the verdict service ----------------------------------------------------

#: bench.py's serve leg at its defaults (bench.py:936-946): pods, policies,
#: single-pod delta steps, queries a step, the seed
SERVE_PODS, SERVE_POLICIES, SERVE_DELTAS, SERVE_QUERIES, SERVE_SEED = 1024, 128, 32, 8, 123
#: the headline leg's query batch, its parity pairs and oracle sample
SERVE_BATCH, SERVE_PAIRS, SERVE_ORACLE = 4096, 4096, 256


def serve_queries(rng, keys, n):
    """bench.py's query mix: half TCP 80, half the named UDP 81."""
    from cyclonus_tpu_torch.worker.model import FlowQuery

    out = []
    for _ in range(n):
        a, b = rng.choice(keys), rng.choice(keys)
        if rng.random() < 0.5:
            out.append(FlowQuery(src=a, dst=b, port=80, protocol="TCP", port_name="serve-80-tcp"))
        else:
            out.append(FlowQuery(src=a, dst=b, port=81, protocol="UDP", port_name="serve-81-udp"))
    return out


def serve_stream(svc, rng, label, steps=SERVE_DELTAS, q_per_step=SERVE_QUERIES, extra=()):
    """bench.py's serve churn against a warm service: `steps` single-pod
    delta batches (every fifth a remove-then-add of the same pod, the
    others a label change) with `q_per_step` queries after each, then the
    batches in `extra` ((kind, [deltas])).  Every apply must patch
    (mode incremental or class_rebuild) and no whole tensor set may move
    to the device.  Returns the figures of the stream."""
    from cyclonus_tpu_torch.engine import api
    from cyclonus_tpu_torch.worker.model import Delta

    from cyclonus_tpu_torch.worker.model import FlowQuery

    keys = list(svc.pods)
    # warm: the device views' upload, then one patch
    svc.query([FlowQuery(src=keys[0], dst=keys[1], port=80, protocol="TCP",
                         port_name="serve-80-tcp")])
    pod = svc.pods[keys[0]]
    svc.apply([Delta(kind="pod_labels", namespace=pod[0], name=pod[1],
                     labels={**pod[2], "tier": "tier1"})])
    transfers0, bytes0 = dict(api.TRANSFERS), svc.patch_stats()["patch_bytes"]
    applies, batch_s, n_queries = {}, [], 0

    def apply(kind, deltas):
        report = svc.apply(deltas)
        if report["mode"] not in ("incremental", "class_rebuild"):
            raise AssertionError(f"{label}: {kind} delta took mode {report['mode']!r}: {deltas}")
        applies.setdefault(kind, []).append(report["seconds"])

    for step in range(steps):
        key = keys[rng.randrange(len(keys))]
        ns, name = key.split("/", 1)
        if step % 5 == 4:
            pod = svc.pods[key]
            apply("remove_add", [Delta(kind="pod_remove", namespace=ns, name=name),
                                 Delta(kind="pod_add", namespace=ns, name=name,
                                       labels=dict(pod[2]), ip=pod[3])])
        else:
            apply("labels", [Delta(kind="pod_labels", namespace=ns, name=name, labels={
                "pod": f"p{rng.randrange(100)}", "app": f"app{rng.randrange(20)}",
                "tier": f"tier{rng.randrange(5)}"})])
        qs = serve_queries(rng, keys, q_per_step)
        t0 = time.perf_counter()
        verdicts = svc.query(qs)
        batch_s.append(time.perf_counter() - t0)
        if any(v.error for v in verdicts):
            raise AssertionError(f"{label}: a query failed: {[v.error for v in verdicts if v.error]}")
        n_queries += len(qs)
    for kind, deltas in extra:
        apply(kind, deltas)
    if api.TRANSFERS != transfers0:
        raise AssertionError(f"{label}: a patch uploaded a tensor set: {transfers0} -> {api.TRANSFERS}")
    return {
        "incremental_apply_s": {k: {"mean": statistics.mean(v), "max": max(v), "n": len(v)}
                                for k, v in applies.items()},
        "patch_bytes": svc.patch_stats()["patch_bytes"] - bytes0,
        "headroom_saves": svc.patch_stats()["headroom_saves"],
        "stream_queries": n_queries,
        "stream_queries_per_sec": n_queries / sum(batch_s),
        "stream_batch_p50_ms": 1e3 * statistics.median(batch_s),
        "stream_batch_p99_ms": 1e3 * sorted(batch_s)[min(len(batch_s) - 1, int(0.99 * len(batch_s)))],
        "transfers": {"before": transfers0, "after": dict(api.TRANSFERS)},
        "applies": svc.state()["applies"],
    }


def serve_small(device, tiers):
    """(a) bench.py's serve leg at its defaults, untiered or with the
    benchmark's admin tiers layered over it (then one ANP delta more);
    the differential gate verify_parity at the end."""
    from cyclonus_tpu_torch.serve import VerdictService
    from cyclonus_tpu_torch.synthetic import build_synthetic
    from cyclonus_tpu_torch.tiers.model import (
        AdminNetworkPolicy, TierRule, TierScope,
    )
    from cyclonus_tpu_torch.kube.netpol import LabelSelector
    from cyclonus_tpu_torch.worker.model import Delta

    label = "serve 1,024" + (" tiered" if tiers else "")
    rng = random.Random(SERVE_SEED)
    pods, namespaces, policies = build_synthetic(SERVE_PODS, SERVE_POLICIES, rng)
    t0 = time.perf_counter()
    svc = VerdictService(pods, namespaces, policies, device=device, tiers=tiers)
    build_s = time.perf_counter() - t0
    extra = ()
    if tiers:
        anp = AdminNetworkPolicy(
            name="serve-deny-tier3", priority=7,
            subject=TierScope(pod_selector=LabelSelector.make({"tier": "tier3"})),
            ingress=[TierRule(action="Deny", peers=[TierScope(
                pod_selector=LabelSelector.make({"app": "app4"}))])],
        )
        extra = [("anp", [Delta(kind="anp_upsert", name=anp.name, policy=anp.to_dict())])]
    out = {"pods": SERVE_PODS, "policies": SERVE_POLICIES, "deltas": SERVE_DELTAS,
           "tiers": svc.state()["tiers"], "build_s": build_s,
           "full_rebuild_s": svc.state()["last_full_rebuild_s"]}
    out.update(serve_stream(svc, rng, label, extra=extra))
    t0 = time.perf_counter()
    out["parity"] = svc.verify_parity(oracle_samples=32)
    out["parity_s"] = time.perf_counter() - t0
    return out


def serve_headline(device):
    """(b) the headline cluster: the same stream plus a namespace-label
    delta and two policy deltas (an update and a create), a
    4,096-query batch, and parity against a fresh engine (pairs, the
    oracle, and the dense counts, whose kernel K1 must launch after the
    patch)."""
    import numpy as np

    from cyclonus_tpu_torch.engine import PortCase, TorchPolicyEngine
    from cyclonus_tpu_torch.engine import packed_kernel as pk
    from cyclonus_tpu_torch.engine.tiled import _precompute
    from cyclonus_tpu_torch.kube.yaml_io import policy_to_dict
    from cyclonus_tpu_torch.matcher.tiered import tiered_oracle_verdicts
    from cyclonus_tpu_torch.oracle import traffic_for_cell
    from cyclonus_tpu_torch.serve import VerdictService
    from cyclonus_tpu_torch.synthetic import build_synthetic
    from cyclonus_tpu_torch.worker.model import Delta

    label = "serve 100,000"
    rng = random.Random(SEED)
    pods, namespaces, policies = build_synthetic(N_PODS, N_POLICIES, rng)
    t0 = time.perf_counter()
    svc = VerdictService(pods, namespaces, policies, device=device)
    build_s = time.perf_counter() - t0
    eng = svc.engine
    cases = [PortCase(80, "serve-80-tcp", "TCP"), PortCase(81, "serve-81-udp", "UDP")]
    # the steady state before the patch: fused, split, steady
    modes, pre_counts, counts_s = [], None, []
    for _ in range(3):
        t0 = time.perf_counter()
        pre_counts = eng.evaluate_grid_counts(cases)
        counts_s.append(time.perf_counter() - t0)
        modes.append(eng.pre_cache_stats()["mode"])
    if modes != ["fused", "split", "steady"]:
        raise AssertionError(f"{label}: counts modes before the patch {modes}")
    pinned = eng.pre_cache_stats()["pinned_bytes"]

    update = policy_to_dict(policies[0])
    update["spec"]["podSelector"] = {"matchLabels": {"app": "app7"}}
    create = {
        "apiVersion": "networking.k8s.io/v1", "kind": "NetworkPolicy",
        "metadata": {"name": "serve-new", "namespace": "ns1"},
        "spec": {"podSelector": {"matchLabels": {"app": "app3"}}, "policyTypes": ["Ingress"],
                 "ingress": [{"from": [{"podSelector": {"matchLabels": {"tier": "tier2"}}}],
                              "ports": [{"protocol": "TCP", "port": 80}]}]},
    }
    ns0 = dict(namespaces["ns0"], team="team3")
    extra = [
        ("ns_labels", [Delta(kind="ns_labels", namespace="ns0", labels=ns0)]),
        ("policy_update", [Delta(kind="policy_upsert", namespace=policies[0].namespace,
                                 name=policies[0].name, policy=update)]),
        ("policy_create", [Delta(kind="policy_upsert", namespace="ns1", name="serve-new",
                                 policy=create)]),
    ]
    out = {"pods": N_PODS, "policies": N_POLICIES, "deltas": SERVE_DELTAS + 3,
           "build_s": build_s, "full_rebuild_s": svc.state()["last_full_rebuild_s"],
           "counts_s_before_patch": dict(zip(modes, counts_s)),
           "pinned_bytes_before_patch": pinned}
    out.update(serve_stream(svc, rng, label, extra=extra))
    if svc.engine is not eng:
        raise AssertionError(f"{label}: the service rebuilt its engine")

    # throughput: one 4,096-query batch over both port cases, 5 times
    keys = list(svc.pods)
    batch = serve_queries(rng, keys, SERVE_BATCH)
    times = []
    for _ in range(6):
        t0 = time.perf_counter()
        verdicts = svc.query(batch)
        times.append(time.perf_counter() - t0)
    times = times[1:]
    if any(v.error for v in verdicts):
        raise AssertionError(f"{label}: a batch query failed")
    share, top = device_time_profile(lambda: svc.query(batch), reps=3)
    out.update({"batch_queries": SERVE_BATCH, "batch_s": times,
                "queries_per_sec": SERVE_BATCH / statistics.median(times),
                "batch_device_busy_share": share, "batch_device_top": top})

    # parity against a fresh engine of the post-delta state
    t0 = time.perf_counter()
    pods_now = list(svc.pods.values())
    fresh = TorchPolicyEngine(svc._policy, pods_now, svc.namespaces, device=device, compact=False)
    out["fresh_build_s"] = time.perf_counter() - t0
    pick = random.Random(SEED + 1)
    pairs = [(pick.randrange(len(pods_now)), pick.randrange(len(pods_now)))
             for _ in range(SERVE_PAIRS)]
    key_of = [f"{p[0]}/{p[1]}" for p in pods_now]
    inc_pairs = [(svc._pod_idx[key_of[s]], svc._pod_idx[key_of[d]]) for s, d in pairs]
    got = eng.evaluate_pairs(cases, inc_pairs)
    want = fresh.evaluate_pairs(cases, pairs)
    if not np.array_equal(got, want):
        raise AssertionError(f"{label}: pairs differ from a fresh engine in "
                             f"{int((got != want).sum())} cells")
    for i in range(SERVE_ORACLE):
        q = i % len(cases)
        s, d = pairs[i]
        o = tiered_oracle_verdicts(svc._policy, None,
                                   traffic_for_cell(pods_now, svc.namespaces, cases[q], s, d))
        if tuple(bool(x) for x in want[i, q]) != tuple(o):
            raise AssertionError(f"{label}: pair {pairs[i]} case {cases[q]} differs from the oracle")
    launched = pk.LAUNCHES["packed_counts"]
    t0 = time.perf_counter()
    counts = eng.evaluate_grid_counts(cases)
    counts_s_after = time.perf_counter() - t0
    mode_after = eng.pre_cache_stats()["mode"]
    k1_after = pk.LAUNCHES["packed_counts"] - launched
    # the serve path's own launches, read before the checks below launch more
    out["launches"] = launch_counts()
    if k1_after != 1 or mode_after != "fused":
        raise AssertionError(f"{label}: post-patch counts call {mode_after}, K1 launched {k1_after}")
    fresh_counts = fresh.evaluate_grid_counts(cases)
    if counts != fresh_counts:
        raise AssertionError(f"{label}: patched counts {counts} != fresh {fresh_counts}")
    del fresh
    # the same counts through the class route (K2 over the classes), and
    # K1 against its plain version at the patched engine's own operands
    t0 = time.perf_counter()
    fresh_cls = TorchPolicyEngine(svc._policy, pods_now, svc.namespaces, device=device,
                                  class_compress="1")
    class_counts = fresh_cls.evaluate_grid_counts(cases)
    if fresh_cls.pod_classes() is None or not fresh_cls._class_counts_eligible(len(cases)):
        raise AssertionError(f"{label}: the fresh class engine did not take the class route")
    if counts != class_counts:
        raise AssertionError(f"{label}: patched counts {counts} != class route {class_counts}")
    class_s = time.perf_counter() - t0
    del fresh_cls
    t0 = time.perf_counter()
    pre = _precompute(eng._dense_counts_tensors(cases), True)
    args, _tier, _got, err = check_packed(pre, eng.n_pods, None,
                                          f"{label}: K1 at the patched engine's operands")
    k1_plain = {"we": int(args[0].shape[0]), "wi": int(args[3].shape[0]),
                "ns": int(args[0].shape[1]), "nd": int(args[3].shape[1]), "max_abs_err": err,
                "check_s": time.perf_counter() - t0}
    del pre, args
    log(f"{label}: K1 equal to plain at the patched engine's operands {k1_plain} "
        f"(tolerance: exact)")
    out.update({"pairs_checked": SERVE_PAIRS * len(cases), "oracle_checked": SERVE_ORACLE,
                "counts_before": pre_counts, "counts_after": counts,
                "counts_equal_fresh": True, "counts_equal_class_route": True,
                "class_route_check_s": class_s, "k1_vs_plain": k1_plain,
                "counts_mode_after": mode_after, "counts_s_after_patch": counts_s_after,
                "k1_launches_after_patch": k1_after})
    return out


def phase_serve(device):
    """The verdict service on the card: (a) bench.py's serve leg, untiered
    and tiered, (b) the headline cluster.  Returns the serve path's
    kernel launches, counted from zero over the phase, and the headline
    service's counts before its patch (the main path's untiered counts
    must equal them)."""
    import torch

    from cyclonus_tpu_torch.engine import dense_kernel as dk
    from cyclonus_tpu_torch.engine import packed_kernel as pk
    from cyclonus_tpu_torch.synthetic import bench_tiers

    pk.reset_launches()
    dk.reset_launches()
    for tiers in (None, bench_tiers()):
        out = serve_small(device, tiers)
        log(json.dumps({"serve": {"card": card_info(), "size": "bench", **out}}))
    torch.cuda.empty_cache()
    out = serve_headline(device)
    launches = out["launches"]
    log(json.dumps({"serve": {"card": card_info(), "size": "headline", **out}}))
    if launches["packed_counts"] < 1:
        raise AssertionError(f"serve: K1 never launched: {launches}")
    torch.cuda.empty_cache()
    return launches, out["counts_before"]


#: the CIDR legs: bench.py's cidr leg at its defaults (pods, distinct
#: CIDRs, IP pool) and the acceptance shape of the reference's TSS stage
#: over 4,096 pods, both from bench.py's seed
CIDR_LEGS = (("bench", 1024, 512, 64), ("acceptance", 4096, 100_000, 4096))
CIDR_SEED = 424242
#: evaluate_pairs cells of each CIDR leg (on the TSS and the dense
#: engine) held against the scalar oracle
CIDR_ORACLE = 256
#: the analyze leg's audit / self-diff cluster: the synthetic generator at
#: 4,096 pods (2 x 4,096^2 cells, half the audit's cell cap) with one
#: policy per 100 pods, which keeps the audit's int32 numpy products
#: (rules x 4,096 x 8,192 multiply-adds each) to tens of seconds
AUDIT_PODS, AUDIT_POLICIES = 4096, 41
EXAMPLES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "examples")


_ORACLE = {}


def _oracle_init(policy, pods, namespaces, cases):
    """A pool worker's copy of the oracle's inputs, sent once."""
    _ORACLE.update(policy=policy, pods=pods, namespaces=namespaces, cases=cases)


def _oracle_cells(cells):
    """The scalar oracle's (ingress, egress, combined) of each (q, src,
    dst) cell, in a pool worker."""
    from cyclonus_tpu_torch.analysis.oracle import oracle_verdicts
    from cyclonus_tpu_torch.oracle import traffic_for_cell

    o = _ORACLE
    return [
        oracle_verdicts(o["policy"], traffic_for_cell(o["pods"], o["namespaces"], o["cases"][q], s, d))
        for q, s, d in cells
    ]


def pairs_vs_oracle(engines, policy, pods, namespaces, cases, n, rng, label):
    """n evaluate_pairs cells (a random pair each, the port cases in
    turn) of each engine against the scalar oracle, which scans every
    ipBlock peer of a cell in Python (about 0.5 s a cell at 100,000
    CIDRs): it runs in one spawned process a CPU core, and every process
    ends with the call."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    pairs = [(rng.randrange(len(pods)), rng.randrange(len(pods))) for _ in range(n)]
    cells = [(i % len(cases), s, d) for i, (s, d) in enumerate(pairs)]
    workers = max(1, min(8, os.cpu_count() or 1))
    chunks = [cells[i::workers] for i in range(workers)]
    with ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn"),
                             initializer=_oracle_init,
                             initargs=(policy, pods, namespaces, cases)) as pool:
        results = list(pool.map(_oracle_cells, chunks))
    want = {}
    for chunk, res in zip(chunks, results):
        want.update(zip(chunk, res))
    for eng in engines:
        got = eng.evaluate_pairs(cases, pairs)
        for i, cell in enumerate(cells):
            if tuple(bool(x) for x in got[i, cell[0]]) != want[cell]:
                raise AssertionError(f"{label}: pair {cell[1:]} case {cases[cell[0]]} "
                                     "differs from the oracle")


def min_s(fn, reps=5):
    """Min host-clock seconds of `reps` calls of fn (each ends in a host
    read, so the device has finished)."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return min(times)


def cidr_leg(device, leg, n_pods, distinct, pool, cases):
    """One CIDR leg: the TSS engine (class route, K2) against the bit-path
    engine and the class_compress="0" engine (K1), the device LPM against
    its numpy twin, pairs against the oracle; at the acceptance shape also
    K1 and K2 against their plain versions at the leg's operands."""
    import numpy as np
    import torch

    from cyclonus_tpu_torch.engine import TorchPolicyEngine
    from cyclonus_tpu_torch.engine import packed_kernel as pk
    from cyclonus_tpu_torch.engine.tiled import _precompute, class_rowsums_plan
    from cyclonus_tpu_torch.matcher import build_network_policies
    from cyclonus_tpu_torch.synthetic import cidr_cluster

    label = f"cidr {leg}"
    t0 = time.perf_counter()
    pods, namespaces, policies = cidr_cluster(n_pods, distinct, pool, random.Random(CIDR_SEED))
    policy = build_network_policies(True, policies)
    out = {"leg": leg, "pods": n_pods, "requested_distinct": distinct, "ip_pool": pool,
           "policies": len(policies), "generate_s": time.perf_counter() - t0}
    # bench.py's leg forces both stages; the acceptance shape runs the
    # defaults, which must engage them on their own
    kw = {"class_compress": "1", "cidr_tss": "1"} if leg == "bench" else {}
    launched = launch_counts()
    t0 = time.perf_counter()
    eng = TorchPolicyEngine(policy, pods, namespaces, device=device, **kw)
    out["build_s"] = time.perf_counter() - t0
    st = eng.cidr_stats()
    out["cidr_stats"] = st
    out["classes_tss"] = eng.class_compression_stats()["classes"]
    if not st["active"] or eng.pod_classes() is None:
        raise AssertionError(f"{label}: the TSS stage did not engage: {st}")
    if not eng._class_counts_eligible(len(cases)):
        raise AssertionError(f"{label}: the TSS engine did not take the class route")
    if leg != "bench" and st["device"] is not True:
        raise AssertionError(f"{label}: the LPM stage did not run on the device: {st}")
    # the device LPM against its numpy twin on the same IPs
    space = eng._class_state["cidr"]
    t = eng._tensors
    ip, valid = t["pod_ip"][:n_pods], t["pod_ip_valid"][:n_pods]
    dev_sig = space.signature_device(ip, valid)
    host_sig = space.signature_host(ip, valid)
    if dev_sig.dtype != np.int32 or not np.array_equal(dev_sig, host_sig):
        raise AssertionError(f"{label}: device LPM signature differs from the numpy twin")
    out["lpm_device_s"] = min_s(lambda: space.signature_device(ip, valid))
    out["lpm_host_s"] = min_s(lambda: space.signature_host(ip, valid), reps=1)
    t0 = time.perf_counter()
    counts = eng.evaluate_grid_counts(cases)
    out["first_counts_s"] = time.perf_counter() - t0
    out["steady_counts_s"] = min_s(lambda: eng.evaluate_grid_counts(cases))
    k2 = launch_counts()["packed_rowsums"] - launched["packed_rowsums"]
    if k2 < 1:
        raise AssertionError(f"{label}: the class route did not launch K2")
    # the pre-TSS bit path, and the dense route (K1)
    t0 = time.perf_counter()
    bit = TorchPolicyEngine(policy, pods, namespaces, device=device, class_compress="1",
                            cidr_tss="0")
    out["build_bit_s"] = time.perf_counter() - t0
    out["classes_bit"] = bit.class_compression_stats()["classes"]
    if bit.cidr_stats()["active"]:
        raise AssertionError(f"{label}: cidr_tss=0 engaged the TSS stage")
    counts_bit = bit.evaluate_grid_counts(cases)
    del bit
    launched_k1 = launch_counts()["packed_counts"]
    t0 = time.perf_counter()
    dense = TorchPolicyEngine(policy, pods, namespaces, device=device, class_compress="0")
    out["build_dense_s"] = time.perf_counter() - t0
    counts_dense = dense.evaluate_grid_counts(cases)
    out["steady_dense_counts_s"] = min_s(lambda: dense.evaluate_grid_counts(cases))
    if launch_counts()["packed_counts"] - launched_k1 < 1:
        raise AssertionError(f"{label}: the dense route did not launch K1")
    if not counts == counts_bit == counts_dense:
        raise AssertionError(f"{label}: counts TSS {counts}, bit path {counts_bit}, "
                             f"dense {counts_dense} differ")
    if counts["cells"] != len(cases) * n_pods * n_pods:
        raise AssertionError(f"{label}: implausible counts {counts}")
    out["counts"] = counts
    out["launches"] = {k: v - launched[k] for k, v in launch_counts().items()}
    t0 = time.perf_counter()
    pairs_vs_oracle((eng, dense), policy, pods, namespaces, cases, CIDR_ORACLE,
                    random.Random(CIDR_SEED + 1), label)
    out["oracle_cells"] = CIDR_ORACLE
    out["oracle_s"] = time.perf_counter() - t0
    if leg != "bench":
        # K1 and K2 against their plain versions at this leg's operands
        t0 = time.perf_counter()
        pre = _precompute(dense._dense_counts_tensors(cases), True)
        _a, _t, _g, err1 = check_packed(pre, n_pods, None, f"{label}: K1 at the leg's operands")
        del pre
        tens = eng._with_cases(eng._class_dev(), cases)
        pc = eng.pod_classes()
        w = torch.from_numpy(class_rowsums_plan(tens, pc.n_classes, pc.class_size)[0]).to(device)
        pre = _precompute(tens, True)
        _a, _t, _g, err2 = check_packed(pre, int(tens["pod_ns_id"].shape[0]), w,
                                        f"{label}: K2 at the leg's operands")
        del pre, tens
        out["plain_checks"] = {"k1_max_abs_err": err1, "k2_max_abs_err": err2,
                               "seconds": time.perf_counter() - t0}
    del eng, dense
    torch.cuda.empty_cache()
    log(f"{label}: counts equal on the TSS class route (K2), the bit path and the "
        f"dense route (K1): {json.dumps(counts)}")
    return out


def analyze_cli(argv):
    """(exit code, stdout) of one in-process `analyze` run of the port."""
    import io

    from cyclonus_tpu_torch.cli import main as cli_main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(["analyze"] + argv)
    return rc, buf.getvalue()


def analyze_leg(device):
    """Every `analyze` mode on the card against --device cpu, byte for
    byte; then the audit and a self-diff at AUDIT_PODS pods on the card."""
    from cyclonus_tpu_torch.analysis import audit_policy_set, diff_policy_sets
    from cyclonus_tpu_torch.engine import PortCase, TorchPolicyEngine
    from cyclonus_tpu_torch.kube.labels import is_labels_match_label_selector
    from cyclonus_tpu_torch.matcher import build_network_policies
    from cyclonus_tpu_torch.synthetic import build_synthetic

    base = ["--policy-path", SIMPLE_EXAMPLE]
    modes = [
        ["--mode", "parse"],
        ["--mode", "explain"],
        ["--mode", "lint"],
        ["--mode", "audit"],
        ["--mode", "diff", "--policy-path2",
         os.path.join(EXAMPLES, "networkpolicies", "getting-started")],
        ["--mode", "query-target", "--target-pod-path", os.path.join(EXAMPLES, "targets.json")],
        ["--mode", "query-traffic", "--traffic-path", os.path.join(EXAMPLES, "traffic.json")],
        ["--mode", "probe", "--probe-path", os.path.join(EXAMPLES, "probe.json"),
         "--engine", "cuda"],
    ]
    out = {"card": card_info(), "cli": []}
    for argv in modes:
        t0 = time.perf_counter()
        rc, text = analyze_cli(base + argv)
        card_s = time.perf_counter() - t0
        rc_cpu, text_cpu = analyze_cli(base + argv + ["--device", "cpu"])
        if rc != 0 or rc_cpu != 0 or text != text_cpu or not text:
            raise AssertionError(f"analyze {argv[1]}: card output (rc {rc}, {len(text)} bytes) "
                                 f"!= --device cpu (rc {rc_cpu}, {len(text_cpu)} bytes)")
        out["cli"].append({"mode": argv[1], "bytes": len(text), "seconds": card_s})
    log(f"analyze: {len(modes)} modes, stdout on the card equal to --device cpu")

    pods, namespaces, policies = build_synthetic(AUDIT_PODS, AUDIT_POLICIES, random.Random(SEED))
    policy = build_network_policies(True, policies)
    cases = [PortCase(80, "serve-80-tcp", "TCP"), PortCase(81, "serve-81-udp", "UDP")]
    t0 = time.perf_counter()
    eng = TorchPolicyEngine(policy, pods, namespaces, device=device)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    report = audit_policy_set(policy, pods, namespaces, cases, engine=eng)
    audit_s = time.perf_counter() - t0
    kinds = {}
    for f in report.findings:
        kinds[f.kind] = kinds.get(f.kind, 0) + 1
    if report.oracle_checked != len(report.findings):
        raise AssertionError(f"audit: {report.oracle_checked} of {len(report.findings)} "
                             "findings oracle-checked")
    out["audit"] = {"pods": AUDIT_PODS, "policies": AUDIT_POLICIES, "cells": report.cells,
                    "rules": report.n_rules, "findings": kinds,
                    "oracle_checked": report.oracle_checked, "build_s": build_s,
                    "seconds": audit_s, **{f"{k}_s": v for k, v in report.seconds.items()}}
    del eng

    # a self-diff with one policy removed: the first policy whose target
    # (namespace, selector) no other policy shares and which selects pods
    def target_of(p):
        return (p.namespace, json.dumps(p.spec.pod_selector.to_dict(), sort_keys=True))

    keys = [target_of(p) for p in policies]
    pick = next(
        i for i, p in enumerate(policies)
        if keys.count(keys[i]) == 1 and any(
            ns == p.namespace and is_labels_match_label_selector(labels, p.spec.pod_selector)
            for ns, _n, labels, _ip in pods
        )
    )
    removed = policies[pick]
    policy_b = build_network_policies(True, policies[:pick] + policies[pick + 1:])
    selected = {
        f"{ns}/{name}" for ns, name, labels, _ip in pods
        if ns == removed.namespace
        and is_labels_match_label_selector(labels, removed.spec.pod_selector)
    }
    t0 = time.perf_counter()
    diff = diff_policy_sets(policy, policy_b, pods, namespaces, cases, max_cells=4096,
                            device=device)
    diff_s = time.perf_counter() - t0
    if diff.equivalent:
        raise AssertionError(f"diff: removing {removed.namespace}/{removed.name} changed nothing")
    types = removed.spec.policy_types
    for c in diff.cells:
        # an ingress change lies on the removed target's destinations,
        # an egress change on its sources
        ing = c.a[0] != c.b[0]
        eg = c.a[1] != c.b[1]
        if (ing and (c.dst not in selected or "Ingress" not in types)) or (
            eg and (c.src not in selected or "Egress" not in types)
        ) or not (ing or eg):
            raise AssertionError(f"diff: cell {c} lies outside {removed.namespace}/{removed.name}")
    bound = len(selected) * AUDIT_PODS * len(cases)
    if diff.n_diff["ingress"] > bound or diff.n_diff["egress"] > bound:
        raise AssertionError(f"diff: {diff.n_diff} exceeds the removed target's {bound} cells")
    out["diff"] = {"removed": f"{removed.namespace}/{removed.name}", "selected_pods": len(selected),
                   "n_diff": diff.n_diff, "cells_checked": len(diff.cells),
                   "oracle_checked": diff.oracle_checked, "seconds": diff_s}
    log(f"analyze: audit {json.dumps(kinds)} in {audit_s:.2f} s; self-diff localised to "
        f"{removed.namespace}/{removed.name}: {json.dumps(diff.n_diff)}")
    return out


def phase_cidr_analyze(device):
    """The CIDR legs and the analyze leg.  Returns the CIDR legs' kernel
    launches: each leg reads the counts just before its engines and just
    after its counts calls, before its plain-version checks launch more."""
    from cyclonus_tpu_torch.engine import PortCase

    cases = [PortCase(80, "serve-80-tcp", "TCP"), PortCase(81, "serve-81-udp", "UDP")]
    launches = {}
    for leg, n_pods, distinct, pool in CIDR_LEGS:
        out = cidr_leg(device, leg, n_pods, distinct, pool, cases)
        log(json.dumps({"cidr": {"card": card_info(), **out}}))
        for k, v in out["launches"].items():
            launches[k] = launches.get(k, 0) + v
    log(json.dumps({"analyze": analyze_leg(device)}))
    return launches


def live_target_bits(tmatch_pk, has, valid):
    """Target bits of one direction of the packed plan that hold data, as
    `live_target_rows` counts K4's rows over the same targets: the bits of
    the packed match operand tmatch_pk [W, N] int32 set for some valid pod,
    plus one where some valid pod has no target (the has flag, K4's pseudo
    row)."""
    import torch

    words = torch.where(valid[None, :], tmatch_pk, torch.zeros_like(tmatch_pk))
    bits = sum(int(((words >> b) & 1).ne(0).any(dim=1).sum()) for b in range(32))
    return bits + int((valid & ~has).any())


def bound(args, w_dst, out, valid_src, valid_dst, tier=None, tier_work=(0, 0)):
    """(ms, bound_by, ops, bytes): the least time the card could take for one
    packed counts call on these inputs — the larger of bytes (each input
    read once, the output written once) over HBM bandwidth and the
    operations' time — and the two counts.  The operations' time is the
    least of three ways to run the same contraction, plus the tier work:
      * on the integer pipe: one LOP3 per packed word, cell and direction,
        EPILOGUE_CELL_OPS per cell and the rest of the epilogue per 32
        cells (the weighted one per cell as well), over PEAK_INT_OPS;
      * on the int8 tensor cores: two operations per (valid cell, target
        bit that holds data) over PEAK_INT8_OPS, the bits counted per
        direction by `live_target_bits` (the count `dense_bound` takes for
        K4 on the same targets);
      * on the single-bit tensor cores: the same operations over
        PEAK_B1_OPS, the rate measured for the instruction the kernels
        use (the data sheet gives none);
    tiered, plus TIER_ROW_OPS per live row and 32 cells it matches and
    LATTICE_WORD_OPS per 32 matched cells and direction, as 32-bit mask
    logic on the integer pipe (a cell that no live row matches needs no
    tier work), and the bytes of `tier` (the input tier rows and keys).
    `tier_work` is this run's (matched (row, cell) pairs, matched cells)
    from `tier_work`.  The returned count is the integer instructions or
    the tensor-core operations, whichever way was fastest, plus the tier
    instructions."""
    tmatch_e_pk, has_e, tallow_e_pk, tmatch_i_pk, has_i, _tallow_i_pk = args
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
    int_ops = cells * (we + wi + per_cell) + per_word * cells / 32
    live = live_target_bits(tmatch_e_pk, has_e, valid_src) + live_target_bits(
        tmatch_i_pk, has_i, valid_dst)
    tc_ops = 2 * q * int(valid_src.sum()) * int(valid_dst.sum()) * live
    n_ops, ops_s = min((int_ops, int_ops / PEAK_INT_OPS), (tc_ops, tc_ops / PEAK_INT8_OPS),
                       (tc_ops, tc_ops / PEAK_B1_OPS), key=lambda c: c[1])
    if tier is not None:
        nbytes += sum(a.numel() * a.element_size() for t in tier.values() for a in t.values())
        row_cells, tier_cells = tier_work
        tier_ops = (TIER_ROW_OPS * row_cells + LATTICE_WORD_OPS * tier_cells) / 32
        n_ops += tier_ops
        ops_s += tier_ops / PEAK_INT_OPS
    by = "operations" if ops_s >= nbytes / PEAK_BYTES else "bytes"
    return max(ops_s, nbytes / PEAK_BYTES) * 1e3, by, n_ops, nbytes


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


def check_packed(pre, n_pods, w_dst, what):
    """Hold the packed counts kernel against its plain version on a
    precompute's packed operands (tiered when it carries tiers); returns
    (kernel arguments, tier, kernel result, max abs error)."""
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
    check_kernel(got, want, what)
    return args, tier, got, float((got.double() - want.double()).abs().max())


def kernel_record(name, replaces, pre, n_pods, w_dst, launches):
    """Hold the kernel against its plain version on the main path's
    inputs (tiered when the precompute carries tiers) and time both."""
    from cyclonus_tpu_torch.engine import packed_kernel as pk

    args, tier, got, max_abs_err = check_packed(pre, n_pods, w_dst,
                                                f"{name}, the main-path shapes")
    valid_src, valid_dst, bs, bd = pk._resolve(
        args[0], args[3], n_pods, None, None, None, None
    )
    ops = pk._packed_operands(*args, valid_src, valid_dst, tier, w_dst, bs, bd)
    ms = time_ms(lambda: pk._counts_cuda(ops, bs), reps=5, warm=1)
    plain_ms = time_ms(lambda: pk._counts_plain(ops, bs), reps=1, warm=0)
    work = (0, 0) if tier is None else tier_work(tier, valid_src, valid_dst)
    b_ms, b_by, b_ops, b_bytes = bound(args, w_dst, got, valid_src, valid_dst, tier, work)
    items = packed_items(ops)
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
        "items": items,
        **pk.kernel_attrs()[name],
    }
    shape = {
        "q": int(args[2].shape[2]), "we": int(args[0].shape[0]), "wi": int(args[3].shape[0]),
        "ns": int(args[0].shape[1]), "nd": int(args[3].shape[1]), "items": items,
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


#: the six port cases of the benchmark's churn-allports traffic
ALLPORT_CASES = [(port, f"serve-{port}-{proto.lower()}", proto)
                 for proto in ("TCP", "UDP", "SCTP") for port in (80, 81)]


def live_targets_record(device, policy, pods, namespaces, cases):
    """The live-target pass (packed_kernel.live_targets) on the operands
    that K1 contracts at compact=False, the verdict service's encoding,
    at `cases` and at ALLPORT_CASES: its kernels against their plain
    versions bit for bit, both directions compacted, K1's counts kept, and
    the kernels timed beside their bytes bound (each operand read once,
    the live words and the compacted copies written once)."""
    import torch

    from cyclonus_tpu_torch.engine import PortCase, TorchPolicyEngine
    from cyclonus_tpu_torch.engine import packed_kernel as pk

    eng = TorchPolicyEngine(policy, pods, namespaces, device=device, class_compress="0",
                            compact=False)
    runs = []
    for qcases in (cases, [PortCase(*c) for c in ALLPORT_CASES]):
        ops = eng._kernel_operands(eng._dense_pre(qcases))
        (q, _nd, de), di = ops["b_e"].shape, ops["b_i"].shape[2]
        pk.reset_launches()
        small = pk.live_targets(ops)
        torch.cuda.synchronize()
        launches = pk.LAUNCHES["live_targets"]
        if launches != 1:
            raise AssertionError(f"live_targets, Q={q}: launches {pk.LAUNCHES}")
        live = pk._live_words(ops["a_e"], ops["a_i"])
        check_kernel(live, torch.cat([pk._or_rows(ops["a_e"]), pk._or_rows(ops["a_i"])]),
                     f"live_or_kernel, Q={q}")
        depth = {"egress": small["a_e"].shape[1], "ingress": small["a_i"].shape[1]}
        if not (depth["egress"] < de and depth["ingress"] < di):
            raise AssertionError(f"live_targets, Q={q}: depths {de}, {di} -> {depth}")
        words = {"egress": live[:de], "ingress": live[de:]}
        jobs = {name: (ops[name], words[d], depth[d])
                for d, pair in pk._DIRECTIONS.items() for name in pair}
        for name, job in jobs.items():
            check_kernel(small[name], pk.gather_live_plain(*job),
                         f"live_gather_kernel {name}, Q={q}")
        check_kernel(pk._counts_cuda(small, small["bs"]), pk._counts_cuda(ops, ops["bs"]),
                     f"K1 over the compacted operands, Q={q}")
        todo = list(jobs.values())
        ms = time_ms(lambda: pk._gather_live_cuda(todo) + [pk._live_words(ops["a_e"], ops["a_i"])])
        plain_ms = time_ms(lambda: [pk._or_rows(ops["a_e"]), pk._or_rows(ops["a_i"])]
                           + [pk.gather_live_plain(*job) for job in todo], reps=1, warm=1)
        nbytes = sum(4 * (a.numel() + a.numel() // a.shape[-1] * dc) for a, _lv, dc in todo)
        nbytes += 4 * (ops["a_e"].numel() + ops["a_i"].numel() + de + di)
        run = {"q": q, "depth": [de, di], "launched": [depth["egress"], depth["ingress"]],
               "live": [int(pk._live_positions(words[d]).numel()) for d in depth],
               "launches": launches, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": nbytes / PEAK_BYTES * 1e3, "bytes": nbytes}
        log(f"live_targets: {ms:.3f} ms (bound {run['bound_ms']:.3f} ms: {nbytes:.4e} bytes; "
            f"plain {plain_ms:.1f} ms) at {run}, equal to plain (tolerance: exact)")
        runs.append(run)
        del ops, small, live, jobs, todo
    del eng
    torch.cuda.empty_cache()
    first = runs[0]
    return {
        "name": "live_targets", "route": "cuda", "source": "cyclonus_tpu_torch/csrc/packed_counts.cu",
        "replaces": None, "launches": sum(r["launches"] for r in runs), "max_abs_err": 0.0,
        "ms": first["ms"], "plain_ms": first["plain_ms"], "bound_ms": first["bound_ms"],
        "bound_by": "bytes", "library_ms": None,
        "instance": "live_or_kernel, live_gather_kernel", "runs": runs,
    }


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


def launch_counts():
    """Every kernel's launch count, both modules."""
    from cyclonus_tpu_torch.engine import dense_kernel as dk
    from cyclonus_tpu_torch.engine import packed_kernel as pk

    return {**dk.LAUNCHES, **pk.LAUNCHES}


@contextlib.contextmanager
def env(**values):
    """Environment variables set for the block, restored after it."""
    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def steady_figures(eng, cases, first_s, want, label, expect, kernel=None, make=None,
                   steady_reps=5):
    """The figures of one counts leg after its first call (first_s
    seconds, counts `want`), every count held equal to the first call's:
    the second call; the steady state as bench.py takes it, the min of
    `steady_reps` calls after those two (host clock, the counts' readback
    included); counts_pipelined_eval_s with 10 launches; the device busy
    share of 3 calls; and, with `make` (a function that builds the leg's engine), a
    fresh engine under CYCLONUS_PRE_CACHE=0: its first call and min of 5.

    `expect` says what the engine's counters must show: "steady" (the
    second call splits and pins; each later call adds one hit, runs no
    precompute and launches `kernel` once and nothing else), "autotune"
    (the same, with the first steady-state call running the slab autotune
    once; `kernel` is then its winner's), "declined" (the reference's byte
    gate keeps the key off the cache: every call fused, nothing pinned,
    no pipelined figure) or None (a route with no cache)."""
    from cyclonus_tpu_torch.engine import api as port_api

    cells = len(cases) * eng.n_pods ** 2

    def call(engine=eng):
        t0 = time.perf_counter()
        got = engine.evaluate_grid_counts(cases)
        dt = time.perf_counter() - t0
        if got != want:
            raise AssertionError(f"{label}: counts {got} != the first call's {want}")
        return dt

    def ran_since(before):
        # the counts kernels alone: the live-target pass before a packed
        # launch has its own entry
        return {k: v - before[k] for k, v in launch_counts().items() if k != "live_targets"}

    cached = expect in ("steady", "autotune")
    out = {"encode_s": eng.encode_s, "first_call_s": first_s}
    before = launch_counts()
    out["second_call_s"] = call()
    st = eng.pre_cache_stats()
    if cached:
        if st["mode"] != "split" or not st["pinned"] or sum(ran_since(before).values()) != 1:
            raise AssertionError(f"{label}: the second call did not split and pin: {st}")
        out["pinned_bytes_split"] = st["pinned_bytes"]
    elif expect == "declined":
        est = eng._pre_bytes_estimate(len(cases))
        if st["mode"] != "fused" or st["pinned"] or est <= port_api._PRE_CACHE_MAX_BYTES:
            raise AssertionError(f"{label}: the key was not declined (estimate {est}): {st}")
        out["estimate_bytes"] = est
    if expect == "autotune":
        out["autotune_call_s"] = call()
        st = eng.pre_cache_stats()
        if st["mode"] != "steady" or st["autotune_searches"] != 1 or st["autotune"]["source"] != "search":
            raise AssertionError(f"{label}: the autotune did not search once: {st}")
        out["autotune"] = st["autotune"]
        kernel = "dense_counts_slab" if st["slab_choice"] else "dense_counts_1chunk"
        out["kernel"] = kernel
    times = []
    for _ in range(steady_reps):
        before, st0 = launch_counts(), eng.pre_cache_stats()
        times.append(call())
        st1 = eng.pre_cache_stats()
        if cached:
            ran = ran_since(before)
            if (st1["mode"] != "steady" or st1["hits"] != st0["hits"] + 1
                    or st1["precomputes"] != st0["precomputes"]
                    or ran != {k: int(k == kernel) for k in ran}):
                raise AssertionError(f"{label}: a steady-state call ran {ran}, "
                                     f"counters {st0} -> {st1}")
        elif expect == "declined" and (st1["mode"] != "fused" or st1["pinned"]):
            raise AssertionError(f"{label}: a declined key was pinned: {st1}")
    out["steady_s"] = min(times)
    out["steady_all_s"] = times
    out["cells_per_s"] = cells / out["steady_s"]
    if cached:
        st = eng.pre_cache_stats()
        out["pinned_bytes"] = st["pinned_bytes"]
        out["slab_ops_bytes"] = st["slab_ops_bytes"]
        if st["autotune_searches"] != (expect == "autotune"):
            raise AssertionError(f"{label}: autotune searches {st['autotune_searches']}")
    piped = eng.counts_pipelined_eval_s(cases, reps=10)
    if (piped is None) != (expect == "declined" or (expect is None and eng.pod_classes() is None)):
        raise AssertionError(f"{label}: pipelined figure {piped} at expect={expect}")
    if piped is not None:
        if piped[1] != want:
            raise AssertionError(f"{label}: pipelined counts {piped[1]} != {want}")
        out["pipelined_s"] = piped[0]
    share, top = device_time_profile(lambda: eng.evaluate_grid_counts(cases))
    out["device_busy_share"] = share
    if make is not None:
        with env(CYCLONUS_PRE_CACHE="0"):
            off = make()
            t0 = time.perf_counter()
            if off.evaluate_grid_counts(cases) != want:
                raise AssertionError(f"{label}, PRE_CACHE=0: counts differ")
            off_first = time.perf_counter() - t0
            off_times = [call(off) for _ in range(5)]
            st = off.pre_cache_stats()
            if st["hits"] or st["pinned"] or st["precomputes"] != 6:
                raise AssertionError(f"{label}, PRE_CACHE=0: the cache engaged: {st}")
            out["pre_cache_off"] = {"encode_s": off.encode_s, "first_call_s": off_first,
                                    "steady_s": min(off_times), "steady_all_s": off_times}
            del off
    figures = {k: out[k] for k in ("first_call_s", "second_call_s", "steady_s") if k in out}
    log(f"{label}: {json.dumps(figures)}, pipelined "
        f"{out.get('pipelined_s', 'none')} s, PRE_CACHE=0 min of 5 "
        f"{out['pre_cache_off']['steady_s'] if make else 'not run'} s, device busy "
        f"{'not measured' if share is None else f'{share:.4f}'}; top kernels ms/call: {top}")
    return out


def route_numbers(eng_a, eng_b, cases, first_a, first_b, counts, label, make_b, kernel_b):
    """Both routes' figures (steady_figures; the class route has no
    cache) and their precompute times; returns (routes dict, class
    precompute inputs, dense precompute)."""
    import torch

    from cyclonus_tpu_torch.engine.tiled import _precompute

    routes = {
        "class": steady_figures(eng_a, cases, first_a, counts, f"{label}, class route", None),
        "dense": steady_figures(eng_b, cases, first_b, counts, f"{label}, dense route",
                                "steady", kernel=kernel_b, make=make_b),
    }
    tens_b = eng_b._dense_counts_tensors(cases)
    pre_b = _precompute(tens_b, True)
    pre_ms_b = time_ms(lambda: _precompute(tens_b, True), reps=3, warm=0)
    tens_a = eng_a._with_cases(eng_a._class_dev(), cases)
    pre_a = _precompute(tens_a, True)
    pre_ms_a = time_ms(lambda: _precompute(tens_a, True), reps=3, warm=0)
    torch.cuda.synchronize()
    routes["class"].update(precompute_ms=pre_ms_a, pod_axis=int(tens_a["pod_ns_id"].shape[0]))
    routes["dense"].update(precompute_ms=pre_ms_b, pod_axis=int(tens_b["pod_ns_id"].shape[0]))
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
                 "tiles": [ops["a_e"].shape[0], ops["a_i"].shape[0]], "items": slab_items(ops)}
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
                 "nz_kept": kept, "items": q * -(-ns // 128) * -(-nd // 256)}
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
#: the kernel the leg's first call must launch, or None for the tile loop,
#: what its steady state must show: steady_figures' `expect`).  K4 and K5
#: are pinned to slab "0": under "auto" on the card their engines would
#: plan the slab and, at K4's first steady-state call, autotune it
DENSE_LEGS = [
    ("dense", False, {"class_compress": "0", "slab": "0"}, "dense_counts_1chunk", "steady"),
    ("chunked", False, {"class_compress": "0", "compact": False, "slab": "0"},
     "dense_counts_chunked", "declined"),
    ("slab", False, {"class_compress": "0", "slab": "1"}, "dense_counts_slab", "steady"),
    ("slab auto", False, {"class_compress": "0", "slab": "auto"}, "dense_counts_1chunk",
     "autotune"),
    ("class", False, {}, None, None),
    ("dense", True, {"class_compress": "0"}, None, None),
    ("class", True, {}, None, None),
]


def phase_dense_plan(device, policy, pods, namespaces, cases, want_plain, want_tiered):
    """The dense dtype plan's main path (pack=False) on the headline
    cluster, once, with every launch count zeroed just before and read
    just after: the dense route through K4, K5 (compaction off) and K6
    (slab forced), the slab "auto" mode (its first call through K4), the
    class route through the tile loop's row sums, and the tiered dense
    and class routes through the tile loop.  Each leg's counts must equal
    the packed plan's (want_plain / want_tiered); each dense kernel must
    have launched, and no packed one.  Then per leg its figures
    (steady_figures: the split call, the steady state, the pipelined
    figure, PRE_CACHE=0; the tiered dense tile loop, 4.5 s a call with no
    cache, one warm call), the slab autotune's record and a second "auto"
    engine that must adopt its persisted winner with no search; per
    kernel the record against its plain version."""
    import torch

    from cyclonus_tpu_torch.engine import TorchPolicyEngine
    from cyclonus_tpu_torch.engine import dense_kernel as dk
    from cyclonus_tpu_torch.engine import packed_kernel as pk
    from cyclonus_tpu_torch.synthetic import bench_tiers

    tiers = bench_tiers()

    def make(tiered, kw):
        return TorchPolicyEngine(policy, pods, namespaces, device=device, pack=False,
                                 tiers=tiers if tiered else None, **kw)

    engines = {}
    pk.reset_launches()
    dk.reset_launches()
    for name, tiered, kw, kernel, expect in DENSE_LEGS:
        key = f"{'tiered ' if tiered else ''}{name}"
        before = dict(dk.LAUNCHES)
        eng = make(tiered, kw)
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
        engines[key] = (eng, tiered, kw, kernel, expect, first)
    launches = {**dict(dk.LAUNCHES), **dict(pk.LAUNCHES)}
    log(f"dense plan launches: {launches}")
    if any(pk.LAUNCHES.values()):
        raise AssertionError(f"dense plan: a packed kernel launched: {pk.LAUNCHES}")
    log(f"dense plan counts: every leg equal to the packed plan (untiered "
        f"{json.dumps(want_plain)}, tiered {json.dumps(want_tiered)})")

    cells = len(cases) * len(pods) ** 2
    legs, records = {}, []
    for key, (eng, tiered, kw, kernel, expect, first) in engines.items():
        want = want_tiered if tiered else want_plain
        label = f"dense plan, {key}"
        if key == "tiered dense":
            # the tile loop over 98 dense tiles: no cache, one warm call
            warm_s = time_ms(lambda e=eng: e.evaluate_grid_counts(cases), reps=1, warm=0) / 1e3
            share, top = device_time_profile(lambda e=eng: e.evaluate_grid_counts(cases), reps=1)
            leg = {"encode_s": eng.encode_s, "first_call_s": first, "warm_s": warm_s,
                   "cells_per_s": cells / warm_s, "device_busy_share": share}
            log(f"{label}: warm {warm_s * 1e3:.2f} ms, device busy "
                f"{'not measured' if share is None else f'{share:.4f}'}; top kernels ms/call: {top}")
        else:
            leg = steady_figures(
                eng, cases, first, want, label, expect, kernel=kernel,
                make=(lambda t=tiered, k=kw: make(t, k)) if expect is not None else None,
            )
        legs[key] = {"kernel": kernel or "tile loop", **leg}
        if kernel == "dense_counts_slab":
            legs[key]["slab_w"] = eng._slab_plan()["w"]
        if expect == "autotune":
            legs[key]["adopted"] = adopt_check(make(tiered, kw), cases, want, leg, label)
        elif kernel is not None:
            records.append(dense_record(kernel, eng, cases, launches[kernel]))
        del eng
        engines[key] = None
        torch.cuda.empty_cache()
    return records, {"legs": legs, "launches": launches}


def adopt_check(eng, cases, want, leg, label):
    """A second slab "auto" engine of the same cluster, on the cache file
    the first one's search wrote: its first steady-state call must adopt
    the persisted winner with no search, and every count must equal."""
    times = []
    for mode in ("fused", "split", "steady", "steady"):
        t0 = time.perf_counter()
        got = eng.evaluate_grid_counts(cases)
        times.append(time.perf_counter() - t0)
        st = eng.pre_cache_stats()
        if got != want or st["mode"] != mode:
            raise AssertionError(f"{label}, adopting: {got} in mode {st['mode']}, want {mode}")
    if st["autotune_searches"] != 0 or st["autotune"]["source"] != "cache" or (
            st["autotune"]["winner"] != leg["autotune"]["winner"]):
        raise AssertionError(f"{label}: the second engine did not adopt the winner: {st}")
    log(f"{label}: a second engine adopted {json.dumps(st['autotune']['winner'])} with no "
        f"search (calls {[round(t, 4) for t in times]} s)")
    return {"winner": st["autotune"]["winner"], "calls_s": times}


def phase_main_path(device):
    import torch

    from cyclonus_tpu_torch.engine import PortCase, TorchPolicyEngine
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
            eng_a, eng_b, cases, first_a, first_b, counts, key,
            lambda tiers=tiers: TorchPolicyEngine(policy, pods, namespaces, device=device,
                                                  class_compress="0", tiers=tiers),
            "packed_counts" + suffix,
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

    records.append(live_targets_record(device, policy, pods, namespaces, cases))

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
    return records, plain, tiered, (policy, pods, namespaces, cases, plain)


#: bench.py's mesh leg (bench.py:707-895): its synthetic cluster and tile
MESH_PODS = 2048
MESH_POLICIES = 200
MESH_SEED = 77
MESH_BLOCK = 512
#: logical shards of the headline leg's sharded calls
MESH_HEADLINE_SHARDS = (1, 4)


def _grids_equal(a, b) -> bool:
    import torch

    return all(torch.equal(getattr(a, k + "_dev"), getattr(b, k + "_dev"))
               for k in ("ingress", "egress", "combined"))


def mesh_bench_leg(device, cases):
    """Leg (a): bench.py's mesh leg on logical meshes of 1, 2, 4 and 8
    shards on the one card.  Ring counts (a warm-up, then the min of 2)
    and the pipelined twin (5 steps), the sharded counts through the
    kernel (K1) and the tile loop, each equal to evaluate_grid_counts; at
    8 shards the ring grid, the all-gather grid and evaluate_grid
    bit-identical, the class engine's sharded grid equal to its
    evaluate_grid, the peer-buffer estimate ring < allgather; the 2-D ring
    on (2, 4); the tiered twin's ring and tile-loop counts equal.  Logical
    shards share one card, so n shards do the work of one n times over:
    the seconds are printed as they come, and no scaling or overlap figure
    is taken from them."""
    from cyclonus_tpu_torch.engine import TorchPolicyEngine, host, sharded
    from cyclonus_tpu_torch.matcher import build_network_policies
    from cyclonus_tpu_torch.synthetic import bench_tiers, build_synthetic

    pods, namespaces, policies = build_synthetic(MESH_PODS, MESH_POLICIES,
                                                 random.Random(MESH_SEED))
    policy = build_network_policies(True, policies)
    n = len(pods)
    eng = TorchPolicyEngine(policy, pods, namespaces, device=device, class_compress="0")
    want = eng.evaluate_grid_counts(cases, block=MESH_BLOCK)
    rows = []
    for n_dev in (1, 2, 4, 8):
        mesh = sharded.logical_mesh(device, n_dev)
        eng.evaluate_grid_counts_ring(cases, block=MESH_BLOCK, mesh=mesh)  # warm-up
        ring_s = min_s(lambda: eng.evaluate_grid_counts_ring(cases, block=MESH_BLOCK, mesh=mesh),
                       reps=2)
        counts = eng.evaluate_grid_counts_ring(cases, block=MESH_BLOCK, mesh=mesh)
        pipe_s, pipe_counts = eng.mesh_counts_pipelined_eval_s(
            cases, reps=5, block=MESH_BLOCK, mesh=mesh)
        row = {"shards": n_dev, "ring_s": ring_s, "pipelined_s": pipe_s}
        got = {"ring": counts, "pipelined": pipe_counts}
        for kernel in ("pallas", "xla"):
            t0 = time.perf_counter()
            got[kernel] = eng.evaluate_grid_counts_sharded(cases, block=MESH_BLOCK, mesh=mesh,
                                                           kernel=kernel)
            row[f"sharded_{kernel}_s"] = time.perf_counter() - t0
        for route, c in got.items():
            if c != want:
                raise AssertionError(f"mesh (a) {route} at {n_dev} shards: {c} != {want}")
        rows.append(row)

    mesh8 = sharded.logical_mesh(device, 8)
    ref = eng.evaluate_grid(cases)
    t0 = time.perf_counter()
    ring = eng.evaluate_grid_sharded(cases, mesh=mesh8, schedule="ring")
    ring_grid_s = time.perf_counter() - t0
    ag = eng.evaluate_grid_sharded(cases, mesh=mesh8, schedule="allgather")
    if not (_grids_equal(ring, ref) and _grids_equal(ag, ref)):
        raise AssertionError("mesh (a): ring / all-gather grid != evaluate_grid at 8 shards")
    del ring, ag
    eng_c = TorchPolicyEngine(policy, pods, namespaces, device=device, class_compress="1")
    if eng_c.pod_classes() is None:
        raise AssertionError("mesh (a): the class engine holds no class state")
    ring_c = eng_c.evaluate_grid_sharded(cases, mesh=mesh8)
    if not (_grids_equal(ring_c, eng_c.evaluate_grid(cases)) and _grids_equal(ring_c, ref)):
        raise AssertionError("mesh (a): the class engine's sharded grid != its evaluate_grid")
    del ring_c, ref
    ring2d = eng.evaluate_grid_counts_ring2d(
        cases, block=MESH_BLOCK, mesh=sharded.logical_mesh(device, shape=(2, 4)))
    if ring2d != want:
        raise AssertionError(f"mesh (a): ring2d {ring2d} != {want}")
    padded, _ = host._pad_pod_arrays(eng._with_host_cases(cases), n, 8)
    peer = {s: sharded.peer_buffer_bytes(padded, 8, s, pack=eng._pack)
            for s in ("ring", "allgather")}
    if not 0 < peer["ring"] < peer["allgather"]:
        raise AssertionError(f"mesh (a): peer-buffer bytes not ring < allgather: {peer}")
    eng_t = TorchPolicyEngine(policy, pods, namespaces, device=device, class_compress="0",
                              tiers=bench_tiers())
    want_t = eng_t.evaluate_grid_counts(cases, block=MESH_BLOCK)
    ring_t = eng_t.evaluate_grid_counts_ring(cases, block=MESH_BLOCK, mesh=mesh8)
    xla_t = eng_t.evaluate_grid_counts_sharded(cases, block=MESH_BLOCK, mesh=mesh8, kernel="xla")
    if not ring_t == xla_t == want_t:
        raise AssertionError(f"mesh (a) tiered: ring {ring_t}, xla {xla_t}, counts {want_t}")
    return {
        "leg": "bench", "pods": n, "policies": len(policies), "seed": MESH_SEED,
        "block": MESH_BLOCK, "logical": True, "counts": want, "tiered_counts": want_t,
        "rows": rows, "ring_grid_s_8": ring_grid_s, "grids_bit_identical": True,
        "ring2d": [2, 4], "peer_buffer_bytes_8": peer, "classes": eng_c.pod_classes().n_classes,
    }


def _shard0_kernel(eng, cases, n_dev):
    """(run, padded pods): run(plain=False) launches the counts kernel of
    shard 0 of an n_dev-shard kernel="pallas" call on the operands
    tiled.evaluate_grid_counts_sharded gives it (K1 packed, K4/K5 under
    pack=False), or its plain version with plain=True."""
    import torch

    from cyclonus_tpu_torch import carry
    from cyclonus_tpu_torch.engine import dense_kernel as dk
    from cyclonus_tpu_torch.engine import packed_kernel as pk
    from cyclonus_tpu_torch.engine import sharded
    from cyclonus_tpu_torch.engine.tiled import _mesh_counts_setup, _precompute

    n = eng.n_pods
    _m, _n_dev, _q, _block, tensors, n_padded = _mesh_counts_setup(
        eng._with_host_cases(cases), n, 1024, sharded.logical_mesh(eng.device, n_dev))
    pre = _precompute(carry.tensors_from_reference(tensors, eng.device), eng._pack)
    rows = slice(0, n_padded // n_dev)
    valid = torch.arange(n_padded, device=eng.device) < n
    e, ig = pre["egress"], pre["ingress"]
    if eng._pack:
        ops = pk.packed_operands(
            e["tmatch_pk"][:, rows], e["has_target"][rows], e["tallow_pk"],
            ig["tmatch_pk"], ig["has_target"], ig["tallow_pk"][:, rows],
            valid_src=valid[rows], valid_dst=valid)
        return (lambda plain=False: pk.counts_from_packed_ops(ops, plain)), n_padded
    ops = dk.dense_operands(
        e["tmatch"][:, rows], e["has_target"][rows], e["tallow_bf"],
        ig["tmatch"], ig["has_target"], ig["tallow_bf"][:, rows], valid[rows], valid)
    return (lambda plain=False: dk.counts_from_ops(ops, plain)), n_padded


def mesh_headline_leg(device, policy, pods, namespaces, cases, want):
    """Leg (b): the headline cluster (the main path's) through
    evaluate_grid_counts_sharded(kernel="pallas") on 1 and 4 logical
    shards, both dtype plans: K1 (packed) and K4 (pack=False) launched once
    per shard on the shard's source rows against the whole target axis.
    The launch counts are zeroed just before these calls and read just
    after them; every result equals evaluate_grid_counts on the same
    engine and the main path's counts.  Then one ring counts call on the
    4-shard mesh (packed plan), and shard 0's partials of the 4-shard call
    against the plain version at the same operands.  No grid: one
    [N, N, Q] bool verdict is 2e10 bytes."""
    import torch

    from cyclonus_tpu_torch.engine import TorchPolicyEngine, sharded

    engines = {}
    for plan, pack in (("packed", True), ("dense", False)):
        eng = TorchPolicyEngine(policy, pods, namespaces, device=device, class_compress="0",
                                pack=pack)
        counts = eng.evaluate_grid_counts(cases)
        if counts != want:
            raise AssertionError(f"mesh (b) {plan}: evaluate_grid_counts {counts} != {want}")
        engines[plan] = eng
    out = {"leg": "headline", "pods": len(pods), "shards": list(MESH_HEADLINE_SHARDS),
           "logical": True}
    from cyclonus_tpu_torch.engine import dense_kernel as dk
    from cyclonus_tpu_torch.engine import packed_kernel as pk

    pk.reset_launches()
    dk.reset_launches()
    for plan, eng in engines.items():
        for n_dev in MESH_HEADLINE_SHARDS:
            mesh = sharded.logical_mesh(device, n_dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            counts = eng.evaluate_grid_counts_sharded(cases, mesh=mesh, kernel="pallas")
            out[f"{plan}_{n_dev}_shard_s"] = time.perf_counter() - t0
            if counts != want:
                raise AssertionError(f"mesh (b) {plan} at {n_dev} shards: {counts} != {want}")
    mesh4 = sharded.logical_mesh(device, 4)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ring = engines["packed"].evaluate_grid_counts_ring(cases, mesh=mesh4)
    out["ring_4_shard_s"] = time.perf_counter() - t0
    launches = launch_counts()
    if ring != want:
        raise AssertionError(f"mesh (b) ring at 4 shards: {ring} != {want}")
    per_plan = sum(MESH_HEADLINE_SHARDS)
    dense = launches["dense_counts_1chunk"] + launches["dense_counts_chunked"]
    if launches["packed_counts"] != per_plan or dense != per_plan:
        raise AssertionError(f"mesh (b): expected {per_plan} K1 and {per_plan} K4/K5 "
                             f"launches, got {launches}")
    out["launches"] = {k: v for k, v in launches.items() if v}
    # second calls: each reruns its precompute (the mesh has no pin)
    for plan, eng in engines.items():
        for n_dev in MESH_HEADLINE_SHARDS:
            mesh = sharded.logical_mesh(device, n_dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.evaluate_grid_counts_sharded(cases, mesh=mesh, kernel="pallas")
            out[f"{plan}_{n_dev}_shard_second_s"] = time.perf_counter() - t0
    # shard 0 of the 4-shard call against the plain version
    for plan, eng in engines.items():
        run, n_padded = _shard0_kernel(eng, cases, 4)
        got = run()
        torch.cuda.synchronize()
        ref = run(plain=True)
        check_kernel(got, ref, f"mesh (b) {plan}, shard 0 of 4")
        out[f"{plan}_shard0"] = {
            "rows": n_padded // 4, "dst": n_padded, "max_abs_err": float(
                (got.double() - ref.double()).abs().max()),
            "kernel_ms": time_ms(run, reps=5, warm=1),
        }
        del run, got, ref
    del engines
    torch.cuda.empty_cache()
    return out, launches


def mesh_gate_leg():
    """Leg (c): the tier fuzz gate with its mesh leg on the card (8
    logical shards on the one card) and the sharded probe, whose stdout
    must equal the single-device probe's byte for byte."""
    root = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, "-m", "cyclonus_tpu_torch", "fuzz", "--seeds", "8",
           "--conformance", "--cidr-seeds", "4", "--json"]
    t0 = time.perf_counter()
    run = subprocess.run(cmd, cwd=root, capture_output=True, text=True, timeout=900)
    fuzz_s = time.perf_counter() - t0
    if run.returncode != 0:
        raise AssertionError(f"mesh (c): fuzz exited {run.returncode}: {run.stdout[-2000:]} "
                             f"{run.stderr[-2000:]}")
    rep = json.loads(run.stdout.strip().splitlines()[-1])
    if not (rep["ok"] and rep["mesh_cells_checked"] > 0 and rep["conformance_cases"] == 10):
        raise AssertionError(f"mesh (c): fuzz report {rep}")
    argv = ["probe", "--mock", "--perfect-cni", "--policy-path", SIMPLE_EXAMPLE]
    rc, cuda_out, _ = run_cli(argv + ["--engine", "cuda"])
    t0 = time.perf_counter()
    rc_s, mesh_out, _ = run_cli(argv + ["--engine", "cuda-sharded"], engine="cuda-sharded")
    probe_s = time.perf_counter() - t0
    if rc != 0 or rc_s != 0 or mesh_out != cuda_out:
        raise AssertionError("mesh (c): the cuda-sharded probe's output != the cuda probe's")
    return {"leg": "gate", "fuzz_s": fuzz_s, "fuzz": {k: rep[k] for k in (
        "seeds", "cells_checked", "mesh_cells_checked", "pair_checks", "tiered_seeds",
        "cidr_cells_checked", "conformance_cases")},
        "probe_sharded_s": probe_s, "probe_equal": True}


def phase_mesh(device, headline):
    """The pod-axis mesh: legs (a)-(c), one {"mesh": ...} line each.
    Returns the kernel launches of leg (b)'s sharded calls."""
    policy, pods, namespaces, cases, want = headline
    log(json.dumps({"mesh": {"card": card_info(), **mesh_bench_leg(device, cases)}}))
    out, launches = mesh_headline_leg(device, policy, pods, namespaces, cases, want)
    log(json.dumps({"mesh": {"card": card_info(), **out}}))
    log(json.dumps({"mesh": {"card": card_info(), **mesh_gate_leg()}}))
    return launches


# --- telemetry ----------------------------------------------------------------

#: state() keys that read a clock or a process-wide counter, or are the
#: reference's blocks the port leaves out (tests/test_torch_serve.py VOLATILE)
SERVE_VOLATILE = {"slo", "audit", "degraded_queries", "query_latency", "last_apply_s",
                  "last_full_rebuild_s", "staleness_s"}
#: steady counts calls each route of leg (b) is held over
TELEMETRY_CALLS = 5
#: rounds of its on/off timing, and the budget of the median of the
#: rounds' on/off ratios.  The median of paired rounds, not the ratio of
#: minima: on the host-bound class route (about 10 ms a call) the ratio
#: of two minima of 5 passed 1.05 in 1 of 12 repeats with telemetry off
#: on both sides, and in 3 of 12 at 15 rounds; the median of 15 paired
#: ratios stayed within 0.977-1.039 there, and 0.990-1.020 off/on
#: (torch_tools/telemetry_spread.py, H100 80GB HBM3 at 700 W)
TELEMETRY_ROUNDS = 15
TELEMETRY_BUDGET = 1.05
#: (b)'s routes: engine options, the flight path, the kernels it launches
TELEMETRY_ROUTES = {
    "packed": ({"class_compress": "0"}, "counts.pallas", ("packed_counts",)),
    "class": ({}, "counts.classes", ("packed_rowsums",)),
    "dense": ({"class_compress": "0", "pack": False}, "counts.pallas",
              ("dense_counts_slab", "dense_counts_1chunk", "dense_counts_chunked")),
}
#: the /profile capture of leg (d), seconds
PROFILE_SECONDS = 2


def http_get(url, timeout=120):
    """(status, body text) of one GET; error statuses read, not raised."""
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def metric_sample(text, prefix):
    """The value of the exposition line that starts with `prefix`."""
    for line in text.splitlines():
        if line.startswith(prefix):
            return float(line.rsplit(" ", 1)[1])
    raise AssertionError(f"no sample {prefix!r} in the scrape")


def telemetry_timeline(tmp):
    """(a) `generate --loopback --batch-jobs --include conflict --max-cases
    2 --metrics-port 0 --trace-out F --phase-stats` through the port's CLI
    on the card: F must hold the driver's events and those of at least one
    worker subprocess under one trace id, `trace --input F` must summarise
    it, and an in-process scrape of /metrics must show the batch probes'
    latency histogram."""
    from cyclonus_tpu_torch.cli import main as cli_main
    from cyclonus_tpu_torch.telemetry import events
    from cyclonus_tpu_torch.telemetry import server as tserver

    skipped = loopback_precondition()
    if skipped:
        raise AssertionError(f"telemetry (a) needs the loopback cluster: {skipped}")
    path = os.path.join(tmp, "timeline.json")
    t0 = time.perf_counter()
    try:
        with worker_batches() as batches:
            rc, text, split = run_cli([
                "generate", "--loopback", "--batch-jobs", "--include", "conflict",
                "--max-cases", "2", "--retries", "0", "--metrics-port", "0",
                "--trace-out", path, "--phase-stats"])
        status, scrape = http_get(tserver.active_server().url + "/metrics")
    finally:
        events.disable()
        events.reset()
        tserver.register_readiness(None)
        tserver.stop_metrics_server()
    seconds = time.perf_counter() - t0
    (wrong, _ignored, correct), steps = comparison_counts(text)
    if rc != 0 or wrong or "phase timers:" not in text or "engine.dispatch" not in text:
        raise AssertionError(f"telemetry (a): rc {rc}, {wrong} wrong cells, phase stats "
                             f"{'phase timers:' in text}")
    with open(path) as f:
        trace = json.load(f)
    evts = [e for e in trace["traceEvents"] if e["ph"] != "M"]
    roles = {e["pid"]: e["args"]["name"] for e in trace["traceEvents"] if e["ph"] == "M"}
    pids = sorted({e["pid"] for e in evts})
    workers = [p for p, r in roles.items() if "worker" in r]
    ids = trace["otherData"]["trace_ids"]
    if len(ids) != 1 or len(pids) < 2 or not workers or os.getpid() not in pids:
        raise AssertionError(f"telemetry (a): trace ids {ids}, pids {pids}, roles {roles}")
    names = {e["name"] for e in evts}
    for want in ("generate.run", "interpreter.case", "probe.simulated", "probe.kube_batch",
                 "worker.batch", "worker.probe", "engine.dispatch"):
        if want not in names:
            raise AssertionError(f"telemetry (a): no {want} span in the trace")
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli_main(["trace", "--input", path])
    summary = out.getvalue()
    if rc != 0 or f"{len(pids)} process(es)" not in summary:
        raise AssertionError(f"telemetry (a): trace --input: rc {rc}: {summary[:500]}")
    latency = metric_sample(
        scrape, 'cyclonus_tpu_probe_latency_seconds_count{source="batch",outcome="ok"}')
    if status != 200 or latency <= 0:
        raise AssertionError(f"telemetry (a): /metrics {status}, {latency} batch probe samples")
    log(f"telemetry (a): {len(evts)} events of {len(pids)} processes under trace "
        f"{ids[0]}, {correct} cells compared, {seconds:.2f} s")
    return {"seconds": seconds, "cases": steps, "cells_compared": correct + wrong,
            "worker_subprocesses": batches[0], "events": len(evts), "pids": len(pids),
            "worker_pids": len(workers), "trace_id": ids[0],
            "probe_latency_samples": latency, "split": split,
            "summary_head": summary.splitlines()[0]}


def kernel_traces():
    from cyclonus_tpu_torch.telemetry import instruments as ti

    return sum(s["value"] for s in ti.KERNEL_TRACES.snapshot()["samples"])


def telemetry_counts(device, headline):
    """(b) the counts routes at full width, telemetry on: on the headline
    engine, three calls to reach the steady state, then TELEMETRY_CALLS
    steady calls on each route (packed: K1; class: K2; pack=False: K6 or
    K4 by the autotune).  The dispatch counter of the route's path must
    move by exactly the calls, the flight recorder must hold one `ok` entry
    a call with the counts' cells, the kernel traces must rise on the first
    shape and stay flat after it, and the route's kernel launches must move
    with the calls.  Then the on/off timing: TELEMETRY_ROUNDS rounds of one
    call with telemetry off and one with it on, in alternating order; the
    median of the rounds' on/off ratios must stay within TELEMETRY_BUDGET.
    Returns (figures, the packed engine for leg (d))."""
    import torch

    from cyclonus_tpu_torch import telemetry
    from cyclonus_tpu_torch.engine import TorchPolicyEngine
    from cyclonus_tpu_torch.engine import build as kbuild
    from cyclonus_tpu_torch.telemetry import instruments as ti

    policy, pods, namespaces, cases, want = headline
    # the shapes this process already ran count again, as in a fresh one
    kbuild._TRACED.clear()
    out, keep = {}, None
    for name, (kw, path, kernels) in TELEMETRY_ROUTES.items():
        t0 = time.perf_counter()
        eng = TorchPolicyEngine(policy, pods, namespaces, device=device, **kw)
        if (name == "class") != eng._class_counts_eligible(len(cases)):
            raise AssertionError(f"telemetry (b) {name}: class route eligibility")
        traces0 = kernel_traces()
        for _ in range(3):
            if eng.evaluate_grid_counts(cases) != want:
                raise AssertionError(f"telemetry (b) {name}: counts != the main path's")
        traces1 = kernel_traces()
        dispatches0 = ti.EVAL_DISPATCHES.value(path=path)
        seq0 = max([e["seq"] for e in telemetry.recorder.entries()], default=0)
        launches0 = launch_counts()
        for _ in range(TELEMETRY_CALLS):
            if eng.evaluate_grid_counts(cases) != want:
                raise AssertionError(f"telemetry (b) {name}: counts != the main path's")
        dispatches = ti.EVAL_DISPATCHES.value(path=path) - dispatches0
        flights = [e for e in telemetry.recorder.entries() if e["seq"] > seq0]
        launches = {k: v - launches0[k] for k, v in launch_counts().items()
                    if v != launches0[k] and k != "live_targets"}
        if dispatches != TELEMETRY_CALLS:
            raise AssertionError(f"telemetry (b) {name}: {dispatches} dispatches of {path}")
        if (len(flights) != TELEMETRY_CALLS
                or any(e["path"] != path or e["outcome"] != "ok" or e["cells"] != want["cells"]
                       for e in flights)):
            raise AssertionError(f"telemetry (b) {name}: flight entries {flights}")
        if not traces1 > traces0 or kernel_traces() != traces1:
            raise AssertionError(f"telemetry (b) {name}: kernel traces {traces0} -> {traces1} "
                                 f"-> {kernel_traces()}")
        if sum(launches.get(k, 0) for k in kernels) != TELEMETRY_CALLS or set(launches) - set(kernels):
            raise AssertionError(f"telemetry (b) {name}: launches {launches}")
        times = {True: [], False: []}
        for r in range(TELEMETRY_ROUNDS):
            # alternate which side runs first, so neither gains by order
            for on in ((False, True) if r % 2 == 0 else (True, False)):
                telemetry.set_enabled(on)
                try:
                    t = time.perf_counter()
                    got = eng.evaluate_grid_counts(cases)
                    times[on].append(time.perf_counter() - t)
                finally:
                    telemetry.set_enabled(True)
                if got != want:
                    raise AssertionError(f"telemetry (b) {name}: counts != the main path's")
        ratio = statistics.median(on / off for on, off in zip(times[True], times[False]))
        out[name] = {
            "path": path, "dispatches": dispatches, "flights": len(flights),
            "flight_cells": flights[-1]["cells"], "flight_mode": flights[-1].get("mode"),
            "kernel_traces": {"before": traces0, "after_warm": traces1,
                              "after_steady": kernel_traces()},
            "launches": launches, "on_s": times[True], "off_s": times[False],
            "on_min_s": min(times[True]), "off_min_s": min(times[False]),
            "on_off_of_minima": min(times[True]) / min(times[False]), "on_off": ratio,
            "seconds": time.perf_counter() - t0,
        }
        log(f"telemetry (b) {name}: {dispatches} dispatches, {len(flights)} flights, "
            f"launches {launches}, min on {1e3 * min(times[True]):.3f} ms / off "
            f"{1e3 * min(times[False]):.3f} ms, median of {TELEMETRY_ROUNDS} on/off rounds "
            f"{ratio:.4f}")
        if ratio > TELEMETRY_BUDGET:
            raise AssertionError(f"telemetry (b) {name}: on/off {ratio:.4f} > {TELEMETRY_BUDGET}")
        if name == "packed":
            keep = eng
        else:
            del eng
        torch.cuda.empty_cache()
    return out, keep


def telemetry_serve(device, srv):
    """(c) a VerdictService at the serve phase's 1,024-pod cluster on the
    card, behind register_http on the metrics server `srv`: /readyz 503
    before the prewarm and 200 after it, /state equal to svc.state()
    outside the volatile keys, 64 /query GETs with the verdicts of
    svc.query, and the query counter moved by 64."""
    from urllib.parse import urlencode

    from cyclonus_tpu_torch.serve import VerdictService
    from cyclonus_tpu_torch.serve.service import register_http
    from cyclonus_tpu_torch.synthetic import build_synthetic
    from cyclonus_tpu_torch.telemetry import instruments as ti
    from cyclonus_tpu_torch.telemetry import server as tserver

    t0 = time.perf_counter()
    rng = random.Random(SERVE_SEED)
    pods, namespaces, policies = build_synthetic(SERVE_PODS, SERVE_POLICIES, rng)
    svc = VerdictService(pods, namespaces, policies, device=device, defer_ready=True)
    register_http(svc)
    tserver.register_readiness(svc.readiness)
    warming = http_get(srv.url + "/readyz")
    svc.prewarm()
    ready = http_get(srv.url + "/readyz")
    if warming[0] != 503 or ready[0] != 200:
        raise AssertionError(f"telemetry (c): /readyz {warming} then {ready}")
    got = json.loads(http_get(srv.url + "/state")[1])
    want = json.loads(json.dumps(svc.state(), default=str))
    for st in (got, want):
        for k in SERVE_VOLATILE:
            st.pop(k, None)
    if got != want:
        raise AssertionError(f"telemetry (c): /state {got} != state() {want}")
    qs = serve_queries(rng, list(svc.pods), 64)
    expect = [(v.ingress, v.egress, v.combined, v.epoch) for v in svc.query(qs)]
    queries0 = ti.SERVE_QUERIES.value()
    answers = []
    for q in qs:
        status, body = http_get(srv.url + "/query?" + urlencode({
            "src": q.src, "dst": q.dst, "port": q.port, "protocol": q.protocol,
            "portName": q.port_name}))
        v = json.loads(body)
        if status != 200:
            raise AssertionError(f"telemetry (c): /query {status}: {body}")
        answers.append((v["Ingress"], v["Egress"], v["Combined"], v["Epoch"]))
    moved = ti.SERVE_QUERIES.value() - queries0
    if answers != expect or moved != len(qs):
        raise AssertionError(f"telemetry (c): /query verdicts equal {answers == expect}, "
                             f"queries counter moved {moved}")
    tserver.register_readiness(None)
    del svc
    return {"seconds": time.perf_counter() - t0, "pods": SERVE_PODS, "policies": SERVE_POLICIES,
            "readyz": [warming[0], ready[0]], "state_keys": len(got), "queries": len(qs),
            "queries_counter": moved,
            "allowed": sum(a[2] for a in answers)}


def telemetry_profile(srv, eng, cases, want):
    """(d) /profile?seconds=PROFILE_SECONDS while a thread makes K1 steady
    calls on `eng`: 200, and its Chrome trace must name
    packed_counts_kernel among the device events; a second /profile during
    the first must get 409."""
    import threading

    from cyclonus_tpu_torch.telemetry import server as tserver

    t0 = time.perf_counter()
    stop, errors, calls = threading.Event(), [], [0]

    def work():
        try:
            while not stop.is_set():
                if eng.evaluate_grid_counts(cases) != want:
                    errors.append("counts != the main path's")
                calls[0] += 1
        except Exception as e:  # reported below, the leg fails
            errors.append(repr(e))

    first = {}
    worker = threading.Thread(target=work, daemon=True)
    capture = threading.Thread(
        target=lambda: first.update(r=http_get(f"{srv.url}/profile?seconds={PROFILE_SECONDS}")))
    worker.start()
    capture.start()
    try:
        for _ in range(3000):
            if tserver._PROFILE_LOCK.locked() or not capture.is_alive():
                break
            time.sleep(0.01)
        second = http_get(srv.url + "/profile?seconds=1")
    finally:
        capture.join()
        stop.set()
        worker.join()
    status, body = first["r"]
    if errors or status != 200 or second[0] != 409:
        raise AssertionError(f"telemetry (d): {errors}, /profile {status} {body[:500]}, "
                             f"second {second}")
    with open(json.loads(body)["trace"]) as f:
        trace = json.load(f)
    kernels = sorted({e["name"] for e in trace["traceEvents"] if e.get("cat") == "kernel"})
    hits = [k for k in kernels if "packed_counts_kernel" in k]
    if not hits:
        raise AssertionError(f"telemetry (d): no packed_counts_kernel among the device "
                             f"events {kernels[:20]}")
    launched = sum(1 for e in trace["traceEvents"]
                   if e.get("cat") == "kernel" and "packed_counts_kernel" in e["name"])
    return {"seconds": time.perf_counter() - t0, "capture_s": PROFILE_SECONDS,
            "status": status, "concurrent_status": second[0], "calls": calls[0],
            "device_kernels": kernels, "packed_counts_kernel_events": launched,
            "trace_events": len(trace["traceEvents"])}


def phase_telemetry(device, headline):
    """Telemetry on the card, legs (a)-(d), one {"telemetry": ...} line.
    Returns the kernel launches of the phase, counted from zero."""
    import torch

    from cyclonus_tpu_torch.engine import dense_kernel as dk
    from cyclonus_tpu_torch.engine import packed_kernel as pk
    from cyclonus_tpu_torch.telemetry import server as tserver

    _policy, _pods, _namespaces, cases, want = headline
    pk.reset_launches()
    dk.reset_launches()
    out = {"card": card_info()}
    with tempfile.TemporaryDirectory(prefix="chip_smoke-telemetry-") as tmp:
        out["a_timeline"] = telemetry_timeline(tmp)
    out["b_counts"], eng = telemetry_counts(device, headline)
    srv = tserver.start_metrics_server(0)
    try:
        out["c_serve"] = telemetry_serve(device, srv)
        out["d_profile"] = telemetry_profile(srv, eng, cases, want)
    finally:
        for route in ("/state", "/query"):
            tserver.unregister_route(route)
        tserver.stop_metrics_server()
    del eng
    torch.cuda.empty_cache()
    out["on_off"] = {k: v["on_off"] for k, v in out["b_counts"].items()}
    out["launches"] = launch_counts()
    log(json.dumps({"telemetry": out}))
    return out["launches"]


#: chaos phase: the audited stream keeps every epoch's digest (the
#: default ring holds 8), and the divergence budget of audit_divergence
CHAOS_EPOCHS, CHAOS_CHECK_BUDGET = 64, 32


def chaos_suite():
    """(a) the `chaos` command on the card (its default device), all seven
    scenarios; every one must hold.  It runs in a subprocess of its own,
    so its launches are not this process's."""
    proc = subprocess.run(
        [sys.executable, "-m", "cyclonus_tpu_torch", "chaos", "--json"],
        capture_output=True, text=True, timeout=900, cwd=HERE,
    )
    if proc.returncode != 0:
        raise AssertionError(f"chaos: the suite failed (exit {proc.returncode}):\n"
                             f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    report = json.loads(proc.stdout)
    failed = [n for n, r in report["scenarios"].items() if not r.get("ok")]
    if len(report["scenarios"]) != 7 or failed:
        raise AssertionError(f"chaos: scenarios failed {failed}: {report}")
    restart = report["scenarios"]["serve_kill_restart"]
    audit = report["scenarios"]["audit_divergence"]
    if audit["detected_after_checks"] > CHAOS_CHECK_BUDGET:
        raise AssertionError(f"chaos: divergence found after {audit['detected_after_checks']}")
    log(f"chaos (a): serve_kill_restart ttfv {restart['ttfv_s']} s against the "
        f"{restart['ttfv_bound_s']} s bound; audit_divergence detected after "
        f"{audit['detected_after_checks']} checks (budget {CHAOS_CHECK_BUDGET})")
    return {
        "seconds": {n: r["seconds"] for n, r in report["scenarios"].items()},
        "ttfv_s": restart["ttfv_s"], "ttfv_bound_s": restart["ttfv_bound_s"],
        "slo_ttfv_s": report["scenarios"]["slo_ttfv"]["restart"]["ttfv_s"],
        "detected_after_checks": audit["detected_after_checks"],
        "poisoned_rejected": report["scenarios"]["poisoned_caches"]["rejected"],
        "worker_retries": report["scenarios"]["worker_wire"]["retries"],
    }


def audited_leg(device, tiers):
    """(b) one audited service on the card (CYCLONUS_AUDIT=1, rate 1.0)
    and its CPU twin (digests only) under bench.py's serve stream: every
    verdict equal to the twin's, every answered query checked with no
    divergence, one digest per epoch equal to the twin's, and the final
    packed counts equal to the twin's with the packed kernel launched."""
    from cyclonus_tpu_torch.audit import AuditController
    from cyclonus_tpu_torch.engine import PortCase
    from cyclonus_tpu_torch.engine import packed_kernel as pk
    from cyclonus_tpu_torch.serve import VerdictService
    from cyclonus_tpu_torch.synthetic import build_synthetic
    from cyclonus_tpu_torch.telemetry import instruments as ti
    from cyclonus_tpu_torch.worker.model import Delta

    label = "chaos (b) audited" + (" tiered" if tiers else "")
    rng = random.Random(SERVE_SEED)
    pods, namespaces, policies = build_synthetic(SERVE_PODS, SERVE_POLICIES, rng)
    checked0, diverged0 = ti.AUDIT_CHECKED.value(), ti.AUDIT_DIVERGED.value()
    t0 = time.perf_counter()
    with env(CYCLONUS_AUDIT="1", CYCLONUS_AUDIT_RATE="1.0", CYCLONUS_AUDIT_EPOCHS=str(CHAOS_EPOCHS)):
        card = VerdictService(pods, namespaces, policies, device=device, tiers=tiers)
        twin = VerdictService(pods, namespaces, policies, device="cpu", tiers=tiers,
                              audit=AuditController(rate=0.0))
    try:
        keys = list(card.pods)
        answered, query_s = 0, []

        def bits(vs):
            return [(v.ingress, v.egress, v.combined, v.error, v.epoch) for v in vs]

        for step in range(SERVE_DELTAS):
            key = keys[rng.randrange(len(keys))]
            ns, name = key.split("/", 1)
            if step % 5 == 4:
                pod = card.pods[key]
                deltas = [Delta(kind="pod_remove", namespace=ns, name=name),
                          Delta(kind="pod_add", namespace=ns, name=name, labels=dict(pod[2]),
                                ip=pod[3])]
            else:
                deltas = [Delta(kind="pod_labels", namespace=ns, name=name, labels={
                    "pod": f"p{rng.randrange(100)}", "app": f"app{rng.randrange(20)}",
                    "tier": f"tier{rng.randrange(5)}"})]
            a, b = card.apply(deltas), twin.apply(deltas)
            if (a["mode"], a["epoch"]) != (b["mode"], b["epoch"]) or a["mode"] == "full":
                raise AssertionError(f"{label}: apply {a} against the twin's {b}")
            qs = serve_queries(rng, keys, SERVE_QUERIES)
            t1 = time.perf_counter()
            got = card.query(qs)
            query_s.append(time.perf_counter() - t1)
            if bits(got) != bits(twin.query(qs)) or any(v.error for v in got):
                raise AssertionError(f"{label}: step {step}: verdicts differ from the twin's")
            answered += len(qs)
        if not (card.audit.flush(timeout=120) and twin.audit.flush(timeout=120)):
            raise AssertionError(f"{label}: the audit queue did not drain")
        snap = card.audit.snapshot()
        checked = ti.AUDIT_CHECKED.value() - checked0
        diverged = ti.AUDIT_DIVERGED.value() - diverged0
        if checked != answered or diverged != 0 or snap["sampled"] != answered:
            raise AssertionError(f"{label}: checked {checked} and diverged {diverged} of "
                                 f"{answered} answered queries ({snap})")
        digests, twin_digests = card.audit.digests(), twin.audit.digests()
        epochs = list(range(card.epoch + 1))
        if sorted(digests) != epochs or sorted(twin_digests) != epochs:
            raise AssertionError(f"{label}: digests of epochs {sorted(digests)}, "
                                 f"twin {sorted(twin_digests)}, want {epochs}")
        differ = [e for e in epochs if digests[e]["digest"] != twin_digests[e]["digest"]]
        if differ:
            raise AssertionError(f"{label}: digests of epochs {differ} differ from the twin's")
        cases = [PortCase(80, "serve-80-tcp", "TCP"), PortCase(81, "serve-81-udp", "UDP")]
        kernel = "packed_counts_tiered" if tiers else "packed_counts"
        launched = pk.LAUNCHES[kernel]
        counts = card.engine.evaluate_grid_counts(cases)
        k_launches = pk.LAUNCHES[kernel] - launched
        twin_counts = twin.engine.evaluate_grid_counts(cases)
        if counts != twin_counts or k_launches != 1:
            raise AssertionError(f"{label}: counts {counts} against the twin's {twin_counts}, "
                                 f"{kernel} launched {k_launches}")
        out = {
            "pods": SERVE_PODS, "policies": SERVE_POLICIES, "deltas": SERVE_DELTAS,
            "tiers": card.state()["tiers"]["active"], "answered": answered,
            "checked": checked, "diverged": diverged, "epochs": len(epochs),
            "digests_equal_twin": True, "last_digest": digests[epochs[-1]]["digest"],
            "digest_s_max": max(d["seconds"] for d in digests.values()),
            "query_batch_p50_ms": 1e3 * statistics.median(query_s),
            "counts": counts, "counts_equal_twin": True, "kernel": kernel,
            "seconds": time.perf_counter() - t0,
        }
    finally:
        card.audit.close()
        twin.audit.close()
    log(f"{label}: {answered} queries checked, 0 diverged, {len(epochs)} epoch digests "
        f"equal to the CPU twin's, {kernel} counts equal")
    return out


def poisoned_leg(device):
    """(c) scenario_poisoned_caches on the card at the serve phase's
    cluster with the autotune on "auto": the dense kernel (K4) and the
    slab kernel (K6) launch, and every poisoned mode searches again and
    gives equal counts."""
    from cyclonus_tpu_torch.chaos import harness
    from cyclonus_tpu_torch.engine import dense_kernel as dk

    before = dict(dk.LAUNCHES)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke-poison-") as tmp:
        report = harness.scenario_poisoned_caches(seed=SERVE_SEED, workdir=tmp, n_pods=SERVE_PODS,
                                                  n_policies=SERVE_POLICIES, device=device)
    launched = {k: dk.LAUNCHES[k] - before[k] for k in dk.LAUNCHES}
    if not (report["ok"] and report["rejected"] == 3):
        raise AssertionError(f"chaos (c): {report}")
    if launched["dense_counts_1chunk"] < 1 or launched["dense_counts_slab"] < 1:
        raise AssertionError(f"chaos (c): K4 and K6 must launch: {launched}")
    log(f"chaos (c): poisoned winners searched again in every mode, counts {report['counts']}, "
        f"launches {launched}")
    return {"rejected": report["rejected"], "counts": report["counts"], "launches": launched,
            "seconds": time.perf_counter() - t0}


def slo_leg(device):
    """(d) SLO enforcement on the card: query_p99 and freshness forced to
    exhausted shed every query (SLO_SHED moves) and refuse a delta batch
    with Admission; forced back to ok, the verdicts are live and equal
    to the scalar oracle."""
    from cyclonus_tpu_torch.engine import PortCase
    from cyclonus_tpu_torch.matcher.tiered import tiered_oracle_verdicts
    from cyclonus_tpu_torch.oracle import traffic_for_cell
    from cyclonus_tpu_torch.serve import VerdictService
    from cyclonus_tpu_torch.serve.loop import handle_line
    from cyclonus_tpu_torch.synthetic import build_synthetic
    from cyclonus_tpu_torch.telemetry import instruments as ti
    from cyclonus_tpu_torch.worker.model import Batch, Delta

    t0 = time.perf_counter()
    rng = random.Random(SERVE_SEED + 1)
    pods, namespaces, policies = build_synthetic(SERVE_PODS, SERVE_POLICIES, random.Random(SERVE_SEED))
    with env(CYCLONUS_SLO_ENFORCE="1"):
        svc = VerdictService(pods, namespaces, policies, device=device)
    if not svc.slo.enforce:
        raise AssertionError("chaos (d): CYCLONUS_SLO_ENFORCE=1 did not arm the controller")
    keys = list(svc.pods)
    qs = serve_queries(rng, keys, 64)
    for objective in ("query_p99", "freshness"):
        svc.slo.force_state(objective, "exhausted")
    shed0, rejects0 = ti.SLO_SHED.value(), ti.SLO_ADMISSION_REJECTS.value()
    shed = svc.query(qs)
    ns, name = keys[0].split("/", 1)
    line = Batch(namespace="", pod="", container="",
                 deltas=[Delta(kind="pod_labels", namespace=ns, name=name, labels={"app": "slo"})],
                 queries=qs[:4]).to_json()
    reply = handle_line(svc, line)
    if not all(v.shed and v.error for v in shed) or ti.SLO_SHED.value() - shed0 != len(qs) + 4:
        raise AssertionError(f"chaos (d): queries not shed ({ti.SLO_SHED.value() - shed0})")
    if reply.get("Applied") != 0 or "freshness" not in reply.get("Admission", "") or \
            ti.SLO_ADMISSION_REJECTS.value() - rejects0 != 1 or svc.epoch != 0:
        raise AssertionError(f"chaos (d): the delta batch was not refused: {reply}")
    state = svc.state()["slo"]["objectives"]
    for objective in ("query_p99", "freshness"):
        svc.slo.force_state(objective, "ok")
    live = svc.query(qs)
    pods_list = list(svc.pods.values())
    index = {k: i for i, k in enumerate(svc.pods)}
    for q, v in zip(qs, live):
        want = tiered_oracle_verdicts(svc._policy, None, traffic_for_cell(
            pods_list, svc.namespaces, PortCase(q.port, q.port_name, q.protocol),
            index[q.src], index[q.dst]))
        if v.shed or v.error or (v.ingress, v.egress, v.combined) != tuple(want):
            raise AssertionError(f"chaos (d): {q} answered {v} against the oracle's {want}")
    log(f"chaos (d): {len(qs) + 4} queries shed, one batch refused ({reply['Admission']!r}); "
        f"{len(qs)} live verdicts equal to the oracle after recovery")
    return {"shed": len(qs) + 4, "admission_rejects": 1,
            "states_when_forced": {k: state[k]["state"] for k in ("query_p99", "freshness")},
            "live_equal_oracle": len(qs), "seconds": time.perf_counter() - t0}


def recipes_leg():
    """(e) `recipes --engine cuda` on the card: the 15 recipes' tables
    equal to `--engine oracle`'s."""
    import io

    from cyclonus_tpu_torch.cli import main as cli_main

    t0 = time.perf_counter()
    out = {}
    for engine in ("cuda", "oracle"):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            if cli_main(["recipes", "--engine", engine]) != 0:
                raise AssertionError(f"chaos (e): recipes --engine {engine} failed")
        out[engine] = buf.getvalue().split("=== recipe ")[1:]
    if len(out["cuda"]) != 15 or out["cuda"] != out["oracle"]:
        bad = [c.split(" ===")[0] for c, o in zip(out["cuda"], out["oracle"]) if c != o]
        raise AssertionError(f"chaos (e): {len(out['cuda'])} recipes, differing: {bad}")
    log("chaos (e): the 15 recipe tables on the card equal the oracle's")
    return {"recipes": 15, "equal_oracle": True, "seconds": time.perf_counter() - t0}


def phase_chaos(device):
    """The SLO controller, the audit plane and the chaos suite on the
    card, legs (a)-(e), one {"chaos": ...} line.  Returns the kernel
    launches of the phase, counted from zero."""
    import torch

    from cyclonus_tpu_torch.engine import dense_kernel as dk
    from cyclonus_tpu_torch.engine import packed_kernel as pk
    from cyclonus_tpu_torch.synthetic import bench_tiers

    pk.reset_launches()
    dk.reset_launches()
    out = {"card": card_info()}
    t = time.perf_counter()
    out["a_suite"] = chaos_suite()
    out["a_suite"]["wall_s"] = time.perf_counter() - t
    out["b_audited"] = [audited_leg(device, tiers) for tiers in (None, bench_tiers())]
    out["c_poisoned"] = poisoned_leg(device)
    out["d_slo"] = slo_leg(device)
    out["e_recipes"] = recipes_leg()
    torch.cuda.empty_cache()
    out["launches"] = launch_counts()
    for kernel in ("packed_counts", "packed_counts_tiered", "dense_counts_1chunk",
                   "dense_counts_slab"):
        if out["launches"][kernel] < 1:
            raise AssertionError(f"chaos: {kernel} never launched: {out['launches']}")
    log(json.dumps({"chaos": out}))
    return out["launches"]


#: phase 13's cluster: synthetic.build_synthetic(NATIVE_PODS,
#: NATIVE_POLICIES, random.Random(0))
NATIVE_PODS = 4096
NATIVE_POLICIES = 200
#: scalar-oracle cells sampled against the native grids
NATIVE_ORACLE_CELLS = 2000


def native_cli_leg(argv):
    """(d) One CLI run on the native engine: its report has no wrong cell,
    its simulated probes ran on the native engine, VERDICTS{engine=
    "native"} moved and no job fell back to the oracle."""
    from cyclonus_tpu_torch.telemetry import instruments as ti

    before = ti.VERDICTS.value(engine="native"), ti.VERDICTS.value(engine="oracle")
    rc, out, split = run_cli(argv, engine="native")
    moved = (ti.VERDICTS.value(engine="native") - before[0],
             ti.VERDICTS.value(engine="oracle") - before[1])
    (wrong, ignored, correct), steps = comparison_counts(out)
    if rc != 0 or wrong or not correct or moved[0] < 1 or moved[1]:
        raise AssertionError(f"native (d): {argv[0]} exited {rc}, {wrong} wrong, {correct} "
                             f"correct in {steps} steps, native/oracle verdicts {moved}")
    return {"steps": steps, "wrong": wrong, "correct": correct, "native_verdicts": moved[0],
            "oracle_verdicts": moved[1], **split}


def native_perf_leg(root):
    """(e) `perf report --format json` and `perf gate` in process on the
    checkout's round artifacts: runs by failure class, the gate's code."""
    import io

    from cyclonus_tpu_torch.cli import main as cli_main

    t0 = time.perf_counter()
    codes, outs = {}, {}
    for mode, argv in (("report", ["perf", "report", "--dir", root, "--format", "json"]),
                       ("gate", ["perf", "gate", "--dir", root])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            codes[mode] = cli_main(argv)
        outs[mode] = buf.getvalue()
    if codes["report"] != 0 or codes["gate"] not in (0, 1, 2):
        raise AssertionError(f"native (e): perf exit codes {codes}")
    doc = json.loads(outs["report"])
    return {"runs": len(doc["runs"]), "by_class": doc["by_class"],
            "gate_status": doc["gate"]["status"], "gate_exit": codes["gate"],
            "gate_head": outs["gate"].splitlines()[0], "seconds": time.perf_counter() - t0}


def native_version_leg():
    """(f) `version --devices` names the card and counts one device."""
    import io

    import torch

    from cyclonus_tpu_torch.cli import main as cli_main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(["version", "--devices"])
    line = buf.getvalue().splitlines()[-1]
    name = torch.cuda.get_device_name(0)
    if rc != 0 or not line.startswith("backend cuda, 1 device(s)") or name not in line:
        raise AssertionError(f"native (f): version --devices exited {rc}: {line!r}")
    return line


def phase_native(device):
    """The C++ host evaluator and the runner's native engine, the perf
    observatory and `version --devices` on the card machine, legs (a)-(f),
    one {"native": ...} line.  Returns the kernel launches of the phase,
    counted from zero."""
    import numpy as np
    import torch

    from cyclonus_tpu_torch import native
    from cyclonus_tpu_torch.engine import PortCase, TorchPolicyEngine
    from cyclonus_tpu_torch.engine import build as kernel_build
    from cyclonus_tpu_torch.engine import dense_kernel as dk
    from cyclonus_tpu_torch.engine import packed_kernel as pk
    from cyclonus_tpu_torch.matcher import build_network_policies
    from cyclonus_tpu_torch.native import build as native_build
    from cyclonus_tpu_torch.synthetic import build_synthetic

    pk.reset_launches()
    dk.reset_launches()
    out = {"card": card_info(), "host_cpus": os.cpu_count()}

    # (a) the build, with no silent fallback
    t = time.perf_counter()
    build_s = native_build.build()
    lib = native_build.library_path()
    if kernel_build.build_dir().resolve() not in lib.resolve().parents or not lib.exists():
        raise AssertionError(f"native (a): library {lib} not under {kernel_build.build_dir()}")
    if not native.native_available():
        raise AssertionError("native (a): the native library does not load")
    out["a_build"] = {"gxx_s": build_s, "library": lib.name, "wall_s": time.perf_counter() - t}
    log(f"native (a): g++ {build_s:.2f} s -> {lib} ({out['card']})")

    # (b) the grids against the card's and the oracle's
    pods, namespaces, policies = build_synthetic(NATIVE_PODS, NATIVE_POLICIES, random.Random(0))
    policy = build_network_policies(True, policies)
    cases = [PortCase(80, "serve-80-tcp", "TCP"), PortCase(81, "serve-81-udp", "UDP"),
             PortCase(9999, "", "SCTP")]
    t = time.perf_counter()
    grid = native.evaluate_grid_native(policy, pods, namespaces, cases)
    native_s = time.perf_counter() - t
    t = time.perf_counter()
    eng = TorchPolicyEngine(policy, pods, namespaces, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize()
    encode_s = time.perf_counter() - t
    t = time.perf_counter()
    card = eng.evaluate_grid(cases)
    card_grids = card.ingress, card.egress, card.combined
    card_s = time.perf_counter() - t
    for name, got, want in zip(("ingress", "egress", "combined"),
                               (grid.ingress, grid.egress, grid.combined), card_grids):
        if got.shape != want.shape or not np.array_equal(got, want):
            diff = np.argwhere(got != want)[:1].tolist() if got.shape == want.shape else "shape"
            raise AssertionError(f"native (b): {name} grid differs from the card's at {diff}")
    rng = random.Random(13)
    cells = [(rng.randrange(len(cases)), rng.randrange(len(pods)), rng.randrange(len(pods)))
             for _ in range(NATIVE_ORACLE_CELLS)]
    t = time.perf_counter()
    _oracle_init(policy, pods, namespaces, cases)
    want = _oracle_cells(cells)
    oracle_s = time.perf_counter() - t
    got = [grid.job_verdict(q, s, d) for q, s, d in cells]
    if got != want:
        bad = next(c for c, a, b in zip(cells, got, want) if a != b)
        raise AssertionError(f"native (b): cell {bad} differs from the oracle")
    out["b_grids"] = {"pods": len(pods), "policies": NATIVE_POLICIES, "cases": len(cases),
                      "cells": len(cases) * len(pods) ** 2, "native_s": native_s,
                      "card_encode_s": encode_s, "card_grid_s": card_s,
                      "oracle_cells": len(cells), "oracle_s": oracle_s}
    log(f"native (b): {len(pods)} pods x {NATIVE_POLICIES} policies x {len(cases)} cases equal "
        f"to the card's grids; native {native_s:.3f} s on {os.cpu_count()} host CPUs, card grid "
        f"{card_s:.3f} s (+ encode {encode_s:.3f} s); {len(cells)} oracle cells equal "
        f"({out['card']})")

    # (c) per-case counts against K1
    before = launch_counts()
    eng1 = TorchPolicyEngine(policy, pods, namespaces, device=device, class_compress="0")
    n = len(pods)
    counts = []
    for qi, case in enumerate(cases):
        got = eng1.evaluate_grid_counts([case])
        want = {"ingress": int(grid.ingress[qi].sum()), "egress": int(grid.egress[qi].sum()),
                "combined": int(grid.combined[qi].sum()), "cells": n * n}
        if got != want:
            raise AssertionError(f"native (c): {case} counts {got} != native {want}")
        counts.append(got)
    k1 = launch_counts()["packed_counts"] - before["packed_counts"]
    if k1 < 1:
        raise AssertionError(f"native (c): packed_counts did not launch ({launch_counts()})")
    out["c_counts"] = {"per_case": counts, "k1_launches": k1}
    del eng, eng1, card, card_grids, grid
    torch.cuda.empty_cache()

    # (d) the CLI on the native engine
    out["d_probe"] = native_cli_leg(["probe", "--mock", "--perfect-cni", "--engine", "native",
                                     "--policy-path", GETTING_STARTED])
    out["d_generate"] = native_cli_leg(["generate", "--mock", "--perfect-cni", "--engine",
                                        "native", "--retries", "0", "--max-cases", "8"])
    # (e), (f)
    out["e_perf"] = native_perf_leg(HERE)
    out["f_version"] = native_version_leg()
    out["launches"] = launch_counts()
    log(json.dumps({"native": out}))
    return out["launches"]


#: the scale phase's legs, at shapes of the reference's bench.py: the
#: packed headline at 1,000,000 and 2,000,000 pods x 500 policies from
#: bench.py's seed (its 1M / 2M runs), mega_class at 1,000,000 pods x
#: 2,000 policies x 512 namespaces (bench.py:1578-1665, its seed), and the
#: full-grid tables mode (BENCH_TILED=0, bench.py:16-21) at 25,000 pods x
#: 2,500 policies (bench.py's seed; both of its defaults' 10:1 ratio)
SCALE_LEGS = {
    "headline_1m": (1_000_000, 500),
    "headline_2m": (2_000_000, 500),
    "mega_class": (1_000_000, 2_000, 512),
    "tables_25k": (25_000, 2_500),
}
MEGA_SEED = 20260803
#: pairs held against the scalar oracle (each at every port case): the
#: headline's BENCH_SAMPLE default and mega_class's BENCH_MEGA_SAMPLE;
#: grid cells of the tables leg
SCALE_SAMPLE = 25
MEGA_SAMPLE = 10
TABLES_ORACLE = 2000
#: steady counts calls after the first, as bench.py's mega_class leg
SCALE_STEADY = 3
#: the phase's own bound, in seconds
SCALE_BOUND_S = 240.0


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize()


def scale_oracle(policy, pods, namespaces, cases, cells):
    """The scalar oracle's (ingress, egress, combined) of each (q, src,
    dst) cell, in this process: at a million pods, a spawned worker would
    have to unpickle the whole pod list."""
    _oracle_init(policy, pods, namespaces, cases)
    try:
        return _oracle_cells(cells)
    finally:
        _ORACLE.clear()


def scale_pairs(policy, pods, namespaces, cases, n, rng):
    """n random (src, dst) pairs and the oracle's [n, Q, 3] verdicts of
    each at every port case, with the seconds the oracle took."""
    import numpy as np

    pairs = [(rng.randrange(len(pods)), rng.randrange(len(pods))) for _ in range(n)]
    cells = [(q, s, d) for s, d in pairs for q in range(len(cases))]
    t = time.perf_counter()
    want = np.array(scale_oracle(policy, pods, namespaces, cases, cells), dtype=bool)
    return pairs, want.reshape(n, len(cases), 3), time.perf_counter() - t


def check_pairs(eng, cases, pairs, want, label):
    got = eng.evaluate_pairs(cases, pairs)
    if got.shape != want.shape or not (got == want).all():
        import numpy as np

        k, q, _ = np.argwhere(got != want)[0] if got.shape == want.shape else (0, 0, 0)
        raise AssertionError(f"{label}: pair {pairs[k]} case {cases[q]} {got[k, q].tolist()} "
                             f"differs from the oracle's {want[k, q].tolist()}")


def scale_engine(device, policy, pods, namespaces, cases, label, steady=SCALE_STEADY, **kw):
    """One engine of a scale leg: its encode, its counts route, the first
    counts call and the min of `steady` more, the kernels it launched
    and its peak device memory.  The route is read before the first
    call and held against the launches: the class route launches K2
    (packed_rowsums) and no K1, the dense route K1 and no K2.  Returns
    (engine, counts, record)."""
    import torch

    from cyclonus_tpu_torch.engine import TorchPolicyEngine

    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    before = launch_counts()
    _sync(device)
    t = time.perf_counter()
    eng = TorchPolicyEngine(policy, pods, namespaces, device=device, **kw)
    _sync(device)
    encode_s = time.perf_counter() - t
    q, n = len(cases), len(pods)
    route = "class" if eng._class_counts_eligible(q) else "dense"
    t = time.perf_counter()
    counts = eng.evaluate_grid_counts(cases)
    first_s = time.perf_counter() - t
    if counts["cells"] != q * n * n or not 0 < counts["combined"] <= counts["cells"]:
        raise AssertionError(f"{label}: implausible counts {counts}")
    times = []
    for _ in range(steady):
        t = time.perf_counter()
        again = eng.evaluate_grid_counts(cases)
        times.append(time.perf_counter() - t)
        if again != counts:
            raise AssertionError(f"{label}: steady counts {again} != first call's {counts}")
    after = launch_counts()
    launches = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    ran, idle = ("packed_rowsums", "packed_counts") if route == "class" else (
        "packed_counts", "packed_rowsums")
    # (on the CPU the wrappers run the plain versions and count nothing)
    if device.type == "cuda" and (launches.get(ran, 0) < 1 + steady or launches.get(idle, 0)):
        raise AssertionError(f"{label}: the {route} route launched {launches}")
    stats = eng.class_compression_stats()
    rec = {
        "route": route,
        "kernel": ran,
        "classes": stats["classes"],
        "class_bytes_estimate": eng._class_counts_bytes(q),
        "encode_s": encode_s,
        "first_s": first_s,
        "steady_s": times,
        "steady_min_s": min(times),
        "cells_per_s": counts["cells"] / min(times),
        "launches": launches,
        "pre_cache": eng.pre_cache_stats() if route == "dense" else None,
        "max_memory_allocated": (torch.cuda.max_memory_allocated()
                                 if device.type == "cuda" else None),
    }
    log(f"{label}: {route} route ({ran}), encode {encode_s:.2f} s, first {first_s:.3f} s, "
        f"steady min {min(times):.4f} s, peak {rec['max_memory_allocated']} bytes; "
        f"{json.dumps(counts)}")
    return eng, counts, rec


def scale_headline(device, label, n_pods, n_policies, cases):
    """(a)/(b): the packed headline on the class route (engine A, auto)
    and the dense route (engine B, class_compress="0", K1) of one
    cluster, each against the oracle's pairs; equal counts."""
    from cyclonus_tpu_torch.engine import host
    from cyclonus_tpu_torch.matcher import build_network_policies
    from cyclonus_tpu_torch.synthetic import build_synthetic

    t = time.perf_counter()
    pods, namespaces, policies = build_synthetic(n_pods, n_policies, random.Random(SEED))
    policy = build_network_policies(True, policies)
    out = {"pods": n_pods, "policies": n_policies, "seed": SEED,
           "build_s": time.perf_counter() - t}
    pairs, want, out["oracle_s"] = scale_pairs(policy, pods, namespaces, cases, SCALE_SAMPLE,
                                               random.Random(SEED + n_pods))
    out["oracle_pairs"] = SCALE_SAMPLE
    counts = {}
    for key, kw in (("a", {}), ("b", {"class_compress": "0"})):
        eng, counts[key], out[key] = scale_engine(device, policy, pods, namespaces, cases,
                                                  f"scale {label} {key}", **kw)
        t = time.perf_counter()
        check_pairs(eng, cases, pairs, want, f"scale {label} {key}")
        out[key]["pairs_s"] = time.perf_counter() - t
        del eng
    if out["b"]["route"] != "dense":
        raise AssertionError(f"scale {label}: class_compress=0 took the {out['b']['route']} route")
    if counts["a"] != counts["b"]:
        raise AssertionError(f"scale {label}: engine A {counts['a']} != engine B {counts['b']}")
    out["counts"] = counts["a"]
    a = out["a"]
    if a["route"] != "class":
        # the class route declined (no class state, or its estimate past
        # the budget): engine A ran K1, named as such, and the leg holds
        # K1 against the oracle's pairs alone
        out["class_route"] = {"eligible": False, "classes": a["classes"],
                              "bytes_estimate": a["class_bytes_estimate"],
                              "budget": host._slab_max_bytes()}
    log(f"scale {label}: engine A ({a['route']}) == engine B (dense) counts, "
        f"{2 * SCALE_SAMPLE} oracle cells equal")
    return out


def scale_k2_check(eng, cases):
    """K2 against its plain version at the class route's operands of an
    engine, timed; the launches it makes are returned so that the phase
    leaves them out of its count."""
    import torch

    from cyclonus_tpu_torch.engine import packed_kernel as pk
    from cyclonus_tpu_torch.engine.tiled import _precompute, class_rowsums_plan

    before = launch_counts()
    pc = eng.pod_classes()
    tens = eng._with_cases(eng._class_dev(), cases)
    pre = _precompute(tens, True)
    n_axis = int(tens["pod_ns_id"].shape[0])
    w = torch.from_numpy(class_rowsums_plan(tens, pc.n_classes, pc.class_size)[0]).to(
        eng.device)
    args, _tier, _got, err = check_packed(pre, n_axis, w, "packed_rowsums, mega_class shapes")
    valid_src, valid_dst, bs, bd = pk._resolve(args[0], args[3], n_axis, None, None, None, None)
    ops = pk._packed_operands(*args, valid_src, valid_dst, None, w, bs, bd)
    ms = time_ms(lambda: pk._counts_cuda(ops, bs), reps=5, warm=1)
    plain_ms = time_ms(lambda: pk._counts_plain(ops, bs), reps=1, warm=0)
    after = launch_counts()
    rec = {"class_axis": n_axis, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           "launches": {k: after[k] - before[k] for k in after if after[k] != before[k]}}
    log(f"scale mega_class: packed_rowsums {ms:.3f} ms (plain {plain_ms:.1f} ms) at a class "
        f"axis of {n_axis}, equal to plain (tolerance: exact)")
    return rec


def scale_mega(device, cases):
    """(c): bench.py's mega_class leg: class compression eligible, counts
    on the class route, pairs against the oracle, the class reduction
    audited against the oracle."""
    from cyclonus_tpu_torch.analysis import audit_class_reduction
    from cyclonus_tpu_torch.matcher import build_network_policies
    from cyclonus_tpu_torch.synthetic import build_synthetic

    n_pods, n_policies, n_ns = SCALE_LEGS["mega_class"]
    rng = random.Random(MEGA_SEED)
    t = time.perf_counter()
    pods, namespaces, policies = build_synthetic(n_pods, n_policies, rng, n_ns=n_ns)
    policy = build_network_policies(True, policies)
    out = {"pods": n_pods, "policies": n_policies, "namespaces": n_ns, "seed": MEGA_SEED,
           "build_s": time.perf_counter() - t}
    eng, counts, out["engine"] = scale_engine(device, policy, pods, namespaces, cases,
                                              "scale mega_class")
    out["eligible"] = eng._class_counts_eligible(len(cases))
    out["class_compression"] = eng.class_compression_stats()
    if not out["class_compression"]["active"] or not out["eligible"]:
        raise AssertionError(f"scale mega_class: class route not eligible "
                             f"({out['class_compression']}, estimate "
                             f"{out['engine']['class_bytes_estimate']})")
    out["counts"] = counts
    if device.type == "cuda":
        out["k2_check"] = scale_k2_check(eng, cases)
    pairs, want, out["oracle_s"] = scale_pairs(policy, pods, namespaces, cases, MEGA_SAMPLE, rng)
    check_pairs(eng, cases, pairs, want, "scale mega_class")
    out["oracle_pairs"] = MEGA_SAMPLE
    t = time.perf_counter()
    audit = audit_class_reduction(policy, pods, namespaces, cases, eng.pod_classes(),
                                  max_classes=4, peers_per_class=4, rng=rng)
    out["audit"] = {"checked_classes": audit["checked_classes"],
                    "checked_cells": audit["checked_cells"], "ok": audit["ok"],
                    "seconds": time.perf_counter() - t}
    if not audit["ok"]:
        raise AssertionError(f"scale mega_class: class reduction audit: {audit['violations'][:3]}")
    log(f"scale mega_class: {out['class_compression']['classes']} classes, eligible, "
        f"{2 * MEGA_SAMPLE} oracle cells equal, audit ok ({audit['checked_cells']} cells)")
    return out


def scale_tables(device, cases):
    """(d): the full-grid tables mode: evaluate_grid on the class route
    (the gather epilogue) and the dense route, equal cell for cell on the
    device; each case's sums equal evaluate_grid_counts on both engines;
    grid cells against the oracle after the host fetch."""
    import torch

    from cyclonus_tpu_torch.engine import TorchPolicyEngine
    from cyclonus_tpu_torch.matcher import build_network_policies
    from cyclonus_tpu_torch.synthetic import build_synthetic

    n_pods, n_policies = SCALE_LEGS["tables_25k"]
    t = time.perf_counter()
    pods, namespaces, policies = build_synthetic(n_pods, n_policies, random.Random(SEED))
    policy = build_network_policies(True, policies)
    out = {"pods": n_pods, "policies": n_policies, "seed": SEED,
           "cells": len(cases) * n_pods * n_pods, "build_s": time.perf_counter() - t}
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    grids = {}
    for key, kw in (("class", {}), ("dense", {"class_compress": "0"})):
        t = time.perf_counter()
        eng = TorchPolicyEngine(policy, pods, namespaces, device=device, **kw)
        _sync(device)
        rec = {"encode_s": time.perf_counter() - t,
               "classes": eng.class_compression_stats()["classes"]}
        if (eng.pod_classes() is not None) != (key == "class"):
            raise AssertionError(f"scale tables_25k: the {key} engine's class state is "
                                 f"{eng.class_compression_stats()}")
        t = time.perf_counter()
        grid = eng.evaluate_grid(cases)
        _sync(device)
        rec["grid_s"] = time.perf_counter() - t
        sums = []
        for qi, case in enumerate(cases):
            got = {name: int(getattr(grid, name + "_dev")[qi].sum())
                   for name in ("ingress", "egress", "combined")}
            want = eng.evaluate_grid_counts([case])
            got["cells"] = n_pods * n_pods
            if got != want:
                raise AssertionError(f"scale tables_25k: {key} grid sums {got} != counts {want} "
                                     f"at {case}")
            sums.append(got)
        rec["sums"] = sums
        out[key] = rec
        grids[key] = grid
        del eng
    for name in ("ingress", "egress", "combined"):
        a, b = getattr(grids["class"], name + "_dev"), getattr(grids["dense"], name + "_dev")
        if a.shape != b.shape or not torch.equal(a, b):
            diff = (a != b).nonzero()[:1].tolist() if a.shape == b.shape else "shape"
            raise AssertionError(f"scale tables_25k: class {name} grid differs from the dense "
                                 f"one at {diff}")
    out["max_memory_allocated"] = (torch.cuda.max_memory_allocated()
                                   if device.type == "cuda" else None)
    grid = grids["dense"]
    del grids
    t = time.perf_counter()
    fetched = grid.ingress, grid.egress, grid.combined
    out["fetch_s"] = time.perf_counter() - t
    out["fetch_bytes"] = sum(int(h.nbytes) for h in fetched)
    rng = random.Random(SEED + n_pods)
    cells = [(rng.randrange(len(cases)), rng.randrange(n_pods), rng.randrange(n_pods))
             for _ in range(TABLES_ORACLE)]
    t = time.perf_counter()
    want = scale_oracle(policy, pods, namespaces, cases, cells)
    out["oracle_s"] = time.perf_counter() - t
    got = [grid.job_verdict(q, s, d) for q, s, d in cells]
    if got != want:
        bad = next(c for c, x, y in zip(cells, got, want) if x != y)
        raise AssertionError(f"scale tables_25k: cell {bad} differs from the oracle")
    out["oracle_cells"] = len(cells)
    log(f"scale tables_25k: class and dense grids equal, sums equal the counts, "
        f"{len(cells)} oracle cells equal; grids {out['class']['grid_s']:.3f} / "
        f"{out['dense']['grid_s']:.3f} s, fetch {out['fetch_s']:.3f} s")
    return out


def phase_scale(device, legs=tuple(SCALE_LEGS)):
    """The reference's largest shapes, legs (a)-(d) (main()'s docstring,
    phase 14), one {"scale": ...} line.  Returns the kernel launches of
    the phase, counted from zero."""
    from cyclonus_tpu_torch.engine import PortCase
    from cyclonus_tpu_torch.engine import dense_kernel as dk
    from cyclonus_tpu_torch.engine import packed_kernel as pk

    pk.reset_launches()
    dk.reset_launches()
    t0 = time.perf_counter()
    cases = [PortCase(80, "serve-80-tcp", "TCP"), PortCase(81, "serve-81-udp", "UDP")]
    out = {"card": card_info() if device.type == "cuda" else None}
    seconds = {}
    for leg in legs:
        t = time.perf_counter()
        if leg.startswith("headline"):
            out[leg] = scale_headline(device, leg, *SCALE_LEGS[leg], cases)
        elif leg == "mega_class":
            out[leg] = scale_mega(device, cases)
        else:
            out[leg] = scale_tables(device, cases)
        seconds[leg] = time.perf_counter() - t
    out["seconds"] = seconds
    out["total_s"] = time.perf_counter() - t0
    # the phase's launches, those of the K2 check against its plain left out
    check = out.get("mega_class", {}).get("k2_check", {}).get("launches", {})
    out["launches"] = {k: v - check.get(k, 0) for k, v in launch_counts().items()}
    log(json.dumps({"scale": out}))
    if out["total_s"] > SCALE_BOUND_S:
        raise AssertionError(f"scale: {out['total_s']:.1f} s past its bound of {SCALE_BOUND_S} s")
    return out["launches"]

#: the guards phase's bound, seconds
GUARDS_BOUND_S = 180.0
#: the flags the armed run of leg (a) sets
GUARD_FLAGS = {"CYCLONUS_SHAPE_CHECK": "1", "CYCLONUS_GUARD_CHECK": "1",
               "CYCLONUS_PLANHARNESS": "1"}


def guards_headline_child(device_name: str = "cuda", n_pods: int = N_PODS,
                          n_policies: int = N_POLICIES) -> int:
    """Leg (a)'s child process: planharness.drive_headline on the
    headline cluster with whatever guard flags its environment sets.
    Prints one JSON line: the drained routes, each call's counts and
    seconds, the contract checks made, whether each flag was read on,
    and the kernel launches."""
    import torch

    sys.path.insert(0, os.path.join(HERE, "torch_tools"))
    import planharness

    from cyclonus_tpu_torch.engine import PortCase, TorchPolicyEngine, planspec
    from cyclonus_tpu_torch.matcher import build_network_policies
    from cyclonus_tpu_torch.synthetic import bench_tiers, build_synthetic
    from cyclonus_tpu_torch.utils import contracts, guards

    device = torch.device(device_name)
    t0 = time.perf_counter()
    pods, namespaces, policies = build_synthetic(n_pods, n_policies, random.Random(SEED))
    policy = build_network_policies(True, policies)
    tiers = bench_tiers()
    cases = [PortCase(80, "serve-80-tcp", "TCP"), PortCase(81, "serve-81-udp", "UDP")]

    def make(**options):
        if options.pop("tiers", False):
            options["tiers"] = tiers
        return TorchPolicyEngine(policy, pods, namespaces, device=device, **options)

    def clock():
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return time.perf_counter()

    routes, counts, seconds = planharness.drive_headline(make, cases, planspec.drain,
                                                         clock=clock)
    print(json.dumps({
        "routes": routes, "counts": counts, "seconds": seconds,
        "checks": contracts.CHECKS,
        "armed": {"shape": contracts.CHECK, "guard": guards.CHECK, "plan": planspec.ACTIVE},
        "launches": launch_counts(), "total_s": time.perf_counter() - t0,
    }))
    return 0


def guards_subprocess(argv, what, env=None, timeout=300):
    """One leg of the guards phase as a process of its own: its last
    stdout line, parsed; raises with its output when it fails."""
    run = subprocess.run([sys.executable, *argv], cwd=HERE, capture_output=True, text=True,
                         timeout=timeout, env={**os.environ, **(env or {})})
    if run.returncode != 0:
        raise AssertionError(f"guards {what}: exited {run.returncode}: "
                             f"{run.stdout[-3000:]} {run.stderr[-3000:]}")
    return json.loads(run.stdout.strip().splitlines()[-1])


def phase_guards(device, want_plain, want_tiered):
    """Phase 15 (main()'s docstring): legs (a)-(e), one {"guards": ...}
    line.  Returns the kernel launches of the phase's processes, each
    counted from zero."""
    sys.path.insert(0, os.path.join(HERE, "torch_tools"))
    import planharness

    t0 = time.perf_counter()
    child = ["-c", f"import sys, chip_smoke; sys.exit(chip_smoke.guards_headline_child("
                   f"{device.type!r}))"]
    runs = {"armed": guards_subprocess(child, "(a) armed", env=GUARD_FLAGS),
            "unarmed": guards_subprocess(child, "(a) unarmed",
                                         env={k: "0" for k in GUARD_FLAGS})}
    want = {"class": want_plain, "packed": want_plain, "dense slab": want_plain,
            "tiered class": want_tiered, "tiered packed": want_tiered}
    for key, run in runs.items():
        for label, calls in run["counts"].items():
            if any(c != want[label] for c in calls):
                raise AssertionError(f"guards (a) {key}, {label}: counts {calls} != main path "
                                     f"{want[label]}")
    armed, unarmed = runs["armed"], runs["unarmed"]
    if armed["armed"] != {"shape": True, "guard": True, "plan": True} or any(
            unarmed["armed"].values()):
        raise AssertionError(f"guards (a): flags read {armed['armed']} / {unarmed['armed']}")
    if armed["checks"] <= 0 or unarmed["checks"] != 0:
        raise AssertionError(f"guards (a): contract checks armed {armed['checks']}, "
                             f"unarmed {unarmed['checks']}")
    if armed["routes"] != planharness.HEADLINE or unarmed["routes"]:
        raise AssertionError(f"guards (a): routes {armed['routes']} != {planharness.HEADLINE}"
                             f" (unarmed {unarmed['routes']})")
    log(f"guards (a): counts equal to the main path's armed and unarmed; "
        f"{armed['checks']} contract checks; routes {armed['routes']}")
    tools = os.path.join(HERE, "torch_tools")
    dev = ["--device", device.type]
    race = guards_subprocess(
        [os.path.join(tools, "raceharness.py"), *dev, "--scenario", "engine_cache",
         "--scenario", "worker_ingest", "--schedules", "50", "--threads", "8", "--seed", "1234"],
        "(b) raceharness", env={"CYCLONUS_GUARD_CHECK": "1"})
    skew = guards_subprocess([os.path.join(tools, "skewharness.py"), *dev], "(c) skewharness")
    plan = guards_subprocess([os.path.join(tools, "planharness.py"), *dev], "(d) planharness")
    t_key = time.perf_counter()
    key = guards_subprocess([os.path.join(tools, "keyharness.py"), *dev, "--full"],
                            "(e) keyharness")
    key_s = time.perf_counter() - t_key
    for what, out in (("(b)", race), ("(c)", skew), ("(d)", plan), ("(e)", key)):
        if not out.get("ok") or out.get("device") != device.type:
            raise AssertionError(f"guards {what}: {out}")
    census = key["results"].get("registry_census", {})
    if len(key["results"]) != 7 or census.get("registered") != 4:
        raise AssertionError(f"guards (e): scenarios {sorted(key['results'])}, "
                             f"registered {census.get('registered')}")
    legs = [armed, unarmed, race, skew, plan, key]
    launches = {k: sum(leg["launches"].get(k, 0) for leg in legs) for k in launch_counts()}
    total = time.perf_counter() - t0
    log(json.dumps({"guards": {
        "card": card_info() if device.type == "cuda" else None,
        "headline": {"pods": N_PODS, "policies": N_POLICIES, "seed": SEED,
                     "routes": armed["routes"], "contract_checks": armed["checks"],
                     "armed_s": armed["seconds"], "unarmed_s": unarmed["seconds"],
                     "armed_total_s": armed["total_s"], "unarmed_total_s": unarmed["total_s"]},
        "race": race["results"], "skew": skew["results"], "plan": plan["results"],
        "keyharness": {
            "scenarios": sorted(key["results"]),
            "mutations": {k: v["mutations"] for k, v in key["results"].items()},
            "registered": sorted(census["families"]),
            "steady_s": census["steady_s"], "register_us": census["register_us"],
            "census_pods": census["pods"], "launches": key["launches"],
            "scenario_s": {k: v["seconds"] for k, v in key["results"].items()},
            "seconds": key_s,
        },
        "launches": launches, "total_s": total,
    }}))
    if total > GUARDS_BOUND_S:
        raise AssertionError(f"guards: {total:.1f} s past its bound of {GUARDS_BOUND_S} s")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    device = torch.device("cuda")
    # a crash dumps the flight recorder into the temporary directory, never
    # into the checkout's artifacts/
    os.environ["CYCLONUS_FLIGHT_RECORDER_PATH"] = os.path.join(
        tempfile.gettempdir(), f"chip_smoke-flight-recorder-{os.getpid()}.json")

    from cyclonus_tpu_torch.engine import build

    log(card_info())
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(device)}")
    t0 = time.perf_counter()
    secs = build.build(verbose=True)
    log(f"build: {json.dumps(secs)} (wall {time.perf_counter() - t0:.1f} s)")
    phase_s = {"build": time.perf_counter() - t0}

    def timed(name, fn):
        t = time.perf_counter()
        out = fn(device)
        phase_s[name] = time.perf_counter() - t
        return out

    timed("kernels", phase_kernels)
    timed("dense_kernels", phase_dense_kernels)
    timed("truth_tables", phase_truth_tables)
    timed("probe", phase_probe)
    loopback_launches = timed("loopback", phase_loopback)
    cidr_launches = timed("cidr_analyze", phase_cidr_analyze)
    # the steady-state settings of the run, and the slab autotune's winners
    # in a file of its own, gone with the run
    with tempfile.TemporaryDirectory(prefix="chip_smoke-") as tmp, env(
        CYCLONUS_PRE_CACHE="1", CYCLONUS_AUTOTUNE="auto",
        CYCLONUS_AUTOTUNE_CACHE=os.path.join(tmp, "autotune.json"),
    ):
        serve_launches, serve_counts = timed("serve", phase_serve)
        records, main_counts, main_tiered, headline = timed("main_path", phase_main_path)
        mesh_launches = timed("mesh", lambda device: phase_mesh(device, headline))
        telemetry_launches = timed("telemetry", lambda device: phase_telemetry(device, headline))
        chaos_launches = timed("chaos", phase_chaos)
    native_launches = timed("native", phase_native)
    scale_launches = timed("scale", phase_scale)
    guards_launches = timed("guards", lambda device: phase_guards(device, main_counts,
                                                                  main_tiered))
    # the serve engine's counts of the headline cluster before its patch
    # are the main path's untiered counts of the same cluster
    if serve_counts != main_counts:
        raise AssertionError(f"serve counts before the patch {serve_counts} != "
                             f"main path {main_counts}")
    log("serve counts before the patch equal the main path's untiered counts")
    for r in records:
        r["serve_launches"] = serve_launches.get(r["name"], 0)
        r["cidr_launches"] = cidr_launches.get(r["name"], 0)
        r["mesh_launches"] = mesh_launches.get(r["name"], 0)
        r["loopback_launches"] = loopback_launches.get(r["name"], 0)
        r["telemetry_launches"] = telemetry_launches.get(r["name"], 0)
        r["chaos_launches"] = chaos_launches.get(r["name"], 0)
        r["native_launches"] = native_launches.get(r["name"], 0)
        r["scale_launches"] = scale_launches.get(r["name"], 0)
        r["guards_launches"] = guards_launches.get(r["name"], 0)
    log(json.dumps({"phase_s": phase_s, "total_s": time.perf_counter() - t0}))
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
