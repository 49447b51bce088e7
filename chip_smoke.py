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
                zero weights.  Exact equality;
  4. truth tables — TorchPolicyEngine.evaluate_grid on the card against
                the scalar oracle, for every policy of all_examples();
  5. main path — the benchmark's synthetic cluster (100,000 pods x 10,000
                policies, seed 20260729, port cases TCP 80 and named UDP
                81) through the default engine (class-compressed route,
                weighted kernel) and with class_compress="0" (dense route,
                plain-epilogue kernel); both counts must agree, both
                kernels must have launched, and the plain version must
                agree with the kernel path at a sub-size and with each
                kernel at the main-path shapes.  Times: encode, precompute,
                kernel (median of 5 CUDA-event runs), plain version, the
                kernel's bound, end-to-end cells/s.

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
#: the benchmark's headline cluster (bench.py): pods, policies, seed
N_PODS = 100_000
N_POLICIES = 10_000
SEED = 20260729
#: per-cell epilogue instructions of the packed counts kernel: two !=0
#: tests, two ORs with !has, the combined AND and three accumulations
EPILOGUE_OPS = 8


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


def phase_kernels(device) -> None:
    import numpy as np
    import torch

    from cyclonus_tpu_torch.engine.packed_kernel import (
        verdict_counts_packed,
        verdict_counts_packed_plain,
    )

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
            got = verdict_counts_packed(*args, **kw)
            torch.cuda.synchronize()
            want = verdict_counts_packed_plain(*args, **kw)
            if not torch.equal(got, want):
                bad = int((got != want).sum())
                raise AssertionError(
                    f"kernel != plain at q={q} we={we} wi={wi} ns={ns} nd={nd} "
                    f"{sorted(kw)}: {bad} entries differ"
                )
            n_checked += 1
    log(f"kernels: {n_checked} kernel-vs-plain checks equal")


def phase_truth_tables(device) -> None:
    from cyclonus_tpu_torch.engine import PortCase, TorchPolicyEngine
    from cyclonus_tpu_torch.kube import examples
    from cyclonus_tpu_torch.matcher import build_network_policies
    from cyclonus_tpu_torch.oracle import oracle_grid

    pods, namespaces = examples.example_cluster()
    cases = [
        PortCase(80, "serve-80-tcp", "TCP"),
        PortCase(5000, "", "TCP"),
        PortCase(53, "", "UDP"),
    ]
    policy_sets = [[p] for p in examples.all_examples()] + [examples.all_examples()]
    cells = 0
    for i, policies in enumerate(policy_sets):
        policy = build_network_policies(True, policies)
        grid = TorchPolicyEngine(policy, pods, namespaces, device=device).evaluate_grid(cases)
        want = oracle_grid(policy, pods, namespaces, cases)
        for k, v in want.items():
            got = getattr(grid, k)
            if got.shape != v.shape or not (got == v).all():
                raise AssertionError(f"policy set {i}: {k} grid differs from the oracle")
            cells += v.size
    log(f"truth tables: {len(policy_sets)} policy sets, {cells} cells equal to the oracle")


def bound(args, w_dst, out):
    """(ms, bound_by, ops, bytes): the least time the card could take for one
    packed counts call on these inputs — the larger of bytes (each input
    read once, the output written once) over HBM bandwidth and 32-bit
    integer instructions (one LOP3 per packed word, cell and direction,
    plus the epilogue) over the integer pipe's peak — and the two counts."""
    tmatch_e_pk, _has_e, tallow_e_pk, tmatch_i_pk, _has_i, _tallow_i_pk = args
    we, ns = tmatch_e_pk.shape
    wi, nd = tmatch_i_pk.shape
    q = tallow_e_pk.shape[2]
    nbytes = sum(a.numel() * a.element_size() for a in args)
    nbytes += out.numel() * out.element_size()
    if w_dst is not None:
        nbytes += w_dst.numel() * w_dst.element_size()
    ops = q * ns * nd * (we + wi + EPILOGUE_OPS)
    by = "operations" if ops / PEAK_INT_OPS >= nbytes / PEAK_BYTES else "bytes"
    return max(ops / PEAK_INT_OPS, nbytes / PEAK_BYTES) * 1e3, by, ops, nbytes


def kernel_record(name, source, replaces, pre, n_pods, w_dst, launches):
    """Hold the kernel against its plain version on the main path's
    inputs and time both."""
    import torch

    from cyclonus_tpu_torch.engine import packed_kernel as pk

    e, ig = pre["egress"], pre["ingress"]
    args = [
        e["tmatch_pk"], e["has_target"], e["tallow_pk"],
        ig["tmatch_pk"], ig["has_target"], ig["tallow_pk"],
    ]
    kw = {"n_pods": n_pods, "w_dst": w_dst}
    got = pk.verdict_counts_packed(*args, **kw)
    torch.cuda.synchronize()
    want = pk.verdict_counts_packed_plain(*args, **kw)
    if not torch.equal(got, want):
        raise AssertionError(f"{name}: kernel != plain at the main-path shapes")
    max_abs_err = float((got.double() - want.double()).abs().max())
    valid_src, valid_dst, bs, bd = pk._resolve(
        args[0], args[3], n_pods, None, None, None, None
    )
    ops = pk._packed_operands(*args, valid_src, valid_dst, w_dst, bs, bd)
    ms = time_ms(lambda: pk._counts_cuda(ops, bs), reps=5, warm=1)
    plain_ms = time_ms(lambda: pk._counts_plain(ops, bs), reps=1, warm=0)
    b_ms, b_by, b_ops, b_bytes = bound(args, w_dst, got)
    rec = {
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": None,
    }
    shape = {
        "q": int(args[2].shape[2]), "we": int(args[0].shape[0]), "wi": int(args[3].shape[0]),
        "ns": int(args[0].shape[1]), "nd": int(args[3].shape[1]),
    }
    log(
        f"{name}: {ms:.3f} ms (bound {b_ms:.3f} ms: {b_ops:.4e} ops, {b_bytes:.4e} bytes; "
        f"plain {plain_ms:.1f} ms) at {shape}, equal to plain (tolerance: exact)"
    )
    return rec


def phase_main_path(device):
    import torch

    from cyclonus_tpu_torch.engine import PortCase, TorchPolicyEngine
    from cyclonus_tpu_torch.engine import packed_kernel as pk
    from cyclonus_tpu_torch.engine.tiled import _precompute, class_rowsums_plan
    from cyclonus_tpu_torch.matcher import build_network_policies
    from cyclonus_tpu_torch.synthetic import build_synthetic

    n_pods, n_policies = N_PODS, N_POLICIES
    t0 = time.perf_counter()
    pods, namespaces, policies = build_synthetic(n_pods, n_policies, random.Random(SEED))
    policy = build_network_policies(True, policies)
    log(f"main path: synthetic {n_pods} pods x {n_policies} policies built in "
        f"{time.perf_counter() - t0:.2f} s")
    cases = [PortCase(80, "serve-80-tcp", "TCP"), PortCase(81, "serve-81-udp", "UDP")]

    # the main path: both entry routes, counters zeroed just before and
    # read just after
    pk.reset_launches()
    eng_a = TorchPolicyEngine(policy, pods, namespaces, device=device)
    t0 = time.perf_counter()
    counts_a = eng_a.evaluate_grid_counts(cases)
    first_a = time.perf_counter() - t0
    eng_b = TorchPolicyEngine(policy, pods, namespaces, device=device, class_compress="0")
    t0 = time.perf_counter()
    counts_b = eng_b.evaluate_grid_counts(cases)
    first_b = time.perf_counter() - t0
    launches = dict(pk.LAUNCHES)
    log(f"main path launches: {launches}")

    pc = eng_a.pod_classes()
    if pc is None or not eng_a._class_counts_eligible(len(cases)):
        raise AssertionError("the default engine did not take the class-compressed route")
    if eng_b.pod_classes() is not None:
        raise AssertionError("class_compress=0 engine holds class state")
    if counts_a != counts_b:
        raise AssertionError(f"class route {counts_a} != dense route {counts_b}")
    cells = counts_a["cells"]
    if cells != len(cases) * n_pods * n_pods or not 0 < counts_a["combined"] <= cells:
        raise AssertionError(f"implausible counts {counts_a}")
    if launches["packed_counts"] < 1 or launches["packed_rowsums"] < 1:
        raise AssertionError(f"a kernel of the main path never launched: {launches}")
    log(f"main path counts (both routes): {json.dumps(counts_a)}")
    class_axis = int(eng_a._class_state["ctensors"]["pod_ns_id"].shape[0])
    log(f"classes: {pc.n_classes} for {n_pods} pods, class axis {class_axis}")

    # warm end-to-end
    e2e_a = time_ms(lambda: eng_a.evaluate_grid_counts(cases), reps=3, warm=0) / 1e3
    e2e_b = time_ms(lambda: eng_b.evaluate_grid_counts(cases), reps=3, warm=0) / 1e3
    busy = {}
    for route, eng in (("class", eng_a), ("dense", eng_b)):
        share, top = device_time_profile(lambda e=eng: e.evaluate_grid_counts(cases))
        busy[route] = share
        if share is None:
            log(f"device busy share, {route} route: not measured (no device time traced)")
        else:
            log(f"device busy share, {route} route: {share:.4f}; top kernels ms/call: {top}")

    # precompute, then each kernel against its plain version on the
    # main path's own inputs
    tens_b = eng_b._dense_counts_tensors(cases)
    pre_b = _precompute(tens_b, True)
    pre_ms_b = time_ms(lambda: _precompute(tens_b, True), reps=3, warm=0)
    tens_a = eng_a._with_cases(eng_a._class_dev(), cases)
    pre_a = _precompute(tens_a, True)
    pre_ms_a = time_ms(lambda: _precompute(tens_a, True), reps=3, warm=0)

    w = torch.from_numpy(class_rowsums_plan(tens_a, pc.n_classes, pc.class_size)).to(device)
    src = "cyclonus_tpu_torch/csrc/packed_counts.cu"
    ref = "cyclonus_tpu/engine/pallas_kernel.py:689"
    records = [
        kernel_record("packed_counts", src, ref, pre_b, n_pods, None, launches["packed_counts"]),
        kernel_record("packed_rowsums", src, ref, pre_a, int(tens_a["pod_ns_id"].shape[0]), w,
                      launches["packed_rowsums"]),
    ]

    # the plain version through the engine at a sub-size, dense route
    n_sub = 8192
    sp, sn, spol = build_synthetic(n_sub, n_policies * n_sub // n_pods, random.Random(SEED))
    eng_c = TorchPolicyEngine(build_network_policies(True, spol), sp, sn, device=device,
                              class_compress="0")
    got_c = eng_c.evaluate_grid_counts(cases)
    want_c = eng_c._counts_dense(cases, counts_fn=pk.verdict_counts_packed_plain)
    if got_c != want_c:
        raise AssertionError(f"sub-size {n_sub}: kernel path {got_c} != plain {want_c}")
    log(f"sub-size {n_sub} pods dense route: kernel path == plain version ({json.dumps(got_c)})")

    # the main path's end-to-end numbers in one line, next to the kernels
    # line at the end of the output
    routes = {
        "class": {"encode_s": eng_a.encode_s, "first_call_s": first_a, "warm_s": e2e_a,
                  "precompute_ms": pre_ms_a, "pod_axis": class_axis},
        "dense": {"encode_s": eng_b.encode_s, "first_call_s": first_b, "warm_s": e2e_b,
                  "precompute_ms": pre_ms_b, "pod_axis": int(tens_b["pod_ns_id"].shape[0])},
    }
    for route, r in routes.items():
        r["cells_per_s"] = cells / r["warm_s"]
        r["device_busy_share"] = busy[route]
    log(json.dumps({"main_path": {"pods": n_pods, "policies": n_policies, "seed": SEED,
                                  "counts": counts_a, "classes": pc.n_classes,
                                  "routes": routes}}))
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
    phase_truth_tables(device)
    records = phase_main_path(device)
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
