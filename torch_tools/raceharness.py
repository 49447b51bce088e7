"""Schedule-fuzzing race harness of the port: the dynamic half of the
lock-discipline gate over cyclonus_tpu_torch (tools/locklint.py is the
static half; a copy of the reference package's tests/raceharness.py on
the port's telemetry, worker client and engine).

CPython has no TSan, so this harness makes its own schedules: for each
seeded SCHEDULE, every scenario spins up 8-16 threads that rendezvous on
a barrier and then interleave mutations with randomized yields (sleep(0)
forces a GIL switch point, the occasional microsecond sleep moves it),
and the main thread asserts the scenario's invariants afterwards — no
lost updates, ring length bound, monotone counters, cache/choice
coherence.

Scenarios (one per shared-mutable-state subsystem):

  spans         SpanRegistry.record from all threads: flat counts must
                sum exactly
  metrics       Counter/Histogram mutation + concurrent Prometheus
                render: final values exact, reader sees counters
                monotone
  ring          BoundedRing append vs snapshot/len/appended readers:
                length bound holds, lifetime count exact, per-thread
                order preserved in the window
  events_since  single writer + mark()/since() readers: since(m) must
                never return a PRE-marker event
  worker_ingest concurrent worker-client batches shipping foreign-pid
                trace events: every event ingested exactly once, ring
                stays bounded
  engine_cache  TorchPolicyEngine._slab_ops_for fills racing a rejection
                of the slab kernel on --device — `choice is False` must
                imply the operand cache is empty

Run it with CYCLONUS_GUARD_CHECK=1 so the guards.Guarded descriptors
(utils/guards.py) also assert the declared locks are really held on
every access the schedules reach:

    CYCLONUS_GUARD_CHECK=1 python torch_tools/raceharness.py \
        --schedules 50 --threads 8 --seed 1234 [--device cpu]

tests/test_torch_lint.py runs exactly that on the CPU; --full runs the
extended 16-thread sweep of 200 schedules.  The last line of the output
is one JSON object (torch_tools/_harness.py).
"""

from __future__ import annotations

import json
import random
import sys
import threading
import time
import traceback
from typing import Callable, Dict, List, Optional, Sequence

import _harness


class Pacing:
    """Per-thread randomized yield points, pre-generated on the main
    thread so a (seed, schedule) pair is reproducible."""

    def __init__(self, jitters: Sequence[float]):
        self.jitters = list(jitters)
        self.i = 0

    def step(self) -> None:
        j = self.jitters[self.i % len(self.jitters)]
        self.i += 1
        if j >= 0:
            time.sleep(j)  # sleep(0) = forced GIL switch point


def _make_pacing(rng: random.Random) -> Pacing:
    # mostly free-running, frequent sleep(0) switch points, occasional
    # real microsleeps to push threads across critical-section edges
    choices = (-1.0, -1.0, 0.0, 0.0, 0.0, 1e-5, 5e-5)
    return Pacing([rng.choice(choices) for _ in range(64)])


def run_threads(
    n: int, rng: random.Random, body: Callable[[int, Pacing], None]
) -> None:
    """Barrier-start n threads on `body(thread_idx, pacing)`; re-raise
    the first failure with its traceback."""
    barrier = threading.Barrier(n)
    failures: List[str] = []
    flock = threading.Lock()

    def runner(idx: int, pacing: Pacing) -> None:
        try:
            barrier.wait(timeout=30)
            body(idx, pacing)
        except BaseException:
            with flock:
                failures.append(f"thread {idx}:\n{traceback.format_exc()}")

    threads = [
        threading.Thread(
            target=runner, args=(i, _make_pacing(rng)), daemon=True
        )
        for i in range(n)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive(), "harness thread wedged (possible deadlock)"
    assert not failures, "\n".join(failures)


# --------------------------------------------------------------------------
# scenarios
# --------------------------------------------------------------------------

OPS = 120  # mutations per thread per scenario


def scenario_spans(rng: random.Random, nthreads: int) -> None:
    from cyclonus_tpu_torch.telemetry.spans import SpanRegistry

    reg = SpanRegistry()

    def body(idx: int, pacing: Pacing) -> None:
        for k in range(OPS):
            name = f"n{k % 4}"
            reg.record(f"root/{name}", name, 0.001, {"t": idx})
            if k % 16 == 0:
                pacing.step()
                reg.stats()  # concurrent reader of the same lock

    run_threads(nthreads, rng, body)
    stats = reg.stats()
    total = sum(int(rec["count"]) for rec in stats.values())
    assert total == nthreads * OPS, f"lost span updates: {total}"
    tree = reg.tree()
    assert sum(int(rec["count"]) for rec in tree.values()) == nthreads * OPS


def scenario_metrics(rng: random.Random, nthreads: int) -> None:
    from cyclonus_tpu_torch.telemetry.metrics import MetricRegistry

    reg = MetricRegistry()
    ctr = reg.counter("race_total", "t", labelnames=("lane",))
    hist = reg.histogram("race_seconds", "t")
    monotone_failures: List[str] = []

    def body(idx: int, pacing: Pacing) -> None:
        if idx == 0:
            # dedicated reader: counters must only ever go up, and the
            # exposition renderer must be safe against live mutation
            last = 0.0
            for _ in range(OPS):
                v = ctr.value(lane="a")
                if v < last:
                    monotone_failures.append(f"{v} < {last}")
                last = v
                reg.render_prometheus()
                pacing.step()
            return
        for k in range(OPS):
            ctr.inc(lane="a")
            hist.observe(0.01)
            if k % 8 == 0:
                pacing.step()

    run_threads(nthreads, rng, body)
    writers = nthreads - 1
    assert not monotone_failures, monotone_failures[:3]
    assert ctr.value(lane="a") == writers * OPS, "lost counter increments"
    (_labels, st) = hist.samples()[0]
    assert st["count"] == writers * OPS, "lost histogram observations"
    assert abs(st["sum"] - 0.01 * writers * OPS) < 1e-6


def scenario_ring(rng: random.Random, nthreads: int) -> None:
    from cyclonus_tpu_torch.utils.bounded import BoundedRing

    cap = 64
    ring = BoundedRing(cap)

    def body(idx: int, pacing: Pacing) -> None:
        if idx == 0:
            seen = 0
            for _ in range(OPS):
                assert len(ring) <= cap, "ring exceeded its bound"
                snap, appended = ring.snapshot_with_count()
                assert len(snap) <= cap
                assert appended >= seen, "lifetime count went backwards"
                seen = appended
                pacing.step()
            return
        for k in range(OPS):
            ring.append((idx, k))
            if k % 8 == 0:
                pacing.step()

    run_threads(nthreads, rng, body)
    writers = nthreads - 1
    assert ring.appended == writers * OPS, "lost appends"
    assert len(ring) == min(cap, writers * OPS)
    # within the surviving window, each writer's items stay in order
    last_per_writer = {}
    for w, k in ring.snapshot():
        assert last_per_writer.get(w, -1) < k, "per-thread order broken"
        last_per_writer[w] = k


def scenario_events_since(rng: random.Random, nthreads: int) -> None:
    from cyclonus_tpu_torch.telemetry import events

    events.reset()
    events.enable()
    violations: List[str] = []

    def body(idx: int, pacing: Pacing) -> None:
        if idx == 0:
            # the single writer: append order == stamp order, so the
            # marker contract is exactly "returned k must exceed m"
            for k in range(1, OPS * 4 + 1):
                events.record("B", "w", "p/w", {"k": k})
                if k % 8 == 0:
                    pacing.step()
            return
        for _ in range(OPS):
            m = events.mark()
            pacing.step()
            for e in events.since(m):
                if e["args"]["k"] <= m:
                    violations.append(
                        f"since({m}) returned pre-marker event k={e['args']['k']}"
                    )
            pacing.step()

    try:
        run_threads(nthreads, rng, body)
    finally:
        events.disable()
    assert not violations, violations[:3]
    assert events.RING.appended == OPS * 4
    events.reset()


def scenario_worker_ingest(rng: random.Random, nthreads: int) -> None:
    from cyclonus_tpu_torch.telemetry import events
    from cyclonus_tpu_torch.worker.client import Client
    from cyclonus_tpu_torch.worker.model import Batch, Request

    events.reset()
    events.disable()  # only ingest() may touch the ring in this scenario
    base_appended = events.RING.appended

    class FakeKube:
        """Echoes one ok Result per request, each carrying one
        foreign-pid trace event (pid varies per call so dedup-by-own-pid
        never triggers)."""

        def execute_remote_command(self, namespace, pod, container, command):
            payload = json.loads(command[2])
            results = []
            for i, r in enumerate(payload["Requests"]):
                results.append(
                    {
                        "Request": r,
                        "Output": "ok",
                        "Error": "",
                        "TraceEvents": [
                            {
                                "ph": "B",
                                "name": "worker.batch",
                                "path": "step/worker.batch",
                                "ts": 1.0 + i,
                                "pid": 10_000_000 + i,
                                "tid": 1,
                            }
                        ],
                    }
                )
            return json.dumps(results), "", None

    client = Client(FakeKube())
    per_batch = 3

    def body(idx: int, pacing: Pacing) -> None:
        for k in range(OPS // 4):
            batch = Batch(
                namespace="ns",
                pod=f"pod{idx}",
                container="c",
                requests=[
                    Request(key=f"{idx}/{k}/{j}", protocol="TCP", host="h", port=80)
                    for j in range(per_batch)
                ],
                trace_id="race-harness",
                parent_span="step",
            )
            results = client.batch(batch)
            assert len(results) == per_batch
            assert all(r.is_success() for r in results)
            if k % 4 == 0:
                pacing.step()

    run_threads(nthreads, rng, body)
    expected = nthreads * (OPS // 4) * per_batch
    delta = events.RING.appended - base_appended
    assert delta == expected, f"ingest lost/duplicated events: {delta} != {expected}"
    assert len(events.RING) <= events.RING.maxlen
    events.reset()


def scenario_engine_cache(rng: random.Random, nthreads: int, device="cpu") -> None:
    """The TOCTOU family of the slab operand cache on the port's
    TorchPolicyEngine._slab_ops_for: operand builds racing a rejection
    of the slab kernel — `choice is False` must imply the cache is
    empty, and the fast path must never crash on a concurrent clear.
    The engine is a stub with a pinned precompute on `device`; the
    operand gather is replaced by one that allocates on it and widens
    the build window the rejection races."""
    import torch

    from cyclonus_tpu_torch.engine import api, dense_kernel
    from cyclonus_tpu_torch.utils import guards

    eng = object.__new__(api.TorchPolicyEngine)
    # guards.lock(), as the real _init_state uses: under
    # CYCLONUS_GUARD_CHECK=1 this is the ownership-checkable RLock
    eng._slab_lock = guards.lock()
    eng._slab_choice = None
    with eng._slab_lock:
        eng._slab_ops_cache = None
    eng._slab_plan_state = {
        "egress": torch.zeros((2, 2), dtype=torch.int32, device=device),
        "ingress": torch.zeros((2, 2), dtype=torch.int32, device=device),
        "w": 8,
    }
    side = {k: torch.zeros((4,), device=device) for k in ("tmatch", "has_target", "tallow_bf")}
    eng._pre_cache = ("key", {"ops": None, "pre": {"egress": side, "ingress": side}})
    eng._pod_keys = [f"ns/p{i}" for i in range(4)]
    builds = [0]
    build_lock = threading.Lock()

    def fake_ops(*args, w=None):
        with build_lock:
            builds[0] += 1
        time.sleep(1e-5)  # widen the build window the rejection races
        return {"a": torch.zeros((8,), device=device)}

    real_ops = dense_kernel.slab_operands
    dense_kernel.slab_operands = fake_ops
    try:
        def body(idx: int, pacing: Pacing) -> None:
            if idx == 0:
                # the rejection of the slab kernel (the autotune's
                # losing branch, _settle_slab_choice), at a random point
                pacing.step()
                with eng._slab_lock:
                    eng._slab_choice = False
                    eng._slab_ops_cache = None
                return
            for k in range(OPS // 4):
                ops = eng._slab_ops_for("key")
                assert ops is not None
                if k % 4 == 0:
                    pacing.step()

        run_threads(nthreads, rng, body)
    finally:
        dense_kernel.slab_operands = real_ops
    with eng._slab_lock:
        choice, cached = eng._slab_choice, eng._slab_ops_cache
    assert choice is False
    assert cached is None, "rejected slab kernel left operands pinned"
    assert builds[0] >= 1


SCENARIOS = {
    "spans": scenario_spans,
    "metrics": scenario_metrics,
    "ring": scenario_ring,
    "events_since": scenario_events_since,
    "worker_ingest": scenario_worker_ingest,
    "engine_cache": scenario_engine_cache,
}


def run(
    schedules: int,
    threads: int,
    seed: int,
    scenarios: Optional[List[str]] = None,
    verbose: bool = False,
    device="cpu",
) -> Dict:
    names = scenarios or list(SCENARIOS)
    t0 = time.perf_counter()
    for s in range(schedules):
        rng = random.Random(seed + s)
        # at least 8 ways; the extended sweep raises the ceiling to 16
        nthreads = rng.randint(min(8, threads), threads)
        for name in names:
            if name == "engine_cache":
                scenario_engine_cache(rng, nthreads, device)
            else:
                SCENARIOS[name](rng, nthreads)
        if verbose:
            print(
                f"schedule {s + 1}/{schedules} ok "
                f"({nthreads} threads, {time.perf_counter() - t0:.1f}s)",
                file=sys.stderr,
            )
    seconds = time.perf_counter() - t0
    print(
        f"raceharness: {schedules} schedule(s) x {len(names)} scenario(s) "
        f"passed in {seconds:.1f}s "
        f"(seed={seed}, threads<={threads}, device={device})",
        file=sys.stderr,
    )
    return {"schedules": schedules, "scenarios": names, "threads": threads, "seed": seed,
            "seconds": seconds}


def main(argv: Optional[List[str]] = None) -> int:
    ap = _harness.parser(__doc__)
    ap.add_argument("--schedules", type=int, default=50)
    ap.add_argument("--threads", type=int, default=8)
    ap.add_argument("--seed", type=int, default=1234)
    ap.add_argument(
        "--scenario",
        action="append",
        choices=sorted(SCENARIOS),
        help="run only these scenarios (default: all)",
    )
    args = ap.parse_args(argv)
    if args.full:
        args.schedules, args.threads, args.seed = 200, 16, 99
    device = _harness.resolve_device(args.device)
    results = run(
        args.schedules, args.threads, args.seed, args.scenario, args.verbose, device
    )
    _harness.report("race", device, results)
    return 0


if __name__ == "__main__":
    sys.exit(main())
