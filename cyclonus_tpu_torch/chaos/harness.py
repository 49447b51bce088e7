"""The chaos suite: seeded, bounded fault-injection scenarios (a copy of
the reference's chaos/harness.py on the port; the `chaos` command runs
them).

Each scenario injects ONE fault class and asserts the designed
degradation — retry, rollback, fresh autotune search, bounded restart —
plus the differential invariant that matters after the fault: verdicts
stay oracle-exact.  Scenarios are pure functions returning a report dict
with an "ok" flag; run_all wraps each in the bounded-run discipline so a
wedged scenario costs its bound, never the suite.

Every scenario and run_all take a `device`: the torch device of the
engines and of the `serve` subprocesses (`--device`).  None means the
current CUDA device, and raises without one; "cpu" runs on the CPU.

Changes against the reference:

  * `scenario_poisoned_caches`: the port has no AOT executable cache.
    Its persisted state is the slab autotune's winners file
    (engine/autotune.py).  The scenario builds engine A on the dense
    dtype plan (pack=False) with the steady-state cache on and the
    autotune armed ("auto" on a CUDA device; forced "1" on the CPU, with
    the slab choice reopened after the first call as
    tests/test_torch_steady.py drives it), and slab tiles of
    POISON_SLAB_TILE pods so a small cluster spans several.  Its first
    steady counts call searches (K4/K5 against K6) and writes an entry.
    The file is then poisoned in each of three modes (truncate, garbage,
    version_skew), and after each a fresh engine B must not raise, must
    search again, and must give A's counts, grid and pairs.  The report
    has no `aot` key; `rejected` counts the modes after which B searched
    again.
  * `scenario_backend_init_flake` stays a pure drive of the retry
    envelope: the port has no backend attach.
"""

from __future__ import annotations

import contextlib
import json
import os
import random
import subprocess
import sys
import time
from typing import Dict, List, Optional

from . import ChaosError, disarm, injected, reset

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

#: the slab tile (pods) of scenario_poisoned_caches, so a cluster of a
#: few dozen pods spans several tiles and gets a slab plan
POISON_SLAB_TILE = 8

#: the three ways scenario_poisoned_caches breaks the winners file
POISON_MODES = ("truncate", "garbage", "version_skew")


def _ttfv_bound_s() -> float:
    """The bound on a restarted replica's time to first verdict
    (CYCLONUS_CHAOS_TTFV_S, default 150 s: generous because a restart pays
    the torch import and CUDA's start, not just the engine build)."""
    from ..utils import envflags

    return envflags.get_float("CYCLONUS_CHAOS_TTFV_S")


def _device(device) -> str:
    """The scenario's device as a string `--device` takes: `device`, or
    the current CUDA device (raises without one)."""
    from ..carry import resolve_device

    return str(resolve_device(device))


@contextlib.contextmanager
def _env(**values):
    """Set (or, for None, unset) environment variables for the block."""
    saved = {k: os.environ.get(k) for k in values}
    try:
        for k, v in values.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


class _Serve:
    """A real `cyclonus-tpu-torch serve` subprocess on the JSON-lines
    wire (stderr to a file so a chatty child can never deadlock the
    pipe)."""

    def __init__(self, n_pods: int, n_ns: int, seed: int, workdir: str,
                 tag: str, device: str, env: Optional[Dict[str, str]] = None):
        self.stderr_path = os.path.join(workdir, f"serve-{tag}.stderr")
        full_env = dict(os.environ)
        full_env.update(env or {})
        self._stderr = open(self.stderr_path, "w")
        self.started_at = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "cyclonus_tpu_torch", "serve",
             "--synthetic-pods", str(n_pods),
             "--synthetic-namespaces", str(n_ns),
             "--seed", str(seed),
             "--device", device],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=self._stderr, text=True, bufsize=1,
            env=full_env, cwd=REPO,
        )

    def round_trip(self, line: str) -> dict:
        self.proc.stdin.write(line + "\n")
        self.proc.stdin.flush()
        reply = self.proc.stdout.readline()
        if not reply:
            raise RuntimeError(
                f"serve died mid-reply (rc={self.proc.poll()}); stderr "
                f"tail: {open(self.stderr_path).read()[-500:]}"
            )
        return json.loads(reply)

    def kill(self) -> None:
        self.proc.kill()
        self.proc.wait(timeout=30)
        self._stderr.close()

    def close(self) -> int:
        try:
            self.proc.stdin.close()
        except OSError:
            pass
        rc = self.proc.wait(timeout=60)
        self._stderr.close()
        return rc


def _oracle_check(pods_state, namespaces, netpols, queries, verdicts) -> int:
    """Every wire verdict must equal the scalar oracle over the SAME
    post-delta state the harness mirrored — the restarted replica is a
    rebuild, so this IS the incremental==rebuild==oracle parity leg."""
    from ..analysis.oracle import oracle_verdicts
    from ..engine.api import PortCase
    from ..matcher.builder import build_network_policies
    from ..oracle import traffic_for_cell

    policy = build_network_policies(True, list(netpols))
    plist = list(pods_state.values())
    idx = {f"{p[0]}/{p[1]}": i for i, p in enumerate(plist)}
    checked = 0
    for q, v in zip(queries, verdicts):
        if v.get("Error"):
            raise AssertionError(f"query errored after fault: {v}")
        case = PortCase(q.port, q.port_name, q.protocol)
        want = oracle_verdicts(
            policy,
            traffic_for_cell(plist, namespaces, case, idx[q.src], idx[q.dst]),
        )
        got = (v["Ingress"], v["Egress"], v["Combined"])
        if got != want:
            raise AssertionError(
                f"CHAOS PARITY: {q.src}->{q.dst}: service={got} "
                f"oracle={want}"
            )
        checked += 1
    return checked


def scenario_serve_kill_restart(
    seed: int = 0,
    workdir: Optional[str] = None,
    n_pods: int = 24,
    churn_steps: int = 6,
    ttfv_bound_s: Optional[float] = None,
    device=None,
) -> Dict:
    """SIGKILL a serve replica mid-churn, restart it, and bound its
    time-to-first-verdict; verdicts after the restart — including after
    a fresh delta batch — must be oracle-exact."""
    import tempfile

    from ..cli.serve_cmd import synthetic_cluster
    from ..worker.model import Batch, Delta, FlowQuery

    device = _device(device)
    bound = ttfv_bound_s if ttfv_bound_s is not None else _ttfv_bound_s()
    workdir = workdir or tempfile.mkdtemp(prefix="cyclonus-chaos-")
    n_ns = 3
    rng = random.Random(seed)
    pods, namespaces = synthetic_cluster(n_pods, n_ns, seed)
    state = {f"{p[0]}/{p[1]}": p for p in pods}
    keys = list(state)

    def churn_line(step: int) -> tuple:
        key = keys[rng.randrange(len(keys))]
        ns, name = key.split("/", 1)
        labels = {"pod": f"p{step}", "app": f"app{rng.randrange(20)}",
                  "tier": f"tier{rng.randrange(5)}"}
        return key, labels, Batch(
            namespace="", pod="", container="",
            deltas=[Delta(kind="pod_labels", namespace=ns, name=name,
                          labels=dict(labels))],
        ).to_json()

    # phase 1: a replica under churn, killed without warning mid-stream
    srv = _Serve(n_pods, n_ns, seed, workdir, "victim", device)
    applied_before_kill = 0
    for step in range(churn_steps):
        _key, _labels, line = churn_line(step)
        reply = srv.round_trip(line)
        if reply.get("Error"):
            raise AssertionError(f"churn delta rejected: {reply}")
        applied_before_kill += 1
    srv.kill()  # mid-churn: no shutdown, no flush — the crash case

    # phase 2: the restarted replica rebuilds from its source of truth
    # (the deltas above died with the victim — by design: authoritative
    # state is upstream, the replica is a cache of it).  TTFV = process
    # start -> first verdict reply on the wire, torch import, CUDA's
    # start and prewarm included.
    rng2 = random.Random(seed + 1)
    queries = [
        FlowQuery(src=rng2.choice(keys), dst=rng2.choice(keys), port=80,
                  protocol="TCP", port_name="serve-80-tcp")
        for _ in range(8)
    ]
    srv2 = _Serve(n_pods, n_ns, seed, workdir, "restarted", device)
    reply = srv2.round_trip(Batch(
        namespace="", pod="", container="", queries=queries,
    ).to_json())
    ttfv_s = time.perf_counter() - srv2.started_at
    checked = _oracle_check(
        {f"{p[0]}/{p[1]}": p for p in pods}, namespaces, [],
        queries, reply.get("Verdicts") or [],
    )
    # post-restart churn: the incremental path must survive the fault
    key, labels, line = churn_line(999)
    delta_reply = srv2.round_trip(line)
    if delta_reply.get("Mode") not in ("incremental", "class_rebuild"):
        raise AssertionError(
            f"post-restart delta fell off the incremental path: "
            f"{delta_reply}"
        )
    p = state[key]
    post_state = dict({f"{q[0]}/{q[1]}": q for q in pods})
    post_state[key] = (p[0], p[1], labels, p[3])
    reply2 = srv2.round_trip(Batch(
        namespace="", pod="", container="", queries=queries,
    ).to_json())
    checked += _oracle_check(
        post_state, namespaces, [], queries, reply2.get("Verdicts") or []
    )
    rc = srv2.close()
    if rc != 0:
        raise AssertionError(f"restarted serve exited rc={rc}")
    if ttfv_s > bound:
        raise AssertionError(
            f"time-to-first-verdict {ttfv_s:.1f}s exceeds the "
            f"{bound:g}s bound (CYCLONUS_CHAOS_TTFV_S)"
        )
    return {
        "ok": True,
        "applied_before_kill": applied_before_kill,
        "ttfv_s": round(ttfv_s, 3),
        "ttfv_bound_s": bound,
        "oracle_checked": checked,
    }


def _poison_file(path: str, mode: str) -> None:
    """Break the autotune winners file: cut it in half, overwrite it with
    bytes that are not JSON, or keep its entries under a version the
    reader does not know."""
    if mode == "truncate":
        size = os.path.getsize(path)
        with open(path, "rb") as f:
            head = f.read(max(1, size // 2))
        with open(path, "wb") as f:
            f.write(head)
    elif mode == "garbage":
        with open(path, "wb") as f:
            f.write(b"\x00not a pickle\xff" * 64)
    elif mode == "version_skew":
        from ..engine import autotune

        with open(path) as f:
            data = json.load(f)
        data["v"] = autotune.CACHE_VERSION + 9998
        with open(path, "w") as f:
            json.dump(data, f)
    else:
        raise ValueError(mode)


@contextlib.contextmanager
def _slab_tiles(tile: int):
    """The dense kernels' slab tile widths set to `tile` pods for the
    block (dense_kernel reads them when a plan or operands are made)."""
    from ..engine import dense_kernel as dk

    saved = (dk.SLAB_BS, dk.SLAB_BD)
    dk.SLAB_BS = dk.SLAB_BD = int(tile)
    try:
        yield
    finally:
        dk.SLAB_BS, dk.SLAB_BD = saved


def scenario_poisoned_caches(
    seed: int = 0,
    workdir: Optional[str] = None,
    n_pods: int = 24,
    n_policies: int = 4,
    device=None,
) -> Dict:
    """Poison the slab autotune's persisted winners (truncate, garbage,
    version skew), then build a fresh engine after each: it must never
    raise, must search again, and must stay bit-identical to the engine
    that wrote the file (see the module docstring)."""
    import tempfile

    import numpy as np
    import torch

    from ..engine import PortCase, TorchPolicyEngine
    from ..matcher.builder import build_network_policies
    from ..synthetic import build_synthetic

    device = _device(device)
    cuda = torch.device(device).type == "cuda"
    workdir = workdir or tempfile.mkdtemp(prefix="cyclonus-chaos-")
    tune_path = os.path.join(workdir, "autotune.json")
    pods, namespaces, policies = build_synthetic(n_pods, n_policies, random.Random(seed))
    policy = build_network_policies(True, policies)
    cases = [PortCase(80, "chaos-80-tcp", "TCP"), PortCase(81, "chaos-81-udp", "UDP")]
    pairs = [(0, 1), (1, 0), (n_pods - 1, 0)]

    def drive(label: str):
        """Engine, counts, grid, pairs and autotune searches after the
        fused, split and first steady call."""
        eng = TorchPolicyEngine(policy, pods, namespaces, device=device)
        first = eng.evaluate_grid_counts(cases)
        if eng._slab_plan() is None:
            raise AssertionError(f"{label}: no slab plan at {n_pods} pods")
        if not cuda:
            # slab "1" chose the slab kernel at plan time: reopen the
            # choice so the first steady call runs the autotune
            eng._slab_choice = None
        for _ in range(2):  # split (pins), then steady (the autotune)
            if eng.evaluate_grid_counts(cases) != first:
                raise AssertionError(f"{label}: counts moved across the steady state")
        grid = eng.evaluate_grid(cases).combined
        got_pairs = eng.evaluate_pairs(cases, pairs)
        return first, grid, got_pairs, eng.pre_cache_stats()["autotune_searches"]

    with _env(
        CYCLONUS_PACK="0",
        CYCLONUS_PRE_CACHE="1",
        CYCLONUS_PALLAS_SLAB="auto" if cuda else "1",
        CYCLONUS_AUTOTUNE="auto" if cuda else "1",
        CYCLONUS_AUTOTUNE_CACHE=tune_path,
    ), _slab_tiles(POISON_SLAB_TILE):
        counts_a, grid_a, pairs_a, searches_a = drive("engine A")
        if searches_a != 1 or not os.path.exists(tune_path):
            raise AssertionError(
                f"engine A: {searches_a} autotune searches, winners file "
                f"written: {os.path.exists(tune_path)}"
            )
        poisoned = {}
        for mode in POISON_MODES:
            _poison_file(tune_path, mode)
            try:
                counts_b, grid_b, pairs_b, searches_b = drive(f"engine B ({mode})")
            except AssertionError:
                raise
            except Exception as e:
                raise AssertionError(
                    f"a {mode} winners file made the engine raise: "
                    f"{type(e).__name__}: {e}"
                ) from e
            if counts_b != counts_a:
                raise AssertionError(f"counts diverged after {mode}: {counts_b} != {counts_a}")
            if not np.array_equal(grid_a, grid_b):
                raise AssertionError(f"grid diverged after {mode}")
            if not np.array_equal(pairs_a, pairs_b):
                raise AssertionError(f"pairs diverged after {mode}")
            poisoned[mode] = {"searched": searches_b == 1}
    rejected = sum(1 for v in poisoned.values() if v["searched"])
    if rejected != len(POISON_MODES):
        raise AssertionError(
            f"a poisoned winners file was adopted instead of searched "
            f"again: {poisoned}"
        )
    return {
        "ok": True,
        "entries_poisoned": len(POISON_MODES),
        "rejected": int(rejected),
        "modes": poisoned,
        "counts": counts_a,
    }


def scenario_backend_init_flake(seed: int = 0, failures: int = 2, device=None) -> Dict:
    """Arm the `backend_init` point for N failures and drive the retry
    envelope (the jittered backoff helper): the attach must recover on
    attempt N+1 with the structured last-error retained.  The port has
    no backend attach, so `device` is unused."""
    from ..utils.retry import full_jitter_pause
    from . import fire

    tok = reset(f"backend_init:{failures}")
    try:
        rng = random.Random(seed)
        state: Dict = {"attempts": 0, "last_error": None}
        recovered_at = None
        for attempt in range(1, failures + 2):
            state["attempts"] = attempt
            try:
                fire("backend_init")
                recovered_at = attempt
                break
            except ChaosError as e:
                state["last_error"] = {
                    "type": type(e).__name__,
                    "message": str(e)[:200],
                }
            time.sleep(min(0.05, full_jitter_pause(0.01, attempt, rng)))
        if recovered_at != failures + 1:
            raise AssertionError(
                f"retry loop recovered at attempt {recovered_at}, "
                f"expected {failures + 1}"
            )
        if (state["last_error"] or {}).get("type") != "ChaosError":
            raise AssertionError(
                f"structured last_error missing: {state['last_error']}"
            )
        return {
            "ok": True,
            "attempts": state["attempts"],
            "last_error": state["last_error"],
            "injected": injected(),
        }
    finally:
        disarm(tok)


class _InProcessKube:
    """The minimal IKubernetes a worker Client needs: run the in-pod
    worker in-process (same JSON contract as kubectl exec)."""

    def execute_remote_command(self, namespace, pod, container, command):
        from ..worker.worker import run_worker

        return run_worker(command[2]), "", None


def scenario_worker_wire(seed: int = 0, failures: int = 2, device=None) -> Dict:
    """Kill the worker wire N times mid-batch: the driver-side client
    must retry with backoff (cyclonus_tpu_worker_retries_total moves)
    and the batch must complete — a dead worker wedges nothing.  The
    wire runs on the host, so `device` is unused."""
    from ..telemetry import instruments as ti
    from ..worker.client import Client
    from ..worker.model import Batch

    tok = reset(f"worker_wire:{failures}")
    try:
        with _env(CYCLONUS_WORKER_BACKOFF_S="0.01"):
            retries0 = ti.WORKER_RETRIES.value()
            client = Client(_InProcessKube())
            results = client.batch(
                Batch(namespace="x", pod="a", container="c", requests=[])
            )
            retried = int(ti.WORKER_RETRIES.value() - retries0)
        if retried != failures:
            raise AssertionError(
                f"expected {failures} retries, counted {retried}"
            )
        return {
            "ok": True,
            "retries": retried,
            "results": len(results),
            "injected": injected(),
        }
    finally:
        disarm(tok)


def scenario_delta_drop(seed: int = 0, n_pods: int = 16, device=None) -> Dict:
    """Drop a delta batch mid-apply (after the authoritative dicts
    mutated): the service must roll the batch back wholesale, stay
    incremental==rebuild==oracle consistent, and accept the next batch
    cleanly."""
    from ..cli.serve_cmd import synthetic_cluster
    from ..serve import VerdictService
    from ..worker.model import Delta

    device = _device(device)
    pods, namespaces = synthetic_cluster(n_pods, 2, seed)
    svc = VerdictService(pods, namespaces, [], device=device)
    epoch0 = svc.epoch
    key = next(iter(svc.pods))
    ns, name = key.split("/", 1)
    delta = Delta(kind="pod_labels", namespace=ns, name=name,
                  labels={"app": "chaos", "pod": "p0", "tier": "t0"})
    tok = reset("delta_apply:1")
    try:
        raised = False
        try:
            svc.apply([delta])
        except ChaosError:
            raised = True
        if not raised:
            raise AssertionError("injected delta_apply fault did not fire")
        if svc.epoch != epoch0:
            raise AssertionError("epoch advanced through a dropped batch")
        if svc.pods[key][2].get("app") == "chaos":
            raise AssertionError("rollback left the mutated pod labels")
        parity1 = svc.verify_parity(oracle_samples=8)
        report = svc.apply([delta])
        if report["epoch"] != epoch0 + 1:
            raise AssertionError(f"post-fault apply failed: {report}")
        parity2 = svc.verify_parity(oracle_samples=8)
        return {
            "ok": True,
            "rolled_back": True,
            "parity": [parity1, parity2],
            "injected": injected(),
        }
    finally:
        disarm(tok)


def scenario_slo_ttfv(
    seed: int = 0,
    workdir: Optional[str] = None,
    device=None,
) -> Dict:
    """The SLO leg, both halves of the ttfv objective's contract:

    (a) kill/restart mid-churn must stay inside the DECLARED
        time-to-first-verdict error budget — CYCLONUS_SLO_TTFV_S, the
        same target the in-service controller enforces, not the looser
        harness bound;
    (b) the breach path: an over-budget first verdict (forced with a
        tiny target) must dump the flight recorder with the triggering
        objective in its reason."""
    import dataclasses
    import tempfile

    from ..slo.engine import SloController
    from ..slo.objectives import declared_objectives
    from ..utils import envflags

    workdir = workdir or tempfile.mkdtemp(prefix="cyclonus-chaos-slo-")

    # (a) restart bounded by the declared objective (smaller cluster
    # than serve_kill_restart: this leg asserts the budget, not churn
    # breadth)
    ttfv_target = envflags.get_float("CYCLONUS_SLO_TTFV_S")
    restart = scenario_serve_kill_restart(
        seed=seed, workdir=workdir, n_pods=12, churn_steps=3,
        ttfv_bound_s=ttfv_target, device=device,
    )

    # (b) forced breach -> black-box dump naming the objective
    dump_file = os.path.join(workdir, "slo-breach.json")
    ttfv_obj = next(o for o in declared_objectives() if o.name == "ttfv")
    ctl = SloController(
        [dataclasses.replace(ttfv_obj, target_s=0.001)], enforce=True
    )
    with _env(CYCLONUS_FLIGHT_RECORDER_PATH=dump_file):
        ctl.observe_ttfv(5.0)  # 5s against a 1ms target: exhaustion
    if ctl.state_of("ttfv") != "exhausted":
        raise AssertionError(
            f"over-budget ttfv left state {ctl.state_of('ttfv')!r}, "
            "expected 'exhausted'"
        )
    if not os.path.exists(dump_file):
        raise AssertionError("slo breach produced no flight-recorder dump")
    with open(dump_file) as f:
        dumped = json.load(f)
    if dumped.get("reason") != "slo-breach:ttfv":
        raise AssertionError(
            f"breach dump reason {dumped.get('reason')!r} does not name "
            "the objective (want 'slo-breach:ttfv')"
        )
    breach_entries = [
        e for e in dumped.get("entries") or []
        if e.get("path") == "slo.breach"
    ]
    if not breach_entries:
        raise AssertionError("breach dump carries no slo.breach entry")
    return {
        "ok": True,
        "restart": restart,
        "ttfv_budget_s": ttfv_target,
        "breach_dump": dump_file,
        "breach_reason": dumped["reason"],
    }


def scenario_audit_divergence(
    seed: int = 0,
    workdir: Optional[str] = None,
    n_pods: int = 12,
    check_budget: int = 32,
    device=None,
) -> Dict:
    """The audit plane's end-to-end detection contract, on a REAL serve
    under churn: arm `verdict_corrupt` (one flipped sampled verdict) and
    the shadow-oracle sampler must detect it within the check budget,
    leaving an `audit-divergence` flight-recorder bundle on disk; then
    the SAME churn with the point disarmed must finish with no
    divergence dump at all."""
    import tempfile

    from ..cli.serve_cmd import synthetic_cluster
    from ..worker.model import Batch, Delta, FlowQuery

    device = _device(device)
    workdir = workdir or tempfile.mkdtemp(prefix="cyclonus-chaos-audit-")
    n_ns = 2
    rng = random.Random(seed)

    def churn(srv, keys, dump_file, budget) -> Optional[int]:
        """Deltas + query batches until the divergence dump appears (the
        audit worker is async — poll between batches); returns the
        number of audited-eligible queries sent before detection, or
        None when the budget ran out without a dump."""
        sent = 0
        for step in range(budget):
            key = keys[rng.randrange(len(keys))]
            ns, name = key.split("/", 1)
            line = Batch(
                namespace="", pod="", container="",
                deltas=[Delta(
                    kind="pod_labels", namespace=ns, name=name,
                    labels={"pod": f"p{step}", "app": f"a{step % 7}"},
                )],
                queries=[FlowQuery(
                    src=keys[rng.randrange(len(keys))],
                    dst=keys[rng.randrange(len(keys))],
                    port=80, protocol="TCP", port_name="serve-80-tcp",
                )],
            ).to_json()
            reply = srv.round_trip(line)
            if reply.get("Error"):
                raise AssertionError(f"churn line rejected: {reply}")
            sent += 1
            deadline = time.perf_counter() + 0.5
            while time.perf_counter() < deadline:
                if os.path.exists(dump_file):
                    return sent
                time.sleep(0.05)
        return None

    pods, _namespaces = synthetic_cluster(n_pods, n_ns, seed)
    keys = [f"{p[0]}/{p[1]}" for p in pods]

    # phase 1: armed — every query sampled (rate 1.0), one corruption
    armed_dump = os.path.join(workdir, "audit-armed.json")
    srv = _Serve(n_pods, n_ns, seed, workdir, "audit-armed", device, env={
        "CYCLONUS_AUDIT": "1",
        "CYCLONUS_AUDIT_RATE": "1.0",
        "CYCLONUS_CHAOS": "verdict_corrupt:1",
        "CYCLONUS_FLIGHT_RECORDER_PATH": armed_dump,
    })
    try:
        detected_after = churn(srv, keys, armed_dump, check_budget)
    finally:
        srv.kill()
    if detected_after is None:
        raise AssertionError(
            f"armed verdict_corrupt went undetected through "
            f"{check_budget} checks (no audit-divergence dump)"
        )
    with open(armed_dump) as f:
        dumped = json.load(f)
    if dumped.get("reason") != "audit-divergence":
        raise AssertionError(
            f"divergence dump reason {dumped.get('reason')!r} "
            "(want 'audit-divergence')"
        )
    div_entries = [
        e for e in dumped.get("entries") or []
        if e.get("path") == "audit.divergence"
    ]
    if not div_entries:
        raise AssertionError("divergence dump carries no repro bundle")
    bundle = div_entries[-1]
    for field in ("query", "served", "oracle", "route", "epoch", "config"):
        if field not in bundle:
            raise AssertionError(f"repro bundle missing {field!r}")

    # phase 2: disarmed — the same churn must audit clean (no dump)
    clean_dump = os.path.join(workdir, "audit-clean.json")
    srv2 = _Serve(n_pods, n_ns, seed, workdir, "audit-clean", device, env={
        "CYCLONUS_AUDIT": "1",
        "CYCLONUS_AUDIT_RATE": "1.0",
        "CYCLONUS_CHAOS": "",
        "CYCLONUS_FLIGHT_RECORDER_PATH": clean_dump,
    })
    try:
        clean = churn(srv2, keys, clean_dump, min(check_budget, 8))
        rc = srv2.close()
    except Exception:
        srv2.kill()
        raise
    if rc != 0:
        raise AssertionError(f"disarmed serve exited rc={rc}")
    if clean is not None or os.path.exists(clean_dump):
        raise AssertionError(
            "disarmed run produced an audit-divergence dump — the "
            "sampler diverged with no injected fault"
        )
    return {
        "ok": True,
        "detected_after_checks": detected_after,
        "check_budget": check_budget,
        "bundle_route": bundle.get("route"),
        "bundle_epoch": bundle.get("epoch"),
        "dump": armed_dump,
    }


SCENARIOS = {
    "serve_kill_restart": scenario_serve_kill_restart,
    "audit_divergence": scenario_audit_divergence,
    "slo_ttfv": scenario_slo_ttfv,
    "poisoned_caches": scenario_poisoned_caches,
    "backend_init_flake": scenario_backend_init_flake,
    "worker_wire": scenario_worker_wire,
    "delta_drop": scenario_delta_drop,
}


def run_all(
    seed: int = 0,
    only: Optional[List[str]] = None,
    bound_s: float = 420.0,
    device=None,
) -> Dict:
    """Run the (selected) scenarios on `device`, each bounded; returns
    the suite report with per-scenario results and the overall ok
    flag."""
    from ..utils.bounded import run_bounded

    device = _device(device)
    names = only or list(SCENARIOS)
    out: Dict = {"seed": seed, "scenarios": {}, "ok": True}
    for name in names:
        fn = SCENARIOS[name]
        t0 = time.perf_counter()
        status, value = run_bounded(lambda f=fn: f(seed=seed, device=device), bound_s)
        if status == "ok":
            report = value
        else:
            report = {
                "ok": False,
                "error": (
                    f"scenario exceeded the {bound_s:g}s bound"
                    if status == "timeout"
                    else f"{type(value).__name__}: {value}"
                ),
            }
        report["seconds"] = round(time.perf_counter() - t0, 3)
        out["scenarios"][name] = report
        out["ok"] = out["ok"] and bool(report.get("ok"))
    return out
