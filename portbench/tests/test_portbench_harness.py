"""The harness on the CPU: the metric arithmetic, cells and metrics found
by name, the refusal without a card, the imports, and whole runs at a
tiny size — sound, under the control, and with the timed path broken."""

import ast
import io
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import harness
from portbench.tests.conftest import REPO, make_root

PORTBENCH = REPO / "portbench"


def _reader(name):
    return harness.load_reader(REPO, name)


def _run(**kw):
    base = dict(steps=[], events=[], window_s=1.0, setup_s=1.0, trace=None)
    base.update(kw)
    return harness.Run(**base)


def _step(cells=10, recount_s=0.1, apply_s=0.01, deltas=1):
    return {"counts": {"cells": cells}, "recount_s": recount_s, "apply_s": apply_s,
            "deltas": deltas}


def test_fresh_p95_from_due_time():
    events = [{"due": i * 0.01, "answered": i * 0.01 + (i + 1) / 1000.0, "failed": False}
              for i in range(100)]
    # latencies 1..100 ms: the nearest-rank 95th percentile is 95 ms
    assert _reader("fresh_p95_ms")(_run(events=events)) == pytest.approx(95.0)


def test_fresh_p95_counts_unanswered_and_failed_as_missing():
    events = [{"due": 0.0, "answered": 0.001, "failed": False} for _ in range(94)]
    events += [{"due": 0.0, "answered": None, "failed": False} for _ in range(5)]
    events += [{"due": 0.0, "answered": 0.001, "failed": True}]
    # 6 of 100 missing: the percentile lands on a missing event
    assert _reader("fresh_p95_ms")(_run(events=events)) is None
    events[-1]["failed"] = False
    assert _reader("fresh_p95_ms")(_run(events=events)) == pytest.approx(1.0)


def test_cells_per_s_over_the_whole_window():
    steps = [_step(cells=100), _step(cells=100), dict(_step(), counts=None)]
    assert _reader("recount_cells_per_s")(_run(steps=steps, window_s=4.0)) == 50.0


def test_apply_and_recount_means():
    steps = [_step(recount_s=0.1, apply_s=0.02), _step(recount_s=0.3, apply_s=0.04),
             _step(recount_s=0.2, apply_s=0.0, deltas=0)]
    run = _run(steps=steps)
    assert _reader("recount_ms")(run) == pytest.approx(200.0)
    # a step with nothing to apply is not an apply
    assert _reader("apply_ms")(run) == pytest.approx(30.0)


def test_trace_readers_read_nothing_without_a_trace():
    for name in ("precompute_ms", "k1_roofline", "k3_roofline", "device_idle_share"):
        assert _reader(name)(_run()) is None


def test_device_trace_union_and_attribution():
    from portbench.trace import DeviceTrace

    ops = [("aten_a", 1.0, 1.5), ("packed_counts_kernel<false, false>(x)", 1.4, 2.0),
           ("aten_b", 3.0, 3.25), ("aten_c", 9.0, 9.5)]
    ranges = {"portbench.window": [(0.0, 5.0)], "portbench.recount": [(0.9, 2.1)],
              "portbench.apply": [(2.9, 3.3)]}
    tr = DeviceTrace(ops, ranges, [("aten::index_put_", 2.95, 3.28)])
    assert tr.window_s == 5.0
    assert tr.busy_s == pytest.approx(1.25)  # [1.0, 2.0] and [3.0, 3.25]; 9.0 is outside
    assert tr.op_time(r"packed_counts_kernel<\s*false\s*,\s*false\s*>") == (pytest.approx(0.6), 1)
    assert tr.in_ranges("recount", exclude="packed_counts_kernel") == (pytest.approx(0.5), 1)
    run = _run(trace=tr)
    assert _reader("device_idle_share")(run) == pytest.approx(75.0)
    assert _reader("precompute_ms")(run) == pytest.approx(500.0)
    b = tr.breakdown()
    assert b["device_ops"][0][0].startswith("packed_counts_kernel")
    assert sum(s for _n, s in b["idle_gaps"]) == pytest.approx(5.0 - 1.25)


def test_run_refuses_without_a_card(tmp_path):
    # the sandbox has no card: exit 2, and no result line
    proc = subprocess.run(
        [sys.executable, str(PORTBENCH / "run.py"), "--workload", "np-100k.churn",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=REPO, timeout=300,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""},
    )
    assert proc.returncode == 2
    assert '"correct"' not in proc.stdout


def _top_imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_no_jax_and_a_reference_apart_from_the_program():
    files = sorted(PORTBENCH.rglob("*.py"))
    assert files
    for f in files:
        names = set(_top_imports(f))
        # whole top-level names: cyclonus_tpu_torch is not cyclonus_tpu
        assert not names & {"jax", "jaxlib", "flax", "cyclonus_tpu"}, f
        if "reference" in f.relative_to(PORTBENCH).parts:
            assert "cyclonus_tpu_torch" not in names, f
            assert "portbench" not in names or f.name == "__init__.py", f


def test_only_the_systems_import_the_program_outside_the_tests():
    users = {f.relative_to(PORTBENCH).as_posix() for f in PORTBENCH.rglob("*.py")
             if "tests" not in f.parts and "cyclonus_tpu_torch" in set(_top_imports(f))}
    assert users == {"systems/verdict_service.py"}


def _run_cell(root, cell, seconds=1.5, traced=False, **kw):
    out, err = io.StringIO(), io.StringIO()
    res = harness.run_cell(cell, 987654321098, seconds, traced, root=root, device="cpu",
                           out=out, err=err, **kw)
    last = out.getvalue().strip().splitlines()[-1]
    assert json.loads(last) == json.loads(json.dumps(res))
    tail = err.getvalue().strip().splitlines()[-len(res["checks"]):]
    assert all(line.startswith("check ") and " limit " in line for line in tail)
    return res


@pytest.mark.parametrize("cell", [w["name"] for w in json.loads(
    (REPO / "BENCHMARK.json").read_text())["workloads"]])
def test_sound_run_is_correct(tiny_root, cell):
    res = _run_cell(tiny_root, cell)
    assert res["correct"] is True
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(res)[-1] == "checks"
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    mix = next(w["traffic"] for w in bench["workloads"] if w["name"] == cell)
    rate = json.loads((tiny_root / "portbench/traffic" / f"{mix}.json").read_text())["rate_per_s"]
    assert res["attempted"] == round(rate * 1.5) and res["failed"] == 0
    e2e = {m["name"] for m in bench["end_to_end"] if cell in m.get("workloads", [cell])}
    assert set(res["metrics"]) == e2e and "setup_s" in e2e and len(e2e) >= 2


def test_traced_run_reports_the_per_layer_metrics_it_can_read(tiny_root):
    res = _run_cell(tiny_root, "np-100k.churn", traced=True)
    assert res["correct"] is True
    # no device on the CPU: only the host-side per-layer metrics are read
    assert set(res["metrics"]) == {"apply_ms", "recount_ms"}
    assert {"busy_s", "window_s", "memory_peak_bytes"} <= set(res["device"])
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


def test_control_fails(tiny_root):
    """The control breaks the configuration's guarantee that every delta
    applied before a recount is visible in it: the recount runs before
    the batch is applied."""
    res = _run_cell(tiny_root, "np-100k.churn", control=True)
    assert res["correct"] is False
    assert res["checks"]["mismatched_recounts"]["value"] > 0


class _Faulty:
    """The system under test with its timed path broken underneath."""

    def __init__(self, fault, inputs, mix, device):
        system = harness.load_module(REPO, "systems", mix["system"]).System
        self.inner = system(inputs, mix, device)
        self.fault = fault
        self.warm = True
        self.calls = 0

    def apply(self, deltas):
        if self.warm:
            return self.inner.apply(deltas)
        if self.fault == "unchanged":
            return {"applied": len(deltas), "mode": "incremental", "rejected": [],
                    "seconds": 0.0}
        if self.fault == "half":
            return self.inner.apply(deltas[: len(deltas) // 2])
        return self.inner.apply(deltas)

    def recount(self):
        counts = dict(self.inner.recount())
        if not self.warm:
            self.calls += 1
            if self.fault == "altered":
                counts["combined"] += 1
            if self.fault == "raises" and self.calls % 2:
                raise RuntimeError("planted")
        return counts

    def sync(self):
        self.inner.sync()

    def route(self):
        self.warm = False  # the warm-up is over: the window's steps follow
        return self.inner.route()

    def close(self):
        self.inner.close()


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered", "raises"])
def test_broken_timed_path_is_not_correct(tiny_root, fault):
    res = _run_cell(tiny_root, "np-100k.churn", seconds=2.0,
                    system=lambda *a: _Faulty(fault, *a))
    assert res["correct"] is False
    if fault == "raises":
        # the steps after a raising one answer its events: none is lost
        assert res["checks"]["recount_errors"]["value"] > 0 and res["failed"] == 0


def test_new_config_mix_and_metric_found_by_name(tmp_path):
    """A later PR adds a configuration, a mix and a metric as new files and
    new entries: no file that is there changes."""
    root = make_root(tmp_path)
    before = {p: p.read_bytes() for p in (root / "portbench").rglob("*") if p.is_file()}
    cfg = json.loads((root / "portbench/configs/np-100k.tiny.json").read_text())
    cfg.update(name="np-small", n_pods=400, n_policies=30)
    (root / "portbench/configs/np-small.json").write_text(json.dumps(cfg))
    mix = json.loads((root / "portbench/traffic/churn.json").read_text())
    mix.update(rate_per_s=10, events={"pod_labels": 1.0}, warmup_batch=3)
    (root / "portbench/traffic/labels-only.json").write_text(json.dumps(mix))
    (root / "portbench/metrics/recounts_done.py").write_text(
        "def read(run):\n    return len(run.recounts())\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "np-small", "source": "https://example.org/np-small",
                             "file": "portbench/configs/np-small.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "np-small.labels-only", "config": "np-small",
                               "traffic": "labels-only", "chips": 1, "why": "a test"})
    bench["end_to_end"].append({"name": "recounts_done", "unit": "recounts",
                                "better": "higher", "bound": 0.1, "source": "host_clock",
                                "workloads": ["np-small.labels-only"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    res = _run_cell(root, "np-small.labels-only", seconds=2.0)
    assert res["correct"] is True
    assert res["attempted"] == 20
    assert res["metrics"]["recounts_done"]["value"] >= 1
    assert "recounts_done" not in _run_cell(root, "np-100k.churn", seconds=1.0)["metrics"]
    after = {p: p.read_bytes() for p in before}
    assert after == before


#: a traffic kind of its own for the test below: point queries, open loop
#: at even gaps, each batch of due queries answered by the system, every
#: answer checked against the plain reference
QUERY_KIND = """
import random, time
from portbench.reference import netpol


def warm_up(sut, inputs, mix, seed, seconds):
    rng = random.Random(f"queries.{seed}")
    keys = sorted(f"{p[0]}/{p[1]}" for p in inputs["pods"])
    n = round(mix["rate_per_s"] * seconds)
    qs = [(rng.choice(keys), rng.choice(keys), tuple(rng.choice(mix["cases"])))
          for _ in range(n)]
    sut.query(qs[:1])
    return {"queries": qs, "due": [(i + 0.5) * seconds / n for i in range(n)]}


def window(sut, plan, seconds, control, rf):
    events = [{"due": d, "answered": None, "failed": False} for d in plan["due"]]
    steps, nxt, t0 = [], 0, time.perf_counter()
    while nxt < len(events):
        now = time.perf_counter() - t0
        if events[nxt]["due"] > now:
            time.sleep(events[nxt]["due"] - now)
            continue
        batch = []
        while nxt < len(events) and events[nxt]["due"] <= now:
            batch.append(nxt)
            nxt += 1
        answers = sut.query([plan["queries"][i] for i in batch])
        for i in batch:
            events[i]["answered"] = time.perf_counter() - t0
        steps.append({"events": batch, "answers": answers})
    return {"steps": steps, "events": events, "window_s": time.perf_counter() - t0}


def check(run, device, seed):
    inp = run.inputs
    index = {f"{p[0]}/{p[1]}": i for i, p in enumerate(inp["pods"])}
    c = netpol._Compiled(inp["pods"], inp["namespaces"],
                         netpol.PolicySet(inp["policies"], inp["anps"], inp["banp"]), device)
    allowed = {}
    wrong = n = 0
    for step in run.steps:
        for i, got in zip(step["events"], step["answers"]):
            src, dst, case = run.plan["queries"][i]
            if case not in allowed:
                allowed[case] = (c.allowed("ingress", case), c.allowed("egress", case))
            a_in, a_eg = allowed[case]
            s, d = index[src], index[dst]
            want = bool(a_in[c.pod_u[d], s]) and bool(a_eg[c.pod_u[s], d])
            wrong += got != want
            n += 1
    return n, {"wrong_answers": {"value": wrong, "limit": 0}}
"""

#: a system of its own: the verdict service's point queries
QUERY_SYSTEM = """
class System:
    def __init__(self, inputs, mix, device="cuda"):
        from cyclonus_tpu_torch.kube.yaml_io import parse_policy_dict
        from cyclonus_tpu_torch.serve import VerdictService

        self.svc = VerdictService(inputs["pods"], inputs["namespaces"],
                                  [parse_policy_dict(p) for p in inputs["policies"]],
                                  device=device)
        self.flip = mix.get("planted_fault", False)

    def query(self, qs):
        from cyclonus_tpu_torch.worker.model import FlowQuery

        out = self.svc.query([FlowQuery(src=s, dst=d, port=c[0], port_name=c[1],
                                        protocol=c[2]) for s, d, c in qs])
        return [v.combined != self.flip for v in out]

    def route(self):
        return {}

    def close(self):
        self.svc = None
"""

#: a cluster generator of its own: two namespaces, one policy
TWO_NS_CLUSTER = """
def build(config, seed):
    names = ["a", "b"] * (config["n_pods"] // 2)
    pods = [(ns, f"pod-{i}", {"app": f"app{i % 3}"}, f"10.0.0.{i + 1}")
            for i, ns in enumerate(names)]
    peer = {"podSelector": {"matchLabels": {"app": "app1"}}}
    policy = {"apiVersion": "networking.k8s.io/v1", "kind": "NetworkPolicy",
              "metadata": {"name": "web", "namespace": "a"},
              "spec": {"podSelector": {"matchLabels": {"app": "app0"}},
                       "policyTypes": ["Ingress"],
                       "ingress": [{"ports": [{"protocol": "TCP", "port": 80}],
                                    "from": [peer]}]}}
    return {"pods": pods, "namespaces": {"a": {"ns": "a"}, "b": {"ns": "b"}},
            "policies": [policy], "anps": [], "banp": None}
"""


@pytest.mark.parametrize("planted_fault", [False, True])
def test_new_kind_of_traffic_added_as_new_files_only(tmp_path, planted_fault):
    """A later PR adds another kind of cell (point queries, through a
    system and a cluster generator of their own) as new files and new
    entries: no file that is there changes, and the run's check catches
    a wrong answer."""
    root = make_root(tmp_path)
    before = {p: p.read_bytes() for p in (root / "portbench").rglob("*") if p.is_file()}
    files = {
        "generators/point_queries.py": QUERY_KIND,
        "systems/service_queries.py": QUERY_SYSTEM,
        "clusters/two_namespaces.py": TWO_NS_CLUSTER,
        "configs/two-ns.json": json.dumps({"generator": "two_namespaces", "n_pods": 24}),
        "traffic/queries.json": json.dumps({
            "generator": "point_queries", "system": "service_queries", "rate_per_s": 40,
            "cases": [[80, "serve-80-tcp", "TCP"], [81, "serve-81-udp", "UDP"]],
            "planted_fault": planted_fault}),
        "metrics/query_p95_ms.py": (
            "def read(run):\n"
            "    lat = sorted(e['answered'] - e['due'] for e in run.events)\n"
            "    return 1e3 * lat[int(0.95 * len(lat))] if lat else None\n"),
    }
    for rel, body in files.items():
        assert not (root / "portbench" / rel).exists()
        (root / "portbench" / rel).write_text(body)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "two-ns", "source": "https://example.org/two-ns",
                             "file": "portbench/configs/two-ns.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "two-ns.queries", "config": "two-ns",
                               "traffic": "queries", "chips": 1, "why": "a test"})
    bench["end_to_end"].append({"name": "query_p95_ms", "unit": "ms", "better": "lower",
                                "bound": 0.1, "source": "host_clock",
                                "workloads": ["two-ns.queries"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    res = _run_cell(root, "two-ns.queries", seconds=1.0)
    assert res["attempted"] == 40 and res["failed"] == 0 and res["checked"] == 40
    assert set(res["metrics"]) == {"setup_s", "query_p95_ms"}
    assert res["correct"] is (not planted_fault)
    assert (res["checks"]["wrong_answers"]["value"] > 0) is planted_fault
    after = {p: p.read_bytes() for p in before}
    assert after == before


@pytest.mark.cuda
def test_control_fails_on_the_card_at_the_cell_size(monkeypatch):
    """The control at np-100k.churn's own size, on the card."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    monkeypatch.setenv("CYCLONUS_AUTOTUNE_CACHE", str(REPO / "build/portbench/autotune.json"))
    out, err = io.StringIO(), io.StringIO()
    res = harness.run_cell("np-100k.churn", 31, 5.0, False, control=True, out=out, err=err)
    assert res["correct"] is False
    assert res["checks"]["mismatched_recounts"]["value"] > 0
    assert math.isfinite(res["metrics"]["recount_cells_per_s"]["value"])
