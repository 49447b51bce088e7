"""The port's spans on torch.profiler's clock, on the CPU.

While a profiler capture is active, every `telemetry.spans.span` (and so
`utils.tracing.phase`) opens a profiler range of its name on its own
thread, at the profiler's function scope: a host event, never a user
annotation (which the profiler would mirror onto the device timeline).
With no capture active, or with telemetry off, no range is opened.

Held here:
  * one apply and one recount of a small VerdictService give a host event
    for each of the apply's spans and for engine.precompute, each inside
    its parent, none a user annotation; a policy upsert gives
    serve.policy and a class-compressed service serve.classes;
  * engine.precompute is opened on fused and split counts calls and
    never on a steady one; engine.ip_peers inside it and inside a pin
    patch's engine.pre_patch;
  * no capture, or telemetry off: span() constructs no profiler range;
  * the benchmark's span readers (portbench/metrics/apply_*_ms.py,
    recount_precompute_share.py, ip_peers_ms.py) on made-up traces, and a
    traced tiny run of the benchmark on the CPU, which reports all six, the apply's
    four parts summing to no more than the run's apply_ms.

The `cuda`-marked test at the end holds on the card that the spans put
nothing on the device timeline (run it there with
`pytest -m cuda tests/test_torch_profiler_spans.py`)."""

import json
import random
import subprocess
import sys
import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cyclonus_tpu_torch import telemetry
from cyclonus_tpu_torch.engine import PortCase, TorchPolicyEngine
from cyclonus_tpu_torch.kube.yaml_io import policy_to_dict
from cyclonus_tpu_torch.matcher import build_network_policies
from cyclonus_tpu_torch.serve import VerdictService
from cyclonus_tpu_torch.synthetic import build_synthetic
from cyclonus_tpu_torch.telemetry import spans
from cyclonus_tpu_torch.utils import tracing
from cyclonus_tpu_torch.worker.model import Delta

from portbench import harness
from portbench.trace import DeviceTrace

CASES = [PortCase(80, "", "TCP"), PortCase(81, "serve-81-udp", "UDP")]
#: the apply's spans on an incremental pod batch, each with its parent
APPLY_SPANS = {
    "serve.validate": "test.apply",
    "serve.snapshot": "test.apply",
    "serve.state": "test.apply",
    "serve.apply": "test.apply",
    "serve.encode": "serve.apply",
    "serve.patch": "serve.apply",
    "serve.finish": "serve.apply",
}
NEW_METRICS = ("apply_state_ms", "apply_encode_ms", "apply_patch_ms", "apply_finish_ms",
               "recount_precompute_share", "ip_peers_ms")


def cluster(n_pods=96, n_policies=12, seed=3):
    return build_synthetic(n_pods, n_policies, random.Random(seed))


def pod_batch(pods, rng, n=4):
    """n label changes and one remove-then-add, as the churn mix sends."""
    out = []
    for ns, name, labels, _ip in rng.sample(pods, n):
        out.append(Delta(kind="pod_labels", namespace=ns, name=name,
                         labels={**labels, "app": f"app{rng.randrange(20)}"}))
    ns, name, labels, ip = pods[-1]
    out.append(Delta(kind="pod_remove", namespace=ns, name=name))
    out.append(Delta(kind="pod_add", namespace=ns, name=name, labels=labels, ip=ip))
    return out


def captured(fn):
    """(fn's result, the capture's events) under a CPU profiler capture."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, list(prof.events())


def by_name(events, name):
    return [e for e in events if e.name == name]


def inside(inner, outer) -> bool:
    return (inner.thread == outer.thread
            and outer.time_range.start <= inner.time_range.start
            and inner.time_range.end <= outer.time_range.end)


def test_apply_and_recount_spans_are_host_events_in_their_parents():
    pods, namespaces, policies = cluster()
    svc = VerdictService(pods, namespaces, policies, device="cpu")
    rng = random.Random(7)

    def step():
        with torch.profiler.record_function("test.apply"):
            report = svc.apply(pod_batch(pods, rng))
        with torch.profiler.record_function("test.recount"):
            counts = svc.engine.evaluate_grid_counts(CASES)
        return report, counts

    (report, counts), events = captured(step)
    assert report["mode"] == "incremental" and counts["cells"] == len(pods) ** 2 * len(CASES)
    for name, parent in APPLY_SPANS.items():
        (ev,) = by_name(events, name)
        (outer,) = by_name(events, parent)
        assert inside(ev, outer), name
    (pre,) = by_name(events, "engine.precompute")
    (recount,) = by_name(events, "test.recount")
    assert inside(pre, recount)
    program = [e for e in events if e.name.startswith(("serve.", "engine."))]
    assert {e.name for e in program} >= set(APPLY_SPANS) | {"engine.precompute",
                                                             "engine.dispatch"}
    # the profiler's function scope, not record_function's user scope:
    # nothing for the profiler to mirror onto the device timeline
    assert not any(e.is_user_annotation for e in program)
    assert all(e.device_type == torch.autograd.DeviceType.CPU for e in program)
    assert by_name(events, "test.apply")[0].is_user_annotation


def test_policy_and_class_spans():
    pods, namespaces, policies = cluster(seed=5)
    svc = VerdictService(pods, namespaces, policies[:-1], device="cpu")
    upsert = Delta(kind="policy_upsert", namespace=policies[-1].namespace,
                   name=policies[-1].name, policy=policy_to_dict(policies[-1]))
    _r, events = captured(lambda: svc.apply([upsert]))
    (pol,) = by_name(events, "serve.policy")
    assert inside(pol, by_name(events, "serve.apply")[0])

    classed = VerdictService(pods, namespaces, policies, device="cpu", class_compress="1")
    assert classed.engine._class_state is not None
    rng = random.Random(2)
    ns, name, labels, _ip = pods[4]
    relabel = Delta(kind="pod_labels", namespace=ns, name=name,
                    labels={**labels, "app": f"app{rng.randrange(20)}"})
    _r, events = captured(lambda: classed.apply([relabel]))
    (cls,) = by_name(events, "serve.classes")
    assert inside(cls, by_name(events, "serve.apply")[0])


def test_precompute_span_marks_fused_and_split_calls_only():
    pods, namespaces, policies = cluster(seed=9)
    eng = TorchPolicyEngine(build_network_policies(True, policies), pods, namespaces,
                            device="cpu", class_compress="0")
    seen = []
    for _ in range(4):
        _c, events = captured(lambda: eng.evaluate_grid_counts(CASES))
        seen.append((eng._last_counts_mode, len(by_name(events, "engine.precompute"))))
    assert seen == [("fused", 1), ("split", 1), ("steady", 0), ("steady", 0)]


def test_ip_peers_span_inside_the_precompute_and_the_pin_patch():
    """engine.ip_peers, the dense precompute's ip leg, is a host event
    once a direction whose peer rows hold ipBlocks: inside
    engine.precompute on a fused call, inside engine.pre_patch on a
    steady call that patches the pin."""
    pods, namespaces, policies = cluster()
    svc = VerdictService(pods, namespaces, policies, device="cpu")
    _c, fused = captured(lambda: svc.engine.evaluate_grid_counts(CASES))
    legs = svc.engine._ip_legs
    dirs = sum(1 for g in legs.values() if g["n_block"] or g["n_part"])
    assert dirs > 0
    (pre,) = by_name(fused, "engine.precompute")
    assert [inside(e, pre) for e in by_name(fused, "engine.ip_peers")] == [True] * dirs
    svc.engine.evaluate_grid_counts(CASES)
    svc.apply(pod_batch(pods, random.Random(4)))
    _c, steady = captured(lambda: svc.engine.evaluate_grid_counts(CASES))
    assert svc.engine._last_counts_mode == "steady"
    (patch,) = by_name(steady, "engine.pre_patch")
    assert [inside(e, patch) for e in by_name(steady, "engine.ip_peers")] == [True] * dirs
    assert not by_name(steady, "engine.precompute")


class _CountingRange:
    """Stands in for the profiler's range: counts constructions."""

    made = 0

    def __init__(self, name):
        type(self).made += 1

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_no_range_without_a_capture_or_with_telemetry_off(monkeypatch):
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", _CountingRange)
    _CountingRange.made = 0
    for _ in range(50):
        with spans.span("serve.encode"), tracing.phase("engine.precompute"):
            pass
    assert _CountingRange.made == 0
    telemetry.set_enabled(False)
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            with spans.span("serve.encode"):
                pass
    finally:
        telemetry.set_enabled(True)
    assert _CountingRange.made == 0
    # the stand-in is the one the spans construct under a capture
    with profile(activities=[ProfilerActivity.CPU]):
        with spans.span("serve.encode"), spans.span("serve.patch"):
            pass
    assert _CountingRange.made == 2


def test_span_range_ends_when_the_span_raises():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with pytest.raises(ValueError):
            with spans.span("serve.encode"):
                raise ValueError("boom")
        with spans.span("serve.patch"):
            pass
    names = [e.name for e in prof.events()]
    assert names.count("serve.encode") == 1 and names.count("serve.patch") == 1


def test_span_range_on_the_spans_own_thread():
    tids = {}

    def work():
        tids["worker"] = threading.get_native_id()
        with spans.span("serve.encode"):
            torch.ones(4).add_(1)

    with profile(activities=[ProfilerActivity.CPU],
                 experimental_config=tracing._all_threads_config()) as prof:
        t = threading.Thread(target=work)
        t.start()
        t.join(timeout=60)
        assert not t.is_alive()
        with spans.span("serve.patch"):
            pass
    (enc,) = by_name(prof.events(), "serve.encode")
    (pat,) = by_name(prof.events(), "serve.patch")
    assert enc.thread != pat.thread


# --- the benchmark's span readers ----------------------------------------


def _trace(host, ranges):
    return harness.Run(steps=[], events=[], window_s=10.0, setup_s=1.0,
                       trace=DeviceTrace([], {"portbench.window": [(0.0, 10.0)], **ranges},
                                         host))


def _read(name, run):
    return harness.load_reader(harness.ROOT, name)(run)


def test_apply_readers_mean_over_batches_with_deltas():
    host = [
        # batch 1: every span
        ("serve.validate", 1.000, 1.001), ("serve.snapshot", 1.001, 1.003),
        ("serve.state", 1.003, 1.004), ("serve.apply", 1.004, 1.020),
        ("serve.encode", 1.004, 1.010), ("aten::index_copy_", 1.011, 1.012),
        ("serve.patch", 1.010, 1.013), ("serve.finish", 1.013, 1.019),
        # batch 2: validated, every delta a no-op (no serve.apply)
        ("serve.validate", 3.000, 3.002), ("serve.snapshot", 3.002, 3.003),
        ("serve.state", 3.003, 3.004),
        # outside any apply range: not read
        ("serve.encode", 6.0, 7.0),
    ]
    ranges = {"portbench.apply": [(0.9, 1.1), (2.9, 3.1), (4.9, 5.1)]}  # the third empty
    run = _trace(host, ranges)
    assert _read("apply_state_ms", run) == pytest.approx((4.0 + 4.0) / 2)
    assert _read("apply_encode_ms", run) == pytest.approx(6.0 / 2)
    assert _read("apply_patch_ms", run) == pytest.approx(3.0 / 2)
    assert _read("apply_finish_ms", run) == pytest.approx(6.0 / 2)


def test_ip_peers_ms_over_recounts():
    host = [("engine.dispatch", 1.0, 1.5), ("engine.precompute", 1.0, 1.4),
            ("engine.ip_peers", 1.1, 1.12), ("engine.ip_peers", 1.2, 1.23),
            ("engine.pre_patch", 2.0, 2.05), ("engine.ip_peers", 2.01, 2.02),
            ("engine.ip_peers", 5.0, 6.0)]
    ranges = {"portbench.recount": [(0.9, 1.6), (1.9, 2.3), (2.9, 3.5)]}
    assert _read("ip_peers_ms", _trace(host, ranges)) == pytest.approx((20 + 30 + 10) / 3)


def test_precompute_share_over_recounts():
    host = [("engine.dispatch", 1.0, 1.5), ("engine.precompute", 1.0, 1.4),
            ("engine.dispatch", 2.0, 2.1), ("engine.execute", 2.1, 2.2),
            ("engine.precompute", 3.0, 3.3)]
    ranges = {"portbench.recount": [(0.9, 1.6), (1.9, 2.3), (2.9, 3.5), (4.0, 4.5)]}
    assert _read("recount_precompute_share", _trace(host, ranges)) == pytest.approx(50.0)


@pytest.mark.parametrize("name", NEW_METRICS)
def test_span_readers_read_nothing_without_the_programs_spans(name):
    """A program whose spans are not on the profiler's clock (only aten
    operations among the host events), and a run without a trace."""
    host = [("aten::index_copy_", 1.0, 1.1), ("aten::mm", 2.0, 2.5)]
    ranges = {"portbench.apply": [(0.9, 1.2)], "portbench.recount": [(1.9, 2.6)]}
    assert _read(name, _trace(host, ranges)) is None
    assert _read(name, harness.Run(steps=[], events=[], window_s=1.0, setup_s=1.0,
                                   trace=None)) is None


#: one traced run of a cell at the benchmark's tiny CPU size, in a fresh
#: interpreter: the harness refuses a process that holds the JAX package,
#: which the other test modules of a worker import
TINY_RUN = """
import io, json, sys
from pathlib import Path
from portbench import harness
from portbench.tests.conftest import make_root
root = make_root(Path(sys.argv[1]))
res = harness.run_cell("np-100k.churn", 2400000001, 1.5, True, root=root, device="cpu",
                       out=io.StringIO(), err=io.StringIO())
print(json.dumps(res))
"""


def test_traced_tiny_run_reports_the_span_metrics(tmp_path):
    proc = subprocess.run([sys.executable, "-c", TINY_RUN, str(tmp_path)], cwd=harness.ROOT,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["correct"] is True
    m = {k: v["value"] for k, v in res["metrics"].items()}
    assert set(NEW_METRICS) <= set(m)
    parts = [m[k] for k in NEW_METRICS[:4]]
    assert all(p > 0 for p in parts)
    assert sum(parts) <= m["apply_ms"]
    # the warm-up pins and every pod batch patches the pin: no recount of
    # the window runs the precompute
    assert m["recount_precompute_share"] == 0.0
    # ... and every patch of it runs the ip leg (the cluster's ipBlocks)
    assert m["ip_peers_ms"] > 0
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    entries = {e["name"]: e for e in bench["per_layer"]}
    for name in NEW_METRICS:
        assert entries[name]["source"] == "program_span"
        assert set(entries[name]["workloads"]) == {w["name"] for w in bench["workloads"]}


@pytest.mark.cuda
def test_spans_put_nothing_on_the_device_timeline():
    """On the card: under a CPU+CUDA capture, an apply and a fused
    recount give the spans as host events and no device event, user
    annotation or otherwise, of a span's name; the device ran the
    recount's work."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the device timeline exists only on the card")
    pods, namespaces, policies = cluster(n_pods=2048, n_policies=64)
    svc = VerdictService(pods, namespaces, policies, device="cuda")
    svc.engine.evaluate_grid_counts(CASES)
    rng = random.Random(11)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        svc.apply(pod_batch(pods, rng))
        svc.engine.evaluate_grid_counts(CASES)
        torch.cuda.synchronize()
    events = list(prof.events())
    device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    host_names = {e.name for e in events if e.device_type == torch.autograd.DeviceType.CPU}
    assert device, "the capture saw no device work"
    assert set(APPLY_SPANS) | {"engine.precompute", "engine.ip_peers"} <= host_names
    assert not [e.name for e in device if e.name.startswith(("serve.", "engine."))]
