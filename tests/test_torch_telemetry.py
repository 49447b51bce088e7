"""The port's telemetry (cyclonus_tpu_torch/telemetry, utils/tracing.py)
against the reference's (cyclonus_tpu/telemetry), on the CPU:

  * the schema: the port's instrument catalog carries the reference's
    (name, type, label names) and help strings, less the five
    instruments nothing in the port could feed (REF_ONLY_INSTRUMENTS),
    so a dashboard reads either package;
  * the same seeded counter / gauge / histogram operations give
    byte-identical Prometheus text and equal JSON snapshots, and
    histogram_quantile agrees on seeded buckets;
  * eval_flight, the flight recorder (on demand and in a crashing
    subprocess) and the `telemetry` CLI;
  * both metrics servers' /healthz, /readyz, /metrics, /metrics.json and
    /telemetry.json, and MetricsPortBusy;
  * the engine's instrumentation: on the same cluster each counts route
    (packed, class, pack=False, the mesh's sharded and ring) moves the
    same counters by the same amounts in both packages, records flight
    entries with the same path / n_pods / q / cells, and yields the same
    span names but the port's precompute span (PORT_ONLY_SPANS);
    telemetry on and off make the same number of readbacks.

No test here bounds a wall-clock time: the overhead figure is taken on
the card by chip_smoke.py.  Every port test that can dump the flight
recorder points CYCLONUS_FLIGHT_RECORDER_PATH at a temporary file."""

import json
import os
import subprocess
import sys
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import cyclonus_tpu.telemetry as ref_telemetry
import cyclonus_tpu.telemetry.instruments as ref_ti
import cyclonus_tpu.telemetry.metrics as ref_metrics
import cyclonus_tpu.telemetry.server as ref_server
import cyclonus_tpu_torch.telemetry as port_telemetry
import cyclonus_tpu_torch.telemetry.instruments as ti
import cyclonus_tpu_torch.telemetry.metrics as port_metrics
import cyclonus_tpu_torch.telemetry.server as port_server
from cyclonus_tpu.engine import PortCase as RefPortCase
from cyclonus_tpu.engine import TpuPolicyEngine
from cyclonus_tpu.matcher import build_network_policies as ref_build
from cyclonus_tpu_torch.cli import main
from cyclonus_tpu_torch.engine import PortCase, TorchPolicyEngine
from cyclonus_tpu_torch.engine import build as port_build
from cyclonus_tpu_torch.utils import tracing

from test_torch_engine import CASE_TUPLES, REPO, fuzz_policies, port_policy


@pytest.fixture(autouse=True)
def _flight_path(tmp_path, monkeypatch):
    """Both packages' crash hooks default to the same file under the
    repo's artifacts/: point every dump at a temporary file instead."""
    monkeypatch.setenv("CYCLONUS_FLIGHT_RECORDER_PATH", str(tmp_path / "flight.json"))


def reset_both():
    ref_telemetry.reset()
    port_telemetry.reset()


def schema(mod):
    """{name: (type, label names, help)} of an instruments module."""
    out = {}
    for v in vars(mod).values():
        if isinstance(v, (ref_metrics.Metric, port_metrics.Metric)):
            out[v.name] = (v.kind, v.labelnames, v.help)
    return out


#: reference instruments the port leaves out: its ahead-of-time executable
#: cache, backend attach and tunnel probes.  The port compiles nothing
#: ahead and has no remote backend, so nothing could feed them and a
#: dashboard would only ever read 0 from them.
REF_ONLY_INSTRUMENTS = {
    "cyclonus_tpu_aot_cache_total",
    "cyclonus_tpu_aot_compiles_total",
    "cyclonus_tpu_backend_init_attempts_total",
    "cyclonus_tpu_backend_init_backoff_seconds",
    "cyclonus_tpu_tunnel_probe_attempts_total",
}


#: port instruments with no counterpart in the reference: the patches of
#: the dense counts route's pin (engine/api.py _patch_pin), which the
#: reference's engine, dropping its pin after every patch, does not make;
#: and the ip leg of the dense precompute (engine/tiled.py
#: _direction_tallow), which resolves ipBlock rows through the CIDR
#: tuple-space partition where the reference resolves them row by row
PORT_ONLY_INSTRUMENTS = {
    "cyclonus_tpu_pre_cache_patches_total",
    "cyclonus_tpu_pre_cache_patched_columns_total",
    "cyclonus_tpu_ip_atoms",
    "cyclonus_tpu_ip_partitions",
    "cyclonus_tpu_ip_except_rows",
    "cyclonus_tpu_ip_resolved_columns_total",
}


class TestSchema:
    def test_instrument_catalogs_equal(self):
        """The port's catalog is the reference's less REF_ONLY_INSTRUMENTS,
        plus PORT_ONLY_INSTRUMENTS, with the same types, label names and
        help strings."""
        ref, port = schema(ref_ti), schema(ti)
        assert REF_ONLY_INSTRUMENTS <= set(ref)
        assert PORT_ONLY_INSTRUMENTS <= set(port) and not PORT_ONLY_INSTRUMENTS & set(ref)
        ref = {k: v for k, v in ref.items() if k not in REF_ONLY_INSTRUMENTS}
        port = {k: v for k, v in port.items() if k not in PORT_ONLY_INSTRUMENTS}
        # the scan found the whole catalog: 64 less the five left out,
        # and the port's own six
        assert len(port) == len(ref) == 59
        assert len(schema(ti)) == 59 + len(PORT_ONLY_INSTRUMENTS) == 65
        assert {k: v[:2] for k, v in port.items()} == {k: v[:2] for k, v in ref.items()}
        assert {k: v[2] for k, v in port.items()} == {k: v[2] for k, v in ref.items()}

    def test_registries_after_import_equal(self):
        """In a fresh interpreter, each package's registry after importing
        its telemetry holds the same (name, type, label names) set, less
        REF_ONLY_INSTRUMENTS, which the port's exposition lacks, and
        PORT_ONLY_INSTRUMENTS, which the reference's lacks; and the port
        loaded no torch for it."""
        code = (
            "import json, sys\n"
            "import cyclonus_tpu.telemetry as r, cyclonus_tpu_torch.telemetry as p\n"
            "def labels(m):\n"
            "    return sorted([x.name, x.kind, list(x.labelnames)]\n"
            "                  for x in m.METRICS._metrics.values())\n"
            "print(json.dumps([labels(r), labels(p), 'torch' in sys.modules,\n"
            "                  p.render_prometheus()]))\n"
        )
        proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                              text=True, timeout=120)
        assert proc.returncode == 0, proc.stderr[-2000:]
        ref, port, torch_loaded, exposition = json.loads(proc.stdout)
        assert {r[0] for r in ref} >= REF_ONLY_INSTRUMENTS
        assert {r[0] for r in port} >= PORT_ONLY_INSTRUMENTS
        assert ([r for r in port if r[0] not in PORT_ONLY_INSTRUMENTS]
                == [r for r in ref if r[0] not in REF_ONLY_INSTRUMENTS])
        assert not torch_loaded
        assert not any(name in exposition for name in REF_ONLY_INSTRUMENTS)

    def test_contract_counter_created_on_first_check(self):
        from cyclonus_tpu_torch.utils import contracts

        contracts._count(2)
        c = port_metrics.REGISTRY._metrics["cyclonus_tpu_contract_checks_total"]
        assert c.value() >= 2 and c.kind == "counter"


def apply_ops(reg, seed):
    """A seeded sequence of counter, gauge and histogram operations."""
    rng = np.random.default_rng(seed)
    c = reg.counter("cyclonus_tpu_test_events_total", "Test events.", labelnames=("path",))
    u = reg.counter("cyclonus_tpu_test_plain_total", "Plain.")
    g = reg.gauge("cyclonus_tpu_test_bytes", "Test bytes.", labelnames=("kind",))
    h = reg.histogram("cyclonus_tpu_test_latency_seconds", "Test latency.",
                      labelnames=("path",))
    h2 = reg.histogram("cyclonus_tpu_test_sizes", "Sizes.", buckets=(1, 10, 100))
    for _ in range(200):
        op = int(rng.integers(5))
        path = ["grid", "counts.pallas", 'we"ird\\'][int(rng.integers(3))]
        if op == 0:
            c.inc(float(rng.integers(1, 4)), path=path)
        elif op == 1:
            u.inc()
        elif op == 2:
            g.set(float(rng.choice([0.5, 1024, 1e20, float("inf")])), kind=path)
        elif op == 3:
            h.observe(float(rng.exponential(0.3)), path=path)
        else:
            h2.observe(float(rng.integers(0, 300)))


class TestMetrics:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_same_ops_same_exposition(self, seed):
        ref, port = ref_metrics.MetricRegistry(), port_metrics.MetricRegistry()
        apply_ops(ref, seed)
        apply_ops(port, seed)
        assert port.render_prometheus() == ref.render_prometheus()
        assert port.snapshot() == ref.snapshot()
        ref.reset()
        port.reset()
        assert port.render_prometheus() == ref.render_prometheus()

    @pytest.mark.parametrize("seed", range(4))
    def test_histogram_quantile_equal(self, seed):
        rng = np.random.default_rng(seed)
        ref, port = ref_metrics.MetricRegistry(), port_metrics.MetricRegistry()
        for reg in (ref, port):
            reg.histogram("cyclonus_tpu_q_seconds", "Q.", labelnames=("k",))
        for v, k in zip(rng.lognormal(-4, 2, 500), rng.integers(0, 3, 500)):
            ref._metrics["cyclonus_tpu_q_seconds"].observe(float(v), k=int(k))
            port._metrics["cyclonus_tpu_q_seconds"].observe(float(v), k=int(k))
        rs, ps = ref.snapshot()["cyclonus_tpu_q_seconds"], port.snapshot()["cyclonus_tpu_q_seconds"]
        for q in (0.0, 0.01, 0.5, 0.9, 0.99, 1.0):
            assert port_metrics.histogram_quantile(ps, q) == ref_metrics.histogram_quantile(rs, q)
        assert port_metrics.histogram_quantile({"samples": [], "buckets": []}, 0.5) is None

    def test_disabled_metrics_and_spans_do_not_move(self):
        reg = port_metrics.MetricRegistry()
        c = reg.counter("c_total", "C.")
        port_telemetry.reset()
        port_telemetry.set_enabled(False)
        try:
            c.inc(100)
            with port_telemetry.span("off.span"):
                pass
            assert tracing.render_stats().startswith("(no phases recorded")
        finally:
            port_telemetry.set_enabled(True)
        assert c.value() == 0 and "off.span" not in tracing.stats()


class TestFlightRecorder:
    def test_eval_flight_records_ok_and_error(self):
        port_telemetry.recorder.reset()
        with ti.eval_flight("test.path", 16, 2) as fl:
            fl.set(cells=512)
        with pytest.raises(RuntimeError):
            with ti.eval_flight("test.path", 16, 2):
                raise RuntimeError("boom")
        ents = port_telemetry.recorder.entries()
        assert ents[-2]["outcome"] == "ok" and ents[-2]["cells"] == 512
        assert ents[-1]["outcome"].startswith("RuntimeError: boom")
        assert ents[-1]["seq"] == ents[-2]["seq"] + 1
        assert ti.EVAL_DISPATCHES.value(path="test.path") >= 2

    def test_dump_on_demand(self, tmp_path):
        port_telemetry.recorder.reset()
        port_telemetry.recorder.record(path="x", n_pods=1, q=1, outcome="ok")
        p = port_telemetry.recorder.dump()
        assert p == str(tmp_path / "flight.json")
        data = json.loads(open(p).read())
        assert data["reason"] == "on-demand" and data["entries"][0]["path"] == "x"

    def test_dump_on_crash_subprocess(self, tmp_path):
        """An unhandled crash leaves a dump through the chained excepthook
        (the reference's hook is installed too, and both run), and the
        crash itself still reaches stderr.  The worker's import chain —
        telemetry, the chaos points, envflags and the worker client with
        its fault point fired — loads no torch."""
        dump_path = str(tmp_path / "crash.json")
        code = (
            "import sys\n"
            "from cyclonus_tpu_torch.telemetry import instruments as ti\n"
            "prev = []\n"
            "sys.excepthook = lambda *a: (prev.append(1), sys.__excepthook__(*a))\n"
            "with ti.eval_flight('counts.pallas', 64, 2) as fl:\n"
            "    fl.set(cells=8192)\n"
            "from cyclonus_tpu_torch import chaos\n"
            "from cyclonus_tpu_torch.utils import envflags\n"
            "from cyclonus_tpu_torch.worker import client\n"
            "chaos.reset('worker_wire:1')\n"
            "try:\n"
            "    client.Client(None)._issue_once(None)\n"
            "except chaos.ChaosError:\n"
            "    pass\n"
            "assert chaos.injected() == {'worker_wire': 1}\n"
            "assert ti.CHAOS_INJECTIONS.value(point='worker_wire') == 1\n"
            "assert envflags.get_float('CYCLONUS_WORKER_TIMEOUT_S') == 120.0\n"
            "assert 'torch' not in sys.modules\n"
            "raise RuntimeError('engine exploded')\n"
        )
        env = dict(os.environ, CYCLONUS_FLIGHT_RECORDER_PATH=dump_path)
        proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                              timeout=120, cwd=REPO, env=env)
        assert proc.returncode != 0
        assert "engine exploded" in proc.stderr
        data = json.loads(open(dump_path).read())
        assert data["reason"].startswith("crash: RuntimeError")
        assert data["entries"][0]["path"] == "counts.pallas"
        assert data["entries"][0]["cells"] == 8192

    def test_crash_hook_skips_benign_terminations(self, tmp_path):
        dump_path = str(tmp_path / "no-dump.json")
        code = (
            "from cyclonus_tpu_torch.telemetry import recorder\n"
            "recorder.record(path='x', outcome='ok')\n"
            "raise SystemExit(3)\n"
        )
        env = dict(os.environ, CYCLONUS_FLIGHT_RECORDER_PATH=dump_path)
        proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                              timeout=120, cwd=REPO, env=env)
        assert proc.returncode == 3 and not os.path.exists(dump_path)


class TestTelemetryCli:
    @pytest.mark.parametrize("fmt", ["text", "json"])
    def test_flight_file_renders_as_reference(self, fmt, tmp_path, capsys):
        from cyclonus_tpu.cli.root import main as ref_main

        port_telemetry.recorder.reset()
        port_telemetry.recorder.record(path="counts.pallas", n_pods=9, q=2, seconds=0.5,
                                       outcome="ok")
        p = port_telemetry.recorder.dump(str(tmp_path / "fr.json"))
        assert main(["telemetry", "--flight-file", p, "--format", fmt]) == 0
        got = capsys.readouterr().out
        assert ref_main(["telemetry", "--flight-file", p, "--format", fmt]) == 0
        assert got == capsys.readouterr().out
        assert "counts.pallas" in got and "n_pods" in got

    def test_formats(self, capsys):
        reset_both()
        with ti.eval_flight("grid", 4, 1):
            pass
        assert main(["telemetry", "--format", "prometheus"]) == 0
        out = capsys.readouterr().out
        assert out == port_telemetry.render_prometheus()
        assert "# TYPE cyclonus_tpu_eval_cells_per_sec gauge" in out
        assert 'cyclonus_tpu_eval_dispatches_total{path="grid"} 1' in out
        assert main(["telemetry", "--format", "json"]) == 0
        snap = json.loads(capsys.readouterr().out)
        assert set(snap) == {"metrics", "phases", "spans", "flight_recorder"}
        assert snap["flight_recorder"][0]["path"] == "grid"
        assert main(["telemetry"]) == 0
        text = capsys.readouterr().out
        assert "# spans" in text and "# flight recorder (1 entries)" in text


def fetch(url):
    """(status, body) — error statuses read, not raised."""
    try:
        with urllib.request.urlopen(url, timeout=30) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


@pytest.fixture
def servers():
    """Both packages' process metrics servers on ephemeral ports."""
    ref_server.stop_metrics_server()
    port_server.stop_metrics_server()
    srvs = (ref_server.start_metrics_server(0), port_server.start_metrics_server(0))
    try:
        yield srvs
    finally:
        for mod in (ref_server, port_server):
            mod.register_readiness(None)
            mod.stop_metrics_server()


class TestServer:
    def test_endpoints_of_both_servers(self, servers):
        ref_srv, port_srv = servers
        assert ref_srv.port != port_srv.port and port_srv.port != 0
        reset_both()
        for mod in (ref_ti, ti):
            with mod.eval_flight("grid", 8, 1) as fl:
                fl.set(cells=64)
        for srv, tel in ((ref_srv, ref_telemetry), (port_srv, port_telemetry)):
            assert fetch(srv.url + "/healthz") == (200, "ok\n")
            assert fetch(srv.url + "/readyz")[0] == 200
            status, body = fetch(srv.url + "/metrics")
            assert status == 200 and 'cyclonus_tpu_eval_dispatches_total{path="grid"} 1' in body
            assert json.loads(fetch(srv.url + "/metrics.json")[1])[
                "cyclonus_tpu_eval_dispatches_total"]["samples"][0]["value"] == 1
            snap = json.loads(fetch(srv.url + "/telemetry.json")[1])
            assert [e["cells"] for e in snap["flight_recorder"]] == [64]
            for path in ("/slo", "/audit"):
                assert fetch(srv.url + path)[0] == 503
            assert fetch(srv.url + "/nope")[0] == 404
        # both packages' perfobs gauges register at the import of their
        # report module: import both, so the cyclonus_tpu_perf_* families
        # are held equal too
        import cyclonus_tpu.perfobs.report  # noqa: F401
        import cyclonus_tpu_torch.perfobs.report  # noqa: F401

        types = [
            {ln for ln in fetch(s.url + "/metrics")[1].splitlines() if ln.startswith("# TYPE")}
            for s in servers
        ]
        assert any("cyclonus_tpu_perf_gate_status" in t for t in types[1])
        # the contract counter exists once a check ran in this process
        lazy = ("_contract_checks_",)
        kinds = schema(ref_ti)
        left_out = {f"# TYPE {n} {kinds[n][0]}" for n in REF_ONLY_INSTRUMENTS}
        port_only = {f"# TYPE {n} {schema(ti)[n][0]}" for n in PORT_ONLY_INSTRUMENTS}
        assert left_out <= types[0] and port_only <= types[1]
        assert ({t for t in types[0] - left_out if not any(x in t for x in lazy)}
                == {t for t in types[1] - port_only if not any(x in t for x in lazy)})

    def test_readyz_follows_callback(self, servers):
        _ref_srv, srv = servers
        state = {"ready": False}
        port_server.register_readiness(lambda: (state["ready"], "warming test"))
        status, body = fetch(srv.url + "/readyz")
        assert status == 503 and body.startswith("warming")
        assert fetch(srv.url + "/healthz") == (200, "ok\n")
        state["ready"] = True
        assert fetch(srv.url + "/readyz") == (200, "ready: warming test\n")

        def boom():
            raise RuntimeError("probe exploded")

        port_server.register_readiness(boom)
        status, body = fetch(srv.url + "/readyz")
        assert status == 503 and "probe exploded" in body

    def test_metrics_port_busy_is_one_line(self):
        first = port_server.MetricsServer(0)
        try:
            with pytest.raises(port_server.MetricsPortBusy) as exc:
                port_server.MetricsServer(first.port)
            msg = str(exc.value)
            assert str(first.port) in msg and "\n" not in msg
        finally:
            first.close()

    def test_cli_exits_cleanly_on_taken_port(self):
        from cyclonus_tpu_torch.cli.probe_cmd import _start_metrics

        port_server.stop_metrics_server()
        blocker = port_server.MetricsServer(0)
        try:
            args = type("A", (), {"metrics_port": blocker.port})()
            with pytest.raises(SystemExit) as exc:
                _start_metrics(args)
            assert "already in use" in str(exc.value)
        finally:
            blocker.close()


# --- the engine's instrumentation ---------------------------------------


def metric_view(tel):
    """The counters' values and the histograms' observation counts of one
    package, zero series dropped; kernel traces left out (the reference
    counts a trace per jit program, the port the first run of a shape:
    TestKernelTraces holds the port's own semantics)."""
    out = {}
    for name, fam in tel.METRICS.snapshot().items():
        if name == "cyclonus_tpu_kernel_traces_total":
            continue
        for s in fam["samples"]:
            key = (name, tuple(sorted(s["labels"].items())))
            v = s["value"] if fam["type"] == "counter" else s.get("count")
            if fam["type"] in ("counter", "histogram") and v:
                out[key] = v
    return out


def nonzero_gauges(tel):
    return {
        name for name, fam in tel.METRICS.snapshot().items()
        if fam["type"] == "gauge" and any(s["value"] for s in fam["samples"])
    }


def flights(tel):
    return [
        {k: e.get(k) for k in ("path", "n_pods", "q", "cells", "outcome", "mode")}
        for e in tel.recorder.entries()
    ]


def twin_engines(monkeypatch, pack: bool, class_compress: str, seed: int = 14):
    monkeypatch.setenv("CYCLONUS_PACK", "1" if pack else "0")
    policies, pods, namespaces = fuzz_policies(seed, 8)
    ref = TpuPolicyEngine(ref_build(True, policies), pods, namespaces,
                          class_compress=class_compress)
    port = TorchPolicyEngine(port_policy(policies), pods, namespaces, device="cpu",
                             class_compress=class_compress)
    return ref, port


#: reference span names with no step in the port: none on these routes
#: (the reference's unpack program and AOT adoption record no span; its
#: packed-buffer transfer and the port's tensor upload both record
#: engine.device_put)
REF_ONLY_SPANS: set = set()
#: port span names with no counterpart in the reference: the dense
#: route's precompute, opened on every fused and split counts call so
#: that a profiler trace shows each call's mode, and the ip leg inside
#: every precompute whose peer rows hold ipBlocks
PORT_ONLY_SPANS = {"engine.precompute", "engine.ip_peers"}

ROUTES = {
    # name: (pack, class_compress, calls, engine method)
    "packed": (True, "0", 3, "counts"),
    "class": (True, "1", 3, "counts"),
    "dense": (False, "0", 3, "counts"),
    "sharded": (True, "0", 1, "sharded"),
    "ring": (True, "0", 1, "ring"),
}


class TestEngineInstrumentation:
    @pytest.mark.parametrize("route", sorted(ROUTES))
    def test_route_moves_the_same_instruments(self, monkeypatch, route):
        pack, cc, calls, method = ROUTES[route]
        ref, port = twin_engines(monkeypatch, pack, cc)
        ref_cases = [RefPortCase(*c) for c in CASE_TUPLES]
        cases = [PortCase(*c) for c in CASE_TUPLES]
        if route == "class":
            assert port._class_counts_eligible(len(cases))
        reset_both()
        for _ in range(calls):
            if method == "counts":
                want = ref.evaluate_grid_counts(ref_cases, backend="pallas")
                got = port.evaluate_grid_counts(cases)
            elif method == "sharded":
                want = ref.evaluate_grid_counts_sharded(ref_cases)
                got = port.evaluate_grid_counts_sharded(cases)
            else:
                want = ref.evaluate_grid_counts_ring(ref_cases)
                got = port.evaluate_grid_counts_ring(cases)
            assert got == want
        assert metric_view(port_telemetry) == metric_view(ref_telemetry)
        assert nonzero_gauges(port_telemetry) == nonzero_gauges(ref_telemetry)
        assert flights(port_telemetry) == flights(ref_telemetry)
        assert len(flights(port_telemetry)) == calls
        assert all(f["cells"] == got["cells"] for f in flights(port_telemetry))
        ref_spans = set(ref_telemetry.SPANS.stats()) - REF_ONLY_SPANS
        assert set(port_telemetry.SPANS.stats()) - PORT_ONLY_SPANS == ref_spans

    def test_constructor_and_grid_spans(self, monkeypatch):
        """Construction records engine.encode with its nested steps, and a
        grid records its dispatch-only flight; both as the reference."""
        reset_both()
        ref, port = twin_engines(monkeypatch, True, "1")
        for eng, cases in ((ref, [RefPortCase(*c) for c in CASE_TUPLES]),
                           (port, [PortCase(*c) for c in CASE_TUPLES])):
            g = eng.evaluate_grid(cases)
            _ = g.combined
            eng.evaluate_pairs(cases, [(0, 1), (2, 3)])
        assert set(port_telemetry.SPANS.stats()) == set(ref_telemetry.SPANS.stats())
        assert flights(port_telemetry) == flights(ref_telemetry)
        tree = port_telemetry.SPANS.tree()
        assert "engine.encode/engine.classify" in tree
        assert "engine.encode/engine.partition" in tree
        assert metric_view(port_telemetry) == metric_view(ref_telemetry)
        for g in ("cyclonus_tpu_class_pods", "cyclonus_tpu_class_count",
                  "cyclonus_tpu_class_compression_ratio"):
            assert (port_telemetry.METRICS.snapshot()[g]["samples"]
                    == ref_telemetry.METRICS.snapshot()[g]["samples"])

    def test_phase_stats_names(self, monkeypatch):
        """--phase-stats renders utils/tracing.render_stats: the same rows
        (names and counts) in both packages for one counts call."""
        from cyclonus_tpu.utils import tracing as ref_tracing

        ref, port = twin_engines(monkeypatch, True, "0")
        reset_both()
        ref.evaluate_grid_counts([RefPortCase(*c) for c in CASE_TUPLES], backend="pallas")
        port.evaluate_grid_counts([PortCase(*c) for c in CASE_TUPLES])

        def rows(text):
            return [ln.split()[:2] for ln in text.splitlines()
                    if ln.split()[0] not in PORT_ONLY_SPANS]

        assert rows(tracing.render_stats()) == rows(ref_tracing.render_stats())
        assert tracing.stats()["engine.precompute"]["count"] == 1

    def test_ip_leg_feeds_its_instruments_and_span(self, monkeypatch):
        """Counts calls over policies with ipBlocks (the synthetic
        cluster's, one except each) feed the ip leg's four instruments:
        the gauges from its legs, the counter with each precompute's pod
        columns a direction (the fused and split calls' whole axis, then
        a pin patch's columns); engine.ip_peers runs once a direction and
        precompute, inside engine.precompute or engine.pre_patch."""
        import random

        from cyclonus_tpu_torch.matcher import build_network_policies
        from cyclonus_tpu_torch.synthetic import build_synthetic

        monkeypatch.setenv("CYCLONUS_PACK", "1")
        pods, namespaces, policies = build_synthetic(120, 16, random.Random(4))
        port = TorchPolicyEngine(build_network_policies(True, policies), pods, namespaces,
                                 device="cpu", compact=False)
        cases = [PortCase(*c) for c in CASE_TUPLES]
        reset_both()
        port.evaluate_grid_counts(cases)
        port.evaluate_grid_counts(cases)
        legs = port._ip_legs
        port.invalidate_after_pod_patch([3, 7])
        port.evaluate_grid_counts(cases)
        assert port._last_counts_mode == "steady"
        snap = port_telemetry.METRICS.snapshot()

        def value(name):
            return snap[name]["samples"][0]["value"]

        n = int(port._tensors["pod_ns_id"].shape[0])
        assert value("cyclonus_tpu_ip_except_rows") == sum(g["n_block"] for g in legs.values()) > 0
        assert value("cyclonus_tpu_ip_atoms") == sum(g["n_atoms"] for g in legs.values())
        assert value("cyclonus_tpu_ip_partitions") == sum(g["n_partitions"] for g in legs.values())
        dirs = sum(1 for g in legs.values() if g["n_block"] or g["n_part"])
        assert value("cyclonus_tpu_ip_resolved_columns_total") == dirs * (2 * n + 2)
        assert tracing.stats()["engine.ip_peers"]["count"] == 3 * dirs
        tree = port_telemetry.SPANS.tree()
        assert any(p.endswith("engine.precompute/engine.ip_peers") for p in tree)
        assert any(p.endswith("engine.pre_patch/engine.ip_peers") for p in tree)


class TestKernelTraces:
    def test_first_shape_rises_then_flat(self, monkeypatch):
        monkeypatch.setattr(port_build, "_TRACED", set())
        for pack, label in ((True, "counts_packed"), (False, "counts_1chunk")):
            _ref, port = twin_engines(monkeypatch, pack, "0")
            cases = [PortCase(*c) for c in CASE_TUPLES]
            before = ti.KERNEL_TRACES.value(kernel=label)
            dispatches = ti.EVAL_DISPATCHES.value(path="counts.pallas")
            for _ in range(4):
                port.evaluate_grid_counts(cases)
            assert ti.KERNEL_TRACES.value(kernel=label) == before + 1
            assert ti.EVAL_DISPATCHES.value(path="counts.pallas") == dispatches + 4
            if not pack:
                assert ti.KERNEL_TRACES.value(kernel="counts_rect") >= 1
            # a new shape is a new trace
            port.evaluate_grid_counts(cases[:1])
            assert ti.KERNEL_TRACES.value(kernel=label) == before + 2


class TestNoSyncAdded:
    def test_readbacks_equal_on_and_off(self, monkeypatch):
        """A steady counts call makes the same readbacks (Tensor.cpu,
        .item, .tolist) with telemetry on as with it off."""
        calls = {"n": 0}
        for name in ("cpu", "item", "tolist"):
            real = getattr(torch.Tensor, name)

            def counted(self, *a, _real=real, **kw):
                calls["n"] += 1
                return _real(self, *a, **kw)

            monkeypatch.setattr(torch.Tensor, name, counted)
        for pack, cc in ((True, "0"), (True, "1"), (False, "0")):
            _ref, port = twin_engines(monkeypatch, pack, cc)
            cases = [PortCase(*c) for c in CASE_TUPLES]
            for _ in range(3):
                port.evaluate_grid_counts(cases)  # reach the steady state
            seen = {}
            for on in (True, False, True):
                port_telemetry.set_enabled(on)
                try:
                    calls["n"] = 0
                    port.evaluate_grid_counts(cases)
                    seen.setdefault(on, set()).add(calls["n"])
                finally:
                    port_telemetry.set_enabled(True)
            assert seen[True] == seen[False] and len(seen[True]) == 1, (pack, cc, seen)


class TestProbeInstruments:
    def test_worker_latency_histograms(self):
        from cyclonus_tpu_torch.probe.runner import KubeBatchJobRunner
        from cyclonus_tpu_torch.worker.model import Batch, Request, Result
        from cyclonus_tpu_torch.worker.worker import run_worker

        port_telemetry.METRICS.reset()
        batch = Batch(namespace="x", pod="a", container="c",
                      requests=[Request(key="k1", protocol="tcp", host="127.0.0.1", port=1)])
        out = json.loads(run_worker(batch.to_json()))
        assert out[0]["LatencyMs"] > 0

        class _FakeClient:
            def batch(self, batch):
                return [Result(request=Request(key="k", protocol="tcp", host="h", port=1),
                               output="connected", latency_ms=12.5)]

        runner = KubeBatchJobRunner.__new__(KubeBatchJobRunner)
        runner.client = _FakeClient()
        runner.workers = 1
        assert runner._run_batch(Batch(namespace="x", pod="a", container="c"))[0][1] == "allowed"
        samples = port_telemetry.METRICS.snapshot()["cyclonus_tpu_probe_latency_seconds"]["samples"]
        by_source = {s["labels"]["source"]: s for s in samples}
        assert by_source["worker"]["count"] == 1
        assert by_source["batch"]["count"] == 1 and abs(by_source["batch"]["sum"] - 0.0125) < 1e-9

    def test_trace_verdicts_and_verdict_counter(self, caplog, monkeypatch):
        """CYCLONUS_TRACE_VERDICTS=1 logs each simulated verdict, and the
        verdict counter moves by the job count on both engines."""
        from cyclonus_tpu_torch.kube import MockKubernetes
        from cyclonus_tpu_torch.matcher import build_network_policies
        from cyclonus_tpu_torch.probe import Resources, new_simulated_runner
        from cyclonus_tpu_torch.probe.probeconfig import ProbeConfig

        resources = Resources.new_default(MockKubernetes(1.0), ["x"], ["a", "b"], [80], ["TCP"],
                                          pod_creation_timeout_seconds=1)
        policy = build_network_policies(True, [])
        config = ProbeConfig.all_available_config()
        port_telemetry.METRICS.reset()
        monkeypatch.delenv("CYCLONUS_TRACE_VERDICTS", raising=False)
        with caplog.at_level("DEBUG", logger="cyclonus.trace.verdicts"):
            new_simulated_runner(policy, engine="oracle").run_probe_for_config(config, resources)
            assert not [r for r in caplog.records if "verdict" in r.getMessage()]
            monkeypatch.setenv("CYCLONUS_TRACE_VERDICTS", "1")
            for engine in ("oracle", "cuda"):
                new_simulated_runner(policy, engine=engine, device="cpu").run_probe_for_config(
                    config, resources)
        lines = [r.getMessage() for r in caplog.records if "verdict" in r.getMessage()]
        assert any("[oracle]" in ln for ln in lines) and any("[cuda]" in ln for ln in lines)
        assert len([ln for ln in lines if "[cuda]" in ln]) == ti.VERDICTS.value(engine="cuda") > 0
        assert ti.VERDICTS.value(engine="oracle") == 2 * ti.VERDICTS.value(engine="cuda")


def test_torch_profile_writes_chrome_trace(tmp_path):
    """utils/tracing.torch_profile on the CPU: a Chrome trace of the
    block's torch operations."""
    d = str(tmp_path / "prof")
    with tracing.torch_profile(d):
        torch.ones(64, 64) @ torch.ones(64, 64)
    with tracing.torch_profile(""):
        pass
    trace = json.load(open(os.path.join(d, tracing.PROFILE_TRACE_FILE)))
    assert any("mm" in e.get("name", "") for e in trace["traceEvents"])

