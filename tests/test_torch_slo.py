"""The port's SLO engine (cyclonus_tpu_torch/slo) against the reference's
(cyclonus_tpu/slo): the same observation and time sequences, with an
injected clock, through both packages' accountants, hysteresis machines
and SloControllers give equal snapshots (states, burn rates, budget
remaining, breaches) at every step; the enforcement decisions agree
under forced states; a breach dumps the flight recorder naming its
objective, as the reference's does.  Then the controller wired into the
port's VerdictService: shed and the degraded route never change a
verdict against the reference's service, admission control on submit()
and the wire loop, /slo over HTTP, the slo block of state(), and the
scrape-time tick."""

import dataclasses
import json
import random
import threading
import urllib.error
import urllib.request

import pytest

import cyclonus_tpu.slo as ref_slo
import cyclonus_tpu_torch.slo as port_slo
from cyclonus_tpu import telemetry as ref_telemetry
from cyclonus_tpu.serve import VerdictService as RefService
from cyclonus_tpu.serve.loop import handle_line as ref_handle_line
from cyclonus_tpu.telemetry import instruments as ref_ti
from cyclonus_tpu.worker.model import Batch as RefBatch
from cyclonus_tpu.worker.model import Delta as RefDelta
from cyclonus_tpu.worker.model import FlowQuery as RefQuery
from cyclonus_tpu_torch import telemetry as port_telemetry
from cyclonus_tpu_torch.serve import VerdictService
from cyclonus_tpu_torch.serve.loop import handle_line
from cyclonus_tpu_torch.serve.service import AdmissionRejected, register_http
from cyclonus_tpu_torch.slo import BURNING, EXHAUSTED, OK, SloController
from cyclonus_tpu_torch.telemetry import instruments as ti
from cyclonus_tpu_torch.telemetry import server as tserver
from cyclonus_tpu_torch.worker.model import Batch, Delta, FlowQuery

#: the two packages' (slo module, telemetry package, instruments)
PKGS = {"ref": (ref_slo, ref_telemetry, ref_ti), "port": (port_slo, port_telemetry, ti)}

#: windows and hold shrunk so a 60-tick timeline crosses every state
SHORT = {"CYCLONUS_SLO_FAST_S": "5", "CYCLONUS_SLO_SLOW_S": "10", "CYCLONUS_SLO_HOLD_S": "2",
         "CYCLONUS_SLO_BUDGET": "0.25", "CYCLONUS_SLO_QUERY_P99_S": "0.1",
         "CYCLONUS_SLO_FRESHNESS_S": "5", "CYCLONUS_SLO_TTFV_S": "3"}


class FakeClock:
    def __init__(self, t=0.0):
        self.t = float(t)

    def __call__(self):
        return self.t


def synth_hist(good, bad, buckets=(0.05, 0.2)):
    """A cumulative latency histogram snapshot: `good` events under the
    first bound, `bad` in the second bucket."""
    return {"type": "histogram", "help": "synthetic", "buckets": list(buckets),
            "samples": [{"labels": {}, "counts": [good, bad], "sum": 0.0,
                         "count": good + bad}]}


def timeline(seed, n=60):
    """A seeded observation sequence: per tick the time, cumulative
    (good, bad) latency events, a staleness sample (None: a contended
    tick), audit checks and divergences to add, and an optional
    time-to-first-verdict to observe.  Bursts of bad latency, stale
    queues and divergences push objectives through burning and
    exhausted; quiet stretches let them recover."""
    rng = random.Random(seed)
    good = bad = 0
    out = []
    t = 0.0
    for i in range(n):
        t += rng.choice((0.5, 1.0, 1.0, 2.0))
        phase = (i // 12) % 3
        good += rng.randrange(0, 40)
        if phase == 1:
            bad += rng.randrange(0, 30)
        staleness = None if rng.random() < 0.1 else (
            rng.uniform(6, 30) if phase == 1 and rng.random() < 0.7 else rng.uniform(0, 4))
        checks = rng.randrange(0, 10)
        diverged = rng.randrange(checks + 1) if phase == 1 and rng.random() < 0.6 else 0
        ttfv = rng.uniform(0.5, 6.0) if i == 3 else None
        out.append((t, good, bad, staleness, checks, diverged, ttfv))
    return out


def run_timeline(pkg, seq, tmp_path, monkeypatch, enforce):
    """Feed `seq` to one package's controller; returns the snapshot after
    every step and the flight-recorder dump of its last breach."""
    slo, tel, tinst = PKGS[pkg]
    tel.reset()
    for k, v in SHORT.items():
        monkeypatch.setenv(k, v)
    dump = tmp_path / f"{pkg}-breach.json"
    monkeypatch.setenv("CYCLONUS_FLIGHT_RECORDER_PATH", str(dump))
    clock = FakeClock()
    ctl = slo.SloController(enforce=enforce, queue_cap=16, clock=clock)
    snaps = []
    for t, good, bad, staleness, checks, diverged, ttfv in seq:
        clock.t = t
        tinst.AUDIT_CHECKED.inc(checks)
        tinst.AUDIT_DIVERGED.inc(diverged)
        ctl.tick(staleness_s=staleness, latency_snapshot=synth_hist(good, bad), now=t)
        if ttfv is not None:
            ctl.observe_ttfv(ttfv, now=t)
        snaps.append((ctl.snapshot(), ctl.query_route(), ctl.admit(12, 6)))
    return snaps, (json.loads(dump.read_text()) if dump.exists() else None)


def breach_entries(dump):
    """The dump's slo.breach entries without their per-process fields."""
    return [{k: v for k, v in e.items() if k not in ("seq", "at", "trace_id", "span_path")}
            for e in dump["entries"] if e.get("path") == "slo.breach"]


def objectives(slo):
    return [dataclasses.asdict(o) for o in slo.declared_objectives()]


class TestControllerDifferential:
    @pytest.mark.parametrize("seed", range(6))
    @pytest.mark.parametrize("enforce", [True, False])
    def test_timeline_snapshots_equal_reference(self, seed, enforce, tmp_path, monkeypatch):
        seq = timeline(seed)
        want, want_dump = run_timeline("ref", seq, tmp_path, monkeypatch, enforce)
        got, got_dump = run_timeline("port", seq, tmp_path, monkeypatch, enforce)
        for i, (g, w) in enumerate(zip(got, want)):
            assert g == w, (i, seq[i])
        assert (got_dump is None) == (want_dump is None)
        if want_dump is not None:
            assert got_dump["reason"] == want_dump["reason"]
            assert breach_entries(got_dump) == breach_entries(want_dump)

    def test_timelines_cross_every_state(self, tmp_path, monkeypatch):
        """The seeded timelines do exercise the machine: every objective
        but ttfv burns or exhausts somewhere, and something recovers."""
        seen = {}
        for seed in range(6):
            snaps, _dump = run_timeline("port", timeline(seed), tmp_path, monkeypatch, True)
            for snap, _route, _admit in snaps:
                for name, o in snap["objectives"].items():
                    seen.setdefault(name, set()).add(o["state"])
        for name in ("query_p99", "freshness", "verdict_integrity"):
            assert {OK, EXHAUSTED} <= seen[name], (name, seen[name])
        assert BURNING in seen["query_p99"] | seen["freshness"]

    @pytest.mark.parametrize("seed", range(4))
    def test_accountant_equals_reference(self, seed):
        rng = random.Random(seed)
        a = ref_slo.BurnAccountant(budget=0.1, fast_s=3.0, slow_s=9.0)
        b = port_slo.BurnAccountant(budget=0.1, fast_s=3.0, slow_s=9.0)
        total = bad = 0.0
        t = 0.0
        for i in range(80):
            t += rng.uniform(0.1, 1.5)
            if i == 40:  # a registry reset: the stream moves backwards
                total = bad = 0.0
            total += rng.randrange(0, 20)
            bad += rng.randrange(0, 5)
            bad = min(bad, total)
            a.observe(t, total, bad)
            b.observe(t, total, bad)
            assert b.burn_rates(t) == a.burn_rates(t)
            assert b.budget_remaining(t) == a.budget_remaining(t)
            assert [tuple(vars(s).values()) for s in b._samples] == [
                tuple(vars(s).values()) for s in a._samples]

    @pytest.mark.parametrize("seed", range(4))
    def test_hysteresis_equals_reference(self, seed):
        rng = random.Random(seed)
        a = ref_slo.Hysteresis(2.0, 1.0, 3.0)
        b = port_slo.Hysteresis(2.0, 1.0, 3.0)
        t = 0.0
        for _ in range(120):
            t += rng.uniform(0.2, 2.0)
            fast, slow = rng.uniform(0, 4), rng.uniform(0, 3)
            remaining = 0.0 if rng.random() < 0.05 else rng.uniform(0.01, 1)
            assert b.update(t, fast, slow, remaining) == a.update(t, fast, slow, remaining)
            assert (b.state, b.since, b.transitions) == (a.state, a.since, a.transitions)
        assert port_slo.state_severity(EXHAUSTED) == ref_slo.state_severity(EXHAUSTED) == 2

    def test_events_over_target_equals_reference(self):
        snap = {"buckets": [0.01, 0.1, 1.0],
                "samples": [{"count": 10, "counts": [3, 4, 2]},
                            {"count": 5, "counts": [5, 0, 0]}]}
        for target in (0.005, 0.01, 0.05, 0.1, 2.0):
            assert port_slo.events_over_target(snap, target) == ref_slo.events_over_target(
                snap, target)
        assert port_slo.events_over_target({}, 0.1) == {"total": 0.0, "bad": 0.0}

    def test_declared_objectives_equal_reference(self, monkeypatch):
        assert objectives(port_slo) == objectives(ref_slo)
        monkeypatch.setenv("CYCLONUS_SLO_QUERY_P99_S", "0.5")
        monkeypatch.setenv("CYCLONUS_SLO_BUDGET", "not-a-number")
        got = {o.name: o for o in port_slo.declared_objectives()}
        assert objectives(port_slo) == objectives(ref_slo)
        assert got["query_p99"].target_s == 0.5 and got["query_p99"].budget == 0.01


STATES = [None, OK, BURNING, EXHAUSTED]


class TestDecisions:
    @pytest.mark.parametrize("enforce", [True, False])
    @pytest.mark.parametrize("state", STATES)
    def test_query_route_equals_reference(self, enforce, state):
        ctls = [m.SloController(enforce=enforce) for m in (ref_slo, port_slo)]
        for c in ctls:
            c.force_state("query_p99", state)
        assert ctls[1].query_route() == ctls[0].query_route()
        want = "live" if not enforce else {BURNING: "degraded", EXHAUSTED: "shed"}.get(state, "live")
        assert ctls[1].query_route() == want

    @pytest.mark.parametrize("enforce", [True, False])
    @pytest.mark.parametrize("state", STATES)
    def test_admit_equals_reference(self, enforce, state):
        ctls = [m.SloController(enforce=enforce, queue_cap=8) for m in (ref_slo, port_slo)]
        for c in ctls:
            c.force_state("freshness", state)
        for depth, incoming in ((0, 1), (4, 2), (7, 2), (100, 100)):
            assert ctls[1].admit(depth, incoming) == ctls[0].admit(depth, incoming)

    def test_force_state_rejects_unknown(self):
        with pytest.raises(ValueError):
            SloController(enforce=True).force_state("query_p99", "melted")

    def test_slo_state_gauge_moves(self):
        ctl = SloController(enforce=True)
        ctl.force_state("query_p99", EXHAUSTED)
        assert ti.SLO_STATE.value(objective="query_p99") == 2
        ctl.force_state("query_p99", BURNING)
        assert ti.SLO_STATE.value(objective="query_p99") == 1
        ctl.force_state("query_p99", None)
        assert ti.SLO_STATE.value(objective="query_p99") == 0


class TestBreachDump:
    def _drive(self, pkg, objective, tmp_path, monkeypatch):
        slo, tel, tinst = PKGS[pkg]
        tel.reset()
        path = tmp_path / f"{pkg}-{objective}.json"
        monkeypatch.setenv("CYCLONUS_FLIGHT_RECORDER_PATH", str(path))
        for k, v in SHORT.items():
            monkeypatch.setenv(k, v)
        ctl = slo.SloController(enforce=True, clock=FakeClock())
        if objective == "ttfv":
            ctl.observe_ttfv(7.5, now=1.0)
        for t in range(1, 4):
            if objective == "verdict_integrity":
                tinst.AUDIT_CHECKED.inc(4)
                tinst.AUDIT_DIVERGED.inc(4)
            ctl.tick(
                staleness_s=60.0 if objective == "freshness" else 0.0,
                latency_snapshot=synth_hist(0, 10 * t) if objective == "query_p99"
                else synth_hist(0, 0),
                now=float(t),
            )
        assert ctl.state_of(objective) == EXHAUSTED
        return json.loads(path.read_text()), ctl.snapshot()["objectives"][objective]["breaches"]

    @pytest.mark.parametrize("objective", ["query_p99", "freshness", "ttfv", "verdict_integrity"])
    def test_breach_dump_names_the_objective(self, objective, tmp_path, monkeypatch):
        want, want_n = self._drive("ref", objective, tmp_path, monkeypatch)
        got, got_n = self._drive("port", objective, tmp_path, monkeypatch)
        assert got["reason"] == want["reason"] == f"slo-breach:{objective}"
        assert breach_entries(got) == breach_entries(want)
        assert breach_entries(got)[-1]["objective"] == objective
        assert got_n == want_n == 1
        assert ti.SLO_BREACHES.value(objective=objective) == 1

    def test_note_first_verdict_is_idempotent(self):
        clock = FakeClock(0.0)
        ctl = SloController(enforce=True, clock=clock)
        clock.t = 3.0
        ctl.note_first_verdict()
        clock.t = 500.0
        ctl.note_first_verdict()
        assert [s.total for s in ctl._trackers["ttfv"].acct._samples] == [1.0]
        assert ctl.state_of("ttfv") == OK

    def test_tick_never_raises(self):
        SloController(enforce=True).tick(latency_snapshot={"buckets": "garbage"}, now=1.0)


def mk_cluster(n_pods=10):
    namespaces = {"x": {"ns": "x"}, "y": {"ns": "y"}}
    pods = []
    for i in range(n_pods):
        ns = "x" if i % 2 == 0 else "y"
        pods.append((ns, f"p{i}", {"app": f"a{i % 3}", "tier": f"t{i % 2}"}, f"10.0.0.{i + 1}"))
    return pods, namespaces


def mk_service(**kw):
    return VerdictService(*mk_cluster(), [], device="cpu", **kw)


def mk_queries(n=6, cls=FlowQuery):
    pods, _ = mk_cluster()
    keys = [f"{p[0]}/{p[1]}" for p in pods]
    rng = random.Random(3)
    return [cls(src=rng.choice(keys), dst=rng.choice(keys), port=80, protocol="TCP",
                port_name="serve-80-tcp") for _ in range(n)]


def bits(v):
    return (v.ingress, v.egress, v.combined, v.error, v.shed, v.epoch)


class TestServiceEnforcement:
    def test_shed_and_degraded_never_change_a_verdict(self):
        """Live, degraded and recovered answers equal the reference
        service's; shed answers are typed refusals, as the reference's,
        and move SLO_SHED by the batch size."""
        svc = mk_service(slo=SloController(enforce=True))
        ref = RefService(*mk_cluster(), [], slo=ref_slo.SloController(enforce=True))
        queries, ref_queries = mk_queries(), mk_queries(cls=RefQuery)
        baseline = [bits(v) for v in ref.query(ref_queries)]
        assert [bits(v) for v in svc.query(queries)] == baseline
        degraded0 = ti.SERVE_DEGRADED.value()
        for c in (svc.slo, ref.slo):
            c.force_state("query_p99", BURNING)
        assert [bits(v) for v in svc.query(queries)] == [bits(v) for v in ref.query(ref_queries)]
        assert ti.SERVE_DEGRADED.value() == degraded0 + len(queries)
        for c in (svc.slo, ref.slo):
            c.force_state("query_p99", EXHAUSTED)
        shed0 = ti.SLO_SHED.value()
        out = svc.query(queries)
        assert [v.to_dict() for v in out] == [v.to_dict() for v in ref.query(ref_queries)]
        assert all(v.shed and v.error for v in out)
        assert ti.SLO_SHED.value() == shed0 + len(queries)
        for c in (svc.slo, ref.slo):
            c.force_state("query_p99", None)
        assert [bits(v) for v in svc.query(queries)] == baseline

    def test_admission_control_on_submit(self):
        svc = mk_service(slo=SloController(enforce=True, queue_cap=2))
        ref = RefService(*mk_cluster(), [], slo=ref_slo.SloController(enforce=True, queue_cap=2))
        delta = Delta(kind="ns_labels", namespace="x", labels={"k": "v"})
        ref_delta = RefDelta(kind="ns_labels", namespace="x", labels={"k": "v"})
        for c in (svc.slo, ref.slo):
            c.force_state("freshness", EXHAUSTED)
        rejects0 = ti.SLO_ADMISSION_REJECTS.value()
        with pytest.raises(AdmissionRejected) as got:
            svc.submit([delta])
        with pytest.raises(Exception) as want:
            ref.submit([ref_delta])
        assert str(got.value) == str(want.value)
        assert ti.SLO_ADMISSION_REJECTS.value() == rejects0 + 1
        with svc._lock:
            assert len(svc._queue) == 0
        svc.slo.force_state("freshness", BURNING)
        assert svc.submit([delta]) == 1
        with pytest.raises(AdmissionRejected):
            svc.submit([delta, delta])
        svc.slo.force_state("freshness", None)
        assert svc.submit([delta, delta]) == 3
        assert svc.apply_pending()["applied"] == 3

    def test_wire_loop_reports_admission_backpressure(self):
        svc = mk_service(slo=SloController(enforce=True))
        ref = RefService(*mk_cluster(), [], slo=ref_slo.SloController(enforce=True))
        for c in (svc.slo, ref.slo):
            c.force_state("freshness", EXHAUSTED)
        line = RefBatch(namespace="", pod="", container="",
                        deltas=[RefDelta(kind="ns_labels", namespace="x", labels={"k": "v"})],
                        queries=mk_queries(2, cls=RefQuery)).to_json()
        assert Batch.from_json(line).to_json() == line
        got, want = handle_line(svc, line), ref_handle_line(ref, line)
        for reply in (got, want):
            for v in reply["Verdicts"]:
                v.pop("LatencyMs", None)
        assert got == want
        assert got["Applied"] == 0 and "freshness" in got["Admission"]
        assert len(got["Verdicts"]) == 2

    def test_http_query_maps_shed_to_429(self):
        svc = mk_service(slo=SloController(enforce=True))
        register_http(svc)
        try:
            fn = tserver._route_for("/query")
            q = mk_queries(1)[0]
            params = {"src": [q.src], "dst": [q.dst], "port": [str(q.port)],
                      "protocol": [q.protocol], "portName": [q.port_name]}
            payload, code = fn(params)
            assert code == 200 and "Shed" not in payload
            svc.slo.force_state("query_p99", EXHAUSTED)
            payload, code = fn(params)
            assert code == 429 and payload["Shed"] is True and payload["Error"]
        finally:
            tserver.unregister_route("/query")
            tserver.unregister_route("/state")
            tserver.register_slo(None)
            tserver.register_audit(None)

    def test_state_slo_block_equals_reference(self):
        for enforce in (True, False):
            svc = mk_service(slo=SloController(enforce=enforce))
            ref = RefService(*mk_cluster(), [], slo=ref_slo.SloController(enforce=enforce))
            assert svc.state()["slo"] == ref.state()["slo"]
            for c in (svc.slo, ref.slo):
                c.force_state("freshness", BURNING)
            assert svc.state()["slo"] == ref.state()["slo"]
            assert svc.state()["slo"]["objectives"]["freshness"]["state"] == BURNING
        assert mk_service().state()["slo"]["enforce"] is False

    def test_enforcement_off_by_default(self, monkeypatch):
        monkeypatch.delenv("CYCLONUS_SLO_ENFORCE", raising=False)
        svc = mk_service()
        svc.slo.force_state("query_p99", EXHAUSTED)
        svc.slo.force_state("freshness", EXHAUSTED)
        assert not any(v.shed for v in svc.query(mk_queries()))
        assert svc.submit([Delta(kind="ns_labels", namespace="x", labels={"k": "v"})]) == 1
        monkeypatch.setenv("CYCLONUS_SLO_ENFORCE", "1")
        assert mk_service().slo.enforce is True

    def test_gauge_refresh_ticks_and_counts_contention(self):
        svc = mk_service()
        skipped0 = ti.SERVE_GAUGE_REFRESH_SKIPPED.value()
        ticks0 = svc.slo.snapshot()["ticks"]
        svc._refresh_gauges()
        assert svc.slo.snapshot()["ticks"] == ticks0 + 1
        entered, release = threading.Event(), threading.Event()

        def hold():
            with svc._lock:
                entered.set()
                release.wait(timeout=30)

        t = threading.Thread(target=hold, daemon=True)
        t.start()
        assert entered.wait(timeout=10)
        try:
            svc._refresh_gauges()
        finally:
            release.set()
            t.join(timeout=10)
        assert ti.SERVE_GAUGE_REFRESH_SKIPPED.value() == skipped0 + 1
        assert svc.slo.snapshot()["ticks"] == ticks0 + 2

    def test_first_verdict_stamps_ttfv(self):
        svc = mk_service()
        assert svc.slo._trackers["ttfv"].acct._samples == []
        svc.query(mk_queries(1))
        assert [s.total for s in svc.slo._trackers["ttfv"].acct._samples] == [1.0]


def get_json(url):
    try:
        with urllib.request.urlopen(url, timeout=30) as resp:
            return resp.status, json.loads(resp.read().decode())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode())


class TestSloHttpRoute:
    def test_slo_route_200_with_a_service_and_503_without(self):
        tserver.register_slo(None)
        srv = tserver.start_metrics_server(0)
        try:
            status, body = get_json(srv.url + "/slo")
            assert status == 503 and "no slo provider" in body["error"]
            svc = mk_service(slo=SloController(enforce=True))
            register_http(svc)
            status, body = get_json(srv.url + "/slo")
            assert status == 200 and body == json.loads(json.dumps(svc.slo_snapshot()))
            assert body["enforce"] is True
            assert set(body["objectives"]) == {"query_p99", "freshness", "ttfv",
                                               "verdict_integrity"}
        finally:
            for route in ("/state", "/query"):
                tserver.unregister_route(route)
            tserver.register_slo(None)
            tserver.register_audit(None)
            tserver.stop_metrics_server()

    def test_broken_provider_answers_500(self):
        def boom():
            raise RuntimeError("controller exploded")

        tserver.register_slo(boom)
        srv = tserver.start_metrics_server(0)
        try:
            status, body = get_json(srv.url + "/slo")
            assert status == 500 and "controller exploded" in body["error"]
        finally:
            tserver.register_slo(None)
            tserver.stop_metrics_server()
