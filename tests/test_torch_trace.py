"""The port's trace timeline (cyclonus_tpu_torch/telemetry: events.py,
trace_export.py, the span context across the worker wire, /profile)
against the reference's, on the CPU:

  * the event ring: off by default, bounded, `ingest` skipping this
    process's own pid, `mark` / `since`, `adopt`;
  * the Chrome export: the same keys and the same (name, ph) sequence as
    the reference's export of the same spans;
  * the driver -> worker round trip under one trace id, in process and
    through a real worker subprocess (`python -m cyclonus_tpu_torch.worker`,
    with --metrics-port and --trace-out too);
  * `probe --trace-out` writing the timeline, and the `trace` command;
  * /profile on the CPU (torch.profiler, CPU activity): 200 with a
    Chrome trace, 400 on bad seconds, 409 on a concurrent capture.

The loopback run whose trace merges the driver's and the worker
subprocesses' events (`generate --loopback --batch-jobs --trace-out`)
lives with the other loopback tests in tests/test_torch_loopback.py."""

import json
import os
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import pytest

import cyclonus_tpu.telemetry.events as ref_events
import cyclonus_tpu.telemetry.spans as ref_spans
import cyclonus_tpu.telemetry.trace_export as ref_export
from cyclonus_tpu_torch import telemetry
from cyclonus_tpu_torch.cli import main
from cyclonus_tpu_torch.telemetry import events, trace_export
from cyclonus_tpu_torch.telemetry import server as tserver
from cyclonus_tpu_torch.telemetry.spans import adopt, span

from test_torch_engine import REPO


@pytest.fixture(autouse=True)
def _trace_isolation(tmp_path, monkeypatch):
    """Every test starts untraced and leaves nothing active (both
    packages), and no flight dump lands in the repo."""
    monkeypatch.setenv("CYCLONUS_FLIGHT_RECORDER_PATH", str(tmp_path / "flight.json"))
    for ev in (events, ref_events):
        ev.disable()
        ev.reset()
    yield
    for ev in (events, ref_events):
        ev.disable()
        ev.reset()
    tserver.stop_metrics_server()


def validate_chrome_trace(trace):
    """Required keys on every event, and per-(pid, tid) balanced B/E
    pairs, each E no earlier than its B.  Returns the span count."""
    assert "traceEvents" in trace and "displayTimeUnit" in trace
    stacks = {}
    spans = 0
    for e in trace["traceEvents"]:
        for key in trace_export.CHROME_EVENT_KEYS:
            assert key in e, f"event missing {key}: {e}"
        if e["ph"] == "M":
            continue
        assert e["ph"] in ("B", "E") and e["ts"] >= 0
        stack = stacks.setdefault((e["pid"], e["tid"]), [])
        if e["ph"] == "B":
            stack.append(e)
        else:
            b = stack.pop()
            assert b["name"] == e["name"] and e["ts"] >= b["ts"]
            spans += 1
    assert not any(stacks.values())
    return spans


class TestEventRing:
    def test_disabled_by_default(self):
        with span("ev.off"):
            pass
        assert events.entries() == [] and not events.enabled()

    def test_span_enter_exit_with_final_attrs(self):
        tid = events.enable()
        with span("ev.outer", pods=3) as s:
            with span("ev.inner"):
                pass
            s.set(targets=9)
        evts = events.entries()
        assert [(e["ph"], e["name"]) for e in evts] == [
            ("B", "ev.outer"), ("B", "ev.inner"), ("E", "ev.inner"), ("E", "ev.outer")]
        assert evts[1]["path"] == "ev.outer/ev.inner"
        assert all(e["trace_id"] == tid and e["pid"] == os.getpid() for e in evts)
        assert evts[0]["args"] == {"pods": 3} and evts[3]["args"] == {"pods": 3, "targets": 9}

    def test_bounded_newest_wins(self):
        events.enable()
        cap = events.RING.maxlen
        for i in range(cap + 10):
            events.record("B", f"n{i}", f"n{i}")
        assert len(events.entries()) == cap
        assert events.entries()[-1]["name"] == f"n{cap + 9}"

    def test_ingest_skips_own_pid_and_junk(self):
        events.enable("t1")
        with span("ev.mine"):
            pass
        own = events.entries()
        assert events.ingest(own) == 0
        assert events.ingest([dict(e, pid=os.getpid() + 1) for e in own]) == 2
        assert events.ingest([{"ph": "B"}, "junk", 42]) == 0
        assert len(events.entries()) == 4

    def test_mark_since(self):
        events.enable()
        with span("ev.before"):
            pass
        marker = events.mark()
        with span("ev.after"):
            pass
        assert [e["name"] for e in events.since(marker)] == ["ev.after", "ev.after"]
        assert events.since(events.mark()) == []

    def test_adopt_nests_under_foreign_path(self):
        events.enable()
        with adopt("driver/step-3"):
            with span("ev.child"):
                pass
        with span("ev.top"):
            pass
        assert [e["path"] for e in events.entries()][::2] == ["driver/step-3/ev.child", "ev.top"]

    def test_reset_keeps_the_trace_active(self):
        events.enable()
        with span("rst.a"):
            pass
        telemetry.reset()
        assert events.entries() == []
        with span("rst.b"):
            pass
        assert [e["name"] for e in events.entries()] == ["rst.b", "rst.b"]


def spans_in_both(trace_id):
    """The same nested spans recorded by both packages under one id."""
    for ev, sp in ((events, None), (ref_events, ref_spans)):
        ev.enable(trace_id)
        mk = span if sp is None else sp.span
        with mk("exp.a", x=1) as s:
            with mk("exp.b"):
                pass
            with mk("exp.c", k="v"):
                pass
            s.set(y=2)


class TestChromeExport:
    def test_keys_and_sequence_equal_reference(self):
        spans_in_both("shape-test")
        got, want = trace_export.to_chrome_trace(), ref_export.to_chrome_trace()
        assert validate_chrome_trace(got) == validate_chrome_trace(want) == 3
        assert set(got) == set(want)
        assert [(e["name"], e["ph"]) for e in got["traceEvents"]] == [
            (e["name"], e["ph"]) for e in want["traceEvents"]]
        assert [sorted(e) for e in got["traceEvents"]] == [sorted(e) for e in want["traceEvents"]]
        assert [e["args"] for e in got["traceEvents"] if e["ph"] != "M"] == [
            e["args"] for e in want["traceEvents"] if e["ph"] != "M"]
        assert got["otherData"]["trace_id"] == want["otherData"]["trace_id"] == "shape-test"
        first = [e for e in got["traceEvents"] if e["ph"] == "B"][0]
        assert first["ts"] == 0.0 and got["otherData"]["epoch_origin_s"] > 0

    def test_trace_id_filter_and_summary(self, tmp_path):
        events.enable("keep")
        with span("exp.keep"):
            pass
        events.ingest([{"ph": "B", "name": "exp.drop", "path": "exp.drop", "ts": 1.0,
                        "pid": os.getpid() + 1, "tid": 1, "trace_id": "other"}])
        trace = trace_export.to_chrome_trace(trace_id="keep")
        assert {e["name"] for e in trace["traceEvents"] if e["ph"] != "M"} == {"exp.keep"}
        p = trace_export.write_chrome_trace(str(tmp_path / "t.json"), trace_id="keep")
        data = json.load(open(p))
        assert trace_export.summarize(data) == ref_export.summarize(data)
        assert "exp.keep" in trace_export.summarize(data)
        assert trace_export.summarize({"traceEvents": []}).startswith("(empty trace")


class _WorkerKube:
    """An IKubernetes whose exec runs the port's in-process worker."""

    def execute_remote_command(self, namespace, pod, container, command):
        from cyclonus_tpu_torch.worker.worker import run_worker

        return run_worker(command[command.index("--jobs") + 1]), "", None


def one_job():
    from cyclonus_tpu_torch.probe.job import Job

    return [Job(from_key="x/a", from_namespace="x", from_pod="a", from_container="cont",
                to_key="x/b", to_host="127.0.0.1", to_namespace="x", resolved_port=1,
                resolved_port_name="p", protocol="TCP")]


class TestWorkerRoundTrip:
    def test_in_process_single_trace_single_ring(self, monkeypatch):
        from cyclonus_tpu_torch.probe.runner import KubeBatchJobRunner
        from cyclonus_tpu_torch.worker import worker as worker_mod
        from cyclonus_tpu_torch.worker.model import Result

        monkeypatch.setattr(worker_mod, "_probe_with_retries",
                            lambda request: Result(request=request, output="connected"))
        driver_tid = events.enable()
        with span("interpreter.step", step=0):
            results = KubeBatchJobRunner(_WorkerKube()).run_jobs(one_job())
        assert [r.combined for r in results] == ["allowed"]
        evts = events.entries()
        assert all(e["trace_id"] == driver_tid for e in evts)
        worker_evts = [e for e in evts if e["name"].startswith("worker.")]
        assert {e["name"] for e in worker_evts} == {"worker.batch", "worker.probe"}
        assert all(e["path"].startswith("interpreter.step/probe.kube_batch/") for e in worker_evts)
        assert len([e for e in worker_evts if e["name"] == "worker.probe" and e["ph"] == "B"]) == 1
        with span("post.batch"):
            pass
        assert events.entries()[-1]["role"] == "driver"
        validate_chrome_trace(trace_export.to_chrome_trace())

    def test_subprocess_worker_shares_trace_and_merges(self):
        from cyclonus_tpu_torch.worker.model import Batch, Request, Result

        driver_tid = events.enable()
        with span("interpreter.step", step=0):
            batch = Batch(namespace="x", pod="a", container="c",
                          requests=[Request(key="x/a->x/b", protocol="tcp", host="127.0.0.1",
                                            port=1)],
                          trace_id=driver_tid, parent_span="interpreter.step")
            proc = subprocess.run(
                [sys.executable, "-m", "cyclonus_tpu_torch.worker", "--jobs", batch.to_json()],
                capture_output=True, text=True, timeout=120, cwd=REPO,
                env=dict(os.environ, CYCLONUS_CONNECT_NATIVE="1"),
            )
        assert proc.returncode == 0, proc.stderr[-500:]
        shipped = [Result.from_dict(d) for d in json.loads(proc.stdout)][0].trace_events
        assert shipped and all(e["trace_id"] == driver_tid for e in shipped)
        assert all(e["pid"] != os.getpid() and e["role"] == "worker" for e in shipped)
        assert all(e["path"].startswith("interpreter.step/") for e in shipped)
        assert events.ingest(shipped) == len(shipped)
        trace = trace_export.to_chrome_trace(trace_id=driver_tid)
        validate_chrome_trace(trace)
        assert len({e["pid"] for e in trace["traceEvents"] if e["ph"] != "M"}) == 2
        names = {e["args"]["name"] for e in trace["traceEvents"] if e["ph"] == "M"}
        assert any("driver" in n for n in names) and any("worker" in n for n in names)

    def test_worker_metrics_port_and_trace_out(self, tmp_path):
        """The worker's own flags: --trace-out writes its timeline,
        --metrics-port reports the bound port, and the worker still loads
        no torch."""
        out = str(tmp_path / "worker.json")
        jobs = json.dumps({"Namespace": "x", "Pod": "a", "Container": "c", "Requests": [
            {"Key": "k", "Protocol": "tcp", "Host": "127.0.0.1", "Port": 1}]})
        code = (
            "import sys, runpy\n"
            "sys.argv = ['worker', '--jobs', sys.argv[1], '--metrics-port', '0', "
            "'--trace-out', sys.argv[2]]\n"
            "try:\n"
            "    runpy.run_module('cyclonus_tpu_torch.worker', run_name='__main__')\n"
            "finally:\n"
            "    print('TORCH', 'torch' in sys.modules, file=sys.stderr)\n"
        )
        proc = subprocess.run([sys.executable, "-c", code, jobs, out], capture_output=True,
                              text=True, timeout=120, cwd=REPO,
                              env=dict(os.environ, CYCLONUS_CONNECT_NATIVE="1"))
        assert proc.returncode == 0, proc.stderr[-1000:]
        assert "telemetry: metrics on http://127.0.0.1:" in proc.stderr
        assert "TORCH False" in proc.stderr
        assert json.loads(proc.stdout)[0]["Request"]["Key"] == "k"
        trace = json.load(open(out))
        names = {e["name"] for e in trace["traceEvents"] if e["ph"] != "M"}
        assert names == {"worker.batch", "worker.probe"}
        validate_chrome_trace(trace)


class TestProbeTraceOut:
    def test_probe_trace_out_writes_the_timeline(self, tmp_path, capsys):
        out = str(tmp_path / "run.json")
        rc = main(["probe", "--mock", "--perfect-cni", "--ignore-loopback", "--device", "cpu",
                   "--trace-out", out])
        assert rc == 0
        assert "trace: recording timeline" in capsys.readouterr().out
        trace = json.load(open(out))
        assert validate_chrome_trace(trace) > 0
        names = {e["name"] for e in trace["traceEvents"] if e["ph"] != "M"}
        for expected in ("probe.run", "interpreter.case", "interpreter.step",
                         "interpreter.probe", "probe.simulated", "engine.encode",
                         "engine.dispatch", "grid.fetch"):
            assert expected in names, expected
        assert len(trace["otherData"]["trace_ids"]) == 1
        paths = [e["args"]["path"] for e in trace["traceEvents"]
                 if e.get("name") == "interpreter.probe"]
        assert paths and all(
            p.startswith("probe.run/interpreter.case/interpreter.step") for p in paths)


class TestTraceCli:
    def test_out_and_input(self, tmp_path, capsys):
        from cyclonus_tpu.cli.root import main as ref_main

        events.enable("cli-test")
        with span("cli.span"):
            pass
        out = str(tmp_path / "cli.json")
        assert main(["trace", "--out", out]) == 0
        capsys.readouterr()
        validate_chrome_trace(json.load(open(out)))
        assert main(["trace", "--input", out]) == 0
        text = capsys.readouterr().out
        assert "cli.span" in text and "trace_id=cli-test" in text
        assert ref_main(["trace", "--input", out]) == 0
        assert capsys.readouterr().out == text

    def test_stdout_export_is_valid_json(self, capsys):
        events.enable()
        with span("cli.stdout"):
            pass
        assert main(["trace"]) == 0
        validate_chrome_trace(json.loads(capsys.readouterr().out))


def fetch(url, timeout=120):
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


class TestProfileEndpoint:
    def test_profile_writes_a_chrome_trace(self):
        """/profile on the CPU: torch.profiler over the capture window, a
        Chrome trace that holds the operations a thread ran meanwhile."""
        import torch

        srv = tserver.start_metrics_server(0)
        stop = threading.Event()

        def work():
            a = torch.ones(128, 128)
            while not stop.is_set():
                a @ a

        t = threading.Thread(target=work, daemon=True)
        t.start()
        try:
            status, body = fetch(srv.url + "/profile?seconds=0.3")
        finally:
            stop.set()
            t.join()
        assert status == 200 and body["seconds"] == 0.3
        assert body["trace"] == os.path.join(body["artifact"], "torch-profile.trace.json")
        trace = json.load(open(body["trace"]))
        assert any("mm" in e.get("name", "") for e in trace["traceEvents"])

    def test_profile_rejects_bad_seconds(self):
        srv = tserver.start_metrics_server(0)
        for q in ("seconds=abc", "seconds=0", "seconds=9999"):
            status, body = fetch(f"{srv.url}/profile?{q}", timeout=30)
            assert status == 400 and "seconds" in body["error"]

    def test_profile_rejects_concurrent_capture(self):
        """While one capture holds _PROFILE_LOCK, a second /profile
        answers 409 instead of queueing behind it.  The test holds the
        lock itself, as the reference's does: a real capture on a thread
        raced a fixed wait for the lock (the 200 capture is
        test_profile_writes_a_chrome_trace's)."""
        srv = tserver.start_metrics_server(0)
        assert tserver._PROFILE_LOCK.acquire(blocking=False)
        try:
            status, body = fetch(srv.url + "/profile?seconds=0.2", timeout=30)
            assert status == 409 and "already running" in body["error"]
        finally:
            tserver._PROFILE_LOCK.release()
            tserver.stop_metrics_server()
        # the refusal released nothing it did not take
        assert tserver._PROFILE_LOCK.acquire(blocking=False)
        tserver._PROFILE_LOCK.release()
