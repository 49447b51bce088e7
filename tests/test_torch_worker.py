"""The port's in-pod batch worker (cyclonus_tpu_torch/worker: worker.py,
client.py, __main__.py) against the reference's (cyclonus_tpu/worker),
on the CPU: the same batch gives the same results apart from the
measured latency_ms, the same stub cluster gives the same results or the
same exception text, and the entry point prints the same JSON.  The
worker and the loopback pod server start without torch, jax or the
reference package: the loopback cluster spawns them once per pod and
once per source pod and step."""

import json
import subprocess
import sys

import pytest

import cyclonus_tpu.worker.client as ref_client
import cyclonus_tpu.worker.model as ref_model
import cyclonus_tpu.worker.worker as ref_worker
import cyclonus_tpu_torch.worker.client as port_client
import cyclonus_tpu_torch.worker.model as port_model
import cyclonus_tpu_torch.worker.worker as port_worker
from cyclonus_tpu.kube.ikubernetes import KubeError as RefKubeError
from cyclonus_tpu_torch.kube.ikubernetes import KubeError

from test_torch_engine import REPO

PAIRS = [(ref_worker, ref_model, ref_client, RefKubeError),
         (port_worker, port_model, port_client, KubeError)]


def make_batch(model, n=3, protocols=("tcp", "udp", "sctp")):
    return model.Batch(
        namespace="x",
        pod="a",
        container="cont-80-tcp",
        requests=[
            model.Request(key=f"k{i}", protocol=protocols[i % len(protocols)],
                          host=f"192.168.1.{i}", port=80 + i)
            for i in range(n)
        ],
    )


class _FakeProc:
    def __init__(self, returncode=0, stdout="CONNECTED", stderr=""):
        self.returncode = returncode
        self.stdout = stdout
        self.stderr = stderr


def _ok(*a, **k):
    return _FakeProc()


def _refused(*a, **k):
    return _FakeProc(returncode=1, stdout="partial", stderr="REFUSED\n")


def _no_stderr(*a, **k):
    return _FakeProc(returncode=3, stdout="", stderr="")


def _timeout(*a, **k):
    raise subprocess.TimeoutExpired(cmd=a[0], timeout=5)


def _missing(*a, **k):
    raise FileNotFoundError(2, "No such file or directory", "/agnhost")


def _flaky():
    """Fails the first attempt of each request, answers the retry."""
    seen = set()

    def run(command, **k):
        if command[2] in seen:
            return _FakeProc()
        seen.add(command[2])
        return _FakeProc(returncode=1, stderr="first try")

    return run


def without_latency(out):
    rows = json.loads(out)
    for r in rows:
        assert r.pop("LatencyMs") >= 0
    return rows


class TestRunWorker:
    @pytest.mark.parametrize(
        "run", [_ok, _refused, _no_stderr, _timeout, _missing, "flaky"],
        ids=["ok", "refused", "no-stderr", "timeout", "missing-binary", "flaky"],
    )
    def test_output_equals_reference(self, run, monkeypatch):
        """run_worker's JSON under a faked subprocess.run, the reference's
        and the port's, equal apart from latency_ms; every request's
        command is the reference's agnhost invocation."""
        outs, commands = [], []
        for worker, model, _, _ in PAIRS:
            seen = []
            fake = _flaky() if run == "flaky" else run

            def recording(command, fake=fake, seen=seen, **k):
                seen.append((tuple(command), k.get("timeout")))
                return fake(command, **k)

            monkeypatch.setattr(worker.subprocess, "run", recording)
            outs.append(without_latency(worker.run_worker(make_batch(model).to_json())))
            commands.append(sorted(seen))
        assert outs[0] == outs[1]
        assert commands[0] == commands[1]
        assert len(outs[1]) == 3

    def test_empty_batch(self):
        for worker, model, _, _ in PAIRS:
            assert worker.run_worker(make_batch(model, 0).to_json()) == "[]"

    def test_constants_equal_reference(self):
        assert port_worker.RETRIES == ref_worker.RETRIES == 1
        assert port_worker.DEFAULT_CONCURRENCY == ref_worker.DEFAULT_CONCURRENCY == 10


class _StubKube:
    """IKubernetes stub: a canned exec result, or a call that blocks
    past the client's bound."""

    def __init__(self, stdout="", stderr="", err=None, raises=None, sleep_s=0.0):
        self._ret = (stdout, stderr, err)
        self._raises = raises
        self._sleep_s = sleep_s
        self.calls = []

    def execute_remote_command(self, namespace, pod, container, command):
        self.calls.append((namespace, pod, container, command))
        if self._sleep_s:
            import time

            time.sleep(self._sleep_s)
        if self._raises is not None:
            raise self._raises
        return self._ret


def results_json(model, batch, error=""):
    return json.dumps([
        model.Result(request=r, output="connected" if not error else "", error=error,
                     latency_ms=1.5).to_dict()
        for r in batch.requests
    ])


CLIENT_CASES = {
    "success": lambda m, ke, b: dict(stdout=results_json(m, b)),
    "blocked-results": lambda m, ke, b: dict(stdout=results_json(m, b, error="timeout")),
    "empty-stdout": lambda m, ke, b: dict(stdout="  \n"),
    "exec-error": lambda m, ke, b: dict(err="command terminated with exit code 1"),
    "exec-raises": lambda m, ke, b: dict(raises=ke("pod x/a not found")),
    "bad-json": lambda m, ke, b: dict(stdout="not-json{"),
    "timeout": lambda m, ke, b: dict(stdout="[]", sleep_s=0.5),
}


class TestClient:
    @pytest.mark.parametrize("case", sorted(CLIENT_CASES))
    def test_batch_equals_reference(self, case, monkeypatch):
        """Client.batch against a stub cluster: the same results, or the
        same exception type and text, after the same number of exec
        attempts, each the same /worker command."""
        monkeypatch.setenv("CYCLONUS_WORKER_BACKOFF_S", "0")
        monkeypatch.setenv("CYCLONUS_WORKER_RETRIES", "2")
        monkeypatch.setenv("CYCLONUS_WORKER_TIMEOUT_S", "0.1" if case == "timeout" else "120")
        got = []
        for _, model, client, kube_error in PAIRS:
            batch = make_batch(model)
            kube = _StubKube(**CLIENT_CASES[case](model, kube_error, batch))
            try:
                out = [r.to_dict() for r in client.Client(kube).batch(batch)]
            except Exception as e:
                out = (type(e).__name__, str(e))
            got.append((out, kube.calls))
        assert got[0] == got[1]
        out, calls = got[1]
        (_, _, _, command) = calls[0]
        assert command[:2] == ["/worker", "--jobs"]
        assert port_model.Batch.from_json(command[2]) == make_batch(port_model)
        failing = case in ("exec-error", "exec-raises", "bad-json", "timeout")
        assert len(calls) == (3 if failing else 1)
        if failing:
            assert out[0] == "KubeError" and "after 3 attempt(s)" in out[1]

    @pytest.mark.parametrize("timeout_s", ["120", "0"], ids=["bounded", "unbounded"])
    def test_retry_then_success(self, timeout_s, monkeypatch):
        """A failing first attempt is retried (bounded and unbounded
        paths alike) and the second attempt's results come back."""
        monkeypatch.setenv("CYCLONUS_WORKER_BACKOFF_S", "0")
        monkeypatch.setenv("CYCLONUS_WORKER_TIMEOUT_S", timeout_s)
        got = []
        for _, model, client, _ in PAIRS:
            batch = make_batch(model)
            answers = [("", "", "transient"), (results_json(model, batch), "", None)]
            kube = _StubKube()
            kube.execute_remote_command = lambda *a, answers=answers: answers.pop(0)
            got.append([r.to_dict() for r in client.Client(kube).batch(batch)])
        assert got[0] == got[1] and len(got[1]) == 3

    def test_wire_read_contract(self, monkeypatch):
        """Under CYCLONUS_SHAPE_CHECK a malformed reply is rejected with
        the same contract violation on both packages."""
        import cyclonus_tpu.utils.contracts as ref_contracts
        import cyclonus_tpu_torch.utils.contracts as port_contracts

        monkeypatch.setenv("CYCLONUS_WORKER_BACKOFF_S", "0")
        monkeypatch.setenv("CYCLONUS_WORKER_RETRIES", "0")
        got = []
        for (_, model, client, _), contracts in zip(PAIRS, (ref_contracts, port_contracts)):
            monkeypatch.setattr(contracts, "CHECK", True)
            for stdout in ('{"Request": {}}', '[{"Request": {"Key": 1}, "Output": "", "Error": ""}]'):
                kube = _StubKube(stdout=stdout)
                with pytest.raises(Exception) as e:
                    client.Client(kube).batch(make_batch(model))
                got.append(str(e.value))
        assert got[:2] == got[2:]
        assert "expected a JSON array" in got[2] and "Request" in got[3]


def run_module(module, *args, code=None):
    argv = [sys.executable, "-c", code] if code else [sys.executable, "-m", module, *args]
    return subprocess.run(argv, cwd=REPO, capture_output=True, text=True, timeout=120)


class TestEntryPoint:
    def test_empty_batch_prints_empty_list(self):
        jobs = '{"Namespace":"x","Pod":"a","Container":"c","Requests":[]}'
        outs = [run_module(m, "--jobs", jobs) for m in ("cyclonus_tpu.worker", "cyclonus_tpu_torch.worker")]
        for proc in outs:
            assert proc.returncode == 0, proc.stderr
        assert outs[1].stdout == outs[0].stdout
        assert json.loads(outs[1].stdout) == []

    def test_jobs_is_required(self):
        proc = run_module("cyclonus_tpu_torch.worker")
        assert proc.returncode == 2 and "--jobs" in proc.stderr

    @pytest.mark.parametrize(
        "module", ["cyclonus_tpu_torch.worker.__main__", "cyclonus_tpu_torch.kube.loopback_server"]
    )
    def test_subprocess_modules_load_without_torch(self, module):
        """What the loopback cluster spawns (the worker in its native
        mode, and the pod server) loads neither torch nor jax nor the
        reference package."""
        code = (
            "import importlib, os, sys\n"
            "os.environ['CYCLONUS_CONNECT_NATIVE'] = '1'\n"
            f"importlib.import_module({module!r})\n"
            "import cyclonus_tpu_torch.worker.worker as w\n"
            "from cyclonus_tpu_torch.kube import loopback\n"
            "from cyclonus_tpu_torch.worker.model import Request\n"
            "w._probe_with_retries(Request(key='k', protocol='tcp', host='127.0.0.1', port=9))\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('torch', 'jax', 'cyclonus_tpu')]\n"
            "assert not bad, bad\n"
            "print('clean')\n"
        )
        proc = run_module(None, code=code)
        assert proc.returncode == 0, proc.stderr
        assert proc.stdout.strip() == "clean"
