"""The in-pod worker side (reference: worker/worker.go): parse a JSON
batch, issue the probes concurrently, print JSON results.  A copy of the
reference package's worker/worker.py."""

from __future__ import annotations

import json
import os
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from typing import List

from ..telemetry import events, instruments as ti
from ..telemetry.spans import adopt, current_path, span
from .model import Batch, Request, Result

DEFAULT_CONCURRENCY = 10
RETRIES = 1


def _issue_one(request: Request) -> Result:
    """Issue one probe (with retries), stamping per-probe wall-clock into
    Result.latency_ms — the real-probe latency histogram's data source —
    and the worker-side telemetry histogram."""
    t0 = time.perf_counter()
    result = _probe_with_retries(request)
    dt = time.perf_counter() - t0
    result.latency_ms = round(dt * 1000.0, 3)
    ti.PROBE_LATENCY.observe(
        dt,
        source="worker",
        outcome="ok" if result.is_success() else "error",
    )
    return result


def _probe_with_retries(request: Request) -> Result:
    """worker.go:60-84 with one retry (worker.go:62-68).

    CYCLONUS_CONNECT_NATIVE=1 probes with python sockets instead of
    shelling to /agnhost — the loopback cluster's mode (kube/loopback.py),
    where the worker runs as a real subprocess on a machine without the
    agnhost binary and binds CYCLONUS_SOURCE_IP so the destination pod
    server sees the probing pod's address."""
    if os.environ.get("CYCLONUS_CONNECT_NATIVE") == "1":
        from ..kube.loopback import native_probe

        last_err = ""
        for _attempt in range(1 + RETRIES):
            err = native_probe(
                request.host,
                request.port,
                request.protocol,
                source_ip=os.environ.get("CYCLONUS_SOURCE_IP") or None,
            )
            if err is None:
                return Result(request=request, output="connected")
            last_err = err
        return Result(request=request, output="", error=last_err)
    command = request.command()
    last_err = ""
    out = ""
    for _attempt in range(1 + RETRIES):
        try:
            proc = subprocess.run(
                command, capture_output=True, text=True, timeout=5
            )
            out = proc.stdout
            if proc.returncode == 0:
                return Result(request=request, output=out)
            last_err = proc.stderr.strip() or f"exit code {proc.returncode}"
        except FileNotFoundError as e:
            last_err = str(e)
        except subprocess.TimeoutExpired:
            last_err = "timeout"
    return Result(request=request, output=out, error=last_err)


def issue_batch(batch: Batch, concurrency: int = DEFAULT_CONCURRENCY) -> List[Result]:
    """worker.go:38-58.

    With trace context on the batch (model.py Batch.trace_id), the
    worker joins the driver's trace: a worker.batch span adopted under
    the driver's span path, one worker.probe span per request (the pool
    threads re-adopt the batch path — pool.map drops thread-locals)."""
    if not batch.requests:
        return []
    if batch.trace_id and not (
        events.enabled() and events.trace_id() == batch.trace_id
    ):
        # a REAL worker process joins the driver's trace as itself; an
        # IN-PROCESS worker (tests, --mock) is already recording on this
        # trace and must not flip the process-global role to "worker" —
        # that would mislabel every later driver-side event
        events.enable(batch.trace_id, role="worker")
    if not events.enabled():
        with ThreadPoolExecutor(max_workers=concurrency) as pool:
            return list(pool.map(_issue_one, batch.requests))
    # span-recording path: driver-supplied context (batch.trace_id), or
    # a locally enabled trace (worker --trace-out standalone debugging)
    with adopt(batch.parent_span):
        with span("worker.batch", pod=batch.key(), requests=len(batch.requests)):
            batch_path = current_path()

            def traced(request: Request) -> Result:
                with adopt(batch_path):
                    with span(
                        "worker.probe",
                        key=request.key,
                        host=request.host,
                        port=request.port,
                        protocol=request.protocol,
                    ):
                        return _issue_one(request)

            with ThreadPoolExecutor(max_workers=concurrency) as pool:
                return list(pool.map(traced, batch.requests))


def _attach_trace_events(
    batch: Batch, results: List[Result], evts: List[dict]
) -> None:
    """Distribute the worker's recorded events onto the Results for the
    trip back to the driver (model.py Result.trace_events, optional on
    the wire): each probe span rides its own request's Result (matched
    by the span's key attr); batch-level spans ride the first Result."""
    evts = [e for e in evts if e.get("trace_id") == batch.trace_id]
    if not evts or not results:
        return
    by_key: dict = {}
    batch_level: List[dict] = []
    for e in evts:
        key = (e.get("args") or {}).get("key")
        (by_key.setdefault(key, []) if key else batch_level).append(e)
    for r in results:
        r.trace_events = by_key.get(r.request.key) or None
    if batch_level:
        results[0].trace_events = batch_level + (results[0].trace_events or [])


def run_worker(jobs_json: str) -> str:
    """worker.go:18-36: JSON in, JSON out."""
    batch = Batch.from_json(jobs_json)
    marker = events.mark()
    results = issue_batch(batch)
    if batch.trace_id:
        _attach_trace_events(batch, results, events.since(marker))
    return json.dumps([r.to_dict() for r in results])
