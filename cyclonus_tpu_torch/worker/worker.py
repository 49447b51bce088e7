"""The in-pod worker side (reference: worker/worker.go): parse a JSON
batch, issue the probes concurrently, print JSON results.  A copy of the
reference package's worker/worker.py without its span and trace-event
plumbing and its probe-latency histogram."""

from __future__ import annotations

import json
import os
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from typing import List

from .model import Batch, Request, Result

DEFAULT_CONCURRENCY = 10
RETRIES = 1


def _issue_one(request: Request) -> Result:
    """Issue one probe (with retries), stamping per-probe wall-clock into
    Result.latency_ms."""
    t0 = time.perf_counter()
    result = _probe_with_retries(request)
    result.latency_ms = round((time.perf_counter() - t0) * 1000.0, 3)
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
    """worker.go:38-58."""
    if not batch.requests:
        return []
    with ThreadPoolExecutor(max_workers=concurrency) as pool:
        return list(pool.map(_issue_one, batch.requests))


def run_worker(jobs_json: str) -> str:
    """worker.go:18-36: JSON in, JSON out."""
    batch = Batch.from_json(jobs_json)
    return json.dumps([r.to_dict() for r in issue_batch(batch)])
