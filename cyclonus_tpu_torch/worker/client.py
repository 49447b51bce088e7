"""Driver-side worker client (reference: worker/client.go): marshal a
batch, kubectl-exec the in-pod worker, parse its stdout (a copy of the
reference package's worker/client.py).

Wire robustness: each batch issue is BOUNDED (CYCLONUS_WORKER_TIMEOUT_S;
a worker pod that dies mid-exec must cost a timeout, never a wedged
driver thread) and RETRIED with the full-jitter backoff of
utils/retry.py, CYCLONUS_WORKER_RETRIES extra attempts
(CYCLONUS_WORKER_BACKOFF_S the base pause).  Probes are idempotent
connection attempts, so a re-issued batch re-measures, it never
double-commits.  Every retry counts into
cyclonus_tpu_worker_retries_total; the final failure raises KubeError
carrying the last error.  The chaos layer's `worker_wire` /
`worker_wire_stall` points inject exactly these fault classes.
"""

from __future__ import annotations

import json
import os
import random
import time
from typing import List

from .. import chaos
from ..kube.ikubernetes import IKubernetes, KubeError
from ..telemetry import instruments as ti
from ..utils import contracts
from ..utils.bounded import run_bounded
from ..utils.retry import full_jitter_pause
from .model import Batch, Result


def _timeout_s() -> float:
    """Per-batch wall-clock bound; <= 0 disables the bound (the exec
    call then blocks as long as kubectl does)."""
    try:
        return float(os.environ.get("CYCLONUS_WORKER_TIMEOUT_S", "120"))
    except ValueError:
        return 120.0


def _retries() -> int:
    try:
        return max(0, int(os.environ.get("CYCLONUS_WORKER_RETRIES", "2")))
    except ValueError:
        return 2


def _backoff_s() -> float:
    try:
        return float(os.environ.get("CYCLONUS_WORKER_BACKOFF_S", "0.5"))
    except ValueError:
        return 0.5


class Client:
    """Stateless per call: probe runners issue batches from a thread
    pool, so the client holds no mutable state of its own — the only
    shared structure the batch path touches is the trace-event ring,
    whose BoundedRing lock (and pid-dedup in events.ingest) makes
    concurrent ingestion safe."""

    def __init__(self, kubernetes: IKubernetes):
        self.kubernetes = kubernetes

    def _issue_once(self, batch: Batch) -> List[Result]:
        """client.go:14-41: one exec + parse attempt."""
        chaos.fire("worker_wire")
        chaos.stall("worker_wire_stall")
        command = ["/worker", "--jobs", batch.to_json()]
        stdout, _stderr, command_err = self.kubernetes.execute_remote_command(
            batch.namespace, batch.pod, batch.container, command
        )
        if command_err is not None:
            raise KubeError(f"worker exec failed: {command_err}")
        try:
            parsed = json.loads(stdout) if stdout.strip() else []
        except json.JSONDecodeError as e:
            raise KubeError(f"unable to parse worker output: {e}")
        # reader-side wire validation (CYCLONUS_SHAPE_CHECK=1): a
        # malformed peer reply is rejected here with the offending key
        # named, instead of surfacing as a KeyError deep in from_dict
        if contracts.CHECK:
            if not isinstance(parsed, list):
                raise contracts.ContractViolation(
                    "worker reply: expected a JSON array of Result "
                    f"objects, got {type(parsed).__name__}"
                )
            for d in parsed:  # wire-read: Result
                contracts.check_wire_read("Result", d, Result.WIRE)
        return [Result.from_dict(d) for d in parsed]

    def batch(self, batch: Batch) -> List[Result]:
        """Issue one batch with the timeout + jittered-backoff retry
        envelope; trace events ingest from the SUCCESSFUL attempt only
        (a half-dead attempt's events would duplicate the retry's)."""
        timeout = _timeout_s()
        attempts = _retries() + 1
        rng = random.Random()  # jitter must differ across drivers
        last_error: Exception = KubeError("worker batch never attempted")
        for attempt in range(1, attempts + 1):
            if timeout > 0:
                status, value = run_bounded(
                    lambda: self._issue_once(batch), timeout
                )
                if status == "ok":
                    results = value
                    break
                last_error = (
                    value
                    if status == "error"
                    else KubeError(
                        f"worker batch timed out after {timeout:g}s "
                        "(CYCLONUS_WORKER_TIMEOUT_S)"
                    )
                )
            else:
                try:
                    results = self._issue_once(batch)
                    break
                except Exception as e:
                    last_error = e
            if attempt < attempts:
                ti.WORKER_RETRIES.inc()
                time.sleep(full_jitter_pause(_backoff_s(), attempt, rng))
        else:
            raise KubeError(
                f"worker batch failed after {attempts} attempt(s): "
                f"{type(last_error).__name__}: {last_error}"
            )
        if batch.trace_id:
            # merge the worker's recorded events into the driver's
            # timeline (in-process workers are deduped by pid in ingest)
            from ..telemetry import events

            for r in results:
                if r.trace_events:
                    events.ingest(r.trace_events)
        return results
