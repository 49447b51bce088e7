"""Driver-side worker client (reference: worker/client.go): marshal a
batch, kubectl-exec the in-pod worker, parse its stdout.  A copy of the
reference package's worker/client.py without its chaos points and its
retry counter.

Wire robustness: each batch issue is BOUNDED (CYCLONUS_WORKER_TIMEOUT_S;
a worker pod that dies mid-exec must cost a timeout, never a wedged
driver thread) and RETRIED with the full-jitter backoff of
utils/retry.py, CYCLONUS_WORKER_RETRIES extra attempts
(CYCLONUS_WORKER_BACKOFF_S the base pause).  Probes are idempotent
connection attempts, so a re-issued batch re-measures, it never
double-commits.  The final failure raises KubeError carrying the last
error.
"""

from __future__ import annotations

import json
import os
import random
import time
from typing import List

from ..kube.ikubernetes import IKubernetes, KubeError
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
    pool, so the client holds no mutable state of its own."""

    def __init__(self, kubernetes: IKubernetes):
        self.kubernetes = kubernetes

    def _issue_once(self, batch: Batch) -> List[Result]:
        """client.go:14-41: one exec + parse attempt."""
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
        envelope."""
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
                    return value
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
                    return self._issue_once(batch)
                except Exception as e:
                    last_error = e
            if attempt < attempts:
                time.sleep(full_jitter_pause(_backoff_s(), attempt, rng))
        raise KubeError(
            f"worker batch failed after {attempts} attempt(s): "
            f"{type(last_error).__name__}: {last_error}"
        )
