"""Job runners (reference: probe/jobrunner.go).

The simulated runner's default engine, "cuda", compiles the (policy,
resources) pair once into a TorchPolicyEngine, evaluates the whole
verdict grid on the device, and scatters every job's verdict out of the
grid; "cuda-sharded" evaluates the grid over the engine's default
pod-axis mesh instead (evaluate_grid_sharded, the reference's
tpu-sharded).  engine="oracle" keeps the scalar per-job evaluation, the
reference behaviour (jobrunner.go:68-94).

Kube runners stay host-side concurrency (they are I/O-bound cluster exec
calls): a thread pool replaces the reference's 15-goroutine pool, and
the batch runner sends one in-pod worker batch per source pod from a
pool of 9.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

import numpy as np

from ..carry import resolve_device
from ..engine import PortCase, TorchPolicyEngine
from ..kube.ikubernetes import IKubernetes, KubeError
from ..matcher.core import Policy
from .connectivity import (
    CONNECTIVITY_ALLOWED,
    CONNECTIVITY_BLOCKED,
    CONNECTIVITY_CHECK_FAILED,
    CONNECTIVITY_INVALID_NAMED_PORT,
    CONNECTIVITY_INVALID_PORT_PROTOCOL,
    CONNECTIVITY_UNKNOWN,
)
from .job import Job, JobResult, Jobs
from .probeconfig import ProbeConfig
from .resources import Resources
from .table import Table

DEFAULT_ENGINE = "cuda"
# the CLI --engine vocabulary (cuda-sharded = cuda over the pod-axis mesh)
ENGINE_CHOICES = ["oracle", "cuda", "cuda-sharded"]

# grid bit -> verdict
_VERDICT = (CONNECTIVITY_BLOCKED, CONNECTIVITY_ALLOWED)


class JobRunner:
    def run_jobs(self, jobs: List[Job]) -> List[JobResult]:
        raise NotImplementedError

    def run_jobs_with_resources(
        self, jobs: List[Job], resources: Optional[Resources]
    ) -> List[JobResult]:
        """Runners that can use whole-cluster context (the grid path)
        override this; the default ignores resources."""
        return self.run_jobs(jobs)


class Runner:
    """jobrunner.go:13-58.  `seconds` holds the split of the last probe:
    "jobs" (the job fan-out), "run" (the job runner) and "table"."""

    def __init__(self, job_runner: JobRunner):
        self.job_runner = job_runner
        self.seconds: Dict[str, float] = {}

    def run_probe_for_config(
        self, probe_config: ProbeConfig, resources: Resources
    ) -> Table:
        t0 = time.perf_counter()
        jobs = resources.get_jobs_for_probe_config(probe_config)
        t1 = time.perf_counter()
        results = self._run_probe(jobs, resources)
        t2 = time.perf_counter()
        table = Table.from_job_results(resources, results)
        self.seconds = {"jobs": t1 - t0, "run": t2 - t1, "table": time.perf_counter() - t2}
        return table

    def _run_probe(self, jobs: Jobs, resources: Resources) -> List[JobResult]:
        results = self.job_runner.run_jobs_with_resources(jobs.valid, resources)

        # invalid buckets (jobrunner.go:36-57)
        for j in jobs.bad_port_protocol:
            results.append(
                JobResult(
                    job=j,
                    ingress=CONNECTIVITY_INVALID_PORT_PROTOCOL,
                    egress=CONNECTIVITY_UNKNOWN,
                    combined=CONNECTIVITY_INVALID_PORT_PROTOCOL,
                )
            )
        for j in jobs.bad_named_port:
            results.append(
                JobResult(
                    job=j,
                    ingress=CONNECTIVITY_INVALID_NAMED_PORT,
                    egress=CONNECTIVITY_UNKNOWN,
                    combined=CONNECTIVITY_INVALID_NAMED_PORT,
                )
            )
        return results


class SimulatedJobRunner(JobRunner):
    """engine="oracle": per-job scalar evaluation (reference behaviour).
    engine="cuda": one TorchPolicyEngine per probe on `device` (None =
    the current CUDA device, which raises when there is none; "cpu" runs
    the engine on the CPU); "cuda-sharded" the same engine with the grid
    evaluated over its default mesh (sharded.default_mesh).  A missing card or a failing engine raises:
    nothing demotes to the oracle.

    `seconds` holds the split of the last grid probe: "build" (the
    engine's compile), "grid" (evaluate_grid and the grids' copy to the
    host, which waits for the device) and "scatter" (the jobs' verdicts
    out of the grids)."""

    def __init__(self, policies: Policy, engine: str = DEFAULT_ENGINE, device=None):
        if engine not in ENGINE_CHOICES:
            raise ValueError(f"invalid simulated engine {engine!r}")
        self.policies = policies
        self.engine = engine
        self.device = resolve_device(device) if engine != "oracle" else None
        self.seconds: Dict[str, float] = {}

    # --- oracle path (jobrunner.go:68-94) ---

    def run_jobs(self, jobs: List[Job]) -> List[JobResult]:
        return [self.run_job(j) for j in jobs]

    def run_job(self, job: Job) -> JobResult:
        allowed = self.policies.is_traffic_allowed(job.traffic())
        return JobResult(
            job=job,
            ingress=_VERDICT[allowed.ingress.is_allowed],
            egress=_VERDICT[allowed.egress.is_allowed],
            combined=_VERDICT[allowed.is_allowed],
        )

    # --- grid path ---

    def run_jobs_with_resources(
        self, jobs: List[Job], resources: Optional[Resources]
    ) -> List[JobResult]:
        if self.engine == "oracle" or resources is None or not jobs:
            return self.run_jobs(jobs)
        t0 = time.perf_counter()
        pods = [(p.namespace, p.name, p.labels, p.ip) for p in resources.pods]
        # the reference's case list: first-seen order over the jobs
        cases: List[PortCase] = []
        case_index: Dict[tuple, int] = {}
        q = np.empty(len(jobs), dtype=np.int64)
        for i, job in enumerate(jobs):
            key = (job.resolved_port, job.resolved_port_name, job.protocol)
            qi = case_index.get(key)
            if qi is None:
                qi = case_index[key] = len(cases)
                cases.append(PortCase(*key))
            q[i] = qi
        engine = TorchPolicyEngine(
            self.policies, pods, resources.namespaces, device=self.device
        )
        t1 = time.perf_counter()
        if self.engine == "cuda-sharded":
            grid = engine.evaluate_grid_sharded(cases)
        else:
            grid = engine.evaluate_grid(cases)
        # one copy of each grid to the host: never a device read per job
        ingress, egress, combined = grid.ingress, grid.egress, grid.combined
        t2 = time.perf_counter()
        pod_index = engine.pod_index()
        s = np.fromiter((pod_index[j.from_key] for j in jobs), np.int64, len(jobs))
        d = np.fromiter((pod_index[j.to_key] for j in jobs), np.int64, len(jobs))
        results = [
            JobResult(job=job, ingress=_VERDICT[i], egress=_VERDICT[e], combined=_VERDICT[c])
            for job, i, e, c in zip(
                jobs,
                ingress[q, d, s].tolist(),
                egress[q, s, d].tolist(),
                combined[q, s, d].tolist(),
            )
        ]
        self.seconds = {
            "build": t1 - t0,
            "grid": t2 - t1,
            "scatter": time.perf_counter() - t2,
        }
        return results


class KubeJobRunner(JobRunner):
    """Thread-pool exec of agnhost connect in every source pod
    (jobrunner.go:96-147)."""

    def __init__(self, kubernetes: IKubernetes, workers: int = 15):
        self.kubernetes = kubernetes
        self.workers = workers

    def run_jobs(self, jobs: List[Job]) -> List[JobResult]:
        if not jobs:
            return []
        with ThreadPoolExecutor(max_workers=self.workers) as pool:
            return list(pool.map(self._run_one, jobs))

    def _run_one(self, job: Job) -> JobResult:
        connectivity = self._probe_connectivity(job)
        return JobResult(job=job, combined=connectivity)

    def _probe_connectivity(self, job: Job) -> str:
        """jobrunner.go:134-147: setup failure => checkfailed; command
        failure => blocked; success => allowed."""
        try:
            _stdout, _stderr, command_err = self.kubernetes.execute_remote_command(
                job.from_namespace, job.from_pod, job.from_container, job.client_command()
            )
        except KubeError:
            return CONNECTIVITY_CHECK_FAILED
        if command_err is not None:
            return CONNECTIVITY_BLOCKED
        return CONNECTIVITY_ALLOWED


class KubeBatchJobRunner(JobRunner):
    """One in-pod worker batch per source pod (jobrunner.go:149-227)."""

    def __init__(self, kubernetes: IKubernetes, workers: int = 9):
        from ..worker.client import Client

        self.client = Client(kubernetes)
        self.workers = workers

    def run_jobs(self, jobs: List[Job]) -> List[JobResult]:
        from ..worker.model import Batch, Request

        job_map: Dict[str, Job] = {}
        batches: Dict[str, Batch] = {}
        for job in jobs:
            if job.from_key not in batches:
                batches[job.from_key] = Batch(
                    namespace=job.from_namespace,
                    pod=job.from_pod,
                    container=job.from_container,
                )
            batches[job.from_key].requests.append(
                Request(
                    key=job.key(),
                    protocol=job.protocol,
                    host=job.to_host,
                    port=job.resolved_port,
                )
            )
            job_map[job.key()] = job

        results: List[JobResult] = []
        if not batches:
            return results
        with ThreadPoolExecutor(max_workers=self.workers) as pool:
            for batch_results in pool.map(self._run_batch, batches.values()):
                for key, connectivity in batch_results:
                    results.append(JobResult(job=job_map[key], combined=connectivity))
        return results

    def _run_batch(self, batch):
        try:
            results = self.client.batch(batch)
        except KubeError:
            return [(r.key, CONNECTIVITY_CHECK_FAILED) for r in batch.requests]
        return [
            (
                r.request.key,
                CONNECTIVITY_ALLOWED if r.is_success() else CONNECTIVITY_BLOCKED,
            )
            for r in results
        ]


def new_simulated_runner(
    policies: Policy, engine: str = DEFAULT_ENGINE, device=None
) -> Runner:
    return Runner(SimulatedJobRunner(policies, engine=engine, device=device))


def new_kube_runner(kubernetes: IKubernetes, workers: int = 15) -> Runner:
    return Runner(KubeJobRunner(kubernetes, workers))


def new_kube_batch_runner(kubernetes: IKubernetes, workers: int = 9) -> Runner:
    return Runner(KubeBatchJobRunner(kubernetes, workers))
