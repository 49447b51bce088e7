"""The worker wire model and the in-pod batch prober (reference:
pkg/worker): the verdict service's Delta, FlowQuery, Verdict and the
Batch envelope (copies of the reference package's worker/model.py and
worker/wireregistry.py), and the batch prober that avoids an apiserver
exec storm by issuing ONE kubectl-exec per source pod carrying a JSON
batch of probe requests; the in-pod worker fans out with a thread pool
and returns JSON results on stdout."""

from .model import Batch, Request, Result
from .client import Client
from .worker import run_worker, issue_batch

__all__ = ["Batch", "Request", "Result", "Client", "run_worker", "issue_batch"]
