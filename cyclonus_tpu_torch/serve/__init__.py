"""The long-running verdict service on the port's engine (the
reference's cyclonus_tpu.serve).

`VerdictService` holds authoritative cluster state and a delta queue,
`IncrementalEngine` patches the live engine's host tensors and device
views row- and slab-wise (falling back to a full rebuild past the churn
threshold or the patch byte budget), and `loop.run_stdio` speaks the
wire protocol's Batch envelope with its Deltas/Queries extensions
(worker/model.py).  The differential gate — incremental engine vs fresh
rebuild vs scalar oracle — is `VerdictService.verify_parity`.
"""

from . import stateregistry
from .incremental import IncrementalEngine, Ineligible
from .loop import run_stdio
from .service import AdmissionRejected, VerdictService

__all__ = [
    "AdmissionRejected",
    "IncrementalEngine",
    "Ineligible",
    "VerdictService",
    "run_stdio",
    "stateregistry",
]
