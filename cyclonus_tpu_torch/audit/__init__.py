"""Verdict audit plane: runtime correctness observability for the
verdict service (a copy of the reference's cyclonus_tpu.audit).

Three pieces, one package:

  * sampler.AuditController — continuous shadow-oracle sampling of
    answered flow queries against the scalar TieredPolicy oracle on a
    consistent per-epoch state snapshot, off the hot path.
  * digest — canonical, order-independent epoch state digests: the
    string equality replica-vs-replica and restart-adoption comparisons
    reduce to.
  * divergence black box — mismatches dump `audit-divergence` repro
    bundles through the flight recorder and burn the
    ``verdict_integrity`` SLO objective (breach-dump posture, never
    query-blocking).

Armed by CYCLONUS_AUDIT (default off: the serving path keeps exactly
one `is None` check).
"""

from .digest import canonical_state, epoch_digest, sampled_rows, state_digest
from .sampler import AuditController

__all__ = [
    "AuditController",
    "canonical_state",
    "epoch_digest",
    "sampled_rows",
    "state_digest",
]
