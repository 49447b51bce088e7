"""Precedence tiers: AdminNetworkPolicy / BaselineAdminNetworkPolicy
over networkingv1 NetworkPolicy.

Layout:
  model.py  - ANP/BANP object model + the TierSet resolution order
  fuzz.py   - the seeded scenario generator (tiered test fixtures)

The scalar lattice oracle lives in matcher/tiered.py (next to the
networkingv1 oracle it extends); the slab encoding in
engine/encoding.py (TierDirectionEncoding); the first-match-by-priority
resolution in engine/kernel.py (truth tables) and in the packed counts
kernel's tiered epilogue (engine/packed_kernel.py, csrc/packed_counts.cu).

fuzz is imported lazily: the model stays importable without the engine.
"""

from .model import (
    ACTION_ALLOW,
    ACTION_DENY,
    ACTION_PASS,
    AdminNetworkPolicy,
    BaselineAdminNetworkPolicy,
    TierPort,
    TierRule,
    TierScope,
    TierSet,
    parse_tier_object,
)

__all__ = [
    "ACTION_ALLOW",
    "ACTION_DENY",
    "ACTION_PASS",
    "AdminNetworkPolicy",
    "BaselineAdminNetworkPolicy",
    "TierPort",
    "TierRule",
    "TierScope",
    "TierSet",
    "parse_tier_object",
]
