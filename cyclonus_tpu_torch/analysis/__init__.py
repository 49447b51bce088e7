"""Static analysis of COMPILED policy sets on the dense tensor encoding
(a copy of the reference package's analysis layer on the port's engine).

Where the source-level linter (cyclonus_tpu_torch.linter) checks the 12
syntactic properties of raw policy YAML, this package asks SEMANTIC
questions of the resolved form, answered with the engine's verdict
tensors plus a handful of boolean reductions:

  * audit (audit.py)  — per-rule firing masks; shadowed / never-firing
                        rule detection with the responsible policies
                        named (`analyze --mode audit`)
  * diff  (diff.py)   — policy-set diff / equivalence: the exact
                        (src, dst, port, proto) cells where two sets'
                        verdict tensors differ (`analyze --mode diff`)
  * oracle (oracle.py)— scalar-matcher cross-checks: every reported
                        claim is re-derived line-by-line on a sampled
                        subset before it reaches the user
  * cluster (cluster.py) — derive port cases / synthesize a
                        representative cluster from the policies alone
  * classes (classes.py) — oracle-backed audit of the equivalence-class
                        grid compression: co-classed pods must get
                        identical scalar verdicts against every peer
"""

from .audit import AuditFinding, AuditReport, RuleRef, audit_policy_set
from .classes import audit_class_reduction
from .cluster import derive_port_cases, synthesize_cluster
from .diff import DiffCell, DiffReport, diff_policy_sets
from .oracle import policy_without_rule

__all__ = [
    "audit_class_reduction",
    "AuditFinding",
    "AuditReport",
    "RuleRef",
    "audit_policy_set",
    "derive_port_cases",
    "synthesize_cluster",
    "DiffCell",
    "DiffReport",
    "diff_policy_sets",
    "policy_without_rule",
]
