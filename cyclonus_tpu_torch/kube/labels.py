"""Label-selector matching semantics (reference: pkg/kube/labelselector.go).

Full matchLabels + matchExpressions support with all four operators.  The
NotIn-with-absent-key rule (absent key => NO match, labelselector.go:37-49)
follows the k8s docs and is a known trap; it is covered by tests.
"""

from __future__ import annotations

import json
from typing import Dict

from .netpol import (
    LabelSelector,
    LabelSelectorRequirement,
    OP_DOES_NOT_EXIST,
    OP_EXISTS,
    OP_IN,
    OP_NOT_IN,
)


def is_name_match(object_name: str, matcher: str) -> bool:
    """Kube pattern: empty matcher matches all (labelselector.go:17-22)."""
    if matcher == "":
        return True
    return object_name == matcher


def is_match_expression_match(
    labels: Dict[str, str], exp: LabelSelectorRequirement
) -> bool:
    """One matchExpression against a label set (labelselector.go:24-59)."""
    if exp.operator == OP_IN:
        if exp.key not in labels:
            return False
        return labels[exp.key] in exp.values
    elif exp.operator == OP_NOT_IN:
        # Absent key => not a match, even for NotIn (k8s set-based requirement
        # docs; labelselector.go:37-49).
        if exp.key not in labels:
            return False
        return labels[exp.key] not in exp.values
    elif exp.operator == OP_EXISTS:
        return exp.key in labels
    elif exp.operator == OP_DOES_NOT_EXIST:
        return exp.key not in labels
    else:
        raise ValueError(f"invalid operator {exp.operator!r}")


def is_labels_match_label_selector(
    labels: Dict[str, str], selector: LabelSelector
) -> bool:
    """matchLabels and matchExpressions are ANDed; an empty selector matches
    all objects (labelselector.go:61-86)."""
    for key, val in selector.match_labels_items:
        if labels.get(key) != val:
            return False
    for exp in selector.match_expressions:
        if not is_match_expression_match(labels, exp):
            return False
    return True


def is_label_selector_empty(selector: LabelSelector) -> bool:
    return len(selector.match_labels_items) == 0 and len(selector.match_expressions) == 0


def serialize_label_selector(selector: LabelSelector) -> str:
    """Deterministic string form used in primary keys
    (labelselector.go:92-112)."""
    key_vals = [f"{k}: {v}" for k, v in selector.match_labels_items]
    exprs = [
        {"key": e.key, "operator": e.operator, "values": list(e.values)}
        for e in selector.match_expressions
    ]
    return json.dumps(
        ["MatchLabels", key_vals, "MatchExpression", exprs], separators=(",", ":")
    )


def label_selector_table_lines(selector: LabelSelector) -> str:
    """Human-readable selector rendering (labelselector.go:114-132)."""
    if is_label_selector_empty(selector):
        return "all pods"
    lines = []
    if selector.match_labels_items:
        lines.append("Match labels:")
        for key, val in selector.match_labels_items:
            lines.append(f"  {key}: {val}")
    if selector.match_expressions:
        lines.append("Match expressions:")
        for exp in selector.match_expressions:
            lines.append(f"  {exp.key} {exp.operator} {list(exp.values)}")
    return "\n".join(lines)
