"""YAML loading/serialization of NetworkPolicies (reference: pkg/cli/utils.go).

Supports the same input shapes: a single policy document, a YAML list, a
multi-doc stream, a `kind: NetworkPolicyList`, or a directory walked
recursively for .yml/.yaml files (utils.go:14-60).

PyYAML is imported inside the loaders and the dumper: nothing on the
engine path needs it, and a machine that only evaluates in-code policies
may not have it.
"""

from __future__ import annotations

import os
from typing import List

from .netpol import NetworkPolicy, NetworkPolicySpec


def parse_policy_dict(d: dict) -> NetworkPolicy:
    meta = d.get("metadata") or {}
    return NetworkPolicy(
        name=meta.get("name", ""),
        namespace=meta.get("namespace", ""),
        spec=NetworkPolicySpec.from_dict(d.get("spec") or {}),
    )


def policy_to_dict(p: NetworkPolicy) -> dict:
    meta: dict = {"name": p.name}
    if p.namespace:
        meta["namespace"] = p.namespace
    return {
        "apiVersion": "networking.k8s.io/v1",
        "kind": "NetworkPolicy",
        "metadata": meta,
        "spec": p.spec.to_dict(),
    }


def policies_to_yaml(policies: List[NetworkPolicy]) -> str:
    import yaml

    return yaml.safe_dump_all(
        [policy_to_dict(p) for p in policies], sort_keys=False, default_flow_style=False
    )


def _parse_documents(docs) -> List[NetworkPolicy]:
    policies: List[NetworkPolicy] = []
    for doc in docs:
        if doc is None:
            continue
        if isinstance(doc, list):
            for item in doc:
                policies.append(parse_policy_dict(item))
        elif isinstance(doc, dict) and doc.get("kind") == "NetworkPolicyList":
            for item in doc.get("items") or []:
                policies.append(parse_policy_dict(item))
        elif isinstance(doc, dict):
            policies.append(parse_policy_dict(doc))
        else:
            raise ValueError(f"unexpected YAML document of type {type(doc)}")
    return policies


def load_policies_from_yaml(text: str) -> List[NetworkPolicy]:
    import yaml

    return _parse_documents(yaml.safe_load_all(text))


def load_policies_from_file(path: str) -> List[NetworkPolicy]:
    with open(path) as f:
        return load_policies_from_yaml(f.read())


def load_policies_from_path(path: str) -> List[NetworkPolicy]:
    """File => parse it; directory => recursive walk of .yml/.yaml files
    (utils.go:14-60)."""
    if os.path.isdir(path):
        policies: List[NetworkPolicy] = []
        for root, _dirs, files in sorted(os.walk(path)):
            for name in sorted(files):
                if name.endswith((".yml", ".yaml")):
                    policies.extend(load_policies_from_file(os.path.join(root, name)))
        return policies
    return load_policies_from_file(path)
