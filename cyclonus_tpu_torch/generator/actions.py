"""Cluster perturbation actions — a 10-variant sum type
(reference: generator/action.go)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..kube.netpol import NetworkPolicy


@dataclass
class CreatePolicyAction:
    policy: NetworkPolicy


@dataclass
class UpdatePolicyAction:
    policy: NetworkPolicy


@dataclass
class DeletePolicyAction:
    namespace: str
    name: str


@dataclass
class CreateNamespaceAction:
    namespace: str
    labels: Dict[str, str]


@dataclass
class SetNamespaceLabelsAction:
    namespace: str
    labels: Dict[str, str]


@dataclass
class DeleteNamespaceAction:
    namespace: str


@dataclass
class ReadNetworkPoliciesAction:
    namespaces: List[str]


@dataclass
class CreatePodAction:
    namespace: str
    pod: str
    labels: Dict[str, str]


@dataclass
class SetPodLabelsAction:
    namespace: str
    pod: str
    labels: Dict[str, str]


@dataclass
class DeletePodAction:
    namespace: str
    pod: str


@dataclass
class Action:
    """Exactly one field is non-None (action.go:5-20)."""

    create_policy: Optional[CreatePolicyAction] = None
    update_policy: Optional[UpdatePolicyAction] = None
    delete_policy: Optional[DeletePolicyAction] = None
    create_namespace: Optional[CreateNamespaceAction] = None
    set_namespace_labels: Optional[SetNamespaceLabelsAction] = None
    delete_namespace: Optional[DeleteNamespaceAction] = None
    read_network_policies: Optional[ReadNetworkPoliciesAction] = None
    create_pod: Optional[CreatePodAction] = None
    set_pod_labels: Optional[SetPodLabelsAction] = None
    delete_pod: Optional[DeletePodAction] = None


def create_policy(policy: NetworkPolicy) -> Action:
    return Action(create_policy=CreatePolicyAction(policy=policy))


def update_policy(policy: NetworkPolicy) -> Action:
    return Action(update_policy=UpdatePolicyAction(policy=policy))


def delete_policy(ns: str, name: str) -> Action:
    return Action(delete_policy=DeletePolicyAction(namespace=ns, name=name))


def create_namespace(ns: str, labels: Dict[str, str]) -> Action:
    return Action(create_namespace=CreateNamespaceAction(namespace=ns, labels=labels))


def set_namespace_labels(ns: str, labels: Dict[str, str]) -> Action:
    return Action(
        set_namespace_labels=SetNamespaceLabelsAction(namespace=ns, labels=labels)
    )


def delete_namespace(ns: str) -> Action:
    return Action(delete_namespace=DeleteNamespaceAction(namespace=ns))


def read_network_policies(namespaces: List[str]) -> Action:
    return Action(
        read_network_policies=ReadNetworkPoliciesAction(namespaces=namespaces)
    )


def create_pod(ns: str, pod: str, labels: Dict[str, str]) -> Action:
    return Action(create_pod=CreatePodAction(namespace=ns, pod=pod, labels=labels))


def set_pod_labels(ns: str, pod: str, labels: Dict[str, str]) -> Action:
    return Action(
        set_pod_labels=SetPodLabelsAction(namespace=ns, pod=pod, labels=labels)
    )


def delete_pod(ns: str, pod: str) -> Action:
    return Action(delete_pod=DeletePodAction(namespace=ns, pod=pod))
