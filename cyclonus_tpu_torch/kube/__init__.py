"""k8s object model and primitives (reference: pkg/kube): the policy
dataclasses, selectors and IP blocks the engine compiles.

No kubernetes client dependency for the core: policies, selectors, and IP
blocks are plain dataclasses, so the whole engine runs clusterless.
"""

from .netpol import (
    IntOrString,
    LabelSelector,
    LabelSelectorRequirement,
    IPBlock,
    NetworkPolicyPort,
    NetworkPolicyPeer,
    NetworkPolicyIngressRule,
    NetworkPolicyEgressRule,
    NetworkPolicySpec,
    NetworkPolicy,
    PROTOCOL_TCP,
    PROTOCOL_UDP,
    PROTOCOL_SCTP,
    POLICY_TYPE_INGRESS,
    POLICY_TYPE_EGRESS,
)
from .labels import (
    is_name_match,
    is_match_expression_match,
    is_labels_match_label_selector,
    is_label_selector_empty,
    serialize_label_selector,
    label_selector_table_lines,
)
from .ipaddr import (
    is_ip_in_cidr,
    is_ip_address_match_for_ip_block,
    make_ipv4_cidr,
    ip_to_uint32,
    cidr_to_base_and_prefix,
)
from .yaml_io import (
    load_policies_from_path,
    parse_policy_dict,
    policy_to_dict,
    policies_to_yaml,
)
from .ikubernetes import IKubernetes, MockKubernetes, MockNamespace
from .protocol import parse_protocol, qualified_service_address

__all__ = [
    "IntOrString",
    "LabelSelector",
    "LabelSelectorRequirement",
    "IPBlock",
    "NetworkPolicyPort",
    "NetworkPolicyPeer",
    "NetworkPolicyIngressRule",
    "NetworkPolicyEgressRule",
    "NetworkPolicySpec",
    "NetworkPolicy",
    "PROTOCOL_TCP",
    "PROTOCOL_UDP",
    "PROTOCOL_SCTP",
    "POLICY_TYPE_INGRESS",
    "POLICY_TYPE_EGRESS",
    "is_name_match",
    "is_match_expression_match",
    "is_labels_match_label_selector",
    "is_label_selector_empty",
    "serialize_label_selector",
    "label_selector_table_lines",
    "is_ip_in_cidr",
    "is_ip_address_match_for_ip_block",
    "make_ipv4_cidr",
    "ip_to_uint32",
    "cidr_to_base_and_prefix",
    "load_policies_from_path",
    "parse_policy_dict",
    "policy_to_dict",
    "policies_to_yaml",
    "IKubernetes",
    "MockKubernetes",
    "MockNamespace",
    "parse_protocol",
    "qualified_service_address",
]
