"""The 8 conformance case families (reference: generator/targetcases.go,
rulescases.go, peerscases.go, portprotocolcases.go, actioncases.go,
conflictcases.go, examplecases.go, upstreame2ecases.go).

Golden counts (testcasegenerator_tests.go:11-24): target 6, rules 4, peers
112, port/protocol 58, example 1, action 6, conflict 16, upstream-e2e 13."""

from __future__ import annotations

from typing import List, Optional

from ..kube.ipaddr import make_ipv4_cidr
from ..kube.labels import is_label_selector_empty, serialize_label_selector
from ..kube.netpol import (
    IPBlock,
    IntOrString,
    LabelSelector,
    LabelSelectorRequirement,
    NetworkPolicy,
    NetworkPolicyEgressRule,
    NetworkPolicyIngressRule,
    NetworkPolicyPeer,
    NetworkPolicyPort,
    NetworkPolicySpec,
    OP_IN,
    OP_NOT_IN,
)
from .actions import (
    Action,
    create_namespace,
    create_pod,
    create_policy,
    delete_namespace,
    delete_pod,
    delete_policy,
    set_namespace_labels,
    set_pod_labels,
    update_policy,
)
from .constants import (
    EMPTY_SELECTOR,
    NS_X_MATCH_LABELS_SELECTOR,
    NS_YZ_MATCH_EXPRESSIONS_SELECTOR,
    POD_AB_MATCH_EXPRESSIONS_SELECTOR,
    POD_A_MATCH_LABELS_SELECTOR,
    POD_C_MATCH_LABELS_SELECTOR,
    PORT7981,
    PORT80,
    PORT81,
    PORT_SERVE_7981_UDP,
    PORT_SERVE_80_SCTP,
    PORT_SERVE_80_TCP,
    PORT_SERVE_80_UDP,
    PORT_SERVE_81_SCTP,
    PORT_SERVE_81_TCP,
    PORT_SERVE_81_UDP,
    SCTP,
    TCP,
    UDP,
    allow_dns_policy,
    allow_dns_rule,
    probe_all_available,
    probe_port,
)
from .netpol_builder import (
    Netpol,
    NetpolPeers,
    NetpolTarget,
    Rule,
    base_test_policy,
    build_policy,
    set_namespace,
    set_peers,
    set_pod_selector,
    set_ports,
    set_rules,
)
from .tags import (
    StringSet,
    TAG_ALLOW_ALL,
    TAG_ALL_NAMESPACES,
    TAG_ALL_PODS,
    TAG_ANY_PEER,
    TAG_ANY_PORT,
    TAG_ANY_PORT_PROTOCOL,
    TAG_CONFLICT,
    TAG_CREATE_NAMESPACE,
    TAG_CREATE_POD,
    TAG_CREATE_POLICY,
    TAG_DELETE_NAMESPACE,
    TAG_DELETE_POD,
    TAG_DELETE_POLICY,
    TAG_DENY_ALL,
    TAG_EGRESS,
    TAG_EXAMPLE,
    TAG_INGRESS,
    TAG_IP_BLOCK_NO_EXCEPT,
    TAG_IP_BLOCK_WITH_EXCEPT,
    TAG_MULTI_PEER,
    TAG_MULTI_PORT_PROTOCOL,
    TAG_NAMED_PORT,
    TAG_NAMESPACES_BY_LABEL,
    TAG_NUMBERED_PORT,
    TAG_PATHOLOGICAL,
    TAG_PODS_BY_LABEL,
    TAG_POLICY_NAMESPACE,
    TAG_SCTP,
    TAG_SET_NAMESPACE_LABELS,
    TAG_SET_POD_LABELS,
    TAG_TARGET_NAMESPACE,
    TAG_TARGET_POD_SELECTOR,
    TAG_TCP,
    TAG_UDP,
    TAG_UPDATE_POLICY,
    TAG_UPSTREAM_E2E,
)
from .testcase import TestCase, TestStep, new_single_step_test_case, new_test_case


def describe_directionality(is_ingress: bool) -> str:
    return TAG_INGRESS if is_ingress else TAG_EGRESS


def describe_port(port: Optional[IntOrString]) -> str:
    if port is None:
        return TAG_ANY_PORT
    return TAG_NUMBERED_PORT if port.is_int else TAG_NAMED_PORT


def describe_protocol(protocol: Optional[str]) -> Optional[str]:
    if protocol is None:
        return None
    return {"TCP": TAG_TCP, "UDP": TAG_UDP, "SCTP": TAG_SCTP}[protocol]


# ---------------------------------------------------------------------------
# target cases (targetcases.go)
# ---------------------------------------------------------------------------


def target_cases(namespaces: List[str]) -> List[TestCase]:
    cases = []
    for ns in namespaces:
        cases.append(
            new_single_step_test_case(
                f"set namespace to {ns}",
                StringSet.of(TAG_TARGET_NAMESPACE),
                probe_all_available(),
                create_policy(build_policy(set_namespace(ns)).network_policy()),
            )
        )
    for selector in (
        EMPTY_SELECTOR,
        POD_A_MATCH_LABELS_SELECTOR,
        POD_AB_MATCH_EXPRESSIONS_SELECTOR,
    ):
        cases.append(
            new_single_step_test_case(
                f"set pod selector to {serialize_label_selector(selector)}",
                StringSet.of(TAG_TARGET_POD_SELECTOR),
                probe_all_available(),
                create_policy(build_policy(set_pod_selector(selector)).network_policy()),
            )
        )
    return cases


# ---------------------------------------------------------------------------
# rules cases (rulescases.go)
# ---------------------------------------------------------------------------


def rules_cases() -> List[TestCase]:
    cases = []
    for is_ingress in (False, True):
        direction = describe_directionality(is_ingress)
        cases.append(
            new_single_step_test_case(
                f"{direction}: deny all",
                StringSet.of(direction, TAG_DENY_ALL),
                probe_all_available(),
                create_policy(build_policy(set_rules(is_ingress, [])).network_policy()),
            )
        )
        cases.append(
            new_single_step_test_case(
                f"{direction}: allow all",
                StringSet.of(direction, TAG_ALLOW_ALL),
                probe_all_available(),
                create_policy(
                    build_policy(set_rules(is_ingress, [Rule()])).network_policy()
                ),
            )
        )
    return cases


# ---------------------------------------------------------------------------
# peers cases (peerscases.go)
# ---------------------------------------------------------------------------


class _DescribedPeer:
    def __init__(self, description: str, peer: NetworkPolicyPeer):
        self.description = description
        self.peer = peer


def _pod_peers() -> List[_DescribedPeer]:
    return [
        _DescribedPeer(
            "empty pods + nil ns", NetworkPolicyPeer(pod_selector=EMPTY_SELECTOR)
        ),
        _DescribedPeer(
            "pods by label + nil ns",
            NetworkPolicyPeer(pod_selector=POD_C_MATCH_LABELS_SELECTOR),
        ),
        _DescribedPeer(
            "nil pods + empty ns", NetworkPolicyPeer(namespace_selector=EMPTY_SELECTOR)
        ),
        _DescribedPeer(
            "empty pods + empty ns",
            NetworkPolicyPeer(
                pod_selector=EMPTY_SELECTOR, namespace_selector=EMPTY_SELECTOR
            ),
        ),
        _DescribedPeer(
            "pods by label + empty ns",
            NetworkPolicyPeer(
                pod_selector=POD_C_MATCH_LABELS_SELECTOR,
                namespace_selector=EMPTY_SELECTOR,
            ),
        ),
        _DescribedPeer(
            "nil pods + ns by label",
            NetworkPolicyPeer(namespace_selector=NS_X_MATCH_LABELS_SELECTOR),
        ),
        _DescribedPeer(
            "empty pods + ns by label",
            NetworkPolicyPeer(
                pod_selector=EMPTY_SELECTOR,
                namespace_selector=NS_X_MATCH_LABELS_SELECTOR,
            ),
        ),
        _DescribedPeer(
            "pods by label + ns by label",
            NetworkPolicyPeer(
                pod_selector=POD_C_MATCH_LABELS_SELECTOR,
                namespace_selector=NS_X_MATCH_LABELS_SELECTOR,
            ),
        ),
    ]


def _ip_block_peers(pod_ip: str) -> List[_DescribedPeer]:
    cidr24 = make_ipv4_cidr(pod_ip, 24)
    cidr28 = make_ipv4_cidr(pod_ip, 28)
    return [
        _DescribedPeer(
            "simple ipblock", NetworkPolicyPeer(ip_block=IPBlock.make(cidr24))
        ),
        _DescribedPeer(
            "ipblock with except",
            NetworkPolicyPeer(ip_block=IPBlock.make(cidr24, [cidr28])),
        ),
    ]


def _make_peers(pod_ip: str) -> List[_DescribedPeer]:
    return _pod_peers() + _ip_block_peers(pod_ip)


def _describe_peer(peer: NetworkPolicyPeer) -> List[str]:
    if peer.ip_block is not None:
        if not peer.ip_block.except_:
            return [TAG_IP_BLOCK_NO_EXCEPT]
        return [TAG_IP_BLOCK_WITH_EXCEPT]
    if peer.namespace_selector is None:
        ns_tag = TAG_POLICY_NAMESPACE
    elif is_label_selector_empty(peer.namespace_selector):
        ns_tag = TAG_ALL_NAMESPACES
    else:
        ns_tag = TAG_NAMESPACES_BY_LABEL
    if peer.pod_selector is None or is_label_selector_empty(peer.pod_selector):
        pod_tag = TAG_ALL_PODS
    else:
        pod_tag = TAG_PODS_BY_LABEL
    return [ns_tag, pod_tag]


def peers_cases(pod_ip: str) -> List[TestCase]:
    cases = []
    # zero peers
    for is_ingress in (True, False):
        direction = describe_directionality(is_ingress)
        cases.append(
            new_single_step_test_case(
                f"{direction}: empty peers",
                StringSet.of(direction, TAG_ANY_PEER),
                probe_all_available(),
                create_policy(
                    build_policy(set_peers(is_ingress, [])).network_policy()
                ),
            )
        )
    # single peers
    for is_ingress in (True, False):
        for p in _make_peers(pod_ip):
            tags = _describe_peer(p.peer) + [describe_directionality(is_ingress)]
            cases.append(
                new_single_step_test_case(
                    p.description,
                    StringSet.of(*tags),
                    probe_all_available(),
                    create_policy(
                        build_policy(set_peers(is_ingress, [p.peer])).network_policy()
                    ),
                )
            )
    # two peers
    for is_ingress in (True, False):
        described = _make_peers(pod_ip)
        for i, p1 in enumerate(described):
            for j, p2 in enumerate(described):
                if i < j:
                    direction = describe_directionality(is_ingress)
                    tags = (
                        _describe_peer(p1.peer)
                        + [TAG_MULTI_PEER, direction]
                        + _describe_peer(p2.peer)
                    )
                    cases.append(
                        new_single_step_test_case(
                            f"{direction}, 2-peer: {p1.description}, {p2.description}",
                            StringSet.of(*tags),
                            probe_all_available(),
                            create_policy(
                                build_policy(
                                    set_peers(is_ingress, [p1.peer, p2.peer])
                                ).network_policy()
                            ),
                        )
                    )
    return cases


# ---------------------------------------------------------------------------
# port/protocol cases (portprotocolcases.go)
# ---------------------------------------------------------------------------


def _network_policy_ports() -> List[NetworkPolicyPort]:
    npps = [
        NetworkPolicyPort(protocol=protocol, port=port)
        for protocol in (None, TCP, UDP, SCTP)
        for port in (None, PORT80, PORT81)
    ]
    npps.extend(
        [
            NetworkPolicyPort(protocol=TCP, port=PORT_SERVE_80_TCP),
            NetworkPolicyPort(protocol=TCP, port=PORT_SERVE_81_TCP),
            NetworkPolicyPort(protocol=UDP, port=PORT_SERVE_80_UDP),
            NetworkPolicyPort(protocol=UDP, port=PORT_SERVE_81_UDP),
            NetworkPolicyPort(protocol=SCTP, port=PORT_SERVE_80_SCTP),
            NetworkPolicyPort(protocol=SCTP, port=PORT_SERVE_81_SCTP),
        ]
    )
    return npps


def port_protocol_cases() -> List[TestCase]:
    cases = []
    # zero
    for is_ingress in (False, True):
        direction = describe_directionality(is_ingress)
        cases.append(
            new_single_step_test_case(
                f"{direction}: empty port/protocol",
                StringSet.of(direction, TAG_ANY_PORT_PROTOCOL),
                probe_all_available(),
                create_policy(
                    build_policy(set_ports(is_ingress, [])).network_policy()
                ),
            )
        )
    # single + pathological
    for is_ingress in (False, True):
        direction = describe_directionality(is_ingress)
        for npp in _network_policy_ports():
            tags = StringSet.of(direction, describe_port(npp.port))
            proto_tag = describe_protocol(npp.protocol)
            if proto_tag is not None:
                tags.add(proto_tag)
            cases.append(
                new_single_step_test_case(
                    "",
                    tags,
                    probe_all_available(),
                    create_policy(
                        build_policy(set_ports(is_ingress, [npp])).network_policy()
                    ),
                )
            )
        pathological = [
            (
                "open a named port that doesn't match its protocol",
                NetworkPolicyPort(protocol=TCP, port=PORT_SERVE_81_UDP),
            ),
            (
                "open a named port that isn't served",
                NetworkPolicyPort(protocol=TCP, port=PORT_SERVE_7981_UDP),
            ),
            (
                "open a numbered port that isn't served",
                NetworkPolicyPort(protocol=TCP, port=PORT7981),
            ),
        ]
        for description, npp in pathological:
            cases.append(
                new_single_step_test_case(
                    description,
                    StringSet.of(
                        TAG_PATHOLOGICAL, direction, describe_port(npp.port), TAG_TCP
                    ),
                    probe_all_available(),
                    create_policy(
                        build_policy(set_ports(is_ingress, [npp])).network_policy()
                    ),
                )
            )
    # two ports (portprotocolcases.go:144-168)
    npp_pairs = [
        [NetworkPolicyPort(), NetworkPolicyPort(port=PORT80)],
        [NetworkPolicyPort(), NetworkPolicyPort(port=PORT_SERVE_80_TCP)],
        [NetworkPolicyPort(), NetworkPolicyPort(protocol=UDP)],
        [NetworkPolicyPort(port=PORT80), NetworkPolicyPort(port=PORT81)],
        [NetworkPolicyPort(port=PORT80), NetworkPolicyPort(port=PORT_SERVE_81_TCP)],
        [
            NetworkPolicyPort(port=PORT80),
            NetworkPolicyPort(protocol=UDP, port=PORT_SERVE_81_UDP),
        ],
        [
            NetworkPolicyPort(protocol=UDP, port=PORT80),
            NetworkPolicyPort(protocol=UDP, port=PORT_SERVE_81_UDP),
        ],
    ]
    for is_ingress in (False, True):
        direction = describe_directionality(is_ingress)
        for npp_slice in npp_pairs:
            tags = StringSet.of(TAG_MULTI_PORT_PROTOCOL, direction)
            for pp in npp_slice:
                proto_tag = describe_protocol(pp.protocol)
                if proto_tag is not None:
                    tags.add(proto_tag)
                tags.add(describe_port(pp.port))
            cases.append(
                new_single_step_test_case(
                    "",
                    tags,
                    probe_all_available(),
                    create_policy(
                        build_policy(set_ports(is_ingress, npp_slice)).network_policy()
                    ),
                )
            )
    return cases


# ---------------------------------------------------------------------------
# action cases (actioncases.go)
# ---------------------------------------------------------------------------


def action_cases() -> List[TestCase]:
    base = base_test_policy()
    return [
        TestCase(
            description="Create/delete policy",
            tags=StringSet.of(TAG_CREATE_POLICY, TAG_DELETE_POLICY),
            steps=[
                TestStep(
                    probe_all_available(),
                    [create_policy(base_test_policy().network_policy())],
                ),
                TestStep(
                    probe_all_available(),
                    [delete_policy(base.target.namespace, base.name)],
                ),
            ],
        ),
        TestCase(
            description="Create/update policy",
            tags=StringSet.of(TAG_CREATE_POLICY, TAG_UPDATE_POLICY),
            steps=[
                TestStep(
                    probe_all_available(),
                    [create_policy(base_test_policy().network_policy())],
                ),
                TestStep(
                    probe_all_available(),
                    [
                        update_policy(
                            build_policy(
                                set_ports(
                                    True,
                                    [
                                        NetworkPolicyPort(
                                            protocol=UDP, port=PORT_SERVE_81_UDP
                                        )
                                    ],
                                )
                            ).network_policy()
                        )
                    ],
                ),
            ],
        ),
        TestCase(
            description="Create/delete namespace",
            tags=StringSet.of(TAG_CREATE_NAMESPACE, TAG_DELETE_NAMESPACE),
            steps=[
                TestStep(
                    probe_all_available(),
                    [create_policy(base_test_policy().network_policy())],
                ),
                TestStep(
                    probe_all_available(),
                    [
                        create_namespace("y-2", {"ns": "y"}),
                        create_pod("y-2", "a", {"pod": "a"}),
                        create_pod("y-2", "b", {"pod": "b"}),
                    ],
                ),
                TestStep(probe_all_available(), [delete_namespace("y-2")]),
            ],
        ),
        TestCase(
            description="Update namespace so that policy applies, then again so it no longer applies",
            tags=StringSet.of(TAG_SET_NAMESPACE_LABELS),
            steps=[
                TestStep(
                    probe_all_available(),
                    [
                        create_policy(
                            build_policy(
                                set_peers(
                                    True,
                                    [
                                        NetworkPolicyPeer(
                                            namespace_selector=LabelSelector.make(
                                                match_labels={"new-ns": "qrs"}
                                            )
                                        )
                                    ],
                                )
                            ).network_policy()
                        )
                    ],
                ),
                TestStep(
                    probe_all_available(),
                    [set_namespace_labels("y", {"ns": "y", "new-ns": "qrs"})],
                ),
                TestStep(
                    probe_all_available(),
                    [set_namespace_labels("y", {"ns": "y"})],
                ),
            ],
        ),
        TestCase(
            description="Create/delete pod",
            tags=StringSet.of(TAG_CREATE_POD, TAG_DELETE_POD),
            steps=[
                TestStep(
                    probe_all_available(),
                    [create_policy(base_test_policy().network_policy())],
                ),
                TestStep(
                    probe_all_available(), [create_pod("x", "d", {"pod": "d"})]
                ),
                TestStep(probe_all_available(), [delete_pod("x", "d")]),
            ],
        ),
        TestCase(
            description="Update pod so that policy applies, then again so it no longer applies",
            tags=StringSet.of(TAG_SET_POD_LABELS),
            steps=[
                TestStep(
                    probe_all_available(),
                    [
                        create_policy(
                            build_policy(
                                set_peers(
                                    True,
                                    [
                                        NetworkPolicyPeer(
                                            pod_selector=LabelSelector.make(
                                                match_labels={"new-label": "abc"}
                                            ),
                                            namespace_selector=NS_YZ_MATCH_EXPRESSIONS_SELECTOR,
                                        )
                                    ],
                                )
                            ).network_policy()
                        )
                    ],
                ),
                TestStep(
                    probe_all_available(),
                    [set_pod_labels("y", "b", {"pod": "b", "new-label": "abc"})],
                ),
                TestStep(
                    probe_all_available(),
                    [set_pod_labels("y", "b", {"pod": "b"})],
                ),
            ],
        ),
    ]


# ---------------------------------------------------------------------------
# conflict cases (conflictcases.go)
# ---------------------------------------------------------------------------


def _explicit_allow_all() -> NetpolPeers:
    return NetpolPeers(rules=[Rule()])


def _deny_all() -> NetpolPeers:
    return NetpolPeers(rules=[])


def _allow_all_by_pod() -> NetpolPeers:
    return NetpolPeers(
        rules=[Rule(peers=[NetworkPolicyPeer(namespace_selector=EMPTY_SELECTOR)])]
    )


def _allow_all_by_ip() -> NetpolPeers:
    return NetpolPeers(
        rules=[Rule(peers=[NetworkPolicyPeer(ip_block=IPBlock.make("0.0.0.0/0"))])]
    )


def _deny_all_by_ip() -> NetpolPeers:
    return NetpolPeers(
        rules=[Rule(peers=[NetworkPolicyPeer(ip_block=IPBlock.make("0.0.0.0/31"))])]
    )


def _deny_all_by_pod() -> NetpolPeers:
    return NetpolPeers(
        rules=[
            Rule(
                peers=[
                    NetworkPolicyPeer(
                        namespace_selector=LabelSelector.make(
                            match_labels={"this-will-never-happen": "qrs123"}
                        )
                    )
                ]
            )
        ]
    )


def conflict_cases(allow_dns: bool) -> List[TestCase]:
    """conflictcases.go:253-304.  NB the reference passes `source` for the
    last 8 slots (including the 'ingress' ones) — mirrored exactly."""
    source = NetpolTarget.make("x", {"pod": "b"})
    dest = NetpolTarget.make("y", {"pod": "c"})

    slices = [
        (
            "deny all from source, allow all to dest",
            [TAG_DENY_ALL, TAG_ALLOW_ALL, TAG_INGRESS, TAG_EGRESS],
            [
                Netpol(name="deny-all-egress", target=source, egress=_deny_all()),
                Netpol(
                    name="allow-all-ingress", target=dest, ingress=_explicit_allow_all()
                ),
            ],
        ),
        (
            "allow all from source, deny all to dest",
            [TAG_DENY_ALL, TAG_ALLOW_ALL, TAG_INGRESS, TAG_EGRESS],
            [
                Netpol(
                    name="allow-all-egress", target=source, egress=_explicit_allow_all()
                ),
                Netpol(name="deny-all-ingress", target=dest, ingress=_deny_all()),
            ],
        ),
        (
            "deny all + allow all from same source",
            [TAG_DENY_ALL, TAG_ALLOW_ALL, TAG_EGRESS],
            [
                Netpol(name="deny-all-egress", target=source, egress=_deny_all()),
                Netpol(
                    name="allow-all-egress", target=source, egress=_explicit_allow_all()
                ),
            ],
        ),
        (
            "deny all + allow all to same dest",
            [TAG_DENY_ALL, TAG_ALLOW_ALL, TAG_INGRESS],
            [
                Netpol(name="deny-all-ingress", target=dest, ingress=_deny_all()),
                Netpol(
                    name="allow-all-ingress", target=dest, ingress=_explicit_allow_all()
                ),
            ],
        ),
        (
            "deny all + allow all by pod from same source",
            [TAG_DENY_ALL, TAG_ALL_PODS, TAG_ALL_NAMESPACES, TAG_EGRESS],
            [
                Netpol(name="deny-all-egress", target=source, egress=_deny_all()),
                Netpol(
                    name="allow-all-egress-by-pod",
                    target=source,
                    egress=_allow_all_by_pod(),
                ),
            ],
        ),
        (
            "deny all + allow all by IP from same source",
            [TAG_DENY_ALL, TAG_EGRESS],
            [
                Netpol(name="deny-all-egress", target=source, egress=_deny_all()),
                Netpol(
                    name="allow-all-egress-by-ip",
                    target=source,
                    egress=_allow_all_by_ip(),
                ),
            ],
        ),
        (
            "deny all by IP + allow all by pod from same source",
            [TAG_ALL_PODS, TAG_ALL_NAMESPACES, TAG_EGRESS],
            [
                Netpol(
                    name="deny-all-egress-by-ip",
                    target=source,
                    egress=_deny_all_by_ip(),
                ),
                Netpol(
                    name="allow-all-egress-by-pod",
                    target=source,
                    egress=_allow_all_by_pod(),
                ),
            ],
        ),
        (
            "deny all by pod + allow all by IP from same source",
            [TAG_EGRESS],
            [
                Netpol(
                    name="deny-all-egress-by-pod",
                    target=source,
                    egress=_deny_all_by_pod(),
                ),
                Netpol(
                    name="allow-all-egress-by-ip",
                    target=source,
                    egress=_allow_all_by_ip(),
                ),
            ],
        ),
        (
            "deny all + allow all by pod to same source",
            [TAG_DENY_ALL, TAG_INGRESS, TAG_ALL_PODS, TAG_ALL_NAMESPACES],
            [
                Netpol(name="deny-all-ingress", target=source, ingress=_deny_all()),
                Netpol(
                    name="allow-all-ingress-by-pod",
                    target=source,
                    ingress=_allow_all_by_pod(),
                ),
            ],
        ),
        (
            "deny all + allow all by IP to same source",
            [TAG_DENY_ALL, TAG_INGRESS],
            [
                Netpol(name="deny-all-ingress", target=source, ingress=_deny_all()),
                Netpol(
                    name="allow-all-ingress-by-ip",
                    target=source,
                    ingress=_allow_all_by_ip(),
                ),
            ],
        ),
        (
            "deny all by IP + allow all by pod to same source",
            [TAG_INGRESS, TAG_ALL_PODS, TAG_ALL_NAMESPACES],
            [
                Netpol(
                    name="deny-all-ingress-by-ip",
                    target=source,
                    ingress=_deny_all_by_ip(),
                ),
                Netpol(
                    name="allow-all-ingress-by-pod",
                    target=source,
                    ingress=_allow_all_by_pod(),
                ),
            ],
        ),
        (
            "deny all by pod + allow all by IP to same source",
            [TAG_INGRESS],
            [
                Netpol(
                    name="deny-all-ingress-by-pod",
                    target=source,
                    ingress=_deny_all_by_pod(),
                ),
                Netpol(
                    name="allow-all-ingress-by-ip",
                    target=source,
                    ingress=_allow_all_by_ip(),
                ),
            ],
        ),
        (
            "egress: deny all by IP",
            [TAG_EGRESS],
            [
                Netpol(
                    name="deny-all-egress-by-ip",
                    target=source,
                    egress=_deny_all_by_ip(),
                )
            ],
        ),
        (
            "egress: deny all by pod",
            [TAG_EGRESS],
            [
                Netpol(
                    name="deny-all-egress-by-ip",
                    target=source,
                    egress=_deny_all_by_pod(),
                )
            ],
        ),
        (
            "ingress: deny all by IP",
            [TAG_INGRESS],
            [
                Netpol(
                    name="deny-all-ingress-by-ip",
                    target=source,
                    ingress=_deny_all_by_ip(),
                )
            ],
        ),
        (
            "ingress: deny all by pod",
            [TAG_INGRESS],
            [
                Netpol(
                    name="deny-all-ingress-by-ip",
                    target=source,
                    ingress=_deny_all_by_pod(),
                )
            ],
        ),
    ]

    cases = []
    for description, tag_list, policies in slices:
        actions = []
        has_egress = False
        for pol in policies:
            if pol.egress is not None:
                has_egress = True
            actions.append(create_policy(pol.network_policy()))
        if has_egress and allow_dns:
            actions.append(create_policy(allow_dns_policy(source).network_policy()))
        tags = StringSet.of(*tag_list)
        tags.add(TAG_CONFLICT)
        cases.append(
            new_single_step_test_case(
                description, tags, probe_all_available(), *actions
            )
        )
    return cases


# ---------------------------------------------------------------------------
# example cases (examplecases.go)
# ---------------------------------------------------------------------------


def example_cases() -> List[TestCase]:
    policy = NetworkPolicy(
        name="allow-all",
        namespace="x",
        spec=NetworkPolicySpec(
            pod_selector=EMPTY_SELECTOR,
            policy_types=["Ingress"],
            ingress=[
                NetworkPolicyIngressRule(
                    ports=[NetworkPolicyPort(port=PORT_SERVE_81_TCP)]
                )
            ],
        ),
    )
    return [
        new_test_case(
            "should allow ingress access on one named port",
            StringSet.of(TAG_EXAMPLE),
            TestStep(probe_all_available(), [create_policy(policy)]),
            TestStep(
                probe_all_available(),
                [
                    create_namespace("w", {"ns": "w"}),
                    create_pod("w", "a", {"pod": "a"}),
                ],
            ),
            TestStep(probe_all_available(), [delete_pod("w", "a")]),
            TestStep(probe_all_available(), [delete_namespace("w")]),
            TestStep(probe_all_available(), []),
            TestStep(probe_port(PORT81, TCP), []),
            TestStep(probe_port(PORT_SERVE_81_TCP, TCP), []),
        )
    ]


# ---------------------------------------------------------------------------
# upstream e2e cases (upstreame2ecases.go)
# ---------------------------------------------------------------------------


def _np(name, ns, pod_selector, types, ingress=None, egress=None) -> NetworkPolicy:
    return NetworkPolicy(
        name=name,
        namespace=ns,
        spec=NetworkPolicySpec(
            pod_selector=pod_selector,
            policy_types=types,
            ingress=ingress or [],
            egress=egress or [],
        ),
    )


def upstream_e2e_cases() -> List[TestCase]:
    probe = probe_all_available
    cases = [
        new_single_step_test_case(
            "should support a 'default-deny-ingress' policy",
            StringSet.of(TAG_UPSTREAM_E2E, TAG_INGRESS, TAG_DENY_ALL),
            probe(),
            create_policy(_np("deny-ingress", "x", EMPTY_SELECTOR, ["Ingress"])),
        ),
        new_single_step_test_case(
            "should support a 'default-deny-all' policy",
            StringSet.of(TAG_UPSTREAM_E2E, TAG_DENY_ALL),
            probe(),
            create_policy(
                _np(
                    "deny-all-allow-dns",
                    "x",
                    EMPTY_SELECTOR,
                    ["Egress", "Ingress"],
                    egress=[allow_dns_rule().egress()],
                )
            ),
        ),
        new_single_step_test_case(
            "should enforce policy based on Multiple PodSelectors and NamespaceSelectors",
            StringSet.of(TAG_UPSTREAM_E2E),
            probe(),
            create_policy(
                _np(
                    "allow-ns-y-z-pod-b-c",
                    "x",
                    POD_A_MATCH_LABELS_SELECTOR,
                    ["Ingress"],
                    ingress=[
                        NetworkPolicyIngressRule(
                            from_=[
                                NetworkPolicyPeer(
                                    namespace_selector=LabelSelector.make(
                                        match_expressions=[
                                            LabelSelectorRequirement(
                                                "ns", OP_NOT_IN, ("x",)
                                            )
                                        ]
                                    ),
                                    pod_selector=LabelSelector.make(
                                        match_expressions=[
                                            LabelSelectorRequirement(
                                                "pod", OP_IN, ("b", "c")
                                            )
                                        ]
                                    ),
                                )
                            ]
                        )
                    ],
                )
            ),
        ),
        new_test_case(
            "should enforce multiple, stacked policies with overlapping podSelectors [Feature:NetworkPolicy]",
            StringSet.of(TAG_UPSTREAM_E2E),
            TestStep(
                probe(),
                [
                    create_policy(
                        _np(
                            "allow-client-a-via-ns-selector-81",
                            "x",
                            POD_A_MATCH_LABELS_SELECTOR,
                            ["Ingress"],
                            ingress=[
                                NetworkPolicyIngressRule(
                                    from_=[
                                        NetworkPolicyPeer(
                                            namespace_selector=LabelSelector.make(
                                                match_labels={"ns": "y"}
                                            )
                                        )
                                    ],
                                    ports=[NetworkPolicyPort(protocol=TCP, port=PORT81)],
                                )
                            ],
                        )
                    )
                ],
            ),
            TestStep(probe(), []),
            TestStep(
                probe(),
                [
                    create_policy(
                        _np(
                            "allow-client-a-via-ns-selector-80",
                            "x",
                            POD_A_MATCH_LABELS_SELECTOR,
                            ["Ingress"],
                            ingress=[
                                NetworkPolicyIngressRule(
                                    from_=[
                                        NetworkPolicyPeer(
                                            namespace_selector=LabelSelector.make(
                                                match_labels={"ns": "y"}
                                            )
                                        )
                                    ],
                                    ports=[NetworkPolicyPort(protocol=TCP, port=PORT80)],
                                )
                            ],
                        )
                    )
                ],
            ),
        ),
        new_test_case(
            "should support allow-all policy",
            StringSet.of(TAG_UPSTREAM_E2E, TAG_ALLOW_ALL),
            TestStep(
                probe(),
                [
                    create_policy(
                        _np(
                            "allow-all",
                            "x",
                            EMPTY_SELECTOR,
                            ["Ingress"],
                            ingress=[NetworkPolicyIngressRule()],
                        )
                    )
                ],
            ),
            TestStep(probe(), []),
        ),
        new_test_case(
            "should allow ingress access on one named port",
            StringSet.of(TAG_UPSTREAM_E2E, TAG_INGRESS, TAG_NAMED_PORT),
            TestStep(
                probe_port(PORT_SERVE_81_TCP, TCP),
                [
                    create_policy(
                        _np(
                            "allow-all",
                            "x",
                            EMPTY_SELECTOR,
                            ["Ingress"],
                            ingress=[
                                NetworkPolicyIngressRule(
                                    ports=[
                                        NetworkPolicyPort(port=PORT_SERVE_81_TCP)
                                    ]
                                )
                            ],
                        )
                    )
                ],
            ),
            TestStep(probe(), []),
        ),
        new_test_case(
            "should enforce updated policy",
            StringSet.of(TAG_UPSTREAM_E2E),
            TestStep(
                probe(),
                [
                    create_policy(
                        _np(
                            "allow-all-mutate-to-deny-all",
                            "x",
                            EMPTY_SELECTOR,
                            ["Ingress"],
                            ingress=[NetworkPolicyIngressRule()],
                        )
                    )
                ],
            ),
            TestStep(
                probe(),
                [
                    update_policy(
                        _np(
                            "allow-all-mutate-to-deny-all",
                            "x",
                            EMPTY_SELECTOR,
                            ["Ingress"],
                        )
                    )
                ],
            ),
        ),
        new_test_case(
            "should allow ingress access from updated namespace",
            StringSet.of(TAG_UPSTREAM_E2E),
            TestStep(
                probe(),
                [
                    create_policy(
                        _np(
                            "allow-client-a-via-ns-selector",
                            "x",
                            POD_A_MATCH_LABELS_SELECTOR,
                            ["Ingress"],
                            ingress=[
                                NetworkPolicyIngressRule(
                                    from_=[
                                        NetworkPolicyPeer(
                                            namespace_selector=LabelSelector.make(
                                                match_labels={"ns2": "updated"}
                                            )
                                        )
                                    ]
                                )
                            ],
                        )
                    )
                ],
            ),
            TestStep(
                probe(),
                [set_namespace_labels("y", {"ns": "y", "ns2": "updated"})],
            ),
        ),
        new_test_case(
            "should allow ingress access from updated pod",
            StringSet.of(TAG_UPSTREAM_E2E),
            TestStep(
                probe(),
                [
                    create_policy(
                        _np(
                            "allow-client-a-via-pod-selector",
                            "x",
                            POD_A_MATCH_LABELS_SELECTOR,
                            ["Ingress"],
                            ingress=[
                                NetworkPolicyIngressRule(
                                    from_=[
                                        NetworkPolicyPeer(
                                            pod_selector=LabelSelector.make(
                                                match_labels={
                                                    "pod": "b",
                                                    "pod2": "updated",
                                                }
                                            )
                                        )
                                    ]
                                )
                            ],
                        )
                    )
                ],
            ),
            TestStep(
                probe(),
                [set_pod_labels("x", "b", {"pod": "b", "pod2": "updated"})],
            ),
        ),
        new_test_case(
            "should deny ingress access to updated pod",
            StringSet.of(TAG_UPSTREAM_E2E),
            TestStep(
                probe(),
                [
                    create_policy(
                        _np(
                            "deny-ingress-via-label-selector",
                            "x",
                            LabelSelector.make(match_labels={"target": "isolated"}),
                            ["Ingress"],
                        )
                    )
                ],
            ),
            TestStep(probe(), [set_pod_labels("x", "a", {"target": "isolated"})]),
        ),
        new_test_case(
            "should work with Ingress, Egress specified together",
            StringSet.of(TAG_UPSTREAM_E2E),
            TestStep(
                probe(),
                [
                    create_policy(
                        _np(
                            "allow-client-a-via-pod-selector",
                            "x",
                            POD_A_MATCH_LABELS_SELECTOR,
                            ["Ingress", "Egress"],
                            ingress=[
                                NetworkPolicyIngressRule(
                                    from_=[
                                        NetworkPolicyPeer(
                                            pod_selector=LabelSelector.make(
                                                match_labels={"pod": "b"}
                                            )
                                        )
                                    ]
                                )
                            ],
                            egress=[
                                NetworkPolicyEgressRule(
                                    ports=[
                                        NetworkPolicyPort(port=PORT80),
                                        NetworkPolicyPort(
                                            protocol=UDP, port=IntOrString(53)
                                        ),
                                    ]
                                )
                            ],
                        )
                    )
                ],
            ),
            TestStep(probe(), []),
        ),
        new_test_case(
            "should support denying of egress traffic on the client side (even if the server explicitly allows this traffic)",
            StringSet.of(TAG_UPSTREAM_E2E, TAG_CONFLICT),
            TestStep(
                probe(),
                [
                    create_policy(
                        _np(
                            "allow-to-ns-y-pod-a",
                            "x",
                            POD_A_MATCH_LABELS_SELECTOR,
                            ["Egress"],
                            egress=[
                                NetworkPolicyEgressRule(
                                    to=[
                                        NetworkPolicyPeer(
                                            namespace_selector=LabelSelector.make(
                                                match_labels={"ns": "y"}
                                            ),
                                            pod_selector=POD_A_MATCH_LABELS_SELECTOR,
                                        )
                                    ]
                                ),
                                NetworkPolicyEgressRule(
                                    ports=[
                                        NetworkPolicyPort(
                                            protocol=UDP, port=IntOrString(53)
                                        )
                                    ]
                                ),
                            ],
                        )
                    ),
                    create_policy(
                        _np(
                            "allow-from-xa-on-ya-match-selector",
                            "y",
                            POD_A_MATCH_LABELS_SELECTOR,
                            ["Ingress"],
                            ingress=[
                                NetworkPolicyIngressRule(
                                    from_=[
                                        NetworkPolicyPeer(
                                            namespace_selector=LabelSelector.make(
                                                match_labels={"ns": "x"}
                                            ),
                                            pod_selector=POD_A_MATCH_LABELS_SELECTOR,
                                        )
                                    ]
                                )
                            ],
                        )
                    ),
                    create_policy(
                        _np(
                            "allow-from-xa-on-yb-match-selector",
                            "y",
                            LabelSelector.make(match_labels={"pod": "b"}),
                            ["Ingress"],
                            ingress=[
                                NetworkPolicyIngressRule(
                                    from_=[
                                        NetworkPolicyPeer(
                                            namespace_selector=LabelSelector.make(
                                                match_labels={"ns": "x"}
                                            ),
                                            pod_selector=POD_A_MATCH_LABELS_SELECTOR,
                                        )
                                    ]
                                )
                            ],
                        )
                    ),
                ],
            ),
        ),
        new_test_case(
            "should stop enforcing policies after they are deleted",
            StringSet.of(TAG_UPSTREAM_E2E, TAG_DENY_ALL, TAG_DELETE_POLICY),
            TestStep(
                probe(),
                [
                    create_policy(
                        _np("deny-all", "x", EMPTY_SELECTOR, ["Ingress", "Egress"])
                    )
                ],
            ),
            TestStep(probe(), [delete_policy("x", "deny-all")]),
        ),
    ]
    return cases
