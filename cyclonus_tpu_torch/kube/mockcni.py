"""A policy-aware exec hook for MockKubernetes: emulates a PERFECT CNI by
evaluating the mock cluster's own NetworkPolicies with the scalar oracle.

The reference's mock exec is pass-rate-random (ikubernetes.go:314-340), so
`generate --mock` always shows comparison noise.  Wiring this in instead
makes the full conformance loop meaningful clusterless: simulated tables
must equal mock-kube tables on every step, or the framework itself is
broken.

Handles both exec shapes the framework issues:
  * /agnhost connect <host:port> --timeout=1s --protocol=<p>
  * /worker --jobs <json-batch>   (the in-pod batch prober)
"""

from __future__ import annotations

import json
from typing import List, Optional, Tuple, Union

from ..matcher.builder import build_network_policies
from ..matcher.core import InternalPeer, Policy, Traffic, TrafficPeer
from .ikubernetes import MockKubernetes
from .objects import KubePod


class PolicyAwareMockExec:
    """Install via ``mock.exec_verdict_fn = PolicyAwareMockExec(mock)``."""

    def __init__(self, mock: MockKubernetes):
        self.mock = mock
        self._policy_cache: Optional[Tuple[int, Policy]] = None

    def _compiled_policy(self) -> Policy:
        """Compile the mock's policy set once per netpol revision."""
        rev = self.mock.policy_rev
        if self._policy_cache is None or self._policy_cache[0] != rev:
            policies = [
                pol
                for ns in self.mock.namespaces.values()
                for pol in ns.netpols.values()
            ]
            self._policy_cache = (rev, build_network_policies(True, policies))
        return self._policy_cache[1]

    def _find_dest_pod(self, host: str) -> Optional[Tuple[str, KubePod]]:
        """Resolve an agnhost target host: pod IP, service cluster IP, or
        qualified service name (s-<ns>-<name>.<ns>.svc.cluster.local)."""
        for ns_name, ns in self.mock.namespaces.items():
            for pod in ns.pods.values():
                if pod.pod_ip == host:
                    return ns_name, pod
        for ns_name, ns in self.mock.namespaces.items():
            for svc in ns.services.values():
                if host == f"{svc.name}.{svc.namespace}.svc.cluster.local" or (
                    svc.cluster_ip and host == svc.cluster_ip
                ):
                    for pod in ns.pods.values():
                        if all(
                            pod.labels.get(k) == v for k, v in svc.selector.items()
                        ):
                            return ns_name, pod
        return None

    def _verdict(self, namespace: str, pod: str, host: str, port: int, protocol: str) -> bool:
        dest = self._find_dest_pod(host)
        if dest is None:
            return False  # unreachable host
        dest_ns, dest_pod = dest
        return self._verdict_resolved(
            namespace, self.mock.get_pod(namespace, pod), dest_ns, dest_pod, port, protocol
        )

    def _verdict_resolved(
        self,
        src_ns: str,
        src_pod: KubePod,
        dest_ns: str,
        dest_pod: KubePod,
        port: int,
        protocol: str,
    ) -> bool:
        """Verdict with both endpoints already resolved — the loopback
        cluster's verdict-map rebuild iterates pod objects directly and
        must not pay _find_dest_pod's linear scan per pair."""
        # the port must actually be served on this protocol
        serving = any(
            p.container_port == port and p.protocol == protocol
            for c in dest_pod.containers
            for p in c.ports
        )
        if not serving:
            return False

        # resolve the traffic's port name from the (port, protocol) container
        # actually being hit — this matches the name the simulated job carries
        # for all-available probes.  (NB the framework's numbered-port
        # resolution wart — resources.py resolve_numbered_port ignores
        # protocol — can diverge here only for numbered-port probes on a
        # non-first protocol combined with named-port rules, which no
        # generated case produces.)
        port_name = ""
        for c in dest_pod.containers:
            for p in c.ports:
                if p.container_port == port and p.protocol == protocol:
                    port_name = p.name

        traffic = Traffic(
            source=TrafficPeer(
                internal=InternalPeer(
                    pod_labels=src_pod.labels,
                    namespace_labels=self.mock.get_namespace(src_ns).labels,
                    namespace=src_ns,
                ),
                ip=src_pod.pod_ip,
            ),
            destination=TrafficPeer(
                internal=InternalPeer(
                    pod_labels=dest_pod.labels,
                    namespace_labels=self.mock.get_namespace(dest_ns).labels,
                    namespace=dest_ns,
                ),
                ip=dest_pod.pod_ip,
            ),
            resolved_port=port,
            resolved_port_name=port_name,
            protocol=protocol,
        )
        return self._compiled_policy().is_traffic_allowed(traffic).is_allowed

    def __call__(
        self, namespace: str, pod: str, container: str, command: List[str]
    ) -> Union[bool, Tuple[str, str, Optional[str]]]:
        if command and command[0] == "/worker":
            # batch prober: answer with the worker's JSON result protocol
            from ..worker.model import Batch, Result

            batch = Batch.from_json(command[command.index("--jobs") + 1])
            results = []
            for req in batch.requests:
                ok = self._verdict(
                    namespace, pod, req.host, req.port, req.protocol.upper()
                )
                results.append(
                    Result(
                        request=req, output="", error="" if ok else "blocked"
                    ).to_dict()
                )
            return (json.dumps(results), "", None)

        # /agnhost connect host:port --timeout=1s --protocol=<p>
        address = command[2]
        host, port_str = address.rsplit(":", 1)
        protocol = command[-1].split("=", 1)[1].upper()
        return self._verdict(namespace, pod, host, int(port_str), protocol)
