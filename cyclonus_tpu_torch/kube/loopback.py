"""Loopback cluster: REAL-socket conformance backend without kubernetes.

The reference proves its real-cluster path with a KinD flow
(hack/kind/run-cyclonus.sh:1-60); this environment has no docker/kind/
kubectl and no netfilter, so that flow cannot run here.  This module is
the strongest available substitute — and a capability the reference
itself lacks: a cluster whose pods are real OS processes with dedicated
loopback IPs (the 127/8 block is fully bindable on Linux), whose probes
are real TCP connects / UDP datagrams issued by the real in-pod worker
subprocess, and whose NetworkPolicies are enforced per-connection by the
pod servers against a verdict map (kube/loopback_server.py).

What is REAL here, vs the in-process mock (ikubernetes.MockKubernetes +
mockcni): pod processes and lifecycle, socket binds on 80/81, source-IP
attribution (clients bind the source pod's address, servers enforce on
getpeername), unserved-port refusals from the kernel, UDP timeout
semantics, the worker's subprocess + JSON protocol, and probe
concurrency.  What is emulated: the allow/deny DECISION comes from this
framework's own matcher (as the perfect-CNI mock's does) because
userspace cannot install packet filters — so this backend validates the
probe/exec/worker/compare machinery end-to-end over a real network
stack, not an independent CNI implementation.

A copy of the reference package's kube/loopback.py whose subprocesses
run this package's pod server and worker.  Used by `generate --loopback`
/ `probe --loopback` and tests/test_torch_loopback.py.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import tempfile
import threading
from typing import Dict, List, Optional, Tuple

from .ikubernetes import KubeError, MockKubernetes
from .objects import KubePod

_ACK = b"A"
_INSTANCES = [0]


def native_probe(
    host: str,
    port: int,
    protocol: str,
    source_ip: Optional[str] = None,
    timeout: float = 1.0,
) -> Optional[str]:
    """One real probe against a loopback pod server; None = allowed,
    otherwise a short error string (the agnhost-connect analog: any
    failure, including no app-level ACK, means blocked).  source_ip
    binds the client socket so the server's getpeername sees the probing
    POD, not a generic 127.0.0.1 — source-IP attribution is what makes
    per-(src, dst) policy enforcement real on loopback."""
    proto = protocol.upper()
    if proto == "TCP":
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    elif proto == "UDP":
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    else:
        return f"protocol {protocol} unsupported on loopback"
    try:
        s.settimeout(timeout)
        if source_ip:
            s.bind((source_ip, 0))
        if proto == "TCP":
            s.connect((host, port))
            data = s.recv(1)
        else:
            # connect() the UDP socket so the kernel filters datagrams
            # from any peer other than (host, port) — otherwise a stray
            # datagram on the bound port could flip a blocked verdict to
            # allowed.  Bonus: ICMP port-unreachable surfaces as
            # ECONNREFUSED instead of a 1 s timeout.
            s.connect((host, port))
            s.send(b"?")
            data = s.recv(1)
        return None if data == _ACK else "closed without ack"
    except socket.timeout:
        return "timeout"
    except OSError as e:
        return f"connect error: {e.strerror or e}"
    finally:
        s.close()


class LoopbackKubernetes(MockKubernetes):
    """MockKubernetes state machine + real pod processes and probes.

    Pods get unique 127.x.y.z addresses; create_pod spawns one
    loopback_server process per pod (READY-handshaked) serving its
    TCP/UDP container ports; every state mutation that can change a
    verdict atomically rewrites the shared allow map the servers
    consult.  execute_remote_command performs the REAL probe instead of
    answering from a table: agnhost-style commands run native_probe
    bound to the source pod's IP, and /worker batches run the actual
    `python -m cyclonus_tpu_torch.worker` subprocess with native connects.
    """

    def __init__(self, ready_timeout_s: float = 20.0):
        super().__init__(pass_rate=1.0)
        from .mockcni import PolicyAwareMockExec

        # base octet: unique per (process, instance) so parallel clusters
        # never collide on (ip, port) binds
        _INSTANCES[0] += 1
        self._base = 10 + (os.getpid() * 7 + _INSTANCES[0]) % 200
        self._ready_timeout_s = ready_timeout_s
        self._servers: Dict[Tuple[str, str], subprocess.Popen] = {}  # guarded-by: self._lock
        self._lock = threading.Lock()
        self._tmp = tempfile.mkdtemp(prefix="cyclonus-loopback-")
        self.verdict_path = os.path.join(self._tmp, "verdicts.json")
        # the same oracle the perfect-CNI mock uses, reused for the
        # verdict map + service-name resolution (kube/mockcni.py)
        self._oracle = PolicyAwareMockExec(self)
        self._write_verdicts()
        # pod servers are real child processes: they survive a parent
        # crash (unlike threads) and would hold their 127.x binds forever.
        # weakref.finalize (not atexit.register(self.close)) so a closed/
        # collected cluster doesn't stay pinned in the atexit table for
        # the process lifetime; close() detaches it.
        import weakref

        self._finalizer = weakref.finalize(
            self, _kill_servers, self._servers, self._lock, self._tmp
        )

    # --- pod lifecycle: real processes ---

    def _alloc_ip(self) -> str:
        i = self._pod_id  # MockKubernetes counter, already advanced
        return f"127.{self._base}.{i // 250}.{i % 250 + 1}"

    def create_pod(self, pod: KubePod) -> KubePod:
        pod = super().create_pod(pod)
        pod.pod_ip = self._alloc_ip()
        listens = [
            f"{p.protocol}:{p.container_port}"
            for c in pod.containers
            for p in c.ports
            if p.protocol in ("TCP", "UDP")
        ]
        if not listens:
            self._write_verdicts()
            return pod
        cmd = [
            sys.executable,
            "-m",
            "cyclonus_tpu_torch.kube.loopback_server",
            "--ip",
            pod.pod_ip,
            "--verdicts",
            self.verdict_path,
        ]
        for spec in listens:
            cmd += ["--listen", spec]
        proc = subprocess.Popen(
            cmd,
            stdout=subprocess.PIPE,
            stderr=subprocess.PIPE,
            text=True,
            cwd=os.path.dirname(os.path.dirname(os.path.dirname(__file__))),
        )
        ready = _read_line_bounded(proc.stdout, self._ready_timeout_s)
        if ready.strip() != "READY":
            err = ""
            try:
                proc.kill()
                err = (proc.stderr.read() or "")[:500]
            except Exception:
                pass
            super().delete_pod(pod.namespace, pod.name)
            raise KubeError(
                f"loopback pod server for {pod.namespace}/{pod.name} "
                f"failed to start: {err or 'no READY within timeout'}"
            )
        with self._lock:
            self._servers[(pod.namespace, pod.name)] = proc
        self._write_verdicts()
        return pod

    def delete_pod(self, namespace: str, pod: str) -> None:
        super().delete_pod(namespace, pod)
        with self._lock:
            proc = self._servers.pop((namespace, pod), None)
        if proc is not None:
            proc.kill()
            proc.wait(timeout=5)
        self._write_verdicts()

    def delete_namespace(self, namespace: str) -> None:
        pods = [p.name for p in self.get_pods_in_namespace(namespace)]
        super().delete_namespace(namespace)
        for name in pods:
            with self._lock:
                proc = self._servers.pop((namespace, name), None)
            if proc is not None:
                proc.kill()
                proc.wait(timeout=5)
        self._write_verdicts()

    def close(self) -> None:
        """Kill every pod server and drop the verdict dir (idempotent:
        the finalizer runs its callback at most once — whether called
        here, at GC, or at interpreter exit)."""
        self._finalizer()

    def __enter__(self) -> "LoopbackKubernetes":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # --- verdict map: every policy-relevant mutation rewrites it ---

    def _write_verdicts(self) -> None:
        allow: List[str] = []
        pods = [
            (ns_name, pod)
            for ns_name, ns in self.namespaces.items()
            for pod in ns.pods.values()
        ]
        for src_ns, src in pods:
            for dst_ns, dst in pods:
                for c in dst.containers:
                    for p in c.ports:
                        if p.protocol not in ("TCP", "UDP"):
                            continue
                        if self._oracle._verdict_resolved(
                            src_ns, src, dst_ns, dst, p.container_port, p.protocol
                        ):
                            allow.append(
                                f"{src.pod_ip}|{dst.pod_ip}|"
                                f"{p.container_port}|{p.protocol}"
                            )
        tmp = self.verdict_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"allow": allow}, f)
        os.replace(tmp, self.verdict_path)  # atomic for per-probe reloads

    def _mutated(self):
        # the oracle's compiled-policy cache keys on policy_rev (bumped by
        # super()); labels/pods have no rev, so verdicts must recompute
        self._write_verdicts()

    def create_namespace(self, ns):
        out = super().create_namespace(ns)
        self._mutated()
        return out

    def set_namespace_labels(self, namespace, labels):
        out = super().set_namespace_labels(namespace, labels)
        self._mutated()
        return out

    def set_pod_labels(self, namespace, pod, labels):
        out = super().set_pod_labels(namespace, pod, labels)
        self._mutated()
        return out

    def create_network_policy(self, policy):
        out = super().create_network_policy(policy)
        self._mutated()
        return out

    def update_network_policy(self, policy):
        out = super().update_network_policy(policy)
        self._mutated()
        return out

    def delete_network_policy(self, namespace, name):
        super().delete_network_policy(namespace, name)
        self._mutated()

    def delete_all_network_policies_in_namespace(self, namespace):
        super().delete_all_network_policies_in_namespace(namespace)
        self._mutated()

    # --- exec: REAL probes ---

    def _resolve_host(self, host: str) -> str:
        """Service names / cluster IPs -> backing pod IP (there is no DNS
        on loopback); pod IPs pass through; unknown hosts pass through
        and fail at connect time, like a real missing DNS record."""
        dest = self._oracle._find_dest_pod(host)
        return dest[1].pod_ip if dest is not None else host

    def execute_remote_command(
        self, namespace: str, pod: str, container: str, command: List[str]
    ) -> Tuple[str, str, Optional[str]]:
        ns = self._ns(namespace)
        if pod not in ns.pods:
            raise KubeError(f"pod {namespace}/{pod} not found")
        pod_obj = ns.pods[pod]
        if not any(c.name == container for c in pod_obj.containers):
            raise KubeError(f"container {namespace}/{pod}/{container} not found")

        if command and command[0] == "/worker":
            # run the REAL in-pod batch prober as a real subprocess with
            # native connects bound to this pod's address
            from ..worker.model import Batch

            batch = Batch.from_json(command[command.index("--jobs") + 1])
            for req in batch.requests:
                req.host = self._resolve_host(req.host)
            env = dict(os.environ)
            env["CYCLONUS_CONNECT_NATIVE"] = "1"
            env["CYCLONUS_SOURCE_IP"] = pod_obj.pod_ip
            # worst case every probe runs the full 1s timeout twice
            # (retry) at worker concurrency 10; a batch that still
            # exceeds the bound reports a check failure instead of
            # crashing the run with an uncaught TimeoutExpired
            budget = 30 + (2.5 * len(batch.requests)) / 10
            try:
                proc = subprocess.run(
                    [
                        sys.executable,
                        "-m",
                        "cyclonus_tpu_torch.worker",
                        "--jobs",
                        batch.to_json(),
                    ],
                    capture_output=True,
                    text=True,
                    timeout=budget,
                    env=env,
                    cwd=os.path.dirname(os.path.dirname(os.path.dirname(__file__))),
                )
            except subprocess.TimeoutExpired:
                raise KubeError(
                    f"loopback worker batch in {namespace}/{pod} exceeded "
                    f"{budget:.0f}s ({len(batch.requests)} requests)"
                )
            if proc.returncode != 0:
                return (proc.stdout, proc.stderr, f"worker exit {proc.returncode}")
            return (proc.stdout, "", None)

        # /agnhost connect <host:port> --timeout=1s --protocol=<p>
        address = command[2]
        host, port_s = address.rsplit(":", 1)
        protocol = command[-1].split("=", 1)[1].upper()
        err = native_probe(
            self._resolve_host(host),
            int(port_s),
            protocol,
            source_ip=pod_obj.pod_ip,
        )
        return ("", "", err)


def _kill_servers(servers: Dict, lock: threading.Lock, tmp: str) -> None:
    """Finalizer body: must not reference the cluster object (a bound
    method would keep it alive in the finalizer registry).  Mutates the
    SHARED servers dict in place — delete_pod pops from the same one."""
    import shutil

    with lock:
        procs = list(servers.values())
        servers.clear()
    for proc in procs:
        try:
            proc.kill()
            proc.wait(timeout=5)
        except Exception:
            pass
    shutil.rmtree(tmp, ignore_errors=True)


def _read_line_bounded(stream, timeout_s: float) -> str:
    """readline() with a deadline (the stream has no timeout of its own)."""
    out: List[str] = []

    def read():
        out.append(stream.readline())

    t = threading.Thread(target=read, daemon=True)
    t.start()
    t.join(timeout_s)
    return out[0] if out else ""
