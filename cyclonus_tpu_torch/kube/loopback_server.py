"""Standalone pod server for the loopback cluster (kube/loopback.py).

One OS process per pod — the loopback analog of a pod's containers.  It
binds the pod's dedicated 127.x.y.z address on every served
(port, protocol) and answers probes with an application-level ACK byte
iff the cluster's current verdict map allows the (source pod -> this
pod, port, protocol) flow:

  TCP: accept -> look up peer IP -> send b"A" if allowed, else close.
  UDP: recvfrom -> look up peer IP -> reply b"A" if allowed, else drop.

Enforcement is at the application layer because this environment offers
no netfilter (see docs/LOOPBACK.md); a blocked flow still completes the
TCP handshake but never receives the ACK, which the native prober
(loopback.native_probe) treats as blocked — mirroring how agnhost
treats a connect that produces no service response.  Probes to a port
the pod does not serve never reach this process at all: they get a real
ECONNREFUSED / UDP timeout from the kernel.

The verdict map is a JSON file ({"allow": ["src|dst|port|PROTO", ...]})
rewritten atomically by LoopbackKubernetes on every policy/label/pod
mutation; the server re-stats it per probe and reloads on change, so a
policy perturbation is visible to the very next probe with no wait.

Protocol note: only TCP and UDP are served — SCTP needs kernel support
python sockets don't portably offer (the reference's kind clusters
commonly lack it too, hack/kind/run-cyclonus.sh).
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import sys
import threading


class VerdictMap:
    """mtime-cached view of the cluster's allow map."""

    def __init__(self, path: str):
        self.path = path
        self._stamp = None  # guarded-by: self._lock
        self._allow = frozenset()  # guarded-by: self._lock
        self._lock = threading.Lock()

    def allowed(self, src_ip: str, dst_ip: str, port: int, proto: str) -> bool:
        with self._lock:
            try:
                st = os.stat(self.path)
                stamp = (st.st_mtime_ns, st.st_size)
                if stamp != self._stamp:
                    with open(self.path) as f:
                        self._allow = frozenset(json.load(f)["allow"])
                    self._stamp = stamp
            except (OSError, ValueError, KeyError):
                # unreadable/missing map: fail closed (deny)
                return False
            return f"{src_ip}|{dst_ip}|{port}|{proto}" in self._allow


def _serve_tcp(srv: socket.socket, ip: str, port: int, verdicts: VerdictMap) -> None:
    srv.listen(64)
    while True:
        conn, addr = srv.accept()
        try:
            if verdicts.allowed(addr[0], ip, port, "TCP"):
                conn.sendall(b"A")
        except OSError:
            pass
        finally:
            conn.close()


def _serve_udp(srv: socket.socket, ip: str, port: int, verdicts: VerdictMap) -> None:
    while True:
        _data, addr = srv.recvfrom(64)
        if verdicts.allowed(addr[0], ip, port, "UDP"):
            try:
                srv.sendto(b"A", addr)
            except OSError:
                pass


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="loopback-pod-server")
    parser.add_argument("--ip", required=True, help="pod loopback IP")
    parser.add_argument(
        "--listen",
        action="append",
        required=True,
        metavar="PROTO:PORT",
        help="served port, e.g. TCP:80 (repeatable)",
    )
    parser.add_argument("--verdicts", required=True, help="verdict map JSON path")
    args = parser.parse_args(argv)

    verdicts = VerdictMap(args.verdicts)
    # bind everything on the MAIN thread so a taken port / bad address
    # fails the readiness handshake instead of dying silently in a
    # daemon thread after READY
    listeners = []
    for spec in args.listen:
        proto, port_s = spec.split(":", 1)
        proto, port = proto.upper(), int(port_s)
        kind = {"TCP": socket.SOCK_STREAM, "UDP": socket.SOCK_DGRAM}.get(proto)
        if kind is None:
            print(f"unsupported protocol {proto}", file=sys.stderr)
            return 2
        srv = socket.socket(socket.AF_INET, kind)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind((args.ip, port))
        serve = _serve_tcp if proto == "TCP" else _serve_udp
        listeners.append((serve, srv, port))
    for serve, srv, port in listeners:
        threading.Thread(
            target=serve, args=(srv, args.ip, port, verdicts), daemon=True
        ).start()

    print("READY", flush=True)  # all sockets bound and serving
    threading.Event().wait()  # serve forever; parent kills the process
    return 0


if __name__ == "__main__":
    sys.exit(main())
