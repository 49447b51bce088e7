"""Optional metrics endpoint: a stdlib http.server thread.

`start_metrics_server(port)` binds 127.0.0.1:<port> (0 = ephemeral; the
BOUND port is logged and available as `.port`/`.url` so callers can curl
it) and serves, on a daemon thread:

    /metrics           Prometheus text exposition (curl-able scrape target)
    /metrics.json      metrics snapshot as JSON
    /telemetry.json    full snapshot: metrics + span tree + flight recorder
    /profile?seconds=N on-demand profiling: runs torch.profiler (CPU, plus
                       CUDA when a card is present) for N seconds into a
                       fresh temp dir and returns the Chrome trace's path
                       as JSON (open in Perfetto / chrome://tracing)
    /healthz           liveness: 200 ok whenever the process serves HTTP
    /readyz            readiness: 200 ready / 503 warming, from the
                       optional callback registered via
                       register_readiness() — serve registers its
                       prewarm state here so a fleet router can hold
                       traffic while a replica warms; with no callback
                       registered, readiness == liveness (the old
                       single-answer behavior)
    /slo               SLO engine snapshot: per-
                       objective budget remaining, burn rates, and
                       enforcement state as JSON, from the provider
                       registered via register_slo() — 503 until a
                       provider registers (serve wires its controller
                       here)
    /audit             verdict audit plane snapshot: checked/diverged counts, queue depth,
                       per-epoch state digests, and the last divergence
                       summary as JSON, from the provider registered
                       via register_audit() — 503 until one registers
                       (serve wires its AuditController here)

Extension routes registered via `register_route(path, fn)` serve JSON
from the same thread — `serve` adds /state (engine epoch,
pending-delta depth, staleness) and /query (curl-able single-flow
verdict) this way.

Used by `probe`/`generate`/the worker via `--metrics-port`.  Stdlib-only
by design (the container bakes no Prometheus client), and the thread is
a daemon, so a finished CLI run never hangs on it.  A port that is
already taken raises MetricsPortBusy with a one-line message (the CLIs
convert it to a clean exit instead of a traceback).
"""

from __future__ import annotations

import errno
import json
import logging
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

logger = logging.getLogger("cyclonus.telemetry")

# /profile runs the process's one torch profiler; concurrent captures cannot
# nest, so a second request while one runs gets 409, not a crash
_PROFILE_LOCK = threading.Lock()
PROFILE_MAX_SECONDS = 60.0


class MetricsPortBusy(RuntimeError):
    """The requested metrics port is already bound by another process."""


_ROUTES_LOCK = threading.Lock()
# extension routes: path -> fn(query_dict) -> (payload_dict, status).
# The verdict service registers /state and /query here so the serve
# engine's epoch/staleness/pending surface rides the SAME stdlib http
# thread (and MetricsPortBusy handling) as /metrics.
_ROUTES: dict = {}  # guarded-by: _ROUTES_LOCK


def register_route(path: str, fn) -> None:
    """Register an extension GET route: fn(query: dict) -> (payload,
    http_status).  Replaces any previous handler at `path`; built-in
    endpoints cannot be shadowed (do_GET checks them first)."""
    with _ROUTES_LOCK:
        _ROUTES[path] = fn


def unregister_route(path: str) -> None:
    with _ROUTES_LOCK:
        _ROUTES.pop(path, None)


def _route_for(path: str):
    with _ROUTES_LOCK:
        return _ROUTES.get(path)


# optional readiness callback: fn() -> (ready: bool, detail: str).
# /healthz stays pure liveness (200 whenever the thread serves); /readyz
# consults this so probe/worker/serve each report HONEST readiness —
# a serve replica still prewarming its executables answers 503 and a
# fleet router holds traffic instead of routing into the warmup.
_READINESS: dict = {"fn": None}  # guarded-by: _ROUTES_LOCK


def register_readiness(fn) -> None:
    """Register the process readiness callback (replaces any previous
    one; None restores the default ready-when-alive behavior)."""
    with _ROUTES_LOCK:
        _READINESS["fn"] = fn


def _readiness() -> tuple:
    with _ROUTES_LOCK:
        fn = _READINESS["fn"]
    if fn is None:
        return True, "no readiness callback registered"
    try:
        ready, detail = fn()
        return bool(ready), str(detail)
    except Exception as e:  # a broken callback reads as not-ready
        return False, f"readiness callback failed: {type(e).__name__}: {e}"


# optional SLO snapshot provider: fn() -> dict (the /slo payload — per-
# objective budget remaining, burn rates, enforcement state; see
# the SLO controller).  Built-in route so /slo sits next to /metrics and
# /readyz on every process that has a provider; without one it answers
# 503 (the surface exists, the engine just isn't wired), mirroring the
# register_readiness pattern.
_SLO: dict = {"fn": None}  # guarded-by: _ROUTES_LOCK


def register_slo(fn) -> None:
    """Register the process SLO snapshot provider (replaces any
    previous one; None unregisters)."""
    with _ROUTES_LOCK:
        _SLO["fn"] = fn


def _slo_payload() -> tuple:
    with _ROUTES_LOCK:
        fn = _SLO["fn"]
    if fn is None:
        return {"error": "no slo provider registered"}, 503
    try:
        return dict(fn()), 200
    except Exception as e:  # a broken provider must answer, not hang
        return {"error": f"slo provider failed: {type(e).__name__}: {e}"}, 500


# optional audit snapshot provider: fn() -> dict (the /audit payload —
# shadow-oracle check counts, queue accounting, epoch state digests;
# see the audit plane).  Same contract as register_slo: 503 until a
# provider registers, 500 when a registered provider breaks.
_AUDIT: dict = {"fn": None}  # guarded-by: _ROUTES_LOCK


def register_audit(fn) -> None:
    """Register the process audit snapshot provider (replaces any
    previous one; None unregisters)."""
    with _ROUTES_LOCK:
        _AUDIT["fn"] = fn


def _audit_payload() -> tuple:
    with _ROUTES_LOCK:
        fn = _AUDIT["fn"]
    if fn is None:
        return {"error": "no audit provider registered"}, 503
    try:
        return dict(fn()), 200
    except Exception as e:  # a broken provider must answer, not hang
        return (
            {"error": f"audit provider failed: {type(e).__name__}: {e}"},
            500,
        )


class _Handler(BaseHTTPRequestHandler):
    def _send(self, body: bytes, content_type: str, code: int = 200) -> None:
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _send_json(self, payload: dict, code: int = 200) -> None:
        self._send(
            json.dumps(payload, default=str).encode(), "application/json", code
        )

    def do_GET(self) -> None:  # noqa: N802 (http.server API)
        from . import render_prometheus, snapshot

        parsed = urlparse(self.path)
        path = parsed.path
        if path == "/metrics":
            self._send(
                render_prometheus().encode(),
                "text/plain; version=0.0.4; charset=utf-8",
            )
        elif path == "/metrics.json":
            from .metrics import REGISTRY

            self._send_json(REGISTRY.snapshot())
        elif path == "/telemetry.json":
            self._send_json(snapshot())
        elif path == "/profile":
            self._profile(parse_qs(parsed.query))
        elif path == "/healthz":
            # liveness ONLY, by contract: restart the process when this
            # fails; readiness (warming vs serving) lives at /readyz
            self._send(b"ok\n", "text/plain")
        elif path == "/readyz":
            ready, detail = _readiness()
            self._send(
                f"{'ready' if ready else 'warming'}: {detail}\n".encode(),
                "text/plain",
                200 if ready else 503,
            )
        elif path == "/slo":
            payload, code = _slo_payload()
            self._send_json(payload, code)
        elif path == "/audit":
            payload, code = _audit_payload()
            self._send_json(payload, code)
        else:
            fn = _route_for(path)
            if fn is None:
                self._send(b"not found\n", "text/plain", 404)
                return
            try:
                payload, code = fn(parse_qs(parsed.query))
            except Exception as e:  # a broken handler must answer
                payload, code = {"error": f"{type(e).__name__}: {e}"}, 500
            self._send_json(payload, code)

    def _profile(self, query: dict) -> None:
        """On-demand profiling: wrap a sleep of ?seconds=N in
        torch.profiler (via the utils/tracing.torch_profile wrapper the
        --torch-profile flags use) and report the Chrome trace's path.
        The handler blocks for the capture window — ThreadingHTTPServer
        keeps the other endpoints responsive meanwhile."""
        try:
            seconds = float(query.get("seconds", ["1"])[0])
        except (TypeError, ValueError):
            self._send_json({"error": "seconds must be a number"}, 400)
            return
        if not (0 < seconds <= PROFILE_MAX_SECONDS):
            self._send_json(
                {"error": f"seconds must be in (0, {PROFILE_MAX_SECONDS:g}]"},
                400,
            )
            return
        if not _PROFILE_LOCK.acquire(blocking=False):
            self._send_json({"error": "a profile capture is already running"}, 409)
            return
        try:
            import tempfile

            from ..utils.tracing import PROFILE_TRACE_FILE, torch_profile

            out_dir = tempfile.mkdtemp(prefix="cyclonus-profile-")
            t0 = time.time()
            with torch_profile(out_dir):
                # _PROFILE_LOCK exists to serialize captures, and the
                # sleep IS the capture window; other endpoints stay
                # responsive (ThreadingHTTPServer), concurrent /profile
                # requests get the 409 above instead of queueing here
                time.sleep(seconds)  # locklint: ignore[LK003] the sleep is the capture window
            self._send_json(
                {
                    "artifact": out_dir,
                    "trace": os.path.join(out_dir, PROFILE_TRACE_FILE),  # locklint: ignore[LK003] os.path.join, no thread join
                    "seconds": seconds,
                    "wall_s": round(time.time() - t0, 3),
                    "hint": "open <trace> in https://ui.perfetto.dev or chrome://tracing",
                }
            )
        except Exception as e:  # a failed capture must answer, not hang
            self._send_json({"error": f"{type(e).__name__}: {e}"}, 500)
        finally:
            _PROFILE_LOCK.release()

    def log_message(self, format: str, *args) -> None:
        pass  # scrapes must not spam the CLI's stdout


class MetricsServer:
    def __init__(self, port: int, host: str = "127.0.0.1"):
        try:
            self._httpd = ThreadingHTTPServer((host, port), _Handler)
        except OSError as e:
            if e.errno == errno.EADDRINUSE:
                raise MetricsPortBusy(
                    f"metrics port {port} is already in use on {host} — "
                    "pass a free port, or 0 for an ephemeral one"
                ) from None
            raise
        self._httpd.daemon_threads = True
        self.host = host
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name=f"cyclonus-metrics:{self.port}",
            daemon=True,
        )
        self._thread.start()
        # with port 0 the OS picked; the log line is how users learn
        # where to curl
        logger.info("metrics server bound on %s", self.url)

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)


_ACTIVE_LOCK = threading.Lock()
_ACTIVE: dict = {"server": None}  # guarded-by: _ACTIVE_LOCK


def start_metrics_server(port: int, host: str = "127.0.0.1") -> MetricsServer:
    """Start (or return the already-running) metrics server.  One per
    process: a second call with a different port replaces nothing — the
    live server wins, matching the process-global registry it serves.
    Raises MetricsPortBusy (one clean line) when the port is taken.

    The whole check-bind-store runs under _ACTIVE_LOCK: the unguarded
    version let two racing callers both see None and each bind a server
    (the loser's socket + daemon thread leaked for the process's life,
    and with port 0 the two callers curl'd different ports)."""
    with _ACTIVE_LOCK:
        srv = _ACTIVE["server"]
        if srv is not None:
            return srv
        srv = MetricsServer(port, host)
        _ACTIVE["server"] = srv
        return srv


def active_server() -> Optional[MetricsServer]:
    with _ACTIVE_LOCK:
        return _ACTIVE["server"]


def stop_metrics_server() -> None:
    # unregister under the lock, CLOSE outside it: close() joins the
    # serve_forever thread (up to 5s), and a concurrent scrape or a
    # fresh start_metrics_server must not stall behind that join
    with _ACTIVE_LOCK:
        srv = _ACTIVE["server"]
        _ACTIVE["server"] = None
    if srv is not None:
        srv.close()
