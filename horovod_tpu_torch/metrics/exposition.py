"""Prometheus text exposition + per-worker HTTP endpoint.

Copied from ``horovod_tpu/metrics/exposition.py`` (stdlib only), serving the
port's own registry.


Renders a :class:`~horovod_tpu.metrics.registry.MetricsRegistry` in the
Prometheus text format (version 0.0.4) and serves it from a tiny
stdlib-only ``http.server`` endpoint per worker:

  * ``GET /metrics``  — the registry, Prometheus text format;
  * ``GET /healthz``  — JSON health summary reflecting the registered
    health sources (stall inspector, background-loop liveness, elastic
    membership state); HTTP 200 when healthy, 503 otherwise.

The endpoint is OFF by default.  ``HVD_TPU_METRICS_PORT`` enables it:

  * unset / empty / negative — disabled (no socket is ever bound);
  * ``0``                    — bind an ephemeral port (tests, one-offs;
    read the chosen port back from ``server.port``);
  * ``N > 0``                — bind port ``N + local_rank`` (every worker
    process on a host needs its own port; rank offsetting mirrors how
    the launcher offsets per-worker service ports).

Health sources follow the same registration shape as metrics: any
subsystem calls :func:`register_health_source` with a callable returning
``(healthy: bool, details: dict)``; ``/healthz`` aggregates them.
"""

from __future__ import annotations

import json
import math
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional, Tuple
from urllib.parse import unquote

from ..utils.logging import get_logger
from .registry import REGISTRY, Histogram, MetricsRegistry

__all__ = [
    "render", "start_http_server", "stop_http_server", "http_server",
    "maybe_start_from_env", "register_health_source",
    "unregister_health_source", "health_snapshot", "ENV_METRICS_PORT",
    "ENV_METRICS_BIND", "register_control_handler",
    "unregister_control_handler",
]

ENV_METRICS_PORT = "HVD_TPU_METRICS_PORT"
# bind address for the endpoint; default "" = all interfaces (the usual
# Prometheus-exporter convention).  Set 127.0.0.1 on multi-tenant hosts.
ENV_METRICS_BIND = "HVD_TPU_METRICS_BIND"

CONTENT_TYPE_LATEST = "text/plain; version=0.0.4; charset=utf-8"


# -- text format -------------------------------------------------------------


def _fmt_value(v: float) -> str:
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if math.isnan(v):
        return "NaN"
    if float(v) == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _escape_label(v: str) -> str:
    return v.replace("\\", r"\\").replace("\n", r"\n").replace('"', r'\"')


def _escape_help(v: str) -> str:
    return v.replace("\\", r"\\").replace("\n", r"\n")


def _labels_str(names: Tuple[str, ...], values: Tuple[str, ...],
                extra: Tuple[Tuple[str, str], ...] = ()) -> str:
    pairs = [
        f'{n}="{_escape_label(v)}"' for n, v in zip(names, values)
    ] + [f'{n}="{_escape_label(v)}"' for n, v in extra]
    return "{" + ",".join(pairs) + "}" if pairs else ""


def render(registry: MetricsRegistry = REGISTRY) -> str:
    """Render the registry in the Prometheus text format 0.0.4."""
    out = []
    for metric in registry.collect():
        out.append(f"# HELP {metric.name} "
                   f"{_escape_help(metric.documentation)}")
        out.append(f"# TYPE {metric.name} {metric.kind}")
        if isinstance(metric, Histogram):
            for labelvalues, state in metric.samples():
                cumulative = 0
                for bound, n in zip(metric.bucket_bounds,
                                    state["buckets"]):
                    cumulative += n
                    ls = _labels_str(metric.labelnames, labelvalues,
                                     (("le", _fmt_value(bound)),))
                    out.append(
                        f"{metric.name}_bucket{ls} {cumulative}"
                    )
                cumulative += state["buckets"][-1]
                ls = _labels_str(metric.labelnames, labelvalues,
                                 (("le", "+Inf"),))
                out.append(f"{metric.name}_bucket{ls} {cumulative}")
                ls = _labels_str(metric.labelnames, labelvalues)
                out.append(
                    f"{metric.name}_sum{ls} {_fmt_value(state['sum'])}"
                )
                out.append(f"{metric.name}_count{ls} {state['count']}")
        else:
            # counters carry their conventional _total suffix in their
            # declared name (text format 0.0.4 exposes it verbatim)
            for labelvalues, value in metric.samples():
                ls = _labels_str(metric.labelnames, labelvalues)
                out.append(f"{metric.name}{ls} {_fmt_value(value)}")
    return "\n".join(out) + "\n" if out else ""


# -- health sources ----------------------------------------------------------

_health_lock = threading.Lock()
_health_sources: Dict[str, Callable[[], Tuple[bool, dict]]] = {}


def register_health_source(name: str,
                           fn: Callable[[], Tuple[bool, dict]]) -> None:
    """Register a health contributor.  ``fn`` returns ``(healthy,
    details)``; it is called on every ``/healthz`` request, so it must be
    cheap and must not block (poll counters, don't take slow locks)."""
    with _health_lock:
        _health_sources[name] = fn


def unregister_health_source(name: str) -> None:
    with _health_lock:
        _health_sources.pop(name, None)


def health_snapshot() -> Tuple[bool, dict]:
    """Aggregate every registered health source: overall AND of the
    per-source verdicts plus their detail dicts."""
    with _health_lock:
        sources = dict(_health_sources)
    healthy = True
    details: dict = {}
    for name, fn in sorted(sources.items()):
        try:
            ok, d = fn()
        except Exception as e:
            ok, d = False, {"error": f"{type(e).__name__}: {e}"}
        healthy = healthy and bool(ok)
        details[name] = {"healthy": bool(ok), **d}
    return healthy, details


# -- control handlers --------------------------------------------------------

_control_lock = threading.Lock()
_control_handlers: Dict[str, Callable[[Dict[str, str]], Tuple[int, dict]]] \
    = {}


def register_control_handler(name: str,
                             fn: Callable[[Dict[str, str]],
                                          Tuple[int, dict]],
                             ) -> None:
    """Mount a small control surface at ``GET /control/<name>`` on the
    worker's endpoint (the same registration shape as health sources).
    ``fn`` receives the parsed query parameters and returns
    ``(http_status, json_dict)``; it must be cheap and thread-safe —
    it runs on the scrape server's threads.  First user: the fleet
    autoscaler's runtime-settable SLO targets
    (``/control/fleet/targets``, docs/FLEET.md)."""
    with _control_lock:
        _control_handlers[name] = fn


def unregister_control_handler(name: str) -> None:
    with _control_lock:
        _control_handlers.pop(name, None)


# -- HTTP endpoint -----------------------------------------------------------


def _deny_remote(client_ip: str) -> bool:
    """The control-surface rule: the scrape surface (/metrics,
    /healthz) is read-only and serves anyone, but mutating or verbose
    surfaces (/control/*, /trace) answer loopback peers only unless
    ``HVD_TPU_CONTROL_REMOTE=1`` opts remote callers in (put a real
    proxy in front then).  Factored out so the gate is unit-testable
    with arbitrary client addresses."""
    return (not client_ip.startswith("127.") and client_ip != "::1"
            and os.environ.get("HVD_TPU_CONTROL_REMOTE", "") != "1")


class _Handler(BaseHTTPRequestHandler):
    registry: MetricsRegistry = REGISTRY

    def do_GET(self):  # noqa: N802 (stdlib handler signature)
        path = self.path.split("?", 1)[0]
        if path in ("/metrics", "/metrics/"):
            body = render(self.registry).encode()
            self._reply(200, CONTENT_TYPE_LATEST, body)
        elif path in ("/healthz", "/health", "/healthz/"):
            healthy, details = health_snapshot()
            body = json.dumps(
                {"status": "ok" if healthy else "unhealthy",
                 "sources": details},
                sort_keys=True,
            ).encode()
            self._reply(200 if healthy else 503, "application/json", body)
        elif path.startswith("/control/") or path in ("/trace", "/trace/"):
            if _deny_remote(self.client_address[0]):
                self._reply(403, "text/plain",
                            b"control surface is loopback-only "
                            b"(HVD_TPU_CONTROL_REMOTE=1 opts in)\n")
                return
            if path.startswith("/control/"):
                name = path[len("/control/"):].rstrip("/")
            else:
                # /trace is the span-recorder export (docs/TRACING.md),
                # mounted through the same control-handler registry
                name = "trace"
            with _control_lock:
                fn = _control_handlers.get(name)
            if fn is None:
                self._reply(404, "text/plain", b"no such control\n")
                return
            query = self.path.split("?", 1)[1] if "?" in self.path else ""
            params = {}
            for pair in query.split("&"):
                if "=" in pair:
                    k, v = pair.split("=", 1)
                    params[unquote(k)] = unquote(v)
            try:
                code, payload = fn(params)
            except Exception as e:
                code, payload = 400, {"error": f"{type(e).__name__}: {e}"}
            self._reply(code, "application/json",
                        json.dumps(payload, sort_keys=True).encode())
        elif path == "/":
            # advertise /trace only where its handler is mounted (a
            # process that never ran trace install would 404 the link)
            with _control_lock:
                has_trace = "trace" in _control_handlers
            body = (b'<html><body><a href="/metrics">/metrics</a> '
                    b'<a href="/healthz">/healthz</a>'
                    + (b' <a href="/trace">/trace</a>' if has_trace
                       else b'')
                    + b'</body></html>')
            self._reply(200, "text/html", body)
        else:
            self._reply(404, "text/plain", b"not found\n")

    def _reply(self, code: int, ctype: str, body: bytes) -> None:
        try:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        except (BrokenPipeError, ConnectionResetError):
            pass  # scraper went away mid-reply

    def log_message(self, fmt, *args):  # silence per-request stderr spam
        pass


class MetricsHTTPServer:
    """One worker's scrape endpoint: a ThreadingHTTPServer on a daemon
    thread (scrapes never touch the training thread)."""

    def __init__(self, port: int, addr: str = "",
                 registry: MetricsRegistry = REGISTRY):
        handler = type("_BoundHandler", (_Handler,),
                       {"registry": registry})
        self._httpd = ThreadingHTTPServer((addr, port), handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, kwargs={"poll_interval": 0.5},
            name="hvd_tpu_metrics_http", daemon=True,
        )
        self._thread.start()

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)


_server_lock = threading.Lock()
_server: Optional[MetricsHTTPServer] = None


def http_server() -> Optional[MetricsHTTPServer]:
    """The process's running endpoint, or None when disabled."""
    return _server


def start_http_server(port: int, addr: str = "",
                      registry: MetricsRegistry = REGISTRY,
                      ) -> MetricsHTTPServer:
    """Start (or return the already-running) endpoint.  ``port=0`` binds
    an ephemeral port; read it back from ``.port``."""
    global _server
    with _server_lock:
        if _server is None:
            _server = MetricsHTTPServer(port, addr, registry)
            get_logger().info(
                "metrics: /metrics + /healthz on port %d", _server.port
            )
        return _server


def stop_http_server() -> None:
    global _server
    with _server_lock:
        srv, _server = _server, None
    if srv is not None:
        srv.close()


def maybe_start_from_env(local_rank: int = 0,
                         registry: MetricsRegistry = REGISTRY,
                         env_var: str = ENV_METRICS_PORT,
                         ) -> Optional[MetricsHTTPServer]:
    """Init-time hook: start the endpoint iff ``env_var`` (default
    ``HVD_TPU_METRICS_PORT``) opts in (see module docstring for the port
    convention).  Never raises — an unbindable port logs a warning and
    leaves metrics collection (which is independent of exposition) fully
    functional.  The elastic driver passes its own ``env_var`` because it
    shares a host with worker 0."""
    raw = os.environ.get(env_var, "").strip()
    if not raw:
        return None
    try:
        base = int(raw)
    except ValueError:
        get_logger().warning(
            "metrics: ignoring non-integer %s=%r", env_var, raw
        )
        return None
    if base < 0:
        return None
    port = base + local_rank if base > 0 else 0
    if port > 65535:
        get_logger().warning(
            "metrics: %s=%d + local_rank %d exceeds 65535; endpoint "
            "disabled", env_var, base, local_rank,
        )
        return None
    try:
        return start_http_server(
            port, addr=os.environ.get(ENV_METRICS_BIND, ""),
            registry=registry,
        )
    except (OSError, OverflowError) as e:
        get_logger().warning(
            "metrics: cannot bind port %d (%s); endpoint disabled",
            port, e,
        )
        return None
