"""Introspection endpoint: /metrics, /healthz, /debug/* over stdlib http.

Ported as it is from ``mxnet_tpu/telemetry/httpd.py``. With the flight
recorder, the SLO engine and request traces in-process, a fleet needs
ONE sanctioned way to read them from outside. This daemon serves:

========================  ==================================================
path                      payload
========================  ==================================================
``/metrics``              :func:`~mxnet_tpu_torch.telemetry.render_prometheus`
                          text exposition (scrape target)
``/healthz``              JSON: ok/degraded, per-site breaker states, the
                          SLO engine's currently-firing alerts (an LB or
                          k8s probe reads the status code: 200 ok, 503
                          degraded)
``/debug/state``          JSON: full registry snapshot + flight-recorder
                          tail + active alerts (the live black box) +
                          any views upper layers registered via
                          :func:`register_debug_view` (the serving fleet
                          publishes a ``fleet`` key: per-replica breaker
                          state, queue depth, pages in use, last scale
                          event)
``/debug/trace/<id>``     one request trace's typed event chain
                          (:func:`~mxnet_tpu_torch.telemetry.tracing.get_trace`)
``/debug/traces``         retained trace ids
``/debug/<view>``         any single registered debug view standalone —
                          ``/debug/perf`` is devprof's device-time
                          attribution summary; ``/debug/hbm`` the pressure
                          governor's; ``/debug/fleet`` the serving fleet's
========================  ==================================================

Security: the endpoint is **unauthenticated introspection** — metrics,
breaker states, trace timing, event kinds. It deliberately binds
``MXNET_METRICS_ADDR`` = ``127.0.0.1`` by default; exposing it beyond
localhost is an explicit operator decision (front it with your mesh's
authn like any other debug port). Request *content* never enters
telemetry (labels are registry-bounded; traces carry sizes and verdicts,
not prompts), so the blast radius of exposure is timing metadata, but
the default still refuses the network.

``MXNET_METRICS_PORT`` > 0 starts the daemon at telemetry import (port 0
= off, the default); embedders call :func:`start_httpd` explicitly
(``port=0`` picks an ephemeral port — tests).
"""
from __future__ import annotations

import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional

from ..base import get_env
from . import exporters as _exporters
from . import flightrec as _flightrec
from . import slo as _slo
from . import tracing as _tracing

__all__ = ["start_httpd", "stop_httpd", "httpd_address",
           "register_debug_view", "unregister_debug_view"]

_LOG = logging.getLogger(__name__)

# extra top-level keys on /debug/state, registered by upper layers the
# telemetry package must not import (the serving fleet registers its
# per-replica view here) — each provider is a zero-arg callable returning
# a JSON-serializable document, evaluated per request and exception-
# isolated so a broken provider degrades to an error string, never a 500
_VIEWS_LOCK = threading.Lock()
_DEBUG_VIEWS: Dict[str, Callable[[], object]] = {}


def register_debug_view(name: str, provider: Callable[[], object]) -> None:
    """Attach ``provider()``'s result as the ``name`` key of every
    ``/debug/state`` reply (last registration per name wins)."""
    with _VIEWS_LOCK:
        _DEBUG_VIEWS[str(name)] = provider


def unregister_debug_view(name: str) -> None:
    with _VIEWS_LOCK:
        _DEBUG_VIEWS.pop(str(name), None)


def _debug_views() -> Dict[str, object]:
    with _VIEWS_LOCK:
        views = list(_DEBUG_VIEWS.items())
    out: Dict[str, object] = {}
    for name, provider in views:
        try:
            out[name] = provider()
        except Exception as exc:  # noqa: BLE001 - a debug view must never
            # take /debug/state down with it: the OTHER views are exactly
            # what a post-mortem needs when one subsystem is wedged
            out[name] = {"error": repr(exc)}
    return out


class _Handler(BaseHTTPRequestHandler):
    server_version = "mxnet-tpu-torch-telemetry"

    def log_message(self, format, *args):  # noqa: A002 - stdlib signature
        pass  # introspection must not spam the serving process's stderr

    def _send(self, code: int, body: bytes, ctype: str):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _json(self, code: int, doc) -> None:
        self._send(code, json.dumps(doc, default=repr).encode(),
                   "application/json")

    def do_GET(self):  # noqa: N802 - stdlib contract
        try:
            self._route()
        except BrokenPipeError:  # pragma: no cover - client went away
            pass
        except Exception as exc:  # noqa: BLE001 - a debug endpoint must
            # answer, never take the serving process down with it
            try:
                self._json(500, {"error": repr(exc)})
            except Exception:  # noqa: BLE001 - socket already dead
                _LOG.debug("introspection reply failed after %r", exc)

    def _route(self):
        path = self.path.split("?", 1)[0].rstrip("/") or "/"
        if path == "/metrics":
            self._send(200, _exporters.render_prometheus().encode(),
                       "text/plain; version=0.0.4")
        elif path == "/healthz":
            doc = self._healthz()
            self._json(200 if doc["status"] == "ok" else 503, doc)
        elif path == "/debug/state":
            doc = {
                "snapshot": _exporters.snapshot(),
                "flightrec": _flightrec.tail(200),
                "flightrec_last_dump": _flightrec.last_dump_path(),
                "alerts": _slo.active_alerts(),
            }
            doc.update(_debug_views())
            self._json(200, doc)
        elif path == "/debug/traces":
            self._json(200, {"trace_ids": _tracing.trace_ids()})
        elif path.startswith("/debug/trace/"):
            trace = _tracing.get_trace(path[len("/debug/trace/"):])
            if trace is None:
                self._json(404, {"error": "unknown or evicted trace id"})
            else:
                self._json(200, trace)
        elif path.startswith("/debug/"):
            # any registered debug view standalone: /debug/perf serves
            # devprof's attribution summary without
            # the full /debug/state payload around it (same exception
            # isolation — the provider's error renders, never a 500)
            name = path[len("/debug/"):]
            with _VIEWS_LOCK:
                provider = _DEBUG_VIEWS.get(name)
            if provider is None:
                with _VIEWS_LOCK:
                    known = sorted(_DEBUG_VIEWS)
                self._json(404, {"error": "unknown debug view",
                                 "views": known})
            else:
                try:
                    self._json(200, provider())
                except Exception as exc:  # noqa: BLE001 - see _debug_views
                    self._json(200, {"error": repr(exc)})
        else:
            self._json(404, {"error": "unknown path",
                             "paths": ["/metrics", "/healthz",
                                       "/debug/state", "/debug/traces",
                                       "/debug/trace/<id>",
                                       "/debug/<view>"]})

    @staticmethod
    def _healthz() -> dict:
        breakers = {}
        try:
            from ..resilience import breaker as _breaker

            breakers = _breaker.snapshot()
        except Exception:  # noqa: BLE001 - resilience may not be loaded
            _LOG.debug("breaker snapshot unavailable", exc_info=True)
        alerts = _slo.evaluate()
        paging = [a for a in alerts if a["level"] == "page"]
        open_breakers = {s: st for s, st in breakers.items()
                         if st == "open"}
        pressure = None
        try:
            from ..resilience import hbm as _hbm

            pressure = _hbm.governor().healthz_view()
        except Exception:  # noqa: BLE001 - resilience may not be loaded
            _LOG.debug("hbm governor unavailable", exc_info=True)
        # Governor red == new admissions stopped: the load balancer
        # must route around this replica even if no SLO alert has
        # sampled the tier gauge yet this cadence.
        red = bool(pressure) and (pressure.get("tier") == "red"
                                  or pressure.get("latched"))
        status = ("ok" if not paging and not open_breakers and not red
                  else "degraded")
        doc = {"status": status, "breakers": breakers,
               "alerts": alerts,
               "open_breakers": sorted(open_breakers)}
        if pressure is not None:
            doc["pressure"] = pressure
        return doc


_LOCK = threading.Lock()
_SERVER: Optional[ThreadingHTTPServer] = None
_THREAD: Optional[threading.Thread] = None


def start_httpd(port: Optional[int] = None,
                addr: Optional[str] = None) -> Optional[ThreadingHTTPServer]:
    """Start (or return the running) introspection daemon.

    ``port`` defaults to ``MXNET_METRICS_PORT`` (unset/non-positive = no
    daemon, returns None — except an explicit ``port=0`` argument, which
    binds an ephemeral port for tests). ``addr`` defaults to
    ``MXNET_METRICS_ADDR`` (127.0.0.1 — see the security note above).
    Idempotent: one daemon per process.
    """
    global _SERVER, _THREAD
    explicit_ephemeral = port == 0
    if port is None:
        port = get_env("MXNET_METRICS_PORT", 0, int, cache=False)
    if port <= 0 and not explicit_ephemeral:
        return None
    if addr is None:
        addr = get_env("MXNET_METRICS_ADDR", "127.0.0.1", str, cache=False)
    with _LOCK:
        if _SERVER is not None:
            return _SERVER
        server = ThreadingHTTPServer((addr, max(0, int(port))), _Handler)
        server.daemon_threads = True
        thread = threading.Thread(target=server.serve_forever,
                                  name="mxnet-telemetry-httpd",
                                  daemon=True)
        thread.start()
        _SERVER, _THREAD = server, thread
        return server


def stop_httpd() -> None:
    global _SERVER, _THREAD
    with _LOCK:
        server, thread = _SERVER, _THREAD
        _SERVER = _THREAD = None
    if server is not None:
        server.shutdown()
        server.server_close()
    if thread is not None:
        thread.join(1.0)


def httpd_address() -> Optional[tuple]:
    """(host, port) of the running daemon, or None."""
    with _LOCK:
        return _SERVER.server_address if _SERVER is not None else None
