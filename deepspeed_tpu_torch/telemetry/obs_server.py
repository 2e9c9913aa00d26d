"""Live observability plane — the HTTP scrape/status endpoint
(counterpart of ``deepspeed_tpu/telemetry/obs_server.py``), on the
stdlib :class:`http.server.ThreadingHTTPServer`:

========================  =================================================
route                     serves
========================  =================================================
``GET /metrics``          :func:`sinks.render_prometheus` over the live
                          registry
``GET /healthz``          liveness + armed-monitor inventory with
                          last-tick ages (no auth — LB probes)
``GET /readyz``           readiness: 200 once at least one monitor is
                          registered, 503 before/after
``GET /api/report/<x>``   each armed monitor's ``report()`` — its latest
                          host-side snapshot
``GET /api/events``       bounded chronicle tail, ``?since_seq=``
                          resumable (:meth:`RunChronicle.events_since`)
========================  =================================================

``identity={"rank": N}`` stamps every ``/metrics`` sample with the rank
label, :meth:`ObsServer.add_route` mounts extra routes and
:meth:`ObsServer.announce` writes the endpoint into a run-dir peer
registry (``<run_dir>/peers/peer_rank_<rank>.json``).

The contract: **a scrape never touches a tensor or synchronizes the
card**. Providers are monitor-level ``report()`` methods, host
bookkeeping only. The JAX package serves under its goodput ledger's
``suppress_attribution``; the port has no ledger yet, so the serving
loop is plain.

The serving thread and ``weakref.finalize`` hold only the stdlib server
and a :class:`_ObsState`, never the :class:`ObsServer`, so an abandoned
server is reclaimed and its port released. ``port=0`` picks a free port
(``server.url``); a failed bind raises. An optional bearer token guards
everything but the two probe routes.
"""

import json
import math
import os
import threading
import weakref
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlsplit

from deepspeed_tpu_torch.telemetry import chronicle as _chronicle
from deepspeed_tpu_torch.telemetry import clock as _clk
from deepspeed_tpu_torch.telemetry import metrics as _metrics
from deepspeed_tpu_torch.utils.logging import logger

OBS_SERVER_SCHEMA = "deepspeed_tpu.obs_server/1"

# every route the API exposes; /api/report/<name> 404s with this
# inventory so an operator's typo is self-diagnosing
ROUTES = ("/metrics", "/healthz", "/readyz", "/api/events",
          "/api/report/<name>")


def _json_sane(obj):
    """Strictly-JSON-serialisable copy: non-finite floats become strings
    (the chronicle contract), unknown objects their repr."""
    if isinstance(obj, float):
        return obj if math.isfinite(obj) else str(obj)
    if isinstance(obj, dict):
        return {str(k): _json_sane(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_json_sane(v) for v in obj]
    if obj is None or isinstance(obj, (bool, int, str)):
        return obj
    return repr(obj)


class _ObsState:
    """Everything the request handlers may touch — the server thread and
    the handlers hold ONLY this (never the ObsServer), so finalize-based
    teardown works."""

    def __init__(self, registry=None, token="", events_tail=256,
                 identity=None):
        self.registry = registry
        self.token = str(token or "")
        self.events_tail = max(1, int(events_tail))
        self.identity = dict(identity or {})
        self.lock = threading.Lock()
        self.providers = {}          # name -> report() callable
        self.age_fns = {}            # name -> seconds-since-last-tick fn
        self.routes = {}             # exact extra path -> handler fn
        self.prefix_routes = {}      # path prefix -> handler fn
        self.requests_total = 0
        self.requests_by_route = {}
        self.errors_total = 0
        self.started_us = _clk.monotonic_us()


class _Handler(BaseHTTPRequestHandler):
    # one handler class shared by every ObsServer; state rides the
    # stdlib server instance (attached in ObsServer.__init__)
    server_version = "ds-obs/1"
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):      # scrapes are not log lines
        logger.debug("[obs_server] " + fmt, *args)

    # ------------------------------------------------------------ replies
    def _reply(self, code, payload, content_type="application/json"):
        if isinstance(payload, bytes):
            body = payload
        else:
            # compact separators and a strict-dump fast path: the scrape
            # path must stay cheap under load (the serving bench pins its
            # tok/s cost), so the recursive _json_sane copy only runs when
            # the payload actually holds NaN/Inf or a non-JSON object
            try:
                body = json.dumps(payload, separators=(",", ":"),
                                  allow_nan=False).encode()
            except (ValueError, TypeError):
                body = json.dumps(_json_sane(payload),
                                  separators=(",", ":"),
                                  allow_nan=False).encode()
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        try:
            self.wfile.write(body)
        except (BrokenPipeError, ConnectionResetError):
            pass                             # scraper went away mid-write

    def _authorized(self, state):
        if not state.token:
            return True
        return (self.headers.get("Authorization", "")
                == f"Bearer {state.token}")

    # ------------------------------------------------------------- routes
    def do_GET(self):                                   # noqa: N802
        state = self.server._obs_state
        split = urlsplit(self.path)
        path = split.path.rstrip("/") or "/"
        with state.lock:
            state.requests_total += 1
            state.requests_by_route[path] = \
                state.requests_by_route.get(path, 0) + 1
        # the two probe routes skip auth: LB health checks can't carry
        # bearer headers, and they expose armed-ness, not data
        if path not in ("/healthz", "/readyz") \
                and not self._authorized(state):
            self._reply(401, {"error": "unauthorized",
                              "detail": "Authorization: Bearer <token> "
                                        "required"})
            return
        try:
            if path == "/metrics":
                self._metrics(state)
            elif path == "/healthz":
                self._healthz(state, ready=False)
            elif path == "/readyz":
                self._healthz(state, ready=True)
            elif path == "/api/events":
                self._events(state, parse_qs(split.query))
            elif path.startswith("/api/report/"):
                self._report(state, path[len("/api/report/"):])
            else:
                with state.lock:
                    fn = state.routes.get(path)
                    if fn is None:
                        for pref, pfn in state.prefix_routes.items():
                            if path.startswith(pref):
                                fn = pfn
                                break
                    extra = sorted(state.routes) + [
                        p + "<...>" for p in sorted(state.prefix_routes)]
                if fn is not None:
                    self._extra(fn, path, parse_qs(split.query))
                else:
                    self._reply(404, {"error": "unknown route",
                                      "routes": list(ROUTES) + extra})
        except Exception as e:   # a broken provider must not kill serving
            with state.lock:
                state.errors_total += 1
            logger.warning("[obs_server] %s failed: %s", path, e)
            try:
                self._reply(500, {"error": f"{type(e).__name__}: {e}"})
            except Exception:
                pass

    def _extra(self, fn, path, query):
        """Dispatch one registered extra route (the federation hook).
        The handler returns either a JSON payload (200) or a
        ``(code, payload, content_type)`` tuple for full control."""
        out = fn(path, query)
        if isinstance(out, tuple):
            code, payload, ctype = out
            self._reply(code, payload, content_type=ctype)
        else:
            self._reply(200, out)

    def _metrics(self, state):
        from deepspeed_tpu_torch.telemetry.sinks import render_prometheus
        reg = state.registry if state.registry is not None \
            else _metrics.get_registry()
        # identity labels ride EVERY family so a federated aggregator's
        # merge needs no exposition re-parse (fleet satellite 2)
        self._reply(200, render_prometheus(
            reg, extra_labels=state.identity or None).encode(),
            content_type="text/plain; version=0.0.4")

    def _healthz(self, state, ready):
        with state.lock:
            names = sorted(state.providers)
            age_fns = dict(state.age_fns)
        monitors = {}
        for n in names:
            age_fn = age_fns.get(n)
            age = None
            if age_fn is not None:
                try:
                    age = age_fn()
                except Exception:
                    age = None
            monitors[n] = {"armed": True, "last_tick_age_s": age}
        doc = {
            "status": "ok",
            "ready": bool(names),
            "uptime_s": round(
                (_clk.monotonic_us() - state.started_us) / 1e6, 3),
            "monitors": monitors,
            "requests_total": state.requests_total,
        }
        if ready and not names:
            self._reply(503, dict(doc, status="no monitors registered"))
        else:
            self._reply(200, doc)

    def _report(self, state, name):
        with state.lock:
            fn = state.providers.get(name)
            known = sorted(state.providers)
        if fn is None:
            self._reply(404, {"error": f"unknown report {name!r}",
                              "known": known})
            return
        self._reply(200, fn())

    def _events(self, state, query):
        chron = _chronicle.get_chronicle()
        if not chron.enabled:
            self._reply(200, {"enabled": False, "events": [],
                              "last_seq": -1})
            return
        try:
            since = int(query.get("since_seq", ["-1"])[0])
            limit = int(query.get("limit", [state.events_tail])[0])
        except (TypeError, ValueError):
            self._reply(400, {"error": "since_seq/limit must be ints"})
            return
        limit = max(1, min(limit, state.events_tail))
        # events_since falls back to the on-disk JSONL stream when the
        # bounded ring has drop-NEW'd part of the requested range — a
        # resumed consumer gets the FULL tail, not a silent gap
        events = chron.events_since(since)
        truncated = len(events) > limit
        # ?oldest=1 pages forward from the cursor (gapless catch-up —
        # the federation scraper's mode); the default keeps the
        # dashboard-friendly newest-tail view
        oldest = (query.get("oldest", ["0"])[0] in ("1", "true"))
        events = events[:limit] if oldest else events[-limit:]
        self._reply(200, {
            "enabled": True,
            "events": events,
            "n": len(events),
            "truncated": truncated,
            "last_seq": events[-1]["seq"] if events else since,
            "dropped": chron.dropped,
        })


def _serve_loop(httpd):
    httpd.serve_forever(poll_interval=0.2)


def _finalize_server(httpd, thread):
    try:
        httpd.shutdown()
    except Exception:
        pass
    if thread.is_alive():
        thread.join(timeout=5.0)
    try:
        httpd.server_close()
    except Exception:
        pass


class ObsServer:
    """The live observability endpoint. Construction binds the socket
    and starts the serving thread; ``close()`` (idempotent — also run by
    ``weakref.finalize`` on abandonment) releases the port.

    ``register(name, report_fn, age_s_fn=None)`` arms one monitor on the
    status API: *report_fn* must be the monitor-level ``report()`` bound
    method (host-side snapshot — the no-device-fetch contract above),
    *age_s_fn* an optional seconds-since-last-tick probe for /healthz.
    """

    def __init__(self, registry=None, host="127.0.0.1", port=0,
                 token="", events_tail=256, identity=None, log_fn=None):
        self._log = log_fn or logger.warning
        self._state = _ObsState(registry=registry, token=token,
                                events_tail=events_tail,
                                identity=identity)
        self._httpd = ThreadingHTTPServer((host, int(port)), _Handler)
        self._httpd.daemon_threads = True
        self._httpd._obs_state = self._state
        self.host, self.port = self._httpd.server_address[:2]
        self._thread = threading.Thread(
            target=_serve_loop, args=(self._httpd,),
            name=f"ds-obs-server-{self.port}", daemon=True)
        self._thread.start()
        self._closed = False
        self._finalizer = weakref.finalize(
            self, _finalize_server, self._httpd, self._thread)

    @classmethod
    def from_config(cls, tcfg, registry=None, identity=None):
        """Build from a parsed :class:`DeepSpeedTelemetryConfig`
        (``telemetry.server`` block)."""
        return cls(registry=registry, host=tcfg.server_host,
                   port=tcfg.server_port, token=tcfg.server_token,
                   events_tail=tcfg.server_events_tail,
                   identity=identity)

    @property
    def url(self):
        return f"http://{self.host}:{self.port}"

    # --------------------------------------------------------- providers
    def register(self, name, report_fn, age_s_fn=None):
        with self._state.lock:
            self._state.providers[str(name)] = report_fn
            if age_s_fn is not None:
                self._state.age_fns[str(name)] = age_s_fn
        return self

    def unregister(self, name):
        with self._state.lock:
            self._state.providers.pop(name, None)
            self._state.age_fns.pop(name, None)

    def add_route(self, path, handler, prefix=False):
        """Mount *handler* at *path* (exact, or every path under it when
        ``prefix=True``; the JAX package's fleet aggregator mounts its
        merged views this way). *handler* is called as ``handler(path,
        query)`` (query already ``parse_qs``-parsed) and returns a JSON
        payload (200) or a ``(code, payload, content_type)`` tuple; it
        runs on the serving thread, so the no-device-fetch scrape
        contract applies to it too."""
        with self._state.lock:
            if prefix:
                self._state.prefix_routes[str(path)] = handler
            else:
                self._state.routes[str(path)] = handler
        return self

    def announce(self, run_dir, rank=0, job_name="", extra=None):
        """Write this endpoint into the run-dir peer registry
        (``<run_dir>/peers/peer_rank_<rank>.json``, tmp+fsync+rename) so
        a fleet aggregator scanning the shared run dir discovers the
        rank without static config. Returns
        the registry path (None on write failure — announcing is
        forensics, never fatal)."""
        doc = {"url": self.url, "rank": int(rank),
               "job_name": job_name, "pid": os.getpid(),
               "started_unix_us": _clk.to_unix_us(
                   self._state.started_us)}
        if extra:
            doc.update(extra)
        path = os.path.join(run_dir, "peers",
                            f"peer_rank_{int(rank):05d}.json")
        try:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            _chronicle._atomic_write_bytes(
                path, json.dumps(doc, sort_keys=True,
                                 allow_nan=False).encode())
        except OSError as e:
            self._log("[obs_server] peer announce failed: %s", e)
            return None
        return path

    def providers(self):
        with self._state.lock:
            return sorted(self._state.providers)

    # ------------------------------------------------------------ report
    def report(self):
        st = self._state
        with st.lock:
            by_route = dict(st.requests_by_route)
            extra_routes = sorted(st.routes) + sorted(st.prefix_routes)
        return {
            "schema": OBS_SERVER_SCHEMA,
            "enabled": True,
            "closed": self._closed,
            "url": self.url,
            "host": self.host,
            "port": self.port,
            "auth": bool(st.token),
            "events_tail": st.events_tail,
            "identity": dict(st.identity),
            "extra_routes": extra_routes,
            "providers": self.providers(),
            "requests_total": st.requests_total,
            "requests_by_route": by_route,
            "errors_total": st.errors_total,
            "uptime_s": round(
                (_clk.monotonic_us() - st.started_us) / 1e6, 3),
        }

    def close(self):
        """Stop serving, join the thread, release the port. Idempotent."""
        if self._closed:
            return
        self._closed = True
        self._finalizer()


# Process-global handle (the tracer/registry/chronicle pattern): the
# armed server and its bound address, reachable without an engine.
_GLOBAL = None


def get_obs_server():
    return _GLOBAL


def set_obs_server(server):
    """Install *server* as the process global; returns the old one."""
    global _GLOBAL
    old, _GLOBAL = _GLOBAL, server
    return old


def reset_obs_server(if_current=None):
    global _GLOBAL
    if if_current is None or _GLOBAL is if_current:
        _GLOBAL = None
