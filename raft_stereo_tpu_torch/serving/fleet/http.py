"""HTTP front end of the fleet router — the one address clients use.

The request surface is the replica surface (serving/http.py): ``POST
/v1/disparity`` and ``POST|DELETE /v1/stream/<id>`` forward verbatim —
body bytes, query string, ``X-*`` headers, typed error bodies and all —
to the replica the router picks, so a client cannot tell the router from
a single engine (the pass-through-parity contract tests/test_fleet.py
pins byte-for-byte).  On top of that the router adds its own fleet-level
surface:

* ``GET /healthz`` — router liveness + per-replica rotation summary.
* ``GET /readyz`` — 200 once at least one replica is in rotation (the
  fleet can answer SOMETHING), 503 otherwise; orchestrators point
  traffic here.
* ``GET /metrics`` — the router's own Prometheus registry
  (``fleet_replicas_ready``, ``fleet_failovers_total``,
  ``fleet_sessions_lost_total``, routing-decision counters).
* ``GET /fleet`` — full JSON status: replica states, ring membership,
  session ledger sizes, brownout level, rollout policy, recent
  transitions.
* ``GET|POST /admin/rollout`` — the canary/shadow rollout policy
  (fleet/rollout.py): ``{"action": "set", "model": "name@version",
  "fraction": F, "shadow_fraction": S}`` arms a deterministic traffic
  split onto a registered canary version; ``{"action": "clear"}``
  disarms; GET returns the live status (fractions, shadow-EPE window,
  demotion state).
* ``GET /metrics/fleet`` — the federated exposition (fleet/federation.py):
  the router's own registry plus every replica's last-scraped series
  re-labelled ``replica="<name>"``, with per-replica up/staleness
  gauges.  Cache-only on this path — the background poller does the
  scraping, so a dead replica can never hang a federation request.
* ``GET /debug/spans?trace=<id>`` — the FEDERATED trace view: the
  router's own spans for that id merged with every replica's
  (``route.request`` parent, ``serve.request`` child — the whole
  cross-process story under one trace id).  Without ``?trace=`` the
  router's own ring renders as Chrome trace JSON, and ``/debug/stacks``
  + ``/debug/flightrecorder`` expose the router process itself — the
  same per-process debug surface replicas carry.

When router-side tracing is on (``--trace_sample_rate``), sampled
requests answer with ``X-Trace-Id`` — including the router-originated
error responses below, so a client quoting a failure quotes the id that
finds it.  At the default rate 0 no header is added anywhere and
forwarding stays byte-verbatim.

Fleet-level typed errors (these are the ONLY responses the router
originates on the request path):

* 503 ``{"error": "no_replicas_ready"}`` + ``Retry-After`` — every
  replica is dead, warming, or draining (stateless retries exhausted).
* 410 ``{"error": "session_lost", "replica": ...}`` — this session's
  replica left the rotation; its warm-start chain is unrecoverable.
  Fired once per session: the client's next frame reseeds cold on a
  surviving replica (the r14 410 contract, fleet-wide).

Both count toward the SLO error totals (router.slo_errors) — fleet-typed
failures burn error budget exactly like replica-side ones.
"""

from __future__ import annotations

import json
import logging
import math
import random
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional, Tuple
from urllib.parse import parse_qs, urlparse

from raft_stereo_tpu_torch.serving.fleet.router import (FleetRouter,
                                                  NoReplicasAvailable,
                                                  SessionLost,
                                                  XlUnavailable)
from raft_stereo_tpu_torch.serving.http import MAX_BODY_BYTES, _stream_session_id
from raft_stereo_tpu_torch.telemetry.http import (handle_debug_get,
                                            handle_debug_post)

log = logging.getLogger(__name__)


def retry_after_jittered(base_s: float = 1.0) -> Tuple[float, str]:
    """A jittered retry hint for the router's 503s: ``(retry_after_s,
    header_value)``.  The body carries the precise float in
    [0.5*base, 1.5*base]; the Retry-After header (integer seconds per
    RFC 9110) rounds UP so header-only clients never retry early.  The
    spread exists so N clients that all hit the same no-capacity window
    do not re-arrive in lockstep and recreate it (the r13 typed-overload
    contract, plus thundering-herd dispersion)."""
    retry_s = round(random.uniform(0.5 * base_s, 1.5 * base_s), 2)
    return retry_s, str(max(1, math.ceil(retry_s)))


def make_router_handler(router: FleetRouter):
    """Handler class closed over the router (instantiated per request by
    the server, like serving/http.py's)."""

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        # Under the pooled server a keep-alive connection occupies one
        # worker until it closes; an idle read past this bound drops the
        # connection (handle_one_request treats the socket timeout as
        # close_connection) so parked clients cannot starve the pool.
        timeout = 30.0

        def log_message(self, fmt, *args):
            log.debug("%s " + fmt, self.client_address[0], *args)

        # ------------------------------------------------------- responses
        def _reply(self, code: int, body: bytes, content_type: str,
                   extra_headers=()):
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            for k, v in extra_headers:
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _reply_json(self, code: int, obj, extra_headers=()):
            self._reply(code, (json.dumps(obj) + "\n").encode(),
                        "application/json", extra_headers)

        def _reply_forwarded(self, status: int,
                             headers: List[Tuple[str, str]],
                             body: bytes):
            """Relay a replica response verbatim: the replica's own
            header set (hop-by-hop stripped by Replica.forward) plus a
            recomputed Content-Length — no router fingerprints on the
            pass-through path."""
            self.send_response(status)
            have_length = False
            for k, v in headers:
                if k.lower() == "content-length":
                    have_length = True
                self.send_header(k, v)
            if not have_length:
                self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        # ---------------------------------------------------------- routes
        def _forward(self, method: str, body: Optional[bytes]):
            url = urlparse(self.path)
            path_qs = url.path + (f"?{url.query}" if url.query else "")
            headers = list(self.headers.items())
            session_id = _stream_session_id(url.path, self.headers)
            if session_id == "":
                self._reply_json(400, {
                    "error": "stream requests need a session "
                             "id: /v1/stream/<id> or "
                             "X-Session-Id"})
                return
            # Sampling decision for the whole routed request; at the
            # default rate 0 this is None in constant time and nothing
            # below adds a span or touches a header.
            trace = router.tracer.start_trace(
                "route.request", method=method, path=url.path,
                **({"session": session_id} if session_id else {}))
            trace_hdrs = ([("X-Trace-Id", trace.trace_id)]
                          if trace is not None else [])
            t0 = time.perf_counter()
            status_out: Optional[int] = None
            try:
                try:
                    if session_id is not None:
                        status, h, payload = router.forward_session(
                            session_id, method, path_qs, body, headers,
                            trace=trace)
                    else:
                        status, h, payload = router.forward_stateless(
                            method, path_qs, body, headers, trace=trace)
                except SessionLost as e:
                    status_out = 410
                    self._reply_json(410, {
                        "error": "session_lost",
                        "session_id": e.session_id,
                        "replica": e.replica,
                        "detail": str(e)},
                        extra_headers=trace_hdrs)
                    return
                except XlUnavailable as e:
                    status_out = 503
                    retry_s, header = retry_after_jittered()
                    self._reply_json(
                        503, {"error": "xl_unavailable",
                              "capable_replicas": e.capable_ready,
                              "capable_total": e.capable_total,
                              "retry_after_s": retry_s,
                              "detail": str(e)},
                        extra_headers=[("Retry-After", header)]
                        + trace_hdrs)
                    return
                except NoReplicasAvailable as e:
                    # The r13 typed-overload contract at fleet level:
                    # the machine-readable body plus a JITTERED
                    # Retry-After so synchronized clients do not retry
                    # in lockstep.
                    status_out = 503
                    retry_s, header = retry_after_jittered()
                    self._reply_json(
                        503, {"error": "no_replicas_ready",
                              "retry_after_s": retry_s,
                              "detail": str(e)},
                        extra_headers=[("Retry-After", header)]
                        + trace_hdrs)
                    return
                status_out = status
                respond_t0 = time.perf_counter()
                if trace is not None and not any(
                        k.lower() == "x-trace-id" for k, _v in h):
                    # Surface the id to the client; the replica usually
                    # already stamped the same one (it adopted our
                    # context), in which case its header relays as-is.
                    h = list(h) + [("X-Trace-Id", trace.trace_id)]
                self._reply_forwarded(status, h, payload)
                router.tracer.add_span("route.respond", trace,
                                       respond_t0, time.perf_counter(),
                                       status=status)
            finally:
                router.note_latency((time.perf_counter() - t0) * 1e3)
                if trace is not None:
                    if trace.root is not None and status_out is not None:
                        trace.root.set_attr("status", status_out)
                    router.tracer.finish_trace(trace)

        def do_GET(self):
            url = urlparse(self.path)
            path = url.path
            if path == "/metrics":
                self._reply(200, router.registry.render_text().encode(),
                            "text/plain; version=0.0.4")
            elif path == "/metrics/fleet":
                text = router.federator.render(
                    own_text=router.registry.render_text())
                self._reply(200, text.encode(),
                            "text/plain; version=0.0.4")
            elif path == "/debug/spans" and parse_qs(url.query).get(
                    "trace", [None])[0]:
                trace_id = parse_qs(url.query)["trace"][0]
                self._reply_json(200, router.federated_trace(trace_id))
            elif handle_debug_get(path, url.query, router.tracer,
                                  router.recorder, router.registry,
                                  self._reply, self._reply_json):
                pass
            elif path == "/healthz":
                status = router.fleet_status()
                self._reply_json(200, {
                    "status": "ok",
                    "role": status["role"],
                    "epoch": status["epoch"],
                    "ready_replicas": status["ready"],
                    "total_replicas": status["total"],
                    "in_rotation": status["in_rotation"],
                    "brownout_level": status["brownout_level"],
                    "sessions_routed": status["sessions_routed"],
                    "sessions_pending_handoff":
                        status["sessions_pending_handoff"]})
            elif path == "/readyz":
                status = router.fleet_status()
                ready = status["ready"] > 0
                self._reply_json(200 if ready else 503, {
                    "status": "ready" if ready else "no_replicas",
                    "ready": ready,
                    "ready_replicas": status["ready"],
                    "total_replicas": status["total"]})
            elif path == "/fleet":
                self._reply_json(200, router.fleet_status())
            elif path == "/admin/rollout":
                self._reply_json(200, router.rollout.status())
            else:
                self._reply_json(404, {"error": f"no route {path!r}"})

        def _handle_rollout_post(self):
            """``POST /admin/rollout`` — arm/disarm the canary split
            (fleet/rollout.py): ``{"action": "set", "model":
            "name@version", "fraction": 0.05, "shadow_fraction": 0.0}``
            arms (re-arming clears a previous demotion — an operator
            decision, never automatic); ``{"action": "clear"}``
            disarms.  200 with the policy status either way."""
            try:
                length = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(length)) if length \
                    else {}
                action = body["action"]
                if action == "set":
                    out = router.rollout.set_canary(
                        str(body["model"]),
                        float(body["fraction"]),
                        shadow_fraction=float(
                            body.get("shadow_fraction", 0.0)))
                elif action == "clear":
                    out = router.rollout.clear_canary()
                else:
                    raise ValueError(f"unknown action {action!r}")
            except (ValueError, KeyError, TypeError) as e:
                self._reply_json(400, {
                    "error": 'need a JSON body {"action": "set"|"clear",'
                             ' ...}',
                    "detail": str(e)})
                return
            self._reply_json(200, {"status": "ok", "rollout": out})

        def do_POST(self):
            url = urlparse(self.path)
            if url.path == "/admin/rollout":
                self._handle_rollout_post()
                return
            if handle_debug_post(url.path, router.recorder,
                                 self._reply_json):
                return
            if (url.path != "/v1/disparity"
                    and _stream_session_id(url.path, self.headers)
                    is None):
                self._reply_json(404, {"error": f"no route {url.path!r}"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                if not 0 < length <= MAX_BODY_BYTES:
                    raise ValueError(
                        f"Content-Length {length} out of range")
                body = self.rfile.read(length)
            except (ValueError, OSError) as e:
                self._reply_json(400, {"error": str(e)})
                return
            self._forward("POST", body)

        def do_DELETE(self):
            if _stream_session_id(urlparse(self.path).path,
                                  self.headers) is None:
                self._reply_json(404,
                                 {"error": f"no route {self.path!r}"})
                return
            self._forward("DELETE", None)

    return Handler


class _PooledHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer spawns one OS thread PER CONNECTION — at 10k
    concurrent sessions that is 10k stacks (~80 GB of virtual address
    space and a scheduler meltdown before the router does any work).
    This variant services connections from a bounded ThreadPoolExecutor:
    accepts queue in the kernel backlog (``request_queue_size``), at
    most ``max_workers`` requests execute concurrently, and an idle
    keep-alive is reaped by the handler timeout so a parked client
    releases its worker.  bench_fleet.py is the receipt: the 5k/10k
    session legs run against exactly this server."""

    request_queue_size = 1024
    daemon_threads = True

    def __init__(self, addr, handler, max_workers: int = 128):
        super().__init__(addr, handler)
        self._pool = ThreadPoolExecutor(max_workers=max_workers,
                                        thread_name_prefix="fleet-http")

    def process_request(self, request, client_address):
        # ThreadingMixIn's per-connection Thread(), routed through the
        # bounded pool instead; process_request_thread still owns
        # finish_request + shutdown_request error handling.
        self._pool.submit(self.process_request_thread, request,
                          client_address)

    def server_close(self):
        super().server_close()
        self._pool.shutdown(wait=False)


class RouterHTTPServer:
    """Owns the router's HTTP server (bounded-pool variant); same
    lifecycle surface as serving/http.StereoHTTPServer (``port=0`` for
    tests, ``start`` for a daemon thread, ``serve_forever`` for the
    CLI)."""

    def __init__(self, router: FleetRouter, host: str = "127.0.0.1",
                 port: int = 8550, max_workers: int = 128):
        self.router = router
        self.server = _PooledHTTPServer((host, port),
                                        make_router_handler(router),
                                        max_workers=max_workers)
        self._thread = None

    @property
    def address(self) -> Tuple[str, int]:
        return self.server.server_address[:2]

    @property
    def url(self) -> str:
        host, port = self.address
        return f"http://{host}:{port}"

    def serve_forever(self):
        self.server.serve_forever()

    def start(self) -> "RouterHTTPServer":
        self._thread = threading.Thread(target=self.server.serve_forever,
                                        daemon=True, name="fleet-http")
        self._thread.start()
        return self

    def shutdown(self):
        self.server.shutdown()
        self.server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
