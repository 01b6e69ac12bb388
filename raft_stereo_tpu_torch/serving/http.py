"""Localhost HTTP front end over the serving engine — stdlib only.

Endpoints:

* ``POST /v1/disparity`` — one stereo pair in, one disparity map out.
  Request body:
    - ``Content-Type: application/x-npz`` (default): an ``np.savez``
      archive with arrays ``left`` and ``right``, each (H, W, 3) uint8.
    - ``Content-Type: image/png``: ONE side-by-side pair (left|right
      concatenated along width; even width), the common packed layout for
      stereo capture streams.
  Optional ``X-Deadline-Ms`` header bounds the queue wait.  Optional
  ``?tier=`` (or ``X-Tier`` header) selects a configured latency tier —
  a named early-exit knob setting (``interactive`` / ``balanced`` /
  ``quality``, serving/engine.py); unknown tiers get 400.  Response
  (``?format=``):
    - ``npy`` (default): raw ``.npy`` float32 positive-disparity map;
    - ``png``: 16-bit PNG, disparity*256 (the KITTI on-disk convention —
      data/frame_utils.write_disp_kitti reads it back losslessly to
      1/256 px);
    - ``npz`` (round 24): an ``np.savez`` archive with ``disparity``
      (float32) plus — when the engine serves with confidence telemetry
      (``--confidence``) — the full-resolution per-pixel ``confidence``
      map (float32 in (0, 1]);
    - ``conf_png``: the CONFIDENCE map alone as an 8-bit PNG
      (confidence*255) — the quick-look heat map; 400 when the result
      carries no confidence.
  Errors map to transport codes with TYPED JSON bodies so clients can
  machine-react: 429 (queue full) and 503 (draining) both carry
  ``{"error": "overloaded", "retry_after_s": N}`` plus the matching
  ``Retry-After`` header (back off instead of hammering); 504 (deadline
  passed in queue); 500 with ``{"error": "request_poisoned",
  "attempts": N}`` when a request's dispatch crashed on every bounded
  retry (serving/engine.py supervised recovery); 400 (malformed input).
  Under brownout degradation a response served at a cheaper tier than
  requested carries ``X-Degraded: <requested>-><served>``; the
  ``X-No-Degrade`` request header opts one request out.
  Quality observability (round 24, ``--confidence``): every response
  carries ``X-Confidence`` (the answer's mean per-pixel confidence,
  4 decimals).  ``?tier=auto`` rides the confidence-gated cascade
  (``--cascade``): the draft tier answers first and only low-confidence
  requests re-run on the quality tier — responses carry
  ``X-Escalated: 0|1``, ``X-Draft-Tier``, and (escalated)
  ``X-Draft-Confidence``; 400 without a cascade configured.
* ``POST /v1/stream/<session-id>`` — one FRAME of a streaming stereo
  session (warm-start video serving, serving/sessions.py).  Body,
  content types, ``?tier=`` / ``X-Tier``, ``X-Deadline-Ms``, and the
  response encodings are exactly ``/v1/disparity``; the session id rides
  the path (or the ``X-Session-Id`` header when the path is bare
  ``/v1/stream``).  The first frame of a new id creates the session and
  cold-starts; subsequent frames warm-start the GRU from the previous
  frame's disparity unless the scene-cut check fires.  Responses carry
  ``X-Session-Id``, ``X-Frame-Index``, ``X-Warm: 0|1``,
  ``X-Scene-Cut: 1`` (when the inter-frame delta check forced a cold
  start), ``X-Frame-Delta`` (the measured delta), and ``X-Iters-Used``.
  Session errors are typed: **410** ``{"error": "session_expired",
  "reason": "expired"|"evicted"|"closed"}`` on a dead id (open a new
  session), 400 ``{"error": "sessions_disabled"}`` when the engine runs
  stateless.  Frames of ONE session are strictly ordered (a frame
  blocks while the previous one is in flight); stream different
  sessions concurrently for pipelining.
* ``DELETE /v1/stream/<session-id>`` — close the session; 200 with its
  lifetime stats (frames, warm/cold split, scene cuts, mean GRU
  iterations), 404 on an unknown id, 410 on an already-dead one.
* ``GET /metrics`` — Prometheus text exposition (serving/metrics.py).
* ``GET /quality`` — online quality posture (round 24): per-tier rolling
  mean confidence, good/bad totals vs the floor, the PSI drift
  watchdog's state, the quality SLO burn, and the cascade's
  draft/escalation split; 404 unless the engine serves with
  ``--confidence`` (the off wire surface is unchanged).
* ``GET /healthz`` — LIVENESS: one JSON line (status, queue depth,
  inflight count, last-batch age, device count, readiness) answered
  whenever the process and its queue exist.  A restart-looping load
  balancer should probe this.
* ``GET /readyz`` — READINESS: 200 only once the configured
  bucket x tier x batch warm ladder has fully compiled (or restored
  from the persistent executable cache); 503 with warm progress before
  that.  Pointing traffic here keeps cold pods out of rotation while
  they prewarm (docs/architecture.md §Resilience).
* ``?model=`` / ``X-Model`` (both request kinds) — pick a REGISTERED
  model version (serving/models.py); absent means the engine default
  (byte-identical to the pre-registry single-model server).  Unknown
  names get a typed 404 ``{"error": "model_unknown"}``; responses
  served by a named model carry ``X-Model`` / ``X-Model-Version``.
  Session frames pin the model their stream started on — naming a
  DIFFERENT model mid-stream is a 400.
* ``GET /admin/models`` — registry inventory (default pointer,
  registered versions, per-model in-flight counts); ``POST
  /admin/models`` — live hot swap: ``{"action": "register", "model":
  "name@version", "default": true}`` loads + prewarms + flips,
  ``{"action": "retire", "model": "name"}`` drains + evicts (409 on
  the default, 504 on drain timeout), ``{"action": "set_default",
  "model": name|null}`` flips the pointer atomically.
* ``POST /admin/brownout`` — fleet control plane (serving/fleet/):
  ``{"level": N}`` sets the brownout degradation FLOOR the router
  computed from aggregate fleet pressure, so every replica steps down
  the tier ladder in lockstep; 200 with the effective level, 409
  ``brownout_unavailable`` without a brownout controller.
* ``POST /debug/trace`` — bounded on-demand profiler window on the live
  serving process (telemetry/trace.py); optional JSON body
  ``{"duration_ms": N}``; replies with the trace directory, 409 while a
  window is already open.
* ``GET /debug/spans`` / ``GET /debug/stacks`` / ``GET|POST
  /debug/flightrecorder`` / ``GET /debug/compiles`` — the same debug
  surface the training endpoint serves (telemetry/http.py
  ``handle_debug_get``/``handle_debug_post``): the request-path span ring
  as Chrome trace JSON, an all-thread stack dump, flight-recorder status /
  forced bundle dump, and the compile-cost registry's executable
  inventory (flops / bytes accessed / memory analysis per bucket
  executable; 404 unless ``ServeConfig.cost_telemetry``).
* Trace propagation (round 23 fleet observability): an inbound
  ``traceparent`` header (W3C-style, telemetry/spans.py codec) makes the
  request's ``serve.request`` span a child of the upstream trace — the
  fleet router injects one per forwarded hop so one trace id spans
  router and replica.  Sampled/adopted requests answer with
  ``X-Trace-Id`` for lookup via ``/debug/spans?trace=<id>``.

``ThreadingHTTPServer`` gives one Python thread per connection; the real
concurrency limit is the service's bounded queue, which is the point —
admission control lives in ONE place and the transport just reports it.

The JAX package's ``serving/http.py`` over the port's engine.  ``?tier=xl``
routes to the engine's xl tier, or answers 400 as the JAX server does
without one.  The handler threads never touch a device tensor: the
engine's workers upload, replay and fetch.
"""

from __future__ import annotations

import io
import json
import logging
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple
from urllib.parse import parse_qs, urlparse

import numpy as np

from raft_stereo_tpu_torch.serving.batcher import (DeadlineExceeded,
                                                   Overloaded,
                                                   RequestPoisoned)
from raft_stereo_tpu_torch.serving.models import (ModelStoreError,
                                                  ModelUnknown)
from raft_stereo_tpu_torch.serving.service import StereoService
from raft_stereo_tpu_torch.serving.sessions import (SessionExpired,
                                                    SessionsDisabled)
from raft_stereo_tpu_torch.telemetry.flight_recorder import FlightRecorder
from raft_stereo_tpu_torch.telemetry.http import (handle_debug_get,
                                                  handle_debug_post,
                                                  handle_trace_post)
from raft_stereo_tpu_torch.telemetry.spans import (TRACE_CONTEXT_HEADER,
                                                   decode_traceparent)
from raft_stereo_tpu_torch.telemetry.trace import TraceCapture

log = logging.getLogger(__name__)

MAX_BODY_BYTES = 256 * 2 ** 20  # refuse absurd uploads before reading them


def _decode_pair(body: bytes, content_type: str
                 ) -> Tuple[np.ndarray, np.ndarray]:
    if content_type.startswith("image/png"):
        from PIL import Image

        pair = np.asarray(Image.open(io.BytesIO(body)).convert("RGB"))
        if pair.shape[1] % 2:
            raise ValueError(
                f"side-by-side pair width {pair.shape[1]} must be even")
        w = pair.shape[1] // 2
        return pair[:, :w], pair[:, w:]
    # default: npz with left/right
    with np.load(io.BytesIO(body), allow_pickle=False) as z:
        if "left" not in z or "right" not in z:
            raise ValueError(
                f"npz must contain 'left' and 'right', got {sorted(z.files)}")
        return z["left"], z["right"]


def _encode_disparity(disp: np.ndarray, fmt: str,
                      confidence: Optional[np.ndarray] = None
                      ) -> Tuple[bytes, str]:
    if fmt == "npy":
        buf = io.BytesIO()
        np.save(buf, disp.astype(np.float32))
        return buf.getvalue(), "application/x-npy"
    if fmt == "png":
        from PIL import Image

        enc = np.clip(disp * 256.0, 0, 2 ** 16 - 1).astype(np.uint16)
        buf = io.BytesIO()
        Image.fromarray(enc).save(buf, format="PNG")
        return buf.getvalue(), "image/png"
    if fmt == "npz":
        # Disparity + (confidence on) the full-res per-pixel confidence
        # map in one archive — the "answer with its error bars" payload.
        arrays = {"disparity": disp.astype(np.float32)}
        if confidence is not None:
            arrays["confidence"] = confidence.astype(np.float32)
        buf = io.BytesIO()
        np.savez(buf, **arrays)
        return buf.getvalue(), "application/x-npz"
    if fmt == "conf_png":
        from PIL import Image

        if confidence is None:
            raise ValueError(
                "format=conf_png: this result carries no confidence map "
                "(serve with --confidence; xl-tier results have none)")
        enc = np.clip(confidence * 255.0, 0, 255).astype(np.uint8)
        buf = io.BytesIO()
        Image.fromarray(enc).save(buf, format="PNG")
        return buf.getvalue(), "image/png"
    raise ValueError(f"format={fmt!r}: use 'npy', 'png', 'npz' or "
                     f"'conf_png'")


def _stream_session_id(path: str, headers) -> Optional[str]:
    """The session id of one ``/v1/stream`` request: the path segment
    (``/v1/stream/<id>``, the canonical spelling) or the
    ``X-Session-Id`` header on the bare path.  None when the path is not
    a stream route at all."""
    if path == "/v1/stream":
        return headers.get("X-Session-Id") or ""
    if path.startswith("/v1/stream/"):
        return path[len("/v1/stream/"):]
    return None


def make_handler(service: StereoService,
                 trace: Optional[TraceCapture] = None,
                 recorder: Optional[FlightRecorder] = None):
    """Handler class closed over ``service`` (BaseHTTPRequestHandler is
    instantiated per request by the server, so state rides the closure)."""
    trace = trace if trace is not None else TraceCapture()

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # route through logging, not
            log.debug("%s " + fmt, self.client_address[0], *args)  # stderr

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

        def do_GET(self):
            url = urlparse(self.path)
            path = url.path
            if (path in ("/healthz", "/readyz")
                    and service.chaos is not None
                    and service.chaos.blackhole()):
                # Injected health-check blackhole (serving/chaos.py
                # healthz_blackhole_after_s): the probe's connection
                # closes with no response — the router's probe timeout
                # must classify this replica dead even though its
                # request path still works.
                self.close_connection = True
                return
            if path == "/metrics":
                self._reply(200, service.metrics.render_text().encode(),
                            "text/plain; version=0.0.4")
            elif path == "/quality":
                # Online quality posture (round 24); 404 with confidence
                # off so the off wire surface stays unchanged.
                q = service.quality_status()
                if q is None:
                    self._reply_json(404, {
                        "error": "quality telemetry off (start "
                                 "raft-serve with --confidence)"})
                else:
                    self._reply_json(200, q)
            elif path == "/healthz":
                # Liveness: answers as long as the process is up; the
                # readiness decision lives on /readyz (split so a warm
                # restart is not health-flapped out of existence while
                # it prewarms).  queue_depth/queue_limit/inflight are
                # the load signals the fleet router balances and
                # aggregates brownout pressure on.
                self._reply_json(200, {
                    "status": ("draining" if service.queue.draining
                               else "ok"),
                    "ready": service.ready,
                    "queue_depth": service.queue.depth,
                    "queue_limit": service.serve_cfg.max_queue,
                    "inflight": service.metrics.inflight.value,
                    # Running totals the fleet autoscaler differences
                    # into a deadline-miss RATE (fleet/autoscaler.py).
                    "admitted": service.metrics.admitted.value,
                    "deadline_missed":
                        service.metrics.deadline_missed.value,
                    "last_batch_age_s":
                        service.metrics.last_batch_age_s(),
                    "anomalies": service.metrics.anomalies.value,
                    "brownout_level":
                        service.metrics.brownout_level.value,
                    "sessions_active": (
                        service.sessions.active_count
                        if service.sessions is not None else None),
                    # Streaming-v2 surface (round 19): whether frames
                    # carry the GRU hidden state across dispatches and
                    # whether the deadline-aware coalescing scheduler
                    # is on — what the multi-stream smoke keys off.
                    "session_hidden": service.serve_cfg.session_hidden,
                    "edf_scheduler": service.serve_cfg.edf_scheduler,
                    "devices": len(service.devices),
                    "xl": service.xl_status(),
                    # Registry inventory, only once a named model exists
                    # (a single-model replica's /healthz body is pinned
                    # byte-identical to pre-registry builds).
                    **({"models": service.models_status()}
                       if (service.default_model is not None
                           or len(service._models) > 1) else {})})
            elif path == "/readyz":
                status = service.warm_status()
                status["status"] = ("ready" if status["ready"]
                                    else "warming")
                self._reply_json(200 if status["ready"] else 503, status)
            elif path == "/admin/models":
                # Registry inventory: the default pointer plus every
                # registered version's coordinate / retiring flag /
                # in-flight count (serving/engine.py models_status).
                self._reply_json(200, service.models_status())
            elif path == "/admin/handoff":
                # The drain handoff manifest: after a graceful SIGTERM
                # published the session blob, a router reads WHICH ids
                # moved and which artifact key carries their state; 404
                # until then.
                manifest = getattr(service, "handoff_manifest", None)
                if manifest is None:
                    self._reply_json(404, {"error": "no_handoff"})
                else:
                    service.note_handoff_fetched()
                    self._reply_json(200, manifest)
            elif handle_debug_get(path, url.query, service.tracer, recorder,
                                  service.metrics.registry,
                                  self._reply, self._reply_json,
                                  costs=service.costs):
                pass
            else:
                self._reply_json(404, {"error": f"no route {path!r}"})

        def _handle_brownout_post(self):
            """``POST /admin/brownout {"level": N}`` — the fleet-wide
            degradation floor the router pushes (serving/fleet/router.py)
            so every replica steps down the tier ladder in lockstep.
            200 with the effective level; 409 ``brownout_unavailable``
            when this engine runs without a brownout controller."""
            try:
                length = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(length)) if length \
                    else {}
                level = int(body["level"])
            except (ValueError, KeyError, TypeError) as e:
                self._reply_json(400, {
                    "error": 'need a JSON body {"level": N}',
                    "detail": str(e)})
                return
            try:
                effective = service.set_brownout_floor(level)
            except RuntimeError as e:
                self._reply_json(409, {"error": "brownout_unavailable",
                                       "detail": str(e)})
                return
            self._reply_json(200, {"status": "ok", "floor": level,
                                   "level": effective})

        def _handle_models_post(self):
            """``POST /admin/models`` — live model lifecycle (round 21
            hot swap; serving/models.py + engine registry):

            * ``{"action": "register", "model": "name[@version]",
              "default": bool, "prewarm": bool}`` — load + verify the
              version from the artifact store, prewarm its ladder
              (readiness gate closed until warm), optionally flip the
              default pointer.  200 with the registration status.
            * ``{"action": "retire", "model": "name"}`` — drain the
              model's in-flight dispatches, then evict its pytree and
              executables.  409 while it is the default.
            * ``{"action": "set_default", "model": "name"|null}`` —
              atomic default-pointer flip (null restores the implicit
              constructor model).

            Typed errors: 404 ``model_unknown``; 409 ``model_store`` /
            ``retire_default``; 504 ``retire_timeout``."""
            try:
                length = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(length)) if length \
                    else {}
                action = body["action"]
                if action not in ("register", "retire", "set_default"):
                    raise ValueError(f"unknown action {action!r}")
            except (ValueError, KeyError, TypeError) as e:
                self._reply_json(400, {
                    "error": 'need a JSON body {"action": '
                             '"register"|"retire"|"set_default", ...}',
                    "detail": str(e)})
                return
            try:
                if action == "register":
                    out = service.register_model(
                        str(body["model"]),
                        set_default=bool(body.get("default", False)),
                        prewarm=bool(body.get("prewarm", True)))
                elif action == "retire":
                    timeout = float(body.get("timeout_s", 30.0))
                    service.retire_model(str(body["model"]),
                                         timeout=timeout)
                    out = {"model": body["model"], "retired": True}
                else:
                    name = body.get("model")
                    service.set_default_model(
                        str(name) if name is not None else None)
                    out = {"default": name}
            except ModelUnknown as e:
                self._reply_json(404, {"error": "model_unknown",
                                       "model": e.model, "known": e.known,
                                       "detail": str(e)})
                return
            except ModelStoreError as e:
                self._reply_json(409, {"error": "model_store",
                                       "detail": str(e)})
                return
            except TimeoutError as e:
                self._reply_json(504, {"error": "retire_timeout",
                                       "detail": str(e)})
                return
            except (ValueError, KeyError, TypeError) as e:
                self._reply_json(400, {"error": str(e)})
                return
            except RuntimeError as e:
                self._reply_json(409, {"error": "retire_default",
                                       "detail": str(e)})
                return
            self._reply_json(200, {"status": "ok", **out,
                                   "models": service.models_status()})

        def do_POST(self):
            url = urlparse(self.path)
            if url.path == "/admin/brownout":
                self._handle_brownout_post()
                return
            if url.path == "/admin/models":
                self._handle_models_post()
                return
            if url.path == "/debug/trace":
                handle_trace_post(self, trace, self._reply_json)
                return
            if handle_debug_post(url.path, recorder, self._reply_json):
                return
            session_id = _stream_session_id(url.path, self.headers)
            if url.path != "/v1/disparity" and session_id is None:
                self._reply_json(404, {"error": f"no route {url.path!r}"})
                return
            try:
                if session_id == "":
                    raise ValueError(
                        "stream frames need a session id: POST "
                        "/v1/stream/<id> or set X-Session-Id")
                length = int(self.headers.get("Content-Length", 0))
                if not 0 < length <= MAX_BODY_BYTES:
                    raise ValueError(f"Content-Length {length} out of range")
                body = self.rfile.read(length)
                left, right = _decode_pair(
                    body, self.headers.get("Content-Type",
                                           "application/x-npz"))
                deadline_hdr = self.headers.get("X-Deadline-Ms")
                deadline_ms: Optional[float] = (
                    float(deadline_hdr) if deadline_hdr else None)
                query = parse_qs(url.query)
                fmt = query.get("format", ["npy"])[0]
                if fmt not in ("npy", "png", "npz", "conf_png"):
                    raise ValueError(f"format={fmt!r}: use 'npy', 'png', "
                                     f"'npz' or 'conf_png'")
                tier = query.get("tier", [None])[0] or \
                    self.headers.get("X-Tier")
                if tier == "xl":
                    # The xl pseudo-tier routes to the context-parallel
                    # family (serving/engine.py submit); valid only on
                    # an engine with an xl tier and a mesh-compatible
                    # bucket (the engine raises ValueError -> 400
                    # otherwise).
                    if getattr(service, "xl", None) is None:
                        raise ValueError(
                            "tier 'xl': this server has no xl mesh "
                            "tier (start raft-serve with --xl_mesh)")
                    if session_id is not None:
                        raise ValueError(
                            "tier 'xl': streaming sessions are "
                            "single-device — the warm/ctx state "
                            "machinery does not compose with the "
                            "mesh-sharded program")
                elif tier == "auto":
                    # The confidence-gated cascade pseudo-tier: valid only
                    # on an engine with a cascade configured; the engine
                    # raises ValueError (-> 400) at submit too, this check
                    # answers with the actionable message first.
                    if getattr(service, "_cascade_draft", None) is None:
                        raise ValueError(
                            "tier 'auto': this server has no confidence "
                            "cascade (start raft-serve with --confidence "
                            "--cascade)")
                    if session_id is not None:
                        raise ValueError(
                            "tier 'auto': streaming sessions pin one "
                            "compiled family per stream — the cascade's "
                            "draft/escalate re-run does not compose "
                            "with warm session state")
                elif tier is not None:
                    service.resolve_tier(tier)  # 400 on unknown tiers
                # ``?model=`` / ``X-Model`` picks a REGISTERED model
                # (serving/models.py); absent means the engine default.
                model = query.get("model", [None])[0] or \
                    self.headers.get("X-Model")
                degradable = self.headers.get("X-No-Degrade") is None
                # Inbound trace context (round 23 fleet observability):
                # a ``traceparent`` header — typically injected by the
                # fleet router — makes this request's serve.request span
                # a CHILD of the upstream trace, regardless of the local
                # sample rate (the upstream sampling decision wins).
                # Malformed headers decode to None and are ignored.
                trace_context = decode_traceparent(
                    self.headers.get(TRACE_CONTEXT_HEADER))
            except (ValueError, KeyError, OSError) as e:
                self._reply_json(400, {"error": str(e)})
                return
            try:
                if session_id is not None:
                    result = service.infer_session(
                        session_id, left, right, deadline_ms=deadline_ms,
                        tier=tier, degradable=degradable, model=model,
                        handoff_key=self.headers.get(
                            "X-Handoff-Artifact"),
                        trace_context=trace_context)
                else:
                    result = service.infer(left, right,
                                           deadline_ms=deadline_ms,
                                           tier=tier, degradable=degradable,
                                           model=model,
                                           trace_context=trace_context)
            except ModelUnknown as e:
                # Typed admission contract: the request named a model
                # this replica does not serve — 404, machine-readable.
                self._reply_json(404, {"error": "model_unknown",
                                       "model": e.model,
                                       "known": e.known,
                                       "detail": str(e)})
                return
            except SessionsDisabled as e:
                self._reply_json(400, {"error": "sessions_disabled",
                                       "detail": str(e)})
                return
            except SessionExpired as e:
                # The typed dead-session contract: 410 Gone — the client
                # must open a fresh session (a silent cold restart would
                # hide the stream break).
                self._reply_json(410, {"error": "session_expired",
                                       "session_id": e.session_id,
                                       "reason": e.reason,
                                       "detail": str(e)})
                return
            except Overloaded as e:
                # Typed overload contract: machine-readable body + the
                # matching Retry-After, so clients back off instead of
                # hammering a saturated (or draining) server.
                retry_after_s = 5.0 if e.draining else 1.0
                body = {"error": "overloaded",
                        "retry_after_s": retry_after_s,
                        "draining": e.draining,
                        "detail": str(e)}
                self._reply_json(
                    503 if e.draining else 429, body,
                    extra_headers=[("Retry-After",
                                    str(int(retry_after_s)))])
                return
            except DeadlineExceeded as e:
                self._reply_json(504, {"error": "deadline_exceeded",
                                       "detail": str(e)})
                return
            except RequestPoisoned as e:
                self._reply_json(500, {"error": "request_poisoned",
                                       "attempts": e.attempts,
                                       "detail": str(e)})
                return
            except ValueError as e:
                # Engine-side admission rejections that only trigger at
                # submit time: xl with a named model, a session's
                # mid-stream model switch.
                self._reply_json(400, {"error": str(e)})
                return
            except Exception as e:  # noqa: BLE001 — model/device failure
                log.exception("inference failed")
                self._reply_json(500, {"error": str(e)})
                return
            try:
                payload, ctype = _encode_disparity(
                    result.disparity, fmt, confidence=result.confidence)
            except ValueError as e:
                # conf_png on a result without a confidence map (xl
                # tier, or a confidence-off engine): client error.
                self._reply_json(400, {"error": str(e)})
                return
            headers = [
                ("X-Queue-Wait-Ms", f"{result.queue_wait_s * 1e3:.2f}"),
                ("X-Device-Ms", f"{result.device_s * 1e3:.2f}"),
                ("X-Batch-Size", str(result.batch_size))]
            if result.iters_used is not None:
                headers.append(("X-Iters-Used", str(result.iters_used)))
            if result.trace_id is not None:
                # Sampled (or trace-context-adopted) requests echo their
                # trace id so a slow response can be looked up in
                # /debug/spans?trace=<id> — on this replica and, when the
                # fleet router originated the trace, in the router's
                # federated view.
                headers.append(("X-Trace-Id", result.trace_id))
            if result.tier is not None:
                headers.append(("X-Tier", result.tier))
            if result.mesh is not None:
                headers.append(("X-Mesh", result.mesh))
            if result.tiles is not None:
                headers.append(("X-Tiles", str(result.tiles)))
                if result.seam_epe is not None:
                    headers.append(("X-Seam-EPE",
                                    f"{result.seam_epe:.4f}"))
            if result.degraded:
                headers.append(("X-Degraded",
                                f"{result.requested_tier}->{result.tier}"))
            if result.confidence_mean is not None:
                headers.append(("X-Confidence",
                                f"{result.confidence_mean:.4f}"))
            if result.draft_tier is not None:
                # Cascade (?tier=auto) provenance: which tier drafted,
                # whether the draft's confidence forced the re-run.
                headers.append(("X-Escalated",
                                "1" if result.escalated else "0"))
                headers.append(("X-Draft-Tier", result.draft_tier))
                if result.draft_confidence is not None:
                    headers.append(("X-Draft-Confidence",
                                    f"{result.draft_confidence:.4f}"))
            if result.model is not None:
                # Named-model responses carry the exact version that
                # served them — the canary comparator keys on this.
                headers.append(("X-Model", result.model))
                headers.append(("X-Model-Version", result.model_version))
            if result.session_id is not None:
                headers.append(("X-Session-Id", result.session_id))
                headers.append(("X-Frame-Index", str(result.frame_index)))
                headers.append(("X-Warm", "1" if result.warm else "0"))
                if result.scene_cut:
                    headers.append(("X-Scene-Cut", "1"))
                if result.ctx_cached:
                    headers.append(("X-Ctx-Cached", "1"))
                if result.frame_delta is not None:
                    headers.append(("X-Frame-Delta",
                                    f"{result.frame_delta:.2f}"))
            self._reply(200, payload, ctype, extra_headers=headers)

        def do_DELETE(self):
            url = urlparse(self.path)
            session_id = _stream_session_id(url.path, self.headers)
            if session_id is None:
                self._reply_json(404, {"error": f"no route {url.path!r}"})
                return
            if session_id == "":
                self._reply_json(400, {"error": "stream close needs a "
                                                "session id"})
                return
            try:
                stats = service.close_session(session_id)
            except SessionsDisabled as e:
                self._reply_json(400, {"error": "sessions_disabled",
                                       "detail": str(e)})
                return
            except SessionExpired as e:
                self._reply_json(410, {"error": "session_expired",
                                       "session_id": e.session_id,
                                       "reason": e.reason})
                return
            except KeyError:
                self._reply_json(404, {"error": "unknown_session",
                                       "session_id": session_id})
                return
            self._reply_json(200, {"status": "closed", **stats})

    return Handler


class _ReplicaHTTPServer(ThreadingHTTPServer):
    """A thread per connection, as the standard server, over a deep
    accept backlog.  The standard backlog of 5 turns connections away
    whenever more than 5 arrive between two accepts (the handler threads
    decoding request bodies hold the interpreter): a router relaying 16
    clients does that, and each turned-away client waits out its SYN
    retry, 1, 3, 7 ... seconds (measured on an H100 host: PERF.md)."""

    request_queue_size = 1024


class StereoHTTPServer:
    """Owns the ThreadingHTTPServer; ``port=0`` binds an ephemeral port
    (tests).  ``serve_forever`` blocks (the CLI's mode); ``start`` runs it
    on a daemon thread (in-process tests)."""

    def __init__(self, service: StereoService, host: str = "127.0.0.1",
                 port: int = 8551,
                 recorder: Optional[FlightRecorder] = None):
        self.service = service
        self.trace = TraceCapture()
        self.recorder = recorder
        self.server = _ReplicaHTTPServer(
            (host, port), make_handler(service, self.trace,
                                       recorder=recorder))
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

    def start(self) -> "StereoHTTPServer":
        import threading

        self._thread = threading.Thread(target=self.server.serve_forever,
                                        daemon=True, name="stereo-http")
        self._thread.start()
        return self

    def shutdown(self):
        self.server.shutdown()
        self.server.server_close()
        self.trace.stop()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
