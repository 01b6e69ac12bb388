"""Training metrics endpoint: the serving HTTP surface, minus the model.

``cli/train.py --metrics_port`` serves these routes off the training
process (same stdlib ``ThreadingHTTPServer`` machinery as
serving/http.py, same response conventions):

* ``GET /metrics`` — Prometheus text exposition of a ``MetricsRegistry``
  (telemetry/registry.py; the train loop's ``TrainTelemetry`` instruments).
* ``GET /healthz`` — one JSON heartbeat line from ``healthz_fn`` — for the
  train loop: status, step progress, and ``last_step_age_s``, the single
  number a watchdog needs to catch a stalled run.
* ``POST /debug/trace`` — open a bounded on-demand profiler window
  (telemetry/trace.py) on the live process; body is optional JSON
  ``{"duration_ms": N}``.  409 while a window is already open.
* ``GET /debug/spans`` — the span-tracer ring (telemetry/spans.py) as
  Chrome trace-event JSON: save the body, open it in Perfetto.  Latency-
  histogram exemplars (sampled trace IDs) ride along under ``?exemplars=1``
  as a JSON wrapper instead of the bare trace.  ``?trace=<id>`` filters to
  ONE trace and answers plain JSON span records instead — the per-process
  half of the fleet router's federated cross-process trace view.
* ``GET /debug/stacks`` — a plain-text stack dump of every live thread
  (where is the loop stuck RIGHT NOW).
* ``GET /debug/flightrecorder`` — recorder status: ring occupancy, dump
  count, bundle paths.  ``POST`` to the same path forces a bundle dump.
* ``GET /debug/compiles`` — the compile-cost registry's executable
  inventory (telemetry/costs.py): per-executable flops, bytes accessed,
  memory-analysis fields, compile wall time, arithmetic intensity.

The /debug surface is shared verbatim with the serving endpoint
(serving/http.py routes through ``handle_debug_get``/``handle_debug_post``
too), so one operator playbook covers both processes.

Scrapes run on server threads while the train loop owns the main thread —
every instrument read is lock-guarded host state, so a scrape never
touches the device or blocks a step.
"""

from __future__ import annotations

import json
import logging
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional, Tuple
from urllib.parse import parse_qs

from raft_stereo_tpu_torch.telemetry.flight_recorder import (FlightRecorder,
                                                       dump_all_stacks)
from raft_stereo_tpu_torch.telemetry.registry import MetricsRegistry
from raft_stereo_tpu_torch.telemetry.spans import SpanTracer, to_chrome_trace
from raft_stereo_tpu_torch.telemetry.trace import TraceBusy, TraceCapture

log = logging.getLogger(__name__)

MAX_TRACE_BODY_BYTES = 4096


def handle_trace_post(handler: BaseHTTPRequestHandler,
                      trace: Optional[TraceCapture],
                      reply_json: Callable[..., None]) -> None:
    """POST /debug/trace, shared verbatim by the training and serving
    endpoints (serving/http.py calls this too): parse the optional
    ``{"duration_ms": N}`` body, open a bounded capture, reply with the
    trace directory."""
    if trace is None:
        reply_json(404, {"error": "trace capture disabled on this endpoint"})
        return
    try:
        length = int(handler.headers.get("Content-Length", 0) or 0)
        if length > MAX_TRACE_BODY_BYTES:
            raise ValueError(f"trace request body {length} B too large")
        body = handler.rfile.read(length) if length else b""
        params = json.loads(body) if body.strip() else {}
        if not isinstance(params, dict):
            raise ValueError("trace request body must be a JSON object")
        duration_ms = params.get("duration_ms")
        if duration_ms is not None:
            duration_ms = float(duration_ms)
    except (ValueError, KeyError) as e:
        reply_json(400, {"error": str(e)})
        return
    try:
        info = trace.start(duration_ms=duration_ms)
    except TraceBusy as e:
        reply_json(409, {"error": str(e)})
        return
    except ValueError as e:
        reply_json(400, {"error": str(e)})
        return
    reply_json(200, info)


def handle_debug_get(path: str, query: str,
                     tracer: Optional[SpanTracer],
                     recorder: Optional[FlightRecorder],
                     registry: Optional[MetricsRegistry],
                     reply: Callable[[int, bytes, str], None],
                     reply_json: Callable[[int, object], None],
                     costs=None) -> bool:
    """The shared GET /debug/* surface (training AND serving endpoints).
    Returns True when the path was one of ours.  ``costs`` is the optional
    ``telemetry.costs.CompileRegistry`` behind ``GET /debug/compiles``."""
    if path == "/debug/compiles":
        if costs is None:
            reply_json(404, {"error": "compile-cost registry not wired on "
                                      "this endpoint (enable cost "
                                      "telemetry)"})
            return True
        reply_json(200, costs.to_json())
        return True
    if path == "/debug/spans":
        if tracer is None:
            reply_json(404, {"error": "span tracing not wired on this "
                                      "endpoint"})
            return True
        trace_filter = parse_qs(query).get("trace", [None])[0]
        if trace_filter:
            # One trace's spans as plain JSON records (spans.jsonl
            # schema) — the federation unit the fleet router's merged
            # GET /debug/spans?trace=<id> collects from each replica.
            spans = [s.to_dict() for s in tracer.spans()
                     if s.trace_id == trace_filter]
            reply_json(200, {"trace_id": trace_filter, "spans": spans})
            return True
        chrome = to_chrome_trace(tracer.spans())
        if "exemplars=1" in query:
            exemplars = {}
            if registry is not None:
                for name, inst in sorted(registry.items()):
                    ex = getattr(inst, "exemplars", None)
                    if ex is not None and ex():
                        exemplars[name] = ex()
            reply_json(200, {"stats": tracer.stats(),
                             "exemplars": exemplars, "trace": chrome})
        else:
            reply(200, json.dumps(chrome).encode(), "application/json")
        return True
    if path == "/debug/stacks":
        reply(200, dump_all_stacks().encode(), "text/plain; charset=utf-8")
        return True
    if path == "/debug/flightrecorder":
        if recorder is None:
            reply_json(404, {"error": "flight recorder not wired on this "
                                      "endpoint"})
            return True
        reply_json(200, recorder.status())
        return True
    return False


def handle_debug_post(path: str, recorder: Optional[FlightRecorder],
                      reply_json: Callable[[int, object], None]) -> bool:
    """POST /debug/flightrecorder — force a bundle dump on the live
    process (the operator's "capture NOW" button).  Returns True when the
    path was ours."""
    if path != "/debug/flightrecorder":
        return False
    if recorder is None:
        reply_json(404, {"error": "flight recorder not wired on this "
                                  "endpoint"})
        return True
    bundle = recorder.dump("manual", force=True)
    reply_json(200, {"bundle": bundle})
    return True


def make_telemetry_handler(registry: MetricsRegistry,
                           healthz_fn: Callable[[], Dict[str, object]],
                           trace: Optional[TraceCapture] = None,
                           tracer: Optional[SpanTracer] = None,
                           recorder: Optional[FlightRecorder] = None,
                           costs=None):
    """Handler class closed over the instruments (the serving/http.py
    pattern: BaseHTTPRequestHandler is instantiated per request, so state
    rides the closure)."""

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # route through logging
            log.debug("%s " + fmt, self.client_address[0], *args)

        def _reply(self, code: int, body: bytes, content_type: str):
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _reply_json(self, code: int, obj):
            self._reply(code, (json.dumps(obj) + "\n").encode(),
                        "application/json")

        def do_GET(self):
            path, _, query = self.path.partition("?")
            if path == "/metrics":
                self._reply(200, registry.render_text().encode(),
                            "text/plain; version=0.0.4")
            elif path == "/healthz":
                self._reply_json(200, healthz_fn())
            elif handle_debug_get(path, query, tracer, recorder, registry,
                                  self._reply, self._reply_json,
                                  costs=costs):
                pass
            else:
                self._reply_json(404, {"error": f"no route {path!r}"})

        def do_POST(self):
            path = self.path.split("?", 1)[0]
            if path == "/debug/trace":
                handle_trace_post(self, trace, self._reply_json)
            elif handle_debug_post(path, recorder, self._reply_json):
                pass
            else:
                self._reply_json(404, {"error": f"no route {path!r}"})

    return Handler


class TelemetryHTTPServer:
    """Owns the ThreadingHTTPServer; ``port=0`` binds an ephemeral port
    (tests, the CI smoke).  ``start`` runs it on a daemon thread so the
    train loop keeps the main thread (and its signal handlers)."""

    def __init__(self, registry: MetricsRegistry,
                 healthz_fn: Callable[[], Dict[str, object]],
                 host: str = "127.0.0.1", port: int = 9100,
                 trace: Optional[TraceCapture] = None,
                 tracer: Optional[SpanTracer] = None,
                 recorder: Optional[FlightRecorder] = None,
                 costs=None):
        self.registry = registry
        self.trace = trace if trace is not None else TraceCapture()
        self.tracer = tracer
        self.recorder = recorder
        self.costs = costs
        self.server = ThreadingHTTPServer(
            (host, port),
            make_telemetry_handler(registry, healthz_fn, self.trace,
                                   tracer=tracer, recorder=recorder,
                                   costs=costs))
        self._thread = None

    @property
    def address(self) -> Tuple[str, int]:
        return self.server.server_address[:2]

    @property
    def url(self) -> str:
        host, port = self.address
        return f"http://{host}:{port}"

    def start(self) -> "TelemetryHTTPServer":
        import threading

        self._thread = threading.Thread(target=self.server.serve_forever,
                                        daemon=True, name="train-metrics")
        self._thread.start()
        return self

    def shutdown(self):
        self.server.shutdown()
        self.server.server_close()
        self.trace.stop()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
