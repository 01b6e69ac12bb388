"""Helpers of the fleet tests (``tests/test_torch_fleet*.py``).

* ``port_twin`` re-binds one of the JAX package's fleet tests to the
  port: the test's source and its module's helpers are executed again
  with every ``raft_stereo_tpu.`` name pointing at
  ``raft_stereo_tpu_torch.`` (inner imports included), so the same
  scenario and the same assertions run on the port's code.
* ``drive`` runs one scripted scenario through either package's router
  (``FleetRouter`` behind its ``RouterHTTPServer``) over the JAX tests'
  stdlib stub replicas, and records what a client and an operator see:
  statuses, typed bodies and ``X-*`` headers, what the stubs received,
  counters, ``/fleet``, ``/metrics`` and ``/metrics/fleet``.  Trace ids,
  clocks, ports and jittered retry hints are normalized away, so the two
  packages' records compare with ``==``.
"""

from __future__ import annotations

import ast
import importlib
import inspect
import json
import re
import textwrap
import time
import types
import urllib.error
import urllib.request

import pytest

JAX = "raft_stereo_tpu"
PORT = "raft_stereo_tpu_torch"
# tests/test_fleet.py's router settings: a dead probe or a transport
# error takes a stub out at once; no fleet brownout unless asked
BASE = dict(health_timeout_s=2.0, fail_after=1, request_timeout_s=5.0,
            fleet_brownout=False)


@pytest.fixture()
def fleet3():
    """``tests/test_fleet.py``'s ``fleet3`` over the port's router."""
    from raft_stereo_tpu_torch.serving import fleet
    from test_fleet import StubReplica
    stubs = [StubReplica(f"s{i}") for i in range(3)]
    router = fleet.FleetRouter({s.name: s.url for s in stubs},
                               fleet.RouterConfig(**BASE))
    router.check_replicas()
    yield stubs, router
    router.stop()
    for s in stubs:
        try:
            s.kill()
        except Exception:
            pass


def to_port(text: str) -> str:
    return text.replace(f"{JAX}.", f"{PORT}.")


def _twin_of(obj):
    """The port's object of the same name where ``obj`` comes from the
    JAX package (a module, a class or a function), else ``obj``."""
    if isinstance(obj, types.ModuleType):
        if obj.__name__.startswith(f"{JAX}."):
            return importlib.import_module(to_port(obj.__name__))
        return obj
    mod = getattr(obj, "__module__", None) or ""
    if mod.startswith(f"{JAX}.") and hasattr(obj, "__name__"):
        return getattr(importlib.import_module(to_port(mod)), obj.__name__)
    return obj


def _function_source(fn) -> str:
    """``fn``'s source from its ``def`` line (decorators dropped)."""
    src = textwrap.dedent(inspect.getsource(fn))
    node = ast.parse(src).body[0]
    return "\n".join(src.splitlines()[node.lineno - 1:]) + "\n"


def port_twin(module_name: str, test_name: str):
    """``test_name`` of the JAX test module ``module_name`` with every
    name of its module, and every import inside its functions, bound to
    the port."""
    mod = importlib.import_module(module_name)
    g = {k: _twin_of(v) for k, v in vars(mod).items()}
    for k, v in vars(mod).items():
        if (isinstance(v, types.FunctionType)
                and v.__module__ == mod.__name__):
            code = compile(to_port(_function_source(v)),
                           f"<port twin of {module_name}.{k}>", "exec")
            exec(code, g)
    fn = g[test_name]
    assert fn.__code__.co_filename.startswith("<port twin"), test_name
    return fn


# ----------------------------------------------------------- HTTP client
def call(url, method="GET", body=None, headers=None, timeout=30):
    req = urllib.request.Request(url, data=body, method=method,
                                 headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


# ---------------------------------------------------------- normalizing
# keys whose values are clocks, latencies, paths or jittered hints
TIME_KEYS = {"t", "last_state_change_ts", "probe_latency_ms", "age_s",
             "retry_after_s", "url", "manifest_path", "bundle",
             "router_bundle", "trigger_trace_id", "start_us",
             "duration_us", "span_id", "parent_id", "trace_id"}
# response headers that carry times or per-process ids (and the length
# of a body that carries a jittered retry hint; the body is compared)
TIME_HEADERS = {"x-trace-id", "retry-after", "date", "server",
                "content-length"}


def scrub(obj, urls=None):
    """``obj`` with time-valued keys dropped and stub URLs replaced by
    the stubs' names (``urls``: url -> name)."""
    urls = urls or {}
    if isinstance(obj, dict):
        return {k: scrub(v, urls) for k, v in obj.items()
                if k not in TIME_KEYS}
    if isinstance(obj, (list, tuple)):
        return [scrub(v, urls) for v in obj]
    if isinstance(obj, str):
        for url, name in urls.items():
            obj = obj.replace(url, f"<{name}>")
        return re.sub(r"\b[0-9a-f]{16,32}\b", "<id>", obj)
    return obj


_TIME_SAMPLE = re.compile(r"^(fleet_federation_scrape_age_seconds"
                          r"|fleet_slo_burn_rate)(\{[^}]*\})? .*$", re.M)


def scrub_metrics(text: str) -> str:
    """Prometheus text with the time-valued samples' values blanked."""
    return _TIME_SAMPLE.sub(lambda m: f"{m.group(1)}{m.group(2) or ''} "
                            "<time>", text)


def _body(raw: bytes):
    try:
        return json.loads(raw)
    except ValueError:
        return raw


class Recorder:
    """What one scenario saw, through one package's router."""

    def __init__(self, router, server, stubs):
        self.router = router
        self.server = server
        self.stubs = stubs
        self.urls = {s.url: s.name for s in stubs}
        self.log = []

    def note(self, tag, value):
        self.log.append((scrub(tag), scrub(value, self.urls)))

    def http(self, path, body=None, method=None, headers=None):
        method = method or ("POST" if body is not None else "GET")
        status, hdrs, raw = call(self.server.url + path, method, body,
                                 headers)
        kept = {k: v for k, v in hdrs.items()
                if k.lower() not in TIME_HEADERS}
        self.note(f"{method} {path}", [status, kept, _body(raw)])
        return status, hdrs, raw

    def stub_traffic(self):
        """What each stub was asked (requests, sessions, brownout pushes),
        and the handoff tags each stream frame carried."""
        self.note("stubs", {s.name: {
            "requests": list(s.requests), "sessions": list(s.sessions),
            "brownout": list(s.brownout_levels),
            "handoff_tags": [h.get("X-Handoff-Artifact")
                             for _, h in s.stream_headers],
            "flightrecorder_dumps": s.flightrecorder_dumps}
            for s in self.stubs})

    def snapshot(self, federate=False):
        """Counters, the lost-session ledger, ``/fleet``, ``/metrics``
        and (``federate``) ``/metrics/fleet`` after one scrape pass."""
        r = self.router
        self.note("state", {
            "ring": sorted(r.ring.members),
            "lost": list(r._lost), "handoff": dict(
                (sid, key) for sid, (key, _t) in r._handoff.items()),
            "sessions": dict(r._session_table),
            "brownout_level": r.brownout_level,
            "counters": {k: getattr(r, k).value for k in (
                "failovers", "sessions_lost", "route_retries",
                "unroutable", "brownout_pushes", "handoff_sessions",
                "handoff_manifests", "xl_unroutable", "slo_errors",
                "takeovers")}})
        _, _, raw = call(self.server.url + "/fleet")
        self.note("/fleet", json.loads(raw))
        _, _, raw = call(self.server.url + "/metrics")
        self.note("/metrics", scrub_metrics(raw.decode()))
        if federate:
            self.note("scrape", r.federator.scrape_once())
            _, _, raw = call(self.server.url + "/metrics/fleet")
            self.note("/metrics/fleet", scrub_metrics(raw.decode()))
        self.stub_traffic()


def root_spans(tracer, trace_id, deadline_s=5.0):
    """The spans of ``trace_id`` in ``tracer``'s ring once its root
    (``route.request``) is there: the HTTP front end finishes the root
    after the response is written, so a reader polls for it."""
    t_end = time.monotonic() + deadline_s
    while True:
        spans = [s.to_dict() for s in tracer.spans()
                 if s.trace_id == trace_id]
        if any(s["name"] == "route.request" for s in spans) \
                or time.monotonic() > t_end:
            return spans
        time.sleep(0.01)


def span_tree(spans):
    """(name, parent's name, attrs) per span, ids replaced by names."""
    by_id = {s["span_id"]: s["name"] for s in spans}
    return sorted((s["name"], by_id.get(s.get("parent_id")),
                   json.dumps(s.get("attrs", {}), sort_keys=True))
                  for s in spans)


def drive(pkg: str, scenario, stub_cls, clock_cls, tmp_path=None):
    """Run ``scenario(rec, fleet, clock)`` through package ``pkg``'s
    router over fresh stubs; returns the recorder's log.  ``scenario``
    declares its stubs and router config through ``scenario.stubs`` and
    ``scenario.config`` (a function of ``tmp_path``)."""
    fleet = importlib.import_module(f"{pkg}.serving.fleet")
    stubs = [stub_cls(name, **kw) for name, kw in scenario.stubs]
    clock = clock_cls()
    cfg = scenario.config(tmp_path)
    router = fleet.FleetRouter({s.name: s.url for s in stubs},
                               fleet.RouterConfig(**cfg), clock=clock)
    server = fleet.RouterHTTPServer(router, port=0).start()
    rec = Recorder(router, server, stubs)
    try:
        router.check_replicas()
        scenario(rec, fleet, clock)
        return rec.log
    finally:
        server.shutdown()
        router.stop()
        for s in stubs:
            try:
                s.kill()
            except Exception:
                pass
