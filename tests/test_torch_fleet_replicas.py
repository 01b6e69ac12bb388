"""The port's router in front of the port's replicas (CPU, ``TINY``
weights): the router answers byte for byte as the replica answers
directly, one trace id spans the router and the replica, and the
``ReplicaHealth`` the port's router parses from a port replica equals the
one JAX's router parses from a JAX replica in the same configuration
(routing reads nothing else).

The servers are the ones ``tests/test_torch_serve_http.py`` builds: the
JAX engine and the port's over one set of seeded weights, here with
streaming sessions and brownout on.
"""

import dataclasses
import io
import json
import time

import numpy as np
import pytest
import torch

from raft_stereo_tpu.config import RaftStereoConfig as JaxConfig
from raft_stereo_tpu.serving import ServeConfig as JaxServeConfig
from raft_stereo_tpu.serving import StereoService as JaxService
from raft_stereo_tpu.serving import fleet as jfleet
from raft_stereo_tpu.serving import http as jhttp
from raft_stereo_tpu_torch.config import RaftStereoConfig
from raft_stereo_tpu_torch.io.jax_weights import state_dict_from_jax
from raft_stereo_tpu_torch.serving import ServeConfig, ServingEngine
from raft_stereo_tpu_torch.serving import fleet as pfleet
from raft_stereo_tpu_torch.serving import http as phttp
from test_torch_serve_http import TINY, _init, _npz, _pair
from torch_fleet_support import call, root_spans

SERVE = dict(iters=1, tiers=("quality", "interactive"),
             default_tier="quality", max_queue=4, sessions=True,
             brownout=True, brownout_poll_s=5.0, batch_sizes=(1,),
             max_batch=1)
# per-dispatch timings: two dispatches of one program clock differently
TIMING_HEADERS = {"server", "date", "x-queue-wait-ms", "x-device-ms",
                  "content-length"}


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def servers():
    """(JAX server, port server): the same weights and configuration."""
    jcfg = JaxConfig(**TINY)
    variables = _init(jcfg)
    jsvc = JaxService(jcfg, variables, JaxServeConfig(**SERVE))
    psvc = ServingEngine(RaftStereoConfig(**TINY),
                         state_dict_from_jax(variables),
                         ServeConfig(**SERVE), device="cpu")
    js = jhttp.StereoHTTPServer(jsvc, port=0).start()
    ps = phttp.StereoHTTPServer(psvc, port=0).start()
    yield js, ps
    for server, svc in ((js, jsvc), (ps, psvc)):
        server.shutdown()
        svc.close()


@pytest.fixture()
def routed(servers):
    """The port's router (tracing every request) over the port replica."""
    _, ps = servers
    router = pfleet.FleetRouter(
        {"r0": ps.url}, pfleet.RouterConfig(health_timeout_s=5.0,
                                            fleet_brownout=False,
                                            trace_sample_rate=1.0))
    router.check_replicas()
    server = pfleet.RouterHTTPServer(router, port=0).start()
    yield ps, router, server
    server.shutdown()
    router.stop()


def _app_headers(headers):
    return {k.lower(): v for k, v in headers.items()
            if k.lower() not in TIMING_HEADERS | {"x-trace-id"}}


def test_passthrough_byte_identical_to_the_replica(servers):
    """Untraced (the default), the routed answer's bytes and headers are
    the replica's own, stateless and streamed; typed errors too."""
    _, ps = servers
    router = pfleet.FleetRouter({"r0": ps.url},
                                pfleet.RouterConfig(health_timeout_s=5.0,
                                                    fleet_brownout=False))
    router.check_replicas()
    rs = pfleet.RouterHTTPServer(router, port=0).start()
    try:
        body = _npz(*_pair(seed=11))
        for path, hdrs in (
                ("/v1/disparity", {}),
                ("/v1/disparity?format=png", {}),
                ("/v1/disparity?tier=interactive&format=npz", {}),
                ("/v1/disparity", {"X-Tier": "nope"}),
                ("/v1/disparity?model=absent", {})):
            want = call(ps.url + path, "POST", body, dict(
                hdrs, **{"Content-Type": "application/x-npz"}))
            got = call(rs.url + path, "POST", body, dict(
                hdrs, **{"Content-Type": "application/x-npz"}))
            assert got[0] == want[0] and got[2] == want[2], path
            assert _app_headers(got[1]) == _app_headers(want[1]), path
            assert "x-trace-id" not in {k.lower() for k in got[1]}
        # a session: the direct chain and the routed chain, frame by frame
        frames = [_npz(*_pair(seed=20 + k)) for k in range(3)]
        direct = [call(ps.url + "/v1/stream/d-cam", "POST", f)
                  for f in frames]
        via = [call(rs.url + "/v1/stream/r-cam", "POST", f)
               for f in frames]
        for (ds, dh, db), (vs, vh, vb) in zip(direct, via):
            assert ds == vs == 200 and db == vb
            assert dh["X-Warm"] == vh["X-Warm"]
            assert dh["X-Frame-Index"] == vh["X-Frame-Index"]
        assert [h["X-Warm"] for _, h, _ in via] == ["0", "1", "1"]
        st, _, raw = call(rs.url + "/v1/stream/r-cam", "DELETE")
        assert st == 200 and json.loads(raw)["frames"] == 3
        assert router.fleet_status()["sessions_routed"] == 0
    finally:
        rs.shutdown()
        router.stop()


def test_one_trace_id_spans_router_and_replica(routed):
    """A sampled request: the replica adopted the router's context, so
    its ``serve.request`` is a child of the router's ``route.forward``
    under the one trace id, and the router's federated view merges the
    two processes' spans in start order."""
    ps, router, server = routed
    st, hdrs, _ = call(server.url + "/v1/disparity", "POST",
                       _npz(*_pair()))
    assert st == 200
    tid = hdrs["X-Trace-Id"]
    spans = root_spans(router.tracer, tid)
    fwd = next(s for s in spans if s["name"] == "route.forward")
    t_end = time.monotonic() + 5
    while True:
        _, _, raw = call(ps.url + f"/debug/spans?trace={tid}")
        replica = json.loads(raw)["spans"]
        if any(s["name"] == "serve.request" for s in replica) \
                or time.monotonic() > t_end:
            break
        time.sleep(0.02)
    serve = next(s for s in replica if s["name"] == "serve.request")
    assert serve["trace_id"] == tid and serve["parent_id"] == fwd["span_id"]
    _, _, raw = call(server.url + f"/debug/spans?trace={tid}")
    view = json.loads(raw)
    procs = {s["process"] for s in view["spans"]}
    assert procs == {"router", "r0"}
    assert view["sources"]["r0"] == len(replica)
    starts = [s["start_us"] for s in view["spans"]]
    assert starts == sorted(starts)


def test_federated_metrics_carry_the_replicas_serve_series(routed):
    ps, router, server = routed
    call(server.url + "/v1/disparity", "POST", _npz(*_pair()))
    assert router.federator.scrape_once() == {"r0": True}
    _, _, raw = call(server.url + "/metrics/fleet")
    text = raw.decode()
    assert 'fleet_federation_up{replica="r0"} 1' in text
    assert 'serve_requests_admitted_total{replica="r0"' in text
    for family in ("serve_requests_admitted_total", "fleet_replicas_ready"):
        assert text.count(f"# HELP {family} ") == 1


def _health(fleet, url):
    return dataclasses.asdict(fleet.Replica("r0", url).probe(10.0))


def test_replica_health_parsed_as_jax_parses_it():
    """What each router reads from its own package's replica, on a fresh
    JAX and port server pair: idle, after one request and one session
    frame each, under a pushed brownout floor, and past
    ``begin_shutdown`` (not ready and draining: the router's planned-drain
    signal, with the replica's typed draining 503 on the request path)."""
    variables = _init(JaxConfig(**TINY))
    jsvc = JaxService(JaxConfig(**TINY), variables, JaxServeConfig(**SERVE))
    psvc = ServingEngine(RaftStereoConfig(**TINY),
                         state_dict_from_jax(variables),
                         ServeConfig(**SERVE), device="cpu")
    js = jhttp.StereoHTTPServer(jsvc, port=0).start()
    ps = phttp.StereoHTTPServer(psvc, port=0).start()
    try:
        rows = [(_health(jfleet, js.url), _health(pfleet, ps.url))]
        body = _npz(*_pair(seed=5))
        for url in (js.url, ps.url):
            assert call(url + "/v1/disparity", "POST", body)[0] == 200
            assert call(url + "/v1/stream/h-cam", "POST", body)[0] == 200
            assert call(url + "/admin/brownout", "POST",
                        json.dumps({"level": 1}).encode(),
                        {"Content-Type": "application/json"})[0] == 200
        rows.append((_health(jfleet, js.url), _health(pfleet, ps.url)))
        jsvc.begin_shutdown()
        psvc.begin_shutdown()
        rows.append((_health(jfleet, js.url), _health(pfleet, ps.url)))
        st, _, raw = call(ps.url + "/v1/disparity", "POST", body)
        assert pfleet.FleetRouter._draining_503(st, raw)
    finally:
        for server, svc in ((js, jsvc), (ps, psvc)):
            server.shutdown()
            svc.close()
    for j, p in rows:
        assert p == j
    idle, busy, draining = (p for _, p in rows)
    assert idle["ready"] and idle["queue_limit"] == 4
    assert busy["brownout_level"] == 1 and busy["sessions_active"] == 1
    assert busy["admitted"] == 2 and busy["xl"] is None
    assert draining["draining"] and not draining["ready"]


def test_routed_answer_is_the_engines_own(routed):
    """The routed disparity is the port engine's answer for the pair,
    bit for bit (the replica's program, not a copy)."""
    ps, router, server = routed
    left, right = _pair(seed=9)
    st, _, raw = call(server.url + "/v1/disparity", "POST",
                      _npz(left, right))
    assert st == 200
    want = ps.service.infer(left, right, timeout=120).flow
    assert np.array_equal(-np.load(io.BytesIO(raw)), want)


def test_replica_listener_holds_a_burst_of_connections():
    """64 clients connect at once to a replica that has not accepted any
    of them yet (its accept loop busy): each connection completes at once
    from the backlog.  The standard backlog of 5 turns the 6th on away, to
    retry its SYN a second later (chip_smoke.py phase 36 saw 1-60 s stalls
    under a router relaying 16 clients)."""
    import socket

    server = phttp.StereoHTTPServer(object(), port=0)   # never started
    socks = []
    try:
        host, port = server.address
        for _ in range(64):
            s = socket.create_connection((host, port), timeout=0.5)
            socks.append(s)
        assert len(socks) == 64
    finally:
        for s in socks:
            s.close()
        server.server.server_close()


def test_probe_reads_a_drain_that_began_between_its_requests():
    """A SIGTERM landing between the probe's /healthz ("ok") and /readyz
    (not ready) is a planned drain: the probe reads /healthz again and
    reports draining, so the router hands the sessions off instead of
    typing them lost."""
    import threading
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    seen = []

    class Draining(BaseHTTPRequestHandler):
        def log_message(self, *args):
            pass

        def do_GET(self):
            seen.append(self.path)
            if self.path == "/healthz":
                body = {"status": "ok" if seen.count("/healthz") == 1
                        else "draining", "ready": False}
                code = 200
            else:
                body, code = {"ready": False, "status": "warming"}, 503
            raw = json.dumps(body).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(raw)))
            self.end_headers()
            self.wfile.write(raw)

    srv = ThreadingHTTPServer(("127.0.0.1", 0), Draining)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        health = _health(pfleet, f"http://127.0.0.1:{srv.server_port}")
    finally:
        srv.shutdown()
        srv.server_close()
    assert seen == ["/healthz", "/readyz", "/healthz"]
    assert health["draining"] and not health["ready"]
