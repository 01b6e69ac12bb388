"""The stream protocol of the port's HTTP front end against the JAX
package's (CPU): ``POST /v1/stream/<id>`` (and the ``X-Session-Id``
spelling on the bare path), ``DELETE /v1/stream/<id>``, the typed 410,
the 400s, and ``/healthz``'s session fields.

Two servers on port 0 serve one set of ``TINY`` weights with sessions on
(the JAX engine and the port's), configured alike.  The same requests go
to both, in the same order: statuses, typed JSON bodies (close stats
included) and the session headers are equal; the disparities of a frame
are held to 2e-3 px, the whole-forward bound of
``tests/test_torch_model.py``.  Each server chains its own states, so the
weights are the settling GRU's (``torch_port_support.settle_jax``): on
random weights the packages' difference grows ~5x an iteration along a
chain (2.3e-3 px at the second frame of one iteration each), on the
settling GRU it damps (``tests/test_torch_serving_sessions.py``).
Without sessions the stream routes answer 400 ``sessions_disabled`` in
both (``tests/test_torch_serve_http.py``).
"""

import io
import json
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_stereo_tpu.config import RaftStereoConfig as JaxConfig
from raft_stereo_tpu.models.raft_stereo import RAFTStereo as JaxRAFTStereo
from raft_stereo_tpu.serving import ServeConfig as JaxServeConfig
from raft_stereo_tpu.serving import StereoService as JaxService
from raft_stereo_tpu.serving import http as jhttp
from raft_stereo_tpu_torch.config import RaftStereoConfig
from raft_stereo_tpu_torch.io.jax_weights import state_dict_from_jax
from raft_stereo_tpu_torch.serving import ServeConfig, ServingEngine
from raft_stereo_tpu_torch.serving import http as phttp
from torch_port_support import perturb, settle_jax

TINY = dict(hidden_dims=(32, 32, 32), fnet_dim=64, corr_backend="reg")
ITERS = 1
FLOW_ATOL = 2e-3
SERVE = dict(iters=ITERS, tiers=("quality", "interactive"), sessions=True,
             session_ttl_s=100.0, batch_sizes=(1,), max_batch=1)
SESSION_HEADERS = ("X-Session-Id", "X-Frame-Index", "X-Warm",
                   "X-Scene-Cut", "X-Ctx-Cached", "X-Frame-Delta",
                   "X-Tier", "X-Iters-Used", "X-Batch-Size")


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def servers():
    """{"jax": server, "port": server}, each over its engine."""
    jcfg = JaxConfig(**TINY)
    jmodel = JaxRAFTStereo(jcfg)
    dummy = jnp.zeros((1, 64, 64, 3), jnp.float32)
    init = jax.jit(lambda key: jmodel.init(key, dummy, dummy, iters=1,
                                           test_mode=True))
    variables = settle_jax(perturb(init(jax.random.PRNGKey(0)),
                                   np.random.default_rng(7)))
    jsvc = JaxService(jcfg, variables, JaxServeConfig(**SERVE))
    psvc = ServingEngine(RaftStereoConfig(**TINY),
                         state_dict_from_jax(variables),
                         ServeConfig(**SERVE), device="cpu")
    out = {"jax": jhttp.StereoHTTPServer(jsvc, port=0).start(),
           "port": phttp.StereoHTTPServer(psvc, port=0).start()}
    yield out
    for server in out.values():
        server.shutdown()
        server.service.close()


def _frame(k, hw=(48, 64), seed=3):
    """Frame ``k`` of a coherent sequence (one noise pair shifted)."""
    rng = np.random.default_rng(seed)
    left = rng.integers(0, 255, (hw[0], hw[1] + 8, 3), dtype=np.uint8)
    right = np.roll(left, -3, axis=1)
    return left[:, k:k + hw[1]], right[:, k:k + hw[1]]


def _npz(left, right):
    buf = io.BytesIO()
    np.savez(buf, left=left, right=right)
    return buf.getvalue()


def _call(url, method="GET", body=None, headers=None, timeout=300):
    req = urllib.request.Request(url, data=body, method=method,
                                 headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _both(servers, path, method="POST", body=None, headers=None):
    """The same request to both servers: {"jax": ..., "port": ...}."""
    return {k: _call(s.url + path, method, body, headers)
            for k, s in servers.items()}


def _same_answer(res):
    """Equal status; equal JSON body, or disparities within FLOW_ATOL and
    equal session headers."""
    (jst, jhdr, jbody), (pst, phdr, pbody) = res["jax"], res["port"]
    assert pst == jst, (pst, jst, pbody, jbody)
    if jhdr.get("Content-Type") == "application/json":
        assert json.loads(pbody) == json.loads(jbody)
        return jst, json.loads(jbody)
    assert {h: phdr.get(h) for h in SESSION_HEADERS} == \
        {h: jhdr.get(h) for h in SESSION_HEADERS}
    np.testing.assert_allclose(np.load(io.BytesIO(pbody)),
                               np.load(io.BytesIO(jbody)), atol=FLOW_ATOL,
                               rtol=0)
    return jst, jhdr


def test_stream_frames_and_header_spelling_equal_to_jax(servers):
    """Frames 0-2 of one stream (cold, then warm with their delta), the
    third on the bare path with ``X-Session-Id``: statuses, session
    headers equal, disparities within FLOW_ATOL."""
    ctype = {"Content-Type": "application/x-npz"}
    st, hdr = _same_answer(_both(servers, "/v1/stream/cam1", body=_npz(
        *_frame(0)), headers=ctype))
    assert (st, hdr["X-Warm"], hdr["X-Frame-Index"]) == (200, "0", "0")
    st, hdr = _same_answer(_both(servers, "/v1/stream/cam1?tier=interactive",
                                 body=_npz(*_frame(1)), headers=ctype))
    assert (hdr["X-Warm"], hdr["X-Tier"]) == ("1", "interactive")
    assert "X-Frame-Delta" in hdr
    st, hdr = _same_answer(_both(servers, "/v1/stream", body=_npz(
        *_frame(2)), headers=dict(ctype, **{"X-Session-Id": "cam1"})))
    assert (hdr["X-Session-Id"], hdr["X-Frame-Index"]) == ("cam1", "2")
    # a handoff artifact with no handoff store: a new session starts cold
    moved = dict(ctype, **{"X-Handoff-Artifact": "ab" * 32})
    st, hdr = _same_answer(_both(servers, "/v1/stream/moved",
                                 body=_npz(*_frame(0)), headers=moved))
    assert (st, hdr["X-Warm"], hdr["X-Frame-Index"]) == (200, "0", "0")


STREAM_ERRORS = [
    ("POST", "/v1/stream", "npz", {}),
    ("POST", "/v1/stream/cam2?tier=auto", "npz", {}),
    ("POST", "/v1/stream/cam2?tier=xl", "npz", {}),
    ("POST", "/v1/stream/cam2?tier=nope", "npz", {}),
    ("POST", "/v1/stream/cam2?model=m", "npz", {}),
    ("POST", "/v1/stream/cam2?format=tiff", "npz", {}),
    ("POST", "/v1/stream/cam2", "bad", {}),
    ("DELETE", "/v1/stream", None, {}),
    ("DELETE", "/v1/stream/never-opened", None, {}),
    ("DELETE", "/v1/other", None, {}),
]


@pytest.mark.parametrize("method,path,body,headers", STREAM_ERRORS,
                         ids=[f"{m} {p} {b}" for m, p, b, _ in
                              STREAM_ERRORS])
def test_stream_errors_equal_to_jax(servers, method, path, body, headers):
    data = {"npz": _npz(*_frame(0)), "bad": b"not an npz",
            None: None}[body]
    st, out = _same_answer(_both(servers, path, method, data, headers))
    assert st in (400, 404) and "error" in out


def test_close_stats_expiry_and_healthz_equal_to_jax(servers):
    """DELETE answers the lifetime stats, then the typed 410 on the
    closed id; a session whose TTL passed answers 410 ``expired``;
    ``/healthz`` counts the live sessions; all equal to JAX's."""
    ctype = {"Content-Type": "application/x-npz"}
    for sid in ("cam3", "gone"):
        for k in range(2):
            _same_answer(_both(servers, f"/v1/stream/{sid}",
                               body=_npz(*_frame(k)), headers=ctype))
    st, stats = _same_answer(_both(servers, "/v1/stream/cam3", "DELETE"))
    assert st == 200 and stats["status"] == "closed"
    assert (stats["frames"], stats["warm_frames"]) == (2, 1)
    st, body = _same_answer(_both(servers, "/v1/stream/cam3", "DELETE"))
    assert (st, body["error"], body["reason"]) == (410, "session_expired",
                                                   "closed")
    st, body = _same_answer(_both(servers, "/v1/stream/cam3",
                                  body=_npz(*_frame(2)), headers=ctype))
    assert (st, body["reason"]) == (410, "closed")
    for server in servers.values():
        # every live session idle past the TTL (the sweep walks them in
        # last-used order and stops at the first live one)
        for sess in list(server.service.sessions._sessions.values()):
            sess.last_used_mono -= 1e3
    st, body = _same_answer(_both(servers, "/v1/stream/gone",
                                  body=_npz(*_frame(2)), headers=ctype))
    assert (st, body["error"], body["reason"]) == (410, "session_expired",
                                                   "expired")
    health = {k: json.loads(v[2]) for k, v in
              _both(servers, "/healthz", "GET").items()}
    for key in ("sessions_active", "session_hidden", "edf_scheduler"):
        assert health["port"][key] == health["jax"][key]
    assert health["port"]["sessions_active"] == \
        servers["port"].service.sessions.active_count
    assert health["port"]["sessions_active"] == 0
    for family in ("serve_sessions_expired_total",
                   "serve_sessions_created_total",
                   'serve_session_frames_total{mode="warm"}'):
        lines = [[ln for ln in _call(s.url + "/metrics")[2].decode(
            ).splitlines() if ln.startswith(family + " ")]
                 for s in servers.values()]
        assert lines[0] == lines[1] and len(lines[0]) == 1
