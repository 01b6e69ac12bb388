"""Session handoff across replicas and across packages (CPU): the port's
engine against the JAX package's.

* ``exec_config_fingerprint`` is byte-equal to JAX's for the default, the
  realtime and the ``TINY`` configurations under several serving knobs
  (and with a registered default model), on each package's own effective
  config; and on two live engines.
* Blobs cross packages both ways.  Four engines (two per package) serve
  the ``TINY`` model with ``session_hidden`` on one set of weights (Flax
  init, norm leaves perturbed, the settling GRU of ``torch_port_support``,
  carried by ``state_dict_from_jax``), sharing one artifact store.  One
  engine of each package runs a session's cold frame and publishes its
  sessions; the port's blob is in JAX's layout (hidden states NHWC per
  level, no context bundle).  The other engines adopt through the
  ``handoff_key`` and run the next frame warm: the port adopting JAX's
  blob, and JAX adopting the port's, each within FLOW_ATOL = 2e-3 px of
  JAX's own adoption of its own blob (one warm forward apart from a state
  one forward apart; on the settling GRU a perturbation of the start
  damps, ``tests/test_torch_serving_sessions.py``), hidden states the
  same.
* The three typed refusals (``config_mismatch``, ``corrupt``,
  ``model_unknown``) are counted as JAX counts them, and ``GET
  /admin/handoff`` answers as JAX's server does before and after a
  publish.
"""

import json
import types
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golden_data import disparity_field, textured_image, warp_right
from raft_stereo_tpu.config import RaftStereoConfig as JaxConfig
from raft_stereo_tpu.eval.runner import \
    effective_inference_config as jax_effective
from raft_stereo_tpu.models.raft_stereo import RAFTStereo as JaxRAFTStereo
from raft_stereo_tpu.serving import ServeConfig as JaxServeConfig
from raft_stereo_tpu.serving import StereoService as JaxService
from raft_stereo_tpu.serving import http as jhttp
from raft_stereo_tpu.serving import sessions as jsessions
from raft_stereo_tpu_torch.config import RaftStereoConfig
from raft_stereo_tpu_torch.eval.runner import \
    effective_inference_config as port_effective
from raft_stereo_tpu_torch.io.jax_weights import state_dict_from_jax
from raft_stereo_tpu_torch.serving import ServeConfig, ServingEngine
from raft_stereo_tpu_torch.serving import http as phttp
from raft_stereo_tpu_torch.serving import sessions as psessions
from torch_port_support import perturb, settle_jax

TINY = dict(hidden_dims=(32, 32, 32), fnet_dim=64, corr_backend="reg")
ITERS = 2
FLOW_ATOL = 2e-3
HW = (48, 64)


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


CONFIGS = {"default": ({}, False), "realtime": ({}, True), "tiny": (TINY,
                                                                    False)}
KNOBS = [dict(), dict(sessions=True, session_hidden=True),
         dict(sessions=True, session_ctx_cache=True, iters=7),
         dict(fetch_dtype="bf16", iters=12)]


def _stub(cls, effective, serve_kw, default=None):
    """The attributes ``exec_config_fingerprint`` reads, on ``cls``'s
    method (no model built)."""
    stub = types.SimpleNamespace(
        effective_config=effective, serve_cfg=serve_kw, default_model=None,
        _models={})
    if default is not None:
        stub.default_model = default
        stub._models = {default: types.SimpleNamespace(coord="kitti@v7")}
    return cls.exec_config_fingerprint(stub)


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("knobs", range(len(KNOBS)))
def test_fingerprints_byte_equal_to_jax(name, knobs):
    kw, realtime = CONFIGS[name]
    jcfg = JaxConfig.realtime() if realtime else JaxConfig(**kw)
    pcfg = RaftStereoConfig.realtime() if realtime else RaftStereoConfig(
        **kw)
    jserve, pserve = JaxServeConfig(**KNOBS[knobs]), ServeConfig(
        **KNOBS[knobs])
    jeff = jax_effective(jcfg, jserve.iters)
    peff = port_effective(pcfg, pserve.iters)
    for default in (None, "kitti"):
        want = _stub(JaxService, jeff, jserve, default)
        got = _stub(ServingEngine, peff, pserve, default)
        assert got == want and len(got) == 64


def _chain(n=2, hw=HW, seed=0):
    """One textured pair shifted one pixel a frame."""
    rng = np.random.default_rng(seed)
    left = textured_image(rng, hw[0], hw[1] + n)
    right = warp_right(left, disparity_field(rng, hw[0], hw[1] + n))
    return [(np.ascontiguousarray(left[:, k:k + hw[1]]),
             np.ascontiguousarray(right[:, k:k + hw[1]])) for k in range(n)]


def _serve(store, **kw):
    return dict(dict(iters=ITERS, sessions=True, session_hidden=True,
                     batch_sizes=(1,), max_batch=1,
                     executable_cache_dir=store), **kw)


@pytest.fixture(scope="module")
def handoff(tmp_path_factory):
    """Exporters (J1, P1) that ran session "j" / "p" one cold frame and
    published; importers (J2, P2) built on the same store, none adopted
    yet; the two manifests; the weights."""
    store = str(tmp_path_factory.mktemp("artifacts"))
    jcfg = JaxConfig(**TINY)
    jmodel = JaxRAFTStereo(jcfg)
    dummy = jnp.zeros((1, 64, 64, 3), jnp.float32)
    init = jax.jit(lambda key: jmodel.init(key, dummy, dummy, iters=1,
                                           test_mode=True))
    variables = settle_jax(perturb(init(jax.random.PRNGKey(0)),
                                   np.random.default_rng(7)))
    state = state_dict_from_jax(variables)
    frames = _chain()
    engines = {
        "J1": JaxService(jcfg, variables, JaxServeConfig(**_serve(store))),
        "P1": ServingEngine(RaftStereoConfig(**TINY), state,
                            ServeConfig(**_serve(store)), device="cpu")}
    engines["J1"].infer_session("j", *frames[0], timeout=600)
    engines["P1"].infer_session("p", *frames[0], timeout=600)
    manifests = {"j": engines["J1"].publish_handoff(),
                 "p": engines["P1"].publish_handoff()}
    engines["J2"] = JaxService(jcfg, variables,
                               JaxServeConfig(**_serve(store)))
    engines["P2"] = ServingEngine(RaftStereoConfig(**TINY), state,
                                  ServeConfig(**_serve(store)),
                                  device="cpu")
    yield dict(engines=engines, manifests=manifests, frames=frames,
               store=store, variables=variables, state=state)
    for eng in engines.values():
        eng.close()


def test_live_fingerprints_and_manifests_equal(handoff):
    e, m = handoff["engines"], handoff["manifests"]
    assert (e["P1"].exec_config_fingerprint()
            == e["J1"].exec_config_fingerprint()
            == m["j"]["config_fingerprint"] == m["p"]["config_fingerprint"])
    assert set(m["p"]) == set(m["j"])
    assert (m["j"]["sessions"], m["p"]["sessions"]) == (["j"], ["p"])
    assert m["j"]["count"] == m["p"]["count"] == 1
    assert (e["P1"].metrics.sessions_exported.value
            == e["J1"].metrics.sessions_exported.value == 1)


def test_port_blob_is_in_jax_layout(handoff):
    """The port's export: hidden states NHWC per level (JAX's layout),
    the context bundle dropped; JAX's parser reads it."""
    e, m = handoff["engines"], handoff["manifests"]
    blob = e["P1"].handoff_store.fetch(m["p"]["artifact"])
    records, skipped = jsessions.parse_handoff_blob(blob)
    assert skipped == 0 and set(records) == {"p"}
    meta, arrays = records["p"]
    hidden = arrays["hidden"]
    assert arrays["ctx"] is None and len(hidden) == 3
    for level, h in enumerate(hidden):
        # the 64x64 bucket at 1/4, 1/8, 1/16; 32 channels last
        assert h.shape == (16 >> level, 16 >> level, 32)
    live = e["P1"].sessions.get("p").hidden
    for h_nhwc, h_nchw in zip(hidden, live):
        assert np.array_equal(h_nhwc, np.transpose(h_nchw, (1, 2, 0)))


def test_blobs_cross_packages_both_ways(handoff):
    e, m, frames = handoff["engines"], handoff["manifests"], handoff["frames"]
    jkey, pkey = m["j"]["artifact"], m["p"]["artifact"]
    want = e["J2"].infer_session("j", *frames[1], handoff_key=jkey,
                                 timeout=600)
    port_of_jax = e["P2"].infer_session("j", *frames[1], handoff_key=jkey,
                                        timeout=600)
    jax_of_port = e["J2"].infer_session("p", *frames[1], handoff_key=pkey,
                                        timeout=600)
    port_of_port = e["P2"].infer_session("p", *frames[1], handoff_key=pkey,
                                         timeout=600)
    for res in (want, port_of_jax, jax_of_port, port_of_port):
        assert res.warm and res.warm_hidden and res.frame_index == 1
    for res in (port_of_jax, jax_of_port, port_of_port):
        np.testing.assert_allclose(res.flow, want.flow, atol=FLOW_ATOL)
    for got in (port_of_jax, port_of_port):
        for g, w in zip(got.hidden, want.hidden):
            np.testing.assert_allclose(g, np.transpose(w, (2, 0, 1)),
                                       atol=FLOW_ATOL)
    assert e["P2"].metrics.sessions_adopted.value == 2
    assert e["J2"].metrics.sessions_adopted.value == 2


def _adopt(engine, sid, key):
    sess, created = engine.sessions.get_or_create(sid)
    assert created
    with sess.order_lock:
        return engine._adopt_handoff(sess, sid, key)


def test_refusals_counted_as_jax(handoff):
    e, m = handoff["engines"], handoff["manifests"]
    store, state = handoff["store"], handoff["state"]
    jkey = m["j"]["artifact"]
    # config_mismatch: importers at another depth
    other = [JaxService(JaxConfig(**TINY), handoff["variables"],
                        JaxServeConfig(**_serve(store, iters=ITERS + 1))),
             ServingEngine(RaftStereoConfig(**TINY), state,
                           ServeConfig(**_serve(store, iters=ITERS + 1)),
                           device="cpu")]
    try:
        for eng in other:
            assert _adopt(eng, "j", jkey) is False
            assert eng.metrics.handoff_skips("config_mismatch") == 1
            assert eng.metrics.sessions_adopted.value == 0
    finally:
        for eng in other:
            eng.close()
    # corrupt: one entry's payload flipped under a valid content key
    blob = bytearray(e["J1"].handoff_store.fetch(jkey))
    blob[-3] ^= 0xFF
    bad_key = e["J1"].handoff_store.publish(bytes(blob))
    # model_unknown: a session pinned to a model no engine serves
    fp = e["P2"].exec_config_fingerprint()
    ghost = psessions.SessionStore()
    sess, _ = ghost.get_or_create("g")
    sess.model = "ghost"
    sess.note_result(flow_low=np.zeros((16, 16), np.float32),
                     thumb=np.zeros((3, 4), np.float32), bucket=(64, 64),
                     raw_shape=HW, warm=False, iters_used=ITERS)
    ghost_key = e["P1"].handoff_store.publish(
        ghost.export(config_fingerprint=fp))
    counts = []
    for name in ("P2", "J2"):
        eng = e[name]
        assert _adopt(eng, "x1", bad_key) is False
        assert _adopt(eng, "g", ghost_key) is False
        assert _adopt(eng, "x2", "0" * 64) is False     # not in the store
        counts.append({r: eng.metrics.handoff_skips(r) for r in
                       ("config_mismatch", "corrupt", "model_unknown")})
    assert counts[0] == counts[1] == {"config_mismatch": 0, "corrupt": 1,
                                      "model_unknown": 1}
    lines = [sorted(ln for ln in e[n].metrics.registry.render_text()
                    .splitlines() if "handoff_import_skipped" in ln)
             for n in ("P2", "J2")]
    assert lines[0] == lines[1] and lines[0]


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_admin_handoff_answers_as_jax(handoff):
    e = handoff["engines"]
    servers = {n: (jhttp if n[0] == "J" else phttp).StereoHTTPServer(
        e[n], port=0).start() for n in ("J1", "P1", "J2", "P2")}
    try:
        before = [_get(servers[n].url + "/admin/handoff")
                  for n in ("J2", "P2")]
        assert before[0] == before[1] == (404, {"error": "no_handoff"})
        after = {n: _get(servers[n].url + "/admin/handoff")
                 for n in ("J1", "P1")}
        assert after["J1"][0] == after["P1"][0] == 200
        for n, sid in (("J1", "j"), ("P1", "p")):
            body = after[n][1]
            assert body == json.loads(json.dumps(
                handoff["manifests"][sid]))
        assert e["P1"].wait_handoff_fetched(0) is True
        assert e["P2"].wait_handoff_fetched(0) is False
    finally:
        for s in servers.values():
            s.shutdown()


def test_publish_without_a_store_is_none():
    """No artifact directory: no handoff store, ``publish_handoff`` None
    in both packages (the router's typed-loss path)."""
    eng = ServingEngine(RaftStereoConfig(**TINY), _tiny_state(),
                        ServeConfig(sessions=True), device="cpu")
    try:
        assert eng.handoff_store is None and eng.publish_handoff() is None
        assert eng.handoff_manifest is None
    finally:
        eng.close()


def _tiny_state():
    from raft_stereo_tpu_torch.models.raft_stereo import RAFTStereo
    torch.manual_seed(0)
    return RAFTStereo(RaftStereoConfig(**TINY)).state_dict()
