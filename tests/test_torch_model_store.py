"""The model store and the engine's registry on the port (CPU), against
the JAX package's ``serving/models.py``, engine and ``/admin/models``.

* The store: a publish/load round trip gives back the config, the state
  dict and the metadata; ``versions``, ``latest_version`` and
  ``list_models`` answer as JAX's store over the same publish sequence; a
  flipped byte fails ``verify`` (and a deep load) with JAX's kind of
  reason; re-publishing raises ``ModelVersionExists`` in both; the token
  rules of ``parse_model_spec`` give JAX's results and errors.
* A version the JAX package published (orbax ``state/``) is refused with
  a typed ``ModelStoreError`` naming ``tools/jax_checkpoint_to_torch.py``.
* The registry over HTTP: both engines serve the ``TINY`` model (Flax
  init, norm leaves perturbed) as the implicit model, each with its own
  store holding the same two named versions (JAX's published by JAX,
  the port's the same weights through ``state_dict_from_jax``).  One
  sequence of register / set_default / retire / unknown requests gives
  equal statuses and bodies (store paths aside).  A named model's flow is
  held to 2e-3 px of JAX's, the whole-forward bound, and carries its
  name and version.
"""

import json
import os
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golden_data import disparity_field, textured_image, warp_right
from raft_stereo_tpu.config import RaftStereoConfig as JaxConfig
from raft_stereo_tpu.models.raft_stereo import RAFTStereo as JaxRAFTStereo
from raft_stereo_tpu.serving import ServeConfig as JaxServeConfig
from raft_stereo_tpu.serving import StereoService as JaxService
from raft_stereo_tpu.serving import http as jhttp
from raft_stereo_tpu.serving import models as jmodels
from raft_stereo_tpu_torch.config import RaftStereoConfig
from raft_stereo_tpu_torch.io.jax_weights import state_dict_from_jax
from raft_stereo_tpu_torch.serving import ServeConfig, ServingEngine
from raft_stereo_tpu_torch.serving import http as phttp
from raft_stereo_tpu_torch.serving import models as pmodels
from torch_port_support import perturb

TINY = dict(hidden_dims=(32, 32, 32), fnet_dim=64, corr_backend="reg")
ITERS = 1
FLOW_ATOL = 2e-3
HW = (48, 64)


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _init(seed):
    jcfg = JaxConfig(**TINY)
    jmodel = JaxRAFTStereo(jcfg)
    dummy = jnp.zeros((1, 64, 64, 3), jnp.float32)
    init = jax.jit(lambda key: jmodel.init(key, dummy, dummy, iters=1,
                                           test_mode=True))
    return perturb(init(jax.random.PRNGKey(seed)),
                   np.random.default_rng(7 + seed))


@pytest.fixture(scope="module")
def weights():
    """JAX variables of three seeds: the implicit model, a@v1, a@v2."""
    return [_init(seed) for seed in range(3)]


@pytest.fixture(scope="module")
def stores(weights, tmp_path_factory):
    """(JAX store, port store) holding a@v1 and a@v2 (seeds 1 and 2) and
    b@v1 (seed 1), published in that order."""
    root = tmp_path_factory.mktemp("stores")
    jstore = jmodels.ModelStore(str(root / "jax"))
    pstore = pmodels.ModelStore(str(root / "port"))
    for name, version, seed in (("a", "v1", 1), ("a", "v2", 2),
                                ("b", "v1", 1)):
        jstore.publish(name, version, JaxConfig(**TINY), weights[seed],
                       metadata={"seed": seed})
        pstore.publish(name, version, RaftStereoConfig(**TINY),
                       state_dict_from_jax(weights[seed]),
                       metadata={"seed": seed})
    return jstore, pstore


def test_store_round_trip_and_queries_as_jax(stores, weights):
    jstore, pstore = stores
    reg = pstore.load("a", "v2")
    want = state_dict_from_jax(weights[2])
    assert reg.coord == "a@v2" and reg.config == RaftStereoConfig(**TINY)
    assert set(reg.variables) == set(want)
    assert all(torch.equal(reg.variables[k], want[k]) for k in want)
    jreg = jstore.load("a", "v2")
    assert reg.metadata == jreg.metadata == {"seed": 2, "name": "a",
                                             "version": "v2"}
    assert pstore.list_models() == jstore.list_models() == {
        "a": ["v1", "v2"], "b": ["v1"]}
    assert pstore.versions("a") == jstore.versions("a")
    assert pstore.versions("zz") == jstore.versions("zz") == []
    assert pstore.has("b", "v1") and not pstore.has("b", "v9")
    assert pstore.has("..", "v1") == jstore.has("..", "v1") is False
    assert pstore.resolve("a").version == jstore.resolve("a").version
    assert pstore.resolve("b@v1").coord == jstore.resolve("b@v1").coord
    for store in (pstore, jstore):
        with pytest.raises(store_error(store)):
            store.resolve("zz")
        with pytest.raises(store_error(store)):
            store.load("a", "v9")


def store_error(store):
    return (pmodels.ModelStoreError
            if isinstance(store, pmodels.ModelStore)
            else jmodels.ModelStoreError)


def test_published_versions_are_immutable(stores, weights):
    jstore, pstore = stores
    with pytest.raises(pmodels.ModelVersionExists):
        pstore.publish("a", "v1", RaftStereoConfig(**TINY),
                       state_dict_from_jax(weights[0]))
    with pytest.raises(jmodels.ModelVersionExists):
        jstore.publish("a", "v1", JaxConfig(**TINY), weights[0])
    assert issubclass(pmodels.ModelVersionExists, pmodels.ModelStoreError)


def test_flipped_byte_fails_verify(weights, tmp_path):
    store = pmodels.ModelStore(str(tmp_path))
    path = store.publish("m", "v1", RaftStereoConfig(**TINY),
                         state_dict_from_jax(weights[0]))
    assert store.verify("m", "v1") == (True, "ok")
    target = os.path.join(path, "weights.pt")
    blob = bytearray(open(target, "rb").read())
    blob[len(blob) // 2] ^= 0xFF
    open(target, "wb").write(bytes(blob))
    ok, reason = store.verify("m", "v1")
    assert not ok and reason == "hash_mismatch:weights.pt"
    with pytest.raises(pmodels.ModelStoreError, match="deep validation"):
        store.load("m", "v1")
    store.load("m", "v1", deep=False)      # the shallow load still reads
    # JAX's store reports a flipped byte with a reason of the same kind
    jstore = jmodels.ModelStore(str(tmp_path / "jax"))
    jpath = jstore.publish("m", "v1", JaxConfig(**TINY), weights[0])
    cfg_file = os.path.join(jpath, "config.json")
    text = open(cfg_file).read()
    open(cfg_file, "w").write(text.replace("32", "33", 1))
    jok, jreason = jstore.verify("m", "v1")
    assert not jok and jreason == "hash_mismatch:config.json"


SPECS = ["kitti", "kitti@v2", "a.b_c-d@2026-08-07a", "a@b@c", "../x",
         "x/y", "", "@v", "k@", "-x", "x" * 64, "x" * 65, "name@ver sion",
         "Z9@0"]


@pytest.mark.parametrize("spec", SPECS)
def test_token_rules_equal_to_jax(spec):
    def outcome(fn):
        try:
            return ("ok", fn(spec))
        except Exception as e:  # noqa: BLE001 - compared across packages
            return ("raise", type(e).__name__, str(e))
    assert outcome(pmodels.parse_model_spec) == outcome(
        jmodels.parse_model_spec)


def test_jax_version_is_refused_typed(weights, tmp_path):
    """A version the JAX package published holds orbax ``state/``: the
    port refuses it, naming the converter."""
    jmodels.ModelStore(str(tmp_path)).publish("j", "v1", JaxConfig(**TINY),
                                              weights[0])
    store = pmodels.ModelStore(str(tmp_path))
    with pytest.raises(pmodels.ModelStoreError,
                       match="tools/jax_checkpoint_to_torch.py"):
        store.load("j", "v1")
    with pytest.raises(pmodels.ModelStoreError,
                       match="tools/jax_checkpoint_to_torch.py"):
        store.resolve("j@v1")
    assert store.versions("j") == []    # no loadable port version


def _call(url, method="GET", body=None):
    req = urllib.request.Request(
        url, data=None if body is None else json.dumps(body).encode(),
        method=method, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=300) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _scrub(obj, roots):
    """A JSON body with each store root replaced by one placeholder."""
    text = json.dumps(obj, sort_keys=True)
    for root in roots:
        text = text.replace(root, "<store>")
    return json.loads(text)


REGISTRY_SEQUENCE = [
    ("GET", None),
    ("POST", {"action": "register", "model": "a@v1"}),
    ("POST", {"action": "register", "model": "a@v1"}),        # idempotent
    ("POST", {"action": "register", "model": "b"}),           # latest
    ("POST", {"action": "set_default", "model": "a"}),
    ("POST", {"action": "retire", "model": "a"}),             # the default
    ("POST", {"action": "register", "model": "a@v2"}),        # replace
    ("POST", {"action": "set_default", "model": None}),
    ("POST", {"action": "retire", "model": "b"}),
    ("POST", {"action": "retire", "model": "b"}),             # unknown
    ("POST", {"action": "set_default", "model": "zz"}),
    ("POST", {"action": "register", "model": "zz@v1"}),       # not stored
    ("POST", {"action": "register", "model": "../x"}),        # bad token
    ("POST", {"action": "explode"}),
    ("GET", None),
]


def test_admin_models_and_named_model_match_jax(stores, weights):
    jstore, pstore = stores
    jeng = JaxService(JaxConfig(**TINY), weights[0], JaxServeConfig(
        iters=ITERS, batch_sizes=(1,), max_batch=1,
        model_store_dir=jstore.root))
    peng = ServingEngine(RaftStereoConfig(**TINY),
                         state_dict_from_jax(weights[0]), ServeConfig(
        iters=ITERS, batch_sizes=(1,), max_batch=1,
        model_store_dir=pstore.root), device="cpu")
    servers = [jhttp.StereoHTTPServer(jeng, port=0).start(),
               phttp.StereoHTTPServer(peng, port=0).start()]
    roots = [jstore.root, pstore.root]
    rng = np.random.default_rng(9)
    left = textured_image(rng, *HW)
    right = warp_right(left, disparity_field(rng, *HW))
    try:
        for method, body in REGISTRY_SEQUENCE:
            got = [_call(s.url + "/admin/models", method, body)
                   for s in servers]
            assert _scrub(got[1], roots) == _scrub(got[0], roots), body
        # a@v2 is registered now: the named model answers as JAX's
        want = jeng.infer(left, right, model="a", timeout=600)
        res = peng.infer(left, right, model="a", timeout=600)
        assert (res.model, res.model_version) == (
            want.model, want.model_version) == ("a", "v2")
        np.testing.assert_allclose(res.flow, want.flow, atol=FLOW_ATOL)
        implicit = peng.infer(left, right, timeout=600)
        assert implicit.model is None and implicit.model_version is None
        assert not np.array_equal(implicit.flow, res.flow)
        # programs per model: the named model's are its own
        assert peng.cached_programs(model="a") == [
            (0, (64, 64), 1, None, None)]
        assert peng.cached_programs() == [(0, (64, 64), 1, None, None)]
        assert set(jeng.models_status()) == set(peng.models_status())
        with pytest.raises(pmodels.ModelUnknown):
            peng.infer(left, right, model="b")
        peng.retire_model("a")
        with pytest.raises(KeyError):
            peng.cached_programs(model="a")
    finally:
        for s in servers:
            s.shutdown()
        jeng.close()
        peng.close()
