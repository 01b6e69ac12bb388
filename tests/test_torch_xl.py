"""The xl serving tier of the port (serving/engine.py ``xl_mesh``)
against the JAX package's engine and the port's solo programs (CPU).

The same numpy-seeded weights (a JAX ``model.init``, carried over by
``io/jax_weights.state_dict_from_jax``) serve three ways: the JAX engine
with ``xl_mesh="rows=2"`` on the forced host devices of
tests/conftest.py, the port's engine over a group of two CPU devices
(``xl_devices``), and the port's solo runner.  The xl answer is held to
5e-4 px of the solo program at one GRU iteration, the JAX package's own
bound (tests/test_xl.py: reassociation noise amplifies ~6x an iteration
on random weights); a rows=1 mesh is the solo program, bit for bit.
Routing, the typed skip line, the typed 400s, readiness, the result's
``tier``/``mesh`` and the HTTP headers, health block and metrics are the
JAX engine's.
"""

import dataclasses
import io
import json
import logging
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_stereo_tpu.config import RaftStereoConfig as JaxConfig
from raft_stereo_tpu.models.raft_stereo import RAFTStereo as JaxModel
from raft_stereo_tpu.serving import ServeConfig as JaxServeConfig
from raft_stereo_tpu.serving import ServingEngine as JaxEngine
from raft_stereo_tpu_torch.config import RaftStereoConfig
from raft_stereo_tpu_torch.eval.runner import InferenceRunner
from raft_stereo_tpu_torch.io.jax_weights import state_dict_from_jax
from raft_stereo_tpu_torch.models.raft_stereo import RAFTStereo
from raft_stereo_tpu_torch.serving import (FAMILY_XL, ServeConfig,
                                           ServingEngine)
from raft_stereo_tpu_torch.serving import http as phttp

# JAX's tests/test_xl.py architecture (tests/test_rows_gru.py's), with
# rows_gru_halo=8 so that 128-row buckets fit a rows=2 mesh
SMALL = dict(n_gru_layers=3, hidden_dims=(48, 48, 48), fnet_dim=96,
             corr_levels=2, corr_radius=3, corr_backend="reg",
             rows_gru_halo=8)
HW = (128, 64)            # fine 32 rows: slab 16 = 2 x halo 8
CPU2 = ["cpu", "cpu"]


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    jcfg = JaxConfig(**SMALL)
    img = jnp.zeros((1, 64, 64, 3), jnp.float32)
    variables = jax.jit(lambda k: JaxModel(jcfg).init(
        k, img, img, iters=1, test_mode=True))(jax.random.PRNGKey(0))
    return jcfg, variables, RaftStereoConfig(**SMALL), state_dict_from_jax(
        variables)


def _pair(seed, h, w):
    left = np.random.default_rng(seed).integers(0, 255, (h, w, 3),
                                                dtype=np.uint8)
    return left, np.roll(left, -4, axis=1)


@pytest.mark.parametrize("kw", [
    dict(xl_mesh="rows=2"), dict(xl_mesh="rows=2,corr=2", xl_workers=2),
    dict(xl_mesh="corr=4", xl_threshold_pixels=10, xl_max_pixels=3000),
    dict(xl_mesh="rows=2", xl_batch_sizes=(1, 2))])
def test_xl_serve_config_accepted_as_jax(kw):
    got, want = ServeConfig(**kw), JaxServeConfig(**kw)
    assert {f.name: getattr(got, f.name) for f in dataclasses.fields(got)
            if f.name != "chaos"} == {
        f.name: getattr(want, f.name) for f in dataclasses.fields(want)
        if f.name != "chaos"}


def test_engine_without_xl_rejects_xl_tier(weights):
    _, _, cfg, state = weights
    with ServingEngine(cfg, state, ServeConfig(iters=1, tiers=()),
                       device="cpu") as eng:
        assert not eng.xl_enabled and eng.xl_status() is None
        left, right = _pair(0, 64, 64)
        with pytest.raises(ValueError, match="no xl tier"):
            eng.submit(left, right, tier="xl")


def test_engine_xl_skips_with_jax_line_when_devices_short(weights, caplog):
    """A replica whose devices cannot supply the mesh serves without the
    tier and logs the JAX engine's typed line (here the JAX engine's 8
    host devices against a mesh of 16, and the port's 8 given devices)."""
    jcfg, variables, cfg, state = weights
    lines = {}
    for tag, make in (
            ("jax", lambda: JaxEngine(jcfg, variables, JaxServeConfig(
                iters=1, tiers=(), xl_mesh="rows=16"))),
            ("port", lambda: ServingEngine(
                cfg, state, ServeConfig(iters=1, tiers=(),
                                        xl_mesh="rows=16"),
                device="cpu", xl_devices=["cpu"] * 8))):
        caplog.clear()
        with caplog.at_level(logging.WARNING):
            with make() as eng:
                assert not eng.xl_enabled
                assert not eng._xl_routes((512, 64))
        lines[tag] = [r.getMessage() for r in caplog.records
                      if "skipped" in r.getMessage()]
    assert lines["port"] == lines["jax"] and len(lines["port"]) == 1
    assert "serving WITHOUT the xl tier" in lines["port"][0]


def test_engine_xl_incompatible_bucket_is_typed(weights):
    _, _, cfg, state = weights
    with ServingEngine(cfg, state, ServeConfig(
            iters=1, tiers=(), xl_mesh="rows=4", xl_threshold_pixels=100),
            device="cpu", xl_devices=["cpu"] * 4) as eng:
        assert eng.xl_enabled
        ok, reason = eng._xl_compatible((64, 96))   # slab < 2 x halo
        assert not ok and "ppermute" in reason
        assert not eng._xl_routes((64, 96))
        left, right = _pair(1, 64, 96)
        with pytest.raises(ValueError, match="does not fit mesh"):
            eng.submit(left, right, tier="xl")


def test_xl_model_config_refusals_as_jax(weights):
    jcfg, variables, cfg, state = weights
    for kw, arch in ((dict(xl_mesh="corr=2"), dict(corr_backend="alt")),
                     (dict(xl_mesh="rows=2"), dict(n_downsample=3))):
        with pytest.raises(ValueError) as want:
            JaxEngine(dataclasses.replace(jcfg, **arch), variables,
                      JaxServeConfig(iters=1, tiers=(), **kw))
        pcfg = dataclasses.replace(cfg, **arch)
        with pytest.raises(ValueError) as got:
            ServingEngine(pcfg, RAFTStereo(pcfg).state_dict(),
                          ServeConfig(iters=1, tiers=(), **kw),
                          device="cpu", xl_devices=CPU2)
        assert str(got.value) == str(want.value)


def test_engine_xl_rows1_bitwise_and_tiling(weights):
    """A rows=1 mesh runs the solo program (bit for bit the runner's);
    a bucket past the mesh's cap falls through to halo row tiles."""
    _, _, cfg, state = weights
    left, right = _pair(2, 64, 96)
    solo, _ = InferenceRunner(cfg, state, iters=2, device="cpu")(left, right)
    with ServingEngine(cfg, state, ServeConfig(
            iters=2, tiers=(), xl_mesh="rows=1", xl_threshold_pixels=1000,
            xl_max_pixels=7000, tile_threshold_pixels=8000, tile_rows=64,
            tile_halo=16), device="cpu") as eng:
        res = eng.infer(left, right, timeout=300)
        assert res.tier == FAMILY_XL and res.mesh == "solo"
        np.testing.assert_array_equal(res.flow, solo)
        assert eng.metrics.xl_dispatches.value == 1
        tres = eng.infer(*_pair(3, 192, 64), timeout=300)
        assert tres.tiles == 3 and tres.tier is None
        assert tres.seam_epe is not None and np.isfinite(tres.flow).all()


def test_engine_xl_rows2_matches_jax_and_solo(weights):
    """The acceptance pin: the port's rows=2 xl answer within 5e-4 of its
    solo runner's and of the JAX engine's rows=2 xl answer, one GRU
    iteration, with a ``,mesh=rows2`` cost record."""
    jcfg, variables, cfg, state = weights
    left, right = _pair(4, *HW)
    solo, _ = InferenceRunner(cfg, state, iters=1, device="cpu")(left, right)
    with JaxEngine(jcfg, variables, JaxServeConfig(
            iters=1, tiers=(), xl_mesh="rows=2",
            xl_threshold_pixels=4000)) as jeng:
        want = jeng.infer(left, right, timeout=600)
    with ServingEngine(cfg, state, ServeConfig(
            iters=1, tiers=(), xl_mesh="rows=2", xl_threshold_pixels=4000,
            cost_telemetry=True), device="cpu", xl_devices=CPU2) as eng:
        res = eng.infer(left, right, timeout=600)
        rec = eng.compiled_cost(HW, 1, family=FAMILY_XL)
        small = eng.infer(*_pair(5, 48, 64), timeout=300)
    assert (res.tier, res.mesh) == (want.tier, want.mesh) == ("xl", "rows2")
    assert float(np.abs(res.flow - solo).max()) < 5e-4
    assert float(np.abs(res.flow - want.flow).max()) < 5e-4
    assert rec is not None and rec.key.endswith(",mesh=rows2)")
    assert small.tier is None and small.mesh is None


def test_xl_groups_hold_their_own_weights(weights, caplog):
    """``xl_workers=2`` over four named devices: two groups taken from
    that pool (no solo skip, no sharing warning), each with its own copy
    of the weights on its first device, as the JAX engine puts one copy
    per group; both groups' programs give one answer, and the engine's
    is the solo runner's within 5e-4."""
    _, _, cfg, state = weights
    left, right = _pair(9, *HW)
    solo, _ = InferenceRunner(cfg, state, iters=1, device="cpu")(left, right)
    with caplog.at_level(logging.WARNING):
        with ServingEngine(cfg, state, ServeConfig(
                iters=1, tiers=(), xl_mesh="rows=2", xl_workers=2,
                xl_threshold_pixels=4000), device="cpu",
                xl_devices=CPU2 * 2) as eng:
            groups = eng.xl.groups
            assert [len(g.devices) for g in groups] == [2, 2]
            assert groups[0].model is not groups[1].model
            for g in groups:
                assert all(p.device == g.devices[0]
                           for p in g.model.parameters())
            outs = [eng._xl_dispatch(
                widx, (widx, HW, 1, None, FAMILY_XL, None), left[None],
                right[None])[0] for widx in eng._xl_worker_indices()]
            res = eng.infer(left, right, timeout=600)
    assert not [r for r in caplog.records if "xl_mesh" in r.getMessage()]
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)
    assert res.tier == FAMILY_XL
    assert float(np.abs(res.flow - solo).max()) < 5e-4


def test_xl_warm_target_and_readiness(weights):
    """An xl-routed warmup shape puts the xl ladder alone on the
    readiness surface, and prewarm opens the gate."""
    _, _, cfg, state = weights
    serve_cfg = ServeConfig(iters=1, tiers=(), xl_mesh="rows=2",
                            xl_threshold_pixels=4000, warmup_shapes=(HW,),
                            prewarm_on_init=False)
    with ServingEngine(cfg, state, serve_cfg, device="cpu",
                       xl_devices=CPU2) as eng:
        assert eng.xl_enabled and not eng.ready
        with eng._warm_lock:
            target = set(eng._warm_target)
        assert target and all(e[4] == FAMILY_XL for e in target)
        eng.prewarm(HW)
        assert eng.ready
        assert eng.infer(*_pair(6, *HW), timeout=300).tier == FAMILY_XL


def _call(url, body=None):
    req = urllib.request.Request(url, data=body,
                                 method="POST" if body else "GET")
    try:
        with urllib.request.urlopen(req, timeout=300) as resp:
            return resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def test_xl_over_http(weights):
    """``X-Tier: xl`` and ``X-Mesh: rows2`` on an xl answer, a typed 400
    for ``?tier=xl`` on a bucket the mesh does not fit, the /healthz xl
    block, and ``serve_xl_dispatches_total``."""
    _, _, cfg, state = weights
    buf = io.BytesIO()
    np.savez(buf, left=_pair(7, *HW)[0], right=_pair(7, *HW)[1])
    small = io.BytesIO()
    np.savez(small, left=_pair(8, 48, 64)[0], right=_pair(8, 48, 64)[1])
    with ServingEngine(cfg, state, ServeConfig(
            iters=1, tiers=(), xl_mesh="rows=2", xl_threshold_pixels=4000),
            device="cpu", xl_devices=CPU2) as eng:
        server = phttp.StereoHTTPServer(eng, port=0).start()
        try:
            st, hdr, _ = _call(server.url + "/v1/disparity", buf.getvalue())
            assert st == 200 and hdr["X-Tier"] == "xl"
            assert hdr["X-Mesh"] == "rows2"
            st, _, body = _call(server.url + "/v1/disparity?tier=xl",
                                small.getvalue())
            assert st == 400 and b"does not fit mesh" in body
            health = json.loads(_call(server.url + "/healthz")[2])
            assert health["xl"] == eng.xl_status()
            assert health["xl"]["label"] == "rows2"
            metrics = _call(server.url + "/metrics")[2].decode()
            assert "serve_xl_dispatches_total 1" in metrics
        finally:
            server.shutdown()


def test_runner_mesh_program_matches_solo_and_refuses_as_jax(weights):
    """``InferenceRunner`` over a group (``mesh``): rows=2 with
    ``rows_gru`` and corr=2 answer within 5e-4 of the solo runner at one
    GRU iteration, the flow gathered on the group's first device; a
    trivial mesh program IS ``make_forward``'s; early exit and the
    streaming programs are refused as the JAX package refuses them."""
    from raft_stereo_tpu.eval.runner import \
        make_forward_mesh as jax_make_forward_mesh
    from raft_stereo_tpu_torch.eval.runner import (MeshForward,
                                                   make_forward_mesh)
    from raft_stereo_tpu_torch.parallel.mesh import make_mesh

    jcfg, variables, cfg, state = weights
    left, right = _pair(6, *HW)
    solo, _ = InferenceRunner(cfg, state, iters=1, device="cpu")(left, right)
    for kw, mesh in ((dict(rows_shards=2, rows_gru=True),
                      make_mesh(n_rows=2, devices=CPU2)),
                     (dict(corr_w2_shards=2),
                      make_mesh(n_corr=2, devices=CPU2))):
        mcfg = dataclasses.replace(cfg, **kw)
        runner = InferenceRunner(mcfg, state, iters=1, device="cpu",
                                 mesh=mesh)
        got, _ = runner(left, right)
        assert got.shape == solo.shape
        assert float(np.abs(got - solo).max()) < 5e-4, kw
        with pytest.raises(ValueError, match="sessions stay on one device"):
            runner.run_stream(left, right)
    model = RAFTStereo(cfg)
    assert not isinstance(make_forward_mesh(model, 1, None), MeshForward)
    exit_cfg = dict(rows_shards=2, exit_threshold_px=0.5)
    with pytest.raises(ValueError) as want:
        jax_make_forward_mesh(JaxModel(dataclasses.replace(jcfg, **exit_cfg)),
                              1, None)
    with pytest.raises(ValueError) as got:
        make_forward_mesh(RAFTStereo(dataclasses.replace(cfg, **exit_cfg)),
                          1, None)
    assert str(got.value) == str(want.value)
