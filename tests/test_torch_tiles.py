"""Halo row tiles on the port's serving engine (CPU), against the JAX
package's ``serving/tiles.py`` and its engine.

* ``plan_tiles``, ``stitch`` and ``seam_epe`` are a copy of the JAX
  module's pure functions: held equal (the same specs, bit-equal stitched
  arrays and seam values, the same errors) over a grid of heights, tile
  rows and halos.
* A tiled request: both engines serve the ``TINY`` model on one set of
  weights (Flax init, norm leaves perturbed, the settling GRU of
  ``torch_port_support.settle_jax``, carried by ``state_dict_from_jax``);
  a 100-row pair past ``tile_threshold_pixels`` runs as four 48-row
  tiles.  The settling GRU damps a perturbation where the random GRU
  amplifies it ~5x an iteration (``tests/test_torch_serving_sessions.py``),
  which on these ~20 px flows reads 2.0e-3 px after two iterations.
  The stitched flow is held to FLOW_ATOL = 2e-3 px, the whole-forward
  bound of ``tests/test_torch_model.py`` (each tile is one forward); the
  seam error, a mean of differences of such flows, to the same bound;
  ``tiles`` equal.  Both engines run the tiles at batch 1 (the JAX
  engine's one compile; another batch axis moves a flow by up to 5e-4 px,
  the JAX engine's own bound, which would stack on the forward's).  A
  second port engine with the 1/2/4 ladder runs the four tiles as one
  batch-4 dispatch, and its stitched flow equals ``tiles.stitch`` of its
  own answers to the four slices in one batch bit for bit.
"""

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
from raft_stereo_tpu.serving import tiles as jtiles
from raft_stereo_tpu_torch.config import RaftStereoConfig
from raft_stereo_tpu_torch.io.jax_weights import state_dict_from_jax
from raft_stereo_tpu_torch.serving import ServeConfig, ServingEngine
from raft_stereo_tpu_torch.serving import tiles as ptiles
from torch_port_support import perturb, settle_jax

TINY = dict(hidden_dims=(32, 32, 32), fnet_dim=64, corr_backend="reg")
ITERS = 2
FLOW_ATOL = 2e-3
HW = (100, 64)
TILING = dict(tile_threshold_pixels=4000, tile_rows=32, tile_halo=8)

HEIGHTS = (1, 31, 47, 48, 49, 100, 639, 640, 641, 1988)
ROWS = (32, 64, 512)
HALOS = (0, 8, 64)


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _outcome(fn, *args):
    """``("ok", value)`` or ``("raise", type name, message)``."""
    try:
        return ("ok", fn(*args))
    except Exception as e:  # noqa: BLE001 - compared across packages
        return ("raise", type(e).__name__, str(e))


@pytest.mark.parametrize("height", HEIGHTS)
def test_plan_tiles_equal_to_jax(height):
    for rows in ROWS:
        for halo in HALOS:
            got = ptiles.plan_tiles(height, rows, halo)
            want = jtiles.plan_tiles(height, rows, halo)
            assert [(s.y0, s.y1, s.src0, s.src1) for s in got] == [
                (s.y0, s.y1, s.src0, s.src1) for s in want]
            assert [s.own_slice for s in got] == [s.own_slice for s in want]
            # owned spans partition the image; every tile one height
            assert got[0].y0 == 0 and got[-1].y1 == height
            assert all(a.y1 == b.y0 for a, b in zip(got, got[1:]))
            assert len({s.height for s in got}) == 1


@pytest.mark.parametrize("args", [(0, 32, 8), (10, 0, 8), (10, 32, -1)])
def test_plan_tiles_errors_equal_to_jax(args):
    got = _outcome(ptiles.plan_tiles, *args)
    assert got[0] == "raise"
    assert got == _outcome(jtiles.plan_tiles, *args)


@pytest.mark.parametrize("height,rows,halo", [(100, 32, 8), (1988, 512, 64),
                                              (641, 64, 0), (48, 32, 8)])
def test_stitch_and_seam_equal_to_jax(height, rows, halo):
    specs = ptiles.plan_tiles(height, rows, halo)
    jspecs = jtiles.plan_tiles(height, rows, halo)
    rng = np.random.default_rng(height)
    flows = [rng.standard_normal((s.height, 24)).astype(np.float32)
             for s in specs]
    got = ptiles.stitch(flows, specs)
    assert np.array_equal(got, jtiles.stitch(flows, jspecs))
    assert got.dtype == np.float32 and got.shape == (height, 24)
    assert ptiles.seam_epe(flows, specs) == jtiles.seam_epe(flows, jspecs)
    # restrictions of one global field stitch back to it, seam 0
    field = rng.standard_normal((height, 24)).astype(np.float32)
    parts = [field[s.src0:s.src1] for s in specs]
    assert np.array_equal(ptiles.stitch(parts, specs), field)
    if len(specs) > 1:
        assert ptiles.seam_epe(parts, specs) == 0.0
    else:
        assert ptiles.seam_epe(parts, specs) is None
    # a wrong tile height or count raises as in JAX
    bad = [flows[0][:-1]] + flows[1:]
    assert _outcome(ptiles.stitch, bad, specs)[:2] == _outcome(
        jtiles.stitch, bad, jspecs)[:2]
    assert _outcome(ptiles.stitch, flows[:-1] or [], specs) == _outcome(
        jtiles.stitch, flows[:-1] or [], jspecs)


@pytest.fixture(scope="module")
def engines():
    """(JAX engine, port engine) on one set of TINY weights, tiling past
    4000 padded pixels into 32-row tiles with 8-row halos."""
    jcfg = JaxConfig(**TINY)
    jmodel = JaxRAFTStereo(jcfg)
    dummy = jnp.zeros((1, 64, 64, 3), jnp.float32)
    init = jax.jit(lambda key: jmodel.init(key, dummy, dummy, iters=1,
                                           test_mode=True))
    variables = settle_jax(perturb(init(jax.random.PRNGKey(0)),
                                   np.random.default_rng(7)))
    jeng = JaxService(jcfg, variables, JaxServeConfig(
        iters=ITERS, batch_sizes=(1,), max_batch=1, **TILING))
    state = state_dict_from_jax(variables)
    peng = ServingEngine(RaftStereoConfig(**TINY), state, ServeConfig(
        iters=ITERS, batch_sizes=(1,), max_batch=1, **TILING),
        device="cpu")
    beng = ServingEngine(RaftStereoConfig(**TINY), state, ServeConfig(
        iters=ITERS, batch_sizes=(1, 2, 4), max_batch=4, **TILING),
        device="cpu")
    yield jeng, peng, beng
    for eng in (jeng, peng, beng):
        eng.close()


def _pair(hw=HW, seed=3):
    rng = np.random.default_rng(seed)
    left = textured_image(rng, *hw)
    return left, warp_right(left, disparity_field(rng, *hw))


def test_tiled_request_matches_jax(engines):
    jeng, peng, _ = engines
    left, right = _pair()
    specs = ptiles.plan_tiles(HW[0], TILING["tile_rows"],
                              TILING["tile_halo"])
    assert len(specs) == 4 and {s.height for s in specs} == {48}
    want = jeng.infer(left, right, timeout=600)
    got = peng.infer(left, right, timeout=600)
    assert got.tiles == want.tiles == 4
    assert got.batch_size == want.batch_size == 1
    assert got.flow.shape == want.flow.shape == HW
    np.testing.assert_allclose(got.flow, want.flow, atol=FLOW_ATOL)
    assert abs(got.seam_epe - want.seam_epe) <= FLOW_ATOL
    assert got.seam_epe > 0.0          # the tiles disagree on the overlap
    assert peng.metrics.tiled_requests.value == 1
    assert jeng.metrics.tiled_requests.value == 1
    assert (peng.metrics.tile_seam_epe.count
            == jeng.metrics.tile_seam_epe.count == 1)


def test_tiles_ride_one_batch(engines):
    """The four tiles of one image in one batch-4 dispatch; the stitched
    flow is ``tiles.stitch`` of the engine's answers to the four slices
    in one batch (each slice alone is below the threshold: the same
    bucket and program), bit for bit."""
    _, _, beng = engines
    left, right = _pair()
    specs = ptiles.plan_tiles(HW[0], TILING["tile_rows"],
                              TILING["tile_halo"])
    dispatches = beng.metrics.batches.value
    beng.queue.pause()
    fut = beng.submit(left, right)
    beng.queue.resume()
    got = fut.result(timeout=600)
    assert beng.metrics.batches.value - dispatches == 1
    assert got.batch_size == 4 and got.tiles == 4
    beng.queue.pause()
    futs = [beng.submit(np.ascontiguousarray(left[s.src0:s.src1]),
                        np.ascontiguousarray(right[s.src0:s.src1]))
            for s in specs]
    beng.queue.resume()
    rows = [f.result(timeout=600) for f in futs]
    assert {r.batch_size for r in rows} == {4}
    flows = [r.flow for r in rows]
    assert np.array_equal(got.flow, ptiles.stitch(flows, specs))
    assert got.seam_epe == ptiles.seam_epe(flows, specs)


def test_short_pair_is_not_tiled(engines):
    """A pair past the threshold but within one tile extent runs whole,
    as in JAX."""
    _, peng, _ = engines
    left, right = _pair(hw=(40, 128), seed=4)      # bucket 64x128 > 4000
    res = peng.infer(left, right, timeout=600)
    assert res.tiles is None and res.seam_epe is None
    assert res.flow.shape == (40, 128)
