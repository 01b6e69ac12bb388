"""PyTorch port ops against the JAX package's ops (CPU).

The same seeded numpy inputs go through both; the port's ops are NCHW,
the JAX ops NHWC, so the tests transpose.  Tolerance atol=rtol=1e-5: the
two compute the same fp32 arithmetic up to summation order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_stereo_tpu.models.corr import pool_axis as jax_pool_axis
from raft_stereo_tpu.ops import grids as jgrids
from raft_stereo_tpu.ops import padding as jpadding
from raft_stereo_tpu.ops import pooling as jpooling
from raft_stereo_tpu.ops import resize as jresize
from raft_stereo_tpu.ops import sampler as jsampler
from raft_stereo_tpu.ops import upsample as jupsample
from raft_stereo_tpu_torch.models.corr import pool_axis
from raft_stereo_tpu_torch.ops import grids, padding, pooling, resize
from raft_stereo_tpu_torch.ops import sampler, upsample

TOL = dict(atol=1e-5, rtol=1e-5)


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).numpy()


def test_coords_grid_x():
    np.testing.assert_array_equal(
        grids.coords_grid_x(2, 3, 7).numpy(),
        np.asarray(jgrids.coords_grid_x(2, 3, 7)))


@pytest.mark.parametrize("mode", ["sintel", "other"])
@pytest.mark.parametrize("hw", [(375, 1242), (13, 29), (64, 96)])
def test_input_padder(rng, mode, hw):
    x = rng.standard_normal((1, *hw, 3)).astype(np.float32)
    jp = jpadding.InputPadder(x.shape, mode=mode, divis_by=32)
    tp = padding.InputPadder((1, 3, *hw), mode=mode, divis_by=32)
    assert tp.pads == jp.pads
    (want,) = jp.pad(jnp.asarray(x))
    (got,) = tp.pad(_nchw(x))
    np.testing.assert_array_equal(_nhwc(got), np.asarray(want))
    np.testing.assert_array_equal(_nhwc(tp.unpad(got)), x)
    flow = rng.standard_normal((1,) + tuple(got.shape[-2:])).astype(
        np.float32)
    np.testing.assert_array_equal(tp.unpad(torch.from_numpy(flow)).numpy(),
                                  np.asarray(jp.unpad(jnp.asarray(flow))))


@pytest.mark.parametrize("hw", [(7, 9), (8, 8), (24, 78)])
def test_pool2x(rng, hw):
    x = rng.standard_normal((2, *hw, 5)).astype(np.float32)
    np.testing.assert_allclose(_nhwc(pooling.pool2x(_nchw(x))),
                               np.asarray(jpooling.pool2x(jnp.asarray(x))),
                               **TOL)


@pytest.mark.parametrize("hw", [(7, 9), (24, 78)])
def test_pool2x_bf16_matches_jax_exactly(rng, hw):
    """bf16 sums rounded after every add, in the JAX package's order."""
    x = jnp.asarray(rng.standard_normal((2, *hw, 16)).astype(
        np.float32)).astype(jnp.bfloat16)
    want = np.asarray(jpooling.pool2x(x).astype(jnp.float32))
    got = pooling.pool2x(_nchw(np.asarray(x.astype(jnp.float32))).bfloat16())
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_nhwc(got.float()), want)


@pytest.mark.parametrize("w", [39, 40, 1, 312])
def test_pool_axis_odd_widths(rng, w):
    x = rng.standard_normal((2, 3, 5, w)).astype(np.float32)
    got = pool_axis(torch.from_numpy(x)).numpy()
    want = np.asarray(jax_pool_axis(jnp.asarray(x)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)
    got2 = pool_axis(torch.from_numpy(x), axis=2).numpy()
    np.testing.assert_allclose(
        got2, np.asarray(jax_pool_axis(jnp.asarray(x), axis=2)), **TOL)


@pytest.mark.parametrize("src,dst", [((6, 10), (12, 20)), ((5, 7), (3, 4)),
                                     ((4, 4), (4, 4)), ((3, 5), (1, 1))])
def test_resize_align_corners(rng, src, dst):
    x = rng.standard_normal((2, *src, 3)).astype(np.float32)
    got = _nhwc(resize.resize_bilinear_align_corners(_nchw(x), dst))
    want = np.asarray(jresize.resize_bilinear_align_corners(
        jnp.asarray(x), dst))
    np.testing.assert_allclose(got, want, **TOL)
    dest = torch.zeros((2, 1, *dst))
    assert resize.interp_like(_nchw(x), dest).shape == (2, 3, *dst)


def test_resize_align_corners_bf16_matches_jax_exactly(rng):
    """In bf16 the interp matrices are rounded to bf16 and each axis pass
    rounds its output, as in the JAX package: equal bit for bit."""
    x = jnp.asarray(np.tanh(rng.standard_normal((1, 12, 20, 16))).astype(
        np.float32)).astype(jnp.bfloat16)
    want = np.asarray(jresize.resize_bilinear_align_corners(
        x, (24, 40)).astype(jnp.float32))
    got = resize.resize_bilinear_align_corners(
        _nchw(np.asarray(x.astype(jnp.float32))).bfloat16(), (24, 40))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_nhwc(got.float()), want)


def test_linear_sampler_out_of_range(rng):
    vol = rng.standard_normal((2, 3, 5, 17)).astype(np.float32)
    # positions well outside [0, W-1] on both sides, and exact bin edges
    x = rng.uniform(-6, 23, size=(2, 3, 5, 9)).astype(np.float32)
    x[0, 0, 0, :4] = [-1.0, 0.0, 16.0, 17.0]
    got = sampler.linear_sampler_1d(torch.from_numpy(vol),
                                    torch.from_numpy(x)).numpy()
    want = np.asarray(jsampler.linear_sampler_1d(jnp.asarray(vol),
                                                 jnp.asarray(x)))
    np.testing.assert_allclose(got, want, **TOL)
    assert np.all(got[x < -1] == 0) and np.all(got[x > 17] == 0)


@pytest.mark.parametrize("factor", [2, 4, 8])
def test_convex_upsample(rng, factor):
    b, h, w = 2, 5, 6
    flow = rng.standard_normal((b, h, w, 1)).astype(np.float32)
    mask = rng.standard_normal((b, h, w, 9 * factor * factor)).astype(
        np.float32)
    got = _nhwc(upsample.convex_upsample(_nchw(flow), _nchw(mask), factor))
    want = np.asarray(jupsample.convex_upsample(
        jnp.asarray(flow), jnp.asarray(mask), factor))
    np.testing.assert_allclose(got, want, **TOL)
