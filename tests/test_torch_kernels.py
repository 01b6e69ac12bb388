"""The port's kernel modules against the JAX package's Pallas kernels.

On the CPU each port wrapper runs its plain version; the JAX kernels run
in Pallas interpret mode, as the JAX package's own kernel tests run them.
The CUDA kernels themselves are held against the plain versions by
tests/test_torch_cuda.py, on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_stereo_tpu.kernels import corr_alt as jcorr_alt
from raft_stereo_tpu.kernels import corr_lookup as jcorr_lookup
from raft_stereo_tpu.kernels import gru_fused as jgru_fused
from raft_stereo_tpu.models.corr import build_corr_pyramid as jax_pyramid
from raft_stereo_tpu.models.corr import pool_axis as jax_pool_axis
from raft_stereo_tpu_torch.kernels.corr_alt import alt_lookup_fused
from raft_stereo_tpu_torch.kernels.corr_lookup import lookup_pyramid_fused
from raft_stereo_tpu_torch.kernels.gru_fused import gru_gates_fused
from raft_stereo_tpu_torch.models.corr import build_corr_pyramid
from torch_port_support import assert_bf16_close

RADIUS = 4
DTYPES = {"fp32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _to_torch(a, dtype):
    """A JAX array as a torch tensor of ``dtype`` (exact: the values are
    representable in it)."""
    return torch.from_numpy(np.array(a.astype(jnp.float32))).to(dtype)


def _f32(t):
    return t.float().numpy()


@pytest.fixture
def interpret_mode():
    jcorr_lookup._interpret_override = True
    yield
    jcorr_lookup._interpret_override = None


def _lookup_case(rng, rows, w1, w2, levels):
    vol = rng.normal(size=(1, rows, w1, w2)).astype(np.float32)
    # centers spread past both ends of the widest level
    coords = rng.uniform(-10, w2 + 10, size=(1, rows, w1)).astype(np.float32)
    return vol, coords


# (rows, W1, W2, levels): the first fits the JAX multi-level launch; the
# second has the KITTI level widths 312/156/78/39, whose working set
# exceeds the JAX VMEM budget, so JAX runs one launch per level.
@pytest.mark.parametrize("rows,w1,w2,levels,multi", [
    (3, 40, 40, 4, True),
    (2, 24, 312, 4, False),
])
def test_lookup_matches_jax_kernel(rng, interpret_mode, rows, w1, w2,
                                   levels, multi):
    vol, coords = _lookup_case(rng, rows, w1, w2, levels)
    w2s = [w2 // 2 ** i for i in range(levels)]
    jax_multi = (jcorr_lookup._multi_working_set(w2s, RADIUS, 4)
                 <= jcorr_lookup.VMEM_BUDGET)
    assert jax_multi == multi
    want = np.asarray(jcorr_lookup.lookup_pyramid_fused(
        jax_pyramid(jnp.asarray(vol), levels), jnp.asarray(coords), RADIUS))
    pyr = build_corr_pyramid(torch.from_numpy(vol), levels)
    before = lookup_pyramid_fused.launches
    got = lookup_pyramid_fused(pyr, torch.from_numpy(coords), RADIUS).numpy()
    assert lookup_pyramid_fused.launches == before  # CPU: plain version
    assert got.shape == want.shape == (1, rows, w1, levels * (2 * RADIUS + 1))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def _gates_case(rng, h, w, ch, cx):
    def arr(*shape, scale=1.0):
        return (scale * rng.normal(size=shape)).astype(np.float32)

    cin = ch + cx
    return (arr(1, h, w, ch), arr(1, h, w, cx), arr(1, h, w, ch),
            arr(3, 3, cin, 2 * ch, scale=(2 / (9 * cin)) ** 0.5),
            arr(2 * ch, scale=0.1),
            arr(3, 3, cin, ch, scale=(2 / (9 * cin)) ** 0.5),
            arr(ch, scale=0.1))


# Cin 384 (gru08/gru16: Ch 128 + 256 inputs) and Cin 256 (gru32).
@pytest.mark.parametrize("h,w,ch,cx", [(5, 9, 128, 256), (4, 7, 128, 128)])
def test_gates_match_jax_kernel(rng, interpret_mode, h, w, ch, cx):
    args = _gates_case(rng, h, w, ch, cx)
    want = jgru_fused.gru_gates_fused(*map(jnp.asarray, args))
    before = gru_gates_fused.launches
    got = gru_gates_fused(*map(torch.from_numpy, args))
    assert gru_gates_fused.launches == before  # CPU: plain version
    # sums over 9*Cin = 3456 products: atol 1e-4
    for g, wv in zip(got, want):
        assert tuple(g.shape) == wv.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(wv), atol=1e-4,
                                   rtol=0)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_lookup_bf16_levels_match_jax_kernel(rng, interpret_mode, dtype):
    """Kernel #1 over volumes stored in the compute dtype (the
    mixed-precision ``reg_fused`` pyramid, pooled in that dtype)."""
    jdt, tdt = DTYPES[dtype]
    vol, coords = _lookup_case(rng, 3, 24, 37, 4)
    jvol = jnp.asarray(vol).astype(jdt)
    want = jcorr_lookup.lookup_pyramid_fused(
        jax_pyramid(jvol, 4), jnp.asarray(coords), RADIUS)
    got = lookup_pyramid_fused(build_corr_pyramid(_to_torch(jvol, tdt), 4),
                               torch.from_numpy(coords), RADIUS)
    assert got.dtype == tdt and want.dtype == jdt
    if dtype == "fp32":
        np.testing.assert_allclose(_f32(got), np.asarray(want), atol=1e-5,
                                   rtol=0)
    else:
        assert_bf16_close(_f32(got), np.asarray(want.astype(jnp.float32)))


def _alt_case(rng, jdt, rows=3, w1=24, w2=37, d=32, levels=4):
    """Features in ``jdt``, the W-pooled right pyramid (pooled in ``jdt``,
    as the JAX package pools it) and centers past both ends."""
    f1 = jnp.asarray(rng.normal(size=(1, rows, w1, d)).astype(np.float32)
                     ).astype(jdt)
    f2 = jnp.asarray(rng.normal(size=(1, rows, w2, d)).astype(np.float32)
                     ).astype(jdt)
    pyramid = [f2]
    for _ in range(levels - 1):
        pyramid.append(jax_pool_axis(pyramid[-1], axis=2))
    coords = rng.uniform(-10, w2 + 10, size=(1, rows, w1)).astype(np.float32)
    return f1, pyramid, coords


def _assert_alt_close(got, want, dtype):
    # fp32: dots of length D summed in another order; bf16: one bf16 ulp
    if dtype == "fp32":
        np.testing.assert_allclose(_f32(got), np.asarray(want), atol=1e-5,
                                   rtol=0)
    else:
        assert_bf16_close(_f32(got), np.asarray(want.astype(jnp.float32)))


# W2 37 and W1 24 are odd and not multiples of the JAX kernel's W1 block.
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_alt_multi_level_matches_jax_kernel(rng, interpret_mode, dtype):
    """Kernel #6: all levels in one launch (the JAX multi-level route)."""
    jdt, tdt = DTYPES[dtype]
    f1, pyramid, coords = _alt_case(rng, jdt)
    w2s = [p.shape[2] for p in pyramid]
    assert w2s == [37, 18, 9, 4]
    assert (jcorr_alt._multi_alt_scoped_bytes(w2s, 32, f1.dtype.itemsize,
                                              RADIUS)
            <= jcorr_alt._MOSAIC_SCOPED_VMEM)
    want = jcorr_alt.alt_lookup_fused(f1, pyramid, jnp.asarray(coords),
                                      RADIUS)
    before = alt_lookup_fused.launches
    got = alt_lookup_fused(_to_torch(f1, tdt),
                           [_to_torch(p, tdt) for p in pyramid],
                           torch.from_numpy(coords), RADIUS)
    assert alt_lookup_fused.launches == before  # CPU: plain version
    assert got.dtype == tdt and want.dtype == jdt
    assert tuple(got.shape) == want.shape == (1, 3, 24, 4 * (2 * RADIUS + 1))
    _assert_alt_close(got, want, dtype)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("level", [0, 2])
def test_alt_one_level_matches_jax_kernel(rng, interpret_mode, dtype, level):
    """Kernel #7: one level at scale 1/2^l, the JAX per-level route, as a
    one-level call at ``coords / 2^l``."""
    jdt, tdt = DTYPES[dtype]
    f1, pyramid, coords = _alt_case(rng, jdt)
    want = jcorr_alt._alt_level(f1, pyramid[level], jnp.asarray(coords),
                                RADIUS, 1.0 / 2 ** level)
    got = alt_lookup_fused(_to_torch(f1, tdt), [_to_torch(pyramid[level], tdt)],
                           torch.from_numpy(coords) / 2 ** level, RADIUS)
    _assert_alt_close(got, want, dtype)


# Cin 384 (gru08: Ch 128 + 256 inputs) and Cin 256 (gru16 of the realtime
# preset: Ch 128 + 128), bf16 activations with fp32 weights and biases, as
# the model hands them over.
@pytest.mark.parametrize("h,w,ch,cx", [(5, 9, 128, 256), (4, 7, 128, 128)])
def test_gates_bf16_match_jax_kernel(rng, interpret_mode, h, w, ch, cx):
    args = _gates_case(rng, h, w, ch, cx)
    jargs = [jnp.asarray(a) for a in args]
    for i in range(3):
        jargs[i] = jargs[i].astype(jnp.bfloat16)
    want = jgru_fused.gru_gates_fused(*jargs)
    targs = [_to_torch(a, torch.bfloat16) for a in jargs[:3]] + [
        torch.from_numpy(a) for a in args[3:]]
    got = gru_gates_fused(*targs)
    # Both sides sum the same exact bf16 products in fp32 in another order
    # and round once; r*h is rounded to bf16 in between, where a one-ulp
    # flip moves qpre by a weight times that ulp.  Measured within one bf16
    # ulp + 1e-5 on these inputs; the bound is that of the card's check,
    # two ulps + 1e-3.
    for g, wv in zip(got, want):
        assert g.dtype == torch.bfloat16 and wv.dtype == jnp.bfloat16
        assert_bf16_close(_f32(g), np.asarray(wv.astype(jnp.float32)),
                          ulps=2, atol=1e-3)
