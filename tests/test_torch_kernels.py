"""The port's two kernel modules against the JAX package's Pallas kernels.

On the CPU each port wrapper runs its plain version; the JAX kernels run
in Pallas interpret mode, as the JAX package's own kernel tests run them.
The CUDA kernels themselves are held against the plain versions by
tests/test_torch_cuda.py, on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_stereo_tpu.kernels import corr_lookup as jcorr_lookup
from raft_stereo_tpu.kernels import gru_fused as jgru_fused
from raft_stereo_tpu.models.corr import build_corr_pyramid as jax_pyramid
from raft_stereo_tpu_torch.kernels.corr_lookup import lookup_pyramid_fused
from raft_stereo_tpu_torch.kernels.gru_fused import gru_gates_fused
from raft_stereo_tpu_torch.models.corr import build_corr_pyramid

RADIUS = 4


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
