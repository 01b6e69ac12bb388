"""Port modules against the JAX package's Flax modules (CPU).

Weights are made by the Flax ``init`` from a seed, perturbed with seeded
numpy noise where init leaves them trivial (frozen-BN statistics, norm
affines), and carried to the port by ``state_dict_from_jax``.  Inputs are
seeded numpy arrays; the port is NCHW, the JAX modules NHWC.  Tolerance
atol=rtol=1e-4: stacks of fp32 convs whose sums run in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_stereo_tpu.config import RaftStereoConfig as JaxConfig
from raft_stereo_tpu.models import extractor as jextractor
from raft_stereo_tpu.models import norm as jnorm
from raft_stereo_tpu.models.update import BasicMultiUpdateBlock as JaxUpdate
from raft_stereo_tpu_torch.config import RaftStereoConfig
from raft_stereo_tpu_torch.io.jax_weights import state_dict_from_jax
from raft_stereo_tpu_torch.models import extractor, norm
from raft_stereo_tpu_torch.models.update import BasicMultiUpdateBlock
from torch_port_support import nchw, nhwc, perturb

TOL = dict(atol=1e-4, rtol=1e-4)
TINY = dict(hidden_dims=(32, 32, 32), fnet_dim=64)


def _jax_init(module, *args):
    return module.init(jax.random.PRNGKey(0), *args)


@pytest.mark.parametrize("kind", ["batch", "instance", "group"])
def test_norm_matches_jax(rng, kind):
    x = (3 * rng.normal(size=(2, 5, 7, 16)) + 1).astype(np.float32)
    jmod = jnorm.make_norm(kind, 16, None, "norm")
    variables = perturb(_jax_init(jmod, jnp.asarray(x)), rng)
    want = jmod.apply(variables, jnp.asarray(x))
    tmod = norm.make_norm(kind, 16)
    tmod.load_state_dict({k.removeprefix("norm."): v for k, v in
                          state_dict_from_jax(variables).items()},
                         strict=True)
    np.testing.assert_allclose(nhwc(tmod(nchw(x))), np.asarray(want), **TOL)


@pytest.mark.parametrize("norm_fn,stride,cin,planes", [
    ("group", 2, 16, 24), ("batch", 1, 24, 24), ("instance", 2, 8, 16)])
def test_residual_block_matches_jax(rng, norm_fn, stride, cin, planes):
    x = rng.normal(size=(2, 10, 12, cin)).astype(np.float32)
    jmod = jextractor.ResidualBlock(planes, norm_fn, stride)
    variables = perturb(_jax_init(jmod, jnp.asarray(x)), rng)
    want = jmod.apply(variables, jnp.asarray(x))
    tmod = extractor.ResidualBlock(cin, planes, norm_fn, stride)
    tmod.load_state_dict(state_dict_from_jax(variables), strict=True)
    with torch.no_grad():
        np.testing.assert_allclose(nhwc(tmod(nchw(x))), np.asarray(want),
                                   **TOL)


def test_basic_encoder_matches_jax(rng):
    x = rng.uniform(-1, 1, size=(2, 32, 48, 3)).astype(np.float32)
    jmod = jextractor.BasicEncoder(output_dim=64, norm_fn="instance",
                                   downsample=2)
    variables = perturb(_jax_init(jmod, jnp.asarray(x)), rng)
    want = jmod.apply(variables, jnp.asarray(x))
    tmod = extractor.BasicEncoder(64, "instance", 2)
    tmod.load_state_dict(state_dict_from_jax(variables), strict=True)
    with torch.no_grad():
        np.testing.assert_allclose(nhwc(tmod(nchw(x))), np.asarray(want),
                                   **TOL)


def test_multi_basic_encoder_matches_jax(rng):
    x = rng.uniform(-1, 1, size=(1, 64, 64, 3)).astype(np.float32)
    dims = ((32, 32, 32), (24, 24, 24))
    jmod = jextractor.MultiBasicEncoder(output_dims=dims, norm_fn="batch",
                                        downsample=2, num_layers=3)
    variables = perturb(_jax_init(jmod, jnp.asarray(x)), rng)
    want_levels, _ = jmod.apply(variables, jnp.asarray(x))
    tmod = extractor.MultiBasicEncoder(dims, "batch", 2, 3)
    tmod.load_state_dict(state_dict_from_jax(variables), strict=True)
    with torch.no_grad():
        got_levels = tmod(nchw(x))
    assert len(got_levels) == len(want_levels) == 3
    for got, want in zip(got_levels, want_levels):
        for g, w in zip(got, want):
            np.testing.assert_allclose(nhwc(g), np.asarray(w), **TOL)


@pytest.mark.parametrize("fused", ["off", "auto"])
def test_update_block_matches_jax(rng, fused):
    jcfg = JaxConfig(**TINY, fused_gru=fused)
    cfg = RaftStereoConfig(**TINY, fused_gru=fused)
    hd = cfg.hidden_dims
    shapes = [(1, 12, 20), (1, 6, 10), (1, 3, 5)]
    net = [np.tanh(rng.normal(size=s + (c,))).astype(np.float32)
           for s, c in zip(shapes, hd)]
    context = [tuple(rng.normal(size=s + (c,)).astype(np.float32)
                     for _ in range(3)) for s, c in zip(shapes, hd)]
    corr = rng.normal(size=shapes[0] + (cfg.corr_channels,)).astype(
        np.float32)
    flow = np.concatenate([rng.normal(0, 3, size=shapes[0] + (1,)),
                           np.zeros(shapes[0] + (1,))], -1).astype(np.float32)
    jmod = JaxUpdate(jcfg)
    jargs = ([jnp.asarray(n) for n in net],
             [tuple(map(jnp.asarray, c)) for c in context],
             jnp.asarray(corr), jnp.asarray(flow))
    variables = perturb(_jax_init(jmod, *jargs), rng)
    want_net, want_mask, want_delta = jmod.apply(variables, *jargs)
    tmod = BasicMultiUpdateBlock(cfg)
    tmod.load_state_dict(state_dict_from_jax(variables), strict=True)
    with torch.no_grad():
        got_net, got_mask, got_delta = tmod(
            [nchw(n) for n in net],
            [tuple(map(nchw, c)) for c in context], nchw(corr),
            nchw(flow))
    for g, w in zip(got_net, want_net):
        np.testing.assert_allclose(nhwc(g), np.asarray(w), **TOL)
    np.testing.assert_allclose(nhwc(got_mask), np.asarray(want_mask), **TOL)
    np.testing.assert_allclose(nhwc(got_delta), np.asarray(want_delta),
                               **TOL)
