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
from raft_stereo_tpu.kernels import corr_lookup as jcorr_lookup
from raft_stereo_tpu.models import extractor as jextractor
from raft_stereo_tpu.models import norm as jnorm
from raft_stereo_tpu.models.update import BasicMultiUpdateBlock as JaxUpdate
from raft_stereo_tpu_torch.config import RaftStereoConfig
from raft_stereo_tpu_torch.io.jax_weights import state_dict_from_jax
from raft_stereo_tpu_torch.models import extractor, norm
from raft_stereo_tpu_torch.models.update import BasicMultiUpdateBlock
from torch_port_support import assert_bf16_close, nchw, nhwc, perturb

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


@pytest.mark.parametrize("kind", ["batch", "instance"])
def test_norm_bf16_matches_jax(rng, kind):
    """bf16 inputs: frozen BN casts its fp32 inv/shift to bf16 and applies
    them in bf16; instance norm takes fp32 statistics and returns bf16."""
    x = jnp.asarray((3 * rng.normal(size=(2, 5, 7, 16)) + 1).astype(
        np.float32)).astype(jnp.bfloat16)
    jmod = jnorm.make_norm(kind, 16, jnp.bfloat16, "norm")
    variables = perturb(_jax_init(jmod, x), rng)
    want = np.asarray(jmod.apply(variables, x).astype(jnp.float32))
    tmod = norm.make_norm(kind, 16)
    tmod.load_state_dict({k.removeprefix("norm."): v for k, v in
                          state_dict_from_jax(variables).items()},
                         strict=True)
    got = tmod(nchw(x.astype(jnp.float32)).bfloat16())
    assert got.dtype == torch.bfloat16
    assert_bf16_close(nhwc(got.float()), want, atol=0)


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


def test_multi_basic_encoder_dual_input_matches_jax(rng):
    """``dual_inp``: the trunk runs on both images, the heads on the left
    half only; ``v`` is the whole batch's trunk output."""
    x = rng.uniform(-1, 1, size=(2, 64, 64, 3)).astype(np.float32)
    dims = ((32, 32, 32), (24, 24, 24))
    jmod = jextractor.MultiBasicEncoder(output_dims=dims, norm_fn="batch",
                                        downsample=3, num_layers=2,
                                        dual_inp=True)
    variables = perturb(_jax_init(jmod, jnp.asarray(x)), rng)
    want_levels, want_v = jmod.apply(variables, jnp.asarray(x))
    tmod = extractor.MultiBasicEncoder(dims, "batch", 3, 2, dual_inp=True)
    tmod.load_state_dict(state_dict_from_jax(variables), strict=True)
    with torch.no_grad():
        got_levels, got_v = tmod(nchw(x))
    assert got_v.shape[0] == 2 and got_levels[0][0].shape[0] == 1
    np.testing.assert_allclose(nhwc(got_v), np.asarray(want_v), **TOL)
    for got, want in zip(got_levels, want_levels):
        for g, w in zip(got, want):
            np.testing.assert_allclose(nhwc(g), np.asarray(w), **TOL)


def test_multi_basic_encoder_matches_jax(rng):
    x = rng.uniform(-1, 1, size=(1, 64, 64, 3)).astype(np.float32)
    dims = ((32, 32, 32), (24, 24, 24))
    jmod = jextractor.MultiBasicEncoder(output_dims=dims, norm_fn="batch",
                                        downsample=2, num_layers=3)
    variables = perturb(_jax_init(jmod, jnp.asarray(x)), rng)
    want_levels, want_v = jmod.apply(variables, jnp.asarray(x))
    tmod = extractor.MultiBasicEncoder(dims, "batch", 2, 3)
    tmod.load_state_dict(state_dict_from_jax(variables), strict=True)
    with torch.no_grad():
        got_levels, got_v = tmod(nchw(x))
    np.testing.assert_allclose(nhwc(got_v), np.asarray(want_v), **TOL)
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


# (levels, iter_fine, iter_mid, iter_coarse, update) of the slow-fast
# schedule: per iteration, 2 levels run the mid-only pre-update (net only)
# and the full update; 3 levels run a coarse-only and a mid+coarse
# pre-update, then the full update.
@pytest.mark.parametrize("flags", [
    (2, False, True, False, False), (2, True, True, False, True),
    (3, False, False, True, False), (3, False, True, True, False),
    (3, True, True, True, True)])
def test_slow_fast_update_matches_jax(rng, flags):
    n, iter_fine, iter_mid, iter_coarse, update = flags
    kw = dict(TINY, n_gru_layers=n, n_downsample=3, slow_fast_gru=True)
    jcfg, cfg = JaxConfig(**kw), RaftStereoConfig(**kw)
    hd = cfg.hidden_dims
    shapes = [(1, 8, 12), (1, 4, 6), (1, 2, 3)][:n]
    net = [np.tanh(rng.normal(size=s + (c,))).astype(np.float32)
           for s, c in zip(shapes, hd)]
    context = [tuple(rng.normal(size=s + (c,)).astype(np.float32)
                     for _ in range(3)) for s, c in zip(shapes, hd)]
    corr = rng.normal(size=shapes[0] + (cfg.corr_channels,)).astype(
        np.float32)
    flow = np.concatenate([rng.normal(0, 3, size=shapes[0] + (1,)),
                           np.zeros(shapes[0] + (1,))], -1).astype(np.float32)
    jmod = JaxUpdate(jcfg)
    jargs = ([jnp.asarray(h) for h in net],
             [tuple(map(jnp.asarray, c)) for c in context],
             jnp.asarray(corr), jnp.asarray(flow))
    variables = perturb(_jax_init(jmod, *jargs), rng)
    want = jmod.apply(variables, *jargs, iter_fine=iter_fine,
                      iter_mid=iter_mid, iter_coarse=iter_coarse,
                      update=update)
    tmod = BasicMultiUpdateBlock(cfg)
    tmod.load_state_dict(state_dict_from_jax(variables), strict=True)
    with torch.no_grad():
        got = tmod([nchw(h) for h in net],
                   [tuple(map(nchw, c)) for c in context], nchw(corr),
                   nchw(flow), iter_fine=iter_fine, iter_mid=iter_mid,
                   iter_coarse=iter_coarse, update=update)
    want_net = want[0] if update else want
    got_net = got[0] if update else got
    assert len(got_net) == n
    for g, w in zip(got_net, want_net):
        np.testing.assert_allclose(nhwc(g), np.asarray(w), **TOL)
    if update:
        for g, w in zip(got[1:], want[1:]):
            np.testing.assert_allclose(nhwc(g), np.asarray(w), **TOL)


@pytest.mark.parametrize("fused", ["off", "auto"])
def test_two_level_update_bf16_matches_jax(rng, fused):
    """The realtime update block in bf16, on the plain gate convs ("off",
    against the Flax convs) and on the gate op ("auto", against the Pallas
    kernel in interpret mode).  JAX rounds bf16 after every op and its
    sigmoid is 1/(1+exp(-x)) op by op, where torch's rounds once, so
    outputs differ by a few ulps: measured up to 2 ulps of each output's
    largest value.  Bound: 4 ulps of that value."""
    kw = dict(TINY, n_gru_layers=2, n_downsample=3, slow_fast_gru=True,
              mixed_precision=True, fused_gru=fused)
    jcfg, cfg = JaxConfig(**kw), RaftStereoConfig(**kw)
    shapes = [(1, 8, 12), (1, 4, 6)]

    def bf16(a):
        return jnp.asarray(a, jnp.float32).astype(jnp.bfloat16)

    def port(a):
        return nchw(np.asarray(a.astype(jnp.float32))).bfloat16()

    net = [bf16(np.tanh(rng.normal(size=s + (c,))))
           for s, c in zip(shapes, cfg.hidden_dims)]
    context = [tuple(bf16(rng.normal(size=s + (c,))) for _ in range(3))
               for s, c in zip(shapes, cfg.hidden_dims)]
    corr = bf16(rng.normal(size=shapes[0] + (cfg.corr_channels,)))
    flow = bf16(np.concatenate([rng.normal(0, 3, size=shapes[0] + (1,)),
                                np.zeros(shapes[0] + (1,))], -1))
    jmod = JaxUpdate(jcfg, dtype=jnp.bfloat16)
    variables = perturb(_jax_init(jmod, net, context, corr, flow), rng)
    jcorr_lookup._interpret_override = True if fused == "auto" else None
    try:
        want_net, want_mask, want_delta = jmod.apply(
            variables, net, context, corr, flow, iter_coarse=False)
    finally:
        jcorr_lookup._interpret_override = None
    tmod = BasicMultiUpdateBlock(cfg)
    tmod.load_state_dict(state_dict_from_jax(variables), strict=True)
    with torch.no_grad():
        got_net, got_mask, got_delta = tmod(
            [port(n) for n in net], [tuple(map(port, c)) for c in context],
            port(corr), port(flow), iter_coarse=False)
    for g, w in zip([*got_net, got_mask, got_delta],
                    [*want_net, want_mask, want_delta]):
        assert g.dtype == torch.bfloat16
        w = np.asarray(w.astype(jnp.float32))
        ulp = 2.0 ** (np.floor(np.log2(np.abs(w).max())) - 7)
        np.testing.assert_allclose(nhwc(g.float()), w, atol=4 * ulp, rtol=0)
