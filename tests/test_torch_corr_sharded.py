"""The W2-sharded correlation of the port (parallel/corr_sharded.py)
against the JAX package's (CPU).

The same numpy-seeded features and lookup centres go through three
routes: the JAX package's sharded executor on the forced host devices of
tests/conftest.py, the port's sharded executor with every shard on the
CPU, and the port's unsharded ``reg`` lookup.  Tolerances are the JAX
package's own (tests/test_parallel.py): values within 1e-5, gradients
within 1e-4 relative plus 1e-5; the whole model within 1e-3 relative plus
2e-3 px (two iterations of random weights amplify reassociation), its
train-mode gradients leaf by leaf as tests/test_torch_rows_gru.py holds
them.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_stereo_tpu.config import RaftStereoConfig as JaxConfig
from raft_stereo_tpu.models.raft_stereo import RAFTStereo as JaxModel
from raft_stereo_tpu.parallel import corr_sharding as jax_corr_sharding
from raft_stereo_tpu.parallel import make_mesh as jax_make_mesh
from raft_stereo_tpu.parallel.corr_sharded import \
    make_corr_fn_w2_sharded as jax_w2_sharded
from raft_stereo_tpu_torch.config import RaftStereoConfig
from raft_stereo_tpu_torch.io.jax_weights import state_dict_from_jax
from raft_stereo_tpu_torch.models.corr import make_corr_fn
from raft_stereo_tpu_torch.models.raft_stereo import RAFTStereo
from raft_stereo_tpu_torch.parallel.corr_sharded import (
    _level_widths, active_corr_mesh, corr_sharding, make_corr_fn_w2_sharded)
from raft_stereo_tpu_torch.parallel.mesh import make_mesh
from torch_port_support import perturb
from torch_rows_support import grad_gaps

TINY = dict(hidden_dims=(32, 32, 32), fnet_dim=64, corr_backend="reg")
HW = (64, 96)
ITERS = 2


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _fmaps(rng, b, h, w1, w2, d=16):
    """NHWC numpy features (the JAX layout); the port takes NCHW."""
    return (rng.standard_normal((b, h, w1, d)).astype(np.float32),
            rng.standard_normal((b, h, w2, d)).astype(np.float32))


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _coords(rng, b, h, w1, w2):
    # in range, fractional, out of range, and windows wholly outside a
    # shard (far negative, past the last bin)
    return rng.uniform(-12.0, w2 + 12.0, (b, h, w1)).astype(np.float32)


def _jax_mesh(n):
    return jax_make_mesh(n_data=1, n_corr=n, devices=jax.devices()[:n])


@pytest.mark.parametrize("n_corr", [2, 4])
@pytest.mark.parametrize("w2", [64, 52, 13])
def test_sharded_lookup_matches_jax_and_reg(rng, n_corr, w2):
    """The port's sharded lookup (``reg`` and ``reg_fused``, whose CPU
    lookup is the kernel's plain version at shard-shifted centres) equals
    the unsharded ``reg`` lookup and JAX's sharded one."""
    b, h, w1 = 1, 3, 20
    f1, f2 = _fmaps(rng, b, h, w1, w2)
    coords = _coords(rng, b, h, w1, w2)
    mesh = make_mesh(n_corr=n_corr, devices=["cpu"] * n_corr)
    ref = make_corr_fn(RaftStereoConfig(corr_backend="reg"), _nchw(f1),
                       _nchw(f2))(torch.from_numpy(coords)).numpy()
    jcfg = JaxConfig(corr_w2_shards=n_corr, corr_backend="reg")
    jmesh = _jax_mesh(n_corr)
    with jax_corr_sharding(jmesh):
        want = np.asarray(jax.jit(lambda a, c, x: jax_w2_sharded(
            jcfg, a, c, jmesh)(x))(f1, f2, coords))
    for backend in ("reg", "reg_fused"):
        cfg = RaftStereoConfig(corr_w2_shards=n_corr, corr_backend=backend)
        got = make_corr_fn_w2_sharded(cfg, _nchw(f1), _nchw(f2), mesh)(
            torch.from_numpy(coords)).numpy()
        assert got.shape == ref.shape == want.shape
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_sharded_gradients_match_reg_and_jax(rng):
    """Gradients of a cotangent through the sharded lookup, in both
    feature maps, equal the unsharded ``reg`` lookup's and JAX's."""
    b, h, w1, w2 = 1, 4, 24, 40
    f1, f2 = _fmaps(rng, b, h, w1, w2, d=8)
    coords = _coords(rng, b, h, w1, w2)
    cot = rng.standard_normal((b, h, w1, 4 * 9)).astype(np.float32)
    mesh = make_mesh(n_corr=2, devices=["cpu", "cpu"])

    def port_grads(cfg, sharded):
        a = _nchw(f1).requires_grad_(True)
        c = _nchw(f2).requires_grad_(True)
        fn = (make_corr_fn_w2_sharded(cfg, a, c, mesh) if sharded
              else make_corr_fn(cfg, a, c))
        (fn(torch.from_numpy(coords)) * torch.from_numpy(cot)).sum(
        ).backward()
        return [g.permute(0, 2, 3, 1).numpy() for g in (a.grad, c.grad)]

    ref = port_grads(RaftStereoConfig(corr_backend="reg"), False)
    jcfg = JaxConfig(corr_w2_shards=2, corr_backend="reg")
    jmesh = _jax_mesh(2)

    def jloss(a, c):
        with jax_corr_sharding(jmesh):
            out = jax_w2_sharded(jcfg, a, c, jmesh)(jnp.asarray(coords))
        return jnp.sum(out * cot)

    want = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jnp.asarray(f1),
                                                    jnp.asarray(f2))
    for backend in ("reg", "reg_fused"):
        got = port_grads(RaftStereoConfig(corr_w2_shards=2,
                                          corr_backend=backend), True)
        for g, r, w in zip(got, ref, want):
            np.testing.assert_allclose(g, r, rtol=1e-4, atol=1e-5)
            np.testing.assert_allclose(g, np.asarray(w), rtol=1e-4,
                                       atol=1e-5)


def test_level_widths_and_padding_quantum():
    """Floor-semantics level widths, the JAX package's."""
    from raft_stereo_tpu.parallel.corr_sharded import \
        _level_widths as jax_widths
    for w2 in (13, 52, 64, 250):
        assert _level_widths(w2, 4) == jax_widths(w2, 4)


@pytest.fixture(scope="module")
def weights():
    jcfg = JaxConfig(**TINY)
    dummy = jnp.zeros((1, 64, 64, 3), jnp.float32)
    variables = perturb(jax.jit(lambda k: JaxModel(jcfg).init(
        k, dummy, dummy, iters=1, test_mode=True))(jax.random.PRNGKey(0)),
        np.random.default_rng(3))
    return variables, state_dict_from_jax(variables)


def _pair(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.uniform(0, 255, (1,) + HW + (3,)).astype(np.float32)
            for _ in range(2)]


def test_model_test_mode_matches_jax_and_unsharded(weights):
    """The whole model with ``corr_w2_shards=2``, test mode: the port's
    sharded forward against its unsharded one and JAX's sharded one."""
    variables, state = weights
    l, r = _pair()
    jcfg = JaxConfig(**TINY, corr_w2_shards=2)
    jmesh = _jax_mesh(2)
    with jax_corr_sharding(jmesh):
        want = jax.jit(lambda v, a, b: JaxModel(jcfg).apply(
            v, a, b, iters=ITERS, test_mode=True))(variables, l, r)
    plain = RAFTStereo(RaftStereoConfig(**TINY)).eval()
    plain.load_state_dict(state)
    model = RAFTStereo(RaftStereoConfig(**TINY, corr_w2_shards=2)).eval()
    model.load_state_dict(state)
    lt, rt = torch.from_numpy(l), torch.from_numpy(r)
    with torch.no_grad():
        ref = plain(lt, rt, iters=ITERS)
        with corr_sharding(make_mesh(n_corr=2, devices=["cpu"] * 2)):
            got = model(lt, rt, iters=ITERS)
    for g, rf, w in zip(got, ref, want):
        np.testing.assert_allclose(g.numpy(), rf.numpy(), rtol=1e-3,
                                   atol=2e-3)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-3,
                                   atol=2e-3)


def test_model_train_mode_and_gradients_match_unsharded(weights):
    """Train mode: every iteration's upsampled flow within the JAX
    package's bound of the unsharded model's, and each parameter's
    gradient of one loss leaf by leaf (``grad_gaps``)."""
    _, state = weights
    l, r = (torch.from_numpy(a) for a in _pair(1))
    outs = {}
    for what, kw in (("plain", {}), ("sharded", dict(corr_w2_shards=2))):
        model = RAFTStereo(RaftStereoConfig(**TINY, **kw)).train()
        model.load_state_dict(state)
        with corr_sharding(make_mesh(n_corr=2, devices=["cpu"] * 2)):
            ups = model(l, r, iters=ITERS, test_mode=False)
        (ups.square().mean()).backward()
        outs[what] = (ups.detach(), {n: p.grad.clone() for n, p in
                                     model.named_parameters()
                                     if p.grad is not None})
    np.testing.assert_allclose(outs["sharded"][0].numpy(),
                               outs["plain"][0].numpy(), rtol=1e-3,
                               atol=2e-3)
    q99, worst, skipped = grad_gaps(outs["sharded"][1], outs["plain"][1])
    assert q99 < 5e-3 and worst < 3e-2, (q99, worst)
    assert skipped < len(outs["plain"][1]) // 2


def test_dispatch_requires_an_active_mesh_and_its_size():
    cfg = RaftStereoConfig(corr_w2_shards=2)
    f = torch.zeros((1, 8, 2, 8))
    assert active_corr_mesh() is None
    with pytest.raises(RuntimeError, match="needs an active mesh"):
        make_corr_fn(cfg, f, f)
    with pytest.raises(ValueError) as got:
        make_corr_fn_w2_sharded(cfg, f, f, make_mesh(
            n_corr=4, devices=["cpu"] * 4))
    assert str(got.value) == ("config asks for corr_w2_shards=2 but mesh "
                              "'corr' axis has 4 devices")


def test_alt_refused_as_jax():
    with pytest.raises(ValueError) as want:
        JaxConfig(corr_w2_shards=2, corr_backend="alt")
    with pytest.raises(ValueError) as got:
        RaftStereoConfig(corr_w2_shards=2, corr_backend="alt")
    assert str(got.value) == str(want.value)
    assert dataclasses.asdict(JaxConfig(corr_w2_shards=2)) == \
        RaftStereoConfig(corr_w2_shards=2).to_dict()
