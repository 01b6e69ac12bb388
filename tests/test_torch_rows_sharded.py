"""The row-sharded trunk of the port (parallel/rows_sharded.py) against
the JAX package's (CPU).

The same numpy-seeded weights (a JAX ``model.init``, carried over by
``io/jax_weights.state_dict_from_jax``) and inputs go through JAX's
``rows_sharded_trunk_apply`` on the forced host devices of
tests/conftest.py, the port's with every shard on the CPU, and the port's
unsharded trunk.  Tolerances are the JAX package's own
(tests/test_rows_sharded.py): the trunk within 1e-5, the whole model
within 1e-3 relative plus 2e-3 px at two iterations.  In fp64 (the norms
take fp64 statistics for fp64 activations) the sharded and unsharded
trunks agree to 1e-10, values and gradients: the exchange of halos and
moments is exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from raft_stereo_tpu.config import RaftStereoConfig as JaxConfig
from raft_stereo_tpu.models.raft_stereo import RAFTStereo as JaxModel
from raft_stereo_tpu.parallel.rows_sharded import \
    rows_sharded_trunk_apply as jax_trunk_apply
from raft_stereo_tpu.parallel.rows_sharded import \
    rows_sharding as jax_rows_sharding
from raft_stereo_tpu_torch.config import RaftStereoConfig
from raft_stereo_tpu_torch.io.jax_weights import state_dict_from_jax
from raft_stereo_tpu_torch.models.raft_stereo import RAFTStereo
from raft_stereo_tpu_torch.parallel.mesh import make_mesh
from raft_stereo_tpu_torch.parallel.rows_sharded import (
    DEFAULT_HALO, active_rows_mesh, rows_sharded_trunk_apply, rows_sharding)
from torch_port_support import perturb

TINY = dict(hidden_dims=(32, 32, 32), fnet_dim=64, corr_backend="reg")


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _jax_mesh(n):
    return Mesh(np.array(jax.devices()[:n]), ("data",))


def _mesh(n):
    return make_mesh(n_rows=n, devices=["cpu"] * n)


def _init(**kw):
    jcfg = JaxConfig(**TINY, **kw)
    dummy = jnp.zeros((1, 64, 64, 3), jnp.float32)
    variables = perturb(jax.jit(lambda k: JaxModel(jcfg).init(
        k, dummy, dummy, iters=1, test_mode=True))(jax.random.PRNGKey(0)),
        np.random.default_rng(5))
    model = RAFTStereo(RaftStereoConfig(**TINY, **kw)).eval()
    model.load_state_dict(state_dict_from_jax(variables))
    return variables, model


@pytest.fixture(scope="module")
def weights():
    """fnet's trunk runs instance norm, cnet's frozen batch norm; the
    second model's cnet runs none."""
    return {"default": _init(), "none": _init(context_norm="none")}


def _trunks(weights, norm_fn):
    """(JAX trunk params, batch stats, port trunk) of one norm."""
    if norm_fn == "instance":
        variables, model = weights["default"]
        return (variables["params"]["fnet"]["trunk"], {}, model.fnet.trunk)
    variables, model = weights["default" if norm_fn == "batch" else "none"]
    return (variables["params"]["cnet"]["trunk"],
            variables.get("batch_stats", {}).get("cnet", {}).get(
                "trunk", {}), model.cnet.trunk)


@pytest.mark.parametrize("norm_fn", ["instance", "batch", "none"])
@pytest.mark.parametrize("n_shards", [2, 4])
def test_rows_trunk_matches_jax_and_unsharded(weights, rng, norm_fn,
                                              n_shards):
    tp, bs, trunk = _trunks(weights, norm_fn)
    h, w = 16 * n_shards, 32
    x = rng.uniform(-1, 1, (2, h, w, 3)).astype(np.float32)
    want = np.asarray(jax_trunk_apply(tp, bs, jnp.asarray(x), norm_fn,
                                      jnp.float32, mesh=_jax_mesh(n_shards),
                                      halo=16))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()
    with torch.no_grad():
        ref = trunk(xt).permute(0, 2, 3, 1).numpy()
        got = rows_sharded_trunk_apply(trunk, xt, norm_fn, _mesh(n_shards),
                                       halo=16).permute(0, 2, 3, 1).numpy()
    assert got.shape == ref.shape == want.shape
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("norm_fn", ["instance", "batch"])
def test_rows_trunk_exact_in_fp64(weights, rng, norm_fn):
    """In fp64 the sharded trunk is the unsharded one: values, the input's
    gradient and every parameter's (each shard's copy of a parameter
    returns its gradient to the one parameter)."""
    _, _, trunk = _trunks(weights, norm_fn)
    trunk = trunk.double()
    try:
        x = torch.from_numpy(rng.uniform(-1, 1, (1, 3, 48, 24)))
        cot = torch.from_numpy(rng.standard_normal((1, 128, 12, 6)))
        outs = []
        for sharded in (False, True):
            trunk.zero_grad()
            xi = x.clone().requires_grad_(True)
            y = (rows_sharded_trunk_apply(trunk, xi, norm_fn, _mesh(3))
                 if sharded else trunk(xi))
            (y * cot).sum().backward()
            outs.append((y.detach(), xi.grad, [p.grad.clone() for p in
                                               trunk.parameters()]))
        (y0, gx0, gp0), (y1, gx1, gp1) = outs
        torch.testing.assert_close(y1, y0, rtol=0, atol=1e-10)
        torch.testing.assert_close(gx1, gx0, rtol=0, atol=1e-10)
        for a, b in zip(gp1, gp0):
            torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-9)
    finally:
        trunk.float()


@pytest.mark.parametrize("h,halo,n", [(36, 16, 2), (64, 10, 2),
                                      (64, 24, 4)])
def test_rows_trunk_errors_match_jax(weights, h, halo, n):
    """H divisible by 4n, the halo by 4, the slab at least the halo: the
    JAX package's ValueErrors, message for message."""
    tp, bs, trunk = _trunks(weights, "instance")
    x = np.zeros((1, h, 16, 3), np.float32)
    with pytest.raises(ValueError) as want:
        jax_trunk_apply(tp, bs, jnp.asarray(x), "instance", jnp.float32,
                        mesh=_jax_mesh(n), halo=halo)
    with pytest.raises(ValueError) as got:
        rows_sharded_trunk_apply(trunk, torch.zeros((1, 3, h, 16)),
                                 "instance", _mesh(n), halo=halo)
    assert str(got.value) == str(want.value)
    assert DEFAULT_HALO == 16


def test_model_rows_shards_matches_jax_and_unsharded(weights, rng):
    """The whole model with ``rows_shards=2`` (the encoders' trunks
    row-sharded, the loop whole), test mode."""
    variables, plain = weights["default"]
    l, r = (rng.uniform(0, 255, (1, 64, 96, 3)).astype(np.float32)
            for _ in range(2))
    jcfg = JaxConfig(**TINY, rows_shards=2)
    with jax_rows_sharding(_jax_mesh(2)):
        want = jax.jit(lambda v, a, b: JaxModel(jcfg).apply(
            v, a, b, iters=2, test_mode=True))(variables, l, r)
    model = RAFTStereo(RaftStereoConfig(**TINY, rows_shards=2)).eval()
    model.load_state_dict(plain.state_dict())
    lt, rt = torch.from_numpy(l), torch.from_numpy(r)
    with torch.no_grad():
        ref = plain(lt, rt, iters=2)
        with rows_sharding(_mesh(2)):
            got = model(lt, rt, iters=2)
    for g, rf, w in zip(got, ref, want):
        np.testing.assert_allclose(g.numpy(), rf.numpy(), rtol=1e-3,
                                   atol=2e-3)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-3,
                                   atol=2e-3)


def test_model_needs_an_active_mesh_of_its_size(weights):
    _, plain = weights["default"]
    model = RAFTStereo(RaftStereoConfig(**TINY, rows_shards=2)).eval()
    model.load_state_dict(plain.state_dict())
    img = torch.zeros((1, 64, 64, 3))
    assert active_rows_mesh() is None
    with pytest.raises(RuntimeError, match="needs an active mesh"):
        model(img, img, iters=1)
    with rows_sharding(_mesh(4)), pytest.raises(ValueError) as e:
        model(img, img, iters=1)
    assert str(e.value) == "rows_shards=2 != mesh axis 'rows' size 4"
    with pytest.raises(ValueError, match="has no 'bogus' axis"):
        with rows_sharding(_mesh(2), axis="bogus"):
            pass


def test_unsupported_norm_refused_as_jax():
    cfg = RaftStereoConfig(**TINY, rows_shards=2, fnet_norm="group")
    model = RAFTStereo(cfg).eval()
    img = torch.zeros((1, 64, 64, 3))
    with rows_sharding(_mesh(2)), pytest.raises(ValueError) as e:
        model(img, img, iters=1)
    assert str(e.value) == ("banded_encoder/rows_shards: norm 'group' with "
                            "n_downsample=2 is unsupported")
    with pytest.raises(ValueError) as want:
        JaxConfig(rows_shards=2, banded_encoder=True)
    with pytest.raises(ValueError) as got:
        RaftStereoConfig(rows_shards=2, banded_encoder=True)
    assert str(got.value) == str(want.value)
