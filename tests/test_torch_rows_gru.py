"""The row-sharded GRU loop of the port (parallel/rows_gru.py) against the
JAX package's (CPU).

The same numpy-seeded weights (a JAX ``model.init``, carried over by
``io/jax_weights.state_dict_from_jax``) and pair go through JAX's model
with ``rows_gru`` on the forced host devices of tests/conftest.py, the
port's with every shard on the CPU, and the port's unsharded model.  The
claim is equality on the owned rows up to float reassociation where the
halo covers one iteration's row receptive field; the bounds are the JAX
package's tests/test_rows_gru.py: flows within 1e-3 relative plus 5e-3
px, the train step's loss within 1e-4 relative and its gradients leaf by
leaf (``torch_rows_support.grad_gaps``: q99 under 5e-3, every element
under 3e-2 of the leaf's scale).  Every validation is held message for
message against the JAX package's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from raft_stereo_tpu.config import RaftStereoConfig as JaxConfig
from raft_stereo_tpu.models.raft_stereo import RAFTStereo as JaxModel
from raft_stereo_tpu.parallel import rows_gru as jax_rows_gru
from raft_stereo_tpu.parallel.rows_sharded import \
    rows_sharding as jax_rows_sharding
from raft_stereo_tpu_torch.config import RaftStereoConfig
from raft_stereo_tpu_torch.io.jax_weights import state_dict_from_jax
from raft_stereo_tpu_torch.models.raft_stereo import RAFTStereo
from raft_stereo_tpu_torch.ops import resize
from raft_stereo_tpu_torch.parallel import rows_gru
from raft_stereo_tpu_torch.parallel.mesh import make_mesh
from raft_stereo_tpu_torch.parallel.rows_sharded import rows_sharding
from raft_stereo_tpu_torch.training.loss import sequence_loss
from torch_port_support import perturb
from torch_rows_support import grad_gaps

# JAX's tests/test_rows_gru.py: 3 GRU levels (both interp sites), small
# widths, the plain ``reg`` correlation
SMALL = dict(n_gru_layers=3, hidden_dims=(48, 48, 48), fnet_dim=96,
             corr_levels=2, corr_radius=3, corr_backend="reg")
HW = (192, 48)            # fine level 48 rows: slab 24 = 2 x halo 12
HALO = 12
ITERS = 3


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    jcfg = JaxConfig(**SMALL)
    dummy = jnp.zeros((1,) + HW + (3,), jnp.float32)
    variables = perturb(jax.jit(lambda k: JaxModel(jcfg).init(
        k, dummy, dummy, iters=1, test_mode=True))(jax.random.PRNGKey(0)),
        np.random.default_rng(9))
    return variables, state_dict_from_jax(variables)


def _pair(seed, b=1):
    rng = np.random.default_rng(seed)
    return [rng.uniform(0, 255, (b,) + HW + (3,)).astype(np.float32)
            for _ in range(2)]


def _port(state, **kw):
    model = RAFTStereo(RaftStereoConfig(**SMALL, **kw))
    model.load_state_dict(state)
    return model


def _mesh(n=2):
    return make_mesh(n_rows=n, devices=["cpu"] * n)


def _jax_rows(variables, l, r, test_mode, **kw):
    jcfg = JaxConfig(**SMALL, rows_shards=2, rows_gru=True,
                     rows_gru_halo=HALO, **kw)
    with jax_rows_sharding(Mesh(np.array(jax.devices()[:2]), ("data",))):
        return jax.jit(lambda v, a, b: JaxModel(jcfg).apply(
            v, a, b, iters=ITERS, test_mode=test_mode))(variables, l, r)


@pytest.mark.parametrize("test_mode", [True, False])
def test_rows_gru_matches_jax_and_unsharded(weights, test_mode):
    """Test mode (flow_low, flow_up) and train mode (every iteration's
    upsampled flow, through the ``remat_gru`` checkpoint that saves the
    lookup)."""
    variables, state = weights
    l, r = _pair(0)
    want = _jax_rows(variables, l, r, test_mode)
    plain = _port(state).eval()
    model = _port(state, rows_shards=2, rows_gru=True,
                  rows_gru_halo=HALO).eval()
    lt, rt = torch.from_numpy(l), torch.from_numpy(r)
    with torch.no_grad():
        ref = plain(lt, rt, iters=ITERS, test_mode=test_mode)
        with rows_sharding(_mesh()):
            got = model(lt, rt, iters=ITERS, test_mode=test_mode)
    if not test_mode:
        got, ref, want = (got,), (ref,), (want,)
    for g, rf, w in zip(got, ref, want):
        assert g.shape == rf.shape == w.shape
        np.testing.assert_allclose(g.numpy(), rf.numpy(), rtol=1e-3,
                                   atol=5e-3)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-3,
                                   atol=5e-3)


@pytest.mark.parametrize("remat_save", [("corr_lookup",),
                                        ("corr_lookup", "gru_gates"),
                                        ("motion_features",), ()])
def test_rows_gru_training_gradients_match(weights, remat_save):
    """The loss and every parameter's gradient of a batch-2 train step
    through the sharded loop against the unsharded step, under each
    ``remat_save`` policy (the halo copies transpose to copies back and
    the cropped rows carry no gradient)."""
    _, state = weights
    l, r = (torch.from_numpy(a) for a in _pair(1, b=2))
    rng = np.random.default_rng(2)
    flow_gt = torch.from_numpy(rng.uniform(-8, 0, (2,) + HW).astype(
        np.float32))
    valid = torch.ones((2,) + HW)
    out = {}
    for what, kw in (("plain", {}), ("rows", dict(
            rows_shards=2, rows_gru=True, rows_gru_halo=HALO))):
        model = _port(state, remat_save=remat_save, **kw).train()
        with rows_sharding(_mesh()):
            loss = sequence_loss(model(l, r, iters=2, test_mode=False),
                                 flow_gt, valid)[0]
        loss.backward()
        out[what] = (loss.item(), {n: p.grad.clone() for n, p in
                                   model.named_parameters()
                                   if p.grad is not None})
    np.testing.assert_allclose(out["rows"][0], out["plain"][0], rtol=1e-4)
    q99, worst, skipped = grad_gaps(out["rows"][1], out["plain"][1])
    assert q99 < 5e-3 and worst < 3e-2, (q99, worst)
    assert skipped < len(out["plain"][1]) // 2


def test_rows_gru_slow_fast_two_level(weights):
    """The realtime-style coupling (2 GRU levels, the slow-fast schedule's
    extra mid-level updates) at the default halo."""
    torch.manual_seed(0)
    kw = dict(SMALL, n_gru_layers=2, slow_fast_gru=True)
    plain = RAFTStereo(RaftStereoConfig(**kw)).eval()
    model = RAFTStereo(RaftStereoConfig(**kw, rows_shards=2, rows_gru=True))
    model.load_state_dict(plain.state_dict())
    model.eval()
    rng = np.random.default_rng(4)
    l, r = (torch.from_numpy(rng.uniform(0, 255, (1, 256, 48, 3)).astype(
        np.float32)) for _ in range(2))
    with torch.no_grad():
        ref = plain(l, r, iters=ITERS)
        with rows_sharding(_mesh()):
            got = model(l, r, iters=ITERS)
    for g, rf in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), rf.numpy(), rtol=1e-3,
                                   atol=5e-3)


@pytest.mark.parametrize("kw", [dict(rows_gru=True),
                                dict(rows_gru=True, rows_shards=2,
                                     corr_w2_shards=2),
                                dict(rows_gru=True, rows_shards=2,
                                     rows_gru_halo=10),
                                dict(rows_shards=2, rows_gru_halo=4),
                                dict(rows_gru=True, rows_shards=2,
                                     exit_threshold_px=0.1)])
def test_config_validation_matches_jax(kw):
    with pytest.raises(ValueError) as want:
        JaxConfig(**kw)
    with pytest.raises(ValueError) as got:
        RaftStereoConfig(**kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("h_f,n,halo", [(48, 2, 12), (50, 2, 12),
                                        (48, 2, 16), (44, 2, 8),
                                        (96, 4, 16)])
def test_geometry_validation_matches_jax(h_f, n, halo):
    """``validate_rows_gru`` and ``_geometry``: the halo it returns or the
    ValueError it raises (divisibility, pyramid alignment, a slab shorter
    than 2 x halo), the JAX package's."""
    cfg = dict(SMALL, rows_shards=n, rows_gru=True, rows_gru_halo=halo)
    try:
        want = jax_rows_gru.validate_rows_gru(JaxConfig(**cfg), h_f, n)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            rows_gru.validate_rows_gru(RaftStereoConfig(**cfg), h_f, n)
        assert str(got.value) == str(e)
        return
    assert rows_gru.validate_rows_gru(RaftStereoConfig(**cfg), h_f,
                                      n) == want
    for a, b in zip(rows_gru._geometry(h_f, n, want),
                    jax_rows_gru._geometry(h_f, n, want)):
        np.testing.assert_array_equal(a, b)


def test_window_geometry_too_small_is_refused_in_the_model(weights):
    """A slab shorter than 2 x halo fails in the forward with the fix-it
    message, instead of losing rows."""
    _, state = weights
    model = _port(state, rows_shards=2, rows_gru=True,
                  rows_gru_halo=16).eval()
    img = torch.zeros((1, 96, 48, 3))
    with rows_sharding(_mesh()), pytest.raises(ValueError,
                                               match="ppermute"):
        model(img, img, iters=1)


def test_default_halo_matches_jax():
    for kw in (dict(), dict(slow_fast_gru=True),
               dict(slow_fast_gru=True, n_gru_layers=2)):
        assert rows_gru.default_gru_halo(RaftStereoConfig(**kw)) == \
            jax_rows_gru.default_gru_halo(JaxConfig(**kw))


def test_restricted_interp_matches_jax_and_fails_loudly(monkeypatch):
    """The restricted matrices are JAX's; a matrix whose sources fall
    more than a row outside the window raises the explicit
    AssertionError, and an unregistered site the KeyError."""
    slab, starts, _, _ = rows_gru._geometry(48, 2, 12)
    for l in range(2):
        args = (48 >> (l + 1), 48 >> l, starts >> (l + 1), starts >> l,
                (slab >> (l + 1)) + 2 * (12 >> (l + 1)),
                (slab >> l) + 2 * (12 >> l))
        np.testing.assert_array_equal(
            rows_gru._restricted_rows_interp(*args),
            jax_rows_gru._restricted_rows_interp(*args))

    def shifted(src, dst):
        m = np.zeros((dst, src), np.float32)
        m[:, -1] = 1.0          # every output from the last source row
        return m
    monkeypatch.setattr(rows_gru, "interp_matrix_np", shifted)
    monkeypatch.setattr(jax_rows_gru, "_interp_matrix", shifted)
    args = (24, 48, starts >> 1, starts, 18, 36)
    with pytest.raises(AssertionError) as want:
        jax_rows_gru._restricted_rows_interp(*args)
    with pytest.raises(AssertionError) as got:
        rows_gru._restricted_rows_interp(*args)
    assert str(got.value) == str(want.value)
    interp = rows_gru._make_window_interp({(18, 36): torch.zeros(36, 18)})
    with pytest.raises(KeyError) as e:
        interp(torch.zeros((1, 4, 10, 8)), torch.zeros((1, 4, 20, 8)))
    assert "no restricted interp matrix for window rows 10->20" in str(
        e.value)
    assert resize.interp_matrix_np(5, 9).shape == (9, 5)


@pytest.mark.parametrize("kw,msg", [
    (dict(return_hidden=True), "hidden_init/return_hidden are unsupported "
     "with rows_gru (the sharded loop executor owns its own state layout)"),
    (dict(return_confidence=True), "return_confidence is unsupported with "
     "rows_gru (the sharded loop executor owns its own state layout)"),
    (dict(return_ctx=True), "ctx_init/return_ctx are unsupported with "
     "rows_gru (the sharded loop executor owns its own context layout)")])
def test_rows_gru_refusals_as_jax(weights, kw, msg):
    _, state = weights
    model = _port(state, rows_shards=2, rows_gru=True).eval()
    img = torch.zeros((1,) + HW + (3,))
    with pytest.raises(ValueError) as e:
        model(img, img, iters=1, **kw)
    assert str(e.value) == msg


def test_update_block_default_interp_is_bitwise(weights):
    """The ``interp_fn`` hook's default is ``interp_like``: passing it
    explicitly changes nothing, bit for bit."""
    _, state = weights
    model = _port(state).eval()
    ub = model.update_block
    rng = np.random.default_rng(8)
    net = [torch.from_numpy(rng.standard_normal((1, 48, 16 >> l, 8 >> l))
                            .astype(np.float32)) for l in range(3)]
    ctx = [tuple(torch.from_numpy(rng.standard_normal(
        (1, 48, 16 >> l, 8 >> l)).astype(np.float32)) for _ in range(3))
        for l in range(3)]
    corr = torch.from_numpy(rng.standard_normal((1, 14, 16, 8)).astype(
        np.float32))
    flow = torch.zeros((1, 2, 16, 8))
    with torch.no_grad():
        a = ub(net, ctx, corr, flow)
        b = ub(net, ctx, corr, flow, interp_fn=resize.interp_like)
    for x, y in zip(a[0] + [a[1], a[2]], b[0] + [b[1], b[2]]):
        assert torch.equal(x, y)
    assert dataclasses.asdict(JaxConfig(rows_shards=2, rows_gru=True)) == \
        RaftStereoConfig(rows_shards=2, rows_gru=True).to_dict()


def _train_losses(**kw):
    """Two steps of ``train()`` at batch 1 on the synthetic loader: each
    step's loss (the weights are the seed's, whatever the sharding)."""
    from raft_stereo_tpu_torch.config import TrainConfig
    from raft_stereo_tpu_torch.data.synthetic import SyntheticStereoLoader
    from raft_stereo_tpu_torch.training.train_loop import train

    cfg = {k: v for k, v in kw.items() if k != "mesh_devices"}
    tc = TrainConfig(batch_size=1, train_iters=2, image_size=HW,
                     num_steps=2, validation_frequency=100, seed=3)
    losses = []
    train(RaftStereoConfig(**SMALL, **cfg), tc, name="cp",
          checkpoint_dir=None, log_dir=None,
          loader=SyntheticStereoLoader(1, HW, seed=5), device="cpu",
          on_step=lambda step, m: losses.append(float(m["loss"])),
          **({"mesh_devices": kw["mesh_devices"]} if "mesh_devices" in kw
             else {}))
    return losses


def test_train_loop_over_a_group_matches_unsharded():
    """``train()`` with ``rows_shards=2, rows_gru`` over a group of two
    CPU devices (``mesh_devices``): both steps' losses within the JAX
    package's 1e-4 relative of the unsharded ``train()`` (the second
    step after one optimizer update through the sharded gradients)."""
    want = _train_losses()
    got = _train_losses(rows_shards=2, rows_gru=True, rows_gru_halo=HALO,
                        mesh_devices=["cpu", "cpu"])
    assert len(got) == len(want) == 2
    np.testing.assert_allclose(got, want, rtol=1e-4)


@pytest.mark.parametrize("kw,tc_kw", [
    (dict(rows_shards=2, use_mesh=False), {}),
    (dict(rows_shards=2), dict(image_size=(190, 48))),
    (dict(rows_shards=2, corr_w2_shards=2), {})])
def test_train_loop_mesh_errors_match_jax(kw, tc_kw):
    """The JAX train loop's refusals of the rows and corr axes, message
    for message: ``use_mesh=False``, a crop height not divisible by
    4 x rows, and a group larger than the devices (one CPU here, the
    JAX package's forced host devices lowered to match)."""
    from raft_stereo_tpu.config import TrainConfig as JaxTrainConfig
    from raft_stereo_tpu.training import train_loop as jax_train_loop
    from raft_stereo_tpu_torch.config import TrainConfig
    from raft_stereo_tpu_torch.training.train_loop import train

    use_mesh = kw.pop("use_mesh", True)
    tc = dict(dict(batch_size=2, train_iters=1, image_size=HW,
                   num_steps=1), **tc_kw)
    jax_devices = jax.devices
    try:
        # the port's one CPU device stands for the JAX package's device
        # count in the "exceeds the available devices" case
        jax_train_loop.jax.devices = lambda *a: jax_devices(*a)[:1]
        with pytest.raises(ValueError) as want:
            jax_train_loop.train(JaxConfig(**SMALL, **kw),
                                 JaxTrainConfig(**tc), checkpoint_dir=None,
                                 log_dir=None, use_mesh=use_mesh)
    finally:
        jax_train_loop.jax.devices = jax_devices
    with pytest.raises(ValueError) as got:
        train(RaftStereoConfig(**SMALL, **kw), TrainConfig(**tc),
              checkpoint_dir=None, log_dir=None, device="cpu",
              use_mesh=use_mesh)
    assert str(got.value) == str(want.value)


def test_on_device_takes_the_module_one_thread_at_a_time():
    """The autograd engine recomputes each card's shard on a thread of
    its own: a shard that runs the module on its own parameters waits
    while another thread holds it swapped to its copies."""
    import threading

    from raft_stereo_tpu_torch.parallel.group import moved_state, on_device

    conv = torch.nn.Conv2d(2, 2, 1)
    moved = moved_state(conv, torch.device("meta"))
    inside, done, seen = threading.Event(), threading.Event(), []

    def other_shard():
        with on_device(conv, moved):
            inside.set()
            done.wait(10)

    def lead_shard():
        with on_device(conv, None):
            seen.append(conv.weight.device.type)

    a = threading.Thread(target=other_shard)
    a.start()
    assert inside.wait(10)
    b = threading.Thread(target=lead_shard)
    b.start()
    b.join(0.2)
    assert b.is_alive() and not seen
    done.set()
    a.join(10)
    b.join(10)
    assert seen == ["cpu"]
