"""The port's training slice against the JAX package (CPU).

Loss, schedule, optimizer, the train-mode forward and one whole training
step of the port against the JAX package's, on the same seeded weights
(a Flax init, norm leaves perturbed, carried by ``state_dict_from_jax``)
and the same seeded batch; then the port's own loop, checkpoint and
configuration.  Every JAX-side value is computed once per module.

Tolerances of the whole step (default TINY, fp32, batch 2, 64x96,
iters 2), each a multiple SPREAD_FACTOR = 4 of the JAX package's own
spread between its kernel path (Pallas in interpret mode) and its plain
XLA path on the same step, measured on these inputs:
* loss: JAX spread 2.86e-6 (port vs JAX kernel path 6.68e-6), epe the
  same; grad_norm: JAX spread 1.31e-3 (port 1.37e-3) on 504.8;
* each gradient leaf, as max |Δ| over max(max |g_leaf|, 1e-3 max |g|):
  JAX spread 7.67e-3 (port 9.90e-3).  The floor keeps the conv biases in
  front of instance norm, whose gradient is zero but for rounding noise,
  from dividing by that noise.  The JAX package's remat-on vs remat-off
  spread is smaller (6.1e-4; loss and epe equal);
* 1px/3px/5px: equal on both sides of the spread; held to one pixel's
  share of the mask;
* every parameter after the step: the first AdamW step moves a parameter
  by about lr(0) (8e-6) times the sign of its gradient, so a gradient of
  rounding-noise size may move the two sides apart by 2 lr(0): measured
  1.59e-5 (port) and 1.22e-5 (JAX's two paths), held to 2.02 lr(0).

The realtime preset in bf16 (the JAX kernel path, interpret mode, as the
port's plain versions mirror the kernels' rounding) on loss and grad_norm:
the JAX spread is 0.382 (loss 34.68) and 18.48 (grad_norm 1071.8); the
port measured 0.053 and 49.66, against SPREAD_FACTOR times the spread.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from raft_stereo_tpu.config import RaftStereoConfig as JaxConfig
from raft_stereo_tpu.config import TrainConfig as JaxTrainConfig
from raft_stereo_tpu.kernels import corr_lookup as jcorr_lookup
from raft_stereo_tpu.models.raft_stereo import RAFTStereo as JaxRAFTStereo
from raft_stereo_tpu.training import loss as jloss
from raft_stereo_tpu.training import optimizer as joptimizer
from raft_stereo_tpu.training.state import TrainState as JaxTrainState
from raft_stereo_tpu.training.step import make_train_step
from raft_stereo_tpu_torch.config import RaftStereoConfig, TrainConfig
from raft_stereo_tpu_torch.data.synthetic import SyntheticStereoLoader
from raft_stereo_tpu_torch.eval.runner import InferenceRunner
from raft_stereo_tpu_torch.io.jax_weights import (load_checkpoint,
                                                  state_dict_from_jax)
from raft_stereo_tpu_torch.models.raft_stereo import RAFTStereo
from raft_stereo_tpu_torch.training.loss import sequence_loss
from raft_stereo_tpu_torch.training.optimizer import (clip_by_global_norm_,
                                                      make_optimizer,
                                                      one_cycle_lr)
from raft_stereo_tpu_torch.training.state import create_train_state
from raft_stereo_tpu_torch.training.step import train_step
from raft_stereo_tpu_torch.training.train_loop import train
from torch_port_support import perturb

TINY = dict(hidden_dims=(32, 32, 32), fnet_dim=64)
HW = (64, 96)
ITERS = 2
FLOW_ATOL = 2e-3          # the whole-forward tolerance of the port
SPREAD_FACTOR = 4.0
JAX_SPREAD = {"loss": 2.86e-6, "epe": 2.86e-6, "grad_norm": 1.31e-3,
              "grad_leaf": 7.67e-3}
RT_JAX_SPREAD = {"loss": 0.382, "grad_norm": 18.48}
TRAIN = dict(batch_size=2, train_iters=ITERS, image_size=HW,
             num_steps=1000)


def _jax_cfg(name, **kw):
    base = (dataclasses.asdict(JaxConfig.realtime()) if name == "realtime"
            else {})
    return JaxConfig(**{**base, **TINY, **kw})


def _port_cfg(jcfg):
    return RaftStereoConfig.from_dict(dataclasses.asdict(jcfg))


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads: the suite runs several workers on one host,
    and the backward's many small CPU kernels slow down many times over
    when every worker's thread pool takes every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def variables():
    """name -> numpy variables of the TINY tree (Flax init under jit,
    seed 0, norm leaves perturbed); the realtime tree serves fp32 and
    bf16 alike."""
    cache = {}

    def get(name):
        if name not in cache:
            model = JaxRAFTStereo(_jax_cfg(name, mixed_precision=False))
            # the parameters do not depend on the image size; a small one
            # compiles faster
            dummy = jnp.zeros((1, 32, 32, 3), jnp.float32)
            init = jax.jit(lambda key: model.init(key, dummy, dummy, iters=1,
                                                  test_mode=True))
            cache[name] = perturb(init(jax.random.PRNGKey(0)),
                                  np.random.default_rng(7))
        return cache[name]
    return get


def _batch():
    """A seeded batch of the JAX loader's dict, the top rows excluded."""
    batch = SyntheticStereoLoader(2, HW, shift=3, seed=5).batch(0)
    batch["valid"][:, :5] = 0
    return batch


def _port_state(jcfg, variables):
    return create_train_state(_port_cfg(jcfg), TrainConfig(**TRAIN), "cpu",
                              state_dict=state_dict_from_jax(variables))


def _adam_mu(opt_state):
    found = []

    def walk(s):
        if hasattr(s, "mu") and hasattr(s, "nu"):
            found.append(s.mu)
        elif isinstance(s, (tuple, list)):
            for x in s:
                walk(x)
    walk(opt_state)
    return found[0]


def _jax_step(jcfg, variables, kernels):
    """JAX ``train_step`` (``make_train_step(donate=False)``) from the
    given variables: (metrics, clipped gradients, new params), both trees
    as port state dicts.  The clipped gradients are read back from the
    optimizer state: after one step AdamW's first moment is exactly
    (1 - b1) times the clipped gradient (rounded once)."""
    jcorr_lookup._interpret_override = True if kernels else None
    try:
        jtc = JaxTrainConfig(**TRAIN)
        tx, _ = joptimizer.make_optimizer(jtc)
        model = JaxRAFTStereo(jcfg)
        state = JaxTrainState.create(apply_fn=model.apply,
                                     params=variables["params"],
                                     batch_stats=variables["batch_stats"],
                                     tx=tx)
        new, metrics = make_train_step(jtc, donate=False)(
            state, {k: jnp.asarray(v) for k, v in _batch().items()})
        grads = jax.tree_util.tree_map(
            lambda m: np.asarray(m) / 0.1,
            jax.device_get(_adam_mu(new.opt_state)))
        return ({k: float(v) for k, v in metrics.items()},
                state_dict_from_jax({"params": grads}),
                state_dict_from_jax({"params": jax.device_get(new.params)}))
    finally:
        jcorr_lookup._interpret_override = None


# ------------------------------------------------------------------ config
def test_train_config_fields_match_jax():
    jfields = {f.name for f in dataclasses.fields(JaxTrainConfig)}
    assert {f.name for f in dataclasses.fields(TrainConfig)} == jfields
    jtc = JaxTrainConfig(batch_size=4, image_size=(256, 512),
                         img_gamma=(0.9, 1.1), gru_telemetry=True)
    tc = TrainConfig.from_dict(jtc.to_dict())
    assert tc.to_dict() == jtc.to_dict()
    assert TrainConfig().to_dict() == JaxTrainConfig().to_dict()


@pytest.mark.parametrize("field,value", [
    ("data_parallel", 2), ("trace_sample_rate", 0.5)])
def test_unported_training_options_raise(field, value):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        TrainConfig(**{field: value})


@pytest.mark.parametrize("field,value", [
    ("device_photometric", True), ("anomaly_policy", True),
    ("checkpoint_keep", 3)])
def test_ported_training_options_round_trip(field, value):
    """The options the training entry point now runs construct, and
    round-trip with the JAX package's ``TrainConfig.to_dict()``."""
    tc = TrainConfig(**{field: value})
    jtc = JaxTrainConfig(**{field: value})
    assert tc.to_dict() == jtc.to_dict()
    assert TrainConfig.from_dict(jtc.to_dict()) == tc


@pytest.mark.parametrize("saves", [("gru_gates",),
                                   ("corr_lookup", "motion_features")])
def test_unported_remat_saves_raise(saves):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        RaftStereoConfig(remat_save=saves)


# ------------------------------------------------- loss, schedule, update
def test_sequence_loss_matches_jax(rng):
    preds = rng.normal(0, 20, size=(3, 2, 8, 12)).astype(np.float32)
    gt = rng.normal(0, 20, size=(2, 8, 12)).astype(np.float32)
    gt[0, 0, :4] = 800.0            # beyond max_flow: excluded
    valid = (rng.uniform(size=(2, 8, 12)) > 0.2).astype(np.float32)
    want_loss, want = jloss.sequence_loss(jnp.asarray(preds), jnp.asarray(gt),
                                          jnp.asarray(valid))
    loss, got = sequence_loss(torch.from_numpy(preds), torch.from_numpy(gt),
                              torch.from_numpy(valid))
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-6)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6)


def test_one_cycle_lr_matches_jax():
    total = 10_100          # num_steps 10,000 + 100: the peak at step 100
    want = joptimizer.one_cycle_lr(2e-4, total)
    got = one_cycle_lr(2e-4, total)
    for step in (0, 50, 100, 5_000, total - 1):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-7)
    opt, sched = make_optimizer([torch.nn.Parameter(torch.zeros(2))],
                                TrainConfig(num_steps=10_000))
    for step in range(3):
        assert opt.param_groups[0]["lr"] == got(step)
        opt.step()
        sched.step()


@pytest.mark.parametrize("clip", [True, False])
def test_clip_adamw_matches_optax(rng, clip):
    """Two clip+AdamW updates against ``make_optimizer``'s optax chain, on
    seeded params and gradients whose global norm is above (clip active)
    or below the 1.0 limit."""
    cfg = TrainConfig(num_steps=10_000)
    shapes = {"a": (3, 4), "b": (5,)}
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()}
    scale = 3.0 if clip else 0.05
    grads = [{k: (scale * rng.normal(size=s) / 4).astype(np.float32)
              for k, s in shapes.items()} for _ in range(2)]
    tx, _ = joptimizer.make_optimizer(JaxTrainConfig(num_steps=10_000))
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = tx.init(jparams)
    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
               for k, v in params.items()}
    opt, sched = make_optimizer(tparams.values(), cfg)
    for g in grads:
        norm = float(optax.global_norm(g))
        assert (norm > 1.0) == clip
        updates, jstate = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                    jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, p in tparams.items():
            p.grad = torch.from_numpy(g[k].copy())
        got_norm = clip_by_global_norm_(tparams.values(),
                                        cfg.clip_grad_norm)
        np.testing.assert_allclose(float(got_norm), norm, rtol=1e-6)
        opt.step()
        sched.step()
        for k, p in tparams.items():
            np.testing.assert_allclose(p.detach().numpy(),
                                       np.asarray(jparams[k]), rtol=1e-6,
                                       atol=1e-9)


# ------------------------------------------------------ train-mode forward
@pytest.fixture(scope="module")
def jax_train_forward(variables):
    """name -> JAX ``test_mode=False`` flows (iters, 1, H, W) of the fp32
    architecture on seeded images."""
    cache = {}

    def get(name):
        if name not in cache:
            jcfg = _jax_cfg(name, mixed_precision=False)
            left = np.random.default_rng(3).integers(0, 256, HW + (3,),
                                                     dtype=np.uint8)
            right = np.roll(left, -3, axis=1)
            flows = jax.jit(lambda v, a, b: JaxRAFTStereo(jcfg).apply(
                v, a, b, iters=ITERS, test_mode=False))(
                variables(name), jnp.asarray(left[None], jnp.float32),
                jnp.asarray(right[None], jnp.float32))
            cache[name] = left, right, np.asarray(flows)
        return cache[name]
    return get


@pytest.mark.parametrize("remat,saves", [(True, ("corr_lookup",)),
                                         (True, ()),
                                         (False, ("corr_lookup",))])
@pytest.mark.parametrize("name", ["default", "realtime"])
def test_train_forward_matches_jax(variables, jax_train_forward, name,
                                   remat, saves):
    """Train mode returns every iteration's full-resolution flow; with
    remat the iteration runs under ``torch.utils.checkpoint`` (grad on),
    the lookup outside it (saved) or, with ``remat_save=()``, inside."""
    left, right, want = jax_train_forward(name)
    jcfg = _jax_cfg(name, mixed_precision=False, remat_gru=remat,
                    remat_save=saves)
    model = RAFTStereo(_port_cfg(jcfg))
    model.load_state_dict(state_dict_from_jax(variables(name)), strict=True)
    flows = model(torch.from_numpy(left[None]), torch.from_numpy(right[None]),
                  iters=ITERS, test_mode=False)
    assert flows.grad_fn is not None
    assert flows.shape == want.shape == (ITERS, 1) + HW
    np.testing.assert_allclose(flows.detach().numpy(), want, atol=FLOW_ATOL,
                               rtol=0)


# ---------------------------------------------------------- the whole step
@pytest.fixture(scope="module")
def default_step(variables):
    jcfg = _jax_cfg("default")
    want = _jax_step(jcfg, variables("default"), kernels=True)
    state = _port_state(jcfg, variables("default"))
    before = {n: p.detach().clone() for n, p in
              state.model.named_parameters()}
    state, metrics = train_step(state, _batch(), iters=ITERS, loss_gamma=0.9,
                                max_flow=700.0)
    return want, state, {k: float(v) for k, v in metrics.items()}, before


def test_train_step_metrics_match_jax(default_step):
    (want, _, _), _, got, _ = default_step
    assert set(got) == set(want)
    for k in ("loss", "epe", "grad_norm"):
        assert abs(got[k] - want[k]) <= SPREAD_FACTOR * JAX_SPREAD[k], k
    share = 1.0 / float((_batch()["valid"] > 0).sum())
    for k in ("1px", "3px", "5px"):
        assert abs(got[k] - want[k]) <= share, k


def test_train_step_gradients_match_jax(default_step):
    (_, want, _), state, _, _ = default_step
    got = {n: p.grad for n, p in state.model.named_parameters()}
    assert set(got) == set(want)   # the parameters are JAX's params
    scale = max(float(np.abs(g).max()) for g in want.values())
    worst = 0.0
    for name, g in got.items():
        w = want[name].numpy()
        err = float(np.abs(g.numpy() - w).max())
        worst = max(worst, err / max(float(np.abs(w).max()), 1e-3 * scale))
    assert worst <= SPREAD_FACTOR * JAX_SPREAD["grad_leaf"], worst
    # the correlation carries a gradient to fnet (the card's autograd
    # fault, where the lookup returned no grad_fn, left it at zero)
    for name in ("fnet.conv2.weight", "fnet.trunk.layer3_1.conv2.weight"):
        assert float(got[name].abs().max()) > 1e-3 * scale


def test_train_step_parameters_match_jax(default_step):
    (_, _, want), state, _, before = default_step
    lr0 = one_cycle_lr(2e-4, TRAIN["num_steps"] + 100)(0)
    moved = 0
    for name, p in state.model.named_parameters():
        got = p.detach().numpy()
        np.testing.assert_allclose(got, want[name].numpy(), atol=2.02 * lr0,
                                   rtol=0)
        moved += int((got != before[name].numpy()).sum())
    assert moved > 0.5 * sum(p.numel() for p in state.model.parameters())
    assert state.step == 1


def test_realtime_bf16_step_matches_jax(variables):
    jcfg = _jax_cfg("realtime")
    assert jcfg.mixed_precision and jcfg.corr_backend == "alt"
    want, _, _ = _jax_step(jcfg, variables("realtime"), kernels=True)
    state = _port_state(jcfg, variables("realtime"))
    state, got = train_step(state, _batch(), iters=ITERS, loss_gamma=0.9,
                            max_flow=700.0)
    for k in ("loss", "grad_norm"):
        assert abs(float(got[k]) - want[k]) <= (SPREAD_FACTOR
                                                * RT_JAX_SPREAD[k]), k
    params = dict(state.model.named_parameters())
    assert all(p.dtype == torch.float32 for p in params.values())
    # the alt lookup carries a gradient to the feature head
    assert float(params["conv2_out.weight"].grad.abs().max()) > 0


# ------------------------------------------------------ loop and checkpoint
def test_train_resume_is_bitwise_and_loads_for_inference(tmp_path):
    """3 steps equal 2 steps, a save, a restore and 1 more step, bit for
    bit; the saved directory is an inference checkpoint."""
    cfg = RaftStereoConfig(**TINY)
    tc = TrainConfig(batch_size=1, train_iters=2, image_size=(32, 64),
                     num_steps=1000, gru_telemetry=True, seed=3)

    def loader(n):
        return SyntheticStereoLoader(1, (32, 64), seed=9, num_batches=n)

    full = train(cfg, tc, loader=loader(3), device="cpu", name="run",
                 checkpoint_dir=str(tmp_path / "full"), log_dir=None)
    train(cfg, tc, loader=loader(2), device="cpu", name="run",
          checkpoint_dir=str(tmp_path / "part"), log_dir=None)
    resumed = train(cfg, tc, loader=loader(3), device="cpu", name="run",
                    checkpoint_dir=str(tmp_path / "resumed"), log_dir=None,
                    restore=str(tmp_path / "part" / "run"))
    assert full.step == resumed.step == 3
    for (n, a), (_, b) in zip(full.model.named_parameters(),
                              resumed.model.named_parameters()):
        assert torch.equal(a, b), n
    sa, sb = full.optimizer.state_dict(), resumed.optimizer.state_dict()
    for i in sa["state"]:
        for k in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(sa["state"][i][k], sb["state"][i][k])
    assert full.scheduler.last_epoch == resumed.scheduler.last_epoch == 3

    ckpt = tmp_path / "resumed" / "run"
    assert sorted(os.listdir(ckpt)) == ["COMMIT", "MANIFEST", "config.json",
                                        "runtime.json", "train_config.json",
                                        "train_state.pt", "weights.pt"]
    cfg2, weights = load_checkpoint(str(ckpt))
    assert cfg2 == cfg
    left = np.random.default_rng(4).integers(0, 256, (32, 64, 3),
                                             dtype=np.uint8)
    right = np.roll(left, -2, axis=1)
    flow, _ = InferenceRunner(cfg2, weights, iters=2, device="cpu")(left,
                                                                    right)
    with torch.no_grad():
        _, want = full.model(torch.from_numpy(left[None]),
                             torch.from_numpy(right[None]), iters=2)
    np.testing.assert_array_equal(flow, want[0].numpy())


def test_step_reports_gru_telemetry():
    cfg = RaftStereoConfig(**TINY)
    state = create_train_state(cfg, TrainConfig(**TRAIN), "cpu")
    batch = SyntheticStereoLoader(1, (32, 64)).batch(0)
    _, metrics = train_step(state, batch, iters=3, loss_gamma=0.9,
                            max_flow=700.0, gru_telemetry=True)
    assert metrics["gru_delta_px"].shape == (2,)
    assert bool(torch.isfinite(metrics["gru_delta_px"]).all())


def test_train_without_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the host without a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train(RaftStereoConfig(**TINY), TrainConfig(**TRAIN),
              loader=SyntheticStereoLoader(1, (32, 64), num_batches=1))
