"""The port's training resilience against the JAX package's (CPU): the
anomaly policy and tracker, the checkpoint's manifest, seal, sidecar,
GOOD stamp and pruning, and the anomaly-gated step against JAX's
``anomaly_train_step`` at TINY widths.

The step's tolerances are tests/test_torch_training.py's: loss, epe and
grad_norm at 4x the JAX package's own kernel-vs-plain spread, every
parameter after the first update within 2.02 lr(0).  A skipped update
keeps every leaf of the port bit for bit; the EWMA within 1e-6 relative.
"""

import json
import os
import signal
import subprocess
import sys
import types

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
from raft_stereo_tpu.training import anomaly as janomaly
from raft_stereo_tpu.training import optimizer as joptimizer
from raft_stereo_tpu.training.state import TrainState as JaxTrainState
from raft_stereo_tpu.training.step import make_train_step as jmake_step
from raft_stereo_tpu_torch.config import RaftStereoConfig, TrainConfig
from raft_stereo_tpu_torch.data.synthetic import SyntheticStereoLoader
from raft_stereo_tpu_torch.io.jax_weights import (save_checkpoint,
                                                  state_dict_from_jax)
from raft_stereo_tpu_torch.training import checkpoint as ckpt
from raft_stereo_tpu_torch.training.anomaly import (AnomalyPolicy,
                                                    AnomalyTracker,
                                                    TrainingDiverged)
from raft_stereo_tpu_torch.training.optimizer import (clip_by_global_norm_,
                                                      make_optimizer,
                                                      one_cycle_lr,
                                                      one_cycle_lr_tensor)
from raft_stereo_tpu_torch.training.state import create_train_state
from raft_stereo_tpu_torch.training.step import (_gated_adamw_,
                                                 make_train_step)
from raft_stereo_tpu_torch.training.train_loop import train
from torch_port_support import perturb
from torch_train_support import adamw_f64

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(hidden_dims=(32, 32, 32), fnet_dim=64)
HW = (32, 64)
SPREAD_FACTOR = 4.0
JAX_SPREAD = {"loss": 2.86e-6, "epe": 2.86e-6, "grad_norm": 1.31e-3}


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ policy units
@pytest.mark.parametrize("kw,match", [
    (dict(spike_factor=-1.0), "spike_factor"),
    (dict(ewma_beta=1.0), "ewma_beta"),
    (dict(ewma_beta=0.0), "ewma_beta"),
    (dict(rewind_after=-1), "rewind_after"),
    (dict(max_rewinds=-1), "max_rewinds")])
def test_anomaly_policy_validation(kw, match):
    with pytest.raises(ValueError, match=match):
        AnomalyPolicy(**kw)
    with pytest.raises(ValueError, match=match):
        janomaly.AnomalyPolicy(**kw)


@pytest.mark.parametrize("kw", [
    dict(), dict(anomaly_policy=True),
    dict(anomaly_policy=True, anomaly_spike_factor=3.0,
         anomaly_ewma_beta=0.9, anomaly_rewind_after=0,
         anomaly_max_rewinds=5)])
def test_anomaly_policy_from_train_config(kw):
    got = AnomalyPolicy.from_train_config(TrainConfig(**kw))
    want = janomaly.AnomalyPolicy.from_train_config(JaxTrainConfig(**kw))
    assert (got is None) == (want is None)
    if got is not None:
        assert vars(got) == vars(want)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_tracker_matches_jax(seed):
    """Seeded sequences of drained metrics (skips, their kinds, clean
    steps): every decision and the history equal JAX's tracker's; a
    rewind is noted whenever one is armed and the budget allows."""
    rng = np.random.default_rng(seed)
    kw = dict(rewind_after=int(rng.integers(0, 4)),
              max_rewinds=int(rng.integers(0, 3)))
    got, want = (AnomalyTracker(AnomalyPolicy(**kw)),
                 janomaly.AnomalyTracker(janomaly.AnomalyPolicy(**kw)))
    for step in range(1, 200):
        skipped = float(rng.random() < 0.4)
        m = {"loss": float(rng.random()), "skipped": skipped,
             "skip_nonfinite": float(skipped and rng.random() < 0.5),
             "skip_spike": 0.0}
        assert got.observe(step, m) == want.observe(step, m)
        assert got.should_rewind() == want.should_rewind()
        assert got.rewind_budget_left() == want.rewind_budget_left()
        if got.should_rewind() and got.rewind_budget_left():
            got.note_rewind(step, step - 2, f"/c/{step}")
            want.note_rewind(step, step - 2, f"/c/{step}")
        assert got.skipped_total == want.skipped_total
    assert got.history() == want.history()
    again = AnomalyTracker(AnomalyPolicy(**kw))
    again.load_history(json.loads(json.dumps(got.history())))
    assert again.history() == got.history()


def test_training_diverged_is_typed():
    e = TrainingDiverged(12, "no checkpoint")
    assert isinstance(e, RuntimeError) and e.step == 12
    assert "step 12" in str(e) and e.reason == "no checkpoint"


# ------------------------------------------------------------- checkpoint
@pytest.fixture(scope="module")
def tiny_state():
    return create_train_state(RaftStereoConfig(**TINY),
                              TrainConfig(batch_size=1, image_size=HW),
                              "cpu", seed=3)


def _save(root, name, step, state, runtime=None):
    path = os.path.join(str(root), f"{step}_{name}")
    state.step = step
    ckpt.save_train_checkpoint(path, state, runtime_state=runtime)
    return path


def test_checkpoint_byte_flip_sweep(tmp_path, tiny_state):
    """A flipped byte in any file of the newest checkpoint fails deep
    validation, and ``latest_checkpoint`` falls back to the older one
    with a typed reason."""
    older = _save(tmp_path, "run", 7, tiny_state, {"loop_step": 7})
    newest = _save(tmp_path, "run", 9, tiny_state, {"loop_step": 9})
    rng = np.random.default_rng(11)
    reasons = set()
    files = sorted(os.listdir(newest))
    assert files == ["COMMIT", "MANIFEST", "config.json", "runtime.json",
                     "train_config.json", "train_state.pt", "weights.pt"]
    for fn in files:
        fp = os.path.join(newest, fn)
        with open(fp, "rb") as f:
            blob = f.read()
        pos = int(rng.integers(0, len(blob)))
        bad = bytearray(blob)
        bad[pos] ^= 0xFF
        with open(fp, "wb") as f:
            f.write(bytes(bad))
        rejected = []
        assert not ckpt.is_valid_checkpoint(newest, deep=True), fn
        got = ckpt.latest_checkpoint(str(tmp_path), name="run", deep=True,
                                     on_reject=lambda p, r: rejected.append(r))
        assert got == older, fn
        assert rejected, fn
        reasons.update(rejected)
        with open(fp, "wb") as f:
            f.write(blob)
    assert ckpt.is_valid_checkpoint(newest, deep=True)
    assert ckpt.latest_checkpoint(str(tmp_path), name="run",
                                  deep=True) == newest
    assert any(r.startswith(("hash_mismatch", "manifest", "commit"))
               for r in reasons)


def test_checkpoint_truncation_and_missing_file_detected(tmp_path,
                                                         tiny_state):
    path = _save(tmp_path, "run", 5, tiny_state)
    victim = os.path.join(path, ckpt.TRAIN_STATE_FILE)
    blob = open(victim, "rb").read()
    with open(victim, "wb") as f:
        f.write(blob[: len(blob) // 2])
    assert not ckpt.is_valid_checkpoint(path, deep=True)
    os.remove(victim)
    ok, reason = ckpt.verify_manifest(path)
    assert not ok and reason == f"missing_file:{ckpt.TRAIN_STATE_FILE}"


def test_checkpoint_runtime_sidecar_roundtrip(tmp_path, tiny_state):
    rt = {"loop_step": 7, "loader": {"offset": 7, "salts": [[0, 3, 1]]},
          "loss_ewma": 1.5, "anomaly": {"rewinds": 1}}
    path = _save(tmp_path, "run", 7, tiny_state, rt)
    assert ckpt.load_runtime_state(path) == rt
    bare = str(tmp_path / "bare")
    ckpt.save_weights(bare, tiny_state.model_cfg,
                      tiny_state.model.state_dict())
    assert ckpt.load_runtime_state(bare) is None
    assert ckpt.is_valid_checkpoint(bare, deep=True)
    cfg, weights = ckpt.load_weights(bare)
    assert cfg == tiny_state.model_cfg
    for k, v in tiny_state.model.state_dict().items():
        assert torch.equal(weights[k], v), k


def test_checkpoint_good_stamp_and_prune_retention(tmp_path, tiny_state):
    paths = {s: _save(tmp_path, "run", s, tiny_state)
             for s in (3, 5, 7, 9, 11)}
    tiny_state.step = 11
    ckpt.save_train_checkpoint(str(tmp_path / "run"), tiny_state)
    ckpt.mark_good(paths[5])
    assert ckpt.is_good(paths[5]) and not ckpt.is_good(paths[9])
    assert ckpt.is_valid_checkpoint(paths[5], deep=True)
    removed = ckpt.prune_checkpoints(str(tmp_path), name="run", keep=2)
    left = sorted(os.listdir(tmp_path))
    assert left == ["11_run", "5_run", "9_run", "run"]
    assert sorted(os.path.basename(p) for p in removed) == ["3_run", "7_run"]
    assert ckpt.prune_checkpoints(str(tmp_path), name="run", keep=0) == []


def test_valid_and_latest_checkpoints_order(tmp_path, tiny_state):
    for s in (3, 9, 5):
        _save(tmp_path, "run", s, tiny_state)
    _save(tmp_path, "other", 12, tiny_state)
    got = [os.path.basename(p)
           for p in ckpt.valid_checkpoints(str(tmp_path), name="run")]
    assert got == ["9_run", "5_run", "3_run"]
    assert os.path.basename(ckpt.latest_checkpoint(
        str(tmp_path), name="run", deep=True)) == "9_run"
    assert os.path.basename(ckpt.latest_checkpoint(
        str(tmp_path), deep=True)) == "12_other"
    # a corrupt newest is skipped
    with open(os.path.join(str(tmp_path), "9_run", ckpt.WEIGHTS_FILE),
              "ab") as f:
        f.write(b"x")
    assert os.path.basename(ckpt.latest_checkpoint(
        str(tmp_path), name="run", deep=True)) == "5_run"
    assert ckpt.checkpoint_step(os.path.join(str(tmp_path), "5_run")) == 5


def test_atomic_save_leaves_only_an_orphan_on_a_crash(tmp_path, tiny_state):
    """A process killed after staging every file, before the rename:
    the previous checkpoint stays intact, the staging directory is an
    orphan that validation and ``latest_checkpoint`` skip."""
    path = str(tmp_path / "run")
    tiny_state.step = 4
    ckpt.save_train_checkpoint(path, tiny_state)
    code = f"""
import os, signal, sys
sys.path.insert(0, {REPO!r})
from raft_stereo_tpu_torch.config import RaftStereoConfig, TrainConfig
from raft_stereo_tpu_torch.training import checkpoint as ckpt
from raft_stereo_tpu_torch.training.state import create_train_state
state = create_train_state(RaftStereoConfig(hidden_dims=(32, 32, 32),
                                            fnet_dim=64),
                           TrainConfig(batch_size=1), "cpu", seed=5)
state.step = 8
ckpt._fsync_dir = lambda p: os.kill(os.getpid(), signal.SIGKILL)
ckpt.save_train_checkpoint({path!r}, state)
"""
    proc = subprocess.run([sys.executable, "-c", code], timeout=120)
    assert proc.returncode == -signal.SIGKILL
    entries = sorted(os.listdir(tmp_path))
    assert len(entries) == 2 and entries[0] == "run"
    assert entries[1].startswith("run.tmp-")
    assert ckpt.checkpoint_step(path) == 4
    assert ckpt.is_valid_checkpoint(path, deep=True)
    assert ckpt.latest_checkpoint(str(tmp_path), deep=True) == path
    assert ckpt.valid_checkpoints(str(tmp_path)) == [path]


def test_checkpoint_of_earlier_port_versions_restores(tmp_path):
    """A checkpoint as the port wrote it before the manifest (config.json,
    weights.pt, train_config.json, train_state.pt; no MANIFEST, COMMIT or
    sidecar) validates, ranks by its directory name and resumes."""
    cfg = RaftStereoConfig(**TINY)
    tc = TrainConfig(batch_size=1, train_iters=2, image_size=HW,
                     num_steps=1000, seed=3)
    state = create_train_state(cfg, tc, "cpu", seed=3)
    loader = SyntheticStereoLoader(1, HW, seed=9, num_batches=3)
    state = train(cfg, tc, loader=loader, device="cpu", checkpoint_dir=None,
                  log_dir=None)
    legacy = str(tmp_path / "3_run")
    save_checkpoint(legacy, cfg, state.model.state_dict())
    with open(os.path.join(legacy, ckpt.TRAIN_CONFIG_FILE), "w") as f:
        json.dump(tc.to_dict(), f)
    torch.save({"optimizer": state.optimizer.state_dict(),
                "scheduler": state.scheduler.state_dict(), "step": 3},
               os.path.join(legacy, ckpt.TRAIN_STATE_FILE))
    assert ckpt.is_valid_checkpoint(legacy)
    assert ckpt.is_valid_checkpoint(legacy, deep=True)
    assert ckpt.verify_manifest(legacy) == (True, "legacy_no_manifest")
    assert ckpt.checkpoint_step(legacy) == 3
    assert ckpt.latest_checkpoint(str(tmp_path), name="run",
                                  deep=True) == legacy
    restored = ckpt.load_train_checkpoint(legacy, "cpu", tc)
    assert restored.step == 3 and restored.scheduler.last_epoch == 3
    for (n, a), (_, b) in zip(restored.model.named_parameters(),
                              state.model.named_parameters()):
        assert torch.equal(a, b), n
    # resumed at the loop step's batch: 4 steps equal an uninterrupted 4
    full = train(cfg, tc, loader=SyntheticStereoLoader(1, HW, seed=9,
                                                       num_batches=4),
                 device="cpu", checkpoint_dir=None, log_dir=None)
    resumed = train(cfg, tc, loader=SyntheticStereoLoader(1, HW, seed=9,
                                                          num_batches=4),
                    device="cpu", checkpoint_dir=str(tmp_path / "out"),
                    log_dir=None, restore=legacy, name="run")
    assert resumed.step == full.step == 4
    for (n, a), (_, b) in zip(full.model.named_parameters(),
                              resumed.model.named_parameters()):
        assert torch.equal(a, b), n
    assert ckpt.is_good(legacy)   # its restore passed the finite probe


# ---------------------------------------------------- the anomaly step
STEP_HW = (64, 96)   # tests/test_torch_training.py's, where the spreads
                     # were measured


def _batches():
    """tests/test_torch_training.py's batch, a NaN batch, and a spike
    batch (the GT moved 200 px)."""
    ok = SyntheticStereoLoader(2, STEP_HW, shift=3, seed=5).batch(0)
    ok["valid"][:, :5] = 0
    nan = dict(ok, flow=np.full_like(ok["flow"], np.nan))
    spike = dict(ok, flow=(ok["flow"].astype(np.float32) - 200.0
                           ).astype(np.float16))
    return ok, nan, spike


def _count_of(opt_state):
    found = []

    def walk(s):
        if "count" in getattr(s, "_fields", ()):
            found.append(int(np.asarray(s.count)))
        elif isinstance(s, (tuple, list)):
            for x in s:
                walk(x)
    walk(opt_state)
    return found


def _port_leaves(state):
    opt = state.optimizer.state
    params = list(state.model.parameters())
    return ([p.detach().clone() for p in params]
            + [opt[p][k].clone() for p in params if p in opt
               for k in ("exp_avg", "exp_avg_sq")]
            + [state.count.clone()])


def _optax_field(opt_state, field):
    """The first ``field`` (``mu``, ``nu``, ``count``) in an optax state."""
    if field in getattr(opt_state, "_fields", ()):
        return getattr(opt_state, field)
    if isinstance(opt_state, (tuple, list)):
        for s in opt_state:
            found = _optax_field(s, field)
            if found is not None:
                return found
    return None


@pytest.mark.parametrize("skips", [(), (1,), (1, 3)])
def test_gated_adamw_matches_optax(skips):
    """The anomaly step's update (clip, then ``_gated_adamw_``) on seeded
    parameters and gradients over 5 steps, a skipped step fed NaN
    gradients (step 1) or finite ones (step 3), against the JAX package's
    optax chain (clip, AdamW on the one-cycle schedule; a skip leaves its
    state as it was) and against the same AdamW in float64.  LR 0.1 and
    weight decay 0.5 make every term of the update large against fp32
    rounding, and ``num_steps`` 300 puts the schedule's peak at step 3,
    so a count off by one changes the LR by a third of the peak.

    Tolerances, per leaf: the parameters within 4 fp32 ulps of the
    leaf's largest |p| of the float64 AdamW (measured 2.7); against
    optax, within optax's own distance from float64 plus those 4 ulps
    (optax's fp32 bias correction ``1 - 0.999^t`` drifts: 24 ulps after
    5 steps); both moments within 1e-6 of the leaf's largest value of
    optax's (measured 3.4e-7); the counts equal."""
    rng = np.random.default_rng(11)
    kw = dict(num_steps=300, lr=0.1, wdecay=0.5)
    cfg = TrainConfig(**kw)
    shapes = {"a": (3, 4), "b": (5,), "c": (2, 3, 2)}
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()}
    grads = [{k: (rng.normal(size=s) * scale).astype(np.float32)
              for k, s in shapes.items()}
             for scale in (0.05, 1.0, 2.0, 0.3, 0.1)]
    tx, _ = joptimizer.make_optimizer(JaxTrainConfig(**kw))
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = tx.init(jparams)
    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
               for k, v in params.items()}
    opt, sched = make_optimizer(tparams.values(), cfg, anomaly=True)
    assert sched is None
    state = types.SimpleNamespace(train_cfg=cfg, optimizer=opt,
                                  count=torch.zeros((), dtype=torch.int64))
    for i, g in enumerate(grads):
        skip = i in skips
        if not skip:
            updates, jstate = tx.update(
                {k: jnp.asarray(v) for k, v in g.items()}, jstate, jparams)
            jparams = optax.apply_updates(jparams, updates)
        for k, p in tparams.items():
            p.grad = torch.from_numpy(
                np.full_like(g[k], np.nan) if skip and i == 1
                else g[k].copy())
        clip_by_global_norm_(tparams.values(), cfg.clip_grad_norm)
        _gated_adamw_(state, torch.tensor(skip))
        applied = i + 1 - sum(s <= i for s in skips)
        assert int(state.count) == applied
        assert int(np.asarray(_optax_field(jstate, "count"))) == applied
        want, _ = adamw_f64(params, grads[:i + 1], skips, cfg)
        mu, nu = _optax_field(jstate, "mu"), _optax_field(jstate, "nu")
        for k, p in tparams.items():
            got, jax_p = p.detach().numpy(), np.asarray(jparams[k])
            ulp = np.spacing(np.float32(np.abs(want[k]).max()))
            assert np.abs(got - want[k]).max() <= 4 * ulp, (k, i)
            assert np.abs(got - jax_p).max() <= (
                np.abs(jax_p - want[k]).max() + 4 * ulp), (k, i)
            st = opt.state[p]
            for mine, theirs in ((st["exp_avg"], mu[k]),
                                 (st["exp_avg_sq"], nu[k])):
                theirs = np.asarray(theirs)
                np.testing.assert_allclose(
                    mine.numpy(), theirs, rtol=0,
                    atol=1e-6 * np.abs(theirs).max(), err_msg=f"{k} {i}")
            assert float(st["step"]) == applied


@pytest.fixture(scope="module")
def anomaly_runs():
    """The same four steps (clean, NaN, spike, clean) through JAX's
    ``anomaly_train_step`` (kernels in interpret mode) and the port's,
    from the same seeded weights, with the spike gate at 2x the EWMA."""
    kw = dict(batch_size=2, train_iters=2, image_size=STEP_HW,
              num_steps=1000, anomaly_policy=True, anomaly_spike_factor=2.0)
    jcfg = JaxConfig(**TINY)
    model = JaxRAFTStereo(jcfg)
    dummy = jnp.zeros((1, 32, 32, 3), jnp.float32)
    variables = perturb(jax.jit(lambda k: model.init(
        k, dummy, dummy, iters=1, test_mode=True))(jax.random.PRNGKey(0)),
        np.random.default_rng(7))
    jtc = JaxTrainConfig(**kw)
    tx, jschedule = joptimizer.make_optimizer(jtc)
    jstate = JaxTrainState.create(apply_fn=model.apply,
                                  params=variables["params"],
                                  batch_stats=variables["batch_stats"], tx=tx)
    jstep = jmake_step(jtc, donate=False,
                       anomaly=janomaly.AnomalyPolicy.from_train_config(jtc))
    tc = TrainConfig(**kw)
    state = create_train_state(RaftStereoConfig(**TINY), tc, "cpu",
                               state_dict=state_dict_from_jax(variables),
                               anomaly=True)
    step = make_train_step(tc, anomaly=AnomalyPolicy.from_train_config(tc))
    jewma, ewma = jnp.asarray(0.0, jnp.float32), torch.zeros(())
    runs = []
    jcorr_lookup._interpret_override = True
    try:
        for batch in _batches() + (_batches()[0],):
            jstate, jm, jewma = jstep(
                jstate, {k: jnp.asarray(v) for k, v in batch.items()}, jewma)
            before = _port_leaves(state)
            lr = float(one_cycle_lr_tensor(tc.lr, tc.num_steps + 100)(
                state.count))
            state, m, ewma = step(state, batch, ewma)
            runs.append(dict(
                jax={k: float(v) for k, v in jm.items()},
                jax_ewma=float(jewma), jax_count=_count_of(jstate.opt_state),
                jax_lr=float(jschedule(_count_of(jstate.opt_state)[0])),
                jax_params=state_dict_from_jax(
                    {"params": jax.device_get(jstate.params)}),
                port={k: float(v) for k, v in m.items()},
                port_ewma=ewma.clone(), before=before,
                after=_port_leaves(state), count=int(state.count), lr=lr,
                step=state.step))
    finally:
        jcorr_lookup._interpret_override = None
    return runs, tc


def test_anomaly_step_finite_matches_jax(anomaly_runs):
    runs, tc = anomaly_runs
    first = runs[0]
    for k in ("loss", "epe", "grad_norm"):
        assert abs(first["port"][k] - first["jax"][k]) <= (
            SPREAD_FACTOR * JAX_SPREAD[k]), k
    for k in ("skipped", "skip_nonfinite", "skip_spike"):
        assert first["port"][k] == first["jax"][k] == 0.0, k
    lr0 = one_cycle_lr(tc.lr, tc.num_steps + 100)(0)
    assert first["lr"] == lr0
    names = [k for k, _ in create_train_state(
        RaftStereoConfig(**TINY), tc, "cpu").model.named_parameters()]
    params = dict(zip(names, first["after"]))
    for name, want in first["jax_params"].items():
        np.testing.assert_allclose(params[name].numpy(), want.numpy(),
                                   atol=2.02 * lr0, rtol=0, err_msg=name)
    # the first finite loss seeds the EWMA
    assert float(first["port_ewma"]) == first["port"]["loss"]
    assert first["count"] == 1 and first["jax_count"][0] == 1


@pytest.mark.parametrize("which,kind", [(1, "skip_nonfinite"),
                                        (2, "skip_spike")])
def test_anomaly_step_skip_keeps_every_leaf(anomaly_runs, which, kind):
    runs, _ = anomaly_runs
    run = runs[which]
    assert run["port"]["skipped"] == run["jax"]["skipped"] == 1.0
    assert run["port"][kind] == run["jax"][kind] == 1.0
    assert len(run["before"]) == len(run["after"])
    for a, b in zip(run["before"], run["after"]):
        assert torch.equal(a, b)
    assert torch.equal(run["port_ewma"], runs[which - 1]["port_ewma"])
    assert run["jax_ewma"] == runs[which - 1]["jax_ewma"]
    assert run["count"] == 1 and run["jax_count"][0] == 1
    assert run["step"] == which + 1          # the loop's step moves on


def test_anomaly_step_lr_after_a_skip_matches_jax(anomaly_runs):
    """The count was not advanced by the skips: the next update runs at
    lr(1), the LR JAX's schedule gives its count."""
    runs, _ = anomaly_runs
    after_skips = runs[3]
    np.testing.assert_allclose(after_skips["lr"], runs[2]["jax_lr"],
                               rtol=1e-7)
    assert after_skips["port"]["skipped"] == after_skips["jax"]["skipped"] == 0
    assert after_skips["count"] == 2 and after_skips["jax_count"][0] == 2


def test_anomaly_step_ewma_matches_jax(anomaly_runs):
    runs, _ = anomaly_runs
    for run in runs:
        np.testing.assert_allclose(float(run["port_ewma"]), run["jax_ewma"],
                                   rtol=1e-6)
    # the clean step after the skips blends the EWMA
    beta = 0.98
    last = runs[3]
    want = np.float32(beta) * np.float32(runs[2]["port_ewma"]) + np.float32(
        1 - beta) * np.float32(last["port"]["loss"])
    np.testing.assert_allclose(float(last["port_ewma"]), want, rtol=1e-6)



def _param_gaps(runs, which, tc):
    """|port - JAX| over every parameter element after ``runs[which]``."""
    names = [k for k, _ in create_train_state(
        RaftStereoConfig(**TINY), tc, "cpu").model.named_parameters()]
    params = dict(zip(names, runs[which]["after"]))
    return np.concatenate([np.abs(params[n].numpy() - w.numpy()).ravel()
                           for n, w in runs[which]["jax_params"].items()])


@pytest.mark.parametrize("which,updates", [(0, 1), (3, 2)])
def test_anomaly_step_parameters_match_jax(anomaly_runs, which, updates):
    """The parameters after the first update (``runs[0]``) and after the
    clean update that follows the two skips (``runs[3]``, the second
    applied update) against JAX's.  A gradient of rounding-noise size may
    take the two sides' AdamW steps apart in sign, so the largest gap is
    bounded by 2.02 times the LRs applied (measured 1.99 lr(0) and 1.26
    (lr(0) + lr(1))); but 99% of the elements lie within 0.1 lr of the
    last update (measured 0.0006 lr(0) and 0.033 lr(1)), which a count,
    an LR or a moment that is off moves by about a whole lr."""
    runs, tc = anomaly_runs
    sched = one_cycle_lr(tc.lr, tc.num_steps + 100)
    lrs = [sched(n) for n in range(updates)]
    gaps = _param_gaps(runs, which, tc)
    assert gaps.max() <= 2.02 * sum(lrs)
    assert np.quantile(gaps, 0.99) <= 0.1 * lrs[-1]
