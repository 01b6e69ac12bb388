"""Data-parallel training of the port (parallel/, the loader's process
slicing, the step and loop under ``DistributedDataParallel``) against the
JAX package's data-parallel step (CPU).

Two-rank runs are real: two processes (tests/torch_distributed_worker.py)
form a gloo group over a localhost port, each trains its slice of every
global batch, and the test compares what they write.  The configuration
is the JAX package's own two-process test's (tests/test_distributed.py):
``RaftStereoConfig(n_gru_layers=1, hidden_dims=(32,), corr_levels=2,
fnet_dim=32)``, ``TrainConfig(batch_size=8, train_iters=2,
image_size=(32, 48))``, its seeded global batches, two steps.

Bounds.  The two ranks hold the same state bit for bit (the all-reduce
gives every rank the same sums).  Against one process at the global
batch: losses rtol 1e-6 and parameters atol 5e-4, the JAX test's bounds
for the same reason: the all-reduce sums the gradients in another order
than one process's backward does, and AdamW's m / sqrt(v) turns an
eps-sized gradient difference into a parameter step of order lr (2e-4)
per step.  Against JAX's step over ``make_mesh(n_data=2)``: parameters
atol 5e-4 as well (measured 3.7e-4, JAX's own kernel-vs-plain spread
over the same two steps 3.1e-4; one AdamW step's 2.02 lr(0) of
tests/test_torch_training.py does not hold over two); the first step's
loss rtol 1e-6 (measured 4.8e-7), the second's rtol 1e-4: it is taken
after an update that moves every parameter by about lr times the sign of
its gradient, so gradients of rounding-noise size move it apart, in one
process as in two (measured 4.6e-5 both ways; JAX's own spread 1.4e-6).
"""

import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_stereo_tpu.config import RaftStereoConfig as JaxConfig
from raft_stereo_tpu.config import TrainConfig as JaxTrainConfig
from raft_stereo_tpu.data.loader import StereoLoader as JaxStereoLoader
from raft_stereo_tpu.parallel import distributed as jdistributed
from raft_stereo_tpu.parallel import mesh as jmesh
from raft_stereo_tpu_torch.config import RaftStereoConfig, TrainConfig
from raft_stereo_tpu_torch.data.loader import StereoLoader
from raft_stereo_tpu_torch.data.synthetic import SyntheticStereoLoader
from raft_stereo_tpu_torch.io.jax_weights import state_dict_from_jax
from raft_stereo_tpu_torch.models.raft_stereo import RAFTStereo
from raft_stereo_tpu_torch.parallel import distributed, mesh
from raft_stereo_tpu_torch.training.train_loop import train
import torch_distributed_worker as worker

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER_TIMEOUT = 240


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


class _ArrayDataset:
    """index -> a recognizable sample (tests/test_distributed.py's)."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i, epoch=0):
        return {"x": np.full((2, 2), i, np.float32)}


def _collect(loader, n):
    it = iter(loader)
    return [next(it) for _ in range(n)]


# ------------------------------------------------------------- the loader
def test_loader_process_slices_partition_each_global_batch():
    ds = _ArrayDataset(16)
    kw = dict(batch_size=8, num_workers=0, epochs=1, seed=7)
    full = _collect(StereoLoader(ds, **kw), 2)
    shards = [_collect(StereoLoader(ds, **kw, process_index=p,
                                    process_count=2), 2) for p in range(2)]
    jshards = [_collect(JaxStereoLoader(ds, **kw, process_index=p,
                                        process_count=2), 2)
               for p in range(2)]
    for b in range(2):
        assert shards[0][b]["x"].shape == (4, 2, 2)
        np.testing.assert_array_equal(
            np.concatenate([shards[0][b]["x"], shards[1][b]["x"]]),
            full[b]["x"])
        for p in range(2):
            np.testing.assert_array_equal(shards[p][b]["x"],
                                          jshards[p][b]["x"])


@pytest.mark.parametrize("kw", [dict(batch_size=6, process_count=4),
                                dict(batch_size=4, process_index=2,
                                     process_count=2),
                                dict(batch_size=4, process_index=-1,
                                     process_count=2)])
def test_loader_process_validation_matches_jax(kw):
    ds = _ArrayDataset(8)
    with pytest.raises(ValueError) as want:
        JaxStereoLoader(ds, **kw)
    with pytest.raises(ValueError) as got:
        StereoLoader(ds, **kw)
    assert str(got.value) == str(want.value)


def test_synthetic_loader_slices_its_global_batch():
    full = SyntheticStereoLoader(8, (16, 24), seed=3).batch(2)
    parts = [SyntheticStereoLoader(8, (16, 24), seed=3, process_index=p,
                                   process_count=4).batch(2)
             for p in range(4)]
    for k, v in full.items():
        np.testing.assert_array_equal(np.concatenate([p[k] for p in parts]),
                                      v)


# ------------------------------------------------------ one process alone
def test_initialize_is_a_noop_in_one_process():
    distributed.initialize()
    assert not torch.distributed.is_initialized()
    assert distributed.loader_shard_kwargs() == \
        jdistributed.loader_shard_kwargs() == {"process_index": 0,
                                               "process_count": 1}
    assert distributed.any_process(True) is True
    assert distributed.any_process(False) is False
    distributed.barrier()


def test_device_groups_match_jax():
    devs = [torch.device("cpu", i) for i in range(8)]
    for size, n, skip in [(2, None, 0), (2, 3, 0), (3, None, 0), (2, 4, 0),
                          (2, 5, 0), (1, 2, 6), (4, 1, 4), (4, None, 2)]:
        got = distributed.device_groups(size, n, devs, skip)
        want = jdistributed.device_groups(size, n, list(range(8)), skip)
        assert [[d.index for d in g] for g in got] == \
            [list(g) for g in want]
    with pytest.raises(ValueError, match="group_size"):
        distributed.device_groups(0)


@pytest.mark.parametrize("spec", ["rows=4", "rows=2,corr=2", " corr=3 ",
                                  "", "rows", "rows=0", "rows=x",
                                  "rows=2,rows=2", "data=2"])
def test_mesh_spec_helpers_match_jax(spec):
    try:
        want = jmesh.parse_mesh_spec(spec)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            mesh.parse_mesh_spec(spec)
        assert str(got.value) == str(e)
        return
    assert mesh.parse_mesh_spec(spec) == want
    assert mesh.mesh_spec_label(want) == jmesh.mesh_spec_label(want)


def test_make_mesh_is_the_data_axis():
    m = mesh.make_mesh()
    assert m.shape == {"data": 1, "corr": 1, "rows": 1} and m.rank == 0
    assert mesh.make_mesh(n_data=4, world_size=4).n_data == 4
    with pytest.raises(ValueError, match="world size 1"):
        mesh.make_mesh(n_data=2)
    for kw in (dict(n_corr=2), dict(n_rows=2)):
        # one CPU device: a group of two is refused, never run solo
        with pytest.raises(ValueError, match="only 1 are available"):
            mesh.make_mesh(**kw)
        m = mesh.make_mesh(devices=["cpu", "cpu"], **kw)
        assert m.devices == (torch.device("cpu"),) * 2
        assert m.shape["corr"] * m.shape["rows"] == 2


def test_data_parallel_must_equal_the_world_size():
    """``data_parallel`` above the world size raises before any step (a
    plain process is a world of one); 0 and 1 train."""
    loader = SyntheticStereoLoader(2, (32, 48), seed=0)
    kw = dict(device="cpu", checkpoint_dir=None, log_dir=None, loader=loader)
    with pytest.raises(ValueError, match="world size 1"):
        train(RaftStereoConfig(**worker.MODEL),
              TrainConfig(batch_size=2, train_iters=1, num_steps=1,
                          image_size=(32, 48), data_parallel=2), **kw)
    state = train(RaftStereoConfig(**worker.MODEL),
                  TrainConfig(batch_size=2, train_iters=1, num_steps=1,
                              image_size=(32, 48), data_parallel=1), **kw)
    assert state.step == 1 and state.ddp is None


@pytest.mark.parametrize("arch", ["default", "realtime"])
def test_every_parameter_gets_a_gradient(arch):
    """``DistributedDataParallel`` runs without ``find_unused_parameters``:
    every parameter the model builds takes part in the train forward."""
    base = RaftStereoConfig.realtime() if arch == "realtime" else \
        RaftStereoConfig()
    cfg = RaftStereoConfig.from_dict(dict(base.to_dict(), hidden_dims=(
        32, 32, 32), fnet_dim=32, mixed_precision=False))
    torch.manual_seed(0)
    model = RAFTStereo(cfg).train()
    img = torch.rand(1, 32, 64, 3) * 255
    model(img, img, iters=2, test_mode=False).sum().backward()
    missing = [n for n, p in model.named_parameters() if p.grad is None]
    assert not missing


# -------------------------------------------------------------- two ranks
def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn(tmp_path, tag, mode, *opts, world=2):
    """Run ``world`` worker ranks to their end; their npz outputs."""
    port = _free_port()
    outs = [str(tmp_path / f"{tag}{r}.npz") for r in range(world)]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.dirname(HERE)] + os.environ.get("PYTHONPATH", "").split(
            os.pathsep)))
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_distributed_worker.py"),
         str(r), str(world), str(port), outs[r], mode, *opts],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=WORKER_TIMEOUT)[0].decode(
                errors="replace"))
    finally:
        for p in procs:   # no rank outlives a failed peer
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, text in zip(procs, logs):
        assert p.returncode == 0, text[-3000:]
    return [dict(np.load(o)) for o in outs]


@pytest.fixture(scope="module")
def jax_variables():
    """The JAX package's seeded variables of the test's model (Flax init,
    PRNGKey(0), as tests/test_distributed.py builds its state)."""
    from raft_stereo_tpu.models.raft_stereo import RAFTStereo as JaxModel
    model = JaxModel(JaxConfig(**worker.MODEL))
    dummy = jnp.zeros((1, 32, 48, 3), jnp.float32)
    return jax.device_get(jax.jit(lambda k: model.init(
        k, dummy, dummy, iters=1, test_mode=True))(jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def weights_file(jax_variables, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("weights") / "weights.pt")
    torch.save(state_dict_from_jax(jax_variables), path)
    return path


def _jax_two_device_steps(jax_variables):
    """JAX's step over ``make_mesh(n_data=2)`` on two virtual CPU devices,
    the same two global batches: (losses, flat parameters in the port's
    order)."""
    from raft_stereo_tpu.models.raft_stereo import RAFTStereo as JaxModel
    from raft_stereo_tpu.training import optimizer as joptimizer
    from raft_stereo_tpu.training.state import TrainState as JaxTrainState
    from raft_stereo_tpu.training.step import make_train_step
    tcfg = JaxTrainConfig(**worker.TRAIN)
    tx, _ = joptimizer.make_optimizer(tcfg)
    state = JaxTrainState.create(
        apply_fn=JaxModel(JaxConfig(**worker.MODEL)).apply,
        params=jax_variables["params"],
        batch_stats=jax_variables["batch_stats"], tx=tx)
    m = jmesh.make_mesh(n_data=2, devices=jax.devices()[:2])
    state = jmesh.replicate(state, m)
    step_fn = make_train_step(tcfg, mesh=m, donate=False)
    losses = []
    for step in range(2):
        state, metrics = step_fn(state, jmesh.shard_batch(
            worker.global_batch(step), m))
        losses.append(float(metrics["loss"]))
    sd = state_dict_from_jax({"params": jax.device_get(state.params)})
    model = RAFTStereo(RaftStereoConfig(**worker.MODEL))
    flat = np.concatenate([sd[n].numpy().ravel()
                           for n, _ in model.named_parameters()])
    return np.asarray(losses), flat


def test_two_ranks_match_one_process_and_jax(tmp_path, weights_file,
                                             jax_variables):
    r0, r1 = _spawn(tmp_path, "dp", "steps", f"weights={weights_file}")
    for k in ("losses", "metrics", "params"):
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)
    one = worker.run_steps(torch.load(weights_file, weights_only=True),
                           False, 0, 1)
    np.testing.assert_allclose(r0["losses"], one["losses"], rtol=1e-6)
    np.testing.assert_allclose(r0["params"], one["params"], rtol=0,
                               atol=5e-4)
    jlosses, jparams = _jax_two_device_steps(jax_variables)
    np.testing.assert_allclose(r0["losses"][0], jlosses[0], rtol=1e-6)
    np.testing.assert_allclose(r0["losses"][1], jlosses[1], rtol=1e-4)
    np.testing.assert_allclose(r0["params"], jparams, rtol=0, atol=5e-4)


def test_two_ranks_jitter_the_global_batch(tmp_path, weights_file):
    """With the device photometric jitter each rank draws the global
    batch's factors and takes its own rows: the two ranks' steps are one
    process's on the global batch (a rank drawing factors for its own
    slice alone would jitter rank 1's images with rank 0's factors)."""
    r0, r1 = _spawn(tmp_path, "jit", "steps", f"weights={weights_file}",
                    "jitter=1")
    np.testing.assert_array_equal(r0["params"], r1["params"])
    one = worker.run_steps(torch.load(weights_file, weights_only=True),
                           True, 0, 1)
    plain = worker.run_steps(torch.load(weights_file, weights_only=True),
                             False, 0, 1)
    np.testing.assert_allclose(r0["losses"], one["losses"], rtol=1e-6)
    np.testing.assert_allclose(r0["params"], one["params"], rtol=0,
                               atol=5e-4)
    assert np.abs(one["losses"] - plain["losses"]).max() > 1e-3


def test_sigterm_on_one_rank_stops_both_and_resume_is_exact(tmp_path):
    """A SIGTERM to rank 1 after step 3 stops both ranks at step 3 with
    one checkpoint (process 0's); both ranks resume it, and the resumed
    run ends where a run that never stopped does, bit for bit."""
    ck = str(tmp_path / "ck")
    a0, a1 = _spawn(tmp_path, "a", "loop", f"ckpt_dir={ck}", "sigterm=3",
                    "num_steps=5")
    assert int(a0["step"]) == int(a1["step"]) == 3
    assert os.listdir(ck) == ["dp"]
    b0, b1 = _spawn(tmp_path, "b", "loop", f"ckpt_dir={ck}", "resume=1",
                    "num_steps=5")
    c0, _ = _spawn(tmp_path, "c", "loop", f"ckpt_dir={tmp_path / 'ck2'}",
                   "num_steps=5")
    assert int(b0["step"]) == int(b1["step"]) == 5
    np.testing.assert_array_equal(b0["params"], b1["params"])
    np.testing.assert_array_equal(b0["params"], c0["params"])
    np.testing.assert_array_equal(
        np.concatenate([a0["losses"], b0["losses"]]), c0["losses"])


def test_two_ranks_each_over_a_device_group(tmp_path):
    """Context parallelism inside data parallelism: two gloo ranks, each
    sharding its slice of every global batch over a rows x corr group of
    four CPU devices of its own, end bit for bit equal to each other (DDP
    reduces over the data axis alone) and within the one-process bounds
    above of the same two ranks unsharded: the shards' copies and
    moments reassociate the loss, not what DDP sums."""
    s0, s1 = _spawn(tmp_path, "cp", "loop", f"ckpt_dir={tmp_path / 'cs'}",
                    "num_steps=2", "cp=1")
    u0, _ = _spawn(tmp_path, "up", "loop", f"ckpt_dir={tmp_path / 'cu'}",
                   "num_steps=2")
    np.testing.assert_array_equal(s0["params"], s1["params"])
    np.testing.assert_array_equal(s0["losses"], s1["losses"])
    assert int(s0["step"]) == int(u0["step"]) == 2
    np.testing.assert_allclose(s0["losses"], u0["losses"], rtol=1e-4)
    np.testing.assert_allclose(s0["params"], u0["params"], rtol=0,
                               atol=5e-4)
