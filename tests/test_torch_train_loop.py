"""The port's training entry point on the CPU: ``train()`` over the
ported ``StereoLoader`` on a tiny SceneFlow tree (SIGTERM and exact
resume, ``restore="latest"``, the anomaly rewind and its salt,
``TrainingDiverged``, validation in the loop, the ``.pth`` and
weights-only warm starts), the ``Logger``, and ``cli/train.py`` against
the JAX package's (tests/test_torch_train_slice.py runs the two CLIs).
"""

import dataclasses
import logging
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_stereo_tpu.cli import train as jcli
from raft_stereo_tpu.config import RaftStereoConfig as JaxConfig
from raft_stereo_tpu.models.raft_stereo import RAFTStereo as JaxRAFTStereo
from raft_stereo_tpu.training import logger as jlogger
from raft_stereo_tpu.training import train_loop as jloop
from raft_stereo_tpu_torch.cli import train as tcli
from raft_stereo_tpu_torch.config import RaftStereoConfig, TrainConfig
from raft_stereo_tpu_torch.data.datasets import build_training_mixture
from raft_stereo_tpu_torch.eval import validate
from raft_stereo_tpu_torch.io.jax_weights import state_dict_from_jax
from raft_stereo_tpu_torch.training import checkpoint as ckpt
from raft_stereo_tpu_torch.training import logger as tlogger
from raft_stereo_tpu_torch.training.anomaly import TrainingDiverged
from raft_stereo_tpu_torch.training.train_loop import (
    merge_warm_start_config, train)
import golden_data
from test_torch_eval import _reference_state_dict
from torch_train_support import RecordingLoader, make_sceneflow_train

TINY = dict(hidden_dims=(32, 32, 32), fnet_dim=64)
CROP = (32, 64)


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tree"))
    make_sceneflow_train(root, n=4)
    golden_data.make_things(root, np.random.default_rng(1), n=2, hw=(48, 80))
    return root


def _tc(**kw):
    return TrainConfig(**{**dict(batch_size=2, train_iters=2,
                                 image_size=CROP, num_steps=4,
                                 validation_frequency=100, seed=3), **kw})


def _loader(tree, tc, poison=()):
    return RecordingLoader(build_training_mixture(tc, tree),
                           batch_size=tc.batch_size, seed=tc.seed,
                           num_workers=2, poison=poison)


def _run(tree, tc, ck, loader=None, **kw):
    return train(RaftStereoConfig(**TINY), tc, name="run",
                 checkpoint_dir=ck, log_dir=None,
                 loader=loader if loader is not None else _loader(tree, tc),
                 device="cpu", **kw)


def _assert_same_params(a, b):
    for (n, p), (_, q) in zip(a.model.named_parameters(),
                              b.model.named_parameters()):
        assert torch.equal(p, q), n


def test_sigterm_checkpoints_and_resume_is_bitwise(tree, tmp_path):
    tc = _tc()
    ld_full = _loader(tree, tc)
    full = _run(tree, tc, str(tmp_path / "full"), ld_full)

    def stop_at_2(step, metrics):
        if step == 2:
            os.kill(os.getpid(), signal.SIGTERM)

    ck = str(tmp_path / "part")
    ld_a = _loader(tree, tc)
    before = signal.getsignal(signal.SIGTERM)
    part = _run(tree, tc, ck, ld_a, on_step=stop_at_2)
    assert part.step == 2
    assert ckpt.load_runtime_state(os.path.join(ck, "run"))["loop_step"] == 2
    assert signal.getsignal(signal.SIGTERM) is before
    ld_b = _loader(tree, tc)
    resumed = _run(tree, tc, ck, ld_b, restore="latest")
    assert resumed.step == full.step == 4
    _assert_same_params(full, resumed)
    sa, sb = full.optimizer.state_dict(), resumed.optimizer.state_dict()
    for i in sa["state"]:
        for k in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(sa["state"][i][k], sb["state"][i][k])
    assert ld_full.iters[0][:4] == ld_a.iters[0][:2] + ld_b.iters[0][:2]


def test_restore_latest_skips_a_corrupt_newest(tree, tmp_path):
    ck = str(tmp_path / "ck")
    _run(tree, _tc(validation_frequency=2), ck)
    assert sorted(os.listdir(ck)) == ["2_run", "4_run", "run"]
    for name in ("4_run", "run"):
        with open(os.path.join(ck, name, ckpt.WEIGHTS_FILE), "ab") as f:
            f.write(b"torn")
    seen = []
    state = _run(tree, _tc(num_steps=5), ck, restore="latest",
                 on_step=lambda s, m: seen.append(s))
    assert seen == [3, 4, 5] and state.step == 5


def test_rewind_on_a_poisoned_loader_reshuffles(tree, tmp_path):
    tc = _tc(num_steps=6, validation_frequency=2, anomaly_policy=True,
             anomaly_rewind_after=2)
    ck = str(tmp_path / "ck")
    loader = _loader(tree, tc, poison=(3, 4))
    seen = []
    state = _run(tree, tc, ck, loader,
                 on_step=lambda s, m: seen.append((s, float(m["skipped"]))))
    assert state.step == 6
    assert seen == [(1, 0.0), (2, 0.0), (3, 1.0), (4, 1.0), (3, 0.0),
                    (4, 0.0), (5, 0.0), (6, 0.0)]
    history = ckpt.load_runtime_state(os.path.join(ck, "run"))["anomaly"]
    rewinds = [r for r in history["recent"] if r["kind"] == "rewind"]
    assert history["rewinds"] == 1 and len(rewinds) == 1
    assert rewinds[0]["step"] == 4 and rewinds[0]["to_step"] == 2
    assert rewinds[0]["checkpoint"] == os.path.join(ck, "2_run")
    assert ckpt.is_good(os.path.join(ck, "2_run"))
    assert loader.salts == ((0, 2, 1),)
    clean = _loader(tree, tc)
    list(zip(range(4), clean))
    assert loader.iters[1][0] != clean.iters[0][2]
    assert all(bool(torch.isfinite(p).all())
               for p in state.model.parameters())


def test_training_diverged_when_the_budget_is_spent(tree, tmp_path):
    tc = _tc(num_steps=6, validation_frequency=2, anomaly_policy=True,
             anomaly_rewind_after=2, anomaly_max_rewinds=0)
    with pytest.raises(TrainingDiverged, match="max_rewinds=0") as e:
        _run(tree, tc, str(tmp_path / "ck"), _loader(tree, tc, poison=(3, 4)))
    assert e.value.step == 4


def test_validation_every_frequency_on_one_runner(tree, tmp_path,
                                                  monkeypatch):
    made = []

    class Counted(validate.InferenceRunner):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    monkeypatch.setattr(validate, "InferenceRunner", Counted)
    tc = _tc(validation_frequency=2)
    fn = validate.make_validation_fn(RaftStereoConfig(**TINY), tc,
                                     data_root=tree, datasets=("things",),
                                     device="cpu")
    results = []

    def hook(state_dict, model_cfg):
        results.append(fn(state_dict, model_cfg))
        return results[-1]

    _run(tree, tc, str(tmp_path / "ck"), validate_fn=hook)
    assert len(results) == 2 and len(made) == 1
    assert all(np.isfinite(r["things-epe"]) for r in results)
    assert results[0] != results[1]       # new weights reached the runner


def test_one_argument_validate_fn_is_called_with_the_weights(tree,
                                                             tmp_path):
    got = []
    _run(tree, _tc(num_steps=2, validation_frequency=2),
         str(tmp_path / "ck"),
         validate_fn=lambda sd: got.append(sorted(sd)) or {"x": 1.0})
    assert len(got) == 1 and "cnet.trunk.conv1.weight" in got[0]


def _jax_variables(**cfg):
    jmodel = JaxRAFTStereo(JaxConfig(**(cfg or TINY)))
    dummy = jnp.zeros((1, 64, 96, 3), jnp.float32)
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), dummy, dummy, iters=1, test_mode=True))
    rng = np.random.default_rng(21)

    def leaf(path, s):
        name = path[-1].key
        if name == "var":
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        if name == "scale":
            return (1 + rng.normal(0, 0.1, s.shape)).astype(np.float32)
        return rng.normal(0, 0.1, s.shape).astype(np.float32)
    variables = jax.tree_util.tree_map_with_path(leaf, shapes)
    return {k: dict(v) for k, v in variables.items()}


def test_pth_warm_start_loads_the_reference_weights(tree, tmp_path):
    variables = _jax_variables()
    path = str(tmp_path / "ref.pth")
    torch.save({f"module.{k}": torch.from_numpy(np.array(v))
                for k, v in _reference_state_dict(variables).items()}, path)
    state = _run(tree, _tc(num_steps=0), str(tmp_path / "ck"), restore=path)
    assert state.step == 0
    want = state_dict_from_jax(variables)
    got = state.model.state_dict()
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    one = _run(tree, _tc(num_steps=1), str(tmp_path / "ck1"), restore=path)
    assert one.step == 1 and one.scheduler.last_epoch == 1


def test_weights_only_warm_start_keeps_the_callers_execution(tree,
                                                             tmp_path):
    src = RaftStereoConfig(**TINY)
    weights = _run(tree, _tc(num_steps=1), str(tmp_path / "a")
                   ).model.state_dict()
    ckpt.save_weights(str(tmp_path / "w"), src, weights)
    caller = RaftStereoConfig(hidden_dims=(64, 64, 64), corr_backend="reg",
                              fused_gru="off", remat_gru=False)
    tc = _tc(num_steps=0)
    state = train(caller, tc, name="run", checkpoint_dir=str(tmp_path / "b"),
                  log_dir=None, loader=_loader(tree, tc), device="cpu",
                  restore=str(tmp_path / "w"), warm_start=True)
    cfg = state.model_cfg
    assert cfg.hidden_dims == (32, 32, 32) and cfg.fnet_dim == 64
    assert (cfg.corr_backend, cfg.fused_gru, cfg.remat_gru) == (
        "reg", "off", False)
    assert state.step == 0 and state.scheduler.last_epoch == 0
    for k, v in weights.items():
        assert torch.equal(state.model.state_dict()[k], v), k


@pytest.mark.parametrize("caller", [
    dict(corr_backend="reg", mixed_precision=True),
    dict(hidden_dims=(64, 64, 64), slow_fast_gru=True, remat_save=())])
def test_merge_warm_start_config_matches_jax(caller):
    ck = dict(TINY, n_gru_layers=2)
    got = merge_warm_start_config(RaftStereoConfig(**caller),
                                  RaftStereoConfig(**ck))
    want = jloop.merge_warm_start_config(JaxConfig(**caller), JaxConfig(**ck))
    assert got.to_dict() == dataclasses.asdict(want)


def test_telemetry_waits_for_d9(tree, tmp_path):
    """Named for the refusal it replaced: ``train(telemetry=...)`` now runs
    and receives the loop's calls (tests/test_torch_telemetry.py holds the
    whole surface)."""
    from raft_stereo_tpu_torch.telemetry import EventLog, TrainTelemetry
    from raft_stereo_tpu_torch.telemetry.events import replay

    path = str(tmp_path / "events.jsonl")
    tel = TrainTelemetry(events=EventLog(path))
    _run(tree, _tc(num_steps=2), None, telemetry=tel)
    tel.events.close()
    kinds = [e["event"] for e in replay(path)]
    assert kinds[0] == "run_start" and kinds[-1] == "run_end"
    assert tel.steps.value == 2 and tel.healthz()["status"] == "complete"


# ------------------------------------------------------------------ logger
@pytest.mark.parametrize("pushes", [5, 99, 250])
def test_logger_means_match_jax(caplog, pushes):
    rng = np.random.default_rng(pushes)
    metrics = [{"loss": float(rng.random()), "epe": float(rng.random()),
                "1px": float(rng.random())} for _ in range(pushes)]
    out = {}
    for mod in (tlogger, jlogger):
        caplog.clear()
        with caplog.at_level(logging.INFO, logger=mod.__name__):
            with mod.Logger(total_steps=3, enable_tensorboard=False) as lg:
                for i, m in enumerate(metrics):
                    lg.push(m, lr=1e-4 * i)
                lg.write_dict({"things-epe": 1.5})
        out[mod] = [r.getMessage() for r in caplog.records
                    if r.name == mod.__name__]
    assert out[tlogger] == out[jlogger] and len(out[tlogger]) >= 2
    assert tlogger.SUM_FREQ == jlogger.SUM_FREQ == 100


# --------------------------------------------------------------------- CLI
def test_parser_matches_jax():
    got = {a.dest: a for a in tcli.build_parser()._actions}
    want = {a.dest: a for a in jcli.build_parser()._actions}
    assert set(got) - set(want) == {"device"}
    assert set(want) <= set(got)
    for dest, a in want.items():
        assert got[dest].default == a.default, dest
        assert got[dest].option_strings == a.option_strings, dest
        assert got[dest].choices == a.choices, dest
        assert got[dest].nargs == a.nargs, dest
    assert got["device"].default == "cuda"
    assert got["train_iters"].default == 16


@pytest.mark.parametrize("argv", [
    [],
    ["--batch_size", "4", "--image_size", "256", "512", "--img_gamma",
     "0.9", "1.1", "--saturation_range", "0.5", "1.5", "--do_flip", "h",
     "--noyjitter", "--train_datasets", "sceneflow", "kitti"],
    ["--hidden_dims", "64", "64", "64", "--n_gru_layers", "2",
     "--shared_backbone", "--corr_implementation", "alt",
     "--mixed_precision", "--slow_fast_gru", "--anomaly_policy",
     "--anomaly_spike_factor", "3", "--checkpoint_keep", "2",
     "--gru_telemetry", "--validation_frequency", "7"]])
def test_configs_from_args_match_jax(argv):
    mcfg, tcfg = tcli.configs_from_args(tcli.build_parser().parse_args(argv))
    jm, jt = jcli.configs_from_args(jcli.build_parser().parse_args(argv))
    assert mcfg.to_dict() == dataclasses.asdict(jm)
    assert tcfg.to_dict() == jt.to_dict()


@pytest.mark.parametrize("argv,item", [
    (["--rows_shards", "2"], "§D7")])
def test_unported_flags_raise(argv, item):
    """The context-parallel flags (§D7) and ``--data_parallel 2``, refused
    before, are ported: ``--rows_shards 2`` needs a group of two devices
    in this process, which one CPU cannot supply (the JAX package's
    message; tests/test_torch_rows_gru.py drives the group), and
    ``--data_parallel 2`` outside a group of two processes raises the
    world-size check (tests/test_torch_distributed.py runs two)."""
    with pytest.raises(ValueError) as e:
        tcli.main(argv + ["--device", "cpu"])
    assert str(e.value) == (
        "corr_w2_shards=1 x rows_shards=2 exceeds the 1 available devices "
        "— no device is left for the data axis")
    with pytest.raises(ValueError, match="world size 1"):
        tcli.main(["--data_parallel", "2", "--device", "cpu"])


@pytest.mark.parametrize("argv", [
    ["--metrics_port", "0"],
    ["--metrics_port", "0", "--metrics_host", "localhost"],
    ["--event_log", "events.jsonl"],
    ["--event_log", "events.jsonl", "--trace_sample_rate", "0.5"],
    ["--event_log", "events.jsonl", "--no-cost_telemetry"],
    ["--event_log", "events.jsonl", "--device_peak_tflops", "989"],
    ["--event_log", "events.jsonl", "--stall_watchdog"],
    ["--event_log", "events.jsonl", "--flight_recorder_dir", "fr"]])
def test_telemetry_flags_build_their_instruments(argv, tmp_path):
    """The eight telemetry flags (once refused) build the JAX CLI's
    instruments: an endpoint answering before training, an event log
    (by default under --log_dir), the tracer's rate, the cost registry and
    its peak, the stall watchdog, the flight recorder's directory."""
    import json
    import urllib.request

    argv = [a if a not in ("events.jsonl", "fr") else str(tmp_path / a)
            for a in argv]
    args = tcli.build_parser().parse_args(
        argv + ["--log_dir", str(tmp_path / "runs"), "--device", "cpu"])
    mcfg, tcfg = tcli.configs_from_args(args)
    tel, server, events = tcli.build_telemetry(args, mcfg, tcfg)
    try:
        assert tel is not None and events is not None
        assert os.path.exists(args.event_log or str(tmp_path / "runs" /
                                                    "events.jsonl"))
        assert tel.tracer.sample_rate == args.trace_sample_rate
        assert (tel.costs is None) == (not args.cost_telemetry)
        if args.device_peak_tflops:
            assert tel.costs.peak_flops == 989e12
        assert (tel.stall_watchdog is not None) == args.stall_watchdog
        assert tel.recorder.root == (args.flight_recorder_dir or str(
            tmp_path / "runs" / "flightrecorder"))
        if args.metrics_port is not None:
            with urllib.request.urlopen(server.url + "/healthz") as r:
                assert json.loads(r.read())["status"] == "starting"
        else:
            assert server is None
    finally:
        if tel.stall_watchdog is not None:
            tel.stall_watchdog.stop()
        if server is not None:
            server.shutdown()
        events.close()


def _cli_argv(tree, root, steps=2):
    return ["--data_root", tree, "--checkpoint_dir", os.path.join(root, "ck"),
            "--log_dir", os.path.join(root, "runs"), "--batch_size", "2",
            "--image_size", str(CROP[0]), str(CROP[1]), "--train_iters", "2",
            "--hidden_dims", "32", "32", "32", "--num_steps", str(steps),
            "--seed", "3", "--data_parallel", "1"]


def test_main_runs_on_the_cpu(tree, tmp_path):
    state = tcli.main(_cli_argv(tree, str(tmp_path)) + [
        "--device", "cpu", "--validate_datasets", "things",
        "--validation_frequency", "2", "--valid_iters", "2"])
    assert state.step == 2
    ck = os.path.join(str(tmp_path), "ck")
    assert sorted(os.listdir(ck)) == ["2_raft-stereo", "raft-stereo"]
    assert ckpt.verify_manifest(os.path.join(ck, "raft-stereo")) == (True,
                                                                     "ok")


def test_main_needs_a_card_without_device_cpu(tree, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the host without a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(_cli_argv(tree, str(tmp_path)))
