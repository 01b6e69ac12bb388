"""Early exit, confidence and state carry of the port against the JAX
package (CPU).

Both sides run the same TINY model: Flax init, norm leaves perturbed, the
settling GRU of ``torch_port_support.settle_jax`` (the hidden states decay
by 0.73 an iteration, so the updates shrink as a trained network's do;
random weights make them grow, and a loop that exits early could not be
told from one that stops at ``min_iters``), carried by
``state_dict_from_jax``.

Tolerances.  Flows: FLOW_ATOL = 2e-3 px, the whole-forward bound of
tests/test_torch_model.py.  ``iters_used``: exactly equal, with every
threshold taken from JAX's own per-iteration deltas at the midpoint of two
values at least 10% apart, so that no summation order can move the trip
count.  Confidence: ``exp(-score * f / 0.25)`` with ``f <= 1`` and
``score = dmag + ewma / 2`` moves by at most ``4 x`` the score's error
(the exponential's slope is at most 1/0.25 where the map is at most 1);
``dmag`` and the EWMA each differ by at most ``2 x FLOW_ATOL`` when the
flows differ by ``FLOW_ATOL``, so the score by ``3 x FLOW_ATOL`` and the
map by CONF_ATOL = 12 x FLOW_ATOL.  The hidden states, tanh outputs of the
same GRU, are held to FLOW_ATOL.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golden_data import (disparity_field, make_kitti, textured_image,
                         warp_right)
from raft_stereo_tpu.config import RaftStereoConfig as JaxConfig
from raft_stereo_tpu.data import datasets as jds
from raft_stereo_tpu.eval.runner import InferenceRunner as JaxRunner
from raft_stereo_tpu.eval.validate import sequence_drift as jax_drift
from raft_stereo_tpu.models.raft_stereo import RAFTStereo as JaxRAFTStereo
from raft_stereo_tpu_torch.cli import demo, evaluate
from raft_stereo_tpu_torch.config import RaftStereoConfig
from raft_stereo_tpu_torch.data import datasets as ds
from raft_stereo_tpu_torch.eval.runner import (InferenceRunner,
                                               early_exit_enabled,
                                               make_forward)
from raft_stereo_tpu_torch.eval.validate import sequence_drift
from raft_stereo_tpu_torch.io.jax_weights import (save_checkpoint,
                                                  state_dict_from_jax)
from raft_stereo_tpu_torch.kernels.graph_loop import (exit_continues,
                                                      exit_predicate, f32)
from raft_stereo_tpu_torch.models.raft_stereo import (CONFIDENCE_SCALE_PX,
                                                      RAFTStereo)
from torch_port_support import perturb, settle_jax

TINY = dict(hidden_dims=(32, 32, 32), fnet_dim=64)
HW = (60, 90)            # golden_data's frame size: pads to 64x96
FLOW_ATOL = 2e-3
CONF_ATOL = 12 * FLOW_ATOL
CAP = 4                  # the depth cap of the exit cases


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _pair(rng, contrast=1.0):
    left = textured_image(rng, *HW)
    right = warp_right(left, disparity_field(rng, *HW))
    if contrast != 1.0:
        left, right = (np.clip(x * contrast + 100, 0, 255).astype(np.uint8)
                       for x in (left, right))
    return left, right


def _pad(x):
    """(N, 60, 90, 3) -> (N, 64, 96, 3), edge-padded as the runners pad."""
    return np.pad(x, ((0, 0), (2, 2), (3, 3), (0, 0)), mode="edge")


@pytest.fixture(scope="module")
def setup():
    """The JAX model and settled variables, the port model, an easy
    (low-contrast) and a hard pair padded to 64x96, and JAX's per-image
    per-iteration deltas at fixed depth (the mean |delta| of iterations
    1..CAP)."""
    jcfg = JaxConfig(**TINY)
    jmodel = JaxRAFTStereo(jcfg)
    dummy = jnp.zeros((1, 64, 96, 3), jnp.float32)
    init = jax.jit(lambda key: jmodel.init(key, dummy, dummy, iters=1,
                                           test_mode=True))
    variables = settle_jax(perturb(init(jax.random.PRNGKey(0)),
                                   np.random.default_rng(7)))
    state = state_dict_from_jax(variables)
    rng = np.random.default_rng(0)
    hard, easy = _pair(rng), _pair(rng, contrast=0.2)
    left = _pad(np.stack([hard[0], easy[0]]))
    right = _pad(np.stack([hard[1], easy[1]]))
    lows = [np.asarray(jmodel.apply(
        variables, jnp.asarray(left, jnp.float32),
        jnp.asarray(right, jnp.float32), iters=k, test_mode=True,
        unroll_gru=True)[0]) for k in range(CAP + 1)]
    deltas = np.stack([np.abs(b - a).mean(axis=(1, 2))
                       for a, b in zip(lows, lows[1:])])   # (CAP, 2)
    return dict(variables=variables, state=state, left=left, right=right,
                deltas=deltas, raw=(hard, easy))


def _jax_exit(setup, idx, threshold, min_iters, max_iters=None,
              iters=CAP, **kw):
    jm = JaxRAFTStereo(JaxConfig(**TINY, exit_threshold_px=threshold,
                                 exit_min_iters=min_iters,
                                 exit_max_iters=max_iters))
    return jm.apply(setup["variables"],
                    jnp.asarray(setup["left"][idx], jnp.float32),
                    jnp.asarray(setup["right"][idx], jnp.float32),
                    iters=iters, test_mode=True, **kw)


def _port(setup, idx, threshold=0.0, min_iters=1, max_iters=None,
          iters=CAP, **kw):
    cfg = RaftStereoConfig(**TINY, exit_threshold_px=threshold,
                           exit_min_iters=min_iters, exit_max_iters=max_iters)
    model = RAFTStereo(cfg).eval()
    model.load_state_dict(setup["state"], strict=True)
    with torch.no_grad():
        return model(torch.from_numpy(setup["left"][idx]),
                     torch.from_numpy(setup["right"][idx]), iters=iters,
                     **kw)


def _midpoint(a, b):
    """A threshold between two deltas at least 10% apart."""
    lo, hi = sorted((float(a), float(b)))
    assert hi >= 1.1 * lo, f"deltas {lo} and {hi} too close to split"
    return (lo + hi) / 2


def _between(deltas):
    """The midpoint of the hard pair's deltas of iterations j and j+1, the
    first j >= 2 whose midpoint lies at least 5% from every delta of both
    pairs (so neither pair's trip count can flip)."""
    d = deltas[:, 0]
    for j in range(1, len(d) - 1):
        thr = _midpoint(d[j], d[j + 1])
        if (np.abs(deltas / thr - 1) >= 0.05).all():
            return thr
    raise AssertionError(f"no threshold splits the deltas {deltas}")


def _expected(d, thr, min_iters, limit=CAP):
    """The trip count JAX's deltas ``d`` (one pair) give."""
    it, delta = 0, float("inf")
    while exit_continues(it, delta, min_iters, limit, thr):
        delta, it = float(d[it]), it + 1
    return it


def _case(deltas, name):
    """(batch index, threshold, min_iters, exit_max_iters, iters_used)."""
    if name == "above":                 # every delta below: min_iters
        return [0], 2 * float(deltas.max()), 2, None, 2
    if name == "between":               # the threshold decides
        thr = _between(deltas)
        return [0], thr, 1, None, _expected(deltas[:, 0], thr, 1)
    if name == "cap":                   # every delta above: exit_max_iters
        return [0], 0.5 * float(deltas.min()), 1, 3, 3
    raise ValueError(name)


def test_settled_deltas_shrink(setup):
    d = setup["deltas"]
    assert (d[1:] < 0.9 * d[:-1]).all(), d


@pytest.mark.parametrize("name", ["above", "between", "cap"])
def test_exit_loop_matches_jax(setup, name):
    idx, thr, lo, hi, want = _case(setup["deltas"], name)
    jlow, jup, jused = _jax_exit(setup, idx, thr, lo, hi)
    low, up, used = _port(setup, idx, thr, lo, hi)
    assert int(jused) == used == want
    if name == "between":
        assert 1 < want < CAP
    np.testing.assert_allclose(low.numpy(), np.asarray(jlow),
                               atol=FLOW_ATOL, rtol=0)
    np.testing.assert_allclose(up.numpy(), np.asarray(jup), atol=FLOW_ATOL,
                               rtol=0)


def test_threshold_zero_is_the_fixed_depth_program(setup):
    """At threshold 0 the forward is the fixed-depth loop: the same
    operations as before early exit existed (equal to a loop over
    ``begin``'s step), and JAX's fixed-depth result."""
    low, up = _port(setup, [0, 1], iters=2)
    cfg = RaftStereoConfig(**TINY)
    model = RAFTStereo(cfg).eval()
    model.load_state_dict(setup["state"])
    with torch.no_grad():
        step, net, disp, _ = model.begin(
            torch.from_numpy(setup["left"]), torch.from_numpy(setup["right"]))
        for _ in range(2):
            net, disp, mask = step(net, disp)
        torch.testing.assert_close(low, disp, rtol=0, atol=0)
        torch.testing.assert_close(up, model._upsample(disp, mask), rtol=0,
                                   atol=0)
    jm = JaxRAFTStereo(JaxConfig(**TINY))
    jlow, _ = jm.apply(setup["variables"], jnp.asarray(setup["left"],
                                                       jnp.float32),
                       jnp.asarray(setup["right"], jnp.float32), iters=2,
                       test_mode=True)
    np.testing.assert_allclose(low.numpy(), np.asarray(jlow), atol=FLOW_ATOL,
                               rtol=0)


def test_batch_rides_to_the_hard_members_depth(setup):
    """The exit test is the worst member's mean |delta|: the easy pair
    alone stops at 2, batched with the hard one it rides to 3."""
    d = setup["deltas"]
    thr = _midpoint(d[1, 1], d[1, 0])
    assert d[0, 1] >= thr and d[2, 0] < thr
    assert _port(setup, [1], thr)[2] == 2
    jlow, _, jused = _jax_exit(setup, [0, 1], thr, 1)
    low, _, used = _port(setup, [0, 1], thr)
    assert int(jused) == used == 3
    np.testing.assert_allclose(low.numpy(), np.asarray(jlow), atol=FLOW_ATOL,
                               rtol=0)


@pytest.mark.parametrize("adaptive", [False, True])
def test_confidence_matches_jax(setup, adaptive):
    thr = _case(setup["deltas"], "between")[1] if adaptive else 0.0
    if adaptive:
        jout = _jax_exit(setup, [0], thr, 1, return_confidence=True)
    else:
        jout = JaxRAFTStereo(JaxConfig(**TINY)).apply(
            setup["variables"], jnp.asarray(setup["left"][[0]], jnp.float32),
            jnp.asarray(setup["right"][[0]], jnp.float32), iters=3,
            test_mode=True, return_confidence=True)
    out = _port(setup, [0], thr, iters=CAP if adaptive else 3,
                return_confidence=True)
    assert len(out) == len(jout) == (4 if adaptive else 3)
    if adaptive:
        assert out[2] == int(jout[2]) == _expected(setup["deltas"][:, 0],
                                                   thr, 1)
    (conf_low, conf_up), (jlow, jup) = out[-1], jout[-1]
    assert conf_low.shape == (1, 16, 24) and conf_up.shape == (1, 64, 96)
    assert float(conf_low.min()) > 0 and float(conf_up.max()) <= 1
    np.testing.assert_allclose(conf_low.numpy(), np.asarray(jlow),
                               atol=CONF_ATOL, rtol=0)
    np.testing.assert_allclose(conf_up.numpy(), np.asarray(jup),
                               atol=CONF_ATOL, rtol=0)
    assert CONF_ATOL == 3 * FLOW_ATOL / CONFIDENCE_SCALE_PX


def test_hidden_and_ctx_round_trips_match_jax(setup):
    """Frame 1 returns its hidden states and context bundle; frame 2
    resumes from them with frame 1's flow as its warm start, on both
    sides.  Reusing a frame's own bundle changes nothing."""
    v = setup["variables"]
    l1, r1 = setup["left"][[0]], setup["right"][[0]]
    l2, r2 = setup["left"][[1]], setup["right"][[1]]
    jm = JaxRAFTStereo(JaxConfig(**TINY))
    jlow1, _, jhid, jctx = jm.apply(
        v, jnp.asarray(l1, jnp.float32), jnp.asarray(r1, jnp.float32),
        iters=2, test_mode=True, return_hidden=True, return_ctx=True)
    jlow2, jup2 = jm.apply(
        v, jnp.asarray(l2, jnp.float32), jnp.asarray(r2, jnp.float32),
        iters=2, test_mode=True, flow_init=jlow1, hidden_init=jhid,
        ctx_init=jctx)
    model = RAFTStereo(RaftStereoConfig(**TINY)).eval()
    model.load_state_dict(setup["state"])
    t1, t2 = (torch.from_numpy(x) for x in (l1, r1))
    with torch.no_grad():
        low1, up1, hid, ctx = model(t1, t2, iters=2, return_hidden=True,
                                    return_ctx=True)
        for got, want in zip(hid, jhid):
            np.testing.assert_allclose(got.numpy(), np.asarray(want).transpose(
                0, 3, 1, 2), atol=FLOW_ATOL, rtol=0)
        for got, want in zip(ctx[0], jctx[0]):
            np.testing.assert_allclose(got.numpy(), np.asarray(want).transpose(
                0, 3, 1, 2), atol=FLOW_ATOL, rtol=0)
        again = model(t1, t2, iters=2, ctx_init=ctx)
        torch.testing.assert_close(again[1], up1, rtol=0, atol=0)
        low2, up2 = model(torch.from_numpy(l2), torch.from_numpy(r2),
                          iters=2, flow_init=low1, hidden_init=hid,
                          ctx_init=ctx)
    np.testing.assert_allclose(low2.numpy(), np.asarray(jlow2),
                               atol=FLOW_ATOL, rtol=0)
    np.testing.assert_allclose(up2.numpy(), np.asarray(jup2), atol=FLOW_ATOL,
                               rtol=0)


@pytest.mark.parametrize("kwargs,pattern", [
    ({"return_confidence": True}, "test-mode"),
    ({"return_hidden": True}, "test-mode"),
    ({"ctx_init": ((), ())}, "test-mode"), ({"return_ctx": True}, "test-mode"),
    ({"hidden_init": ()}, "test-mode")])
def test_state_modes_are_test_mode_only_as_in_jax(setup, kwargs, pattern):
    img = torch.zeros((1, 32, 32, 3))
    model = RAFTStereo(RaftStereoConfig(**TINY))
    with pytest.raises(ValueError, match=pattern):
        model(img, img, iters=1, test_mode=False, **kwargs)
    jm = JaxRAFTStereo(JaxConfig(**TINY))
    jimg = jnp.zeros((1, 32, 32, 3))
    with pytest.raises(ValueError, match=pattern):
        jm.apply(setup["variables"], jimg, jimg, iters=1, test_mode=False,
                 **kwargs)


def test_ctx_init_refused_with_shared_backbone():
    model = RAFTStereo(RaftStereoConfig.realtime())
    img = torch.zeros((1, 32, 32, 3))
    with pytest.raises(ValueError, match="shared_backbone"):
        model(img, img, iters=1, ctx_init=((), ()))


@pytest.mark.parametrize("kw", [{"exit_min_iters": 0},
                                {"exit_min_iters": 3, "exit_max_iters": 2}])
def test_exit_knobs_validated_as_in_jax(kw):
    with pytest.raises(ValueError, match="exit_m"):
        RaftStereoConfig(**kw)
    with pytest.raises(ValueError, match="exit_m"):
        JaxConfig(**kw)
    cfg = RaftStereoConfig(exit_threshold_px=0.05, exit_min_iters=2,
                           exit_max_iters=5)
    assert cfg.to_dict() == JaxConfig(exit_threshold_px=0.05,
                                      exit_min_iters=2,
                                      exit_max_iters=5).to_dict()
    assert early_exit_enabled(cfg) and not early_exit_enabled(
        RaftStereoConfig())


def test_predicate_plain_version():
    """The host predicate and the wrapper's CPU path: the JAX loop's
    condition, NaN ending the loop, the threshold compared in fp32."""
    assert exit_continues(0, float("inf"), 1, 4, 0.5)
    assert exit_continues(1, 0.0, 2, 4, 0.5)          # below min_iters
    assert not exit_continues(2, 0.4, 2, 4, 0.5)
    assert exit_continues(2, 0.5, 2, 4, 0.5)
    assert not exit_continues(4, 9.0, 2, 4, 0.5)      # at the cap
    assert not exit_continues(2, float("nan"), 1, 4, 0.5)
    assert f32(0.1) == float(np.float32(0.1)) != 0.1
    it = torch.zeros((), dtype=torch.int32)
    assert exit_predicate(0, it, torch.tensor(0.7), 1, 4, 0.5)
    assert int(it) == 1
    assert not exit_predicate(0, it, torch.tensor(0.3), 1, 4, 0.5)
    with pytest.raises(ValueError, match="int32"):
        exit_predicate(0, torch.zeros(()), torch.tensor(0.3), 1, 4, 0.5)


# ------------------------------------------------------------- the runner
@pytest.fixture(scope="module")
def runners(setup):
    """(port runner, JAX runner) with early exit at the 'between'
    threshold, cap CAP."""
    thr = _between(setup["deltas"])
    port = InferenceRunner(RaftStereoConfig(**TINY), setup["state"],
                           iters=CAP, device="cpu", exit_threshold_px=thr,
                           exit_min_iters=1)
    jaxr = JaxRunner(JaxConfig(**TINY), setup["variables"], iters=CAP,
                     exit_threshold_px=thr, exit_min_iters=1)
    return port, jaxr


def test_runner_counts_iters_used_as_jax(setup, runners):
    port, jaxr = runners
    hard, easy = setup["raw"]
    d, thr = setup["deltas"], _between(setup["deltas"])
    want = [_expected(d[:, i], thr, 1) for i in (0, 1)]
    port.reset_iters_used()
    jaxr.reset_iters_used()
    for pair, used in zip((hard, easy), want):
        flow, _ = port(*pair)
        jflow, _ = jaxr(*pair)
        np.testing.assert_allclose(flow, jflow, atol=FLOW_ATOL, rtol=0)
        assert port.last_iters_used == jaxr.last_iters_used == used
    assert port.iters_used_mean() == jaxr.iters_used_mean() == sum(want) / 2
    port.run_batch([hard[0], easy[0]], [hard[1], easy[1]])
    assert port.last_iters_used == max(want)
    port.reset_iters_used()
    assert port.iters_used_mean() is None and port.last_iters_used is None
    assert list(port._compiled) == [((64, 96), 1, port._exit_key()[0]),
                                    ((64, 96), 2, port._exit_key()[0])]


def test_run_stream_matches_jax(setup, runners):
    """Three frames: cold, warm, warm with the hidden state carried."""
    port, jaxr = runners
    hard, easy = setup["raw"]
    frames = [hard, easy, hard]
    state, hidden, jstate, jhidden = None, None, None, None
    for i, (l, r) in enumerate(frames):
        f = port.run_stream(l, r, prev_flow_low=state, prev_hidden=hidden,
                            carry_hidden=i >= 1)
        j = jaxr.run_stream(l, r, prev_flow_low=jstate, prev_hidden=jhidden,
                            carry_hidden=i >= 1)
        assert f.warm == j.warm == (i > 0)
        assert f.iters_used == j.iters_used
        assert f.flow_low.shape == (16, 24) and f.flow_low.dtype == np.float32
        np.testing.assert_allclose(f.flow, j.flow, atol=FLOW_ATOL, rtol=0)
        np.testing.assert_allclose(f.flow_low, j.flow_low, atol=FLOW_ATOL,
                                   rtol=0)
        assert (f.hidden is None) == (j.hidden is None) == (i == 0)
        if f.hidden is not None:
            for a, b in zip(f.hidden, j.hidden):
                np.testing.assert_allclose(a, np.asarray(b).transpose(
                    2, 0, 1), atol=FLOW_ATOL, rtol=0)
        state, hidden, jstate, jhidden = (f.flow_low, f.hidden, j.flow_low,
                                          j.hidden)
    assert len(port._stream_compiled) == 3
    with pytest.raises(ValueError, match="changed resolution"):
        port.run_stream(hard[0][:32], hard[1][:32], prev_flow_low=state)
    with pytest.raises(ValueError, match="prev_flow_low"):
        port.run_stream(*hard, prev_hidden=hidden)


def test_stream_programs_of_make_forward(setup):
    """The streaming signature: flow_low in fp32 whatever the fetch
    dtype, ctx "save" then "reuse" equal, confidence in its place."""
    cfg = RaftStereoConfig(**TINY)
    model = RAFTStereo(cfg).eval()
    model.load_state_dict(setup["state"])
    l, r = (torch.from_numpy(x[[0]]) for x in (setup["left"],
                                               setup["right"]))
    with torch.inference_mode():
        up, low, conf, ctx = make_forward(
            model, 2, torch.float16, ctx="save", return_confidence=True)(l, r)
        assert up.dtype == torch.float16 and low.dtype == torch.float32
        assert len(conf) == 2 and len(ctx) == 2
        up2, low2, hid = make_forward(model, 2, ctx="reuse",
                                      return_hidden=True)(l, r, ctx)
        torch.testing.assert_close(low2, low, rtol=0, atol=0)
        assert len(hid) == 3
        with pytest.raises(ValueError, match="ctx"):
            make_forward(model, 2, ctx="load")


def test_sequence_drift_matches_jax(runners, tmp_path):
    port, jaxr = runners
    make_kitti(str(tmp_path / "KITTI"), np.random.default_rng(3), n=3)
    got = sequence_drift(port, ds.KITTI(root=str(tmp_path / "KITTI")),
                         "kitti")
    want = jax_drift(jaxr, jds.KITTI(root=str(tmp_path / "KITTI")), "kitti")
    assert set(got) == set(want)
    for key in ("kitti-epe-cold", "kitti-epe-warm", "kitti-warm-drift-epe"):
        assert abs(got[key] - want[key]) <= FLOW_ATOL, key
    for key in ("kitti-iters-cold-mean", "kitti-iters-warm-mean"):
        assert got[key] == want[key], key


def test_demo_and_evaluate_sequence_flags(setup, tmp_path):
    """``--device cpu`` drives of the demo's ``--sequence``,
    ``--exit_threshold_px`` and ``--min_iters`` (frame by frame equal to
    the runner's chain with the keyframe guard) and evaluate's
    ``--sequence --stream_out`` (the record of the JAX CLI, with its run
    block)."""
    from PIL import Image

    thr = _between(setup["deltas"])
    ckpt = str(tmp_path / "ckpt")
    save_checkpoint(ckpt, RaftStereoConfig(**TINY), setup["state"])
    frames = list(setup["raw"]) * 2
    for i, (l, r) in enumerate(frames):
        Image.fromarray(l).save(tmp_path / f"f{i}_0.png")
        Image.fromarray(r).save(tmp_path / f"f{i}_1.png")
    out = tmp_path / "out"
    demo.main(["--restore_ckpt", ckpt, "--sequence", str(tmp_path / "f*_0.png"),
               "-l", "unused", "-r", str(tmp_path / "f*_1.png"),
               "--output_directory", str(out), "--valid_iters", str(CAP),
               "--exit_threshold_px", str(thr), "--min_iters", "1",
               "--save_numpy", "--device", "cpu"])
    runner = InferenceRunner(RaftStereoConfig(**TINY), setup["state"],
                             iters=CAP, device="cpu", exit_threshold_px=thr)
    state = None
    for i, (l, r) in enumerate(frames):
        f = runner.run_stream(l, r, prev_flow_low=state)
        state = (None if f.warm and f.iters_used >= CAP else f.flow_low)
        np.testing.assert_array_equal(np.load(out / f"f{i}_0.npy"),
                                      f.disparity)
    make_kitti(str(tmp_path / "data" / "KITTI"), np.random.default_rng(3),
               n=3)
    rec_path = str(tmp_path / "stream.json")
    results = evaluate.main(
        ["--restore_ckpt", ckpt, "--dataset", "kitti", "--data_root",
         str(tmp_path / "data"), "--valid_iters", str(CAP), "--sequence",
         "--exit_threshold_px", str(thr), "--min_iters", "1",
         "--stream_out", rec_path, "--device", "cpu"])
    rec = json.load(open(rec_path))
    assert rec["metric"] == "warm_start_sequence_drift"
    assert rec["value"] == results["kitti-warm-drift-epe"]
    assert rec["results"] == {k: round(v, 5) for k, v in results.items()}
    assert {"dataset", "valid_iters", "exit_threshold_px", "min_iters",
            "unit", "run"} <= set(rec)
    assert rec["run"]["device_kind"] == "cpu"
    plain = evaluate.main(
        ["--restore_ckpt", ckpt, "--dataset", "kitti", "--data_root",
         str(tmp_path / "data"), "--valid_iters", str(CAP),
         "--exit_threshold_px", str(thr), "--device", "cpu"])
    assert 1 <= plain["kitti-iters-used-mean"] <= CAP
    assert os.path.exists(rec_path)


@pytest.mark.parametrize("flags", [
    {}, {"return_confidence": True},
    {"warm_start": True, "return_state": True, "hidden_init": True,
     "return_hidden": True}, {"ctx": "save", "return_confidence": True}])
def test_exit_stages_equal_the_eager_loop(setup, flags):
    """Under early exit ``make_forward`` builds an ``ExitStages``, whose
    three parts (what the WHILE graph captures), run eagerly, give the
    model's own exit loop bit for bit, in the program's output order."""
    from torch.utils._pytree import tree_flatten

    from raft_stereo_tpu_torch.eval.runner import ExitStages

    thr = _between(setup["deltas"])
    cfg = RaftStereoConfig(**TINY, exit_threshold_px=thr)
    model = RAFTStereo(cfg).eval()
    model.load_state_dict(setup["state"])
    args = [torch.from_numpy(setup["left"][[0]]),
            torch.from_numpy(setup["right"][[0]])]
    kwargs = {"return_confidence": flags.get("return_confidence", False),
              "return_ctx": flags.get("ctx") == "save",
              "return_hidden": flags.get("return_hidden", False)}
    with torch.inference_mode():
        if flags.get("warm_start"):
            hid = model(*args, iters=2, return_hidden=True)[-1]
            args += [torch.full((1, 16, 24), -1.5), hid]
            kwargs.update(flow_init=args[2], hidden_init=hid)
        program = make_forward(model, CAP, **flags)
        got = program(*args)
        want = model(*args[:2], iters=CAP, test_mode=True, **kwargs)
    assert isinstance(program, ExitStages)
    stream = len(flags) > 1 or "ctx" in flags
    head = (want[1], want[0]) if stream else (want[1],)
    assert int(got[len(head)]) == want[2]
    got, _ = tree_flatten(got[:len(head)] + got[len(head) + 1:])
    want, _ = tree_flatten(head + want[3:])
    assert len(got) == len(want)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
