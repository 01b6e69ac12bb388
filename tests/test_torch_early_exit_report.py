"""The port's early-exit sweep (``raft_stereo_tpu_torch/tools/
early_exit_report.py``) against the JAX package's tool (CPU).

* The four benchmark trees of ``data/scenes.py`` equal
  ``tests/golden_data.py``'s file for file, byte for byte, each tree
  function alone and all four as the two tools build them (one seed).
* On shared seeded weights (Flax init of the tool's hermetic architecture,
  norm leaves perturbed, then the settling GRU of
  ``torch_port_support.settle_jax``, no training: random weights make the
  updates grow each iteration, so every image's deltas would cross any
  threshold at once and all within 10% of each other; settled, they
  shrink by 0.73 an iteration, as a trained network's do), one image per
  validator at 60x90
  and a cap of 4 iterations, the port's ``sweep`` against the JAX tool's
  own functions: the fixed baseline's and every swept row's EPE within
  FLOW_ATOL = 2e-3 px (the whole-forward tolerance of the port), every
  row's mean ``iters_used`` equal, and the operating point the same row.
  The two thresholds lie at midpoints of JAX's own per-iteration deltas,
  each at least 5% from every delta, so that no summation order can move
  a trip count.  ``--max_depe`` lies midway between the two rows' worst
  deltas, so that the rule picks one of them.
"""

import argparse
import filecmp
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import golden_data
from raft_stereo_tpu.data import datasets as jds
from raft_stereo_tpu.eval.runner import InferenceRunner as JaxRunner
from raft_stereo_tpu.models.raft_stereo import RAFTStereo as JaxRAFTStereo
from raft_stereo_tpu_torch.config import RaftStereoConfig
from raft_stereo_tpu_torch.data import scenes
from raft_stereo_tpu_torch.io.jax_weights import state_dict_from_jax
from raft_stereo_tpu_torch.kernels.graph_loop import exit_continues
from raft_stereo_tpu_torch.tools import early_exit_report as port_tool
from torch_port_support import perturb, settle_jax

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
import early_exit_report as jax_tool  # noqa: E402  (the JAX package's)

FLOW_ATOL = 2e-3
HW = (60, 90)
CAP = 4
MIN_ITERS = 2


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _files(root):
    out = []
    for d, _, names in os.walk(root):
        out += [os.path.relpath(os.path.join(d, n), root) for n in names]
    return sorted(out)


def _same_trees(mine, theirs, n_files):
    files = _files(mine)
    assert files == _files(theirs) and len(files) == n_files
    _, mismatch, errors = filecmp.cmpfiles(mine, theirs, files,
                                           shallow=False)
    assert not mismatch and not errors


@pytest.mark.parametrize("n, hw", [(2, HW), (3, (64, 96))])
def test_build_benchmarks_equals_the_jax_tools(tmp_path, n, hw):
    """The sweep's four trees, one seeded generator in the JAX tool's
    order: 13 files a scene and the Middlebury listing."""
    mine, theirs = tmp_path / "port", tmp_path / "jax"
    port_tool.build_benchmarks(str(mine), n, hw)
    jax_tool.build_benchmarks(str(theirs), n, hw)
    _same_trees(mine, theirs, 13 * n + 1)


@pytest.mark.parametrize("make, files", [
    ("make_eth3d", 6), ("make_kitti", 6), ("make_things", 6),
    ("make_middlebury", 9)])
def test_benchmark_trees_equal_golden_data(tmp_path, make, files):
    mine, theirs = tmp_path / "port", tmp_path / "jax"
    for root, mod in ((mine, scenes), (theirs, golden_data)):
        getattr(mod, make)(str(root), np.random.default_rng(11), n=2,
                              hw=HW)
    _same_trees(mine, theirs, files)


@pytest.fixture(scope="module")
def shared(tmp_path_factory):
    """The JAX tool's architecture and settled variables, its trees, and
    the per-iteration deltas of the first image of each validator (JAX,
    fixed depth, the runner's edge padding to 64x96)."""
    jcfg = jax_tool.model_config()
    model = JaxRAFTStereo(jcfg)
    dummy = jnp.zeros((1, 32, 32, 3), jnp.float32)
    init = jax.jit(lambda key: model.init(key, dummy, dummy, iters=1,
                                          test_mode=True))
    variables = settle_jax(perturb(init(jax.random.PRNGKey(0)),
                                   np.random.default_rng(7)))
    root = str(tmp_path_factory.mktemp("ee") / "datasets")
    jax_tool.build_benchmarks(root, n=1, hw=HW)
    samples = [d[0] for d in (
        jds.ETH3D(root=os.path.join(root, "ETH3D")),
        jds.KITTI(root=os.path.join(root, "KITTI")),
        jds.SceneFlow(root=root, dstype="frames_finalpass",
                      things_test=True),
        jds.Middlebury(root=os.path.join(root, "Middlebury"), split="H"))]
    pad = ((0, 0), (2, 2), (3, 3), (0, 0))
    left = np.pad(np.stack([s["image1"] for s in samples]), pad, mode="edge")
    right = np.pad(np.stack([s["image2"] for s in samples]), pad,
                   mode="edge")
    lows = [np.asarray(model.apply(
        variables, jnp.asarray(left, jnp.float32),
        jnp.asarray(right, jnp.float32), iters=k, test_mode=True,
        unroll_gru=True)[0]) for k in range(CAP + 1)]
    deltas = np.stack([np.abs(b - a).mean(axis=(1, 2))
                       for a, b in zip(lows, lows[1:])])   # (CAP, 4)
    return dict(jcfg=jcfg, variables=variables, root=root, deltas=deltas)


def _thresholds(deltas):
    """Two thresholds, loosest first, at midpoints of adjacent deltas of
    the iterations the exit test reads (from ``MIN_ITERS`` on), each at
    least 5% from every delta, giving different mean trip counts."""
    seen = np.sort(deltas[MIN_ITERS - 1:].ravel())
    found = {}
    for lo, hi in zip(seen, seen[1:]):
        if hi < 1.1 * lo:
            continue
        thr = float((lo + hi) / 2)
        if (np.abs(deltas / thr - 1) >= 0.05).all():
            found.setdefault(_mean_trips(deltas, thr), thr)
    assert len(found) >= 2, f"no two thresholds split the deltas {deltas}"
    picked = sorted(found.values())
    return [picked[-1], picked[0]]


def _mean_trips(deltas, thr):
    trips = []
    for d in deltas.T:
        it, delta = 0, float("inf")
        while exit_continues(it, delta, MIN_ITERS, CAP, thr):
            delta, it = float(d[it]), it + 1
        trips.append(it)
    return float(np.mean(trips))


@pytest.fixture(scope="module")
def both(shared):
    """The JAX tool's baseline and rows, and the port's record."""
    jcfg, variables, root = shared["jcfg"], shared["variables"], shared["root"]
    thresholds = _thresholds(shared["deltas"])
    fixed = jax_tool.run_validators(JaxRunner(jcfg, variables, iters=CAP),
                                    root)
    baseline = {v: fixed[f"{v}-epe"] for v in jax_tool.VALIDATORS}
    rows = [jax_tool.sweep_row(jcfg, variables, CAP, root, t, MIN_ITERS,
                               baseline) for t in thresholds]
    worst = sorted(r["max_depe_px"] for r in rows)
    assert worst[1] - worst[0] > 4 * FLOW_ATOL, worst
    max_depe = (worst[0] + worst[1]) / 2
    args = port_tool.build_parser().parse_args([
        "--device", "cpu", "--iters", str(CAP), "--min_iters",
        str(MIN_ITERS), "--images", "1", "--hw", f"{HW[0]}x{HW[1]}",
        "--thresholds", ",".join(repr(t) for t in thresholds),
        "--max_depe", repr(max_depe), "--lat_repeats", "1"])
    cfg = RaftStereoConfig.from_dict(jcfg.to_dict())
    rec = port_tool.sweep(cfg, state_dict_from_jax(variables), args)
    # the JAX tool's rule, as its main() applies it
    admissible = [r for r in rows if r["max_depe_px"] <= max_depe]
    return dict(baseline=baseline, rows=rows, chosen=admissible[0],
                thresholds=thresholds, rec=rec, deltas=shared["deltas"])


def test_fixed_baseline_matches_jax(both):
    got = both["rec"]["fixed_baseline_epe"]
    for v in jax_tool.VALIDATORS:
        assert abs(got[v] - both["baseline"][v]) <= FLOW_ATOL + 5e-5, v


def test_swept_rows_match_jax(both):
    got = both["rec"]["sweep"]
    assert len(got) == len(both["rows"]) == 2
    for mine, theirs, thr in zip(got, both["rows"], both["thresholds"]):
        assert mine["exit_threshold_px"] == theirs["exit_threshold_px"] == thr
        assert set(mine) == set(theirs)
        assert mine["mean_iters_used"] == theirs["mean_iters_used"] == (
            _mean_trips(both["deltas"], thr))
        assert mine["iters_fraction_of_fixed"] == (
            theirs["iters_fraction_of_fixed"])
        for v in jax_tool.VALIDATORS:
            assert abs(mine["epe"][v] - theirs["epe"][v]) <= (
                FLOW_ATOL + 5e-5), v
    assert got[0]["mean_iters_used"] != got[1]["mean_iters_used"]


def test_the_operating_point_is_jax_s(both):
    chosen = both["rec"]["chosen"]
    assert chosen is not None
    assert chosen["exit_threshold_px"] == both["chosen"]["exit_threshold_px"]
    assert chosen["mean_iters_used"] == both["chosen"]["mean_iters_used"]
    assert both["rec"]["meets_60pct_bar"] == (
        both["chosen"]["iters_fraction_of_fixed"] <= 0.60)


def test_record_fields_are_the_jax_tool_s(both):
    """The JAX record's fields, plus the card that ran it (None here)."""
    want = {"metric", "value", "unit", "platform", "model_config",
            "fixed_iters", "min_iters", "train_steps", "train_seconds",
            "validators", "images_per_validator", "fixed_baseline_epe",
            "sweep", "chosen", "meets_60pct_bar", "tier_presets",
            "tier_latency", "interactive_calibrated_p50_speedup_vs_fixed",
            "notes"}
    rec = both["rec"]
    assert set(rec) == want | {"card"}
    assert rec["card"] is None and rec["platform"] == "cpu"
    assert [r["tier"] for r in rec["tier_latency"]] == [
        "fixed", "interactive", "interactive@calibrated"]
    assert rec["model_config"] == jax_tool.model_config().to_dict()


def test_the_parser_takes_the_jax_tool_s_flags():
    """Every flag of the JAX tool, with its default, and ``--device``;
    only the default record's name differs (``--tag``: the port's records
    go under its build directory, never at the repository's root)."""
    def flags(parser):
        return {a.dest: a.default for a in parser._actions
                if not isinstance(a, argparse._HelpAction)}
    mine, theirs = (flags(port_tool.build_parser()),
                    flags(jax_tool.build_parser()))
    assert set(mine) == set(theirs) | {"device"}
    assert {k: mine[k] for k in theirs if k != "tag"} == {
        k: v for k, v in theirs.items() if k != "tag"}
