"""The drift gate's harness and tools against the JAX package (CPU).

The scene generators of ``data/scenes.py`` are held bit for bit against
``tests/golden_data.py``, the record schema and the training stream
against ``tools/drift_common.py`` and ``tools/quant_drift.py``, the gate
object against the JAX tool's own, and ``evaluate_variants``' rows of the
five variants against the JAX harness on carried hermetic weights (JAX's
``early_exit_report.init_variables``) with one calibration record on
both sides.

Tolerances of the rows (mean EPE of a variant over a band's scenes):
``fp32`` and ``int8_w`` (fp32 arithmetic over the dequantized weights,
which are bit-equal on both sides) within EPE_ATOL = 2e-3 px, the
whole-forward bound of tests/test_torch_model.py (a mean moves less than
its worst pixel).  The other variants are held by their drift, dEPE (EPE
less the fp32 EPE), against JAX's, each to a bound that a variant which
did not run as it should fails:

* ``bf16``: a bf16 value flips where the two frameworks round an fp32
  value on either side of a boundary.  Held, as in
  tests/test_torch_realtime.py, to SPREAD_FACTOR = 3x the JAX package's
  own spread, measured in the test as the larger of two moves of its
  dEPE: its two routes on the same weights (the Pallas kernels in
  interpret mode against its XLA fallback) and every fp32 weight moved
  by one ulp, plus EPE_ATOL.  The bf16 dEPE of random weights is chaotic
  in the last bits: the routes alone are no measure of it, and the
  port's own reading moves with the host CPU's fp32 summation order.
  Readings: JAX's routes -0.0002 / +0.0077 px at d<=24 and 0.0747 /
  0.0768 at d<=48, its one-ulp move -0.0105 and 0.0931; the port -0.0052
  and 0.0775 on one host, -0.0130 and 0.0637 on an AMD EPYC host.
* ``int8`` (1-byte pyramid) and ``int8_mxu`` (int8 activations): JAX's
  two routes agree on these to the last digit, so they give no spread to
  scale from.  The port's dEPE must be nonzero where JAX's is, and
  within DEPE_FRACTION = 1/2 of JAX's |dEPE| plus EPE_ATOL: an
  unquantized variant (dEPE 0) or a doubled quantization error fails.
  Readings: int8 -0.0142 / -0.0424 px against JAX's -0.0142 / -0.0419
  (within 1.2%); int8_mxu -0.0441 / -0.2270 against -0.0575 / -0.2804
  (23% and 19%).  The port's int8 codes are those of JAX's forward
  applied without ``jit``; XLA's fused arithmetic in the jitted runner
  moves an activation by an ulp across a half-code boundary and each int8
  conv after it multiplies the flip (tests/test_torch_quant_codes.py), so
  the gap is JAX's own jit-vs-eager spread and DEPE_FRACTION stays.

The calibration record is the port's, fed to both sides (the port reads
and writes the JAX package's scale files).
"""

import json
import os
import sys
import types

import numpy as np
import pytest
import torch

import golden_data
from raft_stereo_tpu_torch.config import RaftStereoConfig
from raft_stereo_tpu_torch.data import scenes
from raft_stereo_tpu_torch.eval import drift
from raft_stereo_tpu_torch.telemetry.events import write_record
from raft_stereo_tpu_torch.io.jax_weights import state_dict_from_jax
from raft_stereo_tpu_torch.quant.calibrate import (conv_input_scales,
                                                   corr_scales)
from raft_stereo_tpu_torch.quant.core import quantize_state_dict
from raft_stereo_tpu_torch.tools import bf16_drift, quant_drift

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
import drift_common  # noqa: E402  (the JAX package's tool)
import early_exit_report  # noqa: E402
import quant_drift as jax_quant_drift  # noqa: E402

EPE_ATOL = 2e-3
SPREAD_FACTOR = 3.0
DEPE_FRACTION = 0.5
HW = (64, 160)
BANDS = {"d<=24": 24.0, "d<=48": 48.0}


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", ["textured_image", "disparity_field",
                                  "layered_scene", "warp_right"])
def test_scenes_bit_equal_golden_data(name):
    def call(mod, rng):
        if name == "warp_right":
            left = mod.textured_image(rng, 24, 40)
            return mod.warp_right(left, mod.disparity_field(rng, 24, 40))
        if name == "layered_scene":
            return mod.layered_scene(rng, 32, 64, d_max=24.0)
        return getattr(mod, name)(rng, 24, 40)

    got = call(scenes, np.random.default_rng(5))
    want = call(golden_data, np.random.default_rng(5))
    for a, b in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_band_scenes_and_calibration_pairs_match_jax():
    got = drift.make_band_scenes(32, 96, BANDS, n_per_band=1)
    want = drift_common.make_band_scenes(32, 96, BANDS, n_per_band=1)
    assert list(got) == list(want)
    for band in got:
        for a, b in zip(got[band][0], want[band][0]):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(drift.calibration_pairs((32, 48), 2, disp_scale=3.0),
                    jax_quant_drift.calibration_pairs((32, 48), 2,
                                                      disp_scale=3.0)):
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
    assert drift.DEFAULT_BANDS == drift_common.DEFAULT_BANDS


def test_drift_record_matches_jax():
    rng = np.random.default_rng(2)
    preds = {n: [rng.normal(size=(8, 12)) for _ in range(2)]
             for n in ("fp32", "int8", "bf16")}
    epes = {n: list(rng.uniform(1, 3, 2)) for n in preds}
    got = drift.drift_record("m", "w", 4, "d<=48", epes, preds, "fp32",
                             "int8")
    want = drift_common.drift_record("m", "w", 4, "d<=48", epes, preds,
                                     "fp32", "int8")
    assert list(got) == list(want) and got == want


def test_brief_train_stream_matches_jax(monkeypatch):
    """The training batches are the JAX recipe's bit for bit (its
    ``Stream``, caught at JAX's ``train``), and two port steps give finite
    losses."""
    import raft_stereo_tpu.training.train_loop as jloop

    caught = {}

    def fake_train(mcfg, tcfg, **kw):
        caught["loader"], caught["tcfg"] = kw["loader"], tcfg
        return types.SimpleNamespace(params={}, batch_stats={})

    monkeypatch.setattr(jloop, "train", fake_train)
    jax_quant_drift.brief_train(early_exit_report.model_config(), 2,
                                (32, 48), 2, 3.0)
    stream = drift.WarpedStream(drift.warped_scenes((32, 48), 12, 3.0), 2, 2)
    got, want = list(stream), list(caught["loader"])
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for k in g:
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k])
    losses = []
    state = drift.brief_train(
        drift.model_config(), 2, (32, 48), 2, 3.0, device="cpu",
        on_step=lambda step, m: losses.append(float(m["loss"])))
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert all(torch.isfinite(v).all() for v in state.values()
               if v.is_floating_point())
    assert set(state) == set(drift.init_state(drift.model_config()))
    assert caught["tcfg"].seed == 3 and caught["tcfg"].lr == 2e-4


@pytest.fixture(scope="module")
def hermetic():
    """JAX's hermetic variables and a calibration record of them."""
    import jax

    from raft_stereo_tpu_torch.quant.calibrate import calibrate

    jcfg = early_exit_report.model_config()
    variables = jax.device_get(early_exit_report.init_variables(jcfg))
    record = calibrate(RaftStereoConfig.from_json(jcfg.to_json()),
                       state_dict_from_jax(variables),
                       drift.calibration_pairs((40, 112), 2, disp_scale=4.0),
                       device="cpu")
    return jcfg, variables, record


def _variants(cfg, state, record, mxu_state):
    import dataclasses

    int8 = dataclasses.replace(cfg, quant="int8",
                               quant_corr_scales=corr_scales(record))
    return {"fp32": (cfg, state),
            "bf16": (dataclasses.replace(cfg, mixed_precision=True), state),
            "int8": (int8, state),
            "int8_w": (dataclasses.replace(int8, quant_corr=False), state),
            "int8_mxu": (dataclasses.replace(int8, quant="int8_mxu"),
                         mxu_state)}


def test_evaluate_variants_matches_jax(hermetic):
    import dataclasses

    import jax

    from raft_stereo_tpu import quant as jquant
    from raft_stereo_tpu.kernels import corr_lookup as jcorr_lookup

    jcfg, variables, record = hermetic
    cfg = RaftStereoConfig.from_json(jcfg.to_json())
    state = state_dict_from_jax(variables)
    mxu = quantize_state_dict(state, act_scales=conv_input_scales(record))
    jmxu = jquant.quantize_variables(
        variables, act_scales=jquant.conv_input_scales(record))
    jint8 = dataclasses.replace(
        jcfg, quant="int8", quant_corr_scales=jquant.corr_scales(record))
    jvariants = {
        "fp32": (jcfg, variables),
        "bf16": (dataclasses.replace(jcfg, mixed_precision=True), variables),
        "int8": (jint8, variables),
        "int8_w": (dataclasses.replace(jint8, quant_corr=False), variables),
        "int8_mxu": (dataclasses.replace(jint8, quant="int8_mxu"), jmxu)}
    band_scenes = drift.make_band_scenes(*HW, BANDS, n_per_band=1)
    got = drift.evaluate_variants(
        "int8_epe_drift", "seeded_init",
        _variants(cfg, state, record, mxu), band_scenes, [2], "fp32",
        "int8", {"corr_fp32_auto": False, "device": "cpu"})
    want = drift_common.evaluate_variants(
        "int8_epe_drift", "seeded_init", jvariants, band_scenes, [2],
        "fp32", "int8", {"corr_fp32_auto": False})
    jcorr_lookup._interpret_override = True
    try:
        kernel_route = drift_common.evaluate_variants(
            "bf16_epe_drift", "seeded_init",
            {n: jvariants[n] for n in ("fp32", "bf16")}, band_scenes, [2],
            "fp32", "bf16", {"corr_fp32_auto": False})
    finally:
        jcorr_lookup._interpret_override = None
    ulp = jax.tree_util.tree_map(
        lambda x: (x * np.float32(1 + 2.0 ** -23)).astype(x.dtype)
        if x.dtype == np.float32 else x, variables)
    ulp_route = drift_common.evaluate_variants(
        "bf16_epe_drift", "seeded_init",
        {"fp32": (jcfg, ulp),
         "bf16": (dataclasses.replace(jcfg, mixed_precision=True), ulp)},
        band_scenes, [2], "fp32", "bf16", {"corr_fp32_auto": False})
    for g, w, k, u in zip(got, want, kernel_route, ulp_route):
        assert list(g) == list(w)
        for name in ("fp32", "int8_w"):
            assert abs(g[f"epe_{name}"] - w[f"epe_{name}"]) <= EPE_ATOL, (
                name, g, w)
        spread = max(abs(k["depe_bf16"] - w["depe_bf16"]),
                     abs(u["depe_bf16"] - w["depe_bf16"]))
        assert abs(g["depe_bf16"] - w["depe_bf16"]) <= (
            SPREAD_FACTOR * spread + EPE_ATOL), (spread, g, w)
        for name in ("int8", "int8_mxu"):
            want_d, got_d = w[f"depe_{name}"], g[f"depe_{name}"]
            assert want_d != 0 and got_d != 0, (name, g, w)
            assert abs(got_d - want_d) <= (
                DEPE_FRACTION * abs(want_d) + EPE_ATOL), (name, g, w)


def _jax_gate(rows, tmp_path, monkeypatch, bands):
    """The gate JAX's tool writes for canned rows (its training,
    calibration and evaluation replaced)."""
    from raft_stereo_tpu import quant as jquant

    out = str(tmp_path / "jax_gate.json")
    monkeypatch.setattr(jax_quant_drift, "OUT", out)
    monkeypatch.setattr(jax_quant_drift, "SCALES_OUT",
                        str(tmp_path / "scales.json"))
    monkeypatch.setattr(drift_common, "evaluate_variants",
                        lambda *a, **k: rows)
    monkeypatch.setattr(jquant, "calibrate", lambda *a, **k: {
        "activations": {}, "corr_levels": [1.0, 1.0, 1.0, 1.0]})
    monkeypatch.setattr(jquant, "save_scales", lambda path, rec: path)
    jax_quant_drift.main(["--steps", "0", "--bands",
                          ",".join(str(int(c)) for c in bands.values())])
    return json.load(open(out))["gate"]


@pytest.mark.parametrize("depes", [(0.01, -0.04), (0.02, 0.07)])
def test_gate_matches_jax(depes, tmp_path, monkeypatch):
    bands = {"d<=48": 48.0, "d<=96": 96.0}
    rows = [{"band": b, "depe_int8": depes[0] * k,
             "depe_int8_mxu": depes[1] * k}
            for b in bands for k in (0.5, 1.0)]
    want = _jax_gate(rows, tmp_path, monkeypatch, bands)
    got = quant_drift.gate_of(rows, bands, 0.05)
    assert got == want
    assert got["pass"] == (max(map(abs, depes)) <= 0.05)


def test_quant_drift_cli_on_the_cpu(tmp_path):
    """The acceptance drive: rows in the JAX tool's schema, the gate, the
    record with its run block at the given path and the scale file beside
    it."""
    out = str(tmp_path / "rec.json")
    rec = quant_drift.run(quant_drift.build_parser().parse_args(
        ["--device", "cpu", "--steps", "0", "--hw", "64x160", "--bands",
         "24,48", "--iters", "2", "--out", out]))
    saved = json.load(open(out))
    assert saved["rows"] == rec["rows"] and saved["run"]["device_kind"] == "cpu"
    assert os.path.exists(tmp_path / quant_drift.DEFAULT_SCALES)
    keys = ["metric", "weights", "iters", "band"] + [
        f"epe_{n}" for n in ("fp32", "bf16", "int8", "int8_w", "int8_mxu")
    ] + [f"depe_{n}" for n in ("bf16", "int8", "int8_w", "int8_mxu")] + [
        "drift_mean_px", "drift_p99_px"]
    assert [list(r) for r in rec["rows"]] == [keys, keys]
    assert set(rec["gate"]) == {"band", "budget_px", "worst_abs_depe_px",
                                "per_mode", "pass"}
    assert rec["param_bytes"]["int8"] > 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            quant_drift.main(["--steps", "0", "--out", out])


def test_bf16_drift_trained_leg_on_the_cpu(tmp_path, monkeypatch):
    """The trained leg at a CPU size (its geometry constants shrunk)."""
    for name, value in (("HW", (64, 128)), ("BANDS", {"d<=24": 24.0}),
                        ("N_PER_BAND", 1), ("ITERS", (1,)),
                        ("TRAIN_STEPS", 1), ("TRAIN_HW", (32, 64)),
                        ("TRAIN_ITERS", 1), ("TRAIN_BATCH", 2)):
        monkeypatch.setattr(bf16_drift, name, value)
    out = str(tmp_path / "bf16.json")
    rec = bf16_drift.run(bf16_drift.build_parser().parse_args(
        ["--device", "cpu", "--out", out]))
    (row,) = rec["rows"]
    assert set(row) >= {"epe_bf16_alt", "epe_fp32corr_alt", "epe_fp32_reg",
                        "depe_bf16_alt", "drift_mean_px"}
    assert all(np.isfinite(v) for k, v in row.items()
               if k.startswith(("epe", "depe", "drift")))
    assert json.load(open(out))["run"]["torch_version"] == torch.__version__


@pytest.mark.parametrize("name", ["QUANT_DRIFT_r22.json", "BF16_DRIFT_r05.json",
                                  "STREAM_ci.json", "BENCH_r05.json"])
def test_records_never_take_a_pre_port_name(tmp_path, name):
    with pytest.raises(ValueError, match="JAX package record"):
        write_record(str(tmp_path / name), {}, device="cpu")
    assert not os.path.exists(tmp_path / name)
