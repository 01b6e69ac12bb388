"""The port's cost layer on the CPU: the FLOP formulas
(telemetry/flops.py) against ``torch.utils.flop_counter.FlopCounterMode``
on the plain forward and the plain training step, exactly, at TINY
widths of every preset with every corr_backend, the quantized tiers and
the options that change the architecture's convs; the runner's
``CompileRegistry`` records (one per capture key, evictions, the degraded
CPU record); ``MfuMeter`` and the roofline helpers against the JAX
package's; the peak table's H100 entry.

XLA's own FLOP count at the same shapes is not held here: it also counts
elementwise operations (tests/torch_costs_vs_xla.py prints both, PERF.md
section 6 quotes them).
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from raft_stereo_tpu.telemetry import costs as jcosts
from raft_stereo_tpu_torch.config import RaftStereoConfig
from raft_stereo_tpu_torch.eval.runner import InferenceRunner
from raft_stereo_tpu_torch.models.raft_stereo import RAFTStereo
from raft_stereo_tpu_torch.telemetry import MetricsRegistry
from raft_stereo_tpu_torch.telemetry import costs
from raft_stereo_tpu_torch.telemetry.flops import (forward_flops,
                                                   train_step_flops)

TINY = dict(hidden_dims=(32, 32, 32), fnet_dim=64)
CONFIGS = {
    "default": RaftStereoConfig(**TINY),
    "realtime": dataclasses.replace(RaftStereoConfig.realtime(), **TINY),
    "default_unfused": RaftStereoConfig(fused_gru="off", **TINY),
    "no_lookup_saved": RaftStereoConfig(remat_save=(), **TINY),
    # every preset with every corr_backend (the presets' own: reg_fused
    # and alt)
    "default_reg": RaftStereoConfig(corr_backend="reg", **TINY),
    "default_alt": RaftStereoConfig(corr_backend="alt", **TINY),
    "realtime_reg": dataclasses.replace(RaftStereoConfig.realtime(),
                                        corr_backend="reg", **TINY),
    "realtime_reg_fused": dataclasses.replace(
        RaftStereoConfig.realtime(), corr_backend="reg_fused", **TINY),
    # the quantized tiers (inference only) and the structural options
    "int8": RaftStereoConfig(quant="int8", **TINY),
    "int8_mxu": RaftStereoConfig(quant="int8_mxu", **TINY),
    "one_level": RaftStereoConfig(n_gru_layers=1, **TINY),
    "slow_fast_3_levels": RaftStereoConfig(slow_fast_gru=True, **TINY),
    "downsample_1": RaftStereoConfig(n_downsample=1, **TINY),
    "no_remat": RaftStereoConfig(remat_gru=False, **TINY),
}
H100 = "NVIDIA H100 80GB HBM3"


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _pair(batch, hw, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.rand(batch, *hw, 3, generator=g) * 255,
            torch.rand(batch, *hw, 3, generator=g) * 255)


@pytest.mark.parametrize("name,hw,batch,iters", [
    ("default", (64, 96), 2, 2), ("realtime", (64, 96), 2, 3),
    ("default", (96, 64), 1, 1), ("default_unfused", (64, 64), 1, 2),
    ("default_reg", (64, 96), 1, 2), ("default_alt", (64, 96), 1, 2),
    ("realtime_reg", (64, 96), 1, 2), ("realtime_reg_fused", (64, 96), 1, 2),
    ("int8", (64, 96), 1, 2), ("int8_mxu", (64, 96), 1, 2),
    ("one_level", (64, 96), 1, 2), ("slow_fast_3_levels", (64, 96), 1, 2),
    ("downsample_1", (32, 64), 1, 2)])
def test_forward_flops_equal_the_flop_counter(name, hw, batch, iters):
    cfg = CONFIGS[name]
    torch.manual_seed(0)
    model = RAFTStereo(cfg).eval()
    counter = FlopCounterMode(display=False)
    with torch.no_grad(), counter:
        model(*_pair(batch, hw), iters=iters, test_mode=True)
    assert counter.get_total_flops() == forward_flops(cfg, hw, batch, iters)


@pytest.mark.parametrize("name", ["default", "default_alt", "one_level",
                                  "downsample_1"])
def test_forward_flops_of_a_reused_context_equal_the_flop_counter(name):
    """A forward that takes a saved context bundle (``ctx_init``, the
    serving engine's warm_ctx programs) runs no cnet and no context convs:
    ``context=False`` counts what FlopCounterMode counts."""
    cfg = CONFIGS[name]
    torch.manual_seed(0)
    model = RAFTStereo(cfg).eval()
    hw = (32, 64) if name == "downsample_1" else (64, 96)
    pair = _pair(1, hw)
    with torch.no_grad():
        bundle = model(*pair, iters=1, test_mode=True, return_ctx=True)[-1]
    counter = FlopCounterMode(display=False)
    with torch.no_grad(), counter:
        model(*pair, iters=2, test_mode=True, ctx_init=bundle)
    got = forward_flops(cfg, hw, 1, 2, context=False)
    assert counter.get_total_flops() == got < forward_flops(cfg, hw, 1, 2)


@pytest.mark.parametrize("name", ["default", "realtime", "default_unfused",
                                  "no_lookup_saved", "default_reg",
                                  "default_alt", "realtime_reg",
                                  "realtime_reg_fused", "one_level",
                                  "slow_fast_3_levels", "downsample_1",
                                  "no_remat"])
def test_train_step_flops_equal_the_flop_counter(name):
    cfg, batch, iters = CONFIGS[name], 2, 2
    hw = (32, 64) if name == "downsample_1" else (64, 96)
    torch.manual_seed(0)
    model = RAFTStereo(cfg).train()
    counter = FlopCounterMode(display=False)
    with counter:
        model(*_pair(batch, hw), iters=iters,
              test_mode=False).float().sum().backward()
    assert counter.get_total_flops() == train_step_flops(cfg, hw, batch,
                                                         iters)


# --------------------------------------------------------- the registry
@pytest.fixture(scope="module")
def runner_records():
    cfg = CONFIGS["default"]
    reg = MetricsRegistry()
    registry = costs.CompileRegistry(registry=reg)
    torch.manual_seed(0)
    runner = InferenceRunner(cfg, RAFTStereo(cfg).state_dict(), iters=1,
                             device="cpu", max_cached_shapes=2,
                             cost_registry=registry)
    rng = np.random.default_rng(0)
    for hw in ((32, 64), (64, 64), (32, 64), (64, 96), (32, 64)):
        img = rng.uniform(0, 255, (*hw, 3)).astype(np.float32)
        runner(img, img)
    return cfg, runner, registry, reg


def test_one_record_per_program_with_evictions(runner_records):
    cfg, runner, registry, reg = runner_records
    keys = [r.key for r in registry.records()]
    # 32x64, 64x64, (32x64 hit), 64x96 evicts 64x64, 32x64 hit
    assert keys == ["eval.forward(32x64,b1)", "eval.forward(64x64,b1)",
                    "eval.forward(64x96,b1)"]
    assert registry.compiles.value == 3
    assert registry.runner_evictions.value == 1
    assert registry.runner_cache_size.value == 2
    assert "runner_compile_evictions_total 1" in reg.render_text()
    for rec in registry.records():
        h, w = map(int, rec.key.split("(")[1].split(",")[0].split("x"))
        assert rec.flops == forward_flops(cfg, (h, w), 1, 1)
        assert rec.site == "eval" and rec.compile_s > 0
    assert runner.compiled_cost((32, 64)).key == "eval.forward(32x64,b1)"
    assert runner.compiled_cost((128, 128)) is None


def test_a_cpu_record_is_degraded(runner_records):
    _, _, registry, _ = runner_records
    rec = registry.get("eval.forward(32x64,b1)")
    assert rec.degraded and rec.memory is None and rec.hbm_bytes is None
    assert rec.device == "cpu"
    full = costs.CompileRegistry().record(
        "k", "bench", 0.5, flops=1e9,
        memory={"bytes_in_use_before": 10, "peak_bytes_in_use": 110})
    assert not full.degraded and full.hbm_bytes == 100


def test_instrument_records_the_first_call_only():
    registry = costs.CompileRegistry(registry=MetricsRegistry())
    calls = []
    fn = registry.instrument(lambda x: calls.append(x) or x * 2,
                             key="train.step", site="train", flops=7.0,
                             device="cpu")
    assert [fn(i) for i in range(3)] == [0, 2, 4] and calls == [0, 1, 2]
    (rec,) = registry.records()
    assert rec.key == "train.step" and rec.flops == 7.0
    assert registry.compiles.value == 1


def test_debug_compiles_payload_keeps_the_jax_schema():
    got = costs.CompileRegistry(device_peak_tflops=10.0)
    got.record("a", "eval", 1.0, flops=2.0)
    want = jcosts.CompileRegistry(device_peak_tflops=10.0)
    want.record("a", "eval", 1.0)
    g, w = got.to_json(), want.to_json()
    assert set(g) == set(w)
    assert set(g["executables"][0]) == set(w["executables"][0]) - {
        "donated_alias_bytes"}
    assert g["peak_flops_per_s"] == w["peak_flops_per_s"] == 10e12


# ------------------------------------------------------ MFU and roofline
def test_mfu_meter_matches_jax():
    out = []
    for mod in (jcosts, costs):
        reg = MetricsRegistry()
        gauge, achieved = reg.gauge("mfu"), reg.gauge("flops_per_s")
        meter = mod.MfuMeter(gauge, 1e12, achieved_gauge=achieved,
                             window_s=10.0)
        seen = []
        for i, t in enumerate((0.0, 1.0, 2.5, 4.0, 15.0, 15.5)):
            meter.note(1e11 * (i + 1), now=t)
            seen.append((gauge.value, achieved.value))
        out.append(seen)
    assert out[0] == out[1]
    assert out[1][1] == (0.3, 3e11)     # 1e11 + 2e11 over 1 s


def test_peak_table_and_ridge_for_the_h100():
    assert costs.peak_flops_for(H100) == 989e12
    assert costs.peak_bytes_per_s_for(H100) == 3350e9
    ridge, source = costs.ridge_flops_per_byte(
        costs.peak_flops_for(H100), costs.peak_bytes_per_s_for(H100))
    assert source == "device" and ridge == pytest.approx(295.22, abs=0.01)
    assert costs.peak_flops_for("TPU v5 lite") is None
    assert costs.peak_flops_for("cpu") is None
    assert costs.ridge_flops_per_byte(None, None) == (
        costs.DEFAULT_RIDGE_FLOPS_PER_BYTE, "default")
    assert costs.DEFAULT_RIDGE_FLOPS_PER_BYTE == pytest.approx(295.22,
                                                               abs=0.01)
    assert costs.peak_flops_for(H100, override_tflops=500) == 500e12
    assert costs.peak_flops_for(H100, dtype="fp32") == 67e12
    assert all(not k.startswith("tpu") for k in costs.DEVICE_PEAK_TFLOPS)
    assert all(not k.startswith("tpu")
               for k in costs.DEVICE_PEAK_FP32_TFLOPS)


@pytest.mark.parametrize("flags,tflops", [((), 67.0),
                                          (("--mixed_precision",), 989.0)])
def test_the_cli_registry_takes_its_compute_dtypes_peak(monkeypatch,
                                                        tmp_path, flags,
                                                        tflops):
    """MFU's denominator is the card's peak for the program's dtype: the
    fp32 default against fp32 outside the tensor cores, bf16 against the
    tensor cores."""
    from raft_stereo_tpu_torch.cli import train as tcli
    monkeypatch.setattr(costs, "_local_device_kind", lambda: H100)
    args = tcli.build_parser().parse_args(
        ["--event_log", str(tmp_path / "events.jsonl"), "--log_dir",
         str(tmp_path), "--device", "cpu", *flags])
    tel, _, events = tcli.build_telemetry(args, *tcli.configs_from_args(args))
    try:
        assert tel.costs.peak_flops == tflops * 1e12
    finally:
        events.close()


@pytest.mark.parametrize("flops,nbytes", [(1e12, 1e9), (1e9, 1e9),
                                          (None, 1e9), (1e9, 0)])
def test_classify_bound_matches_jax(flops, nbytes):
    for ridge in (240.0, 295.2):
        assert (costs.classify_bound(flops, nbytes, ridge)
                == jcosts.classify_bound(flops, nbytes, ridge))
