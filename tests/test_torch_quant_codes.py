"""Where the ``int8_mxu`` codes of the port and JAX part (CPU).

Every quantized encoder conv's input is caught on both sides on one set
of weights (the drift harness's hermetic architecture, JAX's
``model.init`` with the norm leaves perturbed as in torch_port_support)
and one calibration record, at tests/test_torch_drift.py's 64x160 shape:
JAX's ``QuantConv`` sows it as ``qin``, the port's ``Conv2d`` hands it to
``quantized_conv_apply``.  The codes are ``round(x / scale)`` in fp32 on
both sides (the calibrated scale, or the dynamic per-tensor one of the
``context_zqr`` convs).

What it shows (readings in PERF.md section 6):

* JAX's ``jit`` (its ``InferenceRunner``'s route) parts from its own
  eager forward: XLA's fused frozen-BN and residual arithmetic moves an
  activation by an ulp, the first code flips within a few ulps of a
  half-code boundary (a rounding tie), and each int8 conv after it turns
  that flip into a whole code step, so the flips multiply through the
  cnet's deeper layers (~40-48k codes at 64x160).
* The port follows one of JAX's two routes up to such a tie: every
  conv's input agrees with JAX's eager forward within a few fp32 ulps
  until the first code that differs, and that code sits on a tie.  Which
  route the port follows past the tie depends on the CPU's fp32
  summation order: on one host the port's codes equal JAX eager's
  everywhere, on another (an AMD EPYC) they equal JAX jit's everywhere
  and part from eager's at cnet.trunk.layer2_1.conv1, one code at one
  ulp from its boundary, the very tie where JAX's own routes part.  So
  the flows are held to JAX's own route spread (eager vs jit) plus
  EPE_ATOL, and the per-conv flip counts against jit to JAX's own, up to
  the port's flips against eager.

So the ``int8_mxu`` dEPE gap between the port and JAX's jitted runner
(tests/test_torch_drift.py, DEPE_FRACTION) is JAX's jit-vs-eager spread,
not a fault of the port.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

from raft_stereo_tpu_torch.config import RaftStereoConfig
from raft_stereo_tpu_torch.eval import drift
from raft_stereo_tpu_torch.io.jax_weights import state_dict_from_jax
from raft_stereo_tpu_torch.models import extractor
from raft_stereo_tpu_torch.models.raft_stereo import RAFTStereo
from raft_stereo_tpu_torch.quant.calibrate import (calibrate,
                                                   conv_input_scales,
                                                   corr_scales)
from raft_stereo_tpu_torch.quant.core import quantize_state_dict
from torch_port_support import perturb

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
import early_exit_report  # noqa: E402  (the JAX package's tool)

HW = (64, 160)
ITERS = 2
EPE_ATOL = 2e-3
# the divergence's origin: |x/s - (k + 1/2)| within this many fp32 ulps
BOUNDARY_ULPS = 4


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _sown_inputs(intermediates):
    """``{port module name: NHWC fp32 input}`` from JAX's ``qin`` sows."""
    out = {}

    def walk(tree, path):
        for key, value in tree.items():
            if key == "qin":
                out[".".join(path)] = np.asarray(value[0], np.float32)
            elif isinstance(value, dict):
                walk(value, path + (key,))
    walk(intermediates, ())
    return out


def capture():
    """Each quantized conv's input from the port, JAX eager and JAX jit,
    in the port's call order, with the flows and the scene's truth."""
    import jax
    import jax.numpy as jnp

    from raft_stereo_tpu import quant as jquant
    from raft_stereo_tpu.models.raft_stereo import RAFTStereo as JaxModel

    jcfg = early_exit_report.model_config()
    variables = perturb(early_exit_report.init_variables(jcfg),
                        np.random.default_rng(0))
    cfg = RaftStereoConfig.from_json(jcfg.to_json())
    state = state_dict_from_jax(variables)
    record = calibrate(cfg, state, drift.calibration_pairs(
        (40, 112), 2, disp_scale=4.0), device="cpu")
    mxu = quantize_state_dict(state, act_scales=conv_input_scales(record))
    jmxu = jquant.quantize_variables(
        variables, act_scales=jquant.conv_input_scales(record))
    pcfg = dataclasses.replace(cfg, quant="int8_mxu",
                               quant_corr_scales=corr_scales(record))
    jmodel = JaxModel(dataclasses.replace(
        jcfg, quant="int8_mxu", quant_corr_scales=jquant.corr_scales(record)))
    left, right, disp = drift.make_band_scenes(
        *HW, {"d<=48": 48.0}, n_per_band=1)["d<=48"][0]
    l, r = left[None].astype(np.float32), right[None].astype(np.float32)

    def jax_apply(v, a, b):
        return jmodel.apply(v, a, b, iters=ITERS, test_mode=True,
                            mutable=["intermediates"])

    flows, inputs = {}, {}
    for route, fn in (("eager", jax_apply), ("jit", jax.jit(jax_apply))):
        out, inter = fn(jmxu, jnp.asarray(l), jnp.asarray(r))
        flows[route] = np.asarray(out[1], np.float32).squeeze()
        inputs[route] = _sown_inputs(jax.device_get(inter["intermediates"]))

    model = RAFTStereo(pcfg)
    model.load_state_dict(mxu, strict=True)
    model.eval()
    port = {}
    for name, module in model.named_modules():
        if isinstance(module, extractor.Conv2d) and module.quant == "int8_mxu":
            def hook(mod, args, name=name):
                port[name] = args[0].detach().permute(
                    0, 2, 3, 1).numpy().astype(np.float32)
            module.register_forward_pre_hook(hook)
    with torch.no_grad():
        flows["port"] = model(torch.from_numpy(l), torch.from_numpy(r),
                              iters=ITERS, test_mode=True)[1].numpy().squeeze()
    inputs["port"] = port
    scales = {k[:-len(".ascale")]: np.float32(v.item())
              for k, v in mxu.items() if k.endswith(".ascale")}
    return {"inputs": inputs, "flows": flows, "order": list(port),
            "scales": scales, "disp": disp}


@pytest.fixture(scope="module")
def captured():
    return capture()


def _scale(cap, name, x):
    """The conv's calibrated scale, else the dynamic max|x| / 127."""
    if name in cap["scales"]:
        return cap["scales"][name]
    return np.float32(np.maximum(np.abs(x).max(), np.float32(1e-12))
                      / np.float32(127.0))


def _codes(x, s):
    return np.clip(np.round(x / s), -127, 127).astype(np.int8)


def flips(cap, a, b):
    """``[(conv, codes that differ, max |x_a - x_b|, the flips' largest
    distance from their half-code boundary in fp32 ulps of x/s)]`` in the
    port's call order."""
    rows = []
    for name in cap["order"]:
        xa, xb = cap["inputs"][a][name], cap["inputs"][b][name]
        sa, sb = _scale(cap, name, xa), _scale(cap, name, xb)
        diff = _codes(xa, sa) != _codes(xb, sb)
        ulps = 0.0
        if diff.any():
            ra, rb = (xa / sa)[diff], (xb / sb)[diff]
            half = np.floor(np.minimum(ra, rb)) + np.float32(0.5)
            ulps = float(max(
                (np.abs(ra - half) / np.spacing(np.abs(ra))).max(),
                (np.abs(rb - half) / np.spacing(np.abs(rb))).max()))
        rows.append((name, int(diff.sum()), float(np.abs(xa - xb).max()),
                     ulps))
    return rows


def test_every_quantized_conv_is_caught_on_both_sides(captured):
    names = set(captured["order"])
    assert len(names) == 58
    for route in ("eager", "jit"):
        assert set(captured["inputs"][route]) == names
    # the three context_zqr convs quantize with the dynamic scale
    assert sorted(names - set(captured["scales"])) == [
        f"context_zqr_conv{i}" for i in range(3)]


def _first_tie(cap, rows, a):
    """Every conv's input within BOUNDARY_ULPS fp32 ulps until the first
    conv with a differing code, whose every flip sits within
    BOUNDARY_ULPS of a half-code boundary.  Returns that conv's index
    (None: no code differs)."""
    first = next((i for i, r in enumerate(rows) if r[1]), None)
    for name, n, dx, ulps in rows[:len(rows) if first is None
                                  else first + 1]:
        x = cap["inputs"][a][name]
        assert dx <= BOUNDARY_ULPS * np.spacing(np.abs(x).max()), (name, dx)
    if first is not None:
        assert rows[first][3] <= BOUNDARY_ULPS, rows[first]
    return first


def test_port_codes_equal_jax_eager_at_every_conv(captured):
    """Against JAX's eager forward every input agrees within a few ulps
    and every code is equal up to the first rounding tie, where the codes
    may part as JAX's own two routes part; the flows and EPE agree within
    EPE_ATOL plus JAX's own eager-vs-jit spread."""
    _first_tie(captured, flips(captured, "port", "eager"), "port")
    flows = captured["flows"]
    jax_spread = np.abs(flows["eager"] - flows["jit"]).max()
    assert (np.abs(flows["port"] - flows["eager"]).max()
            <= EPE_ATOL + jax_spread)
    epe = {k: float(np.mean(np.abs(f - captured["disp"])))
           for k, f in flows.items()}
    assert abs(epe["port"] - epe["eager"]) <= (
        EPE_ATOL + abs(epe["eager"] - epe["jit"])), epe


def test_jit_flips_start_on_a_boundary_and_match_jax_own(captured):
    """Against JAX's jitted forward the codes part: JAX's own first flip
    (eager vs jit) lies within BOUNDARY_ULPS of a half-code boundary, and
    so does the port's where it has one; every conv's flip count against
    jit is JAX's own eager-vs-jit count up to the port's flips against
    eager (a code differing from jit differs from eager or eager differs
    from jit there, and the other way round)."""
    port_jit = flips(captured, "port", "jit")
    eager_jit = flips(captured, "eager", "jit")
    port_eager = flips(captured, "port", "eager")
    assert [r[0] for r in port_jit] == [r[0] for r in eager_jit]
    for pj, ej, pe in zip(port_jit, eager_jit, port_eager):
        assert abs(pj[1] - ej[1]) <= pe[1], (pj, ej, pe)
    assert _first_tie(captured, eager_jit, "eager") is not None
    _first_tie(captured, port_jit, "port")


if __name__ == "__main__":
    # the per-conv flip counts:
    # JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_quant_codes.py
    torch.set_num_threads(2)
    cap = capture()
    for a, b in (("port", "eager"), ("port", "jit"), ("eager", "jit")):
        rows = flips(cap, a, b)
        print(f"== {a} vs {b}: {sum(r[1] for r in rows)} codes differ")
        for name, n, dx, ulps in rows:
            if n or dx:
                print(f"{name:36s} {n:6d} of {cap['inputs'][a][name].size:8d}"
                      f"  max|dx| {dx:.3g}  boundary ulps {ulps:.3g}")
    epe = {k: float(np.mean(np.abs(f - cap["disp"])))
           for k, f in cap["flows"].items()}
    print("EPE", epe)
