"""The port's realtime preset against the JAX package (CPU).

``RaftStereoConfig.realtime()``: shared backbone, 2 GRU levels at 1/8
resolution on the slow-fast schedule, ``alt`` correlation, bf16.  The
seeded weights are a Flax init at TINY widths (hidden 32, fnet 64; the
shared backbone's feature head stays 128 wide), norm leaves perturbed,
carried by ``state_dict_from_jax``; inputs are seeded images.

Two whole-model checks:
* the realtime ARCHITECTURE in fp32 (``mixed_precision=False``) against
  the JAX model's plain path at iters=2, held to the 2e-3 px of the
  default-config test: it isolates wiring (the slow-fast calls,
  ``dual_inp``, ``conv2_res``/``conv2_out``) from bf16 noise;
* the PRESET in bf16 against the JAX model's kernel path (Pallas in
  interpret mode: the alt lookup and the gates in bf16, the functions the
  port's plain versions compute), with a tolerance set from the JAX
  package's own spread (see ``test_realtime_bf16_matches_jax``).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from raft_stereo_tpu.config import RaftStereoConfig as JaxConfig
from raft_stereo_tpu.kernels import corr_lookup as jcorr_lookup
from raft_stereo_tpu.models.corr import make_corr_fn as jax_make_corr_fn
from raft_stereo_tpu.models.raft_stereo import RAFTStereo as JaxRAFTStereo
from raft_stereo_tpu_torch.cli import demo
from raft_stereo_tpu_torch.config import RaftStereoConfig
from raft_stereo_tpu_torch.eval.runner import InferenceRunner
from raft_stereo_tpu_torch.io.jax_weights import (save_checkpoint,
                                                  state_dict_from_jax)
from raft_stereo_tpu_torch.models.corr import make_corr_fn
from raft_stereo_tpu_torch.models.extractor import Conv2d
from raft_stereo_tpu_torch.models.raft_stereo import RAFTStereo
from torch_port_support import assert_bf16_close, perturb

FLOW_ATOL = 2e-3
TINY = dict(hidden_dims=(32, 32, 32), fnet_dim=64)
HW = (64, 96)
# The bf16 tolerance: this multiple of the JAX package's own spread.
SPREAD_FACTOR = 3.0


def _realtime(**kw):
    return JaxConfig(**{**dataclasses.asdict(JaxConfig.realtime()), **TINY,
                        **kw})


@pytest.fixture(scope="module")
def variables():
    """numpy variables of the TINY realtime tree (Flax init, seed 0)."""
    jmodel = JaxRAFTStereo(_realtime(mixed_precision=False))
    dummy = jnp.zeros((1,) + HW + (3,), jnp.float32)
    init = jax.jit(lambda key: jmodel.init(key, dummy, dummy, iters=1,
                                           test_mode=True))
    return perturb(init(jax.random.PRNGKey(0)), np.random.default_rng(7))


def _port(jcfg, variables):
    model = RAFTStereo(RaftStereoConfig.from_dict(
        dataclasses.asdict(jcfg))).eval()
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    return model


def _images(seed=3, hw=HW):
    rs = np.random.default_rng(seed)
    left = rs.integers(0, 256, hw + (3,), dtype=np.uint8)
    return left, np.roll(left, -3, axis=1)


def _jax_flow(jcfg, variables, left, right, iters, kernels=False):
    jcorr_lookup._interpret_override = True if kernels else None
    try:
        low, up = JaxRAFTStereo(jcfg).apply(
            variables, jnp.asarray(left[None], jnp.float32),
            jnp.asarray(right[None], jnp.float32), iters=iters,
            test_mode=True)
    finally:
        jcorr_lookup._interpret_override = None
    return np.asarray(low), np.asarray(up)


def _port_flow(model, left, right, iters):
    with torch.no_grad():
        low, up = model(torch.from_numpy(left[None]),
                        torch.from_numpy(right[None]), iters=iters)
    return low.numpy(), up.numpy()


def test_realtime_preset_matches_jax():
    assert (RaftStereoConfig.realtime().to_dict()
            == dataclasses.asdict(JaxConfig.realtime()))


def test_alt_with_w2_shards_is_invalid():
    with pytest.raises(ValueError, match="incompatible"):
        RaftStereoConfig(corr_backend="alt", corr_w2_shards=2)


def test_weight_bridge_uses_every_realtime_leaf_once(variables):
    leaves = {}
    for col in ("params", "batch_stats"):
        for path, leaf in jax.tree_util.tree_flatten_with_path(
                variables[col])[0]:
            leaves[tuple(p.key for p in path)] = leaf
    state = state_dict_from_jax(variables)
    port = _port(_realtime(), variables).state_dict()
    assert len(state) == len(leaves) == len(port)
    assert any(k.startswith("conv2_res.") for k in port)
    assert {"conv2_out.weight", "conv2_out.bias"} <= set(port)
    assert not any(k.startswith("fnet.") for k in port)
    for path, leaf in leaves.items():
        name = "weight" if path[-1] == "kernel" else path[-1]
        want = leaf.transpose(3, 2, 0, 1) if path[-1] == "kernel" else leaf
        np.testing.assert_array_equal(
            port[".".join(path[:-1] + (name,))].numpy(), want)


def test_realtime_architecture_fp32_matches_jax(variables):
    """Measured 5.2e-4 px at 1/8 resolution and 1.14e-3 px at full
    resolution, on flows of up to 93 px."""
    jcfg = _realtime(mixed_precision=False)
    left, right = _images()
    want_low, want_up = _jax_flow(jcfg, variables, left, right, iters=2)
    low, up = _port_flow(_port(jcfg, variables), left, right, iters=2)
    assert up.shape == (1,) + HW and low.shape == (1, 8, 12)
    np.testing.assert_allclose(low, want_low, atol=FLOW_ATOL, rtol=0)
    np.testing.assert_allclose(up, want_up, atol=FLOW_ATOL, rtol=0)


@pytest.mark.parametrize("iters", [1, 2])
def test_realtime_bf16_matches_jax(variables, iters):
    """The bf16 preset against the JAX kernel path.

    bf16 noise on random weights is large: the JAX package's own two paths
    (kernel path: bf16 alt lookup and bf16 gates; plain path: the fp32 XLA
    alt fallback and the Flax gate convs) differ on these inputs, on flows
    of up to 50 px (iters=1) and 93 px (iters=2), by max / mean |Δflow|
    1.029 / 0.241 px at iters=1 and 14.25 / 2.074 px at iters=2.  Against
    the kernel path the port measured 1.239 / 0.294 px and 9.715 / 2.084
    px.  The tolerance is 3x the JAX spread, measured in the test itself,
    on both the max and the mean.  It catches a broken path (a missing
    cast, a wrong tap or level), not a single misplaced rounding, which is
    what the module tests pin at one bf16 ulp."""
    jcfg = _realtime()
    left, right = _images()
    _, plain = _jax_flow(jcfg, variables, left, right, iters)
    _, kernel = _jax_flow(jcfg, variables, left, right, iters, kernels=True)
    _, port = _port_flow(_port(jcfg, variables), left, right, iters)
    assert port.dtype == np.float32 and np.isfinite(port).all()
    spread = np.abs(kernel - plain)
    err = np.abs(port - kernel)
    assert err.max() <= SPREAD_FACTOR * spread.max(), (err.max(),
                                                        spread.max())
    assert err.mean() <= SPREAD_FACTOR * spread.mean(), (err.mean(),
                                                         spread.mean())


def _features(rng, b=1, d=32, h=3, w=20):
    f = [torch.from_numpy(rng.normal(size=(b, d, h, w)).astype(np.float32))
         .bfloat16() for _ in range(2)]
    coords = torch.from_numpy(
        rng.uniform(-6, w + 6, size=(b, h, w)).astype(np.float32))
    return f[0], f[1], coords


@pytest.mark.parametrize("backend", ["reg", "alt", "reg_fused"])
def test_corr_fp32_runs_fp32_correlation(rng, backend):
    """``corr_fp32`` upcasts bf16 features before any backend: every
    backend gives fp32 ``reg`` on the bf16-rounded features (the JAX
    package's check, tests/test_corr.py)."""
    f1, f2, coords = _features(rng)
    want = make_corr_fn(RaftStereoConfig(corr_backend="reg"), f1.float(),
                        f2.float())(coords)
    got = make_corr_fn(RaftStereoConfig(corr_backend=backend,
                                        mixed_precision=True,
                                        corr_fp32=True), f1, f2)(coords)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("backend", ["reg", "alt", "reg_fused"])
def test_bf16_correlation_matches_jax(rng, backend):
    """Each backend's mixed-precision correlation against the JAX
    package's kernel path (interpret mode): ``reg`` in fp32 throughout,
    ``reg_fused`` an fp32 volume stored and pooled in bf16 with a bf16
    lookup, ``alt`` bf16 features pooled in bf16 with a bf16 lookup."""
    f1, f2, coords = _features(rng)
    jf = [jnp.asarray(f.float().numpy().transpose(0, 2, 3, 1)).astype(
        jnp.bfloat16) for f in (f1, f2)]
    jcorr_lookup._interpret_override = True
    try:
        want = jax_make_corr_fn(
            JaxConfig(corr_backend=backend, mixed_precision=True),
            *jf)(jnp.asarray(coords.numpy()))
    finally:
        jcorr_lookup._interpret_override = None
    got = make_corr_fn(RaftStereoConfig(corr_backend=backend,
                                        mixed_precision=True), f1, f2)(coords)
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    want = np.asarray(want.astype(jnp.float32))
    if backend == "reg":
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    else:
        assert_bf16_close(got.float().numpy(), want)


def test_runner_runs_its_effective_config_for_a_model(variables):
    """A model passed to the runner at iters >= 16 under bf16 runs fp32
    correlation, as the JAX runner does (it always builds its program
    from ``effective_config``); the caller's model is left as it was."""
    cfg = RaftStereoConfig.from_dict(dataclasses.asdict(_realtime()))
    model = _port(_realtime(), variables)
    state = {k: v.clone() for k, v in model.state_dict().items()}
    left, right = _images(5)
    runner = InferenceRunner(cfg, model, iters=16, device="cpu")
    assert runner.config == cfg and not cfg.corr_fp32
    assert runner.effective_config.corr_fp32
    assert runner.model.config.corr_fp32
    fp32_corr = InferenceRunner(dataclasses.replace(cfg, corr_fp32=True),
                                state, iters=16, device="cpu",
                                corr_fp32_auto=False)
    bf16_corr = InferenceRunner(cfg, state, iters=16, device="cpu",
                                corr_fp32_auto=False)
    assert not bf16_corr.model.config.corr_fp32
    flow = runner(left, right)[0]
    np.testing.assert_array_equal(flow, fp32_corr(left, right)[0])
    assert not np.array_equal(flow, bf16_corr(left, right)[0])
    for k, v in model.state_dict().items():
        assert v.dtype == torch.float32
        torch.testing.assert_close(v, state[k], rtol=0, atol=0)


def test_runner_casts_conv_weights_once(variables):
    cfg = RaftStereoConfig.from_dict(dataclasses.asdict(_realtime()))
    runner = InferenceRunner(cfg, state_dict_from_jax(variables), iters=2,
                             device="cpu")
    model = runner.model
    gates = {model.update_block.gru08.convzr.bias,
             model.update_block.gru08.convq.bias,
             model.update_block.gru16.convzr.bias,
             model.update_block.gru16.convq.bias}
    convs = [m for m in model.modules() if isinstance(m, Conv2d)]
    assert len(convs) > 40
    for m in convs:
        assert m.weight.dtype == torch.bfloat16
        assert m.bias.dtype == (torch.float32 if m.bias in gates
                                else torch.bfloat16)
    assert model.cnet.trunk.norm1.scale.dtype == torch.float32


def test_realtime_checkpoint_and_demo_cli(tmp_path, variables):
    cfg = RaftStereoConfig.from_dict(dataclasses.asdict(_realtime()))
    state = state_dict_from_jax(variables)
    ckpt = str(tmp_path / "ckpt")
    save_checkpoint(ckpt, cfg, state)
    left, right = _images(9, (40, 60))
    Image.fromarray(left).save(tmp_path / "im0.png")
    Image.fromarray(right).save(tmp_path / "im1.png")
    out = tmp_path / "out"
    demo.main(["--restore_ckpt", ckpt, "-l", str(tmp_path / "im0.png"),
               "-r", str(tmp_path / "im1.png"), "--output_directory",
               str(out), "--valid_iters", "2", "--save_numpy",
               "--device", "cpu"])
    assert os.path.exists(out / "im0-disparity.png")
    want = InferenceRunner(cfg, state, iters=2, device="cpu").disparity(
        left, right)
    np.testing.assert_array_equal(np.load(out / "im0.npy"), want)
