"""The port's whole slice against the JAX package (CPU).

``RAFTStereo.forward(test_mode=True)`` of the port and the JAX
``model.apply(..., test_mode=True)`` run on the same seeded weights
(Flax init under ``jax.jit``, norm leaves perturbed, carried by
``state_dict_from_jax``) and the same seeded images.  On the CPU both
sides run their plain paths: the JAX package's own tests hold those equal
to its Pallas kernels, and tests/test_torch_kernels.py holds the port's
kernel modules to the same.

Tolerance of the whole forward (FLOW_ATOL): the JAX package's two loops of
one model, ``lax.scan`` and the unrolled loop, already differ by 8.4e-5
(TINY) and 1.5e-4 (default widths) px at iters=2 on these inputs, and
random weights amplify rounding about 5x per iteration.  Against the scan
the port measured 3.7e-4 (TINY) and 6.7e-4 (default) px on
full-resolution flows of up to 53 and 71 px, and 3.6e-4 and 5.3e-4 px at
1/4 resolution.  The tolerance is 2e-3 px: about 3x the port's largest
measured gap, and a systematic error (a wrong tap, sign or scale) moves
the flow by whole pixels.
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
from raft_stereo_tpu.models.raft_stereo import RAFTStereo as JaxRAFTStereo
from raft_stereo_tpu.models.raft_stereo import (
    sequential_fnet_threshold as jax_sequential_fnet_threshold)
from raft_stereo_tpu.ops.padding import InputPadder as JaxPadder
from raft_stereo_tpu_torch.cli import demo
from raft_stereo_tpu_torch.config import RaftStereoConfig
from raft_stereo_tpu_torch.eval.runner import InferenceRunner
from raft_stereo_tpu_torch.io.jax_weights import (load_checkpoint,
                                                  save_checkpoint,
                                                  state_dict_from_jax)
from raft_stereo_tpu_torch.models.raft_stereo import (
    RAFTStereo, sequential_fnet_threshold)
from torch_port_support import perturb

FLOW_ATOL = 2e-3
ITERS = 2
TINY = dict(hidden_dims=(32, 32, 32), fnet_dim=64)
CONFIGS = {"tiny": TINY, "default": {}}


@pytest.fixture(scope="module")
def models():
    """name -> (JAX model, numpy variables, port model), built once."""
    cache = {}

    def get(name):
        if name not in cache:
            kw = CONFIGS[name]
            jmodel = JaxRAFTStereo(JaxConfig(**kw))
            dummy = jnp.zeros((1, 64, 96, 3), jnp.float32)
            init = jax.jit(lambda key: jmodel.init(key, dummy, dummy,
                                                   iters=1, test_mode=True))
            variables = perturb(init(jax.random.PRNGKey(0)),
                                np.random.default_rng(7))
            tmodel = RAFTStereo(RaftStereoConfig(**kw)).eval()
            tmodel.load_state_dict(state_dict_from_jax(variables),
                                   strict=True)
            cache[name] = jmodel, variables, tmodel
        return cache[name]
    return get


def _images(seed, hw):
    rs = np.random.default_rng(seed)
    left = rs.integers(0, 256, hw + (3,), dtype=np.uint8)
    return left, np.roll(left, -3, axis=1)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_weight_bridge_uses_every_leaf_once(models, name):
    _, variables, tmodel = models(name)
    leaves = {}
    for col in ("params", "batch_stats"):
        for path, leaf in jax.tree_util.tree_flatten_with_path(
                variables[col])[0]:
            leaves[(col,) + tuple(p.key for p in path)] = leaf
    state = state_dict_from_jax(variables)
    assert len(state) == len(leaves) == len(tmodel.state_dict())
    port = tmodel.state_dict()
    for (col, *path), leaf in leaves.items():
        name = "weight" if path[-1] == "kernel" else path[-1]
        got = port[".".join(path[:-1] + [name])].numpy()
        want = leaf.transpose(3, 2, 0, 1) if path[-1] == "kernel" else leaf
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_forward_matches_jax(models, name):
    jmodel, variables, tmodel = models(name)
    left, right = _images(3, (64, 96))
    want_low, want_up = jmodel.apply(
        variables, jnp.asarray(left[None], jnp.float32),
        jnp.asarray(right[None], jnp.float32), iters=ITERS, test_mode=True)
    with torch.no_grad():
        low, up = tmodel(torch.from_numpy(left[None]),
                         torch.from_numpy(right[None]), iters=ITERS)
    assert up.shape == (1, 64, 96) and low.shape == (1, 16, 24)
    np.testing.assert_allclose(low.numpy(), np.asarray(want_low),
                               atol=FLOW_ATOL, rtol=0)
    np.testing.assert_allclose(up.numpy(), np.asarray(want_up),
                               atol=FLOW_ATOL, rtol=0)


def test_runner_pads_and_unpads_like_jax(models):
    """An odd-size pair through ``InferenceRunner(device="cpu")`` against
    the JAX model on the JAX padder's padded input, unpadded."""
    jmodel, variables, tmodel = models("tiny")
    left, right = _images(5, (45, 70))
    padder = JaxPadder((1, 45, 70, 3), divis_by=32)
    p1, p2 = padder.pad(jnp.asarray(left[None], jnp.float32),
                        jnp.asarray(right[None], jnp.float32))
    _, want_up = jmodel.apply(variables, p1, p2, iters=ITERS, test_mode=True)
    want = np.asarray(padder.unpad(want_up))[0]
    runner = InferenceRunner(tmodel.config, tmodel, iters=ITERS,
                             device="cpu")
    flow, seconds = runner(left, right)
    assert flow.shape == (45, 70) and flow.dtype == np.float32
    assert seconds > 0
    np.testing.assert_allclose(flow, want, atol=FLOW_ATOL, rtol=0)
    np.testing.assert_array_equal(runner.disparity(left, right), -flow)


def test_runner_without_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the host without a CUDA device")
    cfg = RaftStereoConfig(**TINY)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceRunner(cfg, RAFTStereo(cfg).state_dict())


def test_config_fields_match_jax():
    jfields = {f.name for f in dataclasses.fields(JaxConfig)}
    assert {f.name for f in dataclasses.fields(RaftStereoConfig)} == jfields
    jcfg = JaxConfig(**TINY, corr_backend="reg_cuda")
    cfg = RaftStereoConfig.from_json(jcfg.to_json())
    assert cfg.to_dict() == dataclasses.asdict(jcfg)


@pytest.mark.parametrize("field,value", [
    ("rows_gru", True), ("banded_encoder", True), ("rows_shards", 2),
    ("corr_w2_shards", 2), ("remat_save", ("gru_gates",))])
def test_unported_options_raise(field, value):
    """Every option once refused is ported now: ``remat_save``
    (models/remat.py), ``banded_encoder`` (models/banded.py) and the
    context-parallel ``rows_shards``, ``rows_gru`` and ``corr_w2_shards``
    (parallel/).  Each constructs and round-trips with the JAX package's
    ``to_dict()``, or, where JAX refuses the setting alone (``rows_gru``
    without ``rows_shards``), raises JAX's ValueError."""
    try:
        want = JaxConfig(**{field: value}).to_dict()
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            RaftStereoConfig(**{field: value})
        assert str(got.value) == str(e)
        return
    cfg = RaftStereoConfig(**{field: value})
    assert cfg.to_dict() == want
    assert RaftStereoConfig.from_json(cfg.to_json()) == cfg


@pytest.mark.parametrize("pixels", [None, 1])
def test_sequential_fnet_route(pixels):
    """fnet runs one image at a time from ``sequential_fnet_threshold``
    (the JAX model's gate: ``sequential_fnet_pixels``, else 0.10 x memory /
    1180 B per pixel, 16 GiB off the card), and in fp32 both routes give
    the same features (instance norm is per image)."""
    cfg = RaftStereoConfig(**TINY, sequential_fnet_pixels=pixels)
    assert sequential_fnet_threshold(cfg, torch.device("cpu")) == (
        1455921 if pixels is None else pixels)
    jcfg = JaxConfig(**TINY, sequential_fnet_pixels=pixels)
    assert sequential_fnet_threshold(cfg, torch.device("cpu")) == (
        jax_sequential_fnet_threshold(jcfg))
    torch.manual_seed(0)
    model = RAFTStereo(cfg).eval()
    calls = []
    model.fnet.register_forward_hook(lambda m, i, o: calls.append(o))
    rs = np.random.default_rng(0)
    img = torch.from_numpy(rs.integers(0, 256, (2, 32, 32, 3)).astype(
        np.float32))
    with torch.no_grad():
        model(img[:1], img[1:], iters=1)
    assert len(calls) == (1 if pixels is None else 2)
    if pixels is not None:
        per_image = torch.cat(calls)
        x = (2 * (img / 255.0) - 1.0).permute(0, 3, 1, 2)
        with torch.no_grad():
            both = model.fnet(x)
        torch.testing.assert_close(per_image, both, rtol=0, atol=1e-5)


def test_unported_forward_modes_raise():
    """Confidence and state carry are ported (tests/test_torch_early_exit.py);
    in train mode they raise the JAX model's ValueError."""
    cfg = RaftStereoConfig(**TINY)
    model = RAFTStereo(cfg)
    img = torch.zeros((1, 32, 32, 3))
    for kwargs in ({"return_confidence": True}, {"return_hidden": True},
                   {"ctx_init": ()}):
        with pytest.raises(ValueError, match="test-mode only"):
            model(img, img, iters=1, test_mode=False, **kwargs)


def test_checkpoint_and_demo_cli(tmp_path):
    cfg = RaftStereoConfig(**TINY)
    torch.manual_seed(0)
    model = RAFTStereo(cfg)
    ckpt = str(tmp_path / "ckpt")
    save_checkpoint(ckpt, cfg, model.state_dict())
    cfg2, state = load_checkpoint(ckpt)
    assert cfg2 == cfg
    for k, v in model.state_dict().items():
        torch.testing.assert_close(state[k], v, rtol=0, atol=0)
    left, right = _images(9, (40, 60))
    Image.fromarray(left).save(tmp_path / "im0.png")
    Image.fromarray(right).save(tmp_path / "im1.png")
    out = tmp_path / "out"
    demo.main(["--restore_ckpt", ckpt, "-l", str(tmp_path / "im0.png"),
               "-r", str(tmp_path / "im1.png"), "--output_directory",
               str(out), "--valid_iters", "1", "--save_numpy",
               "--device", "cpu"])
    assert os.path.exists(out / "im0-disparity.png")
    want = InferenceRunner(cfg, state, iters=1, device="cpu").disparity(
        left, right)
    np.testing.assert_allclose(np.load(out / "im0.npy"), want, atol=1e-6,
                               rtol=0)

