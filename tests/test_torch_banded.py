"""The port's banded encoder (models/banded.py) against the JAX package's
(CPU), and against the port's own unbanded trunk.

The trunk: the same seeded ``_Trunk`` variables (norm leaves perturbed,
carried by ``state_dict_from_jax``) through JAX ``banded_trunk_apply``
and the port's, at heights that are and are not a multiple of the band
(70 is also odd at half resolution), at the JAX package's own bound
(rtol = atol = 1e-5, tests/test_banded.py).  Gradients, input and every
parameter, banded against unbanded port, at the JAX package's bound:
rtol 1e-3 and atol 1e-4 x the largest gradient (per-band partial sums
reassociate the fp32 reductions, so a gradient that is mathematically
zero, a conv bias in front of an instance norm, holds noise of the
global gradient's scale).

The whole model, ``banded_encoder=True``, port against JAX's banded model:
flows within the port's whole-forward bound, 2e-3 px
(tests/test_torch_model.py), at iters 2 on the default architecture
(measured 6.9e-4 px on flows up to 56 px).  The shared backbone at
``n_downsample=2`` is held at iters 1 (measured 4.3e-4 px): at iters 2
its random weights carry the port's UNBANDED forward 3.3e-3 px from
JAX's (flows up to 65 px), the banded one by as much, since with a
frozen-BN cnet the banded port equals the unbanded port bit for bit,
which the test also checks at iters 2.
"""

import argparse
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_stereo_tpu.cli import common as jcommon
from raft_stereo_tpu.config import RaftStereoConfig as JaxConfig
from raft_stereo_tpu.models.banded import \
    banded_trunk_apply as jax_banded_trunk_apply
from raft_stereo_tpu.models.extractor import _Trunk
from raft_stereo_tpu.models.raft_stereo import RAFTStereo as JaxRAFTStereo
from raft_stereo_tpu_torch.cli import common
from raft_stereo_tpu_torch.config import RaftStereoConfig
from raft_stereo_tpu_torch.io.jax_weights import state_dict_from_jax
from raft_stereo_tpu_torch.models import banded
from raft_stereo_tpu_torch.models.banded import (banded_supported,
                                                 banded_trunk_apply,
                                                 default_band_rows)
from raft_stereo_tpu_torch.models.extractor import Trunk
from raft_stereo_tpu_torch.models.raft_stereo import RAFTStereo
from torch_port_support import nchw, nhwc, perturb

FLOW_ATOL = 2e-3
ITERS = 2
MODEL = dict(n_gru_layers=2, hidden_dims=(48, 48))


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _trunks(norm_fn, h, w, seed=0):
    """(JAX variables as numpy, the port's Trunk with them)."""
    jtrunk = _Trunk(norm_fn, downsample=2, dtype=jnp.float32)
    x = jnp.zeros((1, h, w, 3), jnp.float32)
    variables = perturb(jtrunk.init(jax.random.PRNGKey(seed), x),
                        np.random.default_rng(7))
    trunk = Trunk(norm_fn, 2)
    trunk.load_state_dict(state_dict_from_jax(variables), strict=True)
    return variables, trunk


SHAPES = [(64, 96, 32), (70, 96, 32)]
NORMS = ["instance", "batch", "none"]


@pytest.mark.parametrize("norm_fn", NORMS)
@pytest.mark.parametrize("h,w,band", SHAPES)
def test_banded_trunk_matches_jax(rng, norm_fn, h, w, band):
    variables, trunk = _trunks(norm_fn, h, w)
    x = rng.uniform(-1, 1, (2, h, w, 3)).astype(np.float32)
    want = jax_banded_trunk_apply(variables["params"],
                                  variables.get("batch_stats", {}),
                                  jnp.asarray(x), norm_fn, jnp.float32,
                                  band=band)
    with torch.no_grad():
        got = banded_trunk_apply(trunk, nchw(x), norm_fn, band=band)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("norm_fn", NORMS)
@pytest.mark.parametrize("h,w,band", SHAPES)
def test_banded_trunk_matches_unbanded_port(rng, norm_fn, h, w, band):
    _, trunk = _trunks(norm_fn, h, w)
    x = nchw(rng.uniform(-1, 1, (2, h, w, 3)).astype(np.float32))
    with torch.no_grad():
        want = trunk(x)
        got = banded_trunk_apply(trunk, x, norm_fn, band=band)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("norm_fn", ["instance", "batch"])
def test_banded_trunk_gradients_match_unbanded(rng, norm_fn):
    """The checkpointed bands and statistics sweeps carry the gradient of
    the input and of every parameter, the instance norms' statistics
    included (taken under ``no_grad`` they would not)."""
    _, trunk = _trunks(norm_fn, 70, 64)
    x0 = nchw(rng.uniform(-1, 1, (2, 70, 64, 3)).astype(np.float32))
    probe = torch.from_numpy(
        rng.standard_normal((2, 128, 18, 16)).astype(np.float32))

    def grads(fn):
        trunk.zero_grad(set_to_none=True)
        x = x0.clone().requires_grad_()
        (fn(x) * probe).sum().backward()
        return x.grad.numpy(), {n: p.grad.numpy().copy()
                                for n, p in trunk.named_parameters()}

    gx_p, gp_p = grads(trunk)
    gx_b, gp_b = grads(lambda x: banded_trunk_apply(trunk, x, norm_fn, 32))
    assert gp_b.keys() == gp_p.keys()
    atol = 1e-4 * max(float(np.abs(g).max()) for g in gp_p.values())
    np.testing.assert_allclose(gx_b, gx_p, rtol=1e-3, atol=atol)
    for name, g in gp_p.items():
        np.testing.assert_allclose(gp_b[name], g, rtol=1e-3, atol=atol,
                                   err_msg=name)


@pytest.mark.parametrize("norm_fn", ["instance", "batch"])
def test_banded_trunk_exact_in_fp64(rng, norm_fn):
    """In fp64 the banded trunk is the unbanded one, forward and
    gradients, to rounding (1e-10): its bands, halos, masks, statistics
    sweeps and checkpoints lose nothing.  In fp32 two computations that
    round differently may flip a ReLU where a value lies within rounding of
    zero, which moves the gradient behind it by a whole upstream gradient:
    these seeded weights (torch's init, not JAX's) show such a flip in
    fp32, 2.76 on the input gradient, and none in fp64."""
    torch.manual_seed(0)
    trunk = Trunk(norm_fn, 2)
    gen = torch.Generator().manual_seed(7)
    for m in trunk.modules():
        if hasattr(m, "var") and isinstance(m.var, torch.Tensor):
            m.mean.normal_(0, 0.1, generator=gen)
            m.var.uniform_(0.5, 1.5, generator=gen)
            m.scale.data.normal_(1, 0.1, generator=gen)
            m.bias.data.normal_(0, 0.1, generator=gen)
    trunk = trunk.double()
    x0 = torch.from_numpy(rng.uniform(-1, 1, (2, 3, 70, 64)))
    probe = torch.from_numpy(rng.standard_normal((2, 128, 18, 16)))

    def run(fn):
        trunk.zero_grad(set_to_none=True)
        x = x0.clone().requires_grad_()
        out = fn(x)
        (out * probe).sum().backward()
        return [out.detach(), x.grad] + [p.grad for p in trunk.parameters()]

    got = run(lambda x: banded_trunk_apply(trunk, x, norm_fn, 32))
    want = run(trunk)
    np.testing.assert_allclose(got[0].numpy(), want[0].numpy(), rtol=1e-10,
                               atol=1e-10)
    # a zero gradient (a conv bias in front of an instance norm) holds
    # rounding of the overall gradient's scale, as in the fp32 test above
    atol = 1e-10 * max(float(g.abs().max()) for g in want[1:])
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-10,
                                   atol=atol)


@pytest.fixture(scope="module")
def models():
    """variant -> (JAX config, numpy variables, port model), built once."""
    cache = {}

    def get(variant):
        if variant not in cache:
            kw = dict(MODEL, **({"shared_backbone": True}
                                if variant == "shared" else {}))
            jcfg = JaxConfig(**kw, banded_encoder=True)
            dummy = jnp.zeros((1, 64, 96, 3), jnp.float32)
            init = jax.jit(lambda key: JaxRAFTStereo(
                dataclasses.replace(jcfg, banded_encoder=False)).init(
                key, dummy, dummy, iters=1, test_mode=True))
            variables = perturb(init(jax.random.PRNGKey(0)),
                                np.random.default_rng(7))
            model = RAFTStereo(RaftStereoConfig(**kw, banded_encoder=True,
                                                band_rows=32)).eval()
            model.load_state_dict(state_dict_from_jax(variables),
                                  strict=True)
            cache[variant] = jcfg, variables, model
        return cache[variant]
    return get


@pytest.mark.parametrize("variant", ["default", "shared"])
def test_banded_model_matches_jax(models, variant):
    """The whole forward with ``banded_encoder``: the default
    architecture at narrow widths (cnet frozen BN, fnet instance norm,
    fnet one image at a time), and the shared backbone at
    ``n_downsample=2``; bands of 32 rows over a 64-row pair."""
    jcfg, variables, model = models(variant)
    iters = ITERS if variant == "default" else 1
    rs = np.random.default_rng(3)
    left = rs.integers(0, 256, (1, 64, 96, 3)).astype(np.float32)
    right = np.roll(left, -3, axis=2)
    _, want = jax.jit(lambda v, a, b: JaxRAFTStereo(
        dataclasses.replace(jcfg, band_rows=32)).apply(
        v, a, b, iters=iters, test_mode=True))(
        variables, jnp.asarray(left), jnp.asarray(right))
    l, r = torch.from_numpy(left), torch.from_numpy(right)
    with torch.no_grad():
        _, got = model(l, r, iters=iters)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=FLOW_ATOL)
    if variant == "shared":
        plain = RAFTStereo(dataclasses.replace(
            model.config, banded_encoder=False)).eval()
        plain.load_state_dict(model.state_dict())
        with torch.no_grad():
            assert torch.equal(model(l, r, iters=ITERS)[1],
                               plain(l, r, iters=ITERS)[1])


def test_banded_model_fnet_runs_one_image_at_a_time(models, monkeypatch):
    """Banded, fnet runs each image alone (as the JAX model scans it),
    below the sequential-fnet threshold too."""
    _, _, model = models("default")
    seen = []
    forward = model.fnet.forward
    monkeypatch.setattr(model.fnet, "forward", lambda x, **kw: (
        seen.append(x.shape[0]), forward(x, **kw))[1])
    img = torch.zeros((1, 64, 96, 3))
    with torch.no_grad():
        model(img, img, iters=1)
    assert seen == [1, 1]


def test_banded_model_refuses_unsupported_norms():
    model = RAFTStereo(RaftStereoConfig(**MODEL, banded_encoder=True,
                                        fnet_norm="group"))
    img = torch.zeros((1, 32, 32, 3))
    with pytest.raises(ValueError, match="unsupported"):
        model(img, img, iters=1)


def test_default_band_rows():
    """The largest even band under the budget, clamped to [64, 1024]; on
    the CPU against the JAX package's 16 GiB assumption."""
    budget = banded._BAND_MEMORY_FRACTION * 16 * 2 ** 30
    for n, w in [(1, 2880), (2, 1248), (1, 96), (8, 720), (1, 10 ** 7)]:
        band = default_band_rows(n, w)
        raw = int(budget // (n * w * banded._BAND_BYTES_PER_ROW_PIXEL))
        assert band % 2 == 0
        assert band == max(64, min(1024, raw - raw % 2))
    assert default_band_rows(1, 10 ** 9) == 64
    # the card the constants come from: a 2880-wide image on 79.2 GiB
    # gets the sweep's fastest band
    budget = banded._BAND_MEMORY_FRACTION * 79.2 * 2 ** 30
    assert int(budget // (2880 * banded._BAND_BYTES_PER_ROW_PIXEL)) // 2 \
        * 2 == 512


def test_banded_supported_matches_jax():
    from raft_stereo_tpu.models.banded import \
        banded_supported as jax_supported
    for norm in ("instance", "batch", "none", "group"):
        for ds in (1, 2, 3):
            assert banded_supported(norm, ds) == jax_supported(norm, ds)


@pytest.mark.parametrize("kw", [dict(band_rows=31), dict(band_rows=0),
                                dict(banded_encoder=True, rows_shards=2)])
def test_config_errors_match_jax(kw):
    with pytest.raises(ValueError) as want:
        JaxConfig(**kw)
    with pytest.raises(ValueError) as got:
        RaftStereoConfig(**kw)
    assert str(got.value) == str(want.value)


def test_banded_flag_reaches_the_config():
    """``--banded_encoder`` through ``cli/common.arch_overrides`` on every
    entry point's parser, as the JAX package's."""
    from raft_stereo_tpu_torch.cli import demo, evaluate, serve, train
    jp = argparse.ArgumentParser()
    jcommon.add_arch_overrides(jp)
    want = jcommon.arch_overrides(jp.parse_args(["--banded_encoder"]))
    assert want == {"banded_encoder": True}
    parsers = {"demo": (demo.build_parser(), ["--restore_ckpt", "c", "-l",
                                              "l", "-r", "r"]),
               "evaluate": (evaluate.build_parser(),
                            ["--restore_ckpt", "c", "--dataset", "kitti"]),
               "serve": (serve.build_parser(), ["--restore_ckpt", "c"]),
               "train": (train.build_parser(), [])}
    for name, (parser, base) in parsers.items():
        args = parser.parse_args(base + ["--banded_encoder"])
        assert common.arch_overrides(args) == want, name
    mcfg, _ = train.configs_from_args(train.build_parser().parse_args(
        ["--banded_encoder"]))
    assert mcfg.banded_encoder


def test_demo_runs_banded(tmp_path):
    """The demo with ``--banded_encoder`` answers what the banded model
    gives (the runner at one iteration)."""
    from PIL import Image

    from raft_stereo_tpu_torch.cli import demo
    from raft_stereo_tpu_torch.eval.runner import InferenceRunner
    from raft_stereo_tpu_torch.io.jax_weights import save_checkpoint
    cfg = RaftStereoConfig(hidden_dims=(32, 32, 32), fnet_dim=64)
    torch.manual_seed(0)
    state = RAFTStereo(cfg).state_dict()
    save_checkpoint(str(tmp_path / "ckpt"), cfg, state)
    rs = np.random.default_rng(9)
    left = rs.integers(0, 256, (40, 60, 3), dtype=np.uint8)
    right = np.roll(left, -3, axis=1)
    Image.fromarray(left).save(tmp_path / "im0.png")
    Image.fromarray(right).save(tmp_path / "im1.png")
    demo.main(["--restore_ckpt", str(tmp_path / "ckpt"), "-l",
               str(tmp_path / "im0.png"), "-r", str(tmp_path / "im1.png"),
               "--output_directory", str(tmp_path / "out"),
               "--valid_iters", "1", "--save_numpy", "--device", "cpu",
               "--banded_encoder"])
    want = InferenceRunner(dataclasses.replace(cfg, banded_encoder=True),
                           state, iters=1, device="cpu").disparity(left,
                                                                   right)
    np.testing.assert_allclose(np.load(tmp_path / "out" / "im0.npy"), want,
                               atol=1e-6, rtol=0)
