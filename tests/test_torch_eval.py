"""The port's evaluation path against the JAX package's (CPU): the runner's
per-(padded shape, batch) cache, ``run_batch`` and ``fetch_dtype``; the
four validators and ``make_validation_fn``; the ``.pth`` importer; the
evaluate CLI and its flags; ``FpsProtocol``; ``upsample_flow_bilinear``.

Both packages run TINY widths (``hidden_dims=(32, 32, 32)``,
``fnet_dim=64``) at 2 iterations on the 60x90 mini-trees of
tests/golden_data.py, with the JAX weights (Flax init under ``jax.jit``,
norm leaves perturbed) carried by ``state_dict_from_jax``.  On the CPU
both run their plain paths (the JAX runner reaches no Pallas kernel with
these configs; the port's kernel wrappers run their plain versions).

Tolerances: FLOW_ATOL = 2e-3 px, the whole-forward bound of
tests/test_torch_model.py (the JAX package's own scan and unrolled
forwards differ beyond 1e-5), holds each image's EPE in the validators
and the flows of ``run_batch`` and the ``fetch_dtype`` check on random
pairs.  On the validators' textured pairs single pixels differ by more
(3.1e-3 px measured on the KITTI tree, where the JAX package's own jitted
and eager forwards differ by 5.9e-4 and the port and the eager JAX
forward by 8.4e-4), so the validators hold the EPE, and a bad-pixel (D1)
decision may flip only where the JAX error lies within FLOW_ATOL of the
threshold: the test counts those pixels and bounds the flips by the
count.  ``run_batch`` against per-image calls: 5e-4 px, the JAX
package's own tolerance for the same check (batch-N and batch-1 sum in
other orders).
"""

import argparse
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golden_data import make_all_benchmarks, make_middlebury
from raft_stereo_tpu.cli import common as jcommon
from raft_stereo_tpu.cli import evaluate as jevaluate
from raft_stereo_tpu.config import RaftStereoConfig as JaxConfig
from raft_stereo_tpu.data import datasets as jds
from raft_stereo_tpu.eval import validate as jvalidate
from raft_stereo_tpu.eval.runner import InferenceRunner as JaxRunner
from raft_stereo_tpu.io import torch_import as jimport
from raft_stereo_tpu.models.raft_stereo import RAFTStereo as JaxRAFTStereo
from raft_stereo_tpu.ops.padding import InputPadder as JaxPadder
from raft_stereo_tpu.ops.resize import (
    upsample_flow_bilinear as jax_upsample_flow_bilinear)
from raft_stereo_tpu.profiling import FpsProtocol as JaxFpsProtocol
from raft_stereo_tpu_torch.cli import common, evaluate
from raft_stereo_tpu_torch.config import RaftStereoConfig, TrainConfig
from raft_stereo_tpu_torch.eval import validate
from raft_stereo_tpu_torch.eval.runner import InferenceRunner
from raft_stereo_tpu_torch.io.jax_weights import (save_checkpoint,
                                                  state_dict_from_jax)
from raft_stereo_tpu_torch.io.torch_import import import_torch_checkpoint
from raft_stereo_tpu_torch.ops.padding import InputPadder
from raft_stereo_tpu_torch.ops.resize import upsample_flow_bilinear
from raft_stereo_tpu_torch.profiling import FpsProtocol
from torch_port_support import perturb

FLOW_ATOL = 2e-3
BATCH_ATOL = 5e-4
ITERS = 2
TINY = dict(hidden_dims=(32, 32, 32), fnet_dim=64)


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    """The port's CPU forwards slow down many times over when every test
    worker's thread pool takes every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    """(JAX config, JAX numpy variables, port config, port state dict)."""
    jcfg = JaxConfig(**TINY)
    jmodel = JaxRAFTStereo(jcfg)
    dummy = jnp.zeros((1, 64, 96, 3), jnp.float32)
    init = jax.jit(lambda key: jmodel.init(key, dummy, dummy, iters=1,
                                           test_mode=True))
    variables = perturb(init(jax.random.PRNGKey(0)),
                        np.random.default_rng(7))
    return jcfg, variables, RaftStereoConfig(**TINY), \
        state_dict_from_jax(variables)


@pytest.fixture(scope="module")
def runners(weights):
    """(port runner on the CPU, JAX runner), both at ITERS."""
    jcfg, variables, cfg, state = weights
    return (InferenceRunner(cfg, state, iters=ITERS, device="cpu"),
            JaxRunner(jcfg, variables, iters=ITERS))


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """(datasets root, Middlebury-F root) of golden_data mini-trees."""
    base = str(tmp_path_factory.mktemp("bench"))
    make_all_benchmarks(base)
    mb_f = os.path.join(base, "mbF")
    make_middlebury(mb_f, np.random.default_rng(6), split="F")
    return os.path.join(base, "datasets"), mb_f


class Recording:
    """A runner that keeps every flow it returns."""

    def __init__(self, runner):
        self.runner = runner
        self.flows = []

    def __call__(self, image1, image2):
        flow, seconds = self.runner(image1, image2)
        self.flows.append(flow)
        return flow, seconds


def _pair(seed, hw=(60, 90)):
    rs = np.random.default_rng(seed)
    left = rs.integers(0, 256, hw + (3,), dtype=np.uint8)
    return left, np.roll(left, -3, axis=1)


# ------------------------------------------------------------ validators
# name -> (validator, root under the trees, kwargs, bad-pixel threshold,
#          valid mask, pixel-pooled D1)
BENCH = {
    "eth3d": ("validate_eth3d", "ETH3D", {}, 1.0,
              lambda v, f: v >= 0.5, False),
    "kitti": ("validate_kitti", "KITTI", {}, 3.0,
              lambda v, f: v >= 0.5, True),
    "things": ("validate_things", "", {}, 1.0,
               lambda v, f: (v >= 0.5) & (np.abs(f) < 192), True),
    "middleburyH": ("validate_middlebury", "Middlebury", {"split": "H"},
                    2.0, lambda v, f: (v >= -0.5) & (f > -1000), False),
    "middleburyF": ("validate_middlebury", "mbF", {"split": "F"}, 2.0,
                    lambda v, f: (v >= -0.5) & (f > -1000), False),
}


def _bench_root(trees, sub):
    root, mb_f = trees
    return mb_f if sub == "mbF" else os.path.join(root, sub) if sub else root


def _dataset(name, root):
    if name == "eth3d":
        return jds.ETH3D(root=root)
    if name == "kitti":
        return jds.KITTI(root=root)
    if name == "things":
        return jds.SceneFlow(root=root, dstype="frames_finalpass",
                             things_test=True)
    return jds.Middlebury(root=root, split=name[-1])


@pytest.mark.parametrize("name", sorted(BENCH))
def test_validator_matches_jax(runners, trees, name):
    fn, sub, kw, thr, valid_fn, pooled = BENCH[name]
    root = _bench_root(trees, sub)
    port, jaxr = Recording(runners[0]), Recording(runners[1])
    got = getattr(validate, fn)(port, root=root, **kw)
    want = getattr(jvalidate, fn)(jaxr, root=root, **kw)
    assert sorted(got) == sorted(want)
    dataset = _dataset(name, root)
    assert len(port.flows) == len(jaxr.flows) == len(dataset) == 2
    near, flips, n_valid = [], [], []
    for i, (fp, fj) in enumerate(zip(port.flows, jaxr.flows)):
        assert fp.shape == fj.shape and np.isfinite(fp).all()
        gt = dataset[i]["flow"].ravel()
        val = valid_fn(dataset[i]["valid"].ravel(), gt)
        ep = np.abs(fp.ravel() - gt)[val]
        ej = np.abs(fj.ravel() - gt)[val]
        assert abs(ep.mean() - ej.mean()) <= FLOW_ATOL
        near.append(int((np.abs(ej - thr) <= FLOW_ATOL).sum()))
        flips.append(int(((ep > thr) != (ej > thr)).sum()))
        n_valid.append(int(val.sum()))
        assert flips[-1] <= near[-1]
    assert abs(got[f"{name}-epe"] - want[f"{name}-epe"]) <= FLOW_ATOL
    bound = (100 * sum(near) / sum(n_valid) if pooled
             else 100 * np.mean(np.divide(near, n_valid)))
    assert abs(got[f"{name}-d1"] - want[f"{name}-d1"]) <= bound + 1e-9


def test_make_validation_fn_reuses_runner(weights, trees, monkeypatch):
    """One runner while the config holds (new weights are loaded into
    it), a new one when the config changes."""
    _, _, cfg, state = weights
    made = []

    class Counting(InferenceRunner):
        def __init__(self, *a, **k):
            made.append(1)
            super().__init__(*a, **k)

    monkeypatch.setattr(validate, "InferenceRunner", Counting)
    fn = validate.make_validation_fn(
        cfg, TrainConfig(valid_iters=ITERS), data_root=trees[0],
        datasets=("kitti",), max_images=1, device="cpu")
    first = fn(state)
    assert fn(state) == first and len(made) == 1
    moved = {k: v * 1.01 if v.is_floating_point() else v
             for k, v in state.items()}
    again = fn(moved)
    assert len(made) == 1
    fresh = validate.validate_kitti(
        InferenceRunner(cfg, moved, iters=ITERS, device="cpu"),
        root=os.path.join(trees[0], "KITTI"), max_images=1)
    assert again == fresh and again != first
    fn(state, model_cfg=dataclasses.replace(cfg, corr_backend="reg"))
    assert len(made) == 2
    with pytest.raises(ValueError, match="unknown validation datasets"):
        validate.make_validation_fn(cfg, TrainConfig(), datasets=("nope",))
    assert validate.single_device_cfg(cfg) is cfg


# ---------------------------------------------------------------- runner
def test_runner_cache_bound_matches_jax(weights):
    """The shapes of the JAX package's own cache test at
    ``max_cached_shapes=2``: the port runs them; the JAX runner's cache
    takes the same (padded shape, batch) keys through ``_forward_for``
    (its bookkeeping, without compiling), and both keep the same two
    keys in the same LRU order."""
    jcfg, variables, cfg, state = weights
    port = InferenceRunner(cfg, state, iters=1, device="cpu",
                           max_cached_shapes=2)
    jaxr = JaxRunner(jcfg, variables, iters=1, max_cached_shapes=2)
    rng = np.random.default_rng(0)
    for h, w in ((32, 64), (64, 64), (64, 96), (32, 64)):
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        flow, _ = port(img, img)
        assert flow.shape == (h, w)
        jl, jr, jt, jb = JaxPadder((1, h, w, 3), divis_by=32).pads
        jaxr._forward_for((h + jt + jb, w + jl + jr))
    assert len(port._compiled) == 2
    assert list(port._compiled) == list(jaxr._compiled)
    assert port.captures == port.replays == 0  # no graphs on the CPU


def test_runner_shape_bucket_collapses_and_unpads(weights):
    jcfg, variables, cfg, state = weights
    port = InferenceRunner(cfg, state, iters=1, device="cpu",
                           shape_bucket=64)
    jaxr = JaxRunner(jcfg, variables, iters=1, shape_bucket=64)
    rng = np.random.default_rng(1)
    for h, w in ((60, 90), (62, 94), (33, 65)):
        left = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        right = np.roll(left, -2, axis=1)
        flow, _ = port(left, right)
        assert flow.shape == (h, w)
        # exact unpadding: the model on the edge-padded pair, cropped
        padder = InputPadder((1, 3, h, w), divis_by=64)
        pl, pr, pt, pb = padder.pads
        spec = ((pt, pb), (pl, pr), (0, 0))
        with torch.inference_mode():
            _, up = port.model(
                torch.from_numpy(np.pad(left, spec, mode="edge")[None]),
                torch.from_numpy(np.pad(right, spec, mode="edge")[None]),
                iters=1, test_mode=True)
        np.testing.assert_array_equal(flow, padder.unpad(up)[0].numpy())
        jl, jr, jt, jb = JaxPadder((1, h, w, 3), divis_by=64).pads
        jaxr._forward_for((h + jt + jb, w + jl + jr))
    assert list(port._compiled) == list(jaxr._compiled) == [((64, 128), 1)]
    with pytest.raises(ValueError, match="shape_bucket"):
        InferenceRunner(cfg, state, device="cpu", shape_bucket=48)
    with pytest.raises(ValueError, match="max_cached_shapes"):
        InferenceRunner(cfg, state, device="cpu", max_cached_shapes=0)


def test_run_batch_matches_jax_and_single_calls(runners):
    port, jaxr = runners
    pairs = [_pair(s) for s in (3, 4, 5)]
    lefts, rights = [p[0] for p in pairs], [p[1] for p in pairs]
    flows, seconds = port.run_batch(lefts, rights)
    assert flows.shape == (3, 60, 90) and flows.dtype == np.float32
    assert seconds > 0
    want, _ = jaxr.run_batch(lefts, rights)
    np.testing.assert_allclose(flows, want, atol=FLOW_ATOL, rtol=0)
    for i in range(3):
        np.testing.assert_allclose(flows[i], port(lefts[i], rights[i])[0],
                                   atol=BATCH_ATOL, rtol=0)
    assert ((64, 96), 3) in port._compiled
    with pytest.raises(ValueError, match="same-shape"):
        port.run_batch([lefts[0], lefts[1][:32]],
                       [rights[0], rights[1][:32]])


@pytest.mark.parametrize("fetch", ["fp16", "bf16"])
def test_fetch_dtype_rounds_the_fp32_result(weights, runners, fetch):
    jcfg, variables, cfg, state = weights
    left, right = _pair(8)
    full, _ = runners[0](left, right)
    half, _ = InferenceRunner(cfg, state, iters=ITERS, device="cpu",
                              fetch_dtype=fetch)(left, right)
    assert half.dtype == np.float32
    dtype = {"fp16": torch.float16, "bf16": torch.bfloat16}[fetch]
    np.testing.assert_array_equal(
        half, torch.from_numpy(full).to(dtype).float().numpy())
    if fetch == "fp16":
        jhalf, _ = JaxRunner(jcfg, variables, iters=ITERS,
                             fetch_dtype="fp16")(left, right)
        # the forwards' gap plus fp16's rounding (half an ulp: 2^-11 |x|)
        bound = FLOW_ATOL + np.abs(full) * 2.0 ** -11
        assert (np.abs(full - jhalf) <= bound).all()
    for bad in ("fp32", "float16"):
        with pytest.raises(ValueError, match="fetch_dtype"):
            InferenceRunner(cfg, state, device="cpu", fetch_dtype=bad)
        with pytest.raises(ValueError, match="fetch_dtype"):
            JaxRunner(jcfg, variables, fetch_dtype=bad)


# ---------------------------------------------------------- .pth import
def _reference_inner(inner):
    """Our ResidualBlock member path -> the reference's."""
    if inner[0] == "downsample_conv":
        return ("downsample", "0") + tuple(inner[1:])
    return tuple(inner)


def _reference_module(path):
    """The JAX package's module path -> the reference's module path (the
    inverse of ``_translate``); ``convzr`` maps to itself and is split."""
    root = path[0]
    if root in ("cnet", "fnet"):
        rest = path[1:]
        if rest[0] == "trunk":
            rest = rest[1:]
        sub = rest[0]
        if sub in ("conv1", "norm1", "conv2"):
            return (root, sub) + tuple(rest[1:])
        if sub.startswith("layer"):
            layer, block = sub[len("layer"):].split("_")
            return (root, f"layer{layer}", block) + _reference_inner(rest[1:])
        head, h, kind = sub.split("_")  # outputs08_0_res / _conv
        if head == "outputs32":
            return (root, "outputs32", h) + tuple(rest[1:])
        if kind == "res":
            return (root, head, h, "0") + _reference_inner(rest[1:])
        return (root, head, h, "1") + tuple(rest[1:])
    if root == "update_block":
        if path[1] == "mask_conv1":
            return ("update_block", "mask", "0") + tuple(path[2:])
        if path[1] == "mask_conv2":
            return ("update_block", "mask", "2") + tuple(path[2:])
        return tuple(path)
    if root.startswith("context_zqr_conv"):
        return ("context_zqr_convs", root[len("context_zqr_conv"):]) + \
            tuple(path[1:])
    if root == "conv2_res":
        return ("conv2", "0") + _reference_inner(path[1:])
    if root == "conv2_out":
        return ("conv2", "1") + tuple(path[1:])
    raise KeyError(path)


_LEAF = {("params", "kernel"): "weight", ("params", "scale"): "weight",
         ("params", "bias"): "bias", ("batch_stats", "mean"): "running_mean",
         ("batch_stats", "var"): "running_var"}


def _reference_state_dict(variables):
    """A state dict in the reference's key names and layouts, with the
    ``module.`` prefix, the aliased ``downsample.1`` keys and unused
    parameters the reference allocates; every name checked against the
    JAX package's ``_translate``."""
    state = {}
    for col in ("params", "batch_stats"):
        for kpath, leaf in jax.tree_util.tree_flatten_with_path(
                variables.get(col, {}))[0]:
            path = tuple(p.key for p in kpath)
            name = _LEAF[(col, path[-1])]
            value = np.asarray(leaf, np.float32)
            if path[-1] == "kernel":
                value = value.transpose(3, 2, 0, 1)  # HWIO -> OIHW
            module = _reference_module(path[:-1])
            if module[-1] == "convzr":
                z, r = np.split(value, 2, axis=0)
                for gate, half in (("convz", z), ("convr", r)):
                    key = ".".join(module[:-1] + (gate, name))
                    assert jimport._translate(key) == \
                        tuple(path[:-2]) + (gate, name)
                    state[key] = half
                continue
            key = ".".join(module + (name,))
            assert jimport._translate(key) == tuple(path[:-1]) + (name,)
            state[key] = value
            if module[-1] == "norm3":  # the reference registers it twice
                alias = ".".join(module[:-1] + ("downsample", "1", name))
                assert jimport._translate(alias) is None
                state[alias] = value
            if name == "running_var":
                state[".".join(module + ("num_batches_tracked",))] = \
                    np.array(7)
    return state


ARCHS = {"default": {}, "realtime": {
    "shared_backbone": True, "n_downsample": 3, "n_gru_layers": 2,
    "slow_fast_gru": True, "corr_backend": "alt", "mixed_precision": True}}


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_pth_import_matches_jax(tmp_path, arch):
    jcfg = JaxConfig(**TINY, **ARCHS[arch])
    jmodel = JaxRAFTStereo(jcfg)
    dummy = jnp.zeros((1, 64, 96, 3), jnp.float32)
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), dummy, dummy, iters=1, test_mode=True))
    rng = np.random.default_rng(21)
    variables = jax.tree_util.tree_map(
        lambda s: rng.normal(0, 0.1, s.shape).astype(np.float32), shapes)
    variables = {k: dict(v) for k, v in variables.items()}
    state = _reference_state_dict(variables)
    n_gru = jcfg.n_gru_layers
    unused = {}
    if n_gru < 3:  # the reference allocates these unconditionally
        unused["update_block.gru32.convz.weight"] = rng.normal(
            size=(32, 64, 3, 3))
        unused["update_block.gru32.convz.bias"] = rng.normal(size=32)
        unused["update_block.gru32.convr.weight"] = rng.normal(
            size=(32, 64, 3, 3))
        unused["update_block.gru32.convr.bias"] = rng.normal(size=32)
        unused["cnet.outputs32.0.weight"] = rng.normal(size=(32, 128, 3, 3))
    unused["cnet.layer5.0.conv1.weight"] = rng.normal(size=(128, 128, 3, 3))
    state.update({k: np.asarray(v, np.float32) for k, v in unused.items()})
    path = str(tmp_path / f"{arch}.pth")
    torch.save({f"module.{k}": torch.from_numpy(np.array(v))
                for k, v in state.items()}, path)

    overrides = dict(fnet_dim=TINY["fnet_dim"], **{
        k: v for k, v in ARCHS[arch].items()
        if k in ("slow_fast_gru", "corr_backend", "mixed_precision")})
    jcfg_got, jvars = jimport.import_torch_checkpoint(path, **overrides)
    cfg, got = import_torch_checkpoint(path, **overrides)
    for field in dataclasses.fields(RaftStereoConfig):
        assert getattr(cfg, field.name) == getattr(jcfg_got, field.name), \
            field.name
    want = state_dict_from_jax(jax.device_get(jvars))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype == torch.float32
        assert torch.equal(got[k], want[k]), k
    cfg2, state2 = common.load_any_checkpoint(path, **overrides)
    assert cfg2 == cfg and all(torch.equal(state2[k], got[k]) for k in got)


# ------------------------------------------------------------------- CLI
def test_evaluate_cli_matches_jax(weights, runners, trees, tmp_path):
    from raft_stereo_tpu.training.checkpoint import save_weights

    jcfg, variables, cfg, state = weights
    port_ckpt, jax_ckpt = str(tmp_path / "port"), str(tmp_path / "jax")
    save_checkpoint(port_ckpt, cfg, state)
    save_weights(jax_ckpt, jcfg, variables["params"],
                 variables.get("batch_stats"))
    root = trees[0]
    args = ["--dataset", "kitti", "--data_root", root, "--valid_iters",
            str(ITERS), "--json"]
    got = evaluate.main(["--restore_ckpt", port_ckpt, "--device", "cpu"]
                        + args)
    want = jevaluate.main(["--restore_ckpt", jax_ckpt] + args)
    assert sorted(got) == sorted(want) == ["kitti-d1", "kitti-epe"]
    assert abs(got["kitti-epe"] - want["kitti-epe"]) <= FLOW_ATOL
    # the D1 flip bound from the JAX flows on the same tree
    dataset = jds.KITTI(root=os.path.join(root, "KITTI"))
    near = n_valid = 0
    for i in range(len(dataset)):
        s = dataset[i]
        flow, _ = runners[1](s["image1"], s["image2"])
        val = s["valid"].ravel() >= 0.5
        err = np.abs(flow.ravel() - s["flow"].ravel())[val]
        near += int((np.abs(err - 3.0) <= FLOW_ATOL).sum())
        n_valid += int(val.sum())
    assert abs(got["kitti-d1"] - want["kitti-d1"]) <= \
        100 * near / n_valid + 1e-9


def _parsers():
    port, jaxp = argparse.ArgumentParser(), argparse.ArgumentParser()
    common.add_arch_overrides(port)
    jcommon.add_arch_overrides(jaxp)
    return port, jaxp


def test_arch_overrides_same_flags_as_jax():
    port, jaxp = _parsers()
    assert {a.dest: a.default for a in port._actions} == \
        {a.dest: a.default for a in jaxp._actions}
    argv = ["--corr_implementation", "alt", "--slow_fast_gru",
            "--mixed_precision"]
    assert common.arch_overrides(port.parse_args(argv)) == \
        jcommon.arch_overrides(jaxp.parse_args(argv))
    assert {a.dest for a in evaluate.build_parser()._actions} == \
        {a.dest for a in jevaluate.build_parser()._actions} | {"device"}


@pytest.mark.parametrize("argv,item", [
    (["--banded_encoder"], "§D7"), (["--rows_shards", "2"], "§D7"),
    (["--rows_gru"], "§D7"), (["--rows_gru_halo", "4"], "§D7"),
    (["--corr_w2_shards", "2"], "§D7"), (["--sequence"], "§D3"),
    (["--stream_out", "x.json"], "§D3"),
    (["--exit_threshold_px", "0.5"], "§D3"), (["--min_iters", "2"], "§D3")])
def test_unported_flags_raise(argv, item):
    args = evaluate.build_parser().parse_args(
        ["--restore_ckpt", "unused", "--dataset", "kitti"] + argv)
    with pytest.raises(NotImplementedError, match=item):
        evaluate.run_eval(args)


# -------------------------------------------------------------- the rest
def test_fps_protocol_matches_jax():
    calls = [(i,) for i in range(7)]
    got = FpsProtocol(warmup=3).measure(lambda i: np.zeros(2), calls)
    want = JaxFpsProtocol(warmup=3).measure(lambda i: np.zeros(2), calls)
    assert got.n_timed == want.n_timed == 4
    assert len(got.per_image_s) == 4 and got.fps == 1.0 / got.mean_s
    FpsProtocol(warmup=0).measure(lambda: torch.zeros(3), [()])
    with pytest.raises(ValueError, match="warmup"):
        FpsProtocol(warmup=7).measure(lambda i: i, calls)


@pytest.mark.parametrize("factor", [2, 4, 8])
def test_upsample_flow_bilinear_matches_jax(factor):
    flow = np.random.default_rng(factor).normal(
        size=(2, 5, 7, 2)).astype(np.float32)
    want = np.asarray(jax_upsample_flow_bilinear(jnp.asarray(flow), factor))
    got = upsample_flow_bilinear(torch.from_numpy(
        flow.transpose(0, 3, 1, 2)), factor).permute(0, 2, 3, 1).numpy()
    assert got.shape == (2, 5 * factor, 7 * factor, 2)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
