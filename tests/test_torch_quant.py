"""The port's quantized inference tier against the JAX package (CPU).

``quant`` "int8" (encoder weights stored int8, dequantized per call; the
pyramid of ``reg``/``reg_fused`` in one byte) and "int8_mxu" (encoder
convs int8 x int8 -> int32; under ``alt`` the features in one byte), with
int8 or float8_e4m3fn correlation codes.  The JAX Pallas kernels run in
interpret mode (where JAX also takes fp8); the port's wrappers run their
plain versions on CPU tensors.  Quantizers and the quantized state dict
are held bit for bit; the kernels' plain versions to 1e-6 (int8, whose
dots are exact integers) or 1e-5 (fp8) of the output's scale plus the
bound of the port's fp32 tap positions (``_interp_bound``); the int8
conv's accumulator bit for bit; the whole forward and the calibration at
the tolerances their docstrings state.  The JAX forward runs as its
``InferenceRunner`` runs it (weights quantized once, "int8" dequantized
in the program), applied without ``jit``.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_stereo_tpu.config import RaftStereoConfig as JaxConfig
from raft_stereo_tpu.kernels import corr_alt as jcorr_alt
from raft_stereo_tpu.kernels import corr_lookup as jcorr_lookup
from raft_stereo_tpu.models import corr as jcorr
from raft_stereo_tpu.models.raft_stereo import RAFTStereo as JaxRAFTStereo
from raft_stereo_tpu import quant as jcal
from raft_stereo_tpu.quant import core as jcore
from raft_stereo_tpu.quant import matmul as jmatmul
from raft_stereo_tpu_torch.config import RaftStereoConfig
from raft_stereo_tpu_torch.eval.runner import InferenceRunner
from raft_stereo_tpu_torch.io.jax_weights import state_dict_from_jax
from raft_stereo_tpu_torch.kernels.corr_alt import alt_lookup_fused_q
from raft_stereo_tpu_torch.kernels.corr_lookup import (check_q_dtype,
                                                       lookup_pyramid_fused_q)
from raft_stereo_tpu_torch.models import extractor
from raft_stereo_tpu_torch.models.corr import (build_corr_pyramid,
                                               build_corr_volume,
                                               make_corr_fn, quantize_pyramid)
from raft_stereo_tpu_torch.models.extractor import Conv2d
from raft_stereo_tpu_torch.models.raft_stereo import RAFTStereo
from raft_stereo_tpu_torch.quant import calibrate as cal
from raft_stereo_tpu_torch.quant import core
from raft_stereo_tpu_torch.quant.matmul import (int8_conv_int32,
                                                quantized_conv_apply)
from torch_port_support import assert_bf16_close, perturb

RADIUS = 4
TINY = dict(hidden_dims=(32, 32, 32), fnet_dim=64)
HW = (64, 96)
FLOW_ATOL = 2e-3
SPREAD_FACTOR = 3.0
Q_DTYPES = {"int8": (jnp.int8, torch.int8),
            "fp8": (jnp.float8_e4m3fn, torch.float8_e4m3fn)}


@pytest.fixture
def interpret_mode():
    jcorr_lookup._interpret_override = True
    yield
    jcorr_lookup._interpret_override = None


def _jcfg(realtime: bool, **kw):
    base = dataclasses.asdict(JaxConfig.realtime()) if realtime else {}
    return JaxConfig(**{**base, **TINY, **kw})


def _init(jcfg):
    jmodel = JaxRAFTStereo(jcfg)
    dummy = jnp.zeros((1,) + HW + (3,), jnp.float32)
    init = jax.jit(lambda key: jmodel.init(key, dummy, dummy, iters=1,
                                           test_mode=True))
    return perturb(init(jax.random.PRNGKey(0)), np.random.default_rng(7))


@pytest.fixture(scope="module")
def default_vars():
    return _init(_jcfg(False, quant="off"))


@pytest.fixture(scope="module")
def realtime_vars():
    return _init(_jcfg(True, mixed_precision=False))


def _images(seed=3, hw=HW):
    rs = np.random.default_rng(seed)
    left = rs.integers(0, 256, hw + (3,), dtype=np.uint8)
    return left, np.roll(left, -3, axis=1)


def _t(a, dtype=None):
    """A JAX/numpy array as a torch tensor (exact)."""
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).bfloat16()
    if a.dtype == jnp.float8_e4m3fn:
        return torch.from_numpy(a.astype(np.float32)).to(
            torch.float8_e4m3fn)
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def _np(t):
    return t.float().numpy() if t.dtype != torch.int8 else t.numpy()


# ------------------------------------------------------------ quantizers
def _boundary_values(rng, dtype):
    """Random values, plus values at exact .5 code boundaries of a scale,
    in ``dtype``: the scale is that of the values (dynamic)."""
    x = rng.normal(size=(6, 40)).astype(np.float32) * 3
    x[0, 0] = 6.0  # fixes max|x|, so the scale is 6/127 or 6/448
    if dtype == "bf16":
        x = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    return x


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_quantizers_bit_equal_to_jax(rng, dtype):
    """Codes and scales equal JAX's bit for bit, ``x / s`` in the input's
    dtype (bf16 for bf16: cast point 3), at .5 boundaries too."""
    jdt, tdt = {"fp32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    x = _boundary_values(rng, dtype)
    for qmax in (127.0, core.FP8_QMAX):
        jx = jnp.asarray(x, jdt)
        js = jcore.dynamic_scale(jx, qmax=qmax)
        tx = _t(jx)
        ts = core.dynamic_scale(tx, qmax=qmax)
        assert ts.dtype == tdt and js.dtype == jdt
        assert float(ts) == float(js)
        # values on the .5 boundaries of this scale, in the input dtype
        half = (np.arange(-60, 60) + 0.5).astype(np.float32)
        jb = (jnp.asarray(half, jdt) * js).astype(jdt)
        for jv in (jx, jb):
            tv = _t(jv)
            if qmax == 127.0:
                want = np.asarray(jcore.quantize_symmetric(jv, js))
                got = core.quantize_symmetric(tv, ts)
                assert got.dtype == torch.int8
                np.testing.assert_array_equal(got.numpy(), want)
            else:
                want = np.asarray(jcore.quantize_fp8(
                    jv, js, jnp.float8_e4m3fn).astype(jnp.float32))
                got = core.quantize_fp8(tv, ts)
                assert got.dtype == torch.float8_e4m3fn
                np.testing.assert_array_equal(got.float().numpy(), want)
    assert core.clipped_scale(3.0) == jcore.clipped_scale(3.0)


def _act_scales(state):
    """Seeded input scales for half of the encoder convs (strings as the
    calibration's "/"-joined paths)."""
    paths = sorted(k[:-len(".weight")].replace(".", "/") for k, v in
                   state.items() if k.endswith(".weight") and v.dim() == 4
                   and core.in_encoder_scope(k))
    rs = np.random.default_rng(5)
    return {p: float(rs.uniform(0.01, 0.1)) for p in paths[::2]}


@pytest.mark.parametrize("realtime", [False, True])
def test_quantize_state_dict_matches_jax(default_vars, realtime_vars,
                                         realtime):
    """The port's quantization of the bridged fp32 state dict equals the
    bridged JAX quantization, leaf for leaf and bit for bit, with the
    same ``act_scales``; the byte counts agree; the packs dequantize."""
    v = realtime_vars if realtime else default_vars
    state = state_dict_from_jax(v)
    scales = _act_scales(state)
    got = core.quantize_state_dict(state, act_scales=scales)
    jq = jcore.quantize_variables(v, act_scales=scales)
    want = state_dict_from_jax(jq)
    assert set(got) == set(want)
    assert sum(k.endswith(".ascale") for k in got) == len(scales)
    for k, w in want.items():
        assert got[k].dtype == w.dtype, k
        assert torch.equal(got[k], w), k
    assert core.quantized_param_bytes(got) == jcore.quantized_param_bytes(jq)
    assert core.is_quantized(got) and not core.is_quantized(state)
    deq = core.dequantize_state_dict(got)
    jdeq = state_dict_from_jax(jcore.dequantize_variables(
        jax.device_get(jq)))
    assert set(deq) == set(state) == set(jdeq)
    for k in deq:
        assert torch.equal(deq[k], jdeq[k]), k
    packed = {k for k in got if k.endswith(".q8")}
    assert all(core.in_encoder_scope(k) for k in packed)
    assert not any(k.startswith("update_block") for k in packed)


def test_quant_configs_construct_and_validate():
    for quant in ("int8", "int8_mxu"):
        for fp8 in (False, True):
            cfg = RaftStereoConfig(quant=quant, quant_corr_fp8=fp8,
                                   quant_corr_scales=(1.0, 1.0, 0.5, 0.5))
            assert cfg.to_dict() == dataclasses.asdict(JaxConfig(
                quant=quant, quant_corr_fp8=fp8,
                quant_corr_scales=(1.0, 1.0, 0.5, 0.5)))
    for kw in ({"quant": "int4"}, {"quant_corr_scales": (1.0,)},
               {"quant_corr_scales": (1.0, 1.0, 0.0, 1.0)}):
        with pytest.raises(ValueError):
            RaftStereoConfig(**kw)
        with pytest.raises(ValueError):
            JaxConfig(**kw)
    # the turbo tier: int8_mxu with the early exit (ported since §D3)
    assert RaftStereoConfig(quant="int8_mxu", exit_threshold_px=0.05,
                            exit_min_iters=2).to_dict() == dataclasses.asdict(
        JaxConfig(quant="int8_mxu", exit_threshold_px=0.05,
                  exit_min_iters=2))


# --------------------------------------------------- 1-byte kernel entries
def _codes(rng, shape, q):
    jdt, _ = Q_DTYPES[q]
    if q == "int8":
        return jnp.asarray(rng.integers(-127, 128, shape), jnp.int8)
    return jnp.asarray(rng.normal(scale=60, size=shape).clip(-448, 448),
                       jnp.float32).astype(jdt)


def _interp_bound(coords, vmax):
    """How far the port's interpolation may sit from JAX's hat weights:
    the port rounds the tap position ``x = c/2^l + k - r`` to fp32 (half
    an ulp of |x|) and takes ``t = x - floor(x)`` from it, while JAX's
    hat weight ``1 - |j - r - c|`` is exact where it is not zero, so a
    sample may move by half an ulp of the largest |x| times the largest
    gap between two bins, 2 max|v|: at most ulp(max|x|) * max|v|."""
    return float(np.spacing(np.float32(np.abs(coords).max() + RADIUS))
                 ) * vmax


@pytest.mark.parametrize("q", ["int8", "fp8"])
def test_lookup_q_matches_jax_kernel(rng, interpret_mode, q):
    """#1 over 1-byte levels: all levels in one call, and each level alone
    at scale 1/2^l (the per-level route), raw fp32 samples.  Held to 1e-6
    of the output's scale plus the interpolation bound (``_interp_bound``:
    the codes reach 127 or 448, so an ulp of the tap position shows)."""
    rows, w1, w2 = 3, 40, 40
    w2s = [w2 // 2 ** i for i in range(4)]
    levels = [_codes(rng, (1, rows, w1, w), q) for w in w2s]
    coords = rng.uniform(-10, w2 + 10, (1, rows, w1)).astype(np.float32)
    tlevels = [_t(v) for v in levels]
    calls = [(levels, tlevels, coords)] + [
        ([v], [tv], coords / 2 ** i)
        for i, (v, tv) in enumerate(zip(levels, tlevels))]
    for jl, tl, c in calls:
        want = np.asarray(jcorr_lookup.lookup_pyramid_fused_q(
            jl, jnp.asarray(c), RADIUS, out_dtype=jnp.float32,
            q_dtype=Q_DTYPES[q][0]))
        before = lookup_pyramid_fused_q.launches
        got = lookup_pyramid_fused_q(tl, torch.from_numpy(c), RADIUS,
                                     out_dtype=torch.float32)
        assert lookup_pyramid_fused_q.launches == before  # CPU: plain
        assert got.dtype == torch.float32 and got.shape == want.shape
        vmax = max(float(np.abs(np.asarray(v, np.float32)).max())
                   for v in jl)
        np.testing.assert_allclose(
            got.numpy(), want, rtol=0,
            atol=1e-6 * np.abs(want).max() + _interp_bound(c, vmax))
    if q == "fp8":
        with pytest.raises(ValueError, match="forward only"):
            lookup_pyramid_fused_q([v.clone().requires_grad_()
                                    for v in tlevels], torch.from_numpy(
                                        coords), RADIUS, torch.float32)
    with pytest.raises(ValueError, match="q_dtype"):
        check_q_dtype([torch.zeros(2, dtype=torch.bfloat16)])
    with pytest.raises(ValueError, match="must all be"):
        check_q_dtype(tlevels[:1], torch.float8_e4m3fn if q == "int8"
                      else torch.int8)


@pytest.mark.parametrize("q", ["int8", "fp8"])
def test_alt_q_matches_jax_kernel(rng, interpret_mode, q):
    """Kernel #9: the no-volume lookup over 1-byte features (D 32, four
    W-pooled levels), all levels in one call and one level alone at
    1/2^l, and an odd width.  int8 dots are exact integers in fp32, so the
    two versions differ only in the interpolation: 1e-6 of the scale plus
    ``_interp_bound``; fp8 products sum inexactly in another order: 1e-5
    of the scale plus the same bound."""
    tol = 1e-6 if q == "int8" else 1e-5
    for b, h, w1, w2, d in ((1, 2, 16, 32, 32), (1, 3, 21, 27, 64)):
        f1 = _codes(rng, (b, h, w1, d), q)
        pyr = [_codes(rng, (b, h, w2 // 2 ** i, d), q) for i in range(4)]
        coords = rng.uniform(-6, w2 + 6, (b, h, w1)).astype(np.float32)
        calls = [(pyr, coords)] + [([v], coords / 2 ** i)
                                   for i, v in enumerate(pyr)][1:3]
        for jp, c in calls:
            want = np.asarray(jcorr_alt.alt_lookup_fused_q(
                f1, jp, jnp.asarray(c), RADIUS, out_dtype=jnp.float32,
                q_dtype=Q_DTYPES[q][0]))
            before = alt_lookup_fused_q.launches
            got = alt_lookup_fused_q(_t(f1), [_t(v) for v in jp],
                                     torch.from_numpy(c), RADIUS,
                                     out_dtype=torch.float32)
            assert alt_lookup_fused_q.launches == before
            assert got.dtype == torch.float32 and got.shape == want.shape
            vol = np.einsum("bhwd,bhvd->bhwv",
                            np.asarray(f1, np.float32),
                            np.asarray(jp[0], np.float32)) / np.sqrt(d)
            np.testing.assert_allclose(
                got.numpy(), want, rtol=0,
                atol=tol * np.abs(want).max()
                + _interp_bound(c, np.abs(vol).max()))
    if q == "fp8":  # an fp8 tensor can require grad; an int8 one cannot
        with pytest.raises(ValueError, match="forward only"):
            alt_lookup_fused_q(_t(f1).requires_grad_(), [_t(v) for v in pyr],
                               torch.from_numpy(coords), RADIUS,
                               torch.float32)


# ----------------------------------------------------------- int8 conv
@pytest.mark.parametrize("k,stride", [(3, 1), (3, 2), (1, 1), (7, 2)])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_int8_conv_matches_jax(rng, k, stride, dtype):
    """``quantized_conv_apply`` against JAX's on the same input and pack,
    calibrated and dynamic ``ascale``: the int32 accumulators are equal;
    the output agrees to 1e-6 relative in fp32 and within one bf16 ulp in
    bf16 (one rounding of the same fp32 value, up to the order of the
    rescale's two multiplies)."""
    jdt = jnp.float32 if dtype == "fp32" else jnp.bfloat16
    cin, cout = 5, 16
    x = jnp.asarray(rng.normal(size=(2, 11, 13, cin)), jdt)
    w = rng.normal(size=(k, k, cin, cout)).astype(np.float32)
    bias = rng.normal(size=(cout,)).astype(np.float32)
    q8, qscale = jcore.quantize_array(w)
    pad = ((k // 2, k // 2),) * 2
    tx = _t(x).permute(0, 3, 1, 2)
    tq8 = torch.from_numpy(q8.transpose(3, 2, 0, 1).copy())
    tqs = torch.from_numpy(qscale.reshape(-1).copy())
    for ascale in (None, np.float32(0.02)):
        pack = {"q8": q8, "qscale": qscale}
        if ascale is not None:
            pack["ascale"] = ascale
        want = np.asarray(jmatmul.quantized_conv_apply(
            x, pack, jnp.asarray(bias), strides=(stride, stride),
            padding=pad, out_dtype=jdt).astype(jnp.float32))
        jxq, _ = jmatmul.quantize_activation(x, pack.get("ascale"))
        want_acc = np.asarray(jmatmul.int8_conv_int32(
            jxq, q8, strides=(stride, stride), padding=pad))
        ta = None if ascale is None else torch.tensor(ascale)
        got = quantized_conv_apply(tx, tq8, tqs, ta, torch.from_numpy(bias),
                                   stride, k // 2, out_dtype=_t(x).dtype)
        assert got.dtype == _t(x).dtype
        txq = core.quantize_symmetric(
            tx.float(), core.dynamic_scale(tx).float() if ta is None else ta)
        np.testing.assert_array_equal(txq.permute(0, 2, 3, 1).numpy(),
                                      np.asarray(jxq))
        acc = int8_conv_int32(txq, tq8, stride, k // 2)
        assert acc.dtype == torch.int32
        np.testing.assert_array_equal(acc.permute(0, 2, 3, 1).numpy(),
                                      want_acc)
        got = got.permute(0, 2, 3, 1)
        if dtype == "fp32":
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                       atol=1e-6 * np.abs(want).max())
        else:
            assert_bf16_close(got, want, ulps=1, atol=0)


# ------------------------------------------------------- models/corr.py
def _corr_features(rng, dtype, b=1, d=32, h=3, w=20):
    jdt = jnp.float32 if dtype == "fp32" else jnp.bfloat16
    f = [jnp.asarray(rng.normal(size=(b, h, w, d)), jdt) for _ in range(2)]
    coords = rng.uniform(-6, w + 6, size=(b, h, w)).astype(np.float32)
    return f, coords


@pytest.mark.parametrize("calibrated", [False, True])
@pytest.mark.parametrize("q", ["int8", "fp8"])
@pytest.mark.parametrize("backend", ["reg", "reg_fused", "alt"])
def test_quantized_corr_matches_jax(rng, interpret_mode, backend, q,
                                    calibrated):
    """Each quantized backend against JAX's ``make_corr_fn`` (kernel path)
    on the same feature maps: ``reg``/``reg_fused`` fp32 features (the
    default), ``alt`` bf16 features (the realtime preset, bf16 scales and
    ``x / s``).  The codes are compared first: they may differ only where
    the two frameworks' fp32 volumes (another summation order) straddle a
    rounding boundary, and the test counts those.  Where they agree, the
    output is held to 1e-6 of its scale plus the interpolation bound
    (fp32) or one bf16 ulp (bf16)."""
    dtype = "bf16" if backend == "alt" else "fp32"
    (jf1, jf2), coords = _corr_features(rng, dtype)
    kw = dict(quant="int8_mxu", quant_corr_fp8=(q == "fp8"),
              corr_backend=backend, mixed_precision=(dtype == "bf16"),
              quant_corr_scales=(2.0, 1.5, 1.2, 1.0) if calibrated else None)
    want = np.asarray(jcorr.make_corr_fn(JaxConfig(**TINY, **kw), jf1, jf2)(
        jnp.asarray(coords)).astype(jnp.float32))
    cfg = RaftStereoConfig(**TINY, **kw)
    tf = [_t(f).permute(0, 3, 1, 2) for f in (jf1, jf2)]
    fn = make_corr_fn(cfg, *tf)
    got = fn(torch.from_numpy(coords))
    assert got.dtype == tf[0].dtype and not got.requires_grad
    if backend == "alt":
        assert_bf16_close(got, want, ulps=1, atol=0)
        return
    # the codes: JAX's quantization of JAX's fp32 pyramid vs the port's
    jpyr = jcorr.build_corr_pyramid(jcorr.build_corr_volume(jf1, jf2), 4)
    jq, jscales = jcorr.quantize_pyramid(jpyr, JaxConfig(**TINY, **kw))
    flips = 0
    for lvl, (tq, jql, js, jv) in enumerate(zip(fn.codes, jq, jscales,
                                                jpyr)):
        a = np.asarray(jql.astype(jnp.float32))
        diff = _np(tq) != a
        flips += int(diff.sum())
        if diff.any():   # only at a rounding boundary of the scaled value
            v = np.asarray(jv)[diff] / float(js)
            assert np.all(np.abs(np.abs(v - np.round(v)) - 0.5) < 1e-4), lvl
    assert flips <= 2, flips
    if flips == 0:
        vmax = max(float(np.abs(np.asarray(v.astype(jnp.float32))).max())
                   * float(s) for v, s in zip(jq, jscales))
        np.testing.assert_allclose(
            got.numpy(), want, rtol=0,
            atol=1e-6 * np.abs(want).max() + _interp_bound(coords, vmax))


# ------------------------------------------------------------ whole forward
def _jax_flow(jcfg, variables, left, right, iters, kernels):
    """JAX's quantized forward as its runner runs it (quantize once;
    "int8" dequantizes the packs, "int8_mxu" passes them through), with
    the Pallas kernels in interpret mode or on its XLA fallback."""
    jcorr_lookup._interpret_override = True if kernels else None
    try:
        if jcfg.quant == "int8":
            variables = jcore.dequantize_variables(variables)
        _, up = JaxRAFTStereo(jcfg).apply(
            variables, jnp.asarray(left[None], jnp.float32),
            jnp.asarray(right[None], jnp.float32), iters=iters,
            test_mode=True)
    finally:
        jcorr_lookup._interpret_override = None
    return np.asarray(up)[0]


def _port_cfg(jcfg):
    return RaftStereoConfig.from_dict(dataclasses.asdict(jcfg))


@pytest.fixture(scope="module")
def jax_pyramid(default_vars):
    """JAX's int8 pyramid of the default TINY path on the seeded pair (its
    own fnet, its own fp32 volume) against the port's: ``(codes, scales,
    flips, straddled)``: JAX's codes and scales, how many of the port's
    codes differ, and whether every such pair of level values, each in
    code units of its own side's scale, lies on the two sides of the
    rounding boundary between the codes."""
    jcfg = _jcfg(False, quant="int8")
    left, right = _images()
    x = 2 * (jnp.asarray(np.stack([left, right]), jnp.float32) / 255.0) - 1
    jvars = jcore.dequantize_variables(jcore.quantize_variables(default_vars))
    jf = JaxRAFTStereo(jcfg).apply(jvars, x, method=lambda m, b: m.fnet(b))
    jpyr = jcorr.build_corr_pyramid(jcorr.build_corr_volume(jf[:1], jf[1:]),
                                    4)
    jq, js = jcorr.quantize_pyramid(jpyr, jcfg)
    model = RAFTStereo(_port_cfg(jcfg)).eval()
    model.load_state_dict(core.quantize_state_dict(
        state_dict_from_jax(default_vars)))
    with torch.no_grad():
        tf = model.fnet(_t(x).permute(0, 3, 1, 2))
        tpyr = build_corr_pyramid(build_corr_volume(tf[:1], tf[1:]), 4)
        tq, ts = quantize_pyramid(tpyr, model.config)
    flips, straddled = 0, True
    for a, b, sj, st, vt, vj in zip(tq, jq, js, ts, tpyr, jpyr):
        a, b = a.numpy(), np.asarray(b)
        diff = a != b
        flips += int(diff.sum())
        # each value in code units of its own (dynamic) scale
        ut = vt.numpy()[diff] / float(st)
        uj = np.asarray(vj)[diff] / float(sj)
        boundary = np.minimum(a[diff], b[diff]) + 0.5
        straddled &= bool(np.all((np.minimum(ut, uj) <= boundary)
                                 & (boundary <= np.maximum(ut, uj))))
    return ([np.asarray(q) for q in jq], [float(x) for x in js], flips,
            straddled)


@pytest.mark.parametrize("iters", [1, 2])
def test_default_int8_matches_jax(default_vars, jax_pyramid, monkeypatch,
                                  iters):
    """Default config, ``quant="int8"``: fp32 encoders on dequantized
    weights, the int8 ``reg_fused`` pyramid.  The port's pyramid codes
    may differ from JAX's only where the two frameworks' level values
    (fnet and the volume sum in another order; the dynamic scales differ
    by an ulp) lie on the two sides of a rounding boundary: on the seeded
    pair 2 of the 17,280 codes do (29.49998 vs 29.50005 and 71.50003 vs
    71.49992 in code units; the levels differ by up to 18 fp32 ulps of
    their largest value).  A flipped code moves the
    lookup by a whole code step (the flow by up to 0.066 px here), so the
    whole forward is held to the fp32 port's 2e-3 px with JAX's codes and
    scales in the port's pyramid."""
    codes, scales, flips, straddled = jax_pyramid
    assert straddled and flips <= 4, flips
    from raft_stereo_tpu_torch.models import corr as tcorr

    def jax_codes(pyramid, cfg):
        return ([torch.from_numpy(c.copy()) for c in codes],
                [torch.tensor(np.float32(sc)) for sc in scales])

    monkeypatch.setattr(tcorr, "quantize_pyramid", jax_codes)
    jcfg = _jcfg(False, quant="int8")
    left, right = _images()
    want = _jax_flow(jcfg, jcore.quantize_variables(default_vars), left,
                     right, iters, kernels=True)
    got, _ = InferenceRunner(_port_cfg(_jcfg(False)),
                             state_dict_from_jax(default_vars), iters=iters,
                             device="cpu", quant="int8")(left, right)
    assert got.shape == HW and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=FLOW_ATOL, rtol=0)


def test_default_int8_mxu_runs_fnet_per_image_as_jax(default_vars):
    """The default TINY architecture under ``quant="int8_mxu"`` with
    dynamic scales and ``sequential_fnet_pixels`` below the input's H*W:
    JAX's gate sends fnet one image at a time, so each of its int8 convs
    takes one input scale per image.  The port's forward must take the
    same route: for each image, fnet's second int8 conv (the first whose
    input max-abs differs between the two images) gives JAX's per-image
    output to 1e-6 of its scale (bit-equal int32 accumulators, the same
    fp32 rescale: 0 measured).  On the batched route the pair shares one
    scale, and 0.8% of these outputs move, by up to 8e-3.
    Deeper layers are not compared: from there on a code flips where the
    two frameworks' fp32 instance norms straddle a rounding boundary, and
    instance norm spreads each flip (fnet's output differs from JAX's by
    4e-2 of its scale on either route)."""
    from raft_stereo_tpu.models import raft_stereo as jraft
    left, right = _images()
    jcfg = _jcfg(False, quant="int8_mxu",
                 sequential_fnet_pixels=HW[0] * HW[1] // 2)
    assert jraft.sequential_fnet_threshold(jcfg) <= HW[0] * HW[1]
    jq = jcore.quantize_variables(default_vars)
    x = 2 * (jnp.asarray(np.stack([left, right]), jnp.float32) / 255.0) - 1
    want = []
    for img in (x[:1], x[1:]):
        _, inter = JaxRAFTStereo(jcfg).apply(
            jq, img, method=lambda m, b: m.fnet(b),
            capture_intermediates=True, mutable=["intermediates"])
        conv = inter["intermediates"]["fnet"]["trunk"]["layer1_0"]["conv1"]
        want.append(np.asarray(conv["__call__"][0]))
    runner = InferenceRunner(_port_cfg(jcfg), state_dict_from_jax(
        default_vars), iters=1, device="cpu", quant="int8_mxu")
    got = []
    runner.model.fnet.trunk.layer1_0.conv1.register_forward_hook(
        lambda m, i, o: got.append(o.permute(0, 2, 3, 1).float().numpy()))
    flow, _ = runner(left, right)
    assert np.isfinite(flow).all()
    for g, w in zip(np.concatenate(got), np.concatenate(want)):
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=1e-6 * np.abs(w).max())
    assert len(got) == 2, "fnet must run once per image"


@pytest.mark.parametrize("q,iters", [("int8", 1), ("int8", 2),
                                     ("fp8", 1), ("fp8", 2)])
def test_realtime_int8_mxu_matches_jax(realtime_vars, q, iters):
    """The realtime preset under ``quant="int8_mxu"``: int8 x int8 -> int32
    encoder convs, bf16 elsewhere, kernel #9 over int8 or fp8 features.
    bf16 on random weights moves flows by pixels, so the port is held to
    3x the JAX package's own spread between its kernel path (interpret)
    and its XLA fallback (which quantizes fp32 features), max and mean."""
    jcfg = _jcfg(True, quant="int8_mxu", quant_corr_fp8=(q == "fp8"))
    left, right = _images()
    jq = jcore.quantize_variables(realtime_vars)
    kernel = _jax_flow(jcfg, jq, left, right, iters, kernels=True)
    plain = _jax_flow(jcfg, jq, left, right, iters, kernels=False)
    runner = InferenceRunner(_port_cfg(_jcfg(True, quant_corr_fp8=(
        q == "fp8"))), state_dict_from_jax(realtime_vars), iters=iters,
        device="cpu", quant="int8_mxu")
    assert runner.effective_config.quant == "int8_mxu"
    got, _ = runner(left, right)
    assert np.isfinite(got).all()
    spread, err = np.abs(kernel - plain), np.abs(got - kernel)
    assert err.max() <= SPREAD_FACTOR * spread.max(), (err.max(),
                                                       spread.max())
    assert err.mean() <= SPREAD_FACTOR * spread.mean(), (err.mean(),
                                                         spread.mean())


@pytest.fixture(scope="module")
def realtime_record(realtime_vars):
    """The port's calibration of the realtime preset (bf16) on the seeded
    pair."""
    cfg = _port_cfg(_jcfg(True))
    return cal.calibrate(cfg, state_dict_from_jax(realtime_vars),
                         [_images(4)], device="cpu")


def test_realtime_int8_mxu_calibrated_matches_jax(realtime_vars,
                                                  realtime_record):
    """``int8_mxu`` with ``quant_act_scales`` from a calibration record:
    every calibrated encoder conv quantizes its input with its static
    scale (``context_zqr_conv*`` stay dynamic), held to 3x JAX's own
    kernel-vs-fallback spread as above, at iters 2."""
    scales = cal.conv_input_scales(realtime_record)
    assert len(scales) == 35 and not any(
        p.startswith("context_zqr") for p in scales)
    jcfg = _jcfg(True, quant="int8_mxu")
    left, right = _images()
    jq = jcore.quantize_variables(realtime_vars, act_scales=scales)
    kernel = _jax_flow(jcfg, jq, left, right, 2, kernels=True)
    plain = _jax_flow(jcfg, jq, left, right, 2, kernels=False)
    runner = InferenceRunner(_port_cfg(_jcfg(True)),
                             state_dict_from_jax(realtime_vars), iters=2,
                             device="cpu", quant="int8_mxu",
                             quant_act_scales=scales)
    packs = {n: m for n, m in runner.model.named_modules()
             if isinstance(m, Conv2d) and m.quant != "off"}
    assert sum(m.ascale is not None for m in packs.values()) == 35
    got, _ = runner(left, right)
    spread, err = np.abs(kernel - plain), np.abs(got - kernel)
    assert err.max() <= SPREAD_FACTOR * spread.max(), (err.max(),
                                                       spread.max())
    assert err.mean() <= SPREAD_FACTOR * spread.mean(), (err.mean(),
                                                         spread.mean())


def test_int8_mxu_convs_run_the_int8_gemm(realtime_vars, monkeypatch):
    """Under ``int8_mxu`` every call of an encoder conv runs the int8 conv
    (one ``int8_conv_int32`` each) and none dequantizes its weights; the
    update block's convs keep fp weights and are not touched.  A state
    dict quantized beforehand runs as it is, bit for bit the same."""
    from raft_stereo_tpu_torch.quant import matmul
    calls = {"int8": 0, "dequant": 0, "encoder": 0, "other": 0}
    real_int8, real_deq = matmul.int8_conv_int32, extractor.dequantize_array

    def count(key, fn):
        def wrapped(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(matmul, "int8_conv_int32", count("int8", real_int8))
    monkeypatch.setattr(extractor, "dequantize_array",
                        count("dequant", real_deq))
    state = state_dict_from_jax(realtime_vars)
    cfg = _port_cfg(_jcfg(True))
    runner = InferenceRunner(cfg, state, iters=2, device="cpu",
                             quant="int8_mxu")
    for name, m in runner.model.named_modules():
        if isinstance(m, Conv2d):
            assert (m.quant == "int8_mxu") == core.in_encoder_scope(name)
            key = "encoder" if m.quant != "off" else "other"
            m.register_forward_hook(
                lambda *_, key=key: calls.__setitem__(key, calls[key] + 1))
            if m.quant == "off":
                assert m.weight.dtype == torch.bfloat16
            else:
                assert m.q8.dtype == torch.int8 and not hasattr(m, "weight")
    left, right = _images()
    flow, _ = runner(left, right)
    assert calls["encoder"] > 0 and calls["int8"] == calls["encoder"]
    assert calls["dequant"] == 0 and calls["other"] > 0
    again, _ = InferenceRunner(cfg, core.quantize_state_dict(state),
                               iters=2, device="cpu",
                               quant="int8_mxu")(left, right)
    np.testing.assert_array_equal(flow, again)


def test_quant_off_runner_is_unchanged(default_vars):
    """``quant="off"`` (and the default None) runs the unquantized model:
    no packs, and the same flow bit for bit."""
    cfg = _port_cfg(_jcfg(False))
    state = state_dict_from_jax(default_vars)
    left, right = _images()
    base = InferenceRunner(cfg, state, iters=1, device="cpu")
    off = InferenceRunner(cfg, state, iters=1, device="cpu", quant="off")
    assert not any(k.endswith(".q8") for k in off.model.state_dict())
    np.testing.assert_array_equal(base(left, right)[0], off(left, right)[0])


@pytest.mark.parametrize("realtime", [False, True])
def test_calibration_matches_jax(default_vars, realtime_vars, tmp_path,
                                 realtime):
    """The port's record against JAX's ``calibrate`` on the same weights
    and pair, in fp32 (the default config, and the realtime architecture
    with ``mixed_precision`` off): the same key sets; every
    ``corr_levels``, ``features`` and ``qin`` value within 1e-5 relative
    (the convs sum in another order), and the scales derived from them.
    A JAX-written scale file loads into the port and gives JAX's scales;
    two calibrations of the port write byte-identical files."""
    jcfg = _jcfg(realtime, mixed_precision=False)
    v = realtime_vars if realtime else default_vars
    pair = _images(4)
    want = jcal.calibrate(jcfg, v, [pair])
    got = cal.calibrate(_port_cfg(jcfg), state_dict_from_jax(v), [pair],
                        device="cpu")
    assert set(got) == set(want)
    assert set(got["activations"]) == set(want["activations"])
    assert len(got["activations"]) == (115 if realtime else 182)
    np.testing.assert_allclose(got["corr_levels"], want["corr_levels"],
                               rtol=1e-5)
    np.testing.assert_allclose(got["features"]["fmap1"],
                               want["features"]["fmap1"], rtol=1e-5)
    np.testing.assert_allclose(got["features"]["fmap2_levels"],
                               want["features"]["fmap2_levels"], rtol=1e-5)
    qin = sorted(k for k in want["activations"] if k.endswith("/qin"))
    np.testing.assert_allclose(
        [got["activations"][k]["absmax_clipped"] for k in qin],
        [want["activations"][k]["absmax_clipped"] for k in qin], rtol=1e-5)
    gs, ws = cal.conv_input_scales(got), jcal.conv_input_scales(want)
    assert set(gs) == set(ws)
    np.testing.assert_allclose([gs[k] for k in sorted(ws)],
                               [ws[k] for k in sorted(ws)], rtol=1e-5)
    np.testing.assert_allclose(cal.corr_scales(got), jcal.corr_scales(want),
                               rtol=1e-5)
    jpath = jcal.save_scales(str(tmp_path / "jax.json"), want)
    loaded = cal.load_scales(jpath)
    assert cal.conv_input_scales(loaded) == jcal.conv_input_scales(want)
    assert cal.corr_scales(loaded) == jcal.corr_scales(want)
    if not realtime:
        return
    again = cal.calibrate(_port_cfg(jcfg), state_dict_from_jax(v), [pair],
                          device="cpu")
    a = cal.save_scales(str(tmp_path / "a.json"), got)
    b = cal.save_scales(str(tmp_path / "b.json"), again)
    assert open(a, "rb").read() == open(b, "rb").read()
    assert json.load(open(a))["version"] == cal.SCALES_VERSION
