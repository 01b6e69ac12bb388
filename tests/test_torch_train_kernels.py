"""The port's backward kernels and the gate Function against the JAX
package's custom VJPs (CPU).

On the CPU each port wrapper runs its plain version, forward and
backward, through the same ``torch.autograd.Function`` that launches the
CUDA kernels on the card.  The JAX VJPs run their Pallas backward kernels
in interpret mode (#3 ``_bwd_kernel``, #4 ``_bwd_kernel_multi``, #8
``corr_alt._bwd_kernel``), as the JAX package's own kernel tests run
them.  tests/test_torch_cuda.py holds the CUDA kernels to the plain
versions on the card.  Each JAX-side value is computed once per module.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_stereo_tpu.kernels import corr_alt as jcorr_alt
from raft_stereo_tpu.kernels import corr_lookup as jcorr_lookup
from raft_stereo_tpu.kernels import gru_fused as jgru_fused
from raft_stereo_tpu.models.corr import pool_axis as jax_pool_axis
from raft_stereo_tpu_torch.kernels.corr_alt import (alt_lookup_bwd_fused,
                                                    alt_lookup_fused)
from raft_stereo_tpu_torch.kernels.corr_lookup import (
    lookup_pyramid_bwd_fused, lookup_pyramid_fused, lookup_pyramid_xla)
from raft_stereo_tpu_torch.kernels.gru_fused import gru_gates_fused
from torch_port_support import assert_bf16_close

RADIUS = 4
K = 2 * RADIUS + 1
DTYPES = {"fp32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
# Level widths odd and not multiples of the JAX kernels' 128-wide W1 block;
# centers spread past both ends of the widest level.
ROWS, W1, W2S = 3, 37, (43, 21, 10, 5)


def _to_torch(a, dtype=torch.float32):
    return torch.from_numpy(np.array(jnp.asarray(a).astype(jnp.float32))
                            ).to(dtype)


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _interpret(fn, *args):
    jcorr_lookup._interpret_override = True
    try:
        return fn(*args)
    finally:
        jcorr_lookup._interpret_override = None


def _vjp(fn, primals, cotangent):
    """``jax.vjp(fn, *primals)`` applied to ``cotangent``, jitted (several
    times faster than eager interpret mode) with the Pallas kernels in
    interpret mode."""
    return _interpret(jax.jit(lambda p, c: jax.vjp(fn, *p)[1](c)),
                      tuple(primals), cotangent)


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads: the suite runs several workers on one host."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _assert_rel_close(got, want, rtol):
    """|got - want| <= rtol * max|want|: tolerance relative to the
    gradient's scale (a gradient is a sum of products of varied sign)."""
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, (err, scale)


@pytest.fixture(scope="module")
def lookup_case():
    """Seeded volumes, centers and output gradient, and the JAX VJPs:
    #4 (all levels, one launch) in fp32 and bf16, and #3 (level 2 alone
    at scale 1/4) in fp32."""
    rs = np.random.default_rng(11)
    vols = [rs.normal(size=(1, ROWS, W1, w)).astype(np.float32) for w in W2S]
    coords = rs.uniform(-10, W2S[0] + 10, size=(1, ROWS, W1)).astype(
        np.float32)
    g = rs.normal(size=(1, ROWS, W1, len(W2S) * K)).astype(np.float32)
    jc = jnp.asarray(coords)
    want = {}
    for tag, (jdt, _) in DTYPES.items():
        jvols = tuple(jnp.asarray(v).astype(jdt) for v in vols)
        jg = jnp.asarray(g).astype(jdt)
        want[tag, "multi"] = _vjp(
            lambda vs: jcorr_lookup._sample_pyramid(vs, jc, RADIUS),
            [jvols], jg)[0]
    want["fp32", 2] = _vjp(
        lambda v: jcorr_lookup._sample_level(v, jc, RADIUS, 0.25),
        [jnp.asarray(vols[2])], jnp.asarray(g[..., 2 * K:3 * K]))[0]
    return vols, coords, g, want


def _position_atol(coords, g):
    """The fp32 bound of a lookup gradient against the JAX kernel.

    A bin sums at most two products t*g (or (1-t)*g).  The JAX kernel
    builds its hat weights from ``j - r - c``, which is exact where the
    weight is not zero; the port forms the tap position ``x = c + k - r``
    in fp32, as its forward kernel and plain version do, so its ``t``
    carries the rounding of x: half an ulp of |x|, and ``1 - t`` rounds
    once more.  Two products: (ulp(max|x|) + 2^-23) * max|g|, which is
    7.7e-6 * max|g| for the positions of up to 57 px here (the 1e-6 a
    position below 8 px would allow does not hold at these centers)."""
    xmax = float(np.abs(coords).max()) + RADIUS
    ulp = float(np.spacing(np.float32(xmax)))
    return (ulp + 2.0 ** -23) * float(np.abs(g).max())


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_lookup_backward_matches_jax_multi(lookup_case, dtype):
    """Kernel #4: every level's volume gradient in one call.  fp32 within
    ``_position_atol``; bf16 within one bf16 ulp plus that (both sum in
    fp32 and round once)."""
    vols, coords, g, want = lookup_case
    atol = _position_atol(coords, g)
    _, tdt = DTYPES[dtype]
    before = lookup_pyramid_bwd_fused.launches
    got = lookup_pyramid_bwd_fused(
        torch.from_numpy(g).to(tdt), torch.from_numpy(coords), W2S, RADIUS,
        tdt)
    assert lookup_pyramid_bwd_fused.launches == before  # CPU: plain version
    assert len(got) == len(W2S)
    for gv, wv in zip(got, want[dtype, "multi"]):
        assert gv.dtype == tdt and tuple(gv.shape) == wv.shape
        if dtype == "fp32":
            np.testing.assert_allclose(gv.numpy(), np.asarray(wv), atol=atol,
                                       rtol=0)
        else:
            assert_bf16_close(gv, _f32(wv), atol=atol)


def test_lookup_backward_matches_jax_one_level(lookup_case):
    """Kernel #3: one level at scale 1/2^l, as a one-level call at
    ``coords / 2^l``."""
    vols, coords, g, want = lookup_case
    level = 2
    gl = g[..., level * K:(level + 1) * K]
    got, = lookup_pyramid_bwd_fused(
        torch.from_numpy(gl), torch.from_numpy(coords) / 2 ** level,
        [W2S[level]], RADIUS, torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want["fp32", level]),
                               atol=_position_atol(coords / 2 ** level, gl),
                               rtol=0)


def test_lookup_function_backward_is_autograd_of_plain(lookup_case):
    """The Function's backward (plain on the CPU) equals torch.autograd
    through the plain forward, and the centers get no gradient."""
    vols, coords, g, _ = lookup_case
    leaves = [torch.from_numpy(v).requires_grad_() for v in vols]
    c = torch.from_numpy(coords).requires_grad_()
    out = lookup_pyramid_fused(leaves, c, RADIUS)
    assert out.grad_fn is not None
    *got, dc = torch.autograd.grad(out, leaves + [c], torch.from_numpy(g),
                                   allow_unused=True)
    assert dc is None
    plain = [torch.from_numpy(v).requires_grad_() for v in vols]
    want = torch.autograd.grad(
        lookup_pyramid_xla(plain, torch.from_numpy(coords), RADIUS), plain,
        torch.from_numpy(g))
    for gv, wv in zip(got, want):
        torch.testing.assert_close(gv, wv, atol=0, rtol=0)


def _alt_inputs(jdt, d=32):
    rs = np.random.default_rng(12)
    f1 = jnp.asarray(rs.normal(size=(1, ROWS, W1, d)).astype(np.float32)
                     ).astype(jdt)
    f2 = jnp.asarray(rs.normal(size=(1, ROWS, W2S[0], d)).astype(np.float32)
                     ).astype(jdt)
    pyramid = [f2]
    for _ in range(len(W2S) - 1):
        pyramid.append(jax_pool_axis(pyramid[-1], axis=2))
    coords = rs.uniform(-10, W2S[0] + 10, size=(1, ROWS, W1)).astype(
        np.float32)
    g = jnp.asarray(rs.normal(size=(1, ROWS, W1, len(W2S) * K)).astype(
        np.float32)).astype(jdt)
    return f1, pyramid, coords, g


@pytest.fixture(scope="module")
def alt_case():
    """Per dtype: inputs, the JAX VJP of the multi-level lookup (#6
    forward, #8 backward once per level) and, in fp32, of level 2 alone
    (#8)."""
    out = {}
    for tag, (jdt, _) in DTYPES.items():
        f1, pyramid, coords, g = _alt_inputs(jdt)
        w2s = [p.shape[2] for p in pyramid]
        assert w2s == list(W2S)
        assert (jcorr_alt._multi_alt_scoped_bytes(w2s, 32, f1.dtype.itemsize,
                                                  RADIUS)
                <= jcorr_alt._MOSAIC_SCOPED_VMEM)
        jc = jnp.asarray(coords)
        multi = _vjp(lambda a, p: jcorr_alt.alt_lookup_fused(a, p, jc,
                                                             RADIUS),
                     [f1, pyramid], g)
        one = None
        if tag == "fp32":
            one = _vjp(lambda a, b: jcorr_alt._alt_level(a, b, jc, RADIUS,
                                                         0.25),
                       [f1, pyramid[2]], g[..., 2 * K:3 * K])
        out[tag] = (f1, pyramid, coords, g, multi, one)
    return out


def _port_alt_grads(case, tdt, level=None):
    f1, pyramid, coords, g, _, _ = case
    if level is None:
        return alt_lookup_bwd_fused(
            _to_torch(f1, tdt), [_to_torch(p, tdt) for p in pyramid],
            torch.from_numpy(coords), _to_torch(g, tdt), RADIUS)
    df1, (df2,) = alt_lookup_bwd_fused(
        _to_torch(f1, tdt), [_to_torch(pyramid[level], tdt)],
        torch.from_numpy(coords) / 2 ** level,
        _to_torch(g[..., level * K:(level + 1) * K], tdt), RADIUS)
    return df1, [df2]


def test_alt_backward_fp32_matches_jax(alt_case):
    """Kernel #8 in fp32, all levels (the JAX multi-level VJP runs the
    backward kernel once per level) and level 2 alone at 1/4: within 1e-5
    of each gradient's scale (dots of up to W1 products in another
    order)."""
    case = alt_case["fp32"]
    before = alt_lookup_bwd_fused.launches
    df1, df2 = _port_alt_grads(case, torch.float32)
    assert alt_lookup_bwd_fused.launches == before  # CPU: plain version
    want_df1, want_df2 = case[4]
    _assert_rel_close(df1, want_df1, 1e-5)
    for got, want in zip(df2, want_df2):
        assert got.dtype == torch.float32
        _assert_rel_close(got, want, 1e-5)
    df1, (df2,) = _port_alt_grads(case, torch.float32, level=2)
    _assert_rel_close(df1, case[5][0], 1e-5)
    _assert_rel_close(df2, case[5][1], 1e-5)


# The JAX VJP rounds each level's df1 to bf16 and sums the four in bf16
# (_alt_multi_bwd); the port sums them in fp32 and rounds once.  Each of
# the JAX side's 4 roundings of a level gradient and 3 rounded adds is at
# most half a bf16 ulp of a value no larger than the gradient's scale:
# 3.5 ulps of the scale, so the bound is 4 bf16 ulps of max |df1|.  df2
# rounds once on both sides: one ulp of each value.
ALT_BF16_DF1_ULPS = 4


def test_alt_backward_bf16_matches_jax(alt_case):
    case = alt_case["bf16"]
    df1, df2 = _port_alt_grads(case, torch.bfloat16)
    want_df1, want_df2 = case[4]
    assert df1.dtype == torch.bfloat16 and want_df1.dtype == jnp.bfloat16
    _assert_rel_close(df1, want_df1, ALT_BF16_DF1_ULPS * 2.0 ** -8)
    for got, want in zip(df2, want_df2):
        assert got.dtype == torch.bfloat16
        assert_bf16_close(got, _f32(want))


def test_alt_function_gradients(alt_case):
    """``alt_lookup_fused`` is differentiable in the features and not in
    the centers; its gradients are the backward wrapper's."""
    f1, pyramid, coords, g, _, _ = alt_case["fp32"]
    a = _to_torch(f1).requires_grad_()
    levels = [_to_torch(p).requires_grad_() for p in pyramid]
    c = torch.from_numpy(coords).requires_grad_()
    out = alt_lookup_fused(a, levels, c, RADIUS)
    assert out.grad_fn is not None
    da, *dl, dc = torch.autograd.grad(out, [a] + levels + [c], _to_torch(g),
                                      allow_unused=True)
    assert dc is None
    want_df1, want_df2 = _port_alt_grads(alt_case["fp32"], torch.float32)
    torch.testing.assert_close(da, want_df1, atol=0, rtol=0)
    for got, want in zip(dl, want_df2):
        torch.testing.assert_close(got, want, atol=0, rtol=0)


def _gates_inputs(seed, h, w, ch, cx, jdt):
    rs = np.random.default_rng(seed)

    def arr(*shape, scale=1.0):
        return (scale * rs.normal(size=shape)).astype(np.float32)

    cin = ch + cx
    ws = (2 / (9 * cin)) ** 0.5
    args = [arr(1, h, w, ch), arr(1, h, w, cx), arr(1, h, w, ch),
            arr(3, 3, cin, 2 * ch, scale=ws), arr(2 * ch, scale=0.1),
            arr(3, 3, cin, ch, scale=ws), arr(ch, scale=0.1)]
    grads = [arr(1, h, w, 2 * ch), arr(1, h, w, ch)]
    jargs = [jnp.asarray(a) for a in args]
    for i in range(3):   # activations in the compute dtype, weights fp32
        jargs[i] = jargs[i].astype(jdt)
    return jargs, [jnp.asarray(g).astype(jdt) for g in grads]


# Cin 384 (gru08, gru16 of the default: Ch 128 + 256) and Cin 256 (gru32;
# gru16 of the realtime preset).
GATE_SHAPES = {"cin384": (5, 9, 128, 256), "cin256": (4, 7, 128, 128)}


@pytest.fixture(scope="module")
def gates_case():
    """Per shape and dtype: the inputs, output gradients and the JAX
    gradients.  ``jax.vjp(gru_gates_fused)`` runs the forward kernel in
    interpret mode and then the op's VJP rule ``_gates_bwd`` (the plain
    twin's VJP); the gradients are that rule's, called directly except in
    the bf16 Cin-384 case, which goes through ``jax.vjp`` and checks that
    the two agree bit for bit (interpret mode is slow; the forward kernel
    itself is held in tests/test_torch_kernels.py)."""
    out = {}
    for i, (shape_tag, shape) in enumerate(sorted(GATE_SHAPES.items())):
        for tag, (jdt, _) in DTYPES.items():
            jargs, jgrads = _gates_inputs(i, *shape, jdt)
            want = jax.jit(jgru_fused._gates_bwd)(tuple(jargs),
                                                  tuple(jgrads))
            if (shape_tag, tag) == ("cin384", "bf16"):
                for a, b in zip(_vjp(jgru_fused.gru_gates_fused, jargs,
                                     tuple(jgrads)), want):
                    np.testing.assert_array_equal(_f32(a), _f32(b))
            out[shape_tag, tag] = (jargs, jgrads, want)
    return out


@pytest.mark.parametrize("shape", sorted(GATE_SHAPES))
def test_gates_function_fp32_matches_jax_vjp(gates_case, shape):
    """fp32: every input's gradient within 1e-5 of its scale (the twin's
    conv backward in another summation order)."""
    jargs, jgrads, want = gates_case[shape, "fp32"]
    args = [_to_torch(a).requires_grad_() for a in jargs]
    outs = gru_gates_fused(*args)
    assert all(o.grad_fn is not None for o in outs)
    got = torch.autograd.grad(outs, args, [_to_torch(g) for g in jgrads])
    for gv, wv in zip(got, want):
        assert tuple(gv.shape) == wv.shape
        _assert_rel_close(gv, wv, 1e-5)


# bf16: both sides linearise the same bf16 twin (convs rounded, then the
# bias add rounded); the backward's bf16 convs sum in another order and
# round once, and each gradient passes through two or three rounded ops
# (the sigmoid's derivative, r*h, the concatenated conv input).  Measured
# within 3.8 bf16 ulps of each gradient's scale on these inputs (the bias
# gradients, sums over every pixel, are the largest); the bound is 8 bf16
# ulps of the scale.
GATES_BF16_ULPS = 8


@pytest.mark.parametrize("shape", sorted(GATE_SHAPES))
def test_gates_function_bf16_matches_jax_vjp(gates_case, shape):
    jargs, jgrads, want = gates_case[shape, "bf16"]
    args = [_to_torch(a, torch.bfloat16 if i < 3 else torch.float32)
            .requires_grad_() for i, a in enumerate(jargs)]
    outs = gru_gates_fused(*args)
    assert all(o.dtype == torch.bfloat16 for o in outs)
    got = torch.autograd.grad(outs, args, [_to_torch(g, torch.bfloat16)
                                           for g in jgrads])
    for gv, wv, a in zip(got, want, args):
        assert gv.dtype == a.dtype and tuple(gv.shape) == wv.shape
        _assert_rel_close(gv, wv, GATES_BF16_ULPS * 2.0 ** -8)
