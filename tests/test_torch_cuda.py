"""The port's CUDA kernels against their plain versions, on the card:
forward and backward kernels, gradients through every wrapper, one
training step against the same step on the CPU, and the quantized tier
(the 1-byte lookup and alt kernels, the int8 GEMM conv, one TINY
quantized forward against the CPU).

Every test here needs a CUDA device and skips without one.  The file
imports nothing of JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

(``--noconftest`` skips tests/conftest.py, which sets up JAX.)
"""

import numpy as np
import pytest
import torch

from raft_stereo_tpu_torch.config import RaftStereoConfig
from raft_stereo_tpu_torch.eval.runner import InferenceRunner, full_fp32
from raft_stereo_tpu_torch.config import TrainConfig
from raft_stereo_tpu_torch.data.synthetic import SyntheticStereoLoader
from raft_stereo_tpu_torch.kernels.corr_alt import (alt_lookup_bwd_fused,
                                                    alt_lookup_bwd_xla,
                                                    alt_lookup_fused,
                                                    alt_lookup_fused_q,
                                                    alt_lookup_xla)
from raft_stereo_tpu_torch.kernels.corr_lookup import (
    lookup_pyramid_bwd_fused, lookup_pyramid_bwd_xla, lookup_pyramid_fused,
    lookup_pyramid_fused_q, lookup_pyramid_xla)
from raft_stereo_tpu_torch.kernels.gru_fused import (_gates_reference,
                                                     gru_gates_fused)
from raft_stereo_tpu_torch.models.corr import build_corr_pyramid, pool_axis
from raft_stereo_tpu_torch.models.raft_stereo import RAFTStereo
from raft_stereo_tpu_torch.training.state import create_train_state
from raft_stereo_tpu_torch.training.step import train_step
from raft_stereo_tpu_torch.quant.matmul import int8_conv_int32
from torch_port_support import assert_bf16_close

pytestmark = pytest.mark.cuda
RADIUS = 4
TINY = dict(hidden_dims=(32, 32, 32), fnet_dim=64)


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    full_fp32()
    return torch.device("cuda")


@pytest.mark.parametrize("rows,w1,w2,levels", [(8, 96, 312, 4),
                                               (3, 40, 40, 1),
                                               (2, 13, 7, 3)])
def test_lookup_kernel_matches_plain(rng, cuda_device, rows, w1, w2, levels):
    vol = rng.normal(size=(1, rows, w1, w2)).astype(np.float32)
    coords = rng.uniform(-10, w2 + 10, size=(1, rows, w1)).astype(np.float32)
    pyr = build_corr_pyramid(torch.from_numpy(vol).to(cuda_device), levels)
    c = torch.from_numpy(coords).to(cuda_device)
    before = lookup_pyramid_fused.launches
    got = lookup_pyramid_fused(pyr, c, RADIUS)
    torch.cuda.synchronize()
    assert lookup_pyramid_fused.launches == before + 1
    torch.testing.assert_close(got, lookup_pyramid_xla(pyr, c, RADIUS),
                               atol=1e-5, rtol=0)


def test_lookup_kernel_bf16_matches_plain(rng, cuda_device):
    vol = torch.from_numpy(rng.normal(size=(1, 8, 96, 312)).astype(
        np.float32)).to(cuda_device, torch.bfloat16)
    pyr = build_corr_pyramid(vol, 4)
    c = torch.from_numpy(rng.uniform(-10, 322, size=(1, 8, 96)).astype(
        np.float32)).to(cuda_device)
    got = lookup_pyramid_fused(pyr, c, RADIUS)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16
    assert_bf16_close(got, lookup_pyramid_xla(pyr, c, RADIUS))


def test_lookup_kernel_rejects_other_dtypes(cuda_device):
    vol = torch.zeros((1, 2, 8, 8), device=cuda_device, dtype=torch.float16)
    with pytest.raises(TypeError):
        lookup_pyramid_fused([vol], torch.zeros((1, 2, 8), device=cuda_device),
                             RADIUS)


@pytest.mark.parametrize("h,w,ch,cx", [(24, 78, 128, 128),
                                       (17, 35, 32, 160),
                                       (9, 20, 128, 256)])
def test_gates_kernel_matches_plain(rng, cuda_device, h, w, ch, cx):
    cin = ch + cx

    def arr(*shape, scale=1.0):
        return torch.from_numpy((scale * rng.normal(size=shape)).astype(
            np.float32)).to(cuda_device)

    ws = (2 / (9 * cin)) ** 0.5
    args = (arr(2, h, w, ch), arr(2, h, w, cx), arr(2, h, w, ch),
            arr(3, 3, cin, 2 * ch, scale=ws), arr(2 * ch, scale=0.1),
            arr(3, 3, cin, ch, scale=ws), arr(ch, scale=0.1))
    before = gru_gates_fused.launches
    got = gru_gates_fused(*args)
    torch.cuda.synchronize()
    assert gru_gates_fused.launches == before + 1
    # sums over 9*Cin products in another order than cuDNN's: atol 1e-4
    for g, want in zip(got, _gates_reference(*args)):
        torch.testing.assert_close(g, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,w1,w2,d,levels", [(8, 156, 156, 256, 4),
                                                 (3, 24, 37, 64, 4),
                                                 (2, 13, 7, 8, 1)])
def test_alt_kernel_matches_plain(rng, cuda_device, dtype, rows, w1, w2, d,
                                  levels):
    def arr(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(
            np.float32)).to(cuda_device, dtype)

    f1 = arr(1, rows, w1, d)
    pyr = [arr(1, rows, w2, d)]
    for _ in range(levels - 1):
        pyr.append(pool_axis(pyr[-1], axis=2).contiguous())
    c = torch.from_numpy(rng.uniform(-10, w2 + 10, size=(1, rows, w1)).astype(
        np.float32)).to(cuda_device)
    before = alt_lookup_fused.launches
    got = alt_lookup_fused(f1, pyr, c, RADIUS)
    torch.cuda.synchronize()
    assert alt_lookup_fused.launches == before + 1
    assert got.dtype == dtype
    want = alt_lookup_xla(f1, pyr, c, RADIUS)
    if dtype == torch.float32:   # dots of length D in another order
        torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    else:
        assert_bf16_close(got, want)


@pytest.mark.parametrize("h,w,cx", [(24, 78, 128), (17, 35, 256)])
def test_gates_kernel_bf16_matches_plain(rng, cuda_device, h, w, cx):
    ch, cin = 128, 128 + cx

    def arr(*shape, scale=1.0, dtype=torch.bfloat16):
        return torch.from_numpy((scale * rng.normal(size=shape)).astype(
            np.float32)).to(cuda_device, dtype)

    ws = (2 / (9 * cin)) ** 0.5
    args = (arr(2, h, w, ch), arr(2, h, w, cx), arr(2, h, w, ch),
            arr(3, 3, cin, 2 * ch, scale=ws), arr(2 * ch, scale=0.1,
                                                 dtype=torch.float32),
            arr(3, 3, cin, ch, scale=ws), arr(ch, scale=0.1,
                                              dtype=torch.float32))
    got = gru_gates_fused(*args)
    torch.cuda.synchronize()
    # The plain version's rounding points, sums in another order: an
    # output may round to a neighbouring bf16 value, and where r*h rounds
    # to a neighbour, qpre moves by a weight times that ulp (up to ~5e-4
    # here): two bf16 ulps + 1e-3.
    for g, want in zip(got, _gates_reference(*args)):
        assert g.dtype == torch.bfloat16
        assert_bf16_close(g, want, ulps=2, atol=1e-3)


# The gate GEMMs of the driven paths (B, H, W, Ch, Cx): the default
# path's three levels of 384x1248 and one training gru08 call at batch 8
# (fp32), the realtime levels and training gru08 calls (bf16); and the
# odd and narrow shapes, the TINY configs' hidden_dims=(32, 32, 32) among
# them, in both types.
GATE_MAIN_FP32 = [(1, 96, 312, 128, 256), (1, 48, 156, 128, 256),
                  (1, 24, 78, 128, 128), (8, 80, 180, 128, 256)]
GATE_MAIN_BF16 = [(1, 48, 156, 128, 256), (1, 24, 78, 128, 128),
                  (8, 80, 180, 128, 256), (8, 40, 90, 128, 256)]
GATE_ODD = [(2, 17, 35, 32, 160), (2, 9, 20, 128, 256), (2, 24, 78, 128, 128),
            (2, 17, 35, 128, 256), (2, 16, 32, 32, 160), (2, 8, 16, 32, 64),
            (2, 4, 8, 32, 32)]


def _gate_args(rng, device, shape, dtype):
    b, h, w, ch, cx = shape
    cin = ch + cx

    def arr(*s, scale=1.0, dt=dtype):
        return torch.from_numpy((scale * rng.normal(size=s)).astype(
            np.float32)).to(device, dt)

    ws = (2 / (9 * cin)) ** 0.5
    return (torch.tanh(arr(b, h, w, ch)), arr(b, h, w, cx), arr(b, h, w, ch),
            arr(3, 3, cin, 2 * ch, scale=ws),
            arr(2 * ch, scale=0.1, dt=torch.float32),
            arr(3, 3, cin, ch, scale=ws), arr(ch, scale=0.1, dt=torch.float32))


@pytest.mark.parametrize(
    "dtype,shape", [(torch.float32, s) for s in GATE_MAIN_FP32 + GATE_ODD]
    + [(torch.bfloat16, s) for s in GATE_MAIN_BF16 + GATE_ODD])
def test_gates_kernel_matches_plain_at_path_shapes(rng, cuda_device, dtype,
                                                   shape):
    """The tensor-core gate kernel at every gate GEMM the driven paths
    launch and at the odd shapes: fp32 (3xTF32) within 1e-4 of the plain
    version (sums of up to 3,456 products in another order), bf16 within
    two ulps + 1e-3 (a flip of the bf16 r*h moves qpre by a weight times
    its ulp)."""
    args = _gate_args(rng, cuda_device, shape, dtype)
    before = gru_gates_fused.launches
    got = gru_gates_fused(*args)
    torch.cuda.synchronize()
    assert gru_gates_fused.launches == before + 1
    for g, want in zip(got, _gates_reference(*args)):
        assert g.dtype == dtype
        if dtype == torch.float32:
            torch.testing.assert_close(g, want, atol=1e-4, rtol=0)
        else:
            assert_bf16_close(g, want, ulps=2, atol=1e-3)


def _gates_fp64(h, x, cr, wzr, bzr, wq, bq):
    def conv(inp, k):
        return torch.nn.functional.conv2d(
            inp.permute(0, 3, 1, 2), k.permute(3, 2, 0, 1),
            padding=1).permute(0, 2, 3, 1)

    ch = h.shape[-1]
    h, x, cr = h.double(), x.double(), cr.double()
    zr = conv(torch.cat([h, x], -1), wzr.double()) + bzr.double()
    r = torch.sigmoid(zr[..., ch:] + cr)
    return zr, conv(torch.cat([r * h, x], -1), wq.double()) + bq.double()


@pytest.mark.parametrize("shape", GATE_MAIN_FP32[:3])
def test_fp32_gates_keep_fp32_accuracy(rng, cuda_device, shape):
    """3xTF32 against fp64: the kernel's largest error is at most 4x that
    of the plain fp32 version (cuDNN, TF32 off) plus 1e-6.  A single TF32
    pass lands ~100x above it at these sums of up to 3,456 products."""
    args = _gate_args(rng, cuda_device, shape, torch.float32)
    got = gru_gates_fused(*args)
    plain = _gates_reference(*args)
    ref = _gates_fp64(*args)
    d_k = max(float((g.double() - r).abs().max()) for g, r in zip(got, ref))
    d_p = max(float((p.double() - r).abs().max()) for p, r in zip(plain, ref))
    assert d_k <= 4 * d_p + 1e-6, (d_k, d_p)


def test_gate_weights_pack_once_on_card(rng, cuda_device):
    """Inference packs each weight once: later calls reuse the pack."""
    args = _gate_args(rng, cuda_device, (1, 9, 20, 32, 64), torch.bfloat16)
    gru_gates_fused(*args)
    packs = gru_gates_fused.packs
    for _ in range(3):
        gru_gates_fused(*args)
    assert gru_gates_fused.packs == packs


def test_tiny_realtime_card_matches_cpu(rng, cuda_device):
    """The realtime architecture in fp32 on the card and on the CPU, and
    the bf16 preset on the card through the alt and bf16 gate kernels."""
    torch.manual_seed(0)
    cfg = RaftStereoConfig(**{**RaftStereoConfig.realtime().to_dict(),
                              **TINY, "mixed_precision": False})
    state = RAFTStereo(cfg).state_dict()
    left = rng.integers(0, 256, (45, 70, 3), dtype=np.uint8)
    right = np.roll(left, -3, axis=1)
    cpu = InferenceRunner(cfg, state, iters=1, device="cpu")(left, right)[0]
    alts, gates = alt_lookup_fused.launches, gru_gates_fused.launches
    runner = InferenceRunner(cfg, state, iters=1)
    gpu = runner(left, right)[0]
    (graph,) = runner._compiled.values()
    assert graph.launches["alt"] == 1
    assert graph.launches["gates"] == 3   # gru16 twice, gru08
    # the first call runs the wrappers twice: the warm-up and the capture
    assert alt_lookup_fused.launches == alts + 2
    assert gru_gates_fused.launches == gates + 6
    np.testing.assert_allclose(gpu, cpu, atol=1e-3, rtol=0)
    bf16 = InferenceRunner(RaftStereoConfig(**{**cfg.to_dict(),
                                               "mixed_precision": True}),
                           state, iters=2)(left, right)[0]
    assert np.isfinite(bf16).all()


def test_tiny_model_card_matches_cpu(rng, cuda_device):
    torch.manual_seed(0)
    cfg = RaftStereoConfig(hidden_dims=(32, 32, 32), fnet_dim=64)
    state = RAFTStereo(cfg).state_dict()
    left = rng.integers(0, 256, (45, 70, 3), dtype=np.uint8)
    right = np.roll(left, -3, axis=1)
    cpu = InferenceRunner(cfg, state, iters=1, device="cpu")(left, right)[0]
    lookups = lookup_pyramid_fused.launches
    gates = gru_gates_fused.launches
    runner = InferenceRunner(cfg, state, iters=1)
    gpu = runner(left, right)[0]
    (graph,) = runner._compiled.values()
    assert graph.launches["lookup"] == 1 and graph.launches["gates"] == 3
    # the first call runs the wrappers twice: the warm-up and the capture
    assert lookup_pyramid_fused.launches == lookups + 2
    assert gru_gates_fused.launches == gates + 6
    # one iteration on random weights; cuDNN vs CPU conv summation order
    np.testing.assert_allclose(gpu, cpu, atol=1e-3, rtol=0)


def test_demo_cli_on_card(rng, cuda_device, tmp_path):
    from PIL import Image

    from raft_stereo_tpu_torch.cli import demo
    from raft_stereo_tpu_torch.io.jax_weights import save_checkpoint

    torch.manual_seed(0)
    cfg = RaftStereoConfig(hidden_dims=(32, 32, 32), fnet_dim=64)
    state = RAFTStereo(cfg).state_dict()
    save_checkpoint(str(tmp_path / "ckpt"), cfg, state)
    left = rng.integers(0, 256, (40, 60, 3), dtype=np.uint8)
    right = np.roll(left, -3, axis=1)
    Image.fromarray(left).save(tmp_path / "im0.png")
    Image.fromarray(right).save(tmp_path / "im1.png")
    out = tmp_path / "out"
    gates = gru_gates_fused.launches
    demo.main(["--restore_ckpt", str(tmp_path / "ckpt"),
               "-l", str(tmp_path / "im0.png"), "-r", str(tmp_path / "im1.png"),
               "--output_directory", str(out), "--valid_iters", "1",
               "--save_numpy"])
    # ran on the card: the warm-up and the capture of one graph
    assert gru_gates_fused.launches == gates + 6
    cpu = InferenceRunner(cfg, state, iters=1, device="cpu").disparity(
        left, right)
    np.testing.assert_allclose(np.load(out / "im0.npy"), cpu, atol=1e-3,
                               rtol=0)
    assert (out / "im0-disparity.png").exists()


def _rel_err(got, want):
    """max |got - want| over max |want|."""
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,w1,w2s", [(16, 180, (180, 90, 45, 22)),
                                         (3, 37, (43,)),
                                         (2, 13, (7, 3, 1))])
def test_lookup_backward_kernel_matches_plain(rng, cuda_device, dtype, rows,
                                              w1, w2s):
    """Kernel #3/#4 against ``lookup_pyramid_bwd_xla``: the same taps, the
    same fp32 products, at most two per bin, rounded once."""
    k = 2 * RADIUS + 1
    g = torch.from_numpy(rng.normal(size=(2, rows, w1, len(w2s) * k)).astype(
        np.float32)).to(cuda_device, dtype)
    c = torch.from_numpy(rng.uniform(-10, w2s[0] + 10, size=(2, rows, w1))
                         .astype(np.float32)).to(cuda_device)
    before = lookup_pyramid_bwd_fused.launches
    got = lookup_pyramid_bwd_fused(g, c, w2s, RADIUS, dtype)
    torch.cuda.synchronize()
    assert lookup_pyramid_bwd_fused.launches == before + 1
    for gv, wv in zip(got, lookup_pyramid_bwd_xla(g, c, w2s, RADIUS, dtype)):
        assert gv.dtype == dtype
        if dtype == torch.float32:
            torch.testing.assert_close(gv, wv, atol=1e-6, rtol=0)
        else:
            assert_bf16_close(gv, wv)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,w1,w2,d,levels", [(8, 90, 90, 256, 4),
                                                 (3, 37, 43, 64, 4),
                                                 (2, 13, 7, 8, 1)])
def test_alt_backward_kernel_matches_plain(rng, cuda_device, dtype, rows, w1,
                                           w2, d, levels):
    """Kernel #8 against ``alt_lookup_bwd_xla``: fp32 within 1e-5 of each
    gradient's scale (sums in another order); bf16 within one ulp of each
    value plus 1e-5 of the scale (both sum in fp32 and round once)."""
    def arr(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(
            np.float32)).to(cuda_device, dtype)

    f1 = arr(1, rows, w1, d)
    pyr = [arr(1, rows, w2, d)]
    for _ in range(levels - 1):
        pyr.append(pool_axis(pyr[-1], axis=2).contiguous())
    c = torch.from_numpy(rng.uniform(-10, w2 + 10, size=(1, rows, w1)).astype(
        np.float32)).to(cuda_device)
    g = arr(1, rows, w1, levels * (2 * RADIUS + 1))
    before = alt_lookup_bwd_fused.launches
    df1, df2 = alt_lookup_bwd_fused(f1, pyr, c, g, RADIUS)
    torch.cuda.synchronize()
    assert alt_lookup_bwd_fused.launches == before + 1
    want1, want2 = alt_lookup_bwd_xla(f1, pyr, c, g, RADIUS)
    for got, want in [(df1, want1)] + list(zip(df2, want2)):
        assert got.dtype == dtype
        if dtype == torch.float32:
            assert _rel_err(got, want) <= 1e-5
        else:
            assert_bf16_close(got, want,
                              atol=1e-5 * float(want.float().abs().max()))
    again = alt_lookup_bwd_fused(f1, pyr, c, g, RADIUS)
    assert torch.equal(again[0], df1)      # the order of every sum is fixed
    assert all(torch.equal(a, b) for a, b in zip(again[1], df2))


def _centers(rng, rows, w1, w2, spread=10.0):
    """Centers across the row and past both of its ends (non-monotone, so
    windows cross), a few of them far outside on either side."""
    c = rng.uniform(-spread, w2 + spread, size=(1, rows, w1))
    c.flat[::7] = -1e4
    c.flat[3::11] = 1e4
    return c.astype(np.float32)


# (rows, W1, W2 at level 0, D, levels, radius): the realtime training row,
# W1 that is a multiple of no tile, D that is not a multiple of the channel
# chunk (64 bf16 or 32 fp32 channels), radius 0 and 8, 1 and 8 levels, and
# the widest rows the earlier kernel accepted (its df2 of every level in
# shared memory: W2 sums of 1,630 at 4 levels, radius 4, and 1,379 at 8
# levels, radius 8), each with a W1 wider than one pixel tile.
ALT_BWD_EDGE = [(4, 90, 90, 256, 4, 4), (3, 77, 61, 96, 4, 4),
                (2, 45, 50, 40, 4, 4), (2, 30, 30, 64, 4, 0),
                (2, 30, 40, 32, 4, 8), (2, 33, 35, 16, 1, 4),
                (1, 40, 256, 16, 8, 4), (1, 2500, 870, 16, 4, 4),
                (1, 2100, 694, 8, 8, 8)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,w1,w2,d,levels,radius", ALT_BWD_EDGE)
def test_alt_backward_redesign_edges(rng, cuda_device, dtype, rows, w1, w2,
                                     d, levels, radius):
    """Kernel #8 (bf16 rows that fit a block on the tensor cores, fp32 and
    the widest rows on the CUDA cores) against ``alt_lookup_bwd_xla`` at
    its edges, with the tolerances of
    ``test_alt_backward_kernel_matches_plain``, and two launches bit for
    bit equal."""
    def arr(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(
            np.float32)).to(cuda_device, dtype)

    f1 = arr(1, rows, w1, d)
    pyr = [arr(1, rows, w2, d)]
    for _ in range(levels - 1):
        pyr.append(pool_axis(pyr[-1], axis=2).contiguous())
    c = torch.from_numpy(_centers(rng, rows, w1, w2)).to(cuda_device)
    g = arr(1, rows, w1, levels * (2 * radius + 1))
    df1, df2 = alt_lookup_bwd_fused(f1, pyr, c, g, radius)
    again = alt_lookup_bwd_fused(f1, pyr, c, g, radius)
    torch.cuda.synchronize()
    want1, want2 = alt_lookup_bwd_xla(f1, pyr, c, g, radius)
    for got, want in [(df1, want1)] + list(zip(df2, want2)):
        assert got.dtype == dtype and got.shape == want.shape
        scale = float(want.float().abs().max())
        if dtype == torch.float32:
            assert float((got - want).abs().max()) <= 1e-5 * scale
        else:
            assert_bf16_close(got, want, atol=1e-5 * scale)
    assert torch.equal(again[0], df1)
    assert all(torch.equal(a, b) for a, b in zip(again[1], df2))


def test_alt_backward_plan_mirrors_the_kernel(cuda_device):
    """``plan_bwd``'s shared-memory counts are the kernels' own
    (``raft_corr_alt_bwd_smem_bytes``), and a plan above a block's shared
    memory is refused by both."""
    from raft_stereo_tpu_torch.kernels import _build
    from raft_stereo_tpu_torch.kernels.corr_alt import (MAX_BWD_SMEM,
                                                        bwd_smem_bytes,
                                                        plan_bwd,
                                                        tc_smem_bytes)
    import ctypes
    fn = _build.entry("corr_alt", "raft_corr_alt_bwd_smem_bytes",
                      [ctypes.POINTER(ctypes.c_int)] + [ctypes.c_int] * 7)
    for rows, w1, w2, d, levels, radius in ALT_BWD_EDGE:
        w2s = [w2 // 2 ** i for i in range(levels)]
        arr = (ctypes.c_int * levels)(*w2s)
        for item in (2, 4):
            chunk, tile, tc = plan_bwd(w1, w2s, radius,
                                       d - d % (16 // item), item)
            want = (tc_smem_bytes(w2s, radius, w1, chunk) if tc else
                    bwd_smem_bytes(sum(w2s), levels, radius, tile, chunk,
                                   item, w1))
            assert want <= MAX_BWD_SMEM
            assert fn(arr, levels, radius, tile, chunk, item, w1,
                      int(tc)) == want
    big = (ctypes.c_int * 4)(2000, 1000, 500, 250)
    assert fn(big, 4, 4, 64, 64, 2, 64, 0) == 0
    assert fn(big, 4, 4, 64, 64, 2, 64, 1) == 0


# (B, rows, W1, W2s, radius): rows whose W2 * itemsize is no multiple of 16
# (45, 22, 7 fp32; 45, 3 bf16), element counts that are no multiple of a
# 16-byte run (15 pixels x 7 bins), radius 0 and 8, one level, W2 = 1.
LOOKUP_BWD_EDGE = [(2, 16, 180, (180, 90, 45, 22), 4), (1, 3, 5, (7,), 4),
                   (2, 3, 37, (45, 22, 11, 5), 4), (1, 5, 13, (7, 3, 1), 8),
                   (1, 2, 50, (40, 20, 10, 5), 0), (3, 1, 1, (1,), 4),
                   (1, 4, 33, (35,), 2)]


def _lookup_bwd_centers(rng, shape, w2, radius):
    """Random centers past both ends, some far outside, and some at the
    edges of the window test: -R-2 and W2+R+1 (wholly outside, just) and
    a hair inside them."""
    c = rng.uniform(-radius - 6, w2 + radius + 6, size=shape)
    c.flat[::7] = -1e4
    c.flat[3::11] = 1e4
    c.flat[5::13] = -radius - 2
    c.flat[6::17] = w2 + radius + 1
    c.flat[8::19] = np.nextafter(np.float32(-radius - 2), np.float32(0))
    c.flat[9::23] = np.nextafter(np.float32(w2 + radius + 1), np.float32(0))
    return c.astype(np.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,rows,w1,w2s,radius", LOOKUP_BWD_EDGE)
def test_lookup_backward_redesign_edges(rng, cuda_device, dtype, b, rows, w1,
                                        w2s, radius):
    """Kernel #3/#4 (a thread per 16-byte run of the flat dV) against
    ``lookup_pyramid_bwd_xla`` at its edges, all levels in one launch and
    each level alone at 1/2^l, with the tolerances of
    ``test_lookup_backward_kernel_matches_plain``; two launches bit for
    bit equal."""
    k = 2 * radius + 1
    g = torch.from_numpy(rng.normal(size=(b, rows, w1, len(w2s) * k)).astype(
        np.float32)).to(cuda_device, dtype)
    c = torch.from_numpy(_lookup_bwd_centers(rng, (b, rows, w1), w2s[0],
                                             radius)).to(cuda_device)
    calls = [(g, c, list(w2s))] + [
        (g[..., i * k:(i + 1) * k].contiguous(), c / 2 ** i, [w2])
        for i, w2 in enumerate(w2s)]
    for gg, cc, ws_ in calls:
        got = lookup_pyramid_bwd_fused(gg, cc, ws_, radius, dtype)
        again = lookup_pyramid_bwd_fused(gg, cc, ws_, radius, dtype)
        torch.cuda.synchronize()
        want = lookup_pyramid_bwd_xla(gg, cc, ws_, radius, dtype)
        for gv, av, wv in zip(got, again, want):
            assert gv.dtype == dtype and gv.shape == wv.shape
            assert torch.equal(gv, av)
            if dtype == torch.float32:
                torch.testing.assert_close(gv, wv, atol=1e-6, rtol=0)
            else:
                assert_bf16_close(gv, wv)


def _feats(rng, shape, dtype, device):
    if dtype in Q_DTYPES:
        return _q_codes(rng, shape, dtype, device)
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(
        device, dtype)


def _coherent(rng, b, rows, w1):
    """c = x - d, d a smooth field in [0, 24]: a grid with a node every 8
    pixels, upsampled bilinearly."""
    coarse = torch.from_numpy(rng.uniform(0, 24, size=(
        b, 1, rows // 8 + 2, w1 // 8 + 2)).astype(np.float32))
    d = torch.nn.functional.interpolate(coarse, size=(rows, w1),
                                        mode="bilinear", align_corners=True)
    return (torch.arange(w1, dtype=torch.float32) - d[:, 0]).numpy()


# (rows, W1, W2 at level 0, D, levels, radius, centers): the realtime rows
# on coherent and random centers; a band wider than one pass with D at
# the cap (8 levels, radius 8: D in chunks); W2 = 1; a one-pixel row; one
# 16-byte vector of D at radius 0; centers at the edges.
def _alt_fwd_edge(dtype):
    cap = 64 * {torch.float32: 4, torch.bfloat16: 8}.get(dtype, 16)
    vec = {torch.float32: 4, torch.bfloat16: 8}.get(dtype, 16)
    return [(4, 156, 156, 256, 4, 4, "coherent"),
            (4, 156, 156, 256, 4, 4, "random"),
            (2, 90, 90, 256, 4, 4, "coherent"),
            (1, 40, 700, cap, 8, 8, "random"),
            (2, 37, 1, cap, 1, 4, "random"), (3, 1, 20, 64, 4, 4, "random"),
            (2, 33, 35, vec, 1, 0, "edges"), (2, 45, 50, 96, 4, 4, "edges")]


@pytest.mark.parametrize("dtype", ["fp32", "bf16", "int8", "fp8"])
@pytest.mark.parametrize("case", range(8))
def test_alt_forward_redesign_edges(rng, cuda_device, dtype, case):
    """Kernels #6/#7/#9 (tiles of a row, bands in shared memory, the dots on
    the tensor cores or, in fp32, the CUDA cores) against
    ``alt_lookup_xla``: fp32 1e-5 and bf16 one ulp + 1e-5 (the
    tolerances of ``test_alt_kernel_matches_plain``), int8 1e-6 and fp8
    1e-5 of the scale (``test_alt_q_kernel_matches_plain``); two launches
    bit for bit equal."""
    dtype = {"fp32": torch.float32, "bf16": torch.bfloat16,
             "int8": torch.int8, "fp8": torch.float8_e4m3fn}[dtype]
    rows, w1, w2, d, levels, radius, field = _alt_fwd_edge(dtype)[case]
    f1 = _feats(rng, (1, rows, w1, d), dtype, cuda_device)
    pyr = [_feats(rng, (1, rows, w2, d), dtype, cuda_device)]
    for _ in range(levels - 1):
        pyr.append(pyr[-1][:, :, ::2].contiguous() if dtype in Q_DTYPES
                   else pool_axis(pyr[-1], axis=2).contiguous())
    if field == "coherent":
        c = _coherent(rng, 1, rows, w1)
    elif field == "edges":
        c = _lookup_bwd_centers(rng, (1, rows, w1), w2, radius)
    else:
        c = rng.uniform(-10, w2 + 10, size=(1, rows, w1)).astype(np.float32)
    c = torch.from_numpy(c).to(cuda_device)
    if dtype in Q_DTYPES:
        def call():
            return alt_lookup_fused_q(f1, pyr, c, radius, torch.float32)
        want = alt_lookup_xla(f1, pyr, c, radius, torch.float32)
    else:
        def call():
            return alt_lookup_fused(f1, pyr, c, radius)
        want = alt_lookup_xla(f1, pyr, c, radius)
    got, again = call(), call()
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, again)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    elif dtype == torch.bfloat16:
        assert_bf16_close(got, want)
    else:
        tol = 1e-6 if dtype == torch.int8 else 1e-5
        torch.testing.assert_close(got, want, rtol=0, atol=tol * max(
            float(want.abs().max()), 1.0))


def test_alt_forward_plan_mirrors_the_kernel(cuda_device):
    """``plan_fwd``'s shared-memory counts are the kernel's own
    (``raft_corr_alt_fwd_smem_bytes``), and a plan above a block's shared
    memory is refused by both."""
    import ctypes
    from raft_stereo_tpu_torch.kernels import _build
    from raft_stereo_tpu_torch.kernels.corr_alt import (_FWD_ITEM,
                                                        fwd_smem_bytes,
                                                        plan_fwd)
    fn = _build.entry("corr_alt", "raft_corr_alt_fwd_smem_bytes",
                      [ctypes.c_int] * 7)
    for dtype in (torch.float32, torch.bfloat16) + tuple(Q_DTYPES):
        out_item = 2 if dtype == torch.bfloat16 else 4
        for rows, w1, w2, d, levels, radius, _ in _alt_fwd_edge(dtype):
            w2s = [max(w2 // 2 ** i, 1) for i in range(levels)]
            tile, chunk, seg = plan_fwd(w2s, radius, d, dtype)
            want = fwd_smem_bytes(levels, radius, tile, chunk,
                                  _FWD_ITEM[dtype], seg, out_item)
            assert fn(levels, radius, tile, chunk, _FWD_ITEM[dtype], seg,
                      out_item) == want
    assert fn(8, 8, 32, 1024, 4, 512, 4) == 0


# (rows, W1, W2 at level 0, levels, radius): the KITTI row, W1 not a
# multiple of a block's pixels, radius 0 and 8, 1 and 8 levels.
LOOKUP_EDGE = [(4, 312, 312, 4, 4), (3, 77, 61, 4, 4), (2, 50, 40, 4, 0),
               (2, 50, 40, 4, 8), (2, 33, 35, 1, 4), (1, 40, 256, 8, 4),
               (2, 23, 19, 3, 8)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int8, torch.float8_e4m3fn])
@pytest.mark.parametrize("rows,w1,w2,levels,radius", LOOKUP_EDGE)
def test_lookup_redesign_edges(rng, cuda_device, dtype, rows, w1, w2, levels,
                               radius):
    """Kernel #1 (a thread per pixel and level, outputs staged for
    16-byte stores) against ``lookup_pyramid_xla`` on every
    level type, with centers past both ends of the row: fp32 1e-5 (the
    tolerance of ``test_lookup_kernel_matches_plain``), bf16 one ulp, the
    1-byte levels 1e-6 of the scale; and two launches bit for bit equal."""
    if dtype in Q_DTYPES:
        levels_ = [_q_codes(rng, (1, rows, w1, w2 // 2 ** i), dtype,
                            cuda_device) for i in range(levels)]
    else:
        vol = torch.from_numpy(rng.normal(size=(1, rows, w1, w2)).astype(
            np.float32)).to(cuda_device, dtype)
        levels_ = build_corr_pyramid(vol, levels)
    c = torch.from_numpy(_centers(rng, rows, w1, w2)).to(cuda_device)
    if dtype in Q_DTYPES:
        got = lookup_pyramid_fused_q(levels_, c, radius, torch.float32)
        again = lookup_pyramid_fused_q(levels_, c, radius, torch.float32)
        want = lookup_pyramid_xla(levels_, c, radius, torch.float32)
    else:
        got = lookup_pyramid_fused(levels_, c, radius)
        again = lookup_pyramid_fused(levels_, c, radius)
        want = lookup_pyramid_xla(levels_, c, radius)
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == want.dtype
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    elif dtype == torch.bfloat16:
        assert_bf16_close(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=1e-6 * float(want.abs().max()))
    assert torch.equal(got, again)


def test_wrappers_carry_gradients_on_card(rng, cuda_device):
    """The autograd fault's regression: each kernel wrapper's output on the
    card has a ``grad_fn``, and the gradient of a loss through it equals
    the gradient through its plain version on the same card tensors."""
    def leaf(*shape, scale=1.0):
        return torch.from_numpy((scale * rng.normal(size=shape)).astype(
            np.float32)).to(cuda_device).requires_grad_()

    # pyramid lookup: the volume's gradient
    vol = leaf(1, 4, 40, 40)
    c = torch.from_numpy(rng.uniform(-6, 46, size=(1, 4, 40)).astype(
        np.float32)).to(cuda_device)
    pyr = build_corr_pyramid(vol, 4)
    out = lookup_pyramid_fused(pyr, c, RADIUS)
    assert out.grad_fn is not None
    w = torch.randn_like(out)
    got, = torch.autograd.grad((out * w).sum(), vol)
    want, = torch.autograd.grad(
        (lookup_pyramid_xla(build_corr_pyramid(vol, 4), c, RADIUS) * w).sum(),
        vol)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)

    # alt lookup: both feature maps' gradients
    f1, f2 = leaf(1, 4, 40, 64), leaf(1, 4, 44, 64)

    def alt_pyr(f):
        levels = [f]
        for _ in range(3):
            levels.append(pool_axis(levels[-1], axis=2))
        return levels

    out = alt_lookup_fused(f1, alt_pyr(f2), c, RADIUS)
    assert out.grad_fn is not None
    w = torch.randn_like(out)
    got = torch.autograd.grad((out * w).sum(), (f1, f2))
    want = torch.autograd.grad(
        (alt_lookup_xla(f1, alt_pyr(f2), c, RADIUS) * w).sum(), (f1, f2))
    for a, b in zip(got, want):
        assert _rel_err(a, b) <= 1e-5

    # gates: every input's gradient
    ch, cx = 32, 64
    ws = (2 / (9 * (ch + cx))) ** 0.5
    args = (leaf(2, 9, 20, ch), leaf(2, 9, 20, cx), leaf(2, 9, 20, ch),
            leaf(3, 3, ch + cx, 2 * ch, scale=ws), leaf(2 * ch, scale=0.1),
            leaf(3, 3, ch + cx, ch, scale=ws), leaf(ch, scale=0.1))
    outs = gru_gates_fused(*args)
    assert all(o.grad_fn is not None for o in outs)
    ws_out = [torch.randn_like(o) for o in outs]
    got = torch.autograd.grad(sum((o * v).sum() for o, v in
                                  zip(outs, ws_out)), args)
    want = torch.autograd.grad(sum((o * v).sum() for o, v in
                                   zip(_gates_reference(*args), ws_out)),
                               args)
    for a, b in zip(got, want):
        assert _rel_err(a, b) <= 1e-5


def _leaf_err(got, want):
    """Largest gradient-leaf difference, each over max(its scale, 1e-3 of
    the largest gradient)."""
    scale = max(float(g.abs().max()) for g in want.values())
    return max(float((got[n] - g).abs().max())
               / max(float(g.abs().max()), 1e-3 * scale)
               for n, g in want.items())


def test_tiny_train_step_card_matches_cpu(cuda_device):
    """One default TINY step on the card (the lookup, its backward and
    the gate kernel) and on the CPU, from the same weights and batch.
    Loss and grad_norm within 1e-4 and 1e-3 relative; the gradient leaves
    within 3x the card's own spread on the same step (cuDNN vs native
    convolutions, the gate kernel vs plain gate convolutions, the weights
    moved by one fp32 ulp), and never below 3e-2, as in chip_smoke.py's
    step check (the fnet gradients pass through instance norm's backward,
    whose cancellation amplifies rounding: 5e-2 on these inputs at first
    measure)."""
    torch.manual_seed(0)
    cfg = RaftStereoConfig(**TINY)
    tc = TrainConfig(batch_size=1, train_iters=2, image_size=(64, 96),
                     num_steps=1000)
    weights = RAFTStereo(cfg).state_dict()
    batch = SyntheticStereoLoader(1, (64, 96), seed=2).batch(0)
    def grads_on_card(cfg_, w=weights):
        state = create_train_state(cfg_, tc, "cuda", state_dict=w)
        state, _ = train_step(state, batch, iters=2, loss_gamma=0.9,
                              max_flow=700.0)
        return {n: p.grad.cpu() for n, p in state.model.named_parameters()}

    with torch.backends.cudnn.flags(enabled=False):
        native = grads_on_card(cfg)
    plain = grads_on_card(RaftStereoConfig(**TINY, fused_gru="off"))
    gen = torch.Generator().manual_seed(1)
    moved = grads_on_card(cfg, {n: t * (1 + 2.0 ** -23 * (2 * torch.randint(
        0, 2, t.shape, generator=gen) - 1)) for n, t in weights.items()})
    results = {}
    for dev in ("cpu", "cuda"):
        state = create_train_state(cfg, tc, dev, state_dict=weights)
        counts = (lookup_pyramid_fused.launches,
                  lookup_pyramid_bwd_fused.launches,
                  gru_gates_fused.launches)
        state, metrics = train_step(state, batch, iters=2, loss_gamma=0.9,
                                    max_flow=700.0)
        launched = (lookup_pyramid_fused.launches - counts[0],
                    lookup_pyramid_bwd_fused.launches - counts[1],
                    gru_gates_fused.launches - counts[2])
        assert launched == ((0, 0, 0) if dev == "cpu" else (2, 2, 12))
        results[dev] = ({k: float(v) for k, v in metrics.items()},
                        {n: p.grad.cpu() for n, p in
                         state.model.named_parameters()})
    (cpu_m, cpu_g), (gpu_m, gpu_g) = results["cpu"], results["cuda"]
    assert abs(gpu_m["loss"] - cpu_m["loss"]) <= 1e-4 * cpu_m["loss"]
    assert abs(gpu_m["grad_norm"] - cpu_m["grad_norm"]) <= (
        1e-3 * cpu_m["grad_norm"])
    spread = max(_leaf_err(g, gpu_g) for g in (native, plain, moved))
    assert _leaf_err(gpu_g, cpu_g) <= max(3e-2, 3 * spread), spread


# ------------------------------------------------------ the quantized tier
Q_DTYPES = [torch.int8, torch.float8_e4m3fn]


def _q_codes(rng, shape, dtype, device):
    if dtype == torch.int8:
        return torch.from_numpy(rng.integers(-127, 128, shape).astype(
            np.int8)).to(device)
    x = rng.normal(scale=60, size=shape).clip(-448, 448).astype(np.float32)
    return torch.from_numpy(x).to(device).to(dtype)


@pytest.mark.parametrize("dtype", Q_DTYPES)
def test_lookup_q_kernel_matches_plain(rng, cuda_device, dtype):
    """#1 over 1-byte levels, fp32 out: all levels in one launch and each
    level alone at 1/2^l; the same fp32 arithmetic as the plain version
    up to contraction into FMAs, 1e-6 of the scale."""
    w2s = [312, 156, 78, 39]
    levels = [_q_codes(rng, (1, 8, 96, w), dtype, cuda_device) for w in w2s]
    c = torch.from_numpy(rng.uniform(-10, 322, (1, 8, 96)).astype(
        np.float32)).to(cuda_device)
    calls = [(levels, c)] + [([v], c / 2 ** i) for i, v in enumerate(levels)]
    for lv, cc in calls:
        before = lookup_pyramid_fused_q.launches
        got = lookup_pyramid_fused_q(lv, cc, RADIUS, torch.float32)
        torch.cuda.synchronize()
        assert lookup_pyramid_fused_q.launches == before + 1
        want = lookup_pyramid_xla(lv, cc, RADIUS, torch.float32)
        assert got.dtype == torch.float32
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=1e-6 * float(want.abs().max()))
    with pytest.raises(TypeError, match="float32"):
        lookup_pyramid_fused_q(levels, c, RADIUS, torch.bfloat16)


@pytest.mark.parametrize("dtype", Q_DTYPES)
@pytest.mark.parametrize("rows,w1,w2,d", [(8, 156, 156, 256),
                                          (3, 37, 43, 64)])
def test_alt_q_kernel_matches_plain(rng, cuda_device, dtype, rows, w1, w2,
                                    d):
    """Kernel #9 over int8 or fp8 features, fp32 out, four levels and one
    level alone.  int8 dots are exact integers: 1e-6 of the scale; fp8
    products sum in another order: 1e-5."""
    f1 = _q_codes(rng, (1, rows, w1, d), dtype, cuda_device)
    f2 = _q_codes(rng, (1, rows, w2, d), dtype, cuda_device)
    pyr = [f2]
    for _ in range(3):   # codes of pooled levels: any codes will do
        pyr.append(pyr[-1][:, :, ::2].contiguous())
    c = torch.from_numpy(rng.uniform(-6, w2 + 6, (1, rows, w1)).astype(
        np.float32)).to(cuda_device)
    tol = 1e-6 if dtype == torch.int8 else 1e-5
    for lv, cc in [(pyr, c), ([pyr[2]], c / 4)]:
        before = alt_lookup_fused_q.launches
        got = alt_lookup_fused_q(f1, lv, cc, RADIUS, torch.float32)
        torch.cuda.synchronize()
        assert alt_lookup_fused_q.launches == before + 1
        want = alt_lookup_xla(f1, lv, cc, RADIUS, torch.float32)
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=tol * float(want.abs().max()))


@pytest.mark.parametrize("n,cin,hw,cout,k,stride", [
    (2, 3, (64, 96), 64, 7, 2),      # K = 147, padded to 152
    (1, 256, (12, 20), 256, 3, 1),
    (2, 64, (17, 23), 96, 3, 2),
    (2, 128, (8, 12), 128, 1, 1),
    (1, 32, (3, 4), 16, 3, 1),       # 12 rows, padded to the GEMM's 32
])
def test_int8_gemm_conv_bit_equal(rng, cuda_device, n, cin, hw, cout, k,
                                  stride):
    """The int8 conv on the card (im2col + cuBLASLt's int8 GEMM) equals
    the exact CPU version bit for bit."""
    x = torch.from_numpy(rng.integers(-127, 128, (n, cin) + hw).astype(
        np.int8))
    w = torch.from_numpy(rng.integers(-127, 128, (cout, cin, k, k)).astype(
        np.int8))
    want = int8_conv_int32(x, w, stride, k // 2)
    before = int8_conv_int32.launches
    got = int8_conv_int32(x.to(cuda_device), w.to(cuda_device), stride,
                          k // 2)
    torch.cuda.synchronize()
    assert int8_conv_int32.launches == before + 1
    assert got.dtype == torch.int32
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("realtime", [False, True])
def test_tiny_quantized_card_matches_cpu(rng, cuda_device, realtime):
    """One TINY quantized forward (realtime ``int8_mxu``: kernel #9 and
    the int8 GEMMs; default ``int8``: #1 over int8 levels) on the card
    and on the CPU.  Codes may flip where the card and the CPU round the
    encoders differently, so the flow is held to 3x the card's own
    spread when every weight moves by one fp32 ulp, max and mean."""
    torch.manual_seed(0)
    base = RaftStereoConfig.realtime().to_dict() if realtime else {}
    cfg = RaftStereoConfig(**{**base, **TINY})
    quant = "int8_mxu" if realtime else "int8"
    state = RAFTStereo(cfg).state_dict()
    gen = torch.Generator().manual_seed(0)
    moved = {n: t * (1 + 2.0 ** -23 * (2 * torch.randint(
        0, 2, t.shape, generator=gen) - 1)) for n, t in state.items()}
    left = rng.integers(0, 256, (45, 70, 3), dtype=np.uint8)
    right = np.roll(left, -3, axis=1)
    cpu = InferenceRunner(cfg, state, iters=1, device="cpu",
                          quant=quant)(left, right)[0]
    counts = (lookup_pyramid_fused_q.launches, alt_lookup_fused_q.launches,
              int8_conv_int32.launches)
    runner = InferenceRunner(cfg, state, iters=1, quant=quant)
    gpu = runner(left, right)[0]
    launched = [a - b for a, b in zip(
        (lookup_pyramid_fused_q.launches, alt_lookup_fused_q.launches,
         int8_conv_int32.launches), counts)]
    # the warm-up and the capture each ran the forward once
    (graph,) = runner._compiled.values()
    assert [graph.launches["lookup_q"], graph.launches["alt_q"]] == \
        ([0, 1] if realtime else [1, 0])
    assert launched == [2 * graph.launches[k]
                        for k in ("lookup_q", "alt_q", "gemm")]
    assert (launched[2] > 0) == realtime
    ulp = InferenceRunner(cfg, moved, iters=1, quant=quant)(left, right)[0]
    spread, err = np.abs(ulp - gpu), np.abs(gpu - cpu)
    assert np.isfinite(gpu).all()
    assert err.max() <= 3 * spread.max() and err.mean() <= 3 * spread.mean(
    ), (err.max(), err.mean(), spread.max(), spread.mean())


# ------------------------------------------------- the runner's CUDA graphs
GRAPH_CONFIGS = {
    "default": ({}, None),
    "realtime": (RaftStereoConfig.realtime().to_dict(), None),
    "default int8": ({}, "int8"),
    "default int8 calibrated": ({"quant_corr_scales": (0.05, 0.04, 0.03,
                                                      0.02)}, "int8"),
    "realtime int8_mxu": (RaftStereoConfig.realtime().to_dict(),
                          "int8_mxu"),
}


def _graph_runner(name, **kw):
    base, quant = GRAPH_CONFIGS[name]
    torch.manual_seed(0)
    cfg = RaftStereoConfig(**{**base, **TINY})
    return InferenceRunner(cfg, RAFTStereo(cfg).state_dict(), iters=2,
                           quant=quant, **kw)


def _eager(runner, left, right):
    """The runner's closure called eagerly on the padded pair, unpadded:
    what a replay must reproduce bit for bit."""
    from raft_stereo_tpu_torch.eval.runner import make_forward
    from raft_stereo_tpu_torch.ops.padding import InputPadder

    padder = InputPadder((1, 3) + left.shape[:2], divis_by=runner.divis_by)
    pl, pr, pt, pb = padder.pads
    spec = ((pt, pb), (pl, pr), (0, 0))
    dev = runner.device
    with torch.inference_mode():
        flow = make_forward(runner.model, runner.iters, runner.fetch_dtype)(
            torch.from_numpy(np.pad(left, spec, mode="edge")[None]).to(dev),
            torch.from_numpy(np.pad(right, spec, mode="edge")[None]).to(dev))
        if isinstance(flow, tuple):         # early exit: (flow, iters_used)
            runner.eager_iters_used = int(flow[1])
            flow = flow[0]
        return padder.unpad(flow)[0].float().cpu().numpy()


@pytest.mark.parametrize("name", sorted(GRAPH_CONFIGS))
def test_graph_replay_bitwise_equals_eager(rng, cuda_device, name):
    """The first call captures (after an eager warm-up) and replays; the
    replay equals the eager forward bit for bit, and so do two replays."""
    runner = _graph_runner(name)
    left = rng.integers(0, 256, (45, 70, 3), dtype=np.uint8)
    right = np.roll(left, -3, axis=1)
    first = runner(left, right)[0]
    second = runner(left, right)[0]
    assert runner.captures == 1 and runner.replays == 2
    (graph,) = runner._compiled.values()
    assert sum(graph.launches.values()) > 0
    np.testing.assert_array_equal(first, second)
    np.testing.assert_array_equal(first, _eager(runner, left, right))
    other = np.roll(left, 5, axis=0)
    np.testing.assert_array_equal(runner(other, right)[0],
                                  _eager(runner, other, right))
    assert runner.captures == 1


def test_graphs_share_a_pool_a_b_a(rng, cuda_device):
    """Two graphs in one pool, replayed A, B, A: A's results are equal bit
    for bit, and B's equals B's eager forward."""
    runner = _graph_runner("default")
    a = rng.integers(0, 256, (45, 70, 3), dtype=np.uint8)
    b = rng.integers(0, 256, (100, 130, 3), dtype=np.uint8)
    a1 = runner(a, np.roll(a, -3, axis=1))[0]
    b1 = runner(b, np.roll(b, -3, axis=1))[0]
    a2 = runner(a, np.roll(a, -3, axis=1))[0]
    assert runner.captures == 2 and len(runner._compiled) == 2
    pools = {g.pool for g in runner._compiled.values()}
    assert len(pools) == 1
    np.testing.assert_array_equal(a1, a2)
    np.testing.assert_array_equal(b1, _eager(runner, b,
                                             np.roll(b, -3, axis=1)))


def test_graph_eviction_frees_its_graph(rng, cuda_device):
    import gc
    import weakref

    runner = _graph_runner("default", max_cached_shapes=1)
    a = rng.integers(0, 256, (45, 70, 3), dtype=np.uint8)
    b = rng.integers(0, 256, (100, 130, 3), dtype=np.uint8)
    want = runner(a, a)[0]
    first = weakref.ref(next(iter(runner._compiled.values())))
    runner(b, b)
    gc.collect()
    assert first() is None and len(runner._compiled) == 1
    np.testing.assert_array_equal(runner(a, a)[0], want)
    assert runner.captures == 3


def test_graph_run_batch_matches_single_calls(rng, cuda_device):
    """Batch 3 is its own graph; it may take other cuDNN algorithms than
    batch 1, so it is held to the card-vs-CPU bound at 2 iterations
    (chip_smoke.py's CARD_VS_CPU_ATOL)."""
    runner = _graph_runner("default")
    lefts = [rng.integers(0, 256, (45, 70, 3), dtype=np.uint8)
             for _ in range(3)]
    rights = [np.roll(l, -3, axis=1) for l in lefts]
    flows, _ = runner.run_batch(lefts, rights)
    assert flows.shape == (3, 45, 70)
    for i in range(3):
        np.testing.assert_allclose(flows[i], runner(lefts[i], rights[i])[0],
                                   atol=1e-2, rtol=0)
    assert set(runner._compiled) == {((64, 96), 3), ((64, 96), 1)}


@pytest.mark.parametrize("fetch", ["fp16", "bf16"])
def test_graph_fetch_dtype_rounds_on_the_card(rng, cuda_device, fetch):
    left = rng.integers(0, 256, (45, 70, 3), dtype=np.uint8)
    right = np.roll(left, -3, axis=1)
    full = _graph_runner("default")(left, right)[0]
    half = _graph_runner("default", fetch_dtype=fetch)(left, right)[0]
    dtype = {"fp16": torch.float16, "bf16": torch.bfloat16}[fetch]
    assert half.dtype == np.float32
    np.testing.assert_array_equal(
        half, torch.from_numpy(full).to(dtype).float().numpy())


# ------------------------------------------------ the training entry point
def test_prefetcher_uploads_equal_the_host_batches(cuda_device):
    """20 batches through ``_Upload`` (pinned memory, side stream) and the
    prefetcher, each read by a kernel on the compute stream after ``take``
    while other allocations churn the caching allocator: every uploaded
    tensor equals its host batch (the compact dtypes included)."""
    from raft_stereo_tpu_torch.training.train_loop import (_DevicePrefetcher,
                                                           _Upload, compact)
    src = SyntheticStereoLoader(4, (96, 160), seed=3)
    hosts = []

    def batches():
        for i in range(20):
            b = src.batch(i)
            b["flow"] = b["flow"].astype(np.float32) + 0.25 * i
            b["valid"] = b["valid"].astype(np.float32)
            hosts.append(compact(b))
            yield b

    up = _Upload(cuda_device, compact_upload=True)
    pf = _DevicePrefetcher(batches(), up.put)
    seen = 0
    for item in pf:
        got = up.take(item)
        # pressure: allocate and free blocks of the batch's sizes on the
        # compute stream while the upload's tensors are live
        junk = [torch.empty_like(t).fill_(7) for t in got.values()
                for _ in range(3)]
        sums = {k: t.double().sum() for k, t in got.items()}
        del junk
        want = hosts[seen]
        for k, t in got.items():
            assert t.device.type == cuda_device.type, k
            assert t.dtype == torch.as_tensor(want[k]).dtype, k
            assert torch.equal(t.cpu(), torch.from_numpy(want[k])), k
            assert float(sums[k]) == float(want[k].astype(np.float64).sum())
        seen += 1
    pf.close()
    assert seen == 20 and pf.wait_s >= 0


def test_anomaly_step_on_card_keeps_every_leaf(cuda_device):
    """A NaN batch through the anomaly step on the card: the parameters,
    the AdamW moments and steps, the count and the EWMA keep their bits;
    a clean step then advances the count."""
    from raft_stereo_tpu_torch.training.anomaly import AnomalyPolicy
    from raft_stereo_tpu_torch.training.step import make_train_step
    cfg = RaftStereoConfig(**TINY)
    tc = TrainConfig(batch_size=2, train_iters=2, image_size=(64, 96),
                     num_steps=1000, anomaly_policy=True)
    state = create_train_state(cfg, tc, cuda_device, seed=0, anomaly=True)
    step = make_train_step(tc, anomaly=AnomalyPolicy.from_train_config(tc))
    ok = SyntheticStereoLoader(2, (64, 96), seed=2).batch(0)
    nan = dict(ok, flow=np.full_like(ok["flow"], np.nan))
    ewma = torch.zeros((), device=cuda_device)
    state, m, ewma = step(state, ok, ewma)
    assert float(m["skipped"]) == 0 and int(state.count) == 1

    def leaves():
        opt = state.optimizer.state
        return ([p.detach().clone() for p in state.model.parameters()]
                + [opt[p][k].clone() for p in state.model.parameters()
                   for k in ("exp_avg", "exp_avg_sq", "step")]
                + [state.count.clone(), ewma.clone()])

    before = leaves()
    state, m, ewma = step(state, nan, ewma)
    assert float(m["skipped"]) == float(m["skip_nonfinite"]) == 1.0
    after = leaves()
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    state, m, ewma = step(state, ok, ewma)
    assert float(m["skipped"]) == 0 and int(state.count) == 2
    assert state.step == 3


def test_gated_adamw_on_card_matches_float64_without_a_host_sync(
        cuda_device):
    """The anomaly policy's update on the card (torch AdamW,
    ``capturable``, the LR a device tensor) over 5 steps with a skip fed
    NaN gradients, against the same AdamW in float64
    (``torch_train_support.adamw_f64``): every parameter within 4 fp32
    ulps of its leaf's largest |p| plus what the fp32 bias corrections
    can move it (the capturable path computes ``1 - beta^t`` in fp32 on
    the card, as optax does; the CPU path in float64 on the host); the
    counts and AdamW's ``step`` equal the applied updates; and no step
    synchronises with the host (``torch.cuda.set_sync_debug_mode``
    "error")."""
    import types
    from raft_stereo_tpu_torch.training.optimizer import (
        clip_by_global_norm_, make_optimizer)
    from raft_stereo_tpu_torch.training.step import _gated_adamw_
    from torch_train_support import adamw_f64
    gen = np.random.default_rng(5)
    cfg = TrainConfig(num_steps=300, lr=0.1, wdecay=0.5)
    shapes = {"w": (64, 3, 3, 3), "b": (64,), "x": (7, 5)}
    params = {k: gen.normal(size=s).astype(np.float32)
              for k, s in shapes.items()}
    grads = [{k: (gen.normal(size=s) * scale).astype(np.float32)
              for k, s in shapes.items()} for scale in (0.05, 1, 2, 0.3, 0.1)]
    skips = (1,)
    ps = {k: torch.nn.Parameter(torch.from_numpy(v.copy()).to(cuda_device))
          for k, v in params.items()}
    opt, _ = make_optimizer(ps.values(), cfg, anomaly=True)
    state = types.SimpleNamespace(
        train_cfg=cfg, optimizer=opt,
        count=torch.zeros((), dtype=torch.int64, device=cuda_device))
    flags = [torch.full((), i in skips, device=cuda_device)
             for i in range(len(grads))]
    gs = [{k: torch.from_numpy(np.full_like(v, np.nan) if i in skips
                               else v).to(cuda_device)
           for k, v in g.items()} for i, g in enumerate(grads)]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for flag, step_grads in zip(flags, gs):
            for k, p in ps.items():
                p.grad = step_grads[k].clone()
            clip_by_global_norm_(ps.values(), cfg.clip_grad_norm)
            _gated_adamw_(state, flag)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    applied = len(grads) - len(skips)
    assert int(state.count) == applied
    want, bc_bound = adamw_f64(params, grads, skips, cfg)
    for k, p in ps.items():
        assert float(opt.state[p]["step"]) == applied
        got = p.detach().cpu().numpy()
        ulp = np.spacing(np.float32(np.abs(want[k]).max()))
        assert np.all(np.abs(got - want[k]) <= 4 * ulp + bc_bound[k]), k


def test_device_jitter_on_card_matches_cpu(rng, cuda_device):
    from raft_stereo_tpu_torch.data.device_jitter import (
        JitterParams, apply_photometric, draw_factors)
    params = JitterParams(asymmetric_prob=0.5, gamma=(0.8, 1.2, 0.9, 1.1))
    f_card = draw_factors(7, torch.full((), 11, device=cuda_device), 4,
                          params)
    f_cpu = draw_factors(7, torch.tensor(11), 4, params)
    for k in f_cpu:
        assert torch.equal(f_card[k].cpu(), f_cpu[k]), k
    a = rng.integers(0, 256, (4, 64, 96, 3), dtype=np.uint8)
    b = rng.integers(0, 256, (4, 64, 96, 3), dtype=np.uint8)
    g = apply_photometric(torch.from_numpy(a).to(cuda_device),
                          torch.from_numpy(b).to(cuda_device), f_card)
    w = apply_photometric(torch.from_numpy(a), torch.from_numpy(b), f_cpu)
    for x, y in zip(g, w):
        torch.testing.assert_close(x.cpu(), y, atol=1e-4 * 255, rtol=0)


def test_tiny_train_resume_on_card(cuda_device, tmp_path):
    """``train()`` on the card: 4 steps against 2 steps, a SIGTERM, and a
    resume from ``latest``; the loader's batches are the same, and the
    parameters equal (bit for bit, or within the card's own spread
    between two uninterrupted runs)."""
    import os
    import signal

    from raft_stereo_tpu_torch.training.train_loop import train
    cfg = RaftStereoConfig(**TINY)
    tc = TrainConfig(batch_size=2, train_iters=2, image_size=(64, 96),
                     num_steps=4, validation_frequency=100, seed=3)

    def run(ck, **kw):
        return train(cfg, tc, name="run", checkpoint_dir=str(tmp_path / ck),
                     log_dir=None, device=cuda_device,
                     loader=SyntheticStereoLoader(2, (64, 96), seed=9), **kw)

    full, again = run("a"), run("a2")

    def stop_at_2(step, metrics):
        if step == 2:
            os.kill(os.getpid(), signal.SIGTERM)

    assert run("b", on_step=stop_at_2).step == 2
    resumed = run("b", restore="latest")
    assert resumed.step == 4

    def gap(x, y):
        return max(float((p.detach() - q.detach()).abs().max())
                   for p, q in zip(x.model.parameters(),
                                   y.model.parameters()))
    assert gap(full, resumed) <= 3 * gap(full, again)


# ------------------------------------------- early exit under CUDA graphs
EXIT_CAP = 6


def _settled_runner(name, **kw):
    from torch_port_support import settle_state

    base, _ = GRAPH_CONFIGS[name]
    torch.manual_seed(0)
    cfg = RaftStereoConfig(**{**base, **TINY})
    return cfg, settle_state(RAFTStereo(cfg).state_dict())


def _exit_threshold(cfg, state, left, right):
    """A threshold between the eager loop's deltas of iterations 3 and 4
    (the settling GRU's updates shrink), and the trip count it gives."""
    probe = InferenceRunner(cfg, state, iters=EXIT_CAP, device="cuda")
    from raft_stereo_tpu_torch.ops.padding import InputPadder
    pl, pr, pt, pb = InputPadder((1, 3) + left.shape[:2], divis_by=32).pads
    spec = ((pt, pb), (pl, pr), (0, 0))
    imgs = [torch.from_numpy(np.pad(x, spec, mode="edge")[None]).cuda()
            for x in (left, right)]
    deltas = []
    with torch.inference_mode():
        step, net, disp, _ = probe.model.begin(*imgs)
        for _ in range(EXIT_CAP):
            net, new, _ = step(net, disp)
            deltas.append(float(probe.model.batch_delta((new - disp).abs())))
            disp = new
    assert all(b < 0.9 * a for a, b in zip(deltas, deltas[1:])), deltas
    return (deltas[2] + deltas[3]) / 2, 4


def test_exit_predicate_kernel_matches_plain(cuda_device):
    """WHILE loops whose body is the predicate alone: the kernel's trip
    counts are the plain predicate's, NaN ending the loop."""
    import math

    from raft_stereo_tpu_torch.kernels.graph_loop import (WhileGraph,
                                                          exit_continues,
                                                          exit_predicate)

    stream, pool = torch.cuda.Stream(), torch.cuda.graph_pool_handle()
    it = torch.zeros((), dtype=torch.int32, device=cuda_device)
    delta = torch.zeros((), device=cuda_device)
    keep = []
    for d in (0.2, 0.5, 0.9, math.nan):
        for lo, lim in ((1, 6), (4, 6), (3, 3), (1, 1)):
            wg = WhileGraph()
            graphs = [torch.cuda.CUDAGraph(keep_graph=True) for _ in range(3)]
            with torch.cuda.graph(graphs[0], pool=pool, stream=stream):
                it.zero_()
                delta.fill_(d)
            with torch.cuda.graph(graphs[1], pool=pool, stream=stream):
                exit_predicate(wg.handle, it, delta, lo, lim, 0.5)
            with torch.cuda.graph(graphs[2], pool=pool, stream=stream):
                it.add_(0)
            wg.build(*graphs)
            for _ in range(2):
                wg.launch(torch.cuda.current_stream())
                n, dd = 0, math.inf
                while exit_continues(n, dd, lo, lim, 0.5):
                    n, dd = n + 1, d
                assert int(it) == n, (d, lo, lim)
            keep.append((wg, graphs))
    for wg, _ in keep:
        wg.close()


@pytest.mark.parametrize("name", ["default", "realtime"])
def test_exit_graph_matches_the_eager_exit_loop(rng, cuda_device, name):
    """The WHILE graph replays the eager exit loop bit for bit, with its
    trip count, and launches one iteration's kernels (and the predicate)
    per iteration."""
    from raft_stereo_tpu_torch.eval.runner import launch_counts

    left = rng.integers(0, 256, (45, 70, 3), dtype=np.uint8)
    right = np.roll(left, -3, axis=1)
    cfg, state = _settled_runner(name)
    thr, used = _exit_threshold(cfg, state, left, right)
    runner = InferenceRunner(cfg, state, iters=EXIT_CAP, device="cuda",
                             exit_threshold_px=thr, exit_min_iters=2)
    first = runner(left, right)[0]
    assert runner.last_iters_used == used
    again = runner(left, right)[0]
    eager = _eager(runner, left, right)
    assert runner.eager_iters_used == used
    np.testing.assert_array_equal(first, again)
    np.testing.assert_array_equal(first, eager)
    (entry,) = runner._compiled.values()
    corr = "alt" if name == "realtime" else "lookup"
    assert entry.body_launches[corr] == 1 and entry.body_launches[
        "gates"] == 3
    assert entry.body_launches["exit"] == 1
    assert not any(entry.launches.values())
    assert entry.pair_launches(used)[corr] == used
    before = launch_counts()
    runner(left, right)
    assert launch_counts() == before          # a replay runs no wrapper
    assert runner.captures == 1 and runner.iters_used_mean() == used


def test_exit_stream_graph_matches_eager(rng, cuda_device):
    """A warm frame with the hidden state in and out, on the WHILE graph,
    against its eager streaming program."""
    from raft_stereo_tpu_torch.eval.runner import make_forward

    left = rng.integers(0, 256, (45, 70, 3), dtype=np.uint8)
    right = np.roll(left, -3, axis=1)
    cfg, state = _settled_runner("default")
    thr, _ = _exit_threshold(cfg, state, left, right)
    runner = InferenceRunner(cfg, state, iters=EXIT_CAP, device="cuda",
                             exit_threshold_px=thr, exit_min_iters=2)
    cold = runner.run_stream(left, right, carry_hidden=True)
    warm = runner.run_stream(np.roll(left, -1, axis=1),
                             np.roll(right, -1, axis=1),
                             prev_flow_low=cold.flow_low,
                             prev_hidden=cold.hidden)
    fwd = make_forward(runner.model, EXIT_CAP, warm_start=True,
                       return_state=True, hidden_init=True,
                       return_hidden=True)
    from raft_stereo_tpu_torch.ops.padding import InputPadder
    pl, pr, pt, pb = InputPadder((1, 3, 45, 70), divis_by=32).pads
    spec = ((pt, pb), (pl, pr), (0, 0))
    imgs = [torch.from_numpy(np.pad(np.roll(x, -1, axis=1), spec,
                                    mode="edge")[None]).cuda()
            for x in (left, right)]
    with torch.inference_mode():
        _, low, used, hid = fwd(
            *imgs, torch.from_numpy(cold.flow_low[None]).cuda(),
            tuple(torch.from_numpy(h[None]).cuda() for h in cold.hidden))
    np.testing.assert_array_equal(low[0].cpu().numpy(), warm.flow_low)
    assert int(used) == warm.iters_used
    for a, b in zip(hid, warm.hidden):
        np.testing.assert_array_equal(a[0].cpu().numpy(), b)
    assert len(runner._stream_compiled) == 2


def test_exit_graph_cache_recaptures_after_eviction(rng, cuda_device):
    """One cache entry: a second shape evicts the first (its WHILE graph
    is destroyed and its pool released) and the first captures again,
    with the same result."""
    a = rng.integers(0, 256, (45, 70, 3), dtype=np.uint8)
    b = rng.integers(0, 256, (100, 130, 3), dtype=np.uint8)
    cfg, state = _settled_runner("default")
    thr, _ = _exit_threshold(cfg, state, a, np.roll(a, -3, axis=1))
    runner = InferenceRunner(cfg, state, iters=EXIT_CAP, device="cuda",
                             exit_threshold_px=thr, max_cached_shapes=1)
    want = runner(a, np.roll(a, -3, axis=1))[0]
    runner(b, np.roll(b, -3, axis=1))
    np.testing.assert_array_equal(runner(a, np.roll(a, -3, axis=1))[0], want)
    assert runner.captures == 3 and len(runner._compiled) == 1


@pytest.mark.parametrize("adaptive", [False, True])
def test_confidence_card_vs_cpu(rng, cuda_device, adaptive):
    """The confidence map on the card against the CPU, TINY, iters 2:
    flows within chip_smoke.py's 1e-2 px, the map within 12x that (the
    bound exp(-score / 0.25) gives, score moving 3x the flows)."""
    from raft_stereo_tpu_torch.eval.runner import make_forward

    cfg, state = _settled_runner("default")
    if adaptive:
        cfg = RaftStereoConfig(**{**cfg.to_dict(), "exit_threshold_px": 0.05})
    left = rng.integers(0, 256, (1, 64, 96, 3), dtype=np.uint8)
    right = np.roll(left, -3, axis=2)
    outs = []
    for device in ("cuda", "cpu"):
        r = InferenceRunner(cfg, state, iters=2, device=device)
        with torch.inference_mode():
            o = make_forward(r.model, 2, return_confidence=True)(
                torch.from_numpy(left).to(device),
                torch.from_numpy(right).to(device))
        outs.append([o[0].cpu()] + [t.cpu() for t in o[-1]])
    (f1, c1, u1), (f2, c2, u2) = outs
    assert float((f1 - f2).abs().max()) <= 1e-2
    assert float((c1 - c2).abs().max()) <= 0.12
    assert float((u1 - u2).abs().max()) <= 0.12


# ------------------------------------------------ telemetry on the card
def test_device_memory_stats_keys_on_the_card(cuda_device):
    from raft_stereo_tpu_torch.profiling import (device_hbm_bytes,
                                                 device_memory_stats)

    x = torch.empty(1 << 20, device=cuda_device)
    stats = device_memory_stats()
    assert set(stats) == {"bytes_in_use", "peak_bytes_in_use",
                          "bytes_reserved", "peak_bytes_reserved",
                          "num_allocs", "bytes_limit"}
    assert stats["bytes_in_use"] >= x.numel() * 4
    assert stats["peak_bytes_in_use"] >= stats["bytes_in_use"]
    assert stats["bytes_limit"] == device_hbm_bytes(fallback=1) == (
        torch.cuda.get_device_properties(0).total_memory)
    assert device_memory_stats("cpu") == {}


def test_trace_window_names_the_kernels(rng, cuda_device, tmp_path):
    """A ``TraceCapture`` window opened on its own thread records the
    card's kernels launched by this one: the gate, lookup and
    lookup-backward kernels of one TINY training step."""
    import json
    import os
    import time

    from raft_stereo_tpu_torch.telemetry import TraceCapture
    from raft_stereo_tpu_torch.training.step import make_train_step

    cfg = RaftStereoConfig(**TINY)
    tc = TrainConfig(batch_size=2, train_iters=2, image_size=(64, 96))
    state = create_train_state(cfg, tc, cuda_device, seed=0)
    batch = {k: torch.from_numpy(v).to(cuda_device) for k, v in
             SyntheticStereoLoader(2, (64, 96), seed=1).batch(0).items()}
    step = make_train_step(tc)
    step(state, batch)                      # builds and warms the kernels
    torch.cuda.synchronize()
    capture = TraceCapture(root=str(tmp_path))
    info = capture.start(duration_ms=30_000)
    time.sleep(1.0)                         # the window opens
    step(state, batch)
    torch.cuda.synchronize()
    assert capture.stop() and capture.error is None
    events = json.load(open(os.path.join(info["trace_dir"], "trace.json")))[
        "traceEvents"]
    names = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    for kernel in ("gates_conv_kernel", "corr_lookup_kernel",
                   "corr_lookup_bwd_kernel"):
        assert any(kernel in n for n in names), (kernel, sorted(set(names)))


def test_cost_registry_records_a_real_capture(rng, cuda_device):
    from raft_stereo_tpu_torch.telemetry import (CompileRegistry,
                                                 MetricsRegistry)
    from raft_stereo_tpu_torch.telemetry.flops import forward_flops

    cfg = RaftStereoConfig(**TINY)
    torch.manual_seed(0)
    reg = CompileRegistry(registry=MetricsRegistry())
    runner = InferenceRunner(cfg, RAFTStereo(cfg).state_dict(), iters=2,
                             device="cuda", cost_registry=reg)
    left = rng.integers(0, 256, (64, 96, 3), dtype=np.uint8)
    for _ in range(3):
        runner(left, np.roll(left, -3, axis=1))
    (rec,) = reg.records()
    assert runner.captures == 1 and reg.compiles.value == 1
    assert rec.key == "eval.forward(64x96,b1)" and rec.site == "eval"
    assert rec.flops == forward_flops(cfg, (64, 96), 1, 2)
    assert not rec.degraded and rec.hbm_bytes > 0 and rec.compile_s > 0
    assert rec.device == torch.cuda.get_device_name(0)
    # the default config is fp32: MFU against the card's fp32 peak
    assert reg.peak_flops == 67e12 or "H100" not in rec.device


# --------------------------------------------------------------- serving
def _serving_pair(rng, hw=(60, 90)):
    left = rng.integers(0, 256, hw + (3,), dtype=np.uint8)
    return left, np.roll(left, -3, axis=1)


@pytest.mark.parametrize("tier", ["quality", "interactive", "turbo"])
def test_serving_batch1_replay_bit_equal_to_the_runner(rng, cuda_device,
                                                       tier):
    """The engine's batch-1 program of each tier, captured on its worker
    thread and replayed, gives the runner's replay bit for bit (the
    realtime architecture at TINY widths, 3 iterations)."""
    from raft_stereo_tpu_torch.config import parse_tier
    from raft_stereo_tpu_torch.serving import ServeConfig, ServingEngine

    cfg = RaftStereoConfig(**{**RaftStereoConfig.realtime().to_dict(),
                              **TINY})
    torch.manual_seed(0)
    state = RAFTStereo(cfg).state_dict()
    left, right = _serving_pair(rng)
    t = parse_tier(tier)
    runner = InferenceRunner(cfg, state, iters=3,
                             quant=None if t.quant == "off" else t.quant,
                             exit_threshold_px=t.exit_threshold_px,
                             exit_min_iters=t.min_iters)
    want, _ = runner(left, right)
    with ServingEngine(cfg, state, ServeConfig(
            iters=3, tiers=("quality", "interactive", "turbo"),
            batch_sizes=(1, 2))) as eng:
        for _ in range(2):                     # the capture, then a replay
            res = eng.infer(left, right, tier=tier, timeout=300)
            assert res.batch_size == 1
            assert np.array_equal(res.flow, want)
        assert eng.captures == 1 and eng.replays == 2
        if tier != "quality":
            assert res.iters_used == runner.last_iters_used


@pytest.mark.parametrize("tier", ["quality", "interactive", "turbo"])
def test_serving_batch_of_distinct_pairs_bit_equal_to_run_batch(
        rng, cuda_device, tier):
    """A batch of two distinct pairs replays the runner's batch-2 program:
    each row equals the runner's ``run_batch`` row bit for bit, at the
    runner's depth under an exit tier."""
    from raft_stereo_tpu_torch.config import parse_tier
    from raft_stereo_tpu_torch.serving import ServeConfig, ServingEngine

    cfg = RaftStereoConfig(**{**RaftStereoConfig.realtime().to_dict(),
                              **TINY})
    torch.manual_seed(0)
    state = RAFTStereo(cfg).state_dict()
    pairs = [_serving_pair(rng) for _ in range(2)]
    t = parse_tier(tier)
    runner = InferenceRunner(cfg, state, iters=3,
                             quant=None if t.quant == "off" else t.quant,
                             exit_threshold_px=t.exit_threshold_px,
                             exit_min_iters=t.min_iters)
    want, _ = runner.run_batch([p[0] for p in pairs], [p[1] for p in pairs])
    with ServingEngine(cfg, state, ServeConfig(
            iters=3, tiers=("quality", "interactive", "turbo"),
            batch_sizes=(1, 2))) as eng:
        eng.queue.pause()
        futures = [eng.submit(l, r, tier=tier) for l, r in pairs]
        eng.queue.resume()
        rows = [f.result(timeout=300) for f in futures]
    assert [r.batch_size for r in rows] == [2, 2]
    for res, row in zip(rows, want):
        assert np.array_equal(res.flow, row)
    if tier != "quality":
        assert {r.iters_used for r in rows} == {runner.last_iters_used}


@pytest.mark.parametrize("hidden", [False, True])
def test_session_chain_bit_equal_to_run_stream(rng, cuda_device, hidden):
    """A session of 4 coherent frames on the interactive tier (the
    realtime architecture at TINY widths, cap 3; random weights run to the
    cap, so the keyframe guard makes warm and cold alternate): each
    frame's replay of the state, warm (and with ``session_hidden`` the _h)
    graphs equals the runner's ``run_stream`` over the same chain bit for
    bit; two sessions' warm frames batch together, finite."""
    from raft_stereo_tpu_torch.serving import ServeConfig, ServingEngine

    cfg = RaftStereoConfig(**{**RaftStereoConfig.realtime().to_dict(),
                              **TINY})
    torch.manual_seed(0)
    state = RAFTStereo(cfg).state_dict()
    left, right = _serving_pair(rng, hw=(60, 100))
    frames = [(np.ascontiguousarray(left[:, k:k + 90]),
               np.ascontiguousarray(right[:, k:k + 90])) for k in range(4)]
    runner = InferenceRunner(cfg, state, iters=3, exit_threshold_px=0.5,
                             exit_min_iters=1)
    want, prev, hid = [], None, None
    for l, r in frames:
        f = runner.run_stream(l, r, prev_flow_low=prev, prev_hidden=hid,
                              carry_hidden=hidden)
        want.append(f)
        capped = f.warm and f.iters_used >= 3
        prev = None if capped else f.flow_low
        hid = None if capped else f.hidden
    with ServingEngine(cfg, state, ServeConfig(
            iters=3, tiers=("quality", "interactive:0.5:1"), sessions=True,
            session_hidden=hidden, batch_sizes=(1, 2))) as eng:
        for (l, r), w in zip(frames, want):
            res = eng.infer_session("s", l, r, tier="interactive",
                                    timeout=300)
            assert res.warm == w.warm and res.iters_used == w.iters_used
            assert np.array_equal(res.flow, w.flow)
            assert np.array_equal(res.flow_low, w.flow_low)
            if hidden:
                assert all(np.array_equal(a, b)
                           for a, b in zip(res.hidden, w.hidden))
        # two sessions on the fixed-depth tier (no keyframe guard there):
        # their second frames, warm, batch together
        for sid, (l, r) in zip(("u", "v"), frames[:2]):
            eng.infer_session(sid, l, r, tier="quality", timeout=300)
        eng.queue.pause()
        futs = [eng.submit_session(sid, *frames[2], tier="quality")
                for sid in ("u", "v")]
        eng.queue.resume()
        rows = [f.result(timeout=300) for f in futs]
        assert [x.batch_size for x in rows] == [2, 2]
        assert all(x.warm and np.isfinite(x.flow).all() for x in rows)
        assert eng.captures == len(eng.cached_programs())


def test_session_ctx_cache_hit_replays_the_reuse_program(rng, cuda_device):
    """The default architecture at TINY widths with the context cache: the
    cold frame's bundle stays on the card and is the eager ``ctx="save"``
    program's, a static scene's warm frames take it (the warm_ctx graph)
    and give the eager ``ctx="reuse"`` program's answer and the eager
    plain warm program's (which runs the context encoder again), bit for
    bit.  Two sessions' cold frames staged together keep each its own
    row's bundle, in storage of that row alone."""
    from raft_stereo_tpu_torch.eval.runner import make_forward
    from raft_stereo_tpu_torch.serving import ServeConfig, ServingEngine

    cfg = RaftStereoConfig(**TINY)
    torch.manual_seed(0)
    state = RAFTStereo(cfg).state_dict()
    left, right = _serving_pair(rng, hw=(64, 96))
    with ServingEngine(cfg, state, ServeConfig(
            iters=2, sessions=True, session_ctx_cache=True,
            batch_sizes=(1, 2))) as eng:
        cold = eng.infer_session("s", left, right, timeout=300)
        bundle = eng.sessions.get("s").ctx
        hits = [eng.infer_session("s", left, right, timeout=300)
                for _ in range(2)]
        model = eng.tier_model(None)
        prev = [cold.flow_low, hits[0].flow_low]
        eng.queue.pause()
        futs = [eng.submit_session(sid, left, right) for sid in ("u", "v")]
        eng.queue.resume()
        assert [f.result(timeout=300).batch_size for f in futs] == [2, 2]
        rows = [eng.sessions.get(sid).ctx for sid in ("u", "v")]
    assert [h.ctx_cached for h in hits] == [True, True]
    flat = lambda b: [t for level in b for part in level
                      for t in (part if isinstance(part, tuple) else (part,))]
    leaves = flat(bundle)
    assert len(leaves) == 12 and all(t.is_cuda for t in leaves)
    for row in rows:
        assert all(t.untyped_storage().nbytes()
                   == t.numel() * t.element_size() for t in flat(row))
    dev = lambda t: (t[None] if isinstance(t, torch.Tensor)
                     else torch.from_numpy(t[None]).cuda()
                     if isinstance(t, np.ndarray)
                     else tuple(dev(x) for x in t))
    save = make_forward(model, 2, return_state=True, ctx="save")
    reuse = make_forward(model, 2, warm_start=True, return_state=True,
                         ctx="reuse")
    plain = make_forward(model, 2, warm_start=True, return_state=True)
    with torch.inference_mode():
        up, low, want = save(dev(left), dev(right))
        assert np.array_equal(cold.flow, up[0].cpu().numpy())
        assert all(torch.equal(a, b[0]) for a, b in zip(leaves,
                                                        flat(want)))
        for h, p in zip(hits, prev):
            for out in (reuse(dev(left), dev(right), dev(p), dev(bundle)),
                        plain(dev(left), dev(right), dev(p))):
                assert np.array_equal(h.flow, out[0][0].cpu().numpy())
                assert np.array_equal(h.flow_low, out[1][0].cpu().numpy())


def test_serving_captures_on_a_worker_thread_while_scraped(rng,
                                                           cuda_device):
    """Prewarm captures every program on the engine's worker thread while
    another thread scrapes /metrics, /readyz and the device memory
    without pause; every capture succeeds and the answers stay the
    runner's."""
    import threading
    import urllib.error
    import urllib.request

    from raft_stereo_tpu_torch.profiling import device_memory_stats
    from raft_stereo_tpu_torch.serving import ServeConfig, ServingEngine
    from raft_stereo_tpu_torch.serving.http import StereoHTTPServer

    cfg = RaftStereoConfig(**TINY)
    torch.manual_seed(1)
    state = RAFTStereo(cfg).state_dict()
    left, right = _serving_pair(rng)
    want, _ = InferenceRunner(cfg, state, iters=2)(left, right)
    eng = ServingEngine(cfg, state, ServeConfig(
        iters=2, batch_sizes=(1, 2, 4), warmup_shapes=((60, 90),),
        prewarm_on_init=False))
    server = StereoHTTPServer(eng, port=0).start()
    stop, scrapes, errors = threading.Event(), [0], []

    def scrape():
        while not stop.is_set():
            try:
                for route in ("/metrics", "/readyz"):
                    urllib.request.urlopen(server.url + route, timeout=30)
            except urllib.error.HTTPError as e:
                if e.code != 503:              # /readyz while warming
                    errors.append(repr(e))
            except Exception as e:  # noqa: BLE001
                errors.append(repr(e))
            device_memory_stats()
            scrapes[0] += 1

    t = threading.Thread(target=scrape, daemon=True)
    t.start()
    try:
        eng.prewarm((60, 90))
        stop.set()
        t.join(timeout=30)
        assert errors == [] and scrapes[0] > 0
        assert eng.ready and eng.captures == 3
        assert np.array_equal(eng.infer(left, right, timeout=300).flow,
                              want)
    finally:
        stop.set()
        server.shutdown()
        eng.close()


# ------------------------------------------------------- remat policies
@pytest.mark.parametrize("saves", [("corr_lookup", "gru_gates"),
                                   ("gru_gates",),
                                   ("corr_lookup", "motion_features"),
                                   ("corr_lookup", "gru_gates",
                                    "motion_features")])
@pytest.mark.parametrize("arch", ["default", "realtime"])
def test_remat_policy_launches_and_gradients_on_card(cuda_device, saves,
                                                     arch):
    """A TINY step under each new ``remat_save`` on the card, under cuDNN's
    deterministic algorithms: the gate kernel launches 3 per iteration
    (6 without "gru_gates": the recompute), the lookup or alt kernel once
    per iteration where it runs before the region (twice where the region
    recomputes it) and its backward once, and every gradient leaf, the
    loss and grad_norm bit for bit the default policy's."""
    import dataclasses

    base = (dataclasses.replace(RaftStereoConfig.realtime(), **TINY)
            if arch == "realtime" else RaftStereoConfig(**TINY))
    torch.manual_seed(0)
    weights = RAFTStereo(base).state_dict()
    tc = TrainConfig(batch_size=1, train_iters=2, image_size=(64, 96),
                     num_steps=1000)
    batch = SyntheticStereoLoader(1, (64, 96), seed=2).batch(0)
    wrappers = (gru_gates_fused, lookup_pyramid_fused,
                lookup_pyramid_bwd_fused, alt_lookup_fused,
                alt_lookup_bwd_fused)

    def step(cfg):
        state = create_train_state(cfg, tc, "cuda", state_dict=weights)
        before = [w.launches for w in wrappers]
        state, metrics = train_step(state, batch, iters=2, loss_gamma=0.9,
                                    max_flow=700.0)
        torch.cuda.synchronize()
        return ({k: float(v) for k, v in metrics.items()},
                {n: p.grad.cpu() for n, p in state.model.named_parameters()},
                [w.launches - b for w, b in zip(wrappers, before)])

    with torch.backends.cudnn.flags(deterministic=True, benchmark=False):
        want_m, want_g, want_n = step(base)
        got_m, got_g, got_n = step(dataclasses.replace(base,
                                                       remat_save=saves))
    def lookups(kept):
        fwd = 2 if kept else 4          # recomputed inside the region
        return (0, 0, fwd, 2) if arch == "realtime" else (fwd, 2, 0, 0)

    assert want_n == [12, *lookups(True)]
    assert got_n == [6 if "gru_gates" in saves else 12,
                     *lookups("corr_lookup" in saves
                              or "motion_features" in saves)]
    assert got_m == want_m
    assert [n for n in want_g if not torch.equal(got_g[n], want_g[n])] == []


# ------------------------------------------------------ native decoders
def test_native_decoders_in_a_thread_beside_a_card_step(cuda_device,
                                                        tmp_path):
    """The port's native decoders on a loader-like thread while a TINY
    training step runs on the card: every decode bitwise the Python
    readers', the step's loss finite.  Skips where the host cannot build
    them (no libpng), with the compiler's reason."""
    import threading

    from PIL import Image

    from raft_stereo_tpu_torch import native
    from raft_stereo_tpu_torch.data import frame_utils as fu

    if not native.available():
        pytest.skip(f"native decoders unavailable on this host: "
                    f"{native.unavailable_reason()}")
    rng = np.random.default_rng(0)
    files = []
    for i in range(6):
        png = str(tmp_path / f"{i}.png")
        Image.fromarray(rng.integers(0, 256, (120, 200, 3),
                                     dtype=np.uint8)).save(png)
        pfm = str(tmp_path / f"{i}.pfm")
        fu.write_pfm(pfm, rng.normal(size=(120, 200)).astype(np.float32))
        files += [png, pfm]
    decoded, errors, stop = [], [], threading.Event()

    def decode():
        try:
            while not stop.is_set():
                for f in files:
                    decoded.append((f, native.read_pfm(f)
                                    if f.endswith(".pfm")
                                    else native.read_png_rgb8(f)))
        except Exception as e:  # noqa: BLE001
            errors.append(repr(e))

    torch.manual_seed(0)
    cfg = RaftStereoConfig(**TINY)
    tc = TrainConfig(batch_size=1, train_iters=2, image_size=(64, 96),
                     num_steps=1000)
    state = create_train_state(cfg, tc, "cuda",
                               state_dict=RAFTStereo(cfg).state_dict())
    batch = SyntheticStereoLoader(1, (64, 96), seed=2).batch(0)
    t = threading.Thread(target=decode, daemon=True)
    t.start()
    try:
        state, metrics = train_step(state, batch, iters=2, loss_gamma=0.9,
                                    max_flow=700.0)
        torch.cuda.synchronize()
    finally:
        stop.set()
        t.join(timeout=60)
    assert errors == [] and decoded
    assert np.isfinite(float(metrics["loss"]))
    want = {f: (fu._read_pfm_py(f) if f.endswith(".pfm")
                else np.asarray(Image.open(f))) for f in files}
    for f, got in decoded:
        assert got.dtype == want[f].dtype and np.array_equal(got, want[f])


def _realtime_tiny(seed=0):
    cfg = RaftStereoConfig(**{**RaftStereoConfig.realtime().to_dict(),
                              **TINY})
    torch.manual_seed(seed)
    return cfg, RAFTStereo(cfg).state_dict()


def test_tiled_request_bit_equal_to_run_batch(rng, cuda_device):
    """A 100-row pair past the tiling threshold: four 48-row tiles in one
    batch-4 dispatch, each row the runner's ``run_batch`` of the four
    slices bit for bit, the stitched flow ``tiles.stitch`` of those rows
    bit for bit."""
    from raft_stereo_tpu_torch.serving import ServeConfig, ServingEngine
    from raft_stereo_tpu_torch.serving import tiles

    cfg, state = _realtime_tiny()
    left, right = _serving_pair(rng, hw=(100, 90))
    specs = tiles.plan_tiles(100, 32, 8)
    runner = InferenceRunner(cfg, state, iters=3)
    rows, _ = runner.run_batch(
        [np.ascontiguousarray(left[s.src0:s.src1]) for s in specs],
        [np.ascontiguousarray(right[s.src0:s.src1]) for s in specs])
    with ServingEngine(cfg, state, ServeConfig(
            iters=3, batch_sizes=(1, 2, 4), tile_threshold_pixels=4000,
            tile_rows=32, tile_halo=8)) as eng:
        eng.queue.pause()
        fut = eng.submit(left, right)
        eng.queue.resume()
        res = fut.result(timeout=300)
        assert res.tiles == 4 and res.batch_size == 4
        assert eng.metrics.batches.value == 1
    assert np.array_equal(res.flow, tiles.stitch(list(rows), specs))
    assert res.seam_epe == tiles.seam_epe(list(rows), specs)


def test_cascade_answers_bit_equal_to_runner_replays(rng, cuda_device):
    """``tier="auto"``: each draft answer is the exit runner's replay, each
    escalated answer the fixed-depth runner's, bit for bit; the threshold
    sits between two draft confidences, so both kinds occur."""
    from raft_stereo_tpu_torch.serving import ServeConfig, ServingEngine

    cfg, state = _realtime_tiny()
    base, _ = _serving_pair(rng)
    pairs = []
    for c in (1.0, 0.25, 0.5, 0.1):
        l = (128 + (base.astype(np.float32) - 128) * c).astype(np.uint8)
        pairs.append((l, np.roll(l, -3, axis=1)))
    draft = InferenceRunner(cfg, state, iters=3, exit_threshold_px=0.5,
                            exit_min_iters=1)
    quality = InferenceRunner(cfg, state, iters=3)
    drafts = [draft(l, r) for l, r in pairs]
    tiers = ("quality", "interactive:0.5:1")
    with ServingEngine(cfg, state, ServeConfig(
            iters=3, tiers=tiers, confidence=True,
            batch_sizes=(1,))) as probe:
        confs = [probe.infer(l, r, tier="interactive",
                             timeout=300).confidence_mean for l, r in pairs]
    ordered = sorted(confs)
    i = int(np.argmax(np.diff(ordered)))
    thr = (ordered[i] + ordered[i + 1]) / 2
    with ServingEngine(cfg, state, ServeConfig(
            iters=3, tiers=tiers,
            confidence=True, cascade=True, cascade_threshold=thr,
            batch_sizes=(1,))) as eng:
        for (l, r), (dflow, _), conf in zip(pairs, drafts, confs):
            res = eng.infer(l, r, tier="auto", timeout=300)
            assert res.draft_tier == "interactive"
            assert res.escalated == (conf < thr)
            want = quality(l, r)[0] if res.escalated else dflow
            assert np.array_equal(res.flow, want)
        n = len(pairs)
        assert (eng._cascade_drafts.value
                + eng._cascade_escalations.value) == n
        assert 0 < eng._cascade_escalations.value < n


def test_named_models_bit_equal_and_retire_frees_memory(rng, cuda_device,
                                                         tmp_path):
    """Two published versions of other weights, registered: each answers
    as a runner on its weights, bit for bit; retiring one drops its
    graphs, and the allocator's reserved bytes fall by at least what its
    captures reserved."""
    import gc

    from raft_stereo_tpu_torch.serving import ServeConfig, ServingEngine
    from raft_stereo_tpu_torch.serving.models import ModelStore

    cfg, state = _realtime_tiny()
    store = ModelStore(str(tmp_path))
    versions = {}
    for v, seed in (("v1", 1), ("v2", 2)):
        _, sd = _realtime_tiny(seed)
        store.publish("m", v, cfg, sd)
        store.publish("n" + v, "1", cfg, sd)
        versions[v] = sd
    left, right = _serving_pair(rng)
    wants = {v: InferenceRunner(cfg, sd, iters=3)(left, right)[0]
             for v, sd in versions.items()}
    with ServingEngine(cfg, state, ServeConfig(
            iters=3, batch_sizes=(1,), model_store_dir=str(tmp_path),
            models=("m@v1", "nv2@1"))) as eng:
        assert np.array_equal(eng.infer(left, right, model="m",
                                        timeout=300).flow, wants["v1"])
        assert np.array_equal(eng.infer(left, right, model="nv2",
                                        timeout=300).flow, wants["v2"])
        eng.set_default_model("nv2")
        res = eng.infer(left, right, timeout=300)
        assert (res.model, res.model_version) == ("nv2", "1")
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        before = torch.cuda.memory_reserved()
        eng.retire_model("m")
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        assert torch.cuda.memory_reserved() < before
        assert eng.infer(left, right, timeout=300).model == "nv2"


def test_store_fed_build_runs_no_nvcc(cuda_device, tmp_path):
    """The compile farm fills a store; a process whose ``_build/`` is
    empty, with the store read-only, gets every library from it and runs
    no ``nvcc``; its libraries are the farm's bytes."""
    import subprocess
    import sys

    from raft_stereo_tpu_torch.kernels import _build
    from raft_stereo_tpu_torch.tools import compile_farm

    store = tmp_path / "store"
    assert compile_farm.main(["--out", str(store)]) == 0
    code = (
        "import json, pathlib, sys\n"
        "from raft_stereo_tpu_torch.kernels import _build\n"
        "from raft_stereo_tpu_torch.serving.persist import "
        "ExecutableDiskCache\n"
        f"_build.BUILD_DIR = pathlib.Path({str(tmp_path / 'empty')!r})\n"
        f"_build.set_artifact_store(ExecutableDiskCache({str(store)!r}, "
        "read_only=True))\n"
        "_build.build_all()\n"
        "print(json.dumps({'nvcc_runs': _build.nvcc_runs, "
        "'fetched': _build.fetched, 'libs': {n: _build.library_path(n)"
        ".read_bytes().hex()[:64] for n in _build.sources()}}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    import json
    got = json.loads(out[-1])
    assert got["nvcc_runs"] == 0
    assert got["fetched"] == len(_build.sources())
    assert got["libs"] == {n: _build.library_path(n).read_bytes().hex()[:64]
                           for n in _build.sources()}


def test_handoff_frame_bit_equal_to_run_stream(rng, cuda_device, tmp_path):
    """Engine A serves a session two frames (``session_hidden``) and
    publishes; engine B adopts it through the handoff key: B's next frame
    is the runner's ``run_stream`` from A's state, bit for bit.  A blob
    under another fingerprint is refused as ``config_mismatch``."""
    from raft_stereo_tpu_torch.serving import ServeConfig, ServingEngine

    cfg, state = _realtime_tiny()
    left, right = _serving_pair(rng, hw=(60, 100))
    frames = [(np.ascontiguousarray(left[:, k:k + 90]),
               np.ascontiguousarray(right[:, k:k + 90])) for k in range(3)]
    kw = dict(iters=3, sessions=True, session_hidden=True,
              batch_sizes=(1,), executable_cache_dir=str(tmp_path))
    with ServingEngine(cfg, state, ServeConfig(**kw)) as a:
        for l, r in frames[:2]:
            a.infer_session("s", l, r, timeout=300)
        sess = a.sessions.get("s")
        prev, hid = sess.flow_low.copy(), tuple(h.copy() for h in sess.hidden)
        manifest = a.publish_handoff()
    assert manifest["sessions"] == ["s"]
    runner = InferenceRunner(cfg, state, iters=3)
    want = runner.run_stream(*frames[2], prev_flow_low=prev,
                             prev_hidden=hid, carry_hidden=True)
    with ServingEngine(cfg, state, ServeConfig(**kw)) as b:
        res = b.infer_session("s", *frames[2],
                              handoff_key=manifest["artifact"], timeout=300)
        assert res.warm and res.warm_hidden and res.frame_index == 2
        assert np.array_equal(res.flow, want.flow)
        assert all(np.array_equal(x, y)
                   for x, y in zip(res.hidden, want.hidden))
    with ServingEngine(cfg, state, ServeConfig(**dict(kw, iters=4))) as c:
        res = c.infer_session("s", *frames[2],
                              handoff_key=manifest["artifact"], timeout=300)
        assert not res.warm
        assert c.metrics.handoff_skips("config_mismatch") == 1


# ------------------------------------------------------ the banded trunk
# In fp64: two fp32 computations that round differently flip a ReLU where
# a value lies within rounding of zero, and a flip moves the gradient of
# the pixels behind it by a whole upstream gradient (measured on these
# weights in fp32: one flip moves the input gradient by 2.76 against
# atol 0.17, the forward by 1.08e-5 on one element against 1e-5, while in
# fp64 banded and unbanded agree to 1e-13).  fp64 holds the banded
# executor's own arithmetic, its bands, halos, masks, statistics sweeps
# and checkpoints, to the CPU tests' bounds without that noise.
def _banded_trunks(norm_fn, device):
    """A seeded fp64 ``Trunk`` (downsample 2) on ``device`` with
    non-trivial frozen-BN statistics and affine terms."""
    from raft_stereo_tpu_torch.models.extractor import Trunk
    torch.manual_seed(0)
    trunk = Trunk(norm_fn, 2)
    gen = torch.Generator().manual_seed(7)
    for m in trunk.modules():
        if hasattr(m, "var") and isinstance(m.var, torch.Tensor):
            m.mean.normal_(0, 0.1, generator=gen)
            m.var.uniform_(0.5, 1.5, generator=gen)
            m.scale.data.normal_(1, 0.1, generator=gen)
            m.bias.data.normal_(0, 0.1, generator=gen)
    return trunk.to(device, torch.float64)


@pytest.mark.parametrize("norm_fn", ["instance", "batch", "none"])
@pytest.mark.parametrize("h,w,band", [(64, 96, 32), (70, 96, 32)])
def test_banded_trunk_matches_trunk_on_card(rng, cuda_device, norm_fn, h, w,
                                            band):
    """The banded trunk against the unbanded one on the card (the CPU
    tests' bound, 1e-5)."""
    from raft_stereo_tpu_torch.models.banded import banded_trunk_apply
    trunk = _banded_trunks(norm_fn, cuda_device)
    x = torch.from_numpy(rng.uniform(-1, 1, (2, 3, h, w))).to(cuda_device)
    with torch.no_grad():
        want = trunk(x)
        got = banded_trunk_apply(trunk, x, norm_fn, band=band)
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("norm_fn", ["instance", "batch"])
def test_banded_trunk_gradients_on_card(rng, cuda_device, norm_fn):
    """Gradients of the input and of every parameter through the banded
    trunk (checkpointed bands, statistics sweeps) against the unbanded
    trunk's on the card, at 70x64 with band 32 and a random cotangent:
    rtol 1e-3, atol 1e-4 x the largest gradient (the CPU tests' bound)."""
    from raft_stereo_tpu_torch.models.banded import banded_trunk_apply
    trunk = _banded_trunks(norm_fn, cuda_device)
    x0 = torch.from_numpy(rng.uniform(-1, 1, (2, 3, 70, 64))).to(cuda_device)
    probe = torch.from_numpy(rng.standard_normal((2, 128, 18, 16))).to(
        cuda_device)

    def grads(fn):
        trunk.zero_grad(set_to_none=True)
        x = x0.clone().requires_grad_()
        (fn(x) * probe).sum().backward()
        return x.grad, {n: p.grad.clone() for n, p in
                        trunk.named_parameters()}

    gx_p, gp_p = grads(trunk)
    gx_b, gp_b = grads(lambda x: banded_trunk_apply(trunk, x, norm_fn, 32))
    atol = 1e-4 * max(float(g.abs().max()) for g in gp_p.values())
    torch.testing.assert_close(gx_b, gx_p, rtol=1e-3, atol=atol)
    for name, g in gp_p.items():
        torch.testing.assert_close(gp_b[name], g, rtol=1e-3, atol=atol,
                                   msg=name)
