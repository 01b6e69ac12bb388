"""The port's CUDA kernels against their plain versions, on the card.

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
from raft_stereo_tpu_torch.kernels.corr_alt import (alt_lookup_fused,
                                                    alt_lookup_xla)
from raft_stereo_tpu_torch.kernels.corr_lookup import (lookup_pyramid_fused,
                                                       lookup_pyramid_xla)
from raft_stereo_tpu_torch.kernels.gru_fused import (_gates_reference,
                                                     gru_gates_fused)
from raft_stereo_tpu_torch.models.corr import build_corr_pyramid, pool_axis
from raft_stereo_tpu_torch.models.raft_stereo import RAFTStereo
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
    gpu = InferenceRunner(cfg, state, iters=1)(left, right)[0]
    assert alt_lookup_fused.launches == alts + 1
    assert gru_gates_fused.launches == gates + 3   # gru16 twice, gru08
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
    gpu = InferenceRunner(cfg, state, iters=1)(left, right)[0]
    assert lookup_pyramid_fused.launches == lookups + 1
    assert gru_gates_fused.launches == gates + 3
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
    assert gru_gates_fused.launches == gates + 3  # ran on the card
    cpu = InferenceRunner(cfg, state, iters=1, device="cpu").disparity(
        left, right)
    np.testing.assert_allclose(np.load(out / "im0.npy"), cpu, atol=1e-3,
                               rtol=0)
    assert (out / "im0-disparity.png").exists()
