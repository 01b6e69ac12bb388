"""The arithmetic and the host side of the tensor-core gate kernel
(csrc/gru_gates.cu), checked on the CPU.

The kernel runs only on the card (tests/test_torch_cuda.py holds it to
its plain version there).  What can be checked here:

- its fp32 arithmetic, emulated with plain torch: 3xTF32 (TF32 high and
  low parts, rounded by bit operations on fp32 as ``cvt.rna.tf32.f32``
  rounds) meets the card's tolerance against ``_gates_reference``, and a
  single TF32 pass does not, so that tolerance tells the two apart;
- the K-major weight packing it reads (round trip, zero padding, the TF32
  split), and the cache that packs once per weight tensor and version;
- the tile each launch gets at the driven paths' shapes.
"""

import numpy as np
import pytest
import torch

from raft_stereo_tpu_torch.kernels import gru_fused
from raft_stereo_tpu_torch.kernels.gru_fused import (_conv3x3_same,
                                                     _gates_reference, blocks,
                                                     pack_weights, split_tf32,
                                                     tf32_round, tile)

GATES_ATOL = 1e-4   # chip_smoke.py's tolerance for the fp32 gate kernel
H100_SMS = 132
# (B, H, W, Ch, Cx): the card tests' odd shapes and the TINY configs'
# levels (hidden_dims=(32, 32, 32)).
SHAPES = [(2, 17, 35, 32, 160), (2, 9, 20, 128, 256), (2, 16, 32, 32, 160),
          (2, 8, 16, 32, 64), (2, 4, 8, 32, 32)]


def _args(shape, seed=0):
    b, h, w, ch, cx = shape
    rng = np.random.default_rng(seed)
    cin = ch + cx
    ws = (2 / (9 * cin)) ** 0.5

    def arr(*s, scale=1.0):
        return torch.from_numpy((scale * rng.normal(size=s)).astype(
            np.float32))

    return (torch.tanh(arr(b, h, w, ch)), arr(b, h, w, cx), arr(b, h, w, ch),
            arr(3, 3, cin, 2 * ch, scale=ws), arr(2 * ch, scale=0.1),
            arr(3, 3, cin, ch, scale=ws), arr(ch, scale=0.1))


def _emulated(args, passes):
    """The gate function with every conv product in TF32: 3 passes
    (a_lo*b_hi + a_hi*b_lo + a_hi*b_hi) or one (a_hi*b_hi), fp32 sums."""
    h, x, cr, wzr, bzr, wq, bq = args
    ch = h.shape[-1]

    def conv(inp, w):
        a_hi, a_lo = split_tf32(inp)
        w_hi, w_lo = split_tf32(w)
        out = _conv3x3_same(a_hi, w_hi)
        if passes == 3:
            out = (_conv3x3_same(a_lo, w_hi) + _conv3x3_same(a_hi, w_lo)
                   + out)
        return out

    zr = conv(torch.cat([h, x], -1), wzr) + bzr
    r = torch.sigmoid(zr[..., ch:] + cr)
    return zr, conv(torch.cat([r * h, x], -1), wq) + bq


@pytest.mark.parametrize("shape", SHAPES)
def test_3xtf32_meets_the_tolerance_and_1xtf32_does_not(shape):
    args = _args(shape)
    want = _gates_reference(*args)
    err3 = max(float((g - w).abs().max())
               for g, w in zip(_emulated(args, 3), want))
    err1 = max(float((g - w).abs().max())
               for g, w in zip(_emulated(args, 1), want))
    assert err3 <= GATES_ATOL < err1


def test_tf32_round_is_cvt_rna():
    one = 1.0
    ulp = 2.0 ** -10
    x = torch.tensor([one + ulp / 2, one + ulp / 2 - 2 ** -20,
                      -(one + ulp / 2), one + 3 * ulp / 2, 3.0e-39, 0.0])
    got = tf32_round(x)
    want = torch.tensor([one + ulp, one, -(one + ulp), one + 2 * ulp,
                         float(tf32_round(torch.tensor([3.0e-39]))), 0.0])
    assert torch.equal(got, want)
    assert int((got.view(torch.int32) & 0x1FFF).abs().sum()) == 0


def _unpack(packed, cin):
    """Inverse of ``pack_weights``'s regrouping: (9, Cin'/E, Cout, E) ->
    (3, 3, Cin, Cout)."""
    nine, groups, cout, e = packed.shape
    return packed.permute(0, 1, 3, 2).reshape(nine, groups * e, cout)[
        :, :cin].reshape(3, 3, cin, cout)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cin,cout", [(40, 24), (384, 256)])
def test_packing_round_trips(dtype, cin, cout):
    w = torch.from_numpy(np.random.default_rng(1).normal(
        size=(3, 3, cin, cout)).astype(np.float32))
    packed = pack_weights(w, dtype)
    cin16 = -(-cin // 16) * 16
    e = 16 // torch.empty((), dtype=dtype).element_size()
    if dtype == torch.bfloat16:
        assert packed.shape == (9, cin16 // e, cout, e)
        assert torch.equal(_unpack(packed, cin), w.to(dtype))
        planes = [packed]
    else:
        assert packed.shape == (2, 9, cin16 // e, cout, e)
        hi, lo = (_unpack(p, cin) for p in packed)
        assert torch.equal(hi, tf32_round(w))
        assert float(((hi + lo - w).abs() / w.abs()).max()) <= 2.0 ** -21
        assert float(((w - hi).abs() / w.abs()).max()) <= 2.0 ** -11
        for p in packed:   # both planes hold TF32 values
            assert int((p.view(torch.int32) & 0x1FFF).abs().sum()) == 0
        planes = list(packed)
    for p in planes:       # the rows past Cin are zero
        rows = p.permute(0, 1, 3, 2).reshape(9, cin16, cout)
        assert not rows[:, cin:].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_packing_cache_follows_the_version_counter(dtype):
    conv = torch.nn.Conv2d(48, 32, 3)          # OIHW, as the model holds it
    hwio = conv.weight.permute(2, 3, 1, 0)     # the view the model passes
    before = gru_fused.gru_gates_fused.packs
    first = gru_fused._packed(hwio, dtype)
    assert gru_fused.gru_gates_fused.packs == before + 1
    again = gru_fused._packed(conv.weight.permute(2, 3, 1, 0), dtype)
    assert again is first                      # a new view: no repack
    assert gru_fused.gru_gates_fused.packs == before + 1
    with torch.no_grad():
        conv.weight.mul_(2.0)                  # an optimizer step, in place
    updated = gru_fused._packed(conv.weight.permute(2, 3, 1, 0), dtype)
    assert gru_fused.gru_gates_fused.packs == before + 2
    assert torch.equal(updated, pack_weights(
        conv.weight.detach().permute(2, 3, 1, 0), dtype))
    assert not torch.equal(updated, first)
    other = torch.nn.Conv2d(48, 32, 3).weight.permute(2, 3, 1, 0)
    gru_fused._packed(other, dtype)            # another tensor, its own pack
    assert gru_fused.gru_gates_fused.packs == before + 3


def test_group_weight_copies_are_ordinary_tensors():
    """The context-parallel groups' weight copies made under inference
    mode are ordinary tensors, which the packing cache can version
    (parallel/group.moved_state); trained, they are differentiable."""
    from raft_stereo_tpu_torch.parallel.group import moved_state

    conv = torch.nn.Conv2d(48, 32, 3)
    with torch.inference_mode():
        moved = moved_state(conv, torch.device("meta"))
    assert not any(t.is_inference() for t in moved.values())
    assert not any(t.requires_grad for t in moved.values())
    assert moved_state(conv, torch.device("cpu")) is None
    trained = moved_state(conv, torch.device("meta"))
    assert trained["weight"].requires_grad      # differentiable copies


# (B, H, W, Cout, tile, blocks) of each gate launch on the driven paths.
LAUNCHES = [((1, 96, 312), 256, (128, 2, 1), 480),   # default gru08 zr
            ((1, 96, 312), 128, (128, 2, 1), 240),   # default gru08 q
            ((1, 48, 156), 256, (128, 2, 1), 120),   # default gru16,
            ((1, 48, 156), 128, (128, 2, 2), 120),   # realtime gru08
            ((1, 24, 78), 256, (64, 2, 2), 120),     # default gru32,
            ((1, 24, 78), 128, (64, 1, 2), 120),     # realtime gru16
            ((8, 80, 180), 256, (128, 2, 1), 1920),  # training gru08
            ((8, 40, 90), 128, (128, 2, 1), 240),    # realtime training
            ((2, 4, 8), 64, (64, 1, 2), 4)]          # TINY gru32


@pytest.mark.parametrize("shape,cout,want,n", LAUNCHES)
def test_tile_per_launch(shape, cout, want, n):
    assert tile(shape, cout, H100_SMS) == want
    assert blocks(shape, cout, *want) == n
