"""Host-side plans of the port's CUDA kernels, on the CPU (no JAX).

``plan_bwd`` chooses the channel chunk and pixel tile of the no-volume
correlation backward (kernel #8, ``csrc/corr_alt.cu``); ``bwd_smem_bytes``
mirrors the kernel's shared-memory layout (the card tests hold the two
counts equal).  Every shape a driven path gives the kernel, and every row
the earlier kernel accepted (its df2 of every level, fp32 over 32
channels, in one block's shared memory), must find a plan inside a
block's 232,448 bytes whose chunks cover D.

``plan_fwd`` chooses the pixel tile, channel chunk and band rows per pass
of the forward (kernels #6/#7/#9); ``fwd_smem_bytes`` mirrors its layout.
The forward refuses no shape the wrapper's ``_check`` accepts (any W2, D
up to 64 vectors of 16 bytes): a band wider than its rows is taken in
passes, and D in chunks where not even a pass of 64 rows fits.
"""

import pytest
import torch

from raft_stereo_tpu_torch.kernels.corr_alt import (_VEC, FWD_MIN_SEG,
                                                    MAX_BWD_CHUNK,
                                                    MAX_BWD_SMEM,
                                                    MAX_BWD_TILE,
                                                    MAX_FWD_SMEM,
                                                    bwd_smem_bytes,
                                                    fwd_smem_bytes, plan_bwd,
                                                    plan_fwd, tc_smem_bytes)

# (W1, W2 at level 0, levels, radius, D): the realtime training step
# (320x720 at 1/8), phase 15's realtime-fp32 step (64x128 at 1/8), the
# TINY configs of the CPU tests, the odd shapes of chip_smoke.py and of
# the card tests.
PATH_SHAPES = [(90, 90, 4, 4, 256), (16, 16, 4, 4, 256), (12, 12, 4, 4, 64),
               (37, 43, 4, 4, 64), (13, 7, 1, 4, 8), (156, 156, 4, 4, 256)]


def _w2s(w2, levels):
    return [max(w2 // 2 ** i, 1) for i in range(levels)]


def _pr3_bytes(w2s, radius):
    """The earlier kernel's shared bytes: the row's fp32 df2 of every
    level for 32 channels, the levels' df1 partials and window weights
    of a 32-pixel tile."""
    levels = len(w2s)
    return (4 * (sum(w2s) * 32 + levels * 32 * 32
                 + levels * 32 * (2 * radius + 4)) + 4 * 2 * levels * 32)


def _check_plan(w1, w2s, radius, d, itemsize):
    chunk, tile, tensor_cores = plan_bwd(w1, w2s, radius, d, itemsize)
    assert chunk % (16 // itemsize) == 0 and 0 < chunk <= d
    assert -(-d // chunk) * chunk >= d          # the chunks cover D
    assert 1 <= tile <= min(w1, MAX_BWD_TILE)
    if tensor_cores:
        assert itemsize == 2 and tile == w1
        assert tc_smem_bytes(w2s, radius, w1, chunk) <= MAX_BWD_SMEM
    else:
        assert bwd_smem_bytes(sum(w2s), len(w2s), radius, tile, chunk,
                              itemsize, w1) <= MAX_BWD_SMEM
    return chunk, tile, tensor_cores


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("w1,w2,levels,radius,d", PATH_SHAPES)
def test_path_shapes_take_one_tile(w1, w2, levels, radius, d, itemsize):
    chunk, tile, tensor_cores = _check_plan(w1, _w2s(w2, levels), radius, d,
                                            itemsize)
    assert tile == w1
    assert chunk == min(d, MAX_BWD_CHUNK)
    assert tensor_cores == (itemsize == 2)


def test_realtime_training_row_blocks_per_sm():
    """The realtime step's row (W1 90, W2 90/45/22/11, D 256): 64 channels
    per block, 1,280 blocks; the shared memory of an SM (233,472 bytes,
    1 KB of it reserved per block) holds three of the bf16 tensor-core
    kernel's (~63 KB) and two of the fp32 kernel's."""
    w2s = [90, 45, 22, 11]
    assert _check_plan(90, w2s, 4, 256, 2) == (64, 90, True)
    assert _check_plan(90, w2s, 4, 256, 4) == (64, 90, False)
    for smem, per_sm in ((tc_smem_bytes(w2s, 4, 90, 64), 3),
                         (bwd_smem_bytes(168, 4, 4, 90, 64, 4, 90), 2)):
        assert per_sm * (smem + 1024) <= 233472 < (per_sm + 1) * (smem + 1024)
    assert 320 * (256 // 64) == 1280


@pytest.mark.parametrize("levels", [1, 2, 4, 8])
@pytest.mark.parametrize("radius", [0, 4, 8])
@pytest.mark.parametrize("itemsize,d", [(2, 512), (4, 256)])
def test_widest_accepted_rows_still_plan(levels, radius, itemsize, d):
    """The widest level-0 width the earlier kernel took at these levels
    and radius (levels halving), under a W1 wider than any tile."""
    w2 = 1
    while _pr3_bytes(_w2s(w2 + 1, levels), radius) <= MAX_BWD_SMEM:
        w2 += 1
    w2s = _w2s(w2, levels)
    chunk, tile, tensor_cores = _check_plan(5000, w2s, radius, d, itemsize)
    assert tile < 5000 and not tensor_cores
    # and every narrower W1 as well
    for w1 in (1, 31, 90, 2047, 2049):
        _check_plan(w1, w2s, radius, d, itemsize)


def test_plan_refuses_what_cannot_fit():
    with pytest.raises(ValueError, match="shared memory"):
        plan_bwd(90, [20000, 10000], 4, 256, 2)


FWD_DTYPES = [torch.float32, torch.bfloat16, torch.int8, torch.float8_e4m3fn]
_FWD_ITEM = {torch.float32: 4, torch.bfloat16: 2, torch.int8: 1,
             torch.float8_e4m3fn: 2}


def _check_fwd_plan(w2s, radius, d, dtype):
    tile, chunk, seg = plan_fwd(w2s, radius, d, dtype)
    vec = _VEC[dtype]
    assert tile == 32
    assert chunk % vec == 0 and vec <= chunk <= d
    assert seg % 16 == 0 and 16 <= seg <= -(-sum(w2s) // 16) * 16
    out_item = 2 if dtype == torch.bfloat16 else 4
    assert fwd_smem_bytes(len(w2s), radius, tile, chunk, _FWD_ITEM[dtype],
                          seg, out_item) <= MAX_FWD_SMEM
    return tile, chunk, seg


@pytest.mark.parametrize("dtype", FWD_DTYPES)
@pytest.mark.parametrize("w2s", [[156, 78, 39, 19], [90, 45, 22, 11]])
def test_fwd_path_shapes_take_one_plan(w2s, dtype):
    """Inference (48 x 156) and the realtime training row (320 x 90) at D
    256: tiles of 32 pixels and 160 band rows or more per pass, so a
    coherent field's band (the tile plus one window per level, ~100 rows)
    takes one pass; D whole, but for fp32, whose 1 KB rows take it in two
    chunks."""
    tile, chunk, seg = _check_fwd_plan(w2s, 4, 256, dtype)
    assert (tile, chunk) == (32, 128 if dtype == torch.float32 else 256)
    assert seg >= FWD_MIN_SEG == 160


@pytest.mark.parametrize("dtype", FWD_DTYPES)
@pytest.mark.parametrize("levels,radius", [(1, 0), (4, 4), (8, 8)])
def test_fwd_widest_accepted_rows_still_plan(levels, radius, dtype):
    """The largest D ``_check`` accepts (64 vectors) under rows far wider
    than any pass: every level count and radius plans, in chunks where
    the fixed part leaves too few band rows."""
    d = 64 * _VEC[dtype]
    w2s = [max(100000 // 2 ** i, 1) for i in range(levels)]
    tile, chunk, seg = _check_fwd_plan(w2s, radius, d, dtype)
    assert seg >= FWD_MIN_SEG
    if (levels, radius) == (8, 8):
        assert chunk < d


def test_fwd_band_beyond_one_chunk_chunks():
    """fp32 at D 256 with 8 levels and radius 8: the tile's f1, window
    dots and staged outputs leave too few band rows at D whole (or half
    of it), so the plan cuts D into four chunks instead of raising."""
    w2s = [2000 // 2 ** i for i in range(8)]
    item = _FWD_ITEM[torch.float32]
    for chunk in (256, 128):
        assert fwd_smem_bytes(8, 8, 32, chunk, item, FWD_MIN_SEG,
                              4) > MAX_FWD_SMEM
    tile, chunk, seg = _check_fwd_plan(w2s, 8, 256, torch.float32)
    assert chunk == 64 and seg >= FWD_MIN_SEG
