"""The banded (streaming) trunk: the encoders' full-resolution segment in
horizontal bands (the JAX package's ``models/banded.py``, NCHW).

With ``n_downsample=2`` the trunk's stem runs at the image's full
resolution, and its activations, not the correlation, set the peak device
memory of a large pair.  ``banded_trunk_apply`` runs that segment (the 7x7
stem, layer1 and layer2_0's two stride-2 entry convs) band by band, so
only band-sized tensors exist at full resolution:

* Each band carries ``_HALO`` rows above and below (the segment's
  receptive-field half-width), runs the trunk's own convs and norms, and
  crops the halo, so interior rows equal the full-image computation.
  Every activation is masked to the image's rows: at the image's top and
  bottom the halo rows then hold the zeros of the full-image conv's
  padding.
* Frozen batch norm and ``none`` are elementwise: one sweep.
* Instance norm needs each (sample, channel)'s statistics over the whole
  image, so each of the segment's five instance norms adds a sweep that
  recomputes the bands through the statistics already known and gathers
  the next norm's moments (two-pass per band, combined by Chan's formula):
  six sweeps in all.

Under autograd every band of every sweep runs under
``torch.utils.checkpoint`` (non-reentrant): the backward recomputes a
band instead of keeping its activations, and the gradient flows through
the instance-norm statistics as through the full-image norm.

The functions act on the port's ``Trunk`` submodules (their ``Conv2d``
weights and norm modules), so parameters and checkpoints are those of the
unbanded trunk; from layer2_0's norms on, the trunk runs unbanded at half
resolution or less (``trunk_tail``).  Supported: ``n_downsample=2`` with
norm ``instance``, ``batch`` or ``none`` (``banded_supported``).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from raft_stereo_tpu_torch.models.norm import InstanceNorm, stats_dtype

# receptive-field half-width of the banded segment: the 7x7 stem (3),
# four 3x3 convs (1 each) and layer2_0's 3x3 stride-2 entry (1); even, so
# a band's stride-2 outputs align with the image's
_HALO = 8
_N_INSTANCE_STATS = 5  # the stem's norm1 and two per layer1 block

def masked_moments(t: torch.Tensor, m: torch.Tensor, width: int):
    """Per-(sample, channel) mean and sum of squared deviations of ``t``
    (N, C, rows, W) over the rows where the broadcastable bool mask ``m``
    is set (in fp32, or fp64), and the element count: the two-pass form (mean, then M2),
    which does not cancel at many-megapixel counts in fp32 as
    E[x^2] - mean^2 does."""
    t = torch.where(m, t.to(stats_dtype(t)), 0.0)
    n = m.float().sum() * width
    mean = t.sum(dim=(2, 3)) / n                              # (N, C)
    dev = torch.where(m, t - mean[:, :, None, None], 0.0)
    m2 = (dev * dev).sum(dim=(2, 3))
    return mean, m2, n


def chan_combine(means: torch.Tensor, m2s: torch.Tensor, ns: torch.Tensor):
    """Chan's parallel-variance combination of stacked per-chunk moments,
    (k, N, C), (k, N, C), (k,) -> the global ``(mean, var)``, (N, C)
    each."""
    total = ns.sum()
    mean = (means * ns[:, None, None]).sum(dim=0) / total
    m2 = m2s.sum(dim=0) + (ns[:, None, None]
                           * (means - mean[None]).square()).sum(dim=0)
    return mean, m2 / total


def _norm(module: torch.nn.Module, x: torch.Tensor,
          stats: Optional[Tuple[torch.Tensor, torch.Tensor]]
          ) -> torch.Tensor:
    """The trunk's norm ``module`` on ``x``; an instance norm with the
    global ``stats`` (mean, var), (N, C, 1, 1) fp32, where given."""
    if stats is not None and isinstance(module, InstanceNorm):
        mean, var = stats
        return ((x.to(stats_dtype(x)) - mean)
                * (1.0 / torch.sqrt(var + module.eps))).to(x.dtype)
    return module(x)


def _segment(trunk, xb: torch.Tensor, stats, upto: int,
             row_mask: torch.Tensor):
    """The full-resolution segment of ``trunk`` on one haloed band
    ``xb`` (N, 3, rows, W).

    ``upto`` 1..5 returns the input of instance norm ``upto`` (a
    statistics sweep); 6 returns layer2_0's two stride-2 conv outputs.
    ``stats``: the instance norms' (mean, var) so far, or None (batch or
    no norm); or a callable ``stats(k, t) -> (mean, var)`` giving norm
    ``k``'s global statistics from its input ``t`` as the segment reaches
    it (one pass pausing at each norm, the row-sharded executor's use:
    ``parallel/rows_sharded.py`` drives ``_segment_steps`` itself to run
    its shards in step).  ``row_mask`` (rows,) is True on the band's rows
    inside the image; every activation is masked with it."""
    steps = _segment_steps(trunk, xb, upto, row_mask)
    reply = None
    while True:
        try:
            k, t = steps.send(reply)
        except StopIteration as done:
            return done.value
        if callable(stats):
            reply = stats(k, t)
        else:
            reply = stats[k] if stats else None


def _segment_steps(trunk, xb: torch.Tensor, upto: int,
                   row_mask: torch.Tensor):
    """``_segment`` as a generator: yields ``(k, t)`` at each norm ``k``
    (t its input) and takes that norm's (mean, var) or None back."""
    m = row_mask[None, None, :, None]
    l10, l11, l20 = trunk.layer1_0, trunk.layer1_1, trunk.layer2_0

    def mask(t):
        return torch.where(m, t, torch.zeros((), dtype=t.dtype,
                                             device=t.device))

    t1 = trunk.conv1(xb)
    if upto == 1:
        return t1
    a1 = mask(F.relu(_norm(trunk.norm1, t1, (yield 0, t1))))
    t2 = l10.conv1(a1)
    if upto == 2:
        return t2
    a2 = mask(F.relu(_norm(l10.norm1, t2, (yield 1, t2))))
    t3 = l10.conv2(a2)
    if upto == 3:
        return t3
    b1 = mask(F.relu(a1 + F.relu(_norm(l10.norm2, t3, (yield 2, t3)))))
    t4 = l11.conv1(b1)
    if upto == 4:
        return t4
    a4 = mask(F.relu(_norm(l11.norm1, t4, (yield 3, t4))))
    t5 = l11.conv2(a4)
    if upto == 5:
        return t5
    b2 = mask(F.relu(b1 + F.relu(_norm(l11.norm2, t5, (yield 4, t5)))))
    return l20.conv1(b2), l20.downsample_conv(b2)


def trunk_tail(trunk, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """layer2_0's tail, layer2_1 and layer3 at half resolution or less,
    from the segment's two stride-2 outputs (``_segment`` upto=6)."""
    l20 = trunk.layer2_0
    y = F.relu(l20.norm1(u))
    y = F.relu(l20.norm2(l20.conv2(y)))
    x = F.relu(l20.norm3(v) + y)
    x = trunk.layer2_1(x)
    return trunk.layer3_1(trunk.layer3_0(x))


# Band sizing, from the card (chip_smoke.py phase 37 (b), an H100 80GB
# HBM3 at 700 W, fp32): one band's working set (the segment's last sweep,
# the allocator's peak above its input) grew by 3008 bytes per band row
# and image column (and sample) from bands of 128 to 512 rows (1.162 to
# 4.260 GiB at width 2880).  The whole trunk's peak is nearly flat in the
# band (5.42 to 5.32 GiB; its half-resolution tail dominates), and the
# trunk was fastest at 512 rows of the three (0.503, 0.450, 0.428 s).
_BAND_BYTES_PER_ROW_PIXEL = 3008
# Share of the device's memory one band's working set may take: the
# share (0.0522 of 79.2 GiB) that gives that 2880-wide image on that card
# the sweep's fastest band, 512 rows.
_BAND_MEMORY_FRACTION = 0.0522
_BAND_MIN, _BAND_MAX = 64, 1024


def default_band_rows(n: int, w: int,
                      device: Union[str, torch.device] = "cpu") -> int:
    """The largest even band whose working set ``n * w * band *
    _BAND_BYTES_PER_ROW_PIXEL`` stays under ``_BAND_MEMORY_FRACTION`` of
    the device's memory, clamped to [64, 1024]: the card's own total
    memory on a CUDA device, the JAX package's 16 GiB assumption
    elsewhere (models/raft_stereo.py ``_CPU_MEMORY_BYTES``)."""
    from raft_stereo_tpu_torch.models.raft_stereo import device_memory_bytes
    budget = _BAND_MEMORY_FRACTION * device_memory_bytes(torch.device(device))
    band = int(budget // (max(n, 1) * w * _BAND_BYTES_PER_ROW_PIXEL))
    return max(_BAND_MIN, min(_BAND_MAX, band - band % 2))


def _run(fn, *args):
    """``fn(*args)``, under a non-reentrant checkpoint where autograd
    records: the backward recomputes it."""
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False)
    return fn(*args)


def banded_trunk_apply(trunk, x: torch.Tensor, norm_fn: str,
                       band: Optional[int] = None) -> torch.Tensor:
    """``trunk(x)`` (a ``Trunk`` with ``downsample=2``) with its
    full-resolution stages streamed in bands of ``band`` rows (None:
    ``default_band_rows``): the quarter-resolution trunk output."""
    if not banded_supported(norm_fn, 2):
        raise NotImplementedError(
            f"banded trunk does not support norm_fn={norm_fn!r}")
    n, _, h, w = x.shape
    if band is None:
        band = default_band_rows(n, w, x.device)
    if band % 2:
        raise ValueError(f"band={band} must be even for stride-2 alignment")
    nb = -(-h // band)
    xp = F.pad(x, (0, 0, _HALO, nb * band - h + _HALO))
    bands = [xp[:, :, i * band: i * band + band + 2 * _HALO]
             for i in range(nb)]
    rows = torch.arange(band + 2 * _HALO, device=x.device)
    masks = [((rows + i * band - _HALO) >= 0) & ((rows + i * band - _HALO)
                                                  < h)
             for i in range(nb)]
    inner = [(torch.arange(band, device=x.device) + i * band < h)[
        None, None, :, None] for i in range(nb)]

    stats: List[Tuple[torch.Tensor, torch.Tensor]] = []
    if norm_fn == "instance":
        for k in range(1, _N_INSTANCE_STATS + 1):
            def stat_band(xb, i, *flat, k=k):
                known = list(zip(flat[0::2], flat[1::2]))
                t = _segment(trunk, xb, known, k, masks[i])
                return masked_moments(t[:, :, _HALO:_HALO + band], inner[i],
                                      w)
            flat = [s for pair in stats for s in pair]
            moments = [_run(stat_band, bands[i], i, *flat)
                       for i in range(nb)]
            mean, var = chan_combine(
                torch.stack([mo[0] for mo in moments]),
                torch.stack([mo[1] for mo in moments]),
                torch.stack([mo[2] for mo in moments]))
            stats.append((mean[:, :, None, None], var[:, :, None, None]))

    def final_band(xb, i, *flat):
        known = list(zip(flat[0::2], flat[1::2])) or None
        u, v = _segment(trunk, xb, known, 6, masks[i])
        crop = slice(_HALO // 2, _HALO // 2 + band // 2)
        return u[:, :, crop], v[:, :, crop]

    flat = [s for pair in stats for s in pair]
    outs = [_run(final_band, bands[i], i, *flat) for i in range(nb)]
    h2 = -(-h // 2)   # the stride-2 conv's output height
    u = torch.cat([o[0] for o in outs], dim=2)[:, :, :h2]
    v = torch.cat([o[1] for o in outs], dim=2)[:, :, :h2]
    return trunk_tail(trunk, u, v)


def banded_supported(norm_fn: str, downsample: int) -> bool:
    return downsample == 2 and norm_fn in ("instance", "batch", "none")
