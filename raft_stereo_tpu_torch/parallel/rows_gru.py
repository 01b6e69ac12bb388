"""Context-parallel (image-row-sharded) GRU refinement loop (the JAX
package's ``parallel/rows_gru.py``, NCHW).

``rows_sharded.py`` shards the encoders' full-resolution segment; this
module carries the row sharding through the rest of the forward: the
correlation volume, every iteration's multilevel ConvGRU update and the
convex upsampling, over the ``rows`` devices of a group driven by this
one process.  The volume and the loop's per-iteration state stay split
over the shards; the fine-level feature and context maps come in whole
(on the group's first device) and each shard copies its window of them.

Design: clamped extended windows, refreshed halos.

* Row geometry.  Shard ``i`` owns fine-level rows ``[i*slab,
  (i+1)*slab)`` and computes on the window ``[start_i, start_i + slab +
  2*halo)`` with ``start_i = clamp(i*slab - halo, 0, H - slab - 2*halo)``.
  Every window row is a real image row, so the update block needs no row
  mask: at window edges inside the image the SAME-padding error stays at
  least ``halo`` rows from the owned rows, and at the image's own top and
  bottom the window edge is the image edge.
* The static tensors (feature maps, hence each shard's correlation
  volume and pyramid, and the per-level context biases) are windowed once
  per forward.  Halos halve with resolution (``halo >> level``).
* The per-iteration state (GRU hidden states, disparity, upsampling mask)
  is cropped to the owned rows after each iteration and re-windowed
  before the next from the neighbours' crops: the only steady-state
  exchange, ``2*halo`` rows per level per iteration.
* The align-corners ``interp`` between GRU levels is not shift-invariant
  (its grid depends on the GLOBAL heights, ops/resize.py), so each shard
  applies the global interpolation matrix restricted to its window rows
  (``_restricted_rows_interp``, built once on the host); source rows just
  outside the window (at most 1, a property of the align-corners grid)
  are clamped to its edge, which touches window-edge rows only.
* Exactness: the owned rows equal the unsharded loop up to float
  reassociation where ``halo`` covers one iteration's row receptive field
  (``default_gru_halo``); gradients likewise, since the crops drop every
  polluted row's gradient and every copy transposes to a copy back.

Each shard's lookup is kernel #1 (``reg_fused``) on its windowed pyramid,
and each shard's gates kernel #5 on its window.  The JAX executor pins
its inputs' shardings (``_pin``) to steer XLA's SPMD partitioner; an
eager single controller places every tensor itself, so that has no
counterpart here.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
from torch.profiler import record_function
from torch.utils.checkpoint import checkpoint

from raft_stereo_tpu_torch.config import RaftStereoConfig
from raft_stereo_tpu_torch.models import remat
from raft_stereo_tpu_torch.ops.grids import coords_grid_x
from raft_stereo_tpu_torch.ops.resize import _interp_matrix, interp_matrix_np
from raft_stereo_tpu_torch.ops.upsample import convex_upsample
from raft_stereo_tpu_torch.parallel.group import moved_state, on_device
from raft_stereo_tpu_torch.parallel.mesh import Mesh


def default_gru_halo(cfg: RaftStereoConfig) -> int:
    """Fine-level halo rows covering one iteration's row receptive field:
    the motion encoder (<= 5 rows, its 7x7 flow conv), the ConvGRU convs
    (<= 2), the flow and mask heads (<= 2) and the interp's window-edge
    error (<= 2) come to <= 11 fine rows, and the mid and coarse levels
    shrink <= 5 and <= 2 rows at their own resolution against halves of
    the halo: 16.  ``slow_fast_gru`` with 3 GRU levels runs the coarse GRU
    three times an iteration, tripling the coarse shrink against a
    quarter of the halo: 32."""
    if cfg.slow_fast_gru and cfg.n_gru_layers == 3:
        return 32
    return 16


def _geometry(h_f: int, n: int, halo: int):
    """Per-shard clamped window geometry at the fine level (numpy)."""
    slab = h_f // n
    idx = np.arange(n)
    starts = np.clip(idx * slab - halo, 0, h_f - slab - 2 * halo)
    off_ext = starts - (idx * slab - 2 * halo)   # offset into the 4h-extended slab
    own_off = idx * slab - starts                # owned rows' offset in the window
    return slab, starts, off_ext, own_off


def _restricted_rows_interp(h_src: int, h_dst: int, starts_src, starts_dst,
                            len_src: int, len_dst: int) -> np.ndarray:
    """The global align-corners interp matrix restricted to each shard's
    window: (n, len_dst, len_src), rows ``starts_dst[i] : +len_dst`` of
    the global ``(h_dst, h_src)`` matrix with the source columns clamped
    into ``starts_src[i] : +len_src`` (only window-edge outputs are
    affected)."""
    mg = interp_matrix_np(h_src, h_dst)          # (h_dst, h_src)
    n = len(starts_src)
    out = np.zeros((n, len_dst, len_src), np.float32)
    for i in range(n):
        block = mg[starts_dst[i]:starts_dst[i] + len_dst]
        rel = np.arange(h_src) - starts_src[i]
        cols = np.clip(rel, 0, len_src - 1)
        # the window-edge clamp is sound only while align-corners sources
        # fall at most 1 row outside the window; an explicit raise, not
        # ``assert`` (python -O strips asserts, which would misplace
        # weight silently)
        carries = np.abs(block).sum(axis=0) > 0
        clamp_dist = np.abs(rel - cols)
        if int(clamp_dist[carries].max(initial=0)) > 1:
            raise AssertionError(
                "rows_gru: interp source row falls more than 1 row outside "
                "its device window — _interp_matrix semantics changed; "
                "re-derive the halo geometry")
        acc = np.zeros((len_src, len_dst), np.float32)
        np.add.at(acc, cols, block.T)
        out[i] = acc.T
    return out


def _make_window_interp(row_mats):
    """The update block's ``interp_fn`` from one shard's row matrices:
    ``row_mats`` {(src_rows, dst_rows): (dst_rows, src_rows) fp32 tensor}.
    The width pass uses the global matrix (W is not sharded).  As
    ``ops/resize.py``: the matrices rounded to the activation dtype, each
    pass summed in fp32 and rounded once."""

    def interp_fn(x: torch.Tensor, dest: torch.Tensor) -> torch.Tensor:
        sh, sw = x.shape[-2:]
        dh, dw = dest.shape[-2:]
        m = row_mats.get((sh, dh))
        if m is None:
            # a window-local align-corners resize would be SILENTLY
            # wrong (its grid must come from the global heights)
            raise KeyError(
                f"rows_gru: no restricted interp matrix for window rows "
                f"{sh}->{dh}; registered sites: {sorted(row_mats)} — a new "
                f"update-block interp site must be added to the executor's "
                f"interp_shapes")
        dtype = x.dtype
        y = torch.einsum("bchw,oh->bcow", x.float(),
                         m.to(dtype).float()).to(dtype)
        if sw != dw:
            mx = _interp_matrix(sw, dw, x.device, dtype)
            y = torch.einsum("bchw,ow->bcho", y.float(), mx).to(dtype)
        return y

    return interp_fn


def validate_rows_gru(cfg: RaftStereoConfig, h_f: int, n: int) -> int:
    """Check the geometry; return the fine-level halo."""
    halo = cfg.rows_gru_halo or default_gru_halo(cfg)
    align = 2 ** (cfg.n_gru_layers - 1)
    if h_f % n:
        raise ValueError(f"rows_gru: fine-level height {h_f} not divisible "
                         f"by rows_shards={n}")
    slab = h_f // n
    if slab % align or halo % 4:
        raise ValueError(
            f"rows_gru: per-shard fine rows {slab} must be divisible by "
            f"{align} and halo {halo} by 4 (GRU pyramid alignment)")
    if slab < 2 * halo:
        raise ValueError(
            f"rows_gru: per-shard fine rows H/f/n = {slab} < 2*halo = "
            f"{2 * halo}; a single ppermute exchange can only source rows "
            f"from the adjacent shard — use fewer shards, a larger image, "
            f"or a smaller rows_gru_halo (≥ the per-iteration receptive "
            f"field; see default_gru_halo)")
    return halo


def rows_sharded_gru_loop(cfg: RaftStereoConfig, dtype: torch.dtype,
                          update_block, fmap1: torch.Tensor,
                          fmap2: torch.Tensor,
                          net_list: Sequence[torch.Tensor],
                          context: Sequence[Tuple[torch.Tensor, ...]],
                          disp0: torch.Tensor, iters: int, test_mode: bool,
                          mesh: Mesh, axis: str):
    """The refinement loop with image rows split over ``mesh``'s ``axis``
    devices.

    Every tensor argument is the whole (B, C, H_l, W_l) tensor from the
    encoders (``disp0`` (B, H, W)), on the group's first device.  Returns
    what the model's loop returns there: the (iters, B, H, W) upsampled
    flow of every iteration (train), or ``(flow_low, flow_up)`` (test),
    equal to the unsharded loop up to float reassociation."""
    from raft_stereo_tpu_torch.models.corr import make_corr_fn

    devices = mesh.axis_devices(axis)
    n = len(devices)
    if n != cfg.rows_shards or n < 2:
        raise ValueError(f"rows_gru: mesh axis {axis!r} size {n} != "
                         f"rows_shards={cfg.rows_shards} (need >= 2)")
    levels = cfg.n_gru_layers
    b, _, h_f, w_f = net_list[0].shape
    factor = cfg.downsample_factor
    halo = validate_rows_gru(cfg, h_f, n)
    slab, starts, _, own_off = _geometry(h_f, n, halo)
    for l in range(levels):
        if net_list[l].shape[2] != (h_f >> l):
            raise ValueError(
                f"rows_gru: level {l} height {net_list[l].shape[2]} != "
                f"{h_f >> l} — GRU levels must be exact halves")
    out_device = disp0.device

    def win_rows(l: int, i: int) -> Tuple[int, int]:
        """Shard i's window at level l: (first global row, rows)."""
        return int(starts[i]) >> l, (slab >> l) + 2 * (halo >> l)

    def window_of(t: torch.Tensor, l: int, i: int, dim: int
                  ) -> torch.Tensor:
        """Shard i's window of a whole tensor (the static inputs)."""
        s, rows = win_rows(l, i)
        return t.narrow(dim, s, rows).to(devices[i])

    def window(parts: Sequence[torch.Tensor], l: int, i: int, dim: int
               ) -> torch.Tensor:
        """Shard i's window assembled from the shards' owned rows (its
        own and its neighbours'), copied to its device."""
        s, rows = win_rows(l, i)
        sl = slab >> l
        pieces = []
        for j, part in enumerate(parts):
            lo, hi = max(s, j * sl), min(s + rows, (j + 1) * sl)
            if lo < hi:
                pieces.append(part.narrow(dim, lo - j * sl, hi - lo).to(
                    devices[i]))
        return torch.cat(pieces, dim=dim)

    def crop(t: torch.Tensor, l: int, i: int, dim: int, scale: int = 1
             ) -> torch.Tensor:
        return t.narrow(dim, (int(own_off[i]) >> l) * scale,
                        (slab >> l) * scale)

    def gather(parts: Sequence[torch.Tensor], dim: int) -> torch.Tensor:
        return torch.cat([p.to(out_device) for p in parts], dim=dim)

    # restricted interp matrices of the cross-resolution sites (level
    # l+1 -> l), keyed by (src_rows, dst_rows) window sizes
    shard_mats = [dict() for _ in range(n)]
    for l in range(levels - 1):
        len_dst = (slab >> l) + 2 * (halo >> l)
        len_src = (slab >> (l + 1)) + 2 * (halo >> (l + 1))
        mats = _restricted_rows_interp(h_f >> (l + 1), h_f >> l,
                                       starts >> (l + 1), starts >> l,
                                       len_src, len_dst)
        for i, dev in enumerate(devices):
            shard_mats[i][(len_src, len_dst)] = torch.from_numpy(
                mats[i]).to(dev)
    interps = [_make_window_interp(m) for m in shard_mats]

    # the static windows, once per forward
    corr_fns = [make_corr_fn(cfg, window_of(fmap1, 0, i, 2),
                             window_of(fmap2, 0, i, 2)) for i in range(n)]
    ctx_w = [[tuple(window_of(c, l, i, 2) for c in context[l])
              for l in range(levels)] for i in range(n)]
    moved = [moved_state(update_block, dev) for dev in devices]
    rows_w = slab + 2 * halo
    grids = [coords_grid_x(b, rows_w, w_f, device=dev) for dev in devices]

    def lookup(i, disp_w):
        return corr_fns[i](grids[i] + disp_w).to(dtype).permute(0, 3, 1, 2)

    def flow2(disp_w):
        return torch.stack([disp_w, torch.zeros_like(disp_w)],
                           dim=1).to(dtype)

    def motion_features(i, disp_w, corr):
        with on_device(update_block, moved[i]):
            return update_block.encoder(flow2(disp_w), corr)

    def gru_iter(i, net_w, disp_w, corr=None, motion=None):
        """One iteration on shard i's windows: the model's step (lookup
        -> slow-fast coarse steps -> motion encoder -> ConvGRUs -> heads
        -> x-only update)."""
        if motion is None and corr is None:
            corr = lookup(i, disp_w)
        net_w = list(net_w)
        kw = {"interp_fn": interps[i]}
        with on_device(update_block, moved[i]):
            if levels == 3 and cfg.slow_fast_gru:
                net_w = update_block(net_w, ctx_w[i], iter_fine=False,
                                     iter_mid=False, update=False, **kw)
            if levels >= 2 and cfg.slow_fast_gru:
                net_w = update_block(net_w, ctx_w[i], iter_fine=False,
                                     iter_coarse=(levels == 3),
                                     update=False, **kw)
            flow = None if motion is not None else flow2(disp_w)
            net_w, mask, delta = update_block(
                net_w, ctx_w[i], corr, flow, iter_mid=(levels >= 2),
                iter_coarse=(levels == 3), motion=motion, **kw)
        return net_w, disp_w + delta[:, 0].float(), mask

    def upsample(disp_w, mask_w):
        return convex_upsample(disp_w[:, None], mask_w.float(),
                               factor)[:, 0]

    net_parts = [[crop(window_of(t, l, i, 2), l, i, 2)
                  for l, t in enumerate(net_list)] for i in range(n)]
    disp_parts = [crop(window_of(disp0, 0, i, 1), 0, i, 1)
                  for i in range(n)]

    def windows():
        net_w = [[window([net_parts[j][l] for j in range(n)], l, i, 2)
                  for l in range(levels)] for i in range(n)]
        disp_w = [window(disp_parts, 0, i, 1) for i in range(n)]
        return net_w, disp_w

    if test_mode:
        mask_parts = [torch.zeros((b, cfg.mask_channels, slab, w_f),
                                  dtype=dtype, device=dev)
                      for dev in devices]
        for _ in range(iters):
            net_w, disp_w = windows()
            new = [gru_iter(i, net_w[i], disp_w[i]) for i in range(n)]
            net_parts = [[crop(t, l, i, 2) for l, t in enumerate(new[i][0])]
                         for i in range(n)]
            disp_parts = [crop(new[i][1], 0, i, 1) for i in range(n)]
            mask_parts = [crop(new[i][2], 0, i, 2) for i in range(n)]
        flow_up = [crop(upsample(window(disp_parts, 0, i, 1),
                                 window(mask_parts, 0, i, 2)),
                        0, i, 1, factor) for i in range(n)]
        return gather(disp_parts, 1), gather(flow_up, 1)

    save_motion = "motion_features" in cfg.remat_save
    save_lookup = "corr_lookup" in cfg.remat_save or save_motion
    policy = remat.context_fn(cfg.remat_save)

    def train_iteration(i, disp_w, corr, motion, *net_w):
        with record_function("raft::gru_iteration"):
            net_w, disp_w, mask = gru_iter(i, net_w, disp_w, corr, motion)
            flow_up = crop(upsample(disp_w, mask), 0, i, 1, factor)
            return (*(crop(t, l, i, 2) for l, t in enumerate(net_w)),
                    crop(disp_w, 0, i, 1), flow_up)

    flow_ups = []
    for _ in range(iters):
        net_w, disp_w = windows()
        outs = []
        for i in range(n):
            d = disp_w[i].detach()
            corr = lookup(i, d) if save_lookup else None
            motion = motion_features(i, d, corr) if save_motion else None
            if cfg.remat_gru and torch.is_grad_enabled():
                kwargs = {} if policy is None else {"context_fn": policy}
                outs.append(checkpoint(
                    train_iteration, i, d, corr, motion, *net_w[i],
                    use_reentrant=False, preserve_rng_state=False,
                    **kwargs))
            else:
                outs.append(train_iteration(i, d, corr, motion, *net_w[i]))
        net_parts = [list(o[:levels]) for o in outs]
        disp_parts = [o[levels] for o in outs]
        flow_ups.append(gather([o[levels + 1] for o in outs], 1))
    return torch.stack(flow_ups)
