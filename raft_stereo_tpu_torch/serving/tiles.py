"""Halo-overlap row tiling: large inputs through the bucket engine, the
JAX package's ``serving/tiles.py`` copied whole (the port imports nothing
of that package; ``tests/test_torch_tiles.py`` holds the two equal).

Past the xl tier's ceiling (``xl_max_pixels``), or without an xl tier,
tiling is how the engine answers a pair larger than one bucket: split the
image into horizontal bands, run each band as an ordinary bucket dispatch
(all tiles of one image share one padded bucket, so the continuous
batcher groups them into batch-N dispatches — no new scheduler), and
stitch the disparities back together.

Row tiling is the natural cut for stereo: epipolar lines are image ROWS,
so every tile sees the full disparity-search width and the correlation
math inside a tile is exactly the full-image math.  What a tile cannot
see is vertical context beyond its band — receptive fields of the
encoders and the GRU's iterative propagation — so each tile carries a
``halo`` of extra rows on both sides and only its interior ("owned")
rows land in the stitched output.  The default halo of 64 full-res rows
is 4x the JAX package's rows-sharded GRU's 16-row fine-level (=64
full-res at 1/4 resolution) per-iteration receptive-field contract:
tiling cannot refresh halos between GRU iterations the way a sharded
loop does, so it over-provisions instead, and the residual disagreement
is MEASURED per request as the seam-error metric rather than assumed
away.

Geometry is a clamped window: every tile has the SAME height
(``tile_rows + 2*halo``), with edge tiles shifted inward instead of
shrunk — identical tile shapes are what lets the batcher put all of one
image's tiles in one dispatch.  Stitching is
center-crop: each output row is taken from the tile that owns it (the
tile where the row is most interior).  Adjacent tiles both predict the
overlap rows, and ``seam_epe`` reports their mean absolute disagreement
there — zero when the tiles are consistent restrictions of one global
field (the property tests pin this), and a live per-request accuracy
signal (``serve_tile_seam_epe``) when they are not.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

# Owned rows per tile and overlap halo (full-resolution rows), the
# ServeConfig defaults.  See the module docstring for the halo rationale.
DEFAULT_TILE_ROWS = 512
DEFAULT_TILE_HALO = 64


@dataclasses.dataclass(frozen=True)
class TileSpec:
    """One row band: the tile runs rows ``[src0, src1)`` of the full
    image and OWNS rows ``[y0, y1)`` of the stitched output."""

    y0: int
    y1: int
    src0: int
    src1: int

    @property
    def height(self) -> int:
        return self.src1 - self.src0

    @property
    def own_slice(self) -> slice:
        """Owned rows in tile-local coordinates."""
        return slice(self.y0 - self.src0, self.y1 - self.src0)


def plan_tiles(height: int, tile_rows: int = DEFAULT_TILE_ROWS,
               halo: int = DEFAULT_TILE_HALO) -> List[TileSpec]:
    """Split ``height`` rows into equal-height overlapping tiles.

    Every tile spans exactly ``tile_rows + 2*halo`` source rows (edge
    tiles shift inward rather than shrink — same-shape tiles share one
    compiled bucket and batch together).  An image short enough for one
    tile returns a single full-image spec, which callers should treat as
    "don't tile".  Owned spans partition ``[0, height)`` exactly."""
    if height < 1:
        raise ValueError(f"height={height} must be >= 1")
    if tile_rows < 1:
        raise ValueError(f"tile_rows={tile_rows} must be >= 1")
    if halo < 0:
        raise ValueError(f"halo={halo} must be >= 0")
    extent = tile_rows + 2 * halo
    if height <= extent:
        return [TileSpec(0, height, 0, height)]
    n = -(-height // tile_rows)
    edges = [round(i * height / n) for i in range(n + 1)]
    specs = []
    for i in range(n):
        y0, y1 = edges[i], edges[i + 1]
        src0 = min(max(0, y0 - halo), height - extent)
        specs.append(TileSpec(y0, y1, src0, src0 + extent))
    return specs


def stitch(flows: Sequence[np.ndarray],
           specs: Sequence[TileSpec]) -> np.ndarray:
    """Assemble tile disparities into the full-image map by center-crop:
    row ``y`` comes from the tile that owns it.  ``flows[i]`` is tile
    ``i``'s full prediction, shape ``(specs[i].height, W)``."""
    if len(flows) != len(specs) or not specs:
        raise ValueError(f"{len(flows)} tile outputs for {len(specs)} "
                         f"specs")
    height = specs[-1].y1
    out = np.empty((height,) + tuple(flows[0].shape[1:]),
                   dtype=flows[0].dtype)
    for flow, spec in zip(flows, specs):
        if flow.shape[0] != spec.height:
            raise ValueError(
                f"tile output has {flow.shape[0]} rows for a "
                f"{spec.height}-row tile {spec}")
        out[spec.y0:spec.y1] = flow[spec.own_slice]
    return out


def seam_epe(flows: Sequence[np.ndarray],
             specs: Sequence[TileSpec]) -> Optional[float]:
    """Mean |Δdisparity| over all rows that adjacent tiles BOTH predict —
    the measured cost of tiling.  Zero iff every overlap agrees exactly
    (tiles that are restrictions of one global field); grows with the
    vertical context the halo failed to carry.  None for a single tile
    (nothing overlaps)."""
    if len(flows) < 2:
        return None
    total, count = 0.0, 0
    for i in range(len(flows) - 1):
        a, sa = flows[i], specs[i]
        b, sb = flows[i + 1], specs[i + 1]
        lo, hi = max(sa.src0, sb.src0), min(sa.src1, sb.src1)
        if hi <= lo:
            continue
        da = np.asarray(a[lo - sa.src0:hi - sa.src0], np.float64)
        db = np.asarray(b[lo - sb.src0:hi - sb.src0], np.float64)
        total += float(np.abs(da - db).sum())
        count += da.size
    return (total / count) if count else None
