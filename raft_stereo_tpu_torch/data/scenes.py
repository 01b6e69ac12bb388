"""Synthetic stereo scenes and benchmark trees: the port's copy of the JAX
package's test generators (``tests/golden_data.py``), for the drift gates
and the early-exit sweep (tools/early_exit_report.py).

``textured_image`` (multi-octave smooth noise), ``disparity_field`` (a
smooth ramp plus foreground rectangles, ~12 px), ``layered_scene``
(geometrically exact layered stereo with true occlusions, in the
benchmark disparity regime) and ``warp_right`` (the right view as a
per-row warp of the left).  ``make_eth3d``, ``make_kitti``,
``make_things`` and ``make_middlebury`` write
miniature ETH3D / KITTI / FlyingThings3D / Middlebury trees in the layouts
``data/datasets.py`` reads, each benchmark with its own invalid-pixel
encoding (inf PFM values, zero KITTI PNG, the nocc mask).  On one
``np.random.Generator`` state they give the originals' arrays and files bit
for bit (tests/test_torch_drift.py, tests/test_torch_early_exit_report.py).
"""

from __future__ import annotations

import os

import numpy as np
from PIL import Image

from raft_stereo_tpu_torch.data import frame_utils


def textured_image(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    """Multi-octave smooth noise -> (H, W, 3) uint8 with local structure."""
    acc = np.zeros((h, w), np.float32)
    for period in (4, 8, 16, 32):
        gh, gw = h // period + 2, w // period + 2
        grid = rng.standard_normal((gh, gw)).astype(np.float32)
        up = Image.fromarray(grid).resize((w, h), Image.BILINEAR)
        acc += period * np.asarray(up, np.float32)
    acc = (acc - acc.min()) / (acc.max() - acc.min() + 1e-9)
    r = (acc * 255).astype(np.uint8)
    g = np.roll(r, 3, axis=1)
    b = np.roll(r, 3, axis=0)
    return np.stack([r, g, b], axis=-1)


def disparity_field(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    """Smooth ramp + foreground rectangles, positive, max ~12 px."""
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    disp = 3.0 + 4.0 * x / w + 1.5 * np.sin(2 * np.pi * y / h)
    for _ in range(2):
        y0 = int(rng.integers(0, h // 2))
        x0 = int(rng.integers(0, w // 2))
        hh = int(rng.integers(h // 6, h // 3))
        ww = int(rng.integers(w // 6, w // 3))
        disp[y0:y0 + hh, x0:x0 + ww] += float(rng.uniform(2.0, 5.0))
    return disp.astype(np.float32)


def layered_scene(rng: np.random.Generator, h: int, w: int,
                  d_max: float | None = None, n_layers: int | None = None,
                  p_textureless: float = 0.25,
                  d_ceiling: float | None = None):
    """Geometrically exact layered stereo scene in the BENCHMARK disparity
    regime — the round-5 hardening of ``disparity_field``/``warp_right``.

    The reference's metrics are defined over |d| < 192
    (reference: evaluate_stereo.py:133-135) and its training data (SceneFlow)
    is rendered geometry with depth discontinuities, true occlusions, and
    textureless surfaces; the old generator topped out near 12 px, two
    orders of magnitude inside that regime.  This one draws:

    * a background PLANE plus ``n_layers`` foreground planar layers with
      elliptical/rectangular supports, disparities log-uniform up to a
      per-scene ceiling in (0.35, 1.0] * ``d_max`` (so the corpus covers
      the whole range, not just its top);
    * each view rendered INDEPENDENTLY by per-pixel z-buffer (near = larger
      disparity wins).  A planar layer maps right pixel ``xr`` to the left
      /canvas abscissa ``xl = (xr + a + c*y/h) / (1 - b/w)`` (closed form —
      no fixed-point iteration, no resampling error), so the right view is
      TRUE alternate-viewpoint geometry, not a backward warp of the left:
      occluded background is revealed, foreground edges occlude;
    * a TRUE occlusion mask by left-right consistency of the two visible
      surfaces: left pixel (y, x) with visible disparity d is occluded iff
      its match ``x - d`` falls outside the right frame or the right view's
      visible surface there is nearer by > 1 px (exact for planar layers:
      the right-view disparity of the SAME surface is linear in xr, so the
      per-row linear interpolation reproduces it perfectly away from
      layer boundaries);
    * textureless content: each foreground layer is flat (+tiny noise) with
      probability ``p_textureless``, and one blurred-flat patch is carved
      into the background texture.

    Textures live on a canvas of width ``w + ceil(d_ceiling) + 2`` so right
    -view sampling at ``x + d`` never clamps (the old generator's
    BORDER_REPLICATE streaks).  Returns ``(left u8 (H,W,3), right u8
    (H,W,3), disp f32 (H,W) positive left-view GT — dense, occluded pixels
    INCLUDED, exactly like rendered SceneFlow GT — and occ bool (H,W))``.
    """
    if d_max is None:
        # keep the geometry plausible on tiny parity trees (w=90 -> ~31 px)
        d_max = min(190.0, 0.35 * w)
    if n_layers is None:
        n_layers = int(rng.integers(4, 9))
    if d_ceiling is None:
        d_ceiling = float(rng.uniform(0.35, 1.0)) * d_max
    # margin absorbs plane slopes (<= 0.06*d_ceiling each of b, c)
    w_ext = w + int(np.ceil(1.15 * d_ceiling)) + 2
    yy = np.arange(h, dtype=np.float32)[:, None] / h          # (H,1)
    xr = np.arange(w, dtype=np.float32)[None, :]              # (1,W)
    xl_grid = np.arange(w, dtype=np.float32)[None, :]

    def plane_params(lo, hi, slope):
        a = float(rng.uniform(lo, hi))
        b = float(rng.uniform(-slope, slope))
        c = float(rng.uniform(-slope, slope))
        return a, b, c

    def flat_texture():
        base = rng.uniform(40, 215, size=3)
        tex = np.broadcast_to(base.astype(np.float32),
                              (h, w_ext, 3)).copy()
        tex += rng.standard_normal((h, w_ext, 3)).astype(np.float32) * 1.5
        return np.clip(tex, 0, 255)

    def support_mask():
        """Rotated ellipse or rectangle on the canvas, area ~2-12%."""
        cy = rng.uniform(0.1 * h, 0.9 * h)
        cx = rng.uniform(0.05 * w_ext, 0.95 * w_ext)
        ry = rng.uniform(0.10 * h, 0.32 * h)
        rx = rng.uniform(0.06 * w_ext, 0.22 * w_ext)
        th = rng.uniform(0, np.pi)
        gy, gx = np.mgrid[0:h, 0:w_ext].astype(np.float32)
        u = (gx - cx) * np.cos(th) + (gy - cy) * np.sin(th)
        v = -(gx - cx) * np.sin(th) + (gy - cy) * np.cos(th)
        if rng.random() < 0.5:
            return (u / rx) ** 2 + (v / ry) ** 2 <= 1.0
        return (np.abs(u) <= rx) & (np.abs(v) <= ry)

    # --- layers: (a, b, c) plane in left/canvas coords, mask, texture ----
    layers = []
    bg_d0 = float(rng.uniform(1.0, 0.25 * d_ceiling))
    # |c| < bg_d0 - 0.5 keeps the background disparity positive everywhere,
    # so the background plane covers every right-view pixel (no holes)
    c_cap = min(0.1 * d_ceiling, max(bg_d0 - 0.5, 0.0))
    a, b, c = bg_d0, float(rng.uniform(0.0, 0.2 * d_ceiling)), \
        float(rng.uniform(-c_cap, c_cap))
    bg_tex = textured_image(rng, h, w_ext).astype(np.float32)
    # carve one textureless patch into the background
    py0, px0 = int(rng.integers(0, h // 2)), int(rng.integers(0, w_ext // 2))
    ph, pw = h // 4, w_ext // 5
    bg_tex[py0:py0 + ph, px0:px0 + pw] = \
        bg_tex[py0:py0 + ph, px0:px0 + pw].mean(axis=(0, 1), keepdims=True)
    layers.append((a, b, c, np.ones((h, w_ext), bool), bg_tex))
    lo = max(bg_d0 + 0.15 * d_ceiling, 0.2 * d_ceiling)
    for k in range(n_layers):
        # log-uniform base so near AND far layers both appear; the first
        # layer sits AT the ceiling so every scene exercises its full range
        base = d_ceiling if k == 0 else float(
            np.exp(rng.uniform(np.log(lo), np.log(d_ceiling))))
        slope = 0.06 * d_ceiling
        af = base
        bf = float(rng.uniform(-slope, slope))
        cf = float(rng.uniform(-slope, slope))
        tex = (flat_texture() if rng.random() < p_textureless
               else textured_image(rng, h, w_ext).astype(np.float32))
        layers.append((af, bf, cf, support_mask(), tex))

    def lerp_row(img, xs):
        """Per-row linear interpolation of (H, W_ext[, C]) at float xs
        (H, W); xs guaranteed in [0, w_ext-1]."""
        x0 = np.clip(np.floor(xs).astype(np.int64), 0, w_ext - 2)
        fr = (xs - x0)[..., None] if img.ndim == 3 else (xs - x0)
        g0 = np.take_along_axis(
            img, x0[..., None] if img.ndim == 3 else x0, axis=1)
        g1 = np.take_along_axis(
            img, (x0 + 1)[..., None] if img.ndim == 3 else x0 + 1, axis=1)
        return g0 * (1 - fr) + g1 * fr

    # --- left view: z-buffer in canvas coords, crop to [0, w) -----------
    left = np.zeros((h, w, 3), np.float32)
    disp_l = np.full((h, w), -np.inf, np.float32)
    for a, b, c, mask, tex in layers:
        d = a + b * xl_grid / w + c * yy                       # (H,W)
        cover = mask[:, :w] & (d > disp_l)
        disp_l = np.where(cover, d, disp_l)
        left = np.where(cover[..., None], tex[:, :w], left)

    # --- right view: closed-form inverse warp per layer, z-buffer -------
    right = np.zeros((h, w, 3), np.float32)
    disp_r = np.full((h, w), -np.inf, np.float32)
    for a, b, c, mask, tex in layers:
        denom = 1.0 - b / w
        xl = (xr + a + c * yy) / denom                         # (H,W)
        inside = (xl >= 0) & (xl <= w_ext - 1)
        xl_s = np.clip(xl, 0, w_ext - 1)
        cover = inside & (lerp_row(mask.astype(np.float32), xl_s) > 0.5)
        d = a + b * xl / w + c * yy
        take = cover & (d > disp_r)
        disp_r = np.where(take, d, disp_r)
        right = np.where(take[..., None], lerp_row(tex, xl_s), right)

    # --- true occlusion: left-right consistency of visible surfaces -----
    xmatch = xl_grid - disp_l                                  # (H,W)
    off_frame = xmatch < -0.5
    xm = np.clip(xmatch, 0, w - 1)
    x0 = np.clip(np.floor(xm).astype(np.int64), 0, w - 2)
    fr = xm - x0
    # guard -inf (a right pixel no layer covered) against 0*inf = nan
    disp_r_f = np.nan_to_num(disp_r, neginf=-1e9)
    dr0 = np.take_along_axis(disp_r_f, x0, axis=1)
    dr1 = np.take_along_axis(disp_r_f, x0 + 1, axis=1)
    dr_at_match = dr0 * (1 - fr) + dr1 * fr
    occ = off_frame | (dr_at_match > disp_l + 1.01)

    return (np.clip(left, 0, 255).astype(np.uint8),
            np.clip(right, 0, 255).astype(np.uint8),
            disp_l.astype(np.float32), occ)


def warp_right(left: np.ndarray, disp: np.ndarray) -> np.ndarray:
    """right[y, x] = left[y, x + disp[y, x]] per-row linear interpolation —
    the stereo geometry (matching left pixel sits ``disp`` to the RIGHT of
    the right-image pixel)."""
    h, w, _ = left.shape
    xs = np.arange(w, dtype=np.float32)
    out = np.empty_like(left)
    for yy in range(h):
        src = xs + disp[yy]
        for c in range(3):
            out[yy, :, c] = np.interp(src, xs, left[yy, :, c].astype(np.float32))
    return out.astype(np.uint8)


# ----------------------------------------------------- benchmark trees
def _pair(rng, h, w):
    left = textured_image(rng, h, w)
    disp = disparity_field(rng, h, w)
    right = warp_right(left, disp)
    return left, right, disp


def make_eth3d(root: str, rng, n: int = 2, hw=(60, 90)) -> None:
    """two_view_training/<scene>/im{0,1}.png + two_view_training_gt/<scene>/
    disp0GT.pfm; invalid pixels are +inf (reference: stereo_datasets.py:185-195,
    valid = disp < 512 via the non-tuple reader path)."""
    h, w = hw
    for i in range(n):
        scene = os.path.join(root, "two_view_training", f"scene_{i}")
        gt = os.path.join(root, "two_view_training_gt", f"scene_{i}")
        os.makedirs(scene), os.makedirs(gt)
        left, right, disp = _pair(rng, h, w)
        disp = disp.copy()
        Image.fromarray(left).save(os.path.join(scene, "im0.png"))
        Image.fromarray(right).save(os.path.join(scene, "im1.png"))
        disp[rng.random((h, w)) < 0.05] = np.inf  # ETH3D invalid encoding
        frame_utils.write_pfm(os.path.join(gt, "disp0GT.pfm"), disp)


def make_kitti(root: str, rng, n: int = 2, hw=(60, 90)) -> None:
    """training/{image_2,image_3,disp_occ_0}/<id>_10.png; sparse 16-bit
    disparity/256, zero = invalid (reference: stereo_datasets.py:246-257,
    frame_utils.py:124-127)."""
    h, w = hw
    for sub in ("image_2", "image_3", "disp_occ_0"):
        os.makedirs(os.path.join(root, "training", sub))
    for i in range(n):
        left, right, disp = _pair(rng, h, w)
        Image.fromarray(left).save(
            os.path.join(root, "training", "image_2", f"{i:06d}_10.png"))
        Image.fromarray(right).save(
            os.path.join(root, "training", "image_3", f"{i:06d}_10.png"))
        disp = disp.copy()
        disp[rng.random((h, w)) < 0.4] = 0.0  # sparse: ~60% coverage
        frame_utils.write_disp_kitti(
            os.path.join(root, "training", "disp_occ_0", f"{i:06d}_10.png"),
            disp)


def make_things(root: str, rng, n: int = 2, hw=(60, 90),
                dstype: str = "frames_finalpass") -> None:
    """FlyingThings3D/<dstype>/TEST/A/<seq>/left|right/0006.png +
    disparity pfm.  With fewer than 400 files the seed-1000 validation
    subset selects ALL of them in both frameworks
    (reference: stereo_datasets.py:145-149)."""
    h, w = hw
    for i in range(n):
        seq = os.path.join(root, "FlyingThings3D", dstype, "TEST", "A",
                           f"{i:04d}")
        dseq = os.path.join(root, "FlyingThings3D", "disparity", "TEST", "A",
                            f"{i:04d}", "left")
        os.makedirs(os.path.join(seq, "left"))
        os.makedirs(os.path.join(seq, "right"))
        os.makedirs(dseq)
        left, right, disp = _pair(rng, h, w)
        Image.fromarray(left).save(os.path.join(seq, "left", "0006.png"))
        Image.fromarray(right).save(os.path.join(seq, "right", "0006.png"))
        frame_utils.write_pfm(os.path.join(dseq, "0006.pfm"), disp)


def make_middlebury(root: str, rng, n: int = 2, hw=(60, 90),
                    split: str = "H") -> None:
    """MiddEval3/training<split>/<scene>/{im0,im1,disp0GT.pfm,mask0nocc.png}
    + the trainingF listing and official_train.txt filter the reference
    applies (reference: stereo_datasets.py:260-274); unknown GT is +inf,
    nocc mask 255 = non-occluded, 128 = occluded."""
    h, w = hw
    names = []
    for i in range(n):
        name = f"Scene{i}"
        names.append(name)
        scene = os.path.join(root, "MiddEval3", f"training{split}", name)
        os.makedirs(scene)
        # the reference enumerates trainingF to list scene names
        os.makedirs(os.path.join(root, "MiddEval3", "trainingF", name),
                    exist_ok=True)
        left, right, disp = _pair(rng, h, w)
        mask = np.where(rng.random((h, w)) < 0.2, 128, 255).astype(np.uint8)
        Image.fromarray(left).save(os.path.join(scene, "im0.png"))
        Image.fromarray(right).save(os.path.join(scene, "im1.png"))
        disp = disp.copy()
        disp[rng.random((h, w)) < 0.04] = np.inf  # unknown GT
        frame_utils.write_pfm(os.path.join(scene, "disp0GT.pfm"), disp)
        Image.fromarray(mask).save(os.path.join(scene, "mask0nocc.png"))
    with open(os.path.join(root, "MiddEval3", "official_train.txt"),
              "w") as f:
        f.write("\n".join(names) + "\n")
