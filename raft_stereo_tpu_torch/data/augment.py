"""Stereo training augmentation (host side, numpy): the JAX package's
``data/augment.py``, kept bit-equal to it under the same generator seeds.

Re-implements the reference's two augmentors (reference:
core/utils/augmentor.py:60-181 ``FlowAugmentor`` dense-GT path,
:184-316 ``SparseFlowAugmentor`` sparse-GT path) with one deliberate design
change: randomness comes from an explicit ``np.random.Generator`` passed per
call instead of process-global state, so a sample's augmentation is a pure
function of ``(seed, epoch, index)`` regardless of worker/thread scheduling.

Photometric jitter replicates torchvision ColorJitter semantics (brightness/
contrast/saturation blends, HSV hue shift, random op order) + gamma
adjustment, in uint8 NumPy.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

try:
    import cv2
    cv2.setNumThreads(0)
    cv2.ocl.setUseOpenCL(False)
except ImportError:  # pragma: no cover
    cv2 = None


# ----------------------------------------------------------- photometric ops
def _blend(a: np.ndarray, b, factor: float) -> np.ndarray:
    """``factor*a + (1-factor)*b`` clipped to uint8 — in-place fp32 ops (one
    temporary instead of four; the loader's per-sample cost is dominated by
    these full-frame blends)."""
    out = a.astype(np.float32)
    out *= np.float32(factor)
    bb = (1.0 - factor) * b
    if isinstance(bb, np.ndarray) or bb:  # brightness blends with 0: skip
        out += bb
    np.clip(out, 0, 255, out=out)
    return out.astype(np.uint8)


def adjust_brightness(img: np.ndarray, factor: float) -> np.ndarray:
    return _blend(img, np.float32(0.0), factor)


def adjust_contrast(img: np.ndarray, factor: float) -> np.ndarray:
    # mean(dtype=f32) accumulates uint8 in fp32 without materializing the
    # fp32 copy — same reduction order as .astype(f32).mean(-1).mean()
    gray_mean = img.mean(axis=-1, dtype=np.float32).mean(dtype=np.float32)
    return _blend(img, gray_mean, factor)


def adjust_saturation(img: np.ndarray, factor: float) -> np.ndarray:
    # ITU-R 601 luma, same weights torchvision uses for rgb_to_grayscale
    gray = (img.astype(np.float32) @ np.array([0.299, 0.587, 0.114],
                                              np.float32))[..., None]
    return _blend(img, gray, factor)


def adjust_hue(img: np.ndarray, shift: float) -> np.ndarray:
    """``shift`` in [-0.5, 0.5] turns of the hue circle."""
    if cv2 is None:  # pragma: no cover
        return img  # hue jitter needs cv2's HSV conversion; skip without it
    if int(round(shift * 180)) == 0:
        return img  # HSV round-trip is lossy on uint8 — skip the no-op
    hsv = cv2.cvtColor(img, cv2.COLOR_RGB2HSV)
    h = hsv[..., 0].astype(np.int32)  # OpenCV uint8 hue range: 0..179
    hsv[..., 0] = ((h + int(round(shift * 180))) % 180).astype(np.uint8)
    return cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB)


def adjust_gamma(img: np.ndarray, gamma: float, gain: float = 1.0) -> np.ndarray:
    x = img.astype(np.float32) / 255.0
    return np.clip(255.0 * gain * np.power(x, gamma), 0, 255).astype(np.uint8)


class ColorJitter:
    """torchvision-style jitter: factors drawn per call, ops in random order.

    ``brightness``/``contrast`` b give factors U[max(0,1-b), 1+b];
    ``saturation`` is an explicit (lo, hi) range; ``hue`` h gives a shift
    U[-h, h]; ``gamma`` is (gamma_min, gamma_max, gain_min, gain_max).
    """

    def __init__(self, brightness: float, contrast: float,
                 saturation: Tuple[float, float], hue: float,
                 gamma: Sequence[float] = (1, 1, 1, 1)):
        self.brightness = brightness
        self.contrast = contrast
        self.saturation = saturation
        self.hue = hue
        self.gamma = tuple(gamma)

    def __call__(self, img: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        b = rng.uniform(max(0, 1 - self.brightness), 1 + self.brightness)
        c = rng.uniform(max(0, 1 - self.contrast), 1 + self.contrast)
        s = rng.uniform(*self.saturation)
        h = rng.uniform(-self.hue, self.hue)
        ops = [lambda x: adjust_brightness(x, b),
               lambda x: adjust_contrast(x, c),
               lambda x: adjust_saturation(x, s),
               lambda x: adjust_hue(x, h)]
        for i in rng.permutation(4):
            img = ops[i](img)
        gmin, gmax, gainmin, gainmax = self.gamma
        if (gmin, gmax, gainmin, gainmax) != (1, 1, 1, 1):
            img = adjust_gamma(img, rng.uniform(gmin, gmax),
                               rng.uniform(gainmin, gainmax))
        return img


# ------------------------------------------------------------ shared pieces
def _eraser(img2: np.ndarray, rng: np.random.Generator,
            prob: float = 0.5, bounds=(50, 100)) -> np.ndarray:
    """Occlusion augmentation: paint 1-2 random rectangles of img2 with its
    mean color (reference: core/utils/augmentor.py:98-111)."""
    ht, wd = img2.shape[:2]
    if rng.random() < prob:
        img2 = img2.copy()
        mean_color = img2.reshape(-1, 3).mean(axis=0)
        for _ in range(rng.integers(1, 3)):
            x0 = rng.integers(0, wd)
            y0 = rng.integers(0, ht)
            dx = rng.integers(bounds[0], bounds[1])
            dy = rng.integers(bounds[0], bounds[1])
            img2[y0:y0 + dy, x0:x0 + dx, :] = mean_color
    return img2


def _resize(img: np.ndarray, fx: float, fy: float,
            is_flow: bool = False) -> np.ndarray:
    out = cv2.resize(img, None, fx=fx, fy=fy,
                     interpolation=cv2.INTER_LINEAR)
    if is_flow:
        out = out * np.array([fx, fy], np.float32)
    return out


def _stereo_flips(img1, img2, flow, do_flip: Optional[str],
                  rng: np.random.Generator,
                  h_flip_prob=0.5, v_flip_prob=0.1):
    """The reference's three flip modes (core/utils/augmentor.py:137-151):
    'hf' plain h-flip (unreachable from its CLI), 'h' the stereo-correct
    swap-and-mirror, 'v' vertical."""
    if do_flip == "hf" and rng.random() < h_flip_prob:
        img1 = img1[:, ::-1]
        img2 = img2[:, ::-1]
        flow = flow[:, ::-1] * [-1.0, 1.0]
    if do_flip == "h" and rng.random() < h_flip_prob:
        img1, img2 = img2[:, ::-1], img1[:, ::-1]
    if do_flip == "v" and rng.random() < v_flip_prob:
        img1 = img1[::-1, :]
        img2 = img2[::-1, :]
        flow = flow[::-1, :] * [1.0, -1.0]
    return img1, img2, flow


# ---------------------------------------------------------- dense augmentor
class DenseAugmentor:
    """Augmentation for datasets with dense GT (SceneFlow/FallingThings/
    TartanAir).  Reference: core/utils/augmentor.py:60-181."""

    def __init__(self, crop_size: Tuple[int, int], min_scale=-0.2,
                 max_scale=0.5, do_flip: Optional[str] = None, yjitter=False,
                 saturation_range=(0.6, 1.4), gamma=(1, 1, 1, 1),
                 photometric=True):
        self.crop_size = tuple(crop_size)
        self.min_scale = min_scale
        self.max_scale = max_scale
        self.do_flip = do_flip
        self.yjitter = yjitter
        self.stretch_prob = 0.8
        self.max_stretch = 0.2
        self.asymmetric_prob = 0.2
        # photometric=False skips the jitter (the JAX package's
        # TrainConfig.device_photometric; not ported, config.py)
        self.photometric = photometric
        self.jitter = ColorJitter(0.4, 0.4, saturation_range, 0.5 / 3.14,
                                  gamma)

    def _color(self, img1, img2, rng):
        if rng.random() < self.asymmetric_prob:
            return self.jitter(img1, rng), self.jitter(img2, rng)
        # symmetric: identical factors for both views — jitter the stacked
        # pair once (reference: core/utils/augmentor.py:89-93)
        stack = np.concatenate([img1, img2], axis=0)
        stack = self.jitter(stack, rng)
        return np.split(stack, 2, axis=0)

    def _spatial(self, img1, img2, flow, rng):
        ch, cw = self.crop_size
        ht, wd = img1.shape[:2]
        # floor keeps the post-resize image croppable with >=8px slack
        min_scale = max((ch + 8) / ht, (cw + 8) / wd)
        scale = 2.0 ** rng.uniform(self.min_scale, self.max_scale)
        sx = sy = scale
        if rng.random() < self.stretch_prob:
            sx *= 2.0 ** rng.uniform(-self.max_stretch, self.max_stretch)
            sy *= 2.0 ** rng.uniform(-self.max_stretch, self.max_stretch)
        sx = max(sx, min_scale)
        sy = max(sy, min_scale)
        img1 = _resize(img1, sx, sy)
        img2 = _resize(img2, sx, sy)
        flow = _resize(flow, sx, sy, is_flow=True)

        img1, img2, flow = _stereo_flips(img1, img2, flow, self.do_flip, rng)

        if self.yjitter:
            # crop img2 with ±2px vertical offset, simulating imperfect
            # rectification (reference: core/utils/augmentor.py:153-160)
            y0 = int(rng.integers(2, img1.shape[0] - ch - 2))
            x0 = int(rng.integers(2, img1.shape[1] - cw - 2))
            y1 = y0 + int(rng.integers(-2, 3))
            img1 = img1[y0:y0 + ch, x0:x0 + cw]
            img2 = img2[y1:y1 + ch, x0:x0 + cw]
            flow = flow[y0:y0 + ch, x0:x0 + cw]
        else:
            y0 = int(rng.integers(0, img1.shape[0] - ch))
            x0 = int(rng.integers(0, img1.shape[1] - cw))
            img1 = img1[y0:y0 + ch, x0:x0 + cw]
            img2 = img2[y0:y0 + ch, x0:x0 + cw]
            flow = flow[y0:y0 + ch, x0:x0 + cw]
        return img1, img2, flow

    def __call__(self, img1: np.ndarray, img2: np.ndarray, flow: np.ndarray,
                 rng: np.random.Generator):
        """uint8 (H,W,3) ×2 + float32 (H,W,2) flow → cropped/augmented."""
        if self.photometric:
            img1, img2 = self._color(img1, img2, rng)
        img2 = _eraser(img2, rng)
        img1, img2, flow = self._spatial(img1, img2, flow, rng)
        return (np.ascontiguousarray(img1), np.ascontiguousarray(img2),
                np.ascontiguousarray(flow))


# --------------------------------------------------------- sparse augmentor
class SparseAugmentor:
    """Augmentation for sparse GT (KITTI/ETH3D/Middlebury/Sintel): flow must
    be scattered, not interpolated, when resizing.
    Reference: core/utils/augmentor.py:184-316."""

    def __init__(self, crop_size: Tuple[int, int], min_scale=-0.2,
                 max_scale=0.5, do_flip: Optional[str] = None, yjitter=False,
                 saturation_range=(0.7, 1.3), gamma=(1, 1, 1, 1),
                 photometric=True):
        self.crop_size = tuple(crop_size)
        self.min_scale = min_scale
        self.max_scale = max_scale
        self.do_flip = do_flip
        # yjitter accepted-but-unused, like the reference (:184 signature)
        self.spatial_aug_prob = 0.8
        self.photometric = photometric
        self.jitter = ColorJitter(0.3, 0.3, saturation_range, 0.3 / 3.14,
                                  gamma)

    @staticmethod
    def resize_sparse_flow(flow: np.ndarray, valid: np.ndarray,
                           fx: float, fy: float):
        """Scatter valid flow vectors into the scaled grid (rounded target
        pixels), instead of bilinear interpolation which would smear valid
        and invalid values together (reference: core/utils/augmentor.py:223-255).
        """
        ht, wd = flow.shape[:2]
        ht1 = int(round(ht * fy))
        wd1 = int(round(wd * fx))

        yy0, xx0 = np.nonzero(valid >= 1)
        flow0 = flow[yy0, xx0] * np.array([fx, fy], np.float32)
        xx = np.round(xx0 * fx).astype(np.int32)
        yy = np.round(yy0 * fy).astype(np.int32)
        keep = (xx > 0) & (xx < wd1) & (yy > 0) & (yy < ht1)

        flow_img = np.zeros((ht1, wd1, 2), np.float32)
        valid_img = np.zeros((ht1, wd1), np.int32)
        flow_img[yy[keep], xx[keep]] = flow0[keep]
        valid_img[yy[keep], xx[keep]] = 1
        return flow_img, valid_img

    def _spatial(self, img1, img2, flow, valid, rng):
        ch, cw = self.crop_size
        ht, wd = img1.shape[:2]
        min_scale = max((ch + 1) / ht, (cw + 1) / wd)
        scale = max(2.0 ** rng.uniform(self.min_scale, self.max_scale),
                    min_scale)
        if rng.random() < self.spatial_aug_prob:
            img1 = _resize(img1, scale, scale)
            img2 = _resize(img2, scale, scale)
            flow, valid = self.resize_sparse_flow(flow, valid, scale, scale)

        img1, img2, flow = _stereo_flips(img1, img2, flow, self.do_flip, rng)

        # crop with margins so near-border crops are reachable
        # (reference: core/utils/augmentor.py:291-303)
        margin_y, margin_x = 20, 50
        y0 = int(rng.integers(0, img1.shape[0] - ch + margin_y))
        x0 = int(rng.integers(-margin_x, img1.shape[1] - cw + margin_x))
        y0 = int(np.clip(y0, 0, img1.shape[0] - ch))
        x0 = int(np.clip(x0, 0, img1.shape[1] - cw))
        img1 = img1[y0:y0 + ch, x0:x0 + cw]
        img2 = img2[y0:y0 + ch, x0:x0 + cw]
        flow = flow[y0:y0 + ch, x0:x0 + cw]
        valid = valid[y0:y0 + ch, x0:x0 + cw]
        return img1, img2, flow, valid

    def __call__(self, img1, img2, flow, valid, rng: np.random.Generator):
        if self.photometric:
            stack = np.concatenate([img1, img2], axis=0)
            stack = self.jitter(stack, rng)
            img1, img2 = np.split(stack, 2, axis=0)
        img2 = _eraser(img2, rng)
        img1, img2, flow, valid = self._spatial(img1, img2, flow, valid, rng)
        return (np.ascontiguousarray(img1), np.ascontiguousarray(img2),
                np.ascontiguousarray(flow), np.ascontiguousarray(valid))
