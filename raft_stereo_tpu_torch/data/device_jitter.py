"""Photometric augmentation inside the training step (the JAX package's
``data/device_jitter.py``; ``TrainConfig.device_photometric``).

torchvision ``ColorJitter`` semantics (reference:
core/utils/augmentor.py:73-93): brightness, contrast, saturation and hue
in a random order per sample, the stereo pair jittered symmetrically or,
with probability ``asymmetric_prob``, independently, and an optional
gamma.  The ops are plain elementwise torch ops on the step's device.

The random factors are the JAX package's, bit for bit: they are drawn
from ``fold_in(PRNGKey(seed), step)`` with a copy of JAX's threefry2x32
(``jax_threefry_partitionable`` on) and of its ``split``, ``uniform`` and
``bernoulli``, written in int64 torch ops with 32-bit masks.  The draw
runs on the device the step tensor lies on, so under the anomaly policy
the factors follow the update count on the card (which a skipped step
does not advance, as JAX's ``state.step``) without a host sync.

Deviations from the host path (data/augment.py), as in the JAX package:
the jitter runs after the spatial crop, so contrast and saturation means
are over the crop; fp32 throughout with a clip after each op; hue is not
quantized to cv2's grid; the occlusion eraser stays on the host.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


@dataclasses.dataclass(frozen=True)
class JitterParams:
    """Factor ranges, defaulting to the dense-augmentor profile
    (data/augment.py DenseAugmentor; reference: core/utils/augmentor.py:85)."""

    brightness: float = 0.4
    contrast: float = 0.4
    saturation: Tuple[float, float] = (0.6, 1.4)
    hue: float = 0.5 / 3.14
    # (gamma_min, gamma_max, gain_min, gain_max); (1,1,1,1) = off
    gamma: Tuple[float, float, float, float] = (1.0, 1.0, 1.0, 1.0)
    asymmetric_prob: float = 0.2


# ------------------------------------------------------- JAX's threefry
# A key is a (..., 2) int64 tensor holding two uint32 words.

def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & M32


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash of the count pairs ``(x1, x2)`` under the
    key ``(k1, k2)`` (20 rounds, JAX's ``threefry2x32_p``); uint32 words
    held in int64 tensors, which broadcast."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = (x1 + ks[0]) & M32
    y = (x2 + ks[1]) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + y) & M32
            y = x0 ^ _rotl(y, r)
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        y = (y + ks[(i + 2) % 3] + (i + 1)) & M32
    return x0, y


def _full(value, dtype, device) -> torch.Tensor:
    """A 0-d constant made by a fill on ``device``: ``torch.tensor(...,
    device=card)`` would copy from pageable host memory and sync."""
    return torch.full((), value, dtype=dtype, device=device)


def prng_key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for a seed in [0, 2**31)."""
    return torch.stack([_full(0, torch.int64, device),
                        _full(seed & M32, torch.int64, device)])


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``; ``data`` a 0-d integer tensor on the key's
    device, or a Python int."""
    if not isinstance(data, torch.Tensor):
        data = _full(data, torch.int64, key.device)
    data = data.to(torch.int64) & M32
    a, b = threefry2x32(key[0], key[1], torch.zeros_like(data), data)
    return torch.stack([a, b])


def _iota_bits(key: torch.Tensor, n: int):
    counts = torch.arange(n, dtype=torch.int64, device=key.device)
    return threefry2x32(key[0], key[1], torch.zeros_like(counts), counts)


def split(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.split(key, n)``: (n, 2)."""
    a, b = _iota_bits(key, n)
    return torch.stack([a, b], dim=-1)


def uniform(key: torch.Tensor, shape: Tuple[int, ...], minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``."""
    a, b = _iota_bits(key, math.prod(shape))
    bits = ((a ^ b) >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    lo = _full(minval, torch.float32, key.device)
    hi = _full(maxval, torch.float32, key.device)
    # JAX's CPU compiler fuses ``floats * (hi - lo) + lo`` into one FMA;
    # in fp64 the product and the sum of these fp32 operands are exact,
    # so one rounding to fp32 gives the FMA's bits on any device.
    scaled = (floats.double() * (hi - lo).double() + lo.double()).float()
    return torch.maximum(lo, scaled.reshape(shape))


def bernoulli(key: torch.Tensor, p: float, shape: Tuple[int, ...]
              ) -> torch.Tensor:
    """``jax.random.bernoulli(key, p, shape)`` for a float ``p``."""
    return uniform(key, shape) < _full(p, torch.float32, key.device)


def draw_factors(seed: int, step: torch.Tensor, batch: int,
                 params: "JitterParams") -> Dict[str, torch.Tensor]:
    """Every random draw of ``apply_photometric`` for one step, from
    ``fold_in(PRNGKey(seed), step)`` as the JAX step folds its key; on
    ``step``'s device.  Returns the per-view factors ``b1, c1, s1, h1,
    b2, c2, s2, h2`` (view 2's already merged with view 1's where the
    sample is symmetric), ``asym`` (bool), the op orders ``perm1``,
    ``perm2`` (B, 4), and with gamma on ``g1, gain1, g2, gain2``."""
    key = fold_in(prng_key(seed, step.device), step)
    k_f1, k_f2, k_o1, k_o2, k_asym, k_gamma = split(key, 6)
    p = params

    def views(k):
        kb, kc, ks, kh = split(k, 4)
        return {"b": uniform(kb, (batch,), max(0.0, 1 - p.brightness),
                             1 + p.brightness),
                "c": uniform(kc, (batch,), max(0.0, 1 - p.contrast),
                             1 + p.contrast),
                "s": uniform(ks, (batch,), p.saturation[0], p.saturation[1]),
                "h": uniform(kh, (batch,), -p.hue, p.hue)}

    f1, f2i = views(k_f1), views(k_f2)
    asym = bernoulli(k_asym, p.asymmetric_prob, (batch,))
    out = {f"{k}1": v for k, v in f1.items()}
    out.update({f"{k}2": torch.where(asym, f2i[k], f1[k]) for k in f1})
    perm1 = torch.argsort(uniform(k_o1, (batch, 4)), dim=-1, stable=True)
    perm2i = torch.argsort(uniform(k_o2, (batch, 4)), dim=-1, stable=True)
    out.update(asym=asym, perm1=perm1,
               perm2=torch.where(asym[:, None], perm2i, perm1))
    gmin, gmax, gainmin, gainmax = p.gamma
    if (gmin, gmax, gainmin, gainmax) != (1.0, 1.0, 1.0, 1.0):
        kg1, kg2 = split(k_gamma, 2)
        g = uniform(kg1, (batch,), gmin, gmax)
        gain = uniform(kg2, (batch,), gainmin, gainmax)
        g2i = uniform(fold_in(kg1, 1), (batch,), gmin, gmax)
        gain2i = uniform(fold_in(kg2, 1), (batch,), gainmin, gainmax)
        out.update(g1=g, gain1=gain, g2=torch.where(asym, g2i, g),
                   gain2=torch.where(asym, gain2i, gain))
    return out


# ------------------------------------------------------------- fixed-factor ops
# Each mirrors its uint8 host twin in data/augment.py; images are float32
# 0..255, channels last; factors broadcast against them.

def adjust_brightness(img: torch.Tensor, factor) -> torch.Tensor:
    return torch.clamp(img * factor, 0.0, 255.0)


def adjust_contrast(img: torch.Tensor, factor, mean) -> torch.Tensor:
    """``mean`` is the gray mean to blend toward: per sample, the pair's
    joint mean for a symmetric pair (the host jitters the stacked pair)."""
    return torch.clamp(img * factor + (1.0 - factor) * mean, 0.0, 255.0)


def adjust_saturation(img: torch.Tensor, factor) -> torch.Tensor:
    luma = img[..., 0] * 0.299 + img[..., 1] * 0.587 + img[..., 2] * 0.114
    return torch.clamp(img * factor + (1.0 - factor) * luma[..., None],
                       0.0, 255.0)


def adjust_hue(img: torch.Tensor, shift) -> torch.Tensor:
    """``shift`` in turns of the hue circle, like the host op."""
    x = img * (1.0 / 255.0)
    mx = x.amax(dim=-1)
    mn = x.amin(dim=-1)
    c = mx - mn
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    safe_c = torch.where(c > 0, c, torch.ones_like(c))
    h = torch.where(
        c <= 0, torch.zeros_like(c),
        torch.where(mx == r, torch.remainder((g - b) / safe_c, 6.0),
                    torch.where(mx == g, (b - r) / safe_c + 2.0,
                                (r - g) / safe_c + 4.0))) / 6.0
    h = torch.remainder(h + shift, 1.0)
    # HSV -> RGB with v = mx, s*v = c
    k = torch.remainder(torch.stack([torch.full_like(h, 5.0),
                                     torch.full_like(h, 3.0),
                                     torch.full_like(h, 1.0)], dim=-1)
                        + h[..., None] * 6.0, 6.0)
    out = mx[..., None] - c[..., None] * torch.clamp(
        torch.minimum(k, 4.0 - k), 0.0, 1.0)
    return torch.clamp(out * 255.0, 0.0, 255.0)


def adjust_gamma(img: torch.Tensor, gamma, gain) -> torch.Tensor:
    x = img * (1.0 / 255.0)
    return torch.clamp(255.0 * gain * torch.pow(x, gamma), 0.0, 255.0)


def _gray_mean(img: torch.Tensor) -> torch.Tensor:
    """Per-sample mean over pixels and channels."""
    return img.mean(dim=(-3, -2, -1))


# ----------------------------------------------------------------- pair jitter
def apply_photometric(img1: torch.Tensor, img2: torch.Tensor,
                      factors: Dict[str, torch.Tensor]
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Jitter a stereo batch, (B, H, W, 3) uint8 or float 0..255 ->
    float32, with the draws of ``draw_factors``: the four ops in each
    sample's order, both views at once; a symmetric pair's contrast
    blends toward the joint mean of both views."""
    img1 = img1.float()
    img2 = img2.float()
    f = factors
    asym = f["asym"]
    rows = torch.arange(img1.shape[0], device=img1.device)

    def bc(v):
        return v[:, None, None, None]

    def all_ops(img, view, cmean):
        return torch.stack([
            adjust_brightness(img, bc(f[f"b{view}"])),
            adjust_contrast(img, bc(f[f"c{view}"]), bc(cmean)),
            adjust_saturation(img, bc(f[f"s{view}"])),
            adjust_hue(img, f[f"h{view}"][:, None, None]),
        ])

    for k in range(4):
        m1, m2 = _gray_mean(img1), _gray_mean(img2)
        joint = 0.5 * (m1 + m2)
        cmean1 = torch.where(asym, m1, joint)
        cmean2 = torch.where(asym, m2, joint)
        img1, img2 = (all_ops(img1, 1, cmean1)[f["perm1"][:, k], rows],
                      all_ops(img2, 2, cmean2)[f["perm2"][:, k], rows])

    if "g1" in f:
        img1 = adjust_gamma(img1, bc(f["g1"]), bc(f["gain1"]))
        img2 = adjust_gamma(img2, bc(f["g2"]), bc(f["gain2"]))
    return img1, img2


def params_for_datasets(train_datasets, saturation_range=None,
                        img_gamma=None) -> JitterParams:
    """The jitter profile of the training mixture, as
    ``build_training_mixture`` parameterizes the host augmentors: dense-GT
    families the dense profile (0.4/0.4/(0.6,1.4)/0.5÷3.14), sparse-GT
    families the sparse one (0.3/0.3/(0.7,1.3)/0.3÷3.14, always
    symmetric); a mixture of both raises."""
    dense = {"sceneflow", "falling_things"}
    is_dense = [name in dense or name.startswith("tartan_air")
                for name in train_datasets]
    if all(is_dense):
        p = JitterParams()
    elif not any(is_dense):
        p = JitterParams(brightness=0.3, contrast=0.3, saturation=(0.7, 1.3),
                         hue=0.3 / 3.14, asymmetric_prob=0.0)
    else:
        raise ValueError(
            f"device_photometric cannot serve a mixture of dense and "
            f"sparse jitter profiles ({list(train_datasets)}); train with "
            f"host-side augmentation there")
    if saturation_range is not None:
        p = dataclasses.replace(p, saturation=tuple(saturation_range))
    if img_gamma is not None:
        g = tuple(img_gamma)
        p = dataclasses.replace(
            p, gamma=g if len(g) == 4 else (g[0], g[1], 1.0, 1.0))
    return p
