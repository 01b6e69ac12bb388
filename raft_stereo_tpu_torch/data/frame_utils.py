"""Image reading (host side, numpy)."""

from __future__ import annotations

import numpy as np
from PIL import Image


def read_image(path: str) -> np.ndarray:
    """Read an image as (H, W, 3) uint8; grayscale is replicated to 3ch."""
    img = np.asarray(Image.open(path))
    if img.dtype != np.uint8 and np.issubdtype(img.dtype, np.integer):
        # 16-bit sources keep the high byte.
        img = (img.astype(np.uint32) >> 8).astype(np.uint8)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=-1)
    return img[..., :3].astype(np.uint8)
