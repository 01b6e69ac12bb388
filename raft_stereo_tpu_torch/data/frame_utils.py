"""Stereo file-format readers and writers (host side, numpy).

The JAX package's ``data/frame_utils.py``, Python readers only (its
optional ``native`` decoders are not ported; ROADMAP §D4): PFM,
Middlebury ``.flo``, the KITTI 16-bit PNG disparity, the Sintel packed
3-channel disparity with its occlusion masks, FallingThings depth with
the camera JSON, TartanAir ``.npy`` depth, and the Middlebury GT with its
non-occluded mask.

Readers return a plain ``(H, W)`` / ``(H, W, C)`` array (dense GT) or a
``(disparity, valid)`` tuple (formats with a validity channel), float32
or bool, HWC, never tensors.
"""

from __future__ import annotations

import json
import os
import re
from typing import Tuple, Union

import numpy as np
from PIL import Image

try:
    import cv2
    cv2.setNumThreads(0)  # loader threads must not oversubscribe
    cv2.ocl.setUseOpenCL(False)
except ImportError:  # pragma: no cover
    cv2 = None

FLO_MAGIC = 202021.25


# ------------------------------------------------------------------ images
def read_image(path: str) -> np.ndarray:
    """Read an image as (H, W, 3) uint8; grayscale is replicated to 3ch."""
    img = np.asarray(Image.open(path))
    if img.dtype != np.uint8 and np.issubdtype(img.dtype, np.integer):
        # 16-bit sources keep the high byte.
        img = (img.astype(np.uint32) >> 8).astype(np.uint8)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=-1)
    return img[..., :3].astype(np.uint8)


# --------------------------------------------------------------------- PFM
def read_pfm(path: str) -> np.ndarray:
    """Portable Float Map: 'Pf' (1ch) / 'PF' (3ch), rows stored bottom-up,
    the scale's sign gives the byte order."""
    with open(path, "rb") as f:
        header = f.readline().rstrip()
        if header == b"PF":
            channels = 3
        elif header == b"Pf":
            channels = 1
        else:
            raise ValueError(f"{path}: not a PFM file (header {header!r})")
        dims = f.readline()
        m = re.match(rb"^(\d+)\s+(\d+)\s*$", dims)
        if not m:
            raise ValueError(f"{path}: malformed PFM dimensions {dims!r}")
        width, height = int(m.group(1)), int(m.group(2))
        scale = float(f.readline().rstrip())
        dtype = "<f4" if scale < 0 else ">f4"
        data = np.fromfile(f, dtype, count=width * height * channels)
    shape = (height, width, 3) if channels == 3 else (height, width)
    return np.flipud(data.reshape(shape)).astype(np.float32)


def write_pfm(path: str, array: np.ndarray) -> None:
    if array.ndim != 2:
        raise ValueError("write_pfm writes single-channel maps")
    with open(path, "wb") as f:
        h, w = array.shape
        f.write(b"Pf\n" + f"{w} {h}\n".encode() + b"-1\n")
        f.write(np.flipud(array).astype("<f4").tobytes())


# --------------------------------------------------------------------- flo
def read_flo(path: str) -> np.ndarray:
    """Middlebury .flo optical flow -> (H, W, 2) float32."""
    with open(path, "rb") as f:
        magic = np.fromfile(f, "<f4", count=1)
        if magic.size == 0 or magic[0] != np.float32(FLO_MAGIC):
            raise ValueError(f"{path}: bad .flo magic {magic}")
        w = int(np.fromfile(f, "<i4", count=1)[0])
        h = int(np.fromfile(f, "<i4", count=1)[0])
        data = np.fromfile(f, "<f4", count=2 * w * h)
    return data.reshape(h, w, 2).astype(np.float32)


def write_flo(path: str, flow: np.ndarray) -> None:
    if flow.ndim != 3 or flow.shape[2] != 2:
        raise ValueError(f"write_flo wants (H, W, 2), got {flow.shape}")
    h, w = flow.shape[:2]
    with open(path, "wb") as f:
        np.array([FLO_MAGIC], "<f4").tofile(f)
        np.array([w, h], "<i4").tofile(f)
        flow.astype("<f4").tofile(f)


# ------------------------------------------------------------------- KITTI
def read_disp_kitti(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """KITTI 16-bit PNG: disparity*256, 0 = invalid."""
    if cv2 is not None:
        raw = cv2.imread(path, cv2.IMREAD_ANYDEPTH)
    else:  # pragma: no cover
        raw = np.asarray(Image.open(path))
    disp = raw.astype(np.float32) / 256.0
    return disp, disp > 0.0


def write_disp_kitti(path: str, disp: np.ndarray) -> None:
    enc = np.clip(disp * 256.0, 0, 2**16 - 1).astype(np.uint16)
    Image.fromarray(enc).save(path)


# ------------------------------------------------------------------ Sintel
def read_disp_sintel(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Sintel packs disparity into RGB: R*4 + G/64 + B/16384; the sibling
    ``occlusions`` tree masks occluded pixels."""
    a = np.asarray(Image.open(path)).astype(np.float32)
    disp = a[..., 0] * 4 + a[..., 1] / 64.0 + a[..., 2] / 16384.0
    occ = np.asarray(Image.open(path.replace("disparities", "occlusions")))
    return disp, (occ == 0) & (disp > 0)


# ----------------------------------------------------------- FallingThings
def read_disp_falling_things(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """FallingThings stores depth (16-bit PNG); disparity = fx * 6 cm
    baseline * 100 / depth, fx from the scene's camera JSON."""
    depth = np.asarray(Image.open(path)).astype(np.float32)
    cam_json = os.path.join(os.path.dirname(path), "_camera_settings.json")
    with open(cam_json) as f:
        intrinsics = json.load(f)
    fx = intrinsics["camera_settings"][0]["intrinsic_settings"]["fx"]
    with np.errstate(divide="ignore"):
        disp = (fx * 6.0 * 100) / depth
    return disp, disp > 0


# --------------------------------------------------------------- TartanAir
def read_disp_tartanair(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """TartanAir ``.npy`` depth; disparity = 80 / depth."""
    depth = np.load(path)
    with np.errstate(divide="ignore"):
        disp = 80.0 / depth
    return disp.astype(np.float32), disp > 0


# -------------------------------------------------------------- Middlebury
def read_disp_middlebury(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """MiddEval3 GT: disp0GT.pfm + mask0nocc.png (255 = non-occluded)."""
    if os.path.basename(path) != "disp0GT.pfm":
        raise ValueError(f"{path}: expected a disp0GT.pfm")
    disp = read_pfm(path)
    if disp.ndim != 2:
        raise ValueError(f"{path}: GT of shape {disp.shape}")
    nocc = np.asarray(Image.open(
        path.replace("disp0GT.pfm", "mask0nocc.png"))) == 255
    return disp, nocc


# ---------------------------------------------------------------- dispatch
ReaderResult = Union[np.ndarray, Tuple[np.ndarray, np.ndarray]]


def read_gen(path: str) -> ReaderResult:
    """Extension-dispatched read; PFM color maps drop the last channel."""
    ext = os.path.splitext(path)[1].lower()
    if ext in (".png", ".jpeg", ".jpg", ".ppm"):
        return read_image(path)
    if ext in (".bin", ".raw", ".npy"):
        return np.load(path)
    if ext == ".flo":
        return read_flo(path)
    if ext == ".pfm":
        x = read_pfm(path)
        return x if x.ndim == 2 else x[..., :-1]
    raise ValueError(f"read_gen: unsupported extension {ext!r} ({path})")
