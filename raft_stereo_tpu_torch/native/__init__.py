"""ctypes bindings for the native host-side decoders (``stereo_native.cpp``
beside this file): the JAX package's ``native`` module, built the way the
port builds its kernels.

The library builds at first use with one ``g++ -O3 -fPIC -shared ...
-lpng -lz`` into the package's git-ignored ``_build/`` directory, as
``stereo_native-<hash>.so``, the hash covering the source, the compiler's
name and the flags (``kernels/_build.py``'s rule: a change of either
rebuilds), through a per-process temporary file and an atomic rename.  If
the compiler or libpng is missing, ``available()`` is False and
``unavailable_reason()`` says why (the compiler's own message); the
readers in ``data/frame_utils.py`` then take their Python paths, and the
loader says which readers it uses (``data/loader.py``).

ctypes releases the GIL for the duration of each foreign call, so decodes
scale across the ``StereoLoader`` worker threads.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from raft_stereo_tpu_torch.kernels._build import BUILD_DIR

log = logging.getLogger(__name__)

SOURCE = Path(__file__).resolve().parent / "stereo_native.cpp"
CXX = "g++"
CXX_FLAGS = ("-O3", "-fPIC", "-shared")
LIBS = ("-lpng", "-lz")
BUILD_TIMEOUT_S = 120

_lib: Optional[ctypes.CDLL] = None
_reason: Optional[str] = None      # why the library is unavailable
_lib_lock = threading.Lock()

_i64 = ctypes.c_int64
_i64p = ctypes.POINTER(ctypes.c_int64)


def library_path() -> Path:
    """``_build/stereo_native-<hash>.so`` of the current source, compiler
    and flags."""
    digest = hashlib.sha256(
        SOURCE.read_bytes()
        + " ".join((CXX,) + CXX_FLAGS + LIBS).encode()).hexdigest()
    return BUILD_DIR / f"stereo_native-{digest[:16]}.so"


def _build(lib: Path) -> Optional[str]:
    """Compile into ``lib``; None on success, else the reason."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [CXX, *CXX_FLAGS, "-o", str(tmp), str(SOURCE), *LIBS]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=BUILD_TIMEOUT_S)
    except (OSError, subprocess.SubprocessError) as e:
        return f"{' '.join(cmd)}: {e}"
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        return (f"{' '.join(cmd)} exited {proc.returncode}: "
                f"{(proc.stdout + proc.stderr).strip()}")
    os.replace(tmp, lib)
    return None


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _reason
    if _lib is not None or _reason is not None:
        return _lib
    with _lib_lock:
        if _lib is not None or _reason is not None:
            return _lib
        lib_path = library_path()
        if not lib_path.exists():
            reason = _build(lib_path)
            if reason is not None:
                _reason = reason
                log.warning("native decoders unavailable: %s", reason)
                return None
        try:
            lib = ctypes.CDLL(str(lib_path))
        except OSError as e:
            _reason = f"loading {lib_path}: {e}"
            log.warning("native decoders unavailable: %s", _reason)
            return None
        lib.pfm_dims.argtypes = [ctypes.c_char_p, _i64, _i64p, _i64p, _i64p]
        lib.pfm_decode.argtypes = [ctypes.c_char_p, _i64, ctypes.c_void_p]
        lib.png_dims.argtypes = [ctypes.c_char_p, _i64,
                                 _i64p, _i64p, _i64p, _i64p]
        lib.png_decode_rgb8.argtypes = [ctypes.c_char_p, _i64, ctypes.c_void_p]
        lib.png_decode_gray16.argtypes = [ctypes.c_char_p, _i64,
                                          ctypes.c_void_p]
        for f in (lib.pfm_dims, lib.pfm_decode, lib.png_dims,
                  lib.png_decode_rgb8, lib.png_decode_gray16):
            f.restype = ctypes.c_int
        _lib = lib
        return _lib


def available() -> bool:
    """Whether the decoders are built and loaded (builds on first call)."""
    return _load() is not None


def unavailable_reason() -> Optional[str]:
    """Why ``available()`` is False (None while it is True)."""
    _load()
    return _reason


def _need() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native decoders unavailable: {_reason}")
    return lib


def read_pfm(path: str) -> np.ndarray:
    """Decode a PFM file: (H, W) float32 for 'Pf', (H, W, 3) for 'PF',
    rows top-down (the contract of data.frame_utils.read_pfm)."""
    lib = _need()
    with open(path, "rb") as f:
        buf = f.read()
    w, h, c = _i64(), _i64(), _i64()
    rc = lib.pfm_dims(buf, len(buf), ctypes.byref(w), ctypes.byref(h),
                      ctypes.byref(c))
    if rc:
        raise ValueError(f"{path}: PFM parse error {rc}")
    # A corrupt or truncated header could declare huge dims: bound them by
    # the payload before allocating, so the caller gets the ValueError
    # that routes it to the Python reader, not a MemoryError.
    if w.value * h.value * c.value * 4 > len(buf):
        raise ValueError(
            f"{path}: PFM header declares {w.value}x{h.value}x{c.value} "
            f"floats but file holds only {len(buf)} bytes")
    out = np.empty((h.value, w.value, c.value), np.float32)
    rc = lib.pfm_decode(buf, len(buf), out.ctypes.data_as(ctypes.c_void_p))
    if rc:
        raise ValueError(f"{path}: PFM decode error {rc}")
    return out[..., 0] if c.value == 1 else out


def png_info(buf: bytes) -> Tuple[int, int, int, int]:
    """(width, height, bit_depth, channels) of an in-memory PNG."""
    lib = _need()
    w, h, d, c = _i64(), _i64(), _i64(), _i64()
    rc = lib.png_dims(buf, len(buf), ctypes.byref(w), ctypes.byref(h),
                      ctypes.byref(d), ctypes.byref(c))
    if rc:
        raise ValueError(f"PNG parse error {rc}")
    return w.value, h.value, d.value, c.value


def read_png_rgb8(path: str) -> np.ndarray:
    """Decode any 8/16-bit PNG to (H, W, 3) uint8 (gray replicated, alpha
    dropped, 16-bit sources keep the high byte): the native path of
    data.frame_utils.read_image."""
    lib = _need()
    with open(path, "rb") as f:
        buf = f.read()
    w, h, _, _ = png_info(buf)
    out = np.empty((h, w, 3), np.uint8)
    rc = lib.png_decode_rgb8(buf, len(buf),
                             out.ctypes.data_as(ctypes.c_void_p))
    if rc:
        raise ValueError(f"{path}: PNG decode error {rc}")
    return out


def read_png_gray16(path: str) -> np.ndarray:
    """Decode a 16-bit grayscale PNG to (H, W) uint16: KITTI disparity
    maps (value / 256 = px)."""
    lib = _need()
    with open(path, "rb") as f:
        buf = f.read()
    out_w, out_h, depth, channels = png_info(buf)
    if depth != 16 or channels != 1:
        raise ValueError(f"{path}: expected 16-bit gray, got "
                         f"{depth}-bit {channels}ch")
    out = np.empty((out_h, out_w), np.uint16)
    rc = lib.png_decode_gray16(buf, len(buf),
                               out.ctypes.data_as(ctypes.c_void_p))
    if rc:
        raise ValueError(f"{path}: PNG decode error {rc}")
    return out
