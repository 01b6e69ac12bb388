"""Build the CUDA sources under ``csrc/`` and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own
with ``nvcc`` into ``_build/<name>-<hash>.so`` inside the package (a
directory ``.gitignore`` lists).  The hash covers the source and the
flags, so a library is rebuilt exactly when either changes.  Sources
build in parallel, one ``nvcc`` each.  The compiler's register and
shared-memory report (``-Xptxas -v``) is kept beside each library as
``<name>-<hash>.log``.

Nothing here runs at import time: the kernels build on first use.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Sequence, Tuple

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_entries: Dict[Tuple[str, str], object] = {}


def sources() -> Dict[str, Path]:
    return {p.stem: p for p in sorted(CSRC_DIR.glob("*.cu"))}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit to build")


def library_path(name: str) -> Path:
    src = sources()[name]
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build(name: str) -> float:
    """Compile one source if its library is missing; returns seconds and
    reports a compile to ``profiling.note_build``."""
    lib = library_path(name)
    if lib.exists():
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(sources()[name])],
        capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stdout}"
                           f"{proc.stderr}")
    lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)
    seconds = time.perf_counter() - t0
    from raft_stereo_tpu_torch.profiling import note_build
    note_build(f"kernel_build:{name}", seconds)
    return seconds


def build_all() -> Dict[str, float]:
    """Build every source, all ``nvcc`` processes started together."""
    names = list(sources())
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        secs = list(pool.map(build, names))
    return dict(zip(names, secs))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        if name not in _libs:
            build(name)
            _libs[name] = ctypes.CDLL(str(library_path(name)))
        return _libs[name]


def entry(name: str, symbol: str, argtypes: Sequence[type]):
    """The C function ``symbol`` of ``csrc/<name>.cu`` with its argument
    types and its int return type, bound once: a launch then costs one
    dict lookup, not a ctypes attribute set per call."""
    fn = _entries.get((name, symbol))
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _entries[(name, symbol)] = fn
    return fn


def check(err: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
