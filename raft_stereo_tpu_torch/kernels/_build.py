"""Build the CUDA sources under ``csrc/`` and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own
with ``nvcc`` into ``_build/<name>-<hash>.so`` inside the package (a
directory ``.gitignore`` lists).  The hash covers the source and the
flags, so a library is rebuilt exactly when either changes.  Sources
build in parallel, one ``nvcc`` each.  The compiler's register and
shared-memory report (``-Xptxas -v``) is kept beside each library as
``<name>-<hash>.log``.

Nothing here runs at import time: the kernels build on first use.

With an artifact store attached (``set_artifact_store``: the serving
engine's ``executable_cache_dir``, serving/persist.py), a library missing
from ``_build/`` is looked up in the store first, under a key over the
source's hash, the flags, the toolkit's version and the architecture; a
library built here is stored there unless the store is read-only.
``nvcc_runs`` counts the compiler's runs in this process, ``fetched`` the
libraries the store supplied.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import json
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
_store = None            # serving.persist.ExecutableDiskCache, or None
nvcc_runs = 0
fetched = 0


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


def set_artifact_store(store) -> None:
    """Attach (or, with None, detach) the artifact store that a
    ``_build/`` miss reads before it runs ``nvcc``."""
    global _store
    _store = store


@functools.lru_cache(maxsize=None)
def toolkit_version() -> str:
    """The CUDA toolkit's version from its ``version.json`` beside
    ``bin/nvcc`` (no compiler run), else the SHA-256 of the ``nvcc``
    binary."""
    nvcc = _nvcc()
    root = os.path.dirname(os.path.dirname(os.path.realpath(nvcc)))
    try:
        with open(os.path.join(root, "version.json")) as f:
            info = json.load(f)
        return str((info.get("cuda_nvcc") or info["cuda"])["version"])
    except (OSError, ValueError, KeyError, TypeError):
        with open(nvcc, "rb") as f:
            return "sha256:" + hashlib.sha256(f.read()).hexdigest()


def artifact_coords(name: str) -> Dict[str, str]:
    """What selects one library in the artifact store."""
    arch = next(f.split("code=")[1] for f in NVCC_FLAGS if "code=" in f)
    return {"kind": "kernel_library", "name": name,
            "source_sha256": hashlib.sha256(
                sources()[name].read_bytes()).hexdigest(),
            "flags": " ".join(NVCC_FLAGS), "toolkit": toolkit_version(),
            "arch": arch}


def artifact_key(name: str) -> str:
    from raft_stereo_tpu_torch.serving.persist import executable_cache_key
    return executable_cache_key(**artifact_coords(name))


def _fetch(name: str, lib: Path) -> bool:
    """Install the store's library for ``name`` at ``lib``; False on a
    miss."""
    global fetched
    blob = _store.load(artifact_key(name))
    if blob is None:
        return False
    tmp = lib.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    tmp.write_bytes(blob)
    os.replace(tmp, lib)
    fetched += 1
    return True


def build(name: str) -> float:
    """Compile one source if its library is missing (from ``_build/``
    and from the artifact store); returns seconds and reports a compile
    to ``profiling.note_build``."""
    global nvcc_runs
    lib = library_path(name)
    if lib.exists():
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    if _store is not None and _fetch(name, lib):
        return 0.0
    tmp = lib.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    t0 = time.perf_counter()
    nvcc_runs += 1
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
    if _store is not None and not _store.read_only:
        _store.store(artifact_key(name), lib.read_bytes(),
                     meta=artifact_coords(name))
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
