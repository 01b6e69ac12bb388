"""Shared content-addressed artifact store, the JAX package's
``serving/persist.py`` on the port: restart-to-ready (and scale-out)
without rebuilding what another process already built.

**What the store holds in the port.**  The JAX package serializes its
compiled XLA executables here.  The port compiles nothing at run time
but its CUDA kernels (kernels/_build.py runs ``nvcc`` on ``csrc/*.cu``),
and a CUDA graph, its other per-boot cost, cannot be serialized.  So the
port's artifacts are the kernel libraries: when the engine has an
``executable_cache_dir``, a miss in the package's ``_build/`` looks the
library up here first (``kernels/_build.set_artifact_store``) and, after
a build, stores it unless the store is read-only.  A boot from a store
the compile farm filled (``tools/compile_farm.py``) runs no ``nvcc``;
the graph captures are paid again at each boot.

* ``ExecutableDiskCache`` — a content-addressed store of artifacts.  The
  key is a SHA-256 over every coordinate the caller passes (for a kernel
  library: the source's hash, the ``nvcc`` flags, the toolkit's version
  and the architecture) and the ``backend_fingerprint`` (torch, its CUDA,
  the driver, the device): a new toolkit or a changed source misses
  cleanly and rebuilds (stale entries are dead files, never wrong code).

  **Layout** (the JAX package's): entries live at
  ``<store>/<key[:2]>/<key>.kernel`` with an optional ``<key>.json``
  manifest sidecar recording the human-readable coordinates — a flat
  SHA-256-addressed tree any shared medium can carry.  Flat entries
  (``<store>/<key>.kernel``) still load.  Because keys are pure content
  hashes, concurrent writers can share one directory with no
  coordination, and the atomic rename makes the last writer win with an
  equivalent artifact.  Each entry carries the SHA-256 of its payload,
  so a torn or flipped entry is a miss (logged once), never a library
  loaded from garbage.

  **Shared-store roles**: a compile farm populates the store
  (read-write); replicas may mount it ``read_only`` — they fetch warm
  artifacts but never write.

  **Garbage collection**: ``max_bytes`` bounds the store.  Entries are
  evicted least-recently-USED first (atime, which ``load`` refreshes
  explicitly via ``os.utime`` so noatime mounts still track use).  The
  ``bytes_gauge`` hook keeps the ``serve_persist_cache_bytes`` gauge
  live.

* ``SessionHandoffStore`` — the store's ``sessions/`` namespace: the
  serialized SessionStore blobs a draining replica publishes so its live
  streams survive a planned restart.  Content-hash keys, atomic writes,
  TTL-bounded.  Copied whole from the JAX package.

Degradation contract: an artifact that cannot be read, verified or
written logs and falls back to a fresh build.  The store can make boot
faster; it can never make serving wrong or down.  Writes are atomic
(tmp + ``os.replace``).
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

log = logging.getLogger(__name__)

# Bump to invalidate every existing cache entry on a format change.
CACHE_FORMAT_VERSION = 1

ENTRY_SUFFIX = ".kernel"
MANIFEST_SUFFIX = ".json"

# An entry is MAGIC + the payload's SHA-256 (32 bytes) + the payload.
ENTRY_MAGIC = b"RSTK1"


def backend_fingerprint() -> Dict[str, str]:
    """The torch/CUDA/device identity an artifact is only valid under."""
    import torch

    fp = {"torch": torch.__version__,
          "cuda": str(torch.version.cuda),
          "cache_format": str(CACHE_FORMAT_VERSION)}
    if torch.cuda.is_available():
        try:
            fp["driver"] = str(torch._C._cuda_getDriverVersion())
        except Exception:  # pragma: no cover - exotic builds
            fp["driver"] = ""
        fp["device_kind"] = torch.cuda.get_device_name(0)
        fp["capability"] = "%d.%d" % torch.cuda.get_device_capability(0)
    else:
        fp["device_kind"] = "cpu"
    return fp


def executable_cache_key(**coords: Any) -> str:
    """Stable content key of one artifact: the caller passes every
    coordinate that selects a distinct artifact and the backend
    fingerprint is mixed in here."""
    payload = dict(coords)
    payload["backend"] = backend_fingerprint()
    blob = json.dumps(payload, sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()


class ExecutableDiskCache:
    """Content-addressed store of artifacts (the port's kernel
    libraries), keyed by ``executable_cache_key``.

    ``load`` returns the artifact's bytes or None (miss / unreadable /
    failed hash — misses never raise).  ``store`` is best-effort and
    atomic, a no-op in ``read_only`` mode.  ``max_bytes`` bounds the
    store with LRU-by-atime eviction; ``bytes_gauge`` (any object with
    ``set``) tracks the post-GC total.
    """

    def __init__(self, cache_dir: str, max_bytes: Optional[int] = None,
                 read_only: bool = False, bytes_gauge=None):
        if max_bytes is not None and max_bytes < 0:
            raise ValueError(f"max_bytes={max_bytes} must be >= 0")
        self.cache_dir = os.path.abspath(os.path.expanduser(cache_dir))
        if not read_only:
            os.makedirs(self.cache_dir, exist_ok=True)
        self.max_bytes = max_bytes
        self.read_only = read_only
        self.bytes_gauge = bytes_gauge
        self._lock = threading.Lock()
        self._warned: set = set()   # corrupt entries already logged
        self.loads = 0       # warm hits served from disk
        self.stores = 0
        self.misses = 0
        self.evictions = 0
        if bytes_gauge is not None:
            bytes_gauge.set(self.total_bytes())

    # ------------------------------------------------------------- layout
    def _path(self, key: str) -> str:
        """Sharded canonical path: ``<store>/<key[:2]>/<key>.kernel``."""
        return os.path.join(self.cache_dir, key[:2],
                            f"{key}{ENTRY_SUFFIX}")

    def _legacy_path(self, key: str) -> str:
        """The flat layout, still honored on load."""
        return os.path.join(self.cache_dir, f"{key}{ENTRY_SUFFIX}")

    def _entries(self) -> List[Tuple[str, int, float]]:
        """Every entry file as ``(path, size, atime)`` — flat and
        sharded layouts alike; never raises (a racing eviction or an
        unshared store mid-write just drops out of the listing)."""
        out: List[Tuple[str, int, float]] = []
        try:
            roots = [self.cache_dir] + [
                os.path.join(self.cache_dir, d)
                for d in os.listdir(self.cache_dir)
                if len(d) == 2
                and os.path.isdir(os.path.join(self.cache_dir, d))]
        except OSError:
            return out
        for root in roots:
            try:
                names = os.listdir(root)
            except OSError:
                continue
            for name in names:
                if not name.endswith(ENTRY_SUFFIX):
                    continue
                path = os.path.join(root, name)
                try:
                    st = os.stat(path)
                except OSError:
                    continue
                out.append((path, st.st_size, st.st_atime))
        return out

    def total_bytes(self) -> int:
        """Bytes of artifact entries on disk (manifest sidecars are
        noise-level and not counted)."""
        return sum(size for _, size, _ in self._entries())

    # ----------------------------------------------------------------- load
    def _miss(self) -> None:
        with self._lock:
            self.misses += 1

    def _corrupt(self, path: str, why: str) -> None:
        with self._lock:
            self.misses += 1
            first = path not in self._warned
            self._warned.add(path)
        if first:
            log.warning("artifact cache entry %s is unusable (%s); "
                        "rebuilding (the entry will be rewritten)", path,
                        why)

    def load(self, key: str) -> Optional[bytes]:
        path = self._path(key)
        if not os.path.exists(path):
            legacy = self._legacy_path(key)
            path = legacy if os.path.exists(legacy) else path
        try:
            with open(path, "rb") as f:
                blob = f.read()
        except FileNotFoundError:
            self._miss()
            return None
        except OSError as e:
            self._corrupt(path, repr(e))
            return None
        head = len(ENTRY_MAGIC) + 32
        if not blob.startswith(ENTRY_MAGIC) or len(blob) < head:
            self._corrupt(path, "not an artifact entry")
            return None
        payload = blob[head:]
        if hashlib.sha256(payload).digest() != blob[len(ENTRY_MAGIC):head]:
            self._corrupt(path, "payload fails its SHA-256")
            return None
        # Mark use explicitly: LRU eviction orders by atime, and noatime
        # mounts would otherwise never see reads.  Best-effort (a
        # read-only mount cannot utime — fine, its GC runs elsewhere).
        try:
            os.utime(path)
        except OSError:
            pass
        with self._lock:
            self.loads += 1
        return payload

    # ---------------------------------------------------------------- store
    def store(self, key: str, payload: bytes,
              meta: Optional[Dict[str, Any]] = None) -> bool:
        """Write ``payload`` under ``key``; ``meta`` (optional) lands in a
        ``<key>.json`` manifest sidecar so a human (or an audit job) can
        read WHAT each content hash is."""
        if self.read_only:
            return False
        blob = ENTRY_MAGIC + hashlib.sha256(payload).digest() + payload
        path = self._path(key)
        tmp = f"{path}.tmp-{os.getpid()}-{threading.get_ident()}"
        try:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            with open(tmp, "wb") as f:
                f.write(blob)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        except OSError:
            log.warning("could not write artifact cache entry %s", path,
                        exc_info=True)
            try:
                os.unlink(tmp)
            except OSError:
                pass
            return False
        if meta is not None:
            self._write_manifest(key, meta, len(blob))
        with self._lock:
            self.stores += 1
        self.gc()
        return True

    def _write_manifest(self, key: str, meta: Dict[str, Any],
                        size: int) -> None:
        mpath = os.path.join(os.path.dirname(self._path(key)),
                             f"{key}{MANIFEST_SUFFIX}")
        tmp = f"{mpath}.tmp-{os.getpid()}-{threading.get_ident()}"
        try:
            with open(tmp, "w") as f:
                json.dump({"key": key, "bytes": size,
                           "backend": backend_fingerprint(), **meta},
                          f, indent=1, sort_keys=True, default=str)
            os.replace(tmp, mpath)
        except OSError:   # the manifest is advisory — never fail a store
            try:
                os.unlink(tmp)
            except OSError:
                pass

    # ------------------------------------------------------------------- gc
    def gc(self) -> int:
        """Evict least-recently-used entries until the store fits
        ``max_bytes``; returns the number evicted.  Also refreshes the
        bytes gauge.  No-op without a bound (the gauge still updates)."""
        entries = self._entries()
        total = sum(size for _, size, _ in entries)
        evicted = 0
        if (self.max_bytes is not None and not self.read_only
                and total > self.max_bytes):
            for path, size, _ in sorted(entries, key=lambda e: e[2]):
                if total <= self.max_bytes:
                    break
                try:
                    os.unlink(path)
                except OSError:
                    continue
                try:   # the manifest dies with its entry
                    os.unlink(path[:-len(ENTRY_SUFFIX)]
                              + MANIFEST_SUFFIX)
                except OSError:
                    pass
                total -= size
                evicted += 1
            if evicted:
                with self._lock:
                    self.evictions += evicted
                log.info("artifact cache GC: evicted %d LRU entr%s "
                         "(max_bytes=%d, now %d bytes)", evicted,
                         "y" if evicted == 1 else "ies",
                         self.max_bytes, total)
        if self.bytes_gauge is not None:
            self.bytes_gauge.set(total)
        return evicted

    def stats(self) -> Dict[str, int]:
        """The JAX cache's counters; ``disabled`` stays 0 (an artifact of
        the port is plain bytes: there is no serializer to fail)."""
        with self._lock:
            return {"loads": self.loads, "stores": self.stores,
                    "misses": self.misses, "evictions": self.evictions,
                    "disabled": 0,
                    "read_only": int(self.read_only)}


class SessionHandoffStore:
    """The artifact store's ``sessions/`` namespace: a gracefully
    draining replica publishes its serialized session blob here
    (serving/sessions.py ``SessionStore.export``), the router hands the
    content key to whichever survivors inherit those ids
    (``X-Handoff-Artifact``), and the receiving replica fetches the blob
    lazily at the session's next frame.

    Same degradation contract as the artifact store above: a handoff
    that cannot be written, read, or parsed costs warmth (those sessions
    cold-start), never correctness or uptime.  Keys are SHA-256 content
    hashes, writes are atomic, and ``gc`` ages published blobs out after
    ``ttl_s`` — a handoff is only useful for about one session TTL, so
    the namespace is self-bounding under rolling restarts.
    """

    SUFFIX = ".sessions"

    def __init__(self, store_dir: str, ttl_s: float = 600.0,
                 read_only: bool = False):
        self.dir = os.path.join(
            os.path.abspath(os.path.expanduser(store_dir)), "sessions")
        self.ttl_s = ttl_s
        self.read_only = read_only
        if not read_only:
            try:
                os.makedirs(self.dir, exist_ok=True)
            except OSError:
                log.warning("cannot create session handoff namespace %s",
                            self.dir, exc_info=True)

    def _path(self, key: str) -> str:
        return os.path.join(self.dir, f"{key}{self.SUFFIX}")

    def publish(self, blob: bytes) -> Optional[str]:
        """Write one handoff blob; returns its content key, or None when
        the write failed (the drain proceeds — its sessions fail over to
        the typed-loss path instead)."""
        if self.read_only:
            return None
        key = hashlib.sha256(blob).hexdigest()
        path = self._path(key)
        tmp = f"{path}.tmp-{os.getpid()}"
        try:
            os.makedirs(self.dir, exist_ok=True)
            with open(tmp, "wb") as f:
                f.write(blob)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        except OSError:
            log.warning("could not publish session handoff %s", path,
                        exc_info=True)
            try:
                os.unlink(tmp)
            except OSError:
                pass
            return None
        self.gc()
        return key

    def fetch(self, key: str) -> Optional[bytes]:
        """The blob for ``key``, or None (missing / unreadable / key
        fails the content-hash check — a torn or tampered file must not
        reach the parser as trusted state)."""
        try:
            with open(self._path(key), "rb") as f:
                blob = f.read()
        except OSError:
            return None
        if hashlib.sha256(blob).hexdigest() != key:
            log.warning("session handoff %s fails its content hash; "
                        "ignoring", key)
            return None
        return blob

    def gc(self) -> int:
        """Drop handoff blobs older than ``ttl_s`` (mtime); returns the
        count removed."""
        if self.read_only:
            return 0
        removed = 0
        try:
            names = os.listdir(self.dir)
        except OSError:
            return 0
        cutoff = time.time() - self.ttl_s
        for name in names:
            if not name.endswith(self.SUFFIX):
                continue
            path = os.path.join(self.dir, name)
            try:
                if os.stat(path).st_mtime < cutoff:
                    os.unlink(path)
                    removed += 1
            except OSError:
                continue
        return removed
