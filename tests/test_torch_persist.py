"""The artifact store on the port (CPU), against the JAX package's
``serving/persist.py``, and its use by ``kernels/_build.py``.

The JAX store holds serialized XLA executables; the port's holds the
kernel libraries ``nvcc`` builds (bytes with their SHA-256).  What the
two share is held equal: content keys (stable, and moved by every
coordinate), the ``<key[:2]>/<key>.<ext>`` layout with flat entries still
loading, the manifest sidecar, LRU-by-atime garbage collection under
``max_bytes`` (the same entries evicted from the same tree), the
read-only role, a corrupt entry as a logged miss, and
``SessionHandoffStore`` (publish, fetch, tamper, TTL), which the port
copies whole.  ``kernels/_build.build`` takes a library from the store
instead of running ``nvcc`` (a fake source; no compiler on the CPU).
"""

import logging
import os
import time

import numpy as np
import pytest

from raft_stereo_tpu.serving import persist as jpersist
from raft_stereo_tpu_torch.kernels import _build
from raft_stereo_tpu_torch.serving import persist as ppersist


def test_keys_are_content_hashes_like_jax():
    coords = dict(name="gru_gates", source_sha256="ab" * 32,
                  flags="-O3", toolkit="12.4", arch="sm_90a")
    for mod in (ppersist, jpersist):
        key = mod.executable_cache_key(**coords)
        assert len(key) == 64 and int(key, 16) >= 0
        assert key == mod.executable_cache_key(**dict(reversed(
            list(coords.items()))))
        for field in coords:
            moved = dict(coords, **{field: coords[field] + "x"})
            assert mod.executable_cache_key(**moved) != key
    fp = ppersist.backend_fingerprint()
    assert {"torch", "cuda", "device_kind", "cache_format"} <= set(fp)
    assert fp["cache_format"] == str(jpersist.CACHE_FORMAT_VERSION)


def test_layout_equal_to_jax(tmp_path):
    key = "ab" + "c" * 62
    p = ppersist.ExecutableDiskCache(str(tmp_path / "p"))
    j = jpersist.ExecutableDiskCache(str(tmp_path / "j"))
    for cache, suffix in ((p, ppersist.ENTRY_SUFFIX),
                          (j, jpersist.ENTRY_SUFFIX)):
        assert os.path.relpath(cache._path(key), cache.cache_dir) == \
            os.path.join("ab", key + suffix)
        assert os.path.relpath(cache._legacy_path(key),
                               cache.cache_dir) == key + suffix
    assert ppersist.MANIFEST_SUFFIX == jpersist.MANIFEST_SUFFIX


def test_store_load_manifest_and_legacy(tmp_path):
    cache = ppersist.ExecutableDiskCache(str(tmp_path))
    key = ppersist.executable_cache_key(name="x")
    payload = os.urandom(5000)
    assert cache.load(key) is None
    assert cache.store(key, payload, meta={"name": "x"})
    assert cache.load(key) == payload
    with open(os.path.join(tmp_path, key[:2], key + ".json")) as f:
        import json
        meta = json.load(f)
    assert meta["key"] == key and meta["name"] == "x"
    assert meta["backend"] == ppersist.backend_fingerprint()
    # a flat (legacy) entry still loads
    legacy = ppersist.executable_cache_key(name="legacy")
    os.replace(cache._path(key), cache._legacy_path(legacy))
    assert cache.load(legacy) == payload
    assert cache.stats() == {"loads": 2, "stores": 1, "misses": 1,
                             "evictions": 0, "disabled": 0,
                             "read_only": 0}


def _fill(cache, suffix, sizes, t0):
    """Entries of ``sizes`` bytes, flat and sharded, with atimes t0 + i;
    returns their keys in atime order."""
    keys = []
    for i, size in enumerate(sizes):
        key = f"{i:02x}" + "e" * 62
        path = cache._legacy_path(key) if i % 3 == 0 else cache._path(key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "wb") as f:
            f.write(b"\0" * size)
        os.utime(path, (t0 + i, t0 + i))
        keys.append(key)
    return keys


@pytest.mark.parametrize("max_bytes", [0, 1000, 2500, 10 ** 6])
def test_gc_evicts_what_jax_evicts(tmp_path, max_bytes):
    sizes = [400, 900, 300, 1200, 100, 700]
    survivors = []
    for mod in (ppersist, jpersist):
        root = tmp_path / mod.__name__.split(".")[0]
        cache = mod.ExecutableDiskCache(str(root))
        keys = _fill(cache, mod.ENTRY_SUFFIX, sizes, time.time() - 100)
        cache.max_bytes = max_bytes
        evicted = cache.gc()
        left = [k for k in keys if os.path.exists(cache._path(k))
                or os.path.exists(cache._legacy_path(k))]
        assert evicted == len(keys) - len(left)
        assert cache.total_bytes() <= max(max_bytes, 0) or not left
        survivors.append((left, evicted, cache.total_bytes()))
    assert survivors[0] == survivors[1]


def test_read_only_role_equal_to_jax(tmp_path):
    for mod in (ppersist, jpersist):
        root = tmp_path / mod.__name__.split(".")[0]
        ro = mod.ExecutableDiskCache(str(root), read_only=True,
                                     max_bytes=0)
        assert not os.path.exists(root)       # a read-only store makes none
        os.makedirs(root)
        keys = _fill(ro, mod.ENTRY_SUFFIX, [100, 200], time.time())
        assert ro.gc() == 0                   # never evicts
        assert ro.stats()["read_only"] == 1
        assert all(os.path.exists(ro._path(k))
                   or os.path.exists(ro._legacy_path(k)) for k in keys)
    ro = ppersist.ExecutableDiskCache(str(tmp_path / "raft_stereo_tpu_torch"),
                                      read_only=True)
    assert ro.store("f" * 64, b"payload") is False


def test_corrupt_entry_is_a_miss_logged_once(tmp_path, caplog):
    cache = ppersist.ExecutableDiskCache(str(tmp_path))
    key = ppersist.executable_cache_key(name="y")
    cache.store(key, b"library bytes" * 100)
    path = cache._path(key)
    blob = bytearray(open(path, "rb").read())
    blob[-7] ^= 0x01
    open(path, "wb").write(bytes(blob))
    with caplog.at_level(logging.WARNING):
        assert cache.load(key) is None
        assert cache.load(key) is None
    warned = [r for r in caplog.records if "unusable" in r.getMessage()]
    assert len(warned) == 1
    assert cache.stats()["misses"] == 2 and cache.stats()["loads"] == 0
    open(path, "wb").write(b"not an entry")
    assert cache.load(key) is None
    # the entry is rewritten by the next store
    cache.store(key, b"fresh")
    assert cache.load(key) == b"fresh"


def test_session_handoff_store_equal_to_jax(tmp_path):
    blob = b"RSTPU-SESS" + np.arange(300, dtype=np.uint8).tobytes()
    stores = [mod.SessionHandoffStore(str(tmp_path / str(i)), ttl_s=60.0)
              for i, mod in enumerate((ppersist, jpersist))]
    keys = [s.publish(blob) for s in stores]
    assert keys[0] == keys[1] and len(keys[0]) == 64
    for s in stores:
        assert s.fetch(keys[0]) == blob
        assert s.fetch("0" * 64) is None
        path = s._path(keys[0])
        open(path, "wb").write(blob[:-1] + b"X")   # tampered
        assert s.fetch(keys[0]) is None
        s.publish(blob)
        old = time.time() - 3600
        os.utime(path, (old, old))
        assert s.gc() == 1 and s.fetch(keys[0]) is None
    ro = [mod.SessionHandoffStore(str(tmp_path / "ro"), read_only=True)
          for mod in (ppersist, jpersist)]
    assert [s.publish(blob) for s in ro] == [None, None]
    assert [s.gc() for s in ro] == [0, 0]


@pytest.fixture
def fake_source(tmp_path, monkeypatch):
    """``_build`` over one fake source in a temporary package: no nvcc on
    the CPU, so the toolkit's version is pinned and a compile is a
    failure the test would see."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "fake.cu").write_text("extern \"C\" int f() { return 0; }\n")
    monkeypatch.setattr(_build, "CSRC_DIR", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(_build, "toolkit_version", lambda: "12.4.131")
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")

    def no_nvcc(*a, **k):
        raise AssertionError("nvcc ran")
    monkeypatch.setattr(_build.subprocess, "run", no_nvcc)
    yield tmp_path
    _build.set_artifact_store(None)


def test_build_fetches_the_library_from_the_store(fake_source):
    store = ppersist.ExecutableDiskCache(str(fake_source / "store"))
    coords = _build.artifact_coords("fake")
    assert coords["arch"] == "sm_90a" and coords["toolkit"] == "12.4.131"
    assert coords["flags"] == " ".join(_build.NVCC_FLAGS)
    key = _build.artifact_key("fake")
    store.store(key, b"\x7fELF library", meta=coords)
    runs, fetched = _build.nvcc_runs, _build.fetched
    _build.set_artifact_store(store)
    assert _build.build("fake") == 0.0
    lib = _build.library_path("fake")
    assert lib.read_bytes() == b"\x7fELF library"
    assert (_build.nvcc_runs, _build.fetched) == (runs, fetched + 1)
    assert _build.build("fake") == 0.0          # now a _build/ hit
    assert _build.fetched == fetched + 1
    # another source (or flags, toolkit, arch) is another key: a miss
    (fake_source / "csrc" / "fake.cu").write_text("// changed\n")
    assert _build.artifact_key("fake") != key
    with pytest.raises(AssertionError, match="nvcc ran"):
        _build.build("fake")
