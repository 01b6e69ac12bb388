"""The port's session store (``serving/sessions.py``) against the JAX
package's, host only: no model, no device.

* The JAX package's own store tests (``tests/test_sessions.py``) re-run
  with their names bound to the port's objects (``_port_twin``): TTL
  expiry and tombstones, LRU eviction, close stats, in-flight immunity,
  two clients at once, thumbnails and deltas.
* The same scripts of store operations under one injected clock go
  through both packages' stores, and what comes out is compared: created
  flags, typed errors and their reasons, live counts, close stats, the
  metrics' counters.
* Thumbnails and deltas bit-equal on seeded frames.
* Handoff blobs: the same records export to the same bytes in both
  packages; a port blob parses and imports in JAX, a JAX blob in the
  port, records equal; corrupted, truncated and fingerprint-mismatched
  blobs degrade the same entries to cold starts in both.

Every comparison is exact: the store is host code with no arithmetic
beyond the thumbnails' means, which both packages run through one numpy
expression.
"""

import threading

import numpy as np
import pytest

from raft_stereo_tpu.serving import sessions as jsessions
from raft_stereo_tpu_torch.serving import sessions as psessions
from test_torch_serving_queue import _port_twin

PACKAGES = {"jax": jsessions, "port": psessions}

STORE_TESTS = [
    "test_store_ttl_expiry_typed_and_tombstone_ages_out",
    "test_store_lru_eviction_at_capacity",
    "test_store_close_returns_stats_and_tombstones",
    "test_store_inflight_session_immune_to_sweep",
    "test_store_concurrent_access_two_clients",
    "test_frame_thumbnail_and_delta",
]


@pytest.mark.parametrize("name", STORE_TESTS)
def test_store_counterpart(name):
    _port_twin("test_sessions", name)()


def test_twins_bind_the_port_store():
    fn = _port_twin("test_sessions", STORE_TESTS[0])
    assert fn.__globals__["SessionStore"] is psessions.SessionStore
    assert fn.__globals__["SessionExpired"] is psessions.SessionExpired


class Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


class Counter:
    def __init__(self):
        self.value = 0

    def inc(self, n=1):
        self.value += n

    def set(self, v):
        self.value = v


def _store(mod, clock, **kw):
    counters = {k: Counter() for k in ("active", "created", "expired",
                                       "evicted")}
    store = mod.SessionStore(clock=clock, active_gauge=counters["active"],
                             created_counter=counters["created"],
                             expired_counter=counters["expired"],
                             evicted_counter=counters["evicted"], **kw)
    return store, counters


def _frame(sess, rng, warm, iters=None, hidden=False):
    sess.note_result(
        flow_low=rng.standard_normal((6, 8)).astype(np.float32),
        thumb=rng.standard_normal((3, 4)).astype(np.float32),
        bucket=(48, 64), raw_shape=(45, 60), warm=warm, iters_used=iters,
        hidden=(tuple(rng.standard_normal((4, 6 >> l, 8 >> l)).astype(
            np.float32) for l in range(3)) if hidden else None))


# Scripts of store operations: (op, id[, clock advance after]).
SCRIPTS = {
    "ttl": [("new", "a"), ("tick", 5.0), ("new", "a"), ("tick", 10.1),
            ("new", "a"), ("get", "a"), ("tick", 10.1), ("new", "a"),
            ("count",)],
    "lru": [("new", "a"), ("tick", 1), ("new", "b"), ("tick", 1),
            ("new", "a"), ("tick", 1), ("new", "c"), ("new", "b"),
            ("count",), ("new", "a"), ("new", "c"), ("close", "c"),
            ("new", "c"), ("close", "zz"), ("get", "zz"), ("count",)],
    "tombstones": [("new", f"s{i}") for i in range(12)]
    + [("close", f"s{i}") for i in range(0, 12, 3)]
    + [("tick", 3.0)] + [("new", f"s{i}") for i in range(12)]
    + [("tick", 20.0), ("sweep",), ("count",)]
    + [("new", f"s{i}") for i in range(12)] + [("count",)],
    "frames": [("new", "cam"), ("frame", "cam", False, 4),
               ("frame", "cam", True, 2), ("frame", "cam", True, None),
               ("cut", "cam"), ("frame", "cam", False, 6),
               ("close", "cam"), ("new", "cam"), ("count",)],
    "inflight": [("new", "slow"), ("lock", "slow"), ("tick", 100.0),
                 ("count",), ("touch", "slow"), ("unlock", "slow"),
                 ("tick", 0.5), ("new", "slow"), ("tick", 11.0),
                 ("get", "slow"), ("count",)],
}


def _run_script(mod, script, capacity=3, ttl_s=10.0):
    clock = Clock()
    store, counters = _store(mod, clock, capacity=capacity, ttl_s=ttl_s)
    rng = np.random.default_rng(0)
    log = []
    for op in script:
        kind = op[0]
        try:
            if kind == "tick":
                clock.t += op[1]
                continue
            if kind == "new":
                sess, created = store.get_or_create(op[1])
                log.append((kind, op[1], created, sess.frame_index))
            elif kind == "get":
                log.append((kind, store.get(op[1]).session_id))
            elif kind == "close":
                log.append((kind, store.close(op[1])))
            elif kind == "count":
                log.append((kind, store.active_count, len(store)))
            elif kind == "sweep":
                store.sweep()
            elif kind == "touch":
                store.touch(op[1])
            elif kind == "frame":
                _frame(store.get(op[1]), rng, op[2], op[3])
            elif kind == "cut":
                store.get(op[1]).scene_cuts += 1
            elif kind == "lock":
                store.get(op[1]).order_lock.acquire()
            elif kind == "unlock":
                store._sessions[op[1]].order_lock.release()
        except KeyError as e:
            log.append((kind, op[1], type(e).__name__,
                        getattr(e, "reason", None)))
    log.append({k: c.value for k, c in counters.items()})
    return log


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_store_scripts_equal_to_jax(name):
    """One script of operations under one injected clock through both
    packages' stores: every result, typed error and counter equal."""
    got = _run_script(psessions, SCRIPTS[name])
    want = _run_script(jsessions, SCRIPTS[name])
    assert got == want
    assert any(isinstance(e, tuple) and e[0] == "count" for e in got)


def test_store_two_clients_equal_to_jax():
    """Two threads hammering their own ids and a shared one, through each
    package's store: each id created once, the same live count."""
    out = {}
    for tag, mod in PACKAGES.items():
        store = mod.SessionStore(capacity=64, ttl_s=100.0)
        created = {"x": 0, "y": 0, "shared": 0}
        lock = threading.Lock()

        def client(own, store=store, created=created, lock=lock):
            for _ in range(200):
                for sid in (own, "shared"):
                    _, new = store.get_or_create(sid)
                    if new:
                        with lock:
                            created[sid] += 1

        threads = [threading.Thread(target=client, args=(o,))
                   for o in ("x", "y")]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        out[tag] = (created, store.active_count)
    assert out["port"] == out["jax"] == ({"x": 1, "y": 1, "shared": 1}, 3)


@pytest.mark.parametrize("hw", [(48, 64), (375, 1242), (15, 20), (33, 47)])
def test_thumbnails_and_deltas_bit_equal(hw):
    rng = np.random.default_rng(hw[0] * 7 + hw[1])
    a = rng.integers(0, 256, hw + (3,), dtype=np.uint8)
    b = np.clip(a.astype(np.int16) + rng.integers(-30, 30, a.shape), 0,
                 255).astype(np.uint8)
    for pool in (16, 8):
        ta, tb = (psessions.frame_thumbnail(x, pool) for x in (a, b))
        ja, jb = (jsessions.frame_thumbnail(x, pool) for x in (a, b))
        assert ta.dtype == ja.dtype and np.array_equal(ta, ja)
        assert np.array_equal(tb, jb)
        assert psessions.frame_delta(ta, tb) == jsessions.frame_delta(ja, jb)
    assert psessions.frame_delta(None, ta) is None
    assert psessions.THUMB_POOL == jsessions.THUMB_POOL


# ------------------------------------------------------------- handoff
def _filled(mod, n=6, with_ctx=True, with_hidden=True, seed=7):
    """The same records in a store of ``mod``: flows, thumbnails,
    counters, hidden trees (three levels) and context bundles with a None
    leaf."""
    store = mod.SessionStore(clock=Clock())
    rng = np.random.default_rng(seed)
    for i in range(n):
        sess, _ = store.get_or_create(f"cam-{i}")
        for k in range(1 + i % 3):
            _frame(sess, rng, warm=k > 0, iters=3 + i,
                   hidden=with_hidden and i % 3 != 2)
        sess.scene_cuts = i % 2
        sess.ctx_hits = i
        if with_ctx and i % 2 == 0:
            sess.ctx = ((rng.standard_normal((4, 6, 8)).astype(np.float32),),
                        ((rng.standard_normal((4, 6, 8)).astype(np.float32),
                          None),))
    return store


def _records_equal(got, want):
    assert sorted(got) == sorted(want)
    for sid in want:
        gm, ga = got[sid]
        wm, wa = want[sid]
        assert gm == wm
        assert set(ga) == set(wa)
        for name in wa:
            _tree_equal(ga[name], wa[name])


def _tree_equal(a, b):
    if b is None:
        assert a is None
    elif isinstance(b, np.ndarray):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    else:
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _tree_equal(x, y)


@pytest.mark.parametrize("fingerprint", [None, "ab" * 32])
def test_blobs_equal_and_cross_parse(fingerprint):
    """The same records export to the same bytes in both packages; each
    package parses the other's blob into equal records."""
    pblob = _filled(psessions).export(config_fingerprint=fingerprint)
    jblob = _filled(jsessions).export(config_fingerprint=fingerprint)
    assert pblob == jblob
    assert psessions.handoff_fingerprint(jblob) == fingerprint
    assert jsessions.handoff_session_ids(pblob) == \
        psessions.handoff_session_ids(jblob)
    got, pskip = psessions.parse_handoff_blob(jblob)
    want, jskip = jsessions.parse_handoff_blob(pblob)
    assert pskip == jskip == 0 and len(got) == 6
    _records_equal(got, want)


def test_blob_imports_both_ways():
    """A port blob imported by JAX's store and a JAX blob by the port's:
    every field that decides the next frame's warmth arrives equal."""
    src = {"port": _filled(psessions), "jax": _filled(jsessions)}
    for exporter, importer in (("port", jsessions), ("jax", psessions)):
        dst = importer.SessionStore(clock=Clock())
        assert dst.import_(src[exporter].export()) == (6, 0)
        for i in range(6):
            a, b = src[exporter].get(f"cam-{i}"), dst.get(f"cam-{i}")
            assert type(b) is importer.StereoSession
            meta_a, arr_a = a.to_record()
            meta_b, arr_b = b.to_record()
            assert meta_a == meta_b
            for name in arr_a:
                _tree_equal(arr_b[name], arr_a[name])
            assert b.stats() == a.stats()


def test_corrupt_and_truncated_blobs_degrade_alike():
    """Flipped bytes and truncations: neither package raises, and both
    keep and skip the same entries (at worst a session starts cold)."""
    blob = _filled(psessions, n=4, with_ctx=False).export()
    rng = np.random.default_rng(11)
    cases = []
    for _ in range(40):
        bad = bytearray(blob)
        bad[int(rng.integers(0, len(bad)))] ^= 0xFF
        cases.append(bytes(bad))
    cases += [blob[:len(blob) * k // 10] for k in range(10)]
    cases += [b"", b"RSTPU-SESS", blob[:12] + b"\xff" * 8]
    for bad in cases:
        got, pskip = psessions.parse_handoff_blob(bad)
        want, jskip = jsessions.parse_handoff_blob(bad)
        assert pskip == jskip
        _records_equal(got, want)
        p = psessions.SessionStore(clock=Clock()).import_(bad)
        j = jsessions.SessionStore(clock=Clock()).import_(bad)
        assert p == j and p[0] == len(got)


def test_fingerprint_mismatch_refused_alike():
    """A blob stamped with another fingerprint is refused wholesale by
    both stores (every session skipped); a matching one imports; an
    unstamped one is not refused."""
    for exporter in (psessions, jsessions):
        blob = _filled(exporter, n=3).export(config_fingerprint="aa" * 32)
        for importer in (psessions, jsessions):
            dst = importer.SessionStore(clock=Clock())
            assert dst.import_(blob, expect_fingerprint="bb" * 32) == (0, 3)
            assert dst.active_count == 0
            assert dst.import_(blob, expect_fingerprint="aa" * 32) == (3, 0)
        plain = _filled(exporter, n=2).export()
        for importer in (psessions, jsessions):
            dst = importer.SessionStore(clock=Clock())
            assert dst.import_(plain, expect_fingerprint="bb" * 32)[0] == 2


def test_import_respects_live_and_tombstoned_ids_alike():
    blob = _filled(jsessions, n=3, with_ctx=False).export()
    outs = []
    for mod in (psessions, jsessions):
        dst = mod.SessionStore(clock=Clock())
        live, _ = dst.get_or_create("cam-0")
        live.frame_index = 99
        dst.close(dst.get_or_create("cam-1")[0].session_id)
        res = dst.import_(blob)
        outs.append((res, dst.get("cam-0").frame_index,
                     dst.get("cam-2").frame_index))
        with pytest.raises(mod.SessionExpired):
            dst.get("cam-1")
        assert dst.import_(blob, overwrite=True) == (2, 1)
        assert dst.get("cam-0").frame_index != 99
    assert outs[0] == outs[1] and outs[0][:2] == ((1, 2), 99)


def test_note_result_and_adopt_equal_to_jax():
    """``note_result`` (the keyframe guard's None flow drops the hidden
    tree too), ``adopt`` and ``stats`` with confidence give the JAX
    session's fields."""
    states = []
    for mod in (psessions, jsessions):
        store = mod.SessionStore(clock=Clock())
        sess, _ = store.get_or_create("s")
        rng = np.random.default_rng(3)
        _frame(sess, rng, warm=False, iters=5, hidden=True)
        h = sess.hidden
        sess.note_result(flow_low=None, thumb=None, bucket=(32, 48),
                         raw_shape=(32, 48), warm=True, iters_used=2,
                         hidden=h, confidence=0.625)
        assert sess.flow_low is None and sess.hidden is None
        other, _ = store.get_or_create("t")
        store.adopt(other, *sess.to_record())
        states.append((sess.stats(), other.stats(), other.bucket,
                       other.raw_shape, sess.iters_used_mean(),
                       sess.confidence_mean()))
    assert states[0] == states[1]
