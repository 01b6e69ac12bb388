"""Streaming stereo sessions: the temporal state behind warm-start video
serving, the JAX package's ``serving/sessions.py`` on the port.

RAFT-Stereo inherits RAFT's warm start (Teed & Deng, ECCV 2020;
arXiv 2109.07547 §3): the GRU refinement loop accepts an initial
disparity field (``flow_init``, models/raft_stereo.py), and initializing
frame t+1 from frame t's converged low-res disparity lets the
convergence-gated loop stall after a fraction of the iterations a cold
zero-init needs.  This module holds the per-stream state — one
``StereoSession`` per client stream mapping session id → the previous
frame's padded low-res x-flow, a grayscale thumbnail for the scene-cut
check, and bookkeeping — under a thread-safe TTL + LRU store.  The
engine (serving/engine.py ``submit_session``) keeps the flow and the
hidden state on the host, as numpy arrays, so the store can export them;
on the card the context bundle is a tree of tensors there, which an
export drops (the importer's next cold frame saves a new one).

Design points:

* **TTL expiry + LRU capacity eviction.**  A session that stops sending
  frames is garbage after ``ttl_s`` (a stale disparity field is a bad
  init anyway — the scene moved on), and the store holds at most
  ``capacity`` live sessions, evicting the least-recently-used beyond
  that.  Both removals leave a bounded **tombstone** so the next frame
  on a dead id fails with the typed ``SessionExpired`` (the HTTP layer's
  410) instead of silently cold-restarting mid-stream — the client must
  acknowledge the break and open a fresh session.  Tombstones age out
  after ``ttl_s``, so an id becomes reusable once the break is old news.
* **Per-session frame ordering.**  Warm start is a frame-to-frame chain:
  frame t+1's init IS frame t's output, so two frames of one session
  must never be in flight at once (the second would read stale state,
  and a batcher could reorder them within a dispatch cycle).  Each
  session carries an ordering lock the engine holds from submit until
  the frame's future resolves — one frame per session in the pipeline,
  strict submission order, while *different* sessions batch together
  freely.
* **Scene-cut fallback.**  Warm start helps only while frames are
  temporally coherent.  ``frame_delta`` — the mean |Δintensity| between
  consecutive frames' mean-pooled grayscale thumbnails — is compared
  against the engine's threshold; a cut falls back to a cold start (and
  the session keeps streaming: state re-seeds from the cold frame).
* **Handoff serialization.**  ``export()``/``import_()`` round-trip the
  whole store through a VERSIONED, per-entry-CHECKSUMMED blob, the JAX
  package's format byte for byte, so a draining replica of either
  package can hand its live streams to a survivor.  The format is
  deliberately paranoid: a self-describing header, one SHA-256 per
  session over its metadata AND its array payload, and pickle-free numpy
  encoding — a corrupt, truncated, or version-mismatched entry degrades
  that ONE session to a cold start (skipped, counted), never crashes the
  importer, and never installs a torn disparity field as a warm init.
  The port's hidden and context trees are NCHW per level (the JAX
  package's are NHWC); the engine's export writes the JAX layout
  (serving/engine.py ``_to_wire``), so a blob crosses packages.

Host code only: no tensor operation and no device here, so every policy
is testable in milliseconds (tests/test_torch_sessions.py).
"""

from __future__ import annotations

import dataclasses
import hashlib
import io
import json
import logging
import struct
import threading
import time
from collections import OrderedDict
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

log = logging.getLogger(__name__)

# Pooling factor of the scene-cut thumbnails: coarse enough that the
# per-frame host cost is trivial (~Kb), fine enough that a real scene
# change moves the mean intensity delta far past camera noise.
THUMB_POOL = 16


class SessionsDisabled(RuntimeError):
    """Streaming was requested but the engine runs without a session
    store (``ServeConfig.sessions=False``).  The HTTP layer maps this to
    a typed 400."""


class SessionExpired(KeyError):
    """The typed dead-session failure (HTTP 410): the id was live once
    but its session expired (TTL), was evicted (LRU capacity), or was
    closed — the client must open a fresh session.  ``reason`` is one of
    ``"expired"`` / ``"evicted"`` / ``"closed"``."""

    def __init__(self, session_id: str, reason: str):
        super().__init__(f"session {session_id!r} {reason}; open a new "
                         f"session to keep streaming")
        self.session_id = session_id
        self.reason = reason


def frame_thumbnail(image: np.ndarray, pool: int = THUMB_POOL) -> np.ndarray:
    """Mean-pooled grayscale thumbnail of one (H, W, 3) frame — the
    cheap host-side signature the scene-cut delta compares.  Pure NumPy,
    microseconds at video shapes."""
    gray = np.asarray(image, dtype=np.float32).mean(axis=-1)
    h, w = gray.shape
    hp, wp = h - h % pool, w - w % pool
    if hp >= pool and wp >= pool:
        gray = gray[:hp, :wp].reshape(hp // pool, pool,
                                      wp // pool, pool).mean(axis=(1, 3))
    return gray


def frame_delta(thumb_a: Optional[np.ndarray],
                thumb_b: Optional[np.ndarray]) -> Optional[float]:
    """Mean |Δintensity| (0..255) between two frame thumbnails; None when
    either side is missing or the shapes disagree (a resolution change is
    its own cold-start reason, not a measurable delta)."""
    if thumb_a is None or thumb_b is None or thumb_a.shape != thumb_b.shape:
        return None
    return float(np.mean(np.abs(thumb_a - thumb_b)))


# -------------------------------------------------------------- handoff
# Blob layout: MAGIC + u16 version + u32 manifest length + manifest JSON
# + concatenated array payload.  The manifest lists one entry per
# session: its metadata, the [offset, offset+length) payload slice its
# arrays occupy, and a SHA-256 over (canonical metadata JSON + slice).
# Arrays are packed as plain ``np.save`` segments (allow_pickle=False on
# the way back in) under a tiny recursive tree spec, so the ctx bundle's
# nested tuples survive without pickle.
#
# Version 2: entries additionally pack the GRU hidden-state
# tree (``StereoSession.hidden``, the warm-h chain's second state half)
# and the manifest carries the EXPORTING engine's exec-config
# fingerprint so an importer with a different compiled surface (other
# model config / iters / h-family knobs) degrades TYPED instead of
# silently installing state its programs cannot consume.  Version-1
# blobs (no hidden, no fingerprint) are rejected by the version check —
# their sessions cold-start, the documented degrade.
HANDOFF_MAGIC = b"RSTPU-SESS"
HANDOFF_VERSION = 2

# Array trees one session entry packs (in spec order).
_RECORD_ARRAYS = ("flow_low", "thumb", "ctx", "hidden")

# StereoSession counters that ride the handoff verbatim.
_RECORD_COUNTERS = ("frame_index", "warm_frames", "cold_frames",
                    "scene_cuts", "ctx_hits", "iters_used_sum",
                    "iters_used_frames")


def _pack_tree(obj, out: io.BytesIO):
    """Spec node for one array tree: ndarray leaves become np.save
    segments appended to ``out`` (offsets relative to the session's
    payload slice); tuples/lists recurse; None passes through.  Raises
    ``TypeError`` on anything else — the caller decides whether that
    drops the leaf's whole tree (ctx) or the session."""
    if obj is None:
        return {"k": "none"}
    if isinstance(obj, np.ndarray):
        start = out.tell()
        np.save(out, obj, allow_pickle=False)
        return {"k": "nd", "o": start, "n": out.tell() - start}
    if isinstance(obj, (tuple, list)):
        return {"k": "tuple" if isinstance(obj, tuple) else "list",
                "items": [_pack_tree(x, out) for x in obj]}
    raise TypeError(f"unserializable handoff leaf: {type(obj).__name__}")


def _unpack_tree(spec, payload: bytes):
    kind = spec["k"]
    if kind == "none":
        return None
    if kind == "nd":
        seg = payload[spec["o"]:spec["o"] + spec["n"]]
        return np.load(io.BytesIO(seg), allow_pickle=False)
    if kind in ("tuple", "list"):
        items = [_unpack_tree(s, payload) for s in spec["items"]]
        return tuple(items) if kind == "tuple" else items
    raise ValueError(f"unknown handoff tree node {kind!r}")


def _entry_digest(meta: Dict[str, object], payload: bytes) -> str:
    h = hashlib.sha256()
    h.update(json.dumps(meta, sort_keys=True, default=str).encode())
    h.update(payload)
    return h.hexdigest()


def export_sessions_blob(records: Iterable[Tuple[Dict[str, object],
                                                 Dict[str, object]]],
                         config_fingerprint: Optional[str] = None
                         ) -> bytes:
    """Serialize ``(meta, arrays)`` session records (see
    ``StereoSession.to_record``) into one handoff blob.
    ``config_fingerprint`` (engine.exec_config_fingerprint) stamps the
    manifest so an importer with a DIFFERENT compiled surface (model
    config / iters / h-family knobs) can refuse the whole blob typed
    instead of installing state its programs cannot consume."""
    entries: List[Dict[str, object]] = []
    body = io.BytesIO()
    for meta, arrays in records:
        seg = io.BytesIO()
        spec: Dict[str, object] = {}
        for name in ("flow_low", "thumb"):
            spec[name] = _pack_tree(arrays.get(name), seg)
        for name in ("ctx", "hidden"):
            mark = seg.tell()
            try:
                spec[name] = _pack_tree(arrays.get(name), seg)
            except (TypeError, ValueError, OSError):
                # These trees can carry backend-exotic leaves (bf16 via
                # ml_dtypes) np.save may refuse.  Warmth only needs the
                # flow: drop the tree — the ctx bundle re-establishes at
                # the next cold ctx frame on the importer, and a missing
                # hidden tree demotes that session's first inherited
                # frame to a cold start (the stateless baseline, never a torn
                # state).
                seg.seek(mark)
                seg.truncate()
                spec[name] = {"k": "none"}
        payload = seg.getvalue()
        entries.append({"id": meta["session_id"], "meta": meta,
                        "spec": spec, "offset": body.tell(),
                        "length": len(payload),
                        "sha256": _entry_digest(meta, payload)})
        body.write(payload)
    manifest = json.dumps({"version": HANDOFF_VERSION,
                           "config_fingerprint": config_fingerprint,
                           "sessions": entries}).encode()
    return (HANDOFF_MAGIC + struct.pack("<HI", HANDOFF_VERSION,
                                        len(manifest))
            + manifest + body.getvalue())


def handoff_session_ids(blob: bytes) -> List[str]:
    """The session ids a handoff blob claims to carry (header-only read;
    [] on anything unparseable)."""
    manifest = _handoff_manifest(blob)
    if manifest is None:
        return []
    return [str(e.get("id")) for e in manifest.get("sessions", ())]


def handoff_fingerprint(blob: bytes) -> Optional[str]:
    """The exporting engine's exec-config fingerprint a handoff blob
    was stamped with (header-only read; None on anything unparseable or
    an unstamped blob)."""
    manifest = _handoff_manifest(blob)
    if manifest is None:
        return None
    fp = manifest.get("config_fingerprint")
    return str(fp) if fp is not None else None


def _handoff_manifest(blob: bytes) -> Optional[Dict[str, object]]:
    try:
        if not blob.startswith(HANDOFF_MAGIC):
            return None
        off = len(HANDOFF_MAGIC)
        version, mlen = struct.unpack_from("<HI", blob, off)
        if version != HANDOFF_VERSION:
            log.warning("handoff blob version %d != %d; ignoring "
                        "(sessions cold-start)", version, HANDOFF_VERSION)
            return None
        start = off + struct.calcsize("<HI")
        return json.loads(blob[start:start + mlen])
    except (struct.error, ValueError, UnicodeDecodeError):
        log.warning("unparseable handoff blob header; ignoring "
                    "(sessions cold-start)", exc_info=True)
        return None


def parse_handoff_blob(blob: bytes
                       ) -> Tuple[Dict[str, Tuple[Dict[str, object],
                                                  Dict[str, object]]],
                                  int]:
    """Decode a handoff blob into ``{sid: (meta, arrays)}`` plus the
    count of entries SKIPPED (checksum mismatch, truncation, undecodable
    arrays).  Never raises: total garbage returns ``({}, 0)`` — the
    affected sessions simply cold-start, which is the stateless baseline, not
    a failure."""
    manifest = _handoff_manifest(blob)
    if manifest is None:
        return {}, 0
    # The header's manifest length field is authoritative
    # (re-serializing the parsed manifest need not be byte-identical).
    _, mlen = struct.unpack_from("<HI", blob, len(HANDOFF_MAGIC))
    body_start = len(HANDOFF_MAGIC) + struct.calcsize("<HI") + mlen
    body = blob[body_start:]
    out: Dict[str, Tuple[Dict[str, object], Dict[str, object]]] = {}
    skipped = 0
    for entry in manifest.get("sessions", ()):
        try:
            payload = body[entry["offset"]:entry["offset"]
                           + entry["length"]]
            if len(payload) != entry["length"]:
                raise ValueError("truncated payload slice")
            meta = entry["meta"]
            if _entry_digest(meta, payload) != entry["sha256"]:
                raise ValueError("checksum mismatch")
            arrays = {name: _unpack_tree(
                          entry["spec"].get(name, {"k": "none"}), payload)
                      for name in _RECORD_ARRAYS}
            out[str(entry["id"])] = (meta, arrays)
        except Exception:   # noqa: BLE001 — per-entry degradation
            skipped += 1
            log.warning("handoff entry %r corrupt; that session will "
                        "cold-start", entry.get("id"), exc_info=True)
    return out, skipped


@dataclasses.dataclass
class StereoSession:
    """One client stream's temporal state.  ``flow_low`` is the previous
    frame's PADDED low-res x-flow (= -disparity, shape
    (Hp/f, Wp/f) float32) — exactly the tensor the model's ``flow_init``
    consumes; ``None`` until the first frame completes.  Mutated only
    under the store lock or while the session's ordering lock is held."""

    session_id: str
    created_mono: float
    last_used_mono: float
    bucket: Optional[Tuple[int, int]] = None   # padded (Hp, Wp) of state
    raw_shape: Optional[Tuple[int, int]] = None
    flow_low: Optional[np.ndarray] = None
    thumb: Optional[np.ndarray] = None
    # Cached CONTEXT bundle (engine session_ctx_cache): the per-level
    # initial GRU hidden states + context biases a cold state_ctx frame
    # computed, reused by warm_ctx frames while the inter-frame delta
    # proves the scene static; None until a cold frame saves one (and
    # again after any invalidation — scene cut, keyframe guard, a warm
    # frame past the static-scene gate).
    ctx: Optional[object] = None
    ctx_hits: int = 0             # frames served with the cached context
    # Final per-level GRU hidden states of the previous frame (tuple of
    # batch-axis-free host arrays) — the warm-h chain's second state
    # half (``ServeConfig.session_hidden``).  Carried and
    # invalidated in LOCKSTEP with ``flow_low``: scene cuts, the
    # keyframe guard, and crash demotion drop both, so a warm-h frame
    # never mixes a fresh disparity with a stale trajectory.
    hidden: Optional[object] = None
    # Registered-model PIN (multi-model serving): the model
    # name this stream's first frame resolved to, or None for the
    # implicit model.  Every later frame dispatches against the pinned
    # model — a stream never mixes weights mid-flight — and the pin
    # rides the handoff meta so an importer that doesn't serve it
    # degrades typed-cold instead of warm-starting on other weights.
    model: Optional[str] = None
    frame_index: int = 0          # frames COMPLETED (the next frame's index)
    warm_frames: int = 0
    cold_frames: int = 0
    scene_cuts: int = 0
    iters_used_sum: int = 0
    iters_used_frames: int = 0
    # Per-frame mean confidence accumulation (quality
    # observability; fed only when the engine serves with
    # ``ServeConfig.confidence``): the close stats report the stream's
    # lifetime mean and its last frame — the per-stream "was this stream
    # healthy" answer.  Advisory telemetry: deliberately NOT in the
    # handoff record (an imported stream restarts its quality history).
    confidence_sum: float = 0.0
    confidence_frames: int = 0
    confidence_last: Optional[float] = None
    # Frame-ordering lock (see module docstring): held from submit until
    # the frame's future resolves, so one session never has two frames
    # in flight and a dispatch cycle can never reorder them.
    order_lock: threading.Lock = dataclasses.field(
        default_factory=threading.Lock, repr=False, compare=False)

    def note_result(self, flow_low: Optional[np.ndarray],
                    thumb: Optional[np.ndarray],
                    bucket: Tuple[int, int], raw_shape: Tuple[int, int],
                    warm: bool, iters_used: Optional[int],
                    hidden: Optional[object] = None,
                    confidence: Optional[float] = None) -> None:
        """Fold one completed frame into the state (called by the engine
        while ``order_lock`` is held, so no torn reads are possible).
        ``flow_low=None`` drops the warm-start state — the engine's
        keyframe guard passes None when the frame never converged, so
        the next frame cold-starts.  ``hidden`` rides (and drops) with
        it: a dropped flow with a kept trajectory would be exactly the
        torn state the lockstep rule forbids."""
        self.flow_low = flow_low
        self.hidden = hidden if flow_low is not None else None
        self.thumb = thumb
        self.bucket = tuple(bucket)
        self.raw_shape = tuple(raw_shape)
        self.frame_index += 1
        if warm:
            self.warm_frames += 1
        else:
            self.cold_frames += 1
        if iters_used is not None:
            self.iters_used_sum += int(iters_used)
            self.iters_used_frames += 1
        if confidence is not None:
            self.confidence_sum += float(confidence)
            self.confidence_frames += 1
            self.confidence_last = float(confidence)

    def to_record(self) -> Tuple[Dict[str, object], Dict[str, object]]:
        """``(meta, arrays)`` snapshot for the handoff blob.  The caller
        must hold ``order_lock`` (the exporter does), so the fields are
        a consistent post-frame state, never a torn mid-dispatch one."""
        meta: Dict[str, object] = {"session_id": self.session_id,
                                   "bucket": (list(self.bucket)
                                              if self.bucket else None),
                                   "raw_shape": (list(self.raw_shape)
                                                 if self.raw_shape
                                                 else None)}
        for name in _RECORD_COUNTERS:
            meta[name] = int(getattr(self, name))
        if self.model is not None:
            # Only when pinned: implicit-model records stay byte-
            # identical to pre-registry blobs (same digest, same meta).
            meta["model"] = self.model
        return meta, {"flow_low": self.flow_low, "thumb": self.thumb,
                      "ctx": self.ctx, "hidden": self.hidden}

    def apply_record(self, meta: Dict[str, object],
                     arrays: Dict[str, object]) -> None:
        """Install a handed-off state into this (fresh) session: the
        next frame then warm-starts exactly as if the previous frame had
        completed locally.  Caller holds ``order_lock``."""
        self.bucket = (tuple(meta["bucket"]) if meta.get("bucket")
                       else None)
        self.raw_shape = (tuple(meta["raw_shape"])
                          if meta.get("raw_shape") else None)
        for name in _RECORD_COUNTERS:
            setattr(self, name, int(meta.get(name, 0)))
        self.model = meta.get("model") or None
        self.flow_low = arrays.get("flow_low")
        self.thumb = arrays.get("thumb")
        self.ctx = arrays.get("ctx")
        self.hidden = arrays.get("hidden")

    def iters_used_mean(self) -> Optional[float]:
        """Per-session mean GRU trip count — the number the close stats
        and the streaming bench report per stream."""
        if not self.iters_used_frames:
            return None
        return self.iters_used_sum / self.iters_used_frames

    def confidence_mean(self) -> Optional[float]:
        """Lifetime mean per-frame confidence; None unless the engine
        served this stream with confidence telemetry on."""
        if not self.confidence_frames:
            return None
        return self.confidence_sum / self.confidence_frames

    def stats(self) -> Dict[str, object]:
        out = {
            "session_id": self.session_id,
            **({"model": self.model} if self.model is not None else {}),
            "frames": self.frame_index,
            "warm_frames": self.warm_frames,
            "cold_frames": self.cold_frames,
            "scene_cuts": self.scene_cuts,
            "ctx_cache_hits": self.ctx_hits,
            "iters_used_mean": (round(self.iters_used_mean(), 3)
                                if self.iters_used_mean() is not None
                                else None),
        }
        if self.confidence_frames:
            # Only when fed: confidence-off close stats stay
            # byte-identical to the payload without confidence.
            out["confidence_mean"] = round(self.confidence_mean(), 4)
            out["confidence_last"] = round(self.confidence_last, 4)
        return out


class SessionStore:
    """Thread-safe session table: id → ``StereoSession`` with TTL expiry,
    LRU capacity eviction, and tombstoned removal (``SessionExpired``).

    ``clock`` is injectable (tests pin expiry deterministically).  The
    optional ``active_gauge`` / ``expired_counter`` / ``evicted_counter``
    instruments keep ``serve_sessions_*`` live without the store
    importing the metrics module."""

    def __init__(self, capacity: int = 256, ttl_s: float = 30.0,
                 clock=time.monotonic, active_gauge=None,
                 created_counter=None, expired_counter=None,
                 evicted_counter=None):
        if capacity < 1:
            raise ValueError(f"capacity={capacity} must be >= 1")
        if ttl_s <= 0:
            raise ValueError(f"ttl_s={ttl_s} must be > 0")
        self.capacity = capacity
        self.ttl_s = ttl_s
        self._clock = clock
        self._lock = threading.Lock()
        self._sessions: "OrderedDict[str, StereoSession]" = OrderedDict()
        # id -> (reason, tombstone_mono); bounded at 4x capacity and aged
        # out after ttl_s, so dead ids 410 for one TTL window and then
        # become creatable again.
        self._tombstones: "OrderedDict[str, Tuple[str, float]]" = (
            OrderedDict())
        self._active_gauge = active_gauge
        self._created = created_counter
        self._expired = expired_counter
        self._evicted = evicted_counter

    # ----------------------------------------------------------- internals
    def _note_active(self) -> None:
        if self._active_gauge is not None:
            self._active_gauge.set(len(self._sessions))

    def _bury(self, sid: str, reason: str, now: float) -> None:
        self._tombstones[sid] = (reason, now)
        self._tombstones.move_to_end(sid)
        while len(self._tombstones) > 4 * self.capacity:
            self._tombstones.popitem(last=False)
        if reason == "expired" and self._expired is not None:
            self._expired.inc()
        if reason == "evicted" and self._evicted is not None:
            self._evicted.inc()

    def _sweep_locked(self, now: float) -> None:
        """Expire TTL-stale sessions and aged-out tombstones.  Sessions
        iterate in last-used order (every touch moves to the back), so
        the scan stops at the first live one.  A session whose ordering
        lock is held has a frame IN FLIGHT (a first-frame compile can
        outlast a short TTL) — it is skipped, and the frame's completion
        callback touches it back to freshness."""
        expired = []
        for sid, sess in self._sessions.items():
            if now - sess.last_used_mono <= self.ttl_s:
                break
            if sess.order_lock.locked():
                continue
            expired.append(sid)
        for sid in expired:
            del self._sessions[sid]
            self._bury(sid, "expired", now)
        while self._tombstones:
            sid, (_reason, t) = next(iter(self._tombstones.items()))
            if now - t <= self.ttl_s:
                break
            del self._tombstones[sid]
        self._note_active()

    def _check_tombstone_locked(self, sid: str) -> None:
        entry = self._tombstones.get(sid)
        if entry is not None:
            raise SessionExpired(sid, entry[0])

    # -------------------------------------------------------------- surface
    def get_or_create(self, sid: str) -> Tuple[StereoSession, bool]:
        """The session for ``sid``, creating it on first use.  Returns
        ``(session, created)``.  Raises ``SessionExpired`` when the id is
        tombstoned (expired / evicted / closed within the last TTL
        window) — the 410 contract: a broken stream must be re-opened
        explicitly, never silently restarted."""
        now = self._clock()
        with self._lock:
            self._sweep_locked(now)
            sess = self._sessions.get(sid)
            if sess is not None:
                sess.last_used_mono = now
                self._sessions.move_to_end(sid)
                return sess, False
            self._check_tombstone_locked(sid)
            while len(self._sessions) >= self.capacity:
                evicted_id, _ = self._sessions.popitem(last=False)
                self._bury(evicted_id, "evicted", now)
            sess = StereoSession(session_id=sid, created_mono=now,
                                 last_used_mono=now)
            self._sessions[sid] = sess
            if self._created is not None:
                self._created.inc()
            self._note_active()
            return sess, True

    def get(self, sid: str) -> StereoSession:
        """The live session for ``sid``; ``SessionExpired`` on a
        tombstone, plain ``KeyError`` on an id this store never saw."""
        now = self._clock()
        with self._lock:
            self._sweep_locked(now)
            sess = self._sessions.get(sid)
            if sess is None:
                self._check_tombstone_locked(sid)
                raise KeyError(sid)
            sess.last_used_mono = now
            self._sessions.move_to_end(sid)
            return sess

    def touch(self, sid: str) -> None:
        """Refresh ``sid``'s last-used stamp (no-op on unknown ids) —
        the frame-completion callback calls this so a long dispatch
        counts as activity, not idleness."""
        now = self._clock()
        with self._lock:
            sess = self._sessions.get(sid)
            if sess is not None:
                sess.last_used_mono = now
                self._sessions.move_to_end(sid)

    def close(self, sid: str) -> Dict[str, object]:
        """End one session deliberately: removes it and returns its
        lifetime stats (the DELETE response body).  The id tombstones as
        ``"closed"`` for one TTL window so a straggler frame racing the
        close gets the typed 410, not a silent new session."""
        now = self._clock()
        with self._lock:
            self._sweep_locked(now)
            sess = self._sessions.pop(sid, None)
            if sess is None:
                self._check_tombstone_locked(sid)
                raise KeyError(sid)
            self._bury(sid, "closed", now)
            self._note_active()
        return sess.stats()

    # -------------------------------------------------------------- handoff
    def export(self, config_fingerprint: Optional[str] = None,
               record_fn=None) -> bytes:
        """Serialize every live session into one versioned, checksummed
        handoff blob (the graceful-drain path).
        Acquires each session's ordering lock, so a frame still in
        flight completes — and folds its state in — before that session
        is captured; with admission already stopped (begin_shutdown)
        every lock wait is bounded by one frame's latency.
        ``config_fingerprint`` stamps the blob with the exporter's
        exec-config identity (the mismatch-typed import).  ``record_fn``
        (the port's addition) maps each ``(meta, arrays)`` record before
        it is packed: the engine's layout rule (serving/engine.py
        ``_to_wire``)."""
        with self._lock:
            self._sweep_locked(self._clock())
            sessions = list(self._sessions.values())
        records = []
        for sess in sessions:
            with sess.order_lock:
                record = sess.to_record()
            records.append(record if record_fn is None
                           else record_fn(*record))
        return export_sessions_blob(records,
                                    config_fingerprint=config_fingerprint)

    def import_(self, blob: bytes, overwrite: bool = False,
                expect_fingerprint: Optional[str] = None
                ) -> Tuple[int, int]:
        """Bulk-install a handoff blob's sessions; returns ``(imported,
        skipped)``.  Corrupt entries, tombstoned ids, and (without
        ``overwrite``) ids already live here are skipped — an import can
        only ever ADD warmth, never clobber a stream this store is
        actively serving or resurrect one it deliberately killed.
        With ``expect_fingerprint`` set, a blob stamped with a DIFFERENT
        exporter fingerprint is refused wholesale — every session counts
        skipped (the typed config-mismatch degrade; the engine's lazy
        adoption path applies the same check with its own metric)."""
        if expect_fingerprint is not None:
            stamped = handoff_fingerprint(blob)
            if stamped is not None and stamped != expect_fingerprint:
                n = len(handoff_session_ids(blob))
                log.warning(
                    "handoff blob exec-config fingerprint %.12s != this "
                    "store's %.12s; refusing %d session(s) — they "
                    "cold-start (config_mismatch)", stamped,
                    expect_fingerprint, n)
                return 0, n
        records, skipped = parse_handoff_blob(blob)
        now = self._clock()
        imported = 0
        with self._lock:
            self._sweep_locked(now)
            for sid, (meta, arrays) in records.items():
                if sid in self._tombstones:
                    skipped += 1
                    continue
                if sid in self._sessions and not overwrite:
                    skipped += 1
                    continue
                sess = StereoSession(session_id=sid, created_mono=now,
                                     last_used_mono=now)
                sess.apply_record(meta, arrays)
                while len(self._sessions) >= self.capacity \
                        and sid not in self._sessions:
                    evicted_id, _ = self._sessions.popitem(last=False)
                    self._bury(evicted_id, "evicted", now)
                self._sessions[sid] = sess
                self._sessions.move_to_end(sid)
                imported += 1
            self._note_active()
        return imported, skipped

    def adopt(self, sess: StereoSession, meta: Dict[str, object],
              arrays: Dict[str, object]) -> None:
        """Install one handed-off record into an already-created session
        (the LAZY import path: the engine creates the session at the
        frame's arrival and adopts state before deciding warm vs cold).
        Caller holds the session's ordering lock."""
        sess.apply_record(meta, arrays)

    def sweep(self) -> None:
        """Eagerly expire TTL-stale sessions (every access sweeps too —
        this is for idle-time housekeeping / tests)."""
        with self._lock:
            self._sweep_locked(self._clock())

    @property
    def active_count(self) -> int:
        with self._lock:
            self._sweep_locked(self._clock())
            return len(self._sessions)

    def __len__(self) -> int:
        return self.active_count
