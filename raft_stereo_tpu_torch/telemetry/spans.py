"""Request-path span tracing: per-request/per-step causality, exportable
as Chrome trace-event JSON (Perfetto-viewable).

The aggregates (telemetry/registry.py histograms) answer "how slow is
the service"; this module answers "why was THIS request slow".  A sampled
trace is a tree of spans — admission → queue → batch assembly → device
dispatch → fetch → respond on the serving path, data-wait / dispatch /
metric-drain / checkpoint on the train loop — each carrying monotonic
start/end timestamps and attributes (shape bucket, batch size, device).

Design constraints, in priority order:

1. **Zero overhead when disabled.**  ``sample_rate=0.0`` (the default) is
   the production-off switch: ``start_trace`` returns ``None`` and every
   span call takes the constant-time ``if trace is None`` exit.  No clock
   reads, no allocation, and — like all of telemetry/ — never a device
   fetch (tests assert the train loop's device-fetch count is
   identical with a sampling-0 tracer installed vs no telemetry at all).
2. **Cross-thread traces.**  A serving request is admitted on an HTTP
   thread, flushed by the batcher thread, and executed on a device-worker
   thread.  Spans therefore support *explicit* parenting (pass the
   ``Trace`` handle through ``Request``) alongside the usual thread-local
   implicit nesting for same-thread scopes.
3. **Bounded memory.**  Finished spans land in a ring (``deque`` with
   ``maxlen``); the flight recorder and ``GET /debug/spans`` read snapshots
   of the ring, never an unbounded log.

The export format is the Chrome trace-event JSON ``{"traceEvents": [...]}``
with complete ("X") events — the least-common-denominator format that
chrome://tracing, Perfetto, and speedscope all open directly.

**Cross-process propagation.**  A trace no longer stops at a
process boundary: ``encode_traceparent`` serializes a (trace id, parent
span id) pair into a W3C-``traceparent``-style header value
(``00-<trace-id>-<span-id>-<flags>``), ``decode_traceparent`` parses an
inbound one, and ``SpanTracer.adopt_trace`` opens a LOCAL root span under
the REMOTE parent — same trace id, so the fleet router's ``route.request``
span and the replica's ``serve.request`` span tell one story under one id.
Adoption honors the upstream sampling decision (the codec only travels on
sampled traces), so a replica at ``sample_rate=0`` still records adopted
traces — and still records nothing at all when no header arrives, which
keeps the zero-overhead-when-disabled contract intact.
"""

from __future__ import annotations

import collections
import dataclasses
import random
import threading
import time
from typing import Dict, Iterable, List, Optional

# Monotonic->wall anchor taken once at import: Chrome trace timestamps are
# microseconds on one consistent clock, and anchoring perf_counter to wall
# time makes span timestamps comparable with event-log ``ts`` fields.
_ANCHOR_PERF = time.perf_counter()
_ANCHOR_WALL = time.time()


def _wall_us(perf_t: float) -> float:
    return (_ANCHOR_WALL + (perf_t - _ANCHOR_PERF)) * 1e6


def _new_id(bits: int = 64) -> str:
    return f"{random.getrandbits(bits):0{bits // 4}x}"


# ---------------------------------------------------------- trace context
# The canonical propagation header, lowercase (HTTP header names are
# case-insensitive; W3C Trace Context spells it lowercase).
TRACE_CONTEXT_HEADER = "traceparent"

_CONTEXT_VERSION = "00"
_HEX = frozenset("0123456789abcdef")


@dataclasses.dataclass(frozen=True)
class TraceContext:
    """A trace's cross-process identity: which trace this request belongs
    to and which remote span is the local root's parent.  ``sampled``
    mirrors the W3C flags octet; an unsampled context is never emitted by
    ``encode_traceparent`` (unsampled traces are ``None`` everywhere), but
    a standards-shaped inbound header with flags ``00`` decodes to one so
    the caller can ignore it."""

    trace_id: str
    parent_span_id: str
    sampled: bool = True


def encode_traceparent(trace_id: str, span_id: str) -> str:
    """``00-<trace-id>-<span-id>-01``: the outbound header value carrying
    one sampled trace across a process hop.  Id widths are whatever the
    tracer minted (16-hex trace / 8-hex span ids here, vs W3C's 32/16) —
    the decoder accepts any hex run, so the round-trip is exact and a
    true W3C header from a foreign client parses too."""
    return f"{_CONTEXT_VERSION}-{trace_id}-{span_id}-01"


def decode_traceparent(value: Optional[str]) -> Optional[TraceContext]:
    """Parse an inbound ``traceparent``-style header; ``None`` for a
    missing or malformed value (propagation is best-effort — a broken
    header degrades to an unpropagated request, never an error)."""
    if not value:
        return None
    parts = value.strip().lower().split("-")
    if len(parts) != 4:
        return None
    version, trace_id, span_id, flags = parts
    if version != _CONTEXT_VERSION:
        return None
    if not trace_id or not span_id or len(flags) != 2:
        return None
    if not (set(trace_id) <= _HEX and set(span_id) <= _HEX
            and set(flags) <= _HEX):
        return None
    if set(trace_id) == {"0"} or set(span_id) == {"0"}:
        return None       # all-zero ids are the spec's "invalid" sentinel
    return TraceContext(trace_id=trace_id, parent_span_id=span_id,
                        sampled=bool(int(flags, 16) & 0x01))


@dataclasses.dataclass
class Span:
    """One timed operation inside a trace.  ``finish()`` stamps the end and
    moves the span into the tracer's ring; attributes set after finish are
    lost (the ring holds a finished snapshot)."""

    name: str
    trace_id: str
    span_id: str
    parent_id: Optional[str]
    t_start: float                      # perf_counter seconds
    t_end: Optional[float] = None
    attrs: Dict[str, object] = dataclasses.field(default_factory=dict)
    thread: str = ""
    _ringed: bool = dataclasses.field(default=False, repr=False)

    @property
    def duration_s(self) -> float:
        return (self.t_end or time.perf_counter()) - self.t_start

    def set_attr(self, key: str, value) -> None:
        self.attrs[key] = value

    def to_dict(self) -> Dict[str, object]:
        return {"name": self.name, "trace_id": self.trace_id,
                "span_id": self.span_id, "parent_id": self.parent_id,
                "start_us": _wall_us(self.t_start),
                "duration_us": self.duration_s * 1e6,
                "attrs": dict(self.attrs), "thread": self.thread}


class Trace:
    """A sampled trace: the handle that threads spans across threads.

    Created by ``SpanTracer.start_trace``; pass it wherever the request
    goes (e.g. ``serving.Request.trace``) and open child spans against it.
    ``None`` is the universal "not sampled" value — every tracer method
    accepts it and exits in constant time.
    """

    __slots__ = ("trace_id", "tracer", "root")

    def __init__(self, trace_id: str, tracer: "SpanTracer"):
        self.trace_id = trace_id
        self.tracer = tracer
        self.root: Optional[Span] = None


class _SpanScope:
    """Context manager binding one span to the current thread's implicit
    parent stack (so nested ``tracer.span()`` calls parent correctly)."""

    __slots__ = ("tracer", "span")

    def __init__(self, tracer: "SpanTracer", span: Span):
        self.tracer = tracer
        self.span = span

    def __enter__(self) -> Span:
        self.tracer._stack().append(self.span)
        return self.span

    def __exit__(self, *exc) -> None:
        stack = self.tracer._stack()
        if stack and stack[-1] is self.span:
            stack.pop()
        self.tracer.finish(self.span)


class _NullScope:
    """The unsampled path: one shared, allocation-free context manager."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return None


_NULL_SCOPE = _NullScope()


class SpanTracer:
    """Sampling span tracer with a bounded ring of finished spans.

    ``sample_rate`` is the probability a new trace is recorded (decided
    once per trace at ``start_trace``; all spans of a trace share its
    fate — a partial trace is worse than none).  ``ring`` bounds memory:
    the oldest finished spans fall off first.
    """

    def __init__(self, sample_rate: float = 0.0, ring: int = 4096,
                 seed: Optional[int] = None):
        if not 0.0 <= sample_rate <= 1.0:
            raise ValueError(f"sample_rate={sample_rate} must be in [0, 1]")
        self.sample_rate = float(sample_rate)
        self._rng = random.Random(seed)
        self._ring: "collections.deque[Span]" = collections.deque(
            maxlen=max(1, ring))
        self._lock = threading.Lock()
        self._local = threading.local()
        self.traces_started = 0
        self.traces_sampled = 0

    # ------------------------------------------------------------- sampling
    @property
    def enabled(self) -> bool:
        return self.sample_rate > 0.0

    def start_trace(self, name: Optional[str] = None, **attrs
                    ) -> Optional[Trace]:
        """Sampling decision + root span.  Returns ``None`` when this trace
        is not sampled (the constant-time disabled path); otherwise a
        ``Trace`` whose ``root`` span is already open — ``finish_trace``
        closes it."""
        if self.sample_rate <= 0.0:
            return None
        with self._lock:
            self.traces_started += 1
            sampled = (self.sample_rate >= 1.0
                       or self._rng.random() < self.sample_rate)
            if not sampled:
                return None
            self.traces_sampled += 1
        trace = Trace(_new_id(64), self)
        if name is not None:
            trace.root = self._open(name, trace, parent_id=None, attrs=attrs)
        return trace

    def adopt_trace(self, context: Optional[TraceContext],
                    name: Optional[str] = None, **attrs
                    ) -> Optional[Trace]:
        """Continue a REMOTE trace locally: same trace id, local root span
        parented under the remote span the context names.  The upstream
        tracer already made the sampling decision (unsampled traces never
        emit a context), so adoption bypasses the local ``sample_rate`` —
        a replica at rate 0 still records the hop a tracing router asked
        for, and records nothing otherwise.  ``None``/unsampled contexts
        return ``None`` in constant time."""
        if context is None or not context.sampled:
            return None
        with self._lock:
            self.traces_started += 1
            self.traces_sampled += 1
        trace = Trace(context.trace_id, self)
        if name is not None:
            trace.root = self._open(name, trace,
                                    parent_id=context.parent_span_id,
                                    attrs=attrs)
        return trace

    def finish_trace(self, trace: Optional[Trace]) -> None:
        if trace is not None and trace.root is not None:
            self.finish(trace.root)

    # --------------------------------------------------------------- spans
    def _open(self, name: str, trace: Trace, parent_id: Optional[str],
              attrs: Dict[str, object]) -> Span:
        return Span(name=name, trace_id=trace.trace_id, span_id=_new_id(32),
                    parent_id=parent_id, t_start=time.perf_counter(),
                    attrs=dict(attrs),
                    thread=threading.current_thread().name)

    def start_span(self, name: str, trace: Optional[Trace],
                   parent: Optional[Span] = None, **attrs) -> Optional[Span]:
        """Open a span explicitly (cross-thread use: the caller keeps the
        handle and calls ``finish``).  Parent defaults to the trace root."""
        if trace is None:
            return None
        if parent is None:
            parent = trace.root
        return self._open(name, trace,
                          parent.span_id if parent is not None else None,
                          attrs)

    def span(self, name: str, trace: Optional[Trace] = None, **attrs):
        """Scoped span context manager with thread-local implicit nesting:
        inside another ``span()`` block on the same thread, the inner span
        parents to the outer one."""
        if trace is None:
            return _NULL_SCOPE
        stack = self._stack()
        parent = stack[-1] if stack else trace.root
        return _SpanScope(self, self._open(
            name, trace, parent.span_id if parent is not None else None,
            attrs))

    def finish(self, span: Optional[Span]) -> None:
        """Stamp the end time and move the span into the ring; idempotent
        (a span can have two legitimate close paths — e.g. worker pickup
        vs the request future's done-callback — and must land once)."""
        if span is None:
            return
        if span.t_end is None:
            span.t_end = time.perf_counter()
        with self._lock:
            if span._ringed:
                return
            span._ringed = True
            self._ring.append(span)

    def add_span(self, name: str, trace: Optional[Trace], t_start: float,
                 t_end: float, parent: Optional[Span] = None,
                 **attrs) -> Optional[Span]:
        """Record a span retroactively from timestamps already measured
        (``time.perf_counter`` seconds).  The train loop uses this: its
        telemetry hooks already clock data-wait/dispatch/drain, so the
        trace costs no additional clock reads in the hot loop."""
        if trace is None:
            return None
        parent = parent if parent is not None else trace.root
        span = Span(name=name, trace_id=trace.trace_id, span_id=_new_id(32),
                    parent_id=parent.span_id if parent is not None else None,
                    t_start=t_start, t_end=t_end, attrs=dict(attrs),
                    thread=threading.current_thread().name)
        with self._lock:
            self._ring.append(span)
        return span

    def _stack(self) -> List[Span]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    # ------------------------------------------------------------ snapshots
    def spans(self) -> List[Span]:
        """Snapshot of the finished-span ring, oldest first."""
        with self._lock:
            return list(self._ring)

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()

    def stats(self) -> Dict[str, object]:
        with self._lock:
            return {"sample_rate": self.sample_rate,
                    "ring_size": len(self._ring),
                    "ring_capacity": self._ring.maxlen,
                    "traces_started": self.traces_started,
                    "traces_sampled": self.traces_sampled}


def to_chrome_trace(spans: Iterable[Span],
                    process_name: str = "raft_stereo_tpu_torch"
                    ) -> Dict[str, object]:
    """Chrome trace-event JSON (the ``{"traceEvents": [...]}`` object
    format) from finished spans.  Complete ("X") events carry the span
    tree through ``args`` (trace/span/parent ids) — chrome://tracing,
    Perfetto, and speedscope open the result directly.

    Spans are grouped into trace-event "threads" by the Python thread that
    produced them, which is the natural lane layout for the serving path
    (HTTP thread → batcher thread → device worker)."""
    tids: Dict[str, int] = {}
    events: List[Dict[str, object]] = [
        {"ph": "M", "pid": 1, "name": "process_name",
         "args": {"name": process_name}}]
    for span in spans:
        if span.t_end is None:      # unfinished: not exportable as "X"
            continue
        tid = tids.setdefault(span.thread, len(tids) + 1)
        events.append({
            "ph": "X", "pid": 1, "tid": tid, "name": span.name,
            "ts": _wall_us(span.t_start),
            "dur": max(0.0, (span.t_end - span.t_start) * 1e6),
            "cat": span.name.split(".", 1)[0],
            "args": {"trace_id": span.trace_id, "span_id": span.span_id,
                     "parent_id": span.parent_id, **span.attrs},
        })
    for thread, tid in tids.items():
        events.append({"ph": "M", "pid": 1, "tid": tid, "name": "thread_name",
                       "args": {"name": thread}})
    return {"traceEvents": events, "displayTimeUnit": "ms"}
