"""Flight recorder: a bounded in-memory ring of recent spans + run events
that dumps a post-mortem debug bundle when an anomaly triggers.

Aggregate metrics tell you THAT a run went bad; the page that follows asks
what the process was doing in the 30 seconds before the loss went NaN or
the step loop stalled.  The recorder holds exactly that evidence — the
span-tracer ring (telemetry/spans.py) and a ring of recent run events —
and on ``dump()`` writes one self-contained bundle directory:

* ``manifest.json``  — trigger, detail, timestamps, run metadata, file list
* ``trace.json``     — the span ring as Chrome trace-event JSON (Perfetto)
* ``spans.jsonl``    — the same spans as one-record-per-line JSON (greppable)
* ``events.jsonl``   — the recent-run-event ring, same schema as the event
  log so ``telemetry.events.replay()`` reads it back unchanged
* ``metrics.prom``   — a /metrics snapshot (Prometheus text exposition)
* ``stacks.txt``     — a stack dump of every live Python thread
* ``device_memory.json`` — per-card memory stats ({} on the CPU)

Dumps are serialized and rate-limited (at most one per ``min_interval_s``)
so a flapping detector cannot fill the disk; each bundle lands in its own
``<root>/<NNN>-<trigger>/`` directory.
"""

from __future__ import annotations

import collections
import json
import logging
import os
import sys
import threading
import time
import traceback
from typing import Dict, List, Optional

import torch

from raft_stereo_tpu_torch.telemetry.spans import SpanTracer, to_chrome_trace

log = logging.getLogger(__name__)


def dump_all_stacks() -> str:
    """Human-readable stack dump of every live Python thread (the
    ``GET /debug/stacks`` body and the bundle's ``stacks.txt``)."""
    frames = sys._current_frames()
    names = {t.ident: t.name for t in threading.enumerate()}
    out: List[str] = [f"{len(frames)} threads at {time.strftime('%X')}\n"]
    for ident, frame in frames.items():
        out.append(f"--- thread {names.get(ident, '?')} (ident {ident}) ---")
        out.extend(line.rstrip()
                   for line in traceback.format_stack(frame))
        out.append("")
    return "\n".join(out)


def device_memory_snapshot() -> Dict[str, Dict[str, object]]:
    """Per-card memory stats keyed by device string ({} on the CPU)."""
    from raft_stereo_tpu_torch.profiling import device_memory_stats
    if not torch.cuda.is_available():
        return {}
    return {f"cuda:{i}": device_memory_stats(i)
            for i in range(torch.cuda.device_count())}


class FlightRecorder:
    """Bounded recent-history ring + triggered debug-bundle writer.

    Wire-up: give it the run's ``SpanTracer`` and ``MetricsRegistry``,
    and mirror run events into it via ``record_event`` (``EventLog``
    accepts the recorder as a sink).  ``dump()`` is safe to call from any
    thread — watchdogs, the HTTP surface, or a signal handler.
    """

    def __init__(self, root: str,
                 tracer: Optional[SpanTracer] = None,
                 registry=None,
                 event_ring: int = 512,
                 min_interval_s: float = 5.0):
        self.root = root
        self.tracer = tracer
        self.registry = registry
        self.min_interval_s = min_interval_s
        self._events: "collections.deque[Dict[str, object]]" = (
            collections.deque(maxlen=max(1, event_ring)))
        self._lock = threading.Lock()
        self._n_dumps = 0
        self._last_dump_mono: Optional[float] = None
        self._last_trigger: Optional[str] = None
        self.bundles: List[str] = []

    # ------------------------------------------------------------ recording
    def record_event(self, rec: Dict[str, object]) -> None:
        """Event-log sink: keep the most recent events in memory.  Called
        under the EventLog's own lock — must stay non-blocking."""
        self._events.append(rec)

    def recent_events(self) -> List[Dict[str, object]]:
        with self._lock:
            return list(self._events)

    # ------------------------------------------------------------- dumping
    def dump(self, trigger: str, detail: Optional[Dict[str, object]] = None,
             force: bool = False) -> Optional[str]:
        """Write one debug bundle; returns its directory, or ``None`` when
        rate-limited (a dump ran less than ``min_interval_s`` ago and
        ``force`` is False — the flapping-detector guard)."""
        with self._lock:
            now = time.monotonic()
            if (not force and self._last_dump_mono is not None
                    and now - self._last_dump_mono < self.min_interval_s):
                log.warning("flight recorder dump for %r suppressed "
                            "(previous dump %.1fs ago)", trigger,
                            now - self._last_dump_mono)
                return None
            self._last_dump_mono = now
            self._last_trigger = trigger
            n = self._n_dumps
            self._n_dumps += 1
            events = list(self._events)
        safe = "".join(c if c.isalnum() or c in "-_" else "-"
                       for c in trigger) or "anomaly"
        bundle = os.path.join(self.root, f"{n:03d}-{safe}")
        os.makedirs(bundle, exist_ok=True)

        spans = self.tracer.spans() if self.tracer is not None else []
        files = []

        def write(name: str, payload: str) -> None:
            with open(os.path.join(bundle, name), "w") as f:
                f.write(payload)
            files.append(name)

        write("trace.json", json.dumps(to_chrome_trace(spans)))
        write("spans.jsonl",
              "".join(json.dumps(s.to_dict()) + "\n" for s in spans))
        write("events.jsonl",
              "".join(json.dumps(e, default=str) + "\n" for e in events))
        if self.registry is not None:
            write("metrics.prom", self.registry.render_text())
        write("stacks.txt", dump_all_stacks())
        write("device_memory.json",
              json.dumps(device_memory_snapshot(), default=str, indent=2))

        from raft_stereo_tpu_torch.telemetry.events import run_metadata
        write("manifest.json", json.dumps({
            "trigger": trigger, "detail": detail or {},
            "unix_time": time.time(), "n_spans": len(spans),
            "n_events": len(events), "files": files,
            "run": run_metadata()}, default=str, indent=2))
        with self._lock:
            self.bundles.append(bundle)
        log.warning("flight recorder: wrote debug bundle %s (trigger %r, "
                    "%d spans, %d events)", bundle, trigger, len(spans),
                    len(events))
        return bundle

    # -------------------------------------------------------------- status
    def status(self) -> Dict[str, object]:
        """The ``GET /debug/flightrecorder`` body."""
        with self._lock:
            out: Dict[str, object] = {
                "root": self.root,
                "event_ring_size": len(self._events),
                "event_ring_capacity": self._events.maxlen,
                "dumps": self._n_dumps,
                "last_trigger": self._last_trigger,
                "bundles": list(self.bundles),
            }
        if self.tracer is not None:
            out["spans"] = self.tracer.stats()
        return out
