"""On-demand, bounded profiler trace capture for HTTP endpoints.

``POST /debug/trace`` on the training endpoint (telemetry/http.py) opens
a ``profiling.trace()`` window on the LIVE process and returns the trace
directory: "curl the process that is already misbehaving" instead of
"re-run it with a profiler".

The window is strictly bounded.  At most one capture runs at a time (a
second request gets ``TraceBusy`` -> HTTP 409), and the window's own
thread closes it after ``duration_ms`` (clamped to ``MAX_TRACE_MS``) even
if nobody ever asks again.  The torch profiler's state is per thread, so
that one thread opens the window, waits out the duration and closes it;
the card's kernel activity is recorded whichever thread launches it.

Two things keep a window clear of what it must not overlap:
``profiling.trace`` waits while a CUDA graph is being captured (and a
capture waits for an open window to close), and an optional ``gate``, a
context manager the window's thread holds while the window opens (the
train loop passes ``TrainTelemetry.step_boundary``), makes a window open
only between two training steps.
"""

from __future__ import annotations

import contextlib
import logging
import os
import threading
from typing import Callable, ContextManager, Dict, Optional

log = logging.getLogger(__name__)

DEFAULT_TRACE_MS = 1000.0
MAX_TRACE_MS = 60_000.0


class TraceBusy(RuntimeError):
    """A capture is already open (one profiler window at a time)."""


class TraceCapture:
    """Serializes bounded ``profiling.trace()`` windows under ``root``."""

    def __init__(self, root: str = "profiles",
                 gate: Optional[Callable[[], ContextManager]] = None):
        self.root = root
        self.gate = gate
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._done = threading.Event()
        self._n = 0
        self.error: Optional[BaseException] = None   # the last window's

    @property
    def active(self) -> bool:
        with self._lock:
            return self._thread is not None and self._thread.is_alive()

    def start(self, duration_ms: Optional[float] = None) -> Dict[str, object]:
        """Open a capture window; returns ``{"trace_dir", "duration_ms"}``.
        Raises ``TraceBusy`` while a previous window is still open and
        ``ValueError`` on a non-positive duration."""
        ms = DEFAULT_TRACE_MS if duration_ms is None else float(duration_ms)
        if ms <= 0:
            raise ValueError(f"duration_ms={ms} must be > 0")
        ms = min(ms, MAX_TRACE_MS)
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                raise TraceBusy("a trace capture is already running")
            trace_dir = os.path.join(self.root, f"ondemand-{self._n}")
            self._n += 1
            self._done = threading.Event()
            self._thread = threading.Thread(
                target=self._window, args=(trace_dir, ms, self._done),
                daemon=True, name="trace-window")
            self._thread.start()
        return {"trace_dir": trace_dir, "duration_ms": ms}

    def _window(self, trace_dir: str, ms: float,
                done: threading.Event) -> None:
        from raft_stereo_tpu_torch import profiling

        try:
            window = profiling.trace(trace_dir)
            with self.gate() if self.gate else contextlib.nullcontext():
                window.__enter__()
            try:
                done.wait(ms / 1e3)
            finally:
                window.__exit__(None, None, None)
            self.error = None
        except BaseException as e:  # kept for the caller; the loop runs on
            log.exception("trace window %s failed", trace_dir)
            self.error = e

    def stop(self) -> bool:
        """Close the window early (idempotent) and wait for its trace to be
        written.  Returns True if a capture was actually closed."""
        with self._lock:
            thread, done = self._thread, self._done
        if thread is None or not thread.is_alive():
            return False
        done.set()
        thread.join()
        return True
