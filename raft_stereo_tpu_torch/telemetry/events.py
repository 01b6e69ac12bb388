"""Structured run events: a versioned JSONL log and shared record headers.

* ``EventLog``: an append-only JSONL file; every line carries
  ``schema_version``, a wall-clock ``ts``, a monotonically increasing
  ``seq`` and an ``event`` kind.  The training loop emits run-start
  (config snapshot and device topology), periodic step-stat flushes,
  validation results, checkpoint, preemption and resume events, and
  compile events (telemetry/train_metrics.py); ``replay()`` reads the file
  back into the run timeline.
* ``bench_record()`` / ``write_record()``: a result dict wrapped with the
  same ``schema_version`` and run-metadata header (versions, host, the
  device), so every JSON record the port's tools write (the drift gates,
  ``cli/evaluate.py --stream_out``) names what produced it.
  ``write_record`` never overwrites a record of the JAX package's tools
  (``QUANT_DRIFT_r22.json``, ``BF16_DRIFT_r05.json``, ``STREAM_ci.json``,
  every ``*_r<N>.json`` and ``BENCH_*.json``): those are the reference's
  measurements, taken on other hardware.  ``default_path(name)`` puts a
  record under the package's git-ignored ``_build/records/``.

Writes are line-buffered and flushed per event: a SIGKILL mid-run loses at
most the event being written, and every earlier line stays valid JSON.
"""

from __future__ import annotations

import json
import logging
import os
import re
import socket
import threading
import time
from pathlib import Path
from typing import Callable, Dict, Iterator, Optional, Union

import torch

from raft_stereo_tpu_torch.parallel import distributed

log = logging.getLogger(__name__)

SCHEMA_VERSION = 1

RECORDS_DIR = Path(__file__).resolve().parent.parent / "_build" / "records"
_PRE_PORT = re.compile(r"(BENCH_.*|[A-Z0-9_]+_(r\d+|ci))\.json")


def device_topology(device: Union[None, str, torch.device] = None
                    ) -> Dict[str, object]:
    """Device summary for run headers: ``platform`` "gpu" or "cpu",
    ``device_kind`` (the card's name), ``n_devices``, and this process's
    rank and the world size of its process group (0 and 1 outside one,
    parallel/distributed.py).  ``device`` names the device a record was
    measured on; by default the card where there is one."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    ranks = {"process_index": distributed.process_index(),
             "process_count": distributed.process_count()}
    if device.type == "cuda":
        return {"platform": "gpu",
                "device_kind": torch.cuda.get_device_name(device),
                "n_devices": torch.cuda.device_count(), **ranks}
    return {"platform": "cpu", "device_kind": "cpu", "n_devices": 1,
            **ranks}


def run_metadata(device: Union[None, str, torch.device] = None
                 ) -> Dict[str, object]:
    """The shared header: who, where, when, which versions and device."""
    meta: Dict[str, object] = {
        "unix_time": time.time(),
        "hostname": socket.gethostname(),
        "pid": os.getpid(),
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
    }
    meta.update(device_topology(device))
    return meta


def default_path(name: str) -> str:
    """``name`` under the package's git-ignored build directory."""
    return str(RECORDS_DIR / name)


def bench_record(rec: Dict[str, object], **extra) -> Dict[str, object]:
    """Wrap a result with the shared versioned header.  The record's own
    keys stay top-level (the ``{"metric", "value", ...}`` contract the
    parsers read); the header rides alongside."""
    out: Dict[str, object] = {"schema_version": SCHEMA_VERSION,
                              "run": run_metadata()}
    out.update(rec)
    out.update(extra)
    return out


def write_record(path: str, rec: Dict[str, object],
                 indent: Optional[int] = None,
                 device: Union[None, str, torch.device] = None
                 ) -> Dict[str, object]:
    """Write one header-wrapped record to ``path`` (directories made; the
    header's device is ``device``); returns the wrapped record.  Refuses
    the file names of the JAX package's records."""
    if _PRE_PORT.fullmatch(os.path.basename(path)):
        raise ValueError(f"{path}: the name of a JAX package record; the "
                         f"port writes its own records elsewhere")
    wrapped = rec if "schema_version" in rec else {
        "schema_version": SCHEMA_VERSION, "run": run_metadata(device),
        **rec}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write(json.dumps(wrapped, indent=indent) + "\n")
    return wrapped


class EventLog:
    """Append-only JSONL run-event log (thread-safe)."""

    def __init__(self, path: str):
        self.path = path
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
        self._lock = threading.Lock()
        self._f = open(path, "a")
        self._seq = 0
        self._sinks: list = []

    def add_sink(self, sink: Callable[[Dict[str, object]], None]) -> None:
        """Mirror every emitted record into ``sink(rec)`` as well as the
        file — how the flight recorder keeps its bounded in-memory ring of
        recent events (telemetry/flight_recorder.py) without a second
        emission path that could drift from the log."""
        with self._lock:
            self._sinks.append(sink)

    def emit(self, event: str, **fields) -> Dict[str, object]:
        """Write one event line; returns the full record written."""
        with self._lock:
            if self._f is None:
                return {}
            rec = {"schema_version": SCHEMA_VERSION, "seq": self._seq,
                   "ts": time.time(), "event": event, **fields}
            self._seq += 1
            self._f.write(json.dumps(rec, default=_jsonable) + "\n")
            self._f.flush()
            for sink in self._sinks:
                try:
                    sink(rec)
                except Exception:  # pragma: no cover - sink must not kill
                    log.exception("event sink failed")      # the emitter
            return rec

    def close(self) -> None:
        with self._lock:
            if self._f is not None:
                self._f.close()
                self._f = None

    def __enter__(self) -> "EventLog":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _jsonable(v):
    """np scalars/arrays and other strays degrade to plain types instead of
    killing the training run with a serialization error."""
    for attr in ("item", "tolist"):
        f = getattr(v, attr, None)
        if f is not None:
            try:
                return f()
            except Exception:  # pragma: no cover - exotic array type
                pass
    return str(v)


def replay(path: str) -> Iterator[Dict[str, object]]:
    """Read an event log back in order, yielding complete records.

    A torn FINAL line (the process was killed mid-write — the at-most-one-
    line loss ``EventLog.emit`` guarantees) is tolerated with a warning
    instead of raising.  A malformed line anywhere EARLIER is not part of
    that guarantee — it means real corruption — so it is also skipped with
    a (louder) warning rather than silently, and the complete records
    around it still come back; a replay must never lose the readable
    majority of a run's timeline to one bad line."""
    with open(path) as f:
        lines = f.readlines()
    last = len(lines) - 1
    for i, line in enumerate(lines):
        stripped = line.strip()
        if not stripped:
            continue
        try:
            yield json.loads(stripped)
        except ValueError:
            if i == last and not line.endswith("\n"):
                log.warning(
                    "event log %s: torn final line (%d bytes) skipped — "
                    "the process was likely killed mid-write", path,
                    len(line))
            else:
                log.warning(
                    "event log %s: malformed record at line %d skipped — "
                    "this is mid-file corruption, not a torn tail", path,
                    i + 1)
