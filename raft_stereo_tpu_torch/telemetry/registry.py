"""Shared metrics instruments: counters, gauges, histograms, text exposition.

ONE implementation across the three observability islands the repo grew —
serving (serving/metrics.py, which now re-exports from here), the training
runtime (telemetry/train_metrics.py), and the bench tooling — so every
subsystem exposes the same instrument semantics and the same Prometheus
text exposition format over the same stdlib HTTP machinery.

Everything here is stdlib + NumPy: a ``MetricsRegistry`` holds named
instruments, and ``render_text()`` emits the Prometheus text exposition
format so a stdlib HTTP endpoint (serving/http.py, telemetry/http.py
``GET /metrics``) is directly scrapable without any client library.

Histograms keep BOTH cumulative buckets (the scrape surface) and a bounded
reservoir of recent samples, because the bench and the drain report want
honest p50/p95/p99 — bucket interpolation at three-decade latency spreads
would be fiction.  The reservoir is a ring buffer: O(1) per observe, the
percentiles describe the most recent ``reservoir`` samples.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

# Seconds-scale latency buckets: 0.5 ms .. 30 s, roughly 1-2-5 per decade.
# Wide on purpose — the same instrument serves a local CPU fallback
# (micro-seconds of queue wait) and a remote-tunneled device (hundreds of ms
# per forward).
DEFAULT_LATENCY_BUCKETS = (
    0.0005, 0.001, 0.002, 0.005, 0.01, 0.02, 0.05,
    0.1, 0.2, 0.5, 1.0, 2.0, 5.0, 10.0, 30.0)


def escape_help(s: str) -> str:
    r"""HELP-line escaping per the Prometheus text exposition format:
    backslash and line feed (``\\`` and ``\n``)."""
    return s.replace("\\", r"\\").replace("\n", r"\n")


def escape_label_value(s: str) -> str:
    r"""Label-value escaping per the exposition format: backslash,
    double-quote, and line feed (``\\``, ``\"``, ``\n``).  Order matters —
    backslashes first, or the escapes themselves get re-escaped."""
    return (s.replace("\\", r"\\").replace('"', r'\"')
            .replace("\n", r"\n"))


def unescape_label_value(s: str) -> str:
    """Inverse of ``escape_label_value`` (the round-trip test's parser
    half; also handy for consumers of the text format)."""
    out, i = [], 0
    while i < len(s):
        c = s[i]
        if c == "\\" and i + 1 < len(s):
            nxt = s[i + 1]
            out.append({"\\": "\\", '"': '"', "n": "\n"}.get(nxt, c + nxt))
            i += 2
        else:
            out.append(c)
            i += 1
    return "".join(out)


def render_labels(labels: Optional[Dict[str, str]]) -> str:
    """``{k="v",...}`` with escaped values; empty string for no labels."""
    if not labels:
        return ""
    inner = ",".join(f'{k}="{escape_label_value(str(v))}"'
                     for k, v in labels.items())
    return "{" + inner + "}"


class Counter:
    """Monotonic counter (thread-safe)."""

    def __init__(self, name: str, help: str = "",
                 labels: Optional[Dict[str, str]] = None):
        self.name, self.help = name, help
        self.labels = dict(labels) if labels else {}
        self._lock = threading.Lock()
        self._value = 0

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        with self._lock:
            return self._value

    def render(self) -> List[str]:
        return [f"# HELP {self.name} {escape_help(self.help)}",
                f"# TYPE {self.name} counter",
                f"{self.name}{render_labels(self.labels)} {self.value}"]


class Gauge:
    """Instant value (thread-safe); ``set``/``inc``/``dec``."""

    def __init__(self, name: str, help: str = "",
                 labels: Optional[Dict[str, str]] = None):
        self.name, self.help = name, help
        self.labels = dict(labels) if labels else {}
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def inc(self, n: float = 1) -> None:
        with self._lock:
            self._value += n

    def dec(self, n: float = 1) -> None:
        self.inc(-n)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def render(self) -> List[str]:
        return [f"# HELP {self.name} {escape_help(self.help)}",
                f"# TYPE {self.name} gauge",
                f"{self.name}{render_labels(self.labels)} {self.value:g}"]


# Exemplars kept per histogram: enough to link the last few latency
# outliers to their trace IDs without growing the scrape payload.
EXEMPLAR_RING = 16


class Histogram:
    """Cumulative-bucket histogram + bounded reservoir for percentiles.

    ``observe`` is O(1); ``percentile`` sorts the reservoir on demand
    (scrape/report-time cost, not request-time).

    ``observe(v, exemplar=trace_id)`` additionally attaches a sampled
    trace ID as an exemplar (a bounded ring of recent ones): the bridge
    from an aggregate latency histogram to the specific request traces
    behind it (``GET /debug/spans`` serves the span side).  Exemplars ride
    the JSON debug surface, not the text exposition — the 0.0.4 text
    format predates exemplar syntax and adding OpenMetrics markers would
    break strict scrapers.
    """

    def __init__(self, name: str, help: str = "",
                 buckets: Iterable[float] = DEFAULT_LATENCY_BUCKETS,
                 reservoir: int = 4096,
                 labels: Optional[Dict[str, str]] = None):
        self.name, self.help = name, help
        self.labels = dict(labels) if labels else {}
        self.buckets: Tuple[float, ...] = tuple(sorted(buckets))
        self._lock = threading.Lock()
        self._counts = [0] * (len(self.buckets) + 1)  # +inf tail
        self._sum = 0.0
        self._count = 0
        self._samples = np.zeros(max(1, reservoir), np.float64)
        self._next = 0  # ring-buffer write cursor
        self._exemplars: "collections.deque[Dict[str, object]]" = (
            collections.deque(maxlen=EXEMPLAR_RING))

    def observe(self, v: float, exemplar: Optional[str] = None) -> None:
        v = float(v)
        with self._lock:
            i = 0
            for i, edge in enumerate(self.buckets):
                if v <= edge:
                    break
            else:
                i = len(self.buckets)
            self._counts[i] += 1
            self._sum += v
            self._count += 1
            self._samples[self._next % len(self._samples)] = v
            self._next += 1
            if exemplar is not None:
                self._exemplars.append(
                    {"value": v, "trace_id": exemplar, "ts": time.time()})

    def exemplars(self) -> List[Dict[str, object]]:
        """Recent (value, trace_id, ts) exemplars, oldest first."""
        with self._lock:
            return [dict(e) for e in self._exemplars]

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def mean(self) -> float:
        with self._lock:
            return self._sum / self._count if self._count else 0.0

    def percentile(self, q: float) -> float:
        """q in [0, 100] over the reservoir (recent samples); 0.0 if empty."""
        with self._lock:
            n = min(self._next, len(self._samples))
            if not n:
                return 0.0
            return float(np.percentile(self._samples[:n], q))

    def percentiles(self, qs=(50, 95, 99)) -> Dict[str, float]:
        return {f"p{q:g}": self.percentile(q) for q in qs}

    def render(self) -> List[str]:
        with self._lock:
            counts, total, s = list(self._counts), self._count, self._sum
        lines = [f"# HELP {self.name} {escape_help(self.help)}",
                 f"# TYPE {self.name} histogram"]
        base = render_labels(self.labels)
        suffix = base[:-1] + "," if base else "{"  # merge le into labels
        cum = 0
        for edge, c in zip(self.buckets, counts):
            cum += c
            lines.append(f'{self.name}_bucket{suffix}le="{edge:g}"}} {cum}')
        lines.append(f'{self.name}_bucket{suffix}le="+Inf"}} {total}')
        lines.append(f"{self.name}_sum{base} {s:g}")
        lines.append(f"{self.name}_count{base} {total}")
        return lines


class MetricsRegistry:
    """Named instruments + the text exposition the HTTP endpoint serves.

    Instruments are keyed by ``(name, labels)``: several instruments may
    share a name with distinct constant labels (a *family* — the
    per-bucket padding-waste counters use this), and ``render_text``
    groups a family under one HELP/TYPE header as the exposition format
    requires.  Re-registering the exact same (name, labels) still
    raises — that is a real double-registration bug."""

    def __init__(self):
        self._lock = threading.Lock()
        self._instruments: Dict[tuple, object] = {}

    @staticmethod
    def _key(name: str, labels: Optional[Dict[str, str]]):
        return (name, tuple(sorted((labels or {}).items())))

    def _register(self, inst):
        with self._lock:
            key = self._key(inst.name, inst.labels)
            if key in self._instruments:
                raise ValueError(f"metric {inst.name!r} already registered")
            self._instruments[key] = inst
        return inst

    def counter(self, name: str, help: str = "",
                labels: Optional[Dict[str, str]] = None) -> Counter:
        return self._register(Counter(name, help, labels=labels))

    def gauge(self, name: str, help: str = "",
              labels: Optional[Dict[str, str]] = None) -> Gauge:
        return self._register(Gauge(name, help, labels=labels))

    def histogram(self, name: str, help: str = "",
                  buckets: Iterable[float] = DEFAULT_LATENCY_BUCKETS,
                  reservoir: int = 4096,
                  labels: Optional[Dict[str, str]] = None) -> Histogram:
        return self._register(Histogram(name, help, buckets, reservoir,
                                        labels=labels))

    def get(self, name: str,
            labels: Optional[Dict[str, str]] = None):
        """Instrument by name (and labels, for family members).  With no
        ``labels``, an unlabeled instrument of that name wins; otherwise
        the family's first-registered member is returned."""
        with self._lock:
            inst = self._instruments.get(self._key(name, labels))
            if inst is not None or labels is not None:
                return inst
            for (n, _), i in self._instruments.items():
                if n == name:
                    return i
            return None

    def items(self):
        """Snapshot of (name, instrument) pairs (the debug surfaces walk
        this for exemplars); family members repeat the name."""
        with self._lock:
            return [(name, inst)
                    for (name, _), inst in self._instruments.items()]

    def render_text(self) -> str:
        with self._lock:
            insts = list(self._instruments.values())
        # Group same-name instruments (label families) so each name gets
        # exactly one HELP/TYPE header followed by all its sample lines —
        # strict text-format parsers reject interleaved/duplicate headers.
        by_name: Dict[str, List[object]] = {}
        for inst in insts:
            by_name.setdefault(inst.name, []).append(inst)
        lines: List[str] = []
        for name, group in by_name.items():
            lines.extend(group[0].render())
            for inst in group[1:]:
                lines.extend(inst.render()[2:])  # drop repeat HELP/TYPE
        return "\n".join(lines) + "\n"
