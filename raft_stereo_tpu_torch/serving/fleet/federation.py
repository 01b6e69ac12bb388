"""Metrics federation: one scrape surface for the whole fleet.

The router's ``GET /metrics/fleet`` re-exposes every in-rotation
replica's ``/metrics`` with a ``replica="<name>"`` constant label
injected into each sample — one Prometheus target instead of N, and the
label makes per-replica breakdowns a query-time ``by (replica)`` rather
than a scrape-config chore.

Two invariants the design is built around:

* **Never a scrape hang on the request path.**  ``MetricsFederator``
  scrapes on its own daemon thread at ``poll_s`` with a bounded
  per-replica timeout; ``render()`` only reads the cache.  A replica
  dying mid-scrape costs the poller one timeout, never a client request.
* **Stale is visible, not silent.**  Each replica contributes
  ``fleet_federation_up{replica=…}`` (1 scraped fresh, 0 down/stale) and
  ``fleet_federation_scrape_age_seconds{replica=…}``; a down replica's
  last-good series stay exposed (marked stale via those gauges) until
  ``stale_after_s`` ages them out entirely — matching how federation
  consumers reason about absent-vs-zero.

Because re-labelling is generic, NEW series federate with zero code
here: the round-24 quality families (``serve_confidence{tier=,model=}``
histograms with exemplars, ``serve_quality_good/bad_total``,
``serve_cascade_*_total``, ``serve_slo_burn_rate{dimension="quality"}``)
appear in ``/metrics/fleet`` with their ``replica=`` label the moment a
replica starts exposing them — scripts/quality_smoke.py pins exactly
that.

Re-labelling is a text transform on the exposition format, not a parse
into a metric model: each sample line gets ``replica="…"`` spliced into
its labelset (respecting quotes/escapes — label VALUES may contain
``{``/``}``/``,``), and ``# HELP``/``# TYPE`` headers are emitted once
per family across all replicas (first writer wins; Prometheus rejects
duplicate headers).  Replica names are escaped with the registry's own
``escape_label_value`` so arbitrary names round-trip.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Dict, List, Optional, Tuple

from raft_stereo_tpu_torch.telemetry.registry import escape_label_value

log = logging.getLogger(__name__)


def inject_label(sample_line: str, label: str, value: str) -> str:
    """Splice ``label="value"`` into one exposition sample line.

    ``metric{a="b"} 1`` → ``metric{replica="r0",a="b"} 1`` and
    ``metric 1`` → ``metric{replica="r0"} 1``.  The existing-labelset
    case walks the line quote-aware: a bare ``{`` inside a quoted label
    value (legal in the format) must not be mistaken for the labelset
    opener — only the first unquoted ``{`` is."""
    escaped = escape_label_value(value)
    in_quote = False
    backslash = False
    for i, ch in enumerate(sample_line):
        if backslash:
            backslash = False
            continue
        if ch == "\\":
            backslash = True
            continue
        if ch == '"':
            in_quote = not in_quote
            continue
        if in_quote:
            continue
        if ch == "{":
            rest = sample_line[i + 1:]
            comma = "" if rest.lstrip().startswith("}") else ","
            return (f'{sample_line[:i]}{{{label}="{escaped}"{comma}'
                    f'{rest}')
        if ch in (" ", "\t"):
            # No labelset on this sample — open one before the value.
            return (f'{sample_line[:i]}{{{label}="{escaped}"}}'
                    f'{sample_line[i:]}')
    return f'{sample_line}{{{label}="{escaped}"}}'


def relabel_exposition(text: str, label: str, value: str,
                       seen_families: Dict[str, str]) -> List[str]:
    """Re-emit one replica's exposition text with ``label="value"``
    injected into every sample.  ``seen_families`` (family name → owner)
    dedups ``# HELP``/``# TYPE`` headers across replicas — the first
    replica to expose a family owns its header; later replicas' copies
    of the SAME family drop theirs (the merge the federation contract
    requires: duplicate names across replicas appear under one header,
    distinguishable only by the ``replica=`` label)."""
    out: List[str] = []
    for line in text.splitlines():
        if not line.strip():
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) >= 3 and parts[1] in ("HELP", "TYPE"):
                key = f"{parts[1]}:{parts[2]}"
                if key in seen_families:
                    continue
                seen_families[key] = value
            out.append(line)
            continue
        out.append(inject_label(line, label, value))
    return out


class MetricsFederator:
    """Background scraper + cache + renderer behind ``/metrics/fleet``.

    ``replicas_fn`` returns the current scrape set as ``(name, replica)``
    pairs (the router passes its in-rotation view); each poll pass
    scrapes every member with ``timeout_s`` bound and stores
    ``(text, monotonic_ts, ok)`` per name.  ``render()`` is pure cache —
    called on the router's HTTP request path, it never touches the
    network."""

    def __init__(self, replicas_fn, poll_s: float = 5.0,
                 timeout_s: float = 2.0, stale_after_s: float = 60.0,
                 clock=time.monotonic):
        if poll_s <= 0 or timeout_s <= 0:
            raise ValueError("federation poll_s and timeout_s must be "
                             "positive")
        self._replicas_fn = replicas_fn
        self.poll_s = float(poll_s)
        self.timeout_s = float(timeout_s)
        self.stale_after_s = float(stale_after_s)
        self._clock = clock
        self._lock = threading.Lock()
        # name -> (exposition_text, scraped_at, fresh)
        self._cache: Dict[str, Tuple[str, float, bool]] = {}
        self.scrapes_ok = 0
        self.scrapes_failed = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ---------------------------------------------------------------- lifecycle
    def start(self) -> "MetricsFederator":
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="metrics-federator")
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.timeout_s + self.poll_s)
            self._thread = None

    def _run(self):
        while not self._stop.wait(self.poll_s):
            try:
                self.scrape_once()
            except Exception:  # pragma: no cover — poller must not die
                log.exception("federation scrape pass failed")

    # ------------------------------------------------------------------ scrape
    def scrape_once(self) -> Dict[str, bool]:
        """One bounded scrape pass over the current replica set; returns
        ``{name: ok}``.  Tests drive this directly for determinism; the
        daemon thread calls it on the poll cadence.  A replica that dies
        mid-scrape costs ONE ``timeout_s`` here and flips its cache
        entry to stale — nothing on the request path waits."""
        results: Dict[str, bool] = {}
        members = list(self._replicas_fn())
        for name, rep in members:
            try:
                text = rep.get_metrics(self.timeout_s)
            except Exception as e:
                results[name] = False
                with self._lock:
                    self.scrapes_failed += 1
                    prior = self._cache.get(name)
                    if prior is not None:
                        # Keep last-good text, mark stale.
                        self._cache[name] = (prior[0], prior[1], False)
                log.debug("federation scrape of %r failed: %s", name, e)
                continue
            results[name] = True
            with self._lock:
                self.scrapes_ok += 1
                self._cache[name] = (text, self._clock(), True)
        # Members that left the replica set keep their cache entry until
        # stale_after_s ages it out in render() — same absent-vs-down
        # story as a dead replica.
        return results

    # ------------------------------------------------------------------ render
    def render(self, own_text: str = "") -> str:
        """The federated exposition: router's own series first (no extra
        label — the router IS this scrape target), then every cached
        replica's series with ``replica=`` injected, plus the
        per-replica up/staleness meta-gauges.  Cache-only: safe on the
        request path."""
        now = self._clock()
        with self._lock:
            cache = dict(self._cache)
        out: List[str] = []
        seen_families: Dict[str, str] = {}
        if own_text:
            for line in own_text.splitlines():
                if not line.strip():
                    continue
                if line.startswith("#"):
                    parts = line.split(None, 3)
                    if len(parts) >= 3 and parts[1] in ("HELP", "TYPE"):
                        seen_families[f"{parts[1]}:{parts[2]}"] = ""
                out.append(line)
        out.append("# HELP fleet_federation_up Whether the last scrape "
                   "of this replica succeeded (0 = down or stale).")
        out.append("# TYPE fleet_federation_up gauge")
        up_lines: List[str] = []
        age_lines: List[str] = []
        body_lines: List[str] = []
        for name in sorted(cache):
            text, scraped_at, fresh = cache[name]
            age = max(0.0, now - scraped_at)
            escaped = escape_label_value(name)
            if age > self.stale_after_s:
                # Aged out entirely: the series vanish, only the down
                # marker remains.
                up_lines.append(f'fleet_federation_up{{replica='
                                f'"{escaped}"}} 0')
                age_lines.append(f'fleet_federation_scrape_age_seconds'
                                 f'{{replica="{escaped}"}} {age:.3f}')
                continue
            up_lines.append(f'fleet_federation_up{{replica="{escaped}"}}'
                            f' {1 if fresh else 0}')
            age_lines.append(f'fleet_federation_scrape_age_seconds'
                             f'{{replica="{escaped}"}} {age:.3f}')
            body_lines.extend(relabel_exposition(text, "replica", name,
                                                 seen_families))
        out.extend(up_lines)
        out.append("# HELP fleet_federation_scrape_age_seconds Seconds "
                   "since this replica's series were last refreshed.")
        out.append("# TYPE fleet_federation_scrape_age_seconds gauge")
        out.extend(age_lines)
        out.extend(body_lines)
        return "\n".join(out) + "\n"

    def status(self) -> Dict[str, object]:
        now = self._clock()
        with self._lock:
            return {
                "poll_s": self.poll_s, "timeout_s": self.timeout_s,
                "stale_after_s": self.stale_after_s,
                "scrapes_ok": self.scrapes_ok,
                "scrapes_failed": self.scrapes_failed,
                "replicas": {
                    name: {"fresh": fresh,
                           "age_s": round(max(0.0, now - ts), 3)}
                    for name, (_, ts, fresh) in self._cache.items()},
            }
