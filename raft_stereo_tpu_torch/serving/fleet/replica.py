"""One fleet member as the router sees it: an HTTP client plus the
health/readiness state the routing decisions read.

The router never shares application state with a replica — the ONLY
coupling is the replica's public HTTP surface (serving/http.py):
``/healthz`` (liveness + load signals: queue depth/limit, inflight,
brownout level), ``/readyz`` (the warm-ladder gate), the ``/v1/*``
request routes forwarded verbatim, and ``POST /admin/brownout`` (the
fleet-wide degradation floor).  That keeps a replica process free to
crash, restart, or be replaced by anything that speaks the same
protocol.

Transport failures (connection refused, reset, timeout, a blackholed
health check that never answers) raise ``ReplicaUnreachable``; the
router converts those into failover decisions.  HTTP-level error
responses are NOT failures at this layer — a 429 or a typed 410 is a
replica ANSWERING, and the router forwards it byte-for-byte.
"""

from __future__ import annotations

import dataclasses
import http.client
import json
import socket
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple
from urllib.parse import quote, urlparse

# EWMA smoothing for probe round-trip latency: ~0.3 weights the last
# probe enough to track a degrading replica within a few health passes
# without one GC pause dominating the estimate.
_PROBE_EWMA_ALPHA = 0.3


class ReplicaUnreachable(ConnectionError):
    """Transport-level failure talking to one replica (refused / reset /
    timeout / torn response).  The router's failover trigger."""

    def __init__(self, name: str, detail: str):
        super().__init__(f"replica {name!r} unreachable: {detail}")
        self.name = name


@dataclasses.dataclass
class ReplicaHealth:
    """One successful health probe, parsed: what the routing decisions
    read.  ``ready`` is the /readyz verdict (warm ladder captured, not
    draining); the load fields come from /healthz."""

    ready: bool
    draining: bool = False
    queue_depth: int = 0
    queue_limit: int = 0
    inflight: int = 0
    brownout_level: int = 0
    sessions_active: Optional[int] = None
    # XL topology (round 17 /healthz "xl" field): None when this replica
    # serves without the mesh tier — the router's xl-capability routing
    # (round 18) keys off this.
    xl: Optional[Dict] = None
    # Running totals the autoscaler differences into rates.
    admitted: int = 0
    deadline_missed: int = 0

    @property
    def xl_capable(self) -> bool:
        return self.xl is not None

    @property
    def queue_fraction(self) -> float:
        """Queue pressure in [0, 1] — the fleet brownout signal."""
        if self.queue_limit <= 0:
            return 0.0
        return min(1.0, self.queue_depth / self.queue_limit)

    @property
    def load(self) -> Tuple[int, int]:
        """Least-loaded-first sort key for stateless routing: queued
        work first (it is what a new request waits behind), then
        inflight."""
        return (self.queue_depth, self.inflight)


# Hop-by-hop headers never forwarded in either direction (RFC 9110
# §7.6.1) plus the ones the transport layer recomputes itself.
_HOP_HEADERS = frozenset({
    "connection", "keep-alive", "proxy-authenticate",
    "proxy-authorization", "te", "trailer", "transfer-encoding",
    "upgrade", "host", "content-length"})


class Replica:
    """One backend engine process: name, base URL, an HTTP client, and
    the mutable routing state the FleetRouter maintains under its own
    lock (this class only guards its counters).

    ``alive``/``health`` are the router's last verdicts: ``alive=False``
    means the replica failed ``fail_after`` consecutive probes (or a
    forwarded request hit a transport error) and is out of rotation
    until a probe succeeds again.
    """

    def __init__(self, name: str, url: str):
        self.name = name
        self.url = url.rstrip("/")
        parsed = urlparse(self.url)
        if parsed.scheme not in ("http", ""):
            raise ValueError(f"replica {name!r}: only http:// URLs are "
                             f"supported, got {url!r}")
        self.host = parsed.hostname or "127.0.0.1"
        self.port = parsed.port or 80
        # Routing state, owned by the router (mutated under its lock).
        self.alive = True
        self.health: Optional[ReplicaHealth] = None
        self.consecutive_failures = 0
        # Stamped by the router whenever alive/ready flips — `/fleet`
        # surfaces it so a flapping replica is visible as a recent
        # timestamp, not hidden behind a binary up/down.
        self.last_state_change_ts: Optional[float] = None
        self._lock = threading.Lock()
        self.requests_forwarded = 0
        self.transport_errors = 0
        self.probe_latency_ms: Optional[float] = None

    def __repr__(self) -> str:
        return (f"Replica({self.name!r}, {self.url!r}, alive={self.alive}, "
                f"ready={self.ready})")

    @property
    def ready(self) -> bool:
        """Routable right now: alive and the last probe said ready."""
        return self.alive and self.health is not None and self.health.ready

    # ------------------------------------------------------------- transport
    def _request(self, method: str, path: str, body: Optional[bytes],
                 headers: Dict[str, str], timeout: float
                 ) -> Tuple[int, List[Tuple[str, str]], bytes]:
        conn = http.client.HTTPConnection(self.host, self.port,
                                          timeout=timeout)
        try:
            conn.request(method, path, body=body, headers=headers)
            resp = conn.getresponse()
            payload = resp.read()
            return resp.status, resp.getheaders(), payload
        except (OSError, socket.timeout,
                http.client.HTTPException) as e:
            with self._lock:
                self.transport_errors += 1
            raise ReplicaUnreachable(
                self.name, f"{type(e).__name__}: {e}") from e
        finally:
            conn.close()

    def forward(self, method: str, path_qs: str, body: Optional[bytes],
                headers: Sequence[Tuple[str, str]], timeout: float
                ) -> Tuple[int, List[Tuple[str, str]], bytes]:
        """Forward one client request verbatim; returns ``(status,
        headers, body)`` with hop-by-hop headers stripped on both legs —
        everything else (the typed error bodies, the ``X-*`` provenance
        headers, ``Retry-After``) passes through untouched, which is
        what keeps the router pass-through-equivalent to hitting the
        replica directly (tests/test_fleet.py pins byte equality)."""
        fwd = {k: v for k, v in headers
               if k.lower() not in _HOP_HEADERS}
        status, resp_headers, payload = self._request(
            method, path_qs, body, fwd, timeout)
        with self._lock:
            self.requests_forwarded += 1
        kept = [(k, v) for k, v in resp_headers
                if k.lower() not in _HOP_HEADERS
                and k.lower() not in ("server", "date")]
        return status, kept, payload

    # ----------------------------------------------------------- health pokes
    def probe(self, timeout: float) -> ReplicaHealth:
        """One liveness + readiness probe; raises ``ReplicaUnreachable``
        on any transport failure (including a health-check blackhole —
        a replica that accepts the connection but never answers)."""
        t0 = time.monotonic()
        status_h, _, body_h = self._request("GET", "/healthz", None, {},
                                            timeout)
        if status_h != 200:
            raise ReplicaUnreachable(self.name,
                                     f"/healthz answered {status_h}")
        try:
            h = json.loads(body_h)
        except ValueError as e:
            raise ReplicaUnreachable(
                self.name, f"/healthz body unparseable: {e}") from e
        status_r, _, body_r = self._request("GET", "/readyz", None, {},
                                            timeout)
        rtt_ms = (time.monotonic() - t0) * 1e3
        with self._lock:
            if self.probe_latency_ms is None:
                self.probe_latency_ms = rtt_ms
            else:
                self.probe_latency_ms += _PROBE_EWMA_ALPHA * (
                    rtt_ms - self.probe_latency_ms)
        try:
            r = json.loads(body_r)
        except ValueError:
            r = {}
        if not (status_r == 200 and r.get("ready")) and \
                h.get("status") != "draining":
            # a graceful drain that began between the two requests turns
            # /readyz not-ready after /healthz said "ok": read the status
            # again, or the planned drain would count as a replica that
            # stopped being ready and lose its sessions (the engine flips
            # its queue to draining before its readiness)
            status_h2, _, body_h2 = self._request("GET", "/healthz", None,
                                                  {}, timeout)
            if status_h2 == 200:
                try:
                    h = json.loads(body_h2)
                except ValueError:
                    pass
        return ReplicaHealth(
            ready=(status_r == 200 and bool(r.get("ready", False))
                   and h.get("status") != "draining"),
            draining=h.get("status") == "draining",
            queue_depth=int(h.get("queue_depth") or 0),
            queue_limit=int(h.get("queue_limit") or 0),
            inflight=int(h.get("inflight") or 0),
            brownout_level=int(h.get("brownout_level") or 0),
            sessions_active=h.get("sessions_active"),
            xl=h.get("xl") or None,
            admitted=int(h.get("admitted") or 0),
            deadline_missed=int(h.get("deadline_missed") or 0))

    def get_handoff(self, timeout: float) -> Optional[Dict]:
        """The draining replica's session-handoff manifest (``GET
        /admin/handoff``): the artifact key + session ids the router
        remaps to survivors.  None while the replica has not published
        yet (404 — poll again next pass); raises ``ReplicaUnreachable``
        on transport failure (the replica may already be gone — the
        death path takes over)."""
        status, _, body = self._request("GET", "/admin/handoff", None,
                                        {}, timeout)
        if status != 200:
            return None
        try:
            return json.loads(body)
        except ValueError as e:
            raise ReplicaUnreachable(
                self.name, f"/admin/handoff body unparseable: {e}") from e

    def post_brownout(self, level: int, timeout: float) -> bool:
        """Push the fleet brownout floor; True when the replica applied
        it (False: replica runs without a brownout controller — typed
        409 — or answered any other non-200)."""
        body = json.dumps({"level": int(level)}).encode()
        status, _, _ = self._request(
            "POST", "/admin/brownout", body,
            {"Content-Type": "application/json"}, timeout)
        return status == 200

    # -------------------------------------------------- observability fetches
    def get_metrics(self, timeout: float) -> str:
        """This replica's ``GET /metrics`` Prometheus text, verbatim —
        the federation poller's scrape unit."""
        status, _, body = self._request("GET", "/metrics", None, {},
                                        timeout)
        if status != 200:
            raise ReplicaUnreachable(self.name,
                                     f"/metrics answered {status}")
        return body.decode("utf-8", errors="replace")

    def get_spans(self, trace_id: str, timeout: float) -> List[Dict]:
        """One trace's span records from this replica's ring
        (``GET /debug/spans?trace=<id>``) — the federated trace view's
        per-replica half.  Empty list when the replica has no spans for
        that id (or span tracing is off: typed 404)."""
        status, _, body = self._request(
            "GET", f"/debug/spans?trace={quote(trace_id)}", None, {},
            timeout)
        if status != 200:
            return []
        try:
            doc = json.loads(body)
        except ValueError:
            return []
        spans = doc.get("spans") if isinstance(doc, dict) else None
        return spans if isinstance(spans, list) else []

    def post_flightrecorder(self, timeout: float) -> Optional[Dict]:
        """Force a flight-recorder bundle dump on this replica (``POST
        /debug/flightrecorder``) — the coordinated fleet dump's fan-out
        leg.  Returns the replica's bundle record, or None when the
        replica runs without a recorder (typed 404)."""
        status, _, body = self._request("POST", "/debug/flightrecorder",
                                        None, {}, timeout)
        if status != 200:
            return None
        try:
            doc = json.loads(body)
        except ValueError:
            return None
        return doc if isinstance(doc, dict) else None

    def stats(self) -> Dict[str, object]:
        with self._lock:
            forwarded = self.requests_forwarded
            errors = self.transport_errors
            probe_ms = self.probe_latency_ms
        h = self.health
        return {
            "name": self.name, "url": self.url, "alive": self.alive,
            "ready": self.ready,
            "consecutive_failures": self.consecutive_failures,
            "probe_latency_ms": (round(probe_ms, 3)
                                 if probe_ms is not None else None),
            "last_state_change_ts": self.last_state_change_ts,
            "requests_forwarded": forwarded,
            "transport_errors": errors,
            "queue_depth": h.queue_depth if h else None,
            "brownout_level": h.brownout_level if h else None,
            "sessions_active": h.sessions_active if h else None,
        }
