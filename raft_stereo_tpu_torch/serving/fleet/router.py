"""The fleet router: N replica engines behind one front door.

One serving process is now crash-safe *internally* (round 13: supervised
recovery, breakers, brownout) — but the process itself is still a single
fault domain: a kill takes every in-flight request, every streaming
session, and a compile storm with it.  This module makes the REPLICA the
unit of failure:

* **Routing.**  Stateless ``/v1/disparity`` requests go to the
  least-loaded ready replica (queue depth, then inflight, from the last
  health probe; round-robin among equals).  Streaming ``/v1/stream/<id>``
  requests are STICKY: the session id consistent-hashes onto the ring of
  in-rotation replicas (fleet/ring.py), so every frame of one session
  lands on the engine holding its warm-start state, and replica loss
  remaps only ~1/N of the id space — the sessions that died with it.
* **Failover.**  A transport failure (connection refused/reset/timeout)
  on a forwarded request or ``fail_after`` consecutive health-probe
  failures takes the replica out of rotation immediately.  Stateless
  requests retry on the next replica — a disparity request is a pure
  function of its inputs, so the retry is safe and the client never sees
  the death.  The lost replica's sessions CANNOT fail over (their state
  is gone): each one fails typed with ``SessionLost`` (HTTP 410
  ``session_lost``) exactly once, then the id is forgotten so the
  client's reseed — its next frame, cold — routes to a surviving replica
  and starts a fresh chain.  The r14 tombstone contract, fleet-wide: a
  broken stream is always announced, never silently restarted.
* **Fleet brownout.**  Sustained aggregate queue pressure across the
  ready replicas raises one fleet-wide degradation level (hysteresis as
  in serving/resilience.py) and pushes it to every replica's
  ``POST /admin/brownout`` floor — the whole fleet degrades in lockstep
  instead of each replica flapping on its own local signal.
* **Recovery.**  A probe succeeding on a dead replica puts it back in
  rotation (and re-pushes the current brownout floor).  With the shared
  executable artifact store (serving/persist.py) a replacement replica
  boots warm — its ``nvcc`` kernel libraries are fetched, not built — so
  rejoin cost is a fetch and the CUDA graph captures, not a build storm.

Round 18 turns "the fleet survives faults" into "the fleet can be
OPERATED" (docs/architecture.md §Fleet):

* **Session handoff on graceful drain.**  A replica reporting
  ``draining`` is pulled from rotation WITHOUT typing its sessions lost:
  the router polls its ``GET /admin/handoff`` manifest (the draining
  engine published its live streams into the artifact store's
  ``sessions/`` namespace), remaps those ids, and tags each one's next
  frame with ``X-Handoff-Artifact`` so the inheriting replica imports
  the warm state lazily — a planned restart costs zero 410s and the
  first post-drain frame still dispatches warm.  A kill -9 keeps the
  r16 typed-loss path: handoff is for PLANNED drains only.
* **HA pair.**  Two routers share the deterministic ring by
  construction plus a fenced, replicated lost-session/handoff ledger
  (fleet/ledger.py) in the artifact store.  The primary holds a lease
  and appends ``lost``/``fired``/``handoff`` records; the standby
  serves traffic the whole time (stateless + ring-sticky sessions need
  no shared state) and takes over — bump the fencing epoch, replay the
  ledger — when the lease goes stale or the peer stops answering.  A
  loss is never un-typed and never double-fired for one id; a stale
  primary's appends are rejected.
* **Dynamic membership + pressure export.**  ``add_replica`` /
  ``remove_replica`` and ``fleet_pressure()`` are the seams the
  autoscaler (fleet/autoscaler.py) drives: scale-up registers a fresh
  replica (it joins rotation when its probes go ready), scale-down
  always DRAINS through the handoff path, never kills.
* **XL-capability routing.**  ``?tier=xl`` requests route only to
  replicas whose /healthz advertises the mesh tier; a fleet with none
  in rotation answers the typed 503 ``xl_unavailable`` with the
  capable-replica count instead of bouncing the request off a replica
  that will 400 it.  A port replica advertises the tier where it runs
  one (``--xl_mesh`` and devices enough for the mesh); its /healthz
  ``xl`` is null otherwise.

Pass-through contract: with every replica healthy the router adds no
behavior — request and response bytes are forwarded verbatim (hop-by-hop
headers aside), so a one-replica fleet is byte-identical to hitting the
engine directly (the bitwise solo-parity chain now extends client ->
router -> replica -> engine -> solo).
"""

from __future__ import annotations

import dataclasses
import http.client
import json
import logging
import os
import threading
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple
from urllib.parse import parse_qs, urlparse

from raft_stereo_tpu_torch.serving.fleet.federation import MetricsFederator
from raft_stereo_tpu_torch.serving.fleet.ledger import FleetLedger
from raft_stereo_tpu_torch.serving.fleet.replica import (Replica, ReplicaHealth,
                                                   ReplicaUnreachable)
from raft_stereo_tpu_torch.serving.fleet.ring import DEFAULT_VNODES, HashRing
from raft_stereo_tpu_torch.serving.fleet.rollout import (RolloutConfig,
                                                   RolloutPolicy)
from raft_stereo_tpu_torch.telemetry.flight_recorder import FlightRecorder
from raft_stereo_tpu_torch.telemetry.registry import MetricsRegistry
from raft_stereo_tpu_torch.telemetry.slo import BurnRateTracker, SloWatchdog
from raft_stereo_tpu_torch.telemetry.spans import (TRACE_CONTEXT_HEADER,
                                             SpanTracer, Trace,
                                             encode_traceparent)
from raft_stereo_tpu_torch.telemetry.watchdog import AnomalySink

log = logging.getLogger(__name__)


class NoReplicasAvailable(RuntimeError):
    """No ready replica can take this request right now (the fleet's
    503: every member is dead, warming, or draining)."""


class XlUnavailable(NoReplicasAvailable):
    """Typed xl-capability failure (HTTP 503 ``xl_unavailable``): the
    request asked for the mesh-sharded xl tier but no replica currently
    in rotation advertises one.  ``capable_ready`` counts xl replicas
    in rotation (0 here by definition), ``capable_total`` counts
    configured replicas whose last probe advertised the tier."""

    def __init__(self, capable_ready: int, capable_total: int,
                 fleet_size: int):
        super().__init__(
            f"no xl-capable replica in rotation ({capable_ready} ready, "
            f"{capable_total} capable of {fleet_size} configured)")
        self.capable_ready = capable_ready
        self.capable_total = capable_total
        self.fleet_size = fleet_size


class SessionLost(KeyError):
    """Typed fleet-level dead-session failure (HTTP 410
    ``session_lost``): the replica holding this session's warm-start
    state left the rotation, so the chain is unrecoverable.  Fired once
    per session; the client's next frame reseeds cold on a surviving
    replica."""

    def __init__(self, session_id: str, replica: str):
        super().__init__(
            f"session {session_id!r} lost with replica {replica!r}; "
            f"reseed on the next frame (it will cold-start)")
        self.session_id = session_id
        self.replica = replica


@dataclasses.dataclass(frozen=True)
class RouterConfig:
    """Fleet-router knobs (cli/route.py maps flags here)."""

    health_poll_s: float = 0.25      # probe cadence per replica
    health_timeout_s: float = 1.0    # per-probe transport timeout
    # Consecutive failed PROBES before a replica is declared dead.  A
    # transport failure on real forwarded traffic kills it immediately
    # (stronger signal — a request already burned on it).
    fail_after: int = 2
    request_timeout_s: float = 600.0  # forwarded-request timeout (covers
    #                                   a first-request compile on a
    #                                   replica without prewarm)
    # Total stateless dispatch attempts across distinct replicas before
    # the router gives up with NoReplicasAvailable.
    route_retries: int = 3
    vnodes: int = DEFAULT_VNODES
    # Fleet-wide brownout: aggregate queued fraction (sum of ready
    # replicas' queue depths / sum of their limits) above the engage
    # watermark for engage_s raises the fleet level one rung; below the
    # restore watermark for restore_s lowers it.  Same hysteresis shape
    # as the per-engine BrownoutController, driven by the fleet signal.
    fleet_brownout: bool = True
    brownout_engage_fraction: float = 0.75
    brownout_engage_s: float = 0.5
    brownout_restore_fraction: float = 0.25
    brownout_restore_s: float = 2.0
    brownout_max_level: int = 2
    # Lost-session bookkeeping bound: ids older than this are forgotten
    # even if the client never came back for its 410.
    session_lost_ttl_s: float = 60.0
    # Capacity cap on the lost-session AND handoff ledgers (the
    # SessionStore tombstone move, fleet-wide): a long-lived router
    # under session churn forgets the OLDEST owed 410s/handoffs past
    # this many, bounding memory; fleet_lost_ledger_size tracks it.
    session_lost_cap: int = 4096
    # Bounded wait for a draining replica's /admin/handoff manifest
    # when one of its sessions' frames arrives before the manifest was
    # fetched (the export runs at SIGTERM, so this is one export +
    # one store write away).
    handoff_fetch_timeout_s: float = 3.0
    # ---- HA pair (fleet/ledger.py) ------------------------------------
    # Shared ledger directory (inside the artifact store, e.g.
    # <store>/fleet).  None: single-router mode, no ledger, everything
    # below ignored.
    ha_dir: Optional[str] = None
    router_name: str = "router"
    # True: start PASSIVE — serve traffic (stateless + ring-sticky
    # sessions need no shared state) but hold no lease and append no
    # ledger records until the primary's lease goes stale (or the peer
    # stops answering) and this router takes over.
    standby: bool = False
    # Lease renewal happens every health poll; the standby takes over
    # once the lease has not been renewed for this long.
    lease_ttl_s: float = 3.0
    # Optional peer URL (the primary, from the standby's side): probing
    # it detects a kill -9 faster than lease staleness alone.
    peer_url: Optional[str] = None
    peer_fail_after: int = 2
    # ---- fleet observability (round 23) -------------------------------
    # Router-side span sampling.  0.0 (default) keeps the pass-through
    # contract BIT-EXACT: no route.request trace, no traceparent header
    # injected, request and response bytes forwarded verbatim.
    trace_sample_rate: float = 0.0
    # SLO objectives (GET /metrics/fleet burn-rate gauges).  slo_ms:
    # router-observed forward latency above this counts as an SLO error
    # (None: latency does not burn budget); slo_availability is the
    # objective the burn rate is measured against.
    slo_ms: Optional[float] = None
    slo_availability: float = 0.999
    # Multi-window burn thresholds the SloWatchdog pages on (fast=first
    # window, slow=last): both must breach simultaneously.
    slo_fast_burn: float = 14.4
    slo_slow_burn: float = 6.0
    # Metrics federation poller (GET /metrics/fleet): background scrape
    # cadence, per-replica scrape timeout, and how long a dead replica's
    # last-good series stay exposed (stale-marked) before vanishing.
    federation_poll_s: float = 5.0
    federation_timeout_s: float = 2.0
    federation_stale_s: float = 60.0
    # Router-side flight-recorder bundles + the coordinated fleet dump
    # manifests land here.  None: no recorder, SLO breaches still fire
    # anomaly events but capture nothing.
    flight_recorder_dir: Optional[str] = None

    def __post_init__(self):
        if self.fail_after < 1:
            raise ValueError(f"fail_after={self.fail_after} must be >= 1")
        if self.route_retries < 1:
            raise ValueError(
                f"route_retries={self.route_retries} must be >= 1")
        if not (0 < self.brownout_restore_fraction
                <= self.brownout_engage_fraction <= 1):
            raise ValueError(
                f"need 0 < brownout_restore_fraction "
                f"({self.brownout_restore_fraction}) <= "
                f"brownout_engage_fraction "
                f"({self.brownout_engage_fraction}) <= 1")
        if self.session_lost_cap < 1:
            raise ValueError(f"session_lost_cap={self.session_lost_cap} "
                             f"must be >= 1")
        if self.standby and self.ha_dir is None:
            raise ValueError("standby=True needs ha_dir (the shared "
                             "lease/ledger directory to watch)")
        if self.lease_ttl_s <= 0:
            raise ValueError(f"lease_ttl_s={self.lease_ttl_s} must be "
                             f"> 0")
        if not 0.0 <= self.trace_sample_rate <= 1.0:
            raise ValueError(f"trace_sample_rate="
                             f"{self.trace_sample_rate} must be in "
                             f"[0, 1]")
        if not 0.0 < self.slo_availability < 1.0:
            raise ValueError(f"slo_availability="
                             f"{self.slo_availability} must be in "
                             f"(0, 1)")
        if self.slo_ms is not None and self.slo_ms <= 0:
            raise ValueError(f"slo_ms={self.slo_ms} must be > 0")


class FleetRouter:
    """Routing brain over a set of ``Replica`` clients.

    ``replicas`` maps name -> base URL.  ``start()`` runs one synchronous
    probe pass (so routing works immediately) and then the background
    health loop; ``stop()`` joins it.  All routing state (ring
    membership, session table, lost set, brownout level) is guarded by
    one lock — routing decisions are cheap; the forwarding I/O happens
    outside it.
    """

    def __init__(self, replicas: Dict[str, str],
                 cfg: RouterConfig = RouterConfig(),
                 registry: Optional[MetricsRegistry] = None,
                 rollout_cfg: Optional[RolloutConfig] = None,
                 clock=time.monotonic):
        if not replicas:
            raise ValueError("a fleet needs at least one replica")
        self.cfg = cfg
        self._clock = clock
        self.replicas: Dict[str, Replica] = {
            name: Replica(name, url) for name, url in replicas.items()}
        self._lock = threading.Lock()
        # Ring membership == replicas currently IN ROTATION (alive and
        # ready).  Sessions route over this ring only.
        self.ring = HashRing(vnodes=cfg.vnodes)
        # sid -> replica name, for every session the router has routed;
        # the blast-radius ledger a replica death consults.
        self._session_table: Dict[str, str] = {}
        # sid -> (replica, t_lost): sessions owed one typed 410.
        self._lost: "OrderedDict[str, Tuple[str, float]]" = OrderedDict()
        # sid -> (artifact_key, t): sessions a draining replica handed
        # off — their next frame is tagged X-Handoff-Artifact so the
        # inheriting replica imports the warm state (round 18).
        self._handoff: "OrderedDict[str, Tuple[str, float]]" = (
            OrderedDict())
        # name -> Replica currently draining whose handoff manifest has
        # not been fetched yet (polled every probe pass, and inline —
        # bounded — when one of their sessions' frames arrives first).
        self._drain_pending: Dict[str, Replica] = {}
        self._rr = 0                       # round-robin tiebreak
        self._transitions: List[Dict[str, object]] = []   # audit trail
        # Fleet brownout state.
        self.brownout_level = 0
        self._pressure_since: Optional[float] = None
        self._calm_since: Optional[float] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # ---- metrics ----------------------------------------------------
        r = registry or MetricsRegistry()
        self.registry = r
        self.replicas_ready = r.gauge(
            "fleet_replicas_ready",
            "replicas currently in rotation (alive and ready)")
        self.replicas_total = r.gauge(
            "fleet_replicas_total", "replicas configured in the fleet")
        self.replicas_total.set(len(self.replicas))
        self.failovers = r.counter(
            "fleet_failovers_total",
            "replicas removed from rotation after transport failures "
            "(health probes or forwarded traffic)")
        self.sessions_lost = r.counter(
            "fleet_sessions_lost_total",
            "streaming sessions failed typed (410 session_lost) because "
            "their replica left the rotation")
        self.route_retries = r.counter(
            "fleet_route_retries_total",
            "stateless requests re-dispatched to another replica after "
            "a transport failure (the zero-loss failover path)")
        self.unroutable = r.counter(
            "fleet_requests_unroutable_total",
            "requests failed with no_replicas_ready (every fleet member "
            "dead, warming, or draining)")
        self.brownout_gauge = r.gauge(
            "fleet_brownout_level",
            "fleet-wide brownout degradation level pushed to every "
            "replica's /admin/brownout floor (0 = off)")
        self.brownout_pushes = r.counter(
            "fleet_brownout_pushes_total",
            "brownout floor updates pushed to replicas")
        self.lost_ledger_size = r.gauge(
            "fleet_lost_ledger_size",
            "sessions currently owed a typed 410 in the router's "
            "lost-session ledger (TTL + capacity bounded)")
        self.handoff_sessions = r.counter(
            "fleet_handoff_sessions_total",
            "sessions remapped to survivors through a draining "
            "replica's handoff manifest (zero-loss planned restarts)")
        self.handoff_manifests = r.counter(
            "fleet_handoff_manifests_total",
            "drain handoff manifests fetched and applied")
        self.xl_unroutable = r.counter(
            "fleet_xl_unroutable_total",
            "xl-tier requests failed typed (503 xl_unavailable) with "
            "no xl-capable replica in rotation")
        self.active_gauge = r.gauge(
            "fleet_router_active",
            "1 when this router holds the HA lease (or runs without an "
            "HA pair), 0 for a passive standby")
        self.takeovers = r.counter(
            "fleet_router_takeovers_total",
            "standby takeovers: lease acquired + ledger replayed after "
            "the primary went stale/unreachable")
        # ---- HA pair state (fleet/ledger.py) --------------------------
        self.ledger: Optional[FleetLedger] = None
        self.active = True
        self._peer_failures = 0
        self._last_compact = 0.0
        if cfg.ha_dir:
            self.ledger = FleetLedger(cfg.ha_dir, cfg.router_name,
                                      clock=time.time)
            self.active = not cfg.standby
            if self.active:
                self.ledger.acquire()
                self._replay_ledger()
        self.active_gauge.set(1 if self.active else 0)
        # Canary/shadow rollout policy (fleet/rollout.py): always
        # present, disarmed by default — a disarmed policy makes zero
        # routing decisions, so the pass-through contract holds until
        # an operator arms it (--canary / POST /admin/rollout).
        self.rollout = RolloutPolicy(rollout_cfg or RolloutConfig(),
                                     registry=r, clock=clock)
        self._routed_lock = threading.Lock()
        self._routed_by_kind: Dict[str, object] = {}
        self._per_replica_lock = threading.Lock()
        self._routed_by_replica: Dict[str, object] = {}
        # ---- fleet observability (round 23) ---------------------------
        # Router-side spans: at the default sample rate 0 start_trace
        # returns None in constant time and every span call below is a
        # no-op — the pass-through contract stays bit-exact.
        self.tracer = SpanTracer(sample_rate=cfg.trace_sample_rate)
        self.recorder: Optional[FlightRecorder] = None
        if cfg.flight_recorder_dir:
            self.recorder = FlightRecorder(cfg.flight_recorder_dir,
                                           tracer=self.tracer,
                                           registry=r)
        # Typed fleet-level failures the replicas never see (503
        # no_replicas_ready / xl_unavailable, 410 session_lost) — these
        # MUST burn SLO budget too, or the burn rate only measures
        # replica-side badness and a dead fleet looks healthy.
        self.slo_errors = r.counter(
            "fleet_slo_errors_total",
            "router-typed request failures counted against the SLO "
            "error budget (no_replicas_ready, xl_unavailable, "
            "session_lost)")
        self.slo_slow = r.counter(
            "fleet_slo_slow_total",
            "forwarded requests whose router-observed latency exceeded "
            "the --slo_ms objective (counted against the error budget)")
        self.anomalies = r.counter(
            "fleet_anomalies_total",
            "fleet-level anomalies fired (SLO burn-rate breaches)")
        self.slo = BurnRateTracker(availability=cfg.slo_availability,
                                   latency_ms=cfg.slo_ms, registry=r,
                                   clock=clock)
        self._sink = AnomalySink(recorder=self.recorder,
                                 counter=self.anomalies)
        self.slo_watchdog = SloWatchdog(self.slo, self._sink,
                                        fast_burn=cfg.slo_fast_burn,
                                        slow_burn=cfg.slo_slow_burn,
                                        dump_fn=self.coordinated_dump)
        self.fleet_dumps: List[Dict[str, object]] = []
        self.federator = MetricsFederator(
            self._federation_members, poll_s=cfg.federation_poll_s,
            timeout_s=cfg.federation_timeout_s,
            stale_after_s=cfg.federation_stale_s)

    def _federation_members(self) -> List[Tuple[str, Replica]]:
        """The federation poller's scrape set: every ALIVE replica —
        in-rotation plus draining ones (their last metrics are exactly
        what a post-incident look wants); dead replicas age out of the
        cache instead of burning a scrape timeout every pass."""
        with self._lock:
            return [(name, rep) for name, rep in self.replicas.items()
                    if rep.alive]

    # ---------------------------------------------------------------- metrics
    def _note_routed(self, kind: str, replica: str) -> None:
        with self._routed_lock:
            c = self._routed_by_kind.get(kind)
            if c is None:
                c = self.registry.counter(
                    "fleet_requests_routed_total",
                    "requests routed to a replica, by routing kind",
                    labels={"kind": kind})
                self._routed_by_kind[kind] = c
        c.inc()
        with self._per_replica_lock:
            c = self._routed_by_replica.get(replica)
            if c is None:
                c = self.registry.counter(
                    "fleet_replica_routed_total",
                    "requests routed per replica",
                    labels={"replica": replica})
                self._routed_by_replica[replica] = c
        c.inc()

    def routed(self, kind: str) -> int:
        with self._routed_lock:
            c = self._routed_by_kind.get(kind)
        return 0 if c is None else c.value

    # ----------------------------------------------------------- health loop
    def start(self) -> "FleetRouter":
        self.check_replicas()        # synchronous first pass: routable now
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="fleet-health")
        self._thread.start()
        self.federator.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.cfg.health_poll_s):
            try:
                self.check_replicas()
            except Exception:  # pragma: no cover — loop must not die
                log.exception("fleet health poll failed")
            try:
                self._ha_tick()
            except Exception:  # pragma: no cover — loop must not die
                log.exception("fleet HA tick failed")
            try:
                # Hysteresis dwell: a sustained regression verdict must
                # demote even when no new evidence arrives to trigger
                # the inline poll.
                self.rollout.poll()
            except Exception:  # pragma: no cover — loop must not die
                log.exception("rollout poll failed")
            try:
                self.slo_tick()
            except Exception:  # pragma: no cover — loop must not die
                log.exception("SLO tick failed")

    def stop(self) -> None:
        self._stop.set()
        self.federator.stop()
        if self._thread is not None:
            self._thread.join(timeout=5.0)

    def check_replicas(self) -> None:
        """One probe pass over every replica (public: tests and the
        smoke call it directly for deterministic stepping).  Probes run
        OUTSIDE the lock; state transitions apply under it."""
        with self._lock:
            members = list(self.replicas.items())   # autoscaler mutates
        results: Dict[str, Optional[ReplicaHealth]] = {}
        for name, rep in members:
            try:
                results[name] = rep.probe(self.cfg.health_timeout_s)
            except ReplicaUnreachable:
                results[name] = None
        with self._lock:
            for name, health in results.items():
                rep = self.replicas.get(name)
                if rep is None:         # removed mid-pass (autoscaler)
                    continue
                if health is None:
                    rep.consecutive_failures += 1
                    if (rep.alive
                            and rep.consecutive_failures
                            >= self.cfg.fail_after):
                        self._remove_from_rotation_locked(
                            rep, "health_probe_failures")
                    continue
                rep.consecutive_failures = 0
                rep.health = health
                was_dead = not rep.alive
                rep.alive = True
                in_ring = rep.name in self.ring
                if health.ready and not in_ring:
                    self.ring.add(rep.name)
                    self._drain_pending.pop(rep.name, None)
                    rep.last_state_change_ts = time.time()
                    self._transitions.append({
                        "t": self._clock(), "replica": rep.name,
                        "event": ("rejoined" if was_dead else "ready")})
                    log.info("replica %s in rotation (%d/%d ready)",
                             rep.name, len(self.ring),
                             len(self.replicas))
                    if self.brownout_level > 0:
                        self._push_brownout_locked((rep,))
                elif not health.ready and in_ring:
                    if health.draining:
                        # Planned drain (round 18): out of rotation but
                        # its sessions are NOT lost — the handoff
                        # manifest remaps them (fetched below, outside
                        # the lock).  A drain that dies before handing
                        # off falls through to the death path above.
                        self._begin_drain_locked(rep)
                    else:
                        self._remove_from_rotation_locked(
                            rep, "not_ready", dead=False)
            self._note_ready_locked()
            pending = list(self._drain_pending.values())
        for rep in pending:
            self._fetch_handoff(rep)
        self._brownout_poll()

    def _note_ready_locked(self) -> None:
        self.replicas_ready.set(len(self.ring))

    def _remove_from_rotation_locked(self, rep: Replica, reason: str,
                                     dead: bool = True) -> None:
        """Take one replica out of rotation: ring membership drops (only
        ~1/N of session slots remap), its sessions become typed losses,
        and — when ``dead`` — it stays out until a probe succeeds."""
        if dead:
            rep.alive = False
        self._drain_pending.pop(rep.name, None)
        if rep.name not in self.ring and not dead:
            return
        self.ring.remove(rep.name)
        now = self._clock()
        lost = [sid for sid, owner in self._session_table.items()
                if owner == rep.name]
        for sid in lost:
            del self._session_table[sid]
            self._lost[sid] = (rep.name, now)
            self._lost.move_to_end(sid)
        if lost:
            self._ledger_append("lost", sids=lost, replica=rep.name)
        self._bound_ledgers_locked()
        self.sessions_lost.inc(len(lost))
        self.failovers.inc()
        rep.last_state_change_ts = time.time()
        self._transitions.append({
            "t": now, "replica": rep.name, "event": "removed",
            "reason": reason, "sessions_lost": len(lost)})
        self._note_ready_locked()
        log.warning("replica %s out of rotation (%s): %d session(s) "
                    "lost, %d/%d replicas ready", rep.name, reason,
                    len(lost), len(self.ring), len(self.replicas))

    def _bound_ledgers_locked(self) -> None:
        """Capacity-cap the lost and handoff tables (oldest forgotten —
        the SessionStore tombstone bound, fleet-wide) and refresh the
        fleet_lost_ledger_size gauge."""
        while len(self._lost) > self.cfg.session_lost_cap:
            self._lost.popitem(last=False)
        while len(self._handoff) > self.cfg.session_lost_cap:
            self._handoff.popitem(last=False)
        self.lost_ledger_size.set(len(self._lost))

    def _expire_lost_locked(self, now: float) -> None:
        for table in (self._lost, self._handoff):
            while table:
                sid, (_x, t) = next(iter(table.items()))
                if now - t <= self.cfg.session_lost_ttl_s:
                    break
                del table[sid]
        self.lost_ledger_size.set(len(self._lost))

    # ------------------------------------------------------- drain handoff
    def _begin_drain_locked(self, rep: Replica) -> None:
        """A replica reported draining: out of rotation NOW (no new
        frames land on it), sessions kept — the handoff manifest remaps
        them; only if the process dies without one do they fall through
        to the typed-loss path."""
        if rep.name in self.ring:
            self.ring.remove(rep.name)
            self._note_ready_locked()
            rep.last_state_change_ts = time.time()
            self._transitions.append({
                "t": self._clock(), "replica": rep.name,
                "event": "draining"})
            log.info("replica %s draining: out of rotation, awaiting "
                     "session handoff manifest", rep.name)
        if rep.name not in self._drain_pending:
            self._drain_pending[rep.name] = rep

    def _fetch_handoff(self, rep: Replica) -> bool:
        """One attempt to fetch + apply a draining replica's handoff
        manifest (outside the lock; retried every probe pass while the
        replica keeps answering).  True once applied."""
        try:
            manifest = rep.get_handoff(self.cfg.health_timeout_s)
        except ReplicaUnreachable:
            # Gone already — the probe-failure path converts whatever
            # is left in the session table to typed losses.
            return False
        if manifest is None:
            return False            # not published yet; poll again
        sids = [str(s) for s in (manifest.get("sessions") or ())]
        key = manifest.get("artifact")
        now = self._clock()
        with self._lock:
            if rep.name not in self._drain_pending:
                return True         # a concurrent fetch won
            self._drain_pending.pop(rep.name, None)
            remapped = 0
            for sid in sids:
                self._session_table.pop(sid, None)
                if key:
                    self._handoff[sid] = (str(key), now)
                    self._handoff.move_to_end(sid)
                    remapped += 1
            self._bound_ledgers_locked()
            self._transitions.append({
                "t": now, "replica": rep.name, "event": "handoff",
                "sessions": remapped})
        if remapped:
            self._ledger_append("handoff", sids=sids,
                                artifact=str(key), replica=rep.name)
            self.handoff_sessions.inc(remapped)
        self.handoff_manifests.inc()
        log.info("replica %s handed off %d session(s) via artifact %s",
                 rep.name, remapped, key and str(key)[:12])
        return True

    def _await_drain_handoff(self, session_id: str) -> None:
        """A frame arrived for a session whose owner is draining but
        whose manifest has not been fetched yet: fetch it inline,
        bounded — the alternative is routing the frame cold and losing
        the warmth the drain carefully exported."""
        with self._lock:
            owner = self._session_table.get(session_id)
            rep = self._drain_pending.get(owner) if owner else None
        if rep is None:
            return
        deadline = self._clock() + self.cfg.handoff_fetch_timeout_s
        while self._clock() < deadline:
            if self._fetch_handoff(rep):
                return
            with self._lock:
                if rep.name not in self._drain_pending:
                    return
            time.sleep(0.05)

    def _handoff_key(self, session_id: str) -> Optional[str]:
        with self._lock:
            entry = self._handoff.get(session_id)
        return entry[0] if entry else None

    @staticmethod
    def _draining_503(status: int, payload: bytes) -> bool:
        """Whether a forwarded response IS the replica's typed draining
        shed — the race where a frame reached a replica between its
        SIGTERM and the router's next probe."""
        if status != 503:
            return False
        try:
            body = json.loads(payload)
        except ValueError:
            return False
        return bool(body.get("error") == "overloaded"
                    and body.get("draining"))

    # ------------------------------------------------------------- HA pair
    def _ledger_append(self, kind: str, **fields) -> bool:
        """Append one record when this router is the ACTIVE ledger
        writer; silently true in single-router mode (no ledger)."""
        if self.ledger is None:
            return True
        if not self.active:
            return False
        ok = self.ledger.append(kind, **fields)
        if not ok:
            # Fenced: the peer took over while we were serving.  Demote
            # — keep forwarding traffic, stop writing shared state.
            self.active = False
            self.active_gauge.set(0)
            log.warning("router %s fenced out of the ledger; demoted "
                        "to standby", self.cfg.router_name)
        return ok

    def _replay_ledger(self) -> None:
        """Rebuild the replicated session-loss/handoff state from the
        ledger (activation/takeover): owed losses minus fired ones
        re-arm, fired ones stay fired (never a second 410 for one id),
        handoffs re-arm the warm remap."""
        if self.ledger is None:
            return
        pending: "OrderedDict[str, str]" = OrderedDict()
        handoffs: "OrderedDict[str, str]" = OrderedDict()
        for rec in self.ledger.replay():
            kind = rec.get("kind")
            if kind == "lost":
                for sid in rec.get("sids") or ():
                    pending[str(sid)] = str(rec.get("replica"))
                    handoffs.pop(str(sid), None)
            elif kind == "fired":
                pending.pop(str(rec.get("sid")), None)
            elif kind == "handoff":
                for sid in rec.get("sids") or ():
                    handoffs[str(sid)] = str(rec.get("artifact"))
                    pending.pop(str(sid), None)
        now = self._clock()
        with self._lock:
            for sid, replica in pending.items():
                if sid not in self._lost:
                    self._lost[sid] = (replica, now)
            for sid, artifact in handoffs.items():
                if sid not in self._handoff:
                    self._handoff[sid] = (artifact, now)
            self._bound_ledgers_locked()
        log.info("ledger replayed: %d owed loss(es), %d handoff "
                 "remap(s) re-armed", len(pending), len(handoffs))

    def _probe_peer(self) -> bool:
        """One liveness poke at the peer router's /healthz (any HTTP
        answer counts — we only need to know the process is there)."""
        url = self.cfg.peer_url
        if not url:
            return True
        parsed = urlparse(url)
        conn = http.client.HTTPConnection(
            parsed.hostname or "127.0.0.1", parsed.port or 80,
            timeout=self.cfg.health_timeout_s)
        try:
            conn.request("GET", "/healthz")
            conn.getresponse().read()
            return True
        except (OSError, http.client.HTTPException):
            return False
        finally:
            conn.close()

    def _ha_tick(self) -> None:
        """One HA heartbeat, from the health loop: the active router
        renews its lease (and compacts the ledger occasionally); the
        standby watches lease staleness + the peer and takes over."""
        if self.ledger is None:
            return
        if self.active:
            if not self.ledger.renew():
                self.active = False
                self.active_gauge.set(0)
                log.warning("router %s lost the lease; now standby",
                            self.cfg.router_name)
                return
            now = time.time()
            if now - self._last_compact > 60.0:
                self._last_compact = now
                self.ledger.compact(
                    now - 4 * max(self.cfg.session_lost_ttl_s, 60.0))
            return
        # Standby: lease staleness is the authoritative signal; a peer
        # probe failing peer_fail_after times accelerates detection of
        # a hard kill (and is SAFE — taking over bumps the epoch, so a
        # merely-partitioned primary is fenced, not duplicated).
        stale = self.ledger.is_stale(self.cfg.lease_ttl_s)
        peer_dead = False
        if self.cfg.peer_url:
            if self._probe_peer():
                self._peer_failures = 0
            else:
                self._peer_failures += 1
                peer_dead = (self._peer_failures
                             >= self.cfg.peer_fail_after)
        if stale or peer_dead:
            self.takeover()

    def takeover(self) -> int:
        """Become the active ledger writer: bump the fencing epoch,
        replay the ledger, start appending.  Public for tests/ops;
        idempotent when already active."""
        if self.ledger is None or self.active:
            return self.ledger.epoch if self.ledger else 0
        epoch = self.ledger.acquire()
        self._replay_ledger()
        self.active = True
        self.active_gauge.set(1)
        self.takeovers.inc()
        self._peer_failures = 0
        with self._lock:
            self._transitions.append({
                "t": self._clock(), "replica": self.cfg.router_name,
                "event": "takeover", "epoch": epoch})
        log.warning("router %s TOOK OVER at epoch %d (lease stale or "
                    "peer dead); ledger replayed", self.cfg.router_name,
                    epoch)
        return epoch

    # ------------------------------------------------- fleet observability
    def slo_tick(self) -> Dict[str, float]:
        """One burn-rate sample + watchdog evaluation (public: the
        health loop drives it on the poll cadence; tests and the smoke
        call it directly for deterministic stepping).  Good = summed
        replica admissions; bad = summed replica deadline misses plus
        the router's OWN typed failures and slow forwards — the
        satellite-6 fix that makes a dead fleet burn budget even though
        no replica ever saw those requests."""
        with self._lock:
            admitted = missed = 0
            for rep in self.replicas.values():
                if rep.health is None:
                    continue
                admitted += rep.health.admitted
                missed += rep.health.deadline_missed
        bad = missed + self.slo_errors.value + self.slo_slow.value
        burns = self.slo.sample(float(admitted), float(bad))
        self.slo_watchdog.check(burns)
        return burns

    def note_latency(self, elapsed_ms: float) -> None:
        """Router-observed end-to-end latency for one forwarded request
        (fleet/http.py clocks it): above the ``--slo_ms`` objective it
        burns error budget like a failure — a fleet that answers
        everything slowly is NOT meeting its SLO."""
        if self.cfg.slo_ms is not None and elapsed_ms > self.cfg.slo_ms:
            self.slo_slow.inc()

    def coordinated_dump(self, trigger_trace_id: str,
                         detail: Optional[Dict] = None
                         ) -> Dict[str, object]:
        """The fleet-wide capture an SLO breach triggers: one router
        flight-recorder bundle + a forced ``POST /debug/flightrecorder``
        on every alive replica, linked by ONE manifest keyed on the
        trigger trace id — the post-incident artifact is a single file
        naming every bundle, not N directories to correlate by mtime.
        Bounded: each replica POST gets ``health_timeout_s``."""
        router_bundle = None
        if self.recorder is not None:
            router_bundle = self.recorder.dump(
                "fleet_coordinated", detail=detail, force=True)
        with self._lock:
            members = [(n, r) for n, r in self.replicas.items()
                       if r.alive]
        replica_bundles: Dict[str, object] = {}
        for name, rep in members:
            try:
                replica_bundles[name] = rep.post_flightrecorder(
                    self.cfg.health_timeout_s)
            except ReplicaUnreachable:
                replica_bundles[name] = None
        manifest: Dict[str, object] = {
            "trigger_trace_id": trigger_trace_id,
            "router": self.cfg.router_name,
            "router_bundle": router_bundle,
            "replicas": replica_bundles,
            "detail": detail or {},
        }
        if self.cfg.flight_recorder_dir:
            os.makedirs(self.cfg.flight_recorder_dir, exist_ok=True)
            path = os.path.join(self.cfg.flight_recorder_dir,
                                f"fleet-{trigger_trace_id}.json")
            with open(path, "w") as f:
                json.dump(manifest, f, indent=2, default=str)
            manifest["manifest_path"] = path
        self.fleet_dumps.append(manifest)
        log.warning("coordinated fleet dump (trigger trace %s): router "
                    "bundle %s, %d replica bundle(s)", trigger_trace_id,
                    router_bundle,
                    sum(1 for b in replica_bundles.values() if b))
        return manifest

    def federated_trace(self, trace_id: str) -> Dict[str, object]:
        """One trace id's spans merged across the fleet: the router's
        own ring plus every alive replica's ``GET /debug/spans?trace=``
        answer, each span tagged with its ``process`` — the whole
        cross-process story behind one id.  Replicas without the trace
        contribute nothing (the common case: only the owning replica
        holds the server-side half); an unreachable replica is recorded
        in ``sources`` as -1, never an error."""
        spans: List[Dict[str, object]] = []
        sources: Dict[str, int] = {}
        if self.tracer is not None:
            own = [dict(s.to_dict(), process="router")
                   for s in self.tracer.spans()
                   if s.trace_id == trace_id]
            spans.extend(own)
            sources["router"] = len(own)
        with self._lock:
            members = [(n, r) for n, r in self.replicas.items()
                       if r.alive]
        for name, rep in members:
            try:
                got = rep.get_spans(trace_id,
                                    self.cfg.health_timeout_s)
            except ReplicaUnreachable:
                sources[name] = -1
                continue
            sources[name] = len(got)
            spans.extend(dict(s, process=name) for s in got
                         if isinstance(s, dict))
        spans.sort(key=lambda s: (s.get("start_us") or 0.0))
        return {"trace_id": trace_id, "sources": sources,
                "spans": spans}

    # -------------------------------------------------------------- routing
    def _ready_replicas_locked(self) -> List[Replica]:
        return [r for r in self.replicas.values() if r.ready]

    def pick_stateless(self, exclude: Sequence[str] = (),
                       require_xl: bool = False) -> Replica:
        """Least-loaded ready replica (queue depth, then inflight, from
        the last probe), round-robin among equals; raises
        ``NoReplicasAvailable`` when the rotation is empty.  With
        ``require_xl`` only replicas whose last probe advertised the
        mesh tier qualify — none in rotation raises the typed
        ``XlUnavailable`` instead of bouncing the request off a replica
        that would 400 it."""
        with self._lock:
            ready = [r for r in self._ready_replicas_locked()
                     if r.name not in exclude]
            if require_xl:
                capable_total = sum(
                    1 for r in self.replicas.values()
                    if r.health is not None and r.health.xl_capable)
                ready = [r for r in ready
                         if r.health is not None and r.health.xl_capable]
                if not ready:
                    raise XlUnavailable(0, capable_total,
                                        len(self.replicas))
            if not ready:
                raise NoReplicasAvailable(
                    f"no ready replica (fleet of {len(self.replicas)}; "
                    f"excluded {sorted(exclude)})")
            key = lambda r: (r.health.load if r.health else (0, 0))
            best = min(key(r) for r in ready)
            tied = [r for r in ready if key(r) == best]
            self._rr += 1
            return tied[self._rr % len(tied)]

    def pick_session(self, session_id: str) -> Replica:
        """The ring's replica for this session id; raises ``SessionLost``
        (once) for ids whose replica left the rotation, and
        ``NoReplicasAvailable`` on an empty rotation."""
        with self._lock:
            self._expire_lost_locked(self._clock())
            entry = self._lost.pop(session_id, None)
            if entry is not None:
                # Fire-once: the id is forgotten now, so the client's
                # reseed (the next frame on this or a fresh id) routes
                # normally and cold-starts on a surviving replica.  The
                # ledger records the delivery FIRST, so an HA peer
                # replaying after a router kill never fires a second
                # 410 for this id.
                self.lost_ledger_size.set(len(self._lost))
                self._ledger_append("fired", sid=session_id,
                                    replica=entry[0])
                self.slo_errors.inc()
                raise SessionLost(session_id, entry[0])
            name = self.ring.lookup(session_id)
            if name is None:
                self.slo_errors.inc()
                raise NoReplicasAvailable(
                    "no ready replica to own this session")
            rep = self.replicas[name]
            self._session_table[session_id] = name
            return rep

    def forget_session(self, session_id: str) -> None:
        """Drop a session from the routing ledger (its replica answered
        a close, a 410, or the stream ended)."""
        with self._lock:
            self._session_table.pop(session_id, None)
            self._handoff.pop(session_id, None)

    def note_transport_failure(self, rep: Replica) -> None:
        """A forwarded request hit a transport error on ``rep``: out of
        rotation immediately (a burned request outranks ``fail_after``
        probe patience); the health loop will re-admit it when it
        answers probes again."""
        with self._lock:
            if rep.alive or rep.name in self.ring:
                self._remove_from_rotation_locked(rep, "transport_error")

    # ----------------------------------------------------------- forwarding
    @staticmethod
    def _wants_xl(path_qs: str,
                  headers: Sequence[Tuple[str, str]]) -> bool:
        """Whether this request names the xl tier (``?tier=xl`` or the
        ``X-Tier: xl`` header) — the routing-visible part of the r17
        tier selection; everything else about the request stays opaque
        to the router."""
        query = parse_qs(urlparse(path_qs).query)
        tiers = query.get("tier")
        if tiers and tiers[-1] == "xl":
            return True
        return any(k.lower() == "x-tier" and v.strip() == "xl"
                   for k, v in headers)

    @staticmethod
    def _names_model(path_qs: str,
                     headers: Sequence[Tuple[str, str]]) -> bool:
        """Whether the CLIENT already picked a model (``?model=`` or
        ``X-Model``) — the rollout policy never overrides an explicit
        choice, it only splits the default-model traffic."""
        query = parse_qs(urlparse(path_qs).query)
        if query.get("model"):
            return True
        return any(k.lower() == "x-model" and v.strip()
                   for k, v in headers)

    def forward_stateless(self, method: str, path_qs: str,
                          body: Optional[bytes],
                          headers: Sequence[Tuple[str, str]],
                          trace: Optional[Trace] = None
                          ) -> Tuple[int, List[Tuple[str, str]], bytes]:
        """Forward one stateless request with transport-level failover:
        a replica that dies mid-request burns one attempt, the request
        re-dispatches to the next ready replica (inference is a pure
        function of the request body — the retry is safe), and only
        ``route_retries`` exhausted or an empty rotation surfaces as an
        error.  HTTP error responses are answers, not failures — they
        forward verbatim, no retry.  Requests naming the xl tier route
        only to xl-capable replicas (typed ``XlUnavailable`` when the
        rotation has none).

        With a canary armed (fleet/rollout.py) a deterministic hash of
        the body routes the configured fraction of requests that named
        NO model themselves to the canary version (``X-Model`` injected
        before forwarding), and a sampled remainder is mirrored to it
        fire-and-forget for shadow comparison — the client always gets
        the primary answer."""
        require_xl = self._wants_xl(path_qs, headers)
        # Rollout split: inference POSTs only, and never a request that
        # already named a model.
        canary: Optional[str] = None
        shadow = False
        if (method == "POST" and body
                and urlparse(path_qs).path == "/v1/disparity"
                and self.rollout.active
                and not self._names_model(path_qs, headers)):
            split_t0 = time.perf_counter()
            canary = self.rollout.assign(body)
            if canary is not None:
                headers = list(headers) + [("X-Model", canary)]
            else:
                shadow = self.rollout.wants_shadow(body)
            self.tracer.add_span(
                "route.canary_split", trace, split_t0,
                time.perf_counter(),
                arm=("canary" if canary else
                     "shadow" if shadow else "baseline"))
        tried: List[str] = []
        last: Optional[ReplicaUnreachable] = None
        for attempt in range(self.cfg.route_retries):
            pick_t0 = time.perf_counter()
            try:
                rep = self.pick_stateless(exclude=tried,
                                          require_xl=require_xl)
            except XlUnavailable:
                self.xl_unroutable.inc()
                self.unroutable.inc()
                self.slo_errors.inc()
                raise
            except NoReplicasAvailable:
                if last is None:
                    self.unroutable.inc()
                    self.slo_errors.inc()
                    raise
                break
            tried.append(rep.name)
            if attempt > 0:
                self.route_retries.inc()
            self.tracer.add_span("route.pick", trace, pick_t0,
                                 time.perf_counter(), replica=rep.name,
                                 attempt=attempt)
            fwd_headers, fwd_span = self._traced_headers(
                headers, trace, rep, attempt)
            try:
                status, h, payload = rep.forward(
                    method, path_qs, body, fwd_headers,
                    self.cfg.request_timeout_s)
            except ReplicaUnreachable as e:
                if fwd_span is not None:
                    fwd_span.set_attr("error", "transport")
                    self.tracer.finish(fwd_span)
                last = e
                self.note_transport_failure(rep)
                log.warning("stateless %s %s: replica %s died "
                            "mid-request (attempt %d); failing over",
                            method, path_qs, rep.name, attempt + 1)
                continue
            if fwd_span is not None:
                fwd_span.set_attr("status", status)
                self.tracer.finish(fwd_span)
            self._note_routed("stateless", rep.name)
            if canary is not None:
                # 5xx means the canary arm failed the request; a 4xx is
                # the client's fault on either arm and says nothing
                # about the weights.
                self.rollout.note_canary_result(status < 500)
            elif shadow and status == 200:
                self._mirror_shadow(path_qs, body, headers, payload, h)
            return status, h, payload
        if canary is not None:
            # The canary arm never answered at all: transport-level
            # evidence against it (shared with the fleet-health path —
            # a dead fleet demotes nothing by itself thanks to
            # min_samples).
            self.rollout.note_canary_result(False)
        self.unroutable.inc()
        self.slo_errors.inc()
        raise NoReplicasAvailable(
            f"all {len(tried)} dispatch attempt(s) hit transport "
            f"failures (tried {tried}): {last}")

    def _traced_headers(self, headers: Sequence[Tuple[str, str]],
                        trace: Optional[Trace], rep: Replica,
                        attempt: int):
        """Per-attempt trace propagation: open one ``route.forward``
        span and attach ``traceparent`` naming it, so the replica's
        ``serve.request`` parents to the attempt that actually reached
        it (a failover shows two forward children, the survivor owning
        the server-side subtree).  The router OWNS the header while
        tracing (a client-supplied value must not graft onto our
        trace); untraced (sample rate 0) the headers pass through
        UNTOUCHED — byte-verbatim contract, and a client's own
        traceparent still reaches the replica."""
        if trace is None:
            return headers, None
        span = self.tracer.start_span("route.forward", trace,
                                      replica=rep.name, attempt=attempt)
        if span is None:
            return headers, None
        fwd = [(k, v) for k, v in headers
               if k.lower() != TRACE_CONTEXT_HEADER]
        fwd.append((TRACE_CONTEXT_HEADER,
                    encode_traceparent(trace.trace_id, span.span_id)))
        return fwd, span

    # ------------------------------------------------------- shadow mirror
    def _mirror_shadow(self, path_qs: str, body: bytes,
                       headers: Sequence[Tuple[str, str]],
                       primary_payload: bytes,
                       primary_headers: Sequence[Tuple[str, str]] = ()
                       ) -> None:
        """Fire-and-forget mirror of one baseline request to the canary
        version on a short-lived thread: the shadow answer is compared
        against the primary's disparity (mean EPE divergence) — and,
        when both arms answered with ``X-Confidence``, against the
        primary's confidence (round 24) — recorded into the rollout
        policy's regression windows, and DROPPED — never returned,
        never retried, never allowed to fail the client's request."""
        threading.Thread(
            target=self._shadow_once,
            args=(path_qs, body, list(headers), primary_payload,
                  list(primary_headers)),
            daemon=True, name="fleet-shadow").start()

    def _shadow_once(self, path_qs: str, body: bytes,
                     headers: List[Tuple[str, str]],
                     primary_payload: bytes,
                     primary_headers: List[Tuple[str, str]]) -> None:
        try:
            model = self.rollout.canary_model()
            if model is None:
                return
            fwd = [(k, v) for k, v in headers
                   if k.lower() != "x-model"]
            fwd.append(("X-Model", model[0]))
            rep = self.pick_stateless()
            status, h, payload = rep.forward(
                "POST", path_qs, body, fwd, self.cfg.request_timeout_s)
            if status != 200:
                self.rollout.note_canary_result(status < 500)
                return
            epe = self._payload_epe(primary_payload, payload)
            if epe is not None:
                self.rollout.note_shadow_epe(epe)
            delta = self._confidence_delta(primary_headers, h)
            if delta is not None:
                self.rollout.note_shadow_confidence(delta)
        except (ReplicaUnreachable, NoReplicasAvailable):
            pass        # no capacity for shadows is not canary evidence
        except Exception:  # pragma: no cover — mirror must never raise
            log.exception("shadow mirror failed")

    @staticmethod
    def _confidence_delta(primary_headers: Sequence[Tuple[str, str]],
                          shadow_headers: Sequence[Tuple[str, str]]
                          ) -> Optional[float]:
        """Primary minus canary mean confidence from the two responses'
        ``X-Confidence`` headers (positive = the canary is less sure);
        None unless BOTH arms served with confidence telemetry — absent
        headers are not evidence."""
        def _conf(hs):
            for k, v in hs:
                if k.lower() == "x-confidence":
                    try:
                        return float(v)
                    except ValueError:
                        return None
            return None

        a, b = _conf(primary_headers), _conf(shadow_headers)
        if a is None or b is None:
            return None
        return a - b

    @staticmethod
    def _payload_epe(primary: bytes, shadow: bytes) -> Optional[float]:
        """Mean |EPE| between two ``.npy`` disparity payloads; None when
        either payload is not a comparable array (png responses, shape
        mismatch) — the compare is evidence, not a contract."""
        import io

        import numpy as np
        try:
            a = np.load(io.BytesIO(primary), allow_pickle=False)
            b = np.load(io.BytesIO(shadow), allow_pickle=False)
        except Exception:
            return None
        if getattr(a, "shape", None) != getattr(b, "shape", None) \
                or a.shape == ():
            return None
        return float(np.mean(np.abs(np.asarray(a, np.float32)
                                    - np.asarray(b, np.float32))))

    def _forward_session_once(self, session_id: str, method: str,
                              path_qs: str, body: Optional[bytes],
                              headers: Sequence[Tuple[str, str]],
                              trace: Optional[Trace] = None
                              ) -> Tuple[Replica, int,
                                         List[Tuple[str, str]], bytes]:
        """One sticky dispatch: pick the owner, tag the frame with its
        handoff artifact when the id was handed off, forward."""
        pick_t0 = time.perf_counter()
        rep = self.pick_session(session_id)   # SessionLost / NoReplicas
        self.tracer.add_span("route.pick", trace, pick_t0,
                             time.perf_counter(), replica=rep.name,
                             session=session_id)
        key = self._handoff_key(session_id)
        # The router OWNS this header: a client-supplied value must not
        # reach a replica (it would point the import at an arbitrary
        # store key).
        fwd_headers = [(k, v) for k, v in headers
                       if k.lower() != "x-handoff-artifact"]
        if key is not None:
            fwd_headers.append(("X-Handoff-Artifact", key))
            self.tracer.add_span("route.handoff_remap", trace, pick_t0,
                                 time.perf_counter(),
                                 replica=rep.name,
                                 artifact=str(key)[:16])
        fwd_headers, fwd_span = self._traced_headers(
            fwd_headers, trace, rep, 0)
        try:
            status, h, payload = rep.forward(
                method, path_qs, body, fwd_headers,
                self.cfg.request_timeout_s)
        except ReplicaUnreachable:
            if fwd_span is not None:
                fwd_span.set_attr("error", "transport")
                self.tracer.finish(fwd_span)
            self.note_transport_failure(rep)
            with self._lock:
                # pick_session recorded the route; the death path above
                # may have tombstoned it already — pop either way so the
                # 410 fires exactly once, right now.
                self._session_table.pop(session_id, None)
                self._lost.pop(session_id, None)
                self._handoff.pop(session_id, None)
                self.lost_ledger_size.set(len(self._lost))
            self._ledger_append("fired", sid=session_id,
                                replica=rep.name)
            self.slo_errors.inc()
            raise SessionLost(session_id, rep.name) from None
        if fwd_span is not None:
            fwd_span.set_attr("status", status)
            self.tracer.finish(fwd_span)
        if key is not None and status == 200:
            # Adopted: the inheriting replica now owns the live state.
            with self._lock:
                self._handoff.pop(session_id, None)
        return rep, status, h, payload

    def forward_session(self, session_id: str, method: str, path_qs: str,
                        body: Optional[bytes],
                        headers: Sequence[Tuple[str, str]],
                        trace: Optional[Trace] = None
                        ) -> Tuple[int, List[Tuple[str, str]], bytes]:
        """Forward one session-sticky request.  No transport failover:
        the session's state lives on exactly one replica, so a transport
        failure there IS the loss of the session — the replica leaves
        the rotation and this request (and only this one) fails typed
        with ``SessionLost``.  Planned drains are different: a frame
        that races the drain (typed 503 draining answer, or an owner
        whose manifest is still in flight) waits for the handoff
        manifest — bounded — and retries ONCE on the inheriting replica,
        so a rolling restart is zero-loss even for frames already in
        the air."""
        self._await_drain_handoff(session_id)
        rep, status, h, payload = self._forward_session_once(
            session_id, method, path_qs, body, headers, trace=trace)
        if self._draining_503(status, payload):
            # The frame beat the router's probe to a draining replica.
            # Treat the typed shed AS the drain signal: out of
            # rotation, fetch the manifest (bounded), re-pick — the
            # ring now maps the id to a survivor — and retry the frame
            # there with its handoff tag.  The draining replica never
            # admitted it, so the retry cannot double-dispatch.
            with self._lock:
                self._begin_drain_locked(rep)
            remap_t0 = time.perf_counter()
            self._await_drain_handoff_for(rep)
            self.tracer.add_span("route.handoff_remap", trace, remap_t0,
                                 time.perf_counter(), replica=rep.name,
                                 reason="drain_race")
            retry_rep, status, h, payload = self._forward_session_once(
                session_id, method, path_qs, body, headers, trace=trace)
            log.info("session %s frame raced replica %s's drain; "
                     "re-routed to %s", session_id, rep.name,
                     retry_rep.name)
            rep = retry_rep
        self._note_routed("session", rep.name)
        if status == 410 or (method == "DELETE" and status == 200):
            self.forget_session(session_id)
        return status, h, payload

    def _await_drain_handoff_for(self, rep: Replica) -> None:
        """Bounded manifest wait for one specific draining replica."""
        deadline = self._clock() + self.cfg.handoff_fetch_timeout_s
        while self._clock() < deadline:
            with self._lock:
                if rep.name not in self._drain_pending:
                    return
            if self._fetch_handoff(rep):
                return
            time.sleep(0.05)

    # ----------------------------------------------------- fleet membership
    def add_replica(self, name: str, url: str) -> Replica:
        """Register a new fleet member at runtime (the autoscaler's
        scale-up seam).  It joins the rotation when its probes go ready
        — no traffic lands on it before /readyz opens."""
        with self._lock:
            if name in self.replicas:
                raise ValueError(f"replica {name!r} already registered")
            rep = Replica(name, url)
            rep.alive = False        # in rotation only after a probe
            self.replicas[name] = rep
            self.replicas_total.set(len(self.replicas))
            self._transitions.append({
                "t": self._clock(), "replica": name, "event": "added"})
        log.info("replica %s added at %s (%d configured)", name, url,
                 len(self.replicas))
        return rep

    def remove_replica(self, name: str) -> None:
        """Deregister a fleet member (the autoscaler's post-drain
        cleanup).  Sessions still mapped to it — there should be none
        after a handoff — fail typed, never silently."""
        with self._lock:
            rep = self.replicas.get(name)
            if rep is None:
                return
            self._remove_from_rotation_locked(rep, "deregistered")
            del self.replicas[name]
            self.replicas_total.set(len(self.replicas))
            self._note_ready_locked()

    def fleet_pressure(self) -> Dict[str, object]:
        """The aggregate pressure signal the autoscaler consumes:
        queued fraction across ready replicas (None when nothing
        reports a limit), the fleet brownout level, and the summed
        admitted/deadline-miss totals (the caller differences them
        into a rate)."""
        with self._lock:
            admitted = missed = 0
            for rep in self._ready_replicas_locked():
                if rep.health is None:
                    continue
                admitted += rep.health.admitted
                missed += rep.health.deadline_missed
            return {
                "queued_fraction": self._fleet_pressure_locked(),
                "brownout_level": self.brownout_level,
                "brownout_max_level": self.cfg.brownout_max_level,
                "admitted_total": admitted,
                "deadline_missed_total": missed,
                "ready": len(self.ring),
                "total": len(self.replicas),
            }

    # -------------------------------------------------------- fleet brownout
    def _fleet_pressure_locked(self) -> Optional[float]:
        """Aggregate queued fraction across ready replicas; None when no
        replica reports a queue limit (nothing to measure)."""
        depth = limit = 0
        for rep in self._ready_replicas_locked():
            if rep.health is None or rep.health.queue_limit <= 0:
                continue
            depth += rep.health.queue_depth
            limit += rep.health.queue_limit
        if limit <= 0:
            return None
        return depth / limit

    def _brownout_poll(self) -> None:
        if not self.cfg.fleet_brownout:
            return
        now = self._clock()
        push: Optional[Tuple[Replica, ...]] = None
        with self._lock:
            pressure = self._fleet_pressure_locked()
            if pressure is None:
                return
            level = self.brownout_level
            if pressure >= self.cfg.brownout_engage_fraction:
                self._calm_since = None
                if self._pressure_since is None:
                    self._pressure_since = now
                elif (now - self._pressure_since
                        >= self.cfg.brownout_engage_s
                        and level < self.cfg.brownout_max_level):
                    self.brownout_level = level + 1
                    self._pressure_since = now
                    push = tuple(r for r in self.replicas.values()
                                 if r.alive)
            elif pressure <= self.cfg.brownout_restore_fraction:
                self._pressure_since = None
                if level > 0:
                    if self._calm_since is None:
                        self._calm_since = now
                    elif (now - self._calm_since
                            >= self.cfg.brownout_restore_s):
                        self.brownout_level = level - 1
                        self._calm_since = now
                        push = tuple(r for r in self.replicas.values()
                                     if r.alive)
                else:
                    self._calm_since = None
            else:
                self._pressure_since = None
                self._calm_since = None
            if push is not None:
                new_level = self.brownout_level
                self.brownout_gauge.set(new_level)
                log.warning("fleet brownout level %d -> %d (aggregate "
                            "queued fraction %.2f)", level, new_level,
                            pressure)
        if push is not None:
            self._push_brownout(push)

    def _push_brownout(self, reps: Sequence[Replica]) -> None:
        for rep in reps:
            try:
                if rep.post_brownout(self.brownout_level,
                                     self.cfg.health_timeout_s):
                    self.brownout_pushes.inc()
            except ReplicaUnreachable:
                pass    # the health loop will notice and re-push on rejoin

    def _push_brownout_locked(self, reps: Sequence[Replica]) -> None:
        """Re-push the current floor to a rejoining replica — fired from
        inside the lock; the actual I/O rides a short-lived thread so
        the probe pass is never blocked on a slow member."""
        threading.Thread(
            target=lambda: self._push_brownout(reps),
            daemon=True, name="fleet-brownout-push").start()

    # --------------------------------------------------------------- status
    def fleet_status(self) -> Dict[str, object]:
        with self._lock:
            return {
                "replicas": {name: rep.stats()
                             for name, rep in self.replicas.items()},
                "in_rotation": list(self.ring.members),
                "ready": len(self.ring),
                "total": len(self.replicas),
                "sessions_routed": len(self._session_table),
                "sessions_pending_loss": len(self._lost),
                "sessions_pending_handoff": len(self._handoff),
                "draining_replicas": sorted(self._drain_pending),
                "brownout_level": self.brownout_level,
                "role": ("single" if self.ledger is None
                         else "primary" if self.active else "standby"),
                "epoch": self.ledger.epoch if self.ledger else None,
                "rollout": self.rollout.status(),
                "slo": self.slo.status(),
                "federation": self.federator.status(),
                "fleet_dumps": len(self.fleet_dumps),
                "transitions": list(self._transitions[-50:]),
            }
