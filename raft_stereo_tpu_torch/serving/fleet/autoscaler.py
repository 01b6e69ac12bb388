"""Pressure-driven replica autoscaling: the control loop that turns the
r16 aggregate-pressure signal into fleet size changes.

The router already measures everything a scaling decision needs — the
aggregate queued fraction (the brownout engage signal), the fleet
brownout level itself (the fleet is ALREADY degrading answers to keep
up), and the deadline-miss totals each replica's /healthz exports.  The
``Autoscaler`` folds those into one composite pressure in [0, 1] and
runs the same engage/restore hysteresis shape as every other controller
in this repo (serving/resilience.py BrownoutController, the router's
fleet brownout): engaging needs SUSTAINED pressure, restoring needs a
longer sustained calm at a lower watermark, and the dead band between
the watermarks holds — a fleet hovering at the threshold can never flap
replicas up and down.

Scale-up registers a fresh replica with the router (``add_replica``)
and lets readiness gate traffic: the new process boots warm from the
shared artifact store and joins rotation when /readyz opens.
**Scale-down always DRAINS**: the launcher delivers SIGTERM, the
replica publishes its session handoff (serving/sessions.py export →
artifact store), the router remaps the streams to survivors, and only
after the process exited cleanly is it deregistered — a scale-down is
operationally indistinguishable from a rolling restart and produces
zero typed session losses (pinned in tests/test_fleet.py).

``ReplicaLauncher`` is the deployment seam: ``LocalProcessLauncher``
spawns ``raft-serve-torch`` subprocesses on this host (what ``raft-route-torch
--autoscale_cmd`` and scripts/fleet_smoke.py use); a k8s/Borg launcher
implements the same four methods against its API and nothing else
changes.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import shlex
import signal
import socket
import subprocess
import sys
import threading
import time
from typing import Callable, Dict, List, Optional

from raft_stereo_tpu_torch.serving.fleet.router import FleetRouter

log = logging.getLogger(__name__)


class ReplicaLauncher:
    """Deployment seam: how the autoscaler materializes and retires
    replica processes.  Implementations must be idempotent about names
    they never launched."""

    def launch(self, name: str) -> str:
        """Start a replica; returns its base URL.  The replica may take
        arbitrarily long to become ready — the router's probes gate
        traffic, not this call."""
        raise NotImplementedError

    def drain(self, name: str) -> None:
        """Begin a GRACEFUL shutdown (SIGTERM): readyz flips, sessions
        hand off, queued work finishes.  Never a hard kill."""
        raise NotImplementedError

    def poll(self, name: str) -> Optional[int]:
        """The replica's exit code, or None while it is still running
        (also None for unknown names)."""
        raise NotImplementedError

    def destroy(self, name: str) -> None:
        """Force-stop and forget one replica (shutdown cleanup only —
        the scaling path always drains)."""
        raise NotImplementedError


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


class LocalProcessLauncher(ReplicaLauncher):
    """Launch replicas as local subprocesses.

    ``argv_for(name, port)`` returns the full command line (the CLI
    builds it from the ``--autoscale_cmd`` template, substituting
    ``{name}`` / ``{port}``).  Logs go to ``<log_dir>/<name>.log`` when
    a directory is given, else inherit.
    """

    def __init__(self, argv_for: Callable[[str, int], List[str]],
                 env: Optional[Dict[str, str]] = None,
                 log_dir: Optional[str] = None):
        self.argv_for = argv_for
        self.env = env
        self.log_dir = log_dir
        self._lock = threading.Lock()
        self._procs: Dict[str, subprocess.Popen] = {}
        self._logs: Dict[str, object] = {}

    def launch(self, name: str) -> str:
        port = _free_port()
        argv = self.argv_for(name, port)
        stdout = stderr = None
        if self.log_dir:
            os.makedirs(self.log_dir, exist_ok=True)
            stdout = stderr = open(
                os.path.join(self.log_dir, f"{name}.log"), "ab")
        proc = subprocess.Popen(argv, env=self.env, stdout=stdout,
                                stderr=stderr)
        with self._lock:
            self._procs[name] = proc
            if stdout is not None:
                self._logs[name] = stdout
        log.info("launched replica %s (pid %d, port %d): %s", name,
                 proc.pid, port, shlex.join(argv))
        return f"http://127.0.0.1:{port}"

    def drain(self, name: str) -> None:
        with self._lock:
            proc = self._procs.get(name)
        if proc is not None and proc.poll() is None:
            proc.send_signal(signal.SIGTERM)
            log.info("draining replica %s (SIGTERM to pid %d)", name,
                     proc.pid)

    def poll(self, name: str) -> Optional[int]:
        with self._lock:
            proc = self._procs.get(name)
        return None if proc is None else proc.poll()

    def destroy(self, name: str) -> None:
        with self._lock:
            proc = self._procs.pop(name, None)
            fh = self._logs.pop(name, None)
        if proc is not None and proc.poll() is None:
            proc.kill()
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:  # pragma: no cover
                pass
        if fh is not None:
            try:
                fh.close()
            except OSError:  # pragma: no cover
                pass

    def stop_all(self) -> None:
        with self._lock:
            names = list(self._procs)
        for name in names:
            self.destroy(name)


def serve_argv_template(template: str) -> Callable[[str, int], List[str]]:
    """Turn an ``--autoscale_cmd`` template ("... --port {port}") into
    the launcher's argv factory.  ``{port}`` is required (every replica
    needs its own); ``{name}`` is optional."""
    if "{port}" not in template:
        raise ValueError("--autoscale_cmd template needs a {port} "
                         "placeholder")

    def argv_for(name: str, port: int) -> List[str]:
        line = template.replace("{port}", str(port)).replace("{name}",
                                                             name)
        argv = shlex.split(line)
        if argv and argv[0] == "python":
            argv[0] = sys.executable
        return argv

    return argv_for


@dataclasses.dataclass(frozen=True)
class AutoscaleConfig:
    """Scaling-policy knobs (cli/route.py maps flags here)."""

    min_replicas: int = 1
    max_replicas: int = 4
    # Composite pressure in [0, 1] = max(aggregate queued fraction,
    # brownout level / max level, deadline-miss rate over the window).
    # Engage: pressure >= engage_fraction sustained for engage_s.
    engage_fraction: float = 0.6
    engage_s: float = 2.0
    # Restore: pressure <= restore_fraction sustained for restore_s
    # (longer, lower watermark — the anti-flap hysteresis).
    restore_fraction: float = 0.15
    restore_s: float = 10.0
    # Minimum spacing between ANY two scaling actions: a fresh replica
    # needs time to join rotation and absorb load before the signal is
    # trusted again.
    cooldown_s: float = 5.0
    poll_s: float = 0.5
    # Deadline-miss rate only counts once this many admissions happened
    # within the window (a 1-request window is noise).
    miss_min_events: int = 8

    def __post_init__(self):
        if self.min_replicas < 1:
            raise ValueError(f"min_replicas={self.min_replicas} must "
                             f"be >= 1")
        if self.max_replicas < self.min_replicas:
            raise ValueError(
                f"max_replicas={self.max_replicas} must be >= "
                f"min_replicas={self.min_replicas}")
        if not 0 < self.restore_fraction <= self.engage_fraction <= 1:
            raise ValueError(
                f"need 0 < restore_fraction ({self.restore_fraction}) "
                f"<= engage_fraction ({self.engage_fraction}) <= 1")


class Autoscaler:
    """The control loop: reads ``router.fleet_pressure()``, applies the
    engage/restore hysteresis, and drives the launcher + router
    membership.  ``check()`` is one deterministic step (tests drive it
    with a fake clock and scripted pressure); ``start()`` runs it on a
    poll thread."""

    def __init__(self, router: FleetRouter, launcher: ReplicaLauncher,
                 cfg: AutoscaleConfig = AutoscaleConfig(),
                 clock: Callable[[], float] = time.monotonic,
                 pressure_fn: Optional[Callable[[], Optional[float]]]
                 = None):
        self.router = router
        self.launcher = launcher
        self.cfg = cfg
        self._clock = clock
        self._pressure_fn = pressure_fn    # test seam: scripted traces
        self._lock = threading.Lock()
        self._pressure_since: Optional[float] = None
        self._calm_since: Optional[float] = None
        self._last_action: Optional[float] = None
        self._counter = 0
        self._launched: List[str] = []       # scale-down candidates, LIFO
        self._draining: Dict[str, float] = {}
        self._prev_admitted: Optional[int] = None
        self._prev_missed: Optional[int] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        r = router.registry
        self.scale_ups = r.counter(
            "fleet_autoscale_up_total",
            "replicas launched by the pressure-driven autoscaler")
        self.scale_downs = r.counter(
            "fleet_autoscale_down_total",
            "replicas drained away by the autoscaler (always via "
            "handoff, never killed)")
        self.pressure_gauge = r.gauge(
            "fleet_autoscale_pressure",
            "composite autoscaling pressure in [0,1]: max(queued "
            "fraction, normalized brownout level, deadline-miss rate)")

    # ------------------------------------------------------------- pressure
    def _composite_pressure(self) -> Optional[float]:
        if self._pressure_fn is not None:
            return self._pressure_fn()
        sig = self.router.fleet_pressure()
        if sig["ready"] == 0:
            return None           # nothing measurable; never scale blind
        parts = []
        if sig["queued_fraction"] is not None:
            parts.append(min(1.0, float(sig["queued_fraction"])))
        bmax = max(1, int(sig["brownout_max_level"]))
        parts.append(min(1.0, sig["brownout_level"] / bmax))
        admitted = int(sig["admitted_total"])
        missed = int(sig["deadline_missed_total"])
        if self._prev_admitted is not None:
            d_adm = admitted - self._prev_admitted
            d_miss = missed - self._prev_missed
            if d_adm >= self.cfg.miss_min_events and d_miss >= 0:
                parts.append(min(1.0, d_miss / d_adm))
        self._prev_admitted, self._prev_missed = admitted, missed
        return max(parts) if parts else None

    # ----------------------------------------------------------------- step
    def check(self) -> Optional[str]:
        """One control step; returns "up"/"down" when an action fired,
        else None.  Reaps finished drains first, so a completed
        scale-down frees its membership slot before the next decision."""
        self._reap_drained()
        pressure = self._composite_pressure()
        if pressure is None:
            return None
        self.pressure_gauge.set(pressure)
        now = self._clock()
        action: Optional[str] = None
        with self._lock:
            cooling = (self._last_action is not None
                       and now - self._last_action < self.cfg.cooldown_s)
            count = len(self.router.replicas) - len(self._draining)
            if pressure >= self.cfg.engage_fraction:
                self._calm_since = None
                if self._pressure_since is None:
                    self._pressure_since = now
                elif (now - self._pressure_since >= self.cfg.engage_s
                        and not cooling
                        and count < self.cfg.max_replicas):
                    action = "up"
                    self._pressure_since = now
                    self._last_action = now
            elif pressure <= self.cfg.restore_fraction:
                self._pressure_since = None
                if count > self.cfg.min_replicas and self._launched:
                    if self._calm_since is None:
                        self._calm_since = now
                    elif (now - self._calm_since >= self.cfg.restore_s
                            and not cooling):
                        action = "down"
                        self._calm_since = now
                        self._last_action = now
                else:
                    self._calm_since = None
            else:
                # Dead band between the watermarks: hold, reset both
                # timers — this is the hysteresis.
                self._pressure_since = None
                self._calm_since = None
        if action == "up":
            self._scale_up(pressure)
        elif action == "down":
            self._scale_down(pressure)
        return action

    def _scale_up(self, pressure: float) -> None:
        with self._lock:
            self._counter += 1
            name = f"auto{self._counter}"
        url = self.launcher.launch(name)
        self.router.add_replica(name, url)
        with self._lock:
            self._launched.append(name)
        self.scale_ups.inc()
        log.warning("autoscale UP: %s at %s (pressure %.2f, fleet now "
                    "%d)", name, url, pressure,
                    len(self.router.replicas))

    def _scale_down(self, pressure: float) -> None:
        with self._lock:
            if not self._launched:
                return
            victim = self._launched.pop()       # LIFO: newest first
            self._draining[victim] = self._clock()
        # Always a DRAIN: SIGTERM -> readyz flips -> session handoff ->
        # queued work finishes -> exit 0.  remove_replica happens at
        # reap time, after the process is gone.
        self.launcher.drain(victim)
        self.scale_downs.inc()
        log.warning("autoscale DOWN: draining %s (pressure %.2f)",
                    victim, pressure)

    def _reap_drained(self) -> None:
        with self._lock:
            draining = list(self._draining)
        for name in draining:
            code = self.launcher.poll(name)
            if code is None:
                continue
            if code != 0:
                log.warning("drained replica %s exited rc=%d (expected "
                            "0 from a graceful drain)", name, code)
            self.router.remove_replica(name)
            self.launcher.destroy(name)
            with self._lock:
                self._draining.pop(name, None)
            log.info("autoscale: %s fully drained and deregistered",
                     name)

    @property
    def draining(self) -> List[str]:
        with self._lock:
            return sorted(self._draining)

    @property
    def launched(self) -> List[str]:
        with self._lock:
            return list(self._launched)

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "Autoscaler":
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="fleet-autoscaler")
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.cfg.poll_s):
            try:
                self.check()
            except Exception:  # pragma: no cover — loop must not die
                log.exception("autoscaler step failed")

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
