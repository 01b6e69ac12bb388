"""Deterministic fault injection for the serving engine.

A resilience layer is only real if it can be proven under failure, and
failures on demand must be (a) representative of what production devices
actually do and (b) reproducible, or a flaky chaos test erodes exactly the
confidence it was built to create.  This module injects the four failure
modes the engine's supervised-recovery path (serving/engine.py) handles:

* **worker crash mid-dispatch** — an exception between batch pickup and
  result delivery, the generic "XLA runtime died / plugin segfault
  surfaced as a Python error" case;
* **device RESOURCE_EXHAUSTED** — the allocator-failure flavor of the
  same (TPU HBM OOM arrives as an ``XlaRuntimeError`` whose message
  starts with ``RESOURCE_EXHAUSTED``);
* **added dispatch latency** — a slow device (thermal throttle, a noisy
  neighbor on the host) that should trip deadline triage and the
  brownout signals, not the crash path;
* **compile failure** — ``jit(...).lower().compile()`` raising, the
  failure class a persistent-cache restore or an XLA upgrade can hit.

Round 16 adds the REPLICA-level failure modes the fleet router
(serving/fleet/) must survive — the unit of failure is now the whole
process, not a worker thread:

* **process death mid-dispatch** (``die_after_dispatches``) — the
  deterministic kill -9: ``os._exit(137)`` when the Nth dispatch begins,
  in-flight requests and open sockets and all;
* **health-check blackhole** (``healthz_blackhole_after_s``) — /healthz
  and /readyz stop answering while the request path keeps working, the
  "zombie to the load balancer" mode a probe TIMEOUT must catch;
* **slow start** (``slow_start_s``) — the readiness gate held closed
  after boot, pinning that the router keeps a warming replica out of
  rotation.

Determinism: every injection decision is a pure function of
``(seed, site, worker, per-site call index)`` via SHA-256 — independent
of thread interleaving, platform hash seeds, and wall clock.  Two runs
with the same seed and the same per-worker dispatch sequence inject the
same faults, which is what lets scripts/chaos_smoke.py assert exact
recovery behavior in CI.

Zero-overhead contract: chaos is OFF unless a ``ChaosConfig`` is set on
``ServeConfig.chaos``.  The engine holds ``None`` then, and every
injection site is a single attribute check — the dispatch path compiles
the same programs and produces bitwise-identical results
(tests/test_resilience.py pins this against the solo runner).

The JAX package's ``serving/chaos.py``, copied whole; the port's engine
raises the same injected exceptions at the same sites, so a seed injects
the same schedule in both packages.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import threading
import time
from typing import Dict, Optional, Tuple

__all__ = ["ChaosConfig", "ChaosInjector", "InjectedFault",
           "InjectedWorkerCrash", "InjectedResourceExhausted",
           "InjectedCompileFailure", "parse_chaos_spec"]


class InjectedFault(RuntimeError):
    """Base of every injected failure — the recovery path treats these
    exactly like real faults (that is the point), but tests and the smoke
    harness can still tell injected from organic."""


class InjectedWorkerCrash(InjectedFault):
    """Injected worker exception mid-dispatch."""


class InjectedResourceExhausted(InjectedFault):
    """Injected device allocator failure.  The message mirrors the real
    ``XlaRuntimeError: RESOURCE_EXHAUSTED: ...`` prefix so log-scrapers
    exercised under chaos match production strings."""

    def __init__(self, detail: str = ""):
        super().__init__(f"RESOURCE_EXHAUSTED: injected device OOM{detail}")


class InjectedCompileFailure(InjectedFault):
    """Injected XLA compile failure (lower/compile raising)."""


@dataclasses.dataclass(frozen=True)
class ChaosConfig:
    """Fault-injection knobs (``ServeConfig.chaos``; None = off).

    Rates are per-decision probabilities in [0, 1]: ``crash_rate`` and
    ``resource_exhausted_rate`` per dispatch, ``compile_failure_rate``
    per executable build, ``latency_rate`` per dispatch (adding
    ``latency_ms`` of host-side stall).  ``devices`` restricts injection
    to those worker indices (empty = all workers) — a one-element tuple
    is the "flapping device" scenario the circuit breaker is tested
    against.  ``max_faults`` caps TOTAL injected faults (latency
    excluded), after which the injector goes quiet: a deterministic
    "device recovers" story for half-open probe tests.
    """

    seed: int = 0
    crash_rate: float = 0.0
    resource_exhausted_rate: float = 0.0
    compile_failure_rate: float = 0.0
    latency_rate: float = 0.0
    latency_ms: float = 0.0
    devices: Tuple[int, ...] = ()
    max_faults: Optional[int] = None
    # ---- Replica-level faults (round 16; the fleet failover story) ----
    # Hard-kill the WHOLE PROCESS (os._exit(137), the kill -9 exit code)
    # when the engine's Nth dispatch begins: the replica dies
    # mid-dispatch with requests in flight, sockets open, and no
    # goodbye — exactly what the fleet router must survive
    # (scripts/fleet_smoke.py).  Deterministic by construction: the Nth
    # dispatch, not a probability.
    die_after_dispatches: Optional[int] = None
    # Health-check blackhole: after this many seconds of process
    # lifetime, /healthz and /readyz stop answering (connection closed
    # with no response) while the request path keeps working — the
    # "zombie to the load balancer" failure the router's probe timeout
    # must classify as dead.  0 = off.
    healthz_blackhole_after_s: float = 0.0
    # Slow start: the readiness gate stays closed for this many seconds
    # after boot even once the warm ladder is compiled — models a
    # replica fetching artifacts / weights slowly, so failover tests can
    # pin that the router keeps it out of rotation until /readyz opens.
    slow_start_s: float = 0.0

    def __post_init__(self):
        for f in ("crash_rate", "resource_exhausted_rate",
                  "compile_failure_rate", "latency_rate"):
            v = getattr(self, f)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{f}={v} must be in [0, 1]")
        if self.latency_ms < 0:
            raise ValueError(f"latency_ms={self.latency_ms} must be >= 0")
        if self.max_faults is not None and self.max_faults < 0:
            raise ValueError(f"max_faults={self.max_faults} must be >= 0")
        if (self.die_after_dispatches is not None
                and self.die_after_dispatches < 1):
            raise ValueError(f"die_after_dispatches="
                             f"{self.die_after_dispatches} must be >= 1")
        if self.healthz_blackhole_after_s < 0:
            raise ValueError(f"healthz_blackhole_after_s="
                             f"{self.healthz_blackhole_after_s} must be "
                             f">= 0")
        if self.slow_start_s < 0:
            raise ValueError(f"slow_start_s={self.slow_start_s} must be "
                             f">= 0")

    @property
    def enabled(self) -> bool:
        return (any(getattr(self, f) > 0
                    for f in ("crash_rate", "resource_exhausted_rate",
                              "compile_failure_rate", "latency_rate",
                              "healthz_blackhole_after_s",
                              "slow_start_s"))
                or self.die_after_dispatches is not None)


def _fraction(seed: int, site: str, worker: int, n: int) -> float:
    """Uniform [0, 1) from the decision coordinates — SHA-256 so the
    stream is identical across processes, platforms, and PYTHONHASHSEED."""
    digest = hashlib.sha256(
        f"{seed}:{site}:{worker}:{n}".encode()).digest()
    return int.from_bytes(digest[:8], "big") / 2 ** 64


class ChaosInjector:
    """The engine-side injector: one per engine, shared by all workers.

    Each injection site draws from its own deterministic per-(site,
    worker) counter stream, so worker 0's fault sequence does not depend
    on how the scheduler interleaved worker 1's dispatches.  ``observe``
    (optional) is called with the fault kind on every injection — the
    engine wires the ``serve_chaos_injected_total{kind=...}`` counter
    family there.
    """

    def __init__(self, cfg: ChaosConfig, observe=None,
                 sleep=time.sleep, clock=time.monotonic,
                 exit_fn=None):
        self.cfg = cfg
        self.observe = observe
        self._sleep = sleep
        self._clock = clock
        self._t0 = clock()
        # os._exit bypasses atexit/finally on purpose: die_after is the
        # kill -9 simulation, and a graceful unwind would be a different
        # (gentler) failure mode than the one under test.  Injectable for
        # the unit tests.
        self._exit = exit_fn if exit_fn is not None else os._exit
        self._lock = threading.Lock()
        self._counts: Dict[Tuple[str, int], int] = {}
        self._dispatches = 0
        self.faults_injected = 0

    def _roll(self, site: str, worker: int) -> float:
        with self._lock:
            n = self._counts.get((site, worker), 0)
            self._counts[(site, worker)] = n + 1
        return _fraction(self.cfg.seed, site, worker, n)

    def _targets(self, worker: int) -> bool:
        return not self.cfg.devices or worker in self.cfg.devices

    def _fire(self, kind: str) -> bool:
        """Consume one fault from the budget; False when exhausted."""
        with self._lock:
            if (self.cfg.max_faults is not None
                    and self.faults_injected >= self.cfg.max_faults):
                return False
            self.faults_injected += 1
        if self.observe is not None:
            self.observe(kind)
        return True

    # ------------------------------------------------ replica-level faults
    def ready_blocked(self) -> bool:
        """Slow start: True while the readiness gate must stay closed
        (``slow_start_s`` of process lifetime not yet elapsed)."""
        return (self.cfg.slow_start_s > 0
                and self._clock() - self._t0 < self.cfg.slow_start_s)

    def blackhole(self) -> bool:
        """Health-check blackhole: True once /healthz and /readyz must
        stop answering (the HTTP layer closes the connection with no
        response; the router's probe timeout classifies it dead)."""
        return (self.cfg.healthz_blackhole_after_s > 0
                and self._clock() - self._t0
                >= self.cfg.healthz_blackhole_after_s)

    # --------------------------------------------------- injection sites
    def on_dispatch(self, worker: int) -> None:
        """Called between batch pickup and the device call: may stall
        (latency), then may raise a crash or a RESOURCE_EXHAUSTED — or
        hard-kill the whole process (``die_after_dispatches``)."""
        if not self._targets(worker):
            return
        c = self.cfg
        if c.die_after_dispatches is not None:
            with self._lock:
                self._dispatches += 1
                die = self._dispatches == c.die_after_dispatches
            if die:
                if self.observe is not None:
                    self.observe("die")
                self._exit(137)     # kill -9 exit code; no unwinding
        if (c.latency_rate > 0 and c.latency_ms > 0
                and self._roll("latency", worker) < c.latency_rate
                and self._fire("latency")):
            self._sleep(c.latency_ms / 1e3)
        if (c.crash_rate > 0
                and self._roll("crash", worker) < c.crash_rate
                and self._fire("crash")):
            raise InjectedWorkerCrash(
                f"injected worker crash (worker {worker})")
        if (c.resource_exhausted_rate > 0
                and self._roll("oom", worker) < c.resource_exhausted_rate
                and self._fire("resource_exhausted")):
            raise InjectedResourceExhausted(f" (worker {worker})")

    def on_compile(self, worker: int) -> None:
        """Called before an executable build for ``worker``."""
        if not self._targets(worker):
            return
        c = self.cfg
        if (c.compile_failure_rate > 0
                and self._roll("compile", worker) < c.compile_failure_rate
                and self._fire("compile_failure")):
            raise InjectedCompileFailure(
                f"injected compile failure (worker {worker})")


_SPEC_FIELDS = {
    "seed": ("seed", int),
    "crash": ("crash_rate", float),
    "oom": ("resource_exhausted_rate", float),
    "compile": ("compile_failure_rate", float),
    "latency": ("latency_rate", float),
    "latency_ms": ("latency_ms", float),
    "max_faults": ("max_faults", int),
    "die_after": ("die_after_dispatches", int),
    "blackhole_after_s": ("healthz_blackhole_after_s", float),
    "slow_start_s": ("slow_start_s", float),
}


def parse_chaos_spec(spec: str) -> Optional[ChaosConfig]:
    """CLI chaos spec -> ChaosConfig.

    Comma-separated ``key=value`` pairs: ``crash=0.1,seed=7`` injects a
    10% worker-crash rate; keys are ``crash`` / ``oom`` / ``compile`` /
    ``latency`` (rates), ``latency_ms``, ``seed``, ``max_faults``, and
    ``devices`` (``|``-separated worker indices).  Empty/None -> None
    (chaos off)."""
    if not spec or not spec.strip():
        return None
    kwargs: Dict[str, object] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(f"chaos spec {spec!r}: {part!r} is not "
                             f"key=value")
        key, value = (s.strip() for s in part.split("=", 1))
        if key == "devices":
            kwargs["devices"] = tuple(
                int(d) for d in value.split("|") if d.strip())
        elif key in _SPEC_FIELDS:
            field, cast = _SPEC_FIELDS[key]
            kwargs[field] = cast(value)
        else:
            raise ValueError(
                f"chaos spec {spec!r}: unknown key {key!r} (use "
                f"{sorted(_SPEC_FIELDS) + ['devices']})")
    return ChaosConfig(**kwargs)
