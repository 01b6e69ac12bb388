"""Supervised recovery of the port's serving engine against the JAX
package's engine (CPU).

Each scenario runs on both engines, one worker at batch size 1 on the
``TINY`` model of ``tests/test_serving.py`` (shared weights carried by
``state_dict_from_jax``), with faults from the seeded chaos injector
(each package's own copy of ``serving/chaos.py``).  One worker and one
request at a time make the injector's decisions a fixed sequence, so the
outcomes and counters of the two engines are compared as equal: attempts,
retries, restarts, poisonings, the anomaly events in order, the tiers a
brownout serves.  The answers that do come back are held to the port's
solo runner, bit for bit (the batch-1 program).
"""

import sys
import threading
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_stereo_tpu.config import RaftStereoConfig as JaxConfig
from raft_stereo_tpu.models.raft_stereo import RAFTStereo as JaxRAFTStereo
from raft_stereo_tpu.serving import batcher as jbatcher
from raft_stereo_tpu.serving import chaos as jchaos
from raft_stereo_tpu.serving import ServeConfig as JaxServeConfig
from raft_stereo_tpu.serving import StereoService as JaxService
from raft_stereo_tpu_torch.config import RaftStereoConfig
from raft_stereo_tpu_torch.eval.runner import InferenceRunner
from raft_stereo_tpu_torch.io.jax_weights import state_dict_from_jax
from raft_stereo_tpu_torch.serving import (CIRCUIT_CLOSED, CIRCUIT_OPEN,
                                           Overloaded, ServeConfig,
                                           ServingEngine)
from raft_stereo_tpu_torch.serving import batcher as pbatcher
from raft_stereo_tpu_torch.serving import chaos as pchaos
from torch_port_support import perturb

TINY = dict(hidden_dims=(32, 32, 32), fnet_dim=64, corr_backend="reg")
ITERS = 1
SOLO = dict(max_batch=1, batch_sizes=(1,), iters=ITERS)


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def sides():
    """Both packages' engine factories and typed errors over one set of
    weights, and the port's solo runner."""
    jcfg = JaxConfig(**TINY)
    jmodel = JaxRAFTStereo(jcfg)
    dummy = jnp.zeros((1, 64, 64, 3), jnp.float32)
    init = jax.jit(lambda key: jmodel.init(key, dummy, dummy, iters=1,
                                           test_mode=True))
    variables = perturb(init(jax.random.PRNGKey(0)),
                        np.random.default_rng(7))
    cfg, state = RaftStereoConfig(**TINY), state_dict_from_jax(variables)
    jax_side = types.SimpleNamespace(
        name="jax", chaos=jchaos, batcher=jbatcher,
        make=lambda **kw: JaxService(jcfg, variables,
                                     JaxServeConfig(**kw)))
    port_side = types.SimpleNamespace(
        name="port", chaos=pchaos, batcher=pbatcher,
        make=lambda **kw: ServingEngine(cfg, state, ServeConfig(**kw),
                                        device="cpu"))
    solo = InferenceRunner(cfg, state, iters=ITERS, device="cpu")
    return dict(jax=jax_side, port=port_side, solo=solo)


def _pairs(n, hw=(48, 64), seed=3):
    rng = np.random.default_rng(seed)
    lefts = [rng.integers(0, 255, hw + (3,), dtype=np.uint8)
             for _ in range(n)]
    rights = [np.roll(l, -3, axis=1) for l in lefts]
    return lefts, rights


class _Sink:
    def __init__(self):
        self.fired = []

    def fire(self, kind, **detail):
        self.fired.append(kind)


def _both(sides, scenario):
    """``scenario(side)`` on the JAX engine, then on the port's; returns
    the two outcomes."""
    return scenario(sides["jax"]), scenario(sides["port"])


def test_chaos_crash_requeues_and_completes(sides):
    """An injected crash mid-dispatch requeues the request, a fresh worker
    takes it, and the answer is the solo runner's, bit for bit."""
    l, r = _pairs(1)
    want, _ = sides["solo"](l[0], r[0])

    def scenario(side):
        chaos = side.chaos.ChaosConfig(seed=1, crash_rate=1.0, max_faults=1)
        with side.make(**SOLO, chaos=chaos, max_dispatch_attempts=3,
                       retry_backoff_ms=1.0) as svc:
            res = svc.infer(l[0], r[0], timeout=300)
            m = svc.metrics
            return (res.attempts, m.retries.value, m.worker_restarts.value,
                    m.injected_faults("crash"), m.completed.value,
                    m.poisoned.value), res.flow

    (jout, _), (pout, flow) = _both(sides, scenario)
    assert pout == jout == (2, 1, 1, 1, 1, 0)
    assert np.array_equal(flow, want)


def test_poisoned_after_max_dispatch_attempts(sides):
    """A request that crashes on every bounded attempt fails alone with
    ``RequestPoisoned``; the engine goes on serving."""
    l, r = _pairs(1)

    def scenario(side):
        chaos = side.chaos.ChaosConfig(seed=1, crash_rate=1.0, max_faults=2)
        with side.make(**SOLO, chaos=chaos, max_dispatch_attempts=2,
                       retry_backoff_ms=1.0, breaker_failures=5,
                       breaker_cooldown_s=0.05) as svc:
            with pytest.raises(side.batcher.RequestPoisoned) as ei:
                svc.infer(l[0], r[0], timeout=300)
            assert isinstance(ei.value.last_error,
                              side.chaos.InjectedWorkerCrash)
            res = svc.infer(l[0], r[0], timeout=300)
            m = svc.metrics
            return (ei.value.attempts, m.poisoned.value, m.failed.value,
                    res.attempts, m.completed.value, m.retries.value,
                    m.worker_restarts.value)

    jout, pout = _both(sides, scenario)
    assert pout == jout == (2, 1, 1, 1, 1, 1, 2)


def test_breaker_opens_probes_half_open_and_closes(sides):
    """Two consecutive crashes open the worker's circuit; after the
    cooldown one half-open probe succeeds and the circuit closes, with
    every request answered: the same anomaly events, in the same order."""
    lefts, rights = _pairs(2)

    def scenario(side):
        sink = _Sink()
        chaos = side.chaos.ChaosConfig(seed=2, crash_rate=1.0, max_faults=2)
        with side.make(**SOLO, chaos=chaos, max_dispatch_attempts=4,
                       retry_backoff_ms=1.0, breaker_failures=2,
                       breaker_cooldown_s=0.1) as svc:
            svc.attach_anomaly_sink(sink)
            svc.prewarm((48, 64))
            results = [svc.infer(l, r, timeout=300)
                       for l, r in zip(lefts, rights)]
            assert svc.metrics.circuit_gauge(0).value == CIRCUIT_CLOSED
            return sink.fired, [x.attempts for x in results]

    jout, pout = _both(sides, scenario)
    assert pout == jout
    fired = pout[0]
    assert fired.index("circuit_closed") > fired.index("circuit_open")
    assert fired.count("worker_crash") == 2


@pytest.mark.parametrize("seed", [3, 5])
def test_every_admitted_request_ends_as_jax_does(sides, seed):
    """A 30% crash rate over twelve requests one at a time: every request
    ends with a result or ``RequestPoisoned``, each with JAX's outcome
    and attempts, and the ledger balances."""
    lefts, rights = _pairs(12, seed=seed)

    def scenario(side):
        chaos = side.chaos.ChaosConfig(seed=seed, crash_rate=0.3)
        outcomes = []
        with side.make(**SOLO, chaos=chaos, max_dispatch_attempts=2,
                       retry_backoff_ms=1.0, breaker_failures=100) as svc:
            for l, r in zip(lefts, rights):
                try:
                    outcomes.append(("ok", svc.infer(l, r,
                                                     timeout=300).attempts))
                except side.batcher.RequestPoisoned as e:
                    outcomes.append(("poisoned", e.attempts))
            m = svc.metrics
            assert (m.completed.value + m.poisoned.value
                    == m.admitted.value == len(lefts))
            return outcomes, m.injected_faults("crash"), m.retries.value

    jout, pout = _both(sides, scenario)
    assert pout == jout
    assert pout[1] > 0


def test_concurrent_chaos_every_request_ends(sides):
    """Four client threads through a crashing engine at batch sizes 1/2/4:
    every admitted request ends with a result or a typed error, none
    hangs, and every result is finite."""
    lefts, rights = _pairs(16, seed=8)
    chaos = pchaos.ChaosConfig(seed=4, crash_rate=0.25)
    outcomes = []
    lock = threading.Lock()
    with sides["port"].make(max_batch=4, batch_sizes=(1, 2, 4), iters=ITERS,
                            chaos=chaos, max_dispatch_attempts=2,
                            retry_backoff_ms=1.0,
                            breaker_failures=100) as svc:
        def client(idx):
            for i in idx:
                try:
                    res = svc.infer(lefts[i], rights[i], timeout=300)
                    ok = bool(np.isfinite(res.flow).all())
                    with lock:
                        outcomes.append("ok" if ok else "nan")
                except pbatcher.RequestPoisoned:
                    with lock:
                        outcomes.append("poisoned")

        threads = [threading.Thread(target=client, args=(range(k, 16, 4),))
                   for k in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        m = svc.metrics
        assert len(outcomes) == 16 and "nan" not in outcomes
        assert m.completed.value == outcomes.count("ok")
        assert m.poisoned.value == outcomes.count("poisoned")
        assert m.injected_faults("crash") > 0
        assert m.inflight.value == 0 and svc.queue.depth == 0


def test_stress_workers_and_clients_keep_the_ledger(sides):
    """Three CPU workers (each with its own programs), twelve client
    threads and a thread switch every 10 microseconds, under a 20% crash
    rate: every request ends once, the counters balance, nothing is left
    queued, in flight or in backoff."""
    lefts, rights = _pairs(4, seed=12)
    chaos = pchaos.ChaosConfig(seed=6, crash_rate=0.2)
    ends = []
    lock = threading.Lock()
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with sides["port"].make(max_batch=4, batch_sizes=(1, 2, 4),
                                iters=ITERS, data_parallel=3, chaos=chaos,
                                max_dispatch_attempts=3,
                                retry_backoff_ms=1.0,
                                breaker_failures=100) as svc:
            def client(k):
                for i in range(3):
                    try:
                        res = svc.infer(lefts[(k + i) % 4],
                                        rights[(k + i) % 4], timeout=300)
                        end = res.attempts
                    except pbatcher.RequestPoisoned as e:
                        end = -e.attempts
                    with lock:
                        ends.append(end)

            threads = [threading.Thread(target=client, args=(k,))
                       for k in range(12)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300)
            assert not any(t.is_alive() for t in threads)
            m = svc.metrics
            assert len(ends) == 36 == m.admitted.value
            assert m.completed.value + m.poisoned.value == 36
            assert m.completed.value == sum(1 for e in ends if e > 0)
            assert m.retries.value == sum(abs(e) - 1 for e in ends)
            assert svc.queue.depth == 0 and m.inflight.value == 0
            assert svc._pending_retry_count() == 0
            assert len({k[0] for k in svc.cached_programs()}) >= 2
    finally:
        sys.setswitchinterval(switch)


def test_no_chaos_dispatch_bit_equal_to_runner(sides):
    """Chaos unset, or configured with every rate 0, leaves the engine
    without an injector: the solo runner's answer and no recovery."""
    lefts, rights = _pairs(2)
    for chaos in (None, pchaos.ChaosConfig()):
        with sides["port"].make(**SOLO, chaos=chaos) as svc:
            assert svc.chaos is None
            for l, r in zip(lefts, rights):
                res = svc.infer(l, r, timeout=300)
                assert np.array_equal(res.flow, sides["solo"](l, r)[0])
                assert res.attempts == 1
            m = svc.metrics
            assert (m.retries.value == m.worker_restarts.value
                    == m.poisoned.value == 0)


BROWNOUT = dict(max_batch=1, batch_sizes=(1,), iters=4,
                tiers=("interactive:7.0:2", "balanced:3.0:2", "quality"),
                brownout=True, brownout_exempt_tiers=("interactive",),
                brownout_poll_s=3600.0)


def test_brownout_degrades_down_the_ladder_and_restores(sides):
    """A brownout level of 1, then a fleet floor of 2, then 0: a quality
    request runs one rung down, then two, then as asked; ``degradable=
    False`` and the exempt tier are never degraded.  The same tiers and
    counters as JAX's engine."""
    l, r = _pairs(1)

    def scenario(side):
        served = []
        with side.make(**BROWNOUT) as svc:
            assert svc.brownout.ladder == ("interactive", "balanced",
                                           "quality")

            def ask(tier, **kw):
                res = svc.infer(l[0], r[0], tier=tier, timeout=300, **kw)
                served.append((res.tier, res.requested_tier, res.degraded))

            ask("quality")
            with svc.brownout._lock:
                svc.brownout._set_level(1, "test")
            ask("quality")
            ask("quality", degradable=False)
            ask("interactive")
            with svc.brownout._lock:
                svc.brownout._set_level(0, "test")
            assert svc.set_brownout_floor(2) == 2
            ask("quality")
            assert svc.set_brownout_floor(0) == 0
            ask("quality")
            return (served, svc.metrics.degraded.value,
                    svc.metrics.brownout_level.value)

    jout, pout = _both(sides, scenario)
    assert pout == jout
    assert [s[0] for s in pout[0]] == ["quality", "balanced", "quality",
                                       "interactive", "interactive",
                                       "quality"]


def test_brownout_engages_under_pressure_and_restores_when_calm(sides):
    """Real pressure: a queue held at 7 of 8 engages brownout within its
    engage window and a quality request is degraded; once the queue
    drains the level restores after the calm window."""
    l, r = _pairs(1)
    kw = dict(BROWNOUT, max_queue=8, brownout_poll_s=0.01,
              brownout_engage_s=0.05, brownout_restore_s=0.1)
    with sides["port"].make(**kw) as svc:
        svc.queue.pause()
        held = [svc.submit(l[0], r[0], tier="interactive")
                for _ in range(7)]
        t_end = time.monotonic() + 30
        while svc.brownout.level == 0 and time.monotonic() < t_end:
            time.sleep(0.01)
        assert svc.brownout.level >= 1
        degraded = svc.submit(l[0], r[0], tier="quality")
        svc.queue.resume()
        res = degraded.result(timeout=300)
        assert res.degraded and res.requested_tier == "quality"
        assert res.tier in ("balanced", "interactive")
        assert all(f.result(timeout=300).tier == "interactive"
                   for f in held)
        t_end = time.monotonic() + 30
        while svc.brownout.level > 0 and time.monotonic() < t_end:
            time.sleep(0.01)
        assert svc.brownout.level == 0
        res = svc.infer(l[0], r[0], tier="quality", timeout=300)
        assert res.tier == "quality" and not res.degraded


def test_closed_engine_fails_backoff_requests_typed(sides):
    """``close`` during a retry backoff fails the bounced request with
    the draining ``Overloaded`` instead of stranding it."""
    l, r = _pairs(1)
    chaos = pchaos.ChaosConfig(seed=1, crash_rate=1.0, max_faults=1)
    svc = sides["port"].make(**SOLO, chaos=chaos, max_dispatch_attempts=3,
                             retry_backoff_ms=5000.0)
    fut = svc.submit(l[0], r[0])
    t_end = time.monotonic() + 30
    while svc._pending_retry_count() == 0 and time.monotonic() < t_end:
        time.sleep(0.005)
    assert svc._pending_retry_count() == 1
    svc.close()
    with pytest.raises(Overloaded) as e:
        fut.result(timeout=10)
    assert e.value.draining
    assert svc.breakers[0].state != CIRCUIT_OPEN
