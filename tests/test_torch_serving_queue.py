"""The port's serving policies against the JAX package's (CPU, no model).

The scheduler (``BucketQueue``, ``pick_batch_size``, ``decompose_batch``,
EDF), ``BucketPolicy``, the circuit breaker, brownout, the cost ladder,
chaos injection and ``ServingMetrics`` are pure Python in both packages.
Two kinds of test hold the port to the JAX package here:

* every scheduler test of ``tests/test_serving.py`` (the queue, bucket
  policy and metrics tests), every test of ``tests/test_edf.py`` and the
  policy tests of ``tests/test_resilience.py`` run again with their
  module's names bound to the port's objects (``_port_twin``): the same
  scenario, the same assertions, the port's code;
* the same request streams, clocks, seeds and observations go through
  both packages' objects, and what comes out is compared: the pops as
  request indices, the chaos schedule, the breaker's transitions,
  brownout's levels, the buckets, and the Prometheus text byte for byte.
"""

import importlib
import inspect
import os
import sys
import types
from concurrent.futures import Future

import numpy as np
import pytest

from raft_stereo_tpu import config as jconfig
from raft_stereo_tpu.serving import batcher as jbatcher
from raft_stereo_tpu.serving import chaos as jchaos
from raft_stereo_tpu.serving import metrics as jmetrics
from raft_stereo_tpu.serving import resilience as jresilience
from raft_stereo_tpu.serving.engine import BucketPolicy as JaxBucketPolicy
from raft_stereo_tpu_torch import config as pconfig
from raft_stereo_tpu_torch.serving import batcher as pbatcher
from raft_stereo_tpu_torch.serving import chaos as pchaos
from raft_stereo_tpu_torch.serving import metrics as pmetrics
from raft_stereo_tpu_torch.serving import resilience as presilience
from raft_stereo_tpu_torch.serving.engine import BucketPolicy, ServeConfig

TESTS = os.path.dirname(os.path.abspath(__file__))


# ------------------------------------------------------------ port twins
def _twin_of(obj):
    """The port's object of the same name where ``obj`` comes from the
    JAX package (a module, a class or a function), else ``obj``."""
    if isinstance(obj, types.ModuleType):
        name = obj.__name__
        if name.startswith("raft_stereo_tpu."):
            return importlib.import_module(
                "raft_stereo_tpu_torch." + name[len("raft_stereo_tpu."):])
        return obj
    mod = getattr(obj, "__module__", None) or ""
    if mod.startswith("raft_stereo_tpu.") and hasattr(obj, "__name__"):
        port = importlib.import_module(
            "raft_stereo_tpu_torch." + mod[len("raft_stereo_tpu."):])
        return getattr(port, obj.__name__)
    return obj


def _port_twin(module_name: str, test_name: str):
    """``test_name`` of the JAX test module ``module_name`` with every
    name of its module bound to the port's objects (its helpers too)."""
    sys.path.insert(0, TESTS)
    try:
        mod = importlib.import_module(module_name)
    finally:
        sys.path.remove(TESTS)
    fn = getattr(mod, test_name)
    source = inspect.getsource(fn)
    assert "import raft_stereo_tpu" not in source and \
        "from raft_stereo_tpu" not in source, \
        f"{test_name} imports inside its body; write its counterpart out"
    g = {k: _twin_of(v) for k, v in vars(mod).items()}
    for k, v in list(g.items()):
        if isinstance(v, types.FunctionType) and v.__module__ == module_name:
            g[k] = types.FunctionType(v.__code__, g, v.__name__,
                                      v.__defaults__, v.__closure__)
    return g[test_name]


SERVING_SCHEDULER_TESTS = [
    "test_pick_batch_size_selects_largest_filled_bucket",
    "test_decompose_batch_greedy_no_filler",
    "test_queue_pop_selects_batch_size_from_depth",
    "test_queue_groups_by_shape_bucket_oldest_first",
    "test_queue_continuous_dispatch_no_timer_stall",
    "test_queue_pause_stages_exact_depth",
    "test_queue_deadline_rejection_at_pop",
    "test_queue_full_sheds_with_typed_overloaded",
    "test_queue_drain_waits_for_consumers_then_refuses",
    "test_queue_close_fails_orphans",
    "test_queue_validates_batch_sizes",
    "test_bucket_policy_static_is_reference_padding",
    "test_bucket_policy_refines_on_measured_waste",
    "test_metrics_exposition_and_percentiles",
    "test_metrics_dispatch_size_family",
]

EDF_TESTS = [
    "test_edf_key_orders_deadlines_and_enqueue_stamps",
    "test_edf_slack_end_never_exceeds_nearest_deadline_minus_latency",
    "test_edf_slack_end_caps_at_head_age_plus_max_slack",
    "test_edf_slack_end_no_deadlines_means_no_wait",
    "test_edf_pop_orders_earliest_deadline_first",
    "test_edf_expired_requests_still_triage_drop",
    "test_edf_no_starvation_of_deadline_less_behind_stream_flood",
    "test_edf_pop_waits_slack_and_coalesces_into_larger_batch",
    "test_edf_slack_expiry_dispatches_partial_batch",
    "test_edf_latency_fn_reserves_dispatch_time_before_deadline",
    "test_policy_off_pop_path_pinned",
    "test_edf_respects_want_filter_and_sizes",
    "test_edf_config_knob_validation",
]

RESILIENCE_POLICY_TESTS = [
    "test_chaos_injector_is_deterministic_per_stream",
    "test_chaos_injector_respects_device_targeting_and_budget",
    "test_chaos_resource_exhausted_message_matches_xla",
    "test_parse_chaos_spec",
    "test_circuit_breaker_state_machine",
    "test_brownout_engages_on_saturation_and_restores_with_hysteresis",
    "test_brownout_engages_on_deadline_miss_rate",
    "test_requeue_rejoins_ahead_of_fresh_requests",
    "test_requeue_dedups_and_skips_resolved_requests",
    "test_requeue_interleaves_with_fresh_by_tier_group",
    "test_requeue_allowed_while_draining_but_not_closed",
]


@pytest.mark.parametrize("name", SERVING_SCHEDULER_TESTS)
def test_serving_scheduler_counterpart(name):
    _port_twin("test_serving", name)()


@pytest.mark.parametrize("name", EDF_TESTS)
def test_edf_counterpart(name):
    _port_twin("test_edf", name)()


@pytest.mark.parametrize("name", RESILIENCE_POLICY_TESTS)
def test_resilience_policy_counterpart(name):
    _port_twin("test_resilience", name)()


def test_twins_bind_the_port():
    fn = _port_twin("test_serving", "test_queue_pop_selects_batch_size_"
                    "from_depth")
    assert fn.__globals__["BucketQueue"] is pbatcher.BucketQueue
    assert fn.__globals__["_req"].__globals__["Request"] is pbatcher.Request
    assert _twin_of(jmetrics.ServingMetrics) is pmetrics.ServingMetrics
    assert _twin_of(JaxBucketPolicy) is BucketPolicy


def test_chaos_off_by_default():
    assert ServeConfig().chaos is None
    assert not pchaos.ChaosConfig().enabled
    assert pchaos.ChaosConfig(crash_rate=0.1).enabled


def test_cost_ladder_orders_cheapest_first():
    tiers = [pconfig.parse_tier(s) for s in
             ("quality", "interactive", "balanced")]
    assert presilience.cost_ladder(tiers) == [
        "interactive", "balanced", "quality"]
    inline = [pconfig.parse_tier(s) for s in ("a:0.2", "b:0.5", "c:0")]
    assert presilience.cost_ladder(inline) == ["b", "a", "c"]


# --------------------------------------------------- request tiers
@pytest.mark.parametrize("spec", [
    "interactive", "balanced", "quality", "turbo", "fast:0.1",
    "fast:0.1:2", "fast8:0.1:2:int8", "mx:0.2:3:int8_mxu", "zero:0"])
def test_parse_tier_matches_jax(spec):
    j, p = jconfig.parse_tier(spec), pconfig.parse_tier(spec)
    assert (p.name, p.exit_threshold_px, p.min_iters, p.quant) == (
        j.name, j.exit_threshold_px, j.min_iters, j.quant)
    jc = j.apply(jconfig.RaftStereoConfig())
    pc = p.apply(pconfig.RaftStereoConfig())
    for f in ("exit_threshold_px", "exit_min_iters", "exit_max_iters",
              "quant"):
        assert getattr(pc, f) == getattr(jc, f)
    assert sorted(pconfig.REQUEST_TIERS) == sorted(jconfig.REQUEST_TIERS)


@pytest.mark.parametrize("spec", ["nope", "a:b", "a:0.1:x", "a:0.1:2:int4",
                                  ":0.1", "a:1:2:int8:extra"])
def test_parse_tier_errors_match_jax(spec):
    with pytest.raises(ValueError) as je:
        jconfig.parse_tier(spec)
    with pytest.raises(ValueError) as pe:
        pconfig.parse_tier(spec)
    assert str(pe.value) == str(je.value)


def test_cost_ladder_matches_jax():
    specs = ("quality", "interactive", "balanced", "turbo", "a:0.2",
             "b:0.5:2", "c:0")
    assert presilience.cost_ladder(
        [pconfig.parse_tier(s) for s in specs]) == jresilience.cost_ladder(
        [jconfig.parse_tier(s) for s in specs])


# ------------------------------------------------ same streams, both sides
class _Clock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


def _stream(mod, rng, n, clock, deadlines=False):
    """n requests over 3 buckets x 2 tiers, enqueue stamps rising, some
    with deadlines; the payload is the request's index."""
    out = []
    for i in range(n):
        bucket = [(64, 96), (96, 128), (128, 128)][rng.integers(3)]
        tier = [None, "interactive"][rng.integers(2)]
        deadline = None
        if deadlines and rng.random() < 0.6:
            deadline = clock.t + float(rng.uniform(0.5, 5.0))
        out.append(mod.Request(bucket=bucket, payload=i, future=Future(),
                               t_enqueue=clock.t - (n - i) * 1e-3,
                               deadline=deadline, tier=tier))
    return out


@pytest.mark.parametrize("edf", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pop_sequence_matches_jax(edf, seed):
    """One random stream (buckets, tiers, deadlines) through both queues on
    one fake clock: the same batches, as request indices, and the same
    depth and inflight counts after each pop.  EDF runs with zero slack so
    no pop waits on the wall clock."""
    pops = []
    for mod in (jbatcher, pbatcher):
        rng = np.random.default_rng(seed)
        clock = _Clock()
        q = mod.BucketQueue(max_batch=8, batch_sizes=(1, 2, 4, 8),
                            max_queue=64, clock=clock, edf=edf,
                            edf_max_slack_s=0.0)
        for r in _stream(mod, rng, 40, clock, deadlines=True):
            q.submit(r)
        seq = []
        while q.depth:
            clock.t += 0.4          # some deadlines pass: triage
            b = q.pop(timeout=0)
            if b is None:
                break
            seq.append(([r.payload for r in b], q.depth,
                        q.metrics.inflight.value,
                        q.metrics.deadline_missed.value))
        q.close()
        pops.append(seq)
    assert pops[0] == pops[1]
    assert len(pops[0]) > 5


def test_requeue_and_drain_sequence_matches_jax():
    """Pops, a crashed batch requeued among fresh work, draining, and the
    close that fails the orphans: the same indices and the same failures
    on both sides."""
    outs = []
    for mod in (jbatcher, pbatcher):
        rng = np.random.default_rng(5)
        clock = _Clock()
        q = mod.BucketQueue(max_batch=4, batch_sizes=(1, 2, 4),
                            max_queue=12, clock=clock)
        reqs = _stream(mod, rng, 12, clock)
        shed = 0
        for r in reqs + _stream(mod, rng, 3, clock):
            try:
                q.submit(r)
            except mod.Overloaded:
                shed += 1
        first = q.pop(timeout=0)
        q.requeue(first)
        seq = [[r.payload for r in q.pop(timeout=0)] for _ in range(2)]
        q.stop_admitting()
        try:
            q.submit(_stream(mod, rng, 1, clock)[0])
        except mod.Overloaded as e:
            draining = e.draining
        q.close()
        orphans = sum(1 for r in reqs if r.future.done()
                      and isinstance(r.future.exception(), mod.Overloaded))
        outs.append((shed, [r.payload for r in first], seq, draining,
                     orphans, q.metrics.render_text()))
    assert outs[0] == outs[1]


@pytest.mark.parametrize("seed", [3, 7])
def test_chaos_schedule_matches_jax(seed):
    """One seed, the same call sequence on every site and two workers:
    the same faults, kinds and budgets on both sides."""
    kw = dict(seed=seed, crash_rate=0.1, resource_exhausted_rate=0.05,
              compile_failure_rate=0.05, latency_rate=0.1, latency_ms=0.0,
              max_faults=25)
    logs = []
    for mod in (jchaos, pchaos):
        inj = mod.ChaosInjector(mod.ChaosConfig(**kw))
        log = []
        for i in range(300):
            w = i % 2
            for site in ("on_compile", "on_dispatch"):
                try:
                    getattr(inj, site)(w)
                    log.append(None)
                except mod.InjectedFault as e:
                    log.append(type(e).__name__)
        logs.append((log, inj.faults_injected))
    assert logs[0] == logs[1]
    assert logs[0][1] > 0


@pytest.mark.parametrize("spec", [
    None, "", "crash=0.1,seed=7", "crash=0.1,seed=7,latency_ms=50,"
    "latency=0.2,devices=0|2,max_faults=5", "oom=0.3,compile=0.2",
    "die_after=4,blackhole_after_s=2,slow_start_s=1.5"])
def test_parse_chaos_spec_matches_jax(spec):
    j, p = jchaos.parse_chaos_spec(spec), pchaos.parse_chaos_spec(spec)
    if j is None:
        assert p is None
        return
    import dataclasses
    assert dataclasses.asdict(p) == dataclasses.asdict(j)


def test_breaker_transitions_match_jax():
    """A random success/failure sequence on one fake clock: the same
    states, waits and transitions."""
    runs = []
    for mod in (jresilience, presilience):
        rng = np.random.default_rng(11)
        clock = [0.0]
        seen = []
        br = mod.CircuitBreaker(failure_threshold=3, cooldown_s=1.0,
                                clock=lambda: clock[0],
                                on_state=lambda o, n, f: seen.append(
                                    (o, n, f)))
        states = []
        for _ in range(200):
            clock[0] += float(rng.uniform(0, 0.5))
            wait = br.until_allowed()
            if wait == 0.0:
                if rng.random() < 0.45:
                    br.record_failure()
                else:
                    br.record_success()
            states.append((br.state, round(wait, 9)))
        runs.append((states, seen))
    assert runs[0] == runs[1]
    assert len(runs[0][1]) >= 4


class _FakeValue:
    def __init__(self):
        self.value = 0


class _FakeMetrics:
    def __init__(self):
        self.queue_depth = _FakeValue()
        self.admitted = _FakeValue()
        self.deadline_missed = _FakeValue()


def test_brownout_levels_match_jax():
    """The same queue-depth and deadline-miss signal on one fake clock:
    the same levels, floors and degradations."""
    runs = []
    for mod in (jresilience, presilience):
        rng = np.random.default_rng(2)
        clock = [0.0]
        m = _FakeMetrics()
        bc = mod.BrownoutController(
            m, max_queue=10, ladder=["turbo", "interactive", "quality"],
            engage_fraction=0.8, engage_s=0.5, restore_fraction=0.2,
            restore_s=1.0, clock=lambda: clock[0])
        levels = []
        for i in range(300):
            clock[0] += 0.1
            # saturated and calm phases with noise
            base = 9 if (i // 40) % 2 == 0 else 1
            m.queue_depth.value = int(np.clip(base + rng.integers(-1, 2),
                                              0, 10))
            m.admitted.value += 2
            m.deadline_missed.value += int(rng.integers(0, 2))
            if i == 150:
                bc.set_floor(1)
            if i == 220:
                bc.set_floor(0)
            levels.append((bc.check(), bc.level, bc.degrade("quality"),
                           bc.degrade("interactive"), bc.degrade(None)))
        runs.append(levels)
    assert runs[0] == runs[1]
    assert {lv[1] for lv in runs[0]} >= {0, 1, 2}


def test_bucket_policy_matches_jax():
    """Random shapes and waste notes through both adaptive policies: the
    same buckets and refinements."""
    rng = np.random.default_rng(4)
    pols = [cls(grids=(128, 64, 32), max_waste=0.1)
            for cls in (JaxBucketPolicy, BucketPolicy)]
    for _ in range(200):
        h, w = (int(x) for x in rng.integers(20, 700, size=2))
        got = [p.bucket_for(h, w) for p in pols]
        assert got[0] == got[1]
        hp, wp, _ = got[0]
        for p in pols:
            p.note((hp, wp), real_px=h * w, dispatched_px=hp * wp)
    assert pols[0].refined_buckets == pols[1].refined_buckets
    assert pols[0].refined_buckets


def _observe(mod):
    """The same observations on a fresh ``ServingMetrics`` of ``mod``."""
    sm = mod.ServingMetrics(max_batch=8)
    sm.admitted.inc(7)
    sm.completed.inc(5)
    sm.rejected_queue_full.inc(2)
    sm.queue_depth.set(3)
    sm.inflight.inc(2)
    for n in (1, 2, 4, 4, 8):
        sm.observe_dispatch(n)
    sm.observe_iters_used("interactive", 3, 7, n_requests=2)
    sm.observe_iters_used("default", 7, 7, n_requests=1)
    sm.observe_padding((384, 1248), 375 * 1242, 384 * 1248)
    sm.observe_padding((64, 64), 48 * 64, 2 * 64 * 64)
    sm.observe_injected_fault("worker_crash")
    sm.circuit_gauge(0).set(0)
    for v in (0.001, 0.02, 0.3, 4.0):
        sm.queue_wait.observe(v)
        sm.total_latency.observe(v * 2)
        sm.device_time.observe(v / 2)
        sm.fetch_time.observe(v / 4)
    sm.degraded.inc()
    sm.retries.inc(2)
    sm.poisoned.inc()
    sm.failed.inc()
    sm.worker_restarts.inc()
    sm.compiles_cold.inc(3)
    sm.brownout_level.set(1)
    return sm.render_text()


def test_serving_metrics_text_byte_equal_to_jax():
    text = _observe(pmetrics)
    assert text == _observe(jmetrics)
    assert "serve_requests_admitted_total 7" in text
    assert 'serve_dispatches_total{batch="4"} 2' in text
