"""The port's serving engine on the CPU, against its own runner and against
the JAX package's engine.

Both packages serve the ``TINY`` model of ``tests/test_serving.py``
(``corr_backend="reg"``) on one set of weights: Flax init, norm leaves
perturbed (``torch_port_support.perturb``), carried by
``state_dict_from_jax``.  Pairs are seeded numpy images at 48x64 (bucket
64x64), or golden_data's textured frames at 60x90 for the exit tier.

Tolerances.  Batch 1 runs the solo runner's program: bit-equal.  Batch N
runs another batch axis: 5e-4 px of the solo answer, the JAX engine's own
bound (``tests/test_serving.py``).  Port against the JAX engine: 2e-3 px,
the whole-forward bound of ``tests/test_torch_model.py``.  ``iters_used``
under an exit tier: equal, the threshold taken at the midpoint of two of
JAX's own per-iteration deltas at least 10% apart (as
``tests/test_torch_early_exit.py`` takes it).  Confidence: 12 x 2e-3 (the
derivation in ``tests/test_torch_early_exit.py``).  The ``turbo`` tier
(``int8_mxu`` with the exit): JAX's own two routes (its jitted engine and
its eager forward) differ where an fp32 value straddles a code boundary
(ROADMAP §C6), so the port is held to 3x that spread, max and mean, as
``tests/test_torch_quant.py`` holds ``int8_mxu`` to 3x a JAX spread, and to
no less than 2e-3 px.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golden_data import disparity_field, textured_image, warp_right
from raft_stereo_tpu.config import RaftStereoConfig as JaxConfig
from raft_stereo_tpu.models.raft_stereo import RAFTStereo as JaxRAFTStereo
from raft_stereo_tpu.quant import quantize_variables
from raft_stereo_tpu.serving import ServeConfig as JaxServeConfig
from raft_stereo_tpu.serving import StereoService as JaxService
from raft_stereo_tpu_torch.config import RaftStereoConfig
from raft_stereo_tpu_torch.eval.runner import InferenceRunner
from raft_stereo_tpu_torch.io.jax_weights import state_dict_from_jax
from raft_stereo_tpu_torch.serving import (Overloaded, ServeConfig,
                                           ServingEngine, StereoService)
from raft_stereo_tpu_torch.serving.engine import DEFERRED_FIELDS
from torch_port_support import perturb, settle_jax

TINY = dict(hidden_dims=(32, 32, 32), fnet_dim=64, corr_backend="reg")
ITERS = 1
BATCH_ATOL = 5e-4
FLOW_ATOL = 2e-3
CONF_ATOL = 12 * FLOW_ATOL
SPREAD_FACTOR = 3.0


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    """(JAX config, JAX variables, port config, port state dict)."""
    jcfg = JaxConfig(**TINY)
    jmodel = JaxRAFTStereo(jcfg)
    dummy = jnp.zeros((1, 64, 64, 3), jnp.float32)
    init = jax.jit(lambda key: jmodel.init(key, dummy, dummy, iters=1,
                                           test_mode=True))
    variables = perturb(init(jax.random.PRNGKey(0)),
                        np.random.default_rng(7))
    return jcfg, variables, RaftStereoConfig(**TINY), state_dict_from_jax(
        variables)


def _pairs(n, hw=(48, 64), seed=3):
    rng = np.random.default_rng(seed)
    lefts = [rng.integers(0, 255, hw + (3,), dtype=np.uint8)
             for _ in range(n)]
    rights = [np.roll(l, -3, axis=1) for l in lefts]
    return lefts, rights


def _staged(svc, lefts, rights, **kw):
    """Submit with the queue paused, then release: the first pop sees the
    whole depth, so the batch sizes are known."""
    svc.queue.pause()
    futures = [svc.submit(l, r, **kw) for l, r in zip(lefts, rights)]
    svc.queue.resume()
    return [f.result(timeout=120) for f in futures]


def _engine(weights, **kw):
    _, _, cfg, state = weights
    return ServingEngine(cfg, state, ServeConfig(iters=ITERS, **kw),
                         device="cpu")


# --------------------------------------------------------- against itself
def test_batch1_bit_equal_to_runner_and_ladder_within_bound(weights):
    """Batch 1 is the runner's program, bit for bit; each rung of the
    1/2/4/8 ladder runs as ONE dispatch of that size, within 5e-4 px of
    the solo answer."""
    _, _, cfg, state = weights
    solo = InferenceRunner(cfg, state, iters=ITERS, device="cpu")
    lefts, rights = _pairs(8)
    expect = [solo(l, r)[0] for l, r in zip(lefts, rights)]
    with _engine(weights) as svc:
        assert svc.queue.sizes == (1, 2, 4, 8)
        for l, r, want in zip(lefts[:2], rights[:2], expect):
            res = svc.infer(l, r, timeout=120)
            assert res.batch_size == 1 and res.iters_used == ITERS
            assert np.array_equal(res.flow, want)
            np.testing.assert_array_equal(res.disparity, -res.flow)
        for k in (2, 4, 8):
            before = svc.metrics.dispatches_at(k)
            results = _staged(svc, lefts[:k], rights[:k])
            assert [r.batch_size for r in results] == [k] * k
            assert svc.metrics.dispatches_at(k) == before + 1
            for res, want in zip(results, expect):
                np.testing.assert_allclose(res.flow, want, atol=BATCH_ATOL,
                                           rtol=0)


def test_batch_rows_bit_equal_to_the_runners_run_batch(weights):
    """A batch of distinct pairs is the runner's program at that batch
    size: each row equals the runner's ``run_batch`` row of the same
    stack, bit for bit."""
    _, _, cfg, state = weights
    lefts, rights = _pairs(4, seed=11)
    want, _ = InferenceRunner(cfg, state, iters=ITERS,
                              device="cpu").run_batch(lefts, rights)
    with _engine(weights, batch_sizes=(1, 4), max_batch=4) as svc:
        results = _staged(svc, lefts, rights)
    assert [r.batch_size for r in results] == [4] * 4
    for res, row in zip(results, want):
        assert np.array_equal(res.flow, row)


def test_program_cache_evicts_oldest_and_get_refreshes():
    """The runner's and the engine's LRU: ``get`` makes an entry the
    newest, ``add`` past the limit drops the oldest and reports it."""
    from raft_stereo_tpu_torch.eval.runner import PlainForward, ProgramCache

    evicted = []
    programs = ProgramCache(torch.device("cpu"), 2,
                            on_evict=lambda cache, key: evicted.append(key))
    cache = programs.lru()
    for key in ("a", "b"):
        programs.add(cache, key, None, (), None, False)
    assert ProgramCache.get(cache, "a") is cache["a"]
    assert ProgramCache.get(cache, "z") is None
    entry = programs.add(cache, "c", None, (), None, False)
    assert isinstance(entry, PlainForward)
    assert evicted == ["b"] and list(cache) == ["a", "c"]


def test_partial_batches_decompose_without_filler(weights):
    """7 queued -> 4 + 2 + 1: three dispatches for seven requests, no
    batch padded up."""
    lefts, rights = _pairs(7)
    with _engine(weights) as svc:
        d0 = svc.metrics.batches.value
        results = _staged(svc, lefts, rights)
        assert svc.metrics.batches.value - d0 == 3
        assert sorted(r.batch_size for r in results) == [1, 2, 2, 4, 4, 4, 4]
        assert svc.metrics.batches.value < svc.metrics.completed.value
        assert svc.metrics.batch_occupancy.count == svc.metrics.batches.value


def test_overload_sheds_typed_then_drain_finishes_and_refuses(weights):
    """A burst past ``max_queue`` sheds with ``Overloaded`` while every
    admitted request completes; ``drain`` finishes the queue, then
    refuses with the draining flavour."""
    lefts, rights = _pairs(10)
    svc = _engine(weights, max_queue=4)
    svc.queue.pause()
    admitted, shed = [], 0
    for l, r in zip(lefts, rights):
        try:
            admitted.append(svc.submit(l, r))
        except Overloaded as e:
            assert not e.draining
            shed += 1
    assert (len(admitted), shed) == (4, 6)
    assert svc.metrics.rejected_queue_full.value == 6
    svc.queue.resume()
    assert svc.drain(timeout=120)
    assert all(f.result(timeout=1).flow.shape == (48, 64) for f in admitted)
    with pytest.raises(Overloaded) as e:
        svc.submit(lefts[0], rights[0])
    assert e.value.draining
    assert not svc.ready


def test_begin_shutdown_keeps_serving_admitted_work(weights):
    lefts, rights = _pairs(3)
    svc = _engine(weights)
    svc.queue.pause()
    futures = [svc.submit(l, r) for l, r in zip(lefts, rights)]
    svc.begin_shutdown()
    assert not svc.ready
    with pytest.raises(Overloaded):
        svc.submit(lefts[0], rights[0])
    svc.queue.resume()
    assert svc.drain(timeout=120)
    assert all(f.done() and f.exception() is None for f in futures)


def test_prewarm_builds_the_ladder_once_per_distinct_tier_program(weights):
    """``quality`` shares the base programs; ``interactive`` (exit) and
    ``turbo`` (int8 + exit) have their own: 3 programs x 4 batch sizes.
    ``ready`` opens only after the declared surface is warm, and the
    tier models hold the base model's fp32 tensors, not copies."""
    svc = _engine(weights, tiers=("quality", "interactive", "turbo"),
                  warmup_shapes=((48, 64),), prewarm_on_init=False)
    try:
        assert svc._distinct_cache_tiers() == [None, "interactive", "turbo"]
        assert svc.tier_model("quality") is svc.model
        inter = dict(svc.tier_model("interactive").named_parameters())
        for name, p in svc.model.named_parameters():
            assert inter[name] is p
        assert svc.tier_model("turbo").config.quant == "int8_mxu"
        assert not svc.ready
        assert svc.warm_status()["warm_target"] == 12
        svc.prewarm((48, 64))
        assert svc.ready and svc.warm_status()["warm_done"] == 12
        assert len(svc.cached_programs()) == 12
        assert svc.metrics.compiles_cold.value == 12
        l, r = _pairs(1)
        svc.infer(l[0], r[0], tier="quality", timeout=60)
        assert svc.metrics.compiles_cold.value == 12   # a cache hit
    finally:
        svc.close()


def test_lru_evicts_past_max_cached_shapes(weights):
    with _engine(weights, max_cached_shapes=2, batch_sizes=(1,),
                 max_batch=1) as svc:
        for hw in ((48, 64), (80, 64), (48, 96)):
            l, r = _pairs(1, hw=hw)
            svc.infer(l[0], r[0], timeout=60)
        assert [k[1] for k in svc.cached_programs()] == [(96, 64), (64, 96)]


def test_unknown_tier_model_and_pseudo_tiers_are_typed(weights):
    from raft_stereo_tpu_torch.serving import ModelUnknown, SessionsDisabled
    l, r = _pairs(1)
    with _engine(weights, tiers=("quality", "interactive")) as svc:
        with pytest.raises(ValueError, match="unknown tier"):
            svc.submit(l[0], r[0], tier="nope")
        for pseudo in ("auto", "xl"):
            with pytest.raises(ValueError, match=f"tier '{pseudo}'"):
                svc.submit(l[0], r[0], tier=pseudo)
        with pytest.raises(ModelUnknown):
            svc.submit(l[0], r[0], model="m")
        with pytest.raises(SessionsDisabled):
            svc.infer_session("s", l[0], r[0])
        with pytest.raises(ValueError, match="same-shape"):
            svc.submit(l[0], r[0][:, :32])


def test_engine_without_device_needs_a_card(weights):
    _, _, cfg, state = weights
    if torch.cuda.is_available():
        pytest.skip("checks the host without a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(cfg, state, ServeConfig(iters=ITERS))


# ------------------------------------------------ against the JAX engine
def test_flows_match_jax_engine(weights):
    """Each answer within 2e-3 px of the JAX engine's on the same weights
    and pairs, at batch 1 and at batch 4."""
    jcfg, variables, _, _ = weights
    lefts, rights = _pairs(4, seed=9)
    with JaxService(jcfg, variables, JaxServeConfig(iters=ITERS)) as js:
        want1 = [js.infer(l, r, timeout=300).flow
                 for l, r in zip(lefts, rights)]
        want4 = [x.flow for x in _staged(js, lefts, rights)]
    with _engine(weights) as svc:
        got1 = [svc.infer(l, r, timeout=120) for l, r in zip(lefts, rights)]
        got4 = _staged(svc, lefts, rights)
    assert [g.batch_size for g in got4] == [4] * 4
    for g, w in zip(got1 + got4, want1 + want4):
        np.testing.assert_allclose(g.flow, w, atol=FLOW_ATOL, rtol=0)


@pytest.fixture(scope="module")
def settled():
    """The settling GRU (updates shrink by 0.73 an iteration), two 60x90
    pairs (hard: textured; easy: low contrast) and JAX's per-iteration
    deltas of each at fixed depth."""
    jcfg = JaxConfig(**TINY)
    jmodel = JaxRAFTStereo(jcfg)
    dummy = jnp.zeros((1, 64, 96, 3), jnp.float32)
    init = jax.jit(lambda key: jmodel.init(key, dummy, dummy, iters=1,
                                           test_mode=True))
    variables = settle_jax(perturb(init(jax.random.PRNGKey(0)),
                                   np.random.default_rng(7)))
    rng = np.random.default_rng(0)
    pairs = []
    for contrast in (1.0, 0.2):
        left = textured_image(rng, 60, 90)
        right = warp_right(left, disparity_field(rng, 60, 90))
        if contrast != 1.0:
            left, right = (np.clip(x * contrast + 100, 0, 255).astype(
                np.uint8) for x in (left, right))
        pairs.append((left, right))
    pad = lambda x: np.pad(x, ((2, 2), (3, 3), (0, 0)), mode="edge")
    l = jnp.asarray(np.stack([pad(p[0]) for p in pairs]), jnp.float32)
    r = jnp.asarray(np.stack([pad(p[1]) for p in pairs]), jnp.float32)
    lows = [np.asarray(jmodel.apply(variables, l, r, iters=k,
                                    test_mode=True, unroll_gru=True)[0])
            for k in range(5)]
    deltas = np.stack([np.abs(b - a).mean(axis=(1, 2))
                       for a, b in zip(lows, lows[1:])])   # (4, 2)
    return dict(jcfg=jcfg, variables=variables,
                state=state_dict_from_jax(variables), pairs=pairs,
                deltas=deltas)


def test_exit_tier_iters_used_and_confidence_match_jax(settled):
    """An exit tier whose threshold splits the easy pair's deltas from the
    hard pair's: at batch 1 each pair runs JAX's trip count, its flow
    within 2e-3 px and its confidence within 12 x 2e-3 of JAX's engine;
    the fixed-depth tier runs the cap."""
    d = settled["deltas"]                          # (cap, pair)
    cap = d.shape[0]

    def stops(thr):
        return [next((k + 1 for k in range(cap) if d[k, i] < thr), cap)
                for i in range(d.shape[1])]

    vals = np.sort(d.ravel())
    thr = next((a + b) / 2 for a, b in zip(vals, vals[1:])
               if b >= 1.1 * a and len(set(stops((a + b) / 2))) == 2
               and max(stops((a + b) / 2)) < cap)
    expect = stops(thr)
    tiers = ("quality", f"fast:{thr}:1")
    kw = dict(iters=4, tiers=tiers, confidence=True)
    want = {}
    with JaxService(settled["jcfg"], settled["variables"],
                    JaxServeConfig(**kw)) as js:
        for name in ("quality", "fast"):
            want[name] = [js.infer(l, r, tier=name, timeout=300)
                          for l, r in settled["pairs"]]
    with ServingEngine(RaftStereoConfig(**TINY), settled["state"],
                       ServeConfig(**kw), device="cpu") as svc:
        for name in ("quality", "fast"):
            got = [svc.infer(l, r, tier=name, timeout=120)
                   for l, r in settled["pairs"]]
            for g, w in zip(got, want[name]):
                assert g.tier == w.tier == name
                assert g.iters_used == w.iters_used
                np.testing.assert_allclose(g.flow, w.flow, atol=FLOW_ATOL,
                                           rtol=0)
                np.testing.assert_allclose(g.confidence, w.confidence,
                                           atol=CONF_ATOL, rtol=0)
                assert abs(g.confidence_mean - w.confidence_mean) \
                    <= CONF_ATOL
        assert [g.iters_used for g in got] == expect
        assert [w.iters_used for w in want["quality"]] == [cap, cap]


def test_turbo_tier_matches_runner_and_jax(weights):
    """``turbo`` at batch 1 is the port runner's ``int8_mxu`` exit program
    bit for bit, and lies within 3x JAX's own jit-vs-eager spread of the
    JAX engine's answer (no less than 2e-3 px)."""
    jcfg, variables, cfg, state = weights
    lefts, rights = _pairs(2, seed=5)
    with JaxService(jcfg, variables,
                    JaxServeConfig(iters=ITERS, tiers=("quality", "turbo"))
                    ) as js:
        want = [js.infer(l, r, tier="turbo", timeout=300).flow
                for l, r in zip(lefts, rights)]
    tcfg = dataclasses.replace(jcfg, quant="int8_mxu",
                               exit_threshold_px=0.05, exit_min_iters=2)
    jq = quantize_variables(variables)
    eager = []
    for l, r in zip(lefts, rights):
        pad = lambda x: np.pad(x, ((8, 8), (0, 0), (0, 0)), mode="edge")
        out = JaxRAFTStereo(tcfg).apply(
            jq, jnp.asarray(pad(l)[None], jnp.float32),
            jnp.asarray(pad(r)[None], jnp.float32), iters=ITERS,
            test_mode=True)
        eager.append(np.asarray(out[1])[0, 8:-8])
    runner = InferenceRunner(cfg, state, iters=ITERS, device="cpu",
                             quant="int8_mxu", exit_threshold_px=0.05,
                             exit_min_iters=2)
    with _engine(weights, tiers=("quality", "turbo")) as svc:
        got = [svc.infer(l, r, tier="turbo", timeout=120)
               for l, r in zip(lefts, rights)]
    for g, w, e, l, r in zip(got, want, eager, lefts, rights):
        assert g.tier == "turbo" and g.iters_used == ITERS
        assert np.array_equal(g.flow, runner(l, r)[0])
        spread, err = np.abs(e - w), np.abs(g.flow - w)
        assert err.max() <= max(FLOW_ATOL, SPREAD_FACTOR * spread.max()), \
            (err.max(), spread.max())
        assert err.mean() <= max(FLOW_ATOL, SPREAD_FACTOR * spread.mean())


# --------------------------------------------------------- ServeConfig
BAD_CONFIGS = [
    dict(data_parallel=0), dict(trace_sample_rate=1.5),
    dict(batch_sizes=(0, 1)), dict(batch_sizes=(2, 4)),
    dict(shape_bucket=48), dict(max_padding_waste=1.0),
    dict(fetch_dtype="fp8"), dict(bucket_grids=(48,)),
    dict(tiers=("nope",)), dict(tiers=("quality", "quality")),
    dict(tiers=("quality",), default_tier="interactive"),
    dict(max_dispatch_attempts=0), dict(retry_backoff_ms=-1.0),
    dict(breaker_failures=0), dict(breaker_cooldown_s=0.0),
    dict(brownout=True, tiers=("quality",)),
    dict(brownout=True, tiers=("quality", "interactive"),
         brownout_restore_fraction=0.9),
    dict(tiers=("quality",), brownout_exempt_tiers=("turbo",)),
    dict(sessions=True, session_ttl_s=0.0),
    dict(sessions=True, session_capacity=0),
    dict(session_hidden=True), dict(edf_max_slack_ms=-1.0),
    dict(session_ctx_cache=True),
    dict(sessions=True, session_ctx_cache=True, ctx_cache_threshold=0.0),
    dict(xl_mesh="rows=0"), dict(xl_mesh="bogus=2"),
    dict(xl_mesh="rows=2", xl_workers=0),
    dict(xl_mesh="rows=2", xl_batch_sizes=(2,)),
    dict(xl_mesh="rows=2", xl_max_pixels=10, xl_threshold_pixels=20),
    dict(tile_threshold_pixels=0), dict(tile_rows=16), dict(tile_halo=-1),
    dict(models=("a@1", "a@2"), model_store_dir="/x"),
    dict(models=("a b",)), dict(models=("a@1",)),
    dict(default_model="m"), dict(confidence_floor=2.0),
    dict(quality_drift_threshold=0.0), dict(quality_availability=1.0),
    dict(brownout_spare_below=0.5), dict(confidence=True,
                                         brownout_spare_below=1.5),
    dict(cascade=True), dict(cascade=True, confidence=True,
                             tiers=("quality",)),
    dict(cascade=True, confidence=True, tiers=("quality", "interactive"),
         cascade_draft="turbo"),
    dict(cascade=True, confidence=True, tiers=("quality", "interactive"),
         cascade_draft="quality", cascade_escalate="quality"),
    dict(cascade=True, confidence=True, tiers=("quality", "interactive"),
         cascade_threshold=2.0),
    dict(cascade_draft="quality"),
]


@pytest.mark.parametrize("kw", BAD_CONFIGS, ids=lambda kw: ",".join(kw))
def test_serve_config_validation_matches_jax(kw):
    with pytest.raises(Exception) as je:
        JaxServeConfig(**kw)
    with pytest.raises(Exception) as pe:
        ServeConfig(**kw)
    assert type(pe.value) is type(je.value)
    assert str(pe.value) == str(je.value)


# A valid setting away from its default for every deferred field (with the
# companions its validation needs).
DEFERRED_SETTINGS = {
    "sessions": dict(sessions=True),
    "session_ttl_s": dict(session_ttl_s=10.0),
    "session_capacity": dict(session_capacity=8),
    "scene_cut_threshold": dict(scene_cut_threshold=10.0),
    "session_reseed_on_cap": dict(session_reseed_on_cap=False),
    "session_hidden": dict(sessions=True, session_hidden=True),
    "session_ctx_cache": dict(sessions=True, session_ctx_cache=True),
    "ctx_cache_threshold": dict(ctx_cache_threshold=1.0),
    "cascade": dict(cascade=True, confidence=True,
                    tiers=("quality", "interactive")),
    "cascade_draft": dict(cascade=True, confidence=True,
                          tiers=("quality", "interactive"),
                          cascade_draft="interactive"),
    "cascade_escalate": dict(cascade=True, confidence=True,
                             tiers=("quality", "interactive"),
                             cascade_escalate="quality"),
    "cascade_threshold": dict(cascade_threshold=0.3),
    "tile_threshold_pixels": dict(tile_threshold_pixels=1000),
    "tile_rows": dict(tile_rows=256),
    "tile_halo": dict(tile_halo=32),
    "models": dict(models=("m@1",), model_store_dir="/store"),
    "model_store_dir": dict(model_store_dir="/store"),
    "default_model": dict(models=("m@1",), model_store_dir="/store",
                          default_model="m"),
    "executable_cache_dir": dict(executable_cache_dir="/cache"),
    "executable_cache_max_bytes": dict(executable_cache_max_bytes=10),
    "executable_cache_read_only": dict(executable_cache_read_only=True),
    "xl_mesh": dict(xl_mesh="rows=2"),
    "xl_workers": dict(xl_workers=2),
    "xl_threshold_pixels": dict(xl_threshold_pixels=10),
    "xl_max_pixels": dict(xl_max_pixels=3_000_000),
    "xl_batch_sizes": dict(xl_batch_sizes=(1, 2)),
}


@pytest.mark.parametrize("field,tag", DEFERRED_FIELDS,
                         ids=[f for f, _ in DEFERRED_FIELDS])
def test_deferred_field_refuses_naming_its_tag(field, tag):
    kw = DEFERRED_SETTINGS[field]
    JaxServeConfig(**kw)                       # a setting JAX accepts
    with pytest.raises(NotImplementedError,
                       match=tag.split()[0]) as e:
        ServeConfig(**kw)
    assert "is not ported to the PyTorch package yet" in str(e.value)
    assert tag.split()[0] in ("§D6b", "§D7")


def test_serve_config_fields_are_jax_fields():
    """The same fields with the same defaults (``chaos`` aside: each
    package's own ``ChaosConfig`` class, default None in both)."""
    jf = {f.name: f.default for f in dataclasses.fields(JaxServeConfig)}
    pf = {f.name: f.default for f in dataclasses.fields(ServeConfig)}
    assert pf == jf
    assert StereoService is ServingEngine
