"""Streaming sessions on the port's serving engine (CPU), against the JAX
package's engine and against the port's own runner.

Both packages serve the ``TINY`` model of ``tests/test_serving.py``
(``corr_backend="reg"``) on one set of weights (Flax init, norm leaves
perturbed, carried by ``state_dict_from_jax``); the exit cases run the
settling GRU (``torch_port_support.settle_jax``).  A chain is one
textured pair (``golden_data``) shifted by one pixel a frame.

Tolerances.
* **From the same state**: each port frame starts from the JAX frame's
  state before it (its padded low-resolution flow, and where the family
  takes them its hidden state and context bundle, NHWC -> NCHW), so one
  frame's flows are one forward apart: FLOW_ATOL = 2e-3 px, the
  whole-forward bound of ``tests/test_torch_model.py``, or SPREAD_FACTOR
  x JAX's own jit-vs-eager spread on the chain where that is larger (the
  chain test measures it); hidden states, tanh
  outputs of the same GRU, the same; the context bundle the port saves
  (the context encoder's initial hidden states and GRU biases, a part of
  the same forward) the same, held leaf by leaf before JAX's replaces it.
* **Free-running**: each package chains its own states, so a frame's
  input state differs by the previous frame's error.  On random weights a
  chain of k frames is a forward of k x ITERS iterations of a GRU that
  amplifies a perturbation ~5x an iteration: measured 5e-4, 1.5e-2, 0.43,
  8.2 px over frames 0-3, no bound worth stating.  On the settling GRU
  (updates shrink by 0.73 an iteration) a perturbation of the start damps
  instead: measured at most 2.1e-4 px over 6 frames at ITERS = 2, so the
  free chain there is held to FLOW_ATOL, every frame.
* ``iters_used``, warm/cold/scene-cut flags, frame deltas, ctx hits, the
  keyframe guard's reseeds: equal, with the exit threshold at the midpoint
  of two of JAX's own per-iteration deltas at least 10% apart (as
  ``tests/test_torch_early_exit.py`` takes it).
* Against the port's runner: batch 1 is ``run_stream``'s program (a cold
  ctx-saving frame's bundle the runner's ``save_ctx`` bundle, and a ctx
  hit the runner's ``prev_ctx`` program), bit for bit; on a static scene
  a free-running hit equals the plain warm frame from the same state (the
  context encoder on the same images), bit for bit; a batch of two
  sessions' warm frames within BATCH_ATOL = 5e-4 px of their batch-1
  answers (the JAX engine's own bound for another batch axis), and their
  saved bundles within BATCH_ATOL plus BUNDLE_RTOL = 1e-4 of theirs (the
  context biases reach ~70, and the batch axis reorders fp32 sums in
  proportion).
"""

import contextlib
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golden_data import disparity_field, textured_image, warp_right
from raft_stereo_tpu.config import RaftStereoConfig as JaxConfig
from raft_stereo_tpu.eval.runner import InferenceRunner as JaxRunner
from raft_stereo_tpu.models.raft_stereo import RAFTStereo as JaxRAFTStereo
from raft_stereo_tpu.serving import ServeConfig as JaxServeConfig
from raft_stereo_tpu.serving import StereoService as JaxService
from raft_stereo_tpu_torch.config import RaftStereoConfig
from raft_stereo_tpu_torch.eval.runner import InferenceRunner
from raft_stereo_tpu_torch.io.jax_weights import state_dict_from_jax
from raft_stereo_tpu_torch.serving import (FAMILY_BASE, FAMILY_STATE,
                                           FAMILY_WARM, ChaosConfig,
                                           ChaosInjector, RequestPoisoned,
                                           ServeConfig, ServingEngine,
                                           SessionExpired, SessionsDisabled)
from torch_port_support import perturb, settle_jax

TINY = dict(hidden_dims=(32, 32, 32), fnet_dim=64, corr_backend="reg")
ITERS = 2
N_FRAMES = 4
HW = (48, 64)
FLOW_ATOL = 2e-3
SPREAD_FACTOR = 3.0
BATCH_ATOL = 5e-4
BUNDLE_RTOL = 1e-4       # a batch row's context biases reach ~70
CAP = 4                  # the exit cases' depth cap
NEVER = "never:0.000000001:1"   # an exit tier no update gets below


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _init(settled=False):
    jcfg = JaxConfig(**TINY)
    jmodel = JaxRAFTStereo(jcfg)
    dummy = jnp.zeros((1, 64, 64, 3), jnp.float32)
    init = jax.jit(lambda key: jmodel.init(key, dummy, dummy, iters=1,
                                           test_mode=True))
    variables = perturb(init(jax.random.PRNGKey(0)),
                        np.random.default_rng(7))
    if settled:
        variables = settle_jax(variables)
    return jcfg, variables, RaftStereoConfig(**TINY), state_dict_from_jax(
        variables)


@pytest.fixture(scope="module")
def weights():
    """(JAX config, JAX variables, port config, port state dict)."""
    return _init()


def _chain(n=N_FRAMES, hw=HW, seed=0):
    """A coherent sequence: one textured pair shifted one pixel a frame."""
    rng = np.random.default_rng(seed)
    left = textured_image(rng, hw[0], hw[1] + n)
    right = warp_right(left, disparity_field(rng, hw[0], hw[1] + n))
    return [(np.ascontiguousarray(left[:, k:k + hw[1]]),
             np.ascontiguousarray(right[:, k:k + hw[1]])) for k in range(n)]


def _structured(hw=HW, level=40):
    """A smooth ramp: structured content moves the thumbnails' delta
    (mean-pooled noise would not)."""
    ramp = np.linspace(0, 120, hw[1], dtype=np.float32)[None, :] + level
    img = np.broadcast_to(ramp, hw).astype(np.uint8)
    return np.stack([img] * 3, axis=-1)


def _nchw(tree):
    """A JAX per-member state tree (NHWC leaves) in the port's layout."""
    if tree is None:
        return None
    if isinstance(tree, np.ndarray):
        return np.ascontiguousarray(np.asarray(tree, np.float32).transpose(
            2, 0, 1))
    return tuple(_nchw(t) for t in tree)


def _leaves(tree):
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def _assert_tree_close(got, want, atol=FLOW_ATOL, rtol=0.0):
    """Two state trees of one structure, leaf by leaf within ``atol``
    (and ``rtol``)."""
    got, want = _leaves(got), _leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=atol, rtol=rtol)


def _inject(eng, sid, jres):
    """Start the port session's next frame from the JAX frame's state,
    after holding the context bundle the port session saved (its own,
    from its own frame) to JAX's."""
    sess = eng.sessions.get(sid)
    sess.flow_low = None if sess.flow_low is None else jres.flow_low.copy()
    if sess.hidden is not None:
        sess.hidden = _nchw(jres.hidden)
    if sess.ctx is not None and jres.ctx is not None:
        _assert_tree_close(sess.ctx, _nchw(jres.ctx))
        sess.ctx = _nchw(jres.ctx)


def _assert_frame(got, want, atol=FLOW_ATOL):
    assert (got.warm, got.scene_cut, got.frame_index, got.ctx_cached,
            got.warm_hidden) == (want.warm, want.scene_cut,
                                 want.frame_index, want.ctx_cached,
                                 want.warm_hidden)
    assert got.frame_delta == want.frame_delta
    assert got.iters_used == want.iters_used
    np.testing.assert_allclose(got.flow, want.flow, atol=atol, rtol=0)
    np.testing.assert_allclose(got.flow_low, want.flow_low, atol=atol,
                               rtol=0)
    if want.hidden is not None:
        _assert_tree_close(got.hidden, _nchw(want.hidden), atol)
    assert (got.ctx is None) == (want.ctx is None)
    if want.ctx is not None:
        _assert_tree_close(got.ctx, _nchw(want.ctx), atol)


def _port(weights, **kw):
    _, _, cfg, state = weights
    kw.setdefault("iters", ITERS)
    return ServingEngine(cfg, state, ServeConfig(sessions=True, **kw),
                         device="cpu")


@pytest.fixture(scope="module")
def jax_plain(weights):
    """The JAX engine of the plain families (state, warm) at batch 1."""
    jcfg, variables, _, _ = weights
    with JaxService(jcfg, variables, JaxServeConfig(
            iters=ITERS, sessions=True, batch_sizes=(1,),
            max_batch=1)) as js:
        yield js


# ------------------------------------------------ against the JAX engine
def test_chain_matches_jax_from_the_same_state(weights, jax_plain):
    """A 4-frame chain: cold, then warm frames.  Each port frame started
    from JAX's previous state within FLOW_ATOL of JAX's frame, or within
    SPREAD_FACTOR x JAX's own spread where that is larger: the largest
    gap over the chain between JAX's engine frames and the same frames
    run eagerly (``jax.disable_jit``) by JAX's runner from the same
    states (measured 7e-4 to 1e-3 px on flows of ~50 px, and the port
    2.02e-3 px at 1 of 256 low-resolution pixels on an AMD EPYC host).
    Flags and deltas equal; the close stats equal."""
    jcfg, variables, _, _ = weights
    frames = _chain()
    want = [jax_plain.infer_session("same", l, r, timeout=300)
            for l, r in frames]
    closed = jax_plain.close_session("same")
    assert [w.warm for w in want] == [False] + [True] * (N_FRAMES - 1)
    runner = JaxRunner(jcfg, variables, iters=ITERS)
    spread = 0.0
    for k, (l, r) in enumerate(frames):
        with jax.disable_jit():
            e = runner.run_stream(l, r, prev_flow_low=want[k - 1].flow_low
                                  if k else None)
        spread = max(spread, np.abs(e.flow - want[k].flow).max(),
                     np.abs(e.flow_low - want[k].flow_low).max())
    atol = max(FLOW_ATOL, SPREAD_FACTOR * float(spread))
    with _port(weights, batch_sizes=(1,), max_batch=1) as eng:
        for k, (l, r) in enumerate(frames):
            if k:
                _inject(eng, "same", want[k - 1])
            _assert_frame(eng.infer_session("same", l, r, timeout=120),
                          want[k], atol)
        assert eng.metrics.session_frames("warm") == N_FRAMES - 1
        assert eng.close_session("same") == closed


@contextlib.contextmanager
def _clock_past_ttl(store):
    """The session store's clock, read by its TTL sweep, two TTLs ahead
    for the block: every session idle before the block expires, whatever
    other sessions the store holds and whenever they were last used (the
    sweep walks sessions in last-used order and stops at the first live
    one, so moving one session's stamp back alone depends on them)."""
    real = store._clock
    store._clock = lambda: real() + 2 * store.ttl_s
    try:
        yield
    finally:
        store._clock = real


def test_scene_cut_and_ttl_typed_as_jax(weights, jax_plain):
    """A drift stays warm, an inverted frame cuts (cold, delta > 40) and
    the stream recovers warm; an expired session raises the typed 410
    error; the metrics equal JAX's."""
    a, b = _structured(level=20), _structured(level=24)
    c = 255 - a
    seq = [a, b, c, c]
    out = {}
    for tag, eng in (("jax", jax_plain), ("port", None)):
        eng = eng or _port(weights, batch_sizes=(1,), max_batch=1)
        cuts0 = eng.metrics.scene_cuts.value
        n0 = eng.metrics.frame_delta.count
        res = [eng.infer_session("cut", x, x.copy(), timeout=300)
               for x in seq]
        with _clock_past_ttl(eng.sessions), \
                pytest.raises(KeyError) as e:
            eng.infer_session("cut", a, a.copy(), timeout=300)
        out[tag] = ([(r.warm, r.scene_cut, r.frame_delta) for r in res],
                    type(e.value).__name__, e.value.reason,
                    eng.metrics.scene_cuts.value - cuts0,
                    eng.metrics.frame_delta.count - n0)
        if tag == "port":
            assert isinstance(e.value, SessionExpired)
            assert eng.metrics.sessions_expired.value == 1
            eng.close()
    assert out["port"] == out["jax"]
    assert [f[:2] for f in out["port"][0]] == [(False, False), (True, False),
                                               (False, True), (True, False)]
    assert out["port"][1:4] == ("SessionExpired", "expired", 1)


def test_ctx_cache_and_hidden_carry_match_jax(weights):
    """``session_ctx_cache`` with ``session_hidden``: a static scene's warm
    frames take the cached bundle (warm_ctx_h), a brightness step past
    the static gate runs warm_h and drops the bundle, the next cold frame
    re-saves it.  Every frame from JAX's state within FLOW_ATOL, the
    hidden states too; families, hits and close stats equal."""
    jcfg, variables, _, _ = weights
    l, r = _chain(1)[0]
    step = [np.clip(x.astype(np.int16) + 12, 0, 255).astype(np.uint8)
            for x in (l, r)]
    seq = [(l, r), (l, r), (l, r), step, step, step]
    kw = dict(iters=ITERS, sessions=True, session_hidden=True,
              session_ctx_cache=True, batch_sizes=(1,), max_batch=1)
    with JaxService(jcfg, variables, JaxServeConfig(**kw)) as js:
        want = [js.infer_session("s", a, b, timeout=300) for a, b in seq]
        want_stats = js.close_session("s")
        want_hits = js.metrics.ctx_cache_hits.value
    assert [w.ctx_cached for w in want] == [False, True, True, False,
                                            False, False]
    assert all(w.warm_hidden for w in want[1:])
    kw.pop("sessions")
    with _port(weights, **kw) as eng:
        for k, (a, b) in enumerate(seq):
            if k:
                _inject(eng, "s", want[k - 1])
            _assert_frame(eng.infer_session("s", a, b, timeout=120),
                          want[k])
        assert eng.close_session("s") == want_stats
        assert eng.metrics.ctx_cache_hits.value == want_hits == 2


@pytest.fixture(scope="module")
def settled():
    """Settled weights, a 60x90 chain and an exit threshold at the
    midpoint of two of JAX's per-iteration deltas of the cold frame at
    least 10% apart, with the exit strictly inside (1, CAP)."""
    jcfg, variables, cfg, state = _init(settled=True)
    frames = _chain(3, hw=(60, 90), seed=1)
    jmodel = JaxRAFTStereo(jcfg)
    pad = lambda x: np.pad(x, ((2, 2), (3, 3), (0, 0)), mode="edge")
    l = jnp.asarray(pad(frames[0][0])[None], jnp.float32)
    r = jnp.asarray(pad(frames[0][1])[None], jnp.float32)
    lows = [np.asarray(jmodel.apply(variables, l, r, iters=k,
                                    test_mode=True, unroll_gru=True)[0])
            for k in range(CAP + 1)]
    deltas = [float(np.abs(b - a).mean()) for a, b in zip(lows, lows[1:])]
    vals = sorted(deltas)
    thr = next((a + b) / 2 for a, b in zip(vals, vals[1:])
               if b >= 1.1 * a and 1 < next(
                   (k + 1 for k, d in enumerate(deltas) if d < (a + b) / 2),
                   CAP) < CAP)
    return dict(jcfg=jcfg, variables=variables, weights=(jcfg, variables,
                                                         cfg, state),
                frames=frames, thr=thr)


def test_exit_tier_iters_used_keyframe_guard_and_free_chain_match_jax(
        settled):
    """On an exit tier each frame from JAX's state runs JAX's trip count
    and its flow within FLOW_ATOL; on a tier that never exits every warm
    frame hits the cap, so the keyframe guard reseeds the next frame cold
    (warm and cold alternate), with JAX's reseed count; on the fixed-depth
    tier each package's free-running chain within FLOW_ATOL of the
    other's."""
    tiers = ("quality", f"fast:{settled['thr']}:1", NEVER)
    kw = dict(iters=CAP, sessions=True, tiers=tiers, batch_sizes=(1,),
              max_batch=1)
    seq = settled["frames"]
    guard = [seq[0]] * 4
    with JaxService(settled["jcfg"], settled["variables"],
                    JaxServeConfig(**kw)) as js:
        want = [js.infer_session("x", l, r, tier="fast", timeout=300)
                for l, r in seq]
        want_g = [js.infer_session("g", l, r, tier="never", timeout=300)
                  for l, r in guard]
        reseeds = js.metrics.session_reseeds.value
        want_f = [js.infer_session("f", l, r, tier="quality", timeout=300)
                  for l, r in seq]
    kw.pop("sessions")
    with _port(settled["weights"], **kw) as eng:
        for k, (l, r) in enumerate(seq):
            if k:
                _inject(eng, "x", want[k - 1])
            _assert_frame(eng.infer_session("x", l, r, tier="fast",
                                            timeout=120), want[k])
        got_g = [eng.infer_session("g", l, r, tier="never", timeout=120)
                 for l, r in guard]
        for (l, r), w in zip(seq, want_f):
            _assert_frame(eng.infer_session("f", l, r, tier="quality",
                                            timeout=120), w)
        assert eng.metrics.session_reseeds.value == reseeds == 2
        assert "serve_session_reseeds_total 2" in eng.metrics.render_text()
    assert all(1 < w.iters_used < CAP for w in want[:1])
    assert [g.warm for g in got_g] == [w.warm for w in want_g] == [
        False, True, False, True]
    assert [g.iters_used for g in got_g] == [CAP] * 4


# ------------------------------------------------ the engine's own rules
def test_frames_strictly_ordered_and_two_sessions_concurrently(weights):
    """Frame N+1 of a session cannot enter the queue before frame N
    resolved (paused queue: depth 1, completion in submission order);
    two sessions stream concurrently, each warm after its first frame."""
    l, r = _chain(1)[0]
    with _port(weights, batch_sizes=(1, 2), max_batch=2) as eng:
        eng.infer_session("s", l, r, timeout=120)
        eng.queue.pause()
        done, futs = [], {}

        def frame(idx):
            futs[idx] = eng.submit_session("s", l, r)
            futs[idx].add_done_callback(lambda f: done.append(idx))

        t1 = threading.Thread(target=frame, args=(1,))
        t1.start()
        time.sleep(0.2)
        t2 = threading.Thread(target=frame, args=(2,))
        t2.start()
        time.sleep(0.2)
        assert eng.queue.depth == 1
        eng.queue.resume()
        t1.join(timeout=60)
        t2.join(timeout=60)
        r1, r2 = (futs[i].result(timeout=120) for i in (1, 2))
        assert done == [1, 2] and (r1.frame_index, r2.frame_index) == (1, 2)
        assert r1.warm and r2.warm

        results = {}

        def client(sid, seed):
            frames = _chain(seed=seed)
            results[sid] = [eng.infer_session(sid, a, b, timeout=120)
                            for a, b in frames]

        threads = [threading.Thread(target=client, args=(f"c{i}", i))
                   for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        for sid in ("c0", "c1"):
            assert [x.frame_index for x in results[sid]] == \
                list(range(N_FRAMES))
            assert [x.warm for x in results[sid]] == \
                [False] + [True] * (N_FRAMES - 1)
        assert eng.sessions.active_count == 3


def test_batch1_bit_equal_to_run_stream_and_batch2_within_bound(weights):
    """Batch 1: each frame equals the port runner's ``run_stream`` fed
    the same chain (flow-only and with the hidden state), bit for bit.
    Two sessions' warm frames staged together run as one batch-2
    dispatch, each row within BATCH_ATOL of its batch-1 answer."""
    _, _, cfg, state = weights
    frames = _chain()
    runner = InferenceRunner(cfg, state, iters=ITERS, device="cpu")
    for hidden in (False, True):
        prev = hid = None
        want = []
        for l, r in frames:
            f = runner.run_stream(l, r, prev_flow_low=prev,
                                  prev_hidden=hid, carry_hidden=hidden)
            want.append(f)
            prev, hid = f.flow_low, f.hidden
        with _port(weights, batch_sizes=(1, 2), max_batch=2,
                   session_hidden=hidden) as eng:
            for (l, r), w in zip(frames, want):
                g = eng.infer_session("a", l, r, timeout=120)
                assert g.batch_size == 1 and g.warm == w.warm
                assert np.array_equal(g.flow, w.flow)
                assert np.array_equal(g.flow_low, w.flow_low)
                if hidden:
                    assert all(np.array_equal(a, b)
                               for a, b in zip(g.hidden, w.hidden))
            other = _chain(seed=5)
            for l, r in other[:-1]:
                eng.infer_session("b", l, r, timeout=120)
            solo = {}
            for sid, pair in (("a", frames[-1]), ("b", other[-1])):
                sess = eng.sessions.get(sid)
                solo[sid] = runner.run_stream(
                    *pair, prev_flow_low=sess.flow_low,
                    prev_hidden=sess.hidden, carry_hidden=hidden)
            eng.queue.pause()
            futs = {sid: eng.submit_session(sid, *pair)
                    for sid, pair in (("a", frames[-1]), ("b", other[-1]))}
            eng.queue.resume()
            for sid, fut in futs.items():
                g = fut.result(timeout=120)
                assert g.batch_size == 2 and g.warm
                assert g.warm_hidden == hidden
                np.testing.assert_allclose(g.flow, solo[sid].flow,
                                           atol=BATCH_ATOL, rtol=0)


def test_ctx_hit_bit_equal_to_the_reuse_program(weights):
    """The bundle a cold ctx frame saves is the runner's ``save_ctx``
    bundle, and a ctx hit the runner's ``prev_ctx`` program on it and the
    session's previous flow, bit for bit; on the static scene that hit is
    the plain warm frame from the same state, bit for bit (a misparsed or
    misrouted bundle would move it).  Two sessions' cold frames staged
    together save each its own row's bundle (within BATCH_ATOL plus
    BUNDLE_RTOL of its batch-1 bundle), and their hits staged
    together run as one batch-2 dispatch, each row within BATCH_ATOL of
    its batch-1 answer from the same state."""
    _, _, cfg, state = weights
    l, r = _chain(1)[0]
    l2, r2 = _chain(1, seed=4)[0]
    runner = InferenceRunner(cfg, state, iters=ITERS, device="cpu")
    saved = {sid: runner.run_stream(*pair, save_ctx=True)
             for sid, pair in (("s", (l, r)), ("t", (l2, r2)))}
    with _port(weights, batch_sizes=(1, 2), max_batch=2,
               session_ctx_cache=True) as eng:
        cold = eng.infer_session("s", l, r, timeout=120)
        sess = eng.sessions.get("s")
        bundle = sess.ctx
        hit = eng.infer_session("s", l, r, timeout=120)
        assert not cold.ctx_cached and hit.ctx_cached and hit.warm
        assert hit.ctx is None and sess.ctx is bundle
        eng.infer_session("t", l2, r2, timeout=120)
        solo = {}
        for sid, pair in (("s", (l, r)), ("t", (l2, r2))):
            st = eng.sessions.get(sid)
            keep = (st.flow_low, st.thumb, st.frame_index, st.warm_frames,
                    st.ctx_hits)
            solo[sid] = eng.infer_session(sid, *pair, timeout=120)
            (st.flow_low, st.thumb, st.frame_index, st.warm_frames,
             st.ctx_hits) = keep
        eng.queue.pause()
        futs = {sid: eng.submit_session(sid, *pair) for sid, pair in
                (("s", (l, r)), ("t", (l2, r2)))}
        eng.queue.resume()
        for sid, fut in futs.items():
            g = fut.result(timeout=120)
            assert g.batch_size == 2 and g.ctx_cached
            np.testing.assert_allclose(g.flow, solo[sid].flow,
                                       atol=BATCH_ATOL, rtol=0)
        eng.queue.pause()
        futs = {sid: eng.submit_session(sid, *pair) for sid, pair in
                (("u", (l, r)), ("v", (l2, r2)))}
        eng.queue.resume()
        for sid, fut in futs.items():
            assert fut.result(timeout=120).batch_size == 2
            _assert_tree_close(eng.sessions.get(sid).ctx,
                               saved["s" if sid == "u" else "t"].ctx,
                               BATCH_ATOL, BUNDLE_RTOL)
    assert np.array_equal(cold.flow, saved["s"].flow)
    assert all(np.array_equal(a, b) for a, b in zip(
        _leaves(bundle), _leaves(saved["s"].ctx)))
    reuse = runner.run_stream(l, r, prev_flow_low=cold.flow_low,
                              prev_ctx=bundle)
    plain = runner.run_stream(l, r, prev_flow_low=cold.flow_low)
    for want in (reuse, plain):
        assert np.array_equal(hit.flow, want.flow)
        assert np.array_equal(hit.flow_low, want.flow_low)


def test_run_stream_ctx_needs_a_warm_frame_without_save(weights):
    """``prev_ctx`` is a static scene's warm frame: without
    ``prev_flow_low``, or beside ``save_ctx``, it raises before any
    program runs."""
    _, _, cfg, state = weights
    runner = InferenceRunner(cfg, state, iters=ITERS, device="cpu")
    l, r = _chain(1)[0]
    low = np.zeros((HW[0] // 4 + 4, HW[1] // 4), np.float32)
    for kw in (dict(prev_ctx=()), dict(prev_ctx=(), save_ctx=True,
                                       prev_flow_low=low)):
        with pytest.raises(ValueError, match="prev_ctx needs"):
            runner.run_stream(l, r, **kw)
    assert runner.replays == 0


def test_ctx_bundles_past_the_budget_drop_the_least_recent(weights):
    """Past ``ctx_budget_bytes`` the bundle of the session used least
    recently is dropped: its next warm frame runs plain warm, it re-saves
    at its next cold frame; the session that just saved keeps its own."""
    a, b = _chain(1)[0], _chain(1, seed=4)[0]
    with _port(weights, batch_sizes=(1,), max_batch=1,
               session_ctx_cache=True) as eng:
        assert eng.ctx_budget_bytes is None       # host arrays on the CPU
        eng.ctx_budget_bytes = 1 << 40
        eng.infer_session("s", *a, timeout=120)
        one = sum(x.nbytes for x in _leaves(eng.sessions.get("s").ctx))
        eng.ctx_budget_bytes = one + one // 2
        eng.infer_session("t", *b, timeout=120)
        assert eng.sessions.get("s").ctx is None
        assert eng.sessions.get("t").ctx is not None
        assert eng.ctx_bundles_dropped == 1
        s1 = eng.infer_session("s", *a, timeout=120)
        t1 = eng.infer_session("t", *b, timeout=120)
        assert (s1.warm, s1.ctx_cached, t1.warm, t1.ctx_cached) == (
            True, False, True, True)
        eng.close_session("t")
        eng.sessions.get("s").flow_low = None       # the next frame cold
        assert not eng.infer_session("s", *a, timeout=120).warm
        assert eng.infer_session("s", *a, timeout=120).ctx_cached


def test_crashed_warm_frame_retries_cold_and_poisoned_frame_releases(
        weights):
    """A warm frame whose dispatch crashes (the ported chaos injector)
    retries in the cold family and the session's state is dropped; the
    stream keeps flowing, warm off the retry.  A frame poisoned on every
    attempt fails typed, releases the ordering lock and leaves the session
    cold."""
    l, r = _chain(1)[0]
    with _port(weights, batch_sizes=(1,), max_batch=1,
               max_dispatch_attempts=2, retry_backoff_ms=1.0) as eng:
        assert not eng.infer_session("s", l, r, timeout=120).warm
        eng.chaos = ChaosInjector(
            ChaosConfig(seed=1, crash_rate=1.0, max_faults=1),
            observe=eng.metrics.observe_injected_fault)
        f1 = eng.infer_session("s", l, r, timeout=120)
        assert f1.attempts == 2 and not f1.warm
        assert eng.metrics.retries.value == 1
        f2 = eng.infer_session("s", l, r, timeout=120)
        assert f2.warm and f2.attempts == 1
        assert eng.sessions.get("s").cold_frames == 2
        eng.chaos = ChaosInjector(
            ChaosConfig(seed=2, crash_rate=1.0, max_faults=2),
            observe=eng.metrics.observe_injected_fault)
        with pytest.raises(RequestPoisoned):
            eng.infer_session("s", l, r, timeout=120)
        assert eng.sessions.get("s").flow_low is None
        assert eng.metrics.poisoned.value == 1
        assert not eng.infer_session("s", l, r, timeout=120).warm
        assert eng.infer_session("s", l, r, timeout=120).warm


SURFACES = [dict(), dict(session_hidden=True), dict(session_ctx_cache=True),
            dict(session_hidden=True, session_ctx_cache=True)]


@pytest.mark.parametrize("kw", SURFACES,
                         ids=lambda kw: ",".join(kw) or "plain")
def test_families_join_prewarm_and_readyz_as_jax(weights, kw):
    """The session families join the readiness target as in JAX (the
    same families, the same count), and ``prewarm`` builds every one of
    them once, after which a session's frames hit the cache."""
    jcfg, variables, _, _ = weights
    base = dict(iters=ITERS, sessions=True, tiers=("quality", "fast:0.5:1"),
                batch_sizes=(1, 2), max_batch=2, warmup_shapes=(HW,),
                prewarm_on_init=False, **kw)
    js = JaxService(jcfg, variables, JaxServeConfig(**base))
    want = {t[4] for t in js._warm_target}, js.warm_status()
    js.close()
    base.pop("sessions")
    with _port(weights, **base) as eng:
        assert {t[4] for t in eng._warm_target} == want[0]
        assert set(eng._families()) == want[0]
        assert eng.warm_status() == want[1]
        assert not eng.ready
        eng.prewarm(HW)
        status = eng.warm_status()
        assert eng.ready and status["warm_done"] == want[1]["warm_target"]
        assert status["compiles_cold"] == want[1]["warm_target"] == \
            2 * 2 * len(want[0])
        assert {k[4] for k in eng.cached_programs()} == want[0]
        for l, r in _chain(3):
            eng.infer_session("s", l, r, timeout=120)
        assert eng.metrics.compiles_cold.value == status["compiles_cold"]


def test_stateless_engine_program_surface_unchanged(weights):
    """``sessions=False``: the base family only (programs, readiness,
    keys), and a stream is refused typed."""
    _, _, cfg, state = weights
    with ServingEngine(cfg, state, ServeConfig(
            iters=ITERS, batch_sizes=(1, 2), max_batch=2,
            warmup_shapes=(HW,)), device="cpu") as eng:
        assert eng._families() == (FAMILY_BASE,) and eng.sessions is None
        assert eng.ready and eng.warm_status()["warm_target"] == 2
        assert eng.cached_programs() == [(0, (64, 64), 1, None, None),
                                         (0, (64, 64), 2, None, None)]
        l, r = _chain(1)[0]
        res = eng.infer(l, r, timeout=120)
        assert res.session_id is None and res.flow_low is None
        assert not res.warm and res.hidden is None
        for call in (lambda: eng.infer_session("s", l, r),
                     lambda: eng.close_session("s")):
            with pytest.raises(SessionsDisabled):
                call()
    with _port(weights, batch_sizes=(1,), max_batch=1) as eng:
        eng.infer_session("s", l, r, timeout=120)
        eng.infer_session("s", l, r, timeout=120)
        assert [k[4] for k in eng.cached_programs()] == [FAMILY_STATE,
                                                         FAMILY_WARM]
        assert eng.program((64, 64), 1, family=FAMILY_WARM) is not None
        assert eng.program((64, 64), 1) is None


def test_lru_evicts_across_families(weights, caplog):
    """``max_cached_shapes`` bounds a worker's programs whatever their
    family: a stateless request, then a session's cold and warm frames,
    leave the two newest.  The engine warns at construction that one
    bucket's three programs exceed the bound."""
    l, r = _chain(1)[0]
    with caplog.at_level("WARNING", logger="raft_stereo_tpu_torch"):
        eng = _port(weights, batch_sizes=(1,), max_batch=1,
                    max_cached_shapes=2)
    assert any("3 programs per bucket and worker" in m and
               "max_cached_shapes=2" in m for m in caplog.messages)
    with eng:
        eng.infer(l, r, timeout=120)
        eng.infer_session("s", l, r, timeout=120)
        eng.infer_session("s", l, r, timeout=120)
        assert [k[4] for k in eng.cached_programs()] == [FAMILY_STATE,
                                                         FAMILY_WARM]
        assert eng.metrics.compiles_cold.value == 3


def test_ctx_cache_refused_with_shared_backbone(weights):
    _, _, cfg, state = weights
    with pytest.raises(ValueError, match="shared_backbone"):
        ServingEngine(RaftStereoConfig.realtime(), {},
                      ServeConfig(sessions=True, session_ctx_cache=True),
                      device="cpu")
