"""The confidence-gated cascade (``tier="auto"``) on the port's serving
engine (CPU), against the JAX package's engine, HTTP front end and
``tools/confidence_report.py``.

Both engines serve the ``TINY`` model on one set of weights (Flax init,
norm leaves perturbed, the settling GRU of ``torch_port_support``,
carried by ``state_dict_from_jax``), with the tiers "quality" and an
early-exit "interactive", confidence on and the cascade on: the draft is
the cheapest rung of the cost ladder ("interactive"), the escalation the
dearest ("quality").  The pairs are one textured pair at several
contrasts; the threshold sits at the middle of the widest gap between
their draft confidences (measured on the port first), so some escalate
and some do not.

Tolerances.  A draft confidence is a mean of the confidence map, which
``chip_smoke.py`` holds to CONF_ATOL = 12 x 2e-3 (PERF.md §2's bound: the
map is exp(-|delta flow|) through the upsampler, so it moves with the
flow's 2e-3 px); the threshold must sit farther than that from every
draft confidence, so the gate decides alike in both packages and the
provenance (escalated, draft tier, answering tier) is equal.  Flows are
held to 2e-3 px, the whole-forward bound.  The cascade counters' lines of
the Prometheus text are byte-equal.  The report's rank statistics
(AUROC, Spearman) are the JAX tool's functions: equal on the same arrays.
"""

import importlib.util
import json
import os
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golden_data import disparity_field, textured_image, warp_right
from raft_stereo_tpu.config import RaftStereoConfig as JaxConfig
from raft_stereo_tpu.models.raft_stereo import RAFTStereo as JaxRAFTStereo
from raft_stereo_tpu.serving import ServeConfig as JaxServeConfig
from raft_stereo_tpu.serving import StereoService as JaxService
from raft_stereo_tpu.serving import http as jhttp
from raft_stereo_tpu_torch.config import RaftStereoConfig
from raft_stereo_tpu_torch.io.jax_weights import state_dict_from_jax
from raft_stereo_tpu_torch.serving import ServeConfig, ServingEngine
from raft_stereo_tpu_torch.serving import http as phttp
from raft_stereo_tpu_torch.tools import confidence_report as preport
from torch_port_support import perturb, settle_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(hidden_dims=(32, 32, 32), fnet_dim=64, corr_backend="reg")
ITERS = 3
FLOW_ATOL = 2e-3
CONF_ATOL = 12 * 2e-3
HW = (48, 64)
CONTRASTS = (1.0, 0.5, 0.25, 0.1)
TIERS = ("quality", "interactive:0.05:1")
TILING = dict(tile_threshold_pixels=4000, tile_rows=32, tile_halo=8)


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _contrast(img, c):
    return (128 + (img.astype(np.float32) - 128) * c).astype(np.uint8)


def _pairs(hw=HW, seed=0):
    rng = np.random.default_rng(seed)
    left = textured_image(rng, *hw)
    right = warp_right(left, disparity_field(rng, *hw))
    return [(_contrast(left, c), _contrast(right, c)) for c in CONTRASTS]


def _serve(**kw):
    return dict(iters=ITERS, tiers=TIERS, confidence=True,
                batch_sizes=(1,), max_batch=1, **TILING, **kw)


@pytest.fixture(scope="module")
def engines():
    """(JAX engine, port engine, threshold, port draft confidences), both
    engines with the cascade at ``threshold``."""
    jcfg = JaxConfig(**TINY)
    jmodel = JaxRAFTStereo(jcfg)
    dummy = jnp.zeros((1, 64, 64, 3), jnp.float32)
    init = jax.jit(lambda key: jmodel.init(key, dummy, dummy, iters=1,
                                           test_mode=True))
    variables = settle_jax(perturb(init(jax.random.PRNGKey(0)),
                                   np.random.default_rng(7)))
    state = state_dict_from_jax(variables)
    with ServingEngine(RaftStereoConfig(**TINY), state,
                       ServeConfig(**_serve()), device="cpu") as probe:
        drafts = [probe.infer(l, r, tier="interactive",
                              timeout=300).confidence_mean
                  for l, r in _pairs()]
    ordered = sorted(drafts)
    gap, i = max((b - a, i) for i, (a, b) in enumerate(zip(ordered,
                                                           ordered[1:])))
    threshold = round((ordered[i] + ordered[i + 1]) / 2, 4)
    assert gap / 2 > CONF_ATOL, (
        f"draft confidences {drafts}: no gap wider than 2 x {CONF_ATOL}")
    kw = _serve(cascade=True, cascade_threshold=threshold)
    jeng = JaxService(jcfg, variables, JaxServeConfig(**kw))
    peng = ServingEngine(RaftStereoConfig(**TINY), state, ServeConfig(**kw),
                         device="cpu")
    yield jeng, peng, threshold, drafts
    jeng.close()
    peng.close()


def _cascade_lines(engine) -> list:
    return [ln for ln in engine.metrics.registry.render_text().splitlines()
            if "serve_cascade_" in ln]


def test_cascade_provenance_matches_jax(engines):
    jeng, peng, threshold, drafts = engines
    assert (peng._cascade_draft, peng._cascade_escalate) == (
        jeng._cascade_draft, jeng._cascade_escalate) == (
        "interactive", "quality")
    escalated = []
    for (left, right), draft in zip(_pairs(), drafts):
        want = jeng.infer(left, right, tier="auto", timeout=600)
        got = peng.infer(left, right, tier="auto", timeout=600)
        assert (got.escalated, got.draft_tier, got.tier) == (
            want.escalated, want.draft_tier, want.tier)
        assert got.escalated == (draft < threshold)
        assert abs(got.draft_confidence - want.draft_confidence) \
            <= CONF_ATOL
        assert got.draft_confidence == draft   # the same program
        np.testing.assert_allclose(got.flow, want.flow, atol=FLOW_ATOL)
        assert got.iters_used == want.iters_used
        escalated.append(got.escalated)
    assert any(escalated) and not all(escalated)
    n_esc = sum(escalated)
    assert peng._cascade_escalations.value == n_esc
    assert peng._cascade_drafts.value == len(escalated) - n_esc
    assert _cascade_lines(peng) == _cascade_lines(jeng)
    assert len(_cascade_lines(peng)) == 6    # HELP, TYPE, value each


def test_tiled_cascade_matches_jax(engines):
    """Past the tiling threshold the gate runs per tile; the stitched
    answer reports the escalated tier when any tile escalated and the
    worst tile's draft confidence."""
    jeng, peng, _, _ = engines
    rng = np.random.default_rng(5)
    left = textured_image(rng, 100, 64)
    right = warp_right(left, disparity_field(rng, 100, 64))
    # low contrast in the top rows only: its tiles draft differently
    left[:40] = _contrast(left[:40], 0.25)
    right[:40] = _contrast(right[:40], 0.25)
    want = jeng.infer(left, right, tier="auto", timeout=600)
    got = peng.infer(left, right, tier="auto", timeout=600)
    assert got.tiles == want.tiles == 4
    assert (got.escalated, got.draft_tier, got.tier) == (
        want.escalated, want.draft_tier, want.tier)
    assert abs(got.draft_confidence - want.draft_confidence) <= CONF_ATOL
    assert abs(got.confidence_mean - want.confidence_mean) <= CONF_ATOL
    assert got.confidence.shape == (100, 64)
    np.testing.assert_allclose(got.flow, want.flow, atol=FLOW_ATOL)
    assert abs(got.seam_epe - want.seam_epe) <= FLOW_ATOL


def _post(url, body, headers=None):
    req = urllib.request.Request(url, data=body, method="POST",
                                 headers=dict(headers or {}))
    try:
        with urllib.request.urlopen(req, timeout=300) as resp:
            return resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _npz(left, right):
    import io
    buf = io.BytesIO()
    np.savez(buf, left=left, right=right)
    return buf.getvalue()


def test_auto_tier_http_matches_jax(engines):
    """``?tier=auto``: X-Escalated, X-Draft-Tier, X-Tier equal,
    X-Draft-Confidence within CONF_ATOL; on a stream 400 with JAX's body;
    an engine without a cascade answers 400 with JAX's body."""
    jeng, peng, _, drafts = engines
    servers = [jhttp.StereoHTTPServer(jeng, port=0).start(),
               phttp.StereoHTTPServer(peng, port=0).start()]
    plain = [JaxService(JaxConfig(**TINY), jeng._host_variables,
                        JaxServeConfig(**_serve())),
             ServingEngine(RaftStereoConfig(**TINY), peng.model.state_dict(),
                           ServeConfig(**_serve()), device="cpu")]
    plain_servers = [jhttp.StereoHTTPServer(plain[0], port=0).start(),
                     phttp.StereoHTTPServer(plain[1], port=0).start()]
    try:
        body = _npz(*_pairs()[0])
        ctype = {"Content-Type": "application/x-npz"}
        (js, jh, _), (ps, ph, _) = [
            _post(s.url + "/v1/disparity?tier=auto&format=npy", body, ctype)
            for s in servers]
        assert js == ps == 200
        for h in ("X-Escalated", "X-Draft-Tier", "X-Tier"):
            assert ph[h] == jh[h]
        assert abs(float(ph["X-Draft-Confidence"])
                   - float(jh["X-Draft-Confidence"])) <= CONF_ATOL
        (js, _, jb), (ps, _, pb) = [
            _post(s.url + "/v1/stream/cam?tier=auto", body, ctype)
            for s in servers]
        assert (ps, json.loads(pb)) == (js, json.loads(jb))
        assert ps == 400
        (js, _, jb), (ps, _, pb) = [
            _post(s.url + "/v1/disparity?tier=auto", body, ctype)
            for s in plain_servers]
        assert (ps, json.loads(pb)) == (js, json.loads(jb))
        assert ps == 400 and "cascade" in json.loads(pb)["error"]
        with pytest.raises(ValueError) as pe:
            plain[1].infer(*_pairs()[0], tier="auto")
        with pytest.raises(ValueError) as je:
            plain[0].infer(*_pairs()[0], tier="auto")
        assert str(pe.value) == str(je.value)
    finally:
        for s in servers + plain_servers:
            s.shutdown()
        for e in plain:
            e.close()


def _jax_report():
    spec = importlib.util.spec_from_file_location(
        "jax_confidence_report", os.path.join(REPO, "tools",
                                              "confidence_report.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_report_rank_stats_equal_to_jax(seed):
    """AUROC and Spearman of the port's report equal the JAX tool's on the
    same arrays (with ties, and with an empty class)."""
    jreport = _jax_report()
    rng = np.random.default_rng(seed)
    conf = np.round(rng.uniform(0, 1, 4000), 2)       # ties
    err = np.abs(rng.standard_normal(4000)) * 2 - conf
    bad = err > preport.BAD_PX
    assert np.array_equal(preport.average_ranks(conf),
                          jreport.average_ranks(conf))
    assert preport.auroc_good_vs_bad(conf, bad) == \
        jreport.auroc_good_vs_bad(conf, bad)
    assert preport.spearman(conf, err) == jreport.spearman(conf, err)
    none = np.zeros_like(bad)
    assert preport.auroc_good_vs_bad(conf, none) is None
    assert jreport.auroc_good_vs_bad(conf, none) is None
    assert preport.BAD_PX == jreport.BAD_PX
