"""The port's HTTP front end and ``cli/serve.py`` against the JAX
package's (CPU).

Two servers on port 0 serve one set of ``TINY`` weights (the JAX engine
and the port's), configured alike.  The same requests go to both, and the
statuses, typed JSON bodies and headers are compared, so the port answers
as the JAX server answers, including on the routes of the features it
does not run yet (sessions, the model store, the xl and cascade
pseudo-tiers).  Encodings are compared byte for byte on one disparity;
answers are held to the engine's own (bit-equal: the same program).
"""

import io
import json
import os
import signal
import subprocess
import sys
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from raft_stereo_tpu.cli import serve as jserve_cli
from raft_stereo_tpu.config import RaftStereoConfig as JaxConfig
from raft_stereo_tpu.models.raft_stereo import RAFTStereo as JaxRAFTStereo
from raft_stereo_tpu.serving import ServeConfig as JaxServeConfig
from raft_stereo_tpu.serving import StereoService as JaxService
from raft_stereo_tpu.serving import http as jhttp
from raft_stereo_tpu_torch.cli import serve as serve_cli
from raft_stereo_tpu_torch.config import RaftStereoConfig
from raft_stereo_tpu_torch.io.jax_weights import (save_checkpoint,
                                                  state_dict_from_jax)
from raft_stereo_tpu_torch.serving import ServeConfig, ServingEngine
from raft_stereo_tpu_torch.serving import http as phttp
from test_torch_eval import _reference_state_dict
from torch_port_support import perturb

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(hidden_dims=(32, 32, 32), fnet_dim=64, corr_backend="reg")
ITERS = 1
SERVE = dict(iters=ITERS, tiers=("quality", "interactive"),
             trace_sample_rate=1.0, cost_telemetry=True, max_queue=4)


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _init(jcfg, hw=(64, 64)):
    jmodel = JaxRAFTStereo(jcfg)
    dummy = jnp.zeros((1,) + hw + (3,), jnp.float32)
    init = jax.jit(lambda key: jmodel.init(key, dummy, dummy, iters=1,
                                           test_mode=True))
    return perturb(init(jax.random.PRNGKey(0)), np.random.default_rng(7))


@pytest.fixture(scope="module")
def servers():
    """(JAX server, port server), each over its engine, same weights."""
    jcfg = JaxConfig(**TINY)
    variables = _init(jcfg)
    jsvc = JaxService(jcfg, variables, JaxServeConfig(**SERVE))
    psvc = ServingEngine(RaftStereoConfig(**TINY),
                         state_dict_from_jax(variables),
                         ServeConfig(**SERVE), device="cpu")
    js = jhttp.StereoHTTPServer(jsvc, port=0).start()
    ps = phttp.StereoHTTPServer(psvc, port=0).start()
    yield js, ps
    for server, svc in ((js, jsvc), (ps, psvc)):
        server.shutdown()
        svc.close()


def _pair(hw=(48, 64), seed=3):
    rng = np.random.default_rng(seed)
    left = rng.integers(0, 255, hw + (3,), dtype=np.uint8)
    return left, np.roll(left, -3, axis=1)


def _npz(left, right):
    buf = io.BytesIO()
    np.savez(buf, left=left, right=right)
    return buf.getvalue()


def _call(url, method="GET", body=None, headers=None, timeout=300):
    req = urllib.request.Request(url, data=body, method=method,
                                 headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _json(body):
    return json.loads(body.decode())


# ----------------------------------------------------------- encodings
def test_encodings_byte_equal_to_jax():
    rng = np.random.default_rng(0)
    disp = rng.uniform(0, 80, (37, 53)).astype(np.float32)
    conf = rng.uniform(0, 1, (37, 53)).astype(np.float32)
    for fmt in ("npy", "png", "npz", "conf_png"):
        assert phttp._encode_disparity(disp, fmt, confidence=conf) == \
            jhttp._encode_disparity(disp, fmt, confidence=conf)
    for fmt in ("npz", "npy"):
        assert phttp._encode_disparity(disp, fmt) == \
            jhttp._encode_disparity(disp, fmt)
    for bad in (("conf_png", None), ("tiff", conf)):
        with pytest.raises(ValueError) as pe:
            phttp._encode_disparity(disp, bad[0], confidence=bad[1])
        with pytest.raises(ValueError) as je:
            jhttp._encode_disparity(disp, bad[0], confidence=bad[1])
        assert str(pe.value) == str(je.value)


def test_decode_pair_equal_to_jax():
    left, right = _pair()
    for body, ctype in ((_npz(left, right), "application/x-npz"),):
        for a, b in zip(phttp._decode_pair(body, ctype),
                        jhttp._decode_pair(body, ctype)):
            assert np.array_equal(a, b)
    buf = io.BytesIO()
    Image.fromarray(np.concatenate([left, right], axis=1)).save(buf, "PNG")
    got = phttp._decode_pair(buf.getvalue(), "image/png")
    assert np.array_equal(got[0], left) and np.array_equal(got[1], right)


# ------------------------------------------------------------- requests
def test_npz_to_npy_and_png_round_trips(servers):
    """npz in, npy out: the engine's disparity bit for bit.  A
    side-by-side PNG in, a 16-bit PNG out: the KITTI encoding of that
    disparity (JAX's encoder's bytes)."""
    _, ps = servers
    left, right = _pair()
    want = ps.service.infer(left, right, timeout=300).disparity
    st, hdr, body = _call(ps.url + "/v1/disparity", "POST", _npz(left, right),
                          {"Content-Type": "application/x-npz"})
    assert st == 200 and hdr["Content-Type"] == "application/x-npy"
    assert np.array_equal(np.load(io.BytesIO(body)), want)
    assert hdr["X-Tier"] == "quality" and hdr["X-Iters-Used"] == "1"
    assert hdr["X-Batch-Size"] == "1" and "X-Trace-Id" in hdr
    buf = io.BytesIO()
    Image.fromarray(np.concatenate([left, right], axis=1)).save(buf, "PNG")
    st, hdr, body = _call(ps.url + "/v1/disparity?format=png&tier=quality",
                          "POST", buf.getvalue(),
                          {"Content-Type": "image/png"})
    assert st == 200 and hdr["Content-Type"] == "image/png"
    assert body == jhttp._encode_disparity(want, "png")[0]
    back = np.asarray(Image.open(io.BytesIO(body))).astype(np.float32) / 256
    assert np.abs(back - np.clip(want, 0, None)).max() <= 1 / 256


ERROR_CASES = [
    # (method, path, body kind, headers)
    ("POST", "/v1/disparity?format=tiff", "npz", {}),
    ("POST", "/v1/disparity?tier=nope", "npz", {}),
    ("POST", "/v1/disparity?tier=xl", "npz", {}),
    ("POST", "/v1/disparity?tier=auto", "npz", {}),
    ("POST", "/v1/disparity?model=m", "npz", {}),
    ("POST", "/v1/disparity", "bad_npz", {}),
    ("POST", "/v1/disparity", "empty", {}),
    ("POST", "/v1/disparity", "odd_png", {"Content-Type": "image/png"}),
    ("POST", "/v1/disparity?format=conf_png", "npz", {}),
    ("POST", "/v1/stream/cam0", "npz", {}),
    ("POST", "/v1/stream", "npz", {}),
    ("DELETE", "/v1/stream/cam0", None, {}),
    ("DELETE", "/v1/stream", None, {}),
    ("DELETE", "/v1/other", None, {}),
    ("POST", "/v1/other", "npz", {}),
    ("GET", "/nope", None, {}),
    ("GET", "/quality", None, {}),
    ("GET", "/admin/models", None, {}),
    ("GET", "/admin/handoff", None, {}),
    ("GET", "/debug/flightrecorder", None, {}),
    ("POST", "/debug/flightrecorder", None, {}),
    ("POST", "/admin/brownout", "json_level", {}),
    ("POST", "/admin/brownout", "empty_json", {}),
    ("POST", "/admin/models", "json_register", {}),
    ("POST", "/admin/models", "json_retire", {}),
    ("POST", "/admin/models", "json_default_none", {}),
    ("POST", "/admin/models", "json_bad_action", {}),
]


def _body(kind):
    left, right = _pair()
    if kind == "npz":
        return _npz(left, right)
    if kind == "bad_npz":
        buf = io.BytesIO()
        np.savez(buf, a=left)
        return buf.getvalue()
    if kind == "odd_png":
        buf = io.BytesIO()
        Image.fromarray(left[:, :63]).save(buf, "PNG")
        return buf.getvalue()
    if kind == "empty":
        return b""
    return json.dumps({
        "json_level": {"level": 1}, "empty_json": {},
        "json_register": {"action": "register", "model": "m@1"},
        "json_retire": {"action": "retire", "model": "m"},
        "json_default_none": {"action": "set_default", "model": None},
        "json_bad_action": {"action": "boot"}}[kind]).encode()


@pytest.mark.parametrize("case", ERROR_CASES,
                         ids=lambda c: f"{c[0]} {c[1]} {c[2]}")
def test_error_mapping_equal_to_jax(servers, case):
    """The same request to both servers: the same status, the same typed
    JSON body and the same Content-Type."""
    method, path, kind, headers = case
    body = _body(kind) if kind else None
    out = []
    for server in servers:
        st, hdr, raw = _call(server.url + path, method, body, dict(headers))
        out.append((st, hdr.get("Content-Type"), _json(raw)))
    assert out[1] == out[0]
    assert out[0][0] >= 400 or path.startswith("/admin/models")


def test_overload_and_drain_statuses_equal_to_jax(servers):
    """Past ``max_queue`` both answer 429 with ``Retry-After: 1`` and the
    typed body; after ``begin_shutdown`` both answer 503 with
    ``Retry-After: 5`` and ``/readyz`` 503.  Measured on fresh engines
    (the module's servers keep serving)."""
    jcfg = JaxConfig(**TINY)
    variables = _init(jcfg)
    engines = [
        JaxService(jcfg, variables, JaxServeConfig(**SERVE)),
        ServingEngine(RaftStereoConfig(**TINY),
                      state_dict_from_jax(variables), ServeConfig(**SERVE),
                      device="cpu")]
    left, right = _pair()
    out = []
    for svc, mod in zip(engines, (jhttp, phttp)):
        server = mod.StereoHTTPServer(svc, port=0).start()
        try:
            svc.queue.pause()
            held = [svc.submit(left, right) for _ in range(4)]
            st, hdr, raw = _call(server.url + "/v1/disparity", "POST",
                                 _npz(left, right))
            full = (st, hdr.get("Retry-After"), _json(raw))
            svc.begin_shutdown()
            st, hdr, raw = _call(server.url + "/v1/disparity", "POST",
                                 _npz(left, right))
            draining = (st, hdr.get("Retry-After"), _json(raw))
            ready = _call(server.url + "/readyz")[0]
            health = _json(_call(server.url + "/healthz")[2])["status"]
            svc.queue.resume()
            assert svc.drain(timeout=300)
            assert all(f.result(timeout=1) is not None for f in held)
            out.append((full, draining, ready, health))
        finally:
            server.shutdown()
            svc.close()
    assert out[1] == out[0]
    assert out[0][0][:2] == (429, "1") and out[0][1][:2] == (503, "5")


def test_health_metrics_and_debug_surface(servers, tmp_path):
    """/healthz has JAX's keys; /readyz answers ready with JAX's keys;
    /metrics holds the serve_* families; /debug/compiles lists the
    programs; /debug/spans holds one sampled request's span tree with the
    JAX engine's span names; /debug/stacks is text; POST /debug/trace
    opens a window and a second POST gets 409."""
    left, right = _pair(seed=11)
    bodies = []
    for server in servers:
        st, hdr, _ = _call(server.url + "/v1/disparity", "POST",
                           _npz(left, right))
        assert st == 200
        trace_id = hdr["X-Trace-Id"]
        health = _json(_call(server.url + "/healthz")[2])
        ready_st, _, ready = _call(server.url + "/readyz")
        spans = _json(_call(server.url + f"/debug/spans?trace={trace_id}"
                            )[2])["spans"]
        compiles = _json(_call(server.url + "/debug/compiles")[2])
        metrics = _call(server.url + "/metrics")[2].decode()
        stacks = _call(server.url + "/debug/stacks")
        bodies.append(dict(
            health=sorted(health), health_status=health["status"],
            ready=(ready_st, sorted(_json(ready))),
            names=sorted({s["name"] for s in spans}),
            compiles=sorted(r["key"] for r in compiles["executables"]),
            families=sorted({ln.split("{")[0].split(" ")[0]
                             for ln in metrics.splitlines()
                             if ln.startswith("serve_")}),
            stacks=(stacks[0], stacks[1]["Content-Type"])))
    jb, pb = bodies
    assert pb["health"] == jb["health"]
    assert pb["ready"] == jb["ready"] and pb["ready"][0] == 200
    assert pb["names"] == jb["names"] == sorted(
        ["serve.request", "serve.admission", "serve.queue",
         "serve.dispatch", "serve.fetch", "serve.respond"])
    assert set(jb["families"]) <= set(pb["families"])
    assert "serving.forward(64x64,b1)" in pb["compiles"]
    assert set(pb["compiles"]) <= set(jb["compiles"]) | {
        k for k in pb["compiles"] if "tier=interactive" in k}
    assert pb["stacks"] == jb["stacks"]
    ps = servers[1]
    ps.trace.root = str(tmp_path / "profiles")
    st, _, raw = _call(ps.url + "/debug/trace", "POST",
                       json.dumps({"duration_ms": 300}).encode())
    assert st == 200 and "trace_dir" in _json(raw)
    st, _, _ = _call(ps.url + "/debug/trace", "POST", b"")
    assert st == 409
    ps.trace.stop()


# -------------------------------------------------------------------- CLI
def _dests(parser):
    return {a.dest: a.default for a in parser._actions
            if a.dest != "help"}


def test_cli_flags_and_defaults_equal_to_jax():
    """Every flag of JAX's ``raft-serve`` under the same name and default;
    the port adds ``--device`` only."""
    jd, pd = _dests(jserve_cli.build_parser()), _dests(
        serve_cli.build_parser())
    assert set(pd) - set(jd) == {"device"}
    assert {k: pd[k] for k in jd} == jd


REFUSED_FLAGS = [
    (["--sessions"], "§D6b"), (["--session_ttl_s", "5"], "§D6b"),
    (["--session_capacity", "3"], "§D6b"),
    (["--scene_cut_threshold", "9"], "§D6b"),
    (["--sessions", "--session_hidden"], "§D6b"), (["--ctx_cache_threshold", "1"],
                                     "§D6b"),
    (["--handoff_linger_s", "0"], "§D6b"),
    (["--cascade", "--confidence"], "§D6b"),
    (["--cascade_threshold", "0.2"], "§D6b"),
    (["--tile_threshold_pixels", "9"], "§D6b"), (["--tile_rows", "64"],
                                                 "§D6b"),
    (["--tile_halo", "8"], "§D6b"),
    (["--models", "m@1", "--model_store_dir", "/s"], "§D6b"),
    (["--model_store_dir", "/s"], "§D6b"),
    (["--executable_cache_dir", "/c"], "§D6b"),
    (["--executable_cache_max_bytes", "9"], "§D6b"),
    (["--executable_cache_read_only"], "§D6b"),
    (["--xl_mesh", "rows=2"], "§D7"), (["--xl_workers", "2"], "§D7"),
    (["--xl_threshold_pixels", "9"], "§D7"),
    (["--xl_max_pixels", "3000000"], "§D7"),
    (["--xl_batch_sizes", "1,2"], "§D7"),
    (["--rows_gru"], "§D7"),
]


@pytest.mark.parametrize("flags,tag", REFUSED_FLAGS,
                         ids=lambda x: " ".join(x) if isinstance(x, list)
                         else x)
def test_cli_refuses_deferred_flags(flags, tag, tmp_path):
    args = serve_cli.build_parser().parse_args(
        ["--restore_ckpt", str(tmp_path / "absent"), "--device", "cpu"]
        + flags)
    with pytest.raises(NotImplementedError, match=tag):
        serve_cli.build_service(args)


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """A port checkpoint of the TINY model and a reference ``.pth`` of the
    same architecture at the default ``fnet_dim`` (which a ``.pth`` does
    not record)."""
    root = tmp_path_factory.mktemp("serve_ckpts")
    jvars = _init(JaxConfig(**TINY))
    port_dir = str(root / "port")
    save_checkpoint(port_dir, RaftStereoConfig(**TINY),
                    state_dict_from_jax(jvars))
    pvars = _init(JaxConfig(hidden_dims=(32, 32, 32), corr_backend="reg"))
    pth = str(root / "ref.pth")
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in
                _reference_state_dict(pvars).items()}, pth)
    return port_dir, pth


@pytest.mark.parametrize("which", ["port", "pth"])
def test_cli_builds_a_service_and_wires_observability(checkpoints, which,
                                                      tmp_path):
    """``build_service`` from a port checkpoint and from a reference
    ``.pth``; ``build_observability`` attaches the anomaly sink, the
    event log to the cost registry and the watchdog; one request
    answers."""
    ckpt = checkpoints[0] if which == "port" else checkpoints[1]
    args = serve_cli.build_parser().parse_args(
        ["--restore_ckpt", ckpt, "--device", "cpu", "--valid_iters", "1",
         "--corr_implementation", "reg", "--tiers", "quality,interactive",
         "--event_log", str(tmp_path / "ev.jsonl"), "--watchdog",
         "--flight_recorder_dir", str(tmp_path / "fr"),
         "--warmup_shape", "48x64", "--batch_sizes", "1,2"])
    svc = serve_cli.build_service(args)
    try:
        assert svc.config.hidden_dims == (32, 32, 32)
        assert svc.config.fnet_dim == (64 if which == "port" else 256)
        assert not svc.ready and svc.warm_status()["warm_target"] == 4
        events, recorder, watchdog = serve_cli.build_observability(args, svc)
        assert svc.sink is not None and recorder is not None
        assert svc.costs.events is events and watchdog is not None
        svc.prewarm((48, 64))
        assert svc.ready
        left, right = _pair()
        assert svc.infer(left, right, tier="interactive",
                         timeout=300).tier == "interactive"
        watchdog.stop()
        events.close()
        lines = open(str(tmp_path / "ev.jsonl")).read().splitlines()
        assert sum('"compile"' in ln for ln in lines) == 4
    finally:
        svc.close()


def test_cli_process_serves_and_drains_on_sigterm(checkpoints):
    """``python -m raft_stereo_tpu_torch.cli.serve`` as its own process:
    it prewarms, answers a request, and on SIGTERM drains and exits 0."""
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="2")
    proc = subprocess.Popen(
        [sys.executable, "-u", "-m", "raft_stereo_tpu_torch.cli.serve",
         "--restore_ckpt", checkpoints[0], "--device", "cpu", "--port", "0",
         "--valid_iters", "1", "--tiers", "", "--batch_sizes", "1",
         "--warmup_shape", "48x64", "--no-cost_telemetry"],
        cwd=REPO, env=env, stderr=subprocess.PIPE, text=True)
    lines = []
    try:
        url = None
        t_end = time.monotonic() + 120
        while url is None and time.monotonic() < t_end:
            line = proc.stderr.readline()
            if not line:
                break
            lines.append(line)
            if "serving on http://" in line:
                url = line.split("serving on ")[1].split()[0]
        assert url, "".join(lines)
        assert _call(url + "/readyz")[0] == 200
        left, right = _pair()
        st, _, body = _call(url + "/v1/disparity", "POST", _npz(left, right))
        assert st == 200 and np.load(io.BytesIO(body)).shape == (48, 64)
        proc.send_signal(signal.SIGTERM)
        _, err = proc.communicate(timeout=120)
        lines.append(err)
        assert proc.returncode == 0, "".join(lines)
        text = "".join(lines)
        assert "graceful shutdown" in text and "drain complete" in text
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
