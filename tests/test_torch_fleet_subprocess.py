"""The fleet as processes, on the CPU: ``python -m
raft_stereo_tpu_torch.cli.route`` in front of two ``python -m
raft_stereo_tpu_torch.cli.serve --sessions`` replicas (``TINY`` weights,
48x64) sharing one artifact store.  A SIGTERM to the replica holding
sessions hands them over: every next frame answers 200 (zero 410s), the
moved sessions' first frames on the survivor are warm (adopted from the
handoff blob), and the drained process exits 0."""

import io
import json
import os
import signal
import socket
import subprocess
import sys
import time

import numpy as np
import torch

from raft_stereo_tpu_torch.config import RaftStereoConfig
from raft_stereo_tpu_torch.io.jax_weights import save_checkpoint
from raft_stereo_tpu_torch.models.raft_stereo import RAFTStereo
from raft_stereo_tpu_torch.serving.fleet import HashRing
from torch_fleet_support import call

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(hidden_dims=(32, 32, 32), fnet_dim=64, corr_backend="reg")
SESSIONS = 6


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _frame(sid: str, k: int) -> bytes:
    rng = np.random.default_rng(int(sid.rsplit("-", 1)[1]))
    left = np.roll(rng.integers(0, 255, (48, 64, 3), dtype=np.uint8), k,
                   axis=1)
    buf = io.BytesIO()
    np.savez(buf, left=left, right=np.roll(left, -3, axis=1))
    return buf.getvalue()


def _wait(url, proc, log, timeout=120.0, want=None):
    t_end = time.monotonic() + timeout
    while time.monotonic() < t_end:
        assert proc.poll() is None, open(log).read()[-3000:]
        try:
            status, _, raw = call(url + "/readyz", timeout=5)
        except OSError:
            status = None
        if status == 200 and (want is None or want(raw)):
            return
        time.sleep(0.1)
    raise AssertionError(f"{url} not ready: " + open(log).read()[-3000:])


def test_route_cli_drain_moves_sessions_with_zero_410(tmp_path):
    torch.manual_seed(0)
    ckpt = str(tmp_path / "ckpt")
    cfg = RaftStereoConfig(**TINY)
    save_checkpoint(ckpt, cfg, RAFTStereo(cfg).state_dict())
    store = str(tmp_path / "store")
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="2")
    procs, logs, urls = {}, {}, {}

    def start(name, argv, port):
        logs[name] = str(tmp_path / f"{name}.log")
        with open(logs[name], "w") as fh:
            procs[name] = subprocess.Popen(
                [sys.executable, "-u", "-m"] + argv, cwd=REPO, env=env,
                stdout=fh, stderr=subprocess.STDOUT)
        urls[name] = f"http://127.0.0.1:{port}"

    try:
        for name in ("a", "b"):
            port = _free_port()
            start(name, [
                "raft_stereo_tpu_torch.cli.serve", "--restore_ckpt", ckpt,
                "--device", "cpu", "--port", str(port), "--valid_iters",
                "1", "--tiers", "", "--batch_sizes", "1", "--max_batch",
                "1", "--sessions", "--session_ttl_s", "600",
                "--warmup_shape", "48x64", "--executable_cache_dir", store,
                "--no-cost_telemetry", "--handoff_linger_s", "20",
                "--flight_recorder_dir", str(tmp_path / f"fr-{name}")],
                port)
        port = _free_port()
        start("router", [
            "raft_stereo_tpu_torch.cli.route", "--port", str(port),
            "--replica", f"a={urls['a']}", "--replica", f"b={urls['b']}",
            "--health_poll_s", "0.1", "--fail_after", "2",
            "--request_timeout_s", "60", "--no-fleet_brownout"], port)
        for name in ("a", "b"):
            _wait(urls[name], procs[name], logs[name])
        _wait(urls["router"], procs["router"], logs["router"],
              want=lambda raw: json.loads(raw)["ready_replicas"] == 2)

        sids = [f"cam-{i}" for i in range(SESSIONS)]
        owner = {sid: HashRing(["a", "b"]).lookup(sid) for sid in sids}
        victim = max("ab", key=lambda n: sum(o == n for o in owner.values()))
        moved = [sid for sid in sids if owner[sid] == victim]
        assert moved and len(moved) < SESSIONS
        answers = {sid: [] for sid in sids}
        for k in range(2):
            for sid in sids:
                st, hdrs, _ = call(urls["router"] + f"/v1/stream/{sid}",
                                   "POST", _frame(sid, k), timeout=60)
                answers[sid].append((st, hdrs.get("X-Warm")))
        procs[victim].send_signal(signal.SIGTERM)
        for k in range(2, 4):
            for sid in sids:
                st, hdrs, _ = call(urls["router"] + f"/v1/stream/{sid}",
                                   "POST", _frame(sid, k), timeout=60)
                answers[sid].append((st, hdrs.get("X-Warm")))
        assert procs[victim].wait(timeout=60) == 0, \
            open(logs[victim]).read()[-3000:]
        st, _, raw = call(urls["router"] + "/fleet")
        fleet = json.loads(raw)
        _, _, metrics = call(urls["router"] + "/metrics")
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
            p.wait(timeout=30)
    assert all(a == (200, "0") for s in sids for a in answers[s][:1])
    assert all(a == (200, "1") for s in sids for a in answers[s][1:]), \
        answers
    assert fleet["in_rotation"] == [n for n in "ab" if n != victim]
    assert fleet["sessions_pending_loss"] == 0
    text = metrics.decode()
    assert "fleet_sessions_lost_total 0" in text
    assert f"fleet_handoff_sessions_total {len(moved)}" in text
    assert "fleet_handoff_manifests_total 1" in text
