"""The port's telemetry against the JAX package's (CPU).

Each pure-Python module takes one call sequence through
``raft_stereo_tpu.telemetry.X`` and ``raft_stereo_tpu_torch.telemetry.X``
and the results are compared: the Prometheus text byte for byte, event
records less their clock and run metadata, span trees and Chrome traces
under one fake clock and one seed, SLO burn rates, quality PSI, the
watchdogs' firings and the flight recorder's bundles.  Then the port's
own surface: the HTTP routes and their error statuses on an ephemeral
port, a TINY training run through ``cli/train.py main`` scraped while it
runs (after tests/test_telemetry.py's scraped run), and the disabled
path: with telemetry off the parameters after three steps are bit-equal
to a run with it on, and the loop drains its metrics as many times.
"""

import json
import math
import os
import random
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from raft_stereo_tpu import telemetry as jtel
from raft_stereo_tpu.telemetry import quality as jquality
from raft_stereo_tpu.telemetry import slo as jslo
from raft_stereo_tpu.telemetry import spans as jspans
from raft_stereo_tpu.telemetry import watchdog as jwatchdog
from raft_stereo_tpu_torch import telemetry as ttel
from raft_stereo_tpu_torch.cli import train as tcli
from raft_stereo_tpu_torch.config import RaftStereoConfig, TrainConfig
from raft_stereo_tpu_torch.telemetry import quality as tquality
from raft_stereo_tpu_torch.telemetry import slo as tslo
from raft_stereo_tpu_torch.telemetry import spans as tspans
from raft_stereo_tpu_torch.telemetry import watchdog as twatchdog
from raft_stereo_tpu_torch.training import train_loop
from torch_train_support import make_sceneflow_train

TINY = dict(hidden_dims=(32, 32, 32), fnet_dim=64)
SIDES = {"jax": (jtel, jspans, jslo, jquality, jwatchdog),
         "port": (ttel, tspans, tslo, tquality, twatchdog)}


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def both(fn):
    """``fn(modules)`` on the JAX side and the port's, global RNG reseeded
    before each."""
    out = {}
    for side, mods in SIDES.items():
        random.seed(7)
        out[side] = fn(*mods)
    return out["jax"], out["port"]


class FakeClock:
    def __init__(self, step=0.001):
        self.t, self.step = 100.0, step

    def __call__(self):
        self.t += self.step
        return self.t


# ------------------------------------------------------------- registry
def test_prometheus_text_byte_for_byte(monkeypatch):
    def drive(tel, *_):
        monkeypatch.setattr(time, "time", FakeClock())   # exemplar stamps
        reg = tel.MetricsRegistry()
        c = reg.counter("req_total", 'help with \\ and "quotes"\nline',
                        labels={"tier": 'a"b\\c\nd', "model": "m"})
        c.inc(3)
        reg.counter("req_total", "h", labels={"tier": "x", "model": "m"})
        g = reg.gauge("depth", "queue depth")
        g.set(2.5)
        g.inc(0.5)
        g.dec(1)
        h = reg.histogram("lat_seconds", "latency",
                          buckets=(0.001, 0.01, 0.1, 1.0))
        for v in (0.0005, 0.004, 0.05, 0.5, 5.0, 0.02):
            h.observe(v, exemplar=f"{int(v * 1e4):016x}")
        reg.histogram("empty_seconds", "nothing yet")
        return (reg.render_text(), h.percentiles(), h.mean(),
                h.exemplars(), tel.escape_label_value('q"\\\n'),
                tel.unescape_label_value(tel.escape_label_value('q"\\\n')))

    j, p = both(drive)
    assert p == j


# ---------------------------------------------------------------- events
def _strip(rec):
    return {k: v for k, v in rec.items() if k not in ("ts", "run")}


def test_event_records_and_replay_match(tmp_path):
    def drive(tel, *_, path):
        with tel.EventLog(path) as log:
            log.emit("run_start", name="n", start_step=0)
            log.emit("step_stats", step=3, means={"loss": np.float32(1.5)},
                     arr=np.arange(3))
            log.emit("run_end", status="complete", step=3)
        with open(path, "a") as f:
            f.write('{"torn": ')
        return ([_strip(r) for r in tel.replay(path)],
                _strip(tel.bench_record({"metric": "m", "value": 1},
                                        extra=2)))

    j = drive(*SIDES["jax"], path=str(tmp_path / "j.jsonl"))
    p = drive(*SIDES["port"], path=str(tmp_path / "p.jsonl"))
    assert p == j
    assert ttel.SCHEMA_VERSION == jtel.SCHEMA_VERSION


def test_run_metadata_names_torch_and_the_device(tmp_path):
    meta = ttel.run_metadata("cpu")
    assert meta["torch_version"] == torch.__version__
    assert {k: meta[k] for k in ("platform", "device_kind", "n_devices",
                                 "process_index", "process_count")} == {
        "platform": "cpu", "device_kind": "cpu", "n_devices": 1,
        "process_index": 0, "process_count": 1}
    assert set(jtel.run_metadata()) - {"jax_version"} <= set(meta)
    rec = ttel.write_record(str(tmp_path / "r.json"), {"metric": "m"},
                            indent=1, device="cpu")
    assert json.load(open(tmp_path / "r.json")) == rec
    assert rec["schema_version"] == 1 and rec["metric"] == "m"


# ----------------------------------------------------------------- spans
@pytest.fixture(autouse=True)
def one_wall_anchor(monkeypatch):
    """Each package anchors the monotonic clock to wall time once, at
    import: give both the same anchor."""
    for mod in (jspans, tspans):
        monkeypatch.setattr(mod, "_ANCHOR_PERF", 0.0)
        monkeypatch.setattr(mod, "_ANCHOR_WALL", 1.0e6)


def _span_rows(tracer):
    return [s.to_dict() for s in tracer.spans()]


def _chrome(trace):
    """A Chrome trace's events less the process name (each package names
    itself)."""
    return [e for e in trace["traceEvents"]
            if e.get("name") != "process_name"]


def test_span_trees_and_chrome_traces_match(monkeypatch):
    def drive(tel, spans, *_):
        clock = FakeClock()
        monkeypatch.setattr(time, "perf_counter", clock)
        monkeypatch.setattr(time, "time", clock)
        tracer = tel.SpanTracer(0.5, seed=3)
        for i in range(6):
            trace = tracer.start_trace("serve.request", request=i)
            with tracer.span("queue", trace):
                with tracer.span("device", trace, bucket="64x96"):
                    pass
            tracer.add_span("fetch", trace, 200.0 + i, 200.5 + i, n=i)
            tracer.finish_trace(trace)
        ctx = spans.decode_traceparent(
            spans.encode_traceparent("ab" * 8, "cd" * 4))
        adopted = tracer.adopt_trace(ctx, "replica.request")
        tracer.finish_trace(adopted)
        return (_span_rows(tracer), tracer.stats(),
                _chrome(tel.to_chrome_trace(tracer.spans())),
                spans.encode_traceparent("01" * 8, "02" * 4),
                spans.decode_traceparent("garbage"))

    j, p = both(drive)
    assert p == j
    assert len(p[0]) > 6


# --------------------------------------------------------- SLO, quality
def test_slo_burn_rates_and_trips_match():
    def drive(tel, spans, slo, *_):
        clock = FakeClock(step=1.0)
        reg = tel.MetricsRegistry()
        tracker = slo.BurnRateTracker(0.99, latency_ms=50.0, registry=reg,
                                      windows=(("5s", 5.0), ("30s", 30.0)),
                                      clock=clock)
        fired = []

        class Sink:
            def fire(self, kind, **detail):
                fired.append((kind, detail))
        dog = slo.SloWatchdog(tracker, Sink(), fast_burn=2.0, slow_burn=1.0,
                              id_fn=lambda: "t" * 16)
        burns, checks = [], []
        good = bad = 0
        for i in range(60):
            good += 10
            bad += 5 if 20 <= i < 40 else 0
            burns.append(tracker.sample(good, bad))
            checks.append(dog.check())
        return burns, checks, fired, tracker.status(), reg.render_text()

    j, p = both(drive)
    assert p == j
    assert any(p[1])


def test_quality_psi_and_drift_match():
    def drive(tel, spans, slo, quality, *_):
        rng = np.random.default_rng(4)
        reg = tel.MetricsRegistry()
        fired = []

        class Sink:
            def fire(self, kind, **detail):
                fired.append((kind, detail))
        tracker = quality.QualityTracker(registry=reg, sink=Sink(),
                                         drift_reference_size=64,
                                         drift_window=32)
        psis = []
        for i in range(200):
            mu = 0.8 if i < 100 else 0.3
            tracker.observe("fast" if i % 3 else None, "m",
                            float(np.clip(rng.normal(mu, 0.05), 0, 1)))
            psis.append(tracker.drift.psi())
        return (psis, fired, tracker.status(), tracker.totals(),
                tracker.mean_confidence("fast"), reg.render_text())

    j, p = both(drive)
    assert p == j
    assert p[1] and p[1][0][0] == "quality_drift"


# -------------------------------------------------------------- watchdogs
def test_watchdog_firings_match(tmp_path, monkeypatch):
    def drive(tel, spans, slo, quality, watchdog, root):
        clock = FakeClock(step=0.0)
        monkeypatch.setattr(time, "monotonic", clock)
        path = os.path.join(root, "events.jsonl")
        events = tel.EventLog(path)
        reg = tel.MetricsRegistry()
        sink = watchdog.AnomalySink(
            events=events, counter=reg.counter("anomalies_total", "a"))
        sentinel = watchdog.NonFiniteSentinel(sink)
        fires = [sentinel.check({"loss": v}, i)
                 for i, v in enumerate([1.0, math.nan, math.inf, 2.0,
                                        math.nan])]
        stall = watchdog.StepStallWatchdog(sink, factor=3.0, min_stall_s=1.0)
        stall_fires = []
        for i in range(6):
            stall.note_step(i)
            clock.t += 0.5
            stall_fires.append(stall.check())
        clock.t += 10.0
        stall_fires += [stall.check(), stall.check()]

        class Stub:   # the serving instruments ServingWatchdog reads
            queue_depth = reg.gauge("serve_queue_depth", "q")
            admitted = reg.counter("serve_admitted_total", "a")
            deadline_missed = reg.counter("serve_deadline_missed_total", "m")
        serving = watchdog.ServingWatchdog(sink, Stub(), max_queue=10,
                                           sustain_s=1.0, min_events=4)
        serve_fires = []
        for depth, adm, miss in ((9, 5, 0), (10, 5, 4), (10, 5, 5),
                                 (2, 5, 0), (9, 5, 1)):
            Stub.queue_depth.set(depth)
            Stub.admitted.inc(adm)
            Stub.deadline_missed.inc(miss)
            clock.t += 0.6
            serve_fires.append(list(serving.check()))
        events.close()
        return (fires, stall_fires, serve_fires, sink.anomalies,
                [_strip(r) for r in tel.replay(path)], reg.render_text())

    j = drive(*SIDES["jax"], root=str(tmp_path / "j"))
    p = drive(*SIDES["port"], root=str(tmp_path / "p"))
    assert p == j
    assert any(p[0]) and any(p[1]) and any(p[2])


def test_flight_recorder_bundles_match(tmp_path, monkeypatch):
    def drive(tel, spans, slo, quality, watchdog, root):
        random.seed(7)
        clock = FakeClock()
        monkeypatch.setattr(time, "perf_counter", clock)
        tracer = tel.SpanTracer(1.0, seed=1)
        trace = tracer.start_trace("train.step", step=1)
        tracer.finish_trace(trace)
        reg = tel.MetricsRegistry()
        reg.counter("x_total", "x").inc(2)
        rec = tel.FlightRecorder(root, tracer=tracer, registry=reg,
                                 event_ring=2)
        events = tel.EventLog(os.path.join(root, "events.jsonl"))
        events.add_sink(rec.record_event)
        for i in range(3):
            events.emit("step_stats", step=i)
        events.close()
        bundle = rec.dump("non finite!", detail={"step": 3})
        assert rec.dump("again") is None   # rate-limited
        files = {"trace.json": _chrome(json.load(open(
                     os.path.join(bundle, "trace.json")))),
                 "spans.jsonl": [json.loads(line)["name"] for line in
                                 open(os.path.join(bundle, "spans.jsonl"))],
                 "metrics.prom": open(os.path.join(bundle,
                                                   "metrics.prom")).read()}
        files["events"] = [_strip(json.loads(line)) for line in
                           open(os.path.join(bundle, "events.jsonl"))]
        manifest = json.load(open(os.path.join(bundle, "manifest.json")))
        status = rec.status()
        return (os.path.basename(bundle), files,
                {k: manifest[k] for k in ("trigger", "detail", "n_spans",
                                          "n_events", "files")},
                {k: v for k, v in status.items()
                 if k not in ("root", "bundles")},
                json.load(open(os.path.join(bundle, "device_memory.json"))))

    j = drive(*SIDES["jax"], root=str(tmp_path / "j"))
    p = drive(*SIDES["port"], root=str(tmp_path / "p"))
    assert p[:4] == j[:4]
    assert p[4] == {}                                # no card here
    stacks = ttel.dump_all_stacks()
    assert " threads at " in stacks.splitlines()[0]
    assert "--- thread MainThread" in stacks


# ------------------------------------------------------- train telemetry
def test_train_telemetry_exposes_the_jax_metric_names_and_labels():
    def families(text):
        return sorted({line.split("{")[0].split(" ")[0]
                       for line in text.splitlines()
                       if line and not line.startswith("#")}
                      | {line for line in text.splitlines()
                         if line.startswith("# TYPE")})

    def drive(tel, *_):
        tm = tel.TrainTelemetry(costs=tel.CompileRegistry(
            registry=None, device_peak_tflops=100.0))
        tm.run_start(RaftStereoConfig(**TINY), TrainConfig(num_steps=9), 0)
        tm.note_batch({"left": np.zeros((2, 4, 4, 3), np.float32)})
        tm.observe_step(1, data_wait_s=0.01, dispatch_s=0.02)
        tm.observe_drain(0.003, {"loss": 1.0}, 1, window=1)
        tm.observe_gru_deltas([0.5, 0.1])
        tm.observe_anomaly_skip(1, "spike")
        tm.observe_loader_stats({"retried": 2, "quarantined": 1})
        tm.observe_checkpoint(0.1, "ck", 1)
        tm.observe_checkpoint_rejected("old", "torn")
        tm.run_end("complete", 1)
        return families(tm.registry.render_text()), {
            k: v for k, v in tm.healthz().items() if k != "last_step_age_s"}

    j, p = both(drive)
    assert p == j


def test_build_inside_a_step_after_step_one_counts_as_a_recompile(tmp_path):
    from raft_stereo_tpu_torch import profiling
    from raft_stereo_tpu_torch.telemetry.events import replay

    path = str(tmp_path / "e.jsonl")
    tm = ttel.TrainTelemetry(events=ttel.EventLog(path))
    batch = {"left": torch.zeros(2, 8, 8, 3)}
    tm.note_batch(batch)
    profiling.note_build("kernel_build:corr_lookup", 3.0)  # step 1: expected
    tm.observe_step(1, 0.0, 0.1)
    profiling.note_build("graph_capture", 0.5)   # between steps: validation
    tm.note_batch(batch)
    profiling.note_build("graph_capture", 0.2)   # inside step 2: counted
    tm.observe_step(2, 0.0, 0.1)
    tm.run_end("complete", 2)
    profiling.note_build("graph_capture", 0.2)   # after the run: detached
    tm.events.close()
    assert tm.recompiles.value == 1
    (event,) = [e for e in replay(path) if e["event"] == "compile"]
    # the step of the event is the last completed one, as in JAX
    assert event["name"] == "graph_capture" and event["step"] == 1
    assert event["batch_shapes"] == {"left": "(2, 8, 8, 3):torch.float32"}


# ------------------------------------------------------------------- http
def _get(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.status, r.read()


def _post(url, body=b""):
    req = urllib.request.Request(url, data=body, method="POST")
    with urllib.request.urlopen(req, timeout=10) as r:
        return r.status, json.loads(r.read())


def _status(fn, *args):
    with pytest.raises(urllib.error.HTTPError) as e:
        fn(*args)
    return e.value.code


def test_http_routes_and_error_statuses(tmp_path):
    reg = ttel.MetricsRegistry()
    reg.counter("x_total", "t").inc(3)
    bare = ttel.TelemetryHTTPServer(reg, lambda: {"status": "ok"},
                                    port=0).start()
    tracer = ttel.SpanTracer(1.0, seed=0)
    trace = tracer.start_trace("train.step")
    tracer.finish_trace(trace)
    costs = ttel.CompileRegistry(registry=reg)
    costs.record("train.step", "train", 1.5, flops=2e9)
    full = ttel.TelemetryHTTPServer(
        reg, lambda: {"status": "running"}, port=0,
        trace=ttel.TraceCapture(root=str(tmp_path / "profiles")),
        tracer=tracer, costs=costs,
        recorder=ttel.FlightRecorder(str(tmp_path / "fr"),
                                     tracer=tracer)).start()
    try:
        assert b"x_total 3" in _get(bare.url + "/metrics")[1]
        assert json.loads(_get(bare.url + "/healthz")[1]) == {"status": "ok"}
        assert _status(_get, bare.url + "/nope") == 404
        for route in ("/debug/spans", "/debug/flightrecorder",
                      "/debug/compiles"):
            assert _status(_get, bare.url + route) == 404
        assert _status(_post, bare.url + "/debug/flightrecorder") == 404
        assert _status(_post, bare.url + "/nope") == 404
        assert _status(_post, bare.url + "/debug/trace",
                       b'{"duration_ms": "soon"}') == 400
        assert _status(_post, bare.url + "/debug/trace", b"[1]") == 400
        assert _status(_post, bare.url + "/debug/trace",
                       b'{"duration_ms": -1}') == 400
        assert _status(_post, bare.url + "/debug/trace",
                       b"x" * 5000) == 400

        spans = json.loads(_get(full.url + "/debug/spans")[1])
        assert [e["name"] for e in spans["traceEvents"]
                if e["ph"] == "X"] == ["train.step"]
        one = json.loads(_get(full.url + "/debug/spans?trace="
                              + trace.trace_id)[1])
        assert one["trace_id"] == trace.trace_id and len(one["spans"]) == 1
        ex = json.loads(_get(full.url + "/debug/spans?exemplars=1")[1])
        assert set(ex) == {"stats", "exemplars", "trace"}
        assert b"--- thread" in _get(full.url + "/debug/stacks")[1]
        compiles = json.loads(_get(full.url + "/debug/compiles")[1])
        assert compiles["count"] == 1
        assert compiles["executables"][0]["flops"] == 2e9
        assert json.loads(_get(full.url + "/debug/flightrecorder")[1])[
            "dumps"] == 0
        assert os.path.isdir(_post(full.url + "/debug/flightrecorder")[1][
            "bundle"])
        code, info = _post(full.url + "/debug/trace",
                           b'{"duration_ms": 2000}')
        assert code == 200 and info["duration_ms"] == 2000
        assert _status(_post, full.url + "/debug/trace") == 409
        assert full.trace.stop()
        assert os.path.exists(os.path.join(info["trace_dir"], "trace.json"))
    finally:
        bare.shutdown()
        full.shutdown()


# ------------------------------------------------- a scraped training run
@pytest.fixture(scope="module")
def scraped(tmp_path_factory):
    """``cli/train.py main`` with --metrics_port 0 --event_log at TINY
    widths on the CPU, scraped from a thread while it runs."""
    root = str(tmp_path_factory.mktemp("scraped"))
    make_sceneflow_train(os.path.join(root, "data"), n=4)
    built = {}
    real = tcli.build_telemetry

    def capture(args, model_cfg, train_cfg):
        built["parts"] = real(args, model_cfg, train_cfg)
        return built["parts"]

    scrapes = {"metrics": [], "healthz": [], "spans": [], "compiles": []}
    done = threading.Event()

    def scrape():
        while "parts" not in built and not done.is_set():
            time.sleep(0.01)
        url = built["parts"][1].url
        posted = False
        while not done.is_set():
            try:
                for route, key in (("/metrics", "metrics"),
                                   ("/healthz", "healthz"),
                                   ("/debug/spans", "spans"),
                                   ("/debug/compiles", "compiles")):
                    scrapes[key].append(_get(url + route)[1].decode())
                if not posted and built["parts"][0].steps.value >= 1:
                    scrapes["trace"] = _post(url + "/debug/trace",
                                             b'{"duration_ms": 100}')[1]
                    posted = True
            except (urllib.error.URLError, ConnectionError):
                pass   # the endpoint shut down at the end of the run
            time.sleep(0.02)

    argv = ["--data_root", os.path.join(root, "data"), "--checkpoint_dir",
            os.path.join(root, "ck"), "--log_dir", os.path.join(root, "runs"),
            "--batch_size", "2", "--image_size", "32", "64", "--train_iters",
            "2", "--hidden_dims", "32", "32", "32", "--num_steps", "5",
            "--validation_frequency", "5", "--seed", "3", "--device", "cpu",
            "--metrics_port", "0", "--event_log",
            os.path.join(root, "events.jsonl"), "--trace_sample_rate", "1.0",
            "--gru_telemetry"]
    thread = threading.Thread(target=scrape, daemon=True)
    tcli.build_telemetry = capture
    try:
        thread.start()
        state = tcli.main(argv)
    finally:
        tcli.build_telemetry = real
        done.set()
        thread.join(timeout=10)
    tel = built["parts"][0]
    return dict(state=state, telemetry=tel, scrapes=scrapes,
                events=list(ttel.replay(os.path.join(root, "events.jsonl"))))


def test_scraped_run_serves_its_steps(scraped):
    tel, scrapes = scraped["telemetry"], scraped["scrapes"]
    assert scraped["state"].step == 5 and tel.steps.value == 5
    text = tel.registry.render_text()
    for needle in ("train_steps_total 5", "train_recompiles_total 0",
                   "train_step_seconds_count 5",
                   "train_data_wait_seconds_count 5",
                   "train_metric_drain_seconds_count",
                   "train_checkpoint_seconds_count 2",
                   "train_host_rss_bytes", "train_step_flops",
                   "compiles_total 1"):
        assert needle in text, needle
    seen = [m for m in scrapes["metrics"] if "train_steps_total" in m]
    assert seen and any("train_step_seconds_count" in m for m in seen)
    health = [json.loads(h) for h in scrapes["healthz"]]
    assert {h["status"] for h in health} <= {"starting", "running",
                                            "complete"}
    assert any(h["step"] >= 1 for h in health)
    assert any(json.loads(s)["traceEvents"] for s in scrapes["spans"])
    compiles = json.loads(scrapes["compiles"][-1])
    (rec,) = compiles["executables"]
    assert rec["key"] == "train.step" and rec["site"] == "train"
    assert rec["flops"] > 0 and rec["degraded"]      # no allocator here
    assert scrapes["trace"]["duration_ms"] == 100
    assert os.path.exists(os.path.join(scrapes["trace"]["trace_dir"],
                                       "trace.json"))
    assert tel.gru_delta.count == 5


def test_scraped_run_replays_as_a_timeline(scraped):
    recs = scraped["events"]
    kinds = [r["event"] for r in recs]
    assert kinds[0] == "run_start" and kinds[-1] == "run_end"
    assert recs[0]["run"]["platform"] == "cpu"
    assert recs[0]["train_config"]["num_steps"] == 5
    assert "step_stats" in kinds and "checkpoint" in kinds
    # the step's first dispatch is recorded before the first drain; no
    # build happens inside a later step
    compiles = [r for r in recs if r["event"] == "compile"]
    assert [c.get("site") for c in compiles] == ["train"]
    assert recs[-1]["status"] == "complete" and recs[-1]["step"] == 5
    assert [r["seq"] for r in recs] == list(range(len(recs)))


# -------------------------------------------------- the disabled path
def test_telemetry_off_is_bit_equal_and_drains_as_often(tmp_path,
                                                       monkeypatch):
    from raft_stereo_tpu_torch.data.synthetic import SyntheticStereoLoader

    real_fetch = train_loop._fetch
    runs = {}
    for name, tel in (("off", None), ("on", ttel.TrainTelemetry(
            costs=ttel.CompileRegistry()))):
        calls = [0]

        def counting(*a, **k):
            calls[0] += 1
            return real_fetch(*a, **k)
        monkeypatch.setattr(train_loop, "_fetch", counting)
        state = train_loop.train(
            RaftStereoConfig(**TINY),
            TrainConfig(batch_size=2, image_size=(32, 64), train_iters=2,
                        num_steps=3, validation_frequency=2, seed=3),
            loader=SyntheticStereoLoader(2, (32, 64), seed=0),
            checkpoint_dir=str(tmp_path / name), log_dir=None,
            device="cpu", telemetry=tel)
        runs[name] = (state, calls[0])
    (off, n_off), (on, n_on) = runs["off"], runs["on"]
    assert n_off == n_on > 0
    for (k, a), (_, b) in zip(off.model.state_dict().items(),
                              on.model.state_dict().items()):
        assert torch.equal(a, b), k
