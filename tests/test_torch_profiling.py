"""The port's ``profiling.py`` on the CPU: ``chained_seconds_per_call``
against the JAX package's on one fake clock, the memory readers' CPU
answers, ``trace`` writing a Chrome trace that holds an ``annotate``
range, the exclusion of profiler windows and CUDA-graph captures, the
build-event hook, ``make_forward_chain`` and ``TraceCapture``'s bounded
window."""

import contextlib
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from raft_stereo_tpu import profiling as jprofiling
from raft_stereo_tpu_torch import profiling
from raft_stereo_tpu_torch.telemetry import TraceBusy, TraceCapture


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


@pytest.mark.parametrize("reduce", [np.median, np.mean])
def test_chained_seconds_per_call_matches_jax(monkeypatch, reduce):
    out = []
    for mod in (jprofiling, profiling):
        clock = FakeClock()
        monkeypatch.setattr(time, "perf_counter", clock)
        jitter = iter([0.0, 0.003, 0.001, 0.0, 0.002, 0.004, 0.0, 0.0,
                       0.001, 0.0] * 3)

        def make_chain(k):
            def run():
                clock.t += 0.05 + k * 0.01 + next(jitter)
            return run
        out.append(mod.chained_seconds_per_call(make_chain, repeats=4,
                                                reduce=reduce))
    assert out[0] == out[1]
    assert out[1] == pytest.approx(0.01, abs=3e-4)


def test_chained_seconds_per_call_refuses_a_non_positive_estimate(
        monkeypatch):
    clock = FakeClock()
    monkeypatch.setattr(time, "perf_counter", clock)
    with pytest.raises(RuntimeError, match="non-positive"):
        profiling.chained_seconds_per_call(lambda k: (lambda: None))


def test_memory_readers_on_the_cpu():
    assert profiling.device_memory_stats() == {}
    assert profiling.device_memory_stats("cpu") == {}
    if not torch.cuda.is_available():
        assert profiling.device_hbm_bytes(fallback=123) == 123
        assert profiling.device_hbm_bytes() == 16 * 2 ** 30


def test_trace_writes_a_chrome_trace_holding_the_annotations(tmp_path):
    with profiling.trace(str(tmp_path / "t")) as log_dir:
        with profiling.annotate("gru_iter"):
            with profiling.annotate("upsample"):
                torch.ones(64, 64) @ torch.ones(64, 64)
    events = json.load(open(os.path.join(log_dir, profiling.TRACE_FILE)))[
        "traceEvents"]
    names = {e.get("name") for e in events}
    assert {"gru_iter", "upsample", "aten::mm"} <= names


def test_annotate_enters_ranges_only_while_a_profiler_records(monkeypatch):
    entered = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: entered.append(name)
                        or contextlib.nullcontext())
    with profiling.annotate("gru_iter"):
        pass
    assert entered == []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiling.annotate("gru_iter"):
            pass
    assert entered == ["gru_iter"]


def test_graph_capture_and_trace_exclude_each_other(tmp_path):
    # inside a window of the same thread a capture raises, and the reverse
    with profiling.trace(str(tmp_path / "a")):
        with pytest.raises(RuntimeError, match="profiler window"):
            with profiling.graph_capture():
                pass
    with profiling.graph_capture():
        with pytest.raises(RuntimeError, match="CUDA graph capture"):
            with profiling.trace(str(tmp_path / "b")):
                pass
    # across threads a capture waits for the open window to close
    opened, order = threading.Event(), []

    def window():
        with profiling.trace(str(tmp_path / "c")):
            opened.set()
            time.sleep(0.3)
            order.append("window closed")

    t = threading.Thread(target=window)
    t.start()
    opened.wait(10)
    with profiling.graph_capture():
        order.append("captured")
    t.join()
    assert order == ["window closed", "captured"]


def test_build_listeners_hear_captures_and_builds():
    heard = []

    def listener(event, seconds):
        heard.append(event)

    profiling.add_build_listener(listener)
    try:
        with profiling.graph_capture():
            pass
        profiling.note_build("kernel_build:gru_gates", 1.0)
    finally:
        profiling.remove_build_listener(listener)
    profiling.note_build("graph_capture", 1.0)
    assert heard == ["graph_capture", "kernel_build:gru_gates"]


def test_forward_chain_sums_k_perturbed_forwards():
    seen = []

    def apply_fn(variables, a, b):
        seen.append(float(a[0]))
        return variables * (a + b)

    img = torch.zeros(2)
    chain = profiling.make_forward_chain(apply_fn, torch.tensor(3.0), img,
                                         img + 1)
    assert chain(4)() == pytest.approx(4 * 3.0 + 3.0 * 1e-6 * 6)
    assert seen == pytest.approx([0.0, 1e-6, 2e-6, 3e-6])


def test_trace_capture_is_one_bounded_window_at_a_time(tmp_path):
    capture = TraceCapture(root=str(tmp_path))
    gate_held = []

    def gate():
        class Held:
            def __enter__(self):
                gate_held.append(True)

            def __exit__(self, *exc):
                pass
        return Held()

    capture.gate = gate
    with pytest.raises(ValueError):
        capture.start(duration_ms=0)
    info = capture.start(duration_ms=120)
    assert capture.active and info["duration_ms"] == 120
    with pytest.raises(TraceBusy):
        capture.start()
    deadline = time.monotonic() + 10
    while capture.active and time.monotonic() < deadline:
        time.sleep(0.02)
    assert not capture.active and capture.error is None and gate_held
    assert os.path.exists(os.path.join(info["trace_dir"], "trace.json"))
    assert not capture.stop()
    second = capture.start(duration_ms=60_000_000)
    assert second["duration_ms"] == 60_000.0    # clamped
    assert capture.stop() and not capture.active
    assert second["trace_dir"].endswith("ondemand-1")
