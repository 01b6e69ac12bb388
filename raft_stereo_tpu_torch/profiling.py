"""Profiling and timing: the JAX package's ``profiling.py`` on torch.

* ``trace(log_dir)``: a ``torch.profiler`` window over the block, CPU
  and, on the card, CUDA activity; the Chrome trace lands in
  ``log_dir/trace.json`` (Perfetto or chrome://tracing open it).  A card
  whose profiler cannot record CUDA activity raises: the window never
  falls back to a CPU-only trace.
* ``annotate(name)``: a named range that nests: ``record_function`` (the
  profiler's CPU timeline) and, on the card, an NVTX range, both entered
  only while a torch profiler records, so the model's phase ranges cost
  nothing measurable outside a window.
* ``graph_capture()``: held around every CUDA-graph capture
  (eval/runner.py).  A profiler window may not be open while a graph is
  captured, so a capture waits for a window on another thread to close,
  and a window waits for the capture to end.
* ``note_build`` / ``add_build_listener``: the one hook that reports the
  port's program builds, a kernel compiled by ``kernels/_build.py`` and a
  CUDA-graph capture, with their seconds (telemetry/train_metrics.py
  counts the ones inside a training step as recompiles).
* ``device_memory_stats`` / ``device_hbm_bytes``: the allocator's live,
  peak and total bytes under the JAX package's key names.
* ``FpsProtocol``: the reference's FPS protocol.  ``measure`` calls
  ``fn`` per input, discards the first ``warmup`` timings (the
  reference's 50-image discard, which absorbs cuDNN autotuning there and
  the CUDA graph captures here) and reports 1/mean of the rest.  The stop
  clock is the callable's host result: the runner returns numpy arrays
  copied from the card, and a returned tensor is copied to the host
  inside the clock.
* ``make_forward_chain`` / ``chained_seconds_per_call``: per-call device
  time from two chain lengths, which cancels the constant launch and
  fetch overhead.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, List, Tuple, Union

import numpy as np
import torch

TRACE_FILE = "trace.json"

# Open profiler windows and CUDA-graph captures in progress: the two
# exclude each other (graph_capture, trace).
_cond = threading.Condition()
_windows: Dict[int, int] = {}     # thread ident -> open windows
_captures: Dict[int, int] = {}    # thread ident -> captures in progress


_build_listeners: List[Callable[[str, float], None]] = []


def add_build_listener(fn: Callable[[str, float], None]) -> None:
    """Call ``fn(event, seconds)`` after every program build."""
    with _cond:
        if fn not in _build_listeners:
            _build_listeners.append(fn)


def remove_build_listener(fn: Callable[[str, float], None]) -> None:
    with _cond:
        if fn in _build_listeners:
            _build_listeners.remove(fn)


def note_build(event: str, seconds: float) -> None:
    """Report one program build (``"kernel_build:<source>"``,
    ``"graph_capture"``) to the listeners."""
    with _cond:
        listeners = list(_build_listeners)
    for fn in listeners:
        fn(event, seconds)


def _count(table: Dict[int, int], delta: int) -> None:
    ident = threading.get_ident()
    table[ident] = table.get(ident, 0) + delta
    if not table[ident]:
        del table[ident]


@contextlib.contextmanager
def graph_capture():
    """Hold around a CUDA-graph capture: waits while a profiler window is
    open on another thread (its timer closes it), keeps new windows from
    opening, and raises inside a window of this thread.  Reports the
    capture to the build listeners when it ends."""
    with _cond:
        if _windows.get(threading.get_ident()):
            raise RuntimeError("a CUDA graph cannot be captured inside a "
                               "profiler window of the same thread")
        _cond.wait_for(lambda: not _windows)
        _count(_captures, 1)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        with _cond:
            _count(_captures, -1)
            _cond.notify_all()
    note_build("graph_capture", time.perf_counter() - t0)


def _activities() -> List[torch.profiler.ProfilerActivity]:
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        cuda = torch.profiler.ProfilerActivity.CUDA
        if cuda not in torch.profiler.supported_activities():
            raise RuntimeError("this torch build's profiler cannot record "
                               "CUDA activity on the card")
        activities.append(cuda)
    return activities


@contextlib.contextmanager
def trace(log_dir: str = "profiles"):
    """Profile the block into ``log_dir/trace.json`` (module docstring);
    yields ``log_dir``.  Waits while a CUDA graph is being captured on
    another thread."""
    activities = _activities()
    os.makedirs(log_dir, exist_ok=True)
    with _cond:
        if _captures.get(threading.get_ident()):
            raise RuntimeError("a profiler window cannot open inside a CUDA "
                               "graph capture")
        _cond.wait_for(lambda: not _captures)
        _count(_windows, 1)
    try:
        with torch.profiler.profile(activities=activities) as prof:
            yield log_dir
        prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))
    finally:
        with _cond:
            _count(_windows, -1)
            _cond.notify_all()


def _profiler_on() -> bool:
    """A torch profiler is recording, on any thread (``trace``,
    ``TraceCapture``, tools/torch_profile.py)."""
    return getattr(torch.autograd.profiler, "_is_profiler_enabled", True)


@contextlib.contextmanager
def annotate(name: str):
    """Named range, nests: ``record_function`` and, on the card, NVTX.
    Entered only while a profiler records: otherwise one flag test."""
    if not _profiler_on():
        yield
        return
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


def device_memory_stats(device: Union[None, int, str, torch.device] = None
                        ) -> Dict[str, int]:
    """The caching allocator's bytes on a CUDA ``device`` (default: the
    current one) under the JAX package's key names: ``bytes_in_use``,
    ``peak_bytes_in_use``, ``bytes_reserved``, ``peak_bytes_reserved``,
    ``num_allocs`` and ``bytes_limit`` (the card's total memory).  {} on
    the CPU and before CUDA is initialized (so a scrape never starts
    it).  Waits while another thread captures a CUDA graph (a scrape of
    the serving engine's gauges runs beside its workers' captures)."""
    if device is not None and torch.device(device).type != "cuda":
        return {}
    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return {}
    me = threading.get_ident()
    with _cond:
        # read under the lock, which graph_capture takes to begin one
        _cond.wait_for(lambda: not any(t != me for t in _captures))
        stats = torch.cuda.memory_stats(device)
        props = torch.cuda.get_device_properties(
            device if device is not None else torch.cuda.current_device())
    return {"bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak",
                                               0)),
            "bytes_reserved": int(stats.get("reserved_bytes.all.current", 0)),
            "peak_bytes_reserved": int(stats.get("reserved_bytes.all.peak",
                                                 0)),
            "num_allocs": int(stats.get("allocation.all.allocated", 0)),
            "bytes_limit": int(props.total_memory)}


def device_hbm_bytes(fallback: int = 16 * 2 ** 30) -> int:
    """The card's memory; ``fallback`` without a card (CPU test runs)."""
    if not torch.cuda.is_available():
        return fallback
    return int(torch.cuda.get_device_properties(0).total_memory)


@dataclass
class FpsResult:
    fps: float
    mean_s: float
    per_image_s: List[float]
    n_timed: int

    def __str__(self):
        return f"{self.fps:.2f} fps (mean {self.mean_s * 1e3:.2f} ms over " \
               f"{self.n_timed} images)"


class FpsProtocol:
    """The reference's KITTI FPS protocol: run ``fn`` per image, discard
    the first ``warmup`` timings, report 1/mean of the rest."""

    def __init__(self, warmup: int = 50):
        self.warmup = warmup

    def measure(self, fn: Callable[..., object],
                inputs: Iterable[Tuple]) -> FpsResult:
        times: List[float] = []
        n = 0
        for args in inputs:
            t0 = time.perf_counter()
            out = fn(*args)
            if isinstance(out, torch.Tensor):
                out.cpu()  # the copy to the host waits for the device
            elapsed = time.perf_counter() - t0
            n += 1
            if n > self.warmup:
                times.append(elapsed)
        if not times:
            raise ValueError(
                f"need more than warmup={self.warmup} inputs, got {n}")
        mean = float(np.mean(times))
        return FpsResult(fps=1.0 / mean, mean_s=mean, per_image_s=times,
                         n_timed=len(times))


def make_forward_chain(apply_fn: Callable, variables, img1: torch.Tensor,
                       img2: torch.Tensor):
    """``make_chain`` for ``chained_seconds_per_call``: ``k`` calls of
    ``apply_fn(variables, image1, image2)`` queued on the device, the first
    image perturbed by ``i * 1e-6`` each time as in the JAX package, their
    output means summed on the device and fetched once as a float."""

    def chain(k: int) -> float:
        with torch.inference_mode():
            acc = torch.zeros((), dtype=torch.float32, device=img1.device)
            for i in range(k):
                out = apply_fn(variables, img1 + i * 1e-6, img2)
                acc = acc + out.float().mean()
            return float(acc)

    return lambda k: (lambda: chain(k))


def chained_seconds_per_call(make_chain: Callable[[int], Callable[[], object]],
                             k_lo: int = 3, k_hi: int = 23,
                             repeats: int = 3,
                             reduce: Callable = np.median) -> float:
    """Per-call device time robust to launch and fetch overhead.

    ``make_chain(k)`` must return a zero-arg callable that runs ``k``
    device-chained iterations and blocks until a scalar is ready.  The
    difference ``(t(k_hi) - t(k_lo)) / (k_hi - k_lo)`` cancels the constant
    overhead.  ``reduce`` combines the per-repeat estimates; the default
    ``median`` tolerates an outlier repeat (``min`` would pick exactly a
    repeat whose k_lo run was spiked, biasing the difference low).
    """
    chains = {k: make_chain(k) for k in (k_lo, k_hi)}
    for k in (k_lo, k_hi):  # warm both
        chains[k]()
    estimates = []
    for _ in range(repeats):
        ts = {}
        for k in (k_lo, k_hi):
            t0 = time.perf_counter()
            chains[k]()
            ts[k] = time.perf_counter() - t0
        estimates.append((ts[k_hi] - ts[k_lo]) / (k_hi - k_lo))
    per_call = float(reduce(estimates))
    if per_call <= 0:
        raise RuntimeError(
            f"non-positive per-call estimate {per_call!r}: timing noise "
            f"exceeded the chained workload; raise k_hi or repeats")
    return per_call
