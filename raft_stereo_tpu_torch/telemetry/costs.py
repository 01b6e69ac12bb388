"""Cost and efficiency layer: what the captured programs SHOULD cost.

The registry records, per program the port builds, what it costs to
build and what it computes: a CUDA-graph capture by the inference runner
(eval/runner.py: one record per captured graph) or a training step's
first dispatch (training/train_loop.py), with the build's wall time, the
program's FLOPs and its memory.  RAFT-Stereo's fixed-iteration GRU loop
makes device time a function of the padded shape, so measured-vs-required
gaps are attributable to padding and to the card's utilization:

* **FLOPs** come from the port's per-layer formulas (telemetry/flops.py);
  XLA's ``cost_analysis``, which the JAX package reads, has no torch
  counterpart.
* **Memory** is the card's allocator peak around the build
  (``torch.cuda.max_memory_allocated``, its peak counter reset first) and
  the bytes in use before it.
* **MFU** (model FLOP utilization, Chowdhery et al., *PaLM*, 2022):
  achieved FLOP/s = program FLOPs x dispatches / measured seconds,
  divided by the card's peak for the program's compute dtype
  (``DEVICE_PEAK_TFLOPS`` for bf16, ``DEVICE_PEAK_FP32_TFLOPS`` for fp32,
  or a ``--device_peak_tflops`` override).
* **Arithmetic intensity / roofline**: flops / bytes against the card's
  ridge point (``classify_bound``).
* **``GET /debug/compiles``**: the program inventory as JSON
  (telemetry/http.py ``handle_debug_get``).

Degradation contract: where a reading is unavailable (no card: no
allocator peak) the record carries what it has and ``degraded=True``;
building a program never fails because of cost accounting, and with no
``CompileRegistry`` attached the callers keep their exact path.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

from raft_stereo_tpu_torch.telemetry.registry import Gauge, MetricsRegistry


# Dense peak FLOP/s per card, bf16 on the tensor cores, from NVIDIA's data
# sheets (H100 SXM at 700 W; A100 SXM).  Matching is lowercase-substring
# over the device name in ORDER.  MFU against these peaks is the standard
# (conservative) convention.
DEVICE_PEAK_TFLOPS: "collections.OrderedDict[str, float]" = (
    collections.OrderedDict([("h100", 989.0), ("a100", 312.0)]))

# The same cards' fp32 FLOP/s outside the tensor cores: the peak of an
# fp32 program, whose convolutions run with TF32 off (the gate kernel's
# 3xTF32 products can exceed it, up to a third of the TF32 rate).
DEVICE_PEAK_FP32_TFLOPS: "collections.OrderedDict[str, float]" = (
    collections.OrderedDict([("h100", 67.0), ("a100", 19.5)]))

_PEAK_TABLES = {"bf16": DEVICE_PEAK_TFLOPS, "fp32": DEVICE_PEAK_FP32_TFLOPS}

# HBM bandwidth (GB/s per card), same matching rules: the other roofline
# axis.  ridge point = peak_flops / peak_bytes_per_s.
DEVICE_PEAK_GBPS: "collections.OrderedDict[str, float]" = (
    collections.OrderedDict([("h100", 3350.0), ("a100", 2039.0)]))

# Ridge when the device is unknown (the CPU test runs): the H100's,
# 989e12 / 3.35e12 FLOP per byte; the report says which source it took.
DEFAULT_RIDGE_FLOPS_PER_BYTE = 989e12 / 3.35e12


def _local_device_kind() -> str:
    return torch.cuda.get_device_name(0) if torch.cuda.is_available() else ""


def _lookup(table: "collections.OrderedDict[str, float]",
            device_kind: Optional[str]) -> Optional[float]:
    kind = (device_kind if device_kind is not None
            else _local_device_kind()).lower()
    for needle, value in table.items():
        if needle in kind:
            return value
    return None


def peak_flops_for(device_kind: Optional[str] = None,
                   override_tflops: Optional[float] = None,
                   dtype: str = "bf16") -> Optional[float]:
    """Peak FLOP/s for MFU's denominator: the override wins, then the auto
    table of the program's compute ``dtype`` ("bf16" or "fp32") keyed by
    ``device_kind`` (default: local device 0); None when unknown (MFU
    gauges then stay 0 rather than report fiction)."""
    if override_tflops is not None:
        return float(override_tflops) * 1e12
    peak = _lookup(_PEAK_TABLES[dtype], device_kind)
    return None if peak is None else peak * 1e12


def peak_bytes_per_s_for(device_kind: Optional[str] = None,
                         override_gbps: Optional[float] = None
                         ) -> Optional[float]:
    """Peak memory bytes/s (roofline's other axis); None when unknown."""
    if override_gbps is not None:
        return float(override_gbps) * 1e9
    peak = _lookup(DEVICE_PEAK_GBPS, device_kind)
    return None if peak is None else peak * 1e9


def ridge_flops_per_byte(peak_flops: Optional[float],
                         peak_bytes_per_s: Optional[float]
                         ) -> Tuple[float, str]:
    """The roofline ridge point and where it came from
    ("device" | "default")."""
    if peak_flops and peak_bytes_per_s:
        return peak_flops / peak_bytes_per_s, "device"
    return DEFAULT_RIDGE_FLOPS_PER_BYTE, "default"


def classify_bound(flops: Optional[float], bytes_accessed: Optional[float],
                   ridge: float) -> str:
    """Roofline classification: arithmetic intensity vs the ridge point."""
    if not flops or not bytes_accessed:
        return "unknown"
    return "compute" if flops / bytes_accessed >= ridge else "memory"


# ------------------------------------------------------------------ records
@dataclasses.dataclass
class CompileRecord:
    """One built program's cost card."""

    key: str                 # stable label, e.g. "eval.forward(384x1248,b1)"
    site: str                # "eval" | "serving" | "train" | "bench"
    compile_s: float         # the capture's (or first dispatch's) wall time
    created_unix: float
    device: str = ""
    # Registered-model coordinate ("name@version") the program was built
    # for; None at every site that serves one model.
    model: Optional[str] = None
    flops: Optional[float] = None
    bytes_accessed: Optional[float] = None
    transcendentals: Optional[float] = None
    memory: Optional[Dict[str, int]] = None   # _MEMORY_FIELDS
    degraded: bool = False   # a reading was unavailable

    @property
    def arithmetic_intensity(self) -> Optional[float]:
        if not self.flops or not self.bytes_accessed:
            return None
        return self.flops / self.bytes_accessed

    @property
    def hbm_bytes(self) -> Optional[int]:
        """The build's own device-memory footprint: the allocator's peak
        during it less the bytes in use before it."""
        if self.memory is None:
            return None
        return (self.memory["peak_bytes_in_use"]
                - self.memory["bytes_in_use_before"])

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["arithmetic_intensity"] = self.arithmetic_intensity
        d["hbm_bytes"] = self.hbm_bytes
        return d


_MEMORY_FIELDS = ("bytes_in_use_before", "peak_bytes_in_use")


def executable_cost(flops: Optional[float] = None,
                    memory: Optional[Dict[str, int]] = None
                    ) -> Dict[str, Any]:
    """A record's cost fields from what the port measured: ``flops``
    (telemetry/flops.py) and ``memory`` (``_MEMORY_FIELDS``); ``degraded``
    when either is missing."""
    return {"flops": None if flops is None else float(flops),
            "bytes_accessed": None, "transcendentals": None,
            "memory": memory,
            "degraded": flops is None or memory is None}


class _AllocatorWindow:
    """The card's allocator around one build: the bytes in use before it
    and the peak during it (the peak counter is reset at entry).  No
    reading off the card."""

    def __init__(self, device):
        self.device = torch.device(device) if device is not None else None
        self.memory: Optional[Dict[str, int]] = None

    def __enter__(self) -> "_AllocatorWindow":
        if self.device is not None and self.device.type == "cuda":
            self._before = torch.cuda.memory_allocated(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
        return self

    def __exit__(self, *exc) -> None:
        if self.device is not None and self.device.type == "cuda":
            self.memory = {
                "bytes_in_use_before": int(self._before),
                "peak_bytes_in_use": int(
                    torch.cuda.max_memory_allocated(self.device))}


def aot_cost_summary(fn, *args, flops: Optional[float] = None,
                     device=None, **kwargs) -> Dict[str, Any]:
    """One-shot helper for measurement scripts: the first call of ``fn``
    (the build: kernel builds, a capture) timed, with its allocator peak
    on ``device`` and the given ``flops``: ``{flops, bytes_accessed,
    arithmetic_intensity, compile_s, memory, degraded}``."""
    with _AllocatorWindow(device) as window:
        t0 = time.perf_counter()
        fn(*args, **kwargs)
        compile_s = time.perf_counter() - t0
    out = executable_cost(flops, window.memory)
    out["compile_s"] = round(compile_s, 4)
    out["arithmetic_intensity"] = None
    return out


# ----------------------------------------------------------------- registry
# The cost records a registry holds; past it the oldest built is evicted.
MAX_RECORDS = 256


class CompileRegistry:
    """Instruments every program build it is handed: per-program cost
    records (bounded, oldest evicted), build counters and histograms on
    an optional shared ``MetricsRegistry``, compile run-events on an
    optional ``EventLog``, and the runner's graph-cache eviction
    telemetry (eval/runner.py reports into it).

    The registry is passive: callers opt in by wrapping a callable with
    ``instrument`` or by calling ``measure`` or ``record`` themselves.
    No registry attached anywhere == the exact path without it.

    ``dtype`` is the compute dtype of the programs it records ("fp32",
    the default config's, or "bf16" under ``mixed_precision``): it picks
    MFU's peak.
    """

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 events=None,
                 device_peak_tflops: Optional[float] = None,
                 dtype: str = "fp32"):
        self.events = events
        self.peak_flops = peak_flops_for(override_tflops=device_peak_tflops,
                                         dtype=dtype)
        self._lock = threading.Lock()
        # key -> latest record for that build point; insertion-ordered so
        # the bound evicts oldest-built first.
        self._records: "collections.OrderedDict[str, CompileRecord]" = (
            collections.OrderedDict())
        self._evictions = 0
        self._total_compile_s = 0.0
        self.metrics = registry
        if registry is not None:
            self.compiles = registry.counter(
                "compiles_total",
                "programs built through the cost registry (CUDA-graph "
                "captures, first training-step dispatches)")
            self.compile_seconds = registry.histogram(
                "compile_seconds", "per-program build wall time")
            self.executables = registry.gauge(
                "compile_executables", "cost records currently held")
            self.runner_evictions = registry.counter(
                "runner_compile_evictions_total",
                "InferenceRunner per-shape graphs evicted "
                "(oldest-first past max_cached_shapes)")
            self.runner_cache_size = registry.gauge(
                "runner_compile_cache_size",
                "entries in the reporting runner's per-shape graph cache")
            if self.peak_flops:
                registry.gauge(
                    "device_peak_flops_per_s",
                    "peak FLOP/s used as the MFU denominator "
                    "(the program dtype's auto table or "
                    "--device_peak_tflops)"
                ).set(self.peak_flops)
        else:
            self.compiles = self.compile_seconds = None
            self.executables = self.runner_evictions = None
            self.runner_cache_size = None

    # ------------------------------------------------------------ recording
    def record(self, key: str, site: str, compile_s: float,
               flops: Optional[float] = None,
               memory: Optional[Dict[str, int]] = None, device: str = "",
               model: Optional[str] = None) -> CompileRecord:
        """Record one built program; a missing ``flops`` or ``memory``
        makes the record ``degraded``.  ``model`` is the registered-model
        coordinate (``name@version``) for multi-model serving sites."""
        fields = executable_cost(flops, memory)
        rec = CompileRecord(
            key=key, site=site, compile_s=compile_s,
            created_unix=time.time(),
            device=device or _local_device_kind(),
            model=model,
            flops=fields["flops"],
            bytes_accessed=fields["bytes_accessed"],
            transcendentals=fields["transcendentals"],
            memory=fields["memory"],
            degraded=fields["degraded"])
        with self._lock:
            self._records.pop(key, None)  # a rebuild: latest record wins
            self._records[key] = rec
            while len(self._records) > MAX_RECORDS:
                self._records.popitem(last=False)
                self._evictions += 1
            n = len(self._records)
            self._total_compile_s += compile_s
        if self.compiles is not None:
            self.compiles.inc()
            self.compile_seconds.observe(compile_s)
            self.executables.set(n)
        if self.events is not None:
            self.events.emit(
                "compile", site=site, key=key,
                compile_s=round(compile_s, 4), flops=rec.flops,
                bytes_accessed=rec.bytes_accessed, memory=rec.memory,
                degraded=rec.degraded, device=rec.device,
                **({"model": model} if model is not None else {}))
        return rec

    def measure(self, fn, *args, key: str, site: str,
                flops: Optional[float] = None, device=None,
                model: Optional[str] = None, **kwargs):
        """Call ``fn(*args, **kwargs)`` as a program's build, record its
        wall time, ``flops`` and the allocator peak on ``device`` (a CUDA
        device; none elsewhere), and return its result."""
        with _AllocatorWindow(device) as window:
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            compile_s = time.perf_counter() - t0
        name = (torch.cuda.get_device_name(window.device)
                if window.memory is not None else "cpu")
        self.record(key, site, compile_s, flops=flops,
                    memory=window.memory, device=name, model=model)
        return out

    def instrument(self, fn, key: str, site: str,
                   flops: Optional[float] = None, device=None,
                   model: Optional[str] = None) -> "_InstrumentedFn":
        """Wrap ``fn`` so its first call is measured as the build (a
        training step's first dispatch); later calls go straight to
        ``fn``.  Same call signature, same results."""
        return _InstrumentedFn(self, fn, key, site, flops, device, model)

    # -------------------------------------------------------------- queries
    def get(self, key: str) -> Optional[CompileRecord]:
        with self._lock:
            return self._records.get(key)

    def records(self) -> List[CompileRecord]:
        with self._lock:
            return list(self._records.values())

    def to_json(self) -> Dict[str, Any]:
        """The ``GET /debug/compiles`` payload: program inventory plus
        the registry's own counters."""
        with self._lock:
            records = [r.to_dict() for r in self._records.values()]
            evictions = self._evictions
            total_s = self._total_compile_s
        return {
            "executables": records,
            "count": len(records),
            "record_evictions": evictions,
            "total_compile_s": round(total_s, 4),
            "peak_flops_per_s": self.peak_flops,
        }

    # ------------------------------------------- runner cache telemetry
    def note_runner_eviction(self, evicted_key: str, cache_size: int) -> None:
        """eval/runner.py reports each graph-cache eviction here (the
        record for the evicted graph stays in ``records()``: the inventory
        is history, the runner cache is the working set)."""
        if self.runner_evictions is not None:
            self.runner_evictions.inc()
            self.runner_cache_size.set(cache_size)

    def note_runner_cache_size(self, cache_size: int) -> None:
        if self.runner_cache_size is not None:
            self.runner_cache_size.set(cache_size)


class _InstrumentedFn:
    """``fn`` whose first call is measured and recorded as the program's
    build; every later call goes straight to ``fn``."""

    def __init__(self, registry: CompileRegistry, fn, key: str, site: str,
                 flops: Optional[float], device, model: Optional[str]):
        self._registry = registry
        self._fn = fn
        self.key = key
        self.site = site
        self.flops = flops
        self.device = device
        self.model = model
        self._built = False

    def __call__(self, *args, **kwargs):
        if self._built:
            return self._fn(*args, **kwargs)
        self._built = True
        return self._registry.measure(
            self._fn, *args, key=self.key, site=self.site, flops=self.flops,
            device=self.device, model=self.model, **kwargs)


# ---------------------------------------------------------------------- MFU
class MfuMeter:
    """Rolling-window achieved-FLOP/s meter feeding an MFU gauge.

    ``note(flops)`` records each dispatch's model flops; the gauge becomes
    ``flops-in-window / elapsed / peak``.  With no known peak the gauge
    stays 0 — an unknown denominator must not masquerade as utilization.
    An optional second gauge receives the raw achieved FLOP/s (useful even
    without a peak).
    """

    def __init__(self, gauge: Gauge, peak_flops: Optional[float],
                 achieved_gauge: Optional[Gauge] = None,
                 window_s: float = 60.0):
        self.gauge = gauge
        self.achieved_gauge = achieved_gauge
        self.peak_flops = peak_flops
        self.window_s = window_s
        self._lock = threading.Lock()
        self._samples: "collections.deque[Tuple[float, float]]" = (
            collections.deque())
        self._t0: Optional[float] = None

    def note(self, flops: float, now: Optional[float] = None) -> None:
        now = time.monotonic() if now is None else now
        with self._lock:
            if self._t0 is None:
                self._t0 = now
            self._samples.append((now, float(flops)))
            horizon = now - self.window_s
            while self._samples and self._samples[0][0] < horizon:
                self._samples.popleft()
            total = sum(f for _, f in self._samples)
            elapsed = min(self.window_s, now - self._t0)
        achieved = total / elapsed if elapsed > 0 else 0.0
        if self.achieved_gauge is not None:
            self.achieved_gauge.set(achieved)
        if self.peak_flops:
            self.gauge.set(achieved / self.peak_flops)
