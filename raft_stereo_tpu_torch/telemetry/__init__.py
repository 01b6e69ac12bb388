"""Unified observability layer: one instrument registry, one event schema,
one HTTP surface — and the request-path layer on top: span tracing, a
flight recorder, and anomaly watchdogs.  The JAX package's
``telemetry/``, on torch: the same names, metric names, label sets, JSON
schemas and HTTP routes."""

from raft_stereo_tpu_torch.telemetry.costs import (DEVICE_PEAK_TFLOPS,
                                             CompileRecord, CompileRegistry,
                                             MfuMeter, aot_cost_summary,
                                             classify_bound,
                                             executable_cost,
                                             peak_bytes_per_s_for,
                                             peak_flops_for,
                                             ridge_flops_per_byte)
from raft_stereo_tpu_torch.telemetry.events import (SCHEMA_VERSION, EventLog,
                                              bench_record, replay,
                                              run_metadata, write_record)
from raft_stereo_tpu_torch.telemetry.flight_recorder import (FlightRecorder,
                                                       dump_all_stacks)
from raft_stereo_tpu_torch.telemetry.http import TelemetryHTTPServer
from raft_stereo_tpu_torch.telemetry.registry import (DEFAULT_LATENCY_BUCKETS,
                                                Counter, Gauge, Histogram,
                                                MetricsRegistry,
                                                escape_help,
                                                escape_label_value,
                                                unescape_label_value)
from raft_stereo_tpu_torch.telemetry.spans import (Span, SpanTracer, Trace,
                                             to_chrome_trace)
from raft_stereo_tpu_torch.telemetry.trace import (TraceBusy, TraceCapture)
from raft_stereo_tpu_torch.telemetry.train_metrics import TrainTelemetry
from raft_stereo_tpu_torch.telemetry.watchdog import (ANOMALY_VERSION, AnomalySink,
                                                NonFiniteSentinel,
                                                ServingWatchdog,
                                                StepStallWatchdog)

__all__ = [
    "DEVICE_PEAK_TFLOPS", "CompileRecord", "CompileRegistry", "MfuMeter",
    "aot_cost_summary", "classify_bound", "executable_cost",
    "peak_bytes_per_s_for", "peak_flops_for", "ridge_flops_per_byte",
    "SCHEMA_VERSION", "EventLog", "bench_record", "replay", "run_metadata",
    "write_record", "FlightRecorder", "dump_all_stacks",
    "TelemetryHTTPServer", "DEFAULT_LATENCY_BUCKETS",
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "escape_help",
    "escape_label_value", "unescape_label_value", "Span", "SpanTracer",
    "Trace", "to_chrome_trace", "TraceBusy", "TraceCapture",
    "TrainTelemetry", "ANOMALY_VERSION", "AnomalySink", "NonFiniteSentinel",
    "ServingWatchdog", "StepStallWatchdog",
]
