"""The batch-N serving engine on the card: program cache, scheduler,
supervised recovery and cost telemetry in one place.

The JAX package's ``serving/engine.py``, its stateless path, on torch:

* **One program per (bucket, batch, tier) and worker.**  A miss builds the
  runner's ``make_forward`` program for the tier's model and wraps it as
  the runner wraps its own (eval/runner.py): a captured CUDA graph
  (``GraphForward``), or where the tier exits early one graph whose loop
  is a CUDA WHILE node (``WhileForward``); on the CPU the plain closure
  (``PlainForward``).  Each worker keeps its programs in an LRU of
  ``max_cached_shapes`` entries, with one side stream and one memory pool
  of its own.  The batch-1 program is the solo ``InferenceRunner``'s, so
  the batch-1 answer is bit-equal to the runner's.
* **Tiers share the weights.**  Fixed-depth tiers ("quality") run the base
  model and its programs; an early-exit tier runs a model of its own
  config whose parameters are the base model's tensors (not copies); the
  quantized tiers ("turbo") run a model of the state dict quantized once
  per engine (``quant.core.quantize_state_dict``, with the calibrated
  activation scales of ``quant_scales_path`` where one is given).
* **Continuous batching** (serving/batcher.py ``BucketQueue``): an idle
  worker pops the largest batch size in ``batch_sizes`` the queue depth
  fills; a partial batch runs at the next size down (7 -> 4 + 2 + 1), never
  padded up.  Under early exit a batch rides to its hardest member's
  depth.
* **Supervised recovery** (serving/resilience.py, serving/chaos.py): a
  crashed dispatch requeues its requests with backoff, up to
  ``max_dispatch_attempts``, then fails them with ``RequestPoisoned``; the
  worker thread restarts; per-worker circuit breakers quarantine a failing
  device; brownout degrades eligible requests down the tier ladder.

Every upload, capture, replay and fetch of a worker happens on that
worker's thread (``prewarm`` hands its captures to the workers), and the
card's threads never capture while another thread works the card: a miss
(the program's pinned buffers, its warm-up and its capture) holds the
engine's device gate exclusively, a replay holds it shared.  Captures run
inside ``profiling.graph_capture``, so no profiler window is open during
one.

The rest of the JAX engine is refused at ``ServeConfig`` construction,
naming its ROADMAP tag: sessions and their handoff, the cascade, tiles, the
model store and the persistent executable cache (§D6b), the xl mesh
(§D7).  The port keeps its own copies of the two typed exceptions its
requests can meet there (``ModelUnknown``, ``SessionsDisabled``).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import logging
import re
import threading
import time
from concurrent.futures import Future
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch.utils._pytree import tree_flatten

from raft_stereo_tpu_torch import profiling
from raft_stereo_tpu_torch.config import (RaftStereoConfig, RequestTier,
                                          parse_tier)
from raft_stereo_tpu_torch.eval.runner import (FETCH_DTYPES, ProgramCache,
                                               _Graphed,
                                               early_exit_enabled,
                                               effective_inference_config,
                                               full_fp32, make_forward,
                                               resolve_device)
from raft_stereo_tpu_torch.models.raft_stereo import RAFTStereo
from raft_stereo_tpu_torch.ops.padding import InputPadder
from raft_stereo_tpu_torch.quant.core import is_quantized, quantize_state_dict
from raft_stereo_tpu_torch.serving.batcher import (BucketQueue, Overloaded,
                                                   Request, RequestPoisoned,
                                                   decompose_batch)
from raft_stereo_tpu_torch.serving.chaos import ChaosConfig, ChaosInjector
from raft_stereo_tpu_torch.serving.metrics import (MetricsRegistry,
                                                   ServingMetrics)
from raft_stereo_tpu_torch.serving.resilience import (CIRCUIT_CLOSED,
                                                      BrownoutController,
                                                      CircuitBreaker,
                                                      circuit_state_name,
                                                      cost_ladder)
from raft_stereo_tpu_torch.telemetry.flops import forward_flops

log = logging.getLogger(__name__)

# The model's divisibility constraint: every pad grid must be a multiple
# of this, and the adaptive policy can never refine below it.
MODEL_DIVIS = 32

# How long an idle worker waits in the queue before it looks at the tasks
# handed to it (prewarm).
_TASK_POLL_S = 0.02

_D6B = "§D6b serving: sessions, cascade, tiles, model store, executable cache"
_D7 = "§D7 parallel executors"

_TOKEN_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9._-]{0,63}$")


# ------------------------------------------------------- typed exceptions
class ModelUnknown(KeyError):
    """A request named a model this engine does not serve (HTTP 404,
    ``{"error": "model_unknown"}``).  The port serves the implicit
    constructor model only, so every name is unknown."""

    def __init__(self, model: str, known: List[str]):
        super().__init__(
            f"unknown model {model!r}: this engine serves "
            f"{sorted(known) or '(no registered models)'}")
        self.model = model
        self.known = sorted(known)

    def __str__(self) -> str:  # KeyError quotes its arg; keep it readable
        return self.args[0]


class SessionsDisabled(RuntimeError):
    """Streaming was requested but the engine runs without a session
    store.  The HTTP layer maps this to a typed 400."""


def _check_token(kind: str, value: str) -> str:
    if not isinstance(value, str) or not _TOKEN_RE.match(value):
        raise ValueError(
            f"model {kind} {value!r} must match {_TOKEN_RE.pattern} "
            f"(path-safe token; the store builds paths from it)")
    return value


def parse_model_spec(spec: str) -> Tuple[str, Optional[str]]:
    """``"name@version"`` -> (name, version); bare ``"name"`` -> (name,
    None).  ``ServeConfig`` validates ``models`` with it before refusing
    the field."""
    if "@" in spec:
        name, _, version = spec.partition("@")
        return _check_token("name", name), _check_token("version", version)
    return _check_token("name", spec), None


def parse_mesh_spec(spec: str) -> Dict[str, int]:
    """``"rows=4"`` / ``"rows=2,corr=2"`` -> ``{"rows": 4, "corr": 2}``,
    with the JAX package's errors.  ``ServeConfig`` validates ``xl_mesh``
    with it before refusing the field."""
    out = {"rows": 1, "corr": 1}
    seen = set()
    parts = [p.strip() for p in str(spec).split(",") if p.strip()]
    if not parts:
        raise ValueError(f"mesh spec {spec!r} is empty: use e.g. 'rows=4' "
                         f"or 'rows=2,corr=2'")
    for part in parts:
        k, sep, v = part.partition("=")
        k = k.strip()
        if k not in out or not sep:
            raise ValueError(
                f"mesh spec {spec!r}: expected comma-separated "
                f"'rows=N'/'corr=N' entries, got {part!r}")
        if k in seen:
            raise ValueError(f"mesh spec {spec!r}: axis {k!r} named twice")
        seen.add(k)
        try:
            out[k] = int(v.strip())
        except ValueError as e:
            raise ValueError(f"mesh spec {spec!r}: size {v!r} for axis "
                             f"{k!r} is not an integer") from e
        if out[k] < 1:
            raise ValueError(f"mesh spec {spec!r}: axis {k!r} size "
                             f"{out[k]} must be >= 1")
    return out


# ------------------------------------------------------------- ServeConfig
@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Serving knobs (model architecture stays in RaftStereoConfig), the
    JAX package's ``ServeConfig`` field for field.

    Fields of the features the port does not run yet keep their names and
    defaults and raise ``NotImplementedError`` when set away from them
    (``_unsupported_serving``).  ``donate_buffers`` is accepted and does
    nothing: a graph's static inputs already take each upload in place.
    ``max_wait_ms`` is retired in both packages (continuous batching has
    no timed flush)."""

    max_batch: int = 8
    batch_sizes: Tuple[int, ...] = (1, 2, 4, 8)
    max_wait_ms: float = 0.0
    max_queue: int = 64
    data_parallel: int = 1
    iters: int = 32
    tiers: Tuple[str, ...] = ()
    default_tier: Optional[str] = None
    shape_bucket: Optional[int] = None
    adaptive_buckets: bool = False
    bucket_grids: Tuple[int, ...] = (128, 64, 32)
    max_padding_waste: float = 0.10
    warmup_shapes: Tuple[Tuple[int, int], ...] = ()
    prewarm_on_init: bool = True
    max_cached_shapes: int = 16
    fetch_dtype: Optional[str] = None
    default_deadline_ms: Optional[float] = None
    donate_buffers: bool = True
    trace_sample_rate: float = 0.0
    cost_telemetry: bool = False
    device_peak_tflops: Optional[float] = None
    chaos: Optional[ChaosConfig] = None
    max_dispatch_attempts: int = 2
    retry_backoff_ms: float = 20.0
    breaker_failures: int = 3
    breaker_cooldown_s: float = 1.0
    brownout: bool = False
    brownout_engage_fraction: float = 0.75
    brownout_engage_s: float = 0.5
    brownout_restore_fraction: float = 0.25
    brownout_restore_s: float = 2.0
    brownout_poll_s: float = 0.1
    brownout_exempt_tiers: Tuple[str, ...] = ()
    executable_cache_dir: Optional[str] = None
    executable_cache_max_bytes: Optional[int] = None
    executable_cache_read_only: bool = False
    sessions: bool = False
    session_ttl_s: float = 30.0
    session_capacity: int = 256
    scene_cut_threshold: float = 40.0
    session_reseed_on_cap: bool = True
    session_hidden: bool = False
    session_ctx_cache: bool = False
    ctx_cache_threshold: float = 2.0
    edf_scheduler: bool = False
    edf_max_slack_ms: float = 50.0
    quant_scales_path: Optional[str] = None
    xl_mesh: Optional[str] = None
    xl_workers: int = 1
    xl_threshold_pixels: int = 2_000_000
    xl_max_pixels: Optional[int] = None
    xl_batch_sizes: Tuple[int, ...] = (1,)
    tile_threshold_pixels: Optional[int] = None
    tile_rows: int = 512
    tile_halo: int = 64
    models: Tuple[str, ...] = ()
    model_store_dir: Optional[str] = None
    default_model: Optional[str] = None
    confidence: bool = False
    confidence_floor: float = 0.5
    quality_drift_threshold: float = 0.25
    quality_drift_reference: int = 256
    quality_drift_window: int = 128
    quality_availability: float = 0.99
    brownout_spare_below: float = 0.0
    cascade: bool = False
    cascade_draft: Optional[str] = None
    cascade_escalate: Optional[str] = None
    cascade_threshold: float = 0.5

    def __post_init__(self):
        # The JAX package's validation, as it stands: the same bad values
        # raise the same exceptions.
        if self.data_parallel < 1:
            raise ValueError(f"data_parallel={self.data_parallel} must be "
                             f">= 1")
        if not 0.0 <= self.trace_sample_rate <= 1.0:
            raise ValueError(f"trace_sample_rate={self.trace_sample_rate} "
                             f"must be in [0, 1]")
        sizes = tuple(sorted(set(int(s) for s in self.batch_sizes)))
        if not sizes or sizes[0] < 1:
            raise ValueError(
                f"batch_sizes={self.batch_sizes} must be positive ints")
        if 1 not in sizes:
            raise ValueError(
                f"batch_sizes={self.batch_sizes} must include 1 (the "
                f"solo-parity bucket every partial batch bottoms out at)")
        if self.shape_bucket is not None and self.shape_bucket % MODEL_DIVIS:
            raise ValueError(
                f"shape_bucket={self.shape_bucket} must be a multiple of "
                f"the model's /{MODEL_DIVIS} divisibility requirement")
        if not 0.0 < self.max_padding_waste < 1.0:
            raise ValueError(f"max_padding_waste={self.max_padding_waste} "
                             f"must be in (0, 1)")
        if self.fetch_dtype not in (None, "fp16", "bf16"):
            raise ValueError(f"fetch_dtype={self.fetch_dtype!r}: use "
                             f"'fp16', 'bf16', or None (full fp32 fetch)")
        for g in self.bucket_grids:
            if g < MODEL_DIVIS or g % MODEL_DIVIS:
                raise ValueError(
                    f"bucket_grids={self.bucket_grids}: every grid must be "
                    f"a multiple of /{MODEL_DIVIS}")
        parsed = tuple(parse_tier(s) for s in self.tiers)  # raises on bad
        names = [t.name for t in parsed]
        if len(set(names)) != len(names):
            raise ValueError(f"tiers={self.tiers}: duplicate tier names")
        if self.default_tier is not None and self.default_tier not in names:
            raise ValueError(
                f"default_tier={self.default_tier!r} is not one of the "
                f"configured tiers {names}")
        if self.max_dispatch_attempts < 1:
            raise ValueError(f"max_dispatch_attempts="
                             f"{self.max_dispatch_attempts} must be >= 1")
        if self.retry_backoff_ms < 0:
            raise ValueError(f"retry_backoff_ms={self.retry_backoff_ms} "
                             f"must be >= 0")
        if self.breaker_failures < 1:
            raise ValueError(f"breaker_failures={self.breaker_failures} "
                             f"must be >= 1")
        if self.breaker_cooldown_s <= 0:
            raise ValueError(f"breaker_cooldown_s="
                             f"{self.breaker_cooldown_s} must be > 0")
        if self.brownout:
            if len(names) < 2:
                raise ValueError(
                    "brownout=True needs at least two configured tiers — "
                    "the degradation ladder IS the tier ladder")
            if not (0 < self.brownout_restore_fraction
                    <= self.brownout_engage_fraction <= 1):
                raise ValueError(
                    f"need 0 < brownout_restore_fraction "
                    f"({self.brownout_restore_fraction}) <= "
                    f"brownout_engage_fraction "
                    f"({self.brownout_engage_fraction}) <= 1")
        for t in self.brownout_exempt_tiers:
            if t not in names:
                raise ValueError(
                    f"brownout_exempt_tiers={self.brownout_exempt_tiers}: "
                    f"{t!r} is not one of the configured tiers {names}")
        if self.sessions:
            if self.session_ttl_s <= 0:
                raise ValueError(f"session_ttl_s={self.session_ttl_s} "
                                 f"must be > 0")
            if self.session_capacity < 1:
                raise ValueError(f"session_capacity="
                                 f"{self.session_capacity} must be >= 1")
        if self.session_hidden and not self.sessions:
            raise ValueError(
                "session_hidden=True needs sessions=True — the hidden "
                "tree is per-stream state")
        if self.edf_max_slack_ms < 0:
            raise ValueError(f"edf_max_slack_ms={self.edf_max_slack_ms} "
                             f"must be >= 0")
        if self.session_ctx_cache:
            if not self.sessions:
                raise ValueError(
                    "session_ctx_cache=True needs sessions=True — the "
                    "context bundle is per-stream state")
            if self.ctx_cache_threshold <= 0:
                raise ValueError(
                    f"ctx_cache_threshold={self.ctx_cache_threshold} "
                    f"must be > 0 (the static-scene gate)")
        if self.xl_mesh is not None:
            parse_mesh_spec(self.xl_mesh)
            if self.xl_workers < 1:
                raise ValueError(f"xl_workers={self.xl_workers} must be "
                                 f">= 1")
            if self.xl_threshold_pixels < 1:
                raise ValueError(f"xl_threshold_pixels="
                                 f"{self.xl_threshold_pixels} must be "
                                 f">= 1")
            xl_sizes = tuple(sorted(set(int(s)
                                        for s in self.xl_batch_sizes)))
            if not xl_sizes or xl_sizes[0] != 1:
                raise ValueError(
                    f"xl_batch_sizes={self.xl_batch_sizes} must be "
                    f"positive ints including 1 (the partial-batch "
                    f"floor)")
            if (self.xl_max_pixels is not None
                    and self.xl_max_pixels <= self.xl_threshold_pixels):
                raise ValueError(
                    f"xl_max_pixels={self.xl_max_pixels} must exceed "
                    f"xl_threshold_pixels={self.xl_threshold_pixels} "
                    f"(the xl routing band would be empty)")
        if self.tile_threshold_pixels is not None \
                and self.tile_threshold_pixels < 1:
            raise ValueError(f"tile_threshold_pixels="
                             f"{self.tile_threshold_pixels} must be >= 1")
        if self.tile_rows < MODEL_DIVIS:
            raise ValueError(
                f"tile_rows={self.tile_rows} must be >= {MODEL_DIVIS} "
                f"(a tile is an ordinary /{MODEL_DIVIS}-padded bucket "
                f"dispatch)")
        if self.tile_halo < 0:
            raise ValueError(f"tile_halo={self.tile_halo} must be >= 0")
        model_names = [parse_model_spec(s)[0] for s in self.models]
        if len(set(model_names)) != len(model_names):
            raise ValueError(f"models={self.models}: duplicate model "
                             f"names (one served version per name)")
        if self.models and not (self.model_store_dir
                                or self.executable_cache_dir):
            raise ValueError(
                "ServeConfig.models needs a store to load from: set "
                "model_store_dir (or executable_cache_dir — the shared "
                "artifact store holds the models/ namespace)")
        if (self.default_model is not None
                and self.default_model not in model_names):
            raise ValueError(
                f"default_model={self.default_model!r} is not one of the "
                f"registered model names {model_names}")
        if not 0.0 <= self.confidence_floor <= 1.0:
            raise ValueError(f"confidence_floor={self.confidence_floor} "
                             f"must be in [0, 1]")
        if self.quality_drift_threshold <= 0:
            raise ValueError(
                f"quality_drift_threshold={self.quality_drift_threshold} "
                f"must be > 0")
        if not 0.0 < self.quality_availability < 1.0:
            raise ValueError(
                f"quality_availability={self.quality_availability} must "
                f"be in (0, 1) — 1.0 leaves no quality budget to burn")
        if self.brownout_spare_below and not self.confidence:
            raise ValueError(
                "brownout_spare_below needs confidence=True — the spare "
                "signal IS the rolling confidence telemetry")
        if not 0.0 <= self.brownout_spare_below <= 1.0:
            raise ValueError(
                f"brownout_spare_below={self.brownout_spare_below} must "
                f"be in [0, 1]")
        if self.cascade:
            if not self.confidence:
                raise ValueError("cascade=True needs confidence=True — "
                                 "the escalation gate IS the confidence "
                                 "signal")
            if len(names) < 2:
                raise ValueError(
                    "cascade=True needs at least two configured tiers "
                    "(a draft and an escalation target)")
            for field_name, value in (("cascade_draft",
                                       self.cascade_draft),
                                      ("cascade_escalate",
                                       self.cascade_escalate)):
                if value is not None and value not in names:
                    raise ValueError(
                        f"{field_name}={value!r} is not one of the "
                        f"configured tiers {names}")
            if (self.cascade_draft is not None
                    and self.cascade_draft == self.cascade_escalate):
                raise ValueError(
                    f"cascade_draft and cascade_escalate are both "
                    f"{self.cascade_draft!r} — the cascade would never "
                    f"change programs")
            if not 0.0 <= self.cascade_threshold <= 1.0:
                raise ValueError(
                    f"cascade_threshold={self.cascade_threshold} must "
                    f"be in [0, 1]")
        elif self.cascade_draft is not None \
                or self.cascade_escalate is not None:
            raise ValueError("cascade_draft/cascade_escalate need "
                             "cascade=True")
        for field, item in _unsupported_serving(self):
            raise NotImplementedError(
                f"ServeConfig.{field} is not ported to the PyTorch package "
                f"yet (ROADMAP.md {item})")

    def parsed_tiers(self) -> Tuple[RequestTier, ...]:
        return tuple(parse_tier(s) for s in self.tiers)


# Fields of the deferred features, each with its ROADMAP tag.
DEFERRED_FIELDS: Tuple[Tuple[str, str], ...] = tuple(
    (name, _D6B) for name in (
        "sessions", "session_ttl_s", "session_capacity",
        "scene_cut_threshold", "session_reseed_on_cap", "session_hidden",
        "session_ctx_cache", "ctx_cache_threshold", "cascade",
        "cascade_draft", "cascade_escalate", "cascade_threshold",
        "tile_threshold_pixels", "tile_rows", "tile_halo", "models",
        "model_store_dir", "default_model", "executable_cache_dir",
        "executable_cache_max_bytes", "executable_cache_read_only")
) + tuple((name, _D7) for name in (
    "xl_mesh", "xl_workers", "xl_threshold_pixels", "xl_max_pixels",
    "xl_batch_sizes"))


def _unsupported_serving(cfg: ServeConfig) -> List[Tuple[str, str]]:
    """(field, ROADMAP tag) for every deferred field set away from its
    default."""
    defaults = {f.name: f.default for f in dataclasses.fields(ServeConfig)}
    return [(name, tag) for name, tag in DEFERRED_FIELDS
            if getattr(cfg, name) != defaults[name]]


@dataclasses.dataclass
class ServeResult:
    """One answered request: the flow plus its latency decomposition.
    The JAX package's fields; those of the deferred features keep their
    defaults."""

    flow: np.ndarray             # (H, W) x-flow (= -disparity), float32
    queue_wait_s: float          # admission -> worker pickup
    device_s: float              # dispatch -> outputs ready
    fetch_s: float               # device->host result transfer
    total_s: float               # admission -> result ready
    batch_size: int              # occupancy of the dispatch it rode in
    iters_used: Optional[int] = None  # GRU trip count of the dispatch
    tier: Optional[str] = None   # latency tier the request RAN at
    requested_tier: Optional[str] = None  # asked-for tier when degraded
    attempts: int = 1            # dispatch attempts including the last
    session_id: Optional[str] = None
    frame_index: Optional[int] = None
    warm: bool = False
    scene_cut: bool = False
    frame_delta: Optional[float] = None
    flow_low: Optional[np.ndarray] = None
    ctx_cached: bool = False
    ctx: Optional[object] = None
    hidden: Optional[object] = None
    warm_hidden: bool = False
    mesh: Optional[str] = None
    tiles: Optional[int] = None
    seam_epe: Optional[float] = None
    model: Optional[str] = None
    model_version: Optional[str] = None
    trace_id: Optional[str] = None
    confidence: Optional[np.ndarray] = None  # (H, W) float32 in (0, 1]
    confidence_mean: Optional[float] = None
    escalated: bool = False
    draft_tier: Optional[str] = None
    draft_confidence: Optional[float] = None

    @property
    def degraded(self) -> bool:
        return self.requested_tier is not None

    @property
    def disparity(self) -> np.ndarray:
        """Positive disparity (the user-facing convention)."""
        return -self.flow


@dataclasses.dataclass
class _Payload:
    """What the engine parks in Request.payload: padded inputs + unpadder."""

    left: np.ndarray             # (Hp, Wp, 3) host-padded
    right: np.ndarray
    padder: InputPadder


class BucketPolicy:
    """Maps a raw image (H, W) to its padded dispatch bucket (Hp, Wp), the
    JAX package's policy.

    Static mode (``grids`` of length 1): the fixed grid — /32 by default,
    or ``ServeConfig.shape_bucket``.  Adaptive mode: a shape starts at the
    COARSEST grid, and ``note`` — fed the per-dispatch real/padding pixel
    counts — refines a bucket to the next finer grid once its measured
    cumulative waste fraction exceeds ``max_waste``.  Refinement is
    monotonic and bottoms out at the /32 floor.
    """

    def __init__(self, grids: Sequence[int] = (MODEL_DIVIS,),
                 max_waste: float = 0.10, min_observe_px: int = 0,
                 refinements_counter=None):
        grids = sorted(set(int(g) for g in grids), reverse=True)
        if not grids or any(g % MODEL_DIVIS or g < MODEL_DIVIS
                            for g in grids):
            raise ValueError(f"grids={grids} must be multiples of "
                             f"/{MODEL_DIVIS}")
        self.grids = tuple(grids)         # coarsest first
        self.max_waste = max_waste
        self.min_observe_px = min_observe_px
        self._lock = threading.Lock()
        self._px: Dict[Tuple[int, int], List[int]] = {}  # bucket -> [real,
        #                                                   dispatched]
        self._refined: set = set()        # buckets past the waste bound
        self._refinements = refinements_counter
        self.adaptive = len(self.grids) > 1

    @staticmethod
    def _pad_to(h: int, w: int, grid: int) -> Tuple[int, int]:
        return (-(-h // grid) * grid, -(-w // grid) * grid)

    def bucket_for(self, h: int, w: int) -> Tuple[int, int, int]:
        """The (Hp, Wp, grid) this raw shape dispatches at: the coarsest
        grid whose bucket has not been refined away (the finest grid is
        always accepted)."""
        with self._lock:
            for g in self.grids[:-1]:
                bucket = self._pad_to(h, w, g)
                if bucket not in self._refined:
                    return bucket + (g,)
            g = self.grids[-1]
            return self._pad_to(h, w, g) + (g,)

    def note(self, bucket: Tuple[int, int], real_px: int,
             dispatched_px: int) -> None:
        """Per-dispatch waste feedback; crossing ``max_waste`` refines the
        bucket."""
        if not self.adaptive or dispatched_px <= 0:
            return
        with self._lock:
            if bucket in self._refined:
                return
            acc = self._px.setdefault(tuple(bucket), [0, 0])
            acc[0] += real_px
            acc[1] += dispatched_px
            if acc[1] < max(self.min_observe_px, 1):
                return
            waste = 1.0 - acc[0] / acc[1]
            if waste > self.max_waste:
                self._refined.add(tuple(bucket))
                log.info(
                    "bucket %sx%s refined: measured padding waste %.1f%% "
                    "> %.1f%% over %d dispatched pixels — shapes re-route "
                    "to the next finer pad grid",
                    bucket[0], bucket[1], waste * 100,
                    self.max_waste * 100, acc[1])
                if self._refinements is not None:
                    self._refinements.inc()

    @property
    def refined_buckets(self) -> Tuple[Tuple[int, int], ...]:
        with self._lock:
            return tuple(sorted(self._refined))


class _SinkRef:
    """Late-bound anomaly-sink handle: the CLI attaches the sink after the
    engine is constructed."""

    def __init__(self, engine: "ServingEngine"):
        self._engine = engine

    def fire(self, kind: str, **detail):
        sink = self._engine.sink
        if sink is not None:
            return sink.fire(kind, **detail)
        return None


class _DeviceGate:
    """Shared/exclusive gate over the card's threads: replays hold it
    shared, a program's build and capture exclusively, so no thread makes
    a CUDA call while another captures (a capture in the default global
    error mode fails on one)."""

    def __init__(self):
        self._cond = threading.Condition()
        self._shared = 0
        self._exclusive = False
        self._waiting = 0

    @contextlib.contextmanager
    def shared(self):
        with self._cond:
            self._cond.wait_for(lambda: not self._exclusive
                                and not self._waiting)
            self._shared += 1
        try:
            yield
        finally:
            with self._cond:
                self._shared -= 1
                self._cond.notify_all()

    @contextlib.contextmanager
    def exclusive(self):
        with self._cond:
            self._waiting += 1
            self._cond.wait_for(lambda: not self._exclusive
                                and not self._shared)
            self._waiting -= 1
            self._exclusive = True
        try:
            yield
        finally:
            with self._cond:
                self._exclusive = False
                self._cond.notify_all()


def _share_weights(dst: torch.nn.Module, src: torch.nn.Module) -> None:
    """Make ``dst``'s parameters and buffers ``src``'s tensors (one
    architecture, another config): the tier models hold no copies."""
    src_modules = dict(src.named_modules())
    for name, mod in dst.named_modules():
        other = src_modules[name]
        for k in list(mod._parameters):
            mod._parameters[k] = other._parameters[k]
        for k in list(mod._buffers):
            mod._buffers[k] = other._buffers[k]


class ServingEngine:
    """The serving engine: one object owning the program cache, the
    continuous-batching scheduler, the worker pool and the cost/waste
    telemetry.

    ``variables`` is the fp32 state dict (or a ``RAFTStereo`` that lends
    its state dict).  ``devices`` defaults to the first
    ``serve_cfg.data_parallel`` CUDA devices, and raises without a card
    unless ``device="cpu"`` (then every worker runs on the CPU).  Each
    worker is a thread with its own programs, stream and memory pool.
    """

    def __init__(self, config: RaftStereoConfig,
                 variables: Union[Mapping[str, torch.Tensor], RAFTStereo],
                 serve_cfg: ServeConfig = ServeConfig(),
                 devices: Optional[Sequence] = None,
                 registry: Optional[MetricsRegistry] = None,
                 tracer=None,
                 device: Optional[Union[str, torch.device]] = None):
        from raft_stereo_tpu_torch.telemetry.spans import SpanTracer

        self.serve_cfg = serve_cfg
        self.tracer = (tracer if tracer is not None
                       else SpanTracer(serve_cfg.trace_sample_rate))
        if devices is None:
            dev = resolve_device(device)
            n = serve_cfg.data_parallel
            if dev.type == "cuda":
                count = torch.cuda.device_count()
                if n > count:
                    raise ValueError(
                        f"data_parallel={n} exceeds the {count} local "
                        f"devices")
                devices = [torch.device("cuda", i) for i in range(n)]
            else:
                devices = [dev] * n
        self.devices = [torch.device(d) for d in devices]
        if any(d.type == "cuda" for d in self.devices):
            full_fp32()
        self.metrics = ServingMetrics(registry,
                                      max_batch=serve_cfg.max_batch)
        self.config = config
        # The padding policy: static /32 (or shape_bucket) unless
        # adaptive_buckets turns on the waste feedback loop.
        if serve_cfg.adaptive_buckets:
            grids = tuple(serve_cfg.bucket_grids) + (
                serve_cfg.shape_bucket or MODEL_DIVIS,)
        else:
            grids = (serve_cfg.shape_bucket or MODEL_DIVIS,)
        self.policy = BucketPolicy(
            grids=grids, max_waste=serve_cfg.max_padding_waste,
            refinements_counter=self.metrics.bucket_refinements)
        self._quant_corr_scales = None
        self._quant_act_scales = None
        if serve_cfg.quant_scales_path:
            from raft_stereo_tpu_torch.quant.calibrate import (
                conv_input_scales, corr_scales, load_scales)
            record = load_scales(serve_cfg.quant_scales_path)
            self._quant_corr_scales = corr_scales(record)
            self._quant_act_scales = conv_input_scales(record) or None
        self.tiers: Dict[str, RequestTier] = {
            t.name: t for t in serve_cfg.parsed_tiers()}
        self.default_tier: Optional[str] = None
        if self.tiers:
            self.default_tier = serve_cfg.default_tier or (
                "quality" if "quality" in self.tiers
                else next(iter(self.tiers)))
        self.effective_config = self._effective(config)
        self._tier_configs: Dict[Optional[str], RaftStereoConfig] = {
            None: self.effective_config}
        for tname, tier in self.tiers.items():
            self._tier_configs[tname] = self._effective(tier.apply(config))
        state = (variables.state_dict() if isinstance(variables, RAFTStereo)
                 else variables)
        self._qstate = None
        # per device: tier -> model (the device's base model under None)
        self._tier_models: Dict[torch.device, Dict[Optional[str],
                                                   RAFTStereo]] = {}
        for dev in dict.fromkeys(self.devices):
            self._tier_models[dev] = self._build_models(state, dev)
        self.model = self._tier_models[self.devices[0]][None]
        self.costs = None
        self._mfu = None
        if serve_cfg.cost_telemetry:
            from raft_stereo_tpu_torch.telemetry.costs import (CompileRegistry,
                                                               MfuMeter)
            self.costs = CompileRegistry(
                registry=self.metrics.registry,
                device_peak_tflops=serve_cfg.device_peak_tflops,
                dtype=("bf16" if self.effective_config.mixed_precision
                       else "fp32"))
            self._mfu = MfuMeter(
                self.metrics.mfu, self.costs.peak_flops,
                achieved_gauge=self.metrics.achieved_flops_per_s)
        self._cache_lock = threading.Lock()
        # one ProgramCache per worker: its LRU, side stream and graph pool
        self._programs = [ProgramCache(dev, serve_cfg.max_cached_shapes,
                                       on_evict=self._evicted)
                          for dev in self.devices]
        self._compiled = [p.lru() for p in self._programs]
        self._gate = _DeviceGate()
        self.captures = 0
        self.replays = 0
        self._latency_lock = threading.Lock()
        self._dispatch_latency_s: Dict[Tuple, float] = {}
        self.queue = BucketQueue(
            max_batch=serve_cfg.max_batch,
            batch_sizes=serve_cfg.batch_sizes,
            max_queue=serve_cfg.max_queue, metrics=self.metrics,
            edf=serve_cfg.edf_scheduler,
            edf_max_slack_s=serve_cfg.edf_max_slack_ms / 1e3,
            latency_fn=self._dispatch_latency_estimate)
        # The deferred surfaces /healthz reads, as the JAX engine has
        # them when off: no session store, no default-model pointer.
        self.sessions = None
        self.default_model: Optional[str] = None
        # ---- resilience ---------------------------------------------
        self.sink = None
        self.chaos: Optional[ChaosInjector] = None
        if serve_cfg.chaos is not None and serve_cfg.chaos.enabled:
            self.chaos = ChaosInjector(
                serve_cfg.chaos,
                observe=self.metrics.observe_injected_fault)
            log.warning("CHAOS ENABLED: %s — injected faults are ON for "
                        "this engine", serve_cfg.chaos)
        self.breakers = [
            CircuitBreaker(
                failure_threshold=serve_cfg.breaker_failures,
                cooldown_s=serve_cfg.breaker_cooldown_s,
                on_state=self._make_circuit_callback(i))
            for i in range(len(self.devices))]
        for i in range(len(self.devices)):
            self.metrics.circuit_gauge(i).set(CIRCUIT_CLOSED)
        self.brownout: Optional[BrownoutController] = None
        if serve_cfg.brownout:
            self.brownout = BrownoutController(
                self.metrics, serve_cfg.max_queue,
                ladder=cost_ladder(serve_cfg.parsed_tiers()),
                engage_fraction=serve_cfg.brownout_engage_fraction,
                engage_s=serve_cfg.brownout_engage_s,
                restore_fraction=serve_cfg.brownout_restore_fraction,
                restore_s=serve_cfg.brownout_restore_s,
                poll_s=serve_cfg.brownout_poll_s,
                gauge=self.metrics.brownout_level,
                sink=_SinkRef(self)).start()
            self.brownout.spare_below = serve_cfg.brownout_spare_below
        self.quality = None
        if serve_cfg.confidence:
            from raft_stereo_tpu_torch.telemetry.quality import QualityTracker
            from raft_stereo_tpu_torch.telemetry.slo import BurnRateTracker
            quality_slo = BurnRateTracker(
                availability=serve_cfg.quality_availability,
                registry=self.metrics.registry,
                gauge_name="serve_slo_burn_rate",
                dimension="quality")
            self.quality = QualityTracker(
                registry=self.metrics.registry,
                sink=_SinkRef(self),
                floor=serve_cfg.confidence_floor,
                drift_threshold=serve_cfg.quality_drift_threshold,
                drift_reference_size=serve_cfg.quality_drift_reference,
                drift_window=serve_cfg.quality_drift_window,
                slo=quality_slo)
        self._retry_lock = threading.Lock()
        self._pending_retries = 0
        self._retry_timers: set = set()   # (Timer, reqs) pairs
        # Readiness: warmup_shapes x distinct tier programs x batch sizes
        # x workers; ready once every entry has dispatched once.
        self._warm_lock = threading.Lock()
        self._warmed: set = set()
        self._warm_target: set = set()
        for hw in serve_cfg.warmup_shapes:
            hp, wp, _ = self.policy.bucket_for(int(hw[0]), int(hw[1]))
            for widx in range(len(self.devices)):
                for tier in self._distinct_cache_tiers():
                    for n in self.queue.sizes:
                        self._warm_target.add((widx, (hp, wp), n, tier))
        self._closed = False
        self._shutting_down = False
        self._tasks = [collections.deque() for _ in self.devices]
        self._workers_lock = threading.Lock()
        self._workers = [
            threading.Thread(target=self._worker_loop, args=(i,),
                             daemon=True, name=f"stereo-worker-{i}")
            for i in range(len(self.devices))]
        for t in self._workers:
            t.start()
        if serve_cfg.prewarm_on_init:
            for hw in serve_cfg.warmup_shapes:
                self.prewarm(hw)

    # ------------------------------------------------------------- models
    def _effective(self, cfg: RaftStereoConfig) -> RaftStereoConfig:
        """One config's effective inference form: the runner's
        deep-iteration guard plus the calibrated correlation scales for
        quantized configs."""
        eff = effective_inference_config(cfg, self.serve_cfg.iters)
        if (eff.quant != "off" and self._quant_corr_scales is not None
                and eff.quant_corr_scales is None):
            eff = dataclasses.replace(
                eff, quant_corr_scales=self._quant_corr_scales)
        return eff

    def _build_models(self, state: Mapping[str, torch.Tensor],
                      dev: torch.device) -> Dict[Optional[str], RAFTStereo]:
        """One device's models: the base model of the fp32 state, a model
        per distinct tier config sharing its tensors, and the quantized
        tiers' models over the state quantized once per engine."""
        def load(cfg, sd):
            m = RAFTStereo(cfg)
            m.load_state_dict(sd, strict=True)
            return m.to(dev).eval().cast_weights_()

        base = load(self.effective_config, state)
        models: Dict[Optional[str], RAFTStereo] = {None: base}
        by_config: Dict[RaftStereoConfig, RAFTStereo] = {
            self.effective_config: base}
        by_quant: Dict[str, RAFTStereo] = {}
        for tname, teff in self._tier_configs.items():
            if tname is None:
                continue
            if teff in by_config:
                models[tname] = by_config[teff]
                continue
            if teff.quant == "off":
                m = RAFTStereo(teff)
                _share_weights(m, base)
            elif teff.quant in by_quant:
                m = RAFTStereo(teff)
                _share_weights(m, by_quant[teff.quant])
            else:
                m = load(teff, self._quantized_state(state))
                by_quant[teff.quant] = m
            models[tname] = by_config[teff] = m.to(dev).eval()
        return models

    def _quantized_state(self, state: Mapping[str, torch.Tensor]
                         ) -> Mapping[str, torch.Tensor]:
        if is_quantized(state):
            return state
        if self._qstate is None:
            self._qstate = quantize_state_dict(
                state, act_scales=self._quant_act_scales)
        return self._qstate

    def _make_circuit_callback(self, widx: int):
        """Breaker transition hook for one device: gauge + anomaly event."""
        def on_state(old: int, new: int, failures: int) -> None:
            self.metrics.circuit_gauge(widx).set(new)
            log.warning("device %d circuit %s -> %s (%d consecutive "
                        "failures)", widx, circuit_state_name(old),
                        circuit_state_name(new), failures)
            sink = self.sink
            if sink is not None:
                sink.fire(f"circuit_{circuit_state_name(new)}",
                          device=widx,
                          previous=circuit_state_name(old),
                          consecutive_failures=failures)
        return on_state

    def attach_anomaly_sink(self, sink) -> None:
        """Wire an AnomalySink (telemetry/watchdog.py): resilience
        transitions emit anomaly run events + flight-recorder bundles."""
        self.sink = sink

    # ------------------------------------------------ deferred surfaces
    def xl_status(self) -> Optional[Dict[str, object]]:
        """None: the port serves without an xl tier (§D7)."""
        return None

    def resolve_model(self, model: Optional[str]) -> Optional[str]:
        """None (the implicit constructor model); any name raises the
        typed ``ModelUnknown`` (HTTP 404), as the JAX engine does without
        registered models."""
        if model is None:
            return None
        raise ModelUnknown(model, [])

    def models_status(self) -> Dict[str, object]:
        return {"default": None, "registered": [], "pending": {}}

    def register_model(self, spec: str, set_default: bool = False,
                       prewarm: bool = True) -> Dict[str, object]:
        raise RuntimeError(
            "no model store: construct the engine with "
            "ServeConfig.model_store_dir (or executable_cache_dir) to "
            "register models")

    def set_default_model(self, name: Optional[str]) -> Optional[str]:
        if name is not None:
            raise ModelUnknown(name, [])
        return None

    def retire_model(self, name: str, timeout: float = 30.0
                     ) -> Dict[str, object]:
        raise ModelUnknown(name, [])

    def quality_status(self) -> Optional[Dict[str, object]]:
        """Online quality posture (``GET /quality``); None with confidence
        telemetry off."""
        if self.quality is None:
            return None
        return self.quality.status()

    def submit_session(self, session_id: str, left, right, *args, **kw):
        raise SessionsDisabled(
            "this engine runs without a session store — construct it "
            "with ServeConfig(sessions=True) to stream")

    def infer_session(self, session_id: str, left, right, *args, **kw):
        return self.submit_session(session_id, left, right)

    def close_session(self, session_id: str) -> Dict[str, object]:
        raise SessionsDisabled("this engine runs without a session "
                               "store")

    # ------------------------------------------------------------ front door
    def bucket_for(self, shape: Tuple[int, int, int]) -> Tuple[int, int]:
        """The padded (Hp, Wp) this image shape dispatches at."""
        return self.policy.bucket_for(shape[0], shape[1])[:2]

    def _dispatch_latency_estimate(self, group_key: Tuple,
                                   batch_size: int) -> Optional[float]:
        with self._latency_lock:
            return self._dispatch_latency_s.get(group_key)

    def _note_dispatch_latency(self, group_key: Tuple,
                               seconds: float) -> None:
        with self._latency_lock:
            prev = self._dispatch_latency_s.get(group_key)
            self._dispatch_latency_s[group_key] = (
                seconds if prev is None else 0.7 * prev + 0.3 * seconds)

    def resolve_tier(self, tier: Optional[str]) -> Optional[str]:
        """The tier a request actually runs at: the named one (validated),
        or the default tier when tiers are configured, or None (the base
        fixed-depth path) when they are not."""
        if tier is None:
            return self.default_tier
        if tier not in self.tiers:
            raise ValueError(
                f"unknown tier {tier!r}: this engine serves "
                f"{sorted(self.tiers) or '(no tiers configured)'}")
        return tier

    def submit(self, left: np.ndarray, right: np.ndarray,
               deadline_ms: Optional[float] = None,
               tier: Optional[str] = None,
               degradable: bool = True,
               model: Optional[str] = None,
               trace_context=None) -> Future:
        """Admit one stereo pair; returns a Future of ``ServeResult``.

        ``tier`` selects a configured latency tier (None: the default
        tier, or the base program without tiers).  Raises ``Overloaded``
        at the door when the queue is full or the engine is draining; the
        Future fails with ``DeadlineExceeded`` if the deadline passes
        before a worker picks the request up, or with ``RequestPoisoned``
        if its dispatch crashes on every bounded retry.  Under brownout an
        eligible request is rerouted down the tier ladder
        (``degradable=False`` opts out).  ``trace_context`` (a decoded
        ``traceparent``) makes the request's span tree a child of the
        caller's trace."""
        t_admit = time.perf_counter()
        model = self.resolve_model(model)
        left, right = np.asarray(left), np.asarray(right)
        if left.ndim != 3 or left.shape != right.shape:
            raise ValueError(
                f"need two same-shape (H, W, 3) images, got {left.shape} "
                f"vs {right.shape}")
        if tier == "auto":
            raise ValueError(
                "tier 'auto' requested but this engine has no "
                "cascade (configure ServeConfig.cascade / --cascade "
                "with confidence telemetry on)")
        if tier == "xl":
            raise ValueError(
                "tier 'xl' requested but this engine has no xl tier "
                "(configure ServeConfig.xl_mesh / --xl_mesh, and enough "
                "devices for the mesh)")
        tier, requested_tier = self._admit_tier(tier, degradable)
        return self._enqueue(left, right, deadline_ms, tier,
                             requested_tier, t_admit,
                             trace_context=trace_context).future

    def _admit_tier(self, tier: Optional[str], degradable: bool
                    ) -> Tuple[Optional[str], Optional[str]]:
        """Resolve the requested tier and apply brownout degradation:
        ``(effective_tier, requested_tier_if_degraded)``."""
        tier = self.resolve_tier(tier)
        requested_tier = None
        if (self.brownout is not None and degradable
                and tier not in self.serve_cfg.brownout_exempt_tiers):
            conf = (self.quality.mean_confidence(tier)
                    if self.quality is not None else None)
            effective = self.brownout.degrade(tier, confidence=conf)
            if effective != tier:
                requested_tier, tier = tier, effective
        return tier, requested_tier

    def _enqueue(self, left: np.ndarray, right: np.ndarray,
                 deadline_ms: Optional[float], tier: Optional[str],
                 requested_tier: Optional[str], t_admit: float,
                 trace_context=None) -> Request:
        """Pad, build, trace, and queue one request."""
        hp, wp, grid = self.policy.bucket_for(left.shape[0], left.shape[1])
        padder = InputPadder((1, 3) + left.shape[:2], divis_by=grid)
        l, r, t, b = padder.pads
        spec = ((t, b), (l, r), (0, 0))
        payload = _Payload(left=np.pad(left, spec, mode="edge"),
                           right=np.pad(right, spec, mode="edge"),
                           padder=padder)
        now = time.monotonic()
        deadline_ms = (deadline_ms if deadline_ms is not None
                       else self.serve_cfg.default_deadline_ms)
        req = Request(bucket=(hp, wp), payload=payload,
                      future=Future(), t_enqueue=now, tier=tier,
                      requested_tier=requested_tier,
                      deadline=(None if deadline_ms is None
                                else now + deadline_ms / 1e3))
        trace_attrs = dict(
            bucket=str(req.bucket), deadline_ms=deadline_ms,
            **({"tier": tier} if tier is not None else {}))
        if trace_context is not None:
            trace = self.tracer.adopt_trace(trace_context,
                                            "serve.request",
                                            **trace_attrs)
        else:
            trace = self.tracer.start_trace("serve.request",
                                            **trace_attrs)
        if trace is not None:
            req.trace = trace
            self.tracer.add_span("serve.admission", trace,
                                 t_admit, time.perf_counter(),
                                 bucket=str(req.bucket))
            req.queue_span = self.tracer.start_span("serve.queue", trace)
            req.future.add_done_callback(
                lambda f, r=req: self._finish_request_trace(r, f))
        try:
            self.queue.submit(req)     # raises Overloaded at the door
        except Overloaded:
            if trace is not None and trace.root is not None:
                trace.root.set_attr("status", "overloaded")
                self._finish_request_trace(req, None)
            raise
        if requested_tier is not None:
            self.metrics.degraded.inc()
            if trace is not None and trace.root is not None:
                trace.root.set_attr("degraded_from", requested_tier)
        return req

    def _finish_request_trace(self, req: Request, future) -> None:
        """Close the queue span (if no worker picked the request up) and
        the root span."""
        qs = req.queue_span
        if qs is not None and qs.t_end is None:
            self.tracer.finish(qs)
        root = req.trace.root if req.trace is not None else None
        if root is not None and root.t_end is None:
            if future is not None:
                exc = future.exception()
                root.set_attr("status",
                              "ok" if exc is None else type(exc).__name__)
            self.tracer.finish(root)

    def infer(self, left: np.ndarray, right: np.ndarray,
              deadline_ms: Optional[float] = None,
              timeout: Optional[float] = None,
              tier: Optional[str] = None,
              degradable: bool = True,
              model: Optional[str] = None,
              trace_context=None) -> ServeResult:
        """Blocking convenience: submit + wait (the in-process client)."""
        return self.submit(left, right, deadline_ms, tier=tier,
                           degradable=degradable, model=model,
                           trace_context=trace_context
                           ).result(timeout=timeout)

    # ------------------------------------------------------------ readiness
    @property
    def ready(self) -> bool:
        """The /readyz gate: every configured (worker, bucket, batch,
        tier) warm entry has dispatched at least once; False once a
        graceful shutdown begins, or while chaos holds a slow start."""
        if self._shutting_down or self._closed:
            return False
        if self.chaos is not None and self.chaos.ready_blocked():
            return False
        with self._warm_lock:
            return self._warm_target <= self._warmed

    def warm_status(self) -> Dict[str, object]:
        """Readiness detail for /readyz."""
        with self._warm_lock:
            done = len(self._warm_target & self._warmed)
            total = len(self._warm_target)
            ready = self._warm_target <= self._warmed
        return {"ready": ready and self.ready,
                "warm_done": done,
                "warm_target": total,
                "draining": self._shutting_down,
                "compiles_cold": self.metrics.compiles_cold.value,
                "compiles_warm": self.metrics.compiles_warm.value}

    def _note_warm(self, widx: int, bucket: Tuple[int, int], batch: int,
                   cache_tier: Optional[str]) -> None:
        with self._warm_lock:
            self._warmed.add((widx, tuple(bucket), batch, cache_tier))

    # --------------------------------------------------------- program cache
    def _cache_tier(self, tier: Optional[str]) -> Optional[str]:
        """The cache key a tier's programs live under: None where the
        tier's config is the base one (fixed-depth tiers share the base
        programs)."""
        if tier is None or self._tier_configs[tier] == self.effective_config:
            return None
        return tier

    def _distinct_cache_tiers(self) -> List[Optional[str]]:
        """The distinct programs the configured tiers run ("quality" and
        the base path are one)."""
        tiers = tuple(self.tiers) if self.tiers else (None,)
        return sorted({self._cache_tier(t) for t in tiers},
                      key=lambda t: (t is not None, t or ""))

    def tier_model(self, tier: Optional[str], worker: int = 0) -> RAFTStereo:
        """The model a tier's requests run on ``worker``'s device."""
        return self._tier_models[self.devices[worker]][self._cache_tier(
            tier)]

    def _cost_key(self, bucket: Tuple[int, int], batch: int,
                  tier: Optional[str] = None) -> str:
        """The JAX engine's label of one program in the cost registry."""
        cache_tier = self._cache_tier(tier)
        tail = "" if cache_tier is None else f",tier={tier}"
        qmode = self._tier_configs[cache_tier].quant
        if qmode != "off":
            tail += f",quant={qmode}"
        if self.serve_cfg.confidence:
            tail += ",conf"
        return f"serving.forward({bucket[0]}x{bucket[1]},b{batch}{tail})"

    def compiled_cost(self, bucket: Tuple[int, int], batch: int = 1,
                      tier: Optional[str] = None):
        """The cost record of a built (bucket, batch, tier) program, or
        None (no registry / not built yet)."""
        if self.costs is None:
            return None
        return self.costs.get(self._cost_key(bucket, batch, tier))

    def cached_programs(self, worker: Optional[int] = None) -> List[Tuple]:
        """``(worker, bucket, batch, cache_tier)`` of the cached programs,
        oldest first."""
        with self._cache_lock:
            return [k for i, cache in enumerate(self._compiled)
                    if worker is None or i == worker for k in cache]

    def program(self, bucket: Tuple[int, int], batch: int = 1,
                tier: Optional[str] = None, worker: int = 0):
        """The cached program of one (bucket, batch, tier) on ``worker``
        (a ``GraphForward``, ``WhileForward`` or ``PlainForward``), or
        None."""
        with self._cache_lock:
            return self._compiled[worker].get(
                (worker, tuple(bucket), batch, self._cache_tier(tier)))

    def _cached(self, key: Tuple):
        with self._cache_lock:
            return ProgramCache.get(self._compiled[key[0]], key)

    def _build(self, key: Tuple, arrays, spec):
        """Build the program of ``key`` (worker, bucket, batch,
        cache_tier) for inputs of ``arrays``' shapes, evicting the
        worker's oldest past ``max_cached_shapes``."""
        widx, bucket, batch, cache_tier = key
        model = self._tier_models[self.devices[widx]][cache_tier]
        forward = make_forward(model, self.serve_cfg.iters,
                               FETCH_DTYPES[self.serve_cfg.fetch_dtype],
                               return_confidence=self.serve_cfg.confidence)
        self.metrics.compiles_cold.inc()
        with self._cache_lock:
            entry = self._programs[widx].add(
                self._compiled[widx], key, forward, arrays, spec,
                early_exit_enabled(model.config))
            if self.costs is not None:
                self.costs.note_runner_cache_size(
                    sum(map(len, self._compiled)))
        return entry

    def _evicted(self, cache: Dict, key: Tuple) -> None:
        if self.costs is not None:
            self.costs.note_runner_eviction(self._cost_key(*key[1:]),
                                            len(cache))

    def _first_call(self, entry, key: Tuple, arrays) -> List[np.ndarray]:
        """A new program's first call (the capture on the card), measured
        into the cost registry where one is attached."""
        call = entry.capture if isinstance(entry, _Graphed) else entry
        if self.costs is None:
            return call(*arrays)
        widx, bucket, batch, cache_tier = key
        cfg = self._tier_configs[cache_tier]
        model = self._tier_models[self.devices[widx]][cache_tier]
        iters = (model.exit_bounds(self.serve_cfg.iters)[0]
                 if early_exit_enabled(cfg) else self.serve_cfg.iters)
        return self.costs.measure(
            call, *arrays, key=self._cost_key(bucket, batch, cache_tier),
            site="serving", flops=forward_flops(cfg, bucket, batch, iters),
            device=self.devices[widx])

    def _count(self, captures: int = 0, replays: int = 0) -> None:
        with self._cache_lock:
            self.captures += captures
            self.replays += replays

    def _dispatch(self, widx: int, key: Tuple, p1: np.ndarray,
                  p2: np.ndarray) -> Tuple[List[np.ndarray], float]:
        """One dispatch of the program of ``key`` on ``worker``'s thread:
        ``(outputs, t_ready)``.  A miss builds and captures under the
        exclusive gate; a replay uploads, replays and synchronizes under
        the shared one (``t_ready``), then fetches."""
        arrays, spec = tree_flatten((p1, p2))
        entry = self._cached(key)
        cuda = self.devices[widx].type == "cuda"
        if entry is None or (cuda and entry.outputs is None):
            gate = self._gate.exclusive() if cuda else contextlib.nullcontext()
            with gate:
                if entry is None:
                    entry = self._build(key, arrays, spec)
                if cuda:
                    self._count(captures=1, replays=1)
                out = self._first_call(entry, key, arrays)
            return out, time.monotonic()
        if not cuda:
            out = entry(*arrays)
            return out, time.monotonic()
        with self._gate.shared():
            self._count(replays=1)
            return entry.timed_call(*arrays)

    # ---------------------------------------------------------------- prewarm
    def _run_on_worker(self, widx: int, fn) -> Future:
        fut: Future = Future()
        if self._closed:
            fut.set_exception(RuntimeError("engine closed"))
            return fut
        self._tasks[widx].append((fn, fut))
        return fut

    def _run_tasks(self, widx: int) -> None:
        tasks = self._tasks[widx]
        while tasks:
            fn, fut = tasks.popleft()
            try:
                fut.set_result(fn())
            except Exception as e:  # noqa: BLE001 — raised by the caller
                fut.set_exception(e)

    def prewarm(self, raw_hw: Tuple[int, int],
                batch_sizes: Optional[Sequence[int]] = None,
                tiers: Optional[Sequence[Optional[str]]] = None) -> None:
        """Build and warm the whole bucket ladder for one raw shape on
        every worker: each batch size of each distinct tier program runs
        once with zero images, on the worker's own thread (on the card:
        the capture), so the first real requests at this shape replay.
        Fixed-depth tiers share the base programs, so the ladder is built
        once per distinct program."""
        h, w = int(raw_hw[0]), int(raw_hw[1])
        hp, wp, _ = self.policy.bucket_for(h, w)
        sizes = tuple(batch_sizes) if batch_sizes else self.queue.sizes
        if tiers is None:
            cache_tiers = self._distinct_cache_tiers()
        else:
            cache_tiers = sorted({self._cache_tier(t) for t in tiers},
                                 key=lambda t: (t is not None, t or ""))

        def warm(widx):
            for tier in cache_tiers:
                for n in sizes:
                    zeros = np.zeros((n, hp, wp, 3), np.uint8)
                    self._dispatch(widx, (widx, (hp, wp), n, tier), zeros,
                                   zeros.copy())
                    self._note_warm(widx, (hp, wp), n, tier)

        futures = [self._run_on_worker(widx, lambda i=widx: warm(i))
                   for widx in range(len(self.devices))]
        for f in futures:
            f.result()
        log.info("prewarmed bucket %dx%d batch sizes %s (%d tier "
                 "program(s)) on %d worker(s)", hp, wp, sizes,
                 len(cache_tiers), len(self.devices))

    # --------------------------------------------------------------- workers
    def _worker_loop(self, widx: int) -> None:
        """One device worker under supervision.  The circuit breaker gates
        the pop; a dispatch crash hands the batch to the recovery path and
        then restarts the worker thread.  Between pops the worker runs the
        tasks handed to it (prewarm)."""
        dev = self.devices[widx]
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        breaker = self.breakers[widx]
        while True:
            self._run_tasks(widx)
            delay = breaker.until_allowed()
            if delay > 0:
                if self._closed:
                    return
                time.sleep(min(delay, 0.05))
                continue
            batch = self.queue.pop(timeout=_TASK_POLL_S)
            if batch is None:
                if self._closed:        # queue closed: worker shutdown
                    return
                continue
            try:
                self._run_batch(widx, batch)
                breaker.record_success()
            except BaseException as e:  # noqa: BLE001 — recover, restart
                self._on_dispatch_failure(widx, batch, e)
                self.metrics.inflight.dec(len(batch))
                self._restart_worker(widx)
                return              # this thread exits; successor took over
            self.metrics.inflight.dec(len(batch))

    # ---------------------------------------------------- supervised recovery
    def _on_dispatch_failure(self, widx: int, batch: List[Request],
                             exc: BaseException) -> None:
        """The recovery path for one crashed dispatch: record the breaker
        failure, requeue the unresolved requests with backoff, and poison
        the ones that exhausted their attempts."""
        pending = [r for r in batch if not r.future.done()]
        log.exception("dispatch of %d request(s) crashed on worker %d "
                      "(%d unresolved)", len(batch), widx, len(pending))
        self.breakers[widx].record_failure()
        sink = self.sink
        if sink is not None:
            sink.fire("worker_crash", device=widx, batch_size=len(batch),
                      unresolved=len(pending),
                      error=f"{type(exc).__name__}: {exc}")
        retry: List[Request] = []
        now_pc = time.perf_counter()
        for r in pending:
            r.attempts += 1
            if r.attempts >= self.serve_cfg.max_dispatch_attempts:
                self.metrics.poisoned.inc()
                self.metrics.failed.inc()
                if r.trace is not None and r.trace.root is not None:
                    r.trace.root.set_attr("attempts", r.attempts)
                r.future.set_exception(RequestPoisoned(
                    f"dispatch crashed on all {r.attempts} attempts "
                    f"(last: {type(exc).__name__}: {exc})",
                    attempts=r.attempts, last_error=exc))
            else:
                retry.append(r)
        if not retry:
            return
        self.metrics.retries.inc(len(retry))
        attempt = max(r.attempts for r in retry)
        backoff_s = (self.serve_cfg.retry_backoff_ms / 1e3
                     * 2 ** (attempt - 1))
        for r in retry:
            if r.trace is not None:
                self.tracer.add_span(
                    "serve.retry", r.trace, now_pc, time.perf_counter(),
                    attempt=r.attempts, device=widx,
                    backoff_ms=round(backoff_s * 1e3, 3),
                    error=type(exc).__name__)
        self._schedule_requeue(retry, backoff_s)

    def _schedule_requeue(self, reqs: List[Request],
                          delay_s: float) -> None:
        """Requeue ``reqs`` after ``delay_s`` on a backoff timer, counted
        so ``drain`` waits for them and ``close`` fails them."""
        with self._retry_lock:
            self._pending_retries += len(reqs)

        entry = None

        def _requeue():
            try:
                self.queue.requeue(reqs)   # closed queue -> typed failure
            finally:
                with self._retry_lock:
                    self._pending_retries -= len(reqs)
                    self._retry_timers.discard(entry)

        timer = threading.Timer(max(0.0, delay_s), _requeue)
        timer.daemon = True
        entry = (timer, tuple(reqs))
        with self._retry_lock:
            self._retry_timers.add(entry)
        timer.start()

    def _pending_retry_count(self) -> int:
        with self._retry_lock:
            return self._pending_retries

    def _restart_worker(self, widx: int) -> None:
        """Supervisor: replace a crashed worker thread with a fresh one on
        the same device (unless the engine is closing)."""
        with self._workers_lock:
            if self._closed:
                return
            t = threading.Thread(target=self._worker_loop, args=(widx,),
                                 daemon=True, name=f"stereo-worker-{widx}")
            self._workers[widx] = t
            t.start()
        self.metrics.worker_restarts.inc()
        log.warning("worker %d restarted after dispatch crash "
                    "(restart #%d)", widx,
                    self.metrics.worker_restarts.value)

    def _run_batch(self, widx: int, batch: List[Request]) -> None:
        """One popped batch, decomposed so every dispatch runs a batch
        size of the ladder (deadline triage can shrink a batch)."""
        i = 0
        for k in decompose_batch(len(batch), self.queue.sizes):
            self._run_chunk(widx, batch[i:i + k])
            i += k

    def _run_chunk(self, widx: int, batch: List[Request]) -> None:
        t_pickup = time.monotonic()
        waits = [t_pickup - r.t_enqueue for r in batch]
        bucket = batch[0].bucket
        tier = batch[0].tier
        cache_tier = self._cache_tier(tier)
        n = len(batch)
        device_label = str(self.devices[widx])
        sampled = [r for r in batch if r.trace is not None]
        p_pickup = time.perf_counter() if sampled else 0.0
        for r in sampled:
            if r.queue_span is not None and r.queue_span.t_end is None:
                r.queue_span.set_attr("batch_size", n)
                self.tracer.finish(r.queue_span)
        if self.chaos is not None:
            self.chaos.on_compile(widx)
            self.chaos.on_dispatch(widx)
        adaptive = early_exit_enabled(self._tier_configs[cache_tier])
        with profiling.annotate("serve.device"):
            # ONE batch-n dispatch of the (bucket, n, tier) program; n == 1
            # is the solo runner's program, bit for bit.
            p1 = np.stack([r.payload.left for r in batch])
            p2 = np.stack([r.payload.right for r in batch])
            out, t_ready = self._dispatch(
                widx, (widx, tuple(bucket), n, cache_tier), p1, p2)
        p_ready = time.perf_counter() if sampled else 0.0
        flows_padded = out[0]                      # (n, Hp, Wp)
        pos = 1
        iters_used = self.serve_cfg.iters
        if adaptive:
            iters_used = int(out[1])
            pos = 2
        conf_padded = out[pos + 1] if self.serve_cfg.confidence else None
        t_fetched = time.monotonic()
        p_fetched = time.perf_counter() if sampled else 0.0
        for r in sampled:
            self.tracer.add_span(
                "serve.dispatch", r.trace, p_pickup, p_ready,
                bucket=str(bucket), batch_size=n, device=device_label,
                iters_used=iters_used, attempt=r.attempts + 1,
                **({"tier": tier} if tier is not None else {}))
            self.tracer.add_span("serve.fetch", r.trace, p_ready, p_fetched,
                                 batch_size=n)
        device_s = t_ready - t_pickup
        fetch_s = t_fetched - t_ready
        self._note_dispatch_latency(batch[0].group_key,
                                    device_s + fetch_s)
        self.metrics.observe_dispatch(n)
        self.metrics.observe_iters_used(tier or "default", iters_used,
                                        self.serve_cfg.iters, n_requests=n)
        self.metrics.device_time.observe(device_s)
        self.metrics.fetch_time.observe(fetch_s)
        real_px = sum(r.payload.padder.ht * r.payload.padder.wd
                      for r in batch)
        dispatched_px = n * bucket[0] * bucket[1]
        self.metrics.observe_padding(bucket, real_px, dispatched_px)
        self.policy.note(bucket, real_px, dispatched_px)
        if self._mfu is not None:
            rec = self.compiled_cost(bucket, batch=n, tier=tier)
            if rec is not None and rec.flops:
                self.metrics.dispatched_flops.inc(rec.flops)
                self._mfu.note(rec.flops)
        self.metrics.note_batch_done()
        self._note_warm(widx, bucket, n, cache_tier)
        for i, (r, fp, wait) in enumerate(zip(batch, flows_padded, waits)):
            exemplar = r.trace.trace_id if r.trace is not None else None
            p_respond = time.perf_counter() if exemplar is not None else 0.0
            flow = r.payload.padder.unpad(fp[None])[0]
            if flow.dtype != np.float32:             # half-precision fetch
                flow = flow.astype(np.float32)
            total = t_fetched - r.t_enqueue
            self.metrics.queue_wait.observe(wait, exemplar=exemplar)
            self.metrics.total_latency.observe(total, exemplar=exemplar)
            self.metrics.completed.inc()
            conf_i = None
            conf_mean = None
            if conf_padded is not None:
                conf_i = np.ascontiguousarray(
                    r.payload.padder.unpad(conf_padded[i][None])[0],
                    dtype=np.float32)
                conf_mean = float(conf_i.mean())
                if self.quality is not None:
                    self.quality.observe(tier or "default", None, conf_mean,
                                         exemplar=exemplar)
            r.future.set_result(ServeResult(
                flow=np.ascontiguousarray(flow), queue_wait_s=wait,
                device_s=device_s, fetch_s=fetch_s, total_s=total,
                batch_size=n, iters_used=iters_used, tier=tier,
                requested_tier=r.requested_tier, attempts=r.attempts + 1,
                confidence=conf_i, confidence_mean=conf_mean,
                trace_id=exemplar))
            if exemplar is not None:
                self.tracer.add_span("serve.respond", r.trace, p_respond,
                                     time.perf_counter())

    # ---------------------------------------------------------- fleet hooks
    def set_brownout_floor(self, level: int) -> int:
        """Fleet-wide degradation floor (``POST /admin/brownout``).
        Raises ``RuntimeError`` without a brownout controller."""
        if self.brownout is None:
            raise RuntimeError(
                "this engine runs without a brownout controller "
                "(ServeConfig.brownout=False) — no ladder to degrade on")
        return self.brownout.set_floor(level)

    def begin_shutdown(self) -> None:
        """Phase one of graceful SIGTERM: ``ready`` turns False and new
        submits shed with the typed draining ``Overloaded``, while queued,
        in-flight and backoff work keeps flowing."""
        self._shutting_down = True
        self.queue.stop_admitting()

    # -------------------------------------------------------------- shutdown
    def drain(self, timeout: Optional[float] = None) -> bool:
        """Refuse new work, let the workers finish the queue, in-flight
        batches and requests in retry backoff, then stop them.  Returns
        False if ``timeout`` elapsed first."""
        self.queue.stop_admitting()
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        ok = True
        while (self.queue.depth > 0 or self.metrics.inflight.value > 0
               or self._pending_retry_count() > 0):
            if deadline is not None and time.monotonic() > deadline:
                ok = False
                break
            time.sleep(0.002)
        self.close()
        return ok

    def close(self) -> None:
        """Hard stop: closes the queue (queued requests fail with
        ``Overloaded``), fails requests in retry backoff the same way,
        stops the brownout controller, joins the workers and drops the
        programs."""
        if self._closed:
            return
        self._closed = True
        if self.brownout is not None:
            self.brownout.stop()
        self.queue.close()
        with self._retry_lock:
            entries = list(self._retry_timers)
        for timer, reqs in entries:
            timer.cancel()
            self.queue.requeue(list(reqs))
        with self._workers_lock:
            workers = list(self._workers)
        for t in workers:
            t.join(timeout=5.0)
        for tasks in self._tasks:
            while tasks:
                tasks.popleft()[1].set_exception(
                    RuntimeError("engine closed"))
        with self._cache_lock:
            for cache in self._compiled:
                cache.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


# The engine IS the service, as in the JAX package.
StereoService = ServingEngine
