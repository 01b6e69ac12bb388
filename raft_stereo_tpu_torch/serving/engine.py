"""The batch-N serving engine on the card: program cache, scheduler,
streaming sessions, supervised recovery and cost telemetry in one place.

The JAX package's ``serving/engine.py`` on torch:

* **One program per (bucket, batch, tier, family) and worker.**  A miss
  builds the runner's ``make_forward`` program for the tier's model with
  the family's streaming flags and wraps it as the runner wraps its own
  (eval/runner.py): a captured CUDA graph (``GraphForward``), or where the
  tier exits early one graph whose loop is a CUDA WHILE node
  (``WhileForward``); on the CPU the plain closure (``PlainForward``).
  Each worker keeps its programs in an LRU of ``max_cached_shapes``
  entries, with one side stream and one memory pool of its own.  The
  batch-1 program is the solo ``InferenceRunner``'s (``run_stream``'s for
  a session family), so the batch-1 answer is bit-equal to the runner's.
* **Program families.**  A stateless engine runs one family, the base
  program.  With ``sessions`` on, session frames run ``state`` (cold: the
  program also returns the padded low-resolution flow) and ``warm`` (it
  also takes the previous frame's flow as ``flow_init``); the context
  cache (``session_ctx_cache``) swaps them for ``state_ctx`` (also
  returns the context bundle) and ``warm_ctx`` (takes the bundle, skips
  the context encoder), and ``session_hidden`` each for its ``_h``
  variant (returns, and when warm takes, the GRU's hidden state).  A
  family's extra inputs ride the graph's static inputs like the images:
  each dispatch copies the batch's stacked states into them before the
  replay, and copies every state output out of the graph's static
  outputs (to the host, the context bundle to a clone on the card)
  before the next.
* **Streaming sessions** (serving/sessions.py): ``submit_session`` holds
  the session's ordering lock from admission until the frame's future
  resolves, picks the family (warm when the same bucket and raw shape
  have state; a scene cut, measured by the thumbnails' delta, falls back
  cold), and folds the frame's state back into the session when it
  completes (the keyframe guard drops the state of a warm frame that ran
  to the cap on an early-exit tier).  The flow and the hidden state live
  on the host, as numpy arrays, as in the JAX engine (the store exports
  them); the context bundle stays on the card, where its host round trip
  measured costlier than the context encoder it skips (PERF.md), and
  drops out of an export (the importer re-saves it at its next cold
  frame).  The frames of different sessions stack their states along the
  batch axis.
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
  ``max_dispatch_attempts``, then fails them with ``RequestPoisoned``; a
  crashed warm session frame retries cold and drops its session's state;
  the worker thread restarts; per-worker circuit breakers quarantine a
  failing device; brownout degrades eligible requests down the tier
  ladder.

Every upload, capture, replay and fetch of a worker happens on that
worker's thread (``prewarm`` hands its captures to the workers), and the
card's threads never capture while another thread works the card: a miss
(the program's pinned buffers, its warm-up and its capture) holds the
engine's device gate exclusively, a replay holds it shared.  Captures run
inside ``profiling.graph_capture``, so no profiler window is open during
one.

* **Tiles** (serving/tiles.py): a pair whose bucket exceeds
  ``tile_threshold_pixels`` runs as equal-height halo row tiles at one
  bucket, tier and family, so the batcher puts one image's tiles into one
  batch-N dispatch; the result is stitched and its seam measured.
* **The cascade** (``tier="auto"``): the draft tier (the cheapest rung of
  the cost ladder) answers first; a draft whose mean confidence is below
  ``cascade_threshold`` runs again on the escalation tier (the dearest
  rung), per tile past the tiling threshold.
* **The model registry** (serving/models.py): the implicit constructor
  model and every registered ``name@version`` keep their own models per
  device and their own ``ProgramCache`` per worker (so their own CUDA
  graphs and graph pool); the model joins every program key, requests of
  different models never share a dispatch, and ``retire_model`` drains a
  model's admissions before it drops its graphs and weights.
* **The artifact store** (serving/persist.py, ``executable_cache_dir``):
  the kernel libraries ``nvcc`` builds, shared between processes
  (kernels/_build.py reads it before it compiles), and the ``sessions/``
  namespace a draining engine publishes its sessions into.
* **Session handoff**: ``publish_handoff`` exports every live session in
  the JAX package's blob layout (hidden states NHWC per level, the
  context bundle dropped) under ``exec_config_fingerprint``, and a frame
  with a ``handoff_key`` adopts its session from such a blob (either
  package's), or counts the typed reason it cannot.

* **The xl tier** (``xl_mesh``): requests whose padded bucket exceeds
  ``xl_threshold_pixels`` (or that name ``tier="xl"``) run one
  context-parallel program (eval/runner.make_forward_mesh) on a device
  group of their own: ``xl_workers`` groups of rows x corr devices, carved
  from the engine's ``xl_devices`` when the caller names them, else from
  this process's local devices after the solo workers' (sharing them with
  a warning where there are too few), and skipped with the JAX engine's
  typed line where the devices cannot supply them.  Each group holds its
  own copy of the weights on its first device (the JAX engine's one
  ``device_put`` per group) and has its own worker, which pops only the
  xl family from the one shared queue; its program runs eagerly.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import hashlib
import json
import logging
import threading
import time
import weakref
from concurrent.futures import Future
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from raft_stereo_tpu_torch import profiling
from raft_stereo_tpu_torch.config import (RaftStereoConfig, RequestTier,
                                          parse_tier)
from raft_stereo_tpu_torch.eval.runner import (FETCH_DTYPES, PlainForward,
                                               ProgramCache,
                                               _Graphed, ctx_bundle,
                                               early_exit_enabled,
                                               effective_inference_config,
                                               full_fp32, make_forward,
                                               resolve_device)
from raft_stereo_tpu_torch.models.raft_stereo import RAFTStereo
from raft_stereo_tpu_torch.ops.padding import InputPadder
from raft_stereo_tpu_torch.parallel.mesh import parse_mesh_spec
from raft_stereo_tpu_torch.quant.core import is_quantized, quantize_state_dict
from raft_stereo_tpu_torch.serving.batcher import (BucketQueue, Overloaded,
                                                   Request, RequestPoisoned,
                                                   decompose_batch)
from raft_stereo_tpu_torch.serving.chaos import ChaosConfig, ChaosInjector
from raft_stereo_tpu_torch.serving.metrics import (MetricsRegistry,
                                                   ServingMetrics)
from raft_stereo_tpu_torch.serving.models import (ModelStore, ModelUnknown,
                                                  model_coord,
                                                  parse_model_spec)
from raft_stereo_tpu_torch.serving.resilience import (CIRCUIT_CLOSED,
                                                      BrownoutController,
                                                      CircuitBreaker,
                                                      circuit_state_name,
                                                      cost_ladder)
from raft_stereo_tpu_torch.serving.sessions import (SessionsDisabled,
                                                    SessionStore,
                                                    StereoSession,
                                                    frame_delta,
                                                    frame_thumbnail,
                                                    handoff_fingerprint,
                                                    handoff_session_ids,
                                                    parse_handoff_blob)
from raft_stereo_tpu_torch.telemetry.flops import forward_flops

log = logging.getLogger(__name__)

# The model's divisibility constraint: every pad grid must be a multiple
# of this, and the adaptive policy can never refine below it.
MODEL_DIVIS = 32

# How long an idle worker waits in the queue before it looks at the tasks
# handed to it (prewarm).
_TASK_POLL_S = 0.02


# The program families (eval/runner.make_forward's streaming flags), the
# JAX engine's names: the base sessionless program, the state-returning
# program session cold frames run, and the warm program that also takes a
# flow_init.  The *_CTX variants (``ServeConfig.session_ctx_cache``): cold
# frames also return the context bundle, coherent warm frames take it and
# skip the context encoder.  The ``_h`` variants
# (``ServeConfig.session_hidden``) also return the per-level GRU hidden
# state (cold frames) and take it (warm frames).
FAMILY_BASE = None
FAMILY_STATE = "state"
FAMILY_WARM = "warm"
FAMILY_STATE_CTX = "state_ctx"
FAMILY_WARM_CTX = "warm_ctx"
FAMILY_STATE_H = "state_h"
FAMILY_WARM_H = "warm_h"
FAMILY_STATE_CTX_H = "state_ctx_h"
FAMILY_WARM_CTX_H = "warm_ctx_h"
# The xl family: a fixed-depth base-arity program run context-parallel
# over a rows/corr device group (eval/runner.make_forward_mesh): one
# full-resolution pair answered by several devices.  Only the xl groups'
# workers pop these groups (``BucketQueue.pop``'s ``want``).
FAMILY_XL = "xl"

# Families that take a flow_init input.
_WARM_FAMILIES = (FAMILY_WARM, FAMILY_WARM_CTX, FAMILY_WARM_H,
                  FAMILY_WARM_CTX_H)
# _H_IN take the previous frame's hidden tree; _H_OUT return this frame's.
_H_IN_FAMILIES = (FAMILY_WARM_H, FAMILY_WARM_CTX_H)
_H_OUT_FAMILIES = (FAMILY_STATE_H, FAMILY_WARM_H, FAMILY_STATE_CTX_H,
                   FAMILY_WARM_CTX_H)
# _CTX_SAVE also return the context bundle, _CTX_REUSE take it.
_CTX_SAVE_FAMILIES = (FAMILY_STATE_CTX, FAMILY_STATE_CTX_H)
_CTX_REUSE_FAMILIES = (FAMILY_WARM_CTX, FAMILY_WARM_CTX_H)

# The share of a card's memory the sessions' context bundles may hold
# together (``session_ctx_cache`` keeps each on the card: 80.5 MB at
# 375x1242 on the default architecture, PERF.md).  Past it the bundles of
# the sessions used least recently are dropped; each re-saves at its
# session's next cold frame.
CTX_CARD_SHARE = 0.25


# ------------------------------------------------------------- ServeConfig
@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Serving knobs (model architecture stays in RaftStereoConfig), the
    JAX package's ``ServeConfig`` field for field.

    ``donate_buffers`` is accepted and does
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

    def parsed_tiers(self) -> Tuple[RequestTier, ...]:
        return tuple(parse_tier(s) for s in self.tiers)


@dataclasses.dataclass
class ServeResult:
    """One answered request: the flow plus its latency decomposition.
    The JAX package's fields (``mesh``: the mesh label of an xl
    dispatch, else None).
    A tiled answer carries ``tiles`` and ``seam_epe``, a named model's
    ``model`` and ``model_version``, a cascade answer ``escalated``,
    ``draft_tier`` and ``draft_confidence``.

    A session frame (``submit_session``) also says what happened:
    ``session_id``, ``frame_index`` (its index in the stream), ``warm``
    (the GRU started from the previous frame's flow), ``scene_cut`` (the
    delta check forced a cold start), ``frame_delta`` (the measured mean
    |delta intensity| against the previous frame, None on a cold frame
    without one), ``flow_low`` (the padded low-resolution x-flow the
    session carries forward), ``ctx_cached`` (this frame took the
    session's context bundle: the context encoder did not run), ``ctx``
    (the bundle a cold ctx-saving frame computed: numpy on the CPU,
    tensors on the card, where it stays), ``hidden`` (the
    frame's final per-level GRU hidden states, batch axis stripped, NCHW)
    and ``warm_hidden`` (this frame took the previous frame's hidden
    state)."""

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
    """What the engine parks in Request.payload: padded inputs + unpadder,
    plus (session frames only) the warm-start inputs and the state the
    completion callback folds back into the session."""

    left: np.ndarray             # (Hp, Wp, 3) host-padded
    right: np.ndarray
    padder: InputPadder
    flow_init: Optional[np.ndarray] = None   # (Hp/f, Wp/f) fp32, warm only
    hidden_init: Optional[object] = None     # warm-h: per-level hidden tree
    session: Optional[object] = None         # sessions.StereoSession
    thumb: Optional[np.ndarray] = None       # THIS frame's thumbnail
    raw_shape: Optional[Tuple[int, int]] = None
    frame_index: Optional[int] = None
    scene_cut: bool = False
    frame_delta: Optional[float] = None
    ctx_init: Optional[object] = None        # warm_ctx: the cached bundle


@dataclasses.dataclass
class _EngineModel:
    """One served model's engine-side state: the identity coordinate plus
    everything the dispatch path reads per model — the effective config
    and each tier's, the models per device and tier (fixed-depth tiers
    share the base model), the lazily quantized state, and one
    ``ProgramCache`` per worker (so the model's CUDA graphs and their
    memory pool are its own and go with it).  The implicit constructor
    model is the ``name=None`` bundle."""

    name: Optional[str]          # None = the implicit constructor model
    version: Optional[str]
    config: RaftStereoConfig
    effective_config: RaftStereoConfig
    tier_configs: Dict[Optional[str], RaftStereoConfig]
    tier_models: Dict[torch.device, Dict[Optional[str], RAFTStereo]]
    programs: List[ProgramCache]
    compiled: List[Dict[Tuple, object]]
    qstate: Optional[Mapping[str, torch.Tensor]] = None
    # Retirement latch: resolve_model refuses a retiring model (typed
    # 404) while its in-flight dispatches drain.
    retiring: bool = False

    @property
    def coord(self) -> Optional[str]:
        """``name@version``, or None for the implicit model — the tag
        cost keys and metric labels carry."""
        if self.name is None:
            return None
        return model_coord(self.name, self.version or "0")


def _to_wire(meta: Dict[str, object], arrays: Dict[str, object]):
    """A session record in the JAX package's blob layout: the hidden
    states NHWC per level (the port's are NCHW), the context bundle
    dropped (on the card it is a tree of tensors; the importer's next
    cold frame saves a new one)."""
    hidden = arrays.get("hidden")
    if hidden is not None:
        hidden = tuple(np.ascontiguousarray(np.transpose(h, (1, 2, 0)))
                       for h in hidden)
    return meta, dict(arrays, ctx=None, hidden=hidden)


def _from_wire(arrays: Dict[str, object]) -> Dict[str, object]:
    """A blob's arrays in the port's layout (``_to_wire`` undone): the
    hidden states NCHW per level; a context bundle (a JAX exporter keeps
    its NHWC host bundle) dropped, to be saved anew at the next cold
    frame."""
    hidden = arrays.get("hidden")
    if hidden is not None:
        hidden = tuple(np.ascontiguousarray(np.transpose(h, (2, 0, 1)))
                       for h in hidden)
    return dict(arrays, ctx=None, hidden=hidden)


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


def _row(leaf, i: int):
    """Member ``i`` of a batched output leaf, a copy that holds that row
    alone: a host array copied; a tensor on the card (the batch's clone,
    which no later replay writes) as it is at batch 1, else its row cloned,
    so a session's bundle never keeps its batch-mates' rows alive."""
    if not isinstance(leaf, torch.Tensor):
        return leaf[i].copy()
    return leaf[i] if leaf.shape[0] == 1 else leaf[i].clone()


def _tree_bytes(tree) -> int:
    """The bytes of a tree's array and tensor leaves."""
    return sum(x.nbytes if isinstance(x, np.ndarray)
               else x.numel() * x.element_size()
               for x in tree_flatten(tree)[0])


class _Members:
    """Batch-axis-free state trees of one structure, one per member,
    stacked along a new batch axis by ``stack`` when the dispatch runs:
    host arrays as fp32 numpy, trees on a card by ``torch.stack`` on the
    dispatching worker's device (a session's earlier frame may have run
    on another worker), which the dispatch calls under the device gate (a
    card operation)."""

    def __init__(self, trees):
        self.trees = trees

    def stack(self, device: torch.device):
        flat = [tree_flatten(t) for t in self.trees]
        leaves = []
        for members in zip(*(f[0] for f in flat)):
            if isinstance(members[0], torch.Tensor):
                members = [m.to(device) for m in members]
                leaves.append(members[0][None] if len(members) == 1
                              else torch.stack(members))
            else:
                leaves.append(np.stack(members).astype(np.float32,
                                                       copy=False))
        return tree_unflatten(leaves, flat[0][1])


@dataclasses.dataclass
class _XlGroup:
    """One xl worker's device group, the mesh over it, and the group's
    copy of the xl-config model on its first device."""

    devices: Tuple[torch.device, ...]
    mesh: object                  # parallel.mesh.Mesh
    model: RAFTStereo

    @property
    def label(self) -> str:
        return "+".join(str(d) for d in self.devices)


@dataclasses.dataclass
class _XlTier:
    """The xl tier (``ServeConfig.xl_mesh``): the parsed topology, the
    config that carries the sharding knobs (rows_shards / corr_w2_shards /
    rows_gru; the base model's architecture), its groups and one program
    cache per group."""

    spec: Dict[str, int]          # {"rows": r, "corr": c}
    label: str                    # compact tag, e.g. "rows4"
    size: int                     # devices per group (rows * corr)
    config: RaftStereoConfig
    groups: List[_XlGroup]
    programs: List[Dict[Tuple, object]]


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
                 device: Optional[Union[str, torch.device]] = None,
                 xl_devices: Optional[Sequence] = None):
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
        if serve_cfg.session_ctx_cache and config.shared_backbone:
            raise ValueError(
                "session_ctx_cache is unsupported with shared_backbone: "
                "fnet is computed from the cnet trunk, so the context "
                "encoder cannot be skipped (models/raft_stereo.py)")
        state = (variables.state_dict() if isinstance(variables, RAFTStereo)
                 else variables)
        # One side stream per worker, shared by every model's programs:
        # cuBLAS keeps a workspace per stream for the process's life, so a
        # stream per model would leave one behind at each retirement.
        self._streams = [torch.cuda.Stream(d) if d.type == "cuda" else None
                         for d in self.devices]
        # The model registry (serving/models.py): the implicit constructor
        # model under None, each registered "name@version" under its name.
        self._models_lock = threading.Lock()
        self._pending_lock = threading.Lock()
        self._model_pending: Dict[Optional[str], int] = {}
        base_bundle = self._build_bundle(None, None, config, state)
        self._models: Dict[Optional[str], _EngineModel] = {
            None: base_bundle}
        # the implicit model's effective config and first-device model
        self.effective_config = base_bundle.effective_config
        self.model = base_bundle.tier_models[self.devices[0]][None]
        self.model_store: Optional[ModelStore] = None
        store_dir = (serve_cfg.model_store_dir
                     or serve_cfg.executable_cache_dir)
        if store_dir and (serve_cfg.models or serve_cfg.model_store_dir):
            self.model_store = ModelStore(store_dir)
        self.default_model: Optional[str] = None
        for spec in serve_cfg.models:
            reg = self.model_store.resolve(spec)   # deep-verified load
            self._models[reg.name] = self._build_bundle(
                reg.name, reg.version, reg.config, reg.variables)
            log.info("model %s registered at boot", reg.coord)
        if serve_cfg.default_model is not None:
            self.default_model = serve_cfg.default_model
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
        # The xl tier: extra workers at the END of the worker table
        # (indices len(devices) ..), each over its own device group,
        # popping only FAMILY_XL groups; None without xl_mesh or where
        # the devices cannot supply the mesh (the typed skip).
        self.xl: Optional[_XlTier] = None
        self._xl_sizes: Tuple[int, ...] = ()
        if serve_cfg.xl_mesh is not None:
            self._init_xl(state, xl_devices)
        # The streaming-session store behind submit_session; None keeps
        # the engine stateless (one program family, today's surface).
        self.sessions: Optional[SessionStore] = None
        if serve_cfg.sessions:
            self.sessions = SessionStore(
                capacity=serve_cfg.session_capacity,
                ttl_s=serve_cfg.session_ttl_s,
                active_gauge=self.metrics.sessions_active,
                created_counter=self.metrics.sessions_created,
                expired_counter=self.metrics.sessions_expired,
                evicted_counter=self.metrics.sessions_evicted)
        # The card bytes the sessions' context bundles may hold
        # (``_hold_ctx``); None on the CPU, where they are host arrays as
        # in the JAX engine.
        self.ctx_budget_bytes: Optional[int] = None
        self.ctx_bundles_dropped = 0
        self._ctx_lock = threading.Lock()
        self._ctx_held: "collections.OrderedDict[int, weakref.ref]" = (
            collections.OrderedDict())
        if serve_cfg.session_ctx_cache and self.devices[0].type == "cuda":
            self.ctx_budget_bytes = int(CTX_CARD_SHARE * min(
                torch.cuda.get_device_properties(d).total_memory
                for d in set(self.devices)))
        # The artifact store (serving/persist.py): the kernel libraries
        # kernels/_build.py reads before it runs nvcc, and the sessions/
        # namespace of the handoff.
        self.disk_cache = None
        if serve_cfg.executable_cache_dir:
            from raft_stereo_tpu_torch.kernels import _build
            from raft_stereo_tpu_torch.serving.persist import (
                ExecutableDiskCache)
            self.disk_cache = ExecutableDiskCache(
                serve_cfg.executable_cache_dir,
                max_bytes=serve_cfg.executable_cache_max_bytes,
                read_only=serve_cfg.executable_cache_read_only,
                bytes_gauge=self.metrics.persist_cache_bytes)
            _build.set_artifact_store(self.disk_cache)
        # Session handoff: needs the session store and the shared
        # artifact directory; absent either, a drain loses its sessions
        # typed.
        self.handoff_store = None
        self._handoff_manifest: Optional[Dict[str, object]] = None
        self._handoff_fetched = threading.Event()
        self._handoff_lock = threading.Lock()
        self._handoff_blobs: Dict[str, Dict] = {}
        if serve_cfg.sessions and serve_cfg.executable_cache_dir:
            from raft_stereo_tpu_torch.serving.persist import (
                SessionHandoffStore)
            self.handoff_store = SessionHandoffStore(
                serve_cfg.executable_cache_dir,
                ttl_s=max(serve_cfg.session_ttl_s, 60.0) * 4)
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
            for i in range(self._worker_count())]
        for i in range(self._worker_count()):
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
        # Cascade tier resolution ("auto"): draft on the cheapest rung of
        # the cost ladder, escalate to the dearest, unless the config
        # names either.
        self._cascade_draft: Optional[str] = None
        self._cascade_escalate: Optional[str] = None
        self._cascade_drafts = None
        self._cascade_escalations = None
        if serve_cfg.cascade:
            ladder = cost_ladder(serve_cfg.parsed_tiers())
            self._cascade_draft = serve_cfg.cascade_draft or ladder[0]
            self._cascade_escalate = (serve_cfg.cascade_escalate
                                      or ladder[-1])
            if self._cascade_draft == self._cascade_escalate:
                raise ValueError(
                    f"cascade draft and escalation tiers both resolve "
                    f"to {self._cascade_draft!r} — configure "
                    f"cascade_draft/cascade_escalate explicitly")
            self._cascade_drafts = self.metrics.registry.counter(
                "serve_cascade_draft_total",
                "Cascade (tier=auto) requests answered by the draft "
                "tier alone")
            self._cascade_escalations = self.metrics.registry.counter(
                "serve_cascade_escalated_total",
                "Cascade (tier=auto) requests escalated to the "
                "expensive tier on low draft confidence")
        self._retry_lock = threading.Lock()
        self._pending_retries = 0
        self._retry_timers: set = set()   # (Timer, reqs) pairs
        # Readiness: warmup_shapes x distinct tier programs x batch sizes
        # x families x workers; ready once every entry has dispatched once.
        self._warm_lock = threading.Lock()
        self._warmed: set = set()
        self._warm_target: set = set()
        for mname in self._registered_names():
            self._extend_warm_target(mname)
        per_bucket = (len(self._distinct_cache_tiers())
                      * len(self.queue.sizes) * len(self._families()))
        if per_bucket > serve_cfg.max_cached_shapes:
            log.warning(
                "%d programs per bucket and worker (%d tier program(s) x "
                "batch sizes %s x families %s) exceed max_cached_shapes=%d:"
                " prewarm evicts programs it built and live requests "
                "capture them again; raise max_cached_shapes or cut "
                "batch_sizes", per_bucket, len(self._distinct_cache_tiers()),
                self.queue.sizes, self._families(),
                serve_cfg.max_cached_shapes)
        self._closed = False
        self._shutting_down = False
        self._tasks = [collections.deque()
                       for _ in range(self._worker_count())]
        self._workers_lock = threading.Lock()
        self._workers = [
            threading.Thread(target=self._worker_loop, args=(i,),
                             daemon=True, name=f"stereo-worker-{i}")
            for i in range(self._worker_count())]
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

    def _build_bundle(self, name: Optional[str], version: Optional[str],
                      config: RaftStereoConfig,
                      state: Mapping[str, torch.Tensor]) -> _EngineModel:
        """One model's engine-side state: its effective config and each
        tier's, its models on every device, and one ``ProgramCache`` per
        worker.  The same construction for the implicit model and every
        registered one."""
        eff = self._effective(config)
        tier_configs: Dict[Optional[str], RaftStereoConfig] = {None: eff}
        for tname, tier in self.tiers.items():
            tier_configs[tname] = self._effective(tier.apply(config))
        # one ProgramCache per worker: its LRU and graph pool (the
        # worker's side stream)
        programs = [ProgramCache(dev, self.serve_cfg.max_cached_shapes,
                                 on_evict=self._evicted)
                    for dev in self.devices]
        for p, stream in zip(programs, self._streams):
            p.stream = stream
        bundle = _EngineModel(name=name, version=version, config=config,
                              effective_config=eff,
                              tier_configs=tier_configs, tier_models={},
                              programs=programs,
                              compiled=[p.lru() for p in programs])
        for dev in dict.fromkeys(self.devices):
            bundle.tier_models[dev] = self._build_models(bundle, state, dev)
        return bundle

    def _build_models(self, bundle: _EngineModel,
                      state: Mapping[str, torch.Tensor],
                      dev: torch.device) -> Dict[Optional[str], RAFTStereo]:
        """One device's models of one bundle: the base model of the fp32
        state, a model per distinct tier config sharing its tensors, and
        the quantized tiers' models over the state quantized once per
        bundle."""
        def load(cfg, sd):
            m = RAFTStereo(cfg)
            m.load_state_dict(sd, strict=True)
            return m.to(dev).eval().cast_weights_()

        base_cfg = bundle.effective_config
        base = load(base_cfg, state)
        models: Dict[Optional[str], RAFTStereo] = {None: base}
        by_config: Dict[RaftStereoConfig, RAFTStereo] = {base_cfg: base}
        by_quant: Dict[str, RAFTStereo] = {}
        for tname, teff in bundle.tier_configs.items():
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
                m = load(teff, self._quantized_state(bundle, state))
                by_quant[teff.quant] = m
            models[tname] = by_config[teff] = m.to(dev).eval()
        return models

    def _quantized_state(self, bundle: _EngineModel,
                         state: Mapping[str, torch.Tensor]
                         ) -> Mapping[str, torch.Tensor]:
        if is_quantized(state):
            return state
        if bundle.qstate is None:
            bundle.qstate = quantize_state_dict(
                state, act_scales=self._quant_act_scales)
        return bundle.qstate

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

    # ------------------------------------------------------------- xl tier
    def _xl_model_config(self, spec: Dict[str, int]) -> RaftStereoConfig:
        """The config of the xl programs: the engine's effective config
        with the mesh's sharding knobs.  Raises ``ValueError`` at
        construction for architecture and mesh combinations the sharded
        executors do not run, with the JAX engine's messages."""
        base = self.effective_config
        rows, corr = spec["rows"], spec["corr"]
        if corr > 1 and base.corr_backend == "alt":
            raise ValueError(
                "xl_mesh corr sharding shards the 'reg' correlation "
                "volume and is incompatible with corr_backend='alt' "
                "(which builds no volume) — use 'reg'/'reg_fused' or a "
                "rows-only mesh")
        if rows > 1:
            from raft_stereo_tpu_torch.models.banded import banded_supported
            norms = (base.context_norm,) + (
                () if base.shared_backbone else (base.fnet_norm,))
            for norm in norms:
                if not banded_supported(norm, base.n_downsample):
                    raise ValueError(
                        f"xl_mesh rows sharding is unsupported for this "
                        f"architecture: norm {norm!r} with n_downsample="
                        f"{base.n_downsample} (parallel/rows_sharded.py "
                        f"supports the published n_downsample=2 trunks)")
        # fixed depth, full precision, unbanded; rows_gru needs the
        # volume unsharded, so a rows x corr mesh shards the encoders and
        # the volume and leaves the loop on the group's first device
        return dataclasses.replace(
            base, rows_shards=rows, corr_w2_shards=corr,
            rows_gru=(rows > 1 and corr == 1), banded_encoder=False,
            exit_threshold_px=0.0, exit_max_iters=None,
            quant="off", quant_corr_scales=None)

    def _init_xl(self, state: Mapping[str, torch.Tensor],
                 xl_devices: Optional[Sequence]) -> None:
        """Carve the xl device groups from ``xl_devices`` where the caller
        names them; else from this process's local devices
        (``distributed.local_devices_stable``) after the solo workers'
        devices, sharing them with a warning where there are too few.
        Where the devices cannot supply the groups, log the typed skip
        line and serve without the tier."""
        from raft_stereo_tpu_torch.parallel.distributed import (
            device_groups, local_devices_stable)
        from raft_stereo_tpu_torch.parallel.mesh import (make_mesh,
                                                         mesh_spec_label)

        serve_cfg = self.serve_cfg
        spec = parse_mesh_spec(serve_cfg.xl_mesh)
        size = spec["rows"] * spec["corr"]
        xl_cfg = self._xl_model_config(spec)      # typed on bad combos
        pool = [torch.device(d) for d in (
            xl_devices if xl_devices is not None
            else local_devices_stable())]
        groups_devs = device_groups(
            size, serve_cfg.xl_workers, devices=pool,
            skip=0 if xl_devices is not None else len(self.devices))
        if not groups_devs and xl_devices is None:
            groups_devs = device_groups(size, serve_cfg.xl_workers,
                                        devices=pool)
            if groups_devs:
                log.warning(
                    "xl_mesh=%s: not enough devices after the %d solo "
                    "worker(s) — xl group(s) share their devices "
                    "(dispatches contend; size data_parallel + "
                    "xl_workers*%d <= %d local devices to avoid this)",
                    serve_cfg.xl_mesh, len(self.devices), size, len(pool))
        if not groups_devs:
            log.warning(
                "xl_mesh=%s skipped: this replica has %d local "
                "device(s) but the mesh needs %d x %d worker group(s) "
                "— serving WITHOUT the xl tier (big requests fall back "
                "to tiling / solo dispatch)", serve_cfg.xl_mesh,
                len(pool), size, serve_cfg.xl_workers)
            return
        groups = []
        for devs in groups_devs:
            model = RAFTStereo(xl_cfg)
            model.load_state_dict(state, strict=True)
            groups.append(_XlGroup(
                devices=tuple(devs),
                mesh=make_mesh(n_corr=spec["corr"], n_rows=spec["rows"],
                               devices=devs),
                model=model.to(devs[0]).eval().cast_weights_()))
        self.xl = _XlTier(spec=spec, label=mesh_spec_label(spec), size=size,
                          config=xl_cfg, groups=groups,
                          programs=[{} for _ in groups])
        self._xl_sizes = tuple(sorted(set(
            int(s) for s in serve_cfg.xl_batch_sizes)))
        log.info("xl tier up: mesh %s (%s), %d group(s) of %d device(s), "
                 "routing buckets > %d px (and ?tier=xl)",
                 serve_cfg.xl_mesh, self.xl.label, len(groups), size,
                 serve_cfg.xl_threshold_pixels)

    @property
    def xl_enabled(self) -> bool:
        return self.xl is not None

    def _worker_count(self) -> int:
        return len(self.devices) + (len(self.xl.groups)
                                    if self.xl is not None else 0)

    def _is_xl_worker(self, widx: int) -> bool:
        return widx >= len(self.devices)

    def _xl_group(self, widx: int) -> _XlGroup:
        return self.xl.groups[widx - len(self.devices)]

    def _xl_worker_indices(self) -> List[int]:
        if self.xl is None:
            return []
        return list(range(len(self.devices),
                          len(self.devices) + len(self.xl.groups)))

    def _worker_device(self, widx: int) -> torch.device:
        """The device a worker runs on: its own, or its group's first."""
        if self._is_xl_worker(widx):
            return self._xl_group(widx).devices[0]
        return self.devices[widx]

    def _xl_compatible(self, bucket: Tuple[int, int]) -> Tuple[bool, str]:
        """Whether a padded bucket fits the xl mesh's geometry (trunk row
        divisibility, the rows_gru window constraints), with the reason
        where it does not."""
        if self.xl is None:
            return False, "no xl mesh on this engine"
        cfg = self.xl.config
        rows = cfg.rows_shards
        h = int(bucket[0])
        if rows > 1:
            if h % (4 * rows):
                return False, (f"padded H={h} not divisible by 4*rows="
                               f"{4 * rows} (stride-2 trunk stages)")
            from raft_stereo_tpu_torch.parallel.rows_sharded import \
                DEFAULT_HALO
            if h // rows < DEFAULT_HALO:
                return False, (f"per-shard rows H/rows={h // rows} < "
                               f"trunk halo {DEFAULT_HALO}")
            if cfg.rows_gru:
                from raft_stereo_tpu_torch.parallel.rows_gru import \
                    validate_rows_gru
                try:
                    validate_rows_gru(cfg, h // cfg.downsample_factor,
                                      rows)
                except ValueError as e:
                    return False, str(e)
        return True, ""

    def _xl_routes(self, bucket: Tuple[int, int]) -> bool:
        """Whether a stateless request at this bucket routes to the xl
        family by itself (prewarm and readiness use the same test)."""
        px = bucket[0] * bucket[1]
        return (self.xl is not None
                and px > self.serve_cfg.xl_threshold_pixels
                and (self.serve_cfg.xl_max_pixels is None
                     or px <= self.serve_cfg.xl_max_pixels)
                and self._xl_compatible(bucket)[0])

    def xl_status(self) -> Optional[Dict[str, object]]:
        """The /healthz line of the xl tier, or None without one."""
        if self.xl is None:
            return None
        return {"mesh": self.serve_cfg.xl_mesh, "label": self.xl.label,
                "groups": len(self.xl.groups),
                "devices_per_group": self.xl.size,
                "threshold_pixels": self.serve_cfg.xl_threshold_pixels,
                "batch_sizes": list(self._xl_sizes)}

    def _xl_dispatch(self, widx: int, key: Tuple, p1: np.ndarray,
                     p2: np.ndarray) -> Tuple[List[np.ndarray], float]:
        """One dispatch of the xl program of ``key`` on xl worker
        ``widx``'s group: built at its first use (eager, uploading to the
        group's first device), run under the shared gate on the card (a
        solo worker's capture holds it exclusively)."""
        from raft_stereo_tpu_torch.eval.runner import make_forward_mesh

        group = self._xl_group(widx)
        cache = self.xl.programs[widx - len(self.devices)]
        arrays, spec = tree_flatten((p1, p2))
        with self._cache_lock:
            entry = cache.get(key)
        if entry is None:
            forward = make_forward_mesh(
                group.model, self.serve_cfg.iters, group.mesh,
                FETCH_DTYPES[self.serve_cfg.fetch_dtype])
            entry = PlainForward(forward, spec, group.devices[0])
            with self._cache_lock:
                cache[key] = entry
            self.metrics.compiles_cold.inc()
            if self.costs is not None:
                cfg = self.xl.config
                out = self.costs.measure(
                    entry, *arrays,
                    key=self._xl_cost_key(key[1], key[2]), site="serving",
                    flops=forward_flops(cfg, key[1], key[2],
                                        self.serve_cfg.iters),
                    device=group.devices[0])
                rec = self.costs.get(self._xl_cost_key(key[1], key[2]))
                if rec is not None and rec.hbm_bytes:
                    self.metrics.xl_hbm_gauge(
                        self.xl.label,
                        f"{key[1][0]}x{key[1][1]}").set(rec.hbm_bytes)
                return out, time.monotonic()
        gate = (self._gate.shared() if group.devices[0].type == "cuda"
                else contextlib.nullcontext())
        with gate:
            out = entry(*arrays)
        return out, time.monotonic()

    def _xl_cost_key(self, bucket: Tuple[int, int], batch: int) -> str:
        return self._cost_key(bucket, batch, family=FAMILY_XL)

    # -------------------------------------------------------- model registry
    def _registered_names(self, include_implicit: bool = True
                          ) -> List[Optional[str]]:
        """Model names this engine serves, implicit first — what the
        warm target and prewarm iterate."""
        with self._models_lock:
            names = sorted(n for n in self._models if n is not None)
        return ([None] + names) if include_implicit else names

    def resolve_model(self, model: Optional[str]) -> Optional[str]:
        """The model a request actually runs: the named one (validated
        against the registry), or the default-model pointer, or None
        (the implicit constructor model).  Raises the typed
        ``ModelUnknown`` (HTTP 404 ``model_unknown``) on an
        unregistered or retiring name."""
        if model is None:
            model = self.default_model
        if model is None:
            return None
        bundle = self._models.get(model)
        if bundle is None or bundle.retiring:
            with self._models_lock:
                known = [n for n, b in self._models.items()
                         if n is not None and not b.retiring]
            raise ModelUnknown(model, known)
        return model

    def _note_pending(self, model: Optional[str], delta: int) -> None:
        """Per-model in-flight admission count — ``retire_model``'s
        drain signal (a model with pending admissions must not lose its
        graphs and weights under a dispatch that will still read them)."""
        with self._pending_lock:
            self._model_pending[model] = (
                self._model_pending.get(model, 0) + delta)

    def _model_pending_count(self, model: Optional[str]) -> int:
        with self._pending_lock:
            return self._model_pending.get(model, 0)

    def _extend_warm_target(self, name: Optional[str]) -> None:
        """Grow the /readyz warm surface by one model's ladder: ``ready``
        turns False until the new model's prewarm completes.  A bucket
        that routes to the xl tier warms the xl groups' ladder alone
        (named models never route xl)."""
        with self._warm_lock:
            for hw in self.serve_cfg.warmup_shapes:
                hp, wp, _ = self.policy.bucket_for(int(hw[0]), int(hw[1]))
                if self._xl_routes((hp, wp)):
                    if name is None:
                        for widx in self._xl_worker_indices():
                            for n in self._xl_sizes:
                                self._warm_target.add(
                                    (widx, (hp, wp), n, None, FAMILY_XL,
                                     None))
                    continue
                for widx in range(len(self.devices)):
                    for tier in self._distinct_cache_tiers(name):
                        for n in self.queue.sizes:
                            for family in self._families():
                                self._warm_target.add(
                                    (widx, (hp, wp), n, tier, family,
                                     name))

    def _purge_model_cache(self, bundle: _EngineModel,
                           drop_target: bool = False) -> None:
        """Drop one model's programs (its CUDA graphs: their pool goes
        with the last of them) and warm entries (same-name version
        replace / retirement)."""
        with self._cache_lock:
            for cache in bundle.compiled:
                cache.clear()
        with self._warm_lock:
            self._warmed = {e for e in self._warmed
                            if e[5] != bundle.name}
            if drop_target:
                self._warm_target = {e for e in self._warm_target
                                     if e[5] != bundle.name}

    def register_model(self, spec: str, set_default: bool = False,
                       prewarm: bool = True) -> Dict[str, object]:
        """Hot-register a model version on this LIVE engine (``POST
        /admin/models``): deep-verified store load, bundle build (models
        on every device, a ProgramCache per worker), warm-target
        extension, prewarm of the declared ladder and — only then, when
        asked — the atomic default-pointer flip.  Re-registering the
        SAME name@version is idempotent; a new version under a live name
        replaces it (the old version's programs are dropped)."""
        if self.model_store is None:
            store_dir = (self.serve_cfg.model_store_dir
                         or self.serve_cfg.executable_cache_dir)
            if not store_dir:
                raise RuntimeError(
                    "no model store: construct the engine with "
                    "ServeConfig.model_store_dir (or "
                    "executable_cache_dir) to register models")
            self.model_store = ModelStore(store_dir)
        reg = self.model_store.resolve(spec)   # deep SHA-256 verify
        with self._models_lock:
            existing = self._models.get(reg.name)
            fresh = not (existing is not None
                         and existing.version == reg.version
                         and not existing.retiring)
        if fresh:
            bundle = self._build_bundle(reg.name, reg.version,
                                        reg.config, reg.variables)
            if existing is not None:
                # Same-name version replace: the old version's programs
                # must never answer the new version's requests.
                self._purge_model_cache(existing)
            with self._models_lock:
                self._models[reg.name] = bundle
            self._extend_warm_target(reg.name)
            log.info("model %s registered%s", reg.coord,
                     " (replacing a live version)" if existing else "")
            if prewarm:
                for hw in self.serve_cfg.warmup_shapes:
                    self.prewarm(hw, models=[reg.name])
        if set_default:
            self.set_default_model(reg.name)
        return {"model": reg.name, "version": reg.version,
                "registered": bool(fresh),
                "default": self.default_model,
                "ready": self.ready}

    def set_default_model(self, name: Optional[str]) -> Optional[str]:
        """Atomically flip the default-model pointer (what unnamed
        requests run); None restores the implicit constructor model.
        The flip is the LAST step of a rollout — ``register_model``
        prewarms before it, so the first request after it replays warm
        programs."""
        with self._models_lock:
            if name is not None:
                b = self._models.get(name)
                if b is None or b.retiring:
                    raise ModelUnknown(
                        name, [n for n, bb in self._models.items()
                               if n is not None and not bb.retiring])
            previous, self.default_model = self.default_model, name
        log.info("default model: %s -> %s", previous, name)
        return name

    def retire_model(self, name: str, timeout: float = 30.0
                     ) -> Dict[str, object]:
        """Retire a registered model from this live engine: latch it
        retiring (new requests get the typed 404), DRAIN its in-flight
        admissions, then drop its programs (CUDA graphs and their pool)
        and its models.  Refuses the current default (RuntimeError —
        flip the pointer first; HTTP 409) and raises ``TimeoutError``
        (retiring latch released) if in-flight work does not drain in
        ``timeout``."""
        with self._models_lock:
            bundle = self._models.get(name) if name is not None else None
            if bundle is None:
                raise ModelUnknown(
                    name, [n for n in self._models if n is not None])
            if self.default_model == name:
                raise RuntimeError(
                    f"model {name!r} is the default — set_default_model "
                    f"to another version before retiring it")
            bundle.retiring = True
        deadline = time.monotonic() + max(0.0, timeout)
        while self._model_pending_count(name) > 0:
            if time.monotonic() > deadline:
                with self._models_lock:
                    bundle.retiring = False
                raise TimeoutError(
                    f"model {name!r}: {self._model_pending_count(name)} "
                    f"admission(s) still in flight after {timeout}s — "
                    f"retirement rolled back")
            time.sleep(0.005)
        with self._models_lock:
            self._models.pop(name, None)
        self._purge_model_cache(bundle, drop_target=True)
        bundle.tier_models.clear()
        bundle.qstate = None
        with self._pending_lock:
            self._model_pending.pop(name, None)
        log.info("model %s retired (drained, programs and weights "
                 "dropped)", bundle.coord)
        return {"model": name, "version": bundle.version,
                "retired": True}

    def models_status(self) -> Dict[str, object]:
        """The registry's JSON line (/healthz, /admin/models GET):
        registered versions, the default pointer, per-model in-flight
        admissions."""
        with self._models_lock:
            registered = [
                {"name": b.name, "version": b.version,
                 "coord": b.coord, "retiring": b.retiring}
                for n, b in sorted(self._models.items(),
                                   key=lambda kv: kv[0] or "")
                if n is not None]
        with self._pending_lock:
            pending = {(k if k is not None else "(implicit)"): v
                       for k, v in self._model_pending.items() if v > 0}
        return {"default": self.default_model,
                "registered": registered, "pending": pending}

    def quality_status(self) -> Optional[Dict[str, object]]:
        """Online quality posture (``GET /quality``); None with confidence
        telemetry off."""
        if self.quality is None:
            return None
        return self.quality.status()

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
        caller's trace.

        Past ``tile_threshold_pixels`` the request is answered by halo row
        tiles through the ordinary batcher; the stitched result carries
        ``tiles`` and ``seam_epe``.  ``model`` selects a registered model
        version (None: the default-model pointer); an unknown or retiring
        name raises ``ModelUnknown`` (HTTP 404), and requests of
        different models never share a dispatch.  ``tier="auto"`` is the
        confidence-gated cascade (``ServeConfig.cascade``): the draft
        tier answers first and the escalation tier runs only when the
        draft's mean confidence is below ``cascade_threshold``, per tile
        past the tiling threshold."""
        t_admit = time.perf_counter()
        model = self.resolve_model(model)
        left, right = np.asarray(left), np.asarray(right)
        if left.ndim != 3 or left.shape != right.shape:
            raise ValueError(
                f"need two same-shape (H, W, 3) images, got {left.shape} "
                f"vs {right.shape}")
        bucket = self.policy.bucket_for(left.shape[0], left.shape[1])[:2]
        if tier == "auto":
            # A pseudo-tier, resolved here, never a queue coordinate.
            if self._cascade_draft is None:
                raise ValueError(
                    "tier 'auto' requested but this engine has no "
                    "cascade (configure ServeConfig.cascade / --cascade "
                    "with confidence telemetry on)")
            return self._submit_cascade(left, right, deadline_ms,
                                        degradable, t_admit, model,
                                        trace_context=trace_context)
        want_xl = tier == "xl"
        if want_xl and self.xl is None:
            raise ValueError(
                "tier 'xl' requested but this engine has no xl tier "
                "(configure ServeConfig.xl_mesh / --xl_mesh, and enough "
                "devices for the mesh)")
        if want_xl and model is not None:
            raise ValueError(
                f"tier 'xl' serves only the implicit constructor model "
                f"(the mesh groups replicate its weights); model "
                f"{model!r} cannot ride it")
        if (model is None and self.xl is not None
                and (want_xl or self._xl_routes(bucket))):
            ok, reason = self._xl_compatible(bucket)
            if ok:
                # the fixed-depth full-precision program: no tier ladder,
                # no brownout rung below it
                return self._enqueue(left, right, deadline_ms, None, None,
                                     t_admit, family=FAMILY_XL,
                                     trace_context=trace_context).future
            if want_xl:
                raise ValueError(
                    f"tier 'xl': bucket {bucket[0]}x{bucket[1]} does "
                    f"not fit mesh {self.serve_cfg.xl_mesh}: {reason}")
            log.info("bucket %sx%s exceeds xl_threshold_pixels but does "
                     "not fit mesh %s (%s) — falling through to "
                     "tiling/solo dispatch", bucket[0], bucket[1],
                     self.serve_cfg.xl_mesh, reason)
        tier, requested_tier = self._admit_tier(tier, degradable)
        tt = self.serve_cfg.tile_threshold_pixels
        if tt is not None and bucket[0] * bucket[1] > tt:
            return self._submit_tiled(left, right, deadline_ms, tier,
                                      requested_tier, t_admit, model,
                                      trace_context=trace_context)
        return self._enqueue(left, right, deadline_ms, tier,
                             requested_tier, t_admit, model=model,
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
                 family: Optional[str] = FAMILY_BASE,
                 session=None, session_id: Optional[str] = None,
                 flow_init: Optional[np.ndarray] = None,
                 thumb: Optional[np.ndarray] = None,
                 frame_index: Optional[int] = None,
                 scene_cut: bool = False,
                 frame_delta_v: Optional[float] = None,
                 ctx_init=None, hidden_init=None,
                 model: Optional[str] = None,
                 trace_context=None) -> Request:
        """Pad, build, trace, and queue one request: a stateless one
        (base family, no session fields) or a session frame.  ``model``
        is the RESOLVED registered-model name (None = implicit); it joins
        the queue's group key, so models never share a dispatch."""
        hp, wp, grid = self.policy.bucket_for(left.shape[0], left.shape[1])
        padder = InputPadder((1, 3) + left.shape[:2], divis_by=grid)
        l, r, t, b = padder.pads
        spec = ((t, b), (l, r), (0, 0))
        payload = _Payload(left=np.pad(left, spec, mode="edge"),
                           right=np.pad(right, spec, mode="edge"),
                           padder=padder, flow_init=flow_init,
                           hidden_init=hidden_init, session=session,
                           thumb=thumb, raw_shape=tuple(left.shape[:2]),
                           frame_index=frame_index, scene_cut=scene_cut,
                           frame_delta=frame_delta_v, ctx_init=ctx_init)
        now = time.monotonic()
        deadline_ms = (deadline_ms if deadline_ms is not None
                       else self.serve_cfg.default_deadline_ms)
        req = Request(bucket=(hp, wp), payload=payload,
                      future=Future(), t_enqueue=now, tier=tier,
                      requested_tier=requested_tier, family=family,
                      session_id=session_id, model=model,
                      deadline=(None if deadline_ms is None
                                else now + deadline_ms / 1e3))
        # Per-model in-flight accounting (retire_model's drain signal):
        # up before the queue sees the request, down when its future
        # resolves (a refused request's future never resolves: the
        # Overloaded path below takes it down itself).
        self._note_pending(model, +1)
        req.future.add_done_callback(
            lambda f, m=model: self._note_pending(m, -1))
        trace_attrs = dict(
            bucket=str(req.bucket), deadline_ms=deadline_ms,
            **({"tier": tier} if tier is not None else {}),
            **({"session": session_id} if session_id is not None else {}))
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
            self._note_pending(model, -1)
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

    # ------------------------------------------------------------- tiles
    def _when_all(self, futures: Sequence[Future], finish) -> Future:
        """A Future that resolves once every one of ``futures`` did, with
        ``finish()``'s result; the first failure fails it with that
        future's typed error, and later ones are no-ops."""
        agg: Future = Future()
        state = {"remaining": len(futures), "done": False}
        lock = threading.Lock()

        def on_done(future):
            # one-shot resolution decided inside the lock
            action = None
            with lock:
                if state["done"]:
                    return
                if future.exception() is not None:
                    state["done"], action = True, "fail"
                else:
                    state["remaining"] -= 1
                    if state["remaining"] == 0:
                        state["done"], action = True, "finish"
            if action == "fail":
                agg.set_exception(future.exception())
            elif action == "finish":
                try:
                    agg.set_result(finish())
                except BaseException as e:  # noqa: BLE001 — to the caller
                    agg.set_exception(e)

        for fut in futures:
            fut.add_done_callback(on_done)
        return agg

    def _submit_tiled(self, left: np.ndarray, right: np.ndarray,
                      deadline_ms: Optional[float], tier: Optional[str],
                      requested_tier: Optional[str], t_admit: float,
                      model: Optional[str] = None,
                      trace_context=None) -> Future:
        """Answer one beyond-threshold pair as N halo row tiles through
        the ORDINARY bucket path (serving/tiles.py): every tile is an
        equal-height ``_enqueue`` at the same bucket, tier and family, so
        the continuous batcher coalesces them into batch-N dispatches.
        The returned Future resolves once every tile did, with the
        stitched disparity and the measured seam error; a tile failing
        fails the whole request with that tile's typed error.  An
        ``Overloaded`` mid-tiling propagates to the caller; tiles
        admitted before it still run and are discarded."""
        from raft_stereo_tpu_torch.serving import tiles as tiles_mod

        specs = tiles_mod.plan_tiles(left.shape[0],
                                     self.serve_cfg.tile_rows,
                                     self.serve_cfg.tile_halo)
        if len(specs) < 2:
            # shorter than one tile extent: nothing to split
            return self._enqueue(left, right, deadline_ms, tier,
                                 requested_tier, t_admit, model=model,
                                 trace_context=trace_context).future
        reqs = [self._enqueue(
                    np.ascontiguousarray(left[s.src0:s.src1]),
                    np.ascontiguousarray(right[s.src0:s.src1]),
                    deadline_ms, tier, requested_tier, t_admit,
                    model=model, trace_context=trace_context)
                for s in specs]
        return self._when_all(
            [r.future for r in reqs],
            lambda: self._finish_tiled([r.future.result() for r in reqs],
                                       specs, t_admit, tier=tier,
                                       requested_tier=requested_tier))

    def _finish_tiled(self, results: List[ServeResult], specs,
                      t_admit: float, **provenance) -> ServeResult:
        """All tiles answered: stitch the disparity and the confidence,
        measure the seam.  Latency legs report the worst tile (the tiles
        ran concurrently); ``total_s`` is admission -> stitched.
        ``provenance`` sets the tier fields (and a cascade's)."""
        from raft_stereo_tpu_torch.serving import tiles as tiles_mod

        flows = [res.flow for res in results]
        flow = tiles_mod.stitch(flows, specs)
        seam = tiles_mod.seam_epe(flows, specs)
        self.metrics.tiled_requests.inc()
        if seam is not None:
            self.metrics.tile_seam_epe.observe(seam)
        iters = [res.iters_used for res in results
                 if res.iters_used is not None]
        conf_map, conf_mean = None, None
        if all(res.confidence is not None for res in results):
            conf_map = np.ascontiguousarray(tiles_mod.stitch(
                [res.confidence for res in results], specs))
            conf_mean = float(conf_map.mean())
        return ServeResult(
            flow=np.ascontiguousarray(flow),
            queue_wait_s=max(res.queue_wait_s for res in results),
            device_s=max(res.device_s for res in results),
            fetch_s=max(res.fetch_s for res in results),
            total_s=time.perf_counter() - t_admit,
            batch_size=max(res.batch_size for res in results),
            iters_used=max(iters) if iters else None,
            attempts=max(res.attempts for res in results),
            tiles=len(results), seam_epe=seam,
            model=results[0].model,
            model_version=results[0].model_version,
            confidence=conf_map, confidence_mean=conf_mean,
            trace_id=results[0].trace_id, **provenance)

    # ------------------------------------------- confidence-gated cascade
    def _submit_cascade(self, left: np.ndarray, right: np.ndarray,
                        deadline_ms: Optional[float], degradable: bool,
                        t_admit: float, model: Optional[str] = None,
                        trace_context=None) -> Future:
        """The ``auto`` pseudo-tier: answer on the cheap draft tier first
        and escalate to the dearest tier ONLY when the draft's own
        confidence says the answer is doubtful.  Beyond the tiling
        threshold the gate is per tile: only the doubtful rows of a large
        frame run again.  The draft runs at the ADMITTED draft tier
        (brownout may degrade it further); escalation re-admits at
        escalation time."""
        tt = self.serve_cfg.tile_threshold_pixels
        bucket = self.policy.bucket_for(left.shape[0], left.shape[1])[:2]
        if tt is not None and bucket[0] * bucket[1] > tt:
            from raft_stereo_tpu_torch.serving import tiles as tiles_mod

            specs = tiles_mod.plan_tiles(left.shape[0],
                                         self.serve_cfg.tile_rows,
                                         self.serve_cfg.tile_halo)
            if len(specs) >= 2:
                futs = [self._cascade_one(
                            np.ascontiguousarray(left[s.src0:s.src1]),
                            np.ascontiguousarray(right[s.src0:s.src1]),
                            deadline_ms, degradable, t_admit, model,
                            trace_context=trace_context)
                        for s in specs]
                return self._when_all(
                    futs, lambda: self._finish_cascade_tiled(
                        [f.result() for f in futs], specs, t_admit))
        return self._cascade_one(left, right, deadline_ms, degradable,
                                 t_admit, model,
                                 trace_context=trace_context)

    def _cascade_one(self, left: np.ndarray, right: np.ndarray,
                     deadline_ms: Optional[float], degradable: bool,
                     t_admit: float, model: Optional[str] = None,
                     trace_context=None) -> Future:
        """One draft -> (maybe) escalate chain for a single pair; the
        returned Future resolves with whichever answer survived, with its
        provenance (``draft_tier``, ``draft_confidence``,
        ``escalated``)."""
        threshold = self.serve_cfg.cascade_threshold
        agg: Future = Future()
        draft_tier, draft_requested = self._admit_tier(self._cascade_draft,
                                                       degradable)
        dreq = self._enqueue(left, right, deadline_ms, draft_tier,
                             draft_requested, t_admit, model=model,
                             trace_context=trace_context)

        def on_draft(future):
            exc = future.exception()
            if exc is not None:
                agg.set_exception(exc)
                return
            res = future.result()
            conf = res.confidence_mean
            if conf is None or conf >= threshold:
                # confident (or no confidence: fail open to the draft
                # rather than double every request's cost)
                res.draft_tier = draft_tier
                res.draft_confidence = conf
                res.total_s = time.perf_counter() - t_admit
                self._cascade_drafts.inc()
                agg.set_result(res)
                return
            self._cascade_escalations.inc()
            try:
                esc_tier, esc_requested = self._admit_tier(
                    self._cascade_escalate, degradable)
                ereq = self._enqueue(left, right, deadline_ms, esc_tier,
                                     esc_requested, t_admit, model=model,
                                     trace_context=trace_context)
            except BaseException as e:  # noqa: BLE001 — typed to caller
                agg.set_exception(e)
                return

            def on_escalated(f2):
                exc2 = f2.exception()
                if exc2 is not None:
                    agg.set_exception(exc2)
                    return
                res2 = f2.result()
                res2.escalated = True
                res2.draft_tier = draft_tier
                res2.draft_confidence = conf
                res2.total_s = time.perf_counter() - t_admit
                agg.set_result(res2)

            ereq.future.add_done_callback(on_escalated)

        dreq.future.add_done_callback(on_draft)
        return agg

    def _finish_cascade_tiled(self, results: List[ServeResult], specs,
                              t_admit: float) -> ServeResult:
        """All per-tile cascades answered: stitched as ``_finish_tiled``,
        reporting the ESCALATED tier when any tile escalated (the cost
        actually paid) and the worst tile's draft confidence (the gate
        that mattered)."""
        final = next((res for res in results if res.escalated),
                     results[0])
        draft_confs = [res.draft_confidence for res in results
                       if res.draft_confidence is not None]
        return self._finish_tiled(
            results, specs, t_admit, tier=final.tier,
            requested_tier=final.requested_tier,
            escalated=any(res.escalated for res in results),
            draft_tier=results[0].draft_tier,
            draft_confidence=min(draft_confs) if draft_confs else None)

    # ------------------------------------------------------------- sessions
    def submit_session(self, session_id: str, left: np.ndarray,
                       right: np.ndarray,
                       deadline_ms: Optional[float] = None,
                       tier: Optional[str] = None,
                       degradable: bool = True,
                       handoff_key: Optional[str] = None,
                       model: Optional[str] = None,
                       trace_context=None) -> Future:
        """Admit one frame of a streaming session (the engine behind
        ``POST /v1/stream/<session>``); returns a Future of
        ``ServeResult`` whose session fields say what happened.

        The first frame of a new id creates the session and starts cold;
        a later frame starts warm when the session holds state from a
        frame of the same bucket and raw shape (and, with
        ``session_hidden``, its hidden tree), unless the scene-cut gate
        fires: the mean |delta| of the frames' thumbnails above
        ``scene_cut_threshold`` falls back cold.  With
        ``session_ctx_cache`` a cold frame saves the context bundle and a
        warm frame whose delta is at most ``ctx_cache_threshold`` takes
        it.  Raises the typed ``SessionExpired`` (HTTP 410) on an expired,
        evicted or closed id and ``SessionsDisabled`` without a store.

        **Ordering:** the session's ordering lock is held from here until
        the frame's future resolves, so a session never has two frames in
        flight; the call blocks while the previous frame of the same
        session is pending (distinct sessions batch together freely).
        Every admitted frame's future resolves, with a result or a typed
        error, so the lock is never held forever.

        ``handoff_key`` names another replica's published handoff blob
        (``X-Handoff-Artifact``): a new session adopts its state from it
        (``_adopt_handoff``) and may start warm; any failure leaves it
        cold, the baseline without a handoff.

        **Model pinning:** a session pins the model its first frame
        resolved (the explicit ``model`` or the then-current default);
        later frames run that model even if the default moves.  A later
        frame naming another model raises ``ValueError`` (HTTP 400); a
        frame whose pinned model was retired raises ``ModelUnknown``
        (404)."""
        if self.sessions is None:
            raise SessionsDisabled(
                "this engine runs without a session store — construct it "
                "with ServeConfig(sessions=True) to stream")
        t_admit = time.perf_counter()
        tier, requested_tier = self._admit_tier(tier, degradable)
        left, right = np.asarray(left), np.asarray(right)
        if left.ndim != 3 or left.shape != right.shape:
            raise ValueError(
                f"need two same-shape (H, W, 3) images, got {left.shape} "
                f"vs {right.shape}")
        sess, created = self.sessions.get_or_create(session_id)
        # One frame per session in the pipeline: block until the previous
        # frame's future resolved (its done-callback releases the lock).
        sess.order_lock.acquire()
        try:
            if created and handoff_key is not None:
                # Lazy handoff adoption: import THIS session's state from
                # the draining replica's blob, so the frame may start
                # warm where the old replica left off; any failure leaves
                # ``created`` true (a cold start).
                created = not self._adopt_handoff(sess, session_id,
                                                  handoff_key)
            if created:
                # pin the model at session birth: the explicit name or
                # the current default
                sess.model = self.resolve_model(model)
            else:
                pinned = sess.model
                if model is not None and model != pinned:
                    raise ValueError(
                        f"session {session_id!r} is pinned to model "
                        f"{pinned or '(implicit)'} — a mid-stream "
                        f"switch to {model!r} would mix versions; open "
                        f"a new session")
                if pinned is not None:
                    # retired mid-stream -> typed 404 on the next frame
                    self.resolve_model(pinned)
            thumb = frame_thumbnail(left)
            hp, wp, _grid = self.policy.bucket_for(left.shape[0],
                                                   left.shape[1])
            hidden_on = self.serve_cfg.session_hidden
            warm = (not created and sess.flow_low is not None
                    and sess.bucket == (hp, wp)
                    and sess.raw_shape == tuple(left.shape[:2])
                    # warm-h programs take both state halves: a session
                    # without its hidden tree (crash demotion) starts cold
                    and (not hidden_on or sess.hidden is not None))
            scene_cut = False
            delta = None
            if warm:
                delta = frame_delta(thumb, sess.thumb)
                if delta is not None:
                    self.metrics.frame_delta.observe(delta)
                    if (self.serve_cfg.scene_cut_threshold > 0
                            and delta > self.serve_cfg.scene_cut_threshold):
                        # the previous flow belongs to another scene: a
                        # warm start would anchor the GRU to garbage; the
                        # state re-seeds from this cold frame
                        warm, scene_cut = False, True
                        sess.scene_cuts += 1
                        self.metrics.scene_cuts.inc()
            # The ctx cache: cold frames save the bundle, a warm frame
            # whose delta proves the scene static takes it, a warm frame
            # past the gate runs plain warm and drops the bundle at
            # completion (it re-establishes at the next cold frame).
            ctx_on = self.serve_cfg.session_ctx_cache
            ctx_init = None
            if warm:
                family = FAMILY_WARM_H if hidden_on else FAMILY_WARM
                if (ctx_on and sess.ctx is not None and delta is not None
                        and delta <= self.serve_cfg.ctx_cache_threshold):
                    family = (FAMILY_WARM_CTX_H if hidden_on
                              else FAMILY_WARM_CTX)
                    ctx_init = sess.ctx
            elif ctx_on:
                family = (FAMILY_STATE_CTX_H if hidden_on
                          else FAMILY_STATE_CTX)
            else:
                family = FAMILY_STATE_H if hidden_on else FAMILY_STATE
            req = self._enqueue(
                left, right, deadline_ms, tier, requested_tier, t_admit,
                family=family, session=sess, session_id=session_id,
                flow_init=sess.flow_low if warm else None,
                hidden_init=(sess.hidden if warm and hidden_on
                             else None),
                ctx_init=ctx_init, thumb=thumb,
                frame_index=sess.frame_index, scene_cut=scene_cut,
                frame_delta_v=delta, model=sess.model,
                trace_context=trace_context)
        except BaseException:
            sess.order_lock.release()
            raise
        req.future.add_done_callback(
            lambda f, r=req: self._finish_session_frame(r, f))
        return req.future

    def infer_session(self, session_id: str, left: np.ndarray,
                      right: np.ndarray,
                      deadline_ms: Optional[float] = None,
                      timeout: Optional[float] = None,
                      tier: Optional[str] = None,
                      degradable: bool = True,
                      handoff_key: Optional[str] = None,
                      model: Optional[str] = None,
                      trace_context=None) -> ServeResult:
        """Blocking convenience: submit_session + wait."""
        return self.submit_session(
            session_id, left, right, deadline_ms, tier=tier,
            degradable=degradable, handoff_key=handoff_key, model=model,
            trace_context=trace_context).result(timeout=timeout)

    # ------------------------------------------------------------- handoff
    def exec_config_fingerprint(self) -> str:
        """SHA-256 identity of the programs a handed-off session would
        re-enter here: the effective model config (array geometry and
        dtypes of every state tree), the serving knobs that pick the
        session families, the GRU depth cap and the fetch dtype (and the
        default model's coordinate when a registered model holds the
        pointer).  Byte-equal to the JAX engine's for the same
        configuration, so blobs cross packages; an importer whose
        fingerprint differs refuses the blob typed (``config_mismatch``):
        any drift costs one cold start per stream."""
        payload = {
            "model": self.effective_config.to_json(),
            "session_hidden": self.serve_cfg.session_hidden,
            "session_ctx_cache": self.serve_cfg.session_ctx_cache,
            "iters": self.serve_cfg.iters,
            "fetch_dtype": self.serve_cfg.fetch_dtype,
        }
        if self.default_model is not None:
            payload["default_model"] = self._models[
                self.default_model].coord
        return hashlib.sha256(
            json.dumps(payload, sort_keys=True).encode()).hexdigest()

    def _handoff_records(self, key: str) -> Dict:
        """Parsed ``{sid: (meta, arrays)}`` of one published handoff
        blob, fetched and decoded at most once per key.  A blob stamped
        with another exec-config fingerprint is refused wholesale: every
        session it carries counts into
        ``serve_handoff_import_skipped_total{reason="config_mismatch"}``
        and starts cold."""
        with self._handoff_lock:
            cached = self._handoff_blobs.get(key)
        if cached is not None:
            return cached
        records: Dict = {}
        if self.handoff_store is not None:
            blob = self.handoff_store.fetch(key)
            if blob is not None:
                stamped = handoff_fingerprint(blob)
                mine = self.exec_config_fingerprint()
                if stamped is not None and stamped != mine:
                    n = len(handoff_session_ids(blob))
                    self.metrics.observe_handoff_skip("config_mismatch",
                                                      n)
                    log.warning(
                        "handoff artifact %s was exported under exec-"
                        "config %.12s but this engine runs %.12s; "
                        "refusing %d session(s) — they cold-start "
                        "(config_mismatch)", key[:12], stamped, mine, n)
                else:
                    records, skipped = parse_handoff_blob(blob)
                    if skipped:
                        self.metrics.observe_handoff_skip("corrupt",
                                                          skipped)
            else:
                log.warning("handoff artifact %s not in the store; its "
                            "sessions cold-start", key)
        with self._handoff_lock:
            self._handoff_blobs[key] = records
            # a replica inherits from a handful of drains at a time
            while len(self._handoff_blobs) > 8:
                self._handoff_blobs.pop(next(iter(self._handoff_blobs)))
        return records

    def _adopt_handoff(self, sess, sid: str, key: str) -> bool:
        """Install the handed-off state for ``sid`` from blob ``key`` into
        the freshly created session, in the port's layout (``_from_wire``);
        True when adopted (the frame may start warm).  A session pinned to
        a model this engine does not serve is refused typed
        (``model_unknown``): it starts cold on this engine's default."""
        rec = self._handoff_records(key).get(sid)
        if rec is None:
            return False
        meta, arrays = rec
        pinned = meta.get("model") if isinstance(meta, dict) else None
        if pinned is not None:
            bundle = self._models.get(pinned)
            if bundle is None or bundle.retiring:
                self.metrics.observe_handoff_skip("model_unknown", 1)
                log.warning(
                    "session %s was pinned to model %r which this "
                    "engine does not serve — refusing its handed-off "
                    "state (cold start)", sid, pinned)
                return False
        self.sessions.adopt(sess, meta, _from_wire(arrays))
        sess.model = pinned
        self.metrics.sessions_adopted.inc()
        log.info("session %s adopted from handoff %s at frame %s",
                 sid, key[:12], sess.frame_index)
        return True

    def publish_handoff(self) -> Optional[Dict[str, object]]:
        """Serialize every live session (the JAX package's blob layout,
        ``_to_wire``) into the artifact store's ``sessions/`` namespace
        and remember the manifest ``GET /admin/handoff`` serves
        (cli/serve.py calls this at SIGTERM, after ``begin_shutdown``).
        Returns the manifest, with ``artifact=None`` when there was
        nothing to export; None only when this engine cannot hand off
        (no session store, or no shared artifact directory)."""
        if self.sessions is None or self.handoff_store is None:
            return None
        fingerprint = self.exec_config_fingerprint()
        blob = self.sessions.export(config_fingerprint=fingerprint,
                                    record_fn=_to_wire)
        sids = handoff_session_ids(blob)
        key = None
        if sids:
            key = self.handoff_store.publish(blob)
            if key is None:
                log.warning("session handoff publish failed; %d "
                            "session(s) will fail typed on exit instead",
                            len(sids))
                sids = []
            else:
                self.metrics.sessions_exported.inc(len(sids))
        manifest = {"artifact": key, "sessions": sids,
                    "count": len(sids), "published_unix": time.time(),
                    "config_fingerprint": fingerprint}
        self._handoff_manifest = manifest
        log.info("session handoff published: %d session(s) -> %s",
                 len(sids), key and key[:12])
        return manifest

    @property
    def handoff_manifest(self) -> Optional[Dict[str, object]]:
        """The drain handoff manifest (None until ``publish_handoff``
        ran): what ``GET /admin/handoff`` serves."""
        return self._handoff_manifest

    def note_handoff_fetched(self) -> None:
        """The HTTP layer records that a router fetched the manifest:
        the CLI's post-drain linger can stop waiting."""
        self._handoff_fetched.set()

    def wait_handoff_fetched(self, timeout: float) -> bool:
        return self._handoff_fetched.wait(timeout)

    def close_session(self, session_id: str) -> Dict[str, object]:
        """End one session (``DELETE /v1/stream/<id>``); returns its
        lifetime stats.  Raises ``SessionsDisabled`` / ``SessionExpired``
        / ``KeyError`` like the store."""
        if self.sessions is None:
            raise SessionsDisabled("this engine runs without a session "
                                   "store")
        return self.sessions.close(session_id)

    def _finish_session_frame(self, req: Request, future) -> None:
        """Completion hook of one session frame: fold the result's state
        back into the session (the ordering lock is still held, so the
        next frame, possibly blocked in ``submit_session``, reads a
        consistent state), then release the lock.  A failed frame leaves
        the state as it was (a crashed dispatch already dropped it)."""
        sess = req.payload.session
        try:
            if future.exception() is None:
                res = future.result()
                flow_low = res.flow_low
                reseed = False
                if (self.serve_cfg.session_reseed_on_cap and res.warm
                        and res.iters_used is not None
                        and res.iters_used >= self.serve_cfg.iters
                        and early_exit_enabled(
                            self._models[req.model].tier_configs[
                                self._cache_tier(req.tier, req.model)])):
                    # Keyframe guard: the exit gate never fired, so this
                    # warm output is no trusted init; the next frame
                    # starts cold.
                    flow_low = None
                    reseed = True
                    self.metrics.session_reseeds.inc()
                if self.serve_cfg.session_ctx_cache:
                    if res.ctx is not None:
                        sess.ctx = res.ctx
                        self._hold_ctx(sess)
                    elif reseed or (res.warm and not res.ctx_cached):
                        # the keyframe guard fired, or the scene moved
                        # past the static gate: the bundle is stale
                        sess.ctx = None
                    if res.ctx_cached:
                        sess.ctx_hits += 1
                        self.metrics.ctx_cache_hits.inc()
                sess.note_result(
                    flow_low=flow_low, thumb=req.payload.thumb,
                    bucket=req.bucket, raw_shape=req.payload.raw_shape,
                    warm=res.warm, iters_used=res.iters_used,
                    hidden=res.hidden, confidence=res.confidence_mean)
                self.metrics.observe_session_frame(
                    "warm" if res.warm else "cold")
        finally:
            # the dispatch counts as activity: a first-frame capture
            # longer than the TTL must not expire the stream
            self.sessions.touch(req.session_id)
            sess.order_lock.release()

    # ------------------------------------------------------------ readiness
    @property
    def ready(self) -> bool:
        """The /readyz gate: every configured (worker, bucket, batch,
        tier, family) warm entry has dispatched at least once; False once
        a graceful shutdown begins, or while chaos holds a slow start."""
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
        out: Dict[str, object] = {
            "ready": ready and self.ready, "warm_done": done,
            "warm_target": total, "draining": self._shutting_down,
            "compiles_cold": self.metrics.compiles_cold.value,
            "compiles_warm": self.metrics.compiles_warm.value}
        if self.disk_cache is not None:
            out["executable_cache"] = self.disk_cache.stats()
        # the registry joins only when named models exist
        if len(self._models) > 1 or self.default_model is not None:
            out["models"] = self.models_status()
        return out

    def _note_warm(self, widx: int, bucket: Tuple[int, int], batch: int,
                   cache_tier: Optional[str],
                   family: Optional[str] = FAMILY_BASE,
                   model: Optional[str] = None) -> None:
        with self._warm_lock:
            self._warmed.add((widx, tuple(bucket), batch, cache_tier,
                              family, model))

    def _families(self) -> Tuple[Optional[str], ...]:
        """The program families this engine serves: the base program
        always; the session families only with a session store (a
        stateless engine's programs, prewarm and readiness are the base
        family's alone); the ctx-cache families replace state/warm when
        the context cache is on (a cold frame must save the bundle), and
        with ``session_hidden`` every session family is its ``_h``
        variant (one frame without the hidden tree would break the
        chain)."""
        if self.sessions is None:
            return (FAMILY_BASE,)
        hidden = self.serve_cfg.session_hidden
        if self.serve_cfg.session_ctx_cache:
            if hidden:
                return (FAMILY_BASE, FAMILY_STATE_CTX_H, FAMILY_WARM_H,
                        FAMILY_WARM_CTX_H)
            return (FAMILY_BASE, FAMILY_STATE_CTX, FAMILY_WARM,
                    FAMILY_WARM_CTX)
        if hidden:
            return (FAMILY_BASE, FAMILY_STATE_H, FAMILY_WARM_H)
        return (FAMILY_BASE, FAMILY_STATE, FAMILY_WARM)

    def _state_zeros(self, cfg: RaftStereoConfig, bucket: Tuple[int, int],
                     batch: int):
        """Zero host trees of one bucket's state inputs, as the session
        families take them: ``(flow_init, hidden, ctx)``, fp32 NCHW per
        level (the per-level GRU hidden states; the context bundle is
        those initial states and the (cz, cr, cq) biases)."""
        f = cfg.downsample_factor
        flow = np.zeros((batch, bucket[0] // f, bucket[1] // f), np.float32)
        levels = [(batch, cfg.hidden_dims[l], bucket[0] // (f * 2 ** l),
                   bucket[1] // (f * 2 ** l))
                  for l in range(cfg.n_gru_layers)]
        hidden = tuple(np.zeros(sh, np.float32) for sh in levels)
        ctx = (tuple(np.zeros(sh, np.float32) for sh in levels),
               tuple(tuple(np.zeros(sh, np.float32) for _ in range(3))
                     for sh in levels))
        return flow, hidden, ctx

    # --------------------------------------------------------- program cache
    def _cache_tier(self, tier: Optional[str],
                    model: Optional[str] = None) -> Optional[str]:
        """The cache key a tier's programs live under: None where the
        tier's config is the model's base one (fixed-depth tiers share
        the base programs)."""
        bundle = self._models[model]
        if tier is None or (bundle.tier_configs[tier]
                            == bundle.effective_config):
            return None
        return tier

    def _distinct_cache_tiers(self, model: Optional[str] = None
                              ) -> List[Optional[str]]:
        """The distinct programs the configured tiers run ("quality" and
        the base path are one), per model."""
        tiers = tuple(self.tiers) if self.tiers else (None,)
        return sorted({self._cache_tier(t, model) for t in tiers},
                      key=lambda t: (t is not None, t or ""))

    def tier_model(self, tier: Optional[str], worker: int = 0,
                   model: Optional[str] = None) -> RAFTStereo:
        """The model a tier's requests run on ``worker``'s device."""
        return self._models[model].tier_models[self.devices[worker]][
            self._cache_tier(tier, model)]

    def _cost_key(self, bucket: Tuple[int, int], batch: int,
                  tier: Optional[str] = None,
                  family: Optional[str] = FAMILY_BASE,
                  model: Optional[str] = None) -> str:
        """The JAX engine's label of one program in the cost registry; a
        registered model's coordinate joins last.  An xl program's label
        carries its mesh (``,mesh=rows2``) in place of tier and family."""
        if family == FAMILY_XL:
            label = self.xl.label if self.xl is not None else "none"
            return (f"serving.forward({bucket[0]}x{bucket[1]},b{batch}"
                    f",mesh={label})")
        bundle = self._models[model]
        cache_tier = self._cache_tier(tier, model)
        tail = "" if cache_tier is None else f",tier={tier}"
        qmode = bundle.tier_configs[cache_tier].quant
        if qmode != "off":
            tail += f",quant={qmode}"
        if self.serve_cfg.confidence:
            tail += ",conf"
        if family is not None:
            tail += f",{family}"
        if bundle.name is not None:
            tail += f",model={bundle.coord}"
        return f"serving.forward({bucket[0]}x{bucket[1]},b{batch}{tail})"

    def compiled_cost(self, bucket: Tuple[int, int], batch: int = 1,
                      tier: Optional[str] = None,
                      family: Optional[str] = FAMILY_BASE,
                      model: Optional[str] = None):
        """The cost record of a built (bucket, batch, tier, family,
        model) program, or None (no registry / not built yet)."""
        if self.costs is None:
            return None
        return self.costs.get(self._cost_key(bucket, batch, tier, family,
                                             model))

    def cached_programs(self, worker: Optional[int] = None,
                        model: Optional[str] = None) -> List[Tuple]:
        """``(worker, bucket, batch, cache_tier, family)`` of one model's
        cached programs (None: the implicit model's), oldest first."""
        with self._cache_lock:
            return [k[:5] for i, cache in enumerate(
                        self._models[model].compiled)
                    if worker is None or i == worker for k in cache]

    def program(self, bucket: Tuple[int, int], batch: int = 1,
                tier: Optional[str] = None, worker: int = 0,
                family: Optional[str] = FAMILY_BASE,
                model: Optional[str] = None):
        """The cached program of one (bucket, batch, tier, family, model)
        on ``worker`` (a ``GraphForward``, ``WhileForward`` or
        ``PlainForward``), or None."""
        with self._cache_lock:
            return self._models[model].compiled[worker].get(
                (worker, tuple(bucket), batch,
                 self._cache_tier(tier, model), family, model))

    def _cached(self, key: Tuple):
        with self._cache_lock:
            return ProgramCache.get(self._models[key[5]].compiled[key[0]],
                                    key)

    def _build(self, key: Tuple, arrays, spec):
        """Build the program of ``key`` (worker, bucket, batch,
        cache_tier, family, model) for inputs of ``arrays``' shapes, in
        the model's own ProgramCache, evicting the worker's oldest past
        ``max_cached_shapes``."""
        widx, bucket, batch, cache_tier, family, mname = key
        bundle = self._models[mname]
        model = bundle.tier_models[self.devices[widx]][cache_tier]
        forward = make_forward(
            model, self.serve_cfg.iters,
            FETCH_DTYPES[self.serve_cfg.fetch_dtype],
            warm_start=family in _WARM_FAMILIES,
            return_state=family is not FAMILY_BASE,
            ctx=("save" if family in _CTX_SAVE_FAMILIES
                 else "reuse" if family in _CTX_REUSE_FAMILIES else None),
            hidden_init=family in _H_IN_FAMILIES,
            return_hidden=family in _H_OUT_FAMILIES,
            return_confidence=self.serve_cfg.confidence)
        self.metrics.compiles_cold.inc()
        with self._cache_lock:
            entry = bundle.programs[widx].add(
                bundle.compiled[widx], key, forward, arrays, spec,
                early_exit_enabled(model.config))
            if family in _CTX_SAVE_FAMILIES and isinstance(entry, _Graphed):
                # the bundle's (net, (cz, cr, cq)) per level stays on the
                # card: its host round trip costs more than the context
                # encoder it saves (PERF.md)
                entry.keep_last = 4 * model.config.n_gru_layers
            if self.costs is not None:
                self.costs.note_runner_cache_size(
                    sum(len(c) for b in self._models.values()
                        for c in b.compiled))
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
        widx, bucket, batch, cache_tier, family, mname = key
        bundle = self._models[mname]
        cfg = bundle.tier_configs[cache_tier]
        model = bundle.tier_models[self.devices[widx]][cache_tier]
        iters = (model.exit_bounds(self.serve_cfg.iters)[0]
                 if early_exit_enabled(cfg) else self.serve_cfg.iters)
        return self.costs.measure(
            call, *arrays,
            key=self._cost_key(bucket, batch, cache_tier, family, mname),
            site="serving",
            flops=forward_flops(cfg, bucket, batch, iters,
                                context=family not in _CTX_REUSE_FAMILIES),
            device=self.devices[widx])

    def _count(self, captures: int = 0, replays: int = 0) -> None:
        with self._cache_lock:
            self.captures += captures
            self.replays += replays

    def _dispatch(self, widx: int, key: Tuple, p1: np.ndarray,
                  p2: np.ndarray, *extra) -> Tuple[List[np.ndarray], float]:
        """One dispatch of the program of ``key`` on ``worker``'s thread:
        ``(outputs, t_ready)``.  ``extra`` are the family's state inputs
        after the images (``[flow_init][, hidden][, ctx]``: arrays, or
        ``_Members`` stacked here); a graph copies them into its static
        inputs with the images.  A miss builds and captures under the
        exclusive gate; a replay uploads, replays and synchronizes under
        the shared one (``t_ready``), then fetches the outputs (a ctx-saving
        program's bundle stays on the card)."""
        def flat():
            return tree_flatten((p1, p2) + tuple(
                x.stack(self.devices[widx]) if isinstance(x, _Members)
                else x for x in extra))

        entry = self._cached(key)
        cuda = self.devices[widx].type == "cuda"
        if entry is None or (cuda and entry.outputs is None):
            gate = self._gate.exclusive() if cuda else contextlib.nullcontext()
            with gate:
                arrays, spec = flat()
                if entry is None:
                    entry = self._build(key, arrays, spec)
                if cuda:
                    self._count(captures=1, replays=1)
                out = self._first_call(entry, key, arrays)
            return out, time.monotonic()
        if not cuda:
            out = entry(*flat()[0])
            return out, time.monotonic()
        with self._gate.shared():
            self._count(replays=1)
            return entry.timed_call(*flat()[0])

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
                tiers: Optional[Sequence[Optional[str]]] = None,
                models: Optional[Sequence[Optional[str]]] = None) -> None:
        """Build and warm the whole bucket ladder for one raw shape on
        every worker: each batch size of each distinct tier program and
        each family runs once, zero images and zero states (``flow_init``
        a constant -1 px, not zero, so the warm-up before a warm
        program's capture runs a warm start), on the worker's own thread
        (on the card: the capture), so the first real requests at this
        shape replay.  Fixed-depth tiers share the base programs, so the
        ladder is built once per distinct program, for each model of
        ``models`` (None: every served model, the implicit one first)."""
        h, w = int(raw_hw[0]), int(raw_hw[1])
        hp, wp, _ = self.policy.bucket_for(h, w)
        if self._xl_routes((hp, wp)):
            # this bucket's traffic runs on the xl groups: warm that
            # ladder alone (the implicit model's; named models never
            # route xl)
            if models is None or None in models:
                self._prewarm_xl((hp, wp), batch_sizes)
            return
        sizes = tuple(batch_sizes) if batch_sizes else self.queue.sizes
        names = (self._registered_names() if models is None
                 else list(models))
        ladders = []
        for mname in names:
            if tiers is None:
                cache_tiers = self._distinct_cache_tiers(mname)
            else:
                cache_tiers = sorted(
                    {self._cache_tier(t, mname) for t in tiers},
                    key=lambda t: (t is not None, t or ""))
            ladders += [(mname, t) for t in cache_tiers]
        families = self._families()

        def warm(widx):
            for mname, tier in ladders:
                cfg = self._models[mname].tier_configs[tier]
                for n in sizes:
                    flow, hidden, ctx = self._state_zeros(cfg, (hp, wp), n)
                    for family in families:
                        zeros = np.zeros((n, hp, wp, 3), np.uint8)
                        extra = []
                        if family in _WARM_FAMILIES:
                            extra.append(flow - 1.0)
                        if family in _H_IN_FAMILIES:
                            extra.append(hidden)
                        if family in _CTX_REUSE_FAMILIES:
                            extra.append(ctx)
                        self._dispatch(
                            widx, (widx, (hp, wp), n, tier, family, mname),
                            zeros, zeros.copy(), *extra)
                        self._note_warm(widx, (hp, wp), n, tier, family,
                                        mname)

        futures = [self._run_on_worker(widx, lambda i=widx: warm(i))
                   for widx in range(len(self.devices))]
        for f in futures:
            f.result()
        log.info("prewarmed bucket %dx%d batch sizes %s (%d model/tier "
                 "program(s) x %d program variant(s)) on %d worker(s)",
                 hp, wp, sizes, len(ladders), len(families),
                 len(self.devices))

    def _prewarm_xl(self, bucket: Tuple[int, int],
                    batch_sizes: Optional[Sequence[int]] = None) -> None:
        """Build and run the xl ladder of one bucket on every xl group's
        own worker thread: each batch size once, on zero images."""
        sizes = tuple(batch_sizes) if batch_sizes else self._xl_sizes

        def warm(widx):
            for n in sizes:
                zeros = np.zeros((n, bucket[0], bucket[1], 3), np.uint8)
                self._xl_dispatch(
                    widx, (widx, tuple(bucket), n, None, FAMILY_XL, None),
                    zeros, zeros.copy())
                self._note_warm(widx, bucket, n, None, FAMILY_XL)

        futures = [self._run_on_worker(widx, lambda i=widx: warm(i))
                   for widx in self._xl_worker_indices()]
        for f in futures:
            f.result()
        log.info("prewarmed XL bucket %dx%d batch sizes %s (mesh %s) on "
                 "%d device group(s)", bucket[0], bucket[1], sizes,
                 self.xl.label, len(self.xl.groups))

    # --------------------------------------------------------------- workers
    def _worker_loop(self, widx: int) -> None:
        """One device worker under supervision.  The circuit breaker gates
        the pop; a dispatch crash hands the batch to the recovery path and
        then restarts the worker thread.  Between pops the worker runs the
        tasks handed to it (prewarm)."""
        dev = self._worker_device(widx)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        breaker = self.breakers[widx]
        # xl groups take the xl family alone, solo workers everything else
        xl = self._is_xl_worker(widx)
        want = ((lambda key: key[2] == FAMILY_XL) if xl
                else (lambda key: key[2] != FAMILY_XL)
                if self.xl is not None else None)
        sizes = self._xl_sizes if xl else None
        while True:
            self._run_tasks(widx)
            delay = breaker.until_allowed()
            if delay > 0:
                if self._closed:
                    return
                time.sleep(min(delay, 0.05))
                continue
            batch = self.queue.pop(timeout=_TASK_POLL_S, want=want,
                                   sizes=sizes)
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
            if r.payload.session is not None:
                self._invalidate_crashed_session_frame(r)
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

    def _invalidate_crashed_session_frame(self, req: Request) -> None:
        """A crashed dispatch carried this session frame: the flow it was
        to produce never existed.  A requeued warm frame is demoted to the
        cold family (a crash caused by its state, a NaN init or a poisoned
        buffer, would otherwise burn every attempt), and the session's
        state is dropped, so no later frame chains across the gap.  Safe
        to mutate: this frame holds the session's ordering lock until its
        future resolves (retry success or typed poisoning)."""
        sess = req.payload.session
        if req.family in _WARM_FAMILIES:
            ctx_on = self.serve_cfg.session_ctx_cache
            if self.serve_cfg.session_hidden:
                req.family = (FAMILY_STATE_CTX_H if ctx_on
                              else FAMILY_STATE_H)
            else:
                req.family = FAMILY_STATE_CTX if ctx_on else FAMILY_STATE
            req.payload.flow_init = None
            req.payload.hidden_init = None
            req.payload.ctx_init = None
            log.warning("session %s frame %s: crashed warm dispatch "
                        "demoted to a cold start for its retry",
                        req.session_id, req.payload.frame_index)
        sess.flow_low = None
        sess.hidden = None
        sess.ctx = None

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
        sizes = (self._xl_sizes if self._is_xl_worker(widx)
                 else self.queue.sizes)
        for k in decompose_batch(len(batch), sizes):
            self._run_chunk(widx, batch[i:i + k])
            i += k

    def _hold_ctx(self, sess: StereoSession) -> None:
        """Note the bundle ``sess`` has just saved; past
        ``ctx_budget_bytes`` drop the bundles of the other sessions used
        least recently (each re-saves at its next cold frame: a dropped
        bundle costs speed, never a result)."""
        if self.ctx_budget_bytes is None:
            return
        with self._ctx_lock:
            self._ctx_held[id(sess)] = weakref.ref(sess)
            live = []
            for key, ref in list(self._ctx_held.items()):
                s = ref()
                bundle = None if s is None else s.ctx
                if bundle is None:
                    del self._ctx_held[key]
                else:
                    live.append((s.last_used_mono, key, s,
                                 _tree_bytes(bundle)))
            total = sum(e[3] for e in live)
            for _, key, s, nbytes in sorted(live, key=lambda e: e[0]):
                if total <= self.ctx_budget_bytes:
                    break
                if s is sess:
                    continue
                s.ctx = None
                del self._ctx_held[key]
                total -= nbytes
                self.ctx_bundles_dropped += 1
                log.info("context bundles past %d bytes: dropped "
                            "session %s's (it re-saves at its next cold "
                            "frame)", self.ctx_budget_bytes, s.session_id)

    def _run_chunk(self, widx: int, batch: List[Request]) -> None:
        t_pickup = time.monotonic()
        waits = [t_pickup - r.t_enqueue for r in batch]
        bucket = batch[0].bucket
        # the queue groups by (bucket, tier, family): every member of the
        # chunk shares all three
        tier = batch[0].tier
        family = batch[0].family
        mname = batch[0].model
        bundle = self._models[mname]
        xl = family == FAMILY_XL
        cache_tier = None if xl else self._cache_tier(tier, mname)
        n = len(batch)
        device_label = (self._xl_group(widx).label if xl
                        else str(self.devices[widx]))
        sampled = [r for r in batch if r.trace is not None]
        p_pickup = time.perf_counter() if sampled else 0.0
        for r in sampled:
            if r.queue_span is not None and r.queue_span.t_end is None:
                r.queue_span.set_attr("batch_size", n)
                self.tracer.finish(r.queue_span)
        if self.chaos is not None:
            self.chaos.on_compile(widx)
            self.chaos.on_dispatch(widx)
        cfg = (self.xl.config if xl
               else bundle.tier_configs[cache_tier])
        adaptive = early_exit_enabled(cfg)
        with profiling.annotate("serve.device"):
            # ONE batch-n dispatch of the (bucket, n, tier, family)
            # program; n == 1 is the solo runner's program, bit for bit.
            # Session frames of different streams stack their states
            # along the batch axis, leaf by leaf.
            p1 = np.stack([r.payload.left for r in batch])
            p2 = np.stack([r.payload.right for r in batch])
            extra = []
            if family in _WARM_FAMILIES:
                extra.append(np.stack([r.payload.flow_init for r in batch]
                                      ).astype(np.float32))
            if family in _H_IN_FAMILIES:
                extra.append(_Members(
                    [r.payload.hidden_init for r in batch]))
            if family in _CTX_REUSE_FAMILIES:
                extra.append(_Members([r.payload.ctx_init for r in batch]))
            key = (widx, tuple(bucket), n, cache_tier, family, mname)
            if xl:
                out, t_ready = self._xl_dispatch(widx, key, p1, p2)
                self.metrics.xl_dispatches.inc()
            else:
                out, t_ready = self._dispatch(widx, key, p1, p2, *extra)
        p_ready = time.perf_counter() if sampled else 0.0
        # The flat outputs: flow_up[, flow_low][, iters_used][, conf_low,
        # conf_up][, hidden per level][, ctx: nets, then (cz, cr, cq) per
        # level] (eval/runner.make_forward).
        flows_padded = out[0]                      # (n, Hp, Wp)
        pos = 1
        flow_low_padded = None
        if family is not FAMILY_BASE and not xl:
            flow_low_padded = out[1]               # (n, Hp/f, Wp/f)
            pos = 2
        iters_used = self.serve_cfg.iters
        if adaptive:
            iters_used = int(out[pos])
            pos += 1
        conf_padded = None
        if self.serve_cfg.confidence and not xl:
            conf_padded = out[pos + 1]
            pos += 2
        levels = cfg.n_gru_layers
        hidden_out = None
        if family in _H_OUT_FAMILIES:
            hidden_out = out[pos:pos + levels]
            pos += levels
        ctx_out = None
        if family in _CTX_SAVE_FAMILIES:
            ctx_out = ctx_bundle(out[pos:pos + 4 * levels], levels)
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
            rec = (self.costs.get(self._xl_cost_key(bucket, n)) if xl
                   else self.compiled_cost(bucket, batch=n, tier=tier,
                                           family=family, model=mname))
            if rec is not None and rec.flops:
                self.metrics.dispatched_flops.inc(rec.flops)
                self._mfu.note(rec.flops)
        self.metrics.note_batch_done()
        self._note_warm(widx, bucket, n, cache_tier, family, mname)
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
                    self.quality.observe(tier or "default", bundle.coord,
                                         conf_mean, exemplar=exemplar)
            # batch-axis-free copies the session can stack into any
            # later dispatch
            ctx_i = (None if ctx_out is None else tree_unflatten(
                [_row(x, i) for x in tree_flatten(ctx_out)[0]],
                tree_flatten(ctx_out)[1]))
            hidden_i = (None if hidden_out is None else
                        tuple(h[i].copy() for h in hidden_out))
            r.future.set_result(ServeResult(
                flow=np.ascontiguousarray(flow), queue_wait_s=wait,
                device_s=device_s, fetch_s=fetch_s, total_s=total,
                batch_size=n, iters_used=iters_used,
                tier=FAMILY_XL if xl else tier,
                mesh=self.xl.label if xl else None,
                requested_tier=r.requested_tier, attempts=r.attempts + 1,
                session_id=r.session_id,
                frame_index=r.payload.frame_index,
                warm=family in _WARM_FAMILIES,
                scene_cut=r.payload.scene_cut,
                frame_delta=r.payload.frame_delta,
                flow_low=(np.ascontiguousarray(flow_low_padded[i])
                          if flow_low_padded is not None else None),
                ctx_cached=family in _CTX_REUSE_FAMILIES, ctx=ctx_i,
                hidden=hidden_i, warm_hidden=family in _H_IN_FAMILIES,
                model=bundle.name, model_version=bundle.version,
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
        in-flight and backoff work keeps flowing.  The queue turns
        draining first, so that whoever reads ``ready`` False for the
        shutdown reads the queue's draining flag too (the fleet router's
        probe tells a planned drain from a lost replica by it)."""
        self.queue.stop_admitting()
        self._shutting_down = True

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
            for bundle in self._models.values():
                for cache in bundle.compiled:
                    cache.clear()
        if self.disk_cache is not None:
            from raft_stereo_tpu_torch.kernels import _build
            if _build._store is self.disk_cache:
                _build.set_artifact_store(None)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


# The engine IS the service, as in the JAX package.
StereoService = ServingEngine
