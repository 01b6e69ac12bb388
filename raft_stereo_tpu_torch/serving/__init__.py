"""Inference serving on the card: the batch-N serving engine over one CUDA
graph per (bucket, batch, tier, family, model) — continuous batching,
admission control and backpressure, waste-driven bucket selection, request
tiers (early exit, the int8 ``turbo`` tier, confidence, the
confidence-gated ``auto`` cascade), halo row tiles for pairs larger than
a bucket (serving/tiles.py), streaming stereo sessions with their handoff
across replicas (serving/sessions.py), the model store and registry
(serving/models.py), the shared artifact store (serving/persist.py),
supervised crash recovery (retries, per-device circuit breakers, brownout
degradation, chaos testing), span traces, metrics, and the HTTP front end
(serving/http.py).

The JAX package's ``serving/`` names, for the modules the port runs.  The
fleet above N replicas — router, replica clients, the HA ledger, rollout,
metrics federation and the autoscaler — is ``serving/fleet/``
(``raft-route-torch``).  The xl mesh (ROADMAP §D7) is not ported yet; the
xl fields of ``ServeConfig`` raise ``NotImplementedError``."""

from raft_stereo_tpu_torch.serving.batcher import (BucketQueue,
                                                   DeadlineExceeded,
                                                   Overloaded, Request,
                                                   RequestPoisoned,
                                                   decompose_batch,
                                                   pick_batch_size)
from raft_stereo_tpu_torch.serving.chaos import (ChaosConfig, ChaosInjector,
                                                 InjectedCompileFailure,
                                                 InjectedFault,
                                                 InjectedResourceExhausted,
                                                 InjectedWorkerCrash,
                                                 parse_chaos_spec)
from raft_stereo_tpu_torch.serving.engine import (FAMILY_BASE,
                                                  FAMILY_STATE,
                                                  FAMILY_STATE_CTX,
                                                  FAMILY_STATE_CTX_H,
                                                  FAMILY_STATE_H,
                                                  FAMILY_WARM,
                                                  FAMILY_WARM_CTX,
                                                  FAMILY_WARM_CTX_H,
                                                  FAMILY_WARM_H,
                                                  BucketPolicy,
                                                  ModelUnknown,
                                                  ServeConfig, ServeResult,
                                                  ServingEngine,
                                                  StereoService)
from raft_stereo_tpu_torch.serving.metrics import (MetricsRegistry,
                                                   ServingMetrics)
from raft_stereo_tpu_torch.serving.models import (ModelStore,
                                                  ModelStoreError,
                                                  ModelVersionExists,
                                                  RegisteredModel,
                                                  parse_model_spec)
from raft_stereo_tpu_torch.serving.persist import (ExecutableDiskCache,
                                                   SessionHandoffStore)
from raft_stereo_tpu_torch.serving.resilience import (CIRCUIT_CLOSED,
                                                      CIRCUIT_HALF_OPEN,
                                                      CIRCUIT_OPEN,
                                                      BrownoutController,
                                                      CircuitBreaker,
                                                      circuit_state_name,
                                                      cost_ladder)
from raft_stereo_tpu_torch.serving.sessions import (SessionExpired,
                                                    SessionsDisabled,
                                                    SessionStore,
                                                    StereoSession,
                                                    frame_delta,
                                                    frame_thumbnail)

__all__ = ["BucketQueue", "DeadlineExceeded", "Overloaded", "Request",
           "RequestPoisoned", "decompose_batch", "pick_batch_size",
           "ChaosConfig", "ChaosInjector", "InjectedCompileFailure",
           "InjectedFault", "InjectedResourceExhausted",
           "InjectedWorkerCrash", "parse_chaos_spec", "BucketPolicy",
           "MetricsRegistry", "ServingMetrics", "ServeConfig", "ServeResult",
           "ServingEngine", "StereoService", "ModelUnknown",
           "ModelStore", "ModelStoreError", "ModelVersionExists",
           "RegisteredModel", "parse_model_spec", "ExecutableDiskCache",
           "SessionHandoffStore",
           "CIRCUIT_CLOSED", "CIRCUIT_HALF_OPEN", "CIRCUIT_OPEN",
           "BrownoutController", "CircuitBreaker", "circuit_state_name",
           "cost_ladder", "FAMILY_BASE", "FAMILY_STATE",
           "FAMILY_STATE_CTX", "FAMILY_STATE_CTX_H", "FAMILY_STATE_H",
           "FAMILY_WARM", "FAMILY_WARM_CTX", "FAMILY_WARM_CTX_H",
           "FAMILY_WARM_H", "SessionExpired", "SessionsDisabled",
           "SessionStore", "StereoSession", "frame_delta",
           "frame_thumbnail"]
