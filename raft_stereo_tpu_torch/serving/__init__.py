"""Inference serving on the card: the batch-N serving engine over one CUDA
graph per (bucket, batch, tier) — continuous batching, admission control
and backpressure, waste-driven bucket selection, request tiers (early
exit, the int8 ``turbo`` tier, confidence), supervised crash recovery
(retries, per-device circuit breakers, brownout degradation, chaos
testing), span traces, metrics, and the HTTP front end (serving/http.py).

The JAX package's ``serving/`` names, for the modules the port runs.
Sessions, the cascade, tiles, the model store and the persistent
executable cache (ROADMAP §D6b), the fleet (§D6c) and the xl mesh (§D7)
are not ported yet; their ``ServeConfig`` fields raise
``NotImplementedError``."""

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
from raft_stereo_tpu_torch.serving.engine import (BucketPolicy,
                                                  ModelUnknown,
                                                  ServeConfig, ServeResult,
                                                  ServingEngine,
                                                  SessionsDisabled,
                                                  StereoService)
from raft_stereo_tpu_torch.serving.metrics import (MetricsRegistry,
                                                   ServingMetrics)
from raft_stereo_tpu_torch.serving.resilience import (CIRCUIT_CLOSED,
                                                      CIRCUIT_HALF_OPEN,
                                                      CIRCUIT_OPEN,
                                                      BrownoutController,
                                                      CircuitBreaker,
                                                      circuit_state_name,
                                                      cost_ladder)

__all__ = ["BucketQueue", "DeadlineExceeded", "Overloaded", "Request",
           "RequestPoisoned", "decompose_batch", "pick_batch_size",
           "ChaosConfig", "ChaosInjector", "InjectedCompileFailure",
           "InjectedFault", "InjectedResourceExhausted",
           "InjectedWorkerCrash", "parse_chaos_spec", "BucketPolicy",
           "MetricsRegistry", "ServingMetrics", "ServeConfig", "ServeResult",
           "ServingEngine", "StereoService", "ModelUnknown",
           "SessionsDisabled",
           "CIRCUIT_CLOSED", "CIRCUIT_HALF_OPEN", "CIRCUIT_OPEN",
           "BrownoutController", "CircuitBreaker", "circuit_state_name",
           "cost_ladder"]
