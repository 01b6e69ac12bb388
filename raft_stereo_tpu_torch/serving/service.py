"""The JAX package's round-6 serving name: ``StereoService`` is an alias
of ``ServingEngine`` (serving/engine.py), re-exported here."""

from raft_stereo_tpu_torch.serving.engine import (  # noqa: F401 — re-exports
    ServeConfig, ServeResult, ServingEngine, StereoService)

__all__ = ["ServeConfig", "ServeResult", "ServingEngine", "StereoService"]
