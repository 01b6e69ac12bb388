"""Fleet-scale serving: replicated engines behind a session-sticky
router with failover, fleet-wide brownout, the shared executable
artifact store (serving/persist.py), and — round 18 — the operations
layer: session handoff on graceful drain, an HA router pair over a
fenced replicated ledger, and pressure-driven replica autoscaling.
See docs/architecture.md §Fleet.  The JAX package's ``serving/fleet/``,
with its imports pointed at the port's own modules: every module here is
host code (sockets, threads, a file ledger) and never touches the card, so
a router process holds no CUDA context.  Its replicas are
``raft-serve-torch`` processes (cli/serve.py).

* ``ring``       — consistent-hash ring (session id -> replica, ~1/N remap)
* ``replica``    — one fleet member: HTTP client + health state
* ``router``     — routing, failover, lost-session ledger, fleet brownout,
                   drain handoff, HA roles, xl-capability routing
* ``ledger``     — the HA pair's fenced lease + append-only ledger
* ``autoscaler`` — the pressure -> fleet-size control loop + launchers
* ``rollout``    — canary/shadow rollout policy (deterministic traffic
                   split onto a registered model version + hysteresis
                   auto-demotion; round 21 multi-model serving)
* ``federation`` — metrics federation: background replica scraper +
                   ``replica=``-labelled re-exposition (round 23
                   fleet observability)
* ``http``       — the router's HTTP front end (``raft-route-torch``)
"""

from raft_stereo_tpu_torch.serving.fleet.autoscaler import (AutoscaleConfig,
                                                      Autoscaler,
                                                      LocalProcessLauncher,
                                                      ReplicaLauncher,
                                                      serve_argv_template)
from raft_stereo_tpu_torch.serving.fleet.federation import (MetricsFederator,
                                                      inject_label,
                                                      relabel_exposition)
from raft_stereo_tpu_torch.serving.fleet.http import (RouterHTTPServer,
                                                make_router_handler,
                                                retry_after_jittered)
from raft_stereo_tpu_torch.serving.fleet.ledger import FleetLedger
from raft_stereo_tpu_torch.serving.fleet.replica import (Replica, ReplicaHealth,
                                                   ReplicaUnreachable)
from raft_stereo_tpu_torch.serving.fleet.ring import DEFAULT_VNODES, HashRing
from raft_stereo_tpu_torch.serving.fleet.rollout import (RolloutConfig,
                                                   RolloutPolicy)
from raft_stereo_tpu_torch.serving.fleet.router import (FleetRouter,
                                                  NoReplicasAvailable,
                                                  RouterConfig, SessionLost,
                                                  XlUnavailable)

__all__ = ["DEFAULT_VNODES", "HashRing", "Replica", "ReplicaHealth",
           "ReplicaUnreachable", "FleetRouter", "NoReplicasAvailable",
           "RouterConfig", "SessionLost", "XlUnavailable",
           "RouterHTTPServer", "make_router_handler",
           "retry_after_jittered", "FleetLedger", "Autoscaler",
           "AutoscaleConfig", "ReplicaLauncher", "LocalProcessLauncher",
           "serve_argv_template", "RolloutConfig", "RolloutPolicy",
           "MetricsFederator", "inject_label", "relabel_exposition"]
