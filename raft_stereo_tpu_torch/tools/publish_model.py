"""Publish a checkpoint into the model store (the JAX package's
``tools/publish_model.py`` on the port).

The serving registry (serving/models.py) loads weights from the
``models/<name>/<version>`` namespace of the shared artifact store, and
this job is its supported writer: it snapshots a checkpoint (a reference
``.pth`` or a port checkpoint directory, what ``cli/serve.py
--restore_ckpt`` accepts) into one immutable, SHA-256-manifested,
atomically published version::

    python -m raft_stereo_tpu_torch.tools.publish_model \\
        --restore_ckpt runs/kitti/ckpt --store /shared/raft-artifacts \\
        --name kitti --version v2

    # replicas then load it at boot ...
    python -m raft_stereo_tpu_torch.cli.serve ... \\
        --executable_cache_dir /shared/raft-artifacts --models kitti@v2
    # ... or live, without a restart:
    curl -X POST http://replica:8551/admin/models \\
        -d '{"action": "register", "model": "kitti@v2"}'

A JAX checkpoint is converted first with ``tools/jax_checkpoint_to_torch.py``
(the port reads no orbax state).  Versions are immutable: re-publishing an
existing complete version is a typed refusal (``--force`` repairs a torn
write, it does not mutate served weights).  ``--verify`` re-reads the
published version through the deep-validation load a replica uses.
Runs on the CPU: it moves weights, it runs no model.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys

log = logging.getLogger("publish_model")


def build_parser() -> argparse.ArgumentParser:
    from raft_stereo_tpu_torch.cli import common

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--restore_ckpt", required=True,
                   help=".pth file or port checkpoint directory to "
                        "snapshot (the loaders of cli/serve.py "
                        "--restore_ckpt)")
    p.add_argument("--store", required=True,
                   help="artifact-store root (the replicas' "
                        "--executable_cache_dir / --model_store_dir)")
    p.add_argument("--name", required=True,
                   help="model name (path-safe token)")
    p.add_argument("--version", required=True,
                   help="version token, e.g. v2 or 2026-08-07a")
    p.add_argument("--note", default=None,
                   help="free-form provenance note recorded in the "
                        "version's metadata")
    p.add_argument("--force", action="store_true",
                   help="overwrite an existing version (repairing a "
                        "torn publish — NEVER mutate a served version)")
    p.add_argument("--verify", action="store_true",
                   help="after publishing, re-load the version through "
                        "the replica's deep-validation path")
    common.add_arch_overrides(p)
    return p


def run(args) -> int:
    from raft_stereo_tpu_torch.cli import common
    from raft_stereo_tpu_torch.serving.models import (ModelStore,
                                                      ModelVersionExists,
                                                      model_coord)

    cfg, state = common.load_any_checkpoint(
        args.restore_ckpt, **common.arch_overrides(args))
    store = ModelStore(args.store)
    metadata = {"source_checkpoint": os.path.abspath(args.restore_ckpt)}
    if args.note:
        metadata["note"] = args.note
    try:
        path = store.publish(args.name, args.version, cfg, state,
                             metadata=metadata, force=args.force)
    except ModelVersionExists as e:
        log.error("%s", e)
        return 1
    out = {"model": model_coord(args.name, args.version), "path": path,
           "versions": store.versions(args.name)}
    if args.verify:
        ok, reason = store.verify(args.name, args.version)
        out["verified"] = ok
        if not ok:
            log.error("published version failed deep validation: %s",
                      reason)
            print(json.dumps(out, indent=1))
            return 1
        # the replica's whole load (config and weights), not just the
        # manifest walk
        store.load(args.name, args.version, deep=True)
    print(json.dumps(out, indent=1))
    return 0


def main(argv=None) -> int:
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)-8s [%(name)s] %(message)s")
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
