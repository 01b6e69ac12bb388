"""Compile farm: build every CUDA kernel library ONCE into the shared
artifact store, so every serving replica boots without ``nvcc`` (the JAX
package's ``tools/compile_farm.py`` on the port).

The JAX farm serializes XLA executables.  What the port compiles is its
kernels (kernels/_build.py: one ``nvcc`` per ``csrc/*.cu``); its CUDA
graphs cannot be serialized and are captured at each boot.  So the farm
builds every source (all ``nvcc`` processes started together) and stores
each library in the store under the key a replica computes for it:
the source's hash, the flags, the toolkit's version and the architecture,
with the torch/CUDA/driver/device fingerprint (serving/persist.py).
Replicas point ``--executable_cache_dir`` at the store (optionally
``--executable_cache_read_only``); a library missing from their
``_build/`` is then fetched, not compiled::

    python -m raft_stereo_tpu_torch.tools.compile_farm \\
        --out /shared/raft-artifacts --manifest FARM_MANIFEST.json

Keys are content hashes, so re-running the farm is idempotent.  The farm
must run on the replicas' toolkit, torch build and device kind: a
mismatched fingerprint misses cleanly and the replica compiles.  Needs
``nvcc`` and a card.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import time

log = logging.getLogger("compile_farm")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", required=True,
                   help="artifact-store directory to populate (the "
                        "replicas' --executable_cache_dir)")
    p.add_argument("--max_bytes", type=int, default=None,
                   help="GC bound applied to the store after the build")
    p.add_argument("--manifest", default=None,
                   help="write a JSON build manifest here (libraries, "
                        "keys, bytes, wall time)")
    return p


def run(args) -> int:
    from raft_stereo_tpu_torch.kernels import _build
    from raft_stereo_tpu_torch.serving.persist import (ExecutableDiskCache,
                                                       backend_fingerprint)

    t0 = time.perf_counter()
    store = ExecutableDiskCache(args.out, max_bytes=args.max_bytes)
    runs0 = _build.nvcc_runs
    build_s = _build.build_all()
    libraries = {}
    stored = 0
    for name in _build.sources():
        key = _build.artifact_key(name)
        if store.load(key) is None:
            stored += store.store(key,
                                  _build.library_path(name).read_bytes(),
                                  meta=_build.artifact_coords(name))
        libraries[name] = {"key": key,
                           "build_s": round(build_s[name], 3)}
    manifest = {
        "store": os.path.abspath(args.out),
        "backend": backend_fingerprint(),
        "toolkit": _build.toolkit_version(),
        "libraries": libraries,
        "nvcc_runs": _build.nvcc_runs - runs0,
        "stored": stored,
        "store_stats": store.stats(),
        "store_bytes": store.total_bytes(),
        "wall_s": round(time.perf_counter() - t0, 3),
    }
    log.info("compile farm done: %d libraries (%d stored, %d nvcc runs) "
             "in %.1fs -> %s (%d bytes)", len(libraries), stored,
             manifest["nvcc_runs"], manifest["wall_s"], manifest["store"],
             manifest["store_bytes"])
    print(json.dumps(manifest, indent=1))
    if args.manifest:
        with open(args.manifest, "w") as f:
            json.dump(manifest, f, indent=1)
    return 0


def main(argv=None) -> int:
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)-8s [%(name)s] %(message)s")
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
