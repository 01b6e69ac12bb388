"""Shared CLI plumbing (the JAX package's ``cli/common.py``).

Checkpoints describe themselves: a port checkpoint directory carries
``config.json``, and a reference ``.pth`` file has its architecture
inferred from the weights.  CLI architecture flags exist only as
overrides of the few runtime switches the weights do not record.
``--banded_encoder`` streams the encoders' full-resolution segment in
bands (models/banded.py).  ``--rows_shards``, ``--rows_gru``,
``--rows_gru_halo`` and ``--corr_w2_shards`` run the context-parallel
executors over a group of this process's devices (parallel/); a group the
devices cannot supply is refused.
"""

from __future__ import annotations

import argparse
import logging
from typing import Any, Dict, Tuple

import torch

from raft_stereo_tpu_torch.config import RaftStereoConfig



def setup_logging():
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)-8s [%(name)s] %(message)s")


def add_arch_overrides(parser: argparse.ArgumentParser):
    """Runtime switches not recorded in weights (the JAX package's flags,
    dest names and defaults)."""
    parser.add_argument("--corr_implementation", default=None,
                        choices=["reg", "alt", "reg_cuda", "alt_cuda",
                                 "reg_fused"],
                        help="correlation backend override")
    parser.add_argument("--slow_fast_gru", action="store_true",
                        help="extra coarse-GRU updates per iteration")
    parser.add_argument("--mixed_precision", action="store_true",
                        help="bf16 compute")
    parser.add_argument("--banded_encoder", action="store_true",
                        help="stream the encoders' full-resolution stages "
                             "in bands (lower peak card memory for large "
                             "frames, at the cost of recomputing the stem)")
    # context parallelism over a device group of this process
    # (parallel/rows_sharded.py, rows_gru.py, corr_sharded.py)
    parser.add_argument("--rows_shards", type=int, default=None,
                        help="shard image rows over this many devices "
                             "(context parallelism for the encoder trunk)")
    parser.add_argument("--rows_gru", action="store_true",
                        help="extend rows sharding through the corr volume, "
                             "GRU iterations, and upsample (full-loop "
                             "context parallelism; requires --rows_shards)")
    parser.add_argument("--rows_gru_halo", type=int, default=None,
                        help="fine-level halo rows for --rows_gru window "
                             "exchange (default: derived from the GRU "
                             "receptive field)")
    parser.add_argument("--corr_w2_shards", type=int, default=None,
                        help="shard the correlation volume's W2 axis over "
                             "this many devices")


def arch_overrides(args) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    if args.corr_implementation:
        out["corr_backend"] = args.corr_implementation
    if args.slow_fast_gru:
        out["slow_fast_gru"] = True
    if args.mixed_precision:
        out["mixed_precision"] = True
    if args.banded_encoder:
        out["banded_encoder"] = True
    if args.rows_shards:
        out["rows_shards"] = args.rows_shards
    if args.rows_gru:
        out["rows_gru"] = True
    if args.rows_gru_halo is not None:
        out["rows_gru_halo"] = args.rows_gru_halo
    if args.corr_w2_shards:
        out["corr_w2_shards"] = args.corr_w2_shards
    return out


def load_any_checkpoint(path: str, **overrides
                        ) -> Tuple[RaftStereoConfig, Dict[str, torch.Tensor]]:
    """``(config, state_dict)`` from a reference ``.pth`` file or a port
    checkpoint directory (io/jax_weights.save_checkpoint)."""
    if path.endswith(".pth"):
        from raft_stereo_tpu_torch.io.torch_import import (
            import_torch_checkpoint)
        return import_torch_checkpoint(path, **overrides)

    from raft_stereo_tpu_torch.io.jax_weights import load_checkpoint
    cfg, state = load_checkpoint(path)
    if overrides:
        cfg = RaftStereoConfig.from_dict({**cfg.to_dict(), **overrides})
    return cfg, state
