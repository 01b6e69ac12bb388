"""Shared CLI plumbing (the JAX package's ``cli/common.py``).

Checkpoints describe themselves: a port checkpoint directory carries
``config.json``, and a reference ``.pth`` file has its architecture
inferred from the weights.  CLI architecture flags exist only as
overrides of the few runtime switches the weights do not record.
``--banded_encoder`` streams the encoders' full-resolution segment in
bands (models/banded.py).  The flags of the context-parallel executors
are accepted, as in the JAX package, and raise: that machinery is not
ported (ROADMAP.md §D7).
"""

from __future__ import annotations

import argparse
import logging
from typing import Any, Dict, Tuple

import torch

from raft_stereo_tpu_torch.config import RaftStereoConfig

_D7 = "§D7 parallel executors"


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
    parser.add_argument("--rows_shards", type=int, default=None,
                        help=f"not ported (ROADMAP.md {_D7}); raises")
    parser.add_argument("--rows_gru", action="store_true",
                        help=f"not ported (ROADMAP.md {_D7}); raises")
    parser.add_argument("--rows_gru_halo", type=int, default=None,
                        help=f"not ported (ROADMAP.md {_D7}); raises")
    parser.add_argument("--corr_w2_shards", type=int, default=None,
                        help=f"not ported (ROADMAP.md {_D7}); raises")


def arch_overrides(args) -> Dict[str, Any]:
    for flag, on in (("--rows_shards", args.rows_shards),
                     ("--rows_gru", args.rows_gru),
                     ("--rows_gru_halo", args.rows_gru_halo is not None),
                     ("--corr_w2_shards", args.corr_w2_shards)):
        if on:
            raise NotImplementedError(
                f"{flag} is not ported to the PyTorch package yet "
                f"(ROADMAP.md {_D7})")
    out: Dict[str, Any] = {}
    if args.corr_implementation:
        out["corr_backend"] = args.corr_implementation
    if args.slow_fast_gru:
        out["slow_fast_gru"] = True
    if args.mixed_precision:
        out["mixed_precision"] = True
    if args.banded_encoder:
        out["banded_encoder"] = True
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
