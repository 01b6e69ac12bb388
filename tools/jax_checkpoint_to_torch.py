"""Convert a JAX package checkpoint into a checkpoint of the PyTorch port.

    JAX_PLATFORMS=cpu python tools/jax_checkpoint_to_torch.py SRC DST

``SRC`` is a checkpoint directory the JAX package wrote
(``raft_stereo_tpu/training/checkpoint.save_checkpoint``: a training
checkpoint or a ``save_weights`` export).  The conversion:

1. verifies ``SRC``'s SHA-256 manifest (``verify_manifest``); a checkpoint
   that fails it is refused;
2. reads its ``config.json`` and builds the port's ``RaftStereoConfig``
   from it: a configuration the port does not run yet (``rows_shards > 1``
   and the other executors of ROADMAP.md §D7) raises the port's
   ``NotImplementedError``, which names the ROADMAP item;
3. restores the state tree (``load_checkpoint``) and carries its
   ``params`` and ``batch_stats`` through
   ``raft_stereo_tpu_torch.io.jax_weights.state_dict_from_jax``; the
   optimizer state and the step are left behind (the port's checkpoint
   holds weights, what inference and fine-tuning from weights need);
4. loads the state dict into the port's model, every key and shape
   strictly, and writes it with ``io/jax_weights.save_checkpoint`` into a
   temporary directory beside ``DST``, renamed to ``DST`` once complete.

Nothing is written before every check has passed, and ``DST`` must not
exist.  The result loads with ``raft_stereo_tpu_torch.cli.common.
load_any_checkpoint`` and ``--restore_ckpt DST`` in the port's CLIs.

This script imports JAX (to read the JAX checkpoint), so it is not part of
the port's package, which never imports JAX.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
from typing import Tuple

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)


def convert(src: str, dst: str) -> Tuple[object, dict]:
    """Convert ``src`` (a JAX checkpoint directory) into the port's
    checkpoint directory ``dst``; returns the port's ``(config, state
    dict)``.  Raises, having written nothing, on a failed manifest, a
    configuration the port refuses, or weights that do not fit the port's
    model."""
    import jax

    from raft_stereo_tpu.training import checkpoint as ckpt
    from raft_stereo_tpu_torch.config import RaftStereoConfig
    from raft_stereo_tpu_torch.io.jax_weights import (save_checkpoint,
                                                      state_dict_from_jax)
    from raft_stereo_tpu_torch.models.raft_stereo import RAFTStereo

    src, dst = os.path.abspath(src), os.path.abspath(dst)
    if os.path.exists(dst):
        raise FileExistsError(f"{dst} exists; the converter writes a new "
                              f"directory")
    ok, reason = ckpt.verify_manifest(src)
    if not ok:
        raise ValueError(f"{src}: manifest check failed ({reason})")
    cfg = RaftStereoConfig.from_dict(ckpt.load_config(src).to_dict())
    _, tree = ckpt.load_checkpoint(src)
    variables = {"params": tree["params"]}
    if tree.get("batch_stats"):
        variables["batch_stats"] = tree["batch_stats"]
    state = state_dict_from_jax(jax.device_get(variables))
    RAFTStereo(cfg).load_state_dict(state, strict=True)

    tmp = f"{dst}.tmp-{os.getpid()}"
    try:
        save_checkpoint(tmp, cfg, state)
        os.replace(tmp, dst)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return cfg, state


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("src", help="JAX checkpoint directory")
    ap.add_argument("dst", help="the port's checkpoint directory to write "
                                "(must not exist)")
    args = ap.parse_args(argv)
    try:
        cfg, state = convert(args.src, args.dst)
    except (FileExistsError, ValueError, NotImplementedError) as e:
        print(f"jax_checkpoint_to_torch: {e}", file=sys.stderr)
        return 2
    print(f"wrote {args.dst}: {len(state)} tensors, "
          f"{sum(t.numel() for t in state.values())} values")
    return 0


if __name__ == "__main__":
    sys.exit(main())
