"""The EPE cost of the realtime preset's bf16 correlation (the JAX
package's ``tools/bf16_drift.py``, its trained and ``--ckpt`` legs).

    python -m raft_stereo_tpu_torch.tools.bf16_drift [--ckpt DIR] [--device cpu]

The realtime architecture at full width (``RaftStereoConfig.realtime()``)
is trained for 300 steps on warped textured stereo at 320x704 (batch 4,
12 iterations, disparities up to ~70 px, fp32 correlation while
training), then three variants from those weights run over hard layered
scenes at 384x1248 in the bands d<=48/96/192 at depths 7 and 32:
``bf16_alt`` (the shipped preset), ``fp32corr_alt`` (``corr_fp32``) and
``fp32_reg`` (fp32 everywhere, the reference); rows in the shared schema
(``eval/drift.py``), the drift of ``bf16_alt`` against ``fp32_reg``.
``--ckpt DIR`` (a port checkpoint) measures those weights instead and
adds ``bf16_fused`` (``reg_fused`` in bf16).

The JAX tool's third leg, the original PyTorch realtime model's seeded
initialization imported through ``io/torch_import``, needs the original
RAFT-Stereo code, which is not in this repository; it waits until that
code is (ROADMAP.md).

The record goes to ``--out``, by default ``raft_stereo_tpu_torch/_build/
records/BF16_DRIFT_torch.json``; the JAX package's ``BF16_DRIFT_r0*.json``
are never written.  The geometry is this module's constants, as in the
JAX tool.  Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

from raft_stereo_tpu_torch.eval import drift
from raft_stereo_tpu_torch.telemetry.events import default_path, write_record

DEFAULT_OUT = "BF16_DRIFT_torch.json"
HW = (384, 1248)                # KITTI-class, /32-aligned
BANDS = drift.DEFAULT_BANDS
N_PER_BAND = 2
ITERS = (7, 32)                 # the realtime depth, the accuracy depth
TRAIN_STEPS = 300
TRAIN_HW = (320, 704)
TRAIN_ITERS = 12
TRAIN_BATCH = 4


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--ckpt", default=None,
                    help="measure these weights (a port checkpoint "
                         "directory) instead of the 300-step training")
    ap.add_argument("--device", default=None,
                    help="torch device; default the card, 'cpu' runs the "
                         "plain versions")
    ap.add_argument("--out", default=None,
                    help=f"record path (default _build/records/"
                         f"{DEFAULT_OUT})")
    return ap


def three_variants(cfg, state):
    """``bf16_alt``, ``fp32corr_alt`` and ``fp32_reg`` from one state."""
    return {
        "bf16_alt": (cfg, state),
        "fp32corr_alt": (dataclasses.replace(cfg, corr_fp32=True), state),
        "fp32_reg": (dataclasses.replace(cfg, corr_backend="reg",
                                         mixed_precision=False), state),
    }


def run(args) -> dict:
    from raft_stereo_tpu_torch.config import RaftStereoConfig
    from raft_stereo_tpu_torch.eval.runner import resolve_device

    device = resolve_device(args.device)
    scenes = drift.make_band_scenes(HW[0], HW[1], BANDS,
                                    n_per_band=N_PER_BAND, seed=11)
    t0 = time.perf_counter()
    if args.ckpt:
        from raft_stereo_tpu_torch.io.jax_weights import load_checkpoint

        cfg, state = load_checkpoint(args.ckpt)
        cfg = dataclasses.replace(cfg, corr_backend="alt",
                                  mixed_precision=True)
        variants = three_variants(cfg, state)
        variants["bf16_fused"] = (
            dataclasses.replace(cfg, corr_backend="reg_fused"), state)
        tag, steps = "trained_checkpoint", None
    else:
        cfg = RaftStereoConfig.realtime()
        state = drift.brief_train(cfg, TRAIN_STEPS, TRAIN_HW, TRAIN_ITERS,
                                  disp_scale=6.0, batch_n=TRAIN_BATCH,
                                  device=device)
        variants = three_variants(cfg, state)
        tag, steps = f"trained_{TRAIN_STEPS}_steps", TRAIN_STEPS
    train_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    rows = drift.evaluate_variants(
        "bf16_corr_epe_drift", tag, variants, scenes, iters_list=ITERS,
        ref="fp32_reg", drift_of="bf16_alt",
        runner_kwargs={"corr_fp32_auto": False, "device": device})
    rec = {"metric": "bf16_corr_epe_drift", "weights": tag,
           "train_steps": steps, "train_seconds": round(train_s, 1),
           "eval_seconds": round(time.perf_counter() - t0, 1),
           "hw": list(HW), "rows": rows}
    out = args.out or default_path(DEFAULT_OUT)
    write_record(out, rec, indent=1, device=device)
    print(json.dumps({k: v for k, v in rec.items() if k != "rows"}),
          flush=True)
    print(f"bf16 drift -> {out}", flush=True)
    return rec


def main(argv=None) -> int:
    run(build_parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
