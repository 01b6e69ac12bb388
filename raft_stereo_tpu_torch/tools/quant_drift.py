"""The int8 tier's accuracy gate: per-band EPE drift of the quantized
paths on briefly trained weights, beside bf16 (the JAX package's
``tools/quant_drift.py``).

    python -m raft_stereo_tpu_torch.tools.quant_drift [--full] [--device cpu]

1. **Brief training** of the hermetic architecture (``eval/drift.py``
   ``model_config``) on warped textured stereo with band-range
   disparities: drift means something only in a functioning network.
2. **Calibration** (``quant/calibrate.py``) on pairs of the training
   distribution; the scale file is written with ``save_scales``.
3. **Five variants from identical weights** over the shared band scenes
   (``eval/drift.py``, the JAX package's record schema): ``fp32`` (the
   reference), ``bf16``, ``int8`` (int8 encoder weights and the 1-byte
   pyramid with calibrated scales), ``int8_w`` (weights only,
   ``quant_corr=False``) and ``int8_mxu`` (int8 x int8 encoder convs with
   the calibrated activation scales baked into a pre-quantized state dict,
   and the same pyramid).
4. **The gate**: the worst |dEPE| of ``int8`` and ``int8_mxu`` at the
   d<=96 band against ``--gate_px`` (0.05 px), with the per-mode
   breakdown and the quantized state's bytes.

The record (with a ``run`` block naming torch, CUDA and the card) goes to
``--out``, by default ``raft_stereo_tpu_torch/_build/records/
QUANT_DRIFT_torch.json`` (git-ignored), and the scales beside it; the JAX
package's ``QUANT_DRIFT_r22.json`` and ``QUANT_SCALES_r22.json`` are never
written.  The defaults are CPU-sized (tiny architecture, 80x256, two
bands); ``--full`` is the KITTI-class geometry (384x1248, bands
48/96/192, depths 7 and 32, 300 training steps at 320x704; ``--steps``
sets another count).  Runs on the
card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

from raft_stereo_tpu_torch.eval import drift
from raft_stereo_tpu_torch.telemetry.events import default_path, write_record

DEFAULT_OUT = "QUANT_DRIFT_torch.json"
DEFAULT_SCALES = "QUANT_SCALES_torch.json"


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=None,
                    help="brief-training steps (default 180, 300 under "
                         "--full; 0 = seeded init only: not a meaningful "
                         "drift setting, for tests)")
    ap.add_argument("--train_hw", default="40x112")
    ap.add_argument("--train_iters", type=int, default=4)
    ap.add_argument("--train_disp_scale", type=float, default=4.0,
                    help="disparity multiplier of the warped training "
                         "scenes (~12 px base): training must see "
                         "band-range disparities")
    ap.add_argument("--hw", default="80x256",
                    help="evaluation scene HxW (/32-aligned)")
    ap.add_argument("--bands", default="48,96",
                    help="comma list of band ceilings (px); the gate reads "
                         "the 96 band")
    ap.add_argument("--n_per_band", type=int, default=2)
    ap.add_argument("--iters", default="4,10",
                    help="comma list of GRU depths to evaluate")
    ap.add_argument("--calib_pairs", type=int, default=4)
    ap.add_argument("--percentile", type=float, default=99.9)
    ap.add_argument("--gate_px", type=float, default=0.05,
                    help="|dEPE| budget of the int8 tier at d<=96")
    ap.add_argument("--full", action="store_true",
                    help="KITTI-class geometry (384x1248, bands 48/96/192, "
                         "iters 7/32, the bf16 drift's training recipe)")
    ap.add_argument("--device", default=None,
                    help="torch device; default the card, 'cpu' runs the "
                         "plain versions")
    ap.add_argument("--out", default=None,
                    help=f"record path (default _build/records/"
                         f"{DEFAULT_OUT})")
    ap.add_argument("--scales_out", default=None,
                    help="scale file path (default beside the record)")
    ap.add_argument("--state", default=None,
                    help="a saved fp32 state dict (torch.save) to measure "
                         "instead of training")
    ap.add_argument("--save_state", default=None,
                    help="torch.save the measured fp32 state dict here, so "
                         "another device or the JAX package can measure "
                         "the same weights")
    return ap


def gate_of(rows, bands, gate_px: float) -> dict:
    """The gate object: the worst |dEPE| of int8 and int8_mxu at the
    d<=96 band (the first band where there is none), per mode."""
    gate_band = next((b for b in bands if b == "d<=96"), next(iter(bands)))
    gate_rows = [r for r in rows if r["band"] == gate_band]
    per_mode = {
        mode: max((abs(r[f"depe_{mode}"]) for r in gate_rows),
                  default=None)
        for mode in ("int8", "int8_mxu")}
    finite = [v for v in per_mode.values() if v is not None]
    worst = max(finite) if finite else None
    return {"band": gate_band, "budget_px": gate_px,
            "worst_abs_depe_px": worst, "per_mode": per_mode,
            "pass": bool(worst is not None and worst <= gate_px)}


def run(args) -> dict:
    """The gate's record (module docstring); prints each step as JSON."""
    from raft_stereo_tpu_torch.eval.runner import resolve_device
    from raft_stereo_tpu_torch.quant.calibrate import (calibrate,
                                                       conv_input_scales,
                                                       corr_scales,
                                                       save_scales)
    from raft_stereo_tpu_torch.quant.core import (quantize_state_dict,
                                                  quantized_param_bytes)

    if args.full:
        args.hw, args.bands, args.iters = "384x1248", "48,96,192", "7,32"
        args.train_hw, args.train_iters = "320x704", 12
        args.train_disp_scale = 6.0
    if args.steps is None:
        args.steps = 300 if args.full else 180
    device = resolve_device(args.device)
    hw = tuple(int(x) for x in args.hw.split("x"))
    train_hw = tuple(int(x) for x in args.train_hw.split("x"))
    iters_list = [int(x) for x in args.iters.split(",")]
    bands = {f"d<={c}": float(c) for c in args.bands.split(",")}
    out = args.out or default_path(DEFAULT_OUT)
    scales_out = args.scales_out or os.path.join(
        os.path.dirname(os.path.abspath(out)), DEFAULT_SCALES)

    cfg = drift.model_config()
    t0 = time.perf_counter()
    if args.state:
        import torch

        state = torch.load(args.state, map_location="cpu")
        args.steps = 0
    elif args.steps > 0:
        state = drift.brief_train(cfg, args.steps, train_hw,
                                  args.train_iters, args.train_disp_scale,
                                  device=device)
    else:
        state = drift.init_state(cfg)
    train_s = time.perf_counter() - t0
    if args.save_state:
        import torch

        torch.save(state, args.save_state)
    print(json.dumps({"trained": {"steps": args.steps,
                                  "hw": list(train_hw),
                                  "disp_scale": args.train_disp_scale,
                                  "seconds": round(train_s, 1)}}),
          flush=True)

    t0 = time.perf_counter()
    record = calibrate(cfg, state, drift.calibration_pairs(
        train_hw, args.calib_pairs, disp_scale=args.train_disp_scale),
        percentile=args.percentile, device=device)
    os.makedirs(os.path.dirname(os.path.abspath(scales_out)), exist_ok=True)
    save_scales(scales_out, record)
    scales = corr_scales(record)
    calib_s = time.perf_counter() - t0
    print(json.dumps({"calibration": {
        "scales_file": os.path.basename(scales_out),
        "pairs": args.calib_pairs, "percentile": args.percentile,
        "corr_scales": [round(s, 6) for s in scales],
        "activation_sites": len(record["activations"]),
        "seconds": round(calib_s, 1)}}), flush=True)

    int8_cfg = dataclasses.replace(cfg, quant="int8",
                                   quant_corr_scales=scales)
    mxu_state = quantize_state_dict(state,
                                    act_scales=conv_input_scales(record))
    variants = {
        "fp32": (cfg, state),
        "bf16": (dataclasses.replace(cfg, mixed_precision=True), state),
        "int8": (int8_cfg, state),
        "int8_w": (dataclasses.replace(int8_cfg, quant_corr=False), state),
        "int8_mxu": (dataclasses.replace(int8_cfg, quant="int8_mxu"),
                     mxu_state),
    }
    scenes = drift.make_band_scenes(hw[0], hw[1], bands,
                                    n_per_band=args.n_per_band, seed=11)
    t0 = time.perf_counter()
    rows = drift.evaluate_variants(
        "int8_epe_drift", ("given_state" if args.state else "brief_trained"
                           if args.steps else "seeded_init"),
        variants, scenes, iters_list=iters_list, ref="fp32",
        drift_of="int8",
        runner_kwargs={"corr_fp32_auto": False, "device": device})
    eval_s = time.perf_counter() - t0

    gate = gate_of(rows, bands, args.gate_px)
    if not gate["pass"]:
        print(f"WARNING: quant drift gate FAILED: worst |dEPE|="
              f"{gate['worst_abs_depe_px']} px > {args.gate_px} px at "
              f"{gate['band']} (per mode: {gate['per_mode']})", flush=True)
    rec = {
        "metric": "int8_epe_drift_gate",
        "value": gate["worst_abs_depe_px"],
        "unit": f"worst |dEPE| px at {gate['band']} vs fp32 "
                f"({hw[0]}x{hw[1]}, {args.steps} train steps, "
                f"{device.type})",
        "gate": gate,
        "train_steps": args.steps,
        "train_seconds": round(train_s, 1),
        "eval_seconds": round(eval_s, 1),
        "calibration": {"scales_file": os.path.basename(scales_out),
                        "percentile": args.percentile,
                        "pairs": args.calib_pairs,
                        "corr_scales": [round(s, 6) for s in scales]},
        "param_bytes": quantized_param_bytes(mxu_state),
        "rows": rows,
    }
    print(json.dumps(rec), flush=True)
    write_record(out, rec, indent=1, device=device)
    print(f"quant drift -> {out} (scales -> {scales_out})", flush=True)
    return rec


def main(argv=None) -> int:
    run(build_parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
