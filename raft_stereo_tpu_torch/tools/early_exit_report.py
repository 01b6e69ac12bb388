"""Adaptive GRU early exit: the threshold sweep on the four validators (the
JAX package's ``tools/early_exit_report.py``).

    python -m raft_stereo_tpu_torch.tools.early_exit_report [--device cpu]
    python -m raft_stereo_tpu_torch.tools.early_exit_report --steps 40 \\
        --iters 8 --out /tmp/EARLY_EXIT_smoke.json               # smoke

The convergence-gated loop (``exit_threshold_px``) trades GRU iterations
for a bounded cost in EPE.  The tool measures that trade end to end:

1. train the hermetic architecture briefly on warped textured stereo
   (``eval/drift.brief_train``), so that the GRU converges: an untrained
   GRU's update magnitudes mean nothing;
2. write the four mini-benchmarks (``data/scenes.py``: ETH3D / KITTI /
   FlyingThings / Middlebury-H trees in their on-disk formats) and run the
   validators (``eval/validate.py``) at the fixed depth, the baseline EPE;
3. sweep ``exit_threshold_px``: per threshold and validator the EPE delta
   against the baseline and the mean ``iters_used`` the exit loop ran (on
   the card one CUDA graph whose loop is a WHILE node);
4. time each serving tier preset (interactive, and interactive calibrated
   to the sweep's operating point) against the fixed depth over the same
   pairs, p50/p95, and warn where a tier is slower than 1.25x the fixed
   depth's p50;
5. pick the operating point: the loosest threshold whose worst validator
   EPE delta stays within ``--max_depe`` (0.05 px), and report whether its
   mean ``iters_used`` is at most 60% of the fixed depth.

``sweep(cfg, state, args)`` runs steps 2-5 on given weights (a trained
``(config, state dict)``).  The record goes to ``--out``, by default
``raft_stereo_tpu_torch/_build/records/EARLY_EXIT_torch.json``, with the
card's name and power limit (``nvidia-smi``) in it; the JAX package's
``EARLY_EXIT_r*.json`` are never written.  Runs on the card unless
``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np

from raft_stereo_tpu_torch.eval import drift
from raft_stereo_tpu_torch.telemetry.events import default_path, write_record

DEFAULT_TAG = "torch"
VALIDATORS = ("eth3d", "kitti", "things", "middleburyH")
ACCEPT_FRACTION = 0.60     # the bar: mean iters_used / fixed depth
LATENCY_REGRESSION = 1.25  # a tier's p50 over the fixed depth's


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--iters", type=int, default=16,
                   help="fixed GRU depth the sweep compares against (the "
                        "early-exit cap)")
    p.add_argument("--min_iters", type=int, default=2,
                   help="early-exit floor for every sweep point")
    p.add_argument("--thresholds",
                   default="0.5,0.4,0.3,0.25,0.2,0.15,0.1,0.05,0.01",
                   help="comma list of exit_threshold_px values, loosest "
                        "first")
    p.add_argument("--steps", type=int, default=200,
                   help="brief-training steps before measuring (0 = "
                        "measure the seeded init; only for debugging: an "
                        "untrained GRU does not converge)")
    p.add_argument("--images", type=int, default=3,
                   help="images per validator tree")
    p.add_argument("--hw", default="60x90",
                   help="validator image size HxW (pads to /32)")
    p.add_argument("--train_hw", default="64x96")
    p.add_argument("--train_iters", type=int, default=8)
    p.add_argument("--max_depe", type=float, default=0.05,
                   help="worst-validator EPE delta (px) the chosen "
                        "operating point must stay within")
    p.add_argument("--lat_repeats", type=int, default=3,
                   help="latency passes over the eval pairs per tier")
    p.add_argument("--device", default=None,
                   help="torch device; default the card, 'cpu' runs the "
                        "plain versions")
    p.add_argument("--tag", default=DEFAULT_TAG,
                   help="names the default record, EARLY_EXIT_<tag>.json")
    p.add_argument("--out", default=None,
                   help="record path (default _build/records/"
                        "EARLY_EXIT_<tag>.json)")
    return p


def _hw(text: str):
    return tuple(int(x) for x in text.split("x"))


def card_description(device) -> Optional[str]:
    """``name, power limit`` of the card as ``nvidia-smi`` gives them;
    None off the card."""
    if str(device).split(":")[0] != "cuda":
        return None
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout
    return out.strip().splitlines()[0]


def _collect(device) -> None:
    """Collect a dropped runner now: on the card its CUDA graphs sit in
    reference cycles, and a collection that ran during the next runner's
    capture would destroy them inside that capture."""
    if str(device).split(":")[0] == "cuda":
        import gc

        import torch

        gc.collect()
        torch.cuda.synchronize()


def build_benchmarks(data_root: str, n: int, hw) -> None:
    """The four mini-benchmarks under ``data_root``, from one seeded
    generator in the JAX tool's order."""
    from raft_stereo_tpu_torch.data import scenes

    rng = np.random.default_rng(7)
    scenes.make_eth3d(os.path.join(data_root, "ETH3D"), rng, n=n, hw=hw)
    scenes.make_kitti(os.path.join(data_root, "KITTI"), rng, n=n, hw=hw)
    scenes.make_things(data_root, rng, n=n, hw=hw)
    scenes.make_middlebury(os.path.join(data_root, "Middlebury"), rng, n=n,
                           hw=hw, split="H")


def run_validators(runner, data_root: str) -> Dict[str, float]:
    """All four validators; their metrics merged ({"<name>-epe": ...})."""
    from raft_stereo_tpu_torch.eval.validate import (validate_eth3d,
                                                     validate_kitti,
                                                     validate_middlebury,
                                                     validate_things)

    out = {}
    out.update(validate_eth3d(runner, root=os.path.join(data_root, "ETH3D")))
    out.update(validate_kitti(runner, root=os.path.join(data_root, "KITTI")))
    out.update(validate_things(runner, root=data_root))
    out.update(validate_middlebury(
        runner, root=os.path.join(data_root, "Middlebury"), split="H"))
    return out


def sweep_row(cfg, state, iters, data_root, threshold, min_iters,
              baseline_epe, device=None) -> dict:
    """One threshold's row: EPE per validator, its delta against the fixed
    baseline, the mean ``iters_used``."""
    from raft_stereo_tpu_torch.eval.runner import InferenceRunner

    runner = InferenceRunner(cfg, state, iters=iters,
                             exit_threshold_px=threshold,
                             exit_min_iters=min_iters, device=device)
    metrics = run_validators(runner, data_root)
    depe = {v: round(metrics[f"{v}-epe"] - baseline_epe[v], 4)
            for v in VALIDATORS}
    mean_iters = runner.iters_used_mean()
    del runner
    _collect(device)
    row = {
        "exit_threshold_px": threshold,
        "min_iters": min_iters,
        "mean_iters_used": round(mean_iters, 3),
        "iters_fraction_of_fixed": round(mean_iters / iters, 3),
        "epe": {v: round(metrics[f"{v}-epe"], 4) for v in VALIDATORS},
        "depe_vs_fixed": depe,
        "max_depe_px": max(depe.values()),
    }
    print(json.dumps({"early_exit_sweep": row}), flush=True)
    return row


def choose(rows: List[dict], max_depe: float):
    """``(chosen row or None, meets the 60% bar)``: rows run loosest first,
    so the first within ``max_depe`` saves the most iterations."""
    admissible = [r for r in rows if r["max_depe_px"] <= max_depe]
    chosen = admissible[0] if admissible else None
    return chosen, bool(chosen and chosen["iters_fraction_of_fixed"]
                        <= ACCEPT_FRACTION)


def eval_pairs(data_root: str) -> list:
    """The ETH3D and KITTI validator images as (left, right) pairs for the
    latency bench."""
    from raft_stereo_tpu_torch.data import datasets as ds

    pairs = []
    for dataset in (ds.ETH3D(root=os.path.join(data_root, "ETH3D")),
                    ds.KITTI(root=os.path.join(data_root, "KITTI"))):
        for i in range(len(dataset)):
            s = dataset[i]
            pairs.append((s["image1"], s["image2"]))
    return pairs


def latency_bench(cfg, state, iters, pairs, repeats: int, settings,
                  device=None) -> list:
    """Per-image latency of each (tier name, threshold, min_iters) setting
    against the fixed depth (``settings[0]``) over the same pairs."""
    from raft_stereo_tpu_torch.eval.runner import InferenceRunner

    rows = []
    for name, threshold, min_iters in settings:
        runner = InferenceRunner(cfg, state, iters=iters,
                                 exit_threshold_px=threshold,
                                 exit_min_iters=min_iters, device=device)
        runner(*pairs[0])                      # absorb the capture
        runner.reset_iters_used()
        secs = []
        for _ in range(repeats):
            for left, right in pairs:
                secs.append(runner(left, right)[1])
        secs = np.asarray(secs)
        mean_used = runner.iters_used_mean()
        del runner
        _collect(device)
        rows.append({
            "tier": name,
            "exit_threshold_px": threshold,
            "min_iters": min_iters,
            "images": len(secs),
            "latency_ms": {
                "p50": round(float(np.percentile(secs, 50)) * 1e3, 2),
                "p95": round(float(np.percentile(secs, 95)) * 1e3, 2),
                "mean": round(float(secs.mean()) * 1e3, 2)},
            "mean_iters_used": (round(mean_used, 3)
                                if mean_used is not None else float(iters)),
        })
        print(json.dumps({"tier_latency": rows[-1]}), flush=True)
    fixed_p50 = rows[0]["latency_ms"]["p50"]
    for row in rows[1:]:
        # a tier may tie the fixed depth (quality is the fixed depth) but
        # must not be slower beyond the noise band
        if row["latency_ms"]["p50"] > LATENCY_REGRESSION * fixed_p50:
            print(f"WARNING: tier {row['tier']} p50 "
                  f"{row['latency_ms']['p50']} ms regressed vs fixed "
                  f"{fixed_p50} ms", flush=True)
            row["regression_vs_fixed"] = True
    return rows


def sweep(cfg, state, args, train_steps: int = 0,
          train_seconds: float = 0.0) -> dict:
    """Steps 2-5 of the module docstring on ``(cfg, state)``; returns the
    record's fields (``run`` writes them under the shared header)."""
    from raft_stereo_tpu_torch.config import REQUEST_TIERS
    from raft_stereo_tpu_torch.eval.runner import resolve_device

    device = resolve_device(args.device)
    hw = _hw(args.hw)
    thresholds = [float(t) for t in args.thresholds.split(",")]
    with tempfile.TemporaryDirectory() as work:
        data_root = os.path.join(work, "datasets")
        build_benchmarks(data_root, n=args.images, hw=hw)

        from raft_stereo_tpu_torch.eval.runner import InferenceRunner
        fixed = InferenceRunner(cfg, state, iters=args.iters, device=device)
        base_metrics = run_validators(fixed, data_root)
        del fixed
        _collect(device)
        baseline_epe = {v: base_metrics[f"{v}-epe"] for v in VALIDATORS}
        print(json.dumps({"fixed_baseline": {
            "iters": args.iters,
            "epe": {v: round(baseline_epe[v], 4) for v in VALIDATORS},
        }}), flush=True)

        rows = [sweep_row(cfg, state, args.iters, data_root, t,
                          args.min_iters, baseline_epe, device)
                for t in thresholds]
        chosen, meets_bar = choose(rows, args.max_depe)

        # the preset tier (its threshold targets converged models) and the
        # interactive tier calibrated to the sweep's operating point
        settings = [("fixed", None, None),
                    ("interactive",
                     REQUEST_TIERS["interactive"].exit_threshold_px,
                     REQUEST_TIERS["interactive"].min_iters)]
        if chosen is not None:
            settings.append(("interactive@calibrated",
                             chosen["exit_threshold_px"], args.min_iters))
        latency = latency_bench(cfg, state, args.iters, eval_pairs(data_root),
                                args.lat_repeats, settings, device)

    lat_win = None
    calib = [r for r in latency if r["tier"] == "interactive@calibrated"]
    if calib:
        lat_win = round(latency[0]["latency_ms"]["p50"]
                        / calib[0]["latency_ms"]["p50"], 3)
    return {
        "metric": "early_exit_threshold_sweep",
        "value": (chosen["iters_fraction_of_fixed"] if chosen else None),
        "unit": f"mean iters_used / fixed depth ({args.iters}) at worst "
                f"validator dEPE <= {args.max_depe} px",
        "platform": "gpu" if device.type == "cuda" else device.type,
        "card": card_description(device),
        "model_config": cfg.to_dict(),
        "fixed_iters": args.iters,
        "min_iters": args.min_iters,
        "train_steps": train_steps,
        "train_seconds": round(train_seconds, 1),
        "validators": list(VALIDATORS),
        "images_per_validator": args.images,
        "fixed_baseline_epe": {v: round(baseline_epe[v], 4)
                               for v in VALIDATORS},
        "sweep": rows,
        "chosen": chosen,
        "meets_60pct_bar": meets_bar,
        "tier_presets": {name: {"exit_threshold_px": t.exit_threshold_px,
                                "min_iters": t.min_iters}
                         for name, t in REQUEST_TIERS.items()},
        "tier_latency": latency,
        "interactive_calibrated_p50_speedup_vs_fixed": lat_win,
        "notes": "synthetic four-benchmark trees (data/scenes.py) scored "
                 "by the validators on briefly trained weights",
    }


def trained_state(args) -> tuple:
    """``(config, state dict, seconds)``: the hermetic architecture
    trained ``--steps`` steps (the seeded init at ``--steps 0``), the
    weights the sweep measures and ``tools/confidence_report.py`` can
    take from its caller."""
    from raft_stereo_tpu_torch.eval.runner import resolve_device

    device = resolve_device(args.device)
    cfg = drift.model_config()
    t0 = time.perf_counter()
    if args.steps > 0:
        # the JAX tool's recipe: 10 warped textured scenes, batch 2
        state = drift.brief_train(cfg, args.steps, _hw(args.train_hw),
                                  args.train_iters, n_scenes=10,
                                  device=device)
    else:
        state = drift.init_state(cfg)
    return cfg, state, time.perf_counter() - t0


def run(args, trained: Optional[tuple] = None) -> dict:
    """Train (or take ``trained``, ``trained_state``'s triple), sweep,
    write the record; returns it."""
    from raft_stereo_tpu_torch.eval.runner import resolve_device

    device = resolve_device(args.device)
    cfg, state, train_s = trained or trained_state(args)
    rec = sweep(cfg, state, args, train_steps=args.steps,
                train_seconds=train_s)
    out = args.out or default_path(f"EARLY_EXIT_{args.tag}.json")
    rec = write_record(out, rec, indent=1, device=device)
    print(json.dumps({"metric": "early_exit_threshold_sweep", "out": out,
                      "chosen": rec["chosen"],
                      "meets_60pct_bar": rec["meets_60pct_bar"]}),
          flush=True)
    return rec


def main(argv=None) -> int:
    run(build_parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
