"""Confidence calibration and cascade cost report (the JAX package's
``tools/confidence_report.py`` on the port): does the per-pixel
confidence MEAN anything, and does ``tier="auto"`` pay for itself?

    python -m raft_stereo_tpu_torch.tools.confidence_report [--device cpu]
    python -m raft_stereo_tpu_torch.tools.confidence_report --steps 40 \\
        --iters 6 --out /tmp/CONFIDENCE_smoke.json               # smoke

1. train the hermetic architecture briefly (``eval/drift.brief_train``,
   the recipe of ``tools/early_exit_report.py``: an untrained GRU's
   update magnitudes carry no convergence signal), or take the caller's
   weights (``run(args, trained=...)``);
2. build the four validator trees (``tools/early_exit_report.
   build_benchmarks``: ETH3D / KITTI / FlyingThings / Middlebury-H in
   their on-disk formats) and, per validator, score the full-resolution
   confidence map of the static tier against the ground-truth error PER
   PIXEL: **AUROC** (P(confidence at a correct pixel > confidence at a
   bad one), bad = error > 1 px, rank-based Mann-Whitney; 0.5 is a coin
   flip) and **Spearman** of confidence against |error| (expected
   negative);
3. the cascade: the same pairs through one engine pinned to the static
   tier, then as ``tier="auto"`` with the threshold at the median draft
   confidence (so the gate splits this workload).  Cost is the GRU
   iterations CONSUMED per request, read from the per-tier
   ``infer_gru_iters_used`` histogram sums (draft and escalation both
   counted); accuracy is the mean EPE.  WARNs when the auto tier fails
   to undercut the static cost or leaves the ``--max_depe`` budget.

The record goes to ``--out``, by default
``raft_stereo_tpu_torch/_build/records/CONFIDENCE_torch.json``, with the
card's name and power limit in it.  Runs on the card unless
``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from typing import Optional

import numpy as np

from raft_stereo_tpu_torch.telemetry.events import default_path, write_record
from raft_stereo_tpu_torch.tools import early_exit_report as ee

DEFAULT_TAG = "torch"
VALIDATORS = ee.VALIDATORS
BAD_PX = 1.0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--iters", type=int, default=12,
                   help="fixed GRU depth of the static/escalation tier "
                        "(the cascade's expensive arm and the "
                        "calibration scan's program)")
    p.add_argument("--draft", default="0.25:2",
                   help="draft tier spec 'threshold_px:min_iters' — the "
                        "early-exit program the cascade drafts on (same "
                        "syntax as ServeConfig.tiers after the name)")
    p.add_argument("--steps", type=int, default=200,
                   help="brief-training steps before measuring (0 = "
                        "random init; only for debugging — untrained "
                        "update magnitudes are meaningless)")
    p.add_argument("--images", type=int, default=3,
                   help="images per validator tree")
    p.add_argument("--hw", default="60x90",
                   help="validator image size HxW (pads to /32)")
    p.add_argument("--train_hw", default="64x96")
    p.add_argument("--train_iters", type=int, default=8)
    p.add_argument("--max_px", type=int, default=20000,
                   help="pixel subsample per validator for the rank "
                        "statistics (AUROC/Spearman are O(n log n))")
    p.add_argument("--max_depe", type=float, default=0.05,
                   help="mean-EPE budget (px) the auto tier must stay "
                        "within vs the static expensive tier")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    p.add_argument("--tag", default=DEFAULT_TAG)
    p.add_argument("--out", default=None,
                   help="output path; default CONFIDENCE_<tag>.json under "
                        "the package's records directory")
    return p


# ----------------------------------------------------------- rank stats
def average_ranks(x: np.ndarray) -> np.ndarray:
    """1-based average ranks with tie averaging (mergesort = stable)."""
    order = np.argsort(x, kind="mergesort")
    sx = x[order]
    ranks = np.empty(len(x), np.float64)
    i, n = 0, len(x)
    while i < n:
        j = i
        while j + 1 < n and sx[j + 1] == sx[i]:
            j += 1
        ranks[order[i:j + 1]] = 0.5 * (i + j) + 1.0
        i = j + 1
    return ranks


def auroc_good_vs_bad(conf: np.ndarray, bad: np.ndarray):
    """P(conf at a good pixel > conf at a bad pixel), rank-based
    (Mann-Whitney U / (n_good * n_bad)); None when a class is empty."""
    n_bad = int(bad.sum())
    n_good = len(bad) - n_bad
    if n_bad == 0 or n_good == 0:
        return None
    ranks = average_ranks(conf)
    u_good = ranks[~bad].sum() - n_good * (n_good + 1) / 2.0
    return float(u_good / (n_good * n_bad))


def spearman(a: np.ndarray, b: np.ndarray):
    ra, rb = average_ranks(a), average_ranks(b)
    ra -= ra.mean()
    rb -= rb.mean()
    denom = np.sqrt((ra * ra).sum() * (rb * rb).sum())
    return float((ra * rb).sum() / denom) if denom > 0 else None


# ------------------------------------------------------------ validators
def validator_datasets(data_root: str):
    """(dataset, valid_fn) per validator — the valid masks reproduce
    eval/validate.py's per-benchmark rules (Middlebury keeps occluded
    pixels, FlyingThings drops |flow| >= 192)."""
    from raft_stereo_tpu_torch.data import datasets as ds

    return {
        "eth3d": (ds.ETH3D(root=os.path.join(data_root, "ETH3D")),
                  lambda v, f: v >= 0.5),
        "kitti": (ds.KITTI(root=os.path.join(data_root, "KITTI")),
                  lambda v, f: v >= 0.5),
        "things": (ds.SceneFlow(root=data_root,
                                dstype="frames_finalpass",
                                things_test=True),
                   lambda v, f: (v >= 0.5) & (np.abs(f) < 192)),
        "middleburyH": (ds.Middlebury(
            root=os.path.join(data_root, "Middlebury"), split="H"),
            lambda v, f: (v >= -0.5) & (f > -1000)),
    }


def calibration_leg(svc, datasets, static_tier: str, max_px: int) -> dict:
    """Per-validator pixel-level confidence-vs-error rank statistics at
    the static (fixed-depth) tier."""
    rng = np.random.default_rng(11)
    out = {}
    for name, (dataset, valid_fn) in datasets.items():
        confs, errs = [], []
        for i in range(len(dataset)):
            s = dataset[i]
            res = svc.infer(s["image1"], s["image2"], tier=static_tier,
                            timeout=600)
            assert res.confidence is not None, \
                "confidence map missing with ServeConfig.confidence on"
            err = np.abs(res.flow - s["flow"]).ravel()
            conf = res.confidence.ravel()
            valid = valid_fn(s["valid"].ravel(), s["flow"].ravel())
            confs.append(conf[valid])
            errs.append(err[valid])
        conf = np.concatenate(confs)
        err = np.concatenate(errs)
        if len(conf) > max_px:
            idx = rng.choice(len(conf), size=max_px, replace=False)
            conf, err = conf[idx], err[idx]
        bad = err > BAD_PX
        row = {
            "pixels": int(len(conf)),
            "bad_fraction": round(float(bad.mean()), 4),
            "auroc": auroc_good_vs_bad(conf, bad),
            "spearman_conf_vs_err": spearman(conf, err),
            "conf_mean_good": (round(float(conf[~bad].mean()), 4)
                               if (~bad).any() else None),
            "conf_mean_bad": (round(float(conf[bad].mean()), 4)
                              if bad.any() else None),
        }
        if row["auroc"] is not None:
            row["auroc"] = round(row["auroc"], 4)
            if row["auroc"] <= 0.5:
                print(f"WARNING: {name} AUROC {row['auroc']} <= 0.5 — "
                      f"confidence does not predict >1px error on this "
                      f"validator", flush=True)
        if row["spearman_conf_vs_err"] is not None:
            row["spearman_conf_vs_err"] = round(
                row["spearman_conf_vs_err"], 4)
        out[name] = row
        print(json.dumps({"confidence_calibration": {name: row}}),
              flush=True)
    return out


# --------------------------------------------------------------- cascade
def _iters_consumed(svc, tiers) -> float:
    """Total GRU iterations consumed so far, summed over the given
    tiers' infer_gru_iters_used histograms (fixed-depth tiers report the
    configured depth per dispatch)."""
    total = 0.0
    for tier in tiers:
        pair = svc.metrics.iters_used_stats(tier)
        if pair is not None:
            total += float(pair[0].sum)
    return total


def cascade_leg(svc, datasets, draft_tier: str, static_tier: str,
                max_depe: float) -> dict:
    """The same eval pairs through the static expensive tier and through
    tier="auto"; cost = mean GRU iterations consumed per request from the
    per-tier histogram sums, accuracy = mean EPE against ground truth."""
    pairs = []
    for dataset, valid_fn in datasets.values():
        for i in range(len(dataset)):
            s = dataset[i]
            pairs.append((s["image1"], s["image2"], s["flow"],
                          valid_fn(s["valid"], s["flow"])))

    def epe_of(res, flow_gt, mask) -> float:
        err = np.abs(res.flow - flow_gt)
        return float(err[mask].mean())

    tiers = (draft_tier, static_tier)
    mark = _iters_consumed(svc, tiers)
    static_epes = [epe_of(svc.infer(l, r, tier=static_tier, timeout=600),
                          f, v) for l, r, f, v in pairs]
    static_iters = _iters_consumed(svc, tiers) - mark

    mark = _iters_consumed(svc, tiers)
    auto_epes, escalated = [], 0
    for l, r, f, v in pairs:
        res = svc.infer(l, r, tier="auto", timeout=600)
        auto_epes.append(epe_of(res, f, v))
        escalated += bool(res.escalated)
        assert res.draft_tier == draft_tier, res.draft_tier
    auto_iters = _iters_consumed(svc, tiers) - mark

    n = len(pairs)
    row = {
        "requests": n,
        "escalated": escalated,
        "escalated_fraction": round(escalated / n, 4),
        "cascade_threshold": svc.serve_cfg.cascade_threshold,
        "mean_cost_iters_static": round(static_iters / n, 3),
        "mean_cost_iters_auto": round(auto_iters / n, 3),
        "cost_ratio_auto_vs_static": (
            round(auto_iters / static_iters, 4) if static_iters else None),
        "mean_epe_static": round(float(np.mean(static_epes)), 4),
        "mean_epe_auto": round(float(np.mean(auto_epes)), 4),
        "depe_auto_vs_static": round(float(np.mean(auto_epes)
                                           - np.mean(static_epes)), 4),
        "max_depe_budget": max_depe,
    }
    row["within_epe_budget"] = abs(row["depe_auto_vs_static"]) <= max_depe
    row["cost_win"] = auto_iters < static_iters
    if not row["within_epe_budget"]:
        print(f"WARNING: auto tier dEPE {row['depe_auto_vs_static']} px "
              f"exceeds the {max_depe} px budget", flush=True)
    if not row["cost_win"]:
        print(f"WARNING: auto tier mean cost "
              f"{row['mean_cost_iters_auto']} iters did not undercut "
              f"static {row['mean_cost_iters_static']}", flush=True)
    print(json.dumps({"cascade_cost": row}), flush=True)
    return row


def run(args, trained: Optional[tuple] = None) -> dict:
    """Steps 1-3 of the module docstring; ``trained`` is
    ``early_exit_report.trained_state``'s ``(config, state, seconds)``
    (None trains here).  Writes the record and returns it."""
    from raft_stereo_tpu_torch.eval.runner import resolve_device
    from raft_stereo_tpu_torch.serving import ServeConfig, ServingEngine

    device = resolve_device(args.device)
    hw = tuple(int(x) for x in args.hw.split("x"))
    draft_thr, draft_min = args.draft.split(":")
    cfg, state, train_s = trained or ee.trained_state(args)

    draft_tier, static_tier = "draft", "quality"
    with tempfile.TemporaryDirectory() as work:
        data_root = os.path.join(work, "datasets")
        ee.build_benchmarks(data_root, n=args.images, hw=hw)
        datasets = validator_datasets(data_root)

        # One scan engine for the calibration and the threshold pick; the
        # cascade engine is built after, with the calibrated threshold
        # (ServeConfig is frozen).
        base = dict(max_batch=1, batch_sizes=(1,), iters=args.iters,
                    tiers=(f"{draft_tier}:{draft_thr}:{draft_min}",
                           static_tier),
                    confidence=True)
        with ServingEngine(cfg, state, ServeConfig(**base),
                           device=device) as svc:
            calibration = calibration_leg(svc, datasets, static_tier,
                                          args.max_px)
            # the median draft confidence: about half the requests
            # draft-resolved, half escalated
            draft_confs = []
            for dataset, _ in datasets.values():
                for i in range(len(dataset)):
                    s = dataset[i]
                    res = svc.infer(s["image1"], s["image2"],
                                    tier=draft_tier, timeout=600)
                    draft_confs.append(res.confidence_mean)
            threshold = round(float(np.median(draft_confs)), 4)
            print(json.dumps({"draft_confidence": {
                "n": len(draft_confs),
                "min": round(min(draft_confs), 4),
                "median": threshold,
                "max": round(max(draft_confs), 4)}}), flush=True)
        ee._collect(device)

        with ServingEngine(cfg, state, ServeConfig(
                **base, cascade=True, cascade_draft=draft_tier,
                cascade_escalate=static_tier,
                cascade_threshold=threshold), device=device) as svc:
            cascade = cascade_leg(svc, datasets, draft_tier, static_tier,
                                  args.max_depe)
            quality = svc.quality_status()
        ee._collect(device)

    aurocs = [v["auroc"] for v in calibration.values()
              if v["auroc"] is not None]
    rec = {
        "metric": "confidence_report",
        "value": round(float(np.mean(aurocs)), 4) if aurocs else None,
        "unit": f"mean AUROC of confidence vs >{BAD_PX}px error over "
                f"{len(calibration)} validators",
        "platform": "gpu" if device.type == "cuda" else device.type,
        "card": ee.card_description(device),
        "model_config": cfg.to_dict(),
        "train_steps": args.steps,
        "train_seconds": round(train_s, 1),
        "iters": args.iters,
        "draft_tier_spec": f"{draft_tier}:{draft_thr}:{draft_min}",
        "validators": list(VALIDATORS),
        "images_per_validator": args.images,
        "bad_px_threshold": BAD_PX,
        "calibration": calibration,
        "cascade": cascade,
        "quality_status": quality,
        "notes": "synthetic four-benchmark trees (data/scenes.py) on "
                 "briefly trained weights; AUROC/Spearman are pixel-level "
                 "rank statistics on the valid mask; cascade cost counted "
                 "from the per-tier infer_gru_iters_used histogram sums "
                 "(draft and escalation both included)",
    }
    out = args.out or default_path(f"CONFIDENCE_{args.tag}.json")
    rec = write_record(out, rec, indent=1, device=device)
    print(json.dumps({
        "metric": "confidence_report", "out": out,
        "auroc": {k: v["auroc"] for k, v in calibration.items()},
        "cascade_cost_ratio": cascade["cost_ratio_auto_vs_static"],
        "within_epe_budget": cascade["within_epe_budget"],
        "cost_win": cascade["cost_win"],
    }), flush=True)
    return rec


def main(argv=None) -> int:
    run(build_parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
