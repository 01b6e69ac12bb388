"""The drift harness of the low-precision gates (the JAX package's
``tools/drift_common.py`` and the recipe it shares with
``tools/early_exit_report.py`` and ``tools/quant_drift.py``).

A precision variant is judged by the EPE it costs IN DISTRIBUTION, on a
network that functions, per disparity band, against a full-precision
reference from the same weights; an untrained GRU amplifies any numeric
perturbation into meaningless divergence.  So a gate first trains the
hermetic architecture briefly (``brief_train``) on warped textured stereo
(``warped_scenes``, ``WarpedStream``), then runs every variant over the
same hard layered scenes (``make_band_scenes``) and writes one row per
(depth, band) in the JAX package's record schema (``drift_record``):

    {"metric": ..., "weights": ..., "iters": N, "band": "d<=96",
     "epe_<variant>": ...,          # per-variant mean EPE (px)
     "depe_<variant>": ...,         # EPE delta vs the reference variant
     "drift_mean_px": ..., "drift_p99_px": ...}   # |pred - ref pred|

``drift_mean_px``/``drift_p99_px`` measure the raw prediction deviation of
the designated low-precision variant against the reference.
"""

from __future__ import annotations

import dataclasses
import gc
import json
from typing import Dict, Iterable, List, Mapping, Optional, Tuple

import numpy as np
import torch

from raft_stereo_tpu_torch.config import RaftStereoConfig, TrainConfig
from raft_stereo_tpu_torch.data.scenes import (disparity_field,
                                               layered_scene,
                                               textured_image, warp_right)

# Per-band disparity ceilings: hard layered stereo with true occlusions
# at exactly the ceiling, spanning the evaluation range (the reference's
# KITTI protocol clips at 192 px).
DEFAULT_BANDS = {"d<=48": 48.0, "d<=96": 96.0, "d<=192": 192.0}


def make_band_scenes(h: int, w: int, bands: Optional[Dict[str, float]] = None,
                     n_per_band: int = 2, seed: int = 11) -> Dict:
    """Per-band hard layered scenes: ``{band: [(left, right, disp)]}``,
    images as fp32 arrays."""
    bands = dict(DEFAULT_BANDS if bands is None else bands)
    rng = np.random.default_rng(seed)
    scenes = {}
    for name, ceiling in bands.items():
        rows = []
        for _ in range(n_per_band):
            left, right, disp, _occ = layered_scene(
                rng, h, w, d_max=ceiling, d_ceiling=ceiling)
            rows.append((left.astype(np.float32),
                         right.astype(np.float32), disp))
        scenes[name] = rows
    return scenes


def drift_record(metric: str, weights_tag: str, iters: int, band: str,
                 epes: Dict[str, List[float]],
                 preds: Dict[str, List[np.ndarray]],
                 ref: str, drift_of: str) -> dict:
    """One schema row: per-variant mean EPE, EPE deltas vs ``ref``, and
    the raw prediction drift of ``drift_of``."""
    rec = {"metric": metric, "weights": weights_tag, "iters": iters,
           "band": band}
    for name in epes:
        rec[f"epe_{name}"] = round(float(np.mean(epes[name])), 4)
    for name in epes:
        if name != ref:
            rec[f"depe_{name}"] = round(
                rec[f"epe_{name}"] - rec[f"epe_{ref}"], 4)
    drift = [np.abs(a - b) for a, b in zip(preds[drift_of], preds[ref])]
    rec["drift_mean_px"] = round(float(np.mean(
        [d.mean() for d in drift])), 4)
    rec["drift_p99_px"] = round(float(np.mean(
        [np.percentile(d, 99) for d in drift])), 4)
    return rec


def evaluate_variants(metric: str, weights_tag: str,
                      variants: Mapping[str, Tuple[RaftStereoConfig,
                                                   Mapping]],
                      scenes: Dict, iters_list: Iterable[int], ref: str,
                      drift_of: str, runner_kwargs: Optional[Dict] = None
                      ) -> List[dict]:
    """Every (variant, depth, band) cell, one schema row per (depth,
    band): ``variants`` maps a name to (config, state dict).  The runners
    take ``runner_kwargs`` (``device``, ``corr_fp32_auto=False`` in the
    gates: they measure raw bf16 correlation at any depth).  Prints each
    row as a JSON line and returns them."""
    from raft_stereo_tpu_torch.eval.runner import InferenceRunner

    runner_kwargs = dict(runner_kwargs or {})
    rows = []
    for iters in iters_list:
        runners = {name: InferenceRunner(cfg, state, iters=iters,
                                         **runner_kwargs)
                   for name, (cfg, state) in variants.items()}
        for band, rows_in in scenes.items():
            preds = {name: [] for name in runners}
            epes = {name: [] for name in runners}
            for left, right, disp in rows_in:
                for name, runner in runners.items():
                    d = runner.disparity(left, right)
                    preds[name].append(d)
                    epes[name].append(float(np.mean(np.abs(d - disp))))
            rec = drift_record(metric, weights_tag, iters, band, epes,
                               preds, ref, drift_of)
            print(json.dumps(rec), flush=True)
            rows.append(rec)
        # a runner holds itself through its program cache's eviction
        # callback, so ``del`` alone leaves its CUDA graphs and their
        # memory pools to the cyclic collector: collect now, before the
        # next depth's runners capture theirs
        del runners
        gc.collect()
    return rows


# ----------------------------------------------------- the shared recipe
def model_config() -> RaftStereoConfig:
    """The hermetic test architecture: small enough to train and sweep on
    a CPU in minutes, the published GRU update rule; ``fnet_norm="none"``
    as in the JAX package's recipe."""
    return RaftStereoConfig(hidden_dims=(32, 32, 32), fnet_dim=64,
                            fnet_norm="none", corr_backend="reg")


def init_state(cfg: RaftStereoConfig, seed: int = 0
               ) -> Dict[str, torch.Tensor]:
    """A seeded initialization (the global RNG is left as it was)."""
    from raft_stereo_tpu_torch.models.raft_stereo import RAFTStereo

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return RAFTStereo(cfg).state_dict()


def warped_scenes(hw: Tuple[int, int], n: int, disp_scale: float = 1.0,
                  seed: int = 23) -> List[Tuple[np.ndarray, ...]]:
    """``n`` textured left images, each with its right view warped by a
    smooth disparity field times ``disp_scale``: ``(left, right, -disp)``
    fp32 triples (the x-flow is the negative disparity)."""
    h, w = hw
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        left = textured_image(rng, h, w)
        disp = disparity_field(rng, h, w) * disp_scale
        right = warp_right(left, disp)
        out.append((left.astype(np.float32), right.astype(np.float32),
                    -disp))
    return out


class WarpedStream:
    """The brief training's loader: batch ``t`` draws ``batch_n`` scenes
    with ``default_rng(500 + t)``, ``steps + 1`` batches in all (the JAX
    recipe's ``Stream``)."""

    def __init__(self, scenes, steps: int, batch_n: int):
        self.scenes, self.steps, self.batch_n = scenes, steps, batch_n

    def __iter__(self):
        h, w = self.scenes[0][0].shape[:2]
        for t in range(self.steps + 1):
            idx = np.random.default_rng(500 + t).integers(
                0, len(self.scenes), self.batch_n)
            ls, rs, fs = zip(*(self.scenes[i] for i in idx))
            yield {"image1": np.stack(ls), "image2": np.stack(rs),
                   "flow": np.stack(fs),
                   "valid": np.ones((self.batch_n, h, w), np.float32)}


def brief_train(cfg: RaftStereoConfig, steps: int, train_hw, train_iters: int,
                disp_scale: float = 1.0, batch_n: int = 2, n_scenes: int = 12,
                device=None, on_step=None) -> Dict[str, torch.Tensor]:
    """Train ``cfg`` (with ``corr_fp32``: the backend's numerics must not
    leak into the weights being compared) for ``steps`` steps on warped
    textured scenes with band-range disparities (``disp_scale``); returns
    the fp32 state dict.  ``device`` None is the card."""
    from raft_stereo_tpu_torch.eval.runner import resolve_device
    from raft_stereo_tpu_torch.training.train_loop import train

    device = resolve_device(device)
    tcfg = TrainConfig(batch_size=batch_n, train_iters=train_iters,
                       num_steps=steps, image_size=tuple(train_hw), lr=2e-4,
                       validation_frequency=10 ** 9, seed=3)
    stream = WarpedStream(warped_scenes(train_hw, n_scenes, disp_scale),
                          steps, batch_n)
    mcfg = dataclasses.replace(cfg, corr_fp32=True)
    # cuDNN's default algorithms sum in an order that varies from run to
    # run: on an H100 two trainings from one seed part by 2e-8 after one
    # step and 1e-3 after 20, and 300 steps land on weights whose gate
    # reads anywhere from 0.3 to 3.8 px.  Its deterministic algorithms
    # make the weights a function of the seed.
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        state = train(mcfg, tcfg, name="drift", checkpoint_dir=None,
                      log_dir=None, loader=stream, device=device,
                      on_step=on_step)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    return {k: v.detach().float().cpu()
            for k, v in state.model.state_dict().items()}


def calibration_pairs(hw, n: int, seed: int = 71, disp_scale: float = 1.0):
    """In-distribution pairs for the calibration pass: the warped textured
    stereo the brief training saw."""
    return [(l, r) for l, r, _ in warped_scenes(hw, n, disp_scale, seed)]
