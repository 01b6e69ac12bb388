"""The four validation harnesses and the KITTI FPS protocol (the JAX
package's ``eval/validate.py``).

One loop parameterized by each benchmark's quirks, with the reference's
metric definitions:

| benchmark   | bad-px thr | valid mask                         | D1 aggregation |
|-------------|-----------:|------------------------------------|----------------|
| ETH3D       |        1.0 | valid >= 0.5                       | per-image mean |
| KITTI-2015  |        3.0 | valid >= 0.5                       | per-PIXEL pool |
| FlyingThings|        1.0 | valid >= 0.5 and |flow| < 192      | per-PIXEL pool |
| Middlebury  |        2.0 | valid >= -0.5 (occluded INCLUDED)  | per-image mean |
|             |            |   and flow > -1000                 |                |

KITTI also times each forward and reports FPS with the first 50 images
discarded as warm-up; on the card the warm-up absorbs the runner's CUDA
graph captures.  ``sequence_drift`` waits for the runner's streaming
path (ROADMAP §D3).
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Callable, Dict, Optional

import numpy as np

from raft_stereo_tpu_torch.data import datasets as ds
from raft_stereo_tpu_torch.eval.runner import InferenceRunner

log = logging.getLogger(__name__)

WARMUP_IMAGES = 50


def single_device_cfg(cfg):
    """The config without multi-device executor flags: the periodic
    validator is single-device inference."""
    if cfg.rows_shards > 1 or cfg.corr_w2_shards > 1 or cfg.rows_gru:
        return dataclasses.replace(cfg, rows_shards=1, corr_w2_shards=1,
                                   rows_gru=False)
    return cfg


def _validate(runner: InferenceRunner, dataset, name: str,
              bad_threshold: float,
              valid_fn: Callable[[np.ndarray, np.ndarray], np.ndarray],
              pixel_pool_d1: bool, timed: bool = False,
              max_images: Optional[int] = None) -> Dict[str, float]:
    epe_list, out_list, elapsed = [], [], []
    n = len(dataset) if max_images is None else min(len(dataset), max_images)
    for i in range(n):
        sample = dataset[i]
        flow_gt = sample["flow"]
        valid_gt = sample["valid"]
        flow_pr, secs = runner(sample["image1"], sample["image2"])
        if flow_pr.shape != flow_gt.shape:
            raise ValueError(f"{name} {i}: flow {flow_pr.shape} against GT "
                             f"{flow_gt.shape}")
        if timed and i > WARMUP_IMAGES:
            elapsed.append(secs)

        epe = np.abs(flow_pr - flow_gt).ravel()
        val = valid_fn(valid_gt.ravel(), flow_gt.ravel())
        bad = epe > bad_threshold
        image_epe = float(epe[val].mean())
        image_bad = float(bad[val].mean())
        log.info("%s %d/%d. EPE %.4f D1 %.4f", name, i + 1, n,
                 image_epe, image_bad)
        epe_list.append(image_epe)
        out_list.append(bad[val] if pixel_pool_d1 else image_bad)

    epe = float(np.mean(epe_list))
    d1 = 100 * float(np.mean(np.concatenate(out_list) if pixel_pool_d1
                             else np.asarray(out_list)))
    result = {f"{name}-epe": epe, f"{name}-d1": d1}
    if timed and elapsed:
        mean_rt = float(np.mean(elapsed))
        result[f"{name}-fps"] = 1.0 / mean_rt
        print(f"Validation {name}: EPE {epe}, D1 {d1}, "
              f"{1.0 / mean_rt:.2f}-FPS ({mean_rt:.3f}s)")
    else:
        print(f"Validation {name}: EPE {epe}, D1 {d1}")
    return result


def make_validation_fn(model_cfg, train_cfg, data_root: str = "datasets",
                       datasets: tuple = ("things",),
                       max_images: Optional[int] = None, device=None):
    """Periodic-validation hook for training.

    Returns ``validate_fn(state_dict, model_cfg=None) -> dict`` running
    the named validators (any subset of the four benchmarks) at
    ``train_cfg.valid_iters``.  One ``InferenceRunner`` is reused across
    calls while the config is unchanged (new weights are loaded into it,
    ``InferenceRunner.load_state_dict``) and re-created when it changes.
    ``device`` is the runner's (None: the card)."""
    dispatch = {
        "things": lambda r: validate_things(r, root=data_root,
                                            max_images=max_images),
        "kitti": lambda r: validate_kitti(
            r, root=os.path.join(data_root, "KITTI"), max_images=max_images),
        "eth3d": lambda r: validate_eth3d(
            r, root=os.path.join(data_root, "ETH3D"), max_images=max_images),
        "middlebury": lambda r: validate_middlebury(
            r, root=os.path.join(data_root, "Middlebury"), split="H",
            max_images=max_images),
    }
    unknown = set(datasets) - set(dispatch)
    if unknown:
        raise ValueError(f"unknown validation datasets {sorted(unknown)}; "
                         f"choose from {sorted(dispatch)}")
    runner = None
    captured_cfg = model_cfg

    def validate_fn(state_dict, model_cfg=None):
        # model_cfg=None -> the config captured at construction
        cfg = single_device_cfg(captured_cfg if model_cfg is None
                                else model_cfg)
        nonlocal runner
        if runner is None or runner.config != cfg:
            runner = InferenceRunner(cfg, state_dict,
                                     iters=train_cfg.valid_iters,
                                     device=device)
        else:
            runner.load_state_dict(state_dict)
        results = {}
        for name in datasets:
            results.update(dispatch[name](runner))
        return results

    return validate_fn


def validate_eth3d(runner: InferenceRunner, root: str = "datasets/ETH3D",
                   max_images: Optional[int] = None) -> Dict[str, float]:
    """ETH3D two-view training split."""
    return _validate(runner, ds.ETH3D(root=root), "eth3d", 1.0,
                     lambda v, f: v >= 0.5, pixel_pool_d1=False,
                     max_images=max_images)


def validate_kitti(runner: InferenceRunner, root: str = "datasets/KITTI",
                   max_images: Optional[int] = None) -> Dict[str, float]:
    """KITTI-2015 training split; also the FPS harness."""
    return _validate(runner, ds.KITTI(root=root), "kitti", 3.0,
                     lambda v, f: v >= 0.5, pixel_pool_d1=True, timed=True,
                     max_images=max_images)


def validate_things(runner: InferenceRunner, root: str = "datasets",
                    dstype: str = "frames_finalpass",
                    max_images: Optional[int] = None) -> Dict[str, float]:
    """FlyingThings3D TEST subset."""
    return _validate(
        runner, ds.SceneFlow(root=root, dstype=dstype, things_test=True),
        "things", 1.0,
        lambda v, f: (v >= 0.5) & (np.abs(f) < 192),
        pixel_pool_d1=True, max_images=max_images)


def validate_middlebury(runner: InferenceRunner,
                        root: str = "datasets/Middlebury", split: str = "F",
                        max_images: Optional[int] = None) -> Dict[str, float]:
    """MiddEval3 training set; the valid mask keeps OCCLUDED pixels
    (valid >= -0.5 passes the 0/1 nocc mask entirely) and drops only
    unknown-GT pixels (flow > -1000)."""
    return _validate(
        runner, ds.Middlebury(root=root, split=split),
        f"middlebury{split}", 2.0,
        lambda v, f: (v >= -0.5) & (f > -1000),
        pixel_pool_d1=False, max_images=max_images)
