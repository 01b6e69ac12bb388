"""Post-training calibration: activation ranges for the int8 tier.

The port's own copy of the JAX package's ``quant/calibrate.py``, with the
same record and file format (``SCALES_VERSION`` 1), so a scale file
written by either package loads into the other.  ``calibrate`` runs the
unquantized encoders over a few (left, right) pairs, padded as the
runner pads them, and records per site the percentile-clipped |value|:

* ``corr_levels``: the levels of the fp32 correlation pyramid, the
  scales of the 1-byte pyramid (``corr_scales`` ->
  ``RaftStereoConfig.quant_corr_scales``);
* ``features``: ``fmap1`` and the W-pooled ``fmap2`` levels;
* ``activations``: every encoder module's output, under the Flax path
  with the pass's prefix (``"fnet/fnet/trunk/conv1"``), and every encoder
  conv's input as ``<path>/qin`` (``conv_input_scales`` -> the
  ``quant_act_scales`` of the runner).  The passes are the JAX package's:
  the shared backbone runs ``cnet``, ``conv2_res`` and ``conv2_out`` on
  both images under the prefix "cnet"; otherwise ``fnet`` runs on both
  images ("fnet") and ``cnet`` on the left one ("cnet").  The
  ``context_zqr_conv*`` convs run in no pass, so they get no ``qin``
  entry and stay on dynamic scales.

Values are captured with forward hooks; the same pairs give a
byte-identical file.
"""

from __future__ import annotations

import dataclasses
import json
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterable, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn as nn

from raft_stereo_tpu_torch.config import RaftStereoConfig
from raft_stereo_tpu_torch.quant.core import clipped_scale, in_encoder_scope

SCALES_VERSION = 1
DEFAULT_PERCENTILE = 99.9


def _percentile_absmax(values: List[np.ndarray], percentile: float) -> float:
    flat = np.concatenate([np.asarray(v, np.float32).ravel()
                           for v in values])
    np.abs(flat, out=flat)
    return float(np.percentile(flat, percentile, overwrite_input=True))


def _percentiles_absmax(groups: List[List[np.ndarray]], percentile: float
                        ) -> List[float]:
    """``_percentile_absmax`` of each group, on a thread per core (numpy's
    partition releases the GIL): the record's host time at full size."""
    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as pool:
        return list(pool.map(lambda v: _percentile_absmax(v, percentile),
                             groups))


def _arrays(out) -> List[np.ndarray]:
    """Every tensor of a module's (nested) output as fp32 numpy."""
    if isinstance(out, torch.Tensor):
        return [out.detach().float().cpu().numpy()]
    return [a for item in out for a in _arrays(item)]


def calibrate(config: RaftStereoConfig, state_dict: Mapping[str, torch.Tensor],
              pairs: Iterable[Tuple[np.ndarray, np.ndarray]],
              percentile: float = DEFAULT_PERCENTILE, divis_by: int = 32,
              device: Optional[Union[str, torch.device]] = None) -> Dict:
    """The scale record of ``pairs`` of (H, W, 3) images, from the fp32
    state dict, with the unquantized model (``quant`` forced off) in the
    config's compute dtype.  ``device`` as for ``InferenceRunner``: the
    card unless the caller asks for the CPU."""
    from raft_stereo_tpu_torch.eval.runner import full_fp32, resolve_device
    from raft_stereo_tpu_torch.models.corr import (build_corr_pyramid,
                                                   build_corr_volume,
                                                   pool_axis)
    from raft_stereo_tpu_torch.models.raft_stereo import RAFTStereo
    from raft_stereo_tpu_torch.ops.padding import InputPadder

    device = resolve_device(device)
    full_fp32()
    cfg = dataclasses.replace(config, quant="off")
    model = RAFTStereo(cfg)
    model.load_state_dict(state_dict, strict=True)
    model = model.to(device).eval().cast_weights_()
    dtype = model.compute_dtype

    level_vals: List[List[np.ndarray]] = [[] for _ in range(cfg.corr_levels)]
    f1_vals: List[np.ndarray] = []
    f2_level_vals: List[List[np.ndarray]] = [[] for _ in
                                             range(cfg.corr_levels)]
    act_vals: Dict[str, List[np.ndarray]] = {}
    prefix = [""]

    def out_hook(path):
        def hook(module, inputs, out):
            act_vals.setdefault(f"{prefix[0]}/{path}", []).extend(
                _arrays(out))
        return hook

    def in_hook(path):
        def hook(module, inputs):
            act_vals.setdefault(f"{prefix[0]}/{path}/qin", []).extend(
                _arrays(inputs[0]))
        return hook

    handles = []
    for name, m in model.named_modules():
        if not name or not in_encoder_scope(name) or isinstance(
                m, nn.Identity):
            continue
        path = name.replace(".", "/")
        handles.append(m.register_forward_hook(out_hook(path)))
        if isinstance(m, nn.Conv2d):
            handles.append(m.register_forward_pre_hook(in_hook(path)))

    def fmaps(img1: torch.Tensor, img2: torch.Tensor):
        x1, x2 = [(2 * (im / 255.0) - 1.0).to(dtype).permute(0, 3, 1, 2)
                  for im in (img1, img2)]
        both = torch.cat([x1, x2])
        if cfg.shared_backbone:
            prefix[0] = "cnet"
            _, v = model.cnet(both)
            fmap = model.conv2_out(model.conv2_res(v))
        else:
            prefix[0] = "fnet"
            fmap = model.fnet(both)
            prefix[0] = "cnet"
            model.cnet(x1)
        return torch.chunk(fmap, 2)

    n_pairs = 0
    try:
        with torch.inference_mode():
            for left, right in pairs:
                left, right = np.asarray(left), np.asarray(right)
                padder = InputPadder((1, 3) + left.shape[:2],
                                     divis_by=divis_by)
                pl, pr, pt, pb = padder.pads
                spec = ((pt, pb), (pl, pr), (0, 0))
                p1, p2 = [torch.from_numpy(np.pad(im, spec, mode="edge")[
                    None].astype(np.float32)).to(device)
                    for im in (left, right)]
                f1, f2 = fmaps(p1, p2)
                f1_vals.append(f1.float().cpu().numpy())
                pyramid = build_corr_pyramid(
                    build_corr_volume(f1.float(), f2.float()),
                    cfg.corr_levels)
                f2_lvl = f2
                for i, vol in enumerate(pyramid):
                    level_vals[i].append(vol.cpu().numpy())
                    f2_level_vals[i].append(f2_lvl.float().cpu().numpy())
                    if i + 1 < cfg.corr_levels:
                        f2_lvl = pool_axis(f2_lvl, axis=3)
                n_pairs += 1
    finally:
        for h in handles:
            h.remove()
    if n_pairs == 0:
        raise ValueError("calibration needs at least one (left, right) "
                         "pair")
    sites = sorted(act_vals)
    levels = cfg.corr_levels
    clipped = [round(v, 8) for v in _percentiles_absmax(
        level_vals + [f1_vals] + f2_level_vals
        + [act_vals[site] for site in sites], percentile)]
    return {
        "version": SCALES_VERSION,
        "mode": "int8",
        "percentile": percentile,
        "n_pairs": n_pairs,
        "config": json.loads(cfg.to_json()),
        "corr_levels": clipped[:levels],
        "features": {
            "fmap1": clipped[levels],
            "fmap2_levels": clipped[levels + 1:2 * levels + 1]},
        "activations": {
            site: {"absmax_clipped": v}
            for site, v in zip(sites, clipped[2 * levels + 1:])},
    }


def conv_input_scales(record: Dict) -> Dict[str, float]:
    """Per-conv input scales of one record, keyed by "/"-joined module
    paths (``"fnet/trunk/conv1"``): the ``qin`` sites with their pass
    prefix and ``/qin`` stripped; a path seen by two passes keeps the
    wider range."""
    absmax: Dict[str, float] = {}
    for site, entry in record.get("activations", {}).items():
        parts = site.split("/")
        if parts[-1] != "qin" or len(parts) < 3:
            continue
        path = "/".join(parts[1:-1])
        absmax[path] = max(absmax.get(path, 0.0),
                           float(entry["absmax_clipped"]))
    return {path: clipped_scale(v) for path, v in absmax.items()}


def corr_scales(record: Dict) -> Tuple[float, ...]:
    """The per-level scales of the 1-byte pyramid
    (``RaftStereoConfig.quant_corr_scales``)."""
    return tuple(clipped_scale(v) for v in record["corr_levels"])


def save_scales(path: str, record: Dict) -> str:
    """Write the scale file beside a checkpoint: atomic, keys sorted, so
    identical calibrations give byte-identical files."""
    blob = json.dumps(record, indent=1, sort_keys=True)
    tmp = f"{path}.tmp-{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(blob + "\n")
    os.replace(tmp, path)
    return path


def load_scales(path: str) -> Dict:
    with open(path) as f:
        record = json.load(f)
    if record.get("version") != SCALES_VERSION:
        raise ValueError(
            f"scale file {path}: version {record.get('version')!r} != "
            f"{SCALES_VERSION} (recalibrate with this build)")
    if record.get("mode") != "int8":
        raise ValueError(f"scale file {path}: mode "
                         f"{record.get('mode')!r} is not 'int8'")
    return record
