"""Whose fault is a failing int8 drift gate: the port's or the tier's?

    JAX_PLATFORMS=cpu python tests/torch_drift_attribution.py \\
        --state STATE.pt --scales QUANT_SCALES.json [--iters 32]

Runs the same weights (a port state dict saved by
``python -m raft_stereo_tpu_torch.tools.quant_drift --save_state``) and
the same calibration record (its scale file) through the JAX package's
drift harness (``tools/drift_common.evaluate_variants``) and the port's
(``eval/drift.py``), both on the CPU, for the variants ``fp32``, ``int8``,
``int8_w`` and ``int8_mxu`` (each side quantizing the state with the
record's conv input scales) over the hermetic architecture's band scenes
at 384x1248, and prints both rows.  Equal rows put a failing gate on the
tier (the 1-byte pyramid and the int8 activations with these scales), not
on the port.  Takes minutes on the CPU.
"""

import argparse
import dataclasses
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(os.path.dirname(HERE), "tools"))


def jax_variables(state, template):
    """A JAX variables tree of ``state``'s values in ``template``'s
    layout: the inverse of ``io/jax_weights.state_dict_from_jax``."""
    def fill(tree, prefix=()):
        out = {}
        for key, leaf in tree.items():
            path = prefix + (key,)
            if isinstance(leaf, dict):
                out[key] = fill(leaf, path)
                continue
            if key == "kernel":
                out[key] = state[".".join(path[:-1] + ("weight",))].numpy(
                    ).transpose(2, 3, 1, 0)
            else:
                out[key] = state[".".join(path)].numpy()
            if out[key].shape != leaf.shape:
                raise ValueError(f"{path}: {out[key].shape} != {leaf.shape}")
        return out
    return {c: fill(template[c]) for c in template}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--state", required=True)
    ap.add_argument("--scales", required=True)
    ap.add_argument("--hw", default="384x1248")
    ap.add_argument("--bands", default="96",
                    help="the band ceilings to run (the full run's scenes "
                         "of these bands, drawn after 48/96/192's)")
    ap.add_argument("--iters", default="32")
    args = ap.parse_args(argv)

    import jax
    import torch

    import drift_common
    import early_exit_report
    from raft_stereo_tpu import quant as jquant
    from raft_stereo_tpu_torch.config import RaftStereoConfig
    from raft_stereo_tpu_torch.eval import drift
    from raft_stereo_tpu_torch.quant.calibrate import (conv_input_scales,
                                                       corr_scales,
                                                       load_scales)
    from raft_stereo_tpu_torch.quant.core import quantize_state_dict

    state = torch.load(args.state, map_location="cpu")
    record = load_scales(args.scales)
    jcfg = early_exit_report.model_config()
    variables = jax_variables(state, jax.device_get(
        early_exit_report.init_variables(jcfg)))
    h, w = (int(x) for x in args.hw.split("x"))
    scenes = drift.make_band_scenes(h, w, None, n_per_band=2, seed=11)
    scenes = {f"d<={b}": scenes[f"d<={b}"] for b in args.bands.split(",")}
    iters = [int(x) for x in args.iters.split(",")]
    cfg = RaftStereoConfig.from_json(jcfg.to_json())

    def variants(c, weights, scales, mxu_weights):
        int8 = dataclasses.replace(c, quant="int8", quant_corr_scales=scales)
        return {"fp32": (c, weights), "int8": (int8, weights),
                "int8_w": (dataclasses.replace(int8, quant_corr=False),
                           weights),
                "int8_mxu": (dataclasses.replace(int8, quant="int8_mxu"),
                             mxu_weights)}

    port = drift.evaluate_variants(
        "int8_epe_drift", "given_state",
        variants(cfg, state, corr_scales(record), quantize_state_dict(
            state, act_scales=conv_input_scales(record))),
        scenes, iters, "fp32", "int8",
        {"corr_fp32_auto": False, "device": "cpu"})
    ref = drift_common.evaluate_variants(
        "int8_epe_drift", "given_state",
        variants(jcfg, variables, tuple(jquant.corr_scales(record)),
                 jquant.quantize_variables(
                     variables,
                     act_scales=jquant.conv_input_scales(record))),
        scenes, iters, "fp32", "int8", {"corr_fp32_auto": False})
    print(json.dumps({"port_cpu": port, "jax_cpu": ref}))


if __name__ == "__main__":
    main()
