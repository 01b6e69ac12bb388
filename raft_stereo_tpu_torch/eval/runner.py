"""Inference runner: host pad -> forward on the device -> unpad.

``InferenceRunner`` runs on the CUDA card unless the caller passes
``device="cpu"``; with no card and no explicit device it raises.  Its
entry sets ``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` to False: the fp32 model is full fp32.
The JAX package asks for HIGHEST precision only in the correlation
volume's einsum, the align-corners resize and its fp32 kernels; its convs
ask for none (single bf16 passes on a TPU, full fp32 on the CPU).  The
port keeps every fp32 conv in full fp32 until a measurement on the card
decides whether TF32 holds the card-vs-CPU tolerances.
The runner always runs a model of its ``effective_config``: it builds one
from the given weights (a model passed in only lends its state dict), on
the device, with the convs cast once to the compute dtype.

``quant`` ("int8" or "int8_mxu"; None keeps the config's own) runs the
quantized inference tier, in the JAX runner's order: ``config.quant`` is
overridden, then ``effective_inference_config`` applies, then the fp32
state dict is quantized here, once (``quant.core.quantize_state_dict``,
with the calibrated conv input scales ``quant_act_scales`` baked into the
packs).  A state dict that is already quantized is used as it is.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Mapping, Optional, Tuple, Union

import numpy as np
import torch

from raft_stereo_tpu_torch.config import RaftStereoConfig
from raft_stereo_tpu_torch.models.raft_stereo import RAFTStereo
from raft_stereo_tpu_torch.ops.padding import InputPadder
from raft_stereo_tpu_torch.quant.core import is_quantized, quantize_state_dict

log = logging.getLogger(__name__)

# GRU depth from which bf16 correlation drifts on trained weights, so
# inference at or past it turns ``corr_fp32`` on (as the JAX package does).
DEEP_ITERS_FP32_CORR = 16


def effective_inference_config(config: RaftStereoConfig, iters: int,
                               corr_fp32_auto: bool = True
                               ) -> RaftStereoConfig:
    """The config an inference path runs: deep-iteration bf16 correlation
    gets ``corr_fp32`` switched on."""
    if (corr_fp32_auto and iters >= DEEP_ITERS_FP32_CORR
            and config.mixed_precision and not config.corr_fp32):
        log.warning("iters=%d >= %d with bf16 correlation: enabling "
                    "corr_fp32 for this runner", iters, DEEP_ITERS_FP32_CORR)
        return dataclasses.replace(config, corr_fp32=True)
    return config


def full_fp32() -> None:
    """No TF32 in matmuls or cuDNN convs: the fp32 path is full fp32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: Optional[Union[str, torch.device]]
                   ) -> torch.device:
    """``None`` means the CUDA card, and raises when there is none."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the GPU; pass "
                "device='cpu' to run the plain versions on the CPU")
        return torch.device("cuda")
    return torch.device(device)


class InferenceRunner:
    """``runner(image1, image2)`` -> ``(flow (H, W), seconds)``.

    Inputs are (H, W, 3) uint8 or float numpy images; padding to
    ``divis_by``, the test-mode forward and exact unpadding happen inside.
    ``corr_fp32_auto`` (default on) turns ``corr_fp32`` on for bf16
    correlation at ``iters >= DEEP_ITERS_FP32_CORR``
    (``effective_inference_config``); pass False to run raw bf16
    correlation at any depth.  ``quant`` and ``quant_act_scales`` run the
    quantized tier (module docstring).
    """

    def __init__(self, config: RaftStereoConfig,
                 state_dict_or_model: Union[Mapping[str, torch.Tensor],
                                            RAFTStereo],
                 iters: int = 32, divis_by: int = 32,
                 device: Optional[Union[str, torch.device]] = None,
                 corr_fp32_auto: bool = True, quant: Optional[str] = None,
                 quant_act_scales: Optional[Mapping[str, float]] = None):
        self.device = resolve_device(device)
        full_fp32()
        self.config = config
        if quant is not None:
            config = dataclasses.replace(config, quant=quant)
        self.effective_config = effective_inference_config(
            config, iters, corr_fp32_auto)
        state = (state_dict_or_model.state_dict()
                 if isinstance(state_dict_or_model, RAFTStereo)
                 else state_dict_or_model)
        if self.effective_config.quant != "off" and not is_quantized(state):
            state = quantize_state_dict(state, act_scales=quant_act_scales)
        model = RAFTStereo(self.effective_config)
        model.load_state_dict(state, strict=True)
        self.model = model.to(self.device).eval().cast_weights_()
        self.iters = iters
        self.divis_by = divis_by

    def __call__(self, image1: np.ndarray, image2: np.ndarray
                 ) -> Tuple[np.ndarray, float]:
        """Returns ``(flow, seconds)``: flow is the (H, W) x-flow
        (= -disparity); seconds run from the host pad to the end of the
        device->host copy of the result."""
        if image1.ndim != 3 or image1.shape != image2.shape:
            raise ValueError(f"expected two (H, W, 3) images of one shape, "
                             f"got {image1.shape} and {image2.shape}")
        t0 = time.perf_counter()
        padder = InputPadder((1, 3) + image1.shape[:2],
                             divis_by=self.divis_by)
        l, r, t, b = padder.pads
        spec = ((t, b), (l, r), (0, 0))
        p1 = torch.from_numpy(np.pad(np.asarray(image1), spec, mode="edge"))
        p2 = torch.from_numpy(np.pad(np.asarray(image2), spec, mode="edge"))
        with torch.inference_mode():
            _, flow_up = self.model(p1[None].to(self.device),
                                    p2[None].to(self.device),
                                    iters=self.iters, test_mode=True)
            flow = padder.unpad(flow_up)[0].cpu().numpy()
        return np.ascontiguousarray(flow, dtype=np.float32), \
            time.perf_counter() - t0

    def disparity(self, image1: np.ndarray, image2: np.ndarray) -> np.ndarray:
        """Positive disparity map (-flow)."""
        flow, _ = self(image1, image2)
        return -flow
