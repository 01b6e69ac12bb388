"""Timing: the reference's FPS protocol.

``FpsProtocol`` runs a callable per input, discards the first ``warmup``
timings (the reference's 50-image discard, which absorbs cuDNN
autotuning there and the CUDA graph captures here) and reports 1/mean of
the rest.  The stop clock is the callable's host result: the runner
returns numpy arrays that were copied from the card, so the time covers
the device work.  A callable that returns a tensor has it copied to the
host inside the clock.  The JAX package's ``trace``/``annotate`` wait for
ROADMAP §D9.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Iterable, List, Tuple

import numpy as np
import torch


@dataclass
class FpsResult:
    fps: float
    mean_s: float
    per_image_s: List[float]
    n_timed: int

    def __str__(self):
        return f"{self.fps:.2f} fps (mean {self.mean_s * 1e3:.2f} ms over " \
               f"{self.n_timed} images)"


class FpsProtocol:
    """The reference's KITTI FPS protocol: run ``fn`` per image, discard
    the first ``warmup`` timings, report 1/mean of the rest."""

    def __init__(self, warmup: int = 50):
        self.warmup = warmup

    def measure(self, fn: Callable[..., object],
                inputs: Iterable[Tuple]) -> FpsResult:
        times: List[float] = []
        n = 0
        for args in inputs:
            t0 = time.perf_counter()
            out = fn(*args)
            if isinstance(out, torch.Tensor):
                out.cpu()  # the copy to the host waits for the device
            elapsed = time.perf_counter() - t0
            n += 1
            if n > self.warmup:
                times.append(elapsed)
        if not times:
            raise ValueError(
                f"need more than warmup={self.warmup} inputs, got {n}")
        mean = float(np.mean(times))
        return FpsResult(fps=1.0 / mean, mean_s=mean, per_image_s=times,
                         n_timed=len(times))
