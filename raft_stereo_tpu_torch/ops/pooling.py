"""Average pooling with the reference's divisor semantics.

The divisor is the full window size even at padded borders (torch's
``count_include_pad=True``, the reference's ``pool2x``).  The window is
summed in the input's dtype, one shifted view at a time in row-major
window order, then divided: the JAX package's ``reduce_window`` sum, so
bf16 rounds after every add there and here alike.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def pool2x(x: torch.Tensor) -> torch.Tensor:
    """3x3 stride-2 pad-1 average pool of an NCHW tensor."""
    h, w = x.shape[-2:]
    oh, ow = (h - 1) // 2 + 1, (w - 1) // 2 + 1
    xp = F.pad(x, (1, 1, 1, 1))
    total = None
    for ky in range(3):
        for kx in range(3):
            tap = xp[..., ky:ky + 2 * oh - 1:2, kx:kx + 2 * ow - 1:2]
            total = tap if total is None else total + tap
    return total / 9
