"""Average pooling with the reference's divisor semantics.

``F.avg_pool2d`` defaults to ``count_include_pad=True``: the divisor is the
full window size even at padded borders, which is what the reference's
``pool2x`` uses.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def pool2x(x: torch.Tensor) -> torch.Tensor:
    """3x3 stride-2 pad-1 average pool of an NCHW tensor."""
    return F.avg_pool2d(x, 3, stride=2, padding=1, count_include_pad=True)
