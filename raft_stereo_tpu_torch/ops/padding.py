"""Pad inputs to a divisibility constraint and exactly un-pad outputs.

Replicate-mode padding with the 'sintel' (symmetric) or default
(bottom/right-biased) layout.  Tensors are NCHW here, as in the original
PyTorch RAFT-Stereo; the pad amounts equal the JAX package's NHWC
``InputPadder`` for the same image size.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


class InputPadder:
    def __init__(self, dims, mode: str = "sintel", divis_by: int = 8):
        self.ht, self.wd = int(dims[-2]), int(dims[-1])  # NCHW
        pad_ht = (((self.ht // divis_by) + 1) * divis_by - self.ht) % divis_by
        pad_wd = (((self.wd // divis_by) + 1) * divis_by - self.wd) % divis_by
        if mode == "sintel":
            # (left, right, top, bottom)
            self._pad = [pad_wd // 2, pad_wd - pad_wd // 2,
                         pad_ht // 2, pad_ht - pad_ht // 2]
        else:
            self._pad = [pad_wd // 2, pad_wd - pad_wd // 2, 0, pad_ht]

    @property
    def pads(self):
        """(left, right, top, bottom) pad amounts, for host-side padding."""
        return tuple(self._pad)

    def pad(self, *inputs: torch.Tensor):
        out = []
        for x in inputs:
            if x.ndim != 4:
                raise ValueError(f"expected NCHW, got shape {tuple(x.shape)}")
            out.append(F.pad(x, self._pad, mode="replicate"))
        return out

    def unpad(self, x: torch.Tensor) -> torch.Tensor:
        """Exactly undo ``pad`` on the last two (H, W) axes."""
        ht, wd = x.shape[-2:]
        return x[..., self._pad[2]:ht - self._pad[3],
                 self._pad[0]:wd - self._pad[1]]
