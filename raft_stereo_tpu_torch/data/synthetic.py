"""A seeded synthetic stereo loader for training drives and tests.

Each batch is the JAX loader's dict with its compact upload dtypes: the
left image is uniform uint8 noise, the right image is the left shifted
``shift`` pixels to the left (``right[x] = left[x + shift]``, wrapping at
the border), the flow is ``-shift`` in fp16, and ``valid`` (uint8) is 1
except in the ``shift`` leftmost columns, whose match lies outside the
right image.  Batch ``i`` depends only on ``(seed, i)``, so a loader
positioned with ``set_state`` yields what an uninterrupted one would; its
``state``/``set_state`` speak the offset of ``data/loader.StereoLoader``
(no reshuffle salts: the order is fixed).
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np


class SyntheticStereoLoader:
    def __init__(self, batch_size: int, image_size: Tuple[int, int],
                 shift: int = 4, seed: int = 0,
                 num_batches: Optional[int] = None):
        self.batch_size = batch_size
        self.image_size = tuple(image_size)
        self.shift = shift
        self.seed = seed
        self.num_batches = num_batches
        self.start = 0

    def state(self, consumed: int = 0) -> Dict[str, Any]:
        """The position after ``consumed`` batches of the current
        iterator."""
        return {"offset": self.start + consumed, "salts": []}

    def set_state(self, state: Dict[str, Any]) -> None:
        """Start the next iteration at batch ``state["offset"]``."""
        self.start = int(state.get("offset", 0))

    def batch(self, i: int) -> Dict[str, np.ndarray]:
        h, w = self.image_size
        rng = np.random.default_rng([self.seed, i])
        left = rng.integers(0, 256, (self.batch_size, h, w, 3),
                            dtype=np.uint8)
        valid = np.ones((self.batch_size, h, w), np.uint8)
        valid[:, :, :self.shift] = 0
        return {"image1": left,
                "image2": np.roll(left, -self.shift, axis=2),
                "flow": np.full((self.batch_size, h, w), -self.shift,
                                np.float16),
                "valid": valid}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        i = self.start
        while self.num_batches is None or i < self.num_batches:
            yield self.batch(i)
            i += 1
