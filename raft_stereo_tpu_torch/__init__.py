"""PyTorch/CUDA port of RAFT-Stereo for NVIDIA Hopper.

The JAX package ``raft_stereo_tpu`` is the reference; this package imports
nothing of it.  The kernels under ``csrc/`` build with ``nvcc`` at first
use (kernels/_build.py).
"""

from raft_stereo_tpu_torch.config import RaftStereoConfig

__all__ = ["RaftStereoConfig"]
