"""Helpers shared by the PyTorch port's parity tests."""

import jax
import numpy as np
import torch


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(
        0, 3, 1, 2)))


def nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def perturb(variables, rng):
    """numpy copy of a Flax variables tree with non-trivial norm leaves:
    frozen-BN mean ~ N(0, 0.1), var ~ U(0.5, 1.5), norm scale ~ 1 +
    N(0, 0.1), norm bias ~ N(0, 0.1)."""
    def walk(tree, path):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v, path + (k,))
                continue
            a = np.array(v, dtype=np.float32)
            in_norm = any(p.startswith("norm") for p in path)
            if k == "mean":
                a = rng.normal(0, 0.1, a.shape).astype(np.float32)
            elif k == "var":
                a = rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
            elif k == "scale" and in_norm:
                a = (1 + rng.normal(0, 0.1, a.shape)).astype(np.float32)
            elif k == "bias" and in_norm:
                a = rng.normal(0, 0.1, a.shape).astype(np.float32)
            out[k] = a
        return out
    return walk(jax.device_get(variables), ())
