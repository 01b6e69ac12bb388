"""Helpers shared by the PyTorch port's tests.  JAX is imported only
where a helper needs it, so the card's tests (no JAX there) can use the
rest."""

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
    import jax

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


def _f32(a):
    if isinstance(a, torch.Tensor):
        a = a.detach().float().cpu().numpy()
    return np.asarray(a, dtype=np.float32)


def assert_bf16_close(got, want, ulps=1, atol=1e-5):
    """|got - want| <= ``ulps`` bf16 ulps of ``want`` plus ``atol``: two
    computations that sum fp32 products in another order and round once to
    bf16 may land on neighbouring bf16 values; ``atol`` covers values near
    zero, where the fp32 sum-order error exceeds a bf16 ulp of the value.
    Takes numpy arrays or tensors (of any dtype and device)."""
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape
    exp = np.floor(np.log2(np.maximum(np.abs(want), np.finfo(np.float32).tiny)))
    bound = ulps * 2.0 ** (exp - 7) + atol
    err = np.abs(got - want)
    bad = err > bound
    assert not bad.any(), (
        f"{bad.sum()} of {bad.size} values beyond {ulps} bf16 ulp + {atol}: "
        f"max error {err.max():.3e}")
