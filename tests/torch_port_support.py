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


# A settling GRU (the early-exit tests): the candidate state q and the
# update gate's input weights zeroed, the update gate held at
# sigmoid(SETTLE_Z_BIAS) and the flow head's biases zeroed, so every hidden
# state decays by 1 - sigmoid(-1) = 0.73 an iteration and the disparity
# updates shrink geometrically, as a trained network's settle; random
# weights make them grow.  Everything else keeps its random weights.
SETTLE_Z_BIAS = -1.0


def settle_state(state):
    """A copy of a port state dict with the settling GRU."""
    state = {k: v.clone() for k, v in state.items()}
    for key in list(state):
        if key.endswith((".convq.weight", ".convq.bias",
                         "flow_head.conv1.bias", "flow_head.conv2.bias")):
            state[key].zero_()
        elif key.endswith(".convzr.weight") or key.endswith(".convzr.bias"):
            n = state[key].shape[0] // 2
            state[key][:n] = SETTLE_Z_BIAS if key.endswith("bias") else 0
        elif key.startswith("context_zqr_conv"):
            n = state[key].shape[0] // 3
            state[key][:n] = 0        # cz
            state[key][2 * n:] = 0    # cq
    return state


def settle_jax(variables):
    """``settle_state`` on a numpy JAX variables tree (a copy)."""
    import copy

    v = copy.deepcopy(variables)
    p = v["params"]
    for name, mod in p["update_block"].items():
        if name.startswith("gru"):
            mod["convq"]["kernel"][...] = 0
            mod["convq"]["bias"][...] = 0
            n = mod["convzr"]["bias"].shape[0] // 2
            mod["convzr"]["kernel"][..., :n] = 0
            mod["convzr"]["bias"][:n] = SETTLE_Z_BIAS
    for conv in p["update_block"]["flow_head"].values():
        conv["bias"][...] = 0
    for name, conv in p.items():
        if name.startswith("context_zqr_conv"):
            n = conv["bias"].shape[0] // 3
            conv["kernel"][..., :n] = 0
            conv["bias"][:n] = 0
            conv["kernel"][..., 2 * n:] = 0
            conv["bias"][2 * n:] = 0
    return v


def ulp_up(variables):
    """A JAX variables tree with every fp32 leaf moved up by one ulp: the
    parity tests' probe of a step's own sensitivity on the host."""
    import jax

    def up(x):
        a = np.asarray(x)
        if a.dtype != np.float32:
            return x
        return (a * np.float32(1 + 2.0 ** -23)).astype(np.float32)
    return jax.tree_util.tree_map(up, variables)
