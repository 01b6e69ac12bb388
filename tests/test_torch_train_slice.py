"""The slice as a whole against the JAX package (CPU): JAX's
``cli/train.main`` and the port's on one tiny SceneFlow tree, from one
reference ``.pth``.  The loaders feed both sides bit-equal batches, so any
gap is the step's, held to tests/test_torch_training.py's tolerances
(the test's docstring)."""

import jax
import numpy as np
import torch

from raft_stereo_tpu.cli import train as jcli
from raft_stereo_tpu.kernels import corr_lookup as jcorr_lookup
from raft_stereo_tpu.training import logger as jlogger
from raft_stereo_tpu.training import train_loop as jloop
from raft_stereo_tpu_torch.cli import train as tcli
from raft_stereo_tpu_torch.io.jax_weights import state_dict_from_jax
from raft_stereo_tpu_torch.training import logger as tlogger
from raft_stereo_tpu_torch.training import train_loop as tloop
from raft_stereo_tpu_torch.training.optimizer import one_cycle_lr
from test_torch_eval import _reference_state_dict
from test_torch_train_loop import (_cli_argv, _jax_variables, few_threads,
                                   tree)

SPREAD_FACTOR = 4.0
# tests/test_torch_training.py's JAX spreads on the loss (2.86e-6) and the
# gradient norm (1.31e-3), over the values they were measured on (13.19,
# 504.8): relative spreads
JAX_LOSS_REL_SPREAD = 2.86e-6 / 13.19
JAX_GRAD_NORM_REL_SPREAD = 1.31e-3 / 504.8

__all__ = ["few_threads", "tree"]   # the fixtures, shared


def test_slice_matches_jax(tree, tmp_path, monkeypatch):
    """JAX's ``cli/train.main`` and the port's on the same tree, seed and
    flags, 2 steps, both warm-started from one reference ``.pth`` (the
    two packages draw their initial weights differently; the CLI's fnet
    is 256 wide): the loaders feed bit-equal batches; each step's loss
    within 4x the JAX package's own spread, taken here as the larger of
    its kernel-vs-plain gap on this run (JAX's CLI run twice), its move
    when every weight is moved by one fp32 ulp (the third JAX run below)
    and tests/test_torch_training.py's relative spread.  The kernel-vs-
    plain gap alone is machine-dependent: 0 on an AMD EPYC host, where
    the port's first-step loss sat 3.05e-5 from JAX's (27.850746) and
    JAX's own one-ulp move was 7.06e-5.

    Each step's gradient norm within 4x the larger of that kernel-vs-plain
    gap, tests/test_torch_training.py's relative spread, and JAX's move
    when every weight of the ``.pth`` is moved by one fp32 ulp (a third
    JAX run): on these random weights the first step's norm is
    ill-conditioned (JAX's own 1839 moves to 2220 under that
    perturbation; the port reads 1871), the second's is not (the three
    agree to 4e-7 relative).

    The final parameters within 2.02 (lr(0) + lr(1)), what sign flips of
    the two AdamW updates can move, and 99.9% of their elements within
    0.1 lr(1) (measured 0.037 lr(1)), which an LR, a count or a moment
    that is off moves by about a whole update."""
    pushed = {}
    batches = {}

    def recorder(mod, key):
        real_push = mod.Logger.push

        def push(self, metrics, lr=0.0):
            pushed.setdefault(key[0], []).append(dict(metrics))
            return real_push(self, metrics, lr=lr)
        monkeypatch.setattr(mod.Logger, "push", push)

    def batch_recorder(mod, key):
        real_init = mod._DevicePrefetcher.__init__

        def init(self, it, put, depth=2):
            def rec(b):
                batches.setdefault(key[0], []).append(
                    {k: np.array(v) for k, v in b.items()})
                return put(b)
            real_init(self, it, rec, depth)
        monkeypatch.setattr(mod._DevicePrefetcher, "__init__", init)

    jkey, tkey = ["jax"], ["port"]
    recorder(jlogger, jkey)
    recorder(tlogger, tkey)
    batch_recorder(jloop, jkey)
    batch_recorder(tloop, tkey)
    variables = _jax_variables(hidden_dims=(32, 32, 32))
    pth = str(tmp_path / "ref.pth")
    torch.save({f"module.{k}": torch.from_numpy(np.array(v))
                for k, v in _reference_state_dict(variables).items()}, pth)
    warm = ["--restore_ckpt", pth, "--lr", "2e-7"]
    jstates = {}
    ulp = str(tmp_path / "ulp.pth")
    torch.save({f"module.{k}": torch.from_numpy(np.array(v)) * (
        1 + 2.0 ** -23 if np.array(v).dtype == np.float32 else 1)
        for k, v in _reference_state_dict(variables).items()}, ulp)
    for kernels, start in ((True, pth), (None, pth), ("ulp", ulp)):
        jkey[0] = f"jax {kernels}"
        jcorr_lookup._interpret_override = bool(kernels) or None
        try:
            jstates[kernels] = jcli.main(
                _cli_argv(tree, str(tmp_path / f"jax{kernels}"))
                + ["--restore_ckpt", start, "--lr", "2e-7"])
        finally:
            jcorr_lookup._interpret_override = None
    state = tcli.main(_cli_argv(tree, str(tmp_path / "port")) + warm
                      + ["--device", "cpu"])
    for a, b in zip(batches["jax True"][:2], batches["port"][:2]):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    jl = [m["loss"] for m in pushed["jax True"]]
    spread = [max(abs(a["loss"] - b["loss"]), abs(a["loss"] - u["loss"]))
              for a, b, u in zip(pushed["jax True"], pushed["jax None"],
                                 pushed["jax ulp"])]
    pl = [m["loss"] for m in pushed["port"]]
    assert len(jl) == len(pl) == len(spread) == 2
    for got, want, s in zip(pl, jl, spread):
        assert abs(got - want) <= SPREAD_FACTOR * max(
            s, JAX_LOSS_REL_SPREAD * abs(want))
    for j, jp, ju, p in zip(*(pushed[k] for k in ("jax True", "jax None",
                                                  "jax ulp", "port"))):
        want = float(j["grad_norm"])
        spread = max(abs(float(jp["grad_norm"]) - want),
                     abs(float(ju["grad_norm"]) - want),
                     JAX_GRAD_NORM_REL_SPREAD * want)
        assert abs(float(p["grad_norm"]) - want) <= SPREAD_FACTOR * spread
    sched = one_cycle_lr(2e-7, 2 + 100)
    bound = 2.02 * (sched(0) + sched(1))
    want = state_dict_from_jax({"params": jax.device_get(
        jstates[True].params)})
    for name, p in state.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   atol=bound, rtol=0, err_msg=name)
    gaps = np.concatenate([np.abs(p.detach().numpy()
                                  - want[name].numpy()).ravel()
                           for name, p in state.model.named_parameters()])
    assert np.quantile(gaps, 0.999) <= 0.1 * sched(1)
