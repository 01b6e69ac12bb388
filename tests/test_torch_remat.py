"""Selective checkpointing of the training iteration (``remat_save``
"gru_gates" and "motion_features", models/remat.py) against the JAX
package and against the port's default policy (CPU).

* The train-mode forward of each new ``remat_save`` equals the JAX
  model's under the same ``remat_save`` within the port's whole-forward
  tolerance, 2e-3 px (TINY, 64x96, 2 iterations, seeded Flax weights).
* A kept value is the value the recompute would give, so every policy's
  loss gradient equals the default policy's bit for bit (``torch.equal``),
  on the fused and the plain gate paths and under bf16.
* What the backward skips: per training step, the gate op's calls (3 per
  iteration forward, 3 more in the recompute unless "gru_gates" keeps
  them) and the motion encoder's (once per iteration with
  "motion_features", twice without).
* ``telemetry/flops.py``'s training-step count equals
  ``FlopCounterMode``'s for each policy.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from raft_stereo_tpu.config import RaftStereoConfig as JaxConfig
from raft_stereo_tpu.models.raft_stereo import RAFTStereo as JaxRAFTStereo
from raft_stereo_tpu_torch.config import RaftStereoConfig, TrainConfig
from raft_stereo_tpu_torch.data.synthetic import SyntheticStereoLoader
from raft_stereo_tpu_torch.io.jax_weights import state_dict_from_jax
from raft_stereo_tpu_torch.kernels import gru_fused
from raft_stereo_tpu_torch.models import extractor, remat
from raft_stereo_tpu_torch.models.raft_stereo import RAFTStereo
from raft_stereo_tpu_torch.telemetry.flops import train_step_flops
from raft_stereo_tpu_torch.training.state import create_train_state
from raft_stereo_tpu_torch.training.step import train_step
from torch_port_support import perturb

TINY = dict(hidden_dims=(32, 32, 32), fnet_dim=64)
HW = (64, 96)
ITERS = 2
FLOW_ATOL = 2e-3          # the port's whole-forward tolerance
DEFAULT_SAVES = ("corr_lookup",)
NEW_SAVES = [("gru_gates",), ("corr_lookup", "gru_gates"),
             ("motion_features",), ("corr_lookup", "motion_features"),
             ("corr_lookup", "gru_gates", "motion_features")]
BASES = {
    "default": RaftStereoConfig(**TINY),
    "default_unfused": RaftStereoConfig(fused_gru="off", **TINY),
    "realtime": dataclasses.replace(RaftStereoConfig.realtime(), **TINY),
}


def _ids(saves):
    return "+".join(saves) or "none"


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _pair(seed=3):
    left = np.random.default_rng(seed).integers(0, 256, HW + (3,),
                                                dtype=np.uint8)
    return left, np.roll(left, -3, axis=1)


@pytest.fixture(scope="module")
def jax_variables():
    jcfg = JaxConfig(**TINY)
    dummy = jnp.zeros((1, 32, 32, 3), jnp.float32)
    init = jax.jit(lambda key: JaxRAFTStereo(jcfg).init(
        key, dummy, dummy, iters=1, test_mode=True))
    return perturb(init(jax.random.PRNGKey(0)), np.random.default_rng(7))


@pytest.mark.parametrize("saves", NEW_SAVES, ids=_ids)
def test_train_forward_matches_jax_under_the_same_policy(jax_variables,
                                                         saves):
    jcfg = JaxConfig(**TINY, remat_save=saves)
    left, right = _pair()
    want = np.asarray(jax.jit(lambda v, a, b: JaxRAFTStereo(jcfg).apply(
        v, a, b, iters=ITERS, test_mode=False))(
        jax_variables, jnp.asarray(left[None], jnp.float32),
        jnp.asarray(right[None], jnp.float32)))
    model = RAFTStereo(RaftStereoConfig.from_dict(dataclasses.asdict(jcfg)))
    model.load_state_dict(state_dict_from_jax(jax_variables), strict=True)
    flows = model(torch.from_numpy(left[None]), torch.from_numpy(right[None]),
                  iters=ITERS, test_mode=False)
    assert flows.grad_fn is not None
    assert flows.shape == want.shape == (ITERS, 1) + HW
    np.testing.assert_allclose(flows.detach().numpy(), want, atol=FLOW_ATOL,
                               rtol=0)


def _step(cfg, weights, counts=None):
    """One ``train_step`` on a seeded batch: (loss, grad_norm, gradients),
    the gate op's and the motion encoder's calls counted in ``counts``."""
    tc = TrainConfig(batch_size=2, train_iters=ITERS, image_size=HW)
    state = create_train_state(cfg, tc, "cpu", state_dict=weights)
    batch = SyntheticStereoLoader(2, HW, shift=3, seed=5).batch(0)
    hooks = []
    if counts is not None:
        enc = state.model.update_block.encoder
        hooks.append(enc.register_forward_hook(
            lambda *a: counts.__setitem__("motion", counts["motion"] + 1)))
    state, metrics = train_step(state, batch, iters=ITERS, loss_gamma=0.9,
                                max_flow=700.0)
    for h in hooks:
        h.remove()
    return ({k: float(v) for k, v in metrics.items()},
            {n: p.grad.clone() for n, p in state.model.named_parameters()})


@pytest.fixture(scope="module")
def reference_steps():
    """name -> (weights, metrics, gradients) of the default policy."""
    out = {}
    for name, base in BASES.items():
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            weights = RAFTStereo(base).state_dict()
        out[name] = (weights,) + _step(base, weights)
    return out


@pytest.mark.parametrize("saves", [()] + NEW_SAVES, ids=_ids)
@pytest.mark.parametrize("name", list(BASES))
def test_gradients_bit_equal_to_the_default_policy(reference_steps, name,
                                                   saves):
    weights, want_m, want_g = reference_steps[name]
    cfg = dataclasses.replace(BASES[name], remat_save=saves)
    got_m, got_g = _step(cfg, weights)
    assert got_m == want_m
    assert got_g.keys() == want_g.keys()
    unequal = [n for n in want_g if not torch.equal(got_g[n], want_g[n])]
    assert not unequal, unequal


@pytest.mark.parametrize("saves", [DEFAULT_SAVES, ()] + NEW_SAVES, ids=_ids)
def test_calls_per_step_under_the_policy(reference_steps, monkeypatch,
                                         saves):
    """The gate op runs 3 x iters times in the forward and again in the
    recompute unless "gru_gates" keeps its outputs; the motion encoder
    once per iteration with "motion_features", else twice."""
    counts = {"gates": 0, "motion": 0}
    plain = gru_fused._gates_reference

    def counted(*args):
        counts["gates"] += 1
        return plain(*args)

    monkeypatch.setattr(gru_fused, "_gates_reference", counted)
    weights = reference_steps["default"][0]
    _step(dataclasses.replace(BASES["default"], remat_save=saves), weights,
          counts)
    recompute = 1
    assert counts == {
        "gates": 3 * ITERS * (1 + recompute * ("gru_gates" not in saves)),
        "motion": ITERS * (1 + recompute * ("motion_features" not in saves))}


@pytest.mark.parametrize("saves", [DEFAULT_SAVES, ()] + NEW_SAVES, ids=_ids)
def test_plain_gate_convs_leave_the_recompute(reference_steps, monkeypatch,
                                              saves):
    """On the plain path the gate convs run through
    ``raft_stereo::gate_conv``: 6 per iteration in the forward, 6 more in
    the recompute unless "gru_gates" keeps their outputs."""
    calls = []
    plain = remat._gate_conv_plain
    monkeypatch.setattr(remat, "_gate_conv_plain",
                        lambda *a: calls.append(1) or plain(*a))
    weights = reference_steps["default_unfused"][0]
    _step(dataclasses.replace(BASES["default_unfused"], remat_save=saves),
          weights)
    assert len(calls) == 6 * ITERS * (1 + ("gru_gates" not in saves))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=str)
def test_gate_conv_equals_the_ports_conv2d(dtype):
    """``GateConv2d`` (the ``raft_stereo::gate_conv`` operator) gives the
    port's ``Conv2d`` output and gradients bit for bit."""
    torch.manual_seed(0)
    gate = remat.GateConv2d(24, 16, 3, padding=1)
    base = extractor.Conv2d(24, 16, 3, padding=1)
    base.load_state_dict(gate.state_dict())
    x = torch.randn(2, 24, 9, 11).to(dtype)
    outs, grads = [], []
    for conv in (gate, base):
        xi = x.clone().requires_grad_(True)
        y = conv(xi)
        y.float().square().sum().backward()
        outs.append(y.detach())
        grads.append((xi.grad, conv.weight.grad, conv.bias.grad))
    assert torch.equal(outs[0], outs[1])
    for a, b in zip(*grads):
        assert torch.equal(a, b)


@pytest.mark.parametrize("saves", NEW_SAVES, ids=_ids)
@pytest.mark.parametrize("name", list(BASES))
def test_train_step_flops_equal_the_flop_counter(name, saves):
    cfg = dataclasses.replace(BASES[name], remat_save=saves)
    torch.manual_seed(0)
    model = RAFTStereo(cfg).train()
    gen = torch.Generator().manual_seed(0)
    left = torch.randint(0, 256, (2,) + HW + (3,), generator=gen).float()
    counter = FlopCounterMode(display=False)
    with counter:
        model(left, torch.roll(left, -2, 2), iters=ITERS,
              test_mode=False).float().sum().backward()
    assert counter.get_total_flops() == train_step_flops(cfg, HW, 2, ITERS)


def test_no_policy_without_gru_gates():
    """The default and the motion-only policies pass no ``context_fn``:
    their checkpoint is the plain non-reentrant one."""
    assert remat.context_fn(("corr_lookup",)) is None
    assert remat.context_fn(("corr_lookup", "motion_features")) is None
    assert remat.context_fn(()) is None
    assert remat.context_fn(("gru_gates",)) is not None
