"""Print the port's FLOP formulas beside XLA's own count (CPU).

    JAX_PLATFORMS=cpu python tests/torch_costs_vs_xla.py

For the TINY default and realtime architectures (hidden 32, fnet 64) at
64x96, batch 2, 2 iterations: the test-mode forward and one training
step, each as ``telemetry/flops.py`` counts it (2 x MACs of every conv
and matmul, ``FlopCounterMode``'s convention, tests/test_torch_costs.py)
and as XLA's ``cost_analysis`` counts the JAX package's compiled program
(which also counts elementwise operations, and whatever XLA fuses or
rewrites).  Not a test: the two conventions differ by design.
"""

import dataclasses
import json
import os
import sys

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from raft_stereo_tpu.config import RaftStereoConfig as JaxConfig  # noqa: E402
from raft_stereo_tpu.config import TrainConfig as JaxTrainConfig  # noqa: E402
from raft_stereo_tpu.models.raft_stereo import RAFTStereo  # noqa: E402
from raft_stereo_tpu.telemetry.costs import executable_cost  # noqa: E402
from raft_stereo_tpu.training.state import create_train_state  # noqa: E402
from raft_stereo_tpu.training.step import make_train_step  # noqa: E402
from raft_stereo_tpu_torch.config import RaftStereoConfig  # noqa: E402
from raft_stereo_tpu_torch.data.synthetic import (  # noqa: E402
    SyntheticStereoLoader)
from raft_stereo_tpu_torch.telemetry.flops import (  # noqa: E402
    forward_flops, train_step_flops)

TINY = dict(hidden_dims=(32, 32, 32), fnet_dim=64)
HW, BATCH, ITERS = (64, 96), 2, 2


def xla_flops(compiled) -> float:
    return executable_cost(compiled)["flops"]


def main():
    rows = []
    for name, jcfg in (
            ("default", JaxConfig(**TINY)),
            ("realtime", dataclasses.replace(JaxConfig.realtime(), **TINY,
                                             mixed_precision=False))):
        cfg = RaftStereoConfig.from_json(jcfg.to_json())
        model = RAFTStereo(jcfg)
        img = jnp.zeros((BATCH, *HW, 3), jnp.float32)
        variables = model.init(jax.random.PRNGKey(0), img[:1], img[:1],
                               iters=1, test_mode=True)
        fwd = jax.jit(lambda v, a, b: model.apply(v, a, b, iters=ITERS,
                                                  test_mode=True)[1])
        tc = JaxTrainConfig(batch_size=BATCH, image_size=HW,
                            train_iters=ITERS)
        state = create_train_state(jcfg, tc, jax.random.PRNGKey(0),
                                   image_shape=(1, *HW, 3))
        batch = {k: jnp.asarray(v) for k, v in SyntheticStereoLoader(
            BATCH, HW, seed=0).batch(0).items()}
        step = make_train_step(tc, donate=False)
        rows.append({
            "config": name, "hw": HW, "batch": BATCH, "iters": ITERS,
            "forward_port_flops": forward_flops(cfg, HW, BATCH, ITERS),
            "forward_xla_flops": xla_flops(
                fwd.lower(variables, img, img).compile()),
            "train_step_port_flops": train_step_flops(cfg, HW, BATCH, ITERS),
            "train_step_xla_flops": xla_flops(
                step.lower(state, batch).compile()),
        })
        print(json.dumps(rows[-1]), flush=True)
    return rows


if __name__ == "__main__":
    main()
