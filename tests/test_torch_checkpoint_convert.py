"""``tools/jax_checkpoint_to_torch.py``: a JAX checkpoint into the port's
(CPU).

A JAX ``save_checkpoint`` of TINY variables (Flax init, norm leaves
perturbed, so the batch statistics are not their init values) beside an
optimizer-like leaf and a step goes through the converter; the port's
``cli/common.load_any_checkpoint`` reads the result, its config equals
JAX's ``to_dict()``, and its forward at 2 iterations is within the port's
whole-forward tolerance of JAX's, FLOW_ATOL = 2e-3 px; a context-parallel
configuration converts likewise.  Refusals write nothing: a checkpoint
whose manifest fails, an existing destination.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raft_stereo_tpu.config import RaftStereoConfig as JaxConfig
from raft_stereo_tpu.models.raft_stereo import RAFTStereo as JaxRAFTStereo
from raft_stereo_tpu.training import checkpoint as jckpt
from raft_stereo_tpu_torch.cli.common import load_any_checkpoint
from raft_stereo_tpu_torch.eval.runner import InferenceRunner
from torch_port_support import perturb

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
import jax_checkpoint_to_torch as converter  # noqa: E402

TINY = dict(hidden_dims=(32, 32, 32), fnet_dim=64)
HW = (60, 90)
ITERS = 2
FLOW_ATOL = 2e-3


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    jcfg = JaxConfig(**TINY)
    model = JaxRAFTStereo(jcfg)
    dummy = jnp.zeros((1, 32, 32, 3), jnp.float32)
    init = jax.jit(lambda key: model.init(key, dummy, dummy, iters=1,
                                          test_mode=True))
    variables = perturb(init(jax.random.PRNGKey(0)),
                        np.random.default_rng(7))
    assert variables.get("batch_stats")
    src = str(tmp_path_factory.mktemp("jax") / "ck")
    jckpt.save_checkpoint(src, jcfg, {
        "params": variables["params"],
        "batch_stats": variables["batch_stats"],
        "opt_state": {"mu": np.ones(3, np.float32)},
        "step": np.asarray(5)})
    left = np.random.default_rng(3).integers(0, 256, HW + (3,),
                                             dtype=np.uint8)
    right = np.roll(left, -3, axis=1)
    pad = ((0, 0), (2, 2), (3, 3), (0, 0))
    flow = np.asarray(model.apply(
        variables, jnp.asarray(np.pad(left[None], pad, mode="edge"),
                               jnp.float32),
        jnp.asarray(np.pad(right[None], pad, mode="edge"), jnp.float32),
        iters=ITERS, test_mode=True)[1])[0, 2:-2, 3:-3]
    return dict(jcfg=jcfg, src=src, left=left, right=right, flow=flow)


def test_converted_checkpoint_loads_and_matches_jax(jax_side, tmp_path):
    dst = str(tmp_path / "port")
    assert converter.main([jax_side["src"], dst]) == 0
    cfg, state = load_any_checkpoint(dst)
    assert cfg.to_dict() == jax_side["jcfg"].to_dict()
    assert "cnet.trunk.norm1.mean" in state    # a batch statistic
    runner = InferenceRunner(cfg, state, iters=ITERS, device="cpu")
    flow, _ = runner(jax_side["left"], jax_side["right"])
    assert flow.shape == HW
    np.testing.assert_allclose(flow, jax_side["flow"], atol=FLOW_ATOL,
                               rtol=0)
    assert sorted(os.listdir(tmp_path)) == ["port"]


def test_refused_config_raises_with_the_roadmap_and_writes_nothing(
        tmp_path, jax_side):
    """A context-parallel configuration (``rows_shards=2``), which the
    port refused until it ran the sharded executors, converts: the config
    is JAX's, the weights the unsharded checkpoint's.  A second
    conversion into the written destination is refused and writes
    nothing."""
    src = str(tmp_path / "sharded")
    jcfg = JaxConfig(**TINY, rows_shards=2)
    _, tree = jckpt.load_checkpoint(jax_side["src"])
    jckpt.save_checkpoint(src, jcfg, {"params": tree["params"],
                                      "batch_stats": tree["batch_stats"]})
    dst = str(tmp_path / "out")
    assert converter.main([src, dst]) == 0
    cfg, state = load_any_checkpoint(dst)
    assert cfg.to_dict() == jcfg.to_dict()
    assert converter.main([jax_side["src"], str(tmp_path / "plain")]) == 0
    _, want = load_any_checkpoint(str(tmp_path / "plain"))
    assert state.keys() == want.keys()
    for k in want:
        assert np.array_equal(state[k].numpy(), want[k].numpy()), k
    assert converter.main([src, dst]) == 2
    assert sorted(os.listdir(tmp_path)) == ["out", "plain", "sharded"]


def test_a_failed_manifest_is_refused(tmp_path, jax_side):
    import shutil

    src = str(tmp_path / "ck")
    shutil.copytree(jax_side["src"], src)
    with open(os.path.join(src, "MANIFEST")) as f:
        manifest = json.load(f)
    name = sorted(manifest["files"])[0]
    with open(os.path.join(src, name), "ab") as f:
        f.write(b"\0")
    with pytest.raises(ValueError, match="manifest"):
        converter.convert(src, str(tmp_path / "out"))
    assert sorted(os.listdir(tmp_path)) == ["ck"]


def test_an_existing_destination_is_kept(tmp_path, jax_side):
    dst = tmp_path / "port"
    dst.mkdir()
    (dst / "keep").write_text("x")
    with pytest.raises(FileExistsError):
        converter.convert(jax_side["src"], str(dst))
    assert os.listdir(dst) == ["keep"]
