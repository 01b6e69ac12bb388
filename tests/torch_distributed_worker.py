"""One rank of the port's data-parallel tests (tests/test_torch_distributed.py).

Each process forms a gloo group of ``world`` ranks over
``tcp://localhost:<port>`` and trains on the CPU at TINY widths.  Modes:

* ``steps``: two steps of ``training/step.py`` on a model wrapped in
  ``DistributedDataParallel``, from the weights in ``<weights.pt>``, over
  seeded global batches of 8 of which this rank takes its slice;
  ``jitter`` turns on the device photometric jitter.  Writes the losses,
  metrics and final parameters.
* ``loop``: ``training/train_loop.train`` over a ``SyntheticStereoLoader``
  slice into ``<ckpt_dir>``; with ``sigterm=K`` rank 1 signals itself
  after step K; with ``resume`` the run restores the newest checkpoint.
  Writes the final step, every step's loss and the final parameters.
  With ``cp=1`` every rank shards its images over a rows x corr group of
  four CPU devices of its own (``rows_shards=2, corr_w2_shards=2``,
  ``mesh_devices``): context parallelism inside each data rank.

Usage: python torch_distributed_worker.py <rank> <world> <port> <out.npz>
       <mode> [key=value ...]
"""

import os
import signal
import sys

import numpy as np
import torch

MODEL = dict(n_gru_layers=1, hidden_dims=(32,), corr_levels=2, fnet_dim=32)
TRAIN = dict(batch_size=8, train_iters=2, num_steps=10, image_size=(32, 48))


def global_batch(step):
    """The JAX package's data-parallel test batches (tests/test_distributed.py)."""
    h, w = TRAIN["image_size"]
    b = TRAIN["batch_size"]
    rng = np.random.default_rng(100 + step)
    return {"image1": rng.uniform(0, 255, (b, h, w, 3)).astype(np.float32),
            "image2": rng.uniform(0, 255, (b, h, w, 3)).astype(np.float32),
            "flow": rng.normal(0, 5, (b, h, w)).astype(np.float32),
            "valid": np.ones((b, h, w), np.float32)}


def flat_params(model):
    return np.concatenate([p.detach().numpy().ravel()
                           for p in model.parameters()])


def run_steps(weights, jitter, rank, world):
    """Two data-parallel steps (``world`` 1: one process, no wrapper)."""
    from torch.nn.parallel import DistributedDataParallel

    from raft_stereo_tpu_torch.config import RaftStereoConfig, TrainConfig
    from raft_stereo_tpu_torch.training.state import create_train_state
    from raft_stereo_tpu_torch.training.step import make_train_step

    tcfg = TrainConfig(**TRAIN, device_photometric=jitter)
    state = create_train_state(RaftStereoConfig(**MODEL), tcfg, "cpu",
                               state_dict=weights)
    if torch.distributed.is_initialized():
        state.ddp = DistributedDataParallel(state.model,
                                            broadcast_buffers=False)
    step_fn = make_train_step(tcfg)
    local = TRAIN["batch_size"] // world
    losses, metrics = [], []
    for step in range(2):
        batch = {k: v[rank * local:(rank + 1) * local]
                 for k, v in global_batch(step).items()}
        state, m = step_fn(state, batch)
        losses.append(float(m["loss"]))
        metrics.append([float(m[k]) for k in ("epe", "1px", "3px", "5px",
                                              "grad_norm")])
    return {"losses": np.asarray(losses), "metrics": np.asarray(metrics),
            "params": flat_params(state.model)}


def run_loop(ckpt_dir, sigterm, resume, num_steps, rank, world,
             cp=False):
    from raft_stereo_tpu_torch.config import RaftStereoConfig, TrainConfig
    from raft_stereo_tpu_torch.data.synthetic import SyntheticStereoLoader
    from raft_stereo_tpu_torch.training.train_loop import train

    tcfg = TrainConfig(**dict(TRAIN, num_steps=num_steps),
                       validation_frequency=1000, data_parallel=world)
    loader = SyntheticStereoLoader(TRAIN["batch_size"], TRAIN["image_size"],
                                   seed=3, process_index=rank,
                                   process_count=world)
    losses = {}

    def on_step(step, m):
        losses[step] = float(m["loss"])
        if rank == 1 and step == sigterm:
            os.kill(os.getpid(), signal.SIGTERM)

    kw = (dict(rows_shards=2, corr_w2_shards=2) if cp else {})
    state = train(RaftStereoConfig(**MODEL, **kw), tcfg, name="dp",
                  checkpoint_dir=ckpt_dir,
                  restore="latest" if resume else None, log_dir=None,
                  loader=loader, device="cpu", on_step=on_step,
                  mesh_devices=["cpu"] * 4 if cp else None)
    return {"step": np.asarray(state.step),
            "loss_steps": np.asarray(sorted(losses)),
            "losses": np.asarray([losses[k] for k in sorted(losses)]),
            "params": flat_params(state.model)}


def main():
    rank, world, port, out = (int(sys.argv[1]), int(sys.argv[2]),
                              int(sys.argv[3]), sys.argv[4])
    mode = sys.argv[5]
    opts = dict(a.split("=", 1) for a in sys.argv[6:])
    torch.set_num_threads(1)
    from raft_stereo_tpu_torch.parallel import distributed
    distributed.initialize(f"tcp://localhost:{port}", world_size=world,
                           rank=rank, device="cpu")
    try:
        if mode == "steps":
            result = run_steps(torch.load(opts["weights"], weights_only=True),
                               opts.get("jitter") == "1", rank, world)
        else:
            result = run_loop(opts["ckpt_dir"], int(opts.get("sigterm", -1)),
                              opts.get("resume") == "1",
                              int(opts.get("num_steps", 5)), rank, world,
                              opts.get("cp") == "1")
    finally:
        distributed.shutdown()
    np.savez(out, **result)


if __name__ == "__main__":
    main()
