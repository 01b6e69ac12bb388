"""Are the drift gate's brief trainings repeatable on the card?

    python tests/torch_drift_determinism.py [--steps 1,20]

Trains the ``quant_drift --full`` recipe (``eval/drift.brief_train``: the
hermetic architecture at 320x704, 12 iterations, disparity scale 6) twice
for each step count, as ``brief_train`` runs it (cuDNN's deterministic
algorithms) and with cuDNN's default algorithms, and prints the largest
difference between the two runs' weights, with the card's name and power
limit.  Needs a CUDA card.
"""

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", default="1,20")
    args = ap.parse_args(argv)

    import torch

    import raft_stereo_tpu_torch.training.train_loop as loop
    from raft_stereo_tpu_torch.eval import drift

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    cfg = drift.model_config()
    real_train = loop.train

    def default_algorithms(*a, **k):
        torch.backends.cudnn.deterministic = False
        return real_train(*a, **k)

    def trained(steps):
        return drift.brief_train(cfg, steps, (320, 704), 12, 6.0,
                                 device="cuda")

    def max_diff(a, b):
        return max((a[k] - b[k]).abs().max().item() for k in a
                   if a[k].is_floating_point())

    out = {}
    for steps in (int(s) for s in args.steps.split(",")):
        out[f"deterministic, {steps} steps"] = max_diff(trained(steps),
                                                        trained(steps))
        loop.train = default_algorithms
        try:
            out[f"cuDNN defaults, {steps} steps"] = max_diff(
                trained(steps), trained(steps))
        finally:
            loop.train = real_train
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip())
    print(json.dumps({"max |weights of run 1 - run 2|": out}))


if __name__ == "__main__":
    main()
