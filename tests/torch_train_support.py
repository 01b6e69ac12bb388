"""Helpers shared by the port's training-entry-point tests: a tiny
SceneFlow TRAIN tree in the layout both packages' ``SceneFlow`` globs,
a loader that records what it yields, and AdamW in float64."""

import hashlib
import os

import numpy as np
from PIL import Image

import golden_data
from raft_stereo_tpu_torch.data.frame_utils import write_pfm
from raft_stereo_tpu_torch.data.loader import StereoLoader


def make_sceneflow_train(root: str, n: int = 4, hw=(48, 80),
                         seed: int = 0) -> str:
    """``n`` textured FlyingThings3D TRAIN pairs (right = left warped by a
    known disparity) in the clean and the final pass, the passes
    ``build_training_mixture(("sceneflow",))`` reads."""
    rng = np.random.default_rng(seed)
    things = os.path.join(root, "FlyingThings3D")
    for i in range(n):
        left, right, disp = golden_data._pair(rng, *hw)
        for dstype in ("frames_cleanpass", "frames_finalpass"):
            seq = os.path.join(things, dstype, "TRAIN", "A", f"{i:04d}")
            for side, img in (("left", left), ("right", right)):
                os.makedirs(os.path.join(seq, side), exist_ok=True)
                Image.fromarray(img).save(os.path.join(seq, side, "0006.png"))
        d = os.path.join(things, "disparity", "TRAIN", "A", f"{i:04d}", "left")
        os.makedirs(d, exist_ok=True)
        write_pfm(os.path.join(d, "0006.pfm"), disp)
    return root


def batch_sha(batch) -> str:
    h = hashlib.sha256()
    for k in sorted(batch):
        h.update(k.encode())
        h.update(np.ascontiguousarray(batch[k]).tobytes())
    return h.hexdigest()


class RecordingLoader(StereoLoader):
    """A ``StereoLoader`` that keeps the hash of every batch each
    iteration yields (one list per ``iter()``), and sets the flow of the
    first iteration's ``poison`` steps (1-based, counted from offset 0)
    to NaN after hashing it."""

    def __init__(self, *args, poison=(), **kwargs):
        super().__init__(*args, **kwargs)
        self.poison = tuple(poison)
        self.iters = []

    def __iter__(self):
        hashes = []
        self.iters.append(hashes)
        first, offset = len(self.iters) == 1, self.start_offset
        for i, batch in enumerate(super().__iter__()):
            hashes.append(batch_sha(batch))
            if first and offset + i + 1 in self.poison:
                batch = dict(batch, flow=np.full_like(batch["flow"], np.nan))
            yield batch


def adamw_f64(params, grads, skips, cfg):
    """Clip and AdamW (optax's definition: decay on the old parameter, the
    bias corrections of the applied-update count) in float64 at the fp32
    LRs of ``one_cycle_lr``, over the numpy dicts ``params`` and
    ``grads[i]``; a step in ``skips`` changes nothing.  Returns the
    parameters and, per leaf, the most that computing the two bias
    corrections ``1 - beta^t`` in fp32 (as optax and torch's
    ``capturable`` AdamW do) can move them: a rounding of ``beta^t``
    (2^-24, as beta^t lies in [0.5, 1)) over ``1 - beta^t``, times the
    step's |lr u|, summed over the applied steps."""
    from raft_stereo_tpu_torch.training.optimizer import one_cycle_lr
    sched = one_cycle_lr(cfg.lr, cfg.num_steps + 100)
    p = {k: v.astype(np.float64) for k, v in params.items()}
    m = {k: np.zeros_like(v) for k, v in p.items()}
    v = {k: np.zeros_like(x) for k, x in p.items()}
    bound = {k: np.zeros_like(x) for k, x in p.items()}
    t = 0
    for i, g in enumerate(grads):
        if i in skips:
            continue
        norm = np.sqrt(sum((x.astype(np.float64) ** 2).sum()
                           for x in g.values()))
        f = cfg.clip_grad_norm / max(norm, cfg.clip_grad_norm)
        lr, t = sched(t), t + 1
        bc1, bc2 = 1 - 0.9 ** t, 1 - 0.999 ** t
        for k in p:
            gk = g[k] * f
            m[k] = 0.9 * m[k] + 0.1 * gk
            v[k] = 0.999 * v[k] + 0.001 * gk * gk
            u = (m[k] / bc1) / (np.sqrt(v[k] / bc2) + cfg.epsilon)
            bound[k] += np.abs(lr * u) * 2.0 ** -24 * (1 / bc1
                                                       + 0.5 / bc2)
            p[k] = p[k] - lr * (u + cfg.wdecay * p[k])
    return p, bound
